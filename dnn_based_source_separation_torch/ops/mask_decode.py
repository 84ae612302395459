"""Fused mask x latent -> synthesis matmul of the TasNet decoder.

Port of `dnn_based_source_separation_tpu/ops/pallas_kernels.py:fused_mask_decode`.
On CUDA tensors the hand-written Hopper kernel `csrc/mask_decode.cu` runs;
on CPU tensors the plain PyTorch version does. There is no fallback from
one to the other: a CUDA call the kernel cannot take raises.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load_library

# Number of launches of the CUDA kernel in this process. Only the launch
# below increments it; callers reset it to 0 to count a run.
LAUNCHES = 0

MAX_CL = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements per 16-byte load
_MAX_SHARED_BYTES = 232448  # a Hopper block's dynamic shared-memory ceiling
_LIB = None


def fused_mask_decode_reference(w: torch.Tensor, mask: torch.Tensor,
                                kernel: torch.Tensor) -> torch.Tensor:
    """Plain version: (w[:, None] * mask) rounded in the input dtype, then an f32 matmul.

    w (B, T', N), mask (B, S, T', N), kernel (N, CL) -> (B, S, T', CL) float32.
    """
    return (w[:, None] * mask).float() @ kernel.float()


def _library():
    global _LIB
    if _LIB is None:
        lib = load_library("mask_decode")
        lib.mask_decode_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p,
        ]
        lib.mask_decode_launch.restype = ctypes.c_int
        lib.mask_decode_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.mask_decode_smem_bytes.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


def build() -> None:
    """Build (or load) the CUDA kernel now instead of at its first launch."""
    _library()


def _check(w: torch.Tensor, mask: torch.Tensor, kernel: torch.Tensor) -> None:
    if w.dim() != 3 or mask.dim() != 4 or kernel.dim() != 2:
        raise ValueError(f"expected w (B,T',N), mask (B,S,T',N), kernel (N,CL); got "
                         f"{tuple(w.shape)}, {tuple(mask.shape)}, {tuple(kernel.shape)}")
    B, Tp, N = w.shape
    if mask.shape[0] != B or mask.shape[2] != Tp or mask.shape[3] != N or kernel.shape[0] != N:
        raise ValueError(f"shape mismatch: w {tuple(w.shape)}, mask {tuple(mask.shape)}, "
                         f"kernel {tuple(kernel.shape)}")
    if not (w.dtype == mask.dtype == kernel.dtype) or w.dtype not in _DTYPE_CODE:
        raise TypeError(f"w, mask and kernel must share float32 or bfloat16; got "
                        f"{w.dtype}, {mask.dtype}, {kernel.dtype}")
    if not (w.device == mask.device == kernel.device):
        raise ValueError(f"tensors on different devices: {w.device}, {mask.device}, {kernel.device}")
    CL = kernel.shape[1]
    if not 1 <= CL <= MAX_CL:
        raise ValueError(f"kernel width C*L = {CL} outside 1..{MAX_CL}")
    if Tp < 1 or B < 1 or mask.shape[1] < 1 or B > 65535:
        raise ValueError(f"unsupported sizes B={B}, S={mask.shape[1]}, T'={Tp}")
    vec = _VEC[w.dtype]
    if N % vec:
        raise ValueError(f"N = {N} must be a multiple of {vec} for 16-byte loads of {w.dtype}")
    if not kernel.is_contiguous():
        raise ValueError("kernel must be contiguous")
    for name, t in (("w", w), ("mask", mask)):
        if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:-1]):
            raise ValueError(f"{name} needs a contiguous last dimension and 16-byte aligned "
                             f"rows; strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def fused_mask_decode(w: torch.Tensor, mask: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """frames = (w[:, None] * mask) @ kernel without writing w * mask to memory.

    w (B, T', N), mask (B, S, T', N), kernel (N, CL), all float32 or all
    bfloat16 -> (B, S, T', CL) float32. The overlap-add of the frames
    happens outside (ops/filterbank.py:ConvDecoder).

    CPU tensors take the plain version; CUDA tensors launch the kernel or raise.
    """
    global LAUNCHES
    if w.device.type == "cpu":
        return fused_mask_decode_reference(w, mask, kernel)
    if w.device.type != "cuda":
        raise ValueError(f"fused_mask_decode runs on cpu or cuda, not {w.device}")
    _check(w, mask, kernel)
    lib = _library()
    B, Tp, N = w.shape
    S, CL = mask.shape[1], kernel.shape[1]
    code = _DTYPE_CODE[w.dtype]
    smem = lib.mask_decode_smem_bytes(code, N, CL)
    if smem > _MAX_SHARED_BYTES:
        raise ValueError(f"N = {N}, C*L = {CL} needs {smem} B of shared memory "
                         f"(> {_MAX_SHARED_BYTES})")
    out = torch.empty((B, S, Tp, CL), dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.mask_decode_launch(
            w.data_ptr(), mask.data_ptr(), kernel.data_ptr(), out.data_ptr(),
            code, B, S, Tp, N, CL,
            w.stride(0), w.stride(1), mask.stride(0), mask.stride(1), mask.stride(2),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"mask_decode kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
