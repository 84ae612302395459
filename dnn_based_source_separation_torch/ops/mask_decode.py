"""Fused mask x latent -> synthesis matmul of the TasNet decoder.

Port of `dnn_based_source_separation_tpu/ops/pallas_kernels.py:fused_mask_decode`.
On CUDA tensors the hand-written Hopper kernel `csrc/mask_decode.cu` runs;
on CPU tensors the plain PyTorch version does. There is no fallback from
one to the other: a CUDA call the kernel cannot take raises. The kernel
takes every width the decoder can hand over: any N, any C·L, any row
strides, as long as the last dimension of w and mask is contiguous.

It has three paths, and `_plan` picks one per call from dtype, shape and
alignment (no autotuning, and no fallback: a path that cannot launch
raises): "rows" for f32 at DPRNN-TasNet's decoder width (N=64, C·L=2),
"mma" for bf16 with C·L up to 16 on the tensor cores (Conv-TasNet's N=512,
C·L=16 and DPRNN-TasNet's width), and "generic" for every other call.
`PATH_LAUNCHES` counts the launches of each, `WIDTH_LAUNCHES` the same
launches by (path, dtype, N, C·L).

The kernel has no backward, as the Pallas kernel has no VJP: a CUDA call
under autograd raises instead of returning a result with no gradient
history. Training decodes with the plain version (`ops/filterbank.py`).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from ._build import load_library

# Number of launches of the CUDA kernel in this process. Only the launch
# below increments it; callers reset it to 0 to count a run.
LAUNCHES = 0
# The same launches by path, and by (path, dtype name, N, C·L).
PATH_LAUNCHES = {"rows": 0, "mma": 0, "generic": 0}
WIDTH_LAUNCHES: collections.Counter = collections.Counter()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PATH_CODE = {"generic": 0, "rows": 1, "mma": 2}
# Elements of a 16-byte vector.
_VEC = {torch.float32: 4, torch.bfloat16: 8}
# "rows": the (N, C·L) its kernel is built for, in f32.
ROWS_WIDTHS = ((64, 2),)
# "mma": C·L in one or two n8 tiles, K's B fragments in shared memory.
MMA_MAX_COLUMNS = 16
MAX_SHARED = 232448  # a Hopper block's dynamic shared-memory ceiling
# Launch arguments by call signature (see `_launch_args`); cleared when full.
_PLANS: dict = {}
_MAX_PLANS = 256
_LIB = None


def fused_mask_decode_reference(w: torch.Tensor, mask: torch.Tensor,
                                kernel: torch.Tensor) -> torch.Tensor:
    """Plain version: (w[:, None] * mask) rounded in the input dtype, then an f32 matmul.

    w (B, T', N), mask (B, S, T', N), kernel (N, CL) -> (B, S, T', CL) float32
    (float64 for float64 inputs, for gradient checks).
    """
    acc = torch.promote_types(w.dtype, torch.float32)
    return (w[:, None] * mask).to(acc) @ kernel.to(acc)


def _library():
    global _LIB
    if _LIB is None:
        lib = load_library("mask_decode")
        lib.mask_decode_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int,  # dtype, path
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p,
        ]
        lib.mask_decode_launch.restype = ctypes.c_int
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
    if Tp < 1 or B < 1 or mask.shape[1] < 1 or N < 1 or kernel.shape[1] < 1 or B > 65535:
        raise ValueError(f"unsupported sizes B={B}, S={mask.shape[1]}, T'={Tp}, N={N}, "
                         f"C*L={kernel.shape[1]}")
    if not kernel.is_contiguous():
        raise ValueError("kernel must be contiguous")
    for name, t in (("w", w), ("mask", mask)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dimension; strides {t.stride()}")


def _mma_shared(N: int, CL: int) -> int:
    """Bytes of K's B fragments on the "mma" path: 16 a lane, per 32 n and n8 tile."""
    return -(-N // 32) * -(-CL // 8) * 32 * 16


def _mma_fits(dtype: torch.dtype, N: int, CL: int) -> bool:
    return (dtype == torch.bfloat16 and N % 8 == 0 and CL <= MMA_MAX_COLUMNS
            and _mma_shared(N, CL) <= MAX_SHARED)


def _plan(dtype: torch.dtype, B: int, S: int, Tp: int, N: int, CL: int, aligned: bool,
          path: str | None = None) -> str:
    """The kernel path of one call -> "rows", "mma" or "generic".

    `aligned`: N is whole 16-byte vectors and every row of w and mask starts
    16-byte aligned (`_aligned`). "rows" for f32 at the (N, C·L) of
    ROWS_WIDTHS; "mma" for bf16 with N a multiple of 8 and C·L up to 16; both
    need aligned rows and B x S x T' < 2^30. "generic" for every other call,
    f32 at N=512 among them. `path` forces one (the generic kernel at a shape
    that takes another, to time both); forcing a path that cannot take the call
    raises.
    """
    fits = {"rows": dtype == torch.float32 and (N, CL) in ROWS_WIDTHS,
            "mma": _mma_fits(dtype, N, CL), "generic": True}
    if aligned and B * S * Tp < 2 ** 30:
        natural = "rows" if fits["rows"] else "mma" if fits["mma"] else "generic"
    else:
        natural = "generic"
        fits.update(rows=False, mma=False)
    if path is None:
        return natural
    if path not in fits:
        raise ValueError(f"unknown fused_mask_decode path {path!r}")
    if not fits[path]:
        raise ValueError(f"the {path} path cannot take {dtype} at B={B}, S={S}, T'={Tp}, "
                         f"N={N}, C*L={CL} (aligned={aligned})")
    return path


def _aligned(w: torch.Tensor, mask: torch.Tensor) -> bool:
    """N whole 16-byte vectors and every row of w and mask 16-byte aligned."""
    vec = _VEC[w.dtype]
    return (w.shape[-1] % vec == 0
            and all(st % vec == 0 for st in (*w.stride()[:2], *mask.stride()[:3]))
            and w.data_ptr() % 16 == 0 and mask.data_ptr() % 16 == 0)


def launch_plan(w: torch.Tensor, mask: torch.Tensor, kernel: torch.Tensor,
                path: str | None = None) -> str:
    """The path `fused_mask_decode` takes for these tensors on the card (see `_plan`)."""
    _check(w, mask, kernel)
    B, Tp, N = w.shape
    return _plan(w.dtype, B, mask.shape[1], Tp, N, kernel.shape[1], _aligned(w, mask), path)


def _launch_args(w: torch.Tensor, mask: torch.Tensor, kernel: torch.Tensor, path: str | None):
    """(path, width, output shape, C arguments) of one CUDA call, checked and planned once
    per call signature: dtype, device, shapes, strides, whether both data pointers are
    16-byte aligned, and the forced `path`."""
    key = (w.dtype, mask.dtype, kernel.dtype, w.device, mask.device, kernel.device,
           w.shape, mask.shape, kernel.shape, w.stride(), mask.stride(), kernel.stride(),
           (w.data_ptr() | mask.data_ptr()) % 16 == 0, path)
    hit = _PLANS.get(key)
    if hit is None:
        planned = launch_plan(w, mask, kernel, path)
        B, Tp, N = w.shape
        S, CL = mask.shape[1], kernel.shape[1]
        hit = (planned, (planned, str(w.dtype)[6:], N, CL), (B, S, Tp, CL),
               (_DTYPE_CODE[w.dtype], _PATH_CODE[planned], B, S, Tp, N, CL,
                w.stride(0), w.stride(1), mask.stride(0), mask.stride(1), mask.stride(2)))
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.clear()
        _PLANS[key] = hit
    return hit


def _launch(w, mask, kernel, out, planned) -> torch.Tensor:
    """Run the kernel on `planned` (from `_launch_args`) into `out` and count it."""
    global LAUNCHES
    path, width, _, args = planned
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().mask_decode_launch(w.data_ptr(), mask.data_ptr(), kernel.data_ptr(),
                                            out.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"mask_decode kernel launch ({path}) failed: cudaError {err}")
    LAUNCHES += 1
    PATH_LAUNCHES[path] += 1
    WIDTH_LAUNCHES[width] += 1
    return out


def fused_mask_decode(w: torch.Tensor, mask: torch.Tensor, kernel: torch.Tensor,
                      path: str | None = None) -> torch.Tensor:
    """frames = (w[:, None] * mask) @ kernel without writing w * mask to memory.

    w (B, T', N), mask (B, S, T', N), kernel (N, CL), all float32 or all
    bfloat16 -> (B, S, T', CL) float32. The overlap-add of the frames
    happens outside (ops/filterbank.py:ConvDecoder).

    CPU tensors take the plain version; CUDA tensors launch the kernel on the
    path `_plan` gives (or `path`, forced) or raise, and raise under autograd
    (grad mode on and an input requiring grad).
    """
    if w.device.type == "cpu":
        return fused_mask_decode_reference(w, mask, kernel)
    if w.device.type != "cuda":
        raise ValueError(f"fused_mask_decode runs on cpu or cuda, not {w.device}")
    if torch.is_grad_enabled() and (w.requires_grad or mask.requires_grad
                                    or kernel.requires_grad):
        raise NotImplementedError("fused_mask_decode has no backward (no VJP, as in the JAX "
                                  "package): decode with fused_mask_decode_reference under "
                                  "autograd, or call it under torch.no_grad()")
    planned = _launch_args(w, mask, kernel, path)
    out = torch.empty(planned[2], dtype=torch.float32, device=w.device)
    return _launch(w, mask, kernel, out, planned)


def _staged(w: torch.Tensor, mask: torch.Tensor, kernel: torch.Tensor,
            path: str | None = None):
    """Plan and check one CUDA call and allocate its output -> (launch, out).

    Each launch() runs the kernel on the path `_plan` gives (or `path`) into
    `out`, counts it and returns `out`: the kernel alone, without the planning
    and the allocation around it, for a timing loop.
    """
    planned = _launch_args(w, mask, kernel, path)
    out = torch.empty(planned[2], dtype=torch.float32, device=w.device)
    return (lambda: _launch(w, mask, kernel, out, planned)), out
