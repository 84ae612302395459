"""Fused LSTM recurrences: one chain (`lstm_scan`) and two in one launch (`lstm_scan_bidir`).

Port of `dnn_based_source_separation_tpu/ops/pallas_lstm.py:lstm_scan` and
`lstm_scan_bidir` (forward only). On CUDA tensors the hand-written Hopper
kernels of `csrc/lstm_scan.cu` run; on CPU tensors the plain PyTorch
versions do. There is no fallback from one to the other: a CUDA call the
kernel cannot take raises.

Semantics are the Pallas kernels', in both dtypes: gates are
`f32(xw[t]) + f32(h rounded to W's dtype) @ f32(W)`, h and c are carried in
f32, and hs is rounded to the dtype on write. (The JAX `lax.scan` path
computes in the input dtype instead, which differs in bfloat16.)
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load_library

# Launches of each CUDA kernel in this process. Only the launches below
# increment them; callers reset them to 0 to count a run.
LAUNCHES = {"lstm_scan": 0, "lstm_scan_bidir": 0}

MAX_HIDDEN = 512
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def lstm_scan_reference(xw: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Plain version, one step at a time: xw (B, T, 4H), w_hh (H, 4H) -> hs (B, T, H).

    Zero initial state, torch gate order i, f, g, o. `h.to(W.dtype).float() @ W.float()`
    keeps the bfloat16 products exact and sums them in f32, as the Pallas kernel does
    (a bfloat16 matmul would round its output to bfloat16).
    """
    B, T, four_h = xw.shape
    H = four_h // 4
    w = w_hh.float()
    h = torch.zeros((B, H), dtype=torch.float32, device=xw.device)
    c = torch.zeros_like(h)
    hs = torch.empty((B, T, H), dtype=xw.dtype, device=xw.device)
    for t in range(T):
        gates = xw[:, t].float() + h.to(w_hh.dtype).float() @ w
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs[:, t] = h
    return hs


def lstm_scan_bidir_reference(xw_f, xw_b, whh_f, whh_b):
    """Plain version of `lstm_scan_bidir`: two independent chains."""
    return lstm_scan_reference(xw_f, whh_f), lstm_scan_reference(xw_b, whh_b)


def _library():
    global _LIB
    if _LIB is None:
        lib = load_library("lstm_scan")
        lib.lstm_scan_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.lstm_scan_launch.restype = ctypes.c_int
        lib.lstm_scan_bidir_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.lstm_scan_bidir_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def build() -> None:
    """Build (or load) the CUDA kernels now instead of at their first launch."""
    _library()


def _check(xw: torch.Tensor, w_hh: torch.Tensor) -> None:
    if xw.dim() != 3 or w_hh.dim() != 2:
        raise ValueError(f"expected xw (B, T, 4H) and w_hh (H, 4H); got "
                         f"{tuple(xw.shape)}, {tuple(w_hh.shape)}")
    B, T, four_h = xw.shape
    H = w_hh.shape[0]
    if four_h != 4 * H or w_hh.shape[1] != 4 * H:
        raise ValueError(f"shape mismatch: xw {tuple(xw.shape)}, w_hh {tuple(w_hh.shape)}")
    if xw.dtype != w_hh.dtype or xw.dtype not in _DTYPE_CODE:
        raise TypeError(f"xw and w_hh must share float32 or bfloat16; got {xw.dtype}, {w_hh.dtype}")
    if xw.device != w_hh.device:
        raise ValueError(f"tensors on different devices: {xw.device}, {w_hh.device}")
    if H % 4 or not 4 <= H <= MAX_HIDDEN:
        raise ValueError(f"hidden size H = {H} must be a multiple of 4 in 4..{MAX_HIDDEN}")
    if B < 1 or T < 1 or B * T * four_h >= 2 ** 62:
        raise ValueError(f"unsupported sizes B={B}, T={T}")
    for name, t in (("xw", xw), ("w_hh", w_hh)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def lstm_scan(xw: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Fused LSTM recurrence: xw (B, T, 4H) input gates, w_hh (H, 4H) -> hs (B, T, H).

    CPU tensors take the plain version; CUDA tensors launch the kernel or raise.
    """
    if xw.device.type == "cpu":
        return lstm_scan_reference(xw, w_hh)
    if xw.device.type != "cuda":
        raise ValueError(f"lstm_scan runs on cpu or cuda, not {xw.device}")
    _check(xw, w_hh)
    B, T, _ = xw.shape
    H = w_hh.shape[0]
    hs = torch.empty((B, T, H), dtype=xw.dtype, device=xw.device)
    with torch.cuda.device(xw.device):
        err = _library().lstm_scan_launch(
            xw.data_ptr(), w_hh.data_ptr(), hs.data_ptr(), _DTYPE_CODE[xw.dtype], B, T, H,
            torch.cuda.current_stream(xw.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_scan kernel launch failed: cudaError {err}")
    LAUNCHES["lstm_scan"] += 1
    return hs


def lstm_scan_bidir(xw_f: torch.Tensor, xw_b: torch.Tensor, whh_f: torch.Tensor,
                    whh_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Both chains of a bidirectional LSTM layer in one launch.

    xw_f (B, T, 4H): forward input gates; xw_b: the backward chain's input
    gates over the TIME-REVERSED sequence. Returns (hs_f, hs_b), hs_b in
    reversed time order (flip it back outside), as the Pallas kernel does.
    CPU tensors take the plain version; CUDA tensors launch the kernel or raise.
    """
    if xw_f.device.type == "cpu":
        return lstm_scan_bidir_reference(xw_f, xw_b, whh_f, whh_b)
    if xw_f.device.type != "cuda":
        raise ValueError(f"lstm_scan_bidir runs on cpu or cuda, not {xw_f.device}")
    _check(xw_f, whh_f)
    _check(xw_b, whh_b)
    if xw_b.shape != xw_f.shape or xw_b.dtype != xw_f.dtype or xw_b.device != xw_f.device:
        raise ValueError(f"the two chains differ: {tuple(xw_f.shape)} {xw_f.dtype} "
                         f"{xw_f.device} vs {tuple(xw_b.shape)} {xw_b.dtype} {xw_b.device}")
    B, T, _ = xw_f.shape
    H = whh_f.shape[0]
    hs_f = torch.empty((B, T, H), dtype=xw_f.dtype, device=xw_f.device)
    hs_b = torch.empty_like(hs_f)
    with torch.cuda.device(xw_f.device):
        err = _library().lstm_scan_bidir_launch(
            xw_f.data_ptr(), xw_b.data_ptr(), whh_f.data_ptr(), whh_b.data_ptr(),
            hs_f.data_ptr(), hs_b.data_ptr(), _DTYPE_CODE[xw_f.dtype], B, T, H,
            torch.cuda.current_stream(xw_f.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_scan_bidir kernel launch failed: cudaError {err}")
    LAUNCHES["lstm_scan_bidir"] += 1
    return hs_f, hs_b
