"""Fused GRU recurrences: two chains in one launch (`gru_scan_bidir`) and one (`gru_scan`).

Port of `dnn_based_source_separation_tpu/ops/pallas_lstm.py:gru_scan_bidir`
(forward only), plus its one-chain instance for the unidirectional GRU,
which the JAX package runs in `lax.scan`. On CUDA tensors the hand-written
Hopper kernels of `csrc/gru_scan.cu` run; on CPU tensors the plain PyTorch
versions do. There is no fallback from one to the other: a CUDA call the
kernel cannot take raises.

Semantics are the Pallas kernel's, in both dtypes, torch gate order r, z, n:
`g = f32(h rounded to W's dtype) @ f32(W) + f32(b_hh)`,
`r = sigmoid(x_r + g_r)`, `z = sigmoid(x_z + g_z)`, `n = tanh(x_n + r * g_n)`,
`h = (1 - z) * n + z * h`, with `xw = x @ W_ih^T + b_ih` given. h is carried
in f32 and hs is rounded to the dtype on write. (The JAX `lax.scan` path
computes in the input dtype instead, which differs in bfloat16.)
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load_library

# Launches of each CUDA kernel in this process. Only the launches below
# increment them; callers reset them to 0 to count a run.
LAUNCHES = {"gru_scan": 0, "gru_scan_bidir": 0}

MAX_HIDDEN = 512
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def gru_steps(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
              h: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The GRU recurrence one step at a time from state `h` (B, H) f32 (zeros if None).

    xw (B, T, 3H), w_hh (H, 3H), b_hh (3H,) -> (hs (B, T, H) in xw's dtype,
    final h (B, H) f32). Exact streaming carries `h` across calls with this
    loop; from a zero state it is the plain version of the kernels.
    `h.to(W.dtype).float() @ W.float()` keeps the bfloat16 products exact and
    sums them in f32, as the Pallas kernel does.
    """
    B, T, three_h = xw.shape
    H = three_h // 3
    w, b = w_hh.float(), b_hh.float()
    if h is None:
        h = torch.zeros((B, H), dtype=torch.float32, device=xw.device)
    hs = torch.empty((B, T, H), dtype=xw.dtype, device=xw.device)
    for t in range(T):
        g = h.to(w_hh.dtype).float() @ w + b
        x = xw[:, t].float()
        r = torch.sigmoid(x[:, :H] + g[:, :H])
        z = torch.sigmoid(x[:, H:2 * H] + g[:, H:2 * H])
        n = torch.tanh(x[:, 2 * H:] + r * g[:, 2 * H:])
        h = (1.0 - z) * n + z * h
        hs[:, t] = h
    return hs, h


def gru_scan_reference(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """Plain version of `gru_scan`: xw (B, T, 3H), w_hh (H, 3H), b_hh (3H,) -> hs (B, T, H)."""
    return gru_steps(xw, w_hh, b_hh)[0]


def gru_scan_bidir_reference(xw_f, xw_b, whh_f, whh_b, bhh_f, bhh_b):
    """Plain version of `gru_scan_bidir`: two independent chains."""
    return gru_scan_reference(xw_f, whh_f, bhh_f), gru_scan_reference(xw_b, whh_b, bhh_b)


def _library():
    global _LIB
    if _LIB is None:
        lib = load_library("gru_scan")
        lib.gru_scan_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.gru_scan_launch.restype = ctypes.c_int
        lib.gru_scan_bidir_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.gru_scan_bidir_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def build() -> None:
    """Build (or load) the CUDA kernels now instead of at their first launch."""
    _library()


def _check(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> None:
    if xw.dim() != 3 or w_hh.dim() != 2 or b_hh.dim() != 1:
        raise ValueError(f"expected xw (B, T, 3H), w_hh (H, 3H) and b_hh (3H,); got "
                         f"{tuple(xw.shape)}, {tuple(w_hh.shape)}, {tuple(b_hh.shape)}")
    B, T, three_h = xw.shape
    H = w_hh.shape[0]
    if three_h != 3 * H or w_hh.shape[1] != 3 * H or b_hh.shape[0] != 3 * H:
        raise ValueError(f"shape mismatch: xw {tuple(xw.shape)}, w_hh {tuple(w_hh.shape)}, "
                         f"b_hh {tuple(b_hh.shape)}")
    if not (xw.dtype == w_hh.dtype == b_hh.dtype) or xw.dtype not in _DTYPE_CODE:
        raise TypeError(f"xw, w_hh and b_hh must share float32 or bfloat16; got "
                        f"{xw.dtype}, {w_hh.dtype}, {b_hh.dtype}")
    if not (xw.device == w_hh.device == b_hh.device):
        raise ValueError(f"tensors on different devices: {xw.device}, {w_hh.device}, "
                         f"{b_hh.device}")
    if H % 4 or not 4 <= H <= MAX_HIDDEN:
        raise ValueError(f"hidden size H = {H} must be a multiple of 4 in 4..{MAX_HIDDEN}")
    if B < 1 or T < 1 or B * T * three_h >= 2 ** 62:
        raise ValueError(f"unsupported sizes B={B}, T={T}")
    for name, t in (("xw", xw), ("w_hh", w_hh), ("b_hh", b_hh)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """CUDA calls under autograd raise: the kernel has no backward yet, and its output
    would carry no gradient history."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} on CUDA has no backward kernel yet: the GRU backward "
            "(ops/pallas_lstm.py:_gru_bwd_core) is the next slice of the port. Serve under "
            "torch.no_grad(), or train the GRU on the CPU")


def gru_scan(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """Fused GRU recurrence: xw (B, T, 3H) = x W_ih^T + b_ih, w_hh (H, 3H), b_hh (3H,) -> hs.

    CPU tensors take the plain version (differentiable); CUDA tensors launch
    the kernel or raise, and raise under autograd.
    """
    if xw.device.type == "cpu":
        return gru_scan_reference(xw, w_hh, b_hh)
    if xw.device.type != "cuda":
        raise ValueError(f"gru_scan runs on cpu or cuda, not {xw.device}")
    _refuse_autograd("gru_scan", xw, w_hh, b_hh)
    _check(xw, w_hh, b_hh)
    B, T, _ = xw.shape
    H = w_hh.shape[0]
    hs = torch.empty((B, T, H), dtype=xw.dtype, device=xw.device)
    with torch.cuda.device(xw.device):
        err = _library().gru_scan_launch(
            xw.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), hs.data_ptr(),
            _DTYPE_CODE[xw.dtype], B, T, H, torch.cuda.current_stream(xw.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gru_scan kernel launch failed: cudaError {err}")
    LAUNCHES["gru_scan"] += 1
    return hs


def gru_scan_bidir(xw_f: torch.Tensor, xw_b: torch.Tensor, whh_f: torch.Tensor,
                   whh_b: torch.Tensor, bhh_f: torch.Tensor,
                   bhh_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Both chains of a bidirectional GRU layer in one launch.

    xw_f (B, T, 3H): forward input projections (b_ih included); xw_b: the
    backward chain's over the TIME-REVERSED sequence. Returns (hs_f, hs_b),
    hs_b in reversed time order (flip it back outside), as the Pallas kernel
    does. CPU tensors take the plain version (differentiable); CUDA tensors
    launch the kernel or raise, and raise under autograd.
    """
    if xw_f.device.type == "cpu":
        return gru_scan_bidir_reference(xw_f, xw_b, whh_f, whh_b, bhh_f, bhh_b)
    if xw_f.device.type != "cuda":
        raise ValueError(f"gru_scan_bidir runs on cpu or cuda, not {xw_f.device}")
    _refuse_autograd("gru_scan_bidir", xw_f, xw_b, whh_f, whh_b, bhh_f, bhh_b)
    _check(xw_f, whh_f, bhh_f)
    _check(xw_b, whh_b, bhh_b)
    if xw_b.shape != xw_f.shape or xw_b.dtype != xw_f.dtype or xw_b.device != xw_f.device:
        raise ValueError(f"the two chains differ: {tuple(xw_f.shape)} {xw_f.dtype} "
                         f"{xw_f.device} vs {tuple(xw_b.shape)} {xw_b.dtype} {xw_b.device}")
    B, T, _ = xw_f.shape
    H = whh_f.shape[0]
    hs_f = torch.empty((B, T, H), dtype=xw_f.dtype, device=xw_f.device)
    hs_b = torch.empty_like(hs_f)
    with torch.cuda.device(xw_f.device):
        err = _library().gru_scan_bidir_launch(
            xw_f.data_ptr(), xw_b.data_ptr(), whh_f.data_ptr(), whh_b.data_ptr(),
            bhh_f.data_ptr(), bhh_b.data_ptr(), hs_f.data_ptr(), hs_b.data_ptr(),
            _DTYPE_CODE[xw_f.dtype], B, T, H, torch.cuda.current_stream(xw_f.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gru_scan_bidir kernel launch failed: cudaError {err}")
    LAUNCHES["gru_scan_bidir"] += 1
    return hs_f, hs_b
