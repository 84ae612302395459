"""Fused GRU recurrences: two chains in one launch (`gru_scan_bidir`) and one (`gru_scan`).

Port of `dnn_based_source_separation_tpu/ops/pallas_lstm.py:gru_scan_bidir`
with its `jax.custom_vjp` backward (`_gru_bwd_core`), plus its one-chain
instance for the unidirectional GRU, which the JAX package runs in
`lax.scan`. On CUDA tensors the hand-written Hopper kernels run: the
forward of `csrc/gru_scan.cu` and, under autograd, the reverse recurrence of
`csrc/gru_scan_bwd.cu`. On CPU tensors the plain PyTorch versions do. There
is no fallback from one to the other: a CUDA call the kernel cannot take
raises.

The forward has three of the LSTM's four paths, planned by the same `_plan`
(`ops/lstm_scan.py`) over this wrapper's ROUTES, which lack the LSTM's
`"cluster"`: for H a multiple of 16 up to 128 the tensor-core
kernels, `"mma"` (`csrc/recurrence_mma.cuh`) for bfloat16 and `"tf32x3"`
(`csrc/recurrence_tf32.cuh`) for float32; the FMA kernel (`"fma"`) for every
other call. The backward has the LSTM's two, planned by `_plan_bwd`: the
split-TF32 tensor-core kernel of `csrc/recurrence_bwd_tf32.cuh` (`"tf32x3"`
for float32, `"tf32x2"` for bfloat16) for the same H, the FMA kernel
otherwise.

Semantics are the Pallas kernel's, in both dtypes, torch gate order r, z, n:
`g = f32(h rounded to W's dtype) @ f32(W) + f32(b_hh)`,
`r = sigmoid(x_r + g_r)`, `z = sigmoid(x_z + g_z)`, `n = tanh(x_n + r * g_n)`,
`h = (1 - z) * n + z * h`, with `xw = x @ W_ih^T + b_ih` given. h is carried
in f32 and hs is rounded to the dtype on write. (The JAX `lax.scan` path
computes in the input dtype instead, which differs in bfloat16.) The
backward is `_gru_bwd_core`'s: the gates recomputed from the saved hs with
one matmul (on the card one `addmm` onto b_hh), the reverse recurrence in f32, `d_xw` rounded to xw's dtype,
`d_W_hh = h_prev^T @ d_hw` and `d_b_hh = sum d_hw` summed in f32 and rounded
to W's dtype. Both biases train, as in JAX.

Under autograd (grad mode on and an input that requires grad) the calls go
through `torch.autograd.Function`s; CPU tensors run the plain forward and
backward inside the same Functions, so CPU autograd computes what the card
computes. Serving calls, with no grad, launch the forward alone and save
nothing.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import load_library
from .lstm_scan import (  # the GRU plans by the LSTM's rule, over its own routes
    _PATH_CODE, FORWARD_ROUTES, _co_resident_clusters, _plan, _plan_bwd, _plan_launch, _tile_args,
)

# Launches of each CUDA kernel in this process. Only the launches below
# increment them; callers reset them to 0 to count a run.
LAUNCHES = {"gru_scan": 0, "gru_scan_bidir": 0, "gru_scan_bwd": 0, "gru_scan_bidir_bwd": 0}
# The forward launches above, split by the path `_plan` chose.
PATH_LAUNCHES = {name: {"mma": 0, "tf32x3": 0, "fma": 0}
                 for name in ("gru_scan", "gru_scan_bidir")}
# The backward launches above, split by the path `_plan_bwd` chose.
BWD_PATH_LAUNCHES = {name: {"tf32x3": 0, "tf32x2": 0, "fma": 0}
                     for name in ("gru_scan_bwd", "gru_scan_bidir_bwd")}

MAX_HIDDEN = 512
# The forward routes of this wrapper's library: no cluster kernel, so a GRU at
# H = 256 and B = 1 stays on "fma".
ROUTES = FORWARD_ROUTES
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None
_BWD_LIB = None


def _acc(x: torch.Tensor) -> torch.dtype:
    """The plain versions' working type: float32, or float64 for float64 inputs."""
    return torch.promote_types(x.dtype, torch.float32)


def gru_steps(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
              h: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The GRU recurrence one step at a time from state `h` (B, H) f32 (zeros if None).

    xw (B, T, 3H), w_hh (H, 3H), b_hh (3H,) -> (hs (B, T, H) in xw's dtype,
    final h (B, H) f32). Exact streaming carries `h` across calls with this
    loop; from a zero state it is the plain version of the kernels.
    `h.to(W.dtype).float() @ W.float()` keeps the bfloat16 products exact and
    sums them in f32, as the Pallas kernel does. (float64 inputs compute in
    float64, for gradient checks.)
    """
    B, T, three_h = xw.shape
    H = three_h // 3
    acc = _acc(xw)
    w, b = w_hh.to(acc), b_hh.to(acc)
    if h is None:
        h = torch.zeros((B, H), dtype=acc, device=xw.device)
    hs = torch.empty((B, T, H), dtype=xw.dtype, device=xw.device)
    for t in range(T):
        g = h.to(w_hh.dtype).to(acc) @ w + b
        x = xw[:, t].to(acc)
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


def _shifted(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H) -> the same one step later in time, with zeros at t = 0."""
    return F.pad(x[:, :-1], (0, 0, 1, 0))


def _hidden_gates(w_hh: torch.Tensor, b_hh: torch.Tensor, h_prev: torch.Tensor) -> torch.Tensor:
    """hw = f32(h_prev rounded to W's dtype) @ f32(W_hh) + f32(b_hh), one matmul -> (B, T, 3H)."""
    B, T, H = h_prev.shape
    acc = _acc(w_hh)
    h = h_prev.to(w_hh.dtype).to(acc).reshape(B * T, H)
    return (h @ w_hh.to(acc)).view(B, T, 3 * H) + b_hh.to(acc)


def _param_grads(h_prev, d_hw, w_hh, b_hh):
    """d_W_hh = h_prev^T @ d_hw and d_b_hh = sum of d_hw over every (b, t), summed in f32
    and rounded to the parameters' dtypes."""
    H, three_h = h_prev.shape[-1], d_hw.shape[-1]
    d_whh = h_prev.to(d_hw.dtype).reshape(-1, H).t() @ d_hw.reshape(-1, three_h)
    return d_whh.to(w_hh.dtype), d_hw.sum(dim=(0, 1)).to(b_hh.dtype)


def gru_scan_bwd_reference(xw, w_hh, b_hh, hs, g_hs):
    """Plain backward of `gru_scan`: the VJP of hs w.r.t. (xw, w_hh, b_hh).

    The math and roundings of `_gru_bwd_core` (`ops/pallas_lstm.py:431-465`):
    the recurrent pre-activations recomputed from `h_prev` (hs one step later,
    rounded to W's dtype) with one matmul; the reverse recurrence as a step
    loop in f32; `d_xw` rounded to xw's dtype, `d_whh` and `d_bhh` summed in
    f32 and rounded to W's dtype. Returns (d_xw, d_whh, d_bhh).
    """
    B, T, H = hs.shape
    acc = _acc(xw)
    h_prev = _shifted(hs)
    hw = _hidden_gates(w_hh, b_hh, h_prev)
    x = xw.to(acc)
    r = torch.sigmoid(x[..., :H] + hw[..., :H])
    z = torch.sigmoid(x[..., H:2 * H] + hw[..., H:2 * H])
    hn = hw[..., 2 * H:]
    n = torch.tanh(x[..., 2 * H:] + r * hn)
    hp = h_prev.to(acc)
    w_t = w_hh.to(acc).t()
    d_xw = torch.empty((B, T, 3 * H), dtype=acc, device=xw.device)
    d_hw = torch.empty_like(d_xw)
    dh_rec = torch.zeros((B, H), dtype=acc, device=xw.device)
    for t in reversed(range(T)):
        r_t, z_t, n_t = r[:, t], z[:, t], n[:, t]
        dh = g_hs[:, t].to(acc) + dh_rec
        da_z = dh * (hp[:, t] - n_t) * z_t * (1.0 - z_t)
        dn = dh * (1.0 - z_t) * (1.0 - n_t * n_t)
        da_r = dn * hn[:, t] * r_t * (1.0 - r_t)
        d_xw[:, t] = torch.cat([da_r, da_z, dn], dim=-1)
        d_hw[:, t] = torch.cat([da_r, da_z, dn * r_t], dim=-1)
        dh_rec = dh * z_t + d_hw[:, t] @ w_t
    return (d_xw.to(xw.dtype), *_param_grads(h_prev, d_hw, w_hh, b_hh))


def _library():
    global _LIB
    if _LIB is None:
        lib = load_library("gru_scan")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gru_scan_launch.argtypes = [p] * 4 + [i] * 7 + [p]
        lib.gru_scan_launch.restype = i
        lib.gru_scan_bidir_launch.argtypes = [p] * 8 + [i] * 7 + [p]
        lib.gru_scan_bidir_launch.restype = i
        lib.gru_scan_tf32_clusters.argtypes = [i, i, ctypes.POINTER(i)]
        lib.gru_scan_tf32_clusters.restype = i
        _LIB = lib
    return _LIB


def _bwd_library():
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = load_library("gru_scan_bwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gru_scan_bwd_launch.argtypes = [p] * 7 + [i] * 7 + [p]
        lib.gru_scan_bwd_launch.restype = i
        lib.gru_scan_bidir_bwd_launch.argtypes = [p] * 14 + [i] * 7 + [p]
        lib.gru_scan_bidir_bwd_launch.restype = i
        lib.gru_scan_bwd_tf32_clusters.argtypes = [i, i, ctypes.POINTER(i)]
        lib.gru_scan_bwd_tf32_clusters.restype = i
        _BWD_LIB = lib
    return _BWD_LIB


def build() -> None:
    """Build (or load) the forward kernels now instead of at their first launch."""
    _library()


def _tf32_clusters(H: int, device) -> dict:
    """{C: clusters of C blocks of this wrapper's 3xTF32 kernel at H the card holds at once}."""
    return _co_resident_clusters(_library().gru_scan_tf32_clusters, H, torch.device(device))


def build_backward() -> None:
    """Build (or load) the backward kernels now instead of at their first launch."""
    _bwd_library()


def _tf32_bwd_clusters(H: int, device) -> dict:
    """{C: clusters of C blocks of this wrapper's tensor-core backward at H the card holds
    at once}."""
    return _co_resident_clusters(_bwd_library().gru_scan_bwd_tf32_clusters, H,
                                 torch.device(device))


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


def _check_chains(name: str, chains) -> None:
    """Validate the (xw, w_hh, b_hh) triples of one launch: each, and one shape for all."""
    xw0 = chains[0][0]
    if xw0.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {xw0.device}")
    for xw, w_hh, b_hh in chains:
        _check(xw, w_hh, b_hh)
        if xw.shape != xw0.shape or xw.dtype != xw0.dtype or xw.device != xw0.device:
            raise ValueError(f"the two chains differ: {tuple(xw0.shape)} {xw0.dtype} "
                             f"{xw0.device} vs {tuple(xw.shape)} {xw.dtype} {xw.device}")


def _launch(name: str, fn, pointers, dtype, B, T, H, device, *plan) -> None:
    with torch.cuda.device(device):
        err = fn(*pointers, _DTYPE_CODE[dtype], B, T, H, *plan,
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _forward_cuda(chains, path: str | None = None):
    """Launch the forward kernel over one or two (xw, w_hh, b_hh) chains -> list of hs.

    `path` forces a path of `_plan` (only chip_smoke.py passes it, to time
    the FMA kernel where a tensor-core one would run).
    """
    name = "gru_scan" if len(chains) == 1 else "gru_scan_bidir"
    _check_chains(name, chains)
    xw0 = chains[0][0]
    lib = _library()
    B, T, H, path, tile = _plan_launch(_tf32_clusters, chains, path, routes=ROUTES)
    hs = [torch.empty((B, T, H), dtype=xw0.dtype, device=xw0.device) for _ in chains]
    fn = lib.gru_scan_launch if len(chains) == 1 else lib.gru_scan_bidir_launch
    pointers = [c[k].data_ptr() for k in range(3) for c in chains] + [h.data_ptr() for h in hs]
    _launch(name, fn, pointers, xw0.dtype, B, T, H, xw0.device, _PATH_CODE[path],
            *_tile_args(tile))
    PATH_LAUNCHES[name][path] += 1
    return hs


def _staged_hidden_gates(w_hh: torch.Tensor, b_hh: torch.Tensor,
                         h_prev: torch.Tensor) -> torch.Tensor:
    """`_hidden_gates` as the card stages it: one addmm with f32(b_hh) as the row added,
    where a matmul and an add make two more passes over (B, T, 3H) f32 (the same value;
    the sums may run in another order)."""
    B, T, H = h_prev.shape
    h = h_prev.to(w_hh.dtype).float().reshape(B * T, H)
    return torch.addmm(b_hh.float(), h, w_hh.float()).view(B, T, 3 * H)


def _staged_backward(chains, path: str | None = None):
    """Stage the backward kernel's inputs and outputs over one or two
    (xw, w_hh, b_hh, hs, g_hs) chains -> (staged arrays per chain, a call that launches it).

    `path` forces a path of `_plan_bwd` (only chip_smoke.py passes it, to time
    the FMA kernel where the tensor cores would run).
    """
    name = "gru_scan_bwd" if len(chains) == 1 else "gru_scan_bidir_bwd"
    _check_chains(name, [c[:3] for c in chains])
    xw0 = chains[0][0]
    B, T, H, path, tile = _plan_launch(_tf32_bwd_clusters, [c[:3] for c in chains], path,
                                       backward=True)
    staged = []
    for xw, w_hh, b_hh, hs, g_hs in chains:
        # Gradients come back through flip and cat: make them contiguous
        # before any data_ptr() (a no-op where they already are).
        hs, g_hs = hs.contiguous(), g_hs.contiguous()
        for what, t in (("hs", hs), ("g_hs", g_hs)):
            if t.shape != (B, T, H) or t.dtype != xw.dtype or t.device != xw.device:
                raise ValueError(f"{what} {tuple(t.shape)} {t.dtype} does not match xw "
                                 f"{tuple(xw.shape)} {xw.dtype}")
            if t.data_ptr() % 16:
                raise ValueError(f"{what} is not 16-byte aligned")
        h_prev = _shifted(hs)
        w = w_hh.t().contiguous() if path == "fma" else w_hh  # the FMA kernel reads W_hh^T
        staged.append((h_prev, xw, _staged_hidden_gates(w_hh, b_hh, h_prev), hs, g_hs, w,
                       torch.empty_like(xw),
                       torch.empty((B, T, 3 * H), dtype=torch.float32, device=xw.device)))
    lib = _bwd_library()
    fn = lib.gru_scan_bwd_launch if len(chains) == 1 else lib.gru_scan_bidir_bwd_launch

    def launch():  # reads `staged`, so the arrays live as long as the call
        pointers = [s[k].data_ptr() for k in range(1, 8) for s in staged]
        _launch(name, fn, pointers, xw0.dtype, B, T, H, xw0.device, _PATH_CODE[path],
                *_tile_args(tile))
        BWD_PATH_LAUNCHES[name][path] += 1

    return staged, launch


def _backward_cuda(chains, path: str | None = None):
    """The backward kernel over one or two (xw, w_hh, b_hh, hs, g_hs) chains ->
    [(d_xw, d_whh, d_bhh)]."""
    staged, launch = _staged_backward(chains, path)
    launch()
    return [(d_xw, *_param_grads(h_prev, d_hw, w_hh, b_hh))
            for (h_prev, *_, d_xw, d_hw), (_, w_hh, b_hh, *_) in zip(staged, chains)]


def _forward(chains):
    """Forward of one or two (xw, w_hh, b_hh) chains -> list of hs."""
    if chains[0][0].device.type == "cpu":
        return [gru_scan_reference(*c) for c in chains]
    return _forward_cuda(chains)


def _backward(chains):
    """Backward of one or two (xw, w_hh, b_hh, hs, g_hs) chains -> [(d_xw, d_whh, d_bhh)]."""
    if chains[0][0].device.type == "cpu":
        return [gru_scan_bwd_reference(*c) for c in chains]
    return _backward_cuda(chains)


class _GRUScan(torch.autograd.Function):
    """`gru_scan` under autograd: the forward kernel, then the reverse recurrence."""

    @staticmethod
    def forward(ctx, xw, w_hh, b_hh):
        (hs,) = _forward([(xw, w_hh, b_hh)])
        ctx.save_for_backward(xw, w_hh, b_hh, hs)
        return hs

    @staticmethod
    def backward(ctx, g_hs):
        ((d_xw, d_whh, d_bhh),) = _backward([(*ctx.saved_tensors, g_hs)])
        return d_xw, d_whh, d_bhh


class _GRUScanBidir(torch.autograd.Function):
    """`gru_scan_bidir` under autograd: both chains in one launch each way."""

    @staticmethod
    def forward(ctx, xw_f, xw_b, whh_f, whh_b, bhh_f, bhh_b):
        hs_f, hs_b = _forward([(xw_f, whh_f, bhh_f), (xw_b, whh_b, bhh_b)])
        ctx.save_for_backward(xw_f, xw_b, whh_f, whh_b, bhh_f, bhh_b, hs_f, hs_b)
        return hs_f, hs_b

    @staticmethod
    def backward(ctx, g_f, g_b):
        xw_f, xw_b, whh_f, whh_b, bhh_f, bhh_b, hs_f, hs_b = ctx.saved_tensors
        (dx_f, dw_f, db_f), (dx_b, dw_b, db_b) = _backward(
            [(xw_f, whh_f, bhh_f, hs_f, g_f), (xw_b, whh_b, bhh_b, hs_b, g_b)])
        return dx_f, dx_b, dw_f, dw_b, db_f, db_b


def _recording(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def gru_scan(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """Fused GRU recurrence: xw (B, T, 3H) = x W_ih^T + b_ih, w_hh (H, 3H), b_hh (3H,) -> hs.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. Under autograd the backward kernel computes the gradients.
    """
    if _recording(xw, w_hh, b_hh):
        return _GRUScan.apply(xw, w_hh, b_hh)
    return _forward([(xw, w_hh, b_hh)])[0]


def gru_scan_bidir(xw_f: torch.Tensor, xw_b: torch.Tensor, whh_f: torch.Tensor,
                   whh_b: torch.Tensor, bhh_f: torch.Tensor,
                   bhh_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Both chains of a bidirectional GRU layer in one launch.

    xw_f (B, T, 3H): forward input projections (b_ih included); xw_b: the
    backward chain's over the TIME-REVERSED sequence. Returns (hs_f, hs_b),
    hs_b in reversed time order (flip it back outside), as the Pallas kernel
    does. CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise. Under autograd the backward kernel computes the gradients.
    """
    if _recording(xw_f, xw_b, whh_f, whh_b, bhh_f, bhh_b):
        return _GRUScanBidir.apply(xw_f, xw_b, whh_f, whh_b, bhh_f, bhh_b)
    hs_f, hs_b = _forward([(xw_f, whh_f, bhh_f), (xw_b, whh_b, bhh_b)])
    return hs_f, hs_b
