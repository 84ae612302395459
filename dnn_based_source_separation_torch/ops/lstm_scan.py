"""Fused LSTM recurrences: one chain (`lstm_scan`) and two in one launch (`lstm_scan_bidir`).

Port of `dnn_based_source_separation_tpu/ops/pallas_lstm.py:lstm_scan` and
`lstm_scan_bidir`, with their `jax.custom_vjp` backward (`_lstm_bwd_core`).
On CUDA tensors the hand-written Hopper kernels run: the forward of
`csrc/lstm_scan.cu` and, under autograd, the reverse recurrence of
`csrc/lstm_scan_bwd.cu`. On CPU tensors the plain PyTorch versions do.
There is no fallback from one to the other: a CUDA call the kernel cannot
take raises.

The forward has five paths, and `_plan` picks one from the dtype, the
shape and the card's co-resident clusters before the launch: for H a
multiple of 16 up to 128 the tensor-core kernels, `"mma"`
(`csrc/recurrence_mma.cuh`) for bfloat16 and `"tf32x3"`
(`csrc/recurrence_tf32.cuh`, f32 products as three TF32 products, a cluster
of 2 or 4 blocks per tile) for float32; for H = 256 and many sequences
(DPTNet's 5112 and 800) `"wide"` (`csrc/recurrence_wide.cuh`: an M-row tile a
cluster of C blocks, W_hh split over their shared memory, the product on the
tensor cores, mma.sync bf16 or 3xTF32), in either dtype; for H = 256, 384 or
512 and few sequences (musdb18 serving's B = 1) `"cluster"`
(`csrc/recurrence_cluster.cuh`: one sequence a cluster of 8 or 16 blocks,
W_hh held in their registers and shared memory, h exchanged through
distributed shared memory), in either dtype, and for 384 < H < 512
(LSTM-TasNet's H = 500) the same kernel at H = 512 on a zero-padded call;
the FMA kernel (`"fma"`) for every other call (H = 40, 256 < H < 384, H = 384
and 512 past the cluster route, ...). The backward has four, which `_plan_bwd`
picks the same way: for H a multiple of 16 up to 128 the split-TF32
tensor-core kernel of `csrc/recurrence_bwd_tf32.cuh` (`"tf32x3"` for
float32, three TF32 products; `"tf32x2"` for bfloat16, two, since a bf16
W_hh is a TF32 value), on clusters of 2 or 4 blocks; for H = 256 and many
sequences (DPTNet training's 1278 and 200) `"wide"`
(`csrc/recurrence_wide_bwd.cuh`: an M-row tile a cluster of C blocks, each
rank's gate columns of W_hh on chip, the product in split TF32 on the tensor
cores, its partial sums reduce-scattered between the ranks), in either dtype;
for H = 256, 384 or 512 and few sequences (musdb18 training's B = 16) `"cluster"`
(`csrc/recurrence_cluster_bwd.cuh`: the forward's design, one sequence a cluster
of 8 or 16 blocks with W_hh's rows of each rank's units on chip, da exchanged
through distributed shared memory), in either dtype, padded as the forward is
for 384 < H < 512; the FMA kernel (`"fma"`) for every other call.

The padded calls (`cluster_width`) are exact. The four gate blocks of xw and
of W_hh's columns, and W_hh's rows, are zero-padded to H = 512 (`pad_chain`).
A padded unit's gate pre-activations are then 0 at every step, so its c stays
sigmoid(0) c + sigmoid(0) tanh(0) = 0 from c = 0 and its h = sigmoid(0) tanh(0)
= 0, and a real unit's sums gain only products with a zero factor. In the
backward a padded unit's cotangent is 0 and its row of W_hh is 0, so its dh,
dc and every gate's da stay 0, and the real das are the unpadded ones. The
results are sliced back: hs and cs to their first H units, d_xw gate block by
gate block (`unpad_gates`), d_W_hh to the first H rows of each gate block's
first H columns (`unpad_weight_grad`).

Semantics are the Pallas kernels', in both dtypes: gates are
`f32(xw[t]) + f32(h rounded to W's dtype) @ f32(W)`, h and c are carried in
f32, and hs (and cs, for the backward) are rounded to the dtype on write.
(The JAX `lax.scan` path computes in the input dtype instead, which differs
in bfloat16.) The backward is `_lstm_bwd_core`'s: gates recomputed from the
saved hs with one matmul (on the card one `addmm` onto xw), the reverse
recurrence in f32 reading the saved cs, `d_xw` rounded to xw's dtype (by
the kernel, beside the f32 das) and `d_W_hh = h_prev^T @ das` summed in f32
and rounded to W's dtype.

Under autograd (grad mode on and an input that requires grad) the calls go
through `torch.autograd.Function`s whose forward also writes cs; CPU tensors
run the plain forward and backward inside the same Functions, so CPU
autograd computes what the card computes. Serving calls, with no grad,
launch the forward alone and write no cs.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import load_library

# Launches of each CUDA kernel in this process. Only the launches below
# increment them; callers reset them to 0 to count a run.
LAUNCHES = {"lstm_scan": 0, "lstm_scan_bidir": 0, "lstm_scan_bwd": 0, "lstm_scan_bidir_bwd": 0}
# The forward launches above, split by the path `_plan` chose.
PATH_LAUNCHES = {name: {"mma": 0, "tf32x3": 0, "cluster": 0, "wide": 0, "fma": 0}
                 for name in ("lstm_scan", "lstm_scan_bidir")}
# The backward launches above, split by the path `_plan_bwd` chose.
BWD_PATH_LAUNCHES = {name: {"tf32x3": 0, "tf32x2": 0, "cluster": 0, "wide": 0, "fma": 0}
                     for name in ("lstm_scan_bwd", "lstm_scan_bidir_bwd")}
# The launches above that ran a cluster kernel on a zero-padded call (`cluster_width`), by
# kernel: a part of their "cluster" counts.
PADDED_LAUNCHES = dict.fromkeys(LAUNCHES, 0)

MAX_HIDDEN = 512
# The tensor-core paths' widest H: bf16 W_hh as mma B fragments takes G H^2 / 2
# registers a block; the f32 W_hh of one block of a 2-block cluster, G H^2 / 2
# floats of shared memory.
MMA_MAX_HIDDEN = 128
_PATH_CODE = {"fma": 0, "mma": 1, "tf32x3": 2, "tf32x2": 3, "cluster": 4, "wide": 5}
# The routes of each wrapper's libraries: `_plan` and `_plan_bwd` take only these.
# The GRU's have no cluster kernel, forward or backward, and no wide kernel.
FORWARD_ROUTES = ("fma", "mma", "tf32x3")
ROUTES = FORWARD_ROUTES + ("cluster", "wide")
# The tensor-core path of each dtype, for H a multiple of 16 up to MMA_MAX_HIDDEN:
# of the forward, and of the backward (split TF32 in both dtypes).
_TENSOR_CORE_PATH = {torch.bfloat16: "mma", torch.float32: "tf32x3"}
_BWD_TENSOR_CORE_PATH = {torch.bfloat16: "tf32x2", torch.float32: "tf32x3"}
# The tensor-core backward's tile rows (32 spilled to the stack, PERF.md).
BWD_TILE_ROWS = (16,)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None
_BWD_LIB = None
# The 3xTF32 kernel's cluster sizes: C blocks share a tile's H units, H / C each.
TF32_CLUSTER_SIZES = (2, 4)
# (C function, card, H) -> {C: co-resident clusters of C blocks of that kernel}.
_CLUSTERS: dict = {}

# The cluster kernel (csrc/recurrence_cluster.cuh): one sequence of one chain
# a cluster of C blocks, rank r owning hidden units [r H/C, (r+1) H/C) and
# their four gate columns, CLUSTER_UNITS_PER_WARP units a warp. Lane l of a
# warp owns rows 128 jb + 4 l + e (e = 0..3) of each row block jb; the first
# CLUSTER_REG_BLOCKS row blocks of its W_hh values live in registers, the rest
# in shared memory, beside two mbarriers, the double-buffered h and a padded f32
# staging tile.
CLUSTER_SIZES = (8, 16)
CLUSTER_ROW_BLOCK = 128
# Hidden sizes above this one, below MAX_HIDDEN and off the multiples of CLUSTER_ROW_BLOCK
# run the cluster kernels zero-padded to MAX_HIDDEN (`cluster_width`). 256 < H < 384 would
# pad to 384 and stays on the FMA kernel: DANet's, ADANet's and deep clustering's H = 300
# sit there (chip_smoke.py phase 16k times them beside cuDNN, PERF.md section 6).
PADDED_ABOVE = 384
CLUSTER_REG_BLOCKS = 2
CLUSTER_UNITS_PER_WARP = 2
CLUSTER_MAX_THREADS = 512
SHARED_LIMIT = 232448  # a Hopper block's dynamic shared memory
OWN_SM = 120 * 1024  # a block's least shared memory: no two blocks on one SM
# The largest B the plan sends to the cluster kernel: on an H100 (PERF.md, section 6)
# it beat the FMA kernel at every B up to 256 and lost at 512 (H = 256, two
# chains) and at 1024 (H = 512, one chain).
CLUSTER_MAX_BATCH = 256
# The cluster backward (csrc/recurrence_cluster_bwd.cuh): the forward's ranks, units
# and warps; lane l of a warp owns da values 128 jb + 4 l + q (unit 32 jb + l, gate q)
# of each row block jb of the 4H, and W_hh[its warp's units, q H + 32 jb + l]; the
# first CLUSTER_BWD_REG_BLOCKS row blocks (64 floats) in registers, the rest in shared
# memory beside two mbarriers and the double-buffered da.
CLUSTER_BWD_REG_BLOCKS = 8
# The largest B the plan sends to the cluster backward: on an H100 at T = 259 (PERF.md,
# section 6) it beat the FMA backward at every B up to 256 and lost at 512 (H = 256,
# two chains: by 5% at B = 128 and 256; H = 512, one chain: by 33-35%).
CLUSTER_MAX_BATCH_BWD = 256
# The wide kernel (csrc/recurrence_wide.cuh): an M-row tile of sequences of one chain a
# cluster of C blocks at H = WIDE_HIDDEN, rank r owning hidden units [r H/C, (r+1) H/C)
# and their four gate columns, 8 units a warp; warps also split the rows, 16 a warp, or
# 32 in f32 (one split of W serves two m16 tiles) and where 16 would pass WIDE_MAX_WARPS
# warps. Each rank's H x 4H/C slice of W_hh in shared memory beside two mbarriers and
# h [2][C][M][H/C + 16 bytes] (each rank's columns one block).
WIDE_HIDDEN = 256
WIDE_TILE_ROWS = (16, 32, 64)
WIDE_CLUSTER_SIZES = {torch.bfloat16: (4, 8), torch.float32: (8, 16)}
WIDE_MAX_WARPS = 16
# The least B at which the plan takes the wide kernel over the cluster kernel (H = 256),
# by dtype and chains: the least B of chip_smoke.py phase 3i's sweep (B = 1, 4, 16, 64,
# 128, 200, 256, 512 at T = 259 and 639, kernels alone) from which the wide kernel won at
# every larger B, on an H100 (PERF.md, section 6). f32, one chain: at B = 16 the cluster
# kernel took 0.4262 / 0.9853 ms (T = 259 / 639) against 0.9951 / 2.4300, at 64 wide
# 1.0179 / 2.4355 against 1.1500 / 2.6787; two chains: at 16 cluster 0.6872 / 1.6272
# against 1.0044 / 2.4498, at 64 wide 1.0522 / 2.5489 against 2.1524 / 4.9490. bf16, one
# chain: at 4 cluster 0.1976 / 0.4532 against 0.3678 / 0.8810, at 16 wide 0.3904 / 0.9641
# against 0.4295 / 0.9942; two chains: at 4 cluster 0.2165 / 0.5007 against 0.3733 /
# 0.8896, at 16 wide 0.3931 / 0.9664 against 0.6546 / 1.5957.
WIDE_MIN_BATCH = {(torch.float32, 1): 64, (torch.float32, 2): 64,
                  (torch.bfloat16, 1): 16, (torch.bfloat16, 2): 16}
# The wide backward (csrc/recurrence_wide_bwd.cuh): the forward's tiles, cluster sizes and
# ranks; WIDE_BWD_WARPS warps a block, each over H / WIDE_BWD_WARPS output units of the
# product and, in the first (M / 16) (H / 8C) warps, the cell of 16 rows x 8 units. Each
# rank's H x 4H/C slice of W_hh in shared memory beside two mbarriers, the da tile
# [M][4H/C + WIDE_BWD_PAD_DA] f32 and the receive tile [2][C][M][H/C + WIDE_BWD_PAD_BLOCK]
# f32 (block r of a buffer what rank r summed for this rank's units).
WIDE_BWD_WARPS = 8
WIDE_BWD_PAD_DA = 4
WIDE_BWD_PAD_BLOCK = 8
# The least B at which the backward plan takes the wide kernel over the cluster backward
# (H = 256), by dtype and chains: the least B of chip_smoke.py phase 3j's sweep (B = 1, 4,
# 16, 32, 64, 128, 256, 512 at T = 259 and 639, kernels alone) from which the wide kernel
# won at every larger B, on an H100 (PERF.md, section 6). f32, one chain: at B = 32 the
# cluster backward took 0.7574 / 1.8002 ms (T = 259 / 639) against 0.8233 / 2.0050, at 64
# wide 0.8276 / 2.0198 against 1.2659 / 3.0352; two chains: at 16 cluster 0.7570 / 1.8165
# against 0.8243 / 2.0243 (musdb18 training's B = 16 stays), at 32 wide 0.8288 / 2.0274
# against 1.2662 / 3.0529. bf16, one chain: at 32 cluster 1.0658 ms at T = 259 against
# 1.1375; two chains: at 16 cluster 1.0774 / 2.6135 against 1.1489 / 2.7743, at 32 wide
# 1.1440 / 2.7820 against 1.7891 / 4.3608.
WIDE_MIN_BATCH_BWD = {(torch.float32, 1): 64, (torch.float32, 2): 32,
                      (torch.bfloat16, 1): 64, (torch.bfloat16, 2): 32}


def lstm_steps(xw: torch.Tensor, w_hh: torch.Tensor, state=None, cs: torch.Tensor | None = None):
    """The LSTM recurrence one step at a time from `state` = (h, c), (B, H) f32 each.

    xw (B, T, 4H), w_hh (H, 4H) -> (hs (B, T, H) in xw's dtype, final (h, c)
    f32); a None state is zeros. Torch gate order i, f, g, o. Exact streaming
    carries the state across calls with this loop; from a zero state it is
    the plain version of the kernels. `h.to(W.dtype).float() @ W.float()`
    keeps the bfloat16 products exact and sums them in f32, as the Pallas
    kernel does (a bfloat16 matmul would round its output to bfloat16).
    `cs`, a (B, T, H) tensor of xw's dtype, receives each step's c if given.
    (float64 inputs compute in float64, for gradient checks.)
    """
    B, T, four_h = xw.shape
    H = four_h // 4
    acc = _acc(xw)
    w = w_hh.to(acc)
    if state is None:
        h = torch.zeros((B, H), dtype=acc, device=xw.device)
        c = torch.zeros_like(h)
    else:
        h, c = state
    hs = torch.empty((B, T, H), dtype=xw.dtype, device=xw.device)
    for t in range(T):
        gates = xw[:, t].to(acc) + h.to(w_hh.dtype).to(acc) @ w
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs[:, t] = h
        if cs is not None:
            cs[:, t] = c
    return hs, (h, c)


def lstm_scan_reference(xw: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Plain version of `lstm_scan`: xw (B, T, 4H), w_hh (H, 4H) -> hs (B, T, H), zero state."""
    return lstm_steps(xw, w_hh)[0]


def lstm_scan_bidir_reference(xw_f, xw_b, whh_f, whh_b):
    """Plain version of `lstm_scan_bidir`: two independent chains."""
    return lstm_scan_reference(xw_f, whh_f), lstm_scan_reference(xw_b, whh_b)


def lstm_forward_reference(xw: torch.Tensor, w_hh: torch.Tensor):
    """Plain version of the training forward: (hs, cs), each (B, T, H) in xw's dtype."""
    cs = torch.empty(xw.shape[:2] + (w_hh.shape[0],), dtype=xw.dtype, device=xw.device)
    return lstm_steps(xw, w_hh, cs=cs)[0], cs


def _acc(x: torch.Tensor) -> torch.dtype:
    """The plain versions' working type: float32, or float64 for float64 inputs."""
    return torch.promote_types(x.dtype, torch.float32)


def _shifted(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H) -> the same one step later in time, with zeros at t = 0."""
    return F.pad(x[:, :-1], (0, 0, 1, 0))


def _gates(xw: torch.Tensor, w_hh: torch.Tensor, h_prev: torch.Tensor) -> torch.Tensor:
    """Gate pre-activations f32(xw) + f32(h_prev rounded to W's dtype) @ f32(W), one matmul."""
    B, T, four_h = xw.shape
    acc = _acc(xw)
    h = h_prev.to(w_hh.dtype).to(acc).reshape(B * T, -1)
    return xw.to(acc) + (h @ w_hh.to(acc)).view(B, T, four_h)


def _weight_grad(h_prev: torch.Tensor, das: torch.Tensor, dtype) -> torch.Tensor:
    """d_W_hh = h_prev^T @ das over every (b, t), summed in f32, rounded to W's dtype."""
    H, four_h = h_prev.shape[-1], das.shape[-1]
    return (h_prev.to(das.dtype).reshape(-1, H).t() @ das.reshape(-1, four_h)).to(dtype)


def lstm_scan_bwd_reference(xw, w_hh, hs, cs, g_hs):
    """Plain backward of `lstm_scan`: the VJP of hs w.r.t. (xw, w_hh) -> (d_xw, d_whh).

    The math and roundings of `_lstm_bwd_core` (`ops/pallas_lstm.py:182-227`):
    the gates recomputed from `h_prev` (hs one step later, rounded to W's
    dtype) with one matmul; tanh(c) and c_prev from `cs` as saved in the input
    dtype; `W_hh^T` in f32; the reverse recurrence as a step loop in f32;
    `d_xw` rounded to xw's dtype and `d_whh` summed in f32, rounded to W's dtype.
    """
    B, T, H = hs.shape
    h_prev = _shifted(hs)
    gi, gf, gg, go = _gates(xw, w_hh, h_prev).chunk(4, dim=-1)
    gi, gf, gg, go = torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg), torch.sigmoid(go)
    acc = _acc(xw)
    tc = torch.tanh(cs.to(acc))
    c_prev = _shifted(cs).to(acc)
    w_t = w_hh.to(acc).t()
    das = torch.empty((B, T, 4 * H), dtype=acc, device=xw.device)
    dh_rec = torch.zeros((B, H), dtype=acc, device=xw.device)
    dc_rec = torch.zeros_like(dh_rec)
    for t in reversed(range(T)):
        i, f, g, o, c = gi[:, t], gf[:, t], gg[:, t], go[:, t], tc[:, t]
        dh = g_hs[:, t].to(acc) + dh_rec
        da_o = dh * c * o * (1.0 - o)
        dc = dc_rec + dh * o * (1.0 - c * c)
        da_i = dc * g * i * (1.0 - i)
        da_f = dc * c_prev[:, t] * f * (1.0 - f)
        da_g = dc * i * (1.0 - g * g)
        da = torch.cat([da_i, da_f, da_g, da_o], dim=-1)
        das[:, t] = da
        dh_rec = da @ w_t
        dc_rec = dc * f
    return das.to(xw.dtype), _weight_grad(h_prev, das, w_hh.dtype)


def pad_gates(x: torch.Tensor, width: int) -> torch.Tensor:
    """(..., 4H) -> (..., 4 width): each gate block (i, f, g, o) zero-padded from H units
    to `width`."""
    H = x.shape[-1] // 4
    return F.pad(x.unflatten(-1, (4, H)), (0, width - H)).flatten(-2)


def unpad_gates(x: torch.Tensor, H: int) -> torch.Tensor:
    """(..., 4 width) -> (..., 4H): the first H units of each gate block (a copy, or x
    itself where width = H)."""
    return x.unflatten(-1, (4, x.shape[-1] // 4))[..., :H].flatten(-2)


def pad_chain(xw: torch.Tensor, w_hh: torch.Tensor, width: int):
    """One chain's xw (B, T, 4H) and W_hh (H, 4H) zero-padded to hidden size `width`:
    xw's gate blocks, W_hh's gate blocks and its rows -> ((B, T, 4 width), (width, 4 width))."""
    H = w_hh.shape[0]
    return pad_gates(xw, width), F.pad(pad_gates(w_hh, width), (0, 0, 0, width - H))


def pad_backward_chain(chain, width: int):
    """A backward chain (xw, w_hh, hs, cs, g_hs) zero-padded to hidden size `width`:
    xw and W_hh by `pad_chain`, the units of hs, cs and g_hs (B, T, H) -> (B, T, width)."""
    xw, w_hh, *per_unit = chain
    H = w_hh.shape[0]
    return (*pad_chain(xw, w_hh, width), *(F.pad(t, (0, width - H)) for t in per_unit))


def unpad_weight_grad(d_whh: torch.Tensor, H: int) -> torch.Tensor:
    """d_W_hh (width, 4 width) -> (H, 4H): the first H rows of each gate block's first H
    columns (the padded ones are 0)."""
    return unpad_gates(d_whh[:H], H)


def cluster_width(H: int) -> int:
    """The hidden size at which the cluster kernels take hidden size H: MAX_HIDDEN for
    PADDED_ABOVE < H < MAX_HIDDEN off the multiples of CLUSTER_ROW_BLOCK (LSTM-TasNet's
    500: the call zero-padded, which is exact, see the module docstring), else H."""
    if H % CLUSTER_ROW_BLOCK and PADDED_ABOVE < H < MAX_HIDDEN:
        return MAX_HIDDEN
    return H


def launch_width(H: int, path: str) -> int:
    """The hidden size a launch on `path` (a plan's) runs at: `cluster_width` on the
    cluster kernels, H on every other."""
    return cluster_width(H) if path == "cluster" else H


def _tensor_core_path(H: int, dtype: torch.dtype, backward: bool = False) -> str | None:
    """The tensor-core path of a call at H in `dtype` (of the backward if `backward`), or
    None where only the FMA kernel runs."""
    paths = _BWD_TENSOR_CORE_PATH if backward else _TENSOR_CORE_PATH
    return paths.get(dtype) if H % 16 == 0 and 16 <= H <= MMA_MAX_HIDDEN else None


def _cluster_ranks(H: int, C: int) -> tuple[int, int] | None:
    """(units, warps) of a rank of either cluster kernel at hidden size H on clusters of
    C blocks, or None: H a multiple of 128 above MMA_MAX_HIDDEN up to MAX_HIDDEN; C in
    CLUSTER_SIZES with H / C units a rank, CLUSTER_UNITS_PER_WARP a warp, at most
    CLUSTER_MAX_THREADS threads (128 registers each, 64 of them W_hh)."""
    if (H % CLUSTER_ROW_BLOCK or not MMA_MAX_HIDDEN < H <= MAX_HIDDEN or C not in CLUSTER_SIZES
            or H % (CLUSTER_UNITS_PER_WARP * C)):
        return None
    units = H // C
    warps = units // CLUSTER_UNITS_PER_WARP
    return None if 32 * warps > CLUSTER_MAX_THREADS else (units, warps)


def cluster_layout(H: int, C: int, dtype: torch.dtype = torch.float32) -> dict | None:
    """The cluster kernel's layout at hidden size H on clusters of C blocks, or None
    where it cannot run (`shape_ok` of csrc/recurrence_cluster.cuh).

    The ranks of `_cluster_ranks`; the shared memory within SHARED_LIMIT in f32
    (bf16 W rows take half).
    """
    ranks = _cluster_ranks(H, C)
    if ranks is None:
        return None
    units, warps = ranks
    row_blocks = H // CLUSTER_ROW_BLOCK
    reg_blocks = min(row_blocks, CLUSTER_REG_BLOCKS)
    elem = torch.tensor([], dtype=dtype).element_size()

    def shared(size):
        need = (16 + 2 * H * 4 + (row_blocks - reg_blocks) * CLUSTER_ROW_BLOCK * 4 * units * size
                + CLUSTER_ROW_BLOCK * (4 * units + 1) * 4)
        return max(need, OWN_SM)

    if shared(4) > SHARED_LIMIT:
        return None
    return dict(units=units, warps=warps, threads=32 * warps, row_blocks=row_blocks,
                reg_blocks=reg_blocks,
                w_smem_bytes=(row_blocks - reg_blocks) * CLUSTER_ROW_BLOCK * 4 * units * elem,
                smem_bytes=shared(elem))


def cluster_bwd_layout(H: int, C: int, dtype: torch.dtype = torch.float32) -> dict | None:
    """The cluster backward's layout at hidden size H on clusters of C blocks, or None
    where it cannot run (`shape_ok` of csrc/recurrence_cluster_bwd.cuh).

    The forward's ranks (`_cluster_ranks`); K = 4H in row blocks of
    CLUSTER_ROW_BLOCK values (eight W values a thread each), the first
    CLUSTER_BWD_REG_BLOCKS in registers; the shared memory (two mbarriers, da
    [2][4H] f32, the other row blocks' W) within SHARED_LIMIT in f32.
    """
    ranks = _cluster_ranks(H, C)
    if ranks is None:
        return None
    units, warps = ranks
    row_blocks = 4 * H // CLUSTER_ROW_BLOCK
    reg_blocks = min(row_blocks, CLUSTER_BWD_REG_BLOCKS)
    elem = torch.tensor([], dtype=dtype).element_size()

    def shared(size):
        need = 16 + 2 * 4 * H * 4 + (row_blocks - reg_blocks) * CLUSTER_ROW_BLOCK * units * size
        return max(need, OWN_SM)

    if shared(4) > SHARED_LIMIT:
        return None
    return dict(units=units, warps=warps, threads=32 * warps, row_blocks=row_blocks,
                reg_blocks=reg_blocks,
                w_smem_bytes=(row_blocks - reg_blocks) * CLUSTER_ROW_BLOCK * units * elem,
                smem_bytes=shared(elem))


def wide_layout(H: int, M: int, C: int, dtype: torch.dtype = torch.float32) -> dict | None:
    """The wide kernel's layout at hidden size H, tile M and clusters of C blocks, or None
    where it cannot run (`shape_ok` and `Geometry` of csrc/recurrence_wide.cuh).

    H = WIDE_HIDDEN; C in WIDE_CLUSTER_SIZES[dtype]; M in WIDE_TILE_ROWS. A rank owns
    H / C units, 8 a warp (warps over units), and the M / 16 m16 tiles go to warps over
    rows, `tiles_per_warp` each: 2 where one would pass WIDE_MAX_WARPS warps, and in f32
    wherever the tile has two (each split of W then serves both), else 1. The shared
    memory (two mbarriers, the rank's H x 4H/C slice of W_hh, h [2][C][M][H/C + 16
    bytes] in the dtype) within SHARED_LIMIT, and at least OWN_SM.
    """
    if (H != WIDE_HIDDEN or M not in WIDE_TILE_ROWS
            or C not in WIDE_CLUSTER_SIZES.get(dtype, ())):
        return None
    elem = torch.tensor([], dtype=dtype).element_size()
    units = H // C
    unit_warps, m_tiles = units // 8, M // 16
    if unit_warps * m_tiles > WIDE_MAX_WARPS:
        per_warp = unit_warps * m_tiles // WIDE_MAX_WARPS
    else:
        per_warp = 2 if elem == 4 and m_tiles >= 2 else 1
    warps = unit_warps * (m_tiles // per_warp)
    w_bytes = H * 4 * units * elem
    h_bytes = 2 * M * (H * elem + 16 * C)
    need = 16 + w_bytes + h_bytes
    if need > SHARED_LIMIT:
        return None
    return dict(units=units, warps=warps, threads=32 * warps, tiles_per_warp=per_warp,
                w_smem_bytes=w_bytes, h_smem_bytes=h_bytes, smem_bytes=max(need, OWN_SM))


def wide_bwd_layout(H: int, M: int, C: int, dtype: torch.dtype = torch.float32) -> dict | None:
    """The wide backward's layout at hidden size H, tile M and clusters of C blocks, or None
    where it cannot run (`shape_ok` and `smem_bytes` of csrc/recurrence_wide_bwd.cuh).

    H = WIDE_HIDDEN; C in WIDE_CLUSTER_SIZES[dtype]; M in WIDE_TILE_ROWS. A rank owns
    H / C units and their 4H / C gate columns (the product's K); WIDE_BWD_WARPS warps, at
    most one cell tile (16 rows x 8 units) each. The shared memory (two mbarriers, the
    rank's H x 4H/C slice of W_hh in the dtype, the da tile and the receive tile in f32)
    within SHARED_LIMIT, and at least OWN_SM.
    """
    if (H != WIDE_HIDDEN or M not in WIDE_TILE_ROWS
            or C not in WIDE_CLUSTER_SIZES.get(dtype, ())):
        return None
    elem = torch.tensor([], dtype=dtype).element_size()
    units = H // C
    columns = 4 * units
    cell_tiles = M // 16 * (units // 8)
    w_bytes = H * columns * elem
    da_bytes = 4 * M * (columns + WIDE_BWD_PAD_DA)
    block_bytes = 4 * M * (units + WIDE_BWD_PAD_BLOCK)
    recv_bytes = 2 * C * block_bytes
    need = 16 + w_bytes + da_bytes + recv_bytes
    if need > SHARED_LIMIT or cell_tiles > WIDE_BWD_WARPS:
        return None
    return dict(units=units, columns=columns, warps=WIDE_BWD_WARPS,
                threads=32 * WIDE_BWD_WARPS, cell_tiles=cell_tiles,
                n_tiles_per_warp=H // 8 // WIDE_BWD_WARPS, block_bytes=block_bytes,
                sent_bytes=(C - 1) * block_bytes, w_smem_bytes=w_bytes, da_smem_bytes=da_bytes,
                recv_smem_bytes=recv_bytes, smem_bytes=max(need, OWN_SM))


def _wide_tiles(H: int, dtype: torch.dtype, backward: bool = False) -> list:
    """The tiles (M, C) at which the wide kernel (the backward's if `backward`) takes hidden
    size H in `dtype`."""
    layout = wide_bwd_layout if backward else wide_layout
    return [(m, c) for c in WIDE_CLUSTER_SIZES.get(dtype, ()) for m in WIDE_TILE_ROWS
            if layout(H, m, c, dtype)]


def _wide_tile(B: int, n_chains: int, H: int, dtype: torch.dtype, wide: dict | None,
               forced: bool = False, backward: bool = False) -> tuple[int, int] | None:
    """The wide kernel's tile (M, C), or None: the forward's, or the backward's if
    `backward`.

    Of the tiles H admits in `dtype` and the card holds (`wide`, {(M, C):
    co-resident clusters of the kernel at that tile}, 0 where no GPC has C free
    SMs), `_tf32_tile`'s rule: the fewest waves, then the fewest rows x units a
    block (M / C), then the smaller cluster and tile. The plan takes the route for
    B from WIDE_MIN_BATCH[(dtype, n_chains)] up (the backward's WIDE_MIN_BATCH_BWD);
    forced (`path="wide"`) it runs any B, and raises where no tile can run.
    """
    options = [(-(-(n_chains * -(-B // m)) // wide[(m, c)]), m / c, c, m)
               for m, c in _wide_tiles(H, dtype, backward) if (wide or {}).get((m, c), 0) >= 1]
    if not options:
        if forced:
            raise ValueError(f"the wide path takes H = {WIDE_HIDDEN} in bfloat16 (clusters of "
                             f"4 or 8 blocks) or float32 (8 or 16) that the card holds; got "
                             f"H = {H}, {dtype}, clusters {wide}")
        return None
    least = (WIDE_MIN_BATCH_BWD if backward else WIDE_MIN_BATCH)[(dtype, n_chains)]
    if not forced and B < least:
        return None
    *_, c, m = min(options)
    return m, c


def _cluster_sizes(H: int, dtype: torch.dtype = torch.float32, backward: bool = False) -> list:
    """The cluster sizes at which the cluster kernel (the backward's if `backward`) takes
    hidden size H."""
    layout = cluster_bwd_layout if backward else cluster_layout
    return [c for c in CLUSTER_SIZES if layout(H, c, dtype)]


def _cluster_tile(B: int, n_chains: int, H: int, dtype: torch.dtype, clusters: dict | None,
                  forced: bool = False, backward: bool = False) -> tuple[int, int] | None:
    """The cluster kernel's tile (1, C): one sequence a cluster of C blocks, or None.

    Of the C that H admits and the card holds (`clusters`, {C: co-resident
    clusters}, 0 where no GPC has C free SMs), the one that runs the
    n_chains x B clusters in the fewest waves, then the larger (at H = 256
    and B = 1, C = 16 took 8% less time than C = 8 on an H100; C = 8 fits
    twice the clusters in a wave). The forward's kernel, or the backward's if
    `backward`, by the same rule.
    The plan takes the route for B up to CLUSTER_MAX_BATCH (the backward's
    CLUSTER_MAX_BATCH_BWD); forced (`path="cluster"`) it runs any B, and raises
    where no C can run. H is the kernel's: a padded call's `cluster_width`.
    """
    sizes = [c for c in _cluster_sizes(H, dtype, backward) if (clusters or {}).get(c, 0) >= 1]
    if not sizes:
        if forced:
            raise ValueError(f"the cluster path takes H = 256, 384 or 512 (H = 256 on clusters of "
                             f"8 or 16 blocks, else 16; {PADDED_ABOVE} < H < {MAX_HIDDEN} padded "
                             f"to {MAX_HIDDEN}) that the card holds; got H = {H}, "
                             f"clusters {clusters}")
        return None
    if not forced and B > (CLUSTER_MAX_BATCH_BWD if backward else CLUSTER_MAX_BATCH):
        return None
    return 1, min(sizes, key=lambda c: (-(-n_chains * B // clusters[c]), -c))


def _plan(B: int, n_chains: int, H: int, dtype: torch.dtype, sms: int,
          path: str | None = None, clusters: dict | None = None,
          routes: tuple = FORWARD_ROUTES, wide: dict | None = None) -> tuple[str, int | tuple]:
    """The forward kernel and tile for B sequences on each of `n_chains` chains -> (path, tile).

    For H a multiple of 16 up to MMA_MAX_HIDDEN the tensor cores: "mma"
    (tile M rows) for bfloat16, M = 16 while that grid fits one wave over
    `sms` SMs, else M = 32, which halves the blocks (at the serving shapes,
    one wave); "tf32x3" (tile (M, C): M rows held by a cluster of C blocks)
    for float32, by `_tf32_tile` from `clusters`, {C: clusters of C blocks
    the card holds at once}, which the caller queries. "fma" (tile R
    sequences per group of the FMA kernel) for every other call: the largest
    R in 4, 2, 1 that still gives every SM a block. Where no tensor-core path
    of H <= MMA_MAX_HIDDEN runs and the calling wrapper's `routes` hold "wide"
    and "cluster" (the LSTM's ROUTES): "wide" (tile (M, C)) by `_wide_tile`
    from `wide`, the wide kernel's counts by tile, for many sequences at
    H = 256 (B from WIDE_MIN_BATCH up); below that, or at H = 384 and 512,
    "cluster" (tile (1, C)) by `_cluster_tile` from `clusters`, the cluster
    kernel's counts, for few sequences; for PADDED_ABOVE < H < MAX_HIDDEN off
    the multiples of 128 (LSTM-TasNet's 500) "cluster" too, at the padded width
    `cluster_width(H)` = 512 (C = 16; `clusters` the kernel's counts at 512),
    which the launch reads from `launch_width`: zero-padding is exact (module
    docstring), and the padded products are 1.05x the unpadded ones at H = 500.
    `path` forces one (the FMA path at a
    shape that would take another, to time both); forcing a path where it
    cannot run raises, "cluster" and "wide" also from a wrapper whose routes
    lack them. The GRU wrapper plans with this function too, with
    FORWARD_ROUTES.
    """
    natural = _tensor_core_path(H, dtype)
    if path == "wide" or (path is None and natural is None and "wide" in routes):
        if "wide" not in routes:
            raise ValueError(f"this wrapper has no wide kernel (routes {routes})")
        tile = _wide_tile(B, n_chains, H, dtype, wide, forced=path == "wide")
        if tile is not None:
            return "wide", tile
    if path == "cluster" or (path is None and natural is None and "cluster" in routes):
        if "cluster" not in routes:
            raise ValueError(f"this wrapper has no cluster kernel (routes {routes})")
        tile = _cluster_tile(B, n_chains, cluster_width(H), dtype, clusters,
                             forced=path == "cluster")
        if tile is not None:
            return "cluster", tile
    path = path or natural or "fma"
    if path in ("mma", "tf32x3") and path != natural:
        kind = {"mma": "bfloat16", "tf32x3": "float32"}[path]
        raise ValueError(f"the {path} path takes {kind} with H a multiple of 16 up to "
                         f"{MMA_MAX_HIDDEN}; got {dtype}, H = {H}")
    if path == "mma":
        return "mma", 16 if n_chains * -(-B // 16) <= sms else 32
    if path == "tf32x3":
        return "tf32x3", _tf32_tile(B, n_chains, H, clusters)
    if path != "fma":
        raise ValueError(f"unknown path {path!r}")
    return "fma", _fma_tile(B, n_chains, H, sms)


def _fma_tile(B: int, n_chains: int, H: int, sms: int) -> int:
    """The FMA kernels' tile R (forward and backward): sequences per group of
    min(4, 256 / (H / 2)) groups a block, the largest R in 4, 2, 1 that still
    gives every SM a block."""
    groups = min(4, 256 // (H // 2))
    for r in (4, 2):
        if n_chains * -(-B // (groups * r)) >= sms:
            return r
    return 1


def _plan_bwd(B: int, n_chains: int, H: int, dtype: torch.dtype, sms: int,
              path: str | None = None, clusters: dict | None = None,
              routes: tuple = FORWARD_ROUTES, wide: dict | None = None) -> tuple[str, int | tuple]:
    """The backward kernel and tile for B sequences on each of `n_chains` chains -> (path, tile).

    For H a multiple of 16 up to MMA_MAX_HIDDEN the split-TF32 tensor cores,
    "tf32x3" for float32 and "tf32x2" for bfloat16, tile (M, C) by
    `_tf32_tile` from `clusters` (the backward kernel's, which the caller
    queries) over M in BWD_TILE_ROWS: at the training shapes M = 16 on
    2-block clusters, one wave. Where no tensor-core path runs and the calling
    wrapper's `routes` hold "wide" and "cluster" (the LSTM's ROUTES): "wide"
    (tile (M, C)) by `_wide_tile` from `wide`, the wide backward's counts by
    tile, for many sequences at H = 256 (B from WIDE_MIN_BATCH_BWD up: DPTNet
    training); below that, or at H = 384 and 512, "cluster" (tile (1, C)) by
    `_cluster_tile` from `clusters`, the cluster backward's counts, for B up to
    CLUSTER_MAX_BATCH_BWD (musdb18 training: C = 8), and at the forward's padded
    widths on the padded call (`launch_width`; LSTM-TasNet training). "fma" (tile R, the
    forward's rule) for every other call. `path` forces one (the FMA path, to
    time both); forcing a path where it cannot run raises, "cluster" and "wide"
    also from a wrapper whose routes lack them. The GRU wrapper plans with this
    function too, with FORWARD_ROUTES.
    """
    natural = _tensor_core_path(H, dtype, backward=True)
    if path == "wide" or (path is None and natural is None and "wide" in routes):
        if "wide" not in routes:
            raise ValueError(f"this wrapper has no wide backward (routes {routes})")
        tile = _wide_tile(B, n_chains, H, dtype, wide, forced=path == "wide", backward=True)
        if tile is not None:
            return "wide", tile
    if path == "cluster" or (path is None and natural is None and "cluster" in routes):
        if "cluster" not in routes:
            raise ValueError(f"this wrapper has no cluster backward (routes {routes})")
        tile = _cluster_tile(B, n_chains, cluster_width(H), dtype, clusters,
                             forced=path == "cluster", backward=True)
        if tile is not None:
            return "cluster", tile
    path = path or natural or "fma"
    if path in _BWD_TENSOR_CORE_PATH.values():
        if path != natural:
            kind = {"tf32x2": "bfloat16", "tf32x3": "float32"}[path]
            raise ValueError(f"the {path} backward takes {kind} with H a multiple of 16 up to "
                             f"{MMA_MAX_HIDDEN}; got {dtype}, H = {H}")
        return path, _tf32_tile(B, n_chains, H, clusters, BWD_TILE_ROWS)
    if path != "fma":
        raise ValueError(f"unknown backward path {path!r}")
    return "fma", _fma_tile(B, n_chains, H, sms)


def _tf32_tile(B: int, n_chains: int, H: int, clusters: dict | None,
               rows=(16, 32, 64)) -> tuple[int, int]:
    """The cluster kernels' tile (M, C) for B sequences on each of `n_chains` chains.

    A block's share of a step, the product and the cell updates of M rows
    and H / C units, bounds these kernels, so of the M in `rows` and the C in
    `clusters` (C with H % 8C == 0) it takes the fewest waves of
    `clusters[C]`, then the fewest rows x units a block (M / C), then the
    smaller cluster and tile. For the 3xTF32 forward at the intra serving
    shape that is M = 64 on 2-block clusters (one wave of 64), at the training
    shapes M = 16, and for a streamed hop's three chunks a chain M = 16 on
    4-block clusters.
    """
    options = []
    for c, n in (clusters or {}).items():
        if n < 1 or H % (8 * c):
            continue
        for m in rows:
            tiles = n_chains * -(-B // m)
            options.append((-(-tiles // n), m / c, c, m))  # waves first
    if not options:
        raise ValueError(f"the cluster kernels need the card's co-resident clusters at H = {H}; "
                         f"got {clusters}")
    *_, c, m = min(options)
    return m, c


def _tile_args(tile) -> tuple[int, int]:
    """A plan's tile as the C entry points take it: (tile, cluster); cluster 1 off the
    cluster kernels (tf32x3 and its backward, cluster)."""
    return tile if isinstance(tile, tuple) else (tile, 1)


def _co_resident_clusters(fn, H: int, device: torch.device, sizes=None,
                          required: bool = True) -> dict:
    """{C: clusters of C blocks of a cluster kernel at H that the card holds at once}.

    `fn` is the library's query (cudaOccupancyMaxActiveClusters, each block
    on an SM of its own), asked once per card, H and C, for the C in `sizes`
    (default: the 3xTF32 kernels' sizes that H admits). `required`: a count
    under 1 raises; else it is recorded (a card may have no GPC with 16 free
    SMs).
    """
    if sizes is None:
        sizes = [c for c in TF32_CLUSTER_SIZES if H % (8 * c) == 0]
    with torch.cuda.device(device):
        key = (fn.__name__, torch.cuda.current_device(), H)
        if key not in _CLUSTERS:
            counts = {}
            for c in sizes:
                n = ctypes.c_int(0)
                err = fn(H, c, ctypes.byref(n))
                if err != 0 or (required and n.value < 1):
                    raise RuntimeError(f"{fn.__name__}(H = {H}, C = {c}) failed: cudaError "
                                       f"{err}, {n.value} clusters")
                counts[c] = n.value
            _CLUSTERS[key] = counts
    return _CLUSTERS[key]


def _needs_clusters(H: int, dtype: torch.dtype, path: str | None, backward: bool = False,
                    routes: tuple = FORWARD_ROUTES) -> bool:
    """Whether a plan at H in `dtype` (forced to `path`, if given) may take a cluster
    kernel, so that the caller must ask the card for its co-resident clusters (at
    `cluster_width(H)`)."""
    natural = _tensor_core_path(H, dtype, backward)
    if (path or natural) in ("tf32x3", "tf32x2"):
        return True
    return ("cluster" in routes and path in (None, "cluster") and natural is None
            and bool(_cluster_sizes(cluster_width(H), dtype, backward)))


def _needs_wide(H: int, dtype: torch.dtype, path: str | None, routes: tuple = FORWARD_ROUTES,
                backward: bool = False) -> bool:
    """Whether a forward plan (a backward one if `backward`) at H in `dtype` (forced to
    `path`, if given) may take the wide kernel, so that the caller must ask the card for
    its co-resident clusters."""
    return ("wide" in routes and path in (None, "wide")
            and _tensor_core_path(H, dtype, backward) is None
            and bool(_wide_tiles(H, dtype, backward)))


def _plan_launch(clusters_of, chains, path, backward=False, routes=FORWARD_ROUTES):
    """Plan one launch over validated chains (xw, w_hh, ...) -> (B, T, H, path, tile).

    The forward's (over the wrapper's `routes`), or the backward's if
    `backward`. `clusters_of(H, device)` is the count of the cluster kernel
    that runs at H (at `cluster_width(H)`), asked only where one may run. The
    launch runs at `launch_width(H, path)`. The GRU wrapper plans its launches
    with this function too.
    """
    xw0 = chains[0][0]
    B, T, _ = xw0.shape
    H = chains[0][1].shape[0]
    sms = torch.cuda.get_device_properties(xw0.device).multi_processor_count
    clusters = wide = None
    if _needs_clusters(H, xw0.dtype, path, backward, routes):
        clusters = clusters_of(cluster_width(H), xw0.device)
    if _needs_wide(H, xw0.dtype, path, routes, backward):
        wide = _wide_counts(H, xw0.dtype, xw0.device, backward)
    if backward:
        return (B, T, H, *_plan_bwd(B, len(chains), H, xw0.dtype, sms, path, clusters, routes,
                                    wide))
    return (B, T, H, *_plan(B, len(chains), H, xw0.dtype, sms, path, clusters, routes, wide))


def _library():
    global _LIB
    if _LIB is None:
        lib = load_library("lstm_scan")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lstm_scan_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        lib.lstm_scan_launch.restype = i
        lib.lstm_scan_bidir_launch.argtypes = [p] * 8 + [i] * 7 + [p]
        lib.lstm_scan_bidir_launch.restype = i
        lib.lstm_scan_tf32_clusters.argtypes = [i, i, ctypes.POINTER(i)]
        lib.lstm_scan_tf32_clusters.restype = i
        lib.lstm_scan_cluster_clusters.argtypes = [i, i, ctypes.POINTER(i)]
        lib.lstm_scan_cluster_clusters.restype = i
        lib.lstm_scan_cluster_floor_launch.argtypes = [p] * 6 + [i] * 5 + [p]
        lib.lstm_scan_cluster_floor_launch.restype = i
        lib.lstm_scan_wide_clusters.argtypes = [i, i, i, i, ctypes.POINTER(i)]
        lib.lstm_scan_wide_clusters.restype = i
        _LIB = lib
    return _LIB


def _bwd_library():
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = load_library("lstm_scan_bwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lstm_scan_bwd_launch.argtypes = [p] * 6 + [i] * 7 + [p]
        lib.lstm_scan_bwd_launch.restype = i
        lib.lstm_scan_bidir_bwd_launch.argtypes = [p] * 12 + [i] * 7 + [p]
        lib.lstm_scan_bidir_bwd_launch.restype = i
        lib.lstm_scan_bwd_tf32_clusters.argtypes = [i, i, ctypes.POINTER(i)]
        lib.lstm_scan_bwd_tf32_clusters.restype = i
        lib.lstm_scan_bwd_cluster_clusters.argtypes = [i, i, ctypes.POINTER(i)]
        lib.lstm_scan_bwd_cluster_clusters.restype = i
        lib.lstm_scan_bwd_cluster_floor_launch.argtypes = [p] * 12 + [i] * 5 + [p]
        lib.lstm_scan_bwd_cluster_floor_launch.restype = i
        lib.lstm_scan_bwd_wide_clusters.argtypes = [i, i, i, i, ctypes.POINTER(i)]
        lib.lstm_scan_bwd_wide_clusters.restype = i
        lib.lstm_scan_bwd_wide_floor_launch.argtypes = [p] * 12 + [i] * 6 + [p]
        lib.lstm_scan_bwd_wide_floor_launch.restype = i
        _BWD_LIB = lib
    return _BWD_LIB


def build() -> None:
    """Build (or load) the forward kernels now instead of at their first launch."""
    _library()


def _tf32_clusters(H: int, device) -> dict:
    """{C: clusters of C blocks of this wrapper's 3xTF32 kernel at H the card holds at once}."""
    return _co_resident_clusters(_library().lstm_scan_tf32_clusters, H, torch.device(device))


def _cluster_counts(H: int, device) -> dict:
    """{C: clusters of C blocks of the cluster kernel at H the card holds at once}, for
    each C that H admits; 0 where no GPC has C free SMs."""
    return _co_resident_clusters(_library().lstm_scan_cluster_clusters, H, torch.device(device),
                                 sizes=_cluster_sizes(H), required=False)


def _wide_counts(H: int, dtype: torch.dtype, device, backward: bool = False) -> dict:
    """{(M, C): clusters of C blocks of the wide kernel (the backward's if `backward`) at H,
    tile M and `dtype` the card holds at once}, for each tile H admits in `dtype`; 0 where
    no GPC has C free SMs."""
    device = torch.device(device)
    fn = (_bwd_library().lstm_scan_bwd_wide_clusters if backward
          else _library().lstm_scan_wide_clusters)
    with torch.cuda.device(device):
        key = (fn.__name__, torch.cuda.current_device(), H, dtype)
        if key not in _CLUSTERS:
            counts = {}
            for m, c in _wide_tiles(H, dtype, backward):
                n = ctypes.c_int(0)
                err = fn(H, m, c, _DTYPE_CODE[dtype], ctypes.byref(n))
                if err != 0:
                    raise RuntimeError(f"{fn.__name__}(H = {H}, M = {m}, C = {c}, "
                                       f"{dtype}) failed: cudaError {err}")
                counts[(m, c)] = n.value
            _CLUSTERS[key] = counts
    return _CLUSTERS[key]


def _forward_clusters(H: int, device) -> dict:
    """The co-resident clusters of the forward cluster kernel that runs at H: the 3xTF32
    kernel's up to MMA_MAX_HIDDEN, the cluster kernel's above."""
    return _tf32_clusters(H, device) if H <= MMA_MAX_HIDDEN else _cluster_counts(H, device)


def build_backward() -> None:
    """Build (or load) the backward kernels now instead of at their first launch."""
    _bwd_library()


def _tf32_bwd_clusters(H: int, device) -> dict:
    """{C: clusters of C blocks of this wrapper's tensor-core backward at H the card holds
    at once}."""
    return _co_resident_clusters(_bwd_library().lstm_scan_bwd_tf32_clusters, H,
                                 torch.device(device))


def _cluster_bwd_counts(H: int, device) -> dict:
    """{C: clusters of C blocks of the cluster backward at H the card holds at once}, for
    each C that H admits; 0 where no GPC has C free SMs."""
    return _co_resident_clusters(_bwd_library().lstm_scan_bwd_cluster_clusters, H,
                                 torch.device(device), sizes=_cluster_sizes(H, backward=True),
                                 required=False)


def _backward_clusters(H: int, device) -> dict:
    """The co-resident clusters of the backward cluster kernel that runs at H: the
    tensor-core backward's up to MMA_MAX_HIDDEN, the cluster backward's above."""
    return (_tf32_bwd_clusters(H, device) if H <= MMA_MAX_HIDDEN
            else _cluster_bwd_counts(H, device))


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


def _check_chains(name: str, chains) -> None:
    """Validate the (xw, w_hh) pairs of one launch: each pair, and one shape for all."""
    xw0 = chains[0][0]
    if xw0.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {xw0.device}")
    for xw, w_hh in chains:
        _check(xw, w_hh)
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


def _forced_tile(tile, path: str, H: int, dtype: torch.dtype, device,
                 backward: bool = False) -> tuple:
    """A tile (M, C) forced on the wide path or a split-TF32 path ("tf32x3", the
    backward's "tf32x2") -> the tile, if the card holds such clusters; else raises."""
    tile = tuple(tile)
    if path == "wide":
        ok = _wide_counts(H, dtype, device, backward).get(tile, 0) >= 1
    else:
        clusters = _tf32_bwd_clusters(H, device) if backward else _tf32_clusters(H, device)
        rows = BWD_TILE_ROWS if backward else (16, 32, 64)
        m, c = tile
        ok = (path in ("tf32x3", "tf32x2") and m in rows and H % (8 * c) == 0
              and clusters.get(c, 0) >= 1)
    if not ok:
        raise ValueError(f"no {path} {'backward' if backward else 'path'} at tile {tile} here")
    return tile


def _staged_forward(chains, with_cs: bool, path: str | None = None, cluster: int | None = None,
                    tile: tuple | None = None):
    """Plan the forward kernel over one or two (xw, w_hh) chains and allocate its outputs
    -> (hs list, cs list, a call that launches it into them).

    `path` forces a path of `_plan`, `cluster` the cluster size of the cluster
    path and `tile` the tile (M, C) of the wide or tf32x3 path (only chip_smoke.py
    passes them, to time the FMA kernel where another one would run, both cluster
    sizes and every wide and tf32x3 tile). Where the plan pads the call (`launch_width`), the
    chains are padded here and the launch writes padded outputs, of which hs and
    cs are the (B, T, H) views.
    """
    name = "lstm_scan" if len(chains) == 1 else "lstm_scan_bidir"
    _check_chains(name, chains)
    xw0 = chains[0][0]
    lib = _library()
    B, T, H, path, planned = _plan_launch(_forward_clusters, chains, path, routes=ROUTES)
    width = launch_width(H, path)
    if cluster is not None:
        counts = _cluster_counts(width, xw0.device)
        if path != "cluster" or counts.get(cluster, 0) < 1:
            raise ValueError(f"no cluster path on {cluster} blocks here: {path}, {counts}")
        planned = (1, cluster)
    if tile is not None:
        planned = _forced_tile(tile, path, H, xw0.dtype, xw0.device)
    tile = planned
    if width != H:
        chains = [pad_chain(xw, w_hh, width) for xw, w_hh in chains]
    hs = [torch.empty((B, T, width), dtype=xw0.dtype, device=xw0.device) for _ in chains]
    cs = [torch.empty_like(h) for h in hs] if with_cs else []
    fn = lib.lstm_scan_launch if len(chains) == 1 else lib.lstm_scan_bidir_launch

    def launch():  # reads `chains`, `hs` and `cs`, so the arrays live as long as the call
        pointers = ([c[0].data_ptr() for c in chains] + [c[1].data_ptr() for c in chains]
                    + [h.data_ptr() for h in hs]
                    + ([c.data_ptr() for c in cs] if with_cs else [None] * len(chains)))
        _launch(name, fn, pointers, xw0.dtype, B, T, width, xw0.device, _PATH_CODE[path],
                *_tile_args(tile))
        PATH_LAUNCHES[name][path] += 1
        if width != H:
            PADDED_LAUNCHES[name] += 1

    return [h[..., :H] for h in hs], [c[..., :H] for c in cs], launch


def _forward_cuda(chains, with_cs: bool, path: str | None = None):
    """Launch the forward kernel over one or two (xw, w_hh) chains -> (hs list, cs list).

    `path` forces a path of `_plan` (only chip_smoke.py passes it, to time
    the FMA kernel where another one would run). A padded launch's outputs are
    copied out of its padded arrays (`.contiguous()`, a no-op on the others).
    """
    hs, cs, launch = _staged_forward(chains, with_cs, path)
    launch()
    return [h.contiguous() for h in hs], [c.contiguous() for c in cs]


def _staged_cluster_floor(chains, cluster: int):
    """The cluster kernel's serial floor over one or two (xw, w_hh) chains on clusters of
    `cluster` blocks -> (hs list, a call that launches it into them; not counted).

    The same kernel with its product compiled out: every step's reduction,
    cell update and exchange of h, which no product can make shorter.
    Its hs are not the recurrence's. chip_smoke.py times it beside the kernel.
    """
    _check_chains("lstm_scan_cluster_floor", chains)
    xw0 = chains[0][0]
    B, T, _ = xw0.shape
    H = chains[0][1].shape[0]
    if cluster_layout(H, cluster, xw0.dtype) is None:
        raise ValueError(f"the cluster kernel does not take H = {H} on {cluster} blocks")
    hs = [torch.empty((B, T, H), dtype=xw0.dtype, device=xw0.device) for _ in chains]
    fn = _library().lstm_scan_cluster_floor_launch

    def launch():
        pointers = [c[0].data_ptr() for c in chains] + [None] * (2 - len(chains))
        pointers += [c[1].data_ptr() for c in chains] + [None] * (2 - len(chains))
        pointers += [h.data_ptr() for h in hs] + [None] * (2 - len(chains))
        with torch.cuda.device(xw0.device):
            err = fn(*pointers, _DTYPE_CODE[xw0.dtype], B, T, H, cluster,
                     torch.cuda.current_stream(xw0.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"lstm_scan_cluster_floor launch failed: cudaError {err}")

    return hs, launch


def _staged_gates(xw: torch.Tensor, w_hh: torch.Tensor, h_prev: torch.Tensor) -> torch.Tensor:
    """`_gates` as the card stages it: one addmm with f32(xw) as the matrix added, so
    cuBLAS rounds acc + xw once in its epilogue, where a matmul and an add make two
    more passes over (B, T, 4H) f32 (the same value; the sums may run in another order)."""
    B, T, four_h = xw.shape
    h = h_prev.to(w_hh.dtype).float().reshape(B * T, -1)
    return torch.addmm(xw.float().reshape(B * T, four_h), h, w_hh.float()).view(B, T, four_h)


def _stage_backward(chains, B, T, H, path):
    """The backward kernel's arrays of each (xw, w_hh, hs, cs, g_hs) chain on `path`:
    (h_prev, gates, cs, g_hs, W (W_hh^T on "fma", else W_hh), das, d_xw)."""
    staged = []
    for xw, w_hh, hs, cs, g_hs in chains:
        # Gradients come back through flip and cat: make them contiguous
        # before any data_ptr() (a no-op where they already are).
        cs, g_hs = cs.contiguous(), g_hs.contiguous()
        for what, t in (("hs", hs), ("cs", cs), ("g_hs", g_hs)):
            if t.shape != (B, T, H) or t.dtype != xw.dtype or t.device != xw.device:
                raise ValueError(f"{what} {tuple(t.shape)} {t.dtype} does not match xw "
                                 f"{tuple(xw.shape)} {xw.dtype}")
        for what, t in (("cs", cs), ("g_hs", g_hs)):
            if t.data_ptr() % 16:
                raise ValueError(f"{what} is not 16-byte aligned")
        h_prev = _shifted(hs)
        das = torch.empty((B, T, 4 * H), dtype=torch.float32, device=xw.device)
        # In f32 das is d_xw; in bf16 the kernel writes d_xw beside it.
        d_xw = das if xw.dtype == torch.float32 else torch.empty_like(xw)
        w = w_hh.t().contiguous() if path == "fma" else w_hh  # the FMA kernel reads W_hh^T
        staged.append((h_prev, _staged_gates(xw, w_hh, h_prev), cs, g_hs, w, das, d_xw))
    return staged


def _pointers(staged) -> list:
    """The C entry points' arrays of staged chains: gates, cs, g_hs, W and das of each
    chain, then d_xw of each (None where das is d_xw)."""
    return ([s[k].data_ptr() for k in range(1, 6) for s in staged]
            + [None if s[6] is s[5] else s[6].data_ptr() for s in staged])


def _staged_backward(chains, path: str | None = None, cluster: int | None = None,
                     tile: tuple | None = None):
    """Stage the backward kernel's inputs and outputs over one or two
    (xw, w_hh, hs, cs, g_hs) chains -> (staged arrays per chain, a call that launches it).

    `path` forces a path of `_plan_bwd`, `cluster` the cluster size of the cluster
    path and `tile` the tile (M, C) of the wide or split-TF32 path (only chip_smoke.py
    passes them, to time the FMA kernel where another one would run, both cluster sizes
    and every wide and split-TF32 tile). Where the plan pads the call (`launch_width`),
    the chains are padded first and every staged array is the padded one.
    """
    name = "lstm_scan_bwd" if len(chains) == 1 else "lstm_scan_bidir_bwd"
    _check_chains(name, [c[:2] for c in chains])
    xw0 = chains[0][0]
    B, T, H, path, planned = _plan_launch(_backward_clusters, [c[:2] for c in chains], path,
                                          backward=True, routes=ROUTES)
    width = launch_width(H, path)
    if cluster is not None:
        counts = _cluster_bwd_counts(width, xw0.device)
        if path != "cluster" or counts.get(cluster, 0) < 1:
            raise ValueError(f"no cluster backward on {cluster} blocks here: {path}, {counts}")
        planned = (1, cluster)
    if tile is not None:
        planned = _forced_tile(tile, path, H, xw0.dtype, xw0.device, backward=True)
    tile = planned
    if width != H:
        chains = [pad_backward_chain(c, width) for c in chains]
    staged = _stage_backward(chains, B, T, width, path)
    lib = _bwd_library()
    fn = lib.lstm_scan_bwd_launch if len(chains) == 1 else lib.lstm_scan_bidir_bwd_launch

    def launch():  # reads `staged`, so the arrays live as long as the call
        _launch(name, fn, _pointers(staged), xw0.dtype, B, T, width, xw0.device,
                _PATH_CODE[path], *_tile_args(tile))
        BWD_PATH_LAUNCHES[name][path] += 1
        if width != H:
            PADDED_LAUNCHES[name] += 1

    return staged, launch


def _staged_bwd_floor(chains, path: str, tile: tuple):
    """The serial floor of the cluster or wide backward (`path`) over one or two
    (xw, w_hh, hs, cs, g_hs) chains at `tile` ((1, C) or (M, C)) -> (staged arrays, a call
    that launches it; not counted).

    The same kernel with its product compiled out: every step's cell derivative and
    exchange (and the wide kernel's sums of the partials), which no product can make
    shorter. Its das are not the recurrence's. chip_smoke.py times it beside the kernel.
    """
    _check_chains(f"lstm_scan_bwd_{path}_floor", [c[:2] for c in chains])
    xw0 = chains[0][0]
    B, T, _ = xw0.shape
    H = chains[0][1].shape[0]
    M, C = tile
    layout = (cluster_bwd_layout(H, C, xw0.dtype) if path == "cluster"
              else wide_bwd_layout(H, M, C, xw0.dtype))
    if layout is None:
        raise ValueError(f"the {path} backward does not take H = {H} at tile {tile}")
    staged = _stage_backward(chains, B, T, H, path)
    lib = _bwd_library()
    fn = lib.lstm_scan_bwd_cluster_floor_launch if path == "cluster" else \
        lib.lstm_scan_bwd_wide_floor_launch
    plan = (C,) if path == "cluster" else (M, C)

    def launch():
        pointers = [None] * 12
        for k, ptr in enumerate(_pointers(staged)):  # chain c of array a at 2 a + c
            pointers[2 * (k // len(staged)) + k % len(staged)] = ptr
        with torch.cuda.device(xw0.device):
            err = fn(*pointers, _DTYPE_CODE[xw0.dtype], B, T, H, *plan,
                     torch.cuda.current_stream(xw0.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"lstm_scan_bwd_{path}_floor launch failed: cudaError {err}")

    return staged, launch


def _backward_cuda(chains, path: str | None = None):
    """The backward kernel over one or two (xw, w_hh, hs, cs, g_hs) chains -> [(d_xw, d_whh)]:
    a padded launch's d_xw and d_W_hh sliced back to H (d_W_hh summed at the padded width)."""
    staged, launch = _staged_backward(chains, path)
    launch()
    return [(unpad_gates(d_xw, w_hh.shape[0]),
             unpad_weight_grad(_weight_grad(h_prev, das, w_hh.dtype), w_hh.shape[0]))
            for (h_prev, *_, das, d_xw), (_, w_hh, *_) in zip(staged, chains)]


def _forward_with_cs(chains):
    """Training forward of one or two chains -> (hs list, cs list)."""
    if chains[0][0].device.type == "cpu":
        hs, cs = zip(*(lstm_forward_reference(xw, w_hh) for xw, w_hh in chains))
        return list(hs), list(cs)
    return _forward_cuda(chains, with_cs=True)


def _backward(chains):
    """Backward of one or two chains -> [(d_xw, d_whh)]."""
    if chains[0][0].device.type == "cpu":
        return [lstm_scan_bwd_reference(*c) for c in chains]
    return _backward_cuda(chains)


class _LSTMScan(torch.autograd.Function):
    """`lstm_scan` under autograd: forward with cs, backward by the reverse recurrence."""

    @staticmethod
    def forward(ctx, xw, w_hh):
        (hs,), (cs,) = _forward_with_cs([(xw, w_hh)])
        ctx.save_for_backward(xw, w_hh, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, g_hs):
        ((d_xw, d_whh),) = _backward([(*ctx.saved_tensors, g_hs)])
        return d_xw, d_whh


class _LSTMScanBidir(torch.autograd.Function):
    """`lstm_scan_bidir` under autograd: both chains in one launch each way."""

    @staticmethod
    def forward(ctx, xw_f, xw_b, whh_f, whh_b):
        (hs_f, hs_b), (cs_f, cs_b) = _forward_with_cs([(xw_f, whh_f), (xw_b, whh_b)])
        ctx.save_for_backward(xw_f, xw_b, whh_f, whh_b, hs_f, hs_b, cs_f, cs_b)
        return hs_f, hs_b

    @staticmethod
    def backward(ctx, g_f, g_b):
        xw_f, xw_b, whh_f, whh_b, hs_f, hs_b, cs_f, cs_b = ctx.saved_tensors
        (d_xw_f, d_whh_f), (d_xw_b, d_whh_b) = _backward(
            [(xw_f, whh_f, hs_f, cs_f, g_f), (xw_b, whh_b, hs_b, cs_b, g_b)])
        return d_xw_f, d_xw_b, d_whh_f, d_whh_b


def _recording(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def lstm_scan(xw: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Fused LSTM recurrence: xw (B, T, 4H) input gates, w_hh (H, 4H) -> hs (B, T, H).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. Under autograd the backward kernel computes the gradients.
    """
    if _recording(xw, w_hh):
        return _LSTMScan.apply(xw, w_hh)
    if xw.device.type == "cpu":
        return lstm_scan_reference(xw, w_hh)
    return _forward_cuda([(xw, w_hh)], with_cs=False)[0][0]


def lstm_scan_bidir(xw_f: torch.Tensor, xw_b: torch.Tensor, whh_f: torch.Tensor,
                    whh_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Both chains of a bidirectional LSTM layer in one launch.

    xw_f (B, T, 4H): forward input gates; xw_b: the backward chain's input
    gates over the TIME-REVERSED sequence. Returns (hs_f, hs_b), hs_b in
    reversed time order (flip it back outside), as the Pallas kernel does.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. Under autograd the backward kernel computes the gradients.
    """
    if _recording(xw_f, xw_b, whh_f, whh_b):
        return _LSTMScanBidir.apply(xw_f, xw_b, whh_f, whh_b)
    if xw_f.device.type == "cpu":
        return lstm_scan_bidir_reference(xw_f, xw_b, whh_f, whh_b)
    hs_f, hs_b = _forward_cuda([(xw_f, whh_f), (xw_b, whh_b)], with_cs=False)[0]
    return hs_f, hs_b
