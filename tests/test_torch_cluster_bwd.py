"""The layout the cluster kernel of the LSTM backward is launched with (CPU).

`csrc/recurrence_cluster_bwd.cuh` spreads the reverse recurrence of one
sequence of one chain over a cluster of C blocks: rank r owns hidden units
[r H/C, (r+1) H/C), two a warp, with their dh_rec and dc_rec, and W_hh's rows
of them. Every rank keeps the step's da (4H values) in its shared memory in
unit-major order (value 4 u + q is gate q of unit u); lane l of a warp owns
values 128 jb + 4 l + q of every 128-value row block jb (unit 32 jb + l) and
the W_hh values W_hh[its warp's units, q H + 32 jb + l], the first eight row
blocks in registers and the rest in shared memory. `ops/lstm_scan.py:
cluster_bwd_layout` mirrors the kernel's `shape_ok` and `smem_bytes`. Here:
every unit, gate column, da value and W value is owned exactly once, every
layout fits a block, and a numpy model of the partitioned step (each rank's
partial sums over its lanes' values, the lane reduction, the cell derivative
of its units, then da "exchanged" into every rank's buffer) equals the plain
backward. The kernel itself is held to the plain version on the card by
chip_smoke.py phases 3d and 3h.
"""
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.ops import lstm_scan as ls

VALID = [(256, 8), (256, 16), (384, 16), (512, 16)]
SHARED_LIMIT = 232448  # a Hopper block's dynamic shared memory, bytes
REGISTERS = 65536  # 32-bit registers of an SM


def _units(H, C, rank, warp):
    """The hidden units of a warp of rank `rank`: two adjacent ones."""
    units = H // C
    return [rank * units + ls.CLUSTER_UNITS_PER_WARP * warp + u
            for u in range(ls.CLUSTER_UNITS_PER_WARP)]


def _da_units(H, lane, lanes=32):
    """The units whose four da values lane `lane` of every warp reads: lanes jb + lane in
    each row block jb of 4 x lanes values."""
    return [lanes * jb + lane for jb in range(4 * H // (4 * lanes))]


@pytest.mark.parametrize("H,C", VALID, ids=[f"H={H}-C={C}" for H, C in VALID])
def test_every_unit_gate_column_da_value_and_weight_is_owned_once(H, C):
    layout = ls.cluster_bwd_layout(H, C)
    units = [u for r in range(C) for w in range(layout["warps"]) for u in _units(H, C, r, w)]
    assert sorted(units) == list(range(H))
    columns = [q * H + u for u in units for q in range(4)]  # das columns a rank stores
    assert sorted(columns) == list(range(4 * H))
    # Each lane's da values, unit-major (4 u + q), cover the 4H of a step once.
    values = [4 * u + q for lane in range(32) for u in _da_units(H, lane) for q in range(4)]
    assert sorted(values) == list(range(4 * H))
    # W_hh[unit, q H + k] of a thread: its warp's units, every gate q and the units k
    # of its lane; over the cluster, W_hh (H x 4H) once.
    weights = [(unit, q * H + k) for r in range(C) for w in range(layout["warps"])
               for unit in _units(H, C, r, w) for lane in range(32)
               for k in _da_units(H, lane) for q in range(4)]
    assert len(weights) == len(set(weights)) == H * 4 * H
    # A rank holds its units' rows (H/C x 4H): the forward's count of values, split by
    # row block over registers and shared memory.
    per_thread = len(_da_units(H, 0)) * 4 * ls.CLUSTER_UNITS_PER_WARP
    assert per_thread == layout["row_blocks"] * 8
    assert per_thread * layout["threads"] == layout["units"] * 4 * H
    assert per_thread * layout["threads"] == ls.cluster_layout(H, C)["row_blocks"] * 32 * \
        ls.cluster_layout(H, C)["threads"]
    reg_floats = layout["reg_blocks"] * 8
    assert reg_floats == 64  # of the 128 registers a thread has
    smem_blocks = layout["row_blocks"] - layout["reg_blocks"]
    assert (per_thread - reg_floats) * layout["threads"] * 4 == smem_blocks * 128 * H // C * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,C", VALID, ids=[f"H={H}-C={C}" for H, C in VALID])
def test_every_layout_fits_a_block(H, C, dtype):
    layout = ls.cluster_bwd_layout(H, C, dtype)
    size = torch.tensor([], dtype=dtype).element_size()
    units = H // C
    da_buffers = 16 + 2 * 4 * H * 4  # two mbarriers, then da
    w_smem = (layout["row_blocks"] - layout["reg_blocks"]) * 128 * units * size
    assert layout["w_smem_bytes"] == w_smem
    assert layout["smem_bytes"] == max(da_buffers + w_smem, ls.OWN_SM)
    assert layout["smem_bytes"] <= SHARED_LIMIT
    assert layout["threads"] <= ls.CLUSTER_MAX_THREADS
    # 64 registers of W a thread leave 64 for the rest at 128 a thread.
    assert layout["threads"] * 128 <= REGISTERS
    # The forward's ranks, warps and threads: the plan asks the card for each kernel's
    # clusters, which can differ only by shared memory.
    fwd = ls.cluster_layout(H, C, dtype)
    assert (layout["units"], layout["warps"], layout["threads"]) == (
        fwd["units"], fwd["warps"], fwd["threads"])


@pytest.mark.parametrize("H,C,smem,w_smem", [(256, 8, 122880, 0), (256, 16, 122880, 0),
                                             (384, 16, 122880, 49152),
                                             (512, 16, 147472, 131072)],
                         ids=["umx-train-C=8", "umx-train-C=16", "H=384", "causal-umx"])
def test_the_layouts_at_h_256_384_and_512(H, C, smem, w_smem):
    layout = ls.cluster_bwd_layout(H, C)
    assert layout["smem_bytes"] == smem and layout["w_smem_bytes"] == w_smem
    if H == 256:  # all of W in registers: eight row blocks of eight values
        assert layout["row_blocks"] == layout["reg_blocks"] == 8
    if H == 512:  # half of W in registers, half (128 KB) in shared memory
        assert layout["row_blocks"] == 16 and layout["warps"] == 16


@pytest.mark.parametrize("H,C", [(384, 8), (512, 8), (128, 8), (128, 16), (320, 16), (640, 16),
                                 (256, 4), (256, 32), (192, 8), (1024, 16)])
def test_shapes_the_kernel_does_not_take(H, C):
    assert ls.cluster_bwd_layout(H, C) is None
    assert C not in ls._cluster_sizes(H, backward=True)


def _reduce(partials):
    """partials (32 lanes, 2 units): the kernel's reduction -> (2,) totals.

    xor 16: each half keeps one unit (the lower half unit 0) and adds its
    partner's copy of it; xor 8, 4, 2, 1 sum it. Every lane of half h ends with
    unit h's total; the model reads lanes 0 and 16."""
    s = [np.float32(partials[lane, lane >> 4] + partials[lane ^ 16, lane >> 4])
         for lane in range(32)]
    for bit in (8, 4, 2, 1):
        s = [np.float32(s[lane] + s[lane ^ bit]) for lane in range(32)]
    return np.array([s[0], s[16]], dtype=np.float32)


def _sigmoid(x):
    return np.float32(1) / (np.float32(1) + np.exp(-x))


def partitioned_lstm_bwd(gates, cs, g_hs, w, C, lanes):
    """The cluster backward's steps in numpy, f32: C ranks, each with its own da buffer
    (unit-major), t from T - 1 down to 0 -> das (B, T, 4H)."""
    B, T, four_h = gates.shape
    H = four_h // 4
    warps = H // C // ls.CLUSTER_UNITS_PER_WARP
    das = np.zeros((B, T, 4 * H), np.float32)
    for b in range(B):
        dabuf = [np.zeros(4 * H, np.float32) for _ in range(C)]  # each rank's copy of da
        dc_rec = np.zeros(H, np.float32)
        for t in reversed(range(T)):
            new = np.zeros(4 * H, np.float32)
            for r in range(C):
                for wp in range(warps):
                    units = _units(H, C, r, wp)
                    partials = np.zeros((32, 2), np.float32)
                    for lane in range(lanes):
                        for u, unit in enumerate(units):
                            acc = np.float32(0)
                            for k in _da_units(H, lane, lanes):
                                for q in range(4):
                                    acc = np.float32(acc + dabuf[r][4 * k + q] * w[unit, q * H + k])
                            partials[lane, u] = acc
                    dh_rec = _reduce(partials)
                    for u, unit in enumerate(units):
                        gi, gf, go = (_sigmoid(gates[b, t, q * H + unit]) for q in (0, 1, 3))
                        gg = np.tanh(gates[b, t, 2 * H + unit])
                        tc = np.tanh(cs[b, t, unit])
                        cp = cs[b, t - 1, unit] if t > 0 else np.float32(0)
                        dh = g_hs[b, t, unit] + dh_rec[u]
                        dc = dc_rec[unit] + dh * go * (1 - tc * tc)
                        da = [dc * gg * gi * (1 - gi), dc * cp * gf * (1 - gf),
                              dc * gi * (1 - gg * gg), dh * tc * go * (1 - go)]
                        dc_rec[unit] = dc * gf
                        for q in range(4):
                            new[4 * unit + q] = da[q]  # sent to every rank
                            das[b, t, q * H + unit] = da[q]
            dabuf = [new.copy() for _ in range(C)]
    return das


def test_the_partitioned_step_is_the_plain_backward():
    # H = 32 on 4 ranks of 8 units (4 warps of 2), 8 lanes a warp: lane l reads units
    # 8 jb + l of the 4 row blocks of 32 values, as 32 lanes cover a 128-value row
    # block on the card.
    B, T, H, C = 2, 7, 32, 4
    rng = np.random.default_rng(0)
    xw = torch.from_numpy((0.5 * rng.standard_normal((B, T, 4 * H))).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-H ** -0.5, H ** -0.5, (H, 4 * H)).astype(np.float32))
    g_hs = torch.from_numpy(rng.standard_normal((B, T, H)).astype(np.float32))
    hs, cs = ls.lstm_forward_reference(xw, w)
    gates = ls._gates(xw, w, ls._shifted(hs))
    got = partitioned_lstm_bwd(gates.numpy(), cs.numpy(), g_hs.numpy(), w.numpy(), C, lanes=8)
    want = ls.lstm_scan_bwd_reference(xw, w, hs, cs, g_hs)[0].numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
