"""The layout the cluster kernel of the LSTM forward is launched with (CPU).

`csrc/recurrence_cluster.cuh` spreads one sequence of one chain over a
cluster of C blocks: rank r owns hidden units [r H/C, (r+1) H/C) and their
four gate columns of W_hh, two units a warp; lane l of a warp owns rows
128 jb + 4 l + e (e = 0..3) of every 128-row block jb, the first two row
blocks in registers and the rest in shared memory, beside two mbarriers, the
double-buffered h and a padded staging tile. `ops/lstm_scan.py:cluster_layout`
mirrors the kernel's `shape_ok` and `smem_bytes`. Here: every unit, gate column and row
is owned exactly once, every layout fits a block, and a numpy model of the
partitioned step (each rank's partial sums over its lanes' rows, the lane
reduction, the cell update of its units, then h "exchanged" into every
rank's buffer) equals the plain recurrence. The kernel itself is held to
the plain version on the card by chip_smoke.py phase 3h.
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


def _rows(H, lane, lanes=32):
    """The W_hh rows lane `lane` of every warp owns: 4 lane + e in each block of 4 x lanes."""
    block = 4 * lanes
    return [block * jb + 4 * lane + e for jb in range(H // block) for e in range(4)]


@pytest.mark.parametrize("H,C", VALID, ids=[f"H={H}-C={C}" for H, C in VALID])
def test_every_unit_gate_column_and_row_is_owned_once(H, C):
    layout = ls.cluster_layout(H, C)
    units = [u for r in range(C) for w in range(layout["warps"]) for u in _units(H, C, r, w)]
    assert sorted(units) == list(range(H))
    columns = [q * H + u for u in units for q in range(4)]
    assert sorted(columns) == list(range(4 * H))
    rows = [k for lane in range(32) for k in _rows(H, lane)]
    assert sorted(rows) == list(range(H))
    # A rank's units are its own block of H / C, and each thread holds the W_hh
    # values of its rows x its warp's units x 4 gates, split over registers and
    # shared memory by row block.
    assert layout["units"] == H // C and layout["threads"] == 32 * layout["warps"]
    per_thread = len(_rows(H, 0)) * ls.CLUSTER_UNITS_PER_WARP * 4
    assert per_thread == layout["row_blocks"] * 32
    reg_floats = layout["reg_blocks"] * 32
    assert reg_floats == 64  # of the 128 registers a thread has
    smem_blocks = layout["row_blocks"] - layout["reg_blocks"]
    assert (per_thread - reg_floats) * layout["threads"] * 4 == smem_blocks * 128 * 4 * H // C * 4
    assert per_thread * layout["threads"] == H * 4 * layout["units"]  # the rank's slice


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,C", VALID, ids=[f"H={H}-C={C}" for H, C in VALID])
def test_every_layout_fits_a_block(H, C, dtype):
    layout = ls.cluster_layout(H, C, dtype)
    size = torch.tensor([], dtype=dtype).element_size()
    units = H // C
    h_buffers = 16 + 2 * H * 4  # two mbarriers, then h
    staging = 128 * (4 * units + 1) * 4
    w_smem = (layout["row_blocks"] - layout["reg_blocks"]) * 128 * 4 * units * size
    assert layout["w_smem_bytes"] == w_smem
    assert layout["smem_bytes"] == max(h_buffers + w_smem + staging, ls.OWN_SM)
    assert layout["smem_bytes"] <= SHARED_LIMIT
    assert layout["threads"] <= ls.CLUSTER_MAX_THREADS
    # 64 registers of W a thread leave 64 for the rest at 128 a thread.
    assert layout["threads"] * 128 <= REGISTERS


@pytest.mark.parametrize("H,C,smem", [(256, 8, 122880), (256, 16, 122880), (512, 16, 201232)],
                         ids=["umx-C=8", "umx-C=16", "causal-umx"])
def test_the_served_shapes_layouts(H, C, smem):
    layout = ls.cluster_layout(H, C)
    assert layout["smem_bytes"] == smem
    if H == 512:  # half of W in registers, half (128 KB) in shared memory
        assert layout["w_smem_bytes"] == 128 * 1024 and layout["warps"] == 16


@pytest.mark.parametrize("H,C", [(384, 8), (512, 8), (128, 8), (128, 16), (320, 16), (640, 16),
                                 (256, 4), (256, 32), (192, 8)])
def test_shapes_the_kernel_does_not_take(H, C):
    assert ls.cluster_layout(H, C) is None


def _butterfly(partials):
    """partials (32 lanes, 8 values): the kernel's transposed reduction -> (8,) totals.

    xor 16, 8, 4: each lane keeps half of its values and adds its partner's
    copy of them; xor 2, 1: the sum of the last one. Lane l ends with value
    l // 4, which the model reads back in that order."""
    vals = [list(p) for p in partials]
    for bit, width in ((16, 8), (8, 4), (4, 2)):
        new = []
        for lane in range(32):
            hi = bool(lane & bit)
            mine = vals[lane][width // 2:] if hi else vals[lane][:width // 2]
            theirs = vals[lane ^ bit][width // 2:] if hi else vals[lane ^ bit][:width // 2]
            new.append([np.float32(a + b) for a, b in zip(mine, theirs)])
        vals = new
    s = [v[0] for v in vals]
    for bit in (2, 1):
        s = [np.float32(s[lane] + s[lane ^ bit]) for lane in range(32)]
    return np.array([s[4 * v] for v in range(8)], dtype=np.float32)


def _sigmoid(x):
    return np.float32(1) / (np.float32(1) + np.exp(-x))


def partitioned_lstm(xw, w, C, lanes):
    """The cluster kernel's step in numpy, f32: C ranks, each with its own h buffer."""
    B, T, four_h = xw.shape
    H = four_h // 4
    warps = H // C // ls.CLUSTER_UNITS_PER_WARP
    hs = np.zeros((B, T, H), np.float32)
    for b in range(B):
        hbuf = [np.zeros(H, np.float32) for _ in range(C)]  # each rank's copy of h
        c = np.zeros(H, np.float32)
        for t in range(T):
            new = np.zeros(H, np.float32)
            for r in range(C):
                for wp in range(warps):
                    units = _units(H, C, r, wp)
                    partials = np.zeros((32, 8), np.float32)
                    for lane in range(lanes):
                        rows = _rows(H, lane, lanes)
                        for u, unit in enumerate(units):
                            for q in range(4):
                                col = w[rows, q * H + unit]
                                acc = np.float32(0)
                                for k, wk in zip(rows, col):
                                    acc = np.float32(acc + hbuf[r][k] * wk)
                                partials[lane, 4 * u + q] = acc
                    gates = _butterfly(partials).reshape(2, 4)
                    for u, unit in enumerate(units):
                        gi, gf, gg, go = gates[u] + xw[b, t, [q * H + unit for q in range(4)]]
                        c[unit] = _sigmoid(gf) * c[unit] + _sigmoid(gi) * np.tanh(gg)
                        new[unit] = _sigmoid(go) * np.tanh(c[unit])
            hbuf = [new.copy() for _ in range(C)]  # every rank publishes into every rank
            hs[b, t] = new
    return hs


def test_the_partitioned_step_is_the_plain_recurrence():
    # H = 32 on 4 ranks of 8 units (4 warps of 2), 8 lanes a warp: rows 4 l + e
    # cover the 32 rows once, as 32 lanes cover a 128-row block on the card.
    B, T, H, C = 2, 7, 32, 4
    rng = np.random.default_rng(0)
    xw = (0.5 * rng.standard_normal((B, T, 4 * H))).astype(np.float32)
    w = rng.uniform(-H ** -0.5, H ** -0.5, (H, 4 * H)).astype(np.float32)
    got = partitioned_lstm(xw, w, C, lanes=8)
    want = ls.lstm_steps(torch.from_numpy(xw), torch.from_numpy(w))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
