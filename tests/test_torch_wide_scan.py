"""The layout the wide kernel of the LSTM forward is launched with, and its step (CPU).

`csrc/recurrence_wide.cuh` runs an M-row tile of independent sequences of one chain on a
cluster of C blocks at H = 256, and at 384 (H = 300 zero-padded): rank r owns hidden units
[r H/C, (r+1) H/C) and their
four gate columns of W_hh, staged once into its shared memory in mma fragment order;
warp (wm, wu) owns 8 units x 16 rows of each of its m16 tiles (one a warp; two in f32
where the tile has two, and where one would pass WIDE_MAX_WARPS warps); h is written by every rank into every rank's
double-buffered tile, rank-major (a rank's columns one block).
`ops/lstm_scan.py:wide_layout` mirrors the kernel's `shape_ok`, `Geometry` and
`smem_bytes`. Here: every layout the plan can return fits a block and the others are
refused, every unit, gate column and row is owned once, and a numpy model of the
partitioned step (each rank's W slice staged by the kernel's index map and read back as
m16n8k16 or m16n8k8 B fragments, A read from the rank-major tile, the warps' products of
their rows and units, the cell in registers, each rank's block "exchanged" into every
rank's tile, rows past B zero-filled and never stored) equals the plain recurrence. The kernel itself is held to
the plain version on the card by chip_smoke.py phase 3i.
"""
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.ops import lstm_scan as ls

SHARED_LIMIT = 232448  # a Hopper block's dynamic shared memory, bytes
REGISTERS = 65536  # 32-bit registers of an SM
BF16, F32 = torch.bfloat16, torch.float32
TILES = [(dtype, m, c) for dtype in (BF16, F32) for c in ls.WIDE_CLUSTER_SIZES[dtype]
         for m in ls.WIDE_TILE_ROWS if ls.wide_layout(256, m, c, dtype)]
TILE_IDS = [f"{str(d)[6:]}-M={m}-C={c}" for d, m, c in TILES]


def test_the_tiles_of_each_dtype():
    assert [(m, c) for d, m, c in TILES if d == BF16] == [
        (16, 4), (32, 4), (64, 4), (16, 8), (32, 8), (64, 8)]
    # f32 at M = 64 on 8-block clusters: 128 KB of W and 144 KB of h do not fit.
    assert [(m, c) for d, m, c in TILES if d == F32] == [
        (16, 8), (32, 8), (16, 16), (32, 16), (64, 16)]
    assert ls._wide_tiles(256, BF16) == [(m, c) for d, m, c in TILES if d == BF16]


@pytest.mark.parametrize("dtype,M,C", TILES, ids=TILE_IDS)
def test_every_tile_the_plan_can_return_fits_a_block(dtype, M, C):
    layout = ls.wide_layout(256, M, C, dtype)
    size = torch.tensor([], dtype=dtype).element_size()
    units = 256 // C
    assert layout["units"] == units
    assert layout["w_smem_bytes"] == 256 * 4 * units * size  # the rank's slice of W_hh
    # two h tiles, rank-major: C blocks of M rows of H / C values, each row padded
    assert layout["h_smem_bytes"] == 2 * C * M * (units * size + 16)
    need = 16 + layout["w_smem_bytes"] + layout["h_smem_bytes"]
    assert layout["smem_bytes"] == max(need, ls.OWN_SM) <= SHARED_LIMIT
    assert layout["warps"] <= ls.WIDE_MAX_WARPS and layout["threads"] == 32 * layout["warps"]
    # warps over units x warps over rows, each with tiles_per_warp m16 tiles
    assert layout["warps"] * layout["tiles_per_warp"] == units // 8 * (M // 16)
    # two m16 tiles a warp where one would pass WIDE_MAX_WARPS warps, and in f32 wherever
    # the tile has two (a W split serves both)
    two = units // 8 * (M // 16) > ls.WIDE_MAX_WARPS or (dtype == F32 and M >= 32)
    assert layout["tiles_per_warp"] == (2 if two else 1)
    assert layout["threads"] * 128 <= REGISTERS  # at least 128 registers a thread


@pytest.mark.parametrize("dtype,M,C", [
    (F32, 64, 8),  # 128 KB of W beside 144 KB of h
    (BF16, 16, 16), (BF16, 64, 2), (F32, 16, 4), (F32, 32, 32),  # cluster sizes of the other dtype
    (BF16, 128, 4), (F32, 8, 8), (BF16, 48, 4),  # tile rows
    (torch.float16, 16, 4),
], ids=["f32-M=64-C=8", "bf16-C=16", "bf16-C=2", "f32-C=4", "f32-C=32", "M=128", "M=8", "M=48",
        "f16"])
def test_tiles_the_kernel_does_not_take(dtype, M, C):
    assert ls.wide_layout(256, M, C, dtype) is None


# H = 384 runs H = 300 zero-padded: 144 KB of W a rank leaves f32 (16, 16) and bf16 (16, 8)
# and (32, 8); no other width takes the kernel.
TILES_384 = {F32: [(16, 16)], BF16: [(16, 8), (32, 8)]}


@pytest.mark.parametrize("H", [128, 192, 384, 512, 1024])
def test_only_h_256_takes_the_wide_kernel(H):
    want = TILES_384 if H == 384 else {F32: [], BF16: []}
    assert ls._wide_tiles(H, F32) == want[F32] and ls._wide_tiles(H, BF16) == want[BF16]
    assert all(ls.wide_layout(H, m, c, d) is None for d, m, c in TILES
               if (m, c) not in want[d])


@pytest.mark.parametrize("dtype,M,C,smem,warps,per_warp", [
    (F32, 16, 16, 204816, 3, 1), (BF16, 16, 8, 176144, 6, 1), (BF16, 32, 8, 204816, 12, 1),
], ids=["f32-M=16-C=16", "bf16-M=16-C=8", "bf16-M=32-C=8"])
def test_the_h_384_tiles_layouts(dtype, M, C, smem, warps, per_warp):
    layout = ls.wide_layout(384, M, C, dtype)
    size = torch.tensor([], dtype=dtype).element_size()
    assert layout["units"] == 384 // C
    assert layout["w_smem_bytes"] == 384 * 4 * (384 // C) * size == 147456
    assert layout["h_smem_bytes"] == 2 * C * M * ((384 // C) * size + 16)
    assert layout["smem_bytes"] == smem <= SHARED_LIMIT
    assert (layout["warps"], layout["tiles_per_warp"]) == (warps, per_warp)
    # a k-step's columns lie in one rank's block: H / C a multiple of k (16 bf16, 8 f32)
    assert layout["units"] % (16 if dtype == BF16 else 8) == 0
    assert sorted(_owned(384, M, C, ls.WIDE_MAX_WARPS, pair=dtype == F32)) == [
        (u, r) for u in range(384) for r in range(M)]


@pytest.mark.parametrize("dtype,M,C", [
    (F32, 16, 8), (F32, 32, 16), (F32, 64, 16), (BF16, 16, 4), (BF16, 64, 8),
], ids=["f32-C=8", "f32-M=32", "f32-M=64", "bf16-C=4", "bf16-M=64"])
def test_h_384_tiles_that_do_not_fit(dtype, M, C):
    assert ls.wide_layout(384, M, C, dtype) is None


@pytest.mark.parametrize("dtype,M,C,smem", [
    (BF16, 64, 4, 204816), (BF16, 32, 4, 167952), (F32, 32, 8, 204816), (F32, 64, 16, 229392),
    (BF16, 16, 8, 122880),
], ids=["bf16-serve", "bf16-causal", "f32-serve", "f32-M=64", "bf16-own-sm"])
def test_the_dptnet_tiles_layouts(dtype, M, C, smem):
    assert ls.wide_layout(256, M, C, dtype)["smem_bytes"] == smem


def _geometry(H, M, C, max_warps, pair=False):
    """The kernel's Geometry: (units a rank, warps over units, m16 tiles a warp, warps over
    rows); `pair`: two m16 tiles a warp wherever the tile has two (f32)."""
    hu = H // C
    nwu = hu // 8
    mtw = (nwu * (M // 16) // max_warps if nwu * (M // 16) > max_warps
           else 2 if pair and M >= 32 else 1)
    return hu, nwu, mtw, M // 16 // mtw


def _owned(H, M, C, max_warps, pair=False):
    """(unit, row) of every fragment position of every thread of every rank and warp."""
    hu, nwu, mtw, nwm = _geometry(H, M, C, max_warps, pair)
    for rank in range(C):
        for warp in range(nwu * nwm):
            wu, wm = warp % nwu, warp // nwu
            for lane in range(32):
                gid, tig = lane >> 2, lane & 3
                for mt in range(mtw):
                    for j in range(4):
                        yield (rank * hu + 8 * wu + 2 * tig + (j & 1),
                               16 * (wm * mtw + mt) + gid + 8 * (j >> 1))


@pytest.mark.parametrize("dtype,M,C", TILES, ids=TILE_IDS)
def test_every_unit_and_row_is_owned_once(dtype, M, C):
    owned = sorted(_owned(256, M, C, ls.WIDE_MAX_WARPS, pair=dtype == F32))
    hu, nwu, mtw, nwm = _geometry(256, M, C, ls.WIDE_MAX_WARPS, pair=dtype == F32)
    layout = ls.wide_layout(256, M, C, dtype)
    assert (layout["tiles_per_warp"], layout["warps"]) == (mtw, nwu * nwm)
    assert owned == [(u, r) for u in range(256) for r in range(M)]


def stage(w, rank, C, kk):
    """A rank's W slice as the kernel stages it: word i = (((ks NWU + wu) 4 + q) 32 + l) 2
    + e holds column q H + rank H/C + 8 wu + l / 4 at row kk ks + 2 (l % 4) + 8 e (and the
    row after it: the pair of a bf16 word, kk = 16) or at row 8 ks + l % 4 + 4 e (f32,
    kk = 8). -> [KS][NWU][4][32][2] (bf16: [..][2] pairs of rows)."""
    H = w.shape[0]
    hu = H // C
    nwu, ks_n = hu // 8, H // kk
    pairs = kk == 16
    out = np.zeros((ks_n, nwu, 4, 32, 2, 2 if pairs else 1), w.dtype)
    for i in range(ks_n * nwu * 4 * 32 * 2):
        e, lane, q = i & 1, (i >> 1) & 31, (i >> 6) & 3
        rest = i >> 8
        wu, ks = rest % nwu, rest // nwu
        col = q * H + rank * hu + 8 * wu + (lane >> 2)
        if pairs:
            row = kk * ks + 2 * (lane & 3) + 8 * e
            out[ks, wu, q, lane, e] = w[row:row + 2, col]
        else:
            out[ks, wu, q, lane, e, 0] = w[kk * ks + (lane & 3) + 4 * e, col]
    return out


def b_tile(frags, kk):
    """The kk x 8 B matrix that 32 lanes' fragments of one gate and k-step hold: m16n8k16
    (b0 = rows 2 tig, 2 tig + 1; b1 = rows 2 tig + 8, + 9; column gid) or m16n8k8 (b0 =
    row tig, b1 = row tig + 4)."""
    b = np.zeros((kk, 8), frags.dtype)
    for lane in range(32):
        gid, tig = lane >> 2, lane & 3
        for e in range(2):
            if kk == 16:
                b[2 * tig + 8 * e:2 * tig + 8 * e + 2, gid] = frags[lane, e]
            else:
                b[tig + 4 * e, gid] = frags[lane, e, 0]
    return b


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def partitioned_lstm(xw, w, M, C, kk, max_warps):
    """The wide kernel's steps in numpy (f64): tiles of M rows (rows past B zero), C ranks
    with their own rank-major h tiles ([C][M][H/C]: a rank's columns one block) and staged
    W slices, warps over units and rows, A read from block kk ks / (H/C) at column
    kk ks % (H/C), the product from B fragments, the cell of each fragment position, each
    rank's block written into every rank's tile."""
    B, T, four_h = xw.shape
    H = four_h // 4
    hu, nwu, mtw, nwm = _geometry(H, M, C, max_warps)
    assert kk <= hu  # a k-step's columns lie in one rank's block
    slices = [stage(w, r, C, kk) for r in range(C)]
    hs = np.zeros((B, T, H))
    for b0 in range(0, B, M):
        x = np.zeros((M, T, four_h))
        x[:min(M, B - b0)] = xw[b0:b0 + M]
        tiles = [np.zeros((C, M, hu)) for _ in range(C)]  # each rank's h tile
        c = np.zeros((M, H))
        for t in range(T):
            blocks = np.zeros((C, M, hu))  # each rank's new block
            for rank in range(C):
                for warp in range(nwu * nwm):
                    wu, wm = warp % nwu, warp // nwu
                    cols = 8 * wu + np.arange(8)  # in the rank's block
                    units = rank * hu + cols
                    for mt in range(mtw):
                        rows = 16 * (wm * mtw + mt) + np.arange(16)
                        acc = np.stack([x[rows, t][:, q * H + units] for q in range(4)])
                        for ks in range(H // kk):
                            blk, col = divmod(kk * ks, hu)
                            a = tiles[rank][blk][rows, col:col + kk]
                            for q in range(4):
                                acc[q] += a @ b_tile(slices[rank][ks, wu, q], kk)
                        gi, gf, gg, go = acc
                        c[np.ix_(rows, units)] = (_sigmoid(gf) * c[np.ix_(rows, units)]
                                                  + _sigmoid(gi) * np.tanh(gg))
                        blocks[rank][np.ix_(rows, cols)] = (
                            _sigmoid(go) * np.tanh(c[np.ix_(rows, units)]))
            tiles = [blocks.copy() for _ in range(C)]  # every rank's block into every rank
            n = min(M, B - b0)
            hs[b0:b0 + n, t] = blocks.transpose(1, 0, 2).reshape(M, H)[:n]  # rows past B dropped
    return hs


@pytest.mark.parametrize("M,C,kk,max_warps", [
    (16, 2, 16, 16),  # m16n8k16 fragments (bf16's), one m16 tile, two ranks
    (32, 2, 8, 16),  # m16n8k8 fragments (f32's), two row warps
    (32, 2, 16, 2),  # two m16 tiles a warp, as at bf16 M = 64 on 4-block clusters
    (16, 4, 8, 16),  # 8 units a rank: one warp over units
], ids=["k16", "k8", "two-tiles-a-warp", "C=4"])
def test_the_partitioned_step_is_the_plain_recurrence(M, C, kk, max_warps):
    # H = 32 (H / C units a rank, 8 a warp); B = 21 leaves rows past B in the last tile.
    B, T, H = 21, 5, 32
    rng = np.random.default_rng(M + C + kk)
    xw = 0.5 * rng.standard_normal((B, T, 4 * H))
    w = rng.uniform(-H ** -0.5, H ** -0.5, (H, 4 * H))
    got = partitioned_lstm(xw, w, M, C, kk, max_warps)
    want = ls.lstm_scan_reference(torch.from_numpy(xw), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("H,C,M,kk", [(48, 2, 16, 8), (96, 2, 32, 16)],
                         ids=["24-units-k8", "48-units-k16"])
def test_the_partitioned_step_with_h_384s_unit_split_is_the_plain_recurrence(H, C, M, kk):
    # A rank's units as at H = 384: 24 (f32, C = 16: three warps over units) and 48 (bf16,
    # C = 8: six), no power of two; B = 21 leaves rows past B.
    B, T = 21, 4
    rng = np.random.default_rng(H + kk)
    xw = 0.5 * rng.standard_normal((B, T, 4 * H))
    w = rng.uniform(-H ** -0.5, H ** -0.5, (H, 4 * H))
    got = partitioned_lstm(xw, w, M, C, kk, ls.WIDE_MAX_WARPS)
    want = ls.lstm_scan_reference(torch.from_numpy(xw), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kk", [16, 8], ids=["k16", "k8"])
def test_the_staged_fragments_are_the_slice_of_w(kk):
    # Every value of a rank's H x 4H/C slice is staged once, read back as B fragments.
    H, C = 64, 2
    w = np.arange(H * 4 * H, dtype=np.float64).reshape(H, 4 * H)
    for rank in range(C):
        staged = stage(w, rank, C, kk)
        hu = H // C
        for ks in range(H // kk):
            for wu in range(hu // 8):
                for q in range(4):
                    cols = q * H + rank * hu + 8 * wu + np.arange(8)
                    np.testing.assert_array_equal(b_tile(staged[ks, wu, q], kk),
                                                  w[kk * ks:kk * (ks + 1)][:, cols])
        assert sorted(staged.ravel()) == sorted(
            w[:, [q * H + rank * hu + u for q in range(4) for u in range(hu)]].ravel())
