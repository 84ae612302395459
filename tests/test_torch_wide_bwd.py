"""The layout the wide kernel of the LSTM backward is launched with, and its reverse step (CPU).

`csrc/recurrence_wide_bwd.cuh` runs the reverse recurrence of an M-row tile of
independent sequences of one chain on a cluster of C blocks at H = 256: rank r owns
hidden units [r H/C, (r+1) H/C), derives their da from their gates, c and dh, and keeps
their four gate columns of W_hh (H x 4H/C) in shared memory as B fragments of W_own^T.
The recurrent product is a reduce-scatter: each rank multiplies its own columns of da,
read back from a padded tile as m16n8k8 A fragments, by W_own^T into a partial sum for
all H units (split TF32: three products in f32, two in bf16), writes the block of each
rank's units into that rank's slot, and one bulk copy a peer moves it; each rank sums
the C blocks it receives in the order of the ranks. `ops/lstm_scan.py:wide_bwd_layout`
mirrors the kernel's `shape_ok` and `smem_bytes`. Here: every tile the plan can return
fits a block and the others are refused, every unit, gate column, row and partial block
is owned once, and a numpy model of the partitioned reverse step (W staged by the
kernel's index map and read back as fragments, A fragments through ldmatrix's addressing,
each rank's partial dh in emulated split TF32, the blocks "copied" into the peers' tiles
and summed in rank order, rows past B zero-filled and never stored) equals
`lstm_scan_bwd_reference` and JAX's `_lstm_bwd_core` (`jax.vjp` of the Pallas kernels in
interpret mode). The kernel itself is held to the plain version on the card by
chip_smoke.py phase 3j.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.ops import lstm_scan as ls
from dnn_based_source_separation_tpu.ops import pallas_lstm as jpl

SHARED_LIMIT = 232448  # a Hopper block's dynamic shared memory, bytes
REGISTERS = 65536  # 32-bit registers of an SM
H = 256
BF16, F32 = torch.bfloat16, torch.float32
TILES = [(dtype, m, c) for dtype in (BF16, F32) for c in ls.WIDE_CLUSTER_SIZES[dtype]
         for m in ls.WIDE_TILE_ROWS if ls.wide_bwd_layout(H, m, c, dtype)]
TILE_IDS = [f"{str(d)[6:]}-M={m}-C={c}" for d, m, c in TILES]
RTOL = 1e-5  # f32, relative to max|ref| (tests/test_torch_lstm_grad.py's limit)


def test_the_tiles_of_each_dtype():
    # bf16 (32, 4): 128 KB of W, 72 KB received and 32.5 KB of da do not fit; M = 64 never
    # fits: its receive tile alone takes 144-192 KB.
    assert [(m, c) for d, m, c in TILES if d == BF16] == [(16, 4), (16, 8), (32, 8)]
    assert [(m, c) for d, m, c in TILES if d == F32] == [(16, 8), (32, 8), (16, 16), (32, 16)]
    for dtype in (BF16, F32):
        assert ls._wide_tiles(H, dtype, backward=True) == [(m, c) for d, m, c in TILES
                                                           if d == dtype]


@pytest.mark.parametrize("dtype,M,C", TILES, ids=TILE_IDS)
def test_every_tile_the_plan_can_return_fits_a_block(dtype, M, C):
    layout = ls.wide_bwd_layout(H, M, C, dtype)
    size = torch.tensor([], dtype=dtype).element_size()
    units = H // C
    assert layout["units"] == units and layout["columns"] == 4 * units
    assert layout["w_smem_bytes"] == H * 4 * units * size  # the forward's slice of W_hh
    assert layout["da_smem_bytes"] == 4 * M * (4 * units + 4)  # rows padded by 16 bytes
    # two receive buffers of C blocks of M rows of H / C f32, each row padded by 32 bytes
    assert layout["block_bytes"] == 4 * M * (units + 8)
    assert layout["recv_smem_bytes"] == 2 * C * layout["block_bytes"]
    need = 16 + layout["w_smem_bytes"] + layout["da_smem_bytes"] + layout["recv_smem_bytes"]
    assert layout["smem_bytes"] == max(need, ls.OWN_SM) <= SHARED_LIMIT
    # one bulk copy of a block to each peer: 16-byte multiples
    assert layout["block_bytes"] % 16 == 0
    assert layout["sent_bytes"] == (C - 1) * layout["block_bytes"]
    assert layout["threads"] == 32 * layout["warps"] == 256
    assert layout["cell_tiles"] == M // 16 * (units // 8) <= layout["warps"]
    assert layout["n_tiles_per_warp"] * 8 * layout["warps"] == H
    assert layout["threads"] * 255 <= REGISTERS  # the most registers a thread can have


@pytest.mark.parametrize("dtype,M,C", [
    (F32, 64, 8), (F32, 64, 16), (BF16, 32, 4), (BF16, 64, 4), (BF16, 64, 8),  # too large
    (BF16, 16, 16), (BF16, 16, 2), (F32, 16, 4), (F32, 32, 32),  # the other dtype's sizes
    (F32, 8, 8), (BF16, 48, 8), (F32, 128, 16),  # tile rows
    (torch.float16, 16, 8),
], ids=["f32-M=64-C=8", "f32-M=64-C=16", "bf16-M=32-C=4", "bf16-M=64-C=4", "bf16-M=64-C=8",
        "bf16-C=16", "bf16-C=2", "f32-C=4", "f32-C=32", "M=8", "M=48", "M=128", "f16"])
def test_tiles_the_kernel_does_not_take(dtype, M, C):
    assert ls.wide_bwd_layout(H, M, C, dtype) is None


# H = 384 runs H = 300 zero-padded: 144 KB of W a rank leaves M = 16 at f32 C = 16 and bf16
# C = 8; no other width takes the kernel.
TILES_384 = {F32: [(16, 16)], BF16: [(16, 8)]}


@pytest.mark.parametrize("hidden", [128, 192, 384, 512, 1024])
def test_only_h_256_takes_the_wide_backward(hidden):
    want = TILES_384 if hidden == 384 else {F32: [], BF16: []}
    assert ls._wide_tiles(hidden, F32, True) == want[F32]
    assert ls._wide_tiles(hidden, BF16, True) == want[BF16]
    assert all(ls.wide_bwd_layout(hidden, m, c, d) is None for d, m, c in TILES
               if (m, c) not in want[d])


@pytest.mark.parametrize("dtype,M,C,smem,cell_tiles", [
    (F32, 16, 16, 219408, 3), (BF16, 16, 8, 217360, 6),
], ids=["f32-M=16-C=16", "bf16-M=16-C=8"])
def test_the_h_384_tiles_layouts(dtype, M, C, smem, cell_tiles):
    layout = ls.wide_bwd_layout(384, M, C, dtype)
    units = 384 // C
    assert layout["w_smem_bytes"] == 147456 and layout["units"] == units
    assert layout["da_smem_bytes"] == 4 * M * (4 * units + 4)
    assert layout["block_bytes"] == 4 * M * (units + 8) and layout["block_bytes"] % 16 == 0
    assert layout["smem_bytes"] == smem <= SHARED_LIMIT
    assert layout["cell_tiles"] == cell_tiles <= layout["warps"]
    assert layout["n_tiles_per_warp"] == 6  # 48 output units a warp
    everything = [(u, r) for u in range(384) for r in range(M)]
    assert sorted(_cell_positions(M, C, hidden=384)) == everything
    assert sorted(_product_outputs(M, hidden=384)) == everything


@pytest.mark.parametrize("dtype,M,C", [(F32, 32, 16), (BF16, 32, 8), (F32, 16, 8),
                                       (BF16, 16, 4)],
                         ids=["f32-M=32", "bf16-M=32", "f32-C=8", "bf16-C=4"])
def test_h_384_tiles_that_do_not_fit(dtype, M, C):
    assert ls.wide_bwd_layout(384, M, C, dtype) is None


@pytest.mark.parametrize("dtype,M,C,smem", [
    (F32, 32, 8, 229904), (F32, 16, 8, 180496), (F32, 32, 16, 172560), (BF16, 16, 4, 184592),
    (F32, 16, 16, 122880),
], ids=["f32-train", "f32-causal-train", "f32-C=16", "bf16-C=4", "f32-own-sm"])
def test_the_dptnet_tiles_layouts(dtype, M, C, smem):
    assert ls.wide_bwd_layout(H, M, C, dtype)["smem_bytes"] == smem


def _cell_positions(M, C, warps=ls.WIDE_BWD_WARPS, hidden=H):
    """(unit, row) of every cell position of every thread: warp w < (M / 16) (H / 8C) runs
    cell tile (w / (H / 8C), w % (H / 8C)) of 16 rows x 8 units, a lane rows gid, gid + 8
    and units 2 tig, 2 tig + 1 of it."""
    hu = hidden // C
    for rank in range(C):
        for warp in range(min(warps, M // 16 * (hu // 8))):
            cm, cu = divmod(warp, hu // 8)
            for lane in range(32):
                gid, tig = lane >> 2, lane & 3
                for h in range(2):
                    for e in range(2):
                        yield rank * hu + 8 * cu + 2 * tig + e, 16 * cm + gid + 8 * h


def _product_outputs(M, warps=ls.WIDE_BWD_WARPS, hidden=H):
    """(unit, row) of every C-fragment position of a rank's partial sum: warp w's n8 tiles
    NT w .. NT w + NT - 1 over every m16 tile."""
    nt_per_warp = hidden // 8 // warps
    for warp in range(warps):
        for n in range(nt_per_warp):
            for mt in range(M // 16):
                for lane in range(32):
                    gid, tig = lane >> 2, lane & 3
                    for j in range(4):
                        yield (8 * (nt_per_warp * warp + n) + 2 * tig + (j & 1),
                               16 * mt + gid + 8 * (j >> 1))


@pytest.mark.parametrize("dtype,M,C", TILES, ids=TILE_IDS)
def test_every_unit_gate_column_row_and_partial_block_is_owned_once(dtype, M, C):
    hu = H // C
    everything = [(u, r) for u in range(H) for r in range(M)]
    assert sorted(_cell_positions(M, C)) == everything  # the cell: each (unit, row) once
    # a rank's gate columns (its K), over the cluster every column of 4H once
    columns = [q * H + r * hu + j for r in range(C) for q in range(4) for j in range(hu)]
    assert sorted(columns) == list(range(4 * H))
    # each rank's partial sum: every (unit, row) of the M x H output once
    outputs = sorted(_product_outputs(M))
    assert outputs == everything
    # its blocks: block p holds the units of rank p; rank p's buffer gets block p of each
    # rank r into its slot r, so each (destination, source) pair once
    blocks = {}
    for unit, row in outputs:
        blocks.setdefault(unit // hu, set()).add((unit % hu, row))
    assert sorted(blocks) == list(range(C))
    assert all(cells == {(j, r) for j in range(hu) for r in range(M)} for cells in blocks.values())
    slots = sorted((p, r) for r in range(C) for p in blocks)
    assert slots == [(p, r) for p in range(C) for r in range(C)]


def stage(w, rank, C):
    """A rank's B fragments of W_own^T as the kernel stages them: entry (ks, nt, l), element
    e is W_hh[8 nt + l / 4][column of k = 8 ks + l % 4 + 4 e], column of k = (k / (H/C)) H +
    rank H/C + k % (H/C). -> [KS][H / 8][32][2]."""
    hu = w.shape[0] // C
    ks, nt, lane, e = np.meshgrid(np.arange(4 * hu // 8), np.arange(w.shape[0] // 8),
                                  np.arange(32), np.arange(2), indexing="ij")
    k = 8 * ks + (lane & 3) + 4 * e
    return w[8 * nt + (lane >> 2), (k // hu) * w.shape[0] + rank * hu + k % hu]


def b_matrix(frags):
    """The K x H matrix the fragments hold as m16n8k8 B operands: lane l's element e of
    (ks, nt) is row 8 ks + l % 4 + 4 e, column 8 nt + l / 4."""
    n_ks, n_nt = frags.shape[:2]
    out = np.zeros((8 * n_ks, 8 * n_nt), frags.dtype)
    ks, nt, lane, e = np.meshgrid(np.arange(n_ks), np.arange(n_nt), np.arange(32),
                                  np.arange(2), indexing="ij")
    out[8 * ks + (lane & 3) + 4 * e, 8 * nt + (lane >> 2)] = frags
    return out


def a_matrix(tile):
    """The M x K da tile as the kernel's warps read it: for each m16 tile and k-step, lane l
    gives ldmatrix the row (l & 7) + 8 ((l >> 3) & 1) and the column 4 (l >> 4) of matrix
    l / 8 and gets word l % 4 of row l / 4 of each of the four 8 x 4 matrices: a0..a3, the
    m16n8k8 A fragment (rows gid, gid + 8; columns tig, tig + 4). -> the matrix those
    fragments hold."""
    lane, i = np.arange(32)[:, None], np.arange(4)[None, :]
    gid, tig = lane >> 2, lane & 3
    src = 8 * i + gid  # the lane that gave ldmatrix row gid of matrix i
    src_row, src_col = (src & 7) + 8 * ((src >> 3) & 1), 4 * (src >> 4) + tig
    dst_row, dst_col = gid + 8 * (i & 1), tig + 4 * (i >> 1)  # where a_i sits in the A tile
    M, K = tile.shape
    sub = tile.reshape(M // 16, 16, K // 8, 8).transpose(0, 2, 1, 3)  # [mt][ks][16][8]
    out = np.zeros_like(sub)
    out[:, :, dst_row, dst_col] = sub[:, :, src_row, src_col]
    return out.transpose(0, 2, 1, 3).reshape(M, K)


def test_the_staged_fragments_are_w_own_transposed():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((H, 4 * H))
    for C in (4, 8, 16):
        hu = H // C
        for rank in range(C):
            cols = [q * H + rank * hu + j for q in range(4) for j in range(hu)]
            np.testing.assert_array_equal(b_matrix(stage(w, rank, C)), w[:, cols].T)


def test_ldmatrix_addresses_give_the_a_fragments():
    tile = np.arange(32 * 64, dtype=np.float64).reshape(32, 64)
    np.testing.assert_array_equal(a_matrix(tile), tile)


def _tf32(x):
    """The nearest TF32 value, ties away from zero, as an f32 (the kernel's to_tf32)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _product(a, b, products):
    """a @ b as the tensor cores form it: three TF32 products (lo_a hi_b, hi_a lo_b,
    hi_a hi_b) in f32, or two (lo_a b, hi_a b) where b is a TF32 value (a bf16 W)."""
    a_hi, a_lo = _split(a)
    if products == 2:
        assert np.array_equal(_tf32(b), b)
        return a_lo @ b + a_hi @ b
    b_hi, b_lo = _split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _sigmoid(x):
    return np.float32(1) / (np.float32(1) + np.exp(-x))


def partitioned_lstm_bwd(gates, cs, g_hs, w, M, C, products):
    """The wide backward's steps in numpy, f32: tiles of M rows (rows past B zero), C ranks,
    each with its staged W slice read back as B fragments, its da tile read back as A
    fragments, its partial sum for all H units in emulated split TF32, its blocks "copied"
    into slot r of each rank's next buffer and summed there in rank order; t from T - 1
    down to 0 -> das (B, T, 4H)."""
    B, T, four_h = gates.shape
    hidden = four_h // 4
    hu = hidden // C
    w_own_t = [b_matrix(stage(w, r, C)) for r in range(C)]  # (4 H/C, H) each
    das = np.zeros((B, T, four_h), np.float32)
    for b0 in range(0, B, M):
        n = min(M, B - b0)

        def rows(a):
            out = np.zeros((M,) + a.shape[1:], np.float32)
            out[:n] = a[b0:b0 + n]
            return out

        gt, ct, gh = rows(gates), rows(cs), rows(g_hs)
        received = np.zeros((C, C, M, hu), np.float32)  # [rank][slot r: from rank r]
        dc_rec = np.zeros((M, hidden), np.float32)
        for s in range(T):
            t = T - 1 - s
            sent = np.zeros((C, C, M, hu), np.float32)  # [destination p][source r]
            for rank in range(C):
                units = rank * hu + np.arange(hu)
                dh_rec = np.zeros((M, hu), np.float32)
                for r in range(C):  # in the order of the ranks
                    dh_rec = dh_rec + received[rank, r]
                gi, gf, go = (_sigmoid(gt[:, t, q * hidden + units]) for q in (0, 1, 3))
                gg = np.tanh(gt[:, t, 2 * hidden + units])
                tc = np.tanh(ct[:, t, units])
                cp = ct[:, t - 1, units] if t > 0 else np.zeros((M, hu), np.float32)
                dh = gh[:, t, units] + dh_rec
                dc = dc_rec[:, units] + dh * go * (1 - tc * tc)
                da = np.stack([dc * gg * gi * (1 - gi), dc * cp * gf * (1 - gf),
                               dc * gi * (1 - gg * gg), dh * tc * go * (1 - go)], axis=1)
                dc_rec[:, units] = dc * gf
                assert not da[n:].any()  # rows past B stay zero
                for q in range(4):
                    das[b0:b0 + n, t, q * hidden + units] = da[:n, q]  # rows past B not stored
                if s + 1 < T:
                    tile = da.reshape(M, 4 * hu)  # column q H/C + j: gate q of unit j
                    part = _product(a_matrix(tile), w_own_t[rank], products).astype(np.float32)
                    for p in range(C):
                        sent[p, rank] = part[:, p * hu:(p + 1) * hu]
            received = sent  # rank p's buffer: slot r holds rank r's block for p
    return das


def _chain(rng, B, T, dtype=F32, hidden=H):
    """xw ~ N(0, 0.25), W_hh ~ U(+-1/sqrt(H)), g ~ N(0, 1) at hidden size `hidden`; in bf16
    every array rounded to bf16 and handed on as f32 (what the bf16 kernel reads, widened
    exactly)."""
    xw = (0.5 * rng.standard_normal((B, T, 4 * hidden))).astype(np.float32)
    w = rng.uniform(-hidden ** -0.5, hidden ** -0.5, (hidden, 4 * hidden)).astype(np.float32)
    g = rng.standard_normal((B, T, hidden)).astype(np.float32)
    xw, w, g = (torch.from_numpy(a).to(dtype).float() for a in (xw, w, g))
    hs, cs = ls.lstm_forward_reference(xw, w)
    hs, cs = hs.to(dtype).float(), cs.to(dtype).float()
    return xw, w, hs, cs, g


def _model_grads(chain, M, C, products):
    xw, w, hs, cs, g = chain
    h_prev = ls._shifted(hs)
    gates = ls._gates(xw, w, h_prev)
    das = partitioned_lstm_bwd(gates.numpy(), cs.numpy(), g.numpy(), w.numpy(), M, C, products)
    return das, ls._weight_grad(h_prev, torch.from_numpy(das), torch.float32).numpy()


def _close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    err = np.abs(got - ref).max()
    assert err <= RTOL * np.abs(ref).max(), (what, err, np.abs(ref).max())


@pytest.mark.parametrize("dtype,M,C", TILES, ids=TILE_IDS)
def test_the_partitioned_step_is_the_plain_backward(dtype, M, C):
    # B = 37 leaves rows past B in the last tile of every M.
    rng = np.random.default_rng(M + C + (dtype == BF16))
    chain = _chain(rng, 37, 5, dtype)
    got = _model_grads(chain, M, C, products=2 if dtype == BF16 else 3)
    want = ls.lstm_scan_bwd_reference(*chain)
    assert np.abs(want[0].numpy()).max() > 0.1
    for what, a, b in zip(("d_xw", "d_whh"), got, want):
        _close(a, b.numpy(), what)


@pytest.mark.parametrize("hidden,dtype", [(48, F32), (96, BF16)],
                         ids=["24-units-f32", "48-units-bf16"])
def test_the_partitioned_step_with_h_384s_unit_split_is_the_plain_backward(hidden, dtype):
    # A rank's units as at H = 384 on two ranks: 24 (f32 at C = 16) and 48 (bf16 at C = 8),
    # no power of two; M = 16, B = 21 leaves rows past B.
    chain = _chain(np.random.default_rng(hidden), 21, 4, dtype, hidden)
    got = _model_grads(chain, 16, 2, products=2 if dtype == BF16 else 3)
    for what, a, b in zip(("d_xw", "d_whh"), got, ls.lstm_scan_bwd_reference(*chain)):
        _close(a, b.numpy(), what)


@pytest.mark.parametrize("chains", [1, 2], ids=["lstm_scan", "lstm_scan_bidir"])
def test_the_partitioned_step_matches_jax_lstm_bwd_core(chains):
    # DPTNet training's f32 tile (M = 32 on 8-block clusters) at H = 256, B = 37, T = 5.
    rng = np.random.default_rng(chains)
    arrays = [_chain(rng, 37, 5) for _ in range(chains)]
    xw, w, g = ([a[k].numpy() for a in arrays] for k in (0, 1, 4))
    if chains == 1:
        _, vjp = jax.vjp(lambda a, b: jpl.lstm_scan(a, b, True), jnp.asarray(xw[0]),
                         jnp.asarray(w[0]))
        expected = vjp(jnp.asarray(g[0]))
    else:
        _, vjp = jax.vjp(lambda *a: jpl.lstm_scan_bidir(*a, True),
                         *(jnp.asarray(a) for a in (*xw, *w)))
        expected = vjp(tuple(jnp.asarray(a) for a in g))
    got = [_model_grads(chain, 32, 8, products=3) for chain in arrays]
    d_xw, d_whh = expected[:chains], expected[chains:]
    for c in range(chains):
        _close(got[c][0], d_xw[c], f"d_xw of chain {c}")
        _close(got[c][1], d_whh[c], f"d_whh of chain {c}")
