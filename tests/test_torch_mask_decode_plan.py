"""fused_mask_decode's launch plan and the index arithmetic of its "rows" and "mma" kernels (CPU).

`_plan` is pure Python: from dtype, shape and alignment it picks "rows",
"mma" or "generic" before the launch; here the rule itself is held. The
CUDA kernels (csrc/mask_decode.cu) run only on the card, where chip_smoke.py
holds every path against the plain version. What can be checked here is
their index arithmetic, modelled in numpy exactly as the kernels compute it:
the "mma" path's lane -> (row, n) mapping with K permuted into the order of
its A fragments, and the "rows" path's halving reduction over a lane group
with its store mapping. Each model must reproduce the plain sum.
"""
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.ops import mask_decode as md

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("dtype,B,S,Tp,N,CL,aligned,path", [
    (F32, 8, 2, 31999, 64, 2, True, "rows"),  # DPRNN-TasNet's decoder, B = 8 x 4 s
    (BF16, 8, 2, 31999, 64, 2, True, "mma"),
    (BF16, 1, 2, 400, 64, 2, True, "mma"),  # one streamed 0.05 s hop
    (BF16, 8, 2, 3999, 512, 16, True, "mma"),  # paper-config Conv-TasNet's decoder
    (F32, 8, 2, 3999, 512, 16, True, "generic"),
    (F32, 2, 2, 99, 128, 16, True, "generic"),  # "rows" is built for N=64, C·L=2 only
    (BF16, 2, 2, 99, 128, 16, True, "mma"),
    (BF16, 2, 2, 99, 256, 8, True, "mma"),
    (BF16, 2, 3, 77, 200, 12, True, "mma"),  # N past the last 32-wide chunk
    (F32, 2, 2, 99, 64, 3, True, "generic"),
    (F32, 8, 2, 1599, 500, 40, True, "generic"),  # LSTM-TasNet's decoder
    (BF16, 8, 2, 1599, 500, 40, False, "generic"),  # rows of 1000 bytes: not aligned
    (BF16, 2, 2, 333, 61, 2, False, "generic"),
    (F32, 2, 2, 333, 61, 2, False, "generic"),
    (BF16, 2, 2, 257, 512, 80, True, "generic"),  # C·L past 64
    (BF16, 8, 2, 31999, 64, 2, False, "generic"),  # strides off the 16-byte vectors
    (BF16, 8, 2, 3999, 512, 16, False, "generic"),
    (BF16, 32, 2, 2 ** 24, 64, 2, True, "generic"),  # B x S x T' = 2^30: past 32-bit indices
    (F32, 32, 1, 2 ** 25 - 1, 64, 2, True, "rows"),  # the largest call "rows" takes
    (BF16, 2, 2, 1001, 512, 32, True, "generic"),  # C·L past two n8 tiles
    (F32, 8, 2, 31999, 32, 2, True, "generic"),  # a narrow width no model serves
], ids=["dprnn-f32", "dprnn-bf16", "dprnn-hop", "conv-bf16", "conv-f32", "f32-N128",
        "bf16-N128-CL16", "bf16-N256", "bf16-N200", "f32-CL3", "lstm-tasnet-f32",
        "lstm-tasnet-bf16", "N61-bf16", "N61-f32", "CL80", "unaligned-dprnn",
        "unaligned-conv", "huge", "largest", "bf16-CL32", "f32-N32"])
def test_plan_picks_the_path(dtype, B, S, Tp, N, CL, aligned, path):
    assert md._plan(dtype, B, S, Tp, N, CL, aligned) == path
    # The generic kernel takes every call, so it can always be forced (to time it);
    # no call fits both "rows" (f32) and "mma" (bf16).
    assert md._plan(dtype, B, S, Tp, N, CL, aligned, path="generic") == "generic"
    for other in ("rows", "mma"):
        if other != path:
            with pytest.raises(ValueError):
                md._plan(dtype, B, S, Tp, N, CL, aligned, path=other)


def test_plan_refuses_an_unknown_path():
    with pytest.raises(ValueError):
        md._plan(BF16, 8, 2, 3999, 512, 16, True, path="wgmma")


def _tensors(dtype, B=2, S=2, Tp=9, N=64, CL=2):
    w = torch.zeros(B, Tp, N, dtype=dtype)
    mask = torch.zeros(B, Tp, S, N, dtype=dtype).transpose(1, 2)
    return w, mask, torch.zeros(N, CL, dtype=dtype)


@pytest.mark.parametrize("case,path", [
    ("separator-view", "mma"),  # the (B, S, T', N) view of a (B, T', S, N) tensor
    ("contiguous", "mma"),
    ("w-offset", "generic"),  # w starts half a vector into its storage
    ("w-row-stride", "generic"),  # w rows cut out of wider rows, off the vectors
], ids=lambda v: v)
def test_launch_plan_reads_alignment_from_the_tensors(case, path):
    w, mask, kernel = _tensors(BF16)
    if case == "contiguous":
        mask = mask.contiguous()
    elif case == "w-offset":
        w = torch.zeros(w.numel() + 4, dtype=BF16)[4:].view(w.shape)
    elif case == "w-row-stride":
        w = torch.zeros(2, 9, 68, dtype=BF16)[..., :64]
    assert md.launch_plan(w, mask, kernel) == path


def test_launch_args_are_planned_once_per_call_signature():
    w, mask, kernel = _tensors(F32)
    first = md._launch_args(w, mask, kernel, None)
    assert first[0] == "rows" and first[1] == ("rows", "float32", 64, 2)
    assert first[2] == (2, 2, 9, 2)
    assert md._launch_args(*_tensors(F32), None) is first  # other tensors, same signature
    # w half a vector into its storage, or a forced path: other signatures, planned anew.
    w_off = torch.zeros(w.numel() + 2)[2:].view(w.shape)
    assert md._launch_args(w_off, mask, kernel, None)[0] == "generic"
    assert md._launch_args(w, mask, kernel, "generic")[0] == "generic"
    with pytest.raises(ValueError):  # checked before it is cached, and on every call
        md._launch_args(w, mask, torch.zeros(64, 2).t().contiguous().t(), "mma")
    with pytest.raises(ValueError):
        md._launch_args(w, mask, torch.zeros(63, 2), None)


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(BF16).float().numpy()


def _mma_model(w, mask, K):
    """csrc/mask_decode.cu's "mma" kernel in numpy: K staged as B fragments in the
    permuted order, each lane's A fragments built from its 16-byte loads, the
    m16n8k16 products assembled from the lanes' registers as the PTX layout
    places them, the C fragments stored. Inputs hold bf16 values in f32."""
    B, Tp, N = w.shape
    S, CL = mask.shape[1], K.shape[1]
    NT = 1 << (-(-CL // 8) - 1).bit_length()
    n_chunks = -(-N // 32)
    lane = np.arange(32)
    g, c = lane >> 2, lane & 3
    # kfrag[ch, j, lane, q, h] = K[32 ch + 8 c + 2 q + h, 8 j + g], zero past N and CL.
    Kp = np.zeros((n_chunks * 32 + 8, NT * 8), np.float32)
    Kp[:N, :CL] = K
    kfrag = np.zeros((n_chunks, NT, 32, 4, 2), np.float32)
    for ch in range(n_chunks):
        for j in range(NT):
            for q in range(4):
                for h in range(2):
                    kfrag[ch, j, :, q, h] = Kp[32 * ch + 8 * c + 2 * q + h, 8 * j + g]
    frames = B * Tp
    out = np.full((B, S, Tp, CL), np.nan, np.float32)
    for tile in range(-(-frames // 8)):
        for pair in range(-(-S // 2)):
            s0 = 2 * pair
            s1 = min(s0 + 1, S - 1)
            f_row = tile * 8 + g
            b, t = np.divmod(np.minimum(f_row, frames - 1), Tp)
            acc = np.zeros((NT, 32, 4), np.float32)
            for ch in range(n_chunks):
                n = 32 * ch + 8 * c[:, None] + np.arange(8)  # (lane, element)
                valid = (32 * ch + 8 * c < N)[:, None]
                nn = np.minimum(n, N - 1)
                x = np.where(valid, w[b[:, None], t[:, None], nn], 0)
                p = _bf16(x * np.where(valid, mask[b[:, None], s0, t[:, None], nn], 0))
                q = _bf16(x * np.where(valid, mask[b[:, None], s1, t[:, None], nn], 0))
                for s in range(2):
                    regs = [p[:, 4 * s:4 * s + 2], q[:, 4 * s:4 * s + 2],
                            p[:, 4 * s + 2:4 * s + 4], q[:, 4 * s + 2:4 * s + 4]]
                    A = np.zeros((16, 16), np.float32)
                    for r, (row, col) in enumerate([(0, 0), (8, 0), (0, 8), (8, 8)]):
                        for h in range(2):
                            A[g + row, 2 * c + col + h] = regs[r][:, h]
                    for j in range(NT):
                        Bm = np.zeros((16, 8), np.float32)
                        for h in range(2):
                            Bm[2 * c + h, g] = kfrag[ch, j, :, 2 * s, h]
                            Bm[2 * c + 8 + h, g] = kfrag[ch, j, :, 2 * s + 1, h]
                        D = A @ Bm
                        for h in range(2):
                            acc[j, :, h] += D[g, 2 * c + h]
                            acc[j, :, 2 + h] += D[g + 8, 2 * c + h]
            for ln in np.flatnonzero(f_row < frames):
                for j in range(NT):
                    for h in range(2):
                        col = 8 * j + 2 * c[ln] + h
                        if col < CL:
                            out[b[ln], s0, t[ln], col] = acc[j, ln, h]
                            if s0 + 1 < S:
                                out[b[ln], s0 + 1, t[ln], col] = acc[j, ln, 2 + h]
    return out


@pytest.mark.parametrize("B,S,Tp,N,CL", [
    (1, 2, 13, 512, 16),  # Conv-TasNet's decoder width, frames past the last 8-frame tile
    (2, 3, 5, 200, 12),  # N past the last chunk, C·L past the last n8 tile, an odd S
], ids=["N512-CL16", "ragged"])
def test_mma_fragments_reproduce_the_plain_version(B, S, Tp, N, CL):
    rng = np.random.default_rng(N + CL)
    w = _bf16(rng.standard_normal((B, Tp, N)))
    mask = _bf16(rng.uniform(0, 1, (B, S, Tp, N)))
    K = _bf16(0.1 * rng.standard_normal((N, CL)))
    assert md._plan(BF16, B, S, Tp, N, CL, aligned=True) == "mma"
    got = _mma_model(w, mask, K)
    ref = md.fused_mask_decode_reference(*(torch.from_numpy(a).to(BF16)
                                           for a in (w, mask, K))).numpy()
    assert not np.isnan(got).any()  # every output row written
    # The same bf16 products, summed in another order in f32.
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def _rows_iterations(CL):
    """Frames a lane group carries in flight (csrc/mask_decode.cu:rows_iterations)."""
    return 4 if CL <= 4 else 2 if CL == 8 else 1


def _reduce_tree(a, G):
    """reduce_tree<P, 0, G> over a warp's 32 lanes: a (32, P) partial sums."""
    a = a.copy()
    lane = np.arange(32)
    P = a.shape[1]
    H = 0
    while G >> (H + 1) >= 1:
        o = G >> (H + 1)
        cur = P >> H
        partner = lane ^ o
        if cur >= 2:
            half = cur // 2
            upper = (lane & o) != 0
            lo, hi = a[:, :half].copy(), a[:, half:cur].copy()
            keep = np.where(upper[:, None], hi, lo)
            send = np.where(upper[:, None], lo, hi)
            a[:, :half] = keep + send[partner]
        else:
            a[:, 0] += a[partner, 0]
        H += 1
    return a


@pytest.mark.parametrize("G", [8, 16])
@pytest.mark.parametrize("CL", [1, 2, 16])
def test_rows_group_reduction_and_stores_cover_each_sum_once(G, CL):
    """rows_kernel<G, CL>'s reduction and stores; built at G = 16, C·L = 2, and
    modelled at other template values as well."""
    U = _rows_iterations(CL)
    P = U * 2 * CL  # index (2 u + source) CL + column
    groups, k_frames = 32 // G, U * (32 // G)
    rng = np.random.default_rng(G * CL)
    partial = rng.standard_normal((32, P)).astype(np.float32)
    reduced = _reduce_tree(partial, G)
    left = P // G if P >= G else 1
    spread = 1 if P >= G else G // P
    lane = np.arange(32)
    li, gi = lane % G, lane // G
    written = {}
    for ln in lane[li % spread == 0]:
        for i in range(left):
            j = li[ln] // spread * left + i
            expected = partial[gi == gi[ln], j].sum()
            np.testing.assert_allclose(reduced[ln, i], expected, rtol=1e-5, atol=1e-5)
            u, s, col = j // (2 * CL), j // CL % 2, j % CL
            frame = u * groups + gi[ln]  # within the work item
            key = (frame, s, col)
            assert key not in written
            written[key] = reduced[ln, i]
    # Every frame of the item, both sources, every column: stored exactly once.
    assert set(written) == {(f, s, col) for f in range(k_frames) for s in range(2)
                            for col in range(CL)}
