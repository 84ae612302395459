"""The recurrence wrappers' launch plans: which forward kernel and which tile (CPU).

`_plan` is pure Python: from the dtype, the shape, the card's co-resident
clusters and the calling wrapper's routes it picks a tensor-core kernel
("mma" in bf16, "tf32x3" in f32, M-row tiles), the LSTM's wide kernel ("wide",
an M-row tile on a cluster of C blocks, for many sequences at H = 256), the
LSTM's cluster kernel ("cluster", one sequence on a cluster of C blocks, for
few sequences at H = 256, 384 and 512) or the FMA kernel ("fma", R sequences
per group) before the launch. On the card chip_smoke.py checks that every bf16
recurrence of the wsj0 models took "mma", every f32 one "tf32x3", musdb18's
UMX "cluster", and none "fma"; here the rule itself is held, at an H100's
132 SMs and given numbers of co-resident clusters (2 and 4 blocks for the
3xTF32 kernel, whose tile is (M, C): M rows on a cluster of C blocks; 8 and
16 for the cluster kernel). `_plan_bwd` picks the backward's kernel the same
way: the split-TF32 tensor cores, the LSTM's cluster backward (musdb18
training's B = 16 at H = 256), the LSTM's wide backward (DPTNet training's
many sequences at H = 256) or the FMA kernel.
"""
import pytest
import torch

from dnn_based_source_separation_torch.ops import gru_scan as gs
from dnn_based_source_separation_torch.ops import lstm_scan as ls

SMS = 132
# Clusters of C blocks of the 3xTF32 kernel an H100 holds at once, one block an
# SM, as chip_smoke.py read them from the card.
CLUSTERS = {2: 66, 4: 30}
# Clusters of C blocks of the cluster kernel an H100 holds at once (H = 256:
# C = 8 and 16; above, 16), as chip_smoke.py phase 3h read them from the card.
BIG_CLUSTERS = {8: 15, 16: 7}
BF16, F32 = torch.bfloat16, torch.float32
# Clusters of C blocks of the wide kernel an H100 holds at once, by tile (M, C), as
# chip_smoke.py phase 3i read them from the card: each block takes an SM of its own, so
# the count depends on C alone.
WIDE_BY_C = {4: 30, 8: 15, 16: 7}
WRAPPERS = pytest.mark.parametrize("wrapper", [ls, gs], ids=["lstm", "gru"])


def _blocks(B, n_chains, tile):
    return n_chains * -(-B // tile)


def _clusters(H):
    """The counts the wrapper would ask the card for at H: the 3xTF32 kernel's up to 128,
    the cluster kernel's above."""
    return CLUSTERS if H <= 128 else {c: n for c, n in BIG_CLUSTERS.items()
                                      if ls.cluster_layout(H, c)}


def _wide(H, dtype, by_c=WIDE_BY_C):
    """The wide kernel's counts by tile the LSTM wrapper would ask the card for at H."""
    return {(m, c): by_c.get(c, 0) for m, c in ls._wide_tiles(H, dtype)}


@WRAPPERS
@pytest.mark.parametrize("B,n_chains,H,tile", [
    (2040, 2, 128, 32),  # intra-chunk serving, B = 8 x 4 s: one wave of 128 blocks
    (2000, 2, 128, 32),  # inter-chunk serving shape on two chains: 126 blocks
    (2000, 1, 128, 16),  # causal inter-chunk serving: 125 blocks of 16 rows
    (510, 2, 128, 16),  # intra-chunk training, B = 2 x 4 s
    (500, 1, 128, 16),  # causal inter-chunk training
    (3, 2, 128, 16),  # one streamed hop's chunks
    (37, 2, 128, 16),  # rows past B masked
    (50, 2, 64, 16),
    (20000, 2, 128, 32),  # past one wave even at M = 32
], ids=["intra", "inter-bidir", "inter", "train-intra", "train-inter", "stream", "odd",
        "H=64", "huge"])
def test_bf16_at_h_multiple_of_16_up_to_128_takes_the_tensor_cores(wrapper, B, n_chains, H, tile):
    assert wrapper._plan(B, n_chains, H, BF16, SMS) == ("mma", tile)
    # M = 16 while its grid fits one wave, else M = 32.
    assert (_blocks(B, n_chains, 16) <= SMS) == (tile == 16)
    if B in (2040, 2000) and n_chains == 2:  # the serving shapes: one wave
        assert _blocks(B, n_chains, tile) <= SMS


@WRAPPERS
@pytest.mark.parametrize("B,n_chains,H,dtype,R", [
    (37, 2, 40, F32, 1),
    (4096, 1, 512, F32, 4),
    (37, 2, 40, BF16, 1),
    (260, 2, 384, BF16, 2),
], ids=["f32-H=40", "f32-H=512", "bf16-H=40", "bf16-H=384-R2"])
def test_other_calls_take_the_fma_kernel_with_its_tile(wrapper, B, n_chains, H, dtype, R):
    # The FMA kernel's rule, unchanged: groups = min(4, 256 / (H / 2)) of R
    # sequences a block, the largest R in 4, 2, 1 that gives every SM a block.
    # (H = 384 and 512 past CLUSTER_MAX_BATCH sequences: the cluster kernel's
    # calls are in the tests below; H = 256 and 384 many sequences take the wide
    # kernel where the card holds it: here it holds none.)
    assert wrapper._plan(B, n_chains, H, dtype, SMS, clusters=_clusters(H),
                         routes=wrapper.ROUTES, wide=_wide(H, dtype, {})) == ("fma", R)
    groups = min(4, 256 // (H // 2))
    assert _blocks(B, n_chains, groups * R) >= SMS or R == 1
    if R < 4:
        assert _blocks(B, n_chains, groups * 2 * R) < SMS


@WRAPPERS
@pytest.mark.parametrize("B,n_chains,R", [(2040, 2, 4), (2000, 1, 2), (3, 2, 1)])
def test_the_fma_path_can_be_forced_for_timing(wrapper, B, n_chains, R):
    assert wrapper._plan(B, n_chains, 128, BF16, SMS, path="fma") == ("fma", R)


@WRAPPERS
@pytest.mark.parametrize("B,n_chains,H,clusters,tile", [
    (2040, 2, 128, CLUSTERS, (64, 2)),  # intra-chunk serving: 64 clusters, 128 blocks
    (2000, 2, 128, CLUSTERS, (64, 2)),  # inter-chunk serving shape on two chains
    (2000, 1, 128, CLUSTERS, (32, 2)),  # causal inter-chunk serving: 63 clusters of 32 rows
    (510, 2, 128, CLUSTERS, (16, 2)),  # intra-chunk training, B = 2 x 4 s: 64 clusters
    (500, 1, 128, CLUSTERS, (16, 2)),  # causal inter-chunk training: 32 of 4 > 30
    (3, 2, 128, CLUSTERS, (16, 4)),  # one streamed hop's chunks: 4 SMs a chain
    (255, 2, 128, CLUSTERS, (16, 2)),  # one 4 s request's intra-chunk RNN
    (37, 2, 128, CLUSTERS, (16, 4)),  # rows past B masked
    (3, 2, 128, {2: 1}, (16, 2)),  # a card that holds one 2-block cluster
    (510, 2, 128, {2: 60, 4: 30}, (32, 2)),  # fewer clusters: a larger tile
    (2040, 2, 128, {2: 60, 4: 30}, (64, 2)),  # none fits one wave: the fewest waves
    (20000, 2, 128, CLUSTERS, (64, 2)),  # past one wave even at M = 64
    (3, 2, 64, CLUSTERS, (16, 4)),  # H = 64: 16 units a block of 4
    (3, 2, 48, CLUSTERS, (16, 2)),  # H = 48: 48 % 32 != 0, so 2-block clusters only
    *[(50, 2, H, {2: 66}, (16, 2)) for H in range(16, 128, 16)],
], ids=["intra", "inter-bidir", "inter", "train-intra", "train-inter", "stream", "request",
        "odd", "one-cluster", "train-60", "intra-60", "huge", "stream-H=64", "stream-H=48",
        *[f"H={H}" for H in range(16, 128, 16)]])
def test_f32_at_h_multiple_of_16_up_to_128_takes_tf32x3(wrapper, B, n_chains, H, clusters,
                                                        tile):
    assert wrapper._plan(B, n_chains, H, F32, SMS, clusters=clusters) == ("tf32x3", tile)
    # The fewest waves, then the fewest rows x units a block (M / C), then
    # the smaller cluster and tile; H / C units a block, 8 a warp.
    m, c = tile
    assert H % (8 * c) == 0
    options = {(mm, cc): (-(-_blocks(B, n_chains, mm) // n), mm / cc)
               for cc, n in clusters.items() if H % (8 * cc) == 0 for mm in (16, 32, 64)}
    assert options[tile] == min(options.values())
    assert all(options[o] > options[tile] or o[1] > c or (o[1] == c and o[0] > m)
               for o in options if o != tile)
    if clusters is CLUSTERS and B <= 2040:  # the served, trained and streamed shapes
        assert _blocks(B, n_chains, m) <= CLUSTERS[c]  # one wave


@WRAPPERS
@pytest.mark.parametrize("B,n_chains,R", [(2040, 2, 4), (2000, 1, 2), (510, 2, 1), (3, 2, 1)],
                         ids=["intra", "inter", "train", "stream"])
def test_the_fma_path_can_be_forced_in_f32(wrapper, B, n_chains, R):
    assert wrapper._plan(B, n_chains, 128, F32, SMS, path="fma") == ("fma", R)


@WRAPPERS
@pytest.mark.parametrize("H,dtype", [(128, BF16), (144, F32), (40, F32), (256, F32), (8, F32)],
                         ids=["bf16", "H=144", "H=40", "H=256", "H=8"])
def test_forcing_tf32x3_where_it_cannot_run_raises(wrapper, H, dtype):
    with pytest.raises(ValueError):
        wrapper._plan(2040, 2, H, dtype, SMS, path="tf32x3", clusters=CLUSTERS)


@WRAPPERS
@pytest.mark.parametrize("clusters", [None, {}, {2: 0}, {4: 33}], ids=["none", "empty", "zero",
                                                                       "H=16-no-size"])
def test_tf32x3_needs_the_cards_cluster_count(wrapper, clusters):
    with pytest.raises(ValueError):
        wrapper._plan(2040, 2, 16, F32, SMS, clusters=clusters)


@pytest.mark.parametrize("tile,args", [(32, (32, 1)), (4, (4, 1)), ((64, 2), (64, 2)),
                                       ((16, 4), (16, 4)), ((1, 8), (1, 8)), ((1, 16), (1, 16))],
                         ids=["mma", "fma", "tf32x3", "C=4", "cluster", "cluster-C=16"])
def test_a_tile_goes_to_the_c_entry_points_with_its_cluster(tile, args):
    assert ls._tile_args(tile) == args


@WRAPPERS
@pytest.mark.parametrize("H,dtype", [(256, BF16), (128, F32), (40, BF16), (144, BF16)],
                         ids=["H=256", "f32", "H=40", "H=144"])
def test_forcing_the_tensor_cores_where_they_cannot_run_raises(wrapper, H, dtype):
    with pytest.raises(ValueError):
        wrapper._plan(2040, 2, H, dtype, SMS, path="mma")


def test_both_wrappers_plan_by_one_rule():
    assert gs._plan is ls._plan
    assert gs._plan_launch is ls._plan_launch


# The cluster kernel (csrc/recurrence_cluster.cuh), the LSTM's only: few sequences
# at H = 256, 384 or 512 take it, each on a cluster of C blocks, C the one that
# runs the grid in the fewest waves, then the larger; past CLUSTER_MAX_BATCH
# sequences, and in the GRU wrapper, the FMA kernel.
def _fma(B, n_chains, H):
    return "fma", ls._fma_tile(B, n_chains, H, SMS)


@WRAPPERS
@pytest.mark.parametrize("B,n_chains,H,dtype,C", [
    (1, 2, 256, F32, 16),  # UMX / X-UMX serving: a 10 s chunk, bidirectional layers
    (1, 1, 512, F32, 16),  # causal UMX serving
    (1, 2, 256, BF16, 16),
    (1, 1, 512, BF16, 16),
    (3, 2, 256, F32, 16),
    (4, 2, 256, F32, 8),  # 8 clusters: one wave of 8 blocks, two of 16
    (1, 1, 384, F32, 16),  # one row block of W_hh in shared memory
    (64, 2, 256, F32, 8),  # nine waves of 8-block clusters
    (64, 2, 256, BF16, 8),
    (16, 2, 512, BF16, 16),  # five waves of 16-block clusters
    (16, 2, 256, F32, 8),  # UMX / X-UMX training, B = 16 x 6 s: 32 clusters, three waves of 8
], ids=["umx", "causal-umx", "umx-bf16", "causal-umx-bf16", "B=3", "B=4", "H=384", "f32-H=256",
        "bf16-H=256", "bf16-H=512", "umx-train"])
def test_few_sequences_at_h_256_to_512_take_the_cluster_kernel_in_the_lstm(
        wrapper, B, n_chains, H, dtype, C):
    got = wrapper._plan(B, n_chains, H, dtype, SMS, clusters=_clusters(H), routes=wrapper.ROUTES)
    if wrapper is gs:  # no cluster kernel in the GRU's library
        assert got == _fma(B, n_chains, H)
        return
    assert got == ("cluster", (1, C))
    waves = {c: -(-n_chains * B // n) for c, n in _clusters(H).items()}
    assert waves[C] == min(waves.values())
    assert all(waves[c] > waves[C] or c < C for c in waves if c != C)


@WRAPPERS
@pytest.mark.parametrize("n_chains,H", [(2, 256), (1, 512), (1, 384)],
                         ids=["umx", "causal-umx", "H=384"])
def test_the_crossover_batch_goes_back_to_fma(wrapper, n_chains, H):
    B = ls.CLUSTER_MAX_BATCH
    at, past = (wrapper._plan(b, n_chains, H, F32, SMS, clusters=_clusters(H),
                              routes=wrapper.ROUTES, wide=_wide(H, F32)) for b in (B, B + 1))
    if wrapper is ls and H == ls.WIDE_HIDDEN:  # H = 256: the wide kernel on both sides
        assert B >= ls.WIDE_MIN_BATCH[256][(F32, n_chains)]
        assert at[0] == past[0] == "wide"
        return
    assert past == _fma(B + 1, n_chains, H)
    assert at[0] == ("cluster" if wrapper is ls else "fma")


@pytest.mark.parametrize("clusters,H,want", [
    ({8: 15}, 256, ("cluster", (1, 8))),
    ({8: 15, 16: 0}, 256, ("cluster", (1, 8))),
    ({16: 7}, 256, ("cluster", (1, 16))),
    (BIG_CLUSTERS, 256, ("cluster", (1, 16))),
    ({16: 0}, 512, ("fma", 1)),
    ({}, 256, ("fma", 1)),
    (None, 256, ("fma", 1)),
], ids=["no-16", "16-zero", "no-8", "both", "H=512-no-16", "none", "unasked"])
def test_the_cluster_size_follows_the_cards_counts(clusters, H, want):
    assert ls._plan(1, 2 if H == 256 else 1, H, F32, SMS, clusters=clusters,
                    routes=ls.ROUTES) == want


@pytest.mark.parametrize("B,n_chains,H,C", [(256, 2, 256, 8), (256, 1, 512, 16), (8, 2, 256, 8)],
                         ids=["H=256", "H=512", "B=8"])
def test_the_cluster_path_can_be_forced_past_the_crossover(B, n_chains, H, C):
    assert ls._plan(B, n_chains, H, F32, SMS, "cluster", _clusters(H), ls.ROUTES) == (
        "cluster", (1, C))


@pytest.mark.parametrize("H,dtype,clusters", [
    (128, F32, BIG_CLUSTERS), (128, BF16, BIG_CLUSTERS), (64, F32, BIG_CLUSTERS),
    (40, F32, BIG_CLUSTERS), (320, F32, {8: 15}), (512, F32, {8: 15}),
    (256, F32, None), (256, F32, {8: 0, 16: 0}),
], ids=["H=128", "H=128-bf16", "H=64", "H=40", "H=320", "H=512-no-16", "unasked", "zero"])
def test_forcing_the_cluster_path_where_it_cannot_run_raises(H, dtype, clusters):
    # H = 320 runs zero-padded to 384, which takes 16-block clusters alone.
    with pytest.raises(ValueError):
        ls._plan(1, 2, H, dtype, SMS, "cluster", clusters, ls.ROUTES)


def test_forcing_the_cluster_path_from_the_gru_wrapper_raises():
    assert "cluster" in ls.ROUTES and "cluster" not in gs.ROUTES
    with pytest.raises(ValueError):
        gs._plan(1, 2, 256, F32, SMS, "cluster", BIG_CLUSTERS, gs.ROUTES)


@pytest.mark.parametrize("H,dtype,path,routes,want", [
    (256, F32, None, ls.ROUTES, True), (512, BF16, None, ls.ROUTES, True),
    (256, F32, None, gs.ROUTES, False), (256, F32, "fma", ls.ROUTES, False),
    (40, F32, None, ls.ROUTES, False), (128, F32, None, ls.ROUTES, True),
    (128, BF16, None, ls.ROUTES, False),
], ids=["umx", "causal-bf16", "gru", "forced-fma", "H=40", "tf32x3", "mma"])
def test_the_wrapper_asks_the_card_for_clusters_only_where_a_cluster_kernel_may_run(
        H, dtype, path, routes, want):
    assert ls._needs_clusters(H, dtype, path, routes=routes) is want


# The backward: `_plan_bwd` picks the split-TF32 tensor-core kernel ("tf32x3" in
# f32, "tf32x2" in bf16) or the FMA kernel, and for the former the tile (M, C)
# by the forward's rule over M = 16.
BWD_PATH = {F32: "tf32x3", BF16: "tf32x2"}
DTYPES = pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])


@WRAPPERS
@DTYPES
@pytest.mark.parametrize("B,n_chains,H,clusters,tile", [
    (510, 2, 128, CLUSTERS, (16, 2)),  # intra-chunk training: one wave of 128 blocks
    (500, 2, 128, CLUSTERS, (16, 2)),  # inter-chunk training, bidirectional
    (500, 1, 128, CLUSTERS, (16, 2)),  # causal inter-chunk training: 64 blocks
    (3, 2, 128, CLUSTERS, (16, 4)),  # a tiny batch spreads over 4 SMs a tile
    (37, 2, 128, CLUSTERS, (16, 4)),  # rows past B masked
    (2040, 2, 128, CLUSTERS, (16, 2)),  # past one wave: the fewest waves
    (510, 2, 128, {2: 60, 4: 30}, (16, 2)),  # fewer clusters: two waves of 2-block ones
    (510, 2, 64, CLUSTERS, (16, 2)),
    (3, 2, 48, CLUSTERS, (16, 2)),  # H = 48: 48 % 32 != 0, so 2-block clusters only
    *[(50, 2, H, {2: 66}, (16, 2)) for H in range(16, 128, 16)],
], ids=["train-intra", "train-inter-bidir", "train-inter", "tiny", "odd", "serving-size",
        "train-60", "H=64", "tiny-H=48", *[f"H={H}" for H in range(16, 128, 16)]])
def test_the_backward_takes_the_tensor_cores_at_h_multiple_of_16_up_to_128(
        wrapper, dtype, B, n_chains, H, clusters, tile):
    assert wrapper._plan_bwd(B, n_chains, H, dtype, SMS, clusters=clusters) == (
        BWD_PATH[dtype], tile)
    # The forward's rule over M = 16: the fewest waves, then the fewest rows x
    # units a block, then the smaller cluster.
    m, c = tile
    options = {(mm, cc): (-(-_blocks(B, n_chains, mm) // n), mm / cc)
               for cc, n in clusters.items() if H % (8 * cc) == 0 for mm in ls.BWD_TILE_ROWS}
    assert options[tile] == min(options.values())
    assert all(options[o] > options[tile] or o[1] > c for o in options if o != tile)
    if B <= 510 and clusters is CLUSTERS:  # the trained shapes: one wave
        assert _blocks(B, n_chains, m) <= CLUSTERS[c]


@WRAPPERS
@DTYPES
@pytest.mark.parametrize("B,n_chains,H,R", [
    (37, 2, 40, 1), (64, 2, 256, 1), (400, 2, 256, 2), (4096, 1, 512, 4), (16, 2, 512, 1),
], ids=["H=40", "H=256", "H=256-R2", "H=512", "H=512-small"])
def test_the_backward_takes_the_fma_kernel_at_other_h(wrapper, dtype, B, n_chains, H, R):
    # The FMA backward's tile rule (the forward's), over the routes without the
    # cluster backward; the cluster backward's calls are in the tests below.
    got = wrapper._plan_bwd(B, n_chains, H, dtype, SMS, clusters=CLUSTERS)
    assert got == ("fma", R) == ("fma", wrapper._plan(B, n_chains, H, dtype, SMS, "fma")[1])


@WRAPPERS
@DTYPES
@pytest.mark.parametrize("B,n_chains,R", [(510, 2, 1), (500, 1, 1), (4096, 2, 4)],
                         ids=["train-intra", "train-inter", "large"])
def test_the_fma_backward_can_be_forced_for_timing(wrapper, dtype, B, n_chains, R):
    assert wrapper._plan_bwd(B, n_chains, 128, dtype, SMS, path="fma") == ("fma", R)


@WRAPPERS
@pytest.mark.parametrize("H,dtype,path", [
    (128, BF16, "tf32x3"), (128, F32, "tf32x2"), (40, F32, "tf32x3"), (256, F32, "tf32x3"),
    (256, BF16, "tf32x2"), (144, BF16, "tf32x2"), (128, BF16, "mma"), (128, F32, "cuda"),
], ids=["bf16-tf32x3", "f32-tf32x2", "H=40", "H=256", "H=256-bf16", "H=144", "mma", "unknown"])
def test_forcing_the_tensor_core_backward_where_it_cannot_run_raises(wrapper, H, dtype, path):
    with pytest.raises(ValueError):
        wrapper._plan_bwd(510, 2, H, dtype, SMS, path=path, clusters=CLUSTERS)


@WRAPPERS
@DTYPES
@pytest.mark.parametrize("clusters", [None, {}, {2: 0}], ids=["none", "empty", "zero"])
def test_the_tensor_core_backward_needs_the_cards_cluster_count(wrapper, dtype, clusters):
    with pytest.raises(ValueError):
        wrapper._plan_bwd(510, 2, 128, dtype, SMS, clusters=clusters)


def test_both_wrappers_plan_the_backward_by_one_rule():
    assert gs._plan_bwd is ls._plan_bwd


# The cluster backward (csrc/recurrence_cluster_bwd.cuh), the LSTM's only: few sequences
# at H = 256, 384 or 512 take it, by the forward's rule over the backward kernel's own
# counts of co-resident clusters; past CLUSTER_MAX_BATCH_BWD sequences, and in the GRU
# wrapper, the FMA kernel.
# Clusters of C blocks of the cluster backward an H100 holds at once (H = 256: C = 8
# and 16; above, 16), as chip_smoke.py phase 3h read them from the card.
BWD_BIG_CLUSTERS = {8: 15, 16: 7}


def _bwd_clusters(H):
    """The counts the LSTM wrapper would ask the card for at H > 128."""
    return {c: n for c, n in BWD_BIG_CLUSTERS.items() if ls.cluster_bwd_layout(H, c)}


def _fma_bwd(B, n_chains, H):
    return "fma", ls._fma_tile(B, n_chains, H, SMS)


@WRAPPERS
@DTYPES
@pytest.mark.parametrize("B,n_chains,H,C", [
    (16, 2, 256, 8),  # UMX / X-UMX training, B = 16 x 6 s: 32 clusters, three waves of 8
    (64, 2, 256, 8),  # nine waves of 8-block clusters
    (1, 2, 256, 16),  # one sequence: one wave either way, the larger cluster
    (4, 2, 256, 8),  # 8 clusters: one wave of 8 blocks, two of 16
    (16, 1, 512, 16),  # a causal UMX's H = 512: 16-block clusters only
    (3, 1, 384, 16),  # twelve row blocks of W, four of them in shared memory
], ids=["umx-train", "H=256-B=64", "B=1", "B=4", "H=512", "H=384"])
def test_few_sequences_at_h_256_to_512_take_the_cluster_backward_in_the_lstm(
        wrapper, dtype, B, n_chains, H, C):
    got = wrapper._plan_bwd(B, n_chains, H, dtype, SMS, clusters=_bwd_clusters(H),
                            routes=wrapper.ROUTES)
    if wrapper is gs:  # no cluster backward in the GRU's library
        assert got == _fma_bwd(B, n_chains, H)
        return
    assert got == ("cluster", (1, C))
    waves = {c: -(-n_chains * B // n) for c, n in _bwd_clusters(H).items()}
    assert waves[C] == min(waves.values())
    assert all(waves[c] > waves[C] or c < C for c in waves if c != C)


@WRAPPERS
@DTYPES
@pytest.mark.parametrize("n_chains,H", [(2, 256), (1, 512), (1, 384)],
                         ids=["umx-train", "H=512", "H=384"])
def test_the_backward_crossover_batch_goes_back_to_fma(wrapper, dtype, n_chains, H):
    B = ls.CLUSTER_MAX_BATCH_BWD
    at, past = (wrapper._plan_bwd(b, n_chains, H, dtype, SMS, clusters=_bwd_clusters(H),
                                  routes=wrapper.ROUTES) for b in (B, B + 1))
    assert past == _fma_bwd(B + 1, n_chains, H)
    assert at[0] == ("cluster" if wrapper is ls else "fma")


@pytest.mark.parametrize("B,n_chains,H,C", [(512, 2, 256, 8), (1024, 1, 512, 16)],
                         ids=["H=256", "H=512"])
def test_the_cluster_backward_can_be_forced_past_the_crossover(B, n_chains, H, C):
    assert B > ls.CLUSTER_MAX_BATCH_BWD
    assert ls._plan_bwd(B, n_chains, H, F32, SMS, "cluster", _bwd_clusters(H), ls.ROUTES) == (
        "cluster", (1, C))


@pytest.mark.parametrize("H,dtype,clusters", [
    (128, F32, BWD_BIG_CLUSTERS), (128, BF16, BWD_BIG_CLUSTERS), (40, F32, BWD_BIG_CLUSTERS),
    (320, F32, {8: 15}), (512, F32, {8: 15}), (256, F32, None),
    (256, F32, {8: 0, 16: 0}),
], ids=["H=128", "H=128-bf16", "H=40", "H=320", "H=512-no-16", "unasked", "zero"])
def test_forcing_the_cluster_backward_where_it_cannot_run_raises(H, dtype, clusters):
    # H = 320 runs zero-padded to 384, which takes 16-block clusters alone.
    with pytest.raises(ValueError):
        ls._plan_bwd(16, 2, H, dtype, SMS, "cluster", clusters, ls.ROUTES)


@DTYPES
def test_forcing_the_cluster_backward_from_the_gru_wrapper_raises(dtype):
    with pytest.raises(ValueError):
        gs._plan_bwd(16, 2, 256, dtype, SMS, "cluster", BWD_BIG_CLUSTERS, gs.ROUTES)
    with pytest.raises(ValueError):  # the default routes are the GRU's
        ls._plan_bwd(16, 2, 256, dtype, SMS, "cluster", BWD_BIG_CLUSTERS)


@pytest.mark.parametrize("H,dtype,path,routes,want", [
    (256, F32, None, ls.ROUTES, True), (512, BF16, None, ls.ROUTES, True),
    (384, F32, "cluster", ls.ROUTES, True), (256, F32, None, gs.ROUTES, False),
    (256, F32, "fma", ls.ROUTES, False), (40, F32, None, ls.ROUTES, False),
    (320, F32, None, ls.ROUTES, True), (128, F32, None, gs.ROUTES, True),
    (128, BF16, None, ls.ROUTES, True), (40, BF16, None, ls.ROUTES, False),
], ids=["umx-train", "H=512-bf16", "forced", "gru", "forced-fma", "H=40", "H=320",
        "tf32x3", "tf32x2", "H=40-bf16"])
def test_the_backward_asks_the_card_for_clusters_only_where_a_cluster_kernel_may_run(
        H, dtype, path, routes, want):
    # H = 320 runs zero-padded to 384 since the H = 300 routes.
    assert ls._needs_clusters(H, dtype, path, backward=True, routes=routes) is want


@pytest.mark.parametrize("clusters,H,want", [
    ({8: 15}, 256, ("cluster", (1, 8))),
    ({8: 15, 16: 0}, 256, ("cluster", (1, 8))),
    ({16: 7}, 256, ("cluster", (1, 16))),
    ({16: 0}, 512, ("fma", 1)),
    ({}, 256, ("fma", 1)),
    (None, 256, ("fma", 1)),
], ids=["no-16", "16-zero", "no-8", "H=512-no-16", "none", "unasked"])
def test_the_cluster_backward_size_follows_the_cards_counts(clusters, H, want):
    assert ls._plan_bwd(16, 2 if H == 256 else 1, H, F32, SMS, clusters=clusters,
                        routes=ls.ROUTES) == want


# The wide kernel (csrc/recurrence_wide.cuh), the LSTM's only: from WIDE_MIN_BATCH
# sequences up at H = 256 (the crossover with the cluster kernel, measured on an H100;
# musdb18's B = 1 and its training's B = 16 in f32 stay on the cluster kernel),
# an M-row tile on a cluster of C blocks (bf16: 4 or 8, f32: 8 or 16), by the 3xTF32
# kernel's tile rule over the wide kernel's counts; below it "cluster".
DPTNET_SHAPES = [  # B, chains: DPTNet's LSTM launches at H = 256
    (5112, 2),  # serving intra-chunk, B = 8 x 4 s
    (800, 2),  # serving inter-chunk
    (800, 1),  # causal serving inter-chunk
    (1278, 2),  # recipe training intra-chunk, B = 2 x 4 s
    (200, 2),  # recipe training inter-chunk
]


@DTYPES
@pytest.mark.parametrize("B,n_chains", DPTNET_SHAPES,
                         ids=["serve-intra", "serve-inter", "causal-inter", "train-intra",
                              "train-inter"])
def test_dptnets_shapes_take_the_wide_kernel(dtype, B, n_chains):
    wide = _wide(256, dtype)
    path, (m, c) = ls._plan(B, n_chains, 256, dtype, SMS, clusters=_clusters(256),
                            routes=ls.ROUTES, wide=wide)
    assert path == "wide" and c in ls.WIDE_CLUSTER_SIZES[dtype]
    # The fewest waves, then the fewest rows x units a block (M / C), then the smaller
    # cluster and tile.
    options = {t: (-(-_blocks(B, n_chains, t[0]) // n), t[0] / t[1]) for t, n in wide.items()}
    assert options[(m, c)] == min(options.values())
    assert all(options[o] > options[(m, c)] or o[1] > c or (o[1] == c and o[0] > m)
               for o in options if o != (m, c))


@pytest.mark.parametrize("dtype,B,n_chains,tile", [
    (BF16, 5112, 2, (64, 4)),  # 160 tiles: six waves of 30 four-block clusters
    (BF16, 800, 2, (64, 4)),  # 26 tiles: one wave
    (BF16, 800, 1, (32, 4)),  # 25 four-block clusters of 32 rows: one wave; (64, 8) ties
    (F32, 5112, 2, (32, 8)),  # 320 tiles: 22 waves of 15 eight-block clusters
    (F32, 800, 2, (32, 8)),  # four waves; 16-block clusters of 64 rows tie, the smaller cluster
    (F32, 200, 2, (32, 8)),  # 14 tiles: one wave
    (F32, 16, 2, (16, 16)),  # one wave either way, 16 rows x 16 units a block
    (BF16, 16, 2, (16, 8)),
], ids=["bf16-intra", "bf16-inter", "bf16-causal", "f32-intra", "f32-inter", "f32-train-inter",
        "f32-B=16", "bf16-B=16"])
def test_the_wide_tile_at_an_h100s_counts(dtype, B, n_chains, tile):
    assert ls._plan(B, n_chains, 256, dtype, SMS, "wide", None, ls.ROUTES,
                    _wide(256, dtype)) == ("wide", tile)


@DTYPES
@pytest.mark.parametrize("n_chains", [1, 2])
def test_the_wide_crossover_with_the_cluster_kernel(dtype, n_chains):
    B = ls.WIDE_MIN_BATCH[256][(dtype, n_chains)]
    assert 1 < B <= ls.CLUSTER_MAX_BATCH + 1  # B = 1 (musdb18 serving) keeps "cluster"
    below, at = (ls._plan(b, n_chains, 256, dtype, SMS, clusters=_clusters(256),
                          routes=ls.ROUTES, wide=_wide(256, dtype)) for b in (B - 1, B))
    assert below[0] == "cluster" and at[0] == "wide"
    musdb = ls._plan(1, 2, 256, dtype, SMS, clusters=_clusters(256), routes=ls.ROUTES,
                     wide=_wide(256, dtype))
    assert musdb[0] == "cluster"
    if dtype == F32:  # musdb18 training's B = 16 x 6 s
        assert ls._plan(16, 2, 256, dtype, SMS, clusters=_clusters(256), routes=ls.ROUTES,
                        wide=_wide(256, dtype)) == ("cluster", (1, 8))


@DTYPES
@pytest.mark.parametrize("B", [300, 1024, 20000])
def test_no_fma_at_h_256_where_the_card_holds_the_wide_kernel(dtype, B):
    got = ls._plan(B, 2, 256, dtype, SMS, clusters=_clusters(256), routes=ls.ROUTES,
                   wide=_wide(256, dtype))
    assert got[0] == "wide"


@pytest.mark.parametrize("wide,want", [
    ({(m, c): 0 for m, c in ls._wide_tiles(256, F32)}, "fma"),  # no GPC holds a cluster
    (None, "fma"),  # unasked
    ({(32, 8): 16}, ("wide", (32, 8))),  # one tile the card holds
    (_wide(256, F32, {8: 16, 16: 0}), ("wide", (32, 8))),  # no free 16-SM GPC
], ids=["zero", "unasked", "one-tile", "no-16"])
def test_the_wide_tile_follows_the_cards_counts(wide, want):
    got = ls._plan(800, 2, 256, F32, SMS, clusters=_clusters(256), routes=ls.ROUTES, wide=wide)
    assert got == want if isinstance(want, tuple) else got[0] == want


@pytest.mark.parametrize("B,dtype", [(1, F32), (4, BF16), (5112, F32)], ids=["B=1", "B=4", "big"])
def test_the_wide_path_can_be_forced_for_timing(B, dtype):
    got = ls._plan(B, 2, 256, dtype, SMS, "wide", None, ls.ROUTES, _wide(256, dtype))
    assert got[0] == "wide"


@pytest.mark.parametrize("H,dtype,wide", [
    (128, F32, _wide(256, F32)), (512, F32, _wide(256, F32)), (512, BF16, _wide(256, BF16)),
    (384, F32, _wide(256, F32, {8: 15})), (256, F32, None), (256, BF16, _wide(256, BF16, {})),
    (256, torch.float16, _wide(256, F32)),
], ids=["H=128", "H=512", "H=512-bf16", "H=384", "unasked", "zero", "f16"])
def test_forcing_the_wide_path_where_it_cannot_run_raises(H, dtype, wide):
    # H = 384 takes 16-block clusters in f32 alone: counts of 8-block ones do not do.
    with pytest.raises(ValueError):
        ls._plan(1000, 2, H, dtype, SMS, "wide", None, ls.ROUTES, wide)


@pytest.mark.parametrize("routes", [gs.ROUTES, ls.FORWARD_ROUTES], ids=["gru", "default"])
def test_forcing_the_wide_path_from_the_gru_wrapper_raises(routes):
    assert "wide" in ls.ROUTES and "wide" not in gs.ROUTES
    with pytest.raises(ValueError):
        gs._plan(1000, 2, 256, F32, SMS, "wide", None, routes, _wide(256, F32))


def test_the_gru_never_takes_the_wide_kernel():
    got = gs._plan(5112, 2, 256, F32, SMS, clusters=None, routes=gs.ROUTES,
                   wide=_wide(256, F32))
    assert got == _fma(5112, 2, 256)


@pytest.mark.parametrize("H,dtype,path,routes,want", [
    (256, F32, None, ls.ROUTES, True), (256, BF16, None, ls.ROUTES, True),
    (256, F32, "wide", ls.ROUTES, True), (256, F32, "cluster", ls.ROUTES, False),
    (256, F32, "fma", ls.ROUTES, False), (256, F32, None, gs.ROUTES, False),
    (512, F32, None, ls.ROUTES, False), (384, BF16, None, ls.ROUTES, True),
    (128, F32, None, ls.ROUTES, False), (128, BF16, None, ls.ROUTES, False),
    (256, torch.float16, None, ls.ROUTES, False),
], ids=["f32", "bf16", "forced", "forced-cluster", "forced-fma", "gru", "H=512", "H=384",
        "tf32x3", "mma", "f16"])
def test_the_wrapper_asks_the_card_for_wide_counts_only_where_the_wide_kernel_may_run(
        H, dtype, path, routes, want):
    assert ls._needs_wide(H, dtype, path, routes) is want
    # The cluster kernel's counts are still asked at H = 256 where "cluster" may run.
    if H == 256 and path is None and routes is ls.ROUTES and dtype != torch.float16:
        assert ls._needs_clusters(H, dtype, path, routes=routes)


@pytest.mark.parametrize("tile,args", [((64, 4), (64, 4)), ((16, 16), (16, 16))],
                         ids=["bf16", "f32-C=16"])
def test_a_wide_tile_goes_to_the_c_entry_points_with_its_cluster(tile, args):
    assert ls._tile_args(tile) == args
    assert ls._PATH_CODE["wide"] == 5


# The wide backward (csrc/recurrence_wide_bwd.cuh), the LSTM's only: from WIDE_MIN_BATCH_BWD
# sequences up at H = 256 (the crossover with the cluster backward, measured on an H100;
# musdb18 training's B = 16 stays on the cluster backward), an M-row tile on a cluster of
# C blocks (bf16: 4 or 8, f32: 8 or 16), by the forward's tile rule over the wide
# backward's own counts; below it "cluster", past CLUSTER_MAX_BATCH_BWD where the card
# holds no wide tile "fma".
def _wide_bwd(H, dtype, by_c=WIDE_BY_C):
    """The wide backward's counts by tile the LSTM wrapper would ask the card for at H."""
    return {(m, c): by_c.get(c, 0) for m, c in ls._wide_tiles(H, dtype, backward=True)}


def _plan_bwd_h256(B, n_chains, dtype, path=None, wrapper=ls, wide=None):
    return wrapper._plan_bwd(B, n_chains, 256, dtype, SMS, path, _bwd_clusters(256),
                             wrapper.ROUTES, _wide_bwd(256, dtype) if wide is None else wide)


DPTNET_TRAIN_SHAPES = [  # B, chains, the f32 tile: DPTNet's recipe training, B = 2 x 4 s
    (1278, 2, (32, 8)),  # intra-chunk: 80 tiles, six waves of 15 eight-block clusters
    (200, 2, (32, 8)),  # inter-chunk: 14 tiles, one wave
    (200, 1, (16, 8)),  # causal inter-chunk: 13 tiles, one wave; (32, 16) ties on waves and
                        # rows x units, the smaller cluster
]


@DTYPES
@pytest.mark.parametrize("B,n_chains,tile", DPTNET_TRAIN_SHAPES,
                         ids=["train-intra", "train-inter", "train-causal-inter"])
def test_dptnets_training_shapes_take_the_wide_backward(dtype, B, n_chains, tile):
    path, (m, c) = _plan_bwd_h256(B, n_chains, dtype)
    assert path == "wide" and c in ls.WIDE_CLUSTER_SIZES[dtype]
    if dtype == F32:
        assert (m, c) == tile
    # The fewest waves, then the fewest rows x units a block (M / C), then the smaller
    # cluster and tile, over the backward's own tiles.
    wide = _wide_bwd(256, dtype)
    options = {t: (-(-_blocks(B, n_chains, t[0]) // n), t[0] / t[1]) for t, n in wide.items()}
    assert options[(m, c)] == min(options.values())
    assert all(options[o] > options[(m, c)] or o[1] > c or (o[1] == c and o[0] > m)
               for o in options if o != (m, c))


@DTYPES
def test_musdb18_training_keeps_the_cluster_backward(dtype):
    # UMX / X-UMX training, B = 16 x 6 s, two chains: 32 sequences a launch.
    assert 16 < ls.WIDE_MIN_BATCH_BWD[256][(dtype, 2)]
    assert _plan_bwd_h256(16, 2, dtype) == ("cluster", (1, 8))


@DTYPES
@pytest.mark.parametrize("n_chains", [1, 2])
def test_the_wide_backward_crossover_with_the_cluster_backward(dtype, n_chains):
    B = ls.WIDE_MIN_BATCH_BWD[256][(dtype, n_chains)]
    assert 1 < B <= ls.CLUSTER_MAX_BATCH_BWD + 1  # B = 1 keeps "cluster"
    below, at = (_plan_bwd_h256(b, n_chains, dtype)[0] for b in (B - 1, B))
    assert below == "cluster" and at == "wide"
    assert _plan_bwd_h256(1, n_chains, dtype)[0] == "cluster"


@DTYPES
@pytest.mark.parametrize("B", [300, 1278, 20000])
def test_no_fma_backward_at_h_256_where_the_card_holds_the_wide_kernel(dtype, B):
    assert _plan_bwd_h256(B, 2, dtype)[0] == "wide"


@pytest.mark.parametrize("wide,want", [
    ({(m, c): 0 for m, c in ls._wide_tiles(256, F32, backward=True)}, ("fma", 1)),  # no GPC
    ({}, ("fma", 1)),  # unasked
    ({(16, 16): 7}, ("wide", (16, 16))),  # one tile the card holds
    (_wide_bwd(256, F32, {8: 15, 16: 0}), ("wide", (32, 8))),  # no free 16-SM GPC
], ids=["zero", "unasked", "one-tile", "no-16"])
def test_the_wide_backward_tile_follows_the_cards_counts(wide, want):
    assert _plan_bwd_h256(1278, 2, F32, wide=wide) == (
        want if want[0] == "wide" else _fma_bwd(1278, 2, 256))


@pytest.mark.parametrize("B,dtype", [(1, F32), (16, BF16), (5112, F32)], ids=["B=1", "B=16", "big"])
def test_the_wide_backward_can_be_forced_for_timing(B, dtype):
    assert _plan_bwd_h256(B, 2, dtype, "wide")[0] == "wide"


@pytest.mark.parametrize("H,dtype,wide", [
    (128, F32, _wide_bwd(256, F32)), (512, F32, _wide_bwd(256, F32)),
    (384, BF16, _wide_bwd(256, BF16, {4: 30})), (256, F32, None),
    (256, BF16, _wide_bwd(256, BF16, {})), (256, torch.float16, _wide_bwd(256, F32)),
], ids=["H=128", "H=512", "H=384", "unasked", "zero", "f16"])
def test_forcing_the_wide_backward_where_it_cannot_run_raises(H, dtype, wide):
    # H = 384 takes 8-block clusters in bf16 alone: counts of 4-block ones do not do.
    with pytest.raises(ValueError):
        ls._plan_bwd(1278, 2, H, dtype, SMS, "wide", None, ls.ROUTES, wide)


@DTYPES
@pytest.mark.parametrize("routes", [gs.ROUTES, ls.FORWARD_ROUTES], ids=["gru", "default"])
def test_forcing_the_wide_backward_from_the_gru_wrapper_raises(dtype, routes):
    with pytest.raises(ValueError):
        gs._plan_bwd(1278, 2, 256, dtype, SMS, "wide", None, routes, _wide_bwd(256, dtype))


@DTYPES
@pytest.mark.parametrize("B,n_chains,H", [(1278, 2, 384), (1278, 1, 512), (200, 2, 512),
                                          (5112, 2, 256)],
                         ids=["H=384", "H=512", "H=512-B=200", "gru-H=256"])
def test_other_h_and_the_gru_never_take_the_wide_backward(dtype, B, n_chains, H):
    wide = {(m, c): 15 for m in ls.WIDE_TILE_ROWS for c in (4, 8, 16)}  # whatever the card
    for wrapper in (ls, gs) if H != 256 else (gs,):  # the LSTM's H = 256: the tests above
        got = wrapper._plan_bwd(B, n_chains, H, dtype, SMS, clusters=_bwd_clusters(H),
                                routes=wrapper.ROUTES, wide=wide)
        if wrapper is ls and H in ls.WIDE_HIDDENS:  # H = 384 (H = 300's width): it does
            assert got[0] == "wide"
            continue
        want = (ls._plan_bwd(B, n_chains, H, dtype, SMS, clusters=_bwd_clusters(H),
                             routes=ls.ROUTES) if wrapper is ls else _fma_bwd(B, n_chains, H))
        assert got == want and got[0] != "wide"  # the plan without wide counts


@pytest.mark.parametrize("H,dtype,path,routes,want", [
    (256, F32, None, ls.ROUTES, True), (256, BF16, None, ls.ROUTES, True),
    (256, F32, "wide", ls.ROUTES, True), (256, F32, "cluster", ls.ROUTES, False),
    (256, F32, "fma", ls.ROUTES, False), (256, F32, None, gs.ROUTES, False),
    (512, F32, None, ls.ROUTES, False), (384, BF16, None, ls.ROUTES, True),
    (128, F32, None, ls.ROUTES, False), (128, BF16, None, ls.ROUTES, False),
    (256, torch.float16, None, ls.ROUTES, False),
], ids=["f32", "bf16", "forced", "forced-cluster", "forced-fma", "gru", "H=512", "H=384",
        "tf32x3", "tf32x2", "f16"])
def test_the_backward_asks_the_card_for_wide_counts_only_where_the_wide_kernel_may_run(
        H, dtype, path, routes, want):
    assert ls._needs_wide(H, dtype, path, routes, backward=True) is want


def test_the_backward_path_code_of_the_wide_kernel():
    assert ls._PATH_CODE["wide"] == 5
    assert all("wide" in paths for paths in ls.BWD_PATH_LAUNCHES.values())
    assert ls._tile_args((32, 8)) == (32, 8)


# LSTM-TasNet's H = 500 (egs/wsj0-mix/lstm-tasnet/train.sh): 384 < H < 512 off the multiples
# of 128, so the LSTM's cluster kernels take it at the zero-padded width 512 (C = 16 only),
# forward and backward, with the kernels' counts at 512; 16-block counts of 7 and 8, as an
# H100 holds.
LSTM_TASNET_SHAPES = [(8, 2), (8, 1), (4, 2), (4, 1)]  # B, chains
LSTM_TASNET_IDS = ["serve", "serve-causal", "train", "train-causal"]
PADDED_COUNTS = pytest.mark.parametrize("counts", [{16: 7}, {16: 8}], ids=["16:7", "16:8"])


@PADDED_COUNTS
@DTYPES
@pytest.mark.parametrize("B,n_chains", LSTM_TASNET_SHAPES, ids=LSTM_TASNET_IDS)
def test_lstm_tasnets_h_500_takes_the_padded_cluster_route(counts, dtype, B, n_chains):
    forward = ls._plan(B, n_chains, 500, dtype, SMS, clusters=counts, routes=ls.ROUTES,
                       wide=_wide(500, dtype))
    backward = ls._plan_bwd(B, n_chains, 500, dtype, SMS, clusters=counts, routes=ls.ROUTES,
                            wide=_wide_bwd(500, dtype))
    assert forward == backward == ("cluster", (1, 16))
    assert ls.launch_width(500, "cluster") == ls.cluster_width(500) == 512
    assert ls.cluster_layout(512, 16, dtype) and ls.cluster_bwd_layout(512, 16, dtype)
    assert ls._needs_clusters(500, dtype, None, routes=ls.ROUTES)
    assert ls._needs_clusters(500, dtype, None, backward=True, routes=ls.ROUTES)
    assert not ls._needs_wide(500, dtype, None, ls.ROUTES)


@pytest.mark.parametrize("H", [385, 448, 500, 511])
def test_every_h_between_384_and_512_pads_to_512(H):
    assert ls.cluster_width(H) == 512
    assert ls._plan(1, 1, H, F32, SMS, clusters={16: 7}, routes=ls.ROUTES) == ("cluster", (1, 16))
    assert ls.launch_width(H, "fma") == H


@DTYPES
def test_h_500_without_16_block_clusters_takes_fma(dtype):
    for B, n_chains in LSTM_TASNET_SHAPES:
        assert ls._plan(B, n_chains, 500, dtype, SMS, clusters={16: 0},
                        routes=ls.ROUTES) == _fma(B, n_chains, 500)
        assert ls._plan_bwd(B, n_chains, 500, dtype, SMS, clusters={16: 0},
                            routes=ls.ROUTES) == _fma_bwd(B, n_chains, 500)
    with pytest.raises(ValueError):
        ls._plan(8, 2, 500, dtype, SMS, "cluster", {16: 0}, ls.ROUTES)
    with pytest.raises(ValueError):
        ls._plan_bwd(4, 2, 500, dtype, SMS, "cluster", {16: 0}, ls.ROUTES)


@DTYPES
@pytest.mark.parametrize("B,n_chains", LSTM_TASNET_SHAPES, ids=LSTM_TASNET_IDS)
def test_forcing_fma_at_h_500_runs_it_unpadded(dtype, B, n_chains):
    forward = ls._plan(B, n_chains, 500, dtype, SMS, "fma", {16: 7}, ls.ROUTES)
    backward = ls._plan_bwd(B, n_chains, 500, dtype, SMS, "fma", {16: 7}, ls.ROUTES)
    assert forward == _fma(B, n_chains, 500) and backward == _fma_bwd(B, n_chains, 500)
    assert ls.launch_width(500, "fma") == 500
    assert not ls._needs_clusters(500, dtype, "fma", routes=ls.ROUTES)


def test_the_padded_cluster_route_can_be_forced_past_the_crossover():
    B = ls.CLUSTER_MAX_BATCH + 1
    assert ls._plan(B, 2, 500, F32, SMS, clusters={16: 7}, routes=ls.ROUTES)[0] == "fma"
    assert ls._plan(B, 2, 500, F32, SMS, "cluster", {16: 7}, ls.ROUTES) == ("cluster", (1, 16))
    assert ls._plan_bwd(B, 2, 500, F32, SMS, "cluster", {16: 7}, ls.ROUTES) == (
        "cluster", (1, 16))


@DTYPES
def test_the_gru_keeps_fma_at_h_500(dtype):
    assert not ls._needs_clusters(500, dtype, None, routes=gs.ROUTES)
    assert gs._plan(8, 2, 500, dtype, SMS, clusters={16: 7}) == _fma(8, 2, 500)
    assert gs._plan_bwd(4, 2, 500, dtype, SMS, clusters={16: 7}) == _fma_bwd(4, 2, 500)


# DANet's, ADANet's and deep clustering's H = 300 (egs/wsj0-mix/{danet,adanet,
# deep-clustering}): 256 < H < 384 off the multiples of 128, so the LSTM's cluster and wide
# kernels take it zero-padded to 384, with their counts at 384 (16-block clusters: 7 on an
# H100). Requests (B = 1, a 4 s utterance) take the cluster kernels; training's B = 64 the
# route CLUSTER_MAX_BATCH_PADDED and WIDE_MIN_BATCH[384] (their backward's) give it.
def _wide384(dtype, backward=False, by_c=WIDE_BY_C):
    return (_wide_bwd if backward else _wide)(384, dtype, by_c)


def _h300_route(B, dtype, backward=False):
    """The route the constants give two chains of B sequences at H = 300."""
    least = (ls.WIDE_MIN_BATCH_BWD if backward else ls.WIDE_MIN_BATCH)[384].get((dtype, 2))
    if least is not None and B >= least:
        return "wide"
    limit = (ls.CLUSTER_MAX_BATCH_BWD_PADDED if backward else ls.CLUSTER_MAX_BATCH_PADDED)[384]
    return "cluster" if B <= limit else "fma"


@pytest.mark.parametrize("H", [257, 300, 320, 383])
def test_every_h_between_256_and_384_pads_to_384(H):
    assert ls.cluster_width(H) == ls.launch_width(H, "cluster") == ls.launch_width(H, "wide") == 384
    assert ls.launch_width(H, "fma") == H
    assert ls._plan(1, 2, H, F32, SMS, clusters={16: 7}, routes=ls.ROUTES,
                    wide=_wide384(F32)) == ("cluster", (1, 16))


@DTYPES
def test_h_300_requests_take_the_padded_cluster_kernels(dtype):
    assert ls._plan(1, 2, 300, dtype, SMS, clusters={16: 7}, routes=ls.ROUTES,
                    wide=_wide384(dtype)) == ("cluster", (1, 16))
    assert ls._plan_bwd(1, 2, 300, dtype, SMS, clusters={16: 7}, routes=ls.ROUTES,
                        wide=_wide384(dtype, True)) == ("cluster", (1, 16))
    assert ls.cluster_layout(384, 16, dtype) and ls.cluster_bwd_layout(384, 16, dtype)
    assert not ls.cluster_layout(384, 8, dtype)  # 48 units a rank: 768 threads


@DTYPES
@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("B", [1, 4, 16, 32, 64, 128])
def test_h_300_training_takes_the_route_the_constants_give(dtype, backward, B):
    plan = ls._plan_bwd if backward else ls._plan
    got = plan(B, 2, 300, dtype, SMS, clusters={16: 7}, routes=ls.ROUTES,
               wide=_wide384(dtype, backward))
    want = _h300_route(B, dtype, backward)
    assert got[0] == want
    if want == "wide":  # a tile of 16 blocks in f32, 8 in bf16
        assert got[1] in ls._wide_tiles(384, dtype, backward)
        assert got[1][1] == (16 if dtype == F32 else 8)
    elif want == "fma":
        assert got == _fma(B, 2, 300)  # unpadded
    # no plan pads the FMA kernel, and none pads past 384
    assert ls.launch_width(300, got[0]) == (300 if got[0] == "fma" else 384)


@DTYPES
@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_h_300_asks_for_the_counts_at_384(dtype, backward):
    assert ls._needs_clusters(300, dtype, None, backward, ls.ROUTES)
    assert ls._needs_wide(300, dtype, None, ls.ROUTES, backward)
    assert not ls._needs_clusters(300, dtype, "fma", backward, ls.ROUTES)
    assert not ls._needs_wide(300, dtype, "fma", ls.ROUTES, backward)
    assert ls._wide_tiles(ls.cluster_width(300), dtype, backward)


@DTYPES
@pytest.mark.parametrize("B", [1, 64], ids=["request", "train"])
def test_forcing_fma_at_h_300_runs_it_unpadded(dtype, B):
    forward = ls._plan(B, 2, 300, dtype, SMS, "fma", {16: 7}, ls.ROUTES, _wide384(dtype))
    backward = ls._plan_bwd(B, 2, 300, dtype, SMS, "fma", {16: 7}, ls.ROUTES,
                            _wide384(dtype, True))
    assert forward == _fma(B, 2, 300) and backward == _fma_bwd(B, 2, 300)
    assert ls.launch_width(300, "fma") == 300


@DTYPES
@pytest.mark.parametrize("B", [1, 64, 128], ids=["request", "train", "B=128"])
def test_h_300_without_16_block_clusters_takes_fma(dtype, B):
    # bf16's wide tiles take 8 blocks: a card with no free 16-SM GPC still holds them.
    no16 = {4: 30, 8: 15, 16: 0}
    for backward in (False, True):
        plan = ls._plan_bwd if backward else ls._plan
        got = plan(B, 2, 300, dtype, SMS, clusters={16: 0}, routes=ls.ROUTES,
                   wide=_wide384(dtype, backward, no16))
        if dtype == BF16 and _h300_route(B, dtype, backward) == "wide":
            assert got[0] == "wide" and got[1][1] == 8
        else:
            assert got == _fma(B, 2, 300)


@DTYPES
def test_the_gru_keeps_fma_at_h_300(dtype):
    assert not ls._needs_clusters(300, dtype, None, routes=gs.ROUTES)
    assert not ls._needs_wide(300, dtype, None, gs.ROUTES)
    for B in (1, 64):
        assert gs._plan(B, 2, 300, dtype, SMS, clusters={16: 7}, wide=_wide384(dtype)) == (
            _fma(B, 2, 300))
        assert gs._plan_bwd(B, 2, 300, dtype, SMS, clusters={16: 7}) == _fma_bwd(B, 2, 300)


@pytest.mark.parametrize("H,width,forward,backward", [
    (40, 40, ("fma", 1), ("fma", 1)),
    (256, 256, ("cluster", (1, 8)), ("cluster", (1, 8))),
    # 256 < H < 384: unpadded on the FMA kernel until the H = 300 routes, now at 384
    (300, 384, ("cluster", (1, 16)), ("cluster", (1, 16))),
    (384, 384, ("cluster", (1, 16)), ("cluster", (1, 16))),
    (512, 512, ("cluster", (1, 16)), ("cluster", (1, 16))),
], ids=["H=40", "H=256", "H=300", "H=384", "H=512"])
def test_other_widths_plan_unpadded_as_before(H, width, forward, backward):
    # LSTM-TasNet's serving (B = 8, two chains) and training (B = 4) shapes at other widths.
    assert ls.cluster_width(H) == width
    assert all(ls.launch_width(H, p) == (width if p in ("cluster", "wide") else H)
               for p in ("fma", "cluster", "wide", "tf32x3"))
    assert ls._plan(8, 2, H, F32, SMS, clusters=_clusters(width), routes=ls.ROUTES,
                    wide=_wide(width, F32)) == forward
    assert ls._plan_bwd(4, 2, H, F32, SMS, clusters=_bwd_clusters(width), routes=ls.ROUTES,
                        wide=_wide_bwd(width, F32)) == backward


# FurcaNet (egs/wsj0-mix/furcanet/train.sh: six biLSTM layers at H = 128 over every sample)
# runs few, very long sequences: 4 x 16000 steps in training (B = 4 x 2 s), 8 x 32000 in a
# B = 8 x 4 s forward, 1 x the request's length in serving. chip_smoke.py phase 15k timed
# every route and tf32x3 tile there (PERF.md section 6, PR 21, one H100 at 700 W): f32
# (4, 16000) x 2 with cs on tf32x3 (16, 4) 47.8 ms against (16, 2) 59.3, (32, 4) 69.8, the
# FMA kernel 92.5 and cuDNN 61.7; its backward alone (16, 4) 63.3 ms against (16, 2) 78.0
# and FMA 111.7; f32 (8, 32000) x 2 tf32x3 95.6 ms against FMA 185.5; bf16 (8, 32000) x 2
# mma 56.7 ms against FMA 161.1. The rule already takes the fastest of them: the tensor
# cores, and of the tiles the fewest waves, then the fewest rows x units a block.
@pytest.mark.parametrize("B", [1, 4, 8], ids=["request", "train", "B=8"])
def test_furcanet_long_sequences_take_the_fastest_measured_route(B):
    assert ls._plan(B, 2, 128, F32, SMS, clusters=CLUSTERS, routes=ls.ROUTES) == (
        "tf32x3", (16, 4))
    assert ls._plan(B, 2, 128, BF16, SMS, clusters=CLUSTERS, routes=ls.ROUTES) == ("mma", 16)
    assert ls._plan_bwd(B, 2, 128, F32, SMS, clusters=CLUSTERS, routes=ls.ROUTES) == (
        "tf32x3", (16, 4))


# MRX (egs/musdb18/mrx/train.sh: three biLSTM layers a resolution at H = 256) runs 16
# sequences of 1035 frames in training and 1 of 1724 in a 10 s validation forward: the
# cluster kernels, below WIDE_MIN_BATCH (phase 15k: 2.44 and 1.20 ms against FMA 18.81 and
# 31.49; the backward 3.98 ms whole against 19.29).
@pytest.mark.parametrize("B,C", [(1, 16), (16, 8)], ids=["valid", "train"])
def test_mrx_sequences_take_the_cluster_kernels(B, C):
    assert ls._plan(B, 2, 256, F32, SMS, clusters=_clusters(256), routes=ls.ROUTES,
                    wide=_wide(256, F32)) == ("cluster", (1, C))
    assert ls._plan_bwd(B, 2, 256, F32, SMS, clusters=_clusters(256), routes=ls.ROUTES,
                        wide=_wide(256, F32))[0] == "cluster"
