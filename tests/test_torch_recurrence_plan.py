"""The recurrence wrappers' launch plans: which forward kernel and which tile (CPU).

`_plan` is pure Python: from the dtype and the shape it picks the
tensor-core kernel ("mma", M-row tiles) or the FMA kernel ("fma", R
sequences per group) before the launch. On the card chip_smoke.py checks
that every bf16 recurrence of the served and trained models took "mma" and
every f32 one "fma"; here the rule itself is held, at an H100's 132 SMs.
"""
import pytest
import torch

from dnn_based_source_separation_torch.ops import gru_scan as gs
from dnn_based_source_separation_torch.ops import lstm_scan as ls

SMS = 132
BF16, F32 = torch.bfloat16, torch.float32
WRAPPERS = pytest.mark.parametrize("wrapper", [ls, gs], ids=["lstm", "gru"])


def _blocks(B, n_chains, tile):
    return n_chains * -(-B // tile)


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
    (2040, 2, 128, F32, 4),
    (2000, 1, 128, F32, 2),
    (510, 2, 128, F32, 1),
    (37, 2, 40, F32, 1),
    (64, 2, 256, F32, 1),
    (4096, 1, 512, F32, 4),
    (37, 2, 40, BF16, 1),
    (64, 2, 256, BF16, 1),
    (400, 2, 256, BF16, 2),
    (16, 2, 512, BF16, 1),
], ids=["f32-intra", "f32-inter", "f32-train", "f32-H=40", "f32-H=256", "f32-H=512",
        "bf16-H=40", "bf16-H=256", "bf16-H=256-R2", "bf16-H=512"])
def test_other_calls_take_the_fma_kernel_with_its_tile(wrapper, B, n_chains, H, dtype, R):
    # The FMA kernel's rule, unchanged: groups = min(4, 256 / (H / 2)) of R
    # sequences a block, the largest R in 4, 2, 1 that gives every SM a block.
    assert wrapper._plan(B, n_chains, H, dtype, SMS) == ("fma", R)
    groups = min(4, 256 // (H // 2))
    assert _blocks(B, n_chains, groups * R) >= SMS or R == 1
    if R < 4:
        assert _blocks(B, n_chains, groups * 2 * R) < SMS


@WRAPPERS
@pytest.mark.parametrize("B,n_chains,R", [(2040, 2, 4), (2000, 1, 2), (3, 2, 1)])
def test_the_fma_path_can_be_forced_for_timing(wrapper, B, n_chains, R):
    assert wrapper._plan(B, n_chains, 128, BF16, SMS, path="fma") == ("fma", R)


@WRAPPERS
@pytest.mark.parametrize("H,dtype", [(256, BF16), (128, F32), (40, BF16), (144, BF16)],
                         ids=["H=256", "f32", "H=40", "H=144"])
def test_forcing_the_tensor_cores_where_they_cannot_run_raises(wrapper, H, dtype):
    with pytest.raises(ValueError):
        wrapper._plan(2040, 2, H, dtype, SMS, path="mma")


def test_both_wrappers_plan_by_one_rule():
    assert gs._plan is ls._plan
