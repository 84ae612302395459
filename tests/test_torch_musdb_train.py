"""Port's musdb18 training of Open-Unmix and X-UMX against the JAX package (CPU).

- BatchNorm in train mode (`models/umx.py:TransformBlock1d`): its output and running
  statistics after one and two forwards against flax's mutable `batch_stats`, at 1e-5.
- Dropout between the LSTM and GRU layers: eval mode and rate 0 are the identity, the
  kept values are scaled by 1/keep, the masks sit between layers only, one generator seed
  gives one mask, and the kept share is within 3 sigma of keep.
- One Adam step of tiny UMX and X-UMX through `make_train_step` against JAX's
  `make_train_step` (dropout 0, the same weights through `hub/from_jax.py`, JAX's LSTM
  in `lax.scan`): the loss, every updated parameter and the running statistics at 1e-4;
  the bf16 step writes the running statistics back to the f32 buffers.
- `augmentation.py` and the train datasets byte for byte against JAX's, for one seed and
  the same indices.
- `cli/train_musdb18.py --device cpu` for one epoch per model, its refusals, the
  recipe shells through its parser, and a port checkpoint after one step opened in JAX
  through `convert_open_unmix` / `convert_xumx`, whose eval output matches the port's
  at 1e-4.

Tiny widths (`tests/test_cli.py:134-151`): n_fft 64, hop 32, hidden 16, 1-2 layers,
max_bin 20, stereo, four sources, B = 2 x 0.25 s at 8 kHz.
"""
import os
import pathlib
import re
import shlex

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch import augmentation as aug
from dnn_based_source_separation_torch.cli import train_musdb18 as cli
from dnn_based_source_separation_torch.criterion import (
    MSELoss, MultiDomainLoss, SpectralTargetAdapter,
)
from dnn_based_source_separation_torch.data import musdb18 as musdb
from dnn_based_source_separation_torch.data.synthetic import write_musdb_quality_corpus
from dnn_based_source_separation_torch.hub import (
    parallel_open_unmix_state_dict_from_jax, xumx_state_dict_from_jax,
)
from dnn_based_source_separation_torch.models import (
    CrossNetOpenUnmix, ParallelOpenUnmix, SpectrogramMaskingWrapper,
)
from dnn_based_source_separation_torch.models.base import read_checkpoint
from dnn_based_source_separation_torch.models.umx import TransformBlock1d
from dnn_based_source_separation_torch.ops.norms import flax_batch_norm
from dnn_based_source_separation_torch.ops.rnn import GRU, LSTM, set_dropout_generator
from dnn_based_source_separation_torch.ops.windows import build_window
from dnn_based_source_separation_torch.train import make_optimizer, make_train_step
from dnn_based_source_separation_tpu import augmentation as jaug
from dnn_based_source_separation_tpu.criterion.distance import MSELoss as JMSELoss
from dnn_based_source_separation_tpu.criterion.multidomain import (
    MultiDomainLoss as JMultiDomainLoss,
)
from dnn_based_source_separation_tpu.criterion.spectral import (
    SpectralTargetAdapter as JSpectralTargetAdapter,
)
from dnn_based_source_separation_tpu.data import musdb18 as jmusdb
from dnn_based_source_separation_tpu.hub.torch_convert import convert_open_unmix, convert_xumx
from dnn_based_source_separation_tpu.models import umx as jumx
from dnn_based_source_separation_tpu.models import wrappers as jwrappers
from dnn_based_source_separation_tpu.models import xumx as jxumx
from dnn_based_source_separation_tpu.ops.windows import build_window as jax_build_window
from dnn_based_source_separation_tpu.train.steps import make_optimizer as jax_make_optimizer
from dnn_based_source_separation_tpu.train.steps import make_train_step as jax_make_train_step

SR = 8000
N_FFT, HOP = 64, 32
SOURCES = ("bass", "drums", "other", "vocals")
CFG = dict(in_channels=2, hidden_channels=16, num_layers=2, n_bins=N_FFT // 2 + 1, max_bin=20,
           sources=SOURCES)
BASES = {"umx": (ParallelOpenUnmix, jumx.ParallelOpenUnmix, parallel_open_unmix_state_dict_from_jax),
         "xumx": (CrossNetOpenUnmix, jxumx.CrossNetOpenUnmix, xumx_state_dict_from_jax)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= rtol * max(np.abs(ref).max(), 1e-30), (
        np.abs(got - ref).max(), np.abs(ref).max())


def _scramble(tree, rng):
    """Every leaf off its init: positive scales and variances, non-zero biases and means."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _scramble(v, rng)
            continue
        v = np.asarray(v)
        if k in ("scale", "var") or k.startswith("scale_"):
            v = 0.5 + rng.random(v.shape)
        elif k in ("bias", "mean") or k.startswith("bias_") or k.startswith("b"):
            v = 0.2 * rng.standard_normal(v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


# -- BatchNorm in train mode ------------------------------------------------------------

def _block_pair(seed, F_in=12, F_out=5):
    jblock = jumx.TransformBlock1d(F_out, nonlinear="tanh")
    x = np.zeros((2, 9, F_in), np.float32)
    variables = jax.tree_util.tree_map(np.asarray, dict(jblock.init(jax.random.PRNGKey(seed), x)))
    variables = _scramble(variables, np.random.default_rng(seed))
    block = TransformBlock1d(F_in, F_out, nonlinear="tanh")
    p, s = variables["params"], variables["batch_stats"]
    block.load_state_dict({
        "fc.weight": torch.from_numpy(p["linear"]["kernel"].T.copy()),
        "norm1d.weight": torch.from_numpy(p["norm"]["scale"]),
        "norm1d.bias": torch.from_numpy(p["norm"]["bias"]),
        "norm1d.running_mean": torch.from_numpy(s["norm"]["mean"]),
        "norm1d.running_var": torch.from_numpy(s["norm"]["var"]),
        "norm1d.num_batches_tracked": torch.tensor(0)})
    return jblock, variables, block


def test_batch_norm_train_matches_flax_batch_stats():
    # B * T = 18 rows: an unbiased running variance would be 18/17 of flax's.
    jblock, variables, block = _block_pair(seed=1)
    block.train()
    rng = np.random.default_rng(2)
    for step in range(2):
        x = (1.5 * rng.standard_normal((2, 9, 12)) + 0.3).astype(np.float32)
        ref, mutated = jblock.apply(variables, jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
        got = block(torch.from_numpy(x))
        _close(got.detach().numpy(), ref, 1e-5)
        stats = variables["batch_stats"]["norm"]
        _close(block.norm1d.running_mean.numpy(), stats["mean"], 1e-5)
        _close(block.norm1d.running_var.numpy(), stats["var"], 1e-5)
        assert int(block.norm1d.num_batches_tracked) == step + 1
    # Eval mode normalises with the running statistics, as flax's train=False does.
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    _close(block.eval()(torch.from_numpy(x)).detach().numpy(),
           jblock.apply(variables, jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16],
                         ids=["f64", "f32", "bf16"])
def test_flax_batch_norm_computes_in_the_inputs_precision(dtype):
    # f64 input: f64 statistics (chip_smoke's f64 reference steps); f32 and bf16 as before,
    # in f32. A mean of 1e3 over a spread of 1 loses digits to E[x^2] - E[x]^2 in f32.
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 4, 50)) + 1e3).to(dtype)
    norm, kept = (torch.nn.BatchNorm1d(4, dtype=torch.promote_types(dtype, torch.float32))
                  for _ in range(2))
    for n in (norm, kept):
        with torch.no_grad():
            n.weight.copy_(torch.linspace(0.5, 2.0, 4))
            n.bias.copy_(torch.linspace(-1.0, 1.0, 4))
    got = flax_batch_norm(x, norm, dim=1).detach()
    assert got.dtype == dtype
    in_f32 = flax_batch_norm(x, kept, dim=1, dtype=torch.float32).detach()
    xd = x.double()
    mean, var = xd.mean(dim=(0, 2)), xd.var(dim=(0, 2), unbiased=False)
    want = ((xd - mean[:, None]) / torch.sqrt(var[:, None] + norm.eps)
            * norm.weight.detach().double()[:, None] + norm.bias.detach().double()[:, None])
    if dtype == torch.float64:
        assert float((got - want).abs().max()) < 1e-9
        assert float((in_f32.double() - want).abs().max()) > 1e-4  # what f32 statistics lose
        assert float((norm.running_var - 0.9 - 0.1 * var).abs().max()) < 1e-9
    else:
        assert torch.equal(got, in_f32)  # unchanged: f32 statistics
        assert torch.equal(norm.running_mean, kept.running_mean)
        assert torch.equal(norm.running_var, kept.running_var)


def test_batch_norm_train_gradient_flows_through_the_batch_statistics():
    _, _, block = _block_pair(seed=3)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 9, 12)).astype(np.float32))
    x.requires_grad_()
    block.train()(x).sum().backward()
    assert x.grad is not None and float(x.grad.abs().max()) > 0
    assert block.fc.weight.grad is not None and block.norm1d.weight.grad is not None


# -- Dropout between the recurrent layers -------------------------------------------------

RNNS = pytest.mark.parametrize("cls", [LSTM, GRU], ids=["lstm", "gru"])


def _rnn(cls, dropout, num_layers=2, bidirectional=True):
    return cls(6, 5, num_layers=num_layers, bidirectional=bidirectional, dropout=dropout,
               generator=torch.Generator().manual_seed(0))


def _x(seed=5):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((3, 7, 6)).astype(
        np.float32))


@RNNS
def test_dropout_is_the_identity_in_eval_mode_and_at_rate_zero(cls):
    x = _x()
    with torch.no_grad():
        plain = _rnn(cls, 0.0).train()(x)  # rate 0 in train mode: no mask, no generator
        eval_out = _rnn(cls, 0.5).eval()(x)
    torch.testing.assert_close(eval_out, plain, rtol=0, atol=0)


@RNNS
@pytest.mark.parametrize("bidirectional", [True, False])
def test_dropout_scales_by_one_over_keep_between_layers_only(cls, bidirectional):
    rate, x = 0.3, _x(6)
    model = _rnn(cls, rate, num_layers=3, bidirectional=bidirectional).train()
    set_dropout_generator(model, torch.Generator().manual_seed(7))
    with torch.no_grad():
        got = model(x)
    # By hand: each layer alone (its weights in a 1-layer module), the masks from the
    # same seed in the same order, after layers 0 and 1 and not after the last.
    g = torch.Generator().manual_seed(7)
    h = x
    with torch.no_grad():
        for layer in range(3):
            single = cls(h.shape[-1], 5, num_layers=1, bidirectional=bidirectional)
            sfx = [f"_l{layer}"] + ([f"_l{layer}_reverse"] if bidirectional else [])
            single.load_state_dict({
                f"{name}{s.replace(f'_l{layer}', '_l0')}": getattr(model, f"{name}{s}")
                for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh") for s in sfx})
            h = single.eval()(h)
            if layer < 2:
                mask = torch.empty_like(h).bernoulli_(1 - rate, generator=g).bool()
                h = torch.where(mask, h / (1 - rate), torch.zeros_like(h))
    torch.testing.assert_close(got, h, rtol=0, atol=0)
    # Two masks were drawn, so both generators stand at the same state.
    assert torch.equal(g.get_state(), model.generator.get_state())


@RNNS
def test_dropout_masks_follow_the_generator_seed(cls):
    x, model = _x(8), _rnn(cls, 0.5).train()
    outs = []
    for seed in (9, 9, 10):
        set_dropout_generator(model, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            outs.append(model(x))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


@RNNS
def test_dropout_needs_a_generator_and_a_single_layer_draws_none(cls):
    x = _x(11)
    with pytest.raises(ValueError, match="dropout generator"):
        _rnn(cls, 0.5).train()(x)
    single = _rnn(cls, 0.5, num_layers=1).train()
    set_dropout_generator(single, torch.Generator().manual_seed(1))
    state = single.generator.get_state()
    with torch.no_grad():
        torch.testing.assert_close(single(x), single.eval()(x), rtol=0, atol=0)
    assert torch.equal(state, single.generator.get_state())


@pytest.mark.parametrize("rate", [0.4, 0.1])
def test_dropout_keeps_a_share_of_keep(rate):
    model = _rnn(LSTM, rate).train()
    set_dropout_generator(model, torch.Generator().manual_seed(12))
    n = 200_000
    y = model._dropout(torch.ones(n))
    keep = 1 - rate
    kept = y != 0
    share = float(kept.float().mean())
    assert abs(share - keep) <= 3 * (keep * rate / n) ** 0.5, share
    assert torch.all(y[kept] == 1 / keep)


def test_dropout_gradient_reaches_the_kept_values_only():
    model = _rnn(LSTM, 0.5).train()
    set_dropout_generator(model, torch.Generator().manual_seed(13))
    x = torch.ones(4, 3, 10, requires_grad=True)
    y = model._dropout(x)
    y.sum().backward()
    torch.testing.assert_close(x.grad, (y != 0).float() * 2.0, rtol=0, atol=0)


# -- One train step against JAX -----------------------------------------------------------

def _waves(seed, B=2, seconds=0.25):
    rng = np.random.default_rng(seed)
    sources = (0.3 * rng.standard_normal((B, len(SOURCES), 2, int(seconds * SR)))).astype(
        np.float32)
    return sources.sum(axis=1, keepdims=True), sources


def _criteria(kind):
    if kind == "umx":
        return (SpectralTargetAdapter(MSELoss(dim=(-2, -1)), N_FFT, HOP),
                JSpectralTargetAdapter(JMSELoss(dim=(-2, -1)), N_FFT, HOP))
    return (SpectralTargetAdapter(MultiDomainLoss(N_FFT, HOP, window=build_window(N_FFT)),
                                  N_FFT, HOP, complex_target=True),
            JSpectralTargetAdapter(JMultiDomainLoss(N_FFT, HOP, window=jax_build_window(N_FFT)),
                                   N_FFT, HOP, complex_target=True))


def _model_pair(kind, seed, dropout=0.0):
    base, jbase, to_port = BASES[kind]
    config = dict(CFG, dropout=dropout)
    jmodel = jwrappers.SpectrogramMaskingWrapper(base=jbase(**config), n_fft=N_FFT,
                                                 hop_length=HOP)
    # Shapes from a trace of JAX's init (no compile); every leaf drawn from the seed.
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(seed),
                            jnp.zeros((1, 1, 2, 400), jnp.float32))
    rng = np.random.default_rng(seed)
    variables = _scramble(jax.tree_util.tree_map(
        lambda leaf: (rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[0])).astype(
            np.float32), dict(shapes)), rng)
    port = SpectrogramMaskingWrapper(base(**config), N_FFT, HOP)
    port.base.load_state_dict(to_port({k: v["base"] for k, v in variables.items()}, config))
    return jmodel, variables, port, to_port


def _assert_state_matches(port, variables, to_port, rtol):
    """The port's state after one step against JAX's, at `rtol` x max|ref| a tensor.

    `bias_in` is the exception: a per-bin shift of the input is a per-feature constant
    after the block's Linear, which train-mode BatchNorm subtracts again, so its gradient
    is 0 but for rounding (below 1e-7 in both; every other gradient agrees within 1e-5
    relative), and Adam's first step, lr * g / (|g| + 1e-8), turns that rounding into
    steps of any sign up to lr. There the port's gradient must be rounding and its step
    at most lr, as JAX's is.
    """
    ref = to_port({k: v["base"] for k, v in variables.items()}, CFG)
    got = port.base.state_dict()
    grads = dict(port.base.named_parameters())
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 1, k
        elif k.endswith("bias_in"):
            assert float(grads[k].grad.abs().max()) < 1e-7, k
            assert float((got[k] - v).abs().max()) <= 2e-3 * (1 + 1e-6), k
        else:
            _close(got[k].numpy(), v.numpy(), rtol)


@pytest.mark.parametrize("kind", ["umx", "xumx"])
def test_adam_step_matches_jax(monkeypatch, kind):
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", "0")
    jmodel, variables, port, to_port = _model_pair(kind, seed=20)
    mixture, sources = _waves(21)
    criterion, jcriterion = _criteria(kind)
    jstep = jax_make_train_step(jmodel, jcriterion, jax_make_optimizer("adam", 1e-3),
                                train_kwargs={"train": True}, donate=False)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    jopt = jax_make_optimizer("adam", 1e-3).init(jvars["params"])
    new_vars, _, jloss = jstep(jvars, jopt, jnp.asarray(mixture), jnp.asarray(sources))
    new_vars = jax.tree_util.tree_map(np.asarray, dict(new_vars))

    step = make_train_step(port, criterion, make_optimizer("adam", 1e-3,
                                                           params=port.parameters()))
    loss = float(step(torch.from_numpy(mixture), torch.from_numpy(sources)))
    _close(loss, float(jloss), 1e-4)
    _assert_state_matches(port, new_vars, to_port, 1e-4)
    # The step moved every trained tensor and the running statistics.
    before = to_port({k: v["base"] for k, v in variables.items()}, CFG)
    after = port.base.state_dict()
    moved = [k for k in before if not k.endswith(("bias_hh_l0", "bias_hh_l1", "bias_hh_l0_reverse",
                                                   "bias_hh_l1_reverse", "num_batches_tracked"))
             and torch.equal(before[k], after[k])]
    assert not moved, moved


def test_bf16_step_writes_the_running_statistics_back():
    # UMX on magnitudes (B, 1, C, F, S): the running statistics the bf16 forward updates
    # on its cast copies must land in the f32 buffers, as JAX writes new_aux back.
    model = ParallelOpenUnmix(**dict(CFG, num_layers=1), generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, MSELoss(dim=(-2, -1)),
                           make_optimizer("adam", 1e-3, params=model.parameters()),
                           compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(22)
    mixture = np.abs(rng.standard_normal((2, 1, 2, CFG["n_bins"], 9))).astype(np.float32)
    sources = np.abs(rng.standard_normal((2, 4, 2, CFG["n_bins"], 9))).astype(np.float32)
    loss = step(torch.from_numpy(mixture), torch.from_numpy(sources))
    assert torch.isfinite(loss)
    for source in SOURCES:
        norm = model.backbone[source].block.norm1d
        assert norm.running_mean.dtype == torch.float32
        assert float(norm.running_mean.abs().max()) > 0  # moved off its zeros
        assert not torch.equal(norm.running_var, torch.ones_like(norm.running_var))
        assert int(norm.num_batches_tracked) == 1


# -- Augmentation and the train datasets --------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_musdb_quality_corpus(str(tmp_path_factory.mktemp("musdb_train")), n_train=3,
                                      n_valid=1, n_test=1, track_sec=1.0, sample_rate=SR)


@pytest.mark.parametrize("name,kwargs", [
    ("random_flip", {}), ("random_flip", {"flip_rate": 0.9, "axis": 1}),
    ("random_gain", {}), ("random_scaling", {"min": 0.5, "max": 2.0}),
    ("random_sign", {"rate": 0.3})])
def test_augmentations_are_byte_for_byte_jax_s(name, kwargs):
    ours, theirs = aug.choose_augmentation(name, **kwargs), jaug.choose_augmentation(name, **kwargs)
    assert type(ours).__name__ == type(theirs).__name__
    x = np.random.default_rng(30).standard_normal((2, 50)).astype(np.float32)
    for seed in range(8):
        np.testing.assert_array_equal(ours(x, np.random.default_rng(seed)),
                                      theirs(x, np.random.default_rng(seed)))
    with pytest.raises(NotImplementedError):
        aug.choose_augmentation("random_crop")


def test_sequential_augmentation_is_byte_for_byte_jax_s():
    ours = aug.SequentialAugmentation(aug.RandomFlip(0.5, axis=0), aug.RandomGain(0.25, 1.25))
    ours.append(aug.RandomSign())
    theirs = jaug.SequentialAugmentation(jaug.RandomFlip(0.5, axis=0), jaug.RandomGain(0.25, 1.25))
    theirs.append(jaug.RandomSign())
    x = np.random.default_rng(31).standard_normal((2, 64)).astype(np.float32)
    for seed in range(6):
        a, b = ours(x, np.random.default_rng(seed)), theirs(x, np.random.default_rng(seed))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(aug.apply_random_flip(x, np.random.default_rng(0), 1.0, 1),
                                  x[:, ::-1])


@pytest.mark.parametrize("cache", [False, True])
@pytest.mark.parametrize("overlap", [None, 100])
def test_wave_train_dataset_is_byte_for_byte_jax_s(corpus, cache, overlap):
    ds, jds = (m.WaveTrainDataset(corpus, duration=0.25, sample_rate=SR, overlap=overlap,
                                  cache_in_memory=cache) for m in (musdb, jmusdb))
    assert ds.names == jds.names and ds.index == jds.index and len(ds) == len(jds) > 0
    for i in range(len(ds)):
        for a, b in zip(ds[i], jds[i]):
            assert a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("cache", [False, True])
@pytest.mark.parametrize("augmented", [True, False])
def test_augmentation_dataset_is_byte_for_byte_jax_s(corpus, cache, augmented):
    kwargs = dict(duration=0.4, sample_rate=SR, seed=5, cache_in_memory=cache)
    ds = musdb.AugmentationWaveTrainDataset(
        corpus, augmentation=aug.SequentialAugmentation(aug.RandomFlip(), aug.RandomGain())
        if augmented else None, **kwargs)
    jds = jmusdb.AugmentationWaveTrainDataset(
        corpus, augmentation=jaug.SequentialAugmentation(jaug.RandomFlip(), jaug.RandomGain())
        if augmented else None, **kwargs)
    assert len(ds) == len(jds) == int(3 * 1.0 / 0.4)
    for i in (0, 1, 2, 7, 1000):  # an item is a function of (seed, index) alone
        (mix, srcs), (jmix, jsrcs) = ds[i], jds[i]
        assert mix.shape == (1, 2, int(0.4 * SR)) and srcs.shape == (4, 2, int(0.4 * SR))
        assert mix.tobytes() == jmix.tobytes() and srcs.tobytes() == jsrcs.tobytes()
    assert musdb.AugmentationWaveTrainDataset(corpus, samples_per_epoch=9, **kwargs).__len__() == 9


# -- The CLI and the checkpoint round trip ------------------------------------------------

def _cli_args(corpus, tmp_path, model, *extra):
    return ["--musdb18_root", corpus, "--sample_rate", str(SR), "--duration", "0.25",
            "--valid_duration", "0.25", "--samples_per_epoch", "4", "--model", model,
            "--n_fft", str(N_FFT), "--hop_length", str(HOP), "--hidden_channels", "16",
            "--num_layers", "2", "--max_bin", "20", "--batch_size", "2", "--epochs", "1",
            "--exp_dir", str(tmp_path / f"exp_{model}"), "--device", "cpu", *extra]


@pytest.mark.parametrize("model", ["umx", "xumx"])
def test_cli_trains_one_epoch_and_writes_last_ckpt(corpus, tmp_path, model, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)  # PyTorch's default
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    trainer = cli.main(_cli_args(corpus, tmp_path, model))
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    last = tmp_path / f"exp_{model}" / "model" / "last.ckpt"
    assert os.path.exists(last)
    assert np.isfinite(trainer.train_loss[0]) and np.isfinite(trainer.valid_loss[0])
    blob = read_checkpoint(str(last))
    assert blob["model_class"] == "SpectrogramMaskingWrapper"
    assert blob["base"]["config"]["dropout"] == 0.4
    # Dropout 0.4 ran from the seeded generator on the device.
    assert trainer.model.base.backbone["bass"].rnn.generator is not None


@pytest.mark.parametrize("model,flags,slice_", [("umx", ("--n_devices", "2"), "slice H")])
def test_cli_refuses_what_is_not_ported(corpus, tmp_path, model, flags, slice_):
    with pytest.raises(NotImplementedError, match=slice_):
        cli.main(_cli_args(corpus, tmp_path, model, *flags))


def test_cli_refuses_a_missing_card(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(_cli_args(corpus, tmp_path, "umx")[:-2])


def _jax_variables_of(kind, state_dict):
    """A port wrapper's state dict -> the JAX wrapper's variables, through the JAX
    package's own converters of the reference layout."""
    base = {k[len("base."):]: v for k, v in state_dict.items() if k.startswith("base.")}
    if kind == "xumx":
        variables = convert_xumx(base, CFG)
    else:
        variables = {"params": {}, "batch_stats": {}}
        for source in SOURCES:
            prefix = f"backbone.{source}."
            one = convert_open_unmix({k[len(prefix):]: v for k, v in base.items()
                                      if k.startswith(prefix)}, CFG)
            for collection in variables:
                variables[collection][f"backbone_{source}"] = one[collection]
    return {collection: {"base": tree} for collection, tree in variables.items()}


@pytest.mark.parametrize("kind", ["umx", "xumx"])
def test_checkpoint_after_a_step_opens_in_jax(monkeypatch, corpus, tmp_path, kind):
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", "0")
    trainer = cli.main(_cli_args(corpus, tmp_path, kind, "--samples_per_epoch", "2"))
    blob = read_checkpoint(str(tmp_path / f"exp_{kind}" / "model" / "last.ckpt"))
    variables = _jax_variables_of(kind, blob["state_dict"])
    stats = variables["batch_stats"]["base"]
    first = stats["block_bass"] if kind == "xumx" else stats["backbone_bass"]["block"]
    assert float(np.abs(first["norm"]["mean"]).max()) > 0  # the trained running statistics
    jbase = BASES[kind][1](**dict(CFG, dropout=0.4))
    jmodel = jwrappers.SpectrogramMaskingWrapper(base=jbase, n_fft=N_FFT, hop_length=HOP)
    mixture, _ = _waves(23, B=1)
    model = trainer.model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(mixture)).numpy()
    _close(got, jmodel.apply(variables, jnp.asarray(mixture)), 1e-4)


def test_bf16_step_leaves_the_buffers_it_did_not_write_in_f32():
    # A buffer the forward only reads (here a gain 1.1, which bf16 rounds to 1.1015625)
    # stays as it was: the write-back takes what the forward updated in place, no more.
    class Gained(torch.nn.Module):
        def __init__(self, base):
            super().__init__()
            self.base = base
            self.register_buffer("gain", torch.tensor(1.1))

        def forward(self, x):
            return self.base(x * self.gain)

    model = Gained(ParallelOpenUnmix(**dict(CFG, num_layers=1),
                                     generator=torch.Generator().manual_seed(0)))
    state = {name: buf.clone() for name, buf in model.named_buffers()}
    step = make_train_step(model, MSELoss(dim=(-2, -1)),
                           make_optimizer("sgd", 0.0, params=model.parameters()),
                           compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(23)
    mixture = np.abs(rng.standard_normal((2, 1, 2, CFG["n_bins"], 9))).astype(np.float32)
    sources = np.abs(rng.standard_normal((2, 4, 2, CFG["n_bins"], 9))).astype(np.float32)
    step(torch.from_numpy(mixture), torch.from_numpy(sources))
    assert model.gain.dtype == torch.float32 and float(model.gain) == float(torch.tensor(1.1))
    moved = {name for name, buf in model.named_buffers() if not torch.equal(buf, state[name])}
    assert moved == {f"base.backbone.{s}.{block}.norm1d.{stat}" for s in SOURCES
                     for block in ("block", "net.0", "net.1")
                     for stat in ("running_mean", "running_var", "num_batches_tracked")}


@pytest.mark.parametrize("model", ["umx", "x-umx"])
def test_train_recipe_shells_parse_with_the_ports_parser(model):
    # The shell's arguments, its variables given their names as values, through the
    # port's train parser: the JAX recipe's widths (egs/musdb18/<model>/train.sh).
    text = (pathlib.Path(cli.__file__).resolve().parent.parent / "egs" / "musdb18" / model
            / "train.sh").read_text()
    command = re.search(r"python -m (\S+) \\\n(.*?)\| tee", text, re.S)
    body = re.sub(r'"\$\{?(\w+)\}?([^"]*)"', lambda m: f"{m.group(1)}{m.group(2)}",
                  command.group(2).replace("\\\n", " "))
    assert command.group(1) == "dnn_based_source_separation_torch.cli.train_musdb18"
    args = cli.build_parser().parse_args([a for a in shlex.split(body) if a != "$@"])
    assert args.model == model.replace("-", "") and args.device == "device"
    assert (args.n_fft, args.hop_length, args.max_bin, args.hidden_channels,
            args.num_layers, args.dropout, args.batch_size, args.duration) == (
        4096, 1024, 1487, 512, 3, 0.4, 16, 6.0)
    assert args.musdb18_root == "musdb18_root" and args.exp_dir == "exp_dir"
