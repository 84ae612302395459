"""musdb18's waveform models in the port against the JAX package, and their CLI (CPU).

- stereo Conv-TasNet (`in_channels=2`, trainable filterbanks) under `WaveChannelAdapter`,
  weights from `hub/from_jax.py:conv_tasnet_state_dict_from_jax` (its C > 1 filterbank);
- MRX (`MultiResolutionCrossNet`) in eval mode (scrambled running statistics) and in
  train mode (the batch's statistics and their update), including hop == n_fft (the
  rectangular window), weights from `mrx_state_dict_from_jax`, and a port state dict
  read back by JAX's `convert_mrx` bit for bit;
- Meta-TasNet under `MonoWaveAdapter` (the generated per-source convs as one grouped
  conv1d), weights from `meta_tasnet_state_dict_from_jax`;
- WaveNet, causal or not, unconditioned, globally and locally conditioned;
- each forward and every parameter's gradient at TOL x max|ref| in f32;
- `cli/train_musdb18.py --model conv-tasnet|mrx|meta-tasnet --device cpu` at tiny widths
  on a synthetic corpus: the loss of each domain, the criterion override, the checkpoint
  reopened by `load_model`; the port's recipe shells parsed to the JAX recipes' arguments.
"""
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.cli import test_musdb18 as test_cli
from dnn_based_source_separation_torch.cli import train_musdb18 as cli
from dnn_based_source_separation_torch.criterion import MonoTargetAdapter, MSELoss, NegSISDR
from dnn_based_source_separation_torch.data.synthetic import write_musdb_quality_corpus
from dnn_based_source_separation_torch.hub import (
    conv_tasnet_state_dict_from_jax, meta_tasnet_state_dict_from_jax, mrx_state_dict_from_jax,
    wavenet_state_dict_from_jax,
)
from dnn_based_source_separation_torch.models import (
    ConvTasNet, MetaTasNet, MonoWaveAdapter, MultiResolutionCrossNet, WaveChannelAdapter,
    WaveNet,
)
from dnn_based_source_separation_torch.models.base import load_model, read_checkpoint, save_model
from dnn_based_source_separation_tpu.hub.torch_convert import convert_mrx
from dnn_based_source_separation_tpu.models import conv_tasnet as jconv
from dnn_based_source_separation_tpu.models import meta_tasnet as jmeta
from dnn_based_source_separation_tpu.models import mrx as jmrx
from dnn_based_source_separation_tpu.models import wavenet as jwavenet
from dnn_based_source_separation_tpu.cli import train_musdb18 as jcli
from dnn_based_source_separation_tpu.models import wrappers as jwrappers
from test_torch_bench import _recipe_argv

TOL = 1e-4
SR = 8000
SOURCES = ("bass", "drums", "other", "vocals")
CONV = dict(n_basis=16, kernel_size=8, enc_basis="trainable", dec_basis="trainable",
            sep_hidden_channels=12, sep_bottleneck_channels=8, sep_skip_channels=6,
            sep_num_blocks=2, sep_num_layers=2, causal=False, n_sources=4, in_channels=2)
MRX = dict(in_channels=2, hidden_channels=16, num_layers=2, sources=("a", "b", "c"))
META = dict(n_basis=16, kernel_size=8, embed_dim=6, bottleneck_channels=5,
            sep_hidden_channels=12, sep_bottleneck_channels=10, sep_skip_channels=7,
            sep_num_blocks=1, sep_num_layers=3, n_sources=4)
WAVENET = dict(in_channels=2, out_channels=3, hidden_channels=8, skip_channels=6,
               num_blocks=2, num_layers=3)


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    torch.set_num_threads(1)
    # JAX's LSTM on its plain `lax.scan` path, not the Pallas kernel in interpret mode.
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", "0")


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), np.abs(got - ref).max()


def _scramble(tree, rng):
    """Non-zero biases, non-identity affines and, for batch_stats, running statistics
    away from (0, 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _scramble(v, rng)
            continue
        v = np.asarray(v)
        if k in ("gamma", "scale", "var") or k.startswith("scale_out"):
            v = 0.5 + rng.random(v.shape)
        elif k in ("beta", "bias", "mean") or k.startswith(("b", "bias_out")):
            v = 0.3 * rng.standard_normal(v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


def _init(jmodel, x, seed, *extra):
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.asarray(x), *extra)
    return {k: _scramble(jax.tree_util.tree_map(np.asarray, v), np.random.default_rng(seed))
            for k, v in variables.items()}


def _check(port, jmodel, variables, convert, x, *extra, train=False, grads=True):
    """Forward and (with `grads`) every trainable parameter's gradient of sum(y * g) against
    JAX -> in train mode JAX's updated BatchNorm statistics."""
    kwargs = dict(train=True, mutable=["batch_stats"]) if train else {}
    xin = (jnp.asarray(x), *(jnp.asarray(e) for e in extra))
    out = jax.jit(lambda v, *a: jmodel.apply(v, *a, **kwargs))(variables, *xin)
    y, updated = (out if train else (out, None))
    port.train(train)
    got = port(torch.from_numpy(x), *(torch.from_numpy(e) for e in extra))
    _close(got, y)
    if not grads:
        return updated
    g = np.random.default_rng(17).standard_normal(np.shape(y)).astype(np.float32)

    def loss(p):
        out = jmodel.apply({**variables, "params": p}, *xin, **kwargs)
        return jnp.sum((out[0] if train else out) * g)

    grads = jax.jit(jax.grad(loss))(variables["params"])
    ref = convert({**variables, "params": grads})
    port.zero_grad()
    port.train(train)
    (port(torch.from_numpy(x), *(torch.from_numpy(e) for e in extra))
     * torch.from_numpy(g)).sum().backward()
    for name, p in port.named_parameters():
        if p.requires_grad:
            if p.grad is None:  # no path to the output (the last block's residual head)
                assert not np.any(np.asarray(ref[name])), name
            else:
                _close(p.grad, ref[name])
    return updated


def test_stereo_conv_tasnet_under_the_channel_adapter_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 1, 2, 203)).astype(np.float32)
    jmodel = jwrappers.WaveChannelAdapter(jconv.ConvTasNet(**CONV))
    variables = _init(jmodel, x, 1)
    port = WaveChannelAdapter(ConvTasNet(**CONV))
    convert = lambda v: {f"base.{k}": t for k, t in  # noqa: E731
                         conv_tasnet_state_dict_from_jax(v["params"]["base"], CONV).items()}
    port.load_state_dict(convert(variables))
    # The C = 2 filterbanks: (N, C, L), channel-major over the JAX kernel's C*L rows.
    assert port.base.encoder.conv1d.weight.shape == (16, 2, 8)
    assert port.base.decoder.conv_transpose1d.weight.shape == (16, 2, 8)
    with torch.no_grad():
        assert port.eval()(torch.from_numpy(x)).shape == (2, 4, 2, 203)
    _check(port, jmodel, variables, convert, x)


def test_mrx_matches_jax_in_eval_and_train_mode():
    # Three resolutions at one hop: n_fft 16 == hop takes the rectangular window, 32 and 64
    # the Hann window.
    n_fft, hop = (16, 32, 64), 16
    config = dict(MRX, n_fft=n_fft, hop_length=hop)
    x = np.random.default_rng(len(n_fft) + hop).standard_normal((2, 2, 301)).astype(np.float32)
    jmodel = jmrx.MultiResolutionCrossNet(**config)
    variables = _init(jmodel, x, 2)
    port = MultiResolutionCrossNet(**config)
    convert = lambda v: mrx_state_dict_from_jax(v, config)  # noqa: E731
    port.load_state_dict(convert(variables))
    for i, nf in enumerate(n_fft):  # hop == n_fft: a rectangular window
        assert bool(getattr(port, f"window{i}").eq(1).all()) == (hop == nf)
    _check(port, jmodel, variables, convert, x, grads=False)  # running statistics
    updated = _check(port, jmodel, variables, convert, x, train=True)  # the batch's
    # The train-mode forwards updated the running statistics once each, as flax does once.
    port.load_state_dict(convert(variables))
    port.train()(torch.from_numpy(x))
    ref = convert({**variables, "batch_stats": updated["batch_stats"]})
    for name, buf in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            _close(buf, ref[name], 1e-5)


def test_port_mrx_state_dict_reads_back_through_jax_convert_mrx():
    config = dict(MRX, n_fft=(32, 64), hop_length=16)
    port = MultiResolutionCrossNet(**config, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():  # running statistics away from their start
        for name, buf in port.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    variables = convert_mrx(state, port.get_config())
    back = mrx_state_dict_from_jax(variables, port.get_config())
    state = port.state_dict()
    for name, value in state.items():
        if name.endswith("num_batches_tracked"):
            continue
        if ".bias_ih_" in name:  # JAX keeps b = b_ih + b_hh; it comes back as (b, 0)
            value = value + state[name.replace(".bias_ih_", ".bias_hh_")]
        elif ".bias_hh_" in name:
            value = torch.zeros_like(value)
        assert torch.equal(back[name], value), name
    x = np.random.default_rng(5).standard_normal((1, 2, 200)).astype(np.float32)
    y = jax.jit(jmrx.MultiResolutionCrossNet(**config).apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        _close(port.eval()(torch.from_numpy(x)), y)


def test_meta_tasnet_under_the_mono_adapter_matches_jax():
    x = np.random.default_rng(6).standard_normal((2, 1, 2, 203)).astype(np.float32)
    jmodel = jwrappers.MonoWaveAdapter(jmeta.MetaTasNet(**META))
    variables = _init(jmodel, x, 3)
    port = MonoWaveAdapter(MetaTasNet(**META))
    convert = lambda v: {f"base.{k}": t for k, t in  # noqa: E731
                         meta_tasnet_state_dict_from_jax(v["params"]["base"], META).items()}
    port.load_state_dict(convert(variables))
    with torch.no_grad():
        assert port.eval()(torch.from_numpy(x)).shape == (2, 4, 203)
    _check(port, jmodel, variables, convert, x)


@pytest.mark.parametrize("extra", [
    {"causal": False, "output_nonlinear": "softmax"},
    {"conditioning": "global", "enc_dim": 5, "output_nonlinear": "sigmoid"},
    # flax's SAME transposed-conv padding on both of its branches: s > k - 1 and s <= k - 1.
    {"conditioning": "local", "enc_dim": 5, "enc_kernel_size": 4, "enc_stride": 3},
    {"conditioning": "local", "enc_dim": 5, "enc_kernel_size": 2, "enc_stride": 4}])
def test_wavenet_matches_jax(extra):
    config = dict(WAVENET, **extra)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 2, 61)).astype(np.float32)
    enc = {"global": (2, 5), "local": (2, 21, 5)}.get(extra.get("conditioning"))
    cond = () if enc is None else (rng.standard_normal(enc).astype(np.float32),)
    jmodel = jwavenet.WaveNet(**config)
    variables = _init(jmodel, x, 4, *(jnp.asarray(c) for c in cond))
    port = WaveNet(**config)
    convert = lambda v: wavenet_state_dict_from_jax(v, config)  # noqa: E731
    port.load_state_dict(convert(variables))
    _check(port, jmodel, variables, convert, x, *cond)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_musdb_quality_corpus(str(tmp_path_factory.mktemp("musdb_wave")), n_train=3,
                                      n_valid=1, n_test=1, track_sec=1.0, sample_rate=SR)


CLI_FLAGS = {
    "conv-tasnet": ["-N", "16", "-L", "8", "-HH", "12", "-B", "8", "-Sc", "6", "-X", "2",
                    "-R", "1", "--criterion", "mse"],
    "mrx": ["--mrx_n_fft", "32,64", "--hop_length", "16", "--hidden_channels", "16",
            "--num_layers", "1"],
    "meta-tasnet": ["-N", "16", "-L", "8", "-HH", "12", "-B", "10", "-Sc", "7", "-X", "2",
                    "-R", "1"],
}
CLASSES = {"conv-tasnet": (WaveChannelAdapter, ConvTasNet, MSELoss),
           "mrx": (WaveChannelAdapter, MultiResolutionCrossNet, NegSISDR),
           "meta-tasnet": (MonoWaveAdapter, MetaTasNet, MonoTargetAdapter)}


@pytest.mark.parametrize("model", list(CLI_FLAGS))
def test_cli_trains_the_waveform_models(corpus, tmp_path, model):
    exp = tmp_path / f"exp_{model}"
    argv = ["--musdb18_root", corpus, "--sample_rate", str(SR), "--duration", "0.25",
            "--valid_duration", "0.25", "--samples_per_epoch", "4", "--model", model,
            "--batch_size", "2", "--epochs", "1", "--exp_dir", str(exp), "--device", "cpu",
            *CLI_FLAGS[model]]
    trainer = cli.main(argv)
    adapter, base, criterion = CLASSES[model]
    assert isinstance(trainer.model, adapter) and isinstance(trainer.model.base, base)
    args = cli.build_parser().parse_args(argv)
    assert isinstance(cli.build_model_and_criterion(args, list(SOURCES), "cpu")[1], criterion)
    assert np.isfinite(trainer.train_loss[0]) and np.isfinite(trainer.valid_loss[0])
    last = str(exp / "model" / "last.ckpt")
    assert read_checkpoint(last)["model_class"] == adapter.__name__
    reopened = load_model(last)
    x = torch.randn(1, 1, 2, 400, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(reopened(x), trainer.model.eval()(x), rtol=0, atol=0)
    assert os.path.exists(exp / "model" / "best.ckpt")
    # The override table is the output domain's: meta-tasnet's targets are downmixed.
    args = cli.build_parser().parse_args(argv + ["--criterion", "mae"])
    _, override = cli.build_model_and_criterion(args, list(SOURCES), "cpu")
    assert isinstance(override, MonoTargetAdapter) == (model == "meta-tasnet")


@pytest.mark.parametrize("model", list(CLI_FLAGS))
def test_the_musdb18_test_cli_refuses_waveform_checkpoints(corpus, tmp_path, model):
    # cli/test_musdb18.py evaluates spectrogram models only, as JAX's (which fails on these
    # at `model.n_fft` or `model.base.sources`): it refuses each, saying so.
    args = cli.build_parser().parse_args(["--musdb18_root", corpus, "--model", model,
                                          *CLI_FLAGS[model]])
    path = str(tmp_path / f"{model}.ckpt")
    save_model(path, cli.build_model_and_criterion(args, list(SOURCES), "cpu")[0])
    with pytest.raises(ValueError, match="evaluates spectrogram models only"):
        test_cli.run(["--musdb18_root", corpus, "--model_path", path, "--device", "cpu",
                      "--sample_rate", str(SR)])


ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("model", list(CLI_FLAGS))
def test_recipe_shells_parse_to_the_jax_recipes_arguments(model):
    recipe = f"egs/musdb18/{model}/train.sh"
    module, argv = _recipe_argv(ROOT / "dnn_based_source_separation_torch" / recipe)
    jmodule, jargv = _recipe_argv(ROOT / recipe)
    assert (module, jmodule) == ("dnn_based_source_separation_torch.cli.train_musdb18",
                                 "dnn_based_source_separation_tpu.cli.train_musdb18")
    args, jargs = cli.build_parser().parse_args(argv), jcli.build_parser().parse_args(jargv)
    assert args.model == model and args.device == "device" and "--device" not in jargv
    for name, value in vars(jargs).items():
        assert getattr(args, name) == value, name
