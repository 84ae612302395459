"""Port's Open-Unmix family against the JAX package: forward, weights, checkpoints (CPU).

Tiny widths (n_fft 64 -> 33 bins, max_bin 20, hidden 16, 2 layers, stereo, 4
sources); weights from the JAX init, scrambled (BatchNorm statistics
included) and carried over by `hub/from_jax.py`. The JAX side runs both
recurrence paths where they differ: `DNNTPU_PALLAS_LSTM=0` (`lax.scan`) and
`=1` (the Pallas kernels in interpret mode). f32 parity: 1e-4 x max|ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.hub import (
    open_unmix_state_dict_from_jax, parallel_open_unmix_state_dict_from_jax,
    xumx_state_dict_from_jax,
)
from dnn_based_source_separation_torch.models import (
    CrossNetOpenUnmix, OpenUnmix, ParallelOpenUnmix, SpectrogramMaskingWrapper,
)
from dnn_based_source_separation_torch.models.base import load_model, read_checkpoint, save_model
from dnn_based_source_separation_torch.ops.rnn import set_dropout_generator
from dnn_based_source_separation_tpu.hub.torch_convert import convert_open_unmix, convert_xumx
from dnn_based_source_separation_tpu.models import umx as jumx
from dnn_based_source_separation_tpu.models import wrappers as jwrappers
from dnn_based_source_separation_tpu.models import xumx as jxumx

RTOL = 1e-4  # of max|ref|
N_FFT, HOP = 64, 16
CFG = dict(in_channels=2, hidden_channels=16, num_layers=2, n_bins=N_FFT // 2 + 1, max_bin=20)
SOURCES = ("bass", "drums", "other", "vocals")
FRAMES = 19


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max(), np.abs(got - ref).max()


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


def _jax_variables(jmodel, x, seed):
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    return _scramble(variables, np.random.default_rng(seed))


def _amplitude(lead, seed):
    shape = (*lead, CFG["in_channels"], CFG["n_bins"], FRAMES)
    return np.abs(np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _forward(model, x):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy()


def _apply(jmodel, variables, x):
    return np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))


# The Pallas flag only changes JAX's bidirectional recurrences: causal cases run once.
@pytest.mark.parametrize("causal,pallas", [(False, "0"), (False, "1"), (True, "0")])
@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_open_unmix_matches_jax(monkeypatch, causal, rnn_type, pallas):
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", pallas)
    config = dict(CFG, causal=causal, rnn_type=rnn_type)
    x = _amplitude((2,), seed=1)
    jmodel = jumx.OpenUnmix(**config)
    variables = _jax_variables(jmodel, x, seed=2)
    port = OpenUnmix(**config)
    port.load_state_dict(open_unmix_state_dict_from_jax(variables, config))
    _close(_forward(port, x), _apply(jmodel, variables, x))


@pytest.mark.parametrize("pallas", ["0", "1"])
def test_parallel_open_unmix_matches_jax(monkeypatch, pallas):
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", pallas)
    config = dict(CFG, sources=SOURCES)
    x = _amplitude((2, 1), seed=3)
    jmodel = jumx.ParallelOpenUnmix(**config)
    variables = _jax_variables(jmodel, x, seed=4)
    port = ParallelOpenUnmix(**config)
    port.load_state_dict(parallel_open_unmix_state_dict_from_jax(variables, config))
    got = _forward(port, x)
    assert got.shape == (2, 4, 2, CFG["n_bins"], FRAMES)
    _close(got, _apply(jmodel, variables, x))


@pytest.mark.parametrize("bridge,causal,pallas", [(True, False, "0"), (True, False, "1"),
                                                  (False, False, "0"), (False, False, "1"),
                                                  (True, True, "0")])
def test_xumx_matches_jax(monkeypatch, bridge, causal, pallas):
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", pallas)
    config = dict(CFG, bridge=bridge, causal=causal, sources=SOURCES)
    x = _amplitude((2, 1), seed=5)
    jmodel = jxumx.CrossNetOpenUnmix(**config)
    variables = _jax_variables(jmodel, x, seed=6)
    port = CrossNetOpenUnmix(**config)
    port.load_state_dict(xumx_state_dict_from_jax(variables, config))
    _close(_forward(port, x), _apply(jmodel, variables, x))


def test_bridge_mixes_sources():
    # With the bridge, each stem's output depends on the other stems' weights.
    config = dict(CFG, sources=SOURCES)
    x = torch.from_numpy(_amplitude((1, 1), seed=7))
    for bridge in (True, False):
        model = CrossNetOpenUnmix(**config, bridge=bridge,
                                  generator=torch.Generator().manual_seed(0)).eval()
        with torch.no_grad():
            before = model(x)
            model.backbone["drums"].block.fc.weight.mul_(2.0)
            after = model(x)
        changed = not torch.equal(before[:, 0], after[:, 0])  # bass
        assert changed == bridge


def _wrapper_pair(base_cls, jbase_cls, to_port, seed, **extra):
    config = dict(CFG, sources=SOURCES, **extra)
    wave = 0.3 * np.random.default_rng(seed).standard_normal((2, 1, 2, 300)).astype(np.float32)
    jmodel = jwrappers.SpectrogramMaskingWrapper(base=jbase_cls(**config), n_fft=N_FFT,
                                                 hop_length=HOP)
    variables = _jax_variables(jmodel, wave, seed)
    port = SpectrogramMaskingWrapper(base_cls(**config), n_fft=N_FFT, hop_length=HOP)
    sub = {k: v["base"] for k, v in variables.items()}
    port.base.load_state_dict(to_port(sub, config))
    return jmodel, variables, port, wave


@pytest.mark.parametrize("model", ["umx", "xumx"])
def test_spectrogram_wrapper_matches_jax(monkeypatch, model):
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", "1")
    classes = {"umx": (ParallelOpenUnmix, jumx.ParallelOpenUnmix,
                       parallel_open_unmix_state_dict_from_jax),
               "xumx": (CrossNetOpenUnmix, jxumx.CrossNetOpenUnmix, xumx_state_dict_from_jax)}
    jmodel, variables, port, wave = _wrapper_pair(*classes[model], seed=8)
    got = _forward(port, wave)
    assert got.shape == (2, 4, 2, CFG["n_bins"], 300 // HOP + 1)
    _close(got, _apply(jmodel, variables, wave))
    assert "window" not in port.state_dict()


def test_state_dict_round_trips_through_jax_converters():
    # The port's state dict opened by JAX's converters gives JAX's tree bit for bit
    # (the LSTM's one bias as bias_ih + a zero bias_hh), so the same forward.
    x = _amplitude((2,), seed=9)
    jmodel = jumx.OpenUnmix(**CFG)
    variables = _jax_variables(jmodel, x, seed=10)
    port = OpenUnmix(**CFG)
    port.load_state_dict(open_unmix_state_dict_from_jax(variables, CFG))
    back = convert_open_unmix(port.state_dict(), CFG)
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf, err_msg=str(path))
    _close(_apply(jmodel, back, x), _forward(port, x))


@pytest.mark.parametrize("bridge", [True, False])
def test_port_weights_open_in_jax_convert_xumx(bridge):
    # Weights made by the port (seeded torch init, scrambled norms) read by
    # convert_xumx give JAX the port's forward.
    config = dict(CFG, bridge=bridge, sources=SOURCES)
    port = CrossNetOpenUnmix(**config, generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(11)
    with torch.no_grad():
        for name, t in port.state_dict().items():
            if name.endswith(("running_var", "norm1d.weight", "scale_in", "scale_out")):
                t.copy_(torch.from_numpy(0.5 + rng.random(t.shape).astype(np.float32)))
            elif name.endswith(("running_mean", "norm1d.bias", "bias_in", "bias_out",
                                "bias_hh_l0", "bias_hh_l1")):
                t.copy_(torch.from_numpy(0.2 * rng.standard_normal(t.shape).astype(np.float32)))
    x = _amplitude((2, 1), seed=12)
    jvars = convert_xumx(port.state_dict(), config)
    _close(_apply(jxumx.CrossNetOpenUnmix(**config), jvars, x), _forward(port, x))


def test_saved_wrapper_reloads_through_load_model(tmp_path):
    config = dict(CFG, sources=SOURCES, dropout=0.4, rnn_type="gru")
    model = SpectrogramMaskingWrapper(
        CrossNetOpenUnmix(**config, generator=torch.Generator().manual_seed(3)), N_FFT, HOP)
    path = str(tmp_path / "xumx.pth")
    save_model(path, model)
    blob = read_checkpoint(path)
    assert blob["model_class"] == "SpectrogramMaskingWrapper"
    assert blob["base"]["__model__"] == "CrossNetOpenUnmix"
    assert blob["base"]["config"]["sources"] == SOURCES
    loaded = load_model(path)
    assert isinstance(loaded.base, CrossNetOpenUnmix) and loaded.get_config() == model.get_config()
    wave = np.random.default_rng(13).standard_normal((1, 1, 2, 200)).astype(np.float32)
    np.testing.assert_array_equal(_forward(loaded, wave), _forward(model, wave))


def test_train_mode_raises():
    # Train mode with dropout needs the generator its masks come from; with one it
    # trains (batch statistics, dropout; tests/test_torch_musdb_train.py), and eval
    # mode ignores dropout.
    model = OpenUnmix(**CFG, dropout=0.4).train()
    x = torch.from_numpy(_amplitude((1,), seed=14))
    with pytest.raises(ValueError, match="dropout generator"):
        model(x)
    set_dropout_generator(model, torch.Generator().manual_seed(0))
    assert model(x).shape == x.shape
    model.eval()(x)  # dropout ignored in eval
