"""Port's exact streaming of causal Conv-TasNet, and the windowed approximation (CPU).

Mirrors the JAX package's `tests/test_longform.py` streaming tests: the
streamed output equals the port's own offline causal forward at atol 1e-5
(float rounding: the carried cLN sums add in another order) and JAX's
`ExactStreamingSeparator` on the same weights at 1e-4, at hops of 400, 160
and 16 samples and at an off-grid length through the CLI's `stream_file`.
The windowed `StreamingSeparator` is held to JAX's windowed output, not to
the offline forward it only approximates.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.cli import separate as tsep
from dnn_based_source_separation_torch.cli.separate import stream_file
from dnn_based_source_separation_torch.hub import conv_tasnet_state_dict_from_jax
from dnn_based_source_separation_torch.models import ConvTasNet
from dnn_based_source_separation_torch.models.base import save_model
from dnn_based_source_separation_torch.models.streaming import (
    ExactStreamingSeparator, StreamingSeparator,
)
from dnn_based_source_separation_tpu.cli import separate as jsep
from dnn_based_source_separation_tpu.data.audio_io import read_wav, write_wav
from dnn_based_source_separation_tpu.models import ConvTasNet as JConvTasNet
from dnn_based_source_separation_tpu.models.base import save_model as jax_save_model
from dnn_based_source_separation_tpu.models.streaming import (
    ExactStreamingSeparator as JExactStreamingSeparator,
)
from dnn_based_source_separation_tpu.models.streaming import (
    StreamingSeparator as JStreamingSeparator,
)

CFG = dict(
    n_basis=16, kernel_size=16, stride=8, enc_nonlinear="relu", sep_hidden_channels=16,
    sep_bottleneck_channels=8, sep_skip_channels=8, sep_num_blocks=2, sep_num_layers=3,
    causal=True, n_sources=2,
)
T = 1600  # grid-aligned: (T - L) % S == 0, and a whole number of every hop below


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scramble(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _scramble(v, rng)
            continue
        v = np.asarray(v)
        if k == "gamma":
            v = 0.5 + rng.random(v.shape)
        elif k in ("beta", "bias"):
            v = 0.3 * rng.standard_normal(v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def models():
    """(jax model, jax variables, port model) of one tiny causal Conv-TasNet."""
    torch.set_num_threads(1)
    jmodel = JConvTasNet(**CFG)
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 400), jnp.float32)))
    variables = {"params": _scramble(variables["params"], np.random.default_rng(0))}
    port = ConvTasNet(**CFG).eval()
    port.load_state_dict(conv_tasnet_state_dict_from_jax(variables, CFG))
    return jmodel, variables, port


def _offline(port, x):
    with torch.no_grad():
        return port(torch.from_numpy(x)[None, None]).numpy()[0]


def _signal(seed, n):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("hop", [400, 160, 16])
def test_exact_streaming_matches_offline_and_jax(models, hop):
    jmodel, variables, port = models
    x = _signal(0, T)
    stream = ExactStreamingSeparator(port, hop_samples=hop)
    outs = [stream.process(x[lo:lo + hop]) for lo in range(0, T, hop)] + [stream.flush()]
    streamed = torch.cat(outs, -1).numpy()
    offline = _offline(port, x)
    assert streamed.shape == offline.shape == (2, T)
    np.testing.assert_allclose(streamed, offline, rtol=0, atol=1e-5)

    jstream = JExactStreamingSeparator(jmodel, variables, hop_samples=hop)
    expected = np.concatenate([jstream.process(x[lo:lo + hop]) for lo in range(0, T, hop)]
                              + [jstream.flush()], -1)
    np.testing.assert_allclose(streamed, expected, rtol=0, atol=1e-4)
    # Every hop after the first emits exactly hop samples.
    assert [o.shape[-1] for o in outs[1:-1]] == [hop] * (len(outs) - 2)


@pytest.mark.parametrize("n", [1603, 397])
def test_exact_streaming_off_the_grid_matches_offline(models, n):
    # The CLI's stream_file pads to the stride grid as the offline forward does,
    # feeds whole hops and finishes with the rest.
    jmodel, variables, port = models
    x = _signal(1, n)
    streamed = stream_file(port, x, 0.05, 8000)  # 400-sample hops
    offline = _offline(port, x)
    assert streamed.shape == offline.shape == (2, n)
    np.testing.assert_allclose(streamed, offline, rtol=0, atol=1e-5)
    expected = np.asarray(jmodel.apply(variables, jnp.asarray(x)[None, None]))[0]
    np.testing.assert_allclose(streamed, expected, rtol=0, atol=1e-4)


def test_separator_stream_state_is_f32_and_emits_one_mask_frame_per_latent_frame(models):
    _, _, port = models
    model = ConvTasNet(**CFG).to(torch.bfloat16).eval()
    model.load_state_dict(port.state_dict())
    w = torch.randn(1, 49, CFG["n_basis"], dtype=torch.bfloat16)
    with torch.no_grad():
        mask, state = model.separator.stream(w, {})
        mask2, state = model.separator.stream(w[:, :7], state)
    assert mask.shape == (1, 2, 49, 16) and mask2.shape == (1, 2, 7, 16)
    assert state["norm"].dtype == torch.float32
    for block, dilations in zip(state["tdcn"], [(1, 2, 4)] * 2):
        for layer, d in zip(block, dilations):
            assert layer["ctx"].dtype == torch.float32 and layer["ctx"].shape == (1, 2 * d, 16)
            assert layer["norm"].dtype == layer["sep_norm"].dtype == torch.float32


def test_reset_restarts_the_stream(models):
    _, _, port = models
    x = _signal(2, 800)
    stream = ExactStreamingSeparator(port, hop_samples=400)
    first = [stream.process(x[lo:lo + 400]) for lo in range(0, 800, 400)]
    stream.reset()
    second = [stream.process(x[lo:lo + 400]) for lo in range(0, 800, 400)]
    for a, b in zip(first, second):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # finish() ends one stream and leaves the separator ready for the next.
    whole = torch.cat(second + [stream.finish()], -1)
    again = torch.cat([stream.process(x[lo:lo + 400]) for lo in range(0, 800, 400)]
                      + [stream.finish()], -1)
    torch.testing.assert_close(whole, again, rtol=0, atol=0)


@pytest.mark.parametrize("config,error", [
    (dict(causal=False), ValueError),
    (dict(dec_basis="pinv"), NotImplementedError),
    (dict(enc_basis="trainableGated"), NotImplementedError),
    (dict(n_basis=17, enc_basis="Fourier", dec_basis="Fourier"), NotImplementedError),
], ids=["non-causal", "pinv", "gated", "fourier"])
def test_refusals_match_jax(config, error):
    config = dict(CFG, **config)
    jmodel = JConvTasNet(**config)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 400), jnp.float32))
    with pytest.raises(error):
        JExactStreamingSeparator(jmodel, variables, hop_samples=400)
    with pytest.raises(error):
        ExactStreamingSeparator(ConvTasNet(**config), hop_samples=400)


def test_refusals_of_hop_and_strided_blocks():
    with pytest.raises(ValueError, match="stride"):
        ExactStreamingSeparator(ConvTasNet(**CFG), hop_samples=12)  # not a multiple of S
    with pytest.raises(ValueError, match="stride"):
        ExactStreamingSeparator(ConvTasNet(**CFG), hop_samples=8)  # shorter than L
    stream = ExactStreamingSeparator(ConvTasNet(**dict(CFG, dilated=False)).eval(),
                                     hop_samples=400)
    with pytest.raises(NotImplementedError, match="stride-1"):  # as JAX, at the first call
        stream.process(np.zeros(400, np.float32))


def test_windowed_streaming_matches_jax(models):
    jmodel, variables, port = models
    n, hop, context = 4000, 500, 1000
    x = _signal(3, n)[None]
    stream = StreamingSeparator(port, hop_samples=hop, context_samples=context)
    got = torch.cat([stream.process(x[:, s:s + hop]) for s in range(0, n, hop)]
                    + [stream.flush()], -1).numpy()
    jstream = JStreamingSeparator(jmodel, variables, hop_samples=hop, context_samples=context)
    expected = np.concatenate([jstream.process(x[:, s:s + hop]) for s in range(0, n, hop)]
                              + [jstream.flush()], -1)
    assert got.shape == expected.shape == (2, n + hop)
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="hop"):
        stream.process(x[:, :hop - 1])
    stream.reset()
    again = stream.process(x[:, :hop])
    np.testing.assert_allclose(again.numpy(), got[:, :hop], rtol=0, atol=0)


def test_cli_streaming_writes_the_same_wavs_as_jax(models, tmp_path):
    jmodel, variables, port = models
    jax_ckpt, port_ckpt = str(tmp_path / "model.ckpt"), str(tmp_path / "model.pth")
    jax_save_model(jax_ckpt, jmodel, variables, {})
    save_model(port_ckpt, port)
    wav = str(tmp_path / "mix.wav")
    write_wav(wav, 0.1 * _signal(4, 2345), 8000)
    args = ["--input", wav, "--streaming_hop", "0.05"]
    jsep.main(["--model_path", jax_ckpt, "--out_dir", str(tmp_path / "jax"), *args])
    est = tsep.main(["--model_path", port_ckpt, "--out_dir", str(tmp_path / "port"),
                     "--device", "cpu", *args])
    offline = tsep.main(["--model_path", port_ckpt, "--out_dir", str(tmp_path / "offline"),
                         "--device", "cpu", "--input", wav])
    expected, got = (np.stack([read_wav(os.path.join(tmp_path, d, f"source{s}.wav"))[0]
                               for s in range(2)]) for d in ("jax", "port"))
    assert got.shape == expected.shape == est.shape == (2, 2345)
    assert np.abs(got - expected).max() <= 2.0 / 32768  # two 16-bit steps
    np.testing.assert_allclose(est, offline, rtol=0, atol=1e-5)
