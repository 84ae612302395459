"""Port's exact streaming of the stream-safe causal DPRNN-TasNet (CPU).

Mirrors the JAX package's `tests/test_streaming_dprnn.py`: the streamed
output equals the port's own offline stream-safe forward at atol 1e-5
(float rounding: the carried cLN sums and chunked recurrences add in
another order) and the JAX offline forward at the repo's parity tolerance
1e-4, for LSTM and GRU, two hops and two lengths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.hub import dprnn_tasnet_state_dict_from_jax
from dnn_based_source_separation_torch.models import ConvTasNet, DPRNNTasNet
from dnn_based_source_separation_torch.models.streaming import ExactStreamingSeparator
from dnn_based_source_separation_torch.ops.norms import CumulativeLayerNorm
from dnn_based_source_separation_tpu.models import DPRNNTasNet as JDPRNNTasNet

CFG = dict(
    n_basis=16, kernel_size=4, stride=2, enc_nonlinear="relu", sep_bottleneck_channels=8,
    sep_hidden_channels=8, sep_chunk_size=10, sep_hop_size=5, sep_num_blocks=2,
    causal=True, stream_safe=True, n_sources=2,
)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scramble(tree, rng):
    """Non-identity norm affines and non-zero biases, so every parameter matters."""
    if isinstance(tree, dict):
        return {k: _scramble(v, rng) if isinstance(v, dict) else
                np.asarray(0.5 + rng.random(np.shape(v)) if k == "gamma" else
                           0.3 * rng.standard_normal(np.shape(v))
                           if k in ("beta", "bias") or k.startswith("b_") else v, np.float32)
                for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module", params=["lstm", "gru"])
def models(request):
    """(jax model, jax variables, port model) of one tiny stream-safe DPRNN-TasNet."""
    torch.set_num_threads(1)
    config = dict(CFG, rnn_type=request.param)
    jmodel = JDPRNNTasNet(**config)
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 64), jnp.float32)))
    variables = {"params": _scramble(variables["params"], np.random.default_rng(0))}
    port = DPRNNTasNet(**config).eval()
    port.load_state_dict(dprnn_tasnet_state_dict_from_jax(variables, config))
    return jmodel, variables, port


def _offline(port, x):
    with torch.no_grad():
        return port(torch.from_numpy(x)).numpy()[0]


def _stream(port, x, hop):
    stream = ExactStreamingSeparator(port, hop_samples=hop)
    full = (x.shape[-1] // hop) * hop
    outs = [stream.process(x[0, 0, lo:lo + hop]) for lo in range(0, full, hop)]
    outs.append(stream.finish(x[0, 0, full:]))
    return torch.cat(outs, dim=-1).numpy()


@pytest.mark.parametrize("hop", [20, 32])
@pytest.mark.parametrize("T", [132, 140])
def test_streamed_equals_offline(models, hop, T):
    """T=132: 65 latent frames = 13 hops of 5 (on the grid); T=140: 69 (4 left over)."""
    jmodel, variables, port = models
    x = np.random.default_rng(T + hop).standard_normal((1, 1, T)).astype(np.float32)
    streamed = _stream(port, x, hop)
    offline = _offline(port, x)
    assert streamed.shape == offline.shape == (2, T)
    np.testing.assert_allclose(streamed, offline, rtol=0, atol=1e-5)
    expected = np.asarray(jmodel.apply(variables, jnp.asarray(x)))[0]
    np.testing.assert_allclose(streamed, expected, rtol=0, atol=1e-4)


def test_a_stream_shorter_than_one_hop_goes_through_finish(models):
    # 8 samples: 3 latent frames < hop_size 5, all in the final call.
    _, _, port = models
    x = np.random.default_rng(3).standard_normal((1, 1, 8)).astype(np.float32)
    out = ExactStreamingSeparator(port, hop_samples=20).finish(x[0, 0])
    np.testing.assert_allclose(out.numpy(), _offline(port, x), rtol=0, atol=1e-5)


def test_reset_restarts_bit_for_bit(models):
    _, _, port = models
    x = np.random.default_rng(1).standard_normal(80).astype(np.float32)
    stream = ExactStreamingSeparator(port, hop_samples=20)
    first = torch.cat([stream.process(x[lo:lo + 20]) for lo in range(0, 80, 20)], -1)
    stream.reset()
    second = torch.cat([stream.process(x[lo:lo + 20]) for lo in range(0, 80, 20)], -1)
    torch.testing.assert_close(first, second, rtol=0, atol=0)
    # finish() ends one stream and leaves the separator ready for the next.
    whole = torch.cat([first, stream.finish()], -1)
    again = torch.cat([stream.process(x[lo:lo + 20]) for lo in range(0, 80, 20)]
                      + [stream.finish()], -1)
    torch.testing.assert_close(whole, again, rtol=0, atol=0)


def test_refusals():
    with pytest.raises(NotImplementedError, match="stream_safe"):
        ExactStreamingSeparator(DPRNNTasNet(**dict(CFG, stream_safe=False)), hop_samples=20)
    with pytest.raises(ValueError, match="causal"):
        ExactStreamingSeparator(DPRNNTasNet(**dict(CFG, causal=False, stream_safe=False)),
                                hop_samples=20)
    with pytest.raises(ValueError, match="latent frames"):
        # 8 samples -> 3 latent frames < hop_size 5
        ExactStreamingSeparator(DPRNNTasNet(**CFG), hop_samples=8)
    with pytest.raises(ValueError, match="stride"):
        ExactStreamingSeparator(DPRNNTasNet(**CFG), hop_samples=21)
    # Causal Conv-TasNet streams now (tests/test_torch_streaming_conv_tasnet.py),
    # but not with the gated encoder, which normalises over the whole utterance.
    conv_tasnet = ConvTasNet(n_basis=16, kernel_size=4, stride=2, enc_basis="trainableGated",
                             sep_hidden_channels=8, sep_bottleneck_channels=8,
                             sep_skip_channels=8, sep_num_blocks=1, sep_num_layers=2,
                             causal=True)
    with pytest.raises(NotImplementedError, match="frame-local"):
        ExactStreamingSeparator(conv_tasnet, hop_samples=20)


def test_process_takes_whole_hops_and_finish_the_stride_grid():
    stream = ExactStreamingSeparator(DPRNNTasNet(**CFG).eval(), hop_samples=20)
    with pytest.raises(ValueError, match="hop"):
        stream.process(np.zeros(19, np.float32))
    with pytest.raises(ValueError, match="stride grid"):
        stream.finish(np.zeros(7, np.float32))  # (7 - 4) % 2 != 0


def test_separator_stream_refuses_frames_off_the_hop_grid():
    port = DPRNNTasNet(**CFG).eval()
    with torch.no_grad(), pytest.raises(ValueError, match="hop_size"):
        port.separator.stream(torch.zeros(1, 7, 16), {})


def test_cln_carried_stats_match_the_offline_cln():
    rng = np.random.default_rng(7)
    norm = CumulativeLayerNorm(6, eps=1e-12)
    with torch.no_grad():
        norm.gamma.copy_(torch.from_numpy(0.5 + rng.random((1, 6, 1), np.float32)))
        norm.beta.copy_(torch.from_numpy(rng.standard_normal((1, 6, 1)).astype(np.float32)))
        x = torch.from_numpy(rng.standard_normal((3, 23, 6)).astype(np.float32))
        offline = norm(x)
        stats, parts = None, []
        for lo, hi in ((0, 5), (5, 5), (5, 17), (17, 23)):  # (5, 5) is an empty drain call
            y, stats = norm.stream(x[:, lo:hi], stats)
            parts.append(y)
    torch.testing.assert_close(torch.cat(parts, 1), offline, rtol=0, atol=1e-5)
    assert stats.dtype == torch.float32 and stats.shape == (3, 3)
    torch.testing.assert_close(stats[:, 0], torch.full((3,), 23.0))
    torch.testing.assert_close(stats[:, 1], x.sum(dim=(1, 2)), rtol=1e-6, atol=1e-5)
