"""Port's framing, filterbank encoder, norms and PReLU against the JAX package (CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.models.modules import PReLU, choose_nonlinear
from dnn_based_source_separation_torch.ops import filterbank as tfb
from dnn_based_source_separation_torch.ops import norms as tnorms
from dnn_based_source_separation_tpu.models.modules import PReLU as JPReLU
from dnn_based_source_separation_tpu.models.modules import choose_nonlinear as jchoose_nonlinear
from dnn_based_source_separation_tpu.ops import filterbank as jfb
from dnn_based_source_separation_tpu.ops import norms as jnorms

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("T,L,hop", [(64, 8, 4), (67, 8, 4), (50, 7, 3)])
def test_frame_signal_matches_jax(T, L, hop):
    x = _rand(T, 2, 3, T)
    expected = np.asarray(jfb.frame_signal(jnp.asarray(x), L, hop))
    got = tfb.frame_signal(torch.from_numpy(x), L, hop)
    np.testing.assert_array_equal(got.numpy(), expected)


@pytest.mark.parametrize("S,L,hop", [(9, 8, 4), (9, 16, 8), (11, 7, 3), (5, 6, 4)])
def test_unfold_apply_matches_jax(S, L, hop):
    # L % hop == 0 takes the sub-band slice-adds; otherwise per-position strided adds.
    frames = _rand(S * L, 2, 3, S, L)
    expected = np.asarray(jfb.unfold_apply(jnp.asarray(frames), hop))
    got = tfb.unfold_apply(torch.from_numpy(frames), hop)
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=1e-6)


def test_unfold_apply_inverts_frame_signal_sum():
    # Overlap-add of the frames of a signal is the signal times its overlap count.
    x = torch.from_numpy(_rand(1, 2, 40))
    y = tfb.unfold_apply(tfb.frame_signal(x, 8, 4), 4)
    count = tfb.unfold_apply(tfb.frame_signal(torch.ones(1, 40), 8, 4), 4)
    torch.testing.assert_close(y, x * count, rtol=0, atol=1e-6)


@pytest.mark.parametrize("channels,nonlinear", [(1, None), (1, "relu"), (2, "relu")])
def test_conv_encoder_matches_jax(channels, nonlinear):
    N, L, hop, T = 16, 8, 4, 84
    x = _rand(channels, 2, T, channels)
    kernel = _rand(7, channels * L, N)  # JAX layout (C*L, N)
    enc = jfb.ConvEncoder(N, L, hop, in_channels=channels, nonlinear=nonlinear)
    expected = np.asarray(enc.apply({"params": {"kernel": jnp.asarray(kernel)}}, jnp.asarray(x)))
    port = tfb.ConvEncoder(N, L, hop, in_channels=channels, nonlinear=nonlinear)
    port.load_state_dict({"conv1d.weight": torch.from_numpy(kernel.T.reshape(N, channels, L))})
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=ATOL)


def test_choose_filterbank_ports_only_trainable():
    enc, dec = tfb.choose_filterbank(16, 8, enc_nonlinear="relu")
    assert isinstance(enc, tfb.ConvEncoder) and isinstance(dec, tfb.ConvDecoder)
    assert enc.stride == 4 and enc.nonlinear == "relu"
    with pytest.raises(NotImplementedError):
        tfb.choose_filterbank(16, 8, enc_basis="Fourier", dec_basis="Fourier")


def _affine(seed, N):
    rng = np.random.default_rng(seed)
    return (0.5 + rng.random(N)).astype(np.float32), rng.standard_normal(N).astype(np.float32)


def _load_norm(norm, gamma, beta):
    norm.load_state_dict({"gamma": torch.from_numpy(gamma.reshape(1, -1, 1)),
                          "beta": torch.from_numpy(beta.reshape(1, -1, 1))})
    return norm


@pytest.mark.parametrize("kind,eps", [("gLN", 1e-12), ("gLN", 1e-8), ("cLN", 1e-12),
                                      ("LN", 1e-8)])
def test_layer_norms_match_jax(kind, eps):
    N = 12
    x = 3.0 * _rand(N, 2, 25, N) + 1.0
    gamma, beta = _affine(N, N)
    jmod = jnorms.choose_layer_norm(kind, N, eps=eps)
    expected = np.asarray(jmod.apply({"params": {"gamma": jnp.asarray(gamma),
                                                 "beta": jnp.asarray(beta)}}, jnp.asarray(x)))
    port = _load_norm(tnorms.choose_layer_norm(kind, N, eps=eps), gamma, beta)
    assert type(port).__name__ == type(jmod).__name__
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=ATOL)


@pytest.mark.parametrize("pad", [(0, 0), (2, 2), (4, 0)])
def test_gln_without_affine_pads_with_fill_like_jax(pad):
    N = 8
    x = _rand(3, 2, 10, N)
    gamma, beta = _affine(4, N)
    gamma[1] = 0.0  # a zero gamma takes the fill's guarded branch
    jmod = jnorms.GlobalLayerNorm(N, eps=1e-12, affine=False)
    expected = np.asarray(jmod.apply({"params": {"gamma": jnp.asarray(gamma),
                                                 "beta": jnp.asarray(beta)}},
                                     jnp.asarray(x), pad=pad))
    port = _load_norm(tnorms.GlobalLayerNorm(N, eps=1e-12, affine=False), gamma, beta)
    with torch.no_grad():
        got = port(torch.from_numpy(x), pad=pad)
    assert got.shape == expected.shape
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=ATOL)


def test_choose_layer_norm_refuses_folding_non_gln():
    with pytest.raises(ValueError):
        tnorms.choose_layer_norm("cLN", 8, affine=False)
    with pytest.raises(ValueError):
        tnorms.choose_layer_norm("LN", 8, affine=False)
    assert isinstance(tnorms.choose_layer_norm("gLN", 8, causal=True),
                      tnorms.CumulativeLayerNorm)


@pytest.mark.parametrize("alpha", [0.25, -0.3])
def test_prelu_matches_jax(alpha):
    x = _rand(5, 2, 7, 6)
    expected = np.asarray(JPReLU().apply({"params": {"alpha": jnp.float32(alpha)}},
                                         jnp.asarray(x)))
    port = PReLU()
    assert port.weight.tolist() == [0.25]
    port.load_state_dict({"weight": torch.tensor([alpha])})
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", [None, "relu", "sigmoid", "tanh", "softmax", "silu", "gelu",
                                  "leaky-relu"])
def test_choose_nonlinear_matches_jax(name):
    x = 2.0 * _rand(6, 3, 5, 7)
    expected = np.asarray(jchoose_nonlinear(name)(jnp.asarray(x)))
    got = choose_nonlinear(name)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=1e-6)
