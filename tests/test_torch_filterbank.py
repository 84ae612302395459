"""Port's filterbanks and TDCN block variants against the JAX package (CPU).

Every encoder and decoder basis of `choose_filterbank` (Fourier, trainable
Fourier with and without a trainable phase, one- and two-sided, complex and
[real, imaginary] latents, every window; the gated encoder; the pinv
decoder), and the non-separable and strided (non-dilated) residual blocks,
each in a tiny Conv-TasNet whose JAX weights load into the port through
`hub/from_jax.py`; forward outputs at the repo's parity tolerance, 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.hub import conv_tasnet_state_dict_from_jax
from dnn_based_source_separation_torch.models import ConvTasNet
from dnn_based_source_separation_torch.ops import filterbank as tfb
from dnn_based_source_separation_torch.ops import windows as twin
from dnn_based_source_separation_tpu.models import ConvTasNet as JConvTasNet
from dnn_based_source_separation_tpu.ops import filterbank as jfb
from dnn_based_source_separation_tpu.ops import windows as jwin

ATOL = 1e-4
BASE = dict(
    kernel_size=16, stride=8, enc_nonlinear="relu", sep_num_blocks=2, sep_num_layers=2,
    sep_hidden_channels=12, sep_bottleneck_channels=8, sep_skip_channels=8, n_sources=2,
    causal=False,
)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scramble(tree, rng):
    """Non-identity norms, non-zero biases and phases, moved frequencies."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _scramble(v, rng)
            continue
        v = np.asarray(v)
        if k == "gamma":
            v = 0.5 + rng.random(v.shape)
        elif k in ("beta", "bias", "phase"):
            v = 0.3 * rng.standard_normal(v.shape)
        elif k == "frequency":
            v = v + 0.01 * rng.standard_normal(v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


def _check_model(config, T=403, seed=0):
    x = np.random.default_rng(seed).standard_normal((2, 1, T)).astype(np.float32)
    jmodel = JConvTasNet(**config)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(seed),
                                                               jnp.asarray(x)))
    variables = {"params": _scramble(variables["params"], np.random.default_rng(seed + 1))}
    expected = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    port = ConvTasNet(**config).eval()
    port.load_state_dict(conv_tasnet_state_dict_from_jax(variables, config))
    assert port.num_parameters() == sum(a.size for a in jax.tree_util.tree_leaves(variables))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == expected.shape == (2, 2, T)
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)
    return port


@pytest.mark.parametrize("basis", [
    dict(n_basis=17, enc_basis="Fourier", dec_basis="Fourier"),
    dict(n_basis=17, enc_basis="trainableFourier", dec_basis="trainableFourier",
         window_fn="hamming"),
    dict(n_basis=17, enc_basis="trainableFourierTrainablePhase",
         dec_basis="trainableFourierTrainablePhase", window_fn="sine"),
    dict(n_basis=18, enc_basis="trainableFourier", dec_basis="trainableFourier",
         enc_return_complex=False, window_fn="blackman"),
    dict(n_basis=16, enc_basis="Fourier", dec_basis="Fourier", enc_onesided=False,
         window_fn="rect"),
    dict(n_basis=18, enc_basis="trainable", dec_basis="Fourier", enc_return_complex=False),
    dict(n_basis=16, kernel_size=8, stride=4, enc_basis="trainable", dec_basis="pinv"),
    dict(n_basis=16, enc_basis="trainableGated", dec_basis="trainable"),
    dict(n_basis=17, enc_basis="Fourier", dec_basis="Fourier", causal=True),
], ids=["fourier", "trainable-fourier-hamming", "trainable-phase-sine", "real-latent-blackman",
        "twosided-rect", "trainable-enc-fourier-dec", "pinv", "gated", "fourier-causal"])
def test_filterbank_bases_match_jax(basis):
    _check_model(dict(BASE, **basis))


@pytest.mark.parametrize("variant", [
    dict(separable=False), dict(dilated=False), dict(separable=False, dilated=False),
    dict(separable=False, causal=True), dict(dilated=False, causal=True),
    dict(separable=False, sep_norm=False),
], ids=["non-separable", "strided", "non-separable-strided", "non-separable-causal",
        "strided-causal", "non-separable-no-norm"])
def test_block_variants_match_jax(variant):
    _check_model(dict(BASE, n_basis=16, **variant))


@pytest.mark.parametrize("kind", ["hann", "sine", "hamming", "blackman", "rect"])
@pytest.mark.parametrize("n,hop", [(16, 8), (40, 20), (12, 3)])
def test_windows_match_jax(kind, n, hop):
    window = twin.build_window(n, kind)
    np.testing.assert_allclose(window.numpy(), np.asarray(jwin.build_window(n, kind)),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(twin.build_optimal_window(window, hop).numpy(),
                               np.asarray(jwin.build_optimal_window(jnp.asarray(window.numpy()),
                                                                    hop)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("hidden,onesided,complex_", [
    (17, True, True), (18, True, False), (16, False, True), (16, False, False),
])
def test_compute_valid_basis_matches_jax(hidden, onesided, complex_):
    assert tfb.compute_valid_basis(hidden, onesided, complex_) == \
        jfb.compute_valid_basis(hidden, onesided, complex_)


def test_pinv_decode_uses_jax_cutoff_on_a_rank_deficient_basis():
    # A singular value of 5e-6 of the largest: under JAX's cut-off (10 x max(N, L)
    # x eps = 1.9e-5), above torch's default (1.9e-6), so the two defaults differ.
    N, L, S = 16, 8, 4
    rng = np.random.default_rng(3)
    u, _ = np.linalg.qr(rng.standard_normal((N, L)))
    v, _ = np.linalg.qr(rng.standard_normal((L, L)))
    s = np.array([1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 5e-6])
    analysis = (u * s) @ v.T  # (N, L)
    kernel = analysis.T.astype(np.float32)  # JAX layout (L, N)
    w_hat = rng.standard_normal((2, 2, 30, N)).astype(np.float32)
    enc = jfb.ConvEncoder(N, L, S)
    expected = np.asarray(enc.apply({"params": {"kernel": jnp.asarray(kernel)}},
                                    jnp.asarray(w_hat), method=enc.pinv_decode))
    port = tfb.ConvEncoder(N, L, S)
    port.load_state_dict({"conv1d.weight": torch.from_numpy(kernel.T.reshape(N, 1, L))})
    with torch.no_grad():
        got = port.pinv_decode(torch.from_numpy(w_hat)).numpy()
        default = torch.linalg.pinv(torch.from_numpy(analysis.astype(np.float32)))
    assert got.shape == expected.shape == (2, 2, 29 * S + L, 1)
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)
    assert float(default.abs().max()) > 1e4  # torch's own cut-off keeps the 5e-6 value


def test_unsupported_combinations_raise():
    with pytest.raises(ValueError, match="nonlinear"):  # as JAX's pinv_decode
        tfb.ConvEncoder(16, 8, 4, nonlinear="relu").pinv_decode(torch.zeros(1, 3, 16))
    with pytest.raises(NotImplementedError, match="decoder"):
        ConvTasNet(**dict(BASE, n_basis=17, enc_basis="Fourier", dec_basis="trainable"))(
            torch.zeros(1, 1, 64))
    with pytest.raises(NotImplementedError, match="pinv"):
        tfb.choose_filterbank(16, 8, enc_basis="trainableGated", dec_basis="pinv")
    with pytest.raises(ValueError, match="monaural"):
        tfb.choose_filterbank(17, 8, enc_basis="Fourier", dec_basis="Fourier", in_channels=2)
    with pytest.raises(NotImplementedError):
        tfb.choose_filterbank(16, 8, enc_basis="nope")
