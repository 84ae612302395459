"""Port's STFT / iSTFT, ideal masks and multichannel Wiener EM against the JAX package (CPU).

Inputs come from a numpy seed; f32 parity is held at 1e-4 x max|ref|.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.algorithm import frequency_mask as tfm
from dnn_based_source_separation_torch.ops.stft import istft, stft
from dnn_based_source_separation_torch.ops.windows import build_window
from dnn_based_source_separation_tpu.algorithm import frequency_mask as jfm
from dnn_based_source_separation_tpu.ops.windows import build_window as jax_build_window

jstft = importlib.import_module("dnn_based_source_separation_tpu.ops.stft")
RTOL = 1e-4  # of max|ref|


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= rtol * scale, (err, scale)


def _t(a):
    return torch.from_numpy(np.array(a))


# (n_fft, hop, win_length, T): hop divides T and n_fft; hop divides neither; a short
# window; the paper's hop ratio at a ragged T.
STFT_CASES = [(64, 16, None, 1024), (64, 20, None, 1001), (64, 16, 48, 999), (128, 32, None, 777)]


@pytest.mark.parametrize("n_fft,hop,win_length,T", STFT_CASES)
@pytest.mark.parametrize("onesided", [True, False])
def test_stft_matches_jax(n_fft, hop, win_length, T, onesided):
    x = np.random.default_rng(T).standard_normal((2, 2, T)).astype(np.float32)
    window = np.asarray(jax_build_window(win_length or n_fft, "hann"))
    np.testing.assert_allclose(build_window(win_length or n_fft, "hann").numpy(), window,
                               rtol=0, atol=1e-7)
    ref = np.asarray(jstft.stft(jnp.asarray(x), n_fft, hop, win_length, jnp.asarray(window),
                                onesided=onesided))
    got = stft(_t(x), n_fft, hop, win_length, _t(window), onesided=onesided)
    assert got.dtype == torch.complex64
    _close(got.numpy(), ref)


@pytest.mark.parametrize("n_fft,hop,win_length,T", STFT_CASES)
@pytest.mark.parametrize("length", [None, "shorter", "longer"])
def test_istft_matches_jax(n_fft, hop, win_length, T, length):
    rng = np.random.default_rng(T + 1)
    x = rng.standard_normal((2, T)).astype(np.float32)
    window = np.asarray(jax_build_window(win_length or n_fft, "hann"))
    spec = np.asarray(jstft.stft(jnp.asarray(x), n_fft, hop, win_length, jnp.asarray(window)))
    S = spec.shape[-1]
    total = (S - 1) * hop + n_fft
    n = {None: None, "shorter": T - 37, "longer": total + 50}[length]  # past the OLA: zeros
    ref = np.asarray(jstft.istft(jnp.asarray(spec), n_fft, hop, win_length,
                                 jnp.asarray(window), length=n))
    got = istft(_t(spec), n_fft, hop, win_length, _t(window), length=n).numpy()
    _close(got, ref)
    if length == "shorter":  # a round trip through the window-normalised OLA
        np.testing.assert_allclose(got, x[:, :n], atol=1e-4)


def test_paper_chunk_has_431_frames():
    # 10 s at 44.1 kHz, n_fft 4096, hop 1024: the reflect pad makes 431 frames, and
    # istft(length=chunk) gives the chunk back.
    chunk = 441000
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, chunk)).astype(np.float32))
    window = build_window(4096, "hann")
    spec = stft(x, 4096, 1024, window=window)
    assert spec.shape == (1, 2049, 431)
    y = istft(spec, 4096, 1024, window=window, length=chunk)
    assert y.shape == (1, chunk)
    assert float((y - x).abs().max()) < 1e-4


def _sources(shape, seed, complex_=True):
    rng = np.random.default_rng(seed)
    re = rng.standard_normal(shape).astype(np.float32)
    if not complex_:
        return np.abs(re)
    return (re + 1j * rng.standard_normal(shape).astype(np.float32)).astype(np.complex64)


@pytest.mark.parametrize("name", ["ratio", "wiener", "amplitude", "phase_sensitive",
                                  "complex"])
@pytest.mark.parametrize("ndim", [3, 4])
def test_masks_match_jax(name, ndim):
    fn = f"compute_{'ideal_' if name not in ('wiener', 'phase_sensitive') else ''}{name}_" \
         f"{'filter_' if name == 'wiener' else ''}mask"
    x = _sources((3, 9, 11) if ndim == 3 else (2, 3, 9, 11), seed=ndim)
    if name in ("ratio", "wiener"):
        x = np.abs(x)
    ref = np.asarray(getattr(jfm, fn)(jnp.asarray(x)))
    got = getattr(tfm, fn)(_t(x)).numpy()
    _close(got, ref)


def test_binary_mask_matches_jax():
    x = _sources((2, 3, 9, 11), seed=5)
    x[:, 0, 0, 0] = x[:, 1, 0, 0]  # a tie: the first source wins in both
    ref = np.asarray(jfm.compute_ideal_binary_mask(jnp.asarray(x)))
    np.testing.assert_array_equal(tfm.compute_ideal_binary_mask(_t(x)).numpy(), ref)
    amp = np.abs(x[0])
    ref = np.asarray(jfm.compute_ideal_binary_mask(jnp.asarray(amp), source_dim=0))
    np.testing.assert_array_equal(tfm.compute_ideal_binary_mask(_t(amp), source_dim=0).numpy(),
                                  ref)


@pytest.mark.parametrize("C", [1, 2, 3])
def test_inv_small_matches_jax_and_inverts(C):
    A = _sources((5, 7, C, C), seed=C) + 3 * np.eye(C, dtype=np.complex64)
    ref = np.asarray(jfm._inv_small(jnp.asarray(A)))
    got = tfm._inv_small(_t(A)).numpy()
    _close(got, ref)
    np.testing.assert_allclose(A @ got, np.broadcast_to(np.eye(C), A.shape), atol=1e-4)


@pytest.mark.parametrize("iteration", [1, 2])
@pytest.mark.parametrize("lead", [(), (1,)])
def test_wiener_em_matches_jax(iteration, lead):
    # Loud enough that the global scale norm = max|X| / 10 is above 1.
    mix = 30 * _sources((*lead, 2, 17, 23), seed=iteration)
    amp = _sources((4, 2, 17, 23), seed=10 + iteration, complex_=False)
    ref = np.asarray(jfm.multichannel_wiener_filter(jnp.asarray(mix), jnp.asarray(amp),
                                                    iteration=iteration))
    got = tfm.multichannel_wiener_filter(_t(mix), _t(amp), iteration=iteration)
    assert got.dtype == torch.complex64
    _close(got.numpy(), ref)


@pytest.mark.parametrize("mixture_ndim", [4, 5])
def test_batched_wiener_em_matches_jax(mixture_ndim):
    mix = _sources((2, 1, 2, 9, 13) if mixture_ndim == 5 else (2, 2, 9, 13), seed=7)
    amp = _sources((2, 4, 2, 9, 13), seed=8, complex_=False)
    ref = np.asarray(jfm.multichannel_wiener_filter(jnp.asarray(mix), jnp.asarray(amp)))
    got = tfm.multichannel_wiener_filter(_t(mix), _t(amp)).numpy()
    assert got.shape == amp.shape
    _close(got, ref)


def test_wiener_em_by_frequency_block_is_exact():
    # Every statistic is per bin and the scale is global: EM over a slice of bins with
    # the whole mixture's scale equals the whole-array EM on those bins.
    mix = 50 * _sources((2, 16, 21), seed=11)
    amp = _sources((4, 2, 16, 21), seed=12, complex_=False)
    whole = tfm.multichannel_wiener_filter(_t(mix), _t(amp), iteration=2)
    norm = torch.clamp(_t(mix).abs().max() / 10.0, min=1.0)
    est = amp / (amp.sum(axis=0) + tfm.EPS) * mix
    for lo, hi in ((0, 5), (5, 16)):
        part = tfm._em_iterations(_t(mix[:, lo:hi]) / norm, _t(est[:, :, lo:hi]) / norm, 2,
                                  tfm.EPS) * norm
        np.testing.assert_allclose(part.numpy(), whole[:, :, lo:hi].numpy(), rtol=0,
                                   atol=1e-5 * float(whole.abs().max()))


def test_wiener_em_finite_on_loud_correlated_stereo():
    # JAX's regression case (tests/test_algorithm.py): loud, nearly identical channels
    # cancel the closed-form determinant in f32; the ridge relative to the trace keeps
    # the estimates finite and on the mixture's scale, as in JAX. The ridge bounds
    # Cxx's condition number at about 1e5, so f32 rounding (6e-8) moves the gains by up
    # to ~6e-3 of max|X|: the port and JAX are each held to a float64 run of the same
    # EM within 1e-2, and to each other within that.
    rng = np.random.default_rng(0)
    F, T = 16, 64
    base = (rng.standard_normal((F, T))
            + 1j * rng.standard_normal((F, T))).astype(np.complex64) * 100.0
    mix = np.stack([base, base * (1.0 + 1e-7)])
    amps = np.stack([np.abs(mix) * 0.9, np.abs(mix) * 0.1]).astype(np.float32)
    ref = np.asarray(jfm.multichannel_wiener_filter(jnp.asarray(mix), jnp.asarray(amps),
                                                    iteration=2))
    got = tfm.multichannel_wiener_filter(_t(mix), _t(amps), iteration=2).numpy()
    f64 = tfm.multichannel_wiener_filter(_t(mix.astype(np.complex128)),
                                         _t(amps.astype(np.float64)), iteration=2).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got).max() < 4 * np.abs(mix).max()
    for est in (got, ref):
        _close(est, f64, rtol=1e-2)
    _close(got, ref, rtol=1e-2)


def test_wiener_em_refuses_a_batched_mixture_with_unbatched_amplitudes():
    with pytest.raises(ValueError):
        tfm.multichannel_wiener_filter(_t(_sources((2, 2, 4, 5), 0)),
                                       _t(_sources((4, 2, 4, 5), 1, complex_=False)))
