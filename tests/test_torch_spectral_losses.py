"""Port's training losses of musdb18 against the JAX package (CPU): the distances, the
weighted SDR, the subset-combination loss, the spectral adapters and X-UMX's multi-domain
loss.

The same seeded numpy inputs go through both; every loss within 1e-5 relative of JAX's.
The gradients of NegWeightedSDR, CombinationLoss and MultiDomainLoss with respect to the
(real) input: torch's autograd against `jax.grad`, each within 1e-5 x max|g| (1e-4 for
MultiDomainLoss, whose gradient passes two f32 FFTs and an overlap-add). Tiny widths:
n_fft 64, hop 32, B = 2 x 0.25 s at 8 kHz, stereo, 4 sources.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.criterion import (
    CombinationLoss, CosineSimilarityLoss, L1Loss, L2Loss, MAELoss, MonoTargetAdapter, MSELoss,
    MultiDomainLoss, NegWeightedSDR, SpectralTargetAdapter, WeightedSDR, subset_matrix,
    weighted_sdr,
)
from dnn_based_source_separation_torch.ops.stft import stft
from dnn_based_source_separation_torch.ops.windows import build_window
from dnn_based_source_separation_tpu.criterion import combination as jcombination
from dnn_based_source_separation_tpu.criterion import distance as jdistance
from dnn_based_source_separation_tpu.criterion import multidomain as jmultidomain
from dnn_based_source_separation_tpu.criterion import spectral as jspectral
from dnn_based_source_separation_tpu.ops.windows import build_window as jax_build_window

# The JAX package's `criterion.sdr` module (its package exports a function of that name).
jsdr = importlib.import_module("dnn_based_source_separation_tpu.criterion.sdr")

RTOL = 1e-5
N_FFT, HOP, SR = 64, 32, 8000
B, N_SRC, C, T = 2, 4, 2, 2000  # 0.25 s


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= rtol * max(np.abs(ref).max(), 1e-30), (
        np.abs(got - ref).max(), np.abs(ref).max())


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    target = rng.standard_normal(shape).astype(np.float32)
    return (target + 0.5 * rng.standard_normal(shape)).astype(np.float32), target


def _both(criterion, jcriterion, input, target, **kwargs):
    got = criterion(torch.from_numpy(input), torch.from_numpy(target), **kwargs)
    ref = jax.jit(lambda v, t: jcriterion(v, t, **kwargs))(jnp.asarray(input), jnp.asarray(target))
    return got.numpy(), np.asarray(ref)


def _grads(criterion, jcriterion, input, target, **kwargs):
    """(loss, d loss / d input) of the port by autograd and of JAX by jax.grad."""
    x = torch.from_numpy(input).requires_grad_()
    loss = criterion(x, torch.as_tensor(target), **kwargs)
    loss.backward()
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda v, t: jcriterion(v, t, **kwargs)))(jnp.asarray(input), jnp.asarray(target))
    return (float(loss.detach()), x.grad.numpy()), (float(jloss), np.asarray(jgrad))


DISTANCES = {
    "l1": (L1Loss, jdistance.L1Loss), "l2": (L2Loss, jdistance.L2Loss),
    "mse": (MSELoss, jdistance.MSELoss), "mae": (MAELoss, jdistance.MAELoss),
}


@pytest.mark.parametrize("kwargs", [{}, {"dim": -1}, {"dim": (-2, -1)}, {"dim": 2}],
                         ids=["all", "last", "last-two", "dim2"])
@pytest.mark.parametrize("name", list(DISTANCES))
@pytest.mark.parametrize("batch_mean", [True, False])
def test_distances_match_jax(name, kwargs, batch_mean):
    cls, jcls = DISTANCES[name]
    input, target = _pair((B, N_SRC, C, 33), seed=1)
    _close(*_both(cls(**kwargs), jcls(**kwargs), input, target, batch_mean=batch_mean))
    assert cls(**kwargs).maximize == jcls(**kwargs).maximize is False


@pytest.mark.parametrize("name", ["l1", "l2"])
def test_distance_reduction_none_keeps_the_middle_axes(name):
    cls, jcls = DISTANCES[name]
    input, target = _pair((B, N_SRC, 50), seed=2)
    got, ref = _both(cls(dim=-1, reduction=None), jcls(dim=-1, reduction=None), input, target,
                     batch_mean=False)
    assert got.shape == (B, N_SRC)
    _close(got, ref)


@pytest.mark.parametrize("dim", [-1, 1])
@pytest.mark.parametrize("batch_mean", [True, False])
def test_cosine_similarity_matches_jax(dim, batch_mean):
    input, target = _pair((B, N_SRC, 40), seed=3)
    got, ref = _both(CosineSimilarityLoss(dim=dim), jdistance.CosineSimilarityLoss(dim=dim),
                     input, target, batch_mean=batch_mean)
    _close(got, ref)
    assert CosineSimilarityLoss().maximize is True


@pytest.mark.parametrize("source_dim", [1, 2])
def test_weighted_sdr_matches_jax(source_dim):
    input, target = _pair((B, N_SRC, C, 300), seed=4)
    got = weighted_sdr(torch.from_numpy(input), torch.from_numpy(target), source_dim)
    _close(got.numpy(), jsdr.weighted_sdr(jnp.asarray(input), jnp.asarray(target), source_dim))
    for reduction in ("mean", "sum", None):
        for cls, jcls in ((WeightedSDR, jsdr.WeightedSDR), (NegWeightedSDR, jsdr.NegWeightedSDR)):
            c, jc = cls(source_dim, reduction), jcls(source_dim, reduction)
            assert c.maximize == jc.maximize
            _close(*_both(c, jc, input, target, batch_mean=reduction is not None))


def test_neg_weighted_sdr_gradient_matches_jax():
    input, target = _pair((B, N_SRC, C, 300), seed=5)
    (loss, grad), (jloss, jgrad) = _grads(NegWeightedSDR(), jsdr.NegWeightedSDR(), input, target)
    _close(loss, jloss)
    _close(grad, jgrad)


@pytest.mark.parametrize("n,lo,hi", [(4, 1, None), (4, 2, 3), (3, 1, 3), (2, 1, 1)])
def test_subset_matrix_matches_jax(n, lo, hi):
    got = subset_matrix(n, lo, hi)
    np.testing.assert_array_equal(got, jcombination.subset_matrix(n, lo, hi))
    assert got.dtype == np.float32


@pytest.mark.parametrize("reduction", ["mean", "sum", None])
@pytest.mark.parametrize("batch_mean", [True, False])
def test_combination_loss_matches_jax(reduction, batch_mean):
    input, target = _pair((B, N_SRC, C, 33, 7), seed=6)
    got = CombinationLoss(MSELoss(dim=(-2, -1)))(
        torch.from_numpy(input), torch.from_numpy(target), reduction=reduction,
        batch_mean=batch_mean)
    ref = jcombination.CombinationLoss(jdistance.MSELoss(dim=(-2, -1)))(
        jnp.asarray(input), jnp.asarray(target), reduction=reduction, batch_mean=batch_mean)
    _close(got.numpy(), ref)


def test_combination_loss_on_another_axis_and_pairs_matches_jax():
    input, target = _pair((B, C, N_SRC, 200), seed=7)
    kwargs = dict(combination_dim=2, min_pair=2, max_pair=3)
    _close(*_both(CombinationLoss(NegWeightedSDR(), **kwargs),
                  jcombination.CombinationLoss(jsdr.NegWeightedSDR(), **kwargs), input, target))


@pytest.mark.parametrize("base", ["mse", "wsdr"])
def test_combination_loss_gradient_matches_jax(base):
    shape = (B, N_SRC, C, 33, 7) if base == "mse" else (B, N_SRC, C, 300)
    input, target = _pair(shape, seed=8)
    criterion, jcriterion = {
        "mse": (MSELoss(dim=(-2, -1)), jdistance.MSELoss(dim=(-2, -1))),
        "wsdr": (NegWeightedSDR(), jsdr.NegWeightedSDR())}[base]
    (loss, grad), (jloss, jgrad) = _grads(CombinationLoss(criterion),
                                          jcombination.CombinationLoss(jcriterion), input, target)
    _close(loss, jloss)
    _close(grad, jgrad)


def _waves(seed):
    return (0.3 * np.random.default_rng(seed).standard_normal((B, N_SRC, C, T))).astype(
        np.float32)


def _magnitudes(seed):
    """An estimated magnitude spectrogram of the waves' shape (B, n_src, C, F, S)."""
    S = T // HOP + 1
    return np.abs(np.random.default_rng(seed).standard_normal(
        (B, N_SRC, C, N_FFT // 2 + 1, S))).astype(np.float32)


@pytest.mark.parametrize("complex_target", [False, True])
def test_spectral_target_adapter_matches_jax(complex_target):
    waves, est = _waves(9), _magnitudes(10)
    base, jbase = ((MultiDomainLoss(N_FFT, HOP, window=build_window(N_FFT)),
                    jmultidomain.MultiDomainLoss(N_FFT, HOP, window=jax_build_window(N_FFT)))
                   if complex_target else (MSELoss(dim=(-2, -1)), jdistance.MSELoss(dim=(-2, -1))))
    adapter = SpectralTargetAdapter(base, N_FFT, HOP, complex_target=complex_target)
    jadapter = jspectral.SpectralTargetAdapter(jbase, N_FFT, HOP, complex_target=complex_target)
    assert adapter.maximize == jadapter.maximize is False
    _close(*_both(adapter, jadapter, est, waves))


def test_mono_target_adapter_matches_jax():
    waves = _waves(11)
    est = (waves.mean(axis=2) + 0.1).astype(np.float32)
    adapter = MonoTargetAdapter(NegWeightedSDR())
    _close(*_both(adapter, jspectral.MonoTargetAdapter(jsdr.NegWeightedSDR()), est, waves))
    assert MonoTargetAdapter(WeightedSDR()).maximize is True


def _complex_target(seed):
    spec = stft(torch.from_numpy(_waves(seed)), N_FFT, HOP, window=build_window(N_FFT))
    return spec.numpy()


@pytest.mark.parametrize("combination,weights", [(True, (10.0, 1.0)), (False, (10.0, 1.0)),
                                                 (True, (0.0, 1.0)), (True, (1.0, 0.0))],
                         ids=["recipe", "no-combination", "frequency-only", "time-only"])
def test_multidomain_loss_and_gradient_match_jax(combination, weights):
    kwargs = dict(weight_time=weights[0], weight_frequency=weights[1], combination=combination)
    criterion = MultiDomainLoss(N_FFT, HOP, window=build_window(N_FFT), **kwargs)
    jcriterion = jmultidomain.MultiDomainLoss(N_FFT, HOP, window=jax_build_window(N_FFT), **kwargs)
    est, target = _magnitudes(12), _complex_target(13)
    (loss, grad), (jloss, jgrad) = _grads(criterion, jcriterion, est, target)
    _close(loss, jloss)
    _close(grad, jgrad, rtol=1e-4)
    assert np.abs(grad).max() > 0


def test_multidomain_loss_refuses_swapped_inputs():
    criterion = MultiDomainLoss(N_FFT, HOP)
    target = torch.from_numpy(_complex_target(14))
    with pytest.raises(TypeError, match="real"):
        criterion(target, target)
    with pytest.raises(TypeError, match="complex"):
        criterion(target.abs(), target.abs())
