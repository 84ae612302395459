"""The port's divergences, entropies, metric-learning losses, Griffin-Lim, MISI, NMF,
cepstra and PCA against the JAX package (CPU).

Every JAX reference runs under `jax.jit`. Losses and divergences within 1e-5 relative
(f32), their gradients within 1e-5 x max|g|; phase retrieval runs 3-5 iterations and
agrees within 1e-4 x max|x| (iterated STFTs magnify rounding); NMF from JAX's own
initial W and H within 1e-4 relative after 20 updates; cepstra within 1e-4 x max|x|;
PCA's variances within 1e-5 relative and its components up to one sign each.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch import algorithm as ta
from dnn_based_source_separation_torch import criterion as tc
from dnn_based_source_separation_torch import transforms as tt

jdiv = importlib.import_module("dnn_based_source_separation_tpu.criterion.divergence")
jent = importlib.import_module("dnn_based_source_separation_tpu.criterion.entropy")
jml = importlib.import_module("dnn_based_source_separation_tpu.criterion.metric_learn")
jdist = importlib.import_module("dnn_based_source_separation_tpu.criterion.distance")
jgl = importlib.import_module("dnn_based_source_separation_tpu.algorithm.griffin_lim")
jmisi = importlib.import_module("dnn_based_source_separation_tpu.algorithm.misi")
jnmf = importlib.import_module("dnn_based_source_separation_tpu.algorithm.nmf")
jceps = importlib.import_module("dnn_based_source_separation_tpu.transforms.cepstrum")
jpca = importlib.import_module("dnn_based_source_separation_tpu.transforms.pca")
jwin = importlib.import_module("dnn_based_source_separation_tpu.ops.windows")

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _grad_close(port_fn, jax_fn, x, *rest):
    """The value and the gradient of sum(fn(x, *rest)) with respect to x."""
    xt = torch.from_numpy(x).requires_grad_()
    value = port_fn(xt, *_t(*rest))
    value.sum().backward()
    args = [jnp.asarray(a) for a in (x, *rest)]
    ref = np.asarray(jax.jit(jax_fn)(*args))
    j_grad = jax.jit(jax.grad(lambda v, *a: jnp.sum(jax_fn(v, *a))))(*args)
    np.testing.assert_allclose(value.detach().numpy(), ref, rtol=RTOL, atol=1e-6)
    g = np.asarray(j_grad)
    np.testing.assert_allclose(xt.grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max())


@pytest.mark.parametrize("name,kw", [("kl_divergence", {}), ("generalized_kl_divergence", {}),
                                     ("is_divergence", {}), ("beta_divergence", {"beta": 0.0}),
                                     ("beta_divergence", {"beta": 1.0}),
                                     ("beta_divergence", {"beta": 2.0}),
                                     ("beta_divergence", {"beta": 0.5})])
def test_divergences_match_jax(name, kw):
    rng = np.random.default_rng(0)
    x, y = (rng.random((3, 4, 17)).astype(np.float32) + 0.05 for _ in range(2))
    _grad_close(lambda a, b: getattr(tc, name)(a, b, **kw),
                lambda a, b: getattr(jdiv, name)(a, b, **kw), x, y)


@pytest.mark.parametrize("name", ["BinaryCrossEntropy", "CategoricalCrossEntropy", "DiceLoss"])
@pytest.mark.parametrize("batch_mean", [True, False])
def test_entropies_match_jax(name, batch_mean):
    rng = np.random.default_rng(1)
    if name == "CategoricalCrossEntropy":
        logits = rng.standard_normal((4, 5, 6)).astype(np.float32)
        p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        target = np.eye(6, dtype=np.float32)[rng.integers(0, 6, (4, 5))]
    else:
        p = rng.random((4, 3, 7)).astype(np.float32)
        target = (rng.random((4, 3, 7)) > 0.5).astype(np.float32)
    port, ref = getattr(tc, name)(), getattr(jent, name)()
    assert port.maximize == ref.maximize
    _grad_close(lambda a, b: port(a, b, batch_mean=batch_mean),
                lambda a, b: ref(a, b, batch_mean=batch_mean), p.astype(np.float32), target)


def test_metric_learning_losses_match_jax():
    rng = np.random.default_rng(2)
    a, p, n = (rng.standard_normal((6, 8)).astype(np.float32) for _ in range(3))
    label = (rng.random(6) > 0.5).astype(np.float32)
    for batch_mean in (True, False):
        _grad_close(lambda x, y, z: tc.TripletLoss(2.0)(x, y, z, batch_mean),
                    lambda x, y, z: jml.TripletLoss(2.0)(x, y, z, batch_mean), a, p, n)
        _grad_close(lambda x, y, z: tc.ContrastiveLoss(3.0)(x, y, z, batch_mean),
                    lambda x, y, z: jml.ContrastiveLoss(3.0)(x, y, z, batch_mean), a, p, label)
        _grad_close(lambda x, y, z: tc.TripletWithDistanceLoss(tc.L2Loss(), 5.0)(
                        x, y, z, batch_mean),
                    lambda x, y, z: jml.TripletWithDistanceLoss(jdist.L2Loss(), 5.0)(
                        x, y, z, batch_mean), a, p, n)
        _grad_close(lambda x, y, z: tc.ContrastiveWithDistanceLoss(tc.L2Loss(), 4.0)(
                        x, y, z, batch_mean),
                    lambda x, y, z: jml.ContrastiveWithDistanceLoss(jdist.L2Loss(), 4.0)(
                        x, y, z, batch_mean), a, p, label)


@pytest.mark.parametrize("easy_margin", [False, True])
def test_arcface_matches_jax(easy_margin):
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((5, 8)).astype(np.float32)
    weight = rng.standard_normal((7, 8)).astype(np.float32)
    labels = rng.integers(0, 7, 5).astype(np.int32)
    _grad_close(lambda e, w, y: tc.arcface_logits(e, w, y),
                lambda e, w, y: jml.arcface_logits(e, w, y), emb, weight, labels)
    cos = np.clip(rng.standard_normal((5, 7)) / 2, -0.99, 0.99).astype(np.float32)
    port = tc.AdditiveAngularMarginLoss(easy_margin=easy_margin)
    ref = jml.AdditiveAngularMarginLoss(easy_margin=easy_margin)
    _grad_close(lambda c, y: port(c, y, batch_mean=False),
                lambda c, y: ref(c, y, batch_mean=False), cos, labels)


@pytest.mark.parametrize("name", ["ImprovedTripletLoss", "AdaptedTripletLoss",
                                  "QuadrupletLoss"])
def test_metric_learning_stubs_raise_as_jax(name):
    module = importlib.import_module("dnn_based_source_separation_torch.criterion.metric_learn")
    with pytest.raises(NotImplementedError, match=name):
        getattr(module, name)()
    with pytest.raises(NotImplementedError, match=name):
        getattr(jml, name)()


def _speech_like(seed, shape, T=2048):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 8000.0
    x = sum(np.sin(2 * np.pi * f * t + rng.random() * 6) for f in (220.0, 440.0, 1250.0))
    return (0.3 * x + 0.05 * rng.standard_normal(shape + (T,))).astype(np.float32)


def _amplitude(x, n_fft, hop):
    window = np.asarray(jwin.build_window(n_fft, "hann"))
    spec = jax.jit(lambda v: jnp.abs(jgl.stft(v, n_fft, hop, window=jnp.asarray(window))))(
        jnp.asarray(x))
    return np.asarray(spec), window


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("init", ["zeros", "given"])
def test_griffin_lim_matches_jax(fast, init):
    n_fft, hop, T = 128, 32, 2048
    amp, window = _amplitude(_speech_like(4, (2,)), n_fft, hop)
    phase = (np.random.default_rng(5).random(amp.shape) * 2 * np.pi).astype(np.float32)
    kw = {} if init == "zeros" else {"init_phase": phase}
    port_fn, jax_fn = (ta.fast_griffin_lim, jgl.fast_griffin_lim) if fast else (
        ta.griffin_lim, jgl.griffin_lim)
    amp_t, window_t = _t(amp, window)
    got = port_fn(amp_t, n_fft, hop, window=window_t, iteration=4, length=T,
                  **{k: torch.from_numpy(v) for k, v in kw.items()})
    ref = jax.jit(lambda a, **k: jax_fn(a, n_fft, hop, window=jnp.asarray(window), iteration=4,
                                        length=T, **k))(jnp.asarray(amp), **kw)
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (2, T)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    cls = ta.FastGriffinLim if fast else ta.GriffinLim
    again = cls(n_fft, hop, window=window_t, iteration=4)(
        amp_t, length=T, **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_griffin_lim_random_phase_comes_from_the_generator():
    amp = torch.rand(1, 65, 20)
    runs = [ta.griffin_lim(amp, 128, 32, iteration=2, generator=torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_misi_matches_jax():
    n_fft, hop, T = 128, 32, 2048
    sources = _speech_like(6, (2,))
    amps, window = _amplitude(sources, n_fft, hop)
    mixture = sources.sum(axis=0)
    got = ta.MISI(n_fft, hop, window=_t(window)[0], iteration=3)(*_t(amps, mixture))
    ref = np.asarray(jax.jit(lambda a, m: jmisi.misi(a, m, n_fft, hop, window=jnp.asarray(window),
                                                      iteration=3))(jnp.asarray(amps),
                                                                    jnp.asarray(mixture)))
    assert got.shape == ref.shape == (2, T)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("divergence", ["EUC", "KL", "IS"])
def test_nmf_matches_jax_from_its_initial_factors(divergence):
    rng = np.random.default_rng(8)
    V = (rng.random((12, 4)) @ rng.random((4, 30)) + 0.01).astype(np.float32)
    ref = jnmf.NMF(4, divergence, n_iterations=20, seed=3)
    j_W, j_H = jax.jit(ref.__call__)(jnp.asarray(V))
    # JAX's initial draws at PRNGKey(seed), as its NMF makes them (nmf.py:29-31)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    W0 = jax.random.uniform(k1, (12, 4), minval=0.1, maxval=1.0)
    H0 = jax.random.uniform(k2, (4, 30), minval=0.1, maxval=1.0)
    port = ta.NMF(4, divergence, n_iterations=20, seed=3)
    W, H = port(torch.from_numpy(V), init=_t(W0, H0))
    np.testing.assert_allclose(W.numpy(), np.asarray(j_W), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(H.numpy(), np.asarray(j_H), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(port.reconstruct().numpy(), (W @ H).numpy())
    drawn = ta.NMF(4, divergence, seed=3)._init(torch.from_numpy(V))
    assert all(((x >= 0.1) & (x < 1.0)).all() for x in drawn)
    assert torch.equal(drawn[0], ta.NMF(4, divergence, seed=3)._init(torch.from_numpy(V))[0])


@pytest.mark.parametrize("name", ["real_cepstrum", "complex_cepstrum", "minimum_phase"])
@pytest.mark.parametrize("n_fft", [None, 64, 63])
def test_cepstra_match_jax(name, n_fft):
    x = _speech_like(9, (3,), T=64)
    got = getattr(tt, name)(torch.from_numpy(x), n_fft)
    ref = np.asarray(jax.jit(lambda v: getattr(jceps, name)(v, n_fft))(jnp.asarray(x)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("n_components,center", [(None, True), (3, True), (2, False)])
def test_pca_matches_jax_up_to_sign(n_components, center):
    rng = np.random.default_rng(10)
    x = (rng.standard_normal((40, 6)) @ np.diag([5.0, 4.0, 3.0, 2.0, 1.0, 0.5])
         + 1.0).astype(np.float32)
    proj, comps, var = tt.pca(torch.from_numpy(x), n_components, center)
    j_proj, j_comps, j_var = (np.asarray(a) for a in jax.jit(
        lambda v: jpca.pca(v, n_components, center))(jnp.asarray(x)))
    np.testing.assert_allclose(var.numpy(), j_var, rtol=RTOL)
    sign = np.sign((comps.numpy() * j_comps).sum(axis=0))
    np.testing.assert_allclose(comps.numpy() * sign, j_comps, rtol=0, atol=1e-5)
    np.testing.assert_allclose(proj.numpy() * sign, j_proj, rtol=0,
                               atol=1e-5 * np.abs(j_proj).max())
