"""The port's ORPIT, SinkPIT, ProbPIT, Hungarian PIT, MixIT and thresholded SNR against the
JAX package (CPU).

Every JAX reference runs under `jax.jit`. Losses agree within 1e-5 relative (f32), each
gradient with respect to the estimates within 1e-5 x max|g|, and the chosen indices,
patterns and assignments exactly; P of SinkPIT within 1e-5. The batch has B = 3 items with
up to n = 3 sources; ORPIT's counts are [2, 3, 3], its padded target filled with noise
that the criterion must zero.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch import criterion as tc

jpit = importlib.import_module("dnn_based_source_separation_tpu.criterion.pit")
jsdr = importlib.import_module("dnn_based_source_separation_tpu.criterion.sdr")
jhun = importlib.import_module("dnn_based_source_separation_tpu.criterion.hungarian")
jmix = importlib.import_module("dnn_based_source_separation_tpu.criterion.mixit")

RTOL = 1e-5  # losses, relative
GTOL = 1e-5  # gradients, relative to the largest
CRITERIA = ["NegSISDR", "SISDR"]  # minimised and maximised


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _signals(seed, B=3, n=3, T=128):
    """Targets and noisy estimates of them in a shuffled order, so every search has a
    clear winner."""
    rng = np.random.default_rng(seed)
    target = rng.standard_normal((B, n, T)).astype(np.float32)
    perm = np.stack([rng.permutation(n) for _ in range(B)])
    est = target[np.arange(B)[:, None], perm] + 0.5 * rng.standard_normal((B, n, T))
    return est.astype(np.float32), target


def _both(port_fn, jax_fn, est, *args):
    """(port loss, port output, port grad), (JAX loss, JAX output, JAX grad) of one
    search, the gradient that of the batch-mean loss with respect to the estimates."""
    x = torch.from_numpy(est).requires_grad_()
    loss, out = port_fn(x, *[torch.from_numpy(np.asarray(a)) for a in args])
    loss.backward()

    @jax.jit
    def run(e, *a):
        return jax.value_and_grad(lambda v: jax_fn(v, *a)[0])(e), jax_fn(e, *a)[1]

    (j_loss, j_grad), j_out = run(jnp.asarray(est), *[jnp.asarray(a) for a in args])
    return (loss.detach(), out, x.grad), (np.asarray(j_loss), np.asarray(j_out),
                                          np.asarray(j_grad))


def _assert_close(port, ref, exact_out=True):
    (loss, out, grad), (j_loss, j_out, j_grad) = port, ref
    np.testing.assert_allclose(loss.numpy(), j_loss, rtol=RTOL, atol=0)
    assert torch.isfinite(grad).all()
    np.testing.assert_allclose(grad.numpy(), j_grad, rtol=0, atol=GTOL * np.abs(j_grad).max())
    if exact_out:
        np.testing.assert_array_equal(out.numpy(), j_out)
    else:
        np.testing.assert_allclose(out.detach().numpy(), j_out, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", CRITERIA)
def test_orpit_matches_jax_with_padded_sources(name):
    rng = np.random.default_rng(0)
    _, target = _signals(1)
    counts = np.array([2, 3, 3], np.int32)
    target[0, 2] = rng.standard_normal(target.shape[-1])  # padding: must not count
    # (one, rest) estimates: item b's "one" is source b % count, the rest the others' sum
    valid = target * (np.arange(3)[None, :, None] < counts[:, None, None])
    one = np.array([b % c for b, c in zip(range(3), counts)])
    est = np.stack([valid[np.arange(3), one], valid.sum(axis=1) - valid[np.arange(3), one]],
                   axis=1) + 0.3 * rng.standard_normal((3, 2, target.shape[-1]))
    est = est.astype(np.float32)
    port, ref = tc.ORPIT(getattr(tc, name)()), jpit.ORPIT(getattr(jsdr, name)())
    result = _both(lambda x, t, c: port(x, t, c), lambda e, t, c: ref(e, t, n_sources=c), est,
                   target, counts)
    _assert_close(*result)
    np.testing.assert_array_equal(result[0][1].numpy(), one)


def test_orpit_without_counts_uses_every_source():
    est, target = _signals(2, n=3)
    est = est[:, :2]
    port = tc.orpit(tc.NegSISDR(), torch.from_numpy(est), torch.from_numpy(target),
                    batch_mean=False)
    ref = jax.jit(lambda e, t: jpit.orpit(jsdr.NegSISDR(), e, t, batch_mean=False))(
        jnp.asarray(est), jnp.asarray(target))
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]), rtol=RTOL)
    np.testing.assert_array_equal(port[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("name", CRITERIA)
def test_sinkpit_matches_jax(name):
    est, target = _signals(3)
    port, ref = tc.SinkPIT(getattr(tc, name)(), 3), jpit.SinkPIT(getattr(jsdr, name)(), 3)
    _assert_close(*_both(port, ref, est, target))
    # P itself, before SinkPIT's argmax
    _assert_close(*_both(lambda x, t: tc.sinkpit(getattr(tc, name)(), x, t, coldness=0.5),
                         lambda e, t: jpit.sinkpit(getattr(jsdr, name)(), e, t, coldness=0.5),
                         est, target), exact_out=False)


@pytest.mark.parametrize("name", CRITERIA)
@pytest.mark.parametrize("gamma", [1.0, 0.1])
def test_prob_pit_matches_jax(name, gamma):
    est, target = _signals(4)
    port = tc.ProbPIT(getattr(tc, name)(), 3, gamma=gamma)
    ref = jpit.ProbPIT(getattr(jsdr, name)(), 3, gamma=gamma)
    _assert_close(*_both(port, ref, est, target))


@pytest.mark.parametrize("name", CRITERIA)
def test_hungarian_matches_jax_and_exhaustive_pit(name):
    est, target = _signals(5)  # random costs: no ties
    port, ref = tc.HungarianLoss(getattr(tc, name)()), jhun.HungarianLoss(getattr(jsdr, name)())
    result = _both(port, ref, est, target)
    _assert_close(*result)
    loss, pattern = tc.PIT1d(getattr(tc, name)(), 3)(torch.from_numpy(est),
                                                     torch.from_numpy(target))
    np.testing.assert_array_equal(result[0][1].numpy(), pattern.numpy())
    np.testing.assert_allclose(result[0][0].numpy(), loss.numpy(), rtol=RTOL)


@pytest.mark.parametrize("threshold_db", [30.0, 10.0])
def test_thresholded_snr_matches_jax(threshold_db):
    est, target = _signals(6, n=2)
    est[0, 0] = target[0, 0]  # a solved source: the threshold caps it
    got = tc.thresholded_snr(torch.from_numpy(est), torch.from_numpy(target), threshold_db)
    ref = jax.jit(jsdr.thresholded_snr, static_argnums=2)(jnp.asarray(est),
                                                          jnp.asarray(target), threshold_db)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-5)
    assert got[0, 0] <= threshold_db + 1e-4
    crit, j_crit = tc.NegThresholdedSNR(threshold_db), jsdr.NegThresholdedSNR(threshold_db)
    assert crit.maximize == j_crit.maximize is False
    for batch_mean in (True, False):
        np.testing.assert_allclose(
            crit(torch.from_numpy(est), torch.from_numpy(target), batch_mean).numpy(),
            np.asarray(j_crit(jnp.asarray(est), jnp.asarray(target), batch_mean)),
            rtol=RTOL)


@pytest.mark.parametrize("name", ["NegThresholdedSNR", "SISDR"])
@pytest.mark.parametrize("n_est", [2, 4])
def test_mixit_matches_jax(name, n_est):
    rng = np.random.default_rng(7)
    B, T = 3, 96
    sources = rng.standard_normal((B, n_est, T)).astype(np.float32)
    route = np.stack([rng.permutation(np.arange(n_est) % 2) for _ in range(B)])
    mixtures = np.stack([np.stack([sources[b, route[b] == m].sum(axis=0) for m in range(2)])
                         for b in range(B)]).astype(np.float32)
    est = (sources + 0.2 * rng.standard_normal(sources.shape)).astype(np.float32)
    np.testing.assert_array_equal(tc.mixture_assignment_table(n_est),
                                  jmix.mixture_assignment_table(n_est))
    crit = {"NegThresholdedSNR": (tc.NegThresholdedSNR(), jsdr.NegThresholdedSNR()),
            "SISDR": (tc.SISDR(), jsdr.SISDR())}[name]
    result = _both(tc.MixIT(crit[0], n_est), jmix.MixIT(crit[1], n_est), est, mixtures)
    _assert_close(*result)
    np.testing.assert_array_equal(result[0][1].numpy(), route)
