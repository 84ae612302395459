"""Port's SDR criteria and PIT against the JAX package (CPU).

Values agree to float32 rounding: atol 1e-4 dB on losses of tens of dB
(each side sums T products in its own order). Chosen patterns must be equal.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch import criterion as tc

# The packages export functions named like these modules: load the modules themselves.
jpit = importlib.import_module("dnn_based_source_separation_tpu.criterion.pit")
jsdr = importlib.import_module("dnn_based_source_separation_tpu.criterion.sdr")

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _signals(seed, B, n, T):
    """Targets and estimates that resemble them in a shuffled order, so PIT has a clear winner."""
    rng = np.random.default_rng(seed)
    target = rng.standard_normal((B, n, T)).astype(np.float32)
    perm = np.stack([rng.permutation(n) for _ in range(B)])
    est = target[np.arange(B)[:, None], perm] + 0.5 * rng.standard_normal((B, n, T))
    return est.astype(np.float32), target


@pytest.mark.parametrize("name", ["sdr", "sisdr"])
def test_metrics_match_jax(name):
    est, target = _signals(0, 3, 2, 200)
    got = getattr(tc, name)(torch.from_numpy(est), torch.from_numpy(target))
    expected = getattr(jsdr, name)(jnp.asarray(est), jnp.asarray(target))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=0, atol=ATOL)


@pytest.mark.parametrize("cls", ["SDR", "NegSDR", "SISDR", "NegSISDR"])
@pytest.mark.parametrize("batch_mean", [True, False])
def test_criteria_match_jax(cls, batch_mean):
    est, target = _signals(1, 4, 3, 150)
    port, ref = getattr(tc, cls)(), getattr(jsdr, cls)()
    assert port.maximize == ref.maximize
    got = port(torch.from_numpy(est), torch.from_numpy(target), batch_mean=batch_mean)
    expected = ref(jnp.asarray(est), jnp.asarray(target), batch_mean=batch_mean)
    assert tuple(got.shape) == np.shape(expected)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=0, atol=ATOL)


@pytest.mark.parametrize("n_sources", [2, 3])
@pytest.mark.parametrize("batch_mean", [True, False])
@pytest.mark.parametrize("criterion", ["NegSISDR", "SISDR"])
def test_pit_matches_jax(n_sources, batch_mean, criterion):
    est, target = _signals(2 + n_sources, 5, n_sources, 120)
    np.testing.assert_array_equal(tc.permutation_table(n_sources),
                                  jpit.permutation_table(n_sources))
    loss, pattern = tc.pit(getattr(tc, criterion)(), torch.from_numpy(est),
                           torch.from_numpy(target), batch_mean=batch_mean)
    j_loss, j_pattern = jpit.pit(getattr(jsdr, criterion)(), jnp.asarray(est),
                                 jnp.asarray(target), batch_mean=batch_mean)
    np.testing.assert_allclose(loss.numpy(), np.asarray(j_loss), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(pattern.numpy(), np.asarray(j_pattern))


@pytest.mark.parametrize("n_sources", [2, 3])
def test_pit1d_loss_and_gradient_match_jax(n_sources):
    est, target = _signals(7 + n_sources, 3, n_sources, 100)
    port, ref = tc.PIT1d(tc.NegSISDR(), n_sources), jpit.PIT1d(jsdr.NegSISDR(), n_sources)
    x = torch.from_numpy(est).requires_grad_()
    loss, pattern = port(x, torch.from_numpy(target))
    loss.backward()
    j_loss, j_grad = jax.value_and_grad(lambda e: ref(e, jnp.asarray(target))[0])(jnp.asarray(est))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=0, atol=ATOL)
    g = np.asarray(j_grad)
    np.testing.assert_allclose(x.grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max())
    np.testing.assert_array_equal(pattern.numpy(), np.asarray(ref(jnp.asarray(est), jnp.asarray(target))[1]))
