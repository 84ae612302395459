"""Port's LSTM gradients against the JAX package's `custom_vjp` of the Pallas kernels (CPU).

The JAX side is `jax.vjp` of `lstm_scan(..., interpret=True)` and
`lstm_scan_bidir(..., interpret=True)`, whose backward is `_lstm_bwd_core`.
The port's side is `torch.autograd.grad` through its `lstm_scan` /
`lstm_scan_bidir` on CPU tensors, which run the plain forward (with cs) and
`lstm_scan_bwd_reference` inside the same autograd Functions the card runs
with its kernels (chip_smoke.py phase 3d holds the kernels against them).

Tolerances, relative to max|ref| of each gradient: f32 1e-5 (the two sides
sum the recurrent products in another order); bf16 1e-2 (hs and cs are
rounded to bf16 on both sides, a rounding that lands the other way feeds
the recomputed gates, and d_xw / d_W_hh are rounded to bf16 on the way out).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.ops import lstm_scan as ls
from dnn_based_source_separation_torch.ops.rnn import LSTM
from dnn_based_source_separation_tpu.ops import pallas_lstm as jpl

RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# (B, T, H): odd B, T=1, wider, and the cluster backward's H = 256 (musdb18 training,
# where the card takes csrc/recurrence_cluster_bwd.cuh).
SHAPES = [(5, 37, 8), (3, 1, 12), (16, 23, 32), (2, 5, 256)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed, B, T, H, chains):
    """xw ~ N(0, 1), W_hh ~ U(+-1/sqrt(H)) and a cotangent ~ N(0, 1) (non-zero everywhere)."""
    rng = np.random.default_rng(seed)
    xw = [rng.standard_normal((B, T, 4 * H)).astype(np.float32) for _ in range(chains)]
    w = [rng.uniform(-H ** -0.5, H ** -0.5, (H, 4 * H)).astype(np.float32) for _ in range(chains)]
    g = [(rng.standard_normal((B, T, H)) + 0.1).astype(np.float32) for _ in range(chains)]
    return xw, w, g


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a.astype(jnp.float32))


def _close(got, expected, dtype, what):
    ref = _f32(expected)
    assert got.dtype == dtype and tuple(got.shape) == ref.shape, (what, got.dtype, got.shape)
    err = np.abs(_f32(got) - ref).max()
    assert err <= RTOL[dtype] * np.abs(ref).max(), (what, err, np.abs(ref).max())


def _port_grads(fn, arrays, cotangents, dtype):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, leaves, [torch.from_numpy(g).to(dtype) for g in cotangents])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_lstm_scan_grad_matches_jax_custom_vjp(dtype, shape):
    (xw,), (w,), (g,) = _inputs(sum(shape), *shape, chains=1)
    j = JDTYPE[dtype]
    _, vjp = jax.vjp(lambda a, b: jpl.lstm_scan(a, b, True), jnp.asarray(xw, j), jnp.asarray(w, j))
    expected = vjp(jnp.asarray(g, j))
    ls.LAUNCHES["lstm_scan_bwd"] = 0
    got = _port_grads(ls.lstm_scan, [xw, w], [g], dtype)
    for what, a, b in zip(("d_xw", "d_whh"), got, expected):
        _close(a, b, dtype, what)
    assert ls.LAUNCHES["lstm_scan_bwd"] == 0  # CPU tensors never reach the CUDA kernel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_lstm_scan_bidir_grad_matches_jax_custom_vjp(dtype, shape):
    xw, w, g = _inputs(sum(shape) + 1, *shape, chains=2)
    j = JDTYPE[dtype]
    _, vjp = jax.vjp(lambda *a: jpl.lstm_scan_bidir(*a, True), *(jnp.asarray(a, j) for a in (*xw, *w)))
    expected = vjp(tuple(jnp.asarray(a, j) for a in g))
    got = _port_grads(ls.lstm_scan_bidir, [*xw, *w], g, dtype)
    for what, a, b in zip(("d_xw_f", "d_xw_b", "d_whh_f", "d_whh_b"), got, expected):
        _close(a, b, dtype, what)


def test_plain_backward_is_the_gradient_of_the_plain_forward_in_f64():
    # An independent check of the math: finite differences of the f64 recurrence.
    rng = np.random.default_rng(0)
    B, T, H = 2, 4, 4
    xw = torch.from_numpy(rng.standard_normal((B, T, 4 * H))).requires_grad_()
    w = torch.from_numpy(rng.uniform(-0.5, 0.5, (H, 4 * H))).requires_grad_()
    assert torch.autograd.gradcheck(ls.lstm_scan, (xw, w))
    assert torch.autograd.gradcheck(lambda a, b, c, d: ls.lstm_scan_bidir(a, b, c, d),
                                    (xw, xw.detach().flip(1).requires_grad_(), w,
                                     (w.detach() * 0.5).requires_grad_()))


def test_training_forward_writes_the_cell_state():
    # cs is the Pallas kernel's second output: compare with JAX's raw forward.
    (xw,), (w,), _ = _inputs(3, 4, 9, 8, chains=1)
    _, cs_jax = jpl._lstm_pallas_raw(jnp.asarray(xw), jnp.asarray(w), True)
    hs, cs = ls.lstm_forward_reference(torch.from_numpy(xw), torch.from_numpy(w))
    np.testing.assert_allclose(cs.numpy(), np.asarray(cs_jax), rtol=0, atol=1e-5)
    torch.testing.assert_close(hs, ls.lstm_scan_reference(torch.from_numpy(xw), torch.from_numpy(w)),
                               rtol=0, atol=0)


def test_serving_calls_stay_off_autograd():
    (xw,), (w,), _ = _inputs(4, 3, 5, 8, chains=1)
    xw, w = torch.from_numpy(xw), torch.from_numpy(w).requires_grad_()
    with torch.no_grad():
        assert ls.lstm_scan(xw, w).grad_fn is None
    assert ls.lstm_scan(xw, w).grad_fn is not None  # grad mode on and w requires grad


@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_trains_one_bias_per_chain(bidirectional):
    # JAX keeps one bias b per chain (ops/rnn.py:138); the port keeps nn.LSTM's
    # two, so bias_hh is frozen and only bias_ih receives b's gradient.
    port = LSTM(6, 8, num_layers=2, bidirectional=bidirectional,
                generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 7, 6)).astype(np.float32))
    port(x).square().sum().backward()
    for name, p in port.named_parameters():
        if name.startswith("bias_hh"):
            assert not p.requires_grad and p.grad is None, name
        else:
            assert p.requires_grad and p.grad is not None and p.grad.abs().max() > 0, name
