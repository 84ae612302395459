"""Port's GRU gradients against the JAX package's `custom_vjp` of the Pallas kernel (CPU).

The JAX side is `jax.vjp` of `gru_scan_bidir(..., interpret=True)`, whose
backward is `_gru_bwd_core`, and, for the one-chain `gru_scan`, `jax.vjp` of
the same core around the kernel's forward chain and `jax.vjp` through the
`lax.scan` `_gru_scan` (f32). The port's side is `torch.autograd.grad`
through its `gru_scan` / `gru_scan_bidir` on CPU tensors, which run the plain
forward and `gru_scan_bwd_reference` inside the same autograd Functions the
card runs with its kernels (chip_smoke.py phase 3e holds the kernels against
them).

Tolerances, relative to max|ref| of each gradient: f32 1e-5 (the two sides
sum the recurrent products in another order); bf16 1e-2 (hs is rounded to
bf16 on both sides, a rounding that lands the other way feeds the
recomputed gates, and d_xw, d_W_hh and d_b_hh are rounded to bf16 on the
way out).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.ops import gru_scan as gs
from dnn_based_source_separation_torch.ops.rnn import GRU
from dnn_based_source_separation_tpu.ops import pallas_lstm as jpl
from dnn_based_source_separation_tpu.ops import rnn as jrnn

RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
SHAPES = [(5, 37, 8), (3, 1, 12), (16, 23, 32)]  # (B, T, H): odd B, T=1, wider
NAMES = ("d_xw", "d_whh", "d_bhh")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed, B, T, H, chains):
    """xw ~ N(0, 1), W_hh ~ U(+-1/sqrt(H)), b_hh ~ N(0, 0.25) and a cotangent ~ N(0.1, 1)."""
    rng = np.random.default_rng(seed)
    xw = [rng.standard_normal((B, T, 3 * H)).astype(np.float32) for _ in range(chains)]
    w = [rng.uniform(-H ** -0.5, H ** -0.5, (H, 3 * H)).astype(np.float32) for _ in range(chains)]
    b = [(0.5 * rng.standard_normal(3 * H)).astype(np.float32) for _ in range(chains)]
    g = [(rng.standard_normal((B, T, H)) + 0.1).astype(np.float32) for _ in range(chains)]
    return xw, w, b, g


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


@functools.partial(jax.custom_vjp, nondiff_argnums=())
def _jax_one_chain(xw, w_hh, b_hh):
    """The Pallas kernel's forward chain as a one-chain op whose VJP is `_gru_bwd_core`."""
    return jpl._gru_bidir_pallas_raw(xw, xw, w_hh, w_hh, b_hh, b_hh, True)[0]


def _one_chain_fwd(xw, w_hh, b_hh):
    hs = _jax_one_chain(xw, w_hh, b_hh)
    return hs, (xw, w_hh, b_hh, hs)


def _one_chain_bwd(res, g):
    xw, w_hh, b_hh, hs = res
    return jpl._gru_bwd_core(xw, w_hh, b_hh, hs, g)


_jax_one_chain.defvjp(_one_chain_fwd, _one_chain_bwd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_gru_scan_bidir_grad_matches_jax_custom_vjp(dtype, shape):
    xw, w, b, g = _inputs(sum(shape), *shape, chains=2)
    j = JDTYPE[dtype]
    _, vjp = jax.vjp(lambda *a: jpl.gru_scan_bidir(*a, True),
                     *(jnp.asarray(a, j) for a in (*xw, *w, *b)))
    expected = vjp(tuple(jnp.asarray(a, j) for a in g))
    gs.LAUNCHES["gru_scan_bidir_bwd"] = 0
    got = _port_grads(gs.gru_scan_bidir, [*xw, *w, *b], g, dtype)
    for what, a, e in zip(("d_xw_f", "d_xw_b", "d_whh_f", "d_whh_b", "d_bhh_f", "d_bhh_b"),
                          got, expected):
        _close(a, e, dtype, what)
    assert gs.LAUNCHES["gru_scan_bidir_bwd"] == 0  # CPU tensors never reach the CUDA kernel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_gru_scan_grad_matches_jax_bwd_core(dtype, shape):
    (xw,), (w,), (b,), (g,) = _inputs(sum(shape) + 1, *shape, chains=1)
    j = JDTYPE[dtype]
    _, vjp = jax.vjp(_jax_one_chain, *(jnp.asarray(a, j) for a in (xw, w, b)))
    expected = vjp(jnp.asarray(g, j))
    gs.LAUNCHES["gru_scan_bwd"] = 0
    got = _port_grads(gs.gru_scan, [xw, w, b], [g], dtype)
    for what, a, e in zip(NAMES, got, expected):
        _close(a, e, dtype, what)
    assert gs.LAUNCHES["gru_scan_bwd"] == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_gru_scan_grad_matches_lax_scan_autodiff_in_f32(shape):
    (xw,), (w,), (b,), (g,) = _inputs(sum(shape) + 2, *shape, chains=1)
    _, vjp = jax.vjp(lambda a, c, d: jrnn._gru_scan(a, c, d, shape[2]),
                     *(jnp.asarray(a) for a in (xw, w, b)))
    expected = vjp(jnp.asarray(g))
    got = _port_grads(gs.gru_scan, [xw, w, b], [g], torch.float32)
    for what, a, e in zip(NAMES, got, expected):
        _close(a, e, torch.float32, what)


def test_plain_backward_is_the_gradient_of_the_plain_forward_in_f64():
    # An independent check of the math, b_hh included: finite differences of
    # the f64 recurrence.
    rng = np.random.default_rng(0)
    B, T, H = 2, 4, 4
    xw = torch.from_numpy(rng.standard_normal((B, T, 3 * H))).requires_grad_()
    w = torch.from_numpy(rng.uniform(-0.5, 0.5, (H, 3 * H))).requires_grad_()
    b = torch.from_numpy(0.5 * rng.standard_normal(3 * H)).requires_grad_()
    assert torch.autograd.gradcheck(gs.gru_scan, (xw, w, b))
    assert torch.autograd.gradcheck(
        gs.gru_scan_bidir,
        (xw, xw.detach().flip(1).requires_grad_(), w, (w.detach() * 0.5).requires_grad_(), b,
         (b.detach() - 0.2).requires_grad_()))


def test_serving_calls_stay_off_autograd():
    (xw,), (w,), (b,), _ = _inputs(4, 3, 5, 8, chains=1)
    xw, w, b = torch.from_numpy(xw), torch.from_numpy(w).requires_grad_(), torch.from_numpy(b)
    with torch.no_grad():
        assert gs.gru_scan(xw, w, b).grad_fn is None
        hs_f, hs_b = gs.gru_scan_bidir(xw, xw, w, w, b, b)
        assert hs_f.grad_fn is None and hs_b.grad_fn is None
    assert gs.gru_scan(xw, w, b).grad_fn is not None  # grad mode on and w requires grad


@pytest.mark.parametrize("bidirectional", [False, True])
def test_gru_trains_both_biases(bidirectional):
    # JAX trains b_ih and b_hh of every chain (ops/rnn.py:204-205): nothing is
    # frozen, unlike the LSTM's bias_hh.
    port = GRU(6, 8, num_layers=2, bidirectional=bidirectional,
               generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 7, 6)).astype(np.float32))
    port(x).square().sum().backward()
    for name, p in port.named_parameters():
        assert p.requires_grad and p.grad is not None and p.grad.abs().max() > 0, name
