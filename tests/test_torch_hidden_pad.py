"""The LSTM wrappers' zero-padded hidden size (CPU): H = 500 run at 512, H = 300 at 384,
and sliced back.

On the card `ops/lstm_scan.py` runs LSTM-TasNet's H = 500 recurrences, forward
and backward, on the cluster kernels at H = 512, and DANet's, ADANet's and deep
clustering's H = 300 on the cluster and wide kernels at 384: `pad_chain` and
`pad_backward_chain` zero-pad xw's and W_hh's gate blocks and W_hh's rows (and
hs, cs and the cotangent's units), and `unpad_gates` / `unpad_weight_grad` slice
d_xw and d_W_hh back. Here those helpers run around the plain versions at 512,
against the plain versions at 500 (and 300) and against the JAX package's Pallas
kernels (interpret mode) and their `custom_vjp`. chip_smoke.py phases 14k, 3h-3j and
16k hold the padded kernels against the unpadded plain version on the card.

Tolerances: f32 1e-6 x max|ref| between the padded and unpadded plain versions
(the same products and zeros, summed in another blocking of the matmul); bf16
the plain version's own against Pallas, atol 1e-2 on hs and 1e-2 x max|ref| on
the gradients (a bf16 rounding that lands the other way feeds the next step).
Against JAX, f32 1e-5 x max|ref| (the recurrent sums run in another order). The
padded units' hs, cs, d_xw and d_W_hh entries are exactly 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.ops import lstm_scan as ls
from dnn_based_source_separation_tpu.ops import pallas_lstm as jpl

B, T, H, WIDTH = 2, 6, 500, 512
F32, BF16 = torch.float32, torch.bfloat16
DTYPES = pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
CHAINS = pytest.mark.parametrize("chains", [1, 2], ids=["one-chain", "two-chains"])
# (H, the width it runs at): LSTM-TasNet's, and DANet's / ADANet's / deep clustering's.
WIDTHS = pytest.mark.parametrize("hidden,width", [(H, WIDTH), (300, 384)],
                                 ids=["500-to-512", "300-to-384"])


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed, chains, dtype=F32, hidden=H):
    """chains x (xw ~ N(0, 1), W_hh ~ U(+-1/sqrt(H)), a cotangent ~ N(0.1, 1)), in `dtype`,
    at hidden size `hidden`."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(chains):
        xw = rng.standard_normal((B, T, 4 * hidden)).astype(np.float32)
        w = rng.uniform(-hidden ** -0.5, hidden ** -0.5, (hidden, 4 * hidden)).astype(np.float32)
        g = (rng.standard_normal((B, T, hidden)) + 0.1).astype(np.float32)
        out.append(tuple(torch.from_numpy(a).to(dtype) for a in (xw, w, g)))
    return out


def _rel(got, ref):
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


def test_pad_and_unpad_go_gate_block_by_gate_block():
    (xw, w, g), = _inputs(0, 1)
    xw_p, w_p = ls.pad_chain(xw, w, WIDTH)
    assert xw_p.shape == (B, T, 4 * WIDTH) and w_p.shape == (WIDTH, 4 * WIDTH)
    for q in range(4):  # gate q's H values at the head of its padded block, then zeros
        assert torch.equal(xw_p[..., q * WIDTH:q * WIDTH + H], xw[..., q * H:(q + 1) * H])
        assert not xw_p[..., q * WIDTH + H:(q + 1) * WIDTH].any()
        assert torch.equal(w_p[:H, q * WIDTH:q * WIDTH + H], w[:, q * H:(q + 1) * H])
        assert not w_p[:H, q * WIDTH + H:(q + 1) * WIDTH].any()
    assert not w_p[H:].any()  # the padded units' rows
    assert torch.equal(ls.unpad_gates(xw_p, H), xw)
    assert torch.equal(ls.unpad_weight_grad(w_p, H), w)
    assert ls.unpad_gates(xw_p, H).is_contiguous()
    padded = ls.pad_backward_chain((xw, w, g, 2 * g, 3 * g), WIDTH)
    assert torch.equal(padded[0], xw_p) and torch.equal(padded[1], w_p)
    for k, t in enumerate(padded[2:], 1):
        assert t.shape == (B, T, WIDTH) and torch.equal(t[..., :H], k * g)
        assert not t[..., H:].any()


@WIDTHS
@DTYPES
@CHAINS
def test_the_padded_plain_forward_is_the_unpadded_one(hidden, width, dtype, chains):
    H, WIDTH = hidden, width
    assert ls.cluster_width(H) == WIDTH
    inputs = _inputs(1 + chains, chains, dtype, H)
    for xw, w, _ in inputs:
        hs_ref, cs_ref = ls.lstm_forward_reference(xw, w)
        hs_p, cs_p = ls.lstm_forward_reference(*ls.pad_chain(xw, w, WIDTH))
        assert not hs_p[..., H:].any() and not cs_p[..., H:].any()  # exactly 0
        for got, ref in ((hs_p[..., :H], hs_ref), (cs_p[..., :H], cs_ref)):
            assert got.dtype == dtype and got.shape == ref.shape
            if dtype == F32:
                assert _rel(got, ref) <= 1e-6
            else:
                assert float((got.float() - ref.float()).abs().max()) <= 1e-2
    if chains == 2:  # the two-chain plain version over the padded chains
        (xf, wf, _), (xb, wb, _) = inputs
        (xf_p, wf_p), (xb_p, wb_p) = ls.pad_chain(xf, wf, WIDTH), ls.pad_chain(xb, wb, WIDTH)
        got = ls.lstm_scan_bidir_reference(xf_p, xb_p, wf_p, wb_p)
        for h_p, ref in zip(got, ls.lstm_scan_bidir_reference(xf, xb, wf, wb)):
            assert not h_p[..., H:].any()
            assert float((h_p[..., :H].float() - ref.float()).abs().max()) <= (
                1e-6 * float(ref.float().abs().max()) if dtype == F32 else 1e-2)


@WIDTHS
@DTYPES
@CHAINS
def test_the_padded_plain_backward_is_the_unpadded_one(hidden, width, dtype, chains):
    H, WIDTH = hidden, width
    for xw, w, g in _inputs(3 + chains, chains, dtype, H):
        hs, cs = ls.lstm_forward_reference(xw, w)
        d_xw_ref, d_w_ref = ls.lstm_scan_bwd_reference(xw, w, hs, cs, g)
        d_xw_p, d_w_p = ls.lstm_scan_bwd_reference(
            *ls.pad_backward_chain((xw, w, hs, cs, g), WIDTH))
        for q in range(4):  # the dropped entries: the padded units' das and their weights
            assert not d_xw_p[..., q * WIDTH + H:(q + 1) * WIDTH].any()
            assert not d_w_p[:, q * WIDTH + H:(q + 1) * WIDTH].any()
        assert not d_w_p[H:].any()
        tol = 1e-6 if dtype == F32 else 1e-2
        for got, ref in ((ls.unpad_gates(d_xw_p, H), d_xw_ref),
                         (ls.unpad_weight_grad(d_w_p, H), d_w_ref)):
            assert got.dtype == dtype and got.shape == ref.shape
            assert _rel(got, ref) <= tol


def _padded_forward(xw, w):
    """The card's padded route with the plain version in the kernel's place."""
    return ls.lstm_scan_reference(*ls.pad_chain(xw, w, WIDTH))[..., :H]


def _padded_backward(xw, w, g):
    hs, cs = (t[..., :H] for t in ls.lstm_forward_reference(*ls.pad_chain(xw, w, WIDTH)))
    d_xw, d_w = ls.lstm_scan_bwd_reference(*ls.pad_backward_chain((xw, w, hs, cs, g), WIDTH))
    return ls.unpad_gates(d_xw, H), ls.unpad_weight_grad(d_w, H)


@CHAINS
def test_the_padded_path_matches_jax_interpret_and_its_vjp(chains):
    inputs = _inputs(7, chains)
    arrays = [jnp.asarray(t.numpy()) for xw, w, _ in inputs for t in (xw, w)]
    if chains == 1:
        fn = jax.jit(lambda xw, w: jpl.lstm_scan(xw, w, True))
        outs, vjp = jax.vjp(fn, *arrays)
        outs = (outs,)
        grads = vjp(jnp.asarray(inputs[0][2].numpy()))  # d_xw, d_w
    else:
        fn = jax.jit(lambda xf, wf, xb, wb: jpl.lstm_scan_bidir(xf, xb, wf, wb, True))
        outs, vjp = jax.vjp(fn, *arrays)
        grads = vjp(tuple(jnp.asarray(g.numpy()) for *_, g in inputs))
    for (xw, w, g), out, d_xw, d_w in zip(inputs, outs, grads[0::2], grads[1::2]):
        got = (_padded_forward(xw, w), *_padded_backward(xw, w, g))
        for a, ref in zip(got, (out, d_xw, d_w)):
            ref = torch.from_numpy(np.array(ref))
            assert a.shape == ref.shape and _rel(a, ref) <= 1e-5


def test_cpu_tensors_at_h_500_never_reach_a_kernel():
    (xw, w, g), = _inputs(9, 1)
    for table in (ls.LAUNCHES, ls.PADDED_LAUNCHES):
        for name in table:
            table[name] = 0
    leaves = [xw.requires_grad_(), w.requires_grad_()]
    hs = ls.lstm_scan(*leaves)
    d_xw, d_w = torch.autograd.grad(hs, leaves, g)
    ref = ls.lstm_scan_bwd_reference(xw.detach(), w.detach(),
                                     *ls.lstm_forward_reference(xw.detach(), w.detach()), g)
    assert torch.equal(d_xw, ref[0]) and torch.equal(d_w, ref[1])
    assert not any(ls.LAUNCHES.values()) and not any(ls.PADDED_LAUNCHES.values())
