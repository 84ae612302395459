"""The split-TF32 route of the LSTM and GRU backward recurrences, emulated on the CPU.

On the card the backward kernels at H a multiple of 16 up to 128 form the
reverse-recurrent product `dh_rec = carry + da @ W_hh^T` on the tensor cores
(`csrc/recurrence_bwd_tf32.cuh`): one accumulator per gate's block of K, the
first starting from the carry (the GRU's dh * z), each taking TF32 products
per k-step, summed at the end. With an f32 W each product is three TF32
products (lo_da hi_W, hi_da lo_W, hi_da hi_W); with a bf16 W, which is
already a TF32 value, two (lo_da W, hi_da W). Here that arithmetic runs in
plain PyTorch at the recipe's H = 128 over T = 250 steps, on the gates the
card stages (`_staged_gates`, `_staged_hidden_gates`: one addmm), against the
plain backward on float64 inputs: both splits keep d_xw and d_W_hh within the
f32 limit chip_smoke.py holds the kernels to; one TF32 product does not.
"""
import numpy as np
import pytest
import torch
from test_torch_tf32x3 import split_product, tf32

from dnn_based_source_separation_torch.ops import gru_scan as gs
from dnn_based_source_separation_torch.ops import lstm_scan as ls

BWD_TOL = 1e-4  # chip_smoke.py's BWD_TOL: f32 kernel vs plain, relative to max|plain|
B, T, H = 32, 250, 128


def exact_split_product(start, a, w):
    """start + a @ w with a bf16 W: W is a TF32 value, so two products, lo_a W then hi_a W."""
    assert torch.equal(tf32(w), w)
    a_hi = tf32(a)
    return (start + tf32(a - a_hi) @ w) + a_hi @ w


def route_product(carry, da, w_t, gates, passes):
    """carry + da (B, G H) @ w_t (G H, H) as the kernel forms it, `passes` TF32 products a
    k-step (3 or 1; 2 is the exact-W split)."""
    n_h = w_t.shape[1]
    accs = []
    for q in range(gates):
        start = carry if q == 0 else torch.zeros_like(carry)
        a, w = da[:, q * n_h:(q + 1) * n_h], w_t[q * n_h:(q + 1) * n_h]
        accs.append(exact_split_product(start, a, w) if passes == 2
                    else split_product(start, a, w, passes))
    return sum(accs[1:], accs[0])


def lstm_route(xw, w_hh, hs, cs, g_hs, passes):
    """The LSTM backward with the route's products -> (d_xw, d_W_hh), both f32 (unrounded)."""
    h_prev = ls._shifted(hs)
    gi, gf, gg, go = ls._staged_gates(xw, w_hh, h_prev).chunk(4, dim=-1)
    gi, gf, gg, go = torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg), torch.sigmoid(go)
    tc, c_prev = torch.tanh(cs.float()), ls._shifted(cs).float()
    w_t = w_hh.float().t()
    das = torch.empty(hs.shape[:2] + (4 * H,))
    dh_rec = torch.zeros(hs.shape[0], H)
    dc_rec = torch.zeros_like(dh_rec)
    for t in reversed(range(hs.shape[1])):
        i, f, g, o, c = gi[:, t], gf[:, t], gg[:, t], go[:, t], tc[:, t]
        dh = g_hs[:, t].float() + dh_rec
        dc = dc_rec + dh * o * (1.0 - c * c)
        da = torch.cat([dc * g * i * (1.0 - i), dc * c_prev[:, t] * f * (1.0 - f),
                        dc * i * (1.0 - g * g), dh * c * o * (1.0 - o)], dim=-1)
        das[:, t] = da
        dh_rec = route_product(torch.zeros_like(dh), da, w_t, 4, passes)
        dc_rec = dc * f
    return das, ls._weight_grad(h_prev, das, torch.float32)


def gru_route(xw, w_hh, b_hh, hs, g_hs, passes):
    """The GRU backward with the route's products -> (d_xw, d_W_hh, d_b_hh), f32."""
    h_prev = gs._shifted(hs)
    hw = gs._staged_hidden_gates(w_hh, b_hh, h_prev)
    x = xw.float()
    r = torch.sigmoid(x[..., :H] + hw[..., :H])
    z = torch.sigmoid(x[..., H:2 * H] + hw[..., H:2 * H])
    hn = hw[..., 2 * H:]
    n = torch.tanh(x[..., 2 * H:] + r * hn)
    hp = h_prev.float()
    w_t = w_hh.float().t()
    d_xw = torch.empty(hs.shape[:2] + (3 * H,))
    d_hw = torch.empty_like(d_xw)
    dh_rec = torch.zeros(hs.shape[0], H)
    for t in reversed(range(hs.shape[1])):
        r_t, z_t, n_t = r[:, t], z[:, t], n[:, t]
        dh = g_hs[:, t].float() + dh_rec
        dn = dh * (1.0 - z_t) * (1.0 - n_t * n_t)
        da_r, da_z = dn * hn[:, t] * r_t * (1.0 - r_t), dh * (hp[:, t] - n_t) * z_t * (1.0 - z_t)
        d_xw[:, t] = torch.cat([da_r, da_z, dn], dim=-1)
        d_hw[:, t] = torch.cat([da_r, da_z, dn * r_t], dim=-1)
        dh_rec = route_product(dh * z_t, d_hw[:, t], w_t, 3, passes)
    return (d_xw, *gs._param_grads(h_prev, d_hw, w_hh.float(), b_hh.float()))


def inputs(cell, scale, dtype, seed):
    """xw ~ N(0, 0.25), W_hh ~ U(+-scale / sqrt(H)), b_hh ~ N(0, 0.01) and g_hs ~ N(0, 1),
    rounded to `dtype`; hs (and the LSTM's cs) from the plain forward in `dtype`."""
    rng = np.random.default_rng(seed)
    gates = 4 if cell == "lstm" else 3

    def make(a):
        return torch.from_numpy(a.astype(np.float32)).to(dtype)

    xw = make(0.5 * rng.standard_normal((B, T, gates * H)))
    w = make(scale * H ** -0.5 * rng.uniform(-1, 1, (H, gates * H)))
    b = make(0.1 * rng.standard_normal(gates * H))
    g = make(rng.standard_normal((B, T, H)))
    if cell == "lstm":
        hs, cs = ls.lstm_forward_reference(xw, w)
        return xw, w, hs, cs, g
    return xw, w, b, gs.gru_scan_reference(xw, w, b), g


def errors(cell, scale, dtype):
    """{route: [max |route - f64| / max |f64| of each gradient]} for the exact f32 plain
    backward ("f32", f32 inputs only) and the route at 3 (f32 W), 2 (bf16 W) or 1 product."""
    args = inputs(cell, scale, dtype, seed=11 if cell == "lstm" else 12)
    plain, route = ((ls.lstm_scan_bwd_reference, lstm_route) if cell == "lstm"
                    else (gs.gru_scan_bwd_reference, gru_route))
    f64 = plain(*(a.double() for a in args))
    runs = {p: route(*args, p) for p in ((3, 1) if dtype == torch.float32 else (2, 1))}
    if dtype == torch.float32:
        runs["f32"] = plain(*args)
    return {k: [float((a.double() - b).abs().max() / b.abs().max()) for a, b in zip(v, f64)]
            for k, v in runs.items()}


_ERRORS = {}


def cached_errors(cell, scale, dtype):
    if (cell, scale, dtype) not in _ERRORS:
        _ERRORS[(cell, scale, dtype)] = errors(cell, scale, dtype)
    return _ERRORS[(cell, scale, dtype)]


def test_a_bf16_weight_is_a_tf32_value():
    # 8 significant bits against TF32's 11: widened to f32, every bf16 value,
    # over the whole exponent range, is its own TF32 rounding.
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(100_000) * 10.0 ** rng.uniform(-30, 30, 100_000))
                         .astype(np.float32))
    w_bf16 = x.to(torch.bfloat16)
    assert torch.equal(tf32(w_bf16.float()), w_bf16.float())
    assert not torch.equal(tf32(x), x)  # an f32 value in general is not


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("dtype,passes", [(torch.float32, 3), (torch.bfloat16, 2)],
                         ids=["f32-three-products", "bf16-two-products"])
@pytest.mark.parametrize("scale", [1, 4], ids=["W", "4W"])
def test_the_routes_split_keeps_the_f32_limit(cell, dtype, passes, scale):
    err = cached_errors(cell, scale, dtype)
    assert max(err[passes]) <= BWD_TOL, err  # d_xw, d_W_hh (and the GRU's d_b_hh)
    if dtype == torch.float32:  # as accurate as the exact f32 recurrence, within 10x
        assert all(r <= 10 * max(f, 1e-7) for r, f in zip(err[passes], err["f32"])), err


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_one_tf32_product_misses_the_f32_limit_at_4w(cell, dtype):
    # Why more than one: a single TF32 product keeps about three decimal
    # digits of da, and the reverse recurrence carries the error past the
    # limit once W_hh is larger. da is never rounded, even in bf16.
    err = cached_errors(cell, 4, dtype)
    passes = 3 if dtype == torch.float32 else 2
    assert max(err[1]) > BWD_TOL, err
    assert max(err[1]) > 10 * max(err[passes]), err


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_the_staged_gates_are_the_plain_gates(cell, dtype):
    # The card stages the gate pre-activations with one addmm; the plain
    # backward with a matmul and an add. The same value, summed in another
    # order: within a few f32 ulps of the gates' magnitude.
    xw, w, *rest = inputs(cell, 1, dtype, seed=3)
    xw, w = xw[:4, :20], w
    if cell == "lstm":
        hs = rest[0][:4, :20]
        h_prev = ls._shifted(hs)
        got, want = ls._staged_gates(xw, w, h_prev), ls._gates(xw, w, h_prev)
    else:
        b, hs = rest[0], rest[1][:4, :20]
        h_prev = gs._shifted(hs)
        got, want = gs._staged_hidden_gates(w, b, h_prev), gs._hidden_gates(w, b, h_prev)
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
