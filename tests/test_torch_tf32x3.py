"""The 3xTF32 route of the f32 recurrence forwards, emulated on the CPU.

On the card the f32 LSTM and GRU forwards at H a multiple of 16 up to 128
run on the tensor cores (`csrc/recurrence_tf32.cuh`): each operand x splits
into hi = tf32(x) and lo = tf32(x - hi), rounded as `cvt.rna.tf32.f32` rounds
(to nearest, ties away from zero, 10 mantissa bits), and each product is
formed as lo_h hi_W + hi_h lo_W + hi_h hi_W, small terms first, onto the
accumulator that the cell starts. Here that arithmetic runs in plain PyTorch
at the recipe's H = 128 over T = 250 steps, against a float64 recurrence (the
wrappers' plain versions on float64 inputs): three TF32 products keep the
f32 recurrence's accuracy; one does not, at the f32 limit that chip_smoke.py
holds the kernels to. The same holds for the LSTM's "wide" route
(`csrc/recurrence_wide.cuh`) at DPTNet's H = 256 over its intra-chunk T = 100.
"""
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.ops import gru_scan as gs
from dnn_based_source_separation_torch.ops import lstm_scan as ls

LSTM_TOL_F32 = 1e-4  # chip_smoke.py's LSTM_TOL[float32]: kernel vs plain, absolute
B, T, H = 64, 250, 128


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value, ties away from zero, as cvt.rna.tf32.f32 gives it:
    half an ulp of a 10-bit mantissa added to the magnitude's bits, the low 13 cut."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_product(start, h, w, passes):
    """start + h @ w with f32 sums of TF32 products: three (lo_h hi_W, then hi_h lo_W,
    then hi_h hi_W, each product of two TF32 values exact in f32) or one (hi_h hi_W)."""
    h_hi, w_hi = tf32(h), tf32(w)
    if passes == 1:
        return start + h_hi @ w_hi
    h_lo, w_lo = tf32(h - h_hi), tf32(w - w_hi)
    return ((start + h_lo @ w_hi) + h_hi @ w_lo) + h_hi @ w_hi


def lstm_route(xw, w, passes):
    """The LSTM recurrence with the tensor cores' products: gates start from xw."""
    h = torch.zeros(xw.shape[0], w.shape[0])
    c = torch.zeros_like(h)
    hs = []
    for t in range(xw.shape[1]):
        i, f, g, o = split_product(xw[:, t], h, w, passes).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def gru_route(xw, w, b, passes):
    """The GRU recurrence with the tensor cores' products: r and z start from x + b_hh,
    n from b_hn alone, so that n = tanh(x_n + r (W_hn h + b_hn))."""
    n_h = w.shape[0]
    h = torch.zeros(xw.shape[0], n_h)
    hs = []
    for t in range(xw.shape[1]):
        x = xw[:, t]
        start = torch.cat([x[:, :2 * n_h] + b[:2 * n_h], b[2 * n_h:].expand(x.shape[0], n_h)], 1)
        acc = split_product(start, h, w, passes)
        r = torch.sigmoid(acc[:, :n_h])
        z = torch.sigmoid(acc[:, n_h:2 * n_h])
        n = torch.tanh(x[:, 2 * n_h:] + r * acc[:, 2 * n_h:])
        h = (1.0 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs, dim=1)


def inputs(gates, scale, seed, shape=(B, T, H)):
    """xw ~ N(0, 0.25), W_hh ~ U(+-scale / sqrt(H)) and b_hh ~ N(0, 0.01), from a seed;
    `shape` (B, T, H)."""
    b_, t_, h_ = shape
    rng = np.random.default_rng(seed)
    xw = torch.from_numpy((0.5 * rng.standard_normal((b_, t_, gates * h_))).astype(np.float32))
    w = torch.from_numpy((scale * h_ ** -0.5 * rng.uniform(-1, 1, (h_, gates * h_)))
                         .astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(gates * h_)).astype(np.float32))
    return xw, w, b


def errors(cell, scale):
    """max |route - f64| for the exact f32 recurrence (the plain version), 3xTF32 and 1xTF32."""
    if cell == "lstm":
        xw, w, _ = inputs(4, scale, seed=7)
        f64 = ls.lstm_scan_reference(xw.double(), w.double())
        routes = {"f32": ls.lstm_scan_reference(xw, w),
                  **{p: lstm_route(xw, w, p) for p in (3, 1)}}
    else:
        xw, w, b = inputs(3, scale, seed=8)
        f64 = gs.gru_scan_reference(xw.double(), w.double(), b.double())
        routes = {"f32": gs.gru_scan_reference(xw, w, b),
                  **{p: gru_route(xw, w, b, p) for p in (3, 1)}}
    return {k: float((v.double() - f64).abs().max()) for k, v in routes.items()}


_ERRORS = {}


def cached_errors(cell, scale):
    if (cell, scale) not in _ERRORS:
        _ERRORS[(cell, scale)] = errors(cell, scale)
    return _ERRORS[(cell, scale)]


@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),  # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),  # a tie between two odd steps: away
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),  # just under the tie: down
    (1.0 + 2.0 ** -12, 1.0),
    (3.0, 3.0),  # already a TF32 value
    (0.0, 0.0),
], ids=["tie", "negative-tie", "tie-odd", "under-tie", "quarter", "exact", "zero"])
def test_tf32_rounds_to_nearest_ties_away_from_zero(x, want):
    got = tf32(torch.tensor([x], dtype=torch.float32))
    assert float(got[0]) == want


def test_the_split_holds_a_float32_within_2_to_the_minus_22():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(100_000) * 10.0 ** rng.uniform(-6, 6, 100_000))
                         .astype(np.float32))
    hi = tf32(x)
    lo = tf32(x - hi)
    for part in (hi, lo):  # TF32 values: the low 13 bits of the f32 pattern are zero
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    xd = x.double()
    assert float(((xd - hi.double()).abs() / xd.abs()).max()) <= 2.0 ** -11
    assert float(((xd - hi.double() - lo.double()).abs() / xd.abs()).max()) <= 2.0 ** -22


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("scale", [1, 4], ids=["W", "4W"])
def test_three_tf32_products_keep_the_f32_recurrences_accuracy(cell, scale):
    err = cached_errors(cell, scale)
    assert err[3] <= LSTM_TOL_F32
    assert err[3] <= 10 * err["f32"], err


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_one_tf32_product_misses_the_f32_limit_at_4w(cell):
    # Why three: one TF32 product keeps about three decimal digits, and the
    # recurrence carries its error past the f32 limit once W_hh is larger.
    err = cached_errors(cell, 4)
    assert err[1] > LSTM_TOL_F32, err
    assert err[1] > 100 * err[3], err


@pytest.mark.parametrize("scale", [1, 4], ids=["W", "4W"])
def test_three_tf32_products_keep_the_f32_limit_at_dptnets_h_256(scale):
    # The wide route's f32 product at H = 256 over T = 100 steps (DPTNet's intra-chunk
    # recurrence), B = 2: within the f32 limit and near the exact f32 recurrence's error.
    xw, w, _ = inputs(4, scale, seed=9, shape=(2, 100, 256))
    f64 = ls.lstm_scan_reference(xw.double(), w.double())
    err = {k: float((v.double() - f64).abs().max())
           for k, v in (("f32", ls.lstm_scan_reference(xw, w)), (3, lstm_route(xw, w, 3)))}
    assert err[3] <= LSTM_TOL_F32, err
    assert err[3] <= 10 * max(err["f32"], 1e-7), err
