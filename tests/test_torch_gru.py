"""Port's GRU recurrences and GRU module against the JAX package (CPU).

On CPU tensors the port's `gru_scan` / `gru_scan_bidir` run their plain
PyTorch versions; the JAX side runs the Pallas kernel in interpret mode
(and, in f32, the `lax.scan` path too). The CUDA kernels themselves are
checked against the plain versions on the card by chip_smoke.py.

Tolerances: f32 atol 1e-5 (the two sides sum the recurrent product in a
different order, about 1e-7 apart). bf16 atol 1e-2 against Pallas: both
round h to bf16 before the product (about 4e-3 per ulp for |h| < 1), and a
rounding that lands the other way feeds every later step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.ops import gru_scan as gs
from dnn_based_source_separation_torch.ops.rnn import GRU, LSTM, choose_rnn
from dnn_based_source_separation_tpu.ops import pallas_lstm as jpl
from dnn_based_source_separation_tpu.ops import rnn as jrnn

ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
SHAPES = [(5, 37, 8), (3, 1, 12), (16, 23, 32)]  # (B, T, H): odd, T=1, wider


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scan_inputs(seed, B, T, H):
    """Two chains: xw ~ N(0, 1), W_hh ~ U(+-1/sqrt(H)), b_hh ~ N(0, 0.25)."""
    rng = np.random.default_rng(seed)
    xw = [rng.standard_normal((B, T, 3 * H)).astype(np.float32) for _ in range(2)]
    bound = 1 / np.sqrt(H)
    w = [rng.uniform(-bound, bound, (H, 3 * H)).astype(np.float32) for _ in range(2)]
    b = [(0.5 * rng.standard_normal(3 * H)).astype(np.float32) for _ in range(2)]
    return xw, w, b


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_gru_scan_bidir_matches_pallas_interpret(dtype, shape):
    xw, w, b = _scan_inputs(sum(shape), *shape)
    j = JDTYPE[dtype]
    exp_f, exp_b = jpl.gru_scan_bidir(*(jnp.asarray(a, j) for a in (*xw, *w, *b)), True)
    gs.LAUNCHES["gru_scan_bidir"] = 0
    got_f, got_b = gs.gru_scan_bidir(*(torch.from_numpy(a).to(dtype) for a in (*xw, *w, *b)))
    for got, expected in ((got_f, exp_f), (got_b, exp_b)):
        assert got.dtype == dtype and got.shape == expected.shape
        np.testing.assert_allclose(_f32(got), _f32(expected), rtol=0, atol=ATOL[dtype])
    assert gs.LAUNCHES["gru_scan_bidir"] == 0  # CPU tensors never reach the CUDA kernel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_gru_scan_matches_the_forward_chain_of_pallas_interpret(dtype, shape):
    # The Pallas package has no one-chain GRU kernel: its bidirectional
    # kernel's forward chain is the reference for gru_scan.
    xw, w, b = _scan_inputs(sum(shape) + 1, *shape)
    j = JDTYPE[dtype]
    expected, _ = jpl.gru_scan_bidir(*(jnp.asarray(a, j) for a in (*xw, *w, *b)), True)
    gs.LAUNCHES["gru_scan"] = 0
    got = gs.gru_scan(*(torch.from_numpy(a[0]).to(dtype) for a in (xw, w, b)))
    assert got.dtype == dtype and got.shape == expected.shape
    np.testing.assert_allclose(_f32(got), _f32(expected), rtol=0, atol=ATOL[dtype])
    assert gs.LAUNCHES["gru_scan"] == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_gru_scan_matches_the_lax_scan_path_in_f32(shape):
    xw, w, b = _scan_inputs(sum(shape) + 2, *shape)
    expected = jrnn._gru_scan(jnp.asarray(xw[0]), jnp.asarray(w[0]), jnp.asarray(b[0]), shape[2])
    got = gs.gru_scan(*(torch.from_numpy(a[0]) for a in (xw, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=0, atol=ATOL[torch.float32])


def test_gru_steps_continue_from_a_carried_state_as_the_lax_scan_does():
    B, T, H = 3, 11, 8
    xw, w, b = _scan_inputs(21, B, T, H)
    h0 = np.random.default_rng(22).uniform(-0.5, 0.5, (B, H)).astype(np.float32)
    expected, final = jrnn._gru_scan(jnp.asarray(xw[0]), jnp.asarray(w[0]), jnp.asarray(b[0]),
                                     H, init=jnp.asarray(h0), return_final=True)
    got, h = gs.gru_steps(*(torch.from_numpy(a[0]) for a in (xw, w, b)), torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=0, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(final), rtol=0, atol=1e-5)
    # Two calls carrying the state equal one call over the whole sequence.
    t = [torch.from_numpy(a[0]) for a in (xw, w, b)]
    first, h1 = gs.gru_steps(t[0][:, :4], t[1], t[2])
    second, h2 = gs.gru_steps(t[0][:, 4:], t[1], t[2], h1)
    whole, hw = gs.gru_steps(*t)
    torch.testing.assert_close(torch.cat([first, second], 1), whole, rtol=0, atol=0)
    torch.testing.assert_close(h2, hw, rtol=0, atol=0)


def test_bidir_reverse_chain_is_the_single_scan_of_its_input():
    # The second chain takes pre-flipped projections and returns hs in
    # reversed order: exactly gru_scan of those projections.
    xw, w, b = _scan_inputs(11, 4, 9, 8)
    t = [torch.from_numpy(a) for a in (*xw, *w, *b)]
    _, hs_b = gs.gru_scan_bidir(*t)
    torch.testing.assert_close(hs_b, gs.gru_scan(t[1], t[3], t[5]), rtol=0, atol=0)


def test_the_two_biases_are_not_interchangeable():
    # b_hh's n-part sits inside the reset gate, so moving it into xw (as the
    # LSTM may) changes the result: the plain version must keep them apart.
    xw, w, b = _scan_inputs(12, 2, 7, 8)
    xw, w, b = (torch.from_numpy(a[0]) for a in (xw, w, b))
    folded = gs.gru_scan(xw + b, w, torch.zeros_like(b))
    assert (gs.gru_scan(xw, w, b) - folded).abs().max() > 1e-3


@pytest.mark.parametrize("bad", [
    "dtype_mismatch", "bias_dtype", "float16", "shape", "bias_shape",
    "hidden_not_multiple_of_4", "not_contiguous",
])
def test_cuda_argument_checks_raise(bad):
    # `_check` guards the CUDA launch; it is pure shape/dtype logic, so it
    # can be exercised on CPU tensors.
    xw, w, b = _scan_inputs(13, 3, 5, 8)
    xw, w, b = torch.from_numpy(xw[0]), torch.from_numpy(w[0]), torch.from_numpy(b[0])
    if bad == "dtype_mismatch":
        w = w.to(torch.bfloat16)
    elif bad == "bias_dtype":
        b = b.to(torch.bfloat16)
    elif bad == "float16":
        xw, w, b = xw.half(), w.half(), b.half()
    elif bad == "shape":
        w = w[:, :-3].contiguous()
    elif bad == "bias_shape":
        b = b[:-3].contiguous()
    elif bad == "hidden_not_multiple_of_4":
        xw, w, b = torch.zeros(3, 5, 18), torch.zeros(6, 18), torch.zeros(18)
    elif bad == "not_contiguous":
        xw = xw.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((ValueError, TypeError)):
        gs._check(xw, w, b)


def test_cuda_argument_checks_accept_the_serving_layout():
    xw, w, b = _scan_inputs(14, 3, 5, 8)
    xw, w, b = torch.from_numpy(xw[0]), torch.from_numpy(w[0]), torch.from_numpy(b[0])
    gs._check(xw, w, b)
    gs._check(xw.to(torch.bfloat16), w.to(torch.bfloat16), b.to(torch.bfloat16))


def test_unsupported_device_raises():
    xw, w = torch.empty((2, 3, 24), device="meta"), torch.empty((8, 24), device="meta")
    b = torch.empty((24,), device="meta")
    with pytest.raises(ValueError):
        gs.gru_scan(xw, w, b)
    with pytest.raises(ValueError):
        gs.gru_scan_bidir(xw, xw, w, w, b, b)


def _jax_gru_params(port: GRU):
    """The JAX ops/rnn.py:GRU param dict holding the port module's weights (transposes)."""
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    out = {}
    for name, value in sd.items():
        kind, sfx = name.split("_l", 1)
        sfx = "_l" + sfx
        if kind == "weight_ih":
            out[f"w_ih{sfx}"] = value.T
        elif kind == "weight_hh":
            out[f"w_hh{sfx}"] = value.T
        else:
            out[f"b_{kind[len('bias_'):]}{sfx}"] = value
    return out


def _random_gru(F, H, num_layers, bidirectional, seed):
    port = GRU(F, H, num_layers=num_layers, bidirectional=bidirectional,
               generator=torch.Generator().manual_seed(seed)).eval()
    with torch.no_grad():  # b_ih != b_hh != 0: swapping or folding them fails
        for name, p in port.named_parameters():
            if name.startswith("bias_hh"):
                p.add_(0.5)
    return port


@pytest.mark.parametrize("pallas", ["0", "1"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_gru_module_matches_jax(monkeypatch, pallas, bidirectional):
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", pallas)
    F, H = 6, 8
    port = _random_gru(F, H, 2, bidirectional, seed=int(pallas) + 2 * bidirectional)
    x = np.random.default_rng(3).standard_normal((3, 17, F)).astype(np.float32)
    jmodel = jrnn.GRU(hidden_size=H, num_layers=2, bidirectional=bidirectional)
    expected = jmodel.apply({"params": _jax_gru_params(port)}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == expected.shape == (3, 17, H * (2 if bidirectional else 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=0, atol=1e-5)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_gru_module_matches_torch_nn_gru(bidirectional):
    # torch.nn.GRU as an independent oracle: same parameter names and shapes.
    F, H = 5, 12
    port = _random_gru(F, H, 2, bidirectional, seed=9)
    oracle = torch.nn.GRU(F, H, num_layers=2, bidirectional=bidirectional, batch_first=True)
    oracle.load_state_dict(port.state_dict())
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((4, 21, F)).astype(np.float32))
    with torch.no_grad():
        expected, _ = oracle(x)
        got = port(x)
    torch.testing.assert_close(got, expected, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cls", [LSTM, GRU])
def test_stream_carries_the_state_of_a_unidirectional_stack(cls):
    # Chunked calls carrying the state give the offline pass; torch's own
    # module, fed the same initial state, agrees on the final one.
    port = cls(5, 8, num_layers=2, generator=torch.Generator().manual_seed(5)).eval()
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 19, 5)).astype(np.float32))
    with torch.no_grad():
        whole = port(x)
        a, state = port.stream(x[:, :7])
        b, state = port.stream(x[:, 7:], state)
        oracle = (torch.nn.LSTM if cls is LSTM else torch.nn.GRU)(5, 8, num_layers=2,
                                                                   batch_first=True)
        oracle.load_state_dict(port.state_dict())
        _, final = oracle(x)
    torch.testing.assert_close(torch.cat([a, b], 1), whole, rtol=0, atol=1e-6)
    h = torch.stack([s[0] if cls is LSTM else s for s in state])
    torch.testing.assert_close(h, final[0] if cls is LSTM else final, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cls", [LSTM, GRU])
def test_stream_refuses_a_bidirectional_stack(cls):
    port = cls(4, 8, bidirectional=True)
    with pytest.raises(NotImplementedError, match="unidirectional"):
        port.stream(torch.zeros(2, 3, 4))


def test_gru_dropout_is_eval_only():
    # Dropout applies in train mode only, and there it needs the generator its masks
    # come from (tests/test_torch_musdb_train.py holds its semantics).
    port = GRU(4, 8, num_layers=2, dropout=0.25)
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="dropout generator"):
        port.train()(x)
    assert port.eval()(x).shape == (2, 3, 8)


def test_choose_rnn_builds_gru():
    rnn = choose_rnn("gru", 4, 8, bidirectional=True)
    assert isinstance(rnn, GRU) and rnn.weight_hh_l0_reverse.shape == (24, 8)
