"""Port's LSTM recurrences, LSTM module and dual-path chunking against the JAX package (CPU).

On CPU tensors the port's `lstm_scan` / `lstm_scan_bidir` run their plain
PyTorch versions; the JAX side runs the Pallas kernels in interpret mode
(and, in f32, the `lax.scan` path too). The CUDA kernels themselves are
checked against the plain versions on the card by chip_smoke.py.

Tolerances: f32 atol 1e-5 (the two sides sum the recurrent product in a
different order, about 1e-7 apart). bf16 atol 1e-2 against Pallas: both
round h to bf16 on write (about 4e-3 per ulp for |h| < 1), and a rounding
that lands the other way feeds the next step, so a few ulps can differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.ops import lstm_scan as ls
from dnn_based_source_separation_torch.ops import segment as tseg
from dnn_based_source_separation_torch.ops.rnn import GRU, LSTM, RNN, SRU, choose_rnn
from dnn_based_source_separation_tpu.ops import pallas_lstm as jpl
from dnn_based_source_separation_tpu.ops import rnn as jrnn
from dnn_based_source_separation_tpu.ops.segment import overlap_add as j_overlap_add
from dnn_based_source_separation_tpu.ops.segment import segment as j_segment
from dnn_based_source_separation_tpu.ops.segment import segment_padding as j_segment_padding

ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# (B, T, H): odd, T=1, wider; and one sequence at musdb18 UMX's widths (H = 256 a
# direction, 512 causal), which the card runs on the cluster kernel.
SHAPES = [(5, 37, 8), (3, 1, 12), (16, 23, 32), (1, 8, 256), (1, 8, 512)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scan_inputs(seed, B, T, H):
    rng = np.random.default_rng(seed)
    xw = [rng.standard_normal((B, T, 4 * H)).astype(np.float32) for _ in range(2)]
    bound = 1 / np.sqrt(H)
    w = [rng.uniform(-bound, bound, (H, 4 * H)).astype(np.float32) for _ in range(2)]
    return xw, w


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_lstm_scan_matches_pallas_interpret(dtype, shape):
    (xw, _), (w, _) = _scan_inputs(sum(shape), *shape)
    expected = jpl.lstm_scan(jnp.asarray(xw, JDTYPE[dtype]), jnp.asarray(w, JDTYPE[dtype]), True)
    ls.LAUNCHES["lstm_scan"] = 0
    got = ls.lstm_scan(torch.from_numpy(xw).to(dtype), torch.from_numpy(w).to(dtype))
    assert got.dtype == dtype and got.shape == expected.shape
    np.testing.assert_allclose(_f32(got), _f32(expected), rtol=0, atol=ATOL[dtype])
    assert ls.LAUNCHES["lstm_scan"] == 0  # CPU tensors never reach the CUDA kernel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_lstm_scan_bidir_matches_pallas_interpret(dtype, shape):
    xw, w = _scan_inputs(sum(shape) + 1, *shape)
    j = JDTYPE[dtype]
    exp_f, exp_b = jpl.lstm_scan_bidir(*(jnp.asarray(a, j) for a in (*xw, *w)), True)
    ls.LAUNCHES["lstm_scan_bidir"] = 0
    got_f, got_b = ls.lstm_scan_bidir(*(torch.from_numpy(a).to(dtype) for a in (*xw, *w)))
    for got, expected in ((got_f, exp_f), (got_b, exp_b)):
        assert got.dtype == dtype and got.shape == expected.shape
        np.testing.assert_allclose(_f32(got), _f32(expected), rtol=0, atol=ATOL[dtype])
    assert ls.LAUNCHES["lstm_scan_bidir"] == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_lstm_scan_matches_the_lax_scan_path_in_f32(shape):
    (xw, _), (w, _) = _scan_inputs(sum(shape) + 2, *shape)
    H = shape[2]
    expected = jrnn._lstm_scan(jnp.asarray(xw), jnp.asarray(w), H, init=(
        jnp.zeros((shape[0], H)), jnp.zeros((shape[0], H))))  # init forces the scan
    got = ls.lstm_scan(torch.from_numpy(xw), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=0, atol=ATOL[torch.float32])


def test_bidir_reverse_chain_is_the_single_scan_of_its_input():
    # The second chain takes pre-flipped gates and returns hs in reversed order:
    # exactly lstm_scan of those gates.
    xw, w = _scan_inputs(11, 4, 9, 8)
    t = [torch.from_numpy(a) for a in (*xw, *w)]
    _, hs_b = ls.lstm_scan_bidir(*t)
    torch.testing.assert_close(hs_b, ls.lstm_scan(t[1], t[3]), rtol=0, atol=0)


@pytest.mark.parametrize("bad", [
    "dtype_mismatch", "float16", "shape", "hidden_not_multiple_of_4", "not_contiguous",
])
def test_cuda_argument_checks_raise(bad):
    # `_check` guards the CUDA launch; it is pure shape/dtype logic, so it
    # can be exercised on CPU tensors.
    (xw, _), (w, _) = _scan_inputs(12, 3, 5, 8)
    xw, w = torch.from_numpy(xw), torch.from_numpy(w)
    if bad == "dtype_mismatch":
        w = w.to(torch.bfloat16)
    elif bad == "float16":
        xw, w = xw.half(), w.half()
    elif bad == "shape":
        w = w[:, :-4].contiguous()
    elif bad == "hidden_not_multiple_of_4":
        xw, w = torch.zeros(3, 5, 24), torch.zeros(6, 24)
    elif bad == "not_contiguous":
        xw = xw.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((ValueError, TypeError)):
        ls._check(xw, w)


def test_cuda_argument_checks_accept_the_serving_layout():
    (xw, _), (w, _) = _scan_inputs(13, 3, 5, 8)
    xw, w = torch.from_numpy(xw), torch.from_numpy(w)
    ls._check(xw, w)
    ls._check(xw.to(torch.bfloat16), w.to(torch.bfloat16))


def test_unsupported_device_raises():
    xw, w = torch.empty((2, 3, 32), device="meta"), torch.empty((8, 32), device="meta")
    with pytest.raises(ValueError):
        ls.lstm_scan(xw, w)
    with pytest.raises(ValueError):
        ls.lstm_scan_bidir(xw, xw, w, w)


def _jax_lstm_params(port: LSTM):
    """The JAX ops/rnn.py:LSTM param dict holding the port module's weights."""
    from dnn_based_source_separation_tpu.hub.torch_convert import lstm_params

    sd = {k: v.detach() for k, v in port.state_dict().items()}
    return lstm_params(sd, "", num_layers=port.num_layers, bidirectional=port.bidirectional)


def _random_lstm(F, H, num_layers, bidirectional, seed):
    port = LSTM(F, H, num_layers=num_layers, bidirectional=bidirectional,
                generator=torch.Generator().manual_seed(seed)).eval()
    with torch.no_grad():  # separate b_ih and b_hh, so their sum is tested
        for name, p in port.named_parameters():
            if name.startswith("bias_hh"):
                p.add_(0.5)
    return port


@pytest.mark.parametrize("pallas", ["0", "1"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_module_matches_jax(monkeypatch, pallas, bidirectional):
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", pallas)
    F, H = 6, 8
    port = _random_lstm(F, H, 2, bidirectional, seed=int(pallas) + 2 * bidirectional)
    x = np.random.default_rng(3).standard_normal((3, 17, F)).astype(np.float32)
    jmodel = jrnn.LSTM(hidden_size=H, num_layers=2, bidirectional=bidirectional)
    expected = jmodel.apply({"params": _jax_lstm_params(port)}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == expected.shape == (3, 17, H * (2 if bidirectional else 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=0, atol=1e-5)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_module_matches_torch_nn_lstm(bidirectional):
    # torch.nn.LSTM as an independent oracle: same parameter names and shapes.
    F, H = 5, 12
    port = _random_lstm(F, H, 2, bidirectional, seed=9)
    oracle = torch.nn.LSTM(F, H, num_layers=2, bidirectional=bidirectional, batch_first=True)
    oracle.load_state_dict(port.state_dict())
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((4, 21, F)).astype(np.float32))
    with torch.no_grad():
        expected, _ = oracle(x)
        got = port(x)
    torch.testing.assert_close(got, expected, rtol=0, atol=1e-5)


def test_lstm_dropout_is_eval_only():
    # Dropout applies in train mode only, and there it needs the generator its masks
    # come from (tests/test_torch_musdb_train.py holds its semantics).
    port = LSTM(4, 8, num_layers=2, dropout=0.25)
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="dropout generator"):
        port.train()(x)
    assert port.eval()(x).shape == (2, 3, 8)


def test_choose_rnn_ports_lstm_only():
    # Every type of the JAX factory is ported: LSTM, GRU, vanilla RNN and SRU; others raise.
    assert isinstance(choose_rnn("lstm", 4, 8, bidirectional=True), LSTM)
    assert isinstance(choose_rnn("gru", 4, 8), GRU)
    assert isinstance(choose_rnn("rnn", 4, 8), RNN)
    assert isinstance(choose_rnn("sru", 4, 8), SRU)
    with pytest.raises(NotImplementedError):
        choose_rnn("transformer", 4, 8)


@pytest.mark.parametrize("T,K,P", [(23, 6, 3), (40, 10, 5), (7, 7, 2), (30, 8, 4)])
def test_segment_overlap_add_and_padding_match_jax(T, K, P):
    x = np.random.default_rng(T + K).standard_normal((2, T, 5)).astype(np.float32)
    assert tseg.segment_padding(T, K, P) == j_segment_padding(T, K, P)
    pl, pr = tseg.segment_padding(T, K, P)
    xp = np.pad(x, ((0, 0), (pl, pr), (0, 0)))
    chunks = tseg.segment(torch.from_numpy(xp), K, P)
    expected = np.asarray(j_segment(jnp.asarray(xp), K, P))
    np.testing.assert_array_equal(chunks.numpy(), expected)
    np.testing.assert_allclose(tseg.overlap_add(chunks, P).numpy(),
                               np.asarray(j_overlap_add(jnp.asarray(expected), P)),
                               rtol=0, atol=1e-6)


def test_segment_refuses_a_length_off_the_chunk_grid():
    with pytest.raises(ValueError):
        tseg.segment(torch.zeros(1, 24, 3), 6, 4)
    with pytest.raises(ValueError):
        tseg.segment(torch.zeros(1, 4, 3), 6, 2)  # shorter than one chunk
