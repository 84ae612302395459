"""Port's int8 quantization against the JAX package's `quantize_int8` (CPU).

On CPU tensors `quantize_int8` runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode. The deterministic mode must agree
bit for bit: int8 values and the (1, 1) scale. The CUDA kernel is held
against the plain version on the card by chip_smoke.py (phase 3f).
Stochastic rounding has no JAX reference on the CPU (the interpreter rounds
deterministically), so it is checked by its definition.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.hub import (
    conv_tasnet_state_dict_from_jax, dprnn_tasnet_state_dict_from_jax,
)
from dnn_based_source_separation_torch.models import ConvTasNet, DPRNNTasNet
from dnn_based_source_separation_torch.ops import quantize as q8
from dnn_based_source_separation_tpu.models import ConvTasNet as JConvTasNet
from dnn_based_source_separation_tpu.models import DPRNNTasNet as JDPRNNTasNet
from dnn_based_source_separation_tpu.ops import pallas_kernels as jpk

CONV = dict(n_basis=16, kernel_size=8, stride=4, enc_nonlinear="relu", sep_num_blocks=2,
            sep_num_layers=3, sep_hidden_channels=20, sep_bottleneck_channels=12,
            sep_skip_channels=12, causal=False, n_sources=2)
DPRNN = dict(n_basis=16, kernel_size=4, enc_nonlinear="relu", sep_bottleneck_channels=8,
             sep_hidden_channels=12, sep_chunk_size=10, sep_hop_size=5, sep_num_blocks=2,
             causal=False, n_sources=2)
MODELS = {
    "conv-tasnet": (CONV, JConvTasNet, ConvTasNet, conv_tasnet_state_dict_from_jax),
    "dprnn-tasnet-lstm": (dict(DPRNN, rnn_type="lstm"), JDPRNNTasNet, DPRNNTasNet,
                          dprnn_tasnet_state_dict_from_jax),
    "dprnn-tasnet-gru": (dict(DPRNN, rnn_type="gru"), JDPRNNTasNet, DPRNNTasNet,
                         dprnn_tasnet_state_dict_from_jax),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax(x):
    v, s = jpk.quantize_int8(jnp.asarray(x), interpret=True)
    return np.asarray(v), np.asarray(s)


def _assert_bitwise(x):
    v, s = _jax(x)
    q8.LAUNCHES["quantize_int8"] = 0
    pv, ps = q8.quantize_int8(torch.from_numpy(x))
    assert pv.dtype == torch.int8 and pv.shape == x.shape and ps.shape == (1, 1)
    assert np.array_equal(pv.numpy(), v)
    assert ps.numpy().tobytes() == s.astype(np.float32).tobytes()
    assert q8.LAUNCHES["quantize_int8"] == 0  # CPU tensors never reach the CUDA kernel


@pytest.mark.parametrize("shape,scale", [((37, 53), 0.3), ((256, 130), 4.0), ((1, 7), 1e-3),
                                         ((64, 1), 50.0)])
def test_deterministic_matches_jax_bit_for_bit(shape, scale):
    rng = np.random.default_rng(shape[0] + shape[1])
    _assert_bitwise((scale * rng.standard_normal(shape)).astype(np.float32))


def test_all_zero_array_takes_the_scale_floor():
    _assert_bitwise(np.zeros((3, 8), np.float32))
    _, scale = q8.quantize_int8(torch.zeros(3, 8))
    assert float(scale) == np.float32(1e-12)


def test_half_integers_of_the_scale_round_half_to_even():
    # max|x| = 127 makes the scale exactly 1, so x / scale is x itself.
    x = np.array([[127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 100.5, -64.5]],
                 np.float32)
    _assert_bitwise(x)
    values, _ = q8.quantize_int8(torch.from_numpy(x))
    assert values.tolist() == [[127, -127, 0, 2, 2, 0, -2, -2, 4, 100, -64]]


def _leaves(tree, fn):
    """Replace every {"q", "scale"} leaf of a quantized JAX tree by fn(q, scale)."""
    is_q = lambda leaf: isinstance(leaf, dict) and set(leaf) == {"q", "scale"}  # noqa: E731
    return jax.tree_util.tree_map(lambda leaf: fn(leaf["q"], leaf["scale"]) if is_q(leaf)
                                  else leaf, tree, is_leaf=is_q)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_quantize_state_dict_matches_quantize_params(name):
    config, jcls, pcls, from_jax = MODELS[name]
    jmodel = jcls(**config)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, 320), jnp.float32))["params"])
    port = pcls(**config)
    port.load_state_dict(from_jax(params, config))
    state = port.state_dict()
    qstate = q8.quantize_state_dict(state)

    jq = jpk.quantize_params(params)
    # The JAX results carried into the port's layout (transposes and
    # reshapes only): values, scales broadcast to the tensor, dequantized,
    # and which leaves JAX quantizes (its >= 2-D float32 leaves).
    j_values = from_jax(_leaves(jq, lambda v, s: np.asarray(v, np.float32)), config)
    j_scales = from_jax(
        _leaves(jq, lambda v, s: np.full(v.shape, np.asarray(s).item(), np.float32)), config)
    j_deq = from_jax(jpk.dequantize_params(jq), config)
    j_quantized = from_jax(jax.tree_util.tree_map(
        lambda leaf: np.full(leaf.shape, float(leaf.ndim >= 2), np.float32), params), config)
    deq = q8.dequantize_state_dict(qstate)
    assert list(deq) == list(state)

    quantized = [n for n, v in qstate.items() if isinstance(v, dict)]
    assert quantized == [n for n, t in j_quantized.items() if bool((t == 1).all())]
    for n in state:
        # Every tensor, quantized or passed through, equals JAX's dequantized tree.
        assert torch.equal(deq[n], j_deq[n]), n
        if n not in quantized:
            assert torch.equal(deq[n], state[n]), n
            continue
        q, scale = qstate[n]["q"], qstate[n]["scale"]
        assert q.dtype == torch.int8 and q.shape == state[n].shape and scale.shape == (1, 1)
        assert torch.equal(q.float(), j_values[n]), n
        assert float(scale) == float(j_scales[n].reshape(-1)[0]), n
    # Dequantized weights load and serve.
    port.load_state_dict(deq)
    with torch.no_grad():
        assert torch.isfinite(port(torch.randn(1, 1, 400))).all()


def test_stochastic_rounding_is_floor_or_ceil_and_unbiased():
    # 200 generator seeds over 3072 values: each q is floor(s) or ceil(s) of
    # s = x / scale; the mean of q - s over everything is 0 within 5e-3 (8
    # standard deviations of a mean of 614,400 draws, each within +-1), and
    # each value's mean over the seeds within 0.25 of s (6 standard deviations).
    rng = np.random.default_rng(3)
    x = torch.from_numpy((0.7 * rng.standard_normal((64, 48))).astype(np.float32))
    _, scale = q8.quantize_int8(x)
    s = (x / scale).double()
    draws = []
    for seed in range(200):
        values, st_scale = q8.quantize_int8(x, seed=seed, stochastic=True)
        assert torch.equal(st_scale, scale)
        q = values.double()
        assert bool(((q == torch.floor(s)) | (q == torch.ceil(s))).all())
        draws.append(q)
    q = torch.stack(draws)
    assert abs(float((q - s).mean())) <= 5e-3
    assert float((q.mean(0) - s).abs().max()) <= 0.25
    # The same seed gives the same draw; another seed another.
    assert torch.equal(q8.quantize_int8(x, seed=7, stochastic=True)[0], draws[7].to(torch.int8))
    assert not torch.equal(draws[0], draws[1])


def test_dequantize_int8_matches_jax():
    x = np.random.default_rng(4).standard_normal((5, 9)).astype(np.float32)
    v, s = _jax(x)
    got = q8.dequantize_int8(torch.from_numpy(v.copy()), torch.from_numpy(s.copy()))
    assert np.array_equal(got.numpy(), np.asarray(jpk.dequantize_int8(jnp.asarray(v),
                                                                     jnp.asarray(s))))


@pytest.mark.parametrize("bad", ["float64", "empty", "not_contiguous"])
def test_cuda_argument_checks_raise(bad):
    # `_check` guards the CUDA launch; it is pure dtype/shape logic, so it
    # can be exercised on CPU tensors.
    x = {"float64": torch.zeros(4, 4, dtype=torch.float64), "empty": torch.zeros(0, 4),
         "not_contiguous": torch.zeros(4, 6).t()}[bad]
    with pytest.raises((ValueError, TypeError)):
        q8._check(x)
    with pytest.raises(ValueError):
        q8.quantize_int8(torch.zeros(2, 2, device="meta"))
