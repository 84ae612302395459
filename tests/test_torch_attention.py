"""Port's `ops/attention.py:MultiheadAttention` against the JAX package's (CPU).

The same numpy weights (torch layout in the port, flax layout in JAX, one
transpose apart) and inputs go through both: no mask, the causal bias, a
bool mask (True = masked) and a float mask, f32 within 1e-5 x max|ref|; the
gradients of a scalar of the output with respect to the input and every
weight within 1e-5 x max|g| of each tensor (`jax.grad` under `jax.jit`).
Dropout on the attention weights draws its mask from the module's generator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.ops.attention import MultiheadAttention
from dnn_based_source_separation_torch.ops.rnn import set_dropout_generator
from dnn_based_source_separation_tpu.ops.attention import MultiheadAttention as JMHA

B, T, E, HEADS = 3, 7, 12, 3
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _weights(seed):
    rng = np.random.default_rng(seed)
    w = {"in_proj_weight": rng.standard_normal((3 * E, E)),
         "in_proj_bias": rng.standard_normal(3 * E),
         "out_proj.weight": rng.standard_normal((E, E)),
         "out_proj.bias": rng.standard_normal(E)}
    return {k: (0.3 * v).astype(np.float32) for k, v in w.items()}


def _jax_params(w):
    return {"params": {
        "in_proj": {"kernel": w["in_proj_weight"].T, "bias": w["in_proj_bias"]},
        "out_proj": {"kernel": w["out_proj.weight"].T, "bias": w["out_proj.bias"]}}}


def _masks(rng):
    return {
        "none": None,
        "bool": rng.random((T, T)) < 0.3,
        "float": (0.5 * rng.standard_normal((T, T))).astype(np.float32),
    }


def _modules(causal, seed):
    w = _weights(seed)
    port = MultiheadAttention(E, HEADS, causal=causal)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    return port, JMHA(E, HEADS, causal=causal), _jax_params(w)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), np.abs(got - ref).max()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask", ["none", "bool", "float"])
def test_forward_matches_jax(causal, mask):
    rng = np.random.default_rng(1)
    port, jmha, params = _modules(causal, seed=2)
    x = rng.standard_normal((B, T, E)).astype(np.float32)
    m = _masks(rng)[mask]
    ref = jax.jit(jmha.apply)(params, jnp.asarray(x), None if m is None else jnp.asarray(m))
    with torch.no_grad():
        got = port(torch.from_numpy(x), None if m is None else torch.from_numpy(m))
    _close(got.numpy(), ref)


def test_causal_output_ignores_the_future():
    port, _, _ = _modules(True, seed=3)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, T, E)).astype(np.float32))
    y = x.clone()
    y[:, 4:] += 1.0
    with torch.no_grad():
        torch.testing.assert_close(port(x)[:, :4], port(y)[:, :4], rtol=0, atol=1e-6)


@pytest.mark.parametrize("causal,mask", [(False, "none"), (True, "bool"), (False, "float")])
def test_gradients_match_jax(causal, mask):
    rng = np.random.default_rng(5)
    port, jmha, params = _modules(causal, seed=6)
    x = rng.standard_normal((B, T, E)).astype(np.float32)
    m = _masks(rng)[mask]
    probe = rng.standard_normal((B, T, E)).astype(np.float32)

    def jloss(p, xj):
        out = jmha.apply(p, xj, None if m is None else jnp.asarray(m))
        return jnp.sum(out * jnp.asarray(probe))

    j_params, j_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt, None if m is None else torch.from_numpy(m))
    (out * torch.from_numpy(probe)).sum().backward()
    _close(xt.grad.numpy(), j_x)
    jp = j_params["params"]
    _close(port.in_proj_weight.grad.numpy(), np.asarray(jp["in_proj"]["kernel"]).T)
    _close(port.in_proj_bias.grad.numpy(), jp["in_proj"]["bias"])
    _close(port.out_proj.weight.grad.numpy(), np.asarray(jp["out_proj"]["kernel"]).T)
    _close(port.out_proj.bias.grad.numpy(), jp["out_proj"]["bias"])


def test_parameters_are_torch_multihead_attentions():
    port = MultiheadAttention(E, HEADS, generator=torch.Generator().manual_seed(0))
    ref = torch.nn.MultiheadAttention(E, HEADS, batch_first=True)
    assert {k: v.shape for k, v in port.state_dict().items()} == \
        {k: v.shape for k, v in ref.state_dict().items()}
    # The same weights give torch's function (no mask: the packed projection and scaling).
    ref.load_state_dict(port.state_dict())
    x = torch.randn(B, T, E, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(port(x), ref(x, x, x, need_weights=False)[0],
                                   rtol=1e-5, atol=1e-6)
    assert not port.in_proj_bias.any() and not port.out_proj.bias.any()
    with pytest.raises(ValueError, match="divisible"):
        MultiheadAttention(10, 3)


def test_attention_dropout_draws_from_the_generator():
    port, _, _ = _modules(False, seed=7)
    port.attn_dropout.rate = 0.5
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((B, T, E)).astype(np.float32))
    port.train()
    with pytest.raises(ValueError, match="dropout generator"):
        port(x)
    outs = []
    for _ in range(2):
        set_dropout_generator(port, torch.Generator().manual_seed(9))
        with torch.no_grad():
            outs.append(port(x))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    port.eval()
    with torch.no_grad():
        assert not torch.equal(port(x), outs[0])
