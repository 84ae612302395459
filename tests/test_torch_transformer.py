"""Port's positional encodings and `TransformerEncoderLayer` against the JAX package's (CPU).

- `ops/attention.py:positional_encoding` (interleaved sin / cos) and GALR's
  `models/galrnet.py:_galr_positional_encoding` ([sin | cos] concatenated) equal
  JAX's bit for bit (both are host numpy in f32);
- `TransformerEncoderLayer`, post-norm and `norm_first`, relu and gelu, against
  JAX's with the same weights (the port's state dict carried into JAX by
  `hub/torch_convert.py:_transformer_layer_params`): the output within 1e-4 x
  max|ref| in f32, and the gradients of a scalar of the output for the input and
  every parameter within 1e-4 x max|g| of each tensor (`jax.grad` under `jax.jit`);
- the layer norm's form: the port's `nn.LayerNorm` centres before it squares; on
  random rows it agrees with flax's one-pass form (JAX's) to float rounding, and on
  rows of large mean and small spread, where the one-pass form cancels, the port
  stays within 1e-4 of the float64 layer, as `torch.nn.TransformerEncoderLayer`
  (the reference's own module, loaded with the same state dict) does;
- the dropout draws its masks from the module's generator, and raises without one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.models.galrnet import _galr_positional_encoding
from dnn_based_source_separation_torch.ops.attention import (
    TransformerEncoderLayer, positional_encoding,
)
from dnn_based_source_separation_torch.ops.rnn import set_dropout_generator
from dnn_based_source_separation_tpu.hub.torch_convert import _transformer_layer_params
from dnn_based_source_separation_tpu.models.galrnet import (
    _galr_positional_encoding as j_galr_positional_encoding,
)
from dnn_based_source_separation_tpu.ops.attention import (
    TransformerEncoderLayer as JTransformerEncoderLayer,
)
from dnn_based_source_separation_tpu.ops.attention import (
    positional_encoding as j_positional_encoding,
)

E, HEADS, D_FF = 16, 4, 24
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("T,F", [(1, 2), (7, 16), (250, 256), (31, 64)])
def test_interleaved_encoding_matches_jax_bit_for_bit(T, F):
    got = positional_encoding(T, F).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_positional_encoding(T, F)))
    assert got.dtype == np.float32
    angle = np.arange(T)[:, None] / 1e4 ** (np.arange(0, F, 2) / F)  # f64; the table's are f32
    np.testing.assert_allclose(got[:, 0::2], np.sin(angle), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[:, 1::2], np.cos(angle), rtol=0, atol=1e-4)


@pytest.mark.parametrize("length,dimension", [(1, 2), (79 * 32, 64), (12, 8)])
def test_galr_encoding_matches_jax_bit_for_bit(length, dimension):
    got = _galr_positional_encoding(length, dimension).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_galr_positional_encoding(length, dimension)))
    half = dimension // 2
    np.testing.assert_array_equal(got[:, half:] ** 2 + got[:, :half] ** 2 > 0.999, True)


def _layer(norm_first, nonlinear, seed=0):
    """A port layer with non-trivial weights (norm affines, biases), and JAX's params."""
    layer = TransformerEncoderLayer(E, HEADS, d_ff=D_FF, nonlinear=nonlinear,
                                    norm_first=norm_first,
                                    generator=torch.Generator().manual_seed(seed)).eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            if name.endswith("bias") or name.startswith("norm"):
                p.copy_(torch.from_numpy(0.3 * rng.standard_normal(p.shape).astype(np.float32)))
                if name.startswith("norm") and name.endswith("weight"):
                    p.add_(1.0)
    sd = {f"l.{k}": v for k, v in layer.state_dict().items()}
    params = jax.tree_util.tree_map(jnp.asarray, _transformer_layer_params(sd, "l"))
    return layer, JTransformerEncoderLayer(E, HEADS, d_ff=D_FF, nonlinear=nonlinear,
                                           norm_first=norm_first), params


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), np.abs(got - ref).max()


@pytest.mark.parametrize("nonlinear", ["relu", "gelu"])
@pytest.mark.parametrize("norm_first", [False, True], ids=["post-norm", "norm-first"])
def test_layer_and_its_gradients_match_jax(norm_first, nonlinear):
    layer, jlayer, params = _layer(norm_first, nonlinear)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 11, E)).astype(np.float32)
    weight = rng.standard_normal((3, 11, E)).astype(np.float32)

    def loss(p, x):
        return jnp.sum(jlayer.apply({"params": p}, x) * weight)

    ref = np.asarray(jax.jit(jlayer.apply)({"params": params}, jnp.asarray(x)))
    j_gp, j_gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_()
    out = layer(xt)
    _close(out.detach().numpy(), ref)
    (out * torch.from_numpy(weight)).sum().backward()
    _close(xt.grad.numpy(), np.asarray(j_gx))
    grads = _transformer_layer_params(
        {f"l.{k}": p.grad for k, p in layer.named_parameters()}, "l")
    flat = dict(jax.tree_util.tree_flatten_with_path(j_gp)[0])
    got = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert len(got) == len(flat) == 12
    for path, g in got:
        _close(g, flat[path])


def test_parameter_names_are_torchs():
    layer = TransformerEncoderLayer(E, HEADS, d_ff=D_FF)
    ref = torch.nn.TransformerEncoderLayer(E, HEADS, dim_feedforward=D_FF, batch_first=True)
    assert {k: v.shape for k, v in layer.state_dict().items()} == \
        {k: v.shape for k, v in ref.state_dict().items()}


def _rows(kind, rng):
    x = rng.standard_normal((2, 9, E))
    if kind == "large mean":  # |mean| ~ 1e3, spread ~ 1e-2: the one-pass variance cancels
        x = 1e3 * (1.0 + rng.random((2, 9, 1))) + 1e-2 * x
    return x.astype(np.float32)


@pytest.mark.parametrize("norm_first", [False, True], ids=["post-norm", "norm-first"])
@pytest.mark.parametrize("kind", ["random", "large mean"])
def test_layer_norm_is_two_pass(kind, norm_first):
    """The port (and torch's own layer, loaded with the same state dict) against the layer in
    float64; on random rows the JAX layer (flax's one-pass variance) agrees as well."""
    layer, jlayer, params = _layer(norm_first, "relu", seed=2)
    x = _rows(kind, np.random.default_rng(3))
    exact = TransformerEncoderLayer(E, HEADS, d_ff=D_FF, norm_first=norm_first).double().eval()
    exact.load_state_dict(layer.state_dict())
    ref = torch.nn.TransformerEncoderLayer(E, HEADS, dim_feedforward=D_FF, dropout=0.0,
                                           batch_first=True, norm_first=norm_first).eval()
    ref.load_state_dict(layer.state_dict())
    with torch.no_grad():
        want = exact(torch.from_numpy(x).double()).numpy()
        got = layer(torch.from_numpy(x)).numpy()
        torch_ref = ref(torch.from_numpy(x)).numpy()
    _close(got, want)
    _close(torch_ref, want)
    if kind == "random":
        _close(np.asarray(jax.jit(jlayer.apply)({"params": params}, jnp.asarray(x))), want)
    else:  # the norms see rows of large mean: the post-norm layer's first norm does
        x_norm = np.asarray(x, np.float64)
        mean = x_norm.mean(-1, keepdims=True)
        one_pass = np.maximum((x_norm.astype(np.float32) ** 2).mean(-1, keepdims=True)
                              - mean.astype(np.float32) ** 2, 0)
        two_pass = ((x_norm - mean) ** 2).mean(-1, keepdims=True)
        assert np.abs(one_pass - two_pass).max() > 10 * two_pass.max()  # it cancels


def test_dropout_draws_from_the_generator():
    layer = TransformerEncoderLayer(E, HEADS, d_ff=D_FF, dropout=0.3,
                                    generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 5, E)).astype(np.float32))
    with pytest.raises(ValueError, match="dropout generator"):
        layer(x)
    outs = []
    for _ in range(2):
        set_dropout_generator(layer, torch.Generator().manual_seed(5))
        with torch.no_grad():
            outs.append(layer(x))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    with torch.no_grad():
        assert not torch.equal(layer(x), outs[0])
        layer.eval()
        torch.testing.assert_close(layer(x), layer(x), rtol=0, atol=0)
