"""Port's DPTNet against the JAX package: modules, model, gradients, weights (CPU).

JAX weights (non-identity norm affines, non-zero biases) go into the port
through `hub/from_jax.py:dptnet_state_dict_from_jax`; every module of
`models/dptransformer.py` and `models/dptnet.py` runs on the same inputs as
its JAX counterpart with the same weights (the JAX sub-tree of the whole
model's), causal and not, and must agree within 1e-4 x max|ref| in f32. The
JAX references run under `jax.jit` on the `lax.scan` LSTM
(`DNNTPU_PALLAS_LSTM=0`). The gradient of a PIT SI-SDR loss for every
parameter is held to 1e-4 x max|g| of its tensor, JAX's carried into the
port's layout by the same converter (it is linear; the frozen LSTM
`bias_hh` reads as a zero gradient).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.criterion import NegSISDR, PIT1d
from dnn_based_source_separation_torch.hub import dptnet_state_dict_from_jax
from dnn_based_source_separation_torch.models import DPTNet
from dnn_based_source_separation_torch.models.base import load_model, save_model
from dnn_based_source_separation_torch.models.streaming import ExactStreamingSeparator
from dnn_based_source_separation_torch.ops.rnn import set_dropout_generator
from dnn_based_source_separation_tpu.criterion import NegSISDR as JNegSISDR
from dnn_based_source_separation_tpu.criterion import PIT1d as JPIT1d
from dnn_based_source_separation_tpu.hub.torch_convert import (
    build_from_torch_checkpoint, convert_dptnet,
)
from dnn_based_source_separation_tpu.models import DPTNet as JDPTNet
from dnn_based_source_separation_tpu.models.dptnet import (
    DualPathTransformerBlock as JBlock, ImprovedTransformer as JImprovedTransformer,
    Separator as JSeparator,
)
from dnn_based_source_separation_tpu.models.dptransformer import (
    DualPathTransformer as JDualPathTransformer,
)
from dnn_based_source_separation_tpu.models.streaming import (
    ExactStreamingSeparator as JExactStreamingSeparator,
)

TOL = 1e-4  # x max|ref|, f32
E, H, K, HEADS, BLOCKS = 8, 12, 10, 2, 2
CFG = dict(n_basis=16, kernel_size=4, stride=2, enc_nonlinear="relu",
           sep_bottleneck_channels=E, sep_hidden_channels=H, sep_chunk_size=K,
           sep_num_blocks=BLOCKS, sep_num_heads=HEADS, n_sources=2)
T = 203  # T' = 100 latent frames, off the (K=10, P=5) chunk grid: pads 5


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", "0")


def _scramble(tree, rng):
    """Non-identity norm affines and non-zero biases, so every parameter matters."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _scramble(v, rng)
            continue
        v = np.asarray(v)
        if k == "gamma":
            v = 0.5 + rng.random(v.shape)
        elif k in ("beta", "bias", "alpha") or k.startswith("b_"):
            v = 0.3 * rng.standard_normal(v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def pair():
    """(causal, mask_nonlinear) -> (config, jax model, jax variables (numpy), port model
    (eval)), each made once for the module."""
    made = {}

    def make(causal, mask_nonlinear="relu"):
        key = (causal, mask_nonlinear)
        if key not in made:
            config = dict(CFG, causal=causal, mask_nonlinear=mask_nonlinear)
            jmodel = JDPTNet(**config)
            variables = jax.jit(jmodel.init)(jax.random.PRNGKey(int(causal)),
                                             jnp.zeros((1, 1, T)))
            variables = {"params": _scramble(
                jax.tree_util.tree_map(np.asarray, variables["params"]),
                np.random.default_rng(int(causal)))}
            port = DPTNet(**config).eval()
            port.load_state_dict(dptnet_state_dict_from_jax(variables, config))
            made[key] = config, jmodel, variables, port
        return made[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DNNTPU_PALLAS_LSTM", "0")
        yield make


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max(), np.abs(got - ref).max()


def _apply(jmodule, params, x):
    return np.asarray(jax.jit(jmodule.apply)({"params": params}, jnp.asarray(x)))


def _port(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(x)).numpy()


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("part", ["intra_chunk_block", "inter_chunk_block"])
def test_improved_transformer_matches_jax(pair, causal, part):
    _, _, variables, port = pair(causal)
    params = variables["params"]["separator"]["block1"][part]
    causal_here = causal and part == "inter_chunk_block"  # the intra block is never causal
    jmodule = JImprovedTransformer(E, H, num_heads=HEADS, causal=causal_here)
    x = _x((6, 13, E), seed=1)
    _close(_port(getattr(port.separator.dptransformer.net[1], part).transformer, x),
           _apply(jmodule, params, x))


@pytest.mark.parametrize("causal", [False, True])
def test_dual_path_block_and_backbone_match_jax(pair, causal):
    _, _, variables, port = pair(causal)
    sep = variables["params"]["separator"]
    x = _x((2, 7, K, E), seed=2)  # (B, S, K, N)
    _close(_port(port.separator.dptransformer.net[0], x),
           _apply(JBlock(E, H, num_heads=HEADS, causal=causal), sep["block0"], x))
    backbone = JDualPathTransformer(E, H, num_blocks=BLOCKS, num_heads=HEADS, causal=causal)
    _close(_port(port.separator.dptransformer, x),
           _apply(backbone, {f"block{i}": sep[f"block{i}"] for i in range(BLOCKS)}, x))


@pytest.mark.parametrize("causal", [False, True])
def test_separator_matches_jax(pair, causal):
    config, _, variables, port = pair(causal)
    jsep = JSeparator(num_features=16, bottleneck_channels=E, hidden_channels=H, chunk_size=K,
                      num_blocks=BLOCKS, num_heads=HEADS, causal=causal)
    x = _x((2, 100, 16), seed=3)  # (B, T', N): pads 5 to the chunk grid
    masks = _port(port.separator, x)
    assert masks.shape == (2, 2, 100, 16)
    _close(masks, _apply(jsep, variables["params"]["separator"], x))


@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_jax(pair, causal):
    _, jmodel, variables, port = pair(causal)
    x = _x((2, 1, T), seed=4)
    got = _port(port, x)
    assert got.shape == (2, 2, T)
    _close(got, np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x))))


@pytest.mark.parametrize("mask_nonlinear", ["sigmoid", "softmax"])
def test_other_masks_match_jax(pair, mask_nonlinear):
    _, jmodel, variables, port = pair(False, mask_nonlinear)
    x = _x((1, 1, 157), seed=5)
    _close(_port(port, x), np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x))))


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax(pair, causal):
    config, jmodel, variables, port = pair(causal)
    rng = np.random.default_rng(6)
    sources = 0.3 * rng.standard_normal((2, 2, 160)).astype(np.float32)
    mixture = sources.sum(axis=1, keepdims=True)
    jcriterion = JPIT1d(JNegSISDR(), n_sources=2)

    def loss_fn(p):
        est = jmodel.apply({"params": p}, jnp.asarray(mixture))
        return jcriterion(est, jnp.asarray(sources))[0]

    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    j_grads = dptnet_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, j_grads), config)

    port.train()
    try:
        port.zero_grad()
        loss = PIT1d(NegSISDR(), n_sources=2)(port(torch.from_numpy(mixture)),
                                               torch.from_numpy(sources))[0]
        loss.backward()
    finally:
        port.eval()
    assert abs(float(loss.detach()) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    named = dict(port.named_parameters())
    assert sorted(named) == sorted(j_grads)
    for name, g in j_grads.items():
        p = named[name]
        frozen = name.rsplit(".", 1)[-1].startswith("bias_hh")
        assert (p.grad is None) == frozen, name
        got = torch.zeros_like(p) if frozen else p.grad
        _close(got.numpy(), g.numpy())
        p.grad = None


@pytest.mark.parametrize("causal", [False, True])
def test_state_dict_round_trips_the_jax_tree_bit_exactly(pair, causal):
    config, _, variables, port = pair(causal)
    back = convert_dptnet(port.state_dict(), config)
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=str(path))
    assert set(dptnet_state_dict_from_jax(variables, config)) == set(port.state_dict())


@pytest.mark.parametrize("causal", [False, True])
def test_checkpoint_reopens_in_the_port_and_in_jax(pair, tmp_path, causal):
    config, _, _, port = pair(causal)
    path = str(tmp_path / "dptnet.ckpt")
    save_model(path, port)
    loaded = load_model(path)
    assert type(loaded) is DPTNet and loaded.get_config() == port.get_config()
    x = _x((1, 1, T), seed=7)
    np.testing.assert_array_equal(_port(loaded, x), _port(port, x))
    jmodel, jparams = build_from_torch_checkpoint(path)
    _close(_port(port, x), np.asarray(jax.jit(jmodel.apply)(jparams, jnp.asarray(x))))


def test_streaming_refuses_causal_dptnet_as_jax_does(pair):
    config, jmodel, variables, port = pair(True)
    with pytest.raises(NotImplementedError, match="attention-based") as port_error:
        ExactStreamingSeparator(port, hop_samples=400)
    with pytest.raises(NotImplementedError, match="attention-based") as jax_error:
        JExactStreamingSeparator(jmodel, variables, hop_samples=400)
    assert str(port_error.value) == str(jax_error.value)


def test_generator_initialisation_is_reproducible_and_counts_as_jax(pair):
    a = DPTNet(**CFG, generator=torch.Generator().manual_seed(7))
    b = DPTNet(**CFG, generator=torch.Generator().manual_seed(7))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    _, _, variables, _ = pair(False)
    n_jax = sum(np.size(p) for p in jax.tree_util.tree_leaves(variables))
    # The port keeps nn.LSTM's two biases where JAX keeps their sum.
    n_lstm_bias = sum(p.numel() for n, p in a.named_parameters() if "bias_hh" in n)
    assert a.num_parameters() == n_jax + n_lstm_bias


def test_dropout_draws_from_the_generator():
    model = DPTNet(**dict(CFG, sep_dropout=0.5), generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x((1, 1, T), seed=8))
    model.train()
    with pytest.raises(ValueError, match="dropout generator"):
        model(x)
    outs = []
    for _ in range(2):
        set_dropout_generator(model, torch.Generator().manual_seed(3))
        with torch.no_grad():
            outs.append(model(x))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    with torch.no_grad():
        assert not torch.equal(model(x), outs[0])  # the generator moved on
        model.eval()
        torch.testing.assert_close(model(x), model(x), rtol=0, atol=0)
