"""Port's SepFormer and GALRNet against the JAX package: modules, models, gradients, weights (CPU).

JAX weights (non-identity norm affines, non-zero biases) go into the port
through `hub/from_jax.py:sepformer_state_dict_from_jax` and
`galrnet_state_dict_from_jax`. SepFormer's `_PathTransformer` and
`SepFormerBlock`, GALR's `GloballyAttentiveBlock` (low-dimension and not) and
`GALRBlock`, both separators and both models run on the same inputs as their
JAX counterparts with the same weights, causal and not, and must agree within
1e-4 x max|ref| in f32 (JAX under `jax.jit`, GALR's intra-chunk LSTM on
`lax.scan`, `DNNTPU_PALLAS_LSTM=0`). The gradients of a PIT SI-SDR loss are held
to 1e-4 x max|g| of each tensor; each state dict round-trips JAX's tree bit for
bit through `convert_sepformer` / `convert_galrnet`; a port checkpoint reopens in
the port and, through `build_from_torch_checkpoint`, in JAX. Exact streaming
refuses both models with JAX's exception and message. The recipe configs'
parameter counts match `jax.eval_shape` of JAX's models.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.criterion import NegSISDR, PIT1d
from dnn_based_source_separation_torch.hub import (
    galrnet_state_dict_from_jax, sepformer_state_dict_from_jax,
)
from dnn_based_source_separation_torch.models import GALRNet, SepFormer
from dnn_based_source_separation_torch.models import galr as port_galr
from dnn_based_source_separation_torch.models.base import load_model, save_model
from dnn_based_source_separation_torch.models.galrnet import Separator as GALRSeparator
from dnn_based_source_separation_torch.models.sepformer import Separator as SepSeparator
from dnn_based_source_separation_torch.models.streaming import ExactStreamingSeparator
from dnn_based_source_separation_torch.ops.rnn import set_dropout_generator
from dnn_based_source_separation_tpu.criterion import NegSISDR as JNegSISDR
from dnn_based_source_separation_tpu.criterion import PIT1d as JPIT1d
from dnn_based_source_separation_tpu.hub.torch_convert import (
    build_from_torch_checkpoint, convert_galrnet, convert_sepformer,
)
from dnn_based_source_separation_tpu.models import GALRNet as JGALRNet
from dnn_based_source_separation_tpu.models import SepFormer as JSepFormer
from dnn_based_source_separation_tpu.models.galr import (
    GALRBlock as JGALRBlock, GloballyAttentiveBlock as JGloballyAttentiveBlock,
)
from dnn_based_source_separation_tpu.models.galrnet import Separator as JGALRSeparator
from dnn_based_source_separation_tpu.models.sepformer import Separator as JSepSeparator
from dnn_based_source_separation_tpu.models.sepformer import SepFormerBlock as JSepFormerBlock
from dnn_based_source_separation_tpu.models.sepformer import _PathTransformer as JPath
from dnn_based_source_separation_tpu.models.streaming import (
    ExactStreamingSeparator as JExactStreamingSeparator,
)

TOL = 1e-4  # x max|ref|, f32
N, E, K, P, HEADS, D_FF = 16, 8, 10, 5, 2, 16
SEPFORMER = dict(n_basis=N, kernel_size=4, stride=2, sep_bottleneck_channels=E,
                 sep_chunk_size=K, sep_hop_size=P, sep_num_blocks=2, sep_num_layers_intra=2,
                 sep_num_layers_inter=1, sep_num_heads_intra=HEADS, sep_num_heads_inter=HEADS,
                 sep_d_ff_intra=D_FF, sep_d_ff_inter=12, n_sources=2)
H, Q = 16, 4
GALRNET = dict(n_basis=N, kernel_size=4, stride=2, sep_hidden_channels=H, sep_chunk_size=K,
               sep_hop_size=P, sep_num_blocks=2, sep_num_heads=HEADS, n_sources=2)
T = 203  # T' = 100 latent frames, off the (K=10, P=5) chunk grid: pads 5
MODELS = {"sepformer": (SepFormer, JSepFormer, SEPFORMER, sepformer_state_dict_from_jax,
                        convert_sepformer),
          "galrnet": (GALRNet, JGALRNet, GALRNET, galrnet_state_dict_from_jax, convert_galrnet)}


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
        if k in ("gamma", "scale"):
            v = 0.5 + rng.random(v.shape)
        elif k in ("beta", "bias", "alpha") or k.startswith("b_"):
            v = 0.3 * rng.standard_normal(v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def pair():
    """(model, causal, extra config) -> (config, jax model, jax variables (numpy), port model
    (eval)), each made once for the module."""
    made = {}

    def make(model, causal, **extra):
        cls, jcls, base, from_jax, _ = MODELS[model]
        config = dict(base, causal=causal, **{k: v for k, v in extra.items() if v is not None})
        key = (model, tuple(sorted(config.items())))
        if key not in made:
            jmodel = jcls(**config)
            variables = jax.jit(jmodel.init)(jax.random.PRNGKey(len(made)), jnp.zeros((1, 1, T)))
            variables = {"params": _scramble(
                jax.tree_util.tree_map(np.asarray, variables["params"]),
                np.random.default_rng(len(made)))}
            port = cls(**config).eval()
            port.load_state_dict(from_jax(variables, config))
            made[key] = config, jmodel, variables, port
        return made[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DNNTPU_PALLAS_LSTM", "0")
        yield make


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), np.abs(got - ref).max()


def _apply(jmodule, params, x):
    return np.asarray(jax.jit(jmodule.apply)({"params": params}, jnp.asarray(x)))


def _port(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(x)).numpy()


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# -- SepFormer's modules -------------------------------------------------------------------

@pytest.mark.parametrize("path,layers,d_ff", [("intra_transformer", 2, D_FF),
                                               ("inter_transformer", 1, 12)])
def test_path_transformer_matches_jax(pair, path, layers, d_ff):
    _, _, variables, port = pair("sepformer", False)
    params = variables["params"]["separator"]["block1"][path]
    x = _x((6, 13, E), seed=1)
    module = getattr(port.separator.dptransformer.net[1], path)
    _close(_port(module, x), _apply(JPath(E, layers, HEADS, d_ff), params, x))


@pytest.mark.parametrize("causal", [False, True])
def test_sepformer_block_matches_jax(pair, causal):
    _, _, variables, port = pair("sepformer", causal)
    x = _x((2, 7, K, E), seed=2)  # (B, S, K, N)
    jblock = JSepFormerBlock(E, num_layers_intra=2, num_layers_inter=1, num_heads_intra=HEADS,
                             num_heads_inter=HEADS, d_ff_intra=D_FF, d_ff_inter=12,
                             causal=causal)
    _close(_port(port.separator.dptransformer.net[0], x),
           _apply(jblock, variables["params"]["separator"]["block0"], x))


# -- GALR's modules ------------------------------------------------------------------------

@pytest.mark.parametrize("down", [Q, None], ids=["low-dimension", "full"])
@pytest.mark.parametrize("causal", [False, True])
def test_globally_attentive_block_matches_jax(pair, causal, down):
    _, _, variables, port = pair("galrnet", causal, sep_down_chunk_size=down)
    params = variables["params"]["separator"]["galr"]["block1"]["inter_chunk_block"]
    assert ("fc_map" in params) == (down is not None)
    x = _x((2, 7, K, N), seed=3)
    jblock = JGloballyAttentiveBlock(N, chunk_size=K, down_chunk_size=down, num_heads=HEADS,
                                     causal=causal)
    _close(_port(port.separator.galr.net[1].inter_chunk_block, x), _apply(jblock, params, x))


@pytest.mark.parametrize("causal", [False, True])
def test_galr_block_matches_jax(pair, causal):
    _, _, variables, port = pair("galrnet", causal, sep_down_chunk_size=Q)
    x = _x((2, 7, K, N), seed=4)
    jblock = JGALRBlock(N, H, num_heads=HEADS, chunk_size=K, down_chunk_size=Q, causal=causal)
    _close(_port(port.separator.galr.net[0], x),
           _apply(jblock, variables["params"]["separator"]["galr"]["block0"], x))
    assert port_galr.GALRBlock is type(port.separator.galr.net[0])
    assert port_galr.LocallyRecurrentBlock is type(port.separator.galr.net[0].intra_chunk_block)


# -- both models ---------------------------------------------------------------------------

CASES = [("sepformer", {}), ("galrnet", {"sep_down_chunk_size": Q}), ("galrnet", {})]
IDS = ["sepformer", "galrnet-low-dimension", "galrnet-full"]


def _jseparator(model, config):
    if model == "sepformer":
        return JSepSeparator(num_features=N, bottleneck_channels=E, chunk_size=K, hop_size=P,
                             num_blocks=2, num_layers_intra=2, num_layers_inter=1,
                             num_heads_intra=HEADS, num_heads_inter=HEADS, d_ff_intra=D_FF,
                             d_ff_inter=12, causal=config["causal"])
    return JGALRSeparator(num_features=N, hidden_channels=H, chunk_size=K, hop_size=P,
                          down_chunk_size=config.get("sep_down_chunk_size"), num_blocks=2,
                          num_heads=HEADS, causal=config["causal"])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("model,extra", CASES, ids=IDS)
def test_separator_matches_jax(pair, model, extra, causal):
    config, _, variables, port = pair(model, causal, **extra)
    assert isinstance(port.separator, SepSeparator if model == "sepformer" else GALRSeparator)
    x = _x((2, 100, N), seed=5)  # (B, T', N): pads 5 to the chunk grid
    masks = _port(port.separator, x)
    assert masks.shape == (2, 2, 100, N)
    _close(masks, _apply(_jseparator(model, config), variables["params"]["separator"], x))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("model,extra", CASES, ids=IDS)
def test_forward_matches_jax(pair, model, extra, causal):
    _, jmodel, variables, port = pair(model, causal, **extra)
    x = _x((2, 1, T), seed=6)
    got = _port(port, x)
    assert got.shape == (2, 2, T)
    _close(got, np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x))))


@pytest.mark.parametrize("model", ["sepformer", "galrnet"])
def test_other_masks_match_jax(pair, model):
    _, jmodel, variables, port = pair(model, False, mask_nonlinear="softmax")
    x = _x((1, 1, 157), seed=7)
    _close(_port(port, x), np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x))))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("model,extra", CASES[:2], ids=IDS[:2])
def test_gradients_match_jax(pair, model, extra, causal):
    config, jmodel, variables, port = pair(model, causal, **extra)
    from_jax = MODELS[model][3]
    rng = np.random.default_rng(8)
    sources = 0.3 * rng.standard_normal((2, 2, 160)).astype(np.float32)
    mixture = sources.sum(axis=1, keepdims=True)
    jcriterion = JPIT1d(JNegSISDR(), n_sources=2)

    def loss_fn(p):
        est = jmodel.apply({"params": p}, jnp.asarray(mixture))
        return jcriterion(est, jnp.asarray(sources))[0]

    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    j_grads = from_jax(jax.tree_util.tree_map(np.asarray, j_grads), config)
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
    scale = max(float(g.abs().max()) for g in j_grads.values())
    for name, g in j_grads.items():
        p = named[name]
        frozen = name.rsplit(".", 1)[-1].startswith("bias_hh")
        assert (p.grad is None) == frozen, name
        got = (torch.zeros_like(p) if frozen else p.grad).numpy()
        if name.endswith("fc_map.bias"):
            # 0 but for rounding in both: the LayerNorm over the channels that follows
            # `fc_map` removes a constant added to every channel of a position.
            assert max(np.abs(got).max(), float(g.abs().max())) <= 1e-6 * scale, name
        else:
            _close(got, g.numpy())
        p.grad = None


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("model,extra", CASES, ids=IDS)
def test_state_dict_round_trips_the_jax_tree_bit_exactly(pair, model, extra, causal):
    config, _, variables, port = pair(model, causal, **extra)
    back = MODELS[model][4](port.state_dict(), dict(config, low_dimension="sep_down_chunk_size"
                                                    in extra))
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=str(path))
    assert set(MODELS[model][3](variables, config)) == set(port.state_dict())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("model,extra", CASES[:2], ids=IDS[:2])
def test_checkpoint_reopens_in_the_port_and_in_jax(pair, tmp_path, model, extra, causal):
    _, _, _, port = pair(model, causal, **extra)
    path = str(tmp_path / f"{model}.ckpt")
    save_model(path, port)
    loaded = load_model(path)
    assert type(loaded) is type(port) and loaded.get_config() == port.get_config()
    x = _x((1, 1, T), seed=9)
    np.testing.assert_array_equal(_port(loaded, x), _port(port, x))
    jmodel, jparams = build_from_torch_checkpoint(path)
    assert type(jmodel) is MODELS[model][1] and jmodel.causal == causal
    _close(_port(port, x), np.asarray(jax.jit(jmodel.apply)(jparams, jnp.asarray(x))))


@pytest.mark.parametrize("model", ["sepformer", "galrnet"])
def test_streaming_refusals_match_jax(pair, model):
    for causal, error in ((True, NotImplementedError), (False, ValueError)):
        _, jmodel, variables, port = pair(model, causal)
        with pytest.raises(error) as port_error:
            ExactStreamingSeparator(port, hop_samples=400)
        with pytest.raises(error) as jax_error:
            JExactStreamingSeparator(jmodel, variables, hop_samples=400)
        assert str(port_error.value) == str(jax_error.value)
        assert causal == ("attention-based" in str(port_error.value))


def test_sepformer_dropout_draws_from_the_generator():
    model = SepFormer(**dict(SEPFORMER, sep_dropout=0.5),
                      generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x((1, 1, T), seed=10))
    model.train()
    with pytest.raises(ValueError, match="dropout generator"):
        model(x)
    outs = []
    for _ in range(2):
        set_dropout_generator(model, torch.Generator().manual_seed(3))
        with torch.no_grad():
            outs.append(model(x))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


@pytest.mark.parametrize("model", ["sepformer", "galrnet"])
def test_generator_initialisation_and_parameter_count(pair, model):
    cls, _, base, _, _ = MODELS[model]
    a = cls(**base, generator=torch.Generator().manual_seed(7))
    b = cls(**base, generator=torch.Generator().manual_seed(7))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    _, _, variables, port = pair(model, False)
    n_lstm_bias = sum(p.numel() for n, p in port.named_parameters() if "bias_hh" in n)
    assert port.num_parameters() == sum(np.size(p) for p in
                                        jax.tree_util.tree_leaves(variables)) + n_lstm_bias


# The recipes: egs/wsj0-mix/sepformer/train.sh and egs/wsj0-mix/galrnet/train.sh through the
# factory's arguments.
RECIPES = {
    "sepformer": dict(n_basis=256, kernel_size=16, sep_bottleneck_channels=256,
                      sep_chunk_size=250, sep_hop_size=125, sep_num_blocks=2,
                      sep_num_layers_intra=8, sep_num_layers_inter=8, sep_num_heads_intra=8,
                      sep_num_heads_inter=8, mask_nonlinear="relu"),
    "galrnet": dict(n_basis=64, kernel_size=16, sep_hidden_channels=128, sep_chunk_size=100,
                    sep_hop_size=50, sep_down_chunk_size=32, sep_num_blocks=6, sep_num_heads=8,
                    mask_nonlinear="relu"),
}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("model", ["sepformer", "galrnet"])
def test_recipe_parameter_count_matches_jax(model, causal):
    cls, jcls = MODELS[model][:2]
    config = dict(RECIPES[model], causal=causal)
    shapes = jax.eval_shape(jcls(**config).init, jax.random.PRNGKey(0), jnp.zeros((1, 1, 800)))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    port = cls(**config, device="meta")
    n_lstm_bias = sum(p.numel() for n, p in port.named_parameters() if "bias_hh" in n)
    assert port.num_parameters() == n_jax + n_lstm_bias
