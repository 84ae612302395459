"""Slice E's other half against the JAX package (CPU): DenseNet, TDCUNet2d, LaSAFT and its
blocks, the vision models, MultiDilatedConv2d, the complex layers, the activations and the
pools.

Random variables at the shapes `jax.eval_shape(model.init)` gives, carried into the port by
`hub/from_jax.py` (`densenet_state_dict_from_jax`, `tree_state_dict_from_jax`); JAX under
`jax.jit`; every forward at 1e-4 x max|ref| in f32, and every parameter's gradient of
sum(y * g) where the model trains (`test_torch_dense_family.py`'s helpers): DenseNet and
TDCUNet2d in train mode with their updated BatchNorm statistics, TFCLaSAFT too, the vision
models in eval mode. JAX's channels-last modules are held through `ChannelsFirst`, which
transposes at their boundary (the port works in NCHW). A port DenseNet goes through JAX's
own `convert_densenet`; DenseNet and TDCUNet2d reload through `save_model` / `load_model`.
`stochastic_pool1d` (its draws from a `torch.Generator`, JAX's from
`jax.random`: the same distribution, not the same draws): every pick lies in its window,
and its frequencies, and JAX's, are within 0.03 of the activation weights over 4000 draws
(binomial standard deviation at most 0.008).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.hub import (
    densenet_state_dict_from_jax, tree_state_dict_from_jax,
)
from dnn_based_source_separation_torch.models import DenseNet, TDCUNet2d
from dnn_based_source_separation_torch.models import lasaft, vision
from dnn_based_source_separation_torch.models.base import load_model, save_model
from dnn_based_source_separation_torch.ops import activation, complex_conv, multidilated, pool
from dnn_based_source_separation_tpu.hub.torch_convert import convert_densenet
from dnn_based_source_separation_tpu.models import cunet_choi as jcunet_choi
from dnn_based_source_separation_tpu.models import densenet as jdensenet
from dnn_based_source_separation_tpu.models import lasaft as jlasaft
from dnn_based_source_separation_tpu.models import vision as jvision
from dnn_based_source_separation_tpu.ops import activation as jactivation
from dnn_based_source_separation_tpu.ops import complex_conv as jcomplex_conv
from dnn_based_source_separation_tpu.ops import multidilated as jmultidilated
from dnn_based_source_separation_tpu.ops import pool as jpool
from test_torch_dense_family import check, check_statistics, close, held, init, spec

TOL = 1e-4  # of max|ref|
DENSENET = dict(in_channels=2, num_features=4, growth_rate=3, kernel_size=(3, 4),
                hidden_channels=5, num_blocks=2, num_layers=(2, 1))
TDC_UNET = dict(channels=(2, 3, 4, 5), control_channels=(4, 6, 8), masking=True)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class ChannelsFirst(fnn.Module):
    """A channels-last JAX module held at NCHW: its input transposed in, its output out
    (unless it is not a map)."""

    inner: fnn.Module
    map_out: bool = True

    @fnn.compact
    def __call__(self, x, *args, **kwargs):
        y = self.inner(jnp.transpose(x, (0, 2, 3, 1)), *args, **kwargs)
        return jnp.transpose(y, (0, 3, 1, 2)) if self.map_out else y


def _inner(variables):
    """The wrapped module's variables."""
    return {k: v["inner"] for k, v in variables.items()}


def _tree(variables):
    return tree_state_dict_from_jax(_inner(variables))


@pytest.mark.parametrize("stride", [(1, 1), (2, 1)])
def test_densenet_matches_jax(stride):
    config = dict(DENSENET, stride=stride)
    x = spec((2, 2, 13, 11), 1)  # odd: the pools floor
    convert = lambda v: densenet_state_dict_from_jax(v, config)  # noqa: E731
    port = DenseNet(**config)  # the train-mode gradients at one stride
    held(port, jdensenet.DenseNet(**config), convert, x, 1, grads=stride == (1, 1))
    assert port.eval()(torch.from_numpy(x)).shape == (2, 4, 3, 2)  # widths 5, then 4


def test_port_densenet_opens_through_jax_convert_densenet():
    port = DenseNet(**DENSENET, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():  # running statistics away from their start
        for name, buf in port.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
            elif name.endswith("running_mean"):
                buf.normal_(0.0, 0.3)
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    variables = convert_densenet(state, port.get_config())
    back = densenet_state_dict_from_jax(variables, port.get_config())
    for name, value in port.state_dict().items():
        assert torch.equal(back[name], value), name
    x = spec((1, 2, 9, 8), 2)
    y = jax.jit(jdensenet.DenseNet(**DENSENET).apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        close(port.eval()(torch.from_numpy(x)), y)


@pytest.mark.parametrize("cls,config", [(DenseNet, DENSENET), (TDCUNet2d, TDC_UNET)],
                         ids=["densenet", "tdc-unet"])
def test_registered_models_reload_through_load_model(tmp_path, cls, config):
    port = cls(**config, generator=torch.Generator().manual_seed(3))
    path = str(tmp_path / "model.pth")
    save_model(path, port)
    loaded = load_model(path)
    assert type(loaded) is cls and loaded.get_config() == port.get_config()
    for name, value in port.state_dict().items():
        assert torch.equal(loaded.state_dict()[name], value), name


@pytest.mark.parametrize("conditioning", ["film", "gpocm"])
def test_tdc_unet_matches_jax(conditioning):
    config = dict(TDC_UNET, conditioning=conditioning)
    x = spec((2, 2, 13, 11), 3)  # odd: the decoders pad to their skips, the output is cut
    latent = np.eye(4, dtype=np.float32)[1:3]
    jmodel = jcunet_choi.TDCUNet2d(**config)
    convert = tree_state_dict_from_jax
    variables = init(jmodel, 4, x, latent)
    port = TDCUNet2d(**config)
    port.load_state_dict(convert(variables))
    check(port, jmodel, variables, convert, x, latent, grads=False)
    if conditioning == "film":  # the training path: gradients and statistics
        updated = check(port, jmodel, variables, convert, x, latent, train=True)
        check_statistics(port, convert, variables, updated, x, latent)


def test_tfc_lasaft_matches_jax():
    x = spec((2, 3, 8, 5), 5)  # (B, C, n_bins, T)
    embedding = np.random.default_rng(5).standard_normal((2, 7)).astype(np.float32)
    jmodel = ChannelsFirst(jlasaft.TFCLaSAFT(4, 6, 8, 5, num_heads=3))
    variables = init(jmodel, 5, x, embedding)
    port = lasaft.TFCLaSAFT(3, 4, 6, 8, 5, 7, num_heads=3)
    port.load_state_dict(_tree(variables))
    check(port, jmodel, variables, _tree, x, embedding, grads=False)
    updated = check(port, jmodel, variables, _tree, x, embedding, train=True)
    check_statistics(port, _tree, variables, updated, x, embedding)


def test_lasaft_blocks_match_jax():
    x = spec((2, 3, 8, 5), 6)
    for jblock, block in ((jlasaft.TDF2d(6, nonlinear=None, use_bias=True),
                           lasaft.TDF2d(8, 6, nonlinear=None, bias=True)),
                          (jlasaft.TFC2d(4, (3, 2), num_layers=3),
                           lasaft.TFC2d(3, 4, (3, 2), num_layers=3))):
        jmodel = ChannelsFirst(jblock)
        variables = init(jmodel, 6, x)
        block.load_state_dict(_tree(variables))
        check(block, jmodel, variables, _tree, x, grads=False)
    # MultiheadTDF2d: the heads on the last dim, JAX's (B, F, T, C, H) as (B, C, F, T, H).
    jmodel = jlasaft.MultiheadTDF2d(5, num_heads=2)
    variables = init(jmodel, 7, np.transpose(x, (0, 2, 3, 1)))
    heads = lasaft.MultiheadTDF2d(8, 5, num_heads=2)
    heads.load_state_dict(tree_state_dict_from_jax(variables))
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(np.transpose(x, (0, 2, 3, 1))))
    with torch.no_grad():
        close(heads(torch.from_numpy(x)), np.transpose(np.asarray(ref), (0, 3, 1, 2, 4)))


VISION = {  # port model, JAX model (channels-last input)
    "mlp-mixer": (lambda: vision.MLPMixer(3, (8, 12), dim=8, depth=1, tokens_hidden=5,
                                          channels_hidden=7, num_classes=4),
                  jvision.MLPMixer(dim=8, depth=1, tokens_hidden=5, channels_hidden=7,
                                   num_classes=4)),
    "metaformer-overlapped": (
        lambda: vision.MetaFormer(3, patch_size=(3, 3), dim=8, depth=1, mlp_hidden=6,
                                  num_classes=4, pooling="max", overlapped_embedding=True),
        jvision.MetaFormer(patch_size=(3, 3), dim=8, depth=1, mlp_hidden=6, num_classes=4,
                           pooling="max", overlapped_embedding=True)),
    "poolformer": (lambda: vision.PoolFormer(3, dim=8, depth=1, mlp_hidden=6, num_classes=4),
                   jvision.PoolFormer(dim=8, depth=1, mlp_hidden=6, num_classes=4)),
    "poolformer-staged": (
        lambda: vision.PoolFormer(3, (2, 2), mlp_hidden=6, num_classes=4, stage_dims=(4, 8),
                                  stage_depths=(1, 1)),
        jvision.PoolFormer((2, 2), mlp_hidden=6, num_classes=4, stage_dims=(4, 8),
                           stage_depths=(1, 1))),
    "vit": (lambda: vision.ViT(3, dim=8, depth=1, num_heads=2, mlp_hidden=6, num_classes=4),
            jvision.ViT(dim=8, depth=1, num_heads=2, mlp_hidden=6, num_classes=4)),
}


@pytest.mark.parametrize("kind", list(VISION))
def test_vision_models_match_jax(kind):
    make, jmodel = VISION[kind]
    jmodel = ChannelsFirst(jmodel, map_out=False)
    x = np.random.default_rng(8).standard_normal((2, 3, 8, 12)).astype(np.float32)
    variables = init(jmodel, 8, x)
    port = make()
    port.load_state_dict(_tree(variables))
    check(port, jmodel, variables, _tree, x)


def test_mixer_block_and_pool_mixers_match_jax():
    tokens = np.random.default_rng(9).standard_normal((2, 6, 5)).astype(np.float32)
    jblock = jvision.MixerBlock(4, 7)
    variables = init(jblock, 9, tokens)
    block = vision.MixerBlock(6, 5, 4, 7)
    block.load_state_dict(tree_state_dict_from_jax(variables))
    check(block, jblock, variables, tree_state_dict_from_jax, tokens)
    grid = np.random.default_rng(10).standard_normal((2, 5, 4, 3)).astype(np.float32)
    for pool_size in (3, 4):
        close(vision.pool1d_mixer(pool_size)(torch.from_numpy(tokens)),
              jvision.pool1d_mixer(pool_size)(jnp.asarray(tokens)), 1e-6)
        close(vision.pool2d_mixer(pool_size)(torch.from_numpy(grid)),
              jvision.pool2d_mixer(pool_size)(jnp.asarray(grid)), 1e-6)


@pytest.mark.parametrize("kernel,sections", [((3, 3), 3), ((4, 3), (2, 3, 1))],
                         ids=["groups", "sections"])
def test_multidilated_conv_matches_jax(kernel, sections):
    x = np.random.default_rng(11).standard_normal((2, 6, 9, 10)).astype(np.float32)
    grouped = isinstance(sections, int)
    jmodel = ChannelsFirst(jmultidilated.MultiDilatedConv2d(
        5, kernel, in_channels=None if grouped else sections, groups=sections if grouped else None))
    variables = init(jmodel, 11, x)
    port = multidilated.MultiDilatedConv2d(6 if grouped else sections, 5, kernel,
                                           groups=sections if grouped else None)
    port.load_state_dict(_tree(variables))
    check(port, jmodel, variables, _tree, x)


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def test_complex_layers_and_activations_match_jax():
    z = _complex((2, 11, 3), 12)
    for jlayer, layer in ((jcomplex_conv.ComplexConv1d(4, 3, strides=2),
                           complex_conv.ComplexConv1d(3, 4, 3, stride=2)),
                          (jcomplex_conv.ComplexDense(5, use_bias=False),
                           complex_conv.ComplexDense(3, 5, bias=False)),
                          (jactivation.ModReLU(3), activation.ModReLU(3))):
        variables = init(jlayer, 12, z.real)
        if "bias" in variables["params"]:  # ModReLU: about |z|, so some features cut
            variables["params"]["bias"] = np.array([-1.0, 0.3, -0.2], np.float32)
        layer.load_state_dict(tree_state_dict_from_jax(variables))
        # The forward, and every parameter's gradient of sum(Re y * g_re + Im y * g_im).
        shape = jax.eval_shape(jlayer.apply, variables, jnp.asarray(z)).shape
        g = _complex(shape, 13)

        def loss(params):
            y = jlayer.apply({"params": params}, jnp.asarray(z))
            return jnp.sum(y.real * g.real + y.imag * g.imag), y

        (_, y), dp = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
        got = layer(torch.from_numpy(z))
        close(got, y)
        (got.real * torch.from_numpy(g.real) + got.imag * torch.from_numpy(g.imag)).sum().backward()
        ref = tree_state_dict_from_jax({"params": dp})
        for name, p in layer.named_parameters():
            close(p.grad, ref[name])
    for fn, jfn in ((activation.complex_relu, jactivation.complex_relu),
                    (activation.zrelu, jactivation.zrelu)):
        close(fn(torch.from_numpy(z)), jfn(jnp.asarray(z)), 0)
    close(activation.concat_relu(torch.from_numpy(z.real), dim=1),
          jactivation.concat_relu(jnp.asarray(z.real), axis=1), 0)


def test_pools_match_jax():
    x = np.random.default_rng(13).standard_normal((2, 15, 3)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    close(pool.global_avg_pool(xt), jpool.global_avg_pool(xj), 1e-6)
    close(pool.global_max_pool(xt, dim=(1, 2)), jpool.global_max_pool(xj, axis=(1, 2)), 0)
    for kernel, stride in ((3, None), (4, None), (4, 3)):  # an even kernel: two middles
        close(pool.median_pool1d(xt, kernel, stride), jpool.median_pool1d(xj, kernel, stride),
              1e-7)
    jgem = jpool.GeneralizedMeanPool(p_init=2.5)
    variables = {"params": {"p": np.float32(2.2)}}
    gem = pool.GeneralizedMeanPool()
    gem.load_state_dict(tree_state_dict_from_jax(variables))
    check(gem, jgem, variables, tree_state_dict_from_jax, x)


def test_stochastic_pool_picks_by_activation_weight():
    n = 4000
    rows = np.array([[0.0, 1.0, 3.0, -1.0, 2.0, 2.0, -1.0, -2.0, -3.0]], np.float32)
    x = np.repeat(rows[:, :, None], n, axis=0)  # (n, 9, 1): three windows of 3
    windows = rows[0].reshape(3, 3)
    w = np.maximum(windows, 0.0)
    probs = np.where(w.sum(1, keepdims=True) > 0, w / np.maximum(w.sum(1, keepdims=True),
                                                                  1e-30), 1.0 / 3)
    got = pool.stochastic_pool1d(torch.from_numpy(x), 3,
                                 torch.Generator().manual_seed(0)).numpy()[:, :, 0]
    ref = np.asarray(jpool.stochastic_pool1d(jnp.asarray(x), 3, jax.random.PRNGKey(0)))[:, :, 0]
    assert got.shape == ref.shape == (n, 3)
    for picks in (got, ref):
        for j in range(3):
            assert np.isin(picks[:, j], windows[j]).all()
            # the window's positions by value (its last window's values are distinct)
            freq = [(picks[:, j] == v).mean() for v in windows[j]]
            expect = [probs[j][windows[j] == v].sum() for v in windows[j]]
            np.testing.assert_allclose(freq, expect, atol=0.03)
