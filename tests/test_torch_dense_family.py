"""The port's 2-D dense family (MDenseNet, MMDenseNet, D3Net) against the JAX package (CPU).

Tiny widths at odd map sizes (13 x 11 and the like), so the pads to the pooling scale, the
crops of the skips and of the transposed convs' outputs, and the uneven pads of even
kernels (`kernel_size: [4, 3]`, `[2, 1]`) all act. Random weights at the JAX init's
shapes (BatchNorm statistics included), carried over by `hub/from_jax.py`; JAX under
`jax.jit`. Each model: the forward in eval mode and in train mode, the updated BatchNorm
statistics, every parameter's gradient of sum(y * g) in train mode against `jax.grad`
(the Parallel models: the eval forward, their stems being the models held above), at 1e-4 x
max|ref| in f32;
D3Net and MMDenseNet port state dicts read back through JAX's `convert_d3net` /
`convert_mm_densenet` bit for bit. A depth-8 D2Block (dilations up to 128, wider than the
map) and the single-band MDenseNet are held alone too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.hub import (
    d3net_state_dict_from_jax, m_densenet_state_dict_from_jax, mm_densenet_state_dict_from_jax,
    parallel_state_dict_from_jax,
)
from dnn_based_source_separation_torch.hub.from_jax import _dense_block
from dnn_based_source_separation_torch.models.d3net import D2Block, D3Net, ParallelD3Net
from dnn_based_source_separation_torch.models.m_densenet import MDenseNet
from dnn_based_source_separation_torch.models.mm_densenet import (
    MMDenseNet, ParallelMMDenseNet, TimeDomainWrapper,
)
from dnn_based_source_separation_tpu.hub.torch_convert import convert_d3net, convert_mm_densenet
from dnn_based_source_separation_tpu.models import d3net as jd3net
from dnn_based_source_separation_tpu.models import m_densenet as jmdense
from dnn_based_source_separation_tpu.models import mm_densenet as jmmdense

TOL = 1e-4  # of max|ref|
MMDENSE = dict(
    in_channels=2, num_features={"low": 4, "high": 5, "full": 4},
    growth_rate={"low": (3, 4, 3), "high": (2, 2, 2), "full": (3, 2, 4)},
    kernel_size={"low": (4, 3), "high": (3, 3), "full": (4, 3)}, bands=("low", "high"),
    sections=(7, 6), scale={"low": 2, "high": 2, "full": 2},
    depth={"low": (2, 1, 2), "high": (1, 2, 1), "full": (2, 1, 2)},
    growth_rate_final=3, kernel_size_final=(2, 1), depth_final=2)
D3NET = dict(
    in_channels=2, num_features={"low": 4, "middle": 3, "full": 4},
    growth_rate={"low": (3, 4, 3), "middle": (2, 2, 2), "full": (3, 2, 4)},
    kernel_size={"low": 3, "middle": 3, "full": 3}, bands=("low", "middle"), sections=(5, 8),
    scale={"low": 2, "middle": 2, "full": 2},
    num_d2blocks={"low": (2, 1, 1), "middle": (1, 1, 1), "full": (1, 2, 1)},
    depth={"low": (3, 1, 1), "middle": (1, 1, 1), "full": (1, 2, 1)},
    growth_rate_final=3, kernel_size_final=3, depth_final=2)
SOURCES = ("bass", "vocals")
ONE_STAGE = dict(depth={"low": 1, "high": 1, "middle": 1, "full": 1}, depth_final=1,
                 growth_rate={"low": (3,), "high": (2,), "middle": (2,), "full": (3,)},
                 num_d2blocks={"low": (2,), "middle": (1,), "full": (1,)})


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), np.abs(got - ref).max()


def draw(tree, rng):
    """Random variables of the shapes of `tree`: weights (2-D and up) normal over
    sqrt(fan-in), positive scales and variances, non-zero biases and means."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = draw(v, rng)
            continue
        shape = tuple(v.shape)
        if len(shape) >= 2:
            value = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif k in ("scale", "var") or k.startswith("scale_"):
            value = 0.5 + rng.random(shape)
        else:
            value = 0.2 * rng.standard_normal(shape)
        out[k] = np.asarray(value, np.float32)
    return out


def init(jmodel, seed, *inputs):
    """The model's variables, drawn at the shapes `jmodel.init` gives (`jax.eval_shape`:
    traced, not compiled; flax's initialisers take longer to compile than the model)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(seed), *map(jnp.asarray, inputs))
    return draw(jax.tree_util.tree_map(lambda a: a, dict(shapes)),
                np.random.default_rng(seed))


NULL_GRAD = 1e-5  # of the largest gradient: a gradient that is 0 but for rounding
# A gradient whose terms cancel far below the others (a recurrence's 1x1 bottleneck bias:
# one number summed over the whole map) is held to TOL x this share of the largest.
SMALL_GRAD = 1e-2


def check(port, jmodel, variables, convert, *inputs, train=False, grads=True, tol=TOL):
    """The forward and (with `grads`) every trainable parameter's gradient of sum(y * g)
    against JAX -> in train mode JAX's updated batch_stats. A bias right before a
    train-mode BatchNorm has a gradient of 0 (the batch's mean takes it out) but for
    rounding in both: it is held to NULL_GRAD x the largest gradient instead; a gradient
    below SMALL_GRAD x the largest, to TOL x that."""
    kwargs = dict(train=True, mutable=["batch_stats"]) if train else {}
    xin = tuple(map(jnp.asarray, inputs))

    def apply(p):
        out = jmodel.apply({**variables, "params": p}, *xin, **kwargs)
        return out if train else (out, None)

    if grads:  # the forward and its gradients in one compiled function
        shape = jax.eval_shape(apply, variables["params"])[0].shape
        g = np.random.default_rng(17).standard_normal(shape).astype(np.float32)

        def loss(p):
            out = apply(p)
            return jnp.sum(out[0] * g), out

        (_, (y, updated)), dp = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"])
    else:
        y, updated = jax.jit(apply)(variables["params"])
    port.train(train)
    port.zero_grad()
    got = port(*map(torch.from_numpy, inputs))
    close(got, y, tol)
    if grads:
        ref = convert({**variables, "params": dp})
        (got * torch.from_numpy(g)).sum().backward()
        largest = max(float(np.abs(np.asarray(r)).max()) for r in ref.values())
        for name, p in port.named_parameters():
            if not p.requires_grad:
                continue
            want = np.asarray(ref[name])
            if train and np.abs(want).max() <= NULL_GRAD * largest:
                assert float(p.grad.abs().max()) <= NULL_GRAD * largest, name
            else:
                err = float(np.abs(p.grad.numpy() - want).max())
                assert err <= tol * max(np.abs(want).max(), SMALL_GRAD * largest), (name, err)
    return updated


def check_statistics(port, convert, variables, updated, *inputs):
    """One train-mode forward moves the port's running statistics where flax's moved."""
    port.load_state_dict(convert(variables))
    port.train()(*map(torch.from_numpy, inputs))
    ref = convert({**variables, "batch_stats": updated["batch_stats"]})
    moved = 0
    for name, buf in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            close(buf, ref[name], 1e-5)
            moved += 1
    assert moved > 0


def held(port, jmodel, convert, x, seed, grads=True, eval_mode=True, train_mode=True):
    """The forward in eval mode (with `eval_mode`); in train mode (with `train_mode`) with its
    statistics and (with `grads`) the training path's gradients."""
    variables = init(jmodel, seed, x)
    port.load_state_dict(convert(variables))
    if eval_mode:
        check(port, jmodel, variables, convert, x, grads=False)
    if train_mode:
        updated = check(port, jmodel, variables, convert, x, train=True, grads=grads)
        check_statistics(port, convert, variables, updated, x)
    return variables


def spec(shape, seed):
    return np.abs(np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def test_mmdensenet_matches_jax():
    x = spec((2, 2, 13, 11), 11)
    convert = lambda v: mm_densenet_state_dict_from_jax(v, MMDENSE)  # noqa: E731
    # Its eval forward: test_port_state_dict_reads_back_through_jax_converters.
    held(MMDenseNet(**MMDENSE), jmmdense.MMDenseNet(**MMDENSE), convert, x, 1, eval_mode=False)


def test_parallel_mmdensenet_matches_jax():
    config = dict(MMDENSE, sources=SOURCES, depth=ONE_STAGE["depth"],
                  growth_rate=ONE_STAGE["growth_rate"])
    x = spec((2, 1, 2, 13, 9), 2)
    convert = lambda v: parallel_state_dict_from_jax(  # noqa: E731
        mm_densenet_state_dict_from_jax, v, config)
    port = ParallelMMDenseNet(**config)
    held(port, jmmdense.ParallelMMDenseNet(**config), convert, x, 2, train_mode=False)
    assert port.eval()(torch.from_numpy(x)).shape == (2, 2, 2, 13, 9)


def test_mdensenet_single_band_matches_jax():
    config = dict(in_channels=2, num_features=4, growth_rate=(3, 4, 2, 3, 3),
                  kernel_size=(4, 3), max_bin=10, depth=(2, 1, 1, 2, 1), growth_rate_final=3,
                  depth_final=2)
    x = spec((2, 2, 13, 9), 3)  # 3 bins past max_bin pass through
    convert = lambda v: m_densenet_state_dict_from_jax(v, config)  # noqa: E731
    held(MDenseNet(**config), jmdense.MDenseNet(**config), convert, x, 3)


def test_d3net_matches_jax():
    x = spec((2, 2, 13, 8), 12)
    convert = lambda v: d3net_state_dict_from_jax(v, D3NET)  # noqa: E731
    # Its eval forward: test_port_state_dict_reads_back_through_jax_converters.
    held(D3Net(**D3NET), jd3net.D3Net(**D3NET), convert, x, 4, eval_mode=False)


def test_parallel_d3net_matches_jax():
    config = dict(D3NET, sources=SOURCES, **{k: v for k, v in ONE_STAGE.items()
                                             if k != "depth_final"})
    x = spec((1, 1, 2, 13, 7), 5)
    convert = lambda v: parallel_state_dict_from_jax(  # noqa: E731
        d3net_state_dict_from_jax, v, config)
    held(ParallelD3Net(**config), jd3net.ParallelD3Net(**config), convert, x, 5,
         train_mode=False)


def test_depth8_d2block_dilates_past_the_map():
    """Dilations 1..128 over a 9 x 7 map: every layer from the fourth pads wider than the
    map, as D3Net's full band does at its deep levels."""
    x = spec((2, 3, 9, 7), 6)
    jmodel = jd3net.D2Block(growth_rate=2, kernel_size=3, depth=8)

    def convert(v):
        sd = {}
        _dense_block(sd, "block", v["params"]["dense"], v["batch_stats"]["dense"])
        return {k[len("block."):]: t for k, t in sd.items()}

    port = D2Block(3, 2, 3, depth=8)
    assert [b.conv2d.dilation for b in port.net] == [(2 ** i, 2 ** i) for i in range(8)]
    variables = init(jmodel, 6, np.transpose(x, (0, 2, 3, 1)))
    port.load_state_dict(convert(variables))
    for train in (False, True):
        kwargs = dict(train=True, mutable=["batch_stats"]) if train else {}
        out = jax.jit(lambda v, a: jmodel.apply(v, a, **kwargs))(
            variables, jnp.asarray(np.transpose(x, (0, 2, 3, 1))))
        y = out[0] if train else out
        close(port.train(train)(torch.from_numpy(x)), np.transpose(np.asarray(y), (0, 3, 1, 2)))


@pytest.mark.parametrize("kind", ["d3net", "mm-densenet"])
def test_port_state_dict_reads_back_through_jax_converters(kind):
    cls, jcls, config, convert, back = {
        "d3net": (D3Net, jd3net.D3Net, D3NET, convert_d3net, d3net_state_dict_from_jax),
        "mm-densenet": (MMDenseNet, jmmdense.MMDenseNet, MMDENSE, convert_mm_densenet,
                        mm_densenet_state_dict_from_jax)}[kind]
    port = cls(**config, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():  # running statistics away from their start
        for name, buf in port.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
            elif name.endswith("running_mean"):
                buf.normal_(0.0, 0.3)
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    variables = convert(state, port.get_config())
    sd = back(variables, port.get_config())
    for name, value in port.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(sd[name], value), name
    x = spec((1, 2, 13, 9), 8)
    y = jax.jit(jcls(**config).apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        close(port.eval()(torch.from_numpy(x)), y)


def test_time_domain_wrapper_matches_jax():
    config = dict(MMDENSE, sections=(8, 9),  # n_fft 32: 17 bins; one stage a backbone
                  growth_rate=ONE_STAGE["growth_rate"], depth=ONE_STAGE["depth"],
                  depth_final=1)
    jmodel = jmmdense.MMDenseNet(**config)
    wave = np.random.default_rng(9).standard_normal((2, 2, 300)).astype(np.float32)
    variables = init(jmodel, 9, spec((1, 2, 17, 5), 9))
    port = MMDenseNet(**config)
    port.load_state_dict(mm_densenet_state_dict_from_jax(variables, config))
    ref = jax.jit(jmmdense.TimeDomainWrapper(jmodel, variables, 32, 8))(jnp.asarray(wave))
    with torch.no_grad():
        close(TimeDomainWrapper(port.eval(), 32, 8)(torch.from_numpy(wave)), ref)
