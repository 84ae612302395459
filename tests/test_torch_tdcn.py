"""Port's TDCN blocks against the JAX package with the same weights (CPU).

Weights go from the JAX tree to the port through
`hub/from_jax.py:conv_tasnet_state_dict_from_jax`, by wrapping the block's
tree in a model-level tree and keeping the keys under the block's prefix.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.hub import conv_tasnet_state_dict_from_jax
from dnn_based_source_separation_torch.models import tdcn as ttdcn
from dnn_based_source_separation_tpu.models import tdcn as jtdcn

ATOL = 1e-4
F, H, SKIP = 12, 20, 12  # bottleneck, hidden and skip widths


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scramble(tree, rng):
    """Non-trivial gamma/beta/bias/PReLU values (init leaves them trivial)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _scramble(v, rng)
            continue
        v = np.asarray(v)
        if k == "gamma":
            v = 0.5 + rng.random(v.shape)
        elif k in ("beta", "bias"):
            v = 0.3 * rng.standard_normal(v.shape)
        elif k == "alpha":
            v = rng.uniform(-0.5, 0.5, v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


def _init(module, x, seed):
    params = jax.tree_util.tree_map(np.asarray, module.init(jax.random.PRNGKey(seed), x))
    return _scramble(params["params"], np.random.default_rng(seed))


def _port_state(tdcn_tree, prefix, causal, num_blocks, num_layers):
    norm = "CumulativeLayerNorm_0" if causal else "GlobalLayerNorm_0"
    z = np.zeros((1, 1), np.float32)
    tree = {"encoder": {"kernel": z}, "decoder": {"kernel": z}, "separator": {
        norm: {"gamma": np.ones(1, np.float32), "beta": np.zeros(1, np.float32)},
        "bottleneck_conv1d": {"kernel": z, "bias": np.zeros(1, np.float32)},
        "prelu": {"alpha": np.float32(0.25)},
        "mask_conv1d": {"kernel": z, "bias": np.zeros(1, np.float32)},
        "tdcn": tdcn_tree}}
    config = dict(causal=causal, sep_num_blocks=num_blocks, sep_num_layers=num_layers)
    sd = conv_tasnet_state_dict_from_jax(tree, config)
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dual_head", [True, False])
# (K - 1) * dilation odd: the non-causal padding splits unevenly.
@pytest.mark.parametrize("kernel_size,dilation", [(3, 4), (4, 1)])
def test_residual_block_matches_jax(causal, dual_head, kernel_size, dilation):
    kw = dict(hidden_channels=H, skip_channels=SKIP, kernel_size=kernel_size, dilation=dilation,
              separable=True, causal=causal, nonlinear="prelu", norm=True,
              dual_head=dual_head, eps=1e-12)
    x = np.random.default_rng(1).standard_normal((2, 23, F)).astype(np.float32)
    jmod = jtdcn.ResidualBlock1d(F, **kw)
    params = _init(jmod, jnp.asarray(x), seed=2)
    j_out, j_skip = jmod.apply({"params": params}, jnp.asarray(x))

    port = ttdcn.ResidualBlock1d(F, **kw)
    port.load_state_dict(_port_state({"block0": {"layer0": params}},
                                     "separator.tdcn.net.0.net.0.", causal, 1, 1))
    with torch.no_grad():
        out, skip = port(torch.from_numpy(x))
    np.testing.assert_allclose(skip.numpy(), np.asarray(j_skip), rtol=0, atol=ATOL)
    if dual_head:
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0, atol=ATOL)
    else:
        assert out is None and j_out is None


@pytest.mark.parametrize("causal", [False, True])
def test_time_dilated_conv_net_matches_jax(causal):
    kw = dict(hidden_channels=H, skip_channels=SKIP, kernel_size=3, num_blocks=2,
              num_layers=3, dilated=True, separable=True, causal=causal,
              nonlinear="prelu", norm=True, eps=1e-12)
    x = np.random.default_rng(3).standard_normal((2, 31, F)).astype(np.float32)
    jmod = jtdcn.TimeDilatedConvNet(F, **kw)
    params = _init(jmod, jnp.asarray(x), seed=4)
    expected = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))

    port = ttdcn.TimeDilatedConvNet(F, **kw)
    port.load_state_dict(_port_state(params, "separator.tdcn.", causal, 2, 3))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=ATOL)


def test_depthwise_shift_matches_grouped_conv():
    # The K shifted multiply-adds equal torch's grouped, dilated Conv1d.
    rng = np.random.default_rng(5)
    conv = ttdcn.DepthwiseConv1dShift(6, kernel_size=3, dilation=2,
                                      generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.standard_normal((2, 20, 6)).astype(np.float32))
    with torch.no_grad():
        got = conv(x)
        expected = torch.nn.functional.conv1d(x.transpose(1, 2), conv.weight, conv.bias,
                                              dilation=2, groups=6).transpose(1, 2)
    torch.testing.assert_close(got, expected, rtol=0, atol=1e-5)


def test_unported_variants_raise():
    with pytest.raises(NotImplementedError):
        ttdcn.ResidualBlock1d(F, H, SKIP, separable=False)
    with pytest.raises(NotImplementedError):
        ttdcn.TimeDilatedConvBlock1d(F, H, SKIP, num_layers=2, separable=True, remat="block")
    with pytest.raises(NotImplementedError):
        ttdcn.TimeDilatedConvNet(F, H, SKIP, num_layers=2, dilated=False, separable=True)
    assert [ttdcn.fold_mode(v) for v in (False, True, None, "heads")] == \
        ["none", "all", "none", "heads"]
