"""The port's HRNet, U-Nets and CUNet (and their musdb18 wrappers) against the JAX package
(CPU).

- HRNet's up-sampling, `F.interpolate(mode="bilinear", align_corners=False)`, against
  `jax.image.resize(..., "bilinear")` at scales 2, 4 and 8 on maps of odd and even sizes,
  the border rows and columns included; its strided `VALID` down-sampling runs in every
  HRNet forward below;
- HRNet, UNet2d (strided at odd sizes, so the decoders crop and pad to their skips; and
  dilated), UNet1d, EnsembleUNet2d / 1d, and CUNet with FiLM, PoCM and GPoCM conditioning:
  the forward in eval mode (HRNet's under its wrapper below), in train mode with the updated
  BatchNorm statistics, and the train-mode gradients (CUNet's with FiLM), at 1e-4 x max|ref|
  in f32, random weights at the JAX init's shapes
  carried over by `hub/from_jax.py` (`test_torch_dense_family.py`'s helpers);
- `SingleStemSpectrogramWrapper` (HRNet) and `ConditionedSpectrogramWrapper` (CUNet: every
  stem's one-hot in one batch of n_src x B) on waves against JAX's wrappers;
- the conv control network (`ControlConvNet`, which no model builds), both gamma shapes.

JAX's control network ignores `control_channels[0]` and reads the one-hot's width; the
port's first layer takes `control_channels[0]` inputs: the recipes set both to the stems.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dnn_based_source_separation_torch.hub import (
    cunet_state_dict_from_jax, hrnet_state_dict_from_jax, unet_state_dict_from_jax,
)
from dnn_based_source_separation_torch.models import (
    ConditionedSpectrogramWrapper, ConditionedUNet2d, EnsembleUNet1d, EnsembleUNet2d, HRNet,
    SingleStemSpectrogramWrapper, UNet1d, UNet2d,
)
from dnn_based_source_separation_torch.models.cunet import ControlConvNet
from dnn_based_source_separation_tpu.models import cunet as jcunet
from dnn_based_source_separation_tpu.models import hrnet as jhrnet
from dnn_based_source_separation_tpu.models import unet as junet
from dnn_based_source_separation_tpu.models import wrappers as jwrappers
from test_torch_dense_family import check, check_statistics, close, held, init, spec

HRNET = dict(in_channels=2, hidden_channels=(3, 4, 5), bottleneck_channels=2, num_stacks=1,
             in_num_stacks=1, out_num_stacks=1)
CUNET = dict(channels=(2, 3, 4, 5), kernel_size=(5, 5), stride=(2, 2),
             control_channels=(4, 6, 8), masking=True)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("scale", [2, 4, 8])
@pytest.mark.parametrize("shape", [(5, 7), (6, 4)])
def test_bilinear_upsampling_matches_jax_image_resize(scale, shape):
    x = np.random.default_rng(scale).standard_normal((2, 3, *shape)).astype(np.float32)
    size = (shape[0] * scale, shape[1] * scale)
    ref = jax.image.resize(jnp.asarray(np.transpose(x, (0, 2, 3, 1))), (2, *size, 3),
                           method="bilinear")
    got = F.interpolate(torch.from_numpy(x), size=size, mode="bilinear", align_corners=False)
    ref = np.transpose(np.asarray(ref), (0, 3, 1, 2))
    close(got, ref, 1e-6)
    # The borders: the first and last rows and columns, where JAX renormalises.
    for rows in (slice(0, scale), slice(-scale, None)):
        close(got[:, :, rows], ref[:, :, rows], 1e-6)
        close(got[..., rows], ref[..., rows], 1e-6)


def test_hrnet_matches_jax():
    shape = (13, 11)  # odd: the strided convs' and the resizes' maps need crops
    x = spec((2, 2, *shape), shape[0])
    convert = lambda v: hrnet_state_dict_from_jax(v, HRNET)  # noqa: E731
    port = HRNet(**HRNET)
    held(port, jhrnet.HRNet(**HRNET), convert, x, shape[1], eval_mode=False)
    assert port.mix1.down_2_0.conv2d.stride == (4, 4)


UNETS = {  # port class, JAX class, config, input shape
    "unet2d": (UNet2d, junet.UNet2d, dict(channels=(2, 3, 4), kernel_size=(5, 3),
                                          stride=(2, 2)), (2, 2, 13, 11)),
    "unet2d-dilated": (UNet2d, junet.UNet2d, dict(channels=(2, 3, 3), kernel_size=3,
                                                  dilated=True, out_channels=2), (2, 2, 9, 7)),
    "unet1d": (UNet1d, junet.UNet1d, dict(channels=(2, 3, 4), kernel_size=5, stride=2),
               (2, 2, 36)),
    "ensemble2d": (EnsembleUNet2d, junet.EnsembleUNet2d,
                   dict(channels=(2, 3, 4), kernel_size=4, stride=2, out_channels=2),
                   (1, 2, 12, 10)),
    "ensemble1d": (EnsembleUNet1d, junet.EnsembleUNet1d,
                   dict(channels=(2, 3), kernel_size=4, stride=2, out_channels=2), (2, 2, 22)),
}


@pytest.mark.parametrize("kind", list(UNETS))
def test_unets_match_jax(kind):
    cls, jcls, config, shape = UNETS[kind]
    x = np.random.default_rng(len(kind)).standard_normal(shape).astype(np.float32)
    convert = lambda v: unet_state_dict_from_jax(v, config)  # noqa: E731
    held(cls(**config), jcls(**config), convert, x, len(kind))


@pytest.mark.parametrize("conditioning", ["film", "pocm", "gpocm"])
def test_cunet_matches_jax(conditioning):
    config = dict(CUNET, conditioning=conditioning)
    x = spec((3, 2, 21, 13), 3)
    latent = np.eye(4, dtype=np.float32)[1:]  # stems 1-3 of 4
    jmodel = jcunet.ConditionedUNet2d(**config)
    convert = lambda v: cunet_state_dict_from_jax(v, config)  # noqa: E731
    variables = init(jmodel, 4, x, latent)
    port = ConditionedUNet2d(**config)
    port.load_state_dict(convert(variables))
    check(port, jmodel, variables, convert, x, latent, grads=False)
    updated = check(port, jmodel, variables, convert, x, latent, train=True,
                    grads=conditioning == "film")  # the conditioning's own gradients: FiLM's
    check_statistics(port, convert, variables, updated, x, latent)


@pytest.mark.parametrize("gamma_shape", ["vector", "matrix"])
def test_control_conv_net_matches_jax(gamma_shape):
    """The conv control network (no model builds it: CUNet's is the dense one) over an odd
    length, flax's 'SAME' strided padding."""
    config = dict(channels=(3, 4, 5), out_channels=(2, 3), gamma_shape=gamma_shape)
    x = np.random.default_rng(7).standard_normal((2, 11, 3)).astype(np.float32)
    jmodel = jcunet.ControlConvNet(**config)
    variables = init(jmodel, 7, x)
    port = ControlConvNet(**config)
    port.load_state_dict(cunet_state_dict_from_jax(variables, config))
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, r in zip((*got[0], *got[1]), (*ref[0], *ref[1])):
        close(g, r)


def _wrapped(variables):
    return {k: {"base": v["base"]} for k, v in variables.items() if "base" in v}


def test_spectrogram_wrappers_match_jax():
    """HRNet under SingleStemSpectrogramWrapper and CUNet under
    ConditionedSpectrogramWrapper (four stems in one batch of 4 x B) on (B, 1, C, T)
    waves, eval mode (the models' train mode is held above; HRNet's eval mode here)."""
    wave = np.random.default_rng(5).standard_normal((2, 1, 2, 300)).astype(np.float32)
    for port_base, jbase, convert, wrap in (
            (HRNet(**HRNET), jhrnet.HRNet(**HRNET), hrnet_state_dict_from_jax,
             (SingleStemSpectrogramWrapper, jwrappers.SingleStemSpectrogramWrapper, {})),
            (ConditionedUNet2d(**CUNET), jcunet.ConditionedUNet2d(**CUNET),
             cunet_state_dict_from_jax, (ConditionedSpectrogramWrapper,
                                         jwrappers.ConditionedSpectrogramWrapper,
                                         dict(n_sources=4)))):
        cls, jcls, extra = wrap
        jmodel = jcls(jbase, 32, 8, **extra)
        port = cls(port_base, 32, 8, **extra)
        to_port = lambda v, c=convert: {  # noqa: E731
            f"base.{k}": t for k, t in c({n: u["base"] for n, u in v.items()}, {}).items()}
        variables = _wrapped(init(jmodel, 6, wave))
        port.load_state_dict(to_port(variables))
        check(port, jmodel, variables, to_port, wave, grads=False)
        n = extra.get("n_sources", 1)
        assert port(torch.from_numpy(wave)).shape == (2, n, 2, 17, 38)
