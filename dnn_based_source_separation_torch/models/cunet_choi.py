"""Choi-style conditioned TDC U-Net (TDCUNet2d) and its blocks.

Port of `dnn_based_source_separation_tpu/models/cunet_choi.py` (TDC2d, TDCEncoderBlock2d,
TDCDecoderBlock2d, PreprocessBlock, PostprocessBlock, TDCUNet2d; reference
`egs/musdb18/cunet_choi/src/adhoc_model.py` on `src/models/cunet.py` TDC2d). NCHW:
(B, C, n_bins, n_frames), where JAX's maps are channels-last.

- A TDC layer is a 1-D conv along the bins applied per frame: a (k, 1) conv (no bias)
  after a pad of the bins by (p // 2, p - p // 2), then BN and the nonlinearity; TDC2d is a
  dense block of them whose output is its last layer's.
- An encoder block is TDC2d -> a (s, s) stride-s conv ('VALID') -> FiLM / PoCM / GPoCM
  from `models/cunet.py:ControlDenseNet`'s (gamma, beta); a decoder block aligns its input
  to the skip (crop or pad, the smaller half before), concatenates it, then TDC2d -> a
  (s, s) stride-s transposed conv. flax's ConvTranspose does not flip its kernel and
  torch's does: the port keeps torch's layout (`hub/from_jax.py` flips), and with kernel
  equal to stride flax's default padding gives torch's s n outputs.
- The pre-block pads the bins (0, 1) for its (2, 1) conv; the post-block's (2, 1)
  transposed conv gives one bin more, cropped after; the output is cropped or padded to
  the input's size (the smaller half before) and, with `masking`, multiplies it.
- BatchNorm is `ops/norms.py:BatchNorm2d` (flax's train mode) at the model's eps, 1e-12.

The JAX package has no converter of the reference layout for TDCUNet2d: the names follow
the JAX tree (`control_net.*`, `preprocess.{conv2d,norm2d}`, `encoder.{i}.tdc2d.{conv,norm}{j}`,
`encoder.{i}.downsample2d`, `bottleneck`, `decoder.{i}.tdc2d.*`, `decoder.{i}.upsample2d`,
`postprocess.{deconv2d,norm2d}`), and `hub/from_jax.py:tree_state_dict_from_jax` maps one
onto the other.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import BatchNorm2d
from .base import SeparationModelMixin, register_model
from .cunet import CONDITIONING, ControlDenseNet
from .m_densenet import _pair, config_of, conv2d, crop2d, pad2d
from .modules import choose_nonlinear
from .unet import _per_layer

EPS = 1e-12


def _fit(x, H: int, W: int):
    """Crop or pad dims 2 and 3 of x to (H, W), the smaller half before."""
    dh, dw = x.shape[2] - H, x.shape[3] - W
    x = crop2d(x, x.shape[2] - max(0, dh), x.shape[3] - max(0, dw))
    return pad2d(x, max(0, -dh), max(0, -dw))


class TDC2d(nn.Module):
    """(B, C_in, F, T) -> (B, growth_rate, F, T)."""

    def __init__(self, in_channels: int, growth_rate: int, kernel_size: int = 3,
                 num_layers: int = 2, nonlinear: Optional[str] = "relu", eps: float = EPS, *,
                 generator=None, device=None):
        super().__init__()
        self.num_layers, self.nonlinear, self.pad = num_layers, nonlinear, kernel_size - 1
        for idx in range(num_layers):
            self.add_module(f"conv{idx}", conv2d(
                in_channels + idx * growth_rate, growth_rate, (kernel_size, 1), bias=False,
                generator=generator, device=device))
            self.add_module(f"norm{idx}", BatchNorm2d(growth_rate, eps=eps, device=device))

    def forward(self, x):
        stack = x
        for idx in range(self.num_layers):
            y = getattr(self, f"conv{idx}")(pad2d(stack, self.pad, 0))
            y = getattr(self, f"norm{idx}")(y)
            if self.nonlinear:
                y = choose_nonlinear(self.nonlinear)(y)
            if idx < self.num_layers - 1:
                stack = torch.cat([stack, y], dim=1)
        return y


class TDCEncoderBlock2d(nn.Module):
    """TDC2d -> (s, s) stride-s conv -> conditioning: (B, C_in, F, T), gamma, beta ->
    (B, out_channels, F // s, T // s)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 num_layers: int = 2, nonlinear: Optional[str] = "relu",
                 conditioning: str = "film", down_scale: int = 2, eps: float = EPS, *,
                 generator=None, device=None):
        super().__init__()
        self.conditioning = conditioning
        self.tdc2d = TDC2d(in_channels, out_channels, kernel_size, num_layers, nonlinear, eps,
                           generator=generator, device=device)
        self.downsample2d = conv2d(out_channels, out_channels, down_scale, stride=down_scale,
                                   generator=generator, device=device)

    def forward(self, x, gamma, beta):
        return CONDITIONING[self.conditioning](self.downsample2d(self.tdc2d(x)), gamma, beta)


class TDCDecoderBlock2d(nn.Module):
    """[the input fitted to the skip, the skip concatenated] -> TDC2d -> (s, s) stride-s
    transposed conv: (B, C_in, F, T) -> (B, out_channels, s F', s T')."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 num_layers: int = 2, nonlinear: Optional[str] = "relu", up_scale: int = 2,
                 eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        self.tdc2d = TDC2d(in_channels, out_channels, kernel_size, num_layers, nonlinear, eps,
                           generator=generator, device=device)
        self.upsample2d = conv2d(out_channels, out_channels, up_scale, stride=up_scale,
                                 transpose=True, generator=generator, device=device)

    def forward(self, x, skip=None):
        if skip is not None:
            x = torch.cat([_fit(x, skip.shape[2], skip.shape[3]), skip], dim=1)
        return self.upsample2d(self.tdc2d(x))


class PreprocessBlock(nn.Module):
    """pad -> (kh, kw) conv -> BN -> nonlinear; the size kept."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=(2, 1),
                 nonlinear: Optional[str] = "relu", eps: float = EPS, *, generator=None,
                 device=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.pads, self.nonlinear = (kh - 1, kw - 1), nonlinear
        self.conv2d = conv2d(in_channels, out_channels, (kh, kw), generator=generator,
                             device=device)
        self.norm2d = BatchNorm2d(out_channels, eps=eps, device=device)

    def forward(self, x):
        x = self.norm2d(self.conv2d(pad2d(x, *self.pads)))
        return choose_nonlinear(self.nonlinear)(x) if self.nonlinear else x


class PostprocessBlock(nn.Module):
    """(kh, kw) transposed conv -> crop back to the input's size -> BN -> nonlinear."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=(2, 1),
                 nonlinear: Optional[str] = None, eps: float = EPS, *, generator=None,
                 device=None):
        super().__init__()
        self.nonlinear = nonlinear
        self.deconv2d = conv2d(in_channels, out_channels, _pair(kernel_size), transpose=True,
                               generator=generator, device=device)
        self.norm2d = BatchNorm2d(out_channels, eps=eps, device=device)

    def forward(self, x):
        x = self.norm2d(crop2d(self.deconv2d(x), x.shape[2], x.shape[3]))
        return choose_nonlinear(self.nonlinear)(x) if self.nonlinear else x


@register_model
class TDCUNet2d(SeparationModelMixin, nn.Module):
    """(input (B, channels[0], n_bins, n_frames), latent (B, control_channels[0])) -> (B,
    out_channels or channels[0], n_bins, n_frames). channels[1] is the pre-block's width;
    each later pair is one encoder block."""

    def __init__(self, channels: Sequence[int], kernel_size: int = 3, num_layers: int = 2,
                 control_channels: Sequence[int] = (4, 16, 64), enc_nonlinear="relu",
                 dec_nonlinear="relu", out_channels: Optional[int] = None,
                 conditioning: str = "film", masking: bool = False, eps: float = EPS, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = config_of(locals())
        channels = list(channels)
        n = len(channels) - 2
        enc_nl, dec_nl = _per_layer(enc_nonlinear, n), _per_layer(dec_nonlinear, n)
        dec_channels = channels[:1:-1] + [channels[1]]
        self.masking = masking
        common = dict(eps=eps, generator=generator, device=device)
        self.control_net = ControlDenseNet(
            control_channels, channels[2:],
            gamma_shape="matrix" if conditioning in ("pocm", "gpocm") else "vector",
            generator=generator, device=device)
        self.preprocess = PreprocessBlock(channels[0], channels[1], **common)
        self.encoder = nn.ModuleList([TDCEncoderBlock2d(
            channels[i + 1], channels[i + 2], kernel_size, num_layers, nonlinear=enc_nl[i],
            conditioning=conditioning, **common) for i in range(n)])
        self.bottleneck = conv2d(channels[-1], channels[-1], 1, generator=generator,
                                 device=device)
        self.decoder = nn.ModuleList([TDCDecoderBlock2d(
            dec_channels[i] + (channels[n - i + 1] if i else 0), dec_channels[i + 1],
            kernel_size, num_layers, nonlinear=dec_nl[i], **common) for i in range(n)])
        self.postprocess = PostprocessBlock(
            channels[1], out_channels if out_channels is not None else channels[0], **common)

    def forward(self, input, latent):
        gammas, betas = self.control_net(latent)
        x = self.preprocess(input)
        skips = []
        for block, gamma, beta in zip(self.encoder, gammas, betas):
            skips.append(x)
            x = block(x, gamma, beta)
        x = self.bottleneck(x)
        n = len(self.decoder)
        for i, block in enumerate(self.decoder):
            x = block(x, None if i == 0 else skips[n - i])
        x = _fit(self.postprocess(x), input.shape[2], input.shape[3])
        return x * input if self.masking else x
