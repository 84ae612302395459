"""Generic 1-D / 2-D U-Nets and their ensembles.

Port of `dnn_based_source_separation_tpu/models/unet.py` (EncoderBlock2d / 1d,
DecoderBlock2d / 1d, UNet2d, UNet1d, EnsembleUNet2d, EnsembleUNet1d), after the
reference `src/models/unet.py`: strided conv encoder blocks (pad, conv, BN,
nonlinearity), transposed-conv decoder blocks that take the mirrored encoder's output as
a skip (cropped or padded to it), and a final crop to the input's size. Channels-first:
(B, C, H, W) and (B, C, T).

- The encoders pad by the reference's "same-ish" rule, `p = ek - 1 - (s - (n - ek) % s)
  % s` (ek the dilated kernel), split `(p // 2, p - p // 2)`, then convolve with no
  padding of their own.
- flax's `nn.ConvTranspose(padding="VALID")` does not flip its kernel and gives
  (n - 1) s + ek outputs where ek >= s (every recipe); torch's flips it and gives the
  same length. Where ek < s, flax's output is `s - ek` positions longer, bias only:
  `output_padding` adds those. The port keeps torch's layout (`hub/from_jax.py` flips).
- BatchNorm's eps is the model's (1e-12), as JAX passes it.

The JAX package has no converter of the reference layout for these: the names follow the
JAX tree (`encoder.{i}.conv2d`, `encoder.{i}.norm2d`, `bottleneck`,
`decoder.{i}.deconv2d`, `decoder.{i}.norm2d`; 1-D `conv1d`, `norm1d`, `deconv1d`; an
ensemble's `unet.{k}`), and `hub/from_jax.py:unet_state_dict_from_jax` maps one onto the
other.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import BatchNorm1d, BatchNorm2d
from ..ops.params import uniform_parameter
from .base import SeparationModelMixin, register_model
from .m_densenet import _pair, config_of, conv2d, crop2d, pad2d
from .modules import choose_nonlinear

EPS = 1e-12


def encoder_pad(n: int, ek: int, s: int) -> int:
    """The reference encoders' total pad of a length-n axis: ek the dilated kernel."""
    return ek - 1 - (s - (n - ek) % s) % s


def _per_layer(v, n):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


class EncoderBlock2d(nn.Module):
    """pad -> strided conv -> BN -> nonlinear."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=None,
                 dilation=1, nonlinear: Optional[str] = "relu", eps: float = EPS, *,
                 generator=None, device=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride if stride is not None else kernel_size)
        dh, dw = _pair(dilation)
        self.ek = ((kh - 1) * dh + 1, (kw - 1) * dw + 1)
        self.nonlinear = nonlinear
        self.conv2d = conv2d(in_channels, out_channels, (kh, kw), stride=self.stride,
                             dilation=(dh, dw), generator=generator, device=device)
        self.norm2d = BatchNorm2d(out_channels, eps=eps, device=device)

    def forward(self, x):
        ph = encoder_pad(x.shape[2], self.ek[0], self.stride[0])
        pw = encoder_pad(x.shape[3], self.ek[1], self.stride[1])
        return choose_nonlinear(self.nonlinear)(self.norm2d(self.conv2d(pad2d(x, ph, pw))))


def match_skip(x, skip):
    """Crop x where it exceeds the skip, pad it where it falls short (dims 2 and 3;
    (d // 2) before, the rest after), then concat [x, skip]."""
    dh, dw = skip.shape[2] - x.shape[2], skip.shape[3] - x.shape[3]
    x = crop2d(x, x.shape[2] - max(0, -dh), x.shape[3] - max(0, -dw))
    return torch.cat([pad2d(x, max(0, dh), max(0, dw)), skip], dim=1)


class DecoderBlock2d(nn.Module):
    """[concat the skip] -> transposed conv -> crop (ek - s) -> BN -> nonlinear."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=None,
                 dilation=1, nonlinear: Optional[str] = "relu", eps: float = EPS, *,
                 generator=None, device=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride if stride is not None else kernel_size)
        dh, dw = _pair(dilation)
        ek = ((kh - 1) * dh + 1, (kw - 1) * dw + 1)
        self.crop = (ek[0] - self.stride[0], ek[1] - self.stride[1])
        self.nonlinear = nonlinear
        self.deconv2d = conv2d(in_channels, out_channels, (kh, kw), stride=self.stride,
                               dilation=(dh, dw), transpose=True, generator=generator,
                               device=device)
        self.deconv2d.output_padding = (max(0, -self.crop[0]), max(0, -self.crop[1]))
        self.norm2d = BatchNorm2d(out_channels, eps=eps, device=device)

    def forward(self, x, skip=None):
        if skip is not None:
            x = match_skip(x, skip)
        x = self.deconv2d(x)
        ph, pw = max(0, self.crop[0]), max(0, self.crop[1])
        x = crop2d(x, x.shape[2] - ph, x.shape[3] - pw)
        return choose_nonlinear(self.nonlinear)(self.norm2d(x))


def _decoder_channels(channels, out_channels):
    return channels[::-1] if out_channels is None else channels[:0:-1] + [out_channels]


@register_model
class UNet2d(SeparationModelMixin, nn.Module):
    """(B, C_in, H, W) -> (B, C_out, H, W) (reference UNet2d). With `dilated`, stride 1
    and dilations 2^i (2^(n-1-i) back up)."""

    def __init__(self, channels: Sequence[int], kernel_size, stride=None, dilated: bool = False,
                 enc_nonlinear="relu", dec_nonlinear="relu", out_channels: Optional[int] = None,
                 eps: float = EPS, *, generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = config_of(locals())
        channels = list(channels)
        n = len(channels) - 1
        enc_nl, dec_nl = _per_layer(enc_nonlinear, n), _per_layer(dec_nonlinear, n)
        dec_channels = _decoder_channels(channels, out_channels)
        common = dict(eps=eps, generator=generator, device=device)
        self.encoder = nn.ModuleList([EncoderBlock2d(
            channels[i], channels[i + 1], kernel_size, 1 if dilated else stride,
            2 ** i if dilated else 1, enc_nl[i], **common) for i in range(n)])
        self.bottleneck = conv2d(channels[-1], channels[-1], 1, generator=generator,
                                 device=device)
        self.decoder = nn.ModuleList([DecoderBlock2d(
            dec_channels[i] + (channels[n - i] if i else 0), dec_channels[i + 1], kernel_size,
            1 if dilated else stride, 2 ** (n - i - 1) if dilated else 1, dec_nl[i], **common)
            for i in range(n)])

    def forward(self, input):
        x, skips = input, []
        for block in self.encoder:
            x = block(x)
            skips.append(x)
        x = self.bottleneck(x)
        for i, block in enumerate(self.decoder):
            x = block(x, None if i == 0 else skips[-1 - i])
        return crop2d(x, input.shape[2], input.shape[3])


def _conv1d(in_channels, out_channels, k, *, stride=1, dilation=1, transpose=False,
            generator=None, device=None):
    cls = nn.ConvTranspose1d if transpose else nn.Conv1d
    conv = cls(in_channels, out_channels, k, stride=stride, dilation=dilation, device="meta")
    fan_in = (out_channels if transpose else in_channels) * k
    conv.weight = uniform_parameter(conv.weight.shape, fan_in, generator, device)
    conv.bias = uniform_parameter((out_channels,), fan_in, generator, device)
    return conv


class EncoderBlock1d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: Optional[int] = None, dilation: int = 1,
                 nonlinear: Optional[str] = "relu", eps: float = EPS, *, generator=None,
                 device=None):
        super().__init__()
        self.stride = stride if stride is not None else kernel_size
        self.ek, self.nonlinear = (kernel_size - 1) * dilation + 1, nonlinear
        self.conv1d = _conv1d(in_channels, out_channels, kernel_size, stride=self.stride,
                              dilation=dilation, generator=generator, device=device)
        self.norm1d = BatchNorm1d(out_channels, eps=eps, device=device)

    def forward(self, x):
        p = encoder_pad(x.shape[2], self.ek, self.stride)
        x = self.conv1d(F.pad(x, (p // 2, p - p // 2)))
        return choose_nonlinear(self.nonlinear)(self.norm1d(x))


class DecoderBlock1d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: Optional[int] = None, dilation: int = 1,
                 nonlinear: Optional[str] = "relu", eps: float = EPS, *, generator=None,
                 device=None):
        super().__init__()
        self.stride = stride if stride is not None else kernel_size
        self.crop = (kernel_size - 1) * dilation + 1 - self.stride
        self.nonlinear = nonlinear
        self.deconv1d = _conv1d(in_channels, out_channels, kernel_size, stride=self.stride,
                                dilation=dilation, transpose=True, generator=generator,
                                device=device)
        self.deconv1d.output_padding = (max(0, -self.crop),)
        self.norm1d = BatchNorm1d(out_channels, eps=eps, device=device)

    def forward(self, x, skip=None):
        if skip is not None:  # JAX pads by the shortfall (never crops) in 1-D
            dt = skip.shape[2] - x.shape[2]
            x = torch.cat([F.pad(x, (dt // 2, dt - dt // 2)), skip], dim=1)
        x = self.deconv1d(x)
        p = max(0, self.crop)
        x = x[:, :, p // 2: x.shape[2] - (p - p // 2)]
        return choose_nonlinear(self.nonlinear)(self.norm1d(x))


@register_model
class UNet1d(SeparationModelMixin, nn.Module):
    """(B, C_in, T) -> (B, C_out, T) (reference UNet1d)."""

    def __init__(self, channels: Sequence[int], kernel_size: int, stride: Optional[int] = None,
                 dilated: bool = False, enc_nonlinear="relu", dec_nonlinear="relu",
                 out_channels: Optional[int] = None, eps: float = EPS, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = config_of(locals())
        channels = list(channels)
        n = len(channels) - 1
        enc_nl, dec_nl = _per_layer(enc_nonlinear, n), _per_layer(dec_nonlinear, n)
        dec_channels = _decoder_channels(channels, out_channels)
        common = dict(eps=eps, generator=generator, device=device)
        self.encoder = nn.ModuleList([EncoderBlock1d(
            channels[i], channels[i + 1], kernel_size, 1 if dilated else stride,
            2 ** i if dilated else 1, enc_nl[i], **common) for i in range(n)])
        self.bottleneck = _conv1d(channels[-1], channels[-1], 1, generator=generator,
                                  device=device)
        self.decoder = nn.ModuleList([DecoderBlock1d(
            dec_channels[i] + (channels[n - i] if i else 0), dec_channels[i + 1], kernel_size,
            1 if dilated else stride, 2 ** (n - i - 1) if dilated else 1, dec_nl[i], **common)
            for i in range(n)])

    def forward(self, input):
        x, skips = input, []
        for block in self.encoder:
            x = block(x)
            skips.append(x)
        x = self.bottleneck(x)
        for i, block in enumerate(self.decoder):
            x = block(x, None if i == 0 else skips[-1 - i])
        dt = x.shape[2] - input.shape[2]
        return x[:, :, dt // 2: x.shape[2] - (dt - dt // 2)]


class _Ensemble(SeparationModelMixin, nn.Module):
    """U-Nets applied one after another (`unet.{k}`); `return_all_layers` stacks every
    stage's output on dim 1."""

    def forward(self, input, return_all_layers: bool = False):
        outputs, x = [], input
        for net in self.unet:
            x = net(x)
            outputs.append(x)
        return torch.stack(outputs, dim=1) if return_all_layers else x


@register_model
class EnsembleUNet2d(_Ensemble):
    """The reference EnsembleUNet2d."""

    def __init__(self, channels: Sequence[int], kernel_size, num_stages: int = 2, stride=None,
                 dilated: bool = False, enc_nonlinear="relu", dec_nonlinear="relu",
                 out_channels: Optional[int] = None, eps: float = EPS, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = config_of(locals())
        kwargs = {k: v for k, v in self._config.items() if k != "num_stages"}
        self.unet = nn.ModuleList([UNet2d(**kwargs, generator=generator, device=device)
                                   for _ in range(num_stages)])


@register_model
class EnsembleUNet1d(_Ensemble):
    """The reference EnsembleUNet1d."""

    def __init__(self, channels: Sequence[int], kernel_size: int, num_stages: int = 2,
                 stride: Optional[int] = None, dilated: bool = False, enc_nonlinear="relu",
                 dec_nonlinear="relu", out_channels: Optional[int] = None, eps: float = EPS, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = config_of(locals())
        kwargs = {k: v for k, v in self._config.items() if k != "num_stages"}
        self.unet = nn.ModuleList([UNet1d(**kwargs, generator=generator, device=device)
                                   for _ in range(num_stages)])
