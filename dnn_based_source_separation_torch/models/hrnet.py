"""HRNet: parallel multi-scale streams of residual blocks for one stem's mask.

Port of `dnn_based_source_separation_tpu/models/hrnet.py` (DownsampleBlock2d,
UpsampleBlock2d, MixBlock2d, StackedResidualBlock2d, HRNet), after the reference
`src/models/hrnet.py` (Wang et al., arXiv:1908.07919). Streams at scales 1, 2, 4, ...
of bottleneck residual blocks, an all-to-all fusion after each stage (strided convs
down, bilinear resizes up), a concat head at full resolution, and a relu mask on the
input. NCHW.

- Down: 1x1 conv, BN, a pad of 1 on every side, then a 3 x 3 conv of stride (sh^d, sw^d)
  with no padding of its own (flax's `VALID`), and the nonlinearity.
- Up: 1x1 conv, BN, `F.interpolate(mode="bilinear", align_corners=False)` to (H sh^d,
  W sw^d): `jax.image.resize(..., "bilinear")` samples at half-pixel centres and, at
  the borders, renormalises the triangle kernel over the pixels that exist, which for an
  up-sampling is the clamped edge pixel that torch reads.

JAX's package has no converter of the reference layout for HRNet: the port's names follow
the JAX tree (`conv2d_in.block{i}`, `stage{s}_stack{k}_level{l}`, `mix{s}.down_{o}_{i}` /
`up_{o}_{i}`, `concat_up{l}`, `conv2d_out.block{i}`), and
`hub/from_jax.py:hrnet_state_dict_from_jax` maps one onto the other.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import BatchNorm2d
from .base import SeparationModelMixin, register_model
from .m_densenet import _pair, config_of, conv2d, crop2d
from .modules import choose_nonlinear
from .resnet import ResidualBlock2d

EPS = 1e-12


class DownsampleBlock2d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, scale=(2, 2),
                 nonlinear: str = "relu", eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        self.nonlinear = nonlinear
        self.pointwise_conv2d = conv2d(in_channels, out_channels, 1, bias=False,
                                       generator=generator, device=device)
        self.norm2d = BatchNorm2d(out_channels, eps=eps, device=device)
        self.conv2d = conv2d(out_channels, out_channels, 3, stride=scale, generator=generator,
                             device=device)

    def forward(self, x):
        h = F.pad(self.norm2d(self.pointwise_conv2d(x)), (1, 1, 1, 1))
        return choose_nonlinear(self.nonlinear)(self.conv2d(h))


class UpsampleBlock2d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, scale=(2, 2), eps: float = EPS, *,
                 generator=None, device=None):
        super().__init__()
        self.scale = _pair(scale)
        self.pointwise_conv2d = conv2d(in_channels, out_channels, 1, bias=False,
                                       generator=generator, device=device)
        self.norm2d = BatchNorm2d(out_channels, eps=eps, device=device)

    def forward(self, x):
        h = self.norm2d(self.pointwise_conv2d(x))
        size = (h.shape[2] * self.scale[0], h.shape[3] * self.scale[1])
        return F.interpolate(h, size=size, mode="bilinear", align_corners=False)


class MixBlock2d(nn.Module):
    """All-to-all fusion: output level o sums every input level i brought to its scale
    (down d = o - i times, up -d times), each cropped to the first's size."""

    def __init__(self, in_channels: Sequence[int], additional_channels: int = 0, scale=(2, 2),
                 eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        sh, sw = _pair(scale)
        self.n_in = len(in_channels)
        out_channels = list(in_channels) + ([additional_channels]
                                            if additional_channels > 0 else [])
        self.n_out = len(out_channels)
        for o, c_out in enumerate(out_channels):
            for i, c_in in enumerate(in_channels):
                d = o - i
                if d > 0:
                    self.add_module(f"down_{o}_{i}", DownsampleBlock2d(
                        c_in, c_out, (sh ** d, sw ** d), eps=eps, generator=generator,
                        device=device))
                elif d < 0:
                    self.add_module(f"up_{o}_{i}", UpsampleBlock2d(
                        c_in, c_out, (sh ** -d, sw ** -d), eps=eps, generator=generator,
                        device=device))

    def forward(self, xs):
        outs = []
        for o in range(self.n_out):
            acc = None
            for i, x in enumerate(xs):
                d = o - i
                y = getattr(self, f"down_{o}_{i}" if d > 0 else f"up_{o}_{i}")(x) if d else x
                acc = y if acc is None else acc + crop2d(y, acc.shape[2], acc.shape[3])
            outs.append(acc)
        return outs


class StackedResidualBlock2d(nn.Module):
    """`num_stacks` residual blocks, `block{i}`."""

    def __init__(self, in_channels: int, out_channels: int, bottleneck_channels: int,
                 kernel_size=(3, 3), nonlinear: str = "relu", num_stacks: int = 1,
                 eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        self.num_stacks = num_stacks
        for idx in range(num_stacks):
            self.add_module(f"block{idx}", ResidualBlock2d(
                in_channels if idx == 0 else out_channels, out_channels, bottleneck_channels,
                kernel_size, nonlinear, eps, generator=generator, device=device))

    def forward(self, x):
        for idx in range(self.num_stacks):
            x = getattr(self, f"block{idx}")(x)
        return x


@register_model
class HRNet(SeparationModelMixin, nn.Module):
    """(B, in_channels, n_bins, n_frames) amplitude -> the masked amplitude."""

    def __init__(self, in_channels: int, hidden_channels: Sequence[int] = (16, 32, 64),
                 bottleneck_channels: int = 8, kernel_size=(3, 3), scale=(2, 2),
                 nonlinear: str = "relu", mask_nonlinear: str = "relu", num_stacks=1,
                 in_num_stacks: int = 2, out_num_stacks: int = 2, eps: float = EPS, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = config_of(locals())
        hidden = list(hidden_channels)
        self.num_stages = len(hidden)
        self.num_stacks = (list(num_stacks) if isinstance(num_stacks, (list, tuple))
                           else [num_stacks] * self.num_stages)
        self.mask_nonlinear = mask_nonlinear
        sh, sw = _pair(scale)
        common = dict(eps=eps, generator=generator, device=device)
        self.conv2d_in = StackedResidualBlock2d(in_channels, hidden[0], bottleneck_channels,
                                                kernel_size, nonlinear, in_num_stacks, **common)
        levels = 1
        for stage in range(self.num_stages):
            for stack in range(self.num_stacks[stage]):
                for level in range(levels):
                    self.add_module(f"stage{stage}_stack{stack}_level{level}", ResidualBlock2d(
                        hidden[level], hidden[level], bottleneck_channels, kernel_size,
                        nonlinear, **common))
            additional = hidden[stage + 1] if stage < self.num_stages - 1 else 0
            self.add_module(f"mix{stage}", MixBlock2d(hidden[:levels], additional, scale,
                                                      **common))
            levels += additional > 0
        self.levels = levels
        for level in range(1, levels):
            self.add_module(f"concat_up{level}", UpsampleBlock2d(
                hidden[level], hidden[level], (sh ** level, sw ** level), **common))
        self.conv2d_out = StackedResidualBlock2d(sum(hidden[:levels]), in_channels,
                                                 bottleneck_channels, kernel_size, nonlinear,
                                                 out_num_stacks, **common)

    def forward(self, input):
        xs = [self.conv2d_in(input)]
        for stage in range(self.num_stages):
            for stack in range(self.num_stacks[stage]):
                xs = [getattr(self, f"stage{stage}_stack{stack}_level{level}")(x)
                      for level, x in enumerate(xs)]
            xs = getattr(self, f"mix{stage}")(xs)
        H, W = xs[0].shape[2], xs[0].shape[3]
        ups = [xs[0]] + [crop2d(getattr(self, f"concat_up{level}")(xs[level]), H, W)
                         for level in range(1, len(xs))]
        h = self.conv2d_out(torch.cat(ups, dim=1))
        mask = crop2d(choose_nonlinear(self.mask_nonlinear)(h), input.shape[2], input.shape[3])
        return mask * input
