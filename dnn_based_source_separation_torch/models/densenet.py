"""Plain (image-style) DenseNet: DenseNet-BC's layers, blocks and transitions.

Port of `dnn_based_source_separation_tpu/models/densenet.py` (DenseNetLayer, Transition2d,
DenseNetBlock, DenseNet; reference `src/models/densenet.py`). NCHW: (B, in_channels, H, W)
-> (B, C_out, H / 2^num_blocks, W / 2^num_blocks).

- A layer is BN -> relu -> 1x1 bottleneck conv -> BN -> relu -> pad -> KxK conv (no biases),
  concatenated after its input. The pad keeps the input's size for any stride (the
  reference's rule: p = n (s - 1) + k - s, split (p // 2, p - p // 2)), by hand (`F.pad`).
- A transition is BN -> relu -> 1x1 conv -> 2x2 average pooling (floor).
- BatchNorm is `ops/norms.py:BatchNorm2d` (flax's train mode) at the model's eps (1e-12).

Parameter names are the reference torch model's, those `hub/torch_convert.py:
convert_densenet` reads: `preprocess`, `net.{b}.net.{l}.{norm2d1,bottleneck_conv2d,norm2d2,
conv2d}`, `net.{b}.transition2d.{norm2d,conv2d}`.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import BatchNorm2d
from .base import SeparationModelMixin, register_model
from .m_densenet import _pair, config_of, conv2d, pad2d

EPS = 1e-12


class DenseNetLayer(nn.Module):
    """(B, C, H, W) -> (B, C + growth_rate, H, W)."""

    def __init__(self, in_channels: int, growth_rate: int, kernel_size, stride=(1, 1),
                 hidden_channels: int = 128, eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        self.kernel_size, self.stride = _pair(kernel_size), _pair(stride)
        common = dict(bias=False, generator=generator, device=device)
        self.norm2d1 = BatchNorm2d(in_channels, eps=eps, device=device)
        self.bottleneck_conv2d = conv2d(in_channels, hidden_channels, 1, **common)
        self.norm2d2 = BatchNorm2d(hidden_channels, eps=eps, device=device)
        self.conv2d = conv2d(hidden_channels, growth_rate, self.kernel_size, stride=self.stride,
                             **common)

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        H, W = x.shape[2:]
        h = self.bottleneck_conv2d(F.relu(self.norm2d1(x)))
        h = pad2d(F.relu(self.norm2d2(h)), H * (sh - 1) + kh - sh, W * (sw - 1) + kw - sw)
        return torch.cat([x, self.conv2d(h)], dim=1)


class Transition2d(nn.Module):
    """(B, C, H, W) -> (B, out_channels, H // 2, W // 2)."""

    def __init__(self, in_channels: int, out_channels: int, eps: float = EPS, *,
                 generator=None, device=None):
        super().__init__()
        self.norm2d = BatchNorm2d(in_channels, eps=eps, device=device)
        self.conv2d = conv2d(in_channels, out_channels, 1, bias=False, generator=generator,
                             device=device)

    def forward(self, x):
        return F.avg_pool2d(self.conv2d(F.relu(self.norm2d(x))), 2)


class DenseNetBlock(nn.Module):
    """num_layers dense layers (`net`), then a transition (`transition2d`)."""

    def __init__(self, in_channels: int, out_channels: int, growth_rate: int, kernel_size,
                 stride=(1, 1), hidden_channels: int = 128, num_layers: int = 3,
                 eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        common = dict(eps=eps, generator=generator, device=device)
        self.net = nn.Sequential(*[DenseNetLayer(
            in_channels + idx * growth_rate, growth_rate, kernel_size, stride=stride,
            hidden_channels=hidden_channels, **common) for idx in range(num_layers)])
        self.transition2d = Transition2d(in_channels + num_layers * growth_rate,
                                         out_channels, **common)

    def forward(self, x):
        return self.transition2d(self.net(x))


@register_model
class DenseNet(SeparationModelMixin, nn.Module):
    """(B, in_channels, H, W) -> (B, C_out, H / 2^num_blocks, W / 2^num_blocks), C_out the
    last transition's width, (features + num_layers[-1] growth_rate) // 2."""

    def __init__(self, in_channels: int, num_features: int, growth_rate: int, kernel_size,
                 stride=(1, 1), hidden_channels: int = 128, num_blocks: int = 3,
                 num_layers: Union[int, Sequence[int]] = (2, 3, 4), eps: float = EPS, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = config_of(locals())
        if isinstance(num_layers, (list, tuple)):
            if num_blocks != len(num_layers):
                raise ValueError("`num_blocks` must be equal to `len(num_layers)`")
            num_layers = list(num_layers)
        else:
            num_layers = [num_layers] * num_blocks
        self.preprocess = conv2d(in_channels, num_features, 1, generator=generator,
                                 device=device)
        blocks = []
        for n_layers in num_layers:
            out_channels = (num_features + n_layers * growth_rate) // 2
            blocks.append(DenseNetBlock(
                num_features, out_channels, growth_rate, kernel_size, stride=stride,
                hidden_channels=hidden_channels, num_layers=n_layers, eps=eps,
                generator=generator, device=device))
            num_features = out_channels
        self.net = nn.Sequential(*blocks)

    def forward(self, input):
        return self.net(self.preprocess(input))
