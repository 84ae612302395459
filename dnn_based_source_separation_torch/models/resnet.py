"""Bottleneck residual block (HRNet's building block).

Port of `dnn_based_source_separation_tpu/models/resnet.py:ResidualBlock2d` (reference
`src/models/resnet.py`): 1x1 reduce -> BN -> nonlinear -> k x k -> BN -> nonlinear -> 1x1
expand -> BN, plus the input (through a 1x1 conv where the channels change), then the
nonlinearity. NCHW; the convs have no bias; BatchNorm's eps is the model's (1e-12), as
JAX passes it. Names follow JAX's tree: `bottleneck_conv2d_in`, `bottleneck_norm2d_in`,
`conv2d`, `norm2d`, `bottleneck_conv2d_out`, `bottleneck_norm2d_out`, `pointwise_conv2d`.
"""
from __future__ import annotations

from typing import Optional

from torch import nn

from ..ops.norms import BatchNorm2d
from .m_densenet import _pair, conv2d, pad2d
from .modules import choose_nonlinear

EPS = 1e-12


class ResidualBlock2d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, bottleneck_channels: int,
                 kernel_size=(3, 3), nonlinear: Optional[str] = "relu", eps: float = EPS, *,
                 generator=None, device=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.pads, self.nonlinear = (kh - 1, kw - 1), nonlinear
        conv = dict(bias=False, generator=generator, device=device)
        self.bottleneck_conv2d_in = conv2d(in_channels, bottleneck_channels, 1, **conv)
        self.bottleneck_norm2d_in = BatchNorm2d(bottleneck_channels, eps=eps, device=device)
        self.conv2d = conv2d(bottleneck_channels, bottleneck_channels, (kh, kw), **conv)
        self.norm2d = BatchNorm2d(bottleneck_channels, eps=eps, device=device)
        self.bottleneck_conv2d_out = conv2d(bottleneck_channels, out_channels, 1, **conv)
        self.bottleneck_norm2d_out = BatchNorm2d(out_channels, eps=eps, device=device)
        self.pointwise_conv2d = (conv2d(in_channels, out_channels, 1, **conv)
                                 if out_channels != in_channels else None)

    def forward(self, x):
        nl = choose_nonlinear(self.nonlinear)
        h = nl(self.bottleneck_norm2d_in(self.bottleneck_conv2d_in(x)))
        h = nl(self.norm2d(self.conv2d(pad2d(h, *self.pads))))
        h = self.bottleneck_norm2d_out(self.bottleneck_conv2d_out(h))
        residual = x if self.pointwise_conv2d is None else self.pointwise_conv2d(x)
        return nl(h + residual)
