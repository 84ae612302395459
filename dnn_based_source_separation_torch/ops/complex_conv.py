"""Complex-valued convolution and dense layer.

Port of `dnn_based_source_separation_tpu/ops/complex_conv.py` (reference
`src/modules/conv.py:103` ComplexConv1d): (W_r + i W_i) * (x_r + i x_i) as two real layers,
`real` and `imag`, each applied to both parts. Inputs are complex (complex64 on the card);
ComplexConv1d runs on channels-last (B, T, C_in), as JAX's, with 'VALID' padding (JAX's
default; no other padding is ported).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .params import Linear, uniform_parameter


class _ConvPart(nn.Module):
    """One real conv: torch's Conv1d `weight` (out, in, K) and `bias` (None without `bias`),
    uniform in +-1/sqrt(in K) from `generator`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, bias: bool,
                 generator, device):
        super().__init__()
        fan_in = in_channels * kernel_size
        self.weight = uniform_parameter((out_channels, in_channels, kernel_size), fan_in,
                                        generator, device)
        self.bias = (uniform_parameter((out_channels,), fan_in, generator, device)
                     if bias else None)


class ComplexConv1d(nn.Module):
    """(B, T, C_in) complex -> (B, T', C_out) complex, T' = (T - K) // stride + 1."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 bias: bool = True, *, generator=None, device=None):
        super().__init__()
        self.stride = stride
        args = (in_channels, out_channels, kernel_size, bias, generator, device)
        self.real, self.imag = _ConvPart(*args), _ConvPart(*args)

    def _conv(self, conv, x):
        return F.conv1d(x.transpose(1, 2), conv.weight, conv.bias,
                        stride=self.stride).transpose(1, 2)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        xr, xi = z.real, z.imag
        return torch.complex(self._conv(self.real, xr) - self._conv(self.imag, xi),
                             self._conv(self.real, xi) + self._conv(self.imag, xr))


class ComplexDense(nn.Module):
    """(..., F_in) complex -> (..., F_out) complex."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 generator=None, device=None):
        super().__init__()
        self.real = Linear(in_features, out_features, bias=bias, generator=generator,
                           device=device)
        self.imag = Linear(in_features, out_features, bias=bias, generator=generator,
                           device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        xr, xi = z.real, z.imag
        return torch.complex(self.real(xr) - self.imag(xi), self.real(xi) + self.imag(xr))
