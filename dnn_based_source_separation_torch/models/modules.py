"""Shared building blocks: PReLU, 1x1 and K-tap convolutions, dense layer, nonlinearity factory.

The dense layer, `Linear`, lives in `ops/params.py` (the ops' attention uses it too).

Port of `dnn_based_source_separation_tpu/models/modules.py` (PReLU,
choose_nonlinear). GLU/GTU come with the models that use them; the RNN
factory is `ops/rnn.py:choose_rnn`.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.params import Linear, constant_parameter, uniform_parameter  # noqa: F401


class PReLU(nn.Module):
    """Parametric ReLU with one learnable slope, `weight` (1,), initialised to 0.25."""

    def __init__(self, init: float = 0.25, *, device=None):
        super().__init__()
        self.weight = constant_parameter((1,), init, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight)


class Pointwise(nn.Module):
    """1x1 Conv1d on channels-last input, computed as `F.linear`.

    Parameters keep the torch Conv1d layout: weight (out, in, 1), bias (out,).
    """

    def __init__(self, in_channels: int, out_channels: int, *, generator=None, device=None):
        super().__init__()
        self.weight = uniform_parameter((out_channels, in_channels, 1), in_channels,
                                        generator, device)
        self.bias = uniform_parameter((out_channels,), in_channels, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.squeeze(-1), self.bias)


class Conv1d(nn.Module):
    """Conv1d on channels-last input (B, T, C_in) -> (B, T', C_out), no padding of its own.

    Parameters keep the torch Conv1d layout: weight (out, in / groups, K), bias (out,) if
    `bias`; torch's initialisation, uniform in +-1/sqrt(in / groups * K).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1, bias: bool = True, groups: int = 1, *, generator=None,
                 device=None):
        super().__init__()
        self.dilation, self.groups = dilation, groups
        fan_in = in_channels // groups * kernel_size
        self.weight = uniform_parameter((out_channels, in_channels // groups, kernel_size),
                                        fan_in, generator, device)
        self.bias = uniform_parameter((out_channels,), fan_in, generator, device) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x.transpose(1, 2), self.weight, self.bias, dilation=self.dilation,
                        groups=self.groups).transpose(1, 2)


def choose_nonlinear(name: str | None, **kwargs) -> Callable[[torch.Tensor], torch.Tensor]:
    """Stateless activation by name (reference `src/utils/model.py:3`)."""
    if name is None:
        return lambda x: x
    name = name.lower()
    table = {
        "relu": F.relu,
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "softmax": lambda x: torch.softmax(x, dim=kwargs.get("axis", -1)),
        "silu": F.silu,
        "swish": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "leaky-relu": F.leaky_relu,
    }
    if name in table:
        return table[name]
    raise ValueError(f"Unsupported nonlinearity: {name}")
