"""Shared building blocks: PReLU, 1x1 convolution, dense layer, nonlinearity factory.

Port of `dnn_based_source_separation_tpu/models/modules.py` (PReLU,
choose_nonlinear). GLU/GTU come with the models that use them; the RNN
factory is `ops/rnn.py:choose_rnn`.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.params import constant_parameter, uniform_parameter


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


class Linear(nn.Module):
    """Dense layer with torch `nn.Linear` parameters: weight (out, in), bias (out,)."""

    def __init__(self, in_features: int, out_features: int, *, generator=None, device=None):
        super().__init__()
        self.weight = uniform_parameter((out_features, in_features), in_features,
                                        generator, device)
        self.bias = uniform_parameter((out_features,), in_features, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


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
