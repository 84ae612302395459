"""Parameter initialisation shared by the port's modules.

Values are drawn on the CPU from the caller's `torch.Generator` and then
moved to `device`, so one seed gives the same weights on every device.
The ranges follow torch's Conv1d/ConvTranspose1d defaults (uniform in
+-1/sqrt(fan_in)), the reference implementation's framework.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def uniform_parameter(shape, fan_in: int, generator: torch.Generator | None = None,
                      device=None) -> nn.Parameter:
    bound = 1.0 / math.sqrt(fan_in)
    data = torch.empty(shape).uniform_(-bound, bound, generator=generator)
    return nn.Parameter(data.to(device))


def constant_parameter(shape, value: float, device=None) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, float(value), device=device))


class Weight(nn.Module):
    """A bare weight tensor, named `weight`, for modules computed by hand."""

    def __init__(self, shape, fan_in: int, generator=None, device=None):
        super().__init__()
        self.weight = uniform_parameter(shape, fan_in, generator, device)


class Linear(nn.Module):
    """Dense layer with torch `nn.Linear` parameters: weight (out, in), bias (out,)."""

    def __init__(self, in_features: int, out_features: int, *, generator=None, device=None):
        super().__init__()
        self.weight = uniform_parameter((out_features, in_features), in_features,
                                        generator, device)
        self.bias = uniform_parameter((out_features,), in_features, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)
