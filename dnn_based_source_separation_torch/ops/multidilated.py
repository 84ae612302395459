"""Multi-dilated 2-D convolution: a dilation for each group of input channels.

Port of `dnn_based_source_separation_tpu/ops/multidilated.py` (reference
`src/modules/conv.py:227` MultiDilatedConv2d). The input's channels split into groups;
group i is convolved by its own `conv{i}` at dilation 2^i with "same" padding, (p // 2,
p - p // 2) for p = (k - 1) 2^i, padded by hand (`F.pad`: `nn.Conv2d`'s symmetric
`padding` differs for an even kernel); the groups' outputs are summed. NCHW.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from .params import uniform_parameter


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class MultiDilatedConv2d(nn.Module):
    """(B, C_in, H, W) -> (B, out_channels, H, W).

    `in_channels`: the channel count, split into `groups` equal groups, or a list of the
    groups' channel counts.
    """

    def __init__(self, in_channels: Union[int, Sequence[int]], out_channels: int,
                 kernel_size=(3, 3), groups: int | None = None, bias: bool = True, *,
                 generator=None, device=None):
        super().__init__()
        if isinstance(in_channels, (list, tuple)):
            sections = list(in_channels)
        else:
            if groups is None:
                raise ValueError("Specify groups")
            if in_channels % groups:
                raise ValueError(f"in_channels {in_channels} is not a multiple of groups {groups}")
            sections = [in_channels // groups] * groups
        self.sections = sections
        kh, kw = _pair(kernel_size)
        self.pads = []
        for idx, sec in enumerate(sections):
            dil = 2 ** idx
            conv = nn.Conv2d(sec, out_channels, (kh, kw), dilation=dil, bias=bias,
                             device="meta")
            fan_in = sec * kh * kw
            conv.weight = uniform_parameter(conv.weight.shape, fan_in, generator, device)
            if bias:
                conv.bias = uniform_parameter((out_channels,), fan_in, generator, device)
            self.add_module(f"conv{idx}", conv)
            ph, pw = (kh - 1) * dil, (kw - 1) * dil
            self.pads.append((pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != sum(self.sections):
            raise ValueError(f"{x.shape[1]} input channels, expected {sum(self.sections)}")
        out = 0.0
        for idx, xi in enumerate(x.split(self.sections, dim=1)):
            out = out + getattr(self, f"conv{idx}")(F.pad(xi, self.pads[idx]))
        return out
