"""LaSAFT: latent source attentive frequency transformation, with its TDF and TFC blocks.

Port of `dnn_based_source_separation_tpu/models/lasaft.py` (TDF2d, MultiheadTDF2d, TFC2d,
LaSAFT, TFCLaSAFT; reference `src/models/lasaft.py` and the TDF / TFC blocks of
`src/models/cunet.py`; Choi et al., arXiv:2010.11631). NCHW spectrogram maps: (B, C, F, T)
where JAX's are (B, F, T, C).

- TDF2d is a dense layer along the bin axis applied per frame and channel (no bias by
  default); MultiheadTDF2d stacks `num_heads` of them on a new last dim.
- TFC2d is a dense block of BN (eps 1e-5, flax's train mode) -> nonlinear -> KxK conv
  ("same" pad (p // 2, p - p // 2), by hand) layers, each but the last concatenated to its
  input; its output is the last layer's.
- LaSAFT attends over the heads: softmax(q(embedding) @ key / sqrt(hidden_dim)), `key` a
  parameter (hidden_dim, num_heads) drawn from a unit normal.

The JAX package has no converter of the reference layout for these: the names follow the
JAX tree (`tfc2d.norm{i}` / `conv{i}`, `tdf_in.fc`, `tdf_heads.head{i}.fc`,
`lasaft.key`, `lasaft.transform_query`), and `hub/from_jax.py:tree_state_dict_from_jax`
maps one onto the other.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.norms import BatchNorm2d
from ..ops.params import Linear
from .m_densenet import _pair, conv2d, pad2d
from .modules import choose_nonlinear


class TDF2d(nn.Module):
    """(B, C, F_in, T) -> (B, C, F_out, T)."""

    def __init__(self, in_bins: int, out_bins: int, nonlinear: Optional[str] = "relu",
                 bias: bool = False, *, generator=None, device=None):
        super().__init__()
        self.nonlinear = nonlinear
        self.fc = Linear(in_bins, out_bins, bias=bias, generator=generator, device=device)

    def forward(self, x):
        h = self.fc(x.transpose(2, 3)).transpose(2, 3)
        return choose_nonlinear(self.nonlinear)(h) if self.nonlinear else h


class MultiheadTDF2d(nn.Module):
    """(B, C, F_in, T) -> (B, C, F_out, T, num_heads)."""

    def __init__(self, in_bins: int, out_bins: int, num_heads: int = 2,
                 nonlinear: Optional[str] = "relu", bias: bool = False, *, generator=None,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        for i in range(num_heads):
            self.add_module(f"head{i}", TDF2d(in_bins, out_bins, nonlinear, bias,
                                              generator=generator, device=device))

    def forward(self, x):
        return torch.stack([getattr(self, f"head{i}")(x) for i in range(self.num_heads)],
                           dim=-1)


class TFC2d(nn.Module):
    """(B, C_in, F, T) -> (B, growth_rate, F, T)."""

    def __init__(self, in_channels: int, growth_rate: int, kernel_size=(3, 3),
                 num_layers: int = 2, nonlinear: Optional[str] = "relu", *, generator=None,
                 device=None):
        super().__init__()
        self.num_layers, self.nonlinear = num_layers, nonlinear
        kh, kw = _pair(kernel_size)
        self.pads = (kh - 1, kw - 1)
        for idx in range(num_layers):
            channels = in_channels + idx * growth_rate
            self.add_module(f"norm{idx}", BatchNorm2d(channels, eps=1e-5, device=device))
            self.add_module(f"conv{idx}", conv2d(channels, growth_rate, (kh, kw),
                                                 generator=generator, device=device))

    def forward(self, x):
        feats = x
        for idx in range(self.num_layers):
            h = choose_nonlinear(self.nonlinear)(getattr(self, f"norm{idx}")(feats))
            h = getattr(self, f"conv{idx}")(pad2d(h, *self.pads))
            feats = torch.cat([feats, h], dim=1) if idx < self.num_layers - 1 else h
        return feats


class LaSAFT(nn.Module):
    """(value (B, C, F, T, num_heads), embedding (B, E)) -> (B, C, F, T)."""

    def __init__(self, embedding_dim: int, hidden_dim: int, num_heads: int = 2, *,
                 generator=None, device=None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.key = nn.Parameter(torch.randn(hidden_dim, num_heads, generator=generator)
                                .to(device))
        self.transform_query = Linear(embedding_dim, hidden_dim, generator=generator,
                                      device=device)

    def forward(self, value, embedding):
        qk = self.transform_query(embedding) @ self.key / math.sqrt(self.hidden_dim)
        return torch.einsum("bcfth,bh->bcft", value, torch.softmax(qk, dim=-1))


class TFCLaSAFT(nn.Module):
    """TFC, then LaSAFT over a bottleneck TDF's heads, added: (B, C_in, n_bins, T), (B, E)
    -> (B, growth_rate, n_bins, T)."""

    def __init__(self, in_channels: int, growth_rate: int, hidden_dim: int, n_bins: int,
                 bottleneck_bins: int, embedding_dim: int, kernel_size=(3, 3),
                 num_layers: int = 2, num_heads: int = 2, nonlinear: str = "relu", *,
                 generator=None, device=None):
        super().__init__()
        common = dict(generator=generator, device=device)
        self.tfc2d = TFC2d(in_channels, growth_rate, kernel_size, num_layers, nonlinear,
                           **common)
        self.tdf_in = TDF2d(n_bins, bottleneck_bins, nonlinear, **common)
        self.tdf_heads = MultiheadTDF2d(bottleneck_bins, n_bins, num_heads, nonlinear,
                                        **common)
        self.lasaft = LaSAFT(embedding_dim, hidden_dim, num_heads, **common)

    def forward(self, x, embedding):
        h = self.tfc2d(x)
        return h + self.lasaft(self.tdf_heads(self.tdf_in(h)), embedding)
