"""Multi-head self-attention with torch `nn.MultiheadAttention` parameters.

Port of `dnn_based_source_separation_tpu/ops/attention.py:MultiheadAttention`
(:29-76): (B, T, E) -> (B, T, E). One packed input projection `in_proj`
(3E, E), split into q, k and v in that order; scores q·kᵀ divided by
sqrt(d) computed in x's dtype, as JAX divides; `causal` adds the constant
bias triu(-1e9, k=1); a bool `attn_mask` is True where masked (-1e9 added),
a float one is added as it is; softmax over the keys; dropout on the
attention weights by flax's rule from an explicit generator (`ops/dropout.py`);
then `out_proj`. The JAX package computes attention outside any Pallas
kernel, so this is plain `torch.matmul` and `softmax` on both devices.

Parameter names are torch's (`in_proj_weight`, `in_proj_bias`,
`out_proj.weight`, `out_proj.bias`), the names
`hub/torch_convert.py:_mha_params` reads; their initialisation is torch's
(Xavier-uniform `in_proj_weight`, uniform +-1/sqrt(E) `out_proj.weight`,
zero biases), drawn from the caller's generator.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .dropout import Dropout
from .params import constant_parameter, uniform_parameter

MASKED = -1e9


class _OutProjection(nn.Module):
    """torch's `out_proj`: weight (E, E) uniform in +-1/sqrt(E), bias (E,) zero."""

    def __init__(self, E: int, generator=None, device=None):
        super().__init__()
        self.weight = uniform_parameter((E, E), E, generator, device)
        self.bias = constant_parameter((E,), 0.0, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class MultiheadAttention(nn.Module):
    """Self-attention over (B, T, E); `attn_mask` (T, T), bool (True = masked) or float."""

    def __init__(self, embed_dim: int, num_heads: int, causal: bool = False,
                 dropout: float = 0.0, *, generator=None, device=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} must be divisible by num_heads {num_heads}")
        self.embed_dim, self.num_heads, self.causal = embed_dim, num_heads, causal
        E = embed_dim
        bound = math.sqrt(6.0 / (E + 3 * E))  # Xavier-uniform over (3E, E)
        weight = torch.empty(3 * E, E).uniform_(-bound, bound, generator=generator)
        self.in_proj_weight = nn.Parameter(weight.to(device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * E, device=device))
        self.out_proj = _OutProjection(E, generator, device)
        self.attn_dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor | None = None) -> torch.Tensor:
        B, T, E = x.shape
        h = self.num_heads
        d = E // h
        q, k, v = (t.reshape(B, T, h, d).transpose(1, 2)  # (B, h, T, d)
                   for t in F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1))
        scores = torch.matmul(q, k.transpose(-1, -2)) / torch.sqrt(
            torch.tensor(d, dtype=x.dtype, device=x.device))
        if self.causal:
            bias = torch.full((T, T), MASKED, dtype=torch.float32, device=x.device).triu(1)
            scores = scores + bias.to(scores.dtype)
        if attn_mask is not None:
            if attn_mask.dtype == torch.bool:
                attn_mask = torch.where(attn_mask, MASKED, 0.0)
            scores = scores + attn_mask.to(scores.dtype)
        attn = self.attn_dropout(torch.softmax(scores, dim=-1))
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, T, E)
        return self.out_proj(out)
