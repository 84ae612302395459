"""Attention primitives: sinusoidal positional encoding, multi-head self-attention with
torch `nn.MultiheadAttention` parameters, and the transformer encoder layer.

Port of `dnn_based_source_separation_tpu/ops/attention.py`: `positional_encoding`
(:20), `MultiheadAttention` (:29-76) and `TransformerEncoderLayer` (:79-119).

`MultiheadAttention`: (B, T, E) -> (B, T, E). One packed input projection `in_proj`
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

`TransformerEncoderLayer` is torch's `nn.TransformerEncoderLayer` with
`batch_first=True`, post-norm unless `norm_first`, `relu` or `gelu` (the
tanh approximation, flax's `nn.gelu` default), dropout at torch's four
places (the attention weights, after the attention, inside the feed-forward
block and after it) drawn from the explicit generator of `ops/dropout.py`.
Its parameter names are torch's (`self_attn`, `linear1`, `linear2`, `norm1`,
`norm2`), those `hub/torch_convert.py:_transformer_layer_params` reads. Its
two layer norms are `torch.nn.LayerNorm` (eps 1e-5), which centres before it
squares: var = mean((x - mean)^2). flax's `nn.LayerNorm`, the JAX package's,
defaults to the one-pass var = max(mean(x^2) - mean^2, 0); the two agree to
float rounding on rows whose mean is not large against their spread, and the
port keeps the two-pass form, which stays exact where the one-pass form
cancels (rows of large mean and small spread).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .dropout import Dropout
from .params import Linear, constant_parameter, uniform_parameter

MASKED = -1e9


def _interleaved_encoding(T: int, num_features: int, base: float) -> np.ndarray:
    position = np.arange(T, dtype=np.float32)
    index = np.arange(0, num_features, 2, dtype=np.float32) / num_features
    indices = position[:, None] / (base ** index[None, :])  # (T, F // 2)
    return np.stack([np.sin(indices), np.cos(indices)], axis=-1).reshape(T, num_features)


@functools.lru_cache(maxsize=128)
def encoding_on(table, *key, device=None, dtype=torch.float32) -> torch.Tensor:
    """`table(*key)`, a host-computed f32 numpy table, as a tensor on `device` in `dtype`,
    made once per key, device and dtype (so a forward on the card copies nothing from the
    host). A normal tensor even when first made under `torch.inference_mode()`, so a
    later training forward may use it."""
    with torch.inference_mode(False):
        return torch.from_numpy(table(*key)).to(device=device, dtype=dtype)


def positional_encoding(T: int, num_features: int, base: float = 10000.0, *, device=None,
                        dtype=torch.float32) -> torch.Tensor:
    """(T, num_features) sinusoidal encoding, sin and cos interleaved (reference
    transformer.py:7): column 2i is sin(t / base^(2i / F)), column 2i + 1 its cos.

    Computed on the host in f32 with numpy, as the JAX package computes it, so both give
    the same values; then kept on `device` in `dtype`.
    """
    return encoding_on(_interleaved_encoding, int(T), int(num_features), float(base),
                       device=torch.device(device or "cpu"), dtype=dtype)


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


_ACTIVATIONS = {"relu": F.relu, "gelu": lambda x: F.gelu(x, approximate="tanh")}


class TransformerEncoderLayer(nn.Module):
    """(B, T, E) -> (B, T, E): self-attention and a feed-forward block, each with its
    residual and LayerNorm (after the residual, or before the block if `norm_first`)."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int = 2048, nonlinear: str = "relu",
                 norm_first: bool = False, dropout: float = 0.0, eps: float = 1e-5, *,
                 generator=None, device=None):
        super().__init__()
        if nonlinear not in _ACTIVATIONS:
            raise ValueError(f"Unsupported nonlinearity: {nonlinear}")
        self.norm_first = norm_first
        self.activation = _ACTIVATIONS[nonlinear]
        self.self_attn = MultiheadAttention(d_model, num_heads, dropout=dropout,
                                            generator=generator, device=device)
        self.linear1 = Linear(d_model, d_ff, generator=generator, device=device)
        self.linear2 = Linear(d_ff, d_model, generator=generator, device=device)
        self.norm1 = nn.LayerNorm(d_model, eps=eps, device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=eps, device=device)
        self.dropout = Dropout(dropout)  # inside the feed-forward block
        self.dropout1 = Dropout(dropout)  # after the attention
        self.dropout2 = Dropout(dropout)  # after the feed-forward block

    def _attention(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout1(self.self_attn(x))

    def _feed_forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout2(self.linear2(self.dropout(self.activation(self.linear1(x)))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm_first:
            x = x + self._attention(self.norm1(x))
            return x + self._feed_forward(self.norm2(x))
        x = self.norm1(x + self._attention(x))
        return self.norm2(x + self._feed_forward(x))
