"""TasNet normalizations: global LN, cumulative (causal) LN, channel LN.

Port of `dnn_based_source_separation_tpu/ops/norms.py`. Inputs are
channels-last (..., T, N). Parameters follow the reference torch layout
`gamma`/`beta` of shape (1, N, 1) (`hub/torch_convert.py:_gamma_beta_params`).
Streaming cLN state is not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from .params import constant_parameter


def global_layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                      eps: float = 1e-8) -> torch.Tensor:
    """Normalize over (T, N) jointly per sample; two-pass mean and centred variance."""
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = (x - mean).square().mean(dim=(-2, -1), keepdim=True)
    return gamma * (x - mean) / torch.sqrt(var + eps) + beta


def cumulative_layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                          eps: float = 1e-8) -> torch.Tensor:
    """Causal layer norm: statistics over channels and all frames <= t."""
    T, N = x.shape[-2:]
    t_count = torch.arange(1, T + 1, dtype=x.dtype, device=x.device)[:, None] * N
    # Scan over the last dimension: on CUDA a cumsum over a size-1 inner
    # dimension runs serially (38 ms per causal DPRNN-TasNet forward at
    # B=8 x 4 s on an NVIDIA H100 80GB HBM3 at 700 W), the innermost-dimension
    # scan in parallel.
    cum_sum = x.sum(dim=-1).cumsum(dim=-1).unsqueeze(-1)
    cum_sq = x.square().sum(dim=-1).cumsum(dim=-1).unsqueeze(-1)
    mean = cum_sum / t_count
    var = cum_sq / t_count - mean.square()
    return gamma * (x - mean) / torch.sqrt(var + eps) + beta


class _AffineNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-8, *, device=None):
        super().__init__()
        self.features, self.eps = features, eps
        self.gamma = constant_parameter((1, features, 1), 1.0, device)
        self.beta = constant_parameter((1, features, 1), 0.0, device)

    def affine(self):
        return self.gamma.view(-1), self.beta.view(-1)


class GlobalLayerNorm(_AffineNorm):
    """gLN over (T, N) for channels-last inputs (..., T, N).

    `affine=False` is the folded-inference mode (models/fold.py): gamma and
    beta stay as parameters but the affine pass is skipped, because the fold
    moved them into the next linear op. A requested frame `pad` is then
    filled with -beta/gamma, whose affine image is zero, so the folded conv
    over padded frames equals the unfolded zero-padded-after-affine result.
    """

    def __init__(self, features: int, eps: float = 1e-8, affine: bool = True, *, device=None):
        super().__init__(features, eps, device=device)
        self.apply_affine = affine

    def forward(self, x: torch.Tensor, pad: tuple = (0, 0)) -> torch.Tensor:
        gamma, beta = self.affine()
        pl, pr = pad
        if self.apply_affine:
            y = global_layer_norm(x, gamma, beta, self.eps)
            if pl or pr:
                y = nn.functional.pad(y, (0, 0, pl, pr))
            return y
        mean = x.mean(dim=(-2, -1), keepdim=True)
        var = (x - mean).square().mean(dim=(-2, -1), keepdim=True)
        y = (x - mean) / torch.sqrt(var + self.eps)
        if pl or pr:
            # gamma == 0 makes the folded kernel column zero anyway, so the
            # fill value is irrelevant there; avoid the division.
            safe = torch.where(gamma == 0, torch.ones_like(gamma), gamma)
            fill = torch.where(gamma == 0, torch.zeros_like(beta), -beta / safe).to(y.dtype)
            parts = []
            if pl:
                parts.append(fill.expand(*y.shape[:-2], pl, self.features))
            parts.append(y)
            if pr:
                parts.append(fill.expand(*y.shape[:-2], pr, self.features))
            y = torch.cat(parts, dim=-2)
        return y


class CumulativeLayerNorm(_AffineNorm):
    """Causal cLN for channels-last inputs (..., T, N); offline only."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.affine()
        return cumulative_layer_norm(x, gamma, beta, self.eps)


class ChannelLayerNorm(_AffineNorm):
    """Per-frame layer norm over channels only."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.affine()
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return gamma * (x - mean) / torch.sqrt(var + self.eps) + beta


def choose_layer_norm(kind: str, features: int, causal: bool = False, eps: float = 1e-8,
                      affine: bool = True, *, device=None):
    """Factory; `affine=False` (folded inference) is defined for gLN only."""
    if kind in ("cLN",) or causal:
        if not affine:
            raise ValueError("affine folding is only supported for gLN")
        return CumulativeLayerNorm(features, eps=eps, device=device)
    if kind in ("gLN", "global"):
        return GlobalLayerNorm(features, eps=eps, affine=affine, device=device)
    if kind in ("LN", "layer", "channel"):
        if not affine:
            raise ValueError("affine folding is only supported for gLN")
        return ChannelLayerNorm(features, eps=eps, device=device)
    raise ValueError(f"Unsupported layer norm: {kind}")
