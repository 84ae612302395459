"""TasNet normalizations: global LN, cumulative (causal) LN, channel LN; and flax's
train-mode BatchNorm.

Port of `dnn_based_source_separation_tpu/ops/norms.py`. Inputs are
channels-last (..., T, N). Parameters follow the reference torch layout
`gamma`/`beta` of shape (1, N, 1) (`hub/torch_convert.py:_gamma_beta_params`).
cLN also streams, carrying its running statistics (`CumulativeLayerNorm.stream`).

`flax_batch_norm` is flax's `nn.BatchNorm(momentum=0.9)` in train mode on a torch
BatchNorm module's parameters and buffers, over any channel axis: UMX's and MRX's 1-D
blocks (channels last) and the 2-D dense / U-Net family (`BatchNorm2d`, NCHW;
`BatchNorm1d`, (B, C, T)) call it.
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


def flax_batch_norm(x: torch.Tensor, norm: nn.modules.batchnorm._BatchNorm,
                    dim: int = -1, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """flax's train-mode BatchNorm over every axis of `x` but `dim`, with `norm`'s
    weight, bias and eps; updates its buffers.

    The mean and the biased variance (E[x^2] - E[x]^2, clipped at 0), computed in `dtype`
    (f32 whatever x's dtype, f64 too, unless the caller asks for another), then
    `running = 0.9 * running + 0.1 * batch` for both, in place, and
    `num_batches_tracked` counts the updates. (torch's train mode puts the unbiased
    variance into `running_var`: another function.)
    """
    dim = dim % x.ndim
    dims = [d for d in range(x.ndim) if d != dim]
    shape = [-1 if d == dim else 1 for d in range(x.ndim)]
    xf = x.to(dtype)
    mean = xf.mean(dim=dims)
    var = torch.clamp(xf.square().mean(dim=dims) - mean.square(), min=0.0)
    with torch.no_grad():
        for buf, batch in ((norm.running_mean, mean), (norm.running_var, var)):
            buf.copy_(0.9 * buf + 0.1 * batch)
        norm.num_batches_tracked.add_(1)
    mul = torch.rsqrt(var + norm.eps) * norm.weight.to(dtype)
    return ((xf - mean.view(shape)) * mul.view(shape) + norm.bias.to(dtype).view(shape)).to(x.dtype)


class _FlaxTrainMode:
    """flax's train mode (`flax_batch_norm` over the channel axis, dim 1) for a torch
    BatchNorm; eval mode uses the running statistics, as both do."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return flax_batch_norm(x, self, dim=1)
        return super().forward(x)


class BatchNorm1d(_FlaxTrainMode, nn.BatchNorm1d):
    """`nn.BatchNorm1d` over (B, C, T), torch's names, flax's train mode."""


class BatchNorm2d(_FlaxTrainMode, nn.BatchNorm2d):
    """`nn.BatchNorm2d` over NCHW, torch's names, flax's train mode."""


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
    """Causal cLN for channels-last inputs (..., T, N)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.affine()
        return cumulative_layer_norm(x, gamma, beta, self.eps)

    def stream(self, x: torch.Tensor, stats: torch.Tensor | None = None):
        """Exact streaming: continue the statistics `stats` (..., 3) f32 (None = stream start).

        `stats` holds the running [frame count, sum, sum of squares] per
        leading index, in f32 whatever x's dtype, so chunk-by-chunk calls
        reproduce the offline cumulative statistics. Returns (y, stats). An
        empty call (T = 0) is the drain call: x and stats come back as they were.
        """
        if stats is None:
            stats = torch.zeros(x.shape[:-2] + (3,), dtype=torch.float32, device=x.device)
        T, N = x.shape[-2:]
        if T == 0:
            return x, stats
        gamma, beta = self.affine()
        xf = x.float()
        t_idx = torch.arange(1, T + 1, dtype=torch.float32, device=x.device)
        t_count = (stats[..., 0:1] + t_idx) * N  # (..., T)
        cum_sum = stats[..., 1:2] + xf.sum(dim=-1).cumsum(dim=-1)
        cum_sq = stats[..., 2:3] + xf.square().sum(dim=-1).cumsum(dim=-1)
        mean = cum_sum / t_count
        var = cum_sq / t_count - mean.square()
        y = (gamma * (x - mean.unsqueeze(-1).to(x.dtype))
             / torch.sqrt(var + self.eps).unsqueeze(-1).to(x.dtype) + beta)
        stats = torch.stack([stats[..., 0] + T, cum_sum[..., -1], cum_sq[..., -1]], dim=-1)
        return y, stats


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
