"""SDR-family criteria: SDR, SI-SDR and their negatives.

Port of `dnn_based_source_separation_tpu/criterion/sdr.py:19-33, 74-121`.
Every class implements the reference call protocol
`(input, target, batch_mean=True)` with a `maximize` attribute for PIT.

Shapes: (B, T), (B, n_sources, T) or (B, n_sources, n_mics, T); the metric
reduces the last axis, `reduction` averages or sums the middle dims.
"""
from __future__ import annotations

import dataclasses

import torch

EPS = 1e-12


def sdr(input: torch.Tensor, target: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Source-to-distortion ratio in dB over the last axis."""
    num = torch.sum(target.square(), dim=-1) + eps
    den = torch.sum((target - input).square(), dim=-1) + eps
    return 10.0 * torch.log10(num / den)


def sisdr(input: torch.Tensor, target: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Scale-invariant SDR ("SDR - half-baked or well done?", arXiv:1811.02508)."""
    alpha = torch.sum(input * target, dim=-1, keepdim=True) / (
        torch.sum(target.square(), dim=-1, keepdim=True) + eps)
    num = torch.sum((alpha * target).square(), dim=-1) + eps
    den = torch.sum((alpha * target - input).square(), dim=-1) + eps
    return 10.0 * torch.log10(num / den)


def _reduce(loss: torch.Tensor, reduction: str | None, batch_mean: bool) -> torch.Tensor:
    """The reference reduction protocol: middle dims, then the batch dim."""
    if reduction and loss.dim() > 1:
        dims = tuple(range(1, loss.dim()))
        loss = loss.mean(dim=dims) if reduction == "mean" else loss.sum(dim=dims)
    if batch_mean:
        loss = loss.mean(dim=0)
    return loss


@dataclasses.dataclass(frozen=True)
class SDR:
    reduction: str | None = "mean"
    eps: float = EPS
    maximize: bool = dataclasses.field(default=True, init=False)

    def __call__(self, input, target, batch_mean: bool = True):
        return _reduce(sdr(input, target, eps=self.eps), self.reduction, batch_mean)


@dataclasses.dataclass(frozen=True)
class NegSDR:
    reduction: str | None = "mean"
    eps: float = EPS
    maximize: bool = dataclasses.field(default=False, init=False)

    def __call__(self, input, target, batch_mean: bool = True):
        return _reduce(-sdr(input, target, eps=self.eps), self.reduction, batch_mean)


@dataclasses.dataclass(frozen=True)
class SISDR:
    reduction: str | None = "mean"
    eps: float = EPS
    maximize: bool = dataclasses.field(default=True, init=False)

    def __call__(self, input, target, batch_mean: bool = True):
        return _reduce(sisdr(input, target, eps=self.eps), self.reduction, batch_mean)


@dataclasses.dataclass(frozen=True)
class NegSISDR:
    reduction: str | None = "mean"
    eps: float = EPS
    maximize: bool = dataclasses.field(default=False, init=False)

    def __call__(self, input, target, batch_mean: bool = True):
        return _reduce(-sisdr(input, target, eps=self.eps), self.reduction, batch_mean)
