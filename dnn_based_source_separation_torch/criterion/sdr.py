"""SDR-family criteria: SDR, SI-SDR, thresholded SNR, weighted SDR and their negatives.

Port of `dnn_based_source_separation_tpu/criterion/sdr.py:19-51, 54-121, 139-176`,
with MixIT's thresholded SNR.
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


def thresholded_snr(input: torch.Tensor, target: torch.Tensor, threshold_db: float = 30.0,
                    eps: float = EPS) -> torch.Tensor:
    """Soft-thresholded SNR in dB (MixIT, arXiv:2006.12701 eq. 2):
    10 log10(|t|^2 / (|t - e|^2 + tau |t|^2)), tau = 10^(-threshold_db / 10), which caps the
    SNR at threshold_db so solved sources stop dominating the loss."""
    tau = 10.0 ** (-threshold_db / 10.0)
    t_pow = target.square().sum(dim=-1)
    err = (target - input).square().sum(dim=-1)
    return 10.0 * torch.log10((t_pow + eps) / (err + tau * t_pow + eps))


def weighted_sdr(input: torch.Tensor, target: torch.Tensor, source_dim: int = 1,
                 eps: float = EPS) -> torch.Tensor:
    """Weighted SDR ("Phase-Aware Speech Enhancement with Deep Complex U-Net").

    The rho-weighted cosine similarity of (target, input) and of the residual
    pair (mixture - target, mixture - input); mixture = the targets summed
    over `source_dim`.
    """
    mixture = target.sum(dim=source_dim, keepdim=True)
    target_power = target.square().sum(dim=-1)
    cos = ((target * input).sum(dim=-1) + eps) / (
        torch.linalg.vector_norm(target, dim=-1) * torch.linalg.vector_norm(input, dim=-1) + eps)
    res_in, res_tgt = mixture - input, mixture - target
    res_power = res_tgt.square().sum(dim=-1)
    cos_res = ((res_tgt * res_in).sum(dim=-1) + eps) / (
        torch.linalg.vector_norm(res_tgt, dim=-1) * torch.linalg.vector_norm(res_in, dim=-1)
        + eps)
    rho = (target_power + eps) / (target_power + res_power + eps)
    return rho * cos + (1.0 - rho) * cos_res


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


@dataclasses.dataclass(frozen=True)
class NegThresholdedSNR:
    """MixIT's training loss (see `thresholded_snr`)."""

    threshold_db: float = 30.0
    reduction: str | None = "mean"
    eps: float = EPS
    maximize: bool = dataclasses.field(default=False, init=False)

    def __call__(self, input, target, batch_mean: bool = True):
        loss = -thresholded_snr(input, target, threshold_db=self.threshold_db, eps=self.eps)
        return _reduce(loss, self.reduction, batch_mean)


@dataclasses.dataclass(frozen=True)
class WeightedSDR:
    source_dim: int = 1
    reduction: str | None = "mean"
    eps: float = EPS
    maximize: bool = dataclasses.field(default=True, init=False)

    def __call__(self, input, target, batch_mean: bool = True):
        loss = weighted_sdr(input, target, source_dim=self.source_dim, eps=self.eps)
        return _reduce(loss, self.reduction, batch_mean)


@dataclasses.dataclass(frozen=True)
class NegWeightedSDR:
    source_dim: int = 1
    reduction: str | None = "mean"
    eps: float = EPS
    maximize: bool = dataclasses.field(default=False, init=False)

    def __call__(self, input, target, batch_mean: bool = True):
        loss = -weighted_sdr(input, target, source_dim=self.source_dim, eps=self.eps)
        return _reduce(loss, self.reduction, batch_mean)
