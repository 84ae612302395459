"""Distance criteria: L1, L2, MSE, MAE and cosine similarity.

Port of `dnn_based_source_separation_tpu/criterion/distance.py:1-94`. Every
class implements the reference call protocol `(input, target,
batch_mean=True)` with a `maximize` attribute: the distance reduces `dim`
(default every axis but the batch), then the mean over what is left but
the batch, then, with `batch_mean`, the mean over the batch.
"""
from __future__ import annotations

import dataclasses

import torch

EPS = 1e-12


def _dims(x: torch.Tensor, dim) -> tuple:
    if dim is None:
        return tuple(range(1, x.dim()))
    return (dim,) if isinstance(dim, int) else tuple(dim)


def _finish(loss: torch.Tensor, middle: bool, batch_mean: bool) -> torch.Tensor:
    """The mean over the non-batch axes left (when `middle`), then over the batch."""
    if middle and loss.dim() > 1:
        loss = loss.mean(dim=tuple(range(1, loss.dim())))
    if batch_mean:
        loss = loss.mean(dim=0)
    return loss


@dataclasses.dataclass(frozen=True)
class L1Loss:
    dim: object = None
    reduction: str | None = "mean"
    maximize: bool = dataclasses.field(default=False, init=False)

    def __call__(self, input, target, batch_mean: bool = True):
        loss = (input - target).abs().sum(dim=_dims(input, self.dim))
        return _finish(loss, self.reduction == "mean", batch_mean)


@dataclasses.dataclass(frozen=True)
class L2Loss:
    dim: object = None
    reduction: str | None = "mean"
    eps: float = EPS
    maximize: bool = dataclasses.field(default=False, init=False)

    def __call__(self, input, target, batch_mean: bool = True):
        loss = torch.sqrt((input - target).square().sum(dim=_dims(input, self.dim)) + self.eps)
        return _finish(loss, self.reduction == "mean", batch_mean)


@dataclasses.dataclass(frozen=True)
class MSELoss:
    dim: object = None
    maximize: bool = dataclasses.field(default=False, init=False)

    def __call__(self, input, target, batch_mean: bool = True):
        loss = (input - target).square().mean(dim=_dims(input, self.dim))
        return _finish(loss, True, batch_mean)


@dataclasses.dataclass(frozen=True)
class MAELoss:
    dim: object = None
    maximize: bool = dataclasses.field(default=False, init=False)

    def __call__(self, input, target, batch_mean: bool = True):
        loss = (input - target).abs().mean(dim=_dims(input, self.dim))
        return _finish(loss, True, batch_mean)


@dataclasses.dataclass(frozen=True)
class CosineSimilarityLoss:
    dim: int = -1
    eps: float = EPS
    maximize: bool = dataclasses.field(default=True, init=False)

    def __call__(self, input, target, batch_mean: bool = True):
        num = (input * target).sum(dim=self.dim)
        den = (torch.linalg.vector_norm(input, dim=self.dim)
               * torch.linalg.vector_norm(target, dim=self.dim))
        return _finish(num / (den + self.eps), True, batch_mean)
