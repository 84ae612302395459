"""Cross-entropy criteria and the dice loss, with `batch_mean`.

Port of `dnn_based_source_separation_tpu/criterion/entropy.py`.
"""
from __future__ import annotations

import dataclasses

import torch

EPS = 1e-12


def _mean_but_batch(loss: torch.Tensor) -> torch.Tensor:
    return loss.mean(dim=tuple(range(1, loss.dim()))) if loss.dim() > 1 else loss


@dataclasses.dataclass(frozen=True)
class BinaryCrossEntropy:
    eps: float = EPS
    maximize: bool = dataclasses.field(default=False, init=False)

    def __call__(self, input, target, batch_mean: bool = True):
        """input: probabilities in [0, 1]; target: {0, 1}; shapes (B, ...)."""
        p = torch.clamp(input, self.eps, 1.0 - self.eps)
        loss = _mean_but_batch(-(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p)))
        return loss.mean(dim=0) if batch_mean else loss


@dataclasses.dataclass(frozen=True)
class CategoricalCrossEntropy:
    eps: float = EPS
    maximize: bool = dataclasses.field(default=False, init=False)

    def __call__(self, input, target, batch_mean: bool = True):
        """input: probabilities over the classes (last axis); target: one-hot."""
        p = torch.clamp(input, min=self.eps, max=1.0)
        loss = _mean_but_batch(-(target * torch.log(p)).sum(dim=-1))
        return loss.mean(dim=0) if batch_mean else loss


@dataclasses.dataclass(frozen=True)
class DiceLoss:
    eps: float = EPS
    maximize: bool = dataclasses.field(default=False, init=False)

    def __call__(self, input, target, batch_mean: bool = True):
        dims = tuple(range(1, input.dim()))
        num = 2.0 * (input * target).sum(dim=dims)
        den = input.sum(dim=dims) + target.sum(dim=dims)
        loss = 1.0 - (num + self.eps) / (den + self.eps)
        return loss.mean(dim=0) if batch_mean else loss
