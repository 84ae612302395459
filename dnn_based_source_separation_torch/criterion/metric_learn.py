"""Metric-learning criteria: triplet, contrastive, ArcFace.

Port of `dnn_based_source_separation_tpu/criterion/metric_learn.py` (the reference's
`src/criterion/metric_learn.py`), with its three stubs that raise.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

EPS = 1e-12


def _batch_mean(loss: torch.Tensor, batch_mean: bool) -> torch.Tensor:
    return loss.mean() if batch_mean else loss


@dataclasses.dataclass(frozen=True)
class TripletLoss:
    margin: float = 1.0
    maximize: bool = dataclasses.field(default=False, init=False)

    def __call__(self, anchor, positive, negative, batch_mean: bool = True):
        dp = (anchor - positive).square().sum(dim=-1)
        dn = (anchor - negative).square().sum(dim=-1)
        return _batch_mean(torch.clamp(dp - dn + self.margin, min=0.0), batch_mean)


@dataclasses.dataclass(frozen=True)
class ContrastiveLoss:
    margin: float = 1.0
    maximize: bool = dataclasses.field(default=False, init=False)

    def __call__(self, x1, x2, label, batch_mean: bool = True):
        """label: 1 for the same class, 0 for different ones."""
        d = torch.sqrt((x1 - x2).square().sum(dim=-1) + EPS)
        loss = label * d.square() + (1 - label) * torch.clamp(self.margin - d, min=0.0).square()
        return _batch_mean(loss, batch_mean)


def arcface_logits(embeddings: torch.Tensor, weight: torch.Tensor, labels: torch.Tensor,
                   margin: float = 0.5, scale: float = 64.0, eps: float = 1e-7) -> torch.Tensor:
    """ArcFace: the target class's logit gets the angular margin.

    embeddings (B, D); weight (n_classes, D); labels (B,) -> scaled cosine logits
    (B, n_classes) for a cross-entropy.
    """
    e = embeddings / (torch.linalg.vector_norm(embeddings, dim=-1, keepdim=True) + EPS)
    w = weight / (torch.linalg.vector_norm(weight, dim=-1, keepdim=True) + EPS)
    cos = torch.clamp(e @ w.T, -1 + eps, 1 - eps)
    theta = torch.arccos(cos)
    onehot = F.one_hot(labels.long(), weight.shape[0]).to(cos.dtype)
    return scale * (onehot * torch.cos(theta + margin) + (1 - onehot) * cos)


@dataclasses.dataclass(frozen=True)
class TripletWithDistanceLoss:
    """The triplet margin loss over a distance criterion (reference metric_learn.py:47)."""

    distance_fn: object
    margin: float = 1.0
    maximize: bool = dataclasses.field(default=False, init=False)

    def __call__(self, anchor, positive, negative, batch_mean: bool = True):
        dp = self.distance_fn(positive, anchor, batch_mean=False)
        dn = self.distance_fn(negative, anchor, batch_mean=False)
        return _batch_mean(torch.clamp(dp + self.margin - dn, min=0.0), batch_mean)


@dataclasses.dataclass(frozen=True)
class ContrastiveWithDistanceLoss:
    """The contrastive loss over a distance criterion (reference metric_learn.py:96)."""

    distance_fn: object
    margin: float = 1.0
    maximize: bool = dataclasses.field(default=False, init=False)

    def __call__(self, x1, x2, is_same, batch_mean: bool = True):
        d = self.distance_fn(x1, x2, batch_mean=False)
        loss = is_same * d.square() + (1 - is_same) * torch.clamp(self.margin - d, min=0.0).square()
        return _batch_mean(loss, batch_mean)


@dataclasses.dataclass(frozen=True)
class AdditiveAngularMarginLoss:
    """ArcFace's loss over precomputed cosine logits (reference metric_learn.py:154): the
    margin by the addition theorem cos(th + m) = cos th cos m - sin th sin m, with the
    reference's easy-margin fallback, then a scaled cross-entropy."""

    scale: float = 30.0
    margin: float = 0.5
    easy_margin: bool = False
    eps: float = 1e-12
    maximize: bool = dataclasses.field(default=False, init=False)

    def __call__(self, cos_th, target, batch_mean: bool = True):
        """cos_th (B, n_classes) cosine logits; target (B,) labels."""
        cos_m, sin_m = math.cos(self.margin), math.sin(self.margin)
        sin_th = torch.sqrt(torch.clamp(1.0 - cos_th.square(), min=0.0) + self.eps)
        cos_phi = cos_th * cos_m - sin_th * sin_m
        if self.easy_margin:
            cos_phi = torch.where(cos_th < 0, cos_th, cos_phi)
        else:
            # The reference's branch orientation, kept as the JAX package keeps it
            # (metric_learn.py:195): the opposite of the usual ArcFace fallback.
            cos_phi = torch.where(cos_th > -cos_m, cos_th - self.margin * sin_m, cos_phi)
        mask = F.one_hot(target.long(), cos_th.shape[-1]).to(cos_th.dtype)
        logits = self.scale * (mask * cos_phi + (1.0 - mask) * cos_th)
        loss = -(mask * torch.log_softmax(logits, dim=-1)).sum(dim=-1)
        return _batch_mean(loss, batch_mean)


class ImprovedTripletLoss:
    """A stub in the reference too (metric_learn.py:127)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("Implement `ImprovedTripletLoss`")


class AdaptedTripletLoss:
    """A stub in the reference too (metric_learn.py:136)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("Implement `AdaptedTripletLoss`")


class QuadrupletLoss:
    """A stub in the reference too (metric_learn.py:145)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("Implement `QuadrupletLoss`")
