"""Divergences between nonnegative spectra: KL, Itakura-Saito, generalized KL, beta.

Port of `dnn_based_source_separation_tpu/criterion/divergence.py`; each sums over the
last axis.
"""
from __future__ import annotations

import torch

EPS = 1e-12


def kl_divergence(input: torch.Tensor, target: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """sum target * log(target / input)."""
    ratio = (target + eps) / (input + eps)
    return (target * torch.log(ratio)).sum(dim=-1)


def generalized_kl_divergence(input: torch.Tensor, target: torch.Tensor,
                              eps: float = EPS) -> torch.Tensor:
    ratio = (target + eps) / (input + eps)
    return (target * torch.log(ratio) - target + input).sum(dim=-1)


def is_divergence(input: torch.Tensor, target: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Itakura-Saito: sum target / input - log(target / input) - 1."""
    ratio = (target + eps) / (input + eps)
    return (ratio - torch.log(ratio) - 1.0).sum(dim=-1)


def beta_divergence(input: torch.Tensor, target: torch.Tensor, beta: float = 2.0,
                    eps: float = EPS) -> torch.Tensor:
    """The beta family: beta = 0 Itakura-Saito, 1 generalized KL, 2 half the squared error."""
    if beta == 0.0:
        return is_divergence(input, target, eps=eps)
    if beta == 1.0:
        return generalized_kl_divergence(input, target, eps=eps)
    x, y = input + eps, target + eps
    term = (torch.pow(y, beta) + (beta - 1.0) * torch.pow(x, beta)
            - beta * y * torch.pow(x, beta - 1.0)) / (beta * (beta - 1.0))
    return term.sum(dim=-1)
