"""Combination loss over the sums of every subset of sources (X-UMX, MDX).

Port of `dnn_based_source_separation_tpu/criterion/combination.py:17-59`:
a (n_combos, n_sources) 0/1 subset matrix contracted with the source axis
gives every subset sum at once, then the base criterion runs on each.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch


def subset_matrix(n_sources: int, min_pair: int = 1, max_pair: int | None = None) -> np.ndarray:
    """(n_combos, n_sources) float32 0/1 selection of the subsets of min_pair..max_pair
    sources (default n_sources - 1), in itertools.combinations order."""
    if max_pair is None:
        max_pair = n_sources - 1
    rows = []
    for k in range(min_pair, max_pair + 1):
        for combo in itertools.combinations(range(n_sources), k):
            row = np.zeros(n_sources, dtype=np.float32)
            row[list(combo)] = 1.0
            rows.append(row)
    return np.stack(rows)


@dataclasses.dataclass(frozen=True)
class CombinationLoss:
    criterion: object
    combination_dim: int = 1
    min_pair: int = 1
    max_pair: int | None = None

    def __call__(self, input, target, reduction: str = "mean", batch_mean: bool = True):
        """input, target (B, n_sources, ...) -> the criterion of every subset sum, reduced
        over the subsets ("mean" or "sum"; else stacked)."""
        n = input.shape[self.combination_dim]
        M = torch.from_numpy(subset_matrix(n, self.min_pair, self.max_pair)).to(
            input.device, input.dtype)
        x = torch.movedim(input, self.combination_dim, 1)
        y = torch.movedim(target, self.combination_dim, 1)
        x_sum = torch.einsum("ks,bs...->bk...", M, x)
        y_sum = torch.einsum("ks,bs...->bk...", M, y)
        losses = [self.criterion(x_sum[:, k], y_sum[:, k], batch_mean=batch_mean)
                  for k in range(x_sum.shape[1])]
        dim = 0 if batch_mean else 1
        loss = torch.stack(losses, dim=dim)
        if reduction == "mean":
            loss = loss.mean(dim=dim)
        elif reduction == "sum":
            loss = loss.sum(dim=dim)
        return loss
