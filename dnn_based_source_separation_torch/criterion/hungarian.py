"""Hungarian-assignment PIT: the optimal matching in O(n^3) instead of n! permutations.

Port of `dnn_based_source_separation_tpu/criterion/hungarian.py`. The (B, n, n)
pairwise loss matrix comes from one criterion call over B * n * n items
(`pit.pairwise_losses`); the assignment of each item is solved on the host by
`scipy.optimize.linear_sum_assignment` (JAX: `optax.assignment.hungarian_algorithm`),
and the loss gathers the matrix at the matched pairs, so gradients flow into the
criterion as they do in JAX. Protocol as `pit`: (loss, pattern), pattern[b, i] the
target matched to estimate i; a drop-in for PIT1d at large n.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .pit import pairwise_losses


def hungarian_pit(criterion, input: torch.Tensor, target: torch.Tensor,
                  batch_mean: bool = True):
    """input, target (B, n, ...) -> (loss () or (B,), pattern (B, n)); the loss is the
    matched losses' mean over the n sources, as `pit`'s."""
    from scipy.optimize import linear_sum_assignment

    n = input.shape[1]
    C = pairwise_losses(criterion, input, target, n)
    maximize = bool(getattr(criterion, "maximize", False))
    costs = -C if maximize else C
    # The solve runs on the host: one device-to-host copy of the (B, n, n) costs per call,
    # which waits for the forward that produced them.
    host = costs.detach().to("cpu", torch.float64).numpy()
    pattern = np.stack([linear_sum_assignment(c)[1] for c in host])  # rows come sorted
    pattern = torch.from_numpy(pattern).to(device=costs.device, dtype=torch.long)
    total = costs.gather(2, pattern[..., None])[..., 0].sum(dim=1)
    loss = (-total if maximize else total) / n
    if batch_mean:
        loss = loss.mean(dim=0)
    return loss, pattern


@dataclasses.dataclass(frozen=True)
class HungarianLoss:
    """PIT by Hungarian assignment; use instead of PIT1d for large n."""

    criterion: object

    def __call__(self, input, target, batch_mean: bool = True):
        return hungarian_pit(self.criterion, input, target, batch_mean=batch_mean)
