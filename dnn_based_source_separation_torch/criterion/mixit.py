"""Mixture-invariant training (MixIT, arXiv:2006.12701).

Port of `dnn_based_source_separation_tpu/criterion/mixit.py`: the JAX `vmap` over the
(n_mix ** n_est, n_est) table of source-to-mixture routings becomes one criterion call
over (K x B x n_mix) items, each candidate's per-mixture sums one einsum against its
one-hot routing. Criteria follow the PIT protocol; `mixit` returns (loss, assignment),
assignment (B, n_est) the mixture each estimate was routed to. The paper trains with
`NegThresholdedSNR`.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch
import torch.nn.functional as F


def mixture_assignment_table(n_est: int, n_mix: int = 2) -> np.ndarray:
    """(n_mix ** n_est, n_est) table, in itertools.product order: every way to route each
    of the n_est estimates to one of the n_mix mixtures."""
    return np.array(list(itertools.product(range(n_mix), repeat=n_est)), dtype=np.int64)


def mixit(criterion, input: torch.Tensor, mixtures: torch.Tensor, table=None,
          batch_mean: bool = True):
    """input (B, n_est, ...) estimates; mixtures (B, n_mix, ...) the references (the model
    heard their sum) -> (loss () or (B,), assignment (B, n_est))."""
    B, n_est = input.shape[0], input.shape[1]
    n_mix = mixtures.shape[1]
    if table is None:
        table = mixture_assignment_table(n_est, n_mix)
    table = torch.as_tensor(np.asarray(table), dtype=torch.long, device=input.device)
    K = table.shape[0]
    onehot = F.one_hot(table, n_mix).to(input.dtype)  # (K, n_est, n_mix)
    est = torch.einsum("kmn,bm...->kbn...", onehot, input)  # (K, B, n_mix, ...)
    flat = (K * B * n_mix, *mixtures.shape[2:])
    losses = criterion(est.reshape(flat), mixtures[None].expand(K, *mixtures.shape).reshape(flat),
                       batch_mean=False)
    possible = losses.view(K, B, n_mix).mean(dim=2).transpose(0, 1)  # (B, K)
    maximize = bool(getattr(criterion, "maximize", False))
    indices = possible.argmax(dim=1) if maximize else possible.argmin(dim=1)
    loss = possible.gather(1, indices[:, None])[:, 0]
    if batch_mean:
        loss = loss.mean(dim=0)
    return loss, table[indices]


@dataclasses.dataclass(frozen=True)
class MixIT:
    """MixIT over a fixed (n_est, n_mix) geometry, its table built once."""

    criterion: object
    n_est: int
    n_mix: int = 2

    def __post_init__(self):
        object.__setattr__(self, "table", mixture_assignment_table(self.n_est, self.n_mix))

    def __call__(self, input, mixtures, batch_mean: bool = True):
        return mixit(self.criterion, input, mixtures, table=self.table, batch_mean=batch_mean)
