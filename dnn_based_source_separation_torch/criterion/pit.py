"""Permutation-invariant training: exhaustive PIT.

Port of `dnn_based_source_separation_tpu/criterion/pit.py:22-54, 177-189`.
The JAX package's `vmap` over the (n!, n) permutation table becomes one
batched gather: every permutation of the targets is evaluated in a single
criterion call over (B * n!) items. Criteria follow the reference protocol
`(input, target, batch_mean=False) -> (B,)` with a `maximize` attribute.

ORPIT, SinkPIT, ProbPIT and the Hungarian matcher come with slice G of the
port; they raise here.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch


def permutation_table(n_sources: int) -> np.ndarray:
    """(n!, n) int64 table of all permutations of range(n_sources), in itertools order."""
    return np.array(list(itertools.permutations(range(n_sources))), dtype=np.int64)


def pit(criterion, input: torch.Tensor, target: torch.Tensor, n_sources: int | None = None,
        patterns=None, batch_mean: bool = True):
    """Exhaustive-permutation PIT.

    input, target (B, n_sources, ...) -> (loss, pattern): loss () or (B,);
    pattern (B, n_sources), the target permutation achieving the optimum
    (the first one on ties, as `jnp.argmin` / `jnp.argmax` pick it).
    """
    if patterns is None:
        n = n_sources if n_sources is not None else input.shape[1]
        patterns = permutation_table(n)
    patterns = torch.as_tensor(np.asarray(patterns), dtype=torch.long, device=target.device)
    B, P = input.shape[0], patterns.shape[0]
    permuted = target[:, patterns]  # (B, P, n, ...)
    repeated = input.unsqueeze(1).expand_as(permuted)
    possible = criterion(repeated.reshape(B * P, *input.shape[1:]),
                         permuted.reshape(B * P, *target.shape[1:]),
                         batch_mean=False).view(B, P)
    maximize = bool(getattr(criterion, "maximize", False))
    indices = possible.argmax(dim=1) if maximize else possible.argmin(dim=1)
    loss = possible.gather(1, indices[:, None])[:, 0]
    if batch_mean:
        loss = loss.mean(dim=0)
    return loss, patterns[indices]


@dataclasses.dataclass(frozen=True)
class PIT:
    criterion: object
    n_sources: int

    def __post_init__(self):
        object.__setattr__(self, "patterns", permutation_table(self.n_sources))

    def __call__(self, input, target, batch_mean: bool = True):
        return pit(self.criterion, input, target, patterns=self.patterns, batch_mean=batch_mean)


class PIT1d(PIT):
    pass


def _not_ported(name: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet (slice G of the port); "
                                  "use PIT1d, the recipe's exhaustive PIT")
    return refuse


ORPIT = _not_ported("ORPIT")
SinkPIT = _not_ported("SinkPIT")
ProbPIT = _not_ported("ProbPIT")
HungarianLoss = _not_ported("HungarianLoss")
