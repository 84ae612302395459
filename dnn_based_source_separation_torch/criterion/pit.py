"""Permutation-invariant training: exhaustive PIT, ORPIT, SinkPIT and ProbPIT.

Port of `dnn_based_source_separation_tpu/criterion/pit.py` (`PIT1d` for
waveforms, `PIT2d` for spectrograms: the same search). The JAX package's
`vmap` over a table of candidates (the (n!, n) permutations, ORPIT's choices
of the "one" source) becomes one batched criterion call over (B x
candidates) items. Criteria follow the reference protocol
`(input, target, batch_mean=False) -> (B,)` with a `maximize` attribute.
The Hungarian matcher is `criterion/hungarian.py`.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch


def permutation_table(n_sources: int) -> np.ndarray:
    """(n!, n) int64 table of all permutations of range(n_sources), in itertools order."""
    return np.array(list(itertools.permutations(range(n_sources))), dtype=np.int64)


def _permuted_losses(criterion, input: torch.Tensor, target: torch.Tensor, patterns):
    """(patterns (P, n) on the device, losses (B, P)): the criterion of `input` against
    each permutation of the targets, in one call over B * P items."""
    patterns = torch.as_tensor(np.asarray(patterns), dtype=torch.long, device=target.device)
    B, P = input.shape[0], patterns.shape[0]
    permuted = target[:, patterns]  # (B, P, n, ...)
    repeated = input.unsqueeze(1).expand_as(permuted)
    possible = criterion(repeated.reshape(B * P, *input.shape[1:]),
                         permuted.reshape(B * P, *target.shape[1:]),
                         batch_mean=False).view(B, P)
    return patterns, possible


def pairwise_losses(criterion, input: torch.Tensor, target: torch.Tensor,
                    n: int | None = None) -> torch.Tensor:
    """C (B, n, n), C[b, i, j] = criterion(input[b, i], target[b, j]), in one call over
    B * n * n items (the JAX package's repeat-and-flatten, `pit.py:111-116`)."""
    B = input.shape[0]
    n = n if n is not None else input.shape[1]
    inp = input[:, :, None].expand(B, n, n, *input.shape[2:])
    tgt = target[:, None].expand(B, n, n, *target.shape[2:])
    return criterion(inp.reshape(-1, *input.shape[2:]), tgt.reshape(-1, *target.shape[2:]),
                     batch_mean=False).reshape(B, n, n)


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
    patterns, possible = _permuted_losses(criterion, input, target, patterns)
    maximize = bool(getattr(criterion, "maximize", False))
    indices = possible.argmax(dim=1) if maximize else possible.argmin(dim=1)
    loss = possible.gather(1, indices[:, None])[:, 0]
    if batch_mean:
        loss = loss.mean(dim=0)
    return loss, patterns[indices]


def orpit(criterion, input: torch.Tensor, target: torch.Tensor, n_sources=None,
          batch_mean: bool = True):
    """One-and-Rest PIT over a zero-padded variable-source batch (JAX `pit.py:57-99`).

    input (B, 2, ...): the (one, rest) pair of estimates; target (B, n_max, ...),
    zero beyond each item's count; n_sources: (B,) counts, or None for all n_max.
    Each valid choice c of the "one" source scores loss(one, target[c]) +
    loss(rest, sum of the other valid targets) / max(count - 1, 1); invalid choices
    get the sentinel (+inf, or -inf for a maximized criterion), so they are never
    picked and pass no gradient. Returns (loss, indices (B,)), the chosen "one".
    """
    B, n_max = target.shape[0], target.shape[1]
    if n_sources is None:
        counts = torch.full((B,), n_max, dtype=torch.long, device=target.device)
    else:
        counts = torch.as_tensor(n_sources, device=target.device).long()
    valid = torch.arange(n_max, device=target.device)[None, :] < counts[:, None]  # (B, n_max)
    tail = (1,) * (target.ndim - 2)
    target = target * valid.reshape(valid.shape + tail).to(target.dtype)  # zero the padding
    # choice c: the one target is target[:, c], the rest the sum of the others (valid ones:
    # the padding is zero already), as sums over the source axis like JAX's masks.
    one_mask = torch.eye(n_max, dtype=target.dtype, device=target.device)  # (choice, source)
    one_mask = one_mask.reshape(n_max, 1, n_max, *tail)
    target_one = (one_mask * target[None]).sum(dim=2)  # (n_max, B, ...)
    target_rest = ((1.0 - one_mask) * target[None]).sum(dim=2)
    flat = (n_max * B, *target.shape[2:])
    loss_one = criterion(input[None, :, 0].expand(n_max, *input[:, 0].shape).reshape(flat),
                         target_one.reshape(flat), batch_mean=False).view(n_max, B)
    loss_rest = criterion(input[None, :, 1].expand(n_max, *input[:, 1].shape).reshape(flat),
                          target_rest.reshape(flat), batch_mean=False).view(n_max, B)
    possible = (loss_one + loss_rest / torch.clamp(counts - 1, min=1)).transpose(0, 1)

    maximize = bool(getattr(criterion, "maximize", False))
    sentinel = torch.full_like(possible, -math.inf if maximize else math.inf)
    possible = torch.where(valid, possible, sentinel)
    indices = possible.argmax(dim=1) if maximize else possible.argmin(dim=1)
    loss = possible.gather(1, indices[:, None])[:, 0]
    if batch_mean:
        loss = loss.mean(dim=0)
    return loss, indices


def sinkpit(criterion, input: torch.Tensor, target: torch.Tensor, n_sources: int | None = None,
            coldness: float = 1.0, iteration: int = 10, batch_mean: bool = True):
    """Sinkhorn-relaxation PIT (arXiv:2010.11871; JAX `pit.py:102-134`).

    The (B, n, n) loss matrix C, then `iteration` log-domain Sinkhorn sweeps of
    Z = -coldness * C (rows, then columns) to a doubly-stochastic P = exp(Z); the loss
    is sum((C + Z / coldness) * P). Returns (loss, P).
    """
    C = pairwise_losses(criterion, input, target, n_sources)
    maximize = bool(getattr(criterion, "maximize", False))
    if maximize:
        C = -C
    Z = -coldness * C
    for _ in range(iteration):
        Z = Z - torch.logsumexp(Z, dim=1, keepdim=True)
        Z = Z - torch.logsumexp(Z, dim=2, keepdim=True)
    P = torch.exp(Z)
    loss = ((C + Z / coldness) * P).sum(dim=(1, 2))
    if maximize:
        loss = -loss
    if batch_mean:
        loss = loss.mean(dim=0)
    return loss, P


def prob_pit(criterion, input: torch.Tensor, target: torch.Tensor, n_sources: int | None = None,
             patterns=None, gamma: float = 1.0, batch_mean: bool = True):
    """Probabilistic PIT (arXiv:1908.01768; JAX `pit.py:137-174`): the soft-min over every
    permutation, loss = -gamma * (logsumexp(-L_p / gamma) - log n!), which trains through
    each permutation by its likelihood. Returns (loss, the most likely pattern (B, n))."""
    if patterns is None:
        n = n_sources if n_sources is not None else input.shape[1]
        patterns = permutation_table(n)
    patterns, possible = _permuted_losses(criterion, input, target, patterns)
    maximize = bool(getattr(criterion, "maximize", False))
    signed = -possible if maximize else possible
    loss = -gamma * (torch.logsumexp(-signed / gamma, dim=1) - math.log(patterns.shape[0]))
    if maximize:
        loss = -loss
    indices = signed.argmin(dim=1)
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


class PIT2d(PIT):
    pass


@dataclasses.dataclass(frozen=True)
class ORPIT:
    criterion: object

    def __call__(self, input, target, n_sources=None, batch_mean: bool = True):
        return orpit(self.criterion, input, target, n_sources=n_sources, batch_mean=batch_mean)


@dataclasses.dataclass(frozen=True)
class ProbPIT:
    """Soft-min PIT over every permutation (see `prob_pit`)."""

    criterion: object
    n_sources: int
    gamma: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "patterns", permutation_table(self.n_sources))

    def __call__(self, input, target, batch_mean: bool = True):
        return prob_pit(self.criterion, input, target, patterns=self.patterns, gamma=self.gamma,
                        batch_mean=batch_mean)


@dataclasses.dataclass(frozen=True)
class SinkPIT:
    criterion: object
    n_sources: int | None = None
    coldness: float = 1.0
    iteration: int = 10

    def __call__(self, input, target, batch_mean: bool = True):
        loss, P = sinkpit(self.criterion, input, target, n_sources=self.n_sources,
                          coldness=self.coldness, iteration=self.iteration,
                          batch_mean=batch_mean)
        return loss, P.argmax(dim=2)
