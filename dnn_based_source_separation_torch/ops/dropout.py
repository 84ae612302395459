"""Dropout by flax's rule, with its mask drawn from an explicit `torch.Generator`.

flax's `nn.Dropout` computes `where(mask, x / keep, 0)` with keep = 1 - rate
and mask ~ Bernoulli(keep); `F.dropout` takes no generator, so the port
draws the mask itself. `Dropout` is the module form: its `generator` is set
by `ops/rnn.py:set_dropout_generator`, as the LSTM's and GRU's are, and a
train-mode forward with rate > 0 and no generator raises, as JAX requires a
'dropout' rng.
"""
from __future__ import annotations

import torch
from torch import nn


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            owner: str = "dropout") -> torch.Tensor:
    """flax's nn.Dropout in train mode: where(mask, x / keep, 0), mask ~ Bernoulli(keep)."""
    if generator is None:
        raise ValueError(f"{owner} with dropout {rate} in train mode needs a dropout "
                         "generator: call set_dropout_generator(model, g)")
    keep = 1.0 - rate
    mask = torch.empty_like(x).bernoulli_(keep, generator=generator).bool()
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Dropout(nn.Module):
    """`dropout` in train mode when rate > 0, the identity otherwise."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        return dropout(x, self.rate, self.generator, type(self).__name__)
