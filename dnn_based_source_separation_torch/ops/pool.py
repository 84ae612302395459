"""Pooling: global average and max, median, stochastic, generalized mean (GeM).

Port of `dnn_based_source_separation_tpu/ops/pool.py` (reference `src/modules/pool.py`:
GlobalAvgPool, GlobalMaxPool, StochasticPool, MedianPool, GeneralizedMeanPool). Channels
last, as JAX's: the 1-D pools take (B, T, C).

- `median_pool1d` averages a window's two middle values when its kernel is even, as
  `jnp.median` does (`torch.median` would return the lower one).
- `stochastic_pool1d` picks one value a window with probability its relu's share of the
  window's sum (uniformly where the window has nothing positive), by the Gumbel-max rule
  `jax.random.categorical` uses, on uniforms drawn from the caller's `torch.Generator`:
  the same distribution as JAX's, not the same draws.
"""
from __future__ import annotations

import torch
from torch import nn


def global_avg_pool(x: torch.Tensor, dim=(1,)) -> torch.Tensor:
    """The mean over the spatial dims `dim`."""
    return x.mean(dim=dim)


def global_max_pool(x: torch.Tensor, dim=(1,)) -> torch.Tensor:
    return x.amax(dim=dim)


def _windows(x: torch.Tensor, kernel_size: int, stride: int | None) -> torch.Tensor:
    """(B, T, C) -> (B, n, k, C), n = (T - k) // stride + 1 windows."""
    return x.unfold(1, kernel_size, stride or kernel_size).transpose(2, 3)


def median_pool1d(x: torch.Tensor, kernel_size: int, stride: int | None = None) -> torch.Tensor:
    """(B, T, C) -> (B, T', C): each window's median."""
    ordered = _windows(x, kernel_size, stride).sort(dim=2).values
    return (ordered[:, :, kernel_size // 2] + ordered[:, :, (kernel_size - 1) // 2]) / 2


def stochastic_pool1d(x: torch.Tensor, kernel_size: int, generator: torch.Generator,
                      stride: int | None = None) -> torch.Tensor:
    """(B, T, C) -> (B, T', C): one value a window, drawn by its activation's weight."""
    windows = _windows(x, kernel_size, stride)  # (B, n, k, C)
    w = windows.clamp(min=0.0)
    logits = torch.log(w / (w.sum(dim=2, keepdim=True) + 1e-12) + 1e-12)
    u = torch.rand(windows.shape, generator=generator, device=generator.device)
    u = u.to(device=x.device, dtype=logits.dtype).clamp(min=torch.finfo(logits.dtype).tiny)
    choice = (logits - torch.log(-torch.log(u))).argmax(dim=2, keepdim=True)
    return windows.gather(2, choice).squeeze(2)


class GeneralizedMeanPool(nn.Module):
    """GeM: (mean over `dim` of max(x, eps)^p)^(1/p), a learnable scalar `p` (p_init)."""

    def __init__(self, p_init: float = 3.0, dim: int = 1, eps: float = 1e-6, *, device=None):
        super().__init__()
        self.dim, self.eps = dim, eps
        self.p = nn.Parameter(torch.tensor(float(p_init), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.clamp(min=self.eps).pow(self.p).mean(dim=self.dim).pow(1.0 / self.p)
