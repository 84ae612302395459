"""FiLM and PoCM conditioning.

Port of `dnn_based_source_separation_tpu/models/film.py` (film, pocm, gpocm; reference
`src/models/film.py`, `src/models/pocm.py`, LaSAFT arXiv:2010.11631), on channels-first
tensors (B, C, ...): the port's convs run NCHW, so the channel axis is dim 1 here where
JAX's is the last.
"""
from __future__ import annotations

import torch


def _expand(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B, C) -> (B, C, 1, ...) for an input of `ndim` dims."""
    return t.reshape(*t.shape, *(1,) * (ndim - 2))


def film(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """x (B, C, ...); gamma, beta (B, C) broadcast over the other dims."""
    return _expand(gamma, x.ndim) * x + _expand(beta, x.ndim)


def pocm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Point-wise convolutional modulation: x (B, C_in, ...); gamma (B, C_out, C_in); beta
    (B, C_out). y[b, d, ...] = sum_c gamma[b, d, c] x[b, c, ...] + beta[b, d]."""
    y = torch.einsum("bc...,bdc->bd...", x, gamma)
    return y + _expand(beta, x.ndim)


def gpocm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Gated PoCM: sigmoid(PoCM(x)) * x (a square gamma)."""
    return torch.sigmoid(pocm(x, gamma, beta)) * x


# The reference's class names.
FiLM = FiLM1d = FiLM2d = film
PoCM2d = pocm
GPoCM2d = gpocm
