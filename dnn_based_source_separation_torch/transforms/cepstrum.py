"""Cepstra (real and complex) and the minimum-phase signal of a magnitude spectrum.

Port of `dnn_based_source_separation_tpu/transforms/cepstrum.py` on `torch.fft`.
"""
from __future__ import annotations

import math

import torch

EPS = 1e-12


def real_cepstrum(x: torch.Tensor, n_fft: int | None = None, eps: float = EPS) -> torch.Tensor:
    """(..., T) -> (..., n_fft): irfft(log |FFT(x)|)."""
    n_fft = n_fft or x.shape[-1]
    spec = torch.fft.rfft(x, n=n_fft)
    return torch.fft.irfft(torch.log(spec.abs() + eps), n=n_fft)


def _unwrap(phase: torch.Tensor) -> torch.Tensor:
    """numpy's `unwrap` over the last axis (period 2 pi, discontinuity pi)."""
    d = torch.diff(phase, dim=-1)
    dd = torch.remainder(d + math.pi, 2 * math.pi) - math.pi
    dd = torch.where((dd == -math.pi) & (d > 0), torch.full_like(dd, math.pi), dd)
    correct = torch.where(d.abs() < math.pi, torch.zeros_like(d), dd - d)
    return torch.cat([phase[..., :1], phase[..., 1:] + torch.cumsum(correct, dim=-1)], dim=-1)


def complex_cepstrum(x: torch.Tensor, n_fft: int | None = None, eps: float = EPS) -> torch.Tensor:
    """The complex cepstrum from the log spectrum with its phase unwrapped."""
    n_fft = n_fft or x.shape[-1]
    spec = torch.fft.fft(x, n=n_fft)
    log_spec = torch.complex(torch.log(spec.abs() + eps), _unwrap(torch.angle(spec)))
    return torch.fft.ifft(log_spec).real


def minimum_phase(x: torch.Tensor, n_fft: int | None = None, eps: float = EPS) -> torch.Tensor:
    """The minimum-phase signal with x's magnitude spectrum."""
    n = n_fft or x.shape[-1]
    ceps = real_cepstrum(x, n, eps)
    win = torch.cat([torch.ones(1), 2.0 * torch.ones(n // 2 - 1),
                     torch.ones(1 if n % 2 == 0 else 2), torch.zeros(n - n // 2 - 1)])[:n]
    spec = torch.exp(torch.fft.fft(ceps * win.to(ceps), n=n))
    return torch.fft.ifft(spec).real
