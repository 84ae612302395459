"""MISI: multiple input spectrogram inversion (Gunawan & Sen, 2010).

Port of `dnn_based_source_separation_tpu/algorithm/misi.py` over the port's STFT: from
the sources' amplitude spectrograms and the time-domain mixture, each iteration spreads
the mixture's residual evenly over the sources, then re-analyses them and keeps the
given magnitudes with the new phases.
"""
from __future__ import annotations

import torch

from ..ops.stft import istft, stft


def misi(amplitudes: torch.Tensor, mixture: torch.Tensor, n_fft: int,
         hop_length: int | None = None, window: torch.Tensor | None = None,
         iteration: int = 10) -> torch.Tensor:
    """amplitudes (n_src, ..., F, T'); mixture (..., T) -> estimates (n_src, ..., T)."""
    hop_length = hop_length or n_fft // 4
    n_sources, T = amplitudes.shape[0], mixture.shape[-1]
    spec = amplitudes * torch.exp(1j * torch.zeros_like(amplitudes))
    estimates = istft(spec, n_fft, hop_length, window=window, length=T)
    for _ in range(iteration):
        corrected = estimates + (mixture - estimates.sum(dim=0)) / n_sources
        spec = stft(corrected, n_fft, hop_length, window=window)
        spec = amplitudes * torch.exp(1j * torch.angle(spec))
        estimates = istft(spec, n_fft, hop_length, window=window, length=T)
    return estimates


class MISI:
    def __init__(self, n_fft, hop_length=None, window=None, iteration=10):
        self.n_fft, self.hop_length = n_fft, hop_length or n_fft // 4
        self.window, self.iteration = window, iteration

    def __call__(self, amplitudes, mixture):
        return misi(amplitudes, mixture, self.n_fft, self.hop_length, window=self.window,
                    iteration=self.iteration)
