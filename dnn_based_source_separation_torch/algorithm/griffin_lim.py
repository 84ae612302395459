"""Griffin-Lim phase reconstruction and its momentum ("fast") variant.

Port of `dnn_based_source_separation_tpu/algorithm/griffin_lim.py` over the port's
STFT (`ops/stft.py`): each iteration keeps the given magnitude, takes the phase of the
last re-analysis, resynthesises and re-analyses. `torch.angle(0)` is 0, as in JAX.
A random initial phase is drawn from a `torch.Generator` (JAX: `jax.random` at a key),
so the two draw different phases from the same seed; pass `init_phase` to match.
"""
from __future__ import annotations

import math

import torch

from ..ops.stft import istft, stft


def _with_phase(amplitude: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    return amplitude * torch.exp(1j * phase)


def _initial(amplitude, init_phase, generator):
    if init_phase is None:
        if generator is not None:
            init_phase = 2 * math.pi * torch.rand(amplitude.shape, generator=generator,
                                                  device=generator.device).to(amplitude)
        else:
            init_phase = torch.zeros_like(amplitude)
    return _with_phase(amplitude, init_phase)


def _project(amplitude, spec, n_fft, hop_length, window, length):
    """Enforce the magnitude, resynthesise, re-analyse."""
    x = istft(_with_phase(amplitude, torch.angle(spec)), n_fft, hop_length, window=window,
              length=length)
    return stft(x, n_fft, hop_length, window=window)


def griffin_lim(amplitude: torch.Tensor, n_fft: int, hop_length: int | None = None,
                window: torch.Tensor | None = None, iteration: int = 100,
                length: int | None = None, init_phase: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """amplitude (..., n_bins, n_frames) -> waveform (..., T)."""
    hop_length = hop_length or n_fft // 4
    spec = _initial(amplitude, init_phase, generator)
    for _ in range(iteration):
        spec = _project(amplitude, spec, n_fft, hop_length, window, length)
    return istft(_with_phase(amplitude, torch.angle(spec)), n_fft, hop_length, window=window,
                 length=length)


def fast_griffin_lim(amplitude: torch.Tensor, n_fft: int, hop_length: int | None = None,
                     window: torch.Tensor | None = None, iteration: int = 100,
                     alpha: float = 0.99, length: int | None = None,
                     init_phase: torch.Tensor | None = None,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """Momentum-accelerated Griffin-Lim (the reference's FastGriffinLim)."""
    hop_length = hop_length or n_fft // 4
    spec = _initial(amplitude, init_phase, generator)
    prev = spec
    for _ in range(iteration):
        proj = _project(amplitude, spec + alpha * (spec - prev), n_fft, hop_length, window,
                        length)
        prev, spec = spec, proj
    return istft(_with_phase(amplitude, torch.angle(spec)), n_fft, hop_length, window=window,
                 length=length)


class GriffinLim:
    """The object form of `griffin_lim`, as the reference's module classes."""

    def __init__(self, n_fft, hop_length=None, window=None, iteration=100):
        self.n_fft, self.hop_length = n_fft, hop_length or n_fft // 4
        self.window, self.iteration = window, iteration

    def __call__(self, amplitude, length=None, **kwargs):
        return griffin_lim(amplitude, self.n_fft, self.hop_length, window=self.window,
                           iteration=self.iteration, length=length, **kwargs)


class FastGriffinLim(GriffinLim):
    def __init__(self, n_fft, hop_length=None, window=None, iteration=100, alpha=0.99):
        super().__init__(n_fft, hop_length, window, iteration)
        self.alpha = alpha

    def __call__(self, amplitude, length=None, **kwargs):
        return fast_griffin_lim(amplitude, self.n_fft, self.hop_length, window=self.window,
                                iteration=self.iteration, alpha=self.alpha, length=length,
                                **kwargs)
