"""Adapters that compare spectral estimates with waveform targets on the device.

Port of `dnn_based_source_separation_tpu/criterion/spectral.py`: the target
STFT is taken inside the loss, on the estimates' device, so the loaders
ship waveforms.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.stft import stft
from ..ops.windows import build_window


@dataclasses.dataclass(frozen=True)
class SpectralTargetAdapter:
    """`base(estimates, STFT of target_waves (B, n_src, C, T))`: the complex spectrogram
    with `complex_target`, else its magnitude."""

    base: object
    n_fft: int
    hop_length: Optional[int] = None
    window_fn: str = "hann"
    complex_target: bool = False

    @property
    def maximize(self):
        return bool(getattr(self.base, "maximize", False))

    def __call__(self, estimates, target_waves, batch_mean: bool = True):
        hop = self.hop_length or self.n_fft // 4
        window = build_window(self.n_fft, self.window_fn, device=target_waves.device)
        target = stft(target_waves, self.n_fft, hop, window=window)
        if not self.complex_target:
            target = target.abs()
        return self.base(estimates, target, batch_mean=batch_mean)


@dataclasses.dataclass(frozen=True)
class MonoTargetAdapter:
    """`base(estimates, target_waves (B, n_src, C, T) averaged over C)`."""

    base: object

    @property
    def maximize(self):
        return bool(getattr(self.base, "maximize", False))

    def __call__(self, estimates, target_waves, batch_mean: bool = True):
        return self.base(estimates, target_waves.mean(dim=2), batch_mean=batch_mean)
