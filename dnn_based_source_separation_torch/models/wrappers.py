"""Waveform -> spectrogram wrapper for the spectrogram-domain models.

Port of `dnn_based_source_separation_tpu/models/wrappers.py:
SpectrogramMaskingWrapper`: the STFT and its magnitude run on the model's
device inside the forward, so callers hand it waves. The other wrappers of
the JAX module come with their models.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.stft import stft
from ..ops.windows import build_window
from .base import SeparationModelMixin, register_model


@register_model
class SpectrogramMaskingWrapper(SeparationModelMixin, nn.Module):
    """(B, 1, C, T) mixture wave -> the base model's magnitudes (B, n_src, C, F, S).

    The base model's parameters are `base.*`; the window is a buffer outside
    the state dict, as JAX keeps it outside the params.
    """

    def __init__(self, base: nn.Module, n_fft: int, hop_length: Optional[int] = None,
                 window_fn: str = "hann", *, device=None):
        super().__init__()
        self._config = dict(base=base, n_fft=n_fft, hop_length=hop_length, window_fn=window_fn)
        self.base = base.to(device) if device is not None else base
        self.n_fft, self.hop_length, self.window_fn = n_fft, hop_length or n_fft // 4, window_fn
        self.register_buffer("window", build_window(n_fft, window_fn, device=device),
                             persistent=False)

    def spectrogram(self, wave: torch.Tensor) -> torch.Tensor:
        """(..., T) -> the complex STFT (..., F, S) this model takes the magnitude of."""
        return stft(wave, self.n_fft, self.hop_length, window=self.window)

    def forward(self, mixture: torch.Tensor) -> torch.Tensor:
        return self.base(self.spectrogram(mixture).abs())
