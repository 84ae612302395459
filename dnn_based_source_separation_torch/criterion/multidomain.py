"""X-UMX's multi-domain loss: time-domain weighted SDR plus frequency-domain MSE, each
over the sums of source subsets.

Port of `dnn_based_source_separation_tpu/criterion/multidomain.py:22-67`
(the reference's `egs/musdb18/x-umx/src/adhoc_criterion.py`). The input is
the estimated magnitude spectrogram, the target the complex one. The time
branch gives the estimates the phase of the target's remix, resynthesises
both and compares the waves; the frequency branch compares the magnitudes.
Every STFT round trip runs on the input's device (`ops/stft.py`), and the
gradient reaches the real input through complex64 ops and the iSTFT.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.stft import istft, stft
from .combination import CombinationLoss
from .distance import MSELoss
from .sdr import NegWeightedSDR


@dataclasses.dataclass(frozen=True)
class MultiDomainLoss:
    n_fft: int
    hop_length: int
    window: Optional[torch.Tensor] = None
    weight_time: float = 10.0
    weight_frequency: float = 1.0
    combination: bool = True
    source_dim: int = 1
    min_pair: int = 1
    max_pair: Optional[int] = None
    maximize: bool = dataclasses.field(default=False, init=False)

    def __post_init__(self):
        time_loss, frequency_loss = NegWeightedSDR(reduction="mean"), MSELoss(dim=(-2, -1))
        if self.combination:
            time_loss, frequency_loss = (
                CombinationLoss(c, combination_dim=self.source_dim, min_pair=self.min_pair,
                                max_pair=self.max_pair) for c in (time_loss, frequency_loss))
        object.__setattr__(self, "_criterion_time", time_loss)
        object.__setattr__(self, "_criterion_frequency", frequency_loss)

    def __call__(self, input, target, batch_mean: bool = True):
        """input: real (B, n_src, C, F, S); target: complex, the same shape."""
        if input.is_complex():
            raise TypeError("input should be real.")
        if not target.is_complex():
            raise TypeError("target should be complex.")
        window = None if self.window is None else self.window.to(input.device)
        target_time = istft(target, self.n_fft, self.hop_length, window=window)
        mixture = stft(target_time.sum(dim=1, keepdim=True), self.n_fft, self.hop_length,
                       window=window)
        estimate = input * torch.exp(1j * torch.angle(mixture))
        input_time = istft(estimate, self.n_fft, self.hop_length, window=window)

        loss = 0.0
        if self.weight_time != 0:
            loss = self.weight_time * self._criterion_time(input_time, target_time,
                                                           batch_mean=batch_mean)
        if self.weight_frequency != 0:
            loss = loss + self.weight_frequency * self._criterion_frequency(
                input, target.abs(), batch_mean=batch_mean)
        return loss
