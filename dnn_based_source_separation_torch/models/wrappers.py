"""Adapters from musdb18's (B, 1, C, T) mixture waves to the models' inputs.

Port of `dnn_based_source_separation_tpu/models/wrappers.py:
SpectrogramMaskingWrapper` (the STFT and its magnitude run on the model's
device inside the forward, so callers hand it waves), `WaveChannelAdapter`
(stereo Conv-TasNet, MRX) and `MonoWaveAdapter` (Meta-TasNet). The other
wrappers of the JAX module come with their models. Also `SpectrogramSeparator`,
the wsj0-mix spectrogram models (DANet, ADANet, deep clustering) served on waves,
as JAX's `train/tester.py:AttractorTester` serves them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..algorithm.clustering import KMeans
from ..ops.stft import istft, stft
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


class _WaveAdapter(SeparationModelMixin, nn.Module):
    """A waveform model under a musdb18 adapter; its parameters are `base.*`."""

    def __init__(self, base: nn.Module, *, device=None):
        super().__init__()
        self._config = dict(base=base)
        self.base = base.to(device) if device is not None else base


@register_model
class WaveChannelAdapter(_WaveAdapter):
    """(B, 1, C, T) mixture -> the time-domain base model over (B, C, T): stereo
    Conv-TasNet's (B, n_src, C, T) or MRX's."""

    def forward(self, mixture: torch.Tensor) -> torch.Tensor:
        return self.base(mixture[:, 0])


@register_model
class MonoWaveAdapter(_WaveAdapter):
    """(B, 1, C, T) -> the mono downmix (B, 1, T) -> the base model's (B, n_src, T)
    (Meta-TasNet; its targets are downmixed alike, `criterion/spectral.py:MonoTargetAdapter`)."""

    def forward(self, mixture: torch.Tensor) -> torch.Tensor:
        return self.base(mixture[:, 0].mean(dim=1, keepdim=True))


class SpectrogramSeparator(nn.Module):
    """A spectrogram-domain model (DANet, ADANet, deep clustering) served on waveforms:
    (B, 1, T) -> (B, n_src, T) f32.

    The mixture's STFT in f32 (`n_fft`, `hop_length`, a periodic Hann or a rectangular
    window), the clustering inference path on its amplitude in the model's dtype, the
    estimates' amplitudes resynthesised with the mixture's phase (JAX
    `train/tester.py:AttractorTester`, :246-268). `kind` is 'danet' (KMeans attractors
    inside the model), 'adanet' (anchored attractors) or 'embedding' (a DeepEmbedding's
    embeddings clustered by KMeans into binary masks).
    """

    def __init__(self, model: nn.Module, n_fft: int, hop_length: Optional[int] = None,
                 window_fn: str = "hann", kind: str = "danet", n_sources: int = 2,
                 iter_clustering: int = 10):
        super().__init__()
        if kind not in ("danet", "adanet", "embedding"):
            raise ValueError(f"Unsupported kind: {kind}")
        self.model, self.n_fft, self.hop_length = model, n_fft, hop_length or n_fft // 4
        self.kind, self.n_sources, self.iter_clustering = kind, n_sources, iter_clustering
        param = next(model.parameters())
        self.dtype = param.dtype
        k = torch.arange(n_fft, dtype=torch.float32, device=param.device)
        self.register_buffer("window", 0.5 - 0.5 * torch.cos(2 * math.pi * k / n_fft)
                             if window_fn == "hann" else torch.ones_like(k), persistent=False)

    def forward(self, mixture: torch.Tensor) -> torch.Tensor:
        T = mixture.shape[-1]
        spec = stft(mixture.float(), self.n_fft, self.hop_length, window=self.window)
        amp = spec.abs()  # (B, 1, F, S)
        x = amp.to(self.dtype)
        if self.kind == "danet":
            est_amp = self.model(x, None, None, self.n_sources)
        elif self.kind == "adanet":
            est_amp = self.model(x, None, self.n_sources)
        else:
            emb = self.model(x)  # (B, F, S, D)
            B, Fq, S, D = emb.shape
            assign, _ = KMeans(self.n_sources, n_iterations=self.iter_clustering)(
                emb.reshape(B, Fq * S, D))
            mask = F.one_hot(assign, self.n_sources).to(amp.dtype)
            est_amp = mask.reshape(B, Fq, S, self.n_sources).permute(0, 3, 1, 2) * amp
        est_spec = torch.polar(est_amp.float(), torch.angle(spec))
        return istft(est_spec, self.n_fft, self.hop_length, window=self.window, length=T)
