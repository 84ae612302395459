"""Transforms: the STFT (re-exported from `ops/stft.py`), cepstra and PCA."""

from ..ops.stft import istft, stft
from .cepstrum import complex_cepstrum, minimum_phase, real_cepstrum
from .pca import pca

__all__ = ["complex_cepstrum", "istft", "minimum_phase", "pca", "real_cepstrum", "stft"]
