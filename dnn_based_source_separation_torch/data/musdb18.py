"""MUSDB18-style track datasets for evaluation and testing.

The port's own copy of `_MUSDB18Base`, `WaveEvalDataset` and
`WaveTestDataset` of `dnn_based_source_separation_tpu/data/musdb18.py`
(:36-93, :160-198), which follow the reference
`egs/musdb18/common/src/dataset.py`: the first max_duration of each
validation track, and whole test tracks with their names. Items are
float32 numpy arrays, (1, C, T) mixtures and (n_src, C, T) stems. The
train datasets come with musdb18 training.

Directory layout (as the musdb18 prep scripts produce it):
  root/train/<track>/{mixture,bass,drums,other,vocals}.wav
  root/test/<track>/...
  root/train.txt, root/validation.txt, root/test.txt
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from .audio_io import read_wav

SAMPLE_RATE_MUSDB18 = 44100
__sources__ = ["bass", "drums", "other", "vocals"]


def _read_names(path: str) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


class _MUSDB18Base:
    """Track lists and (C, T) reads. `cache_in_memory=True` keeps each (track,
    stem)'s decoded f32 waveform after its first read, so later windows are
    numpy slices with no file IO (about 4 B x channels x samples x (1 +
    n_sources) of RAM)."""

    def __init__(self, musdb18_root: str, subset: str = "train",
                 sources: Sequence[str] = __sources__, include_valid: bool = False,
                 valid_only: bool = False, cache_in_memory: bool = False):
        self.root = musdb18_root
        self.sources = list(sources)
        self.subset = "train" if subset == "valid" else subset
        self.cache_in_memory = cache_in_memory
        self._cache: dict = {}

        if subset in ("train", "valid"):
            valid_path = os.path.join(musdb18_root, "validation.txt")
            valid_lst = _read_names(valid_path) if os.path.exists(valid_path) else []
            names = _read_names(os.path.join(musdb18_root, "train.txt"))
            if subset == "valid" or valid_only:
                names = [n for n in names if n in valid_lst]
            elif not include_valid:
                names = [n for n in names if n not in valid_lst]
        else:
            names = _read_names(os.path.join(musdb18_root, "test.txt"))
        self.names = names

    def _path(self, name: str, source: str) -> str:
        return os.path.join(self.root, self.subset, name, f"{source}.wav")

    def _load(self, name: str, source: str, start: int = 0, frames: Optional[int] = None):
        if self.cache_in_memory:
            key = (name, source)
            full = self._cache.get(key)
            if full is None:
                x, _ = read_wav(self._path(name, source), 0, None)
                if x.ndim == 1:
                    x = x[:, None]
                full = x.T.astype(np.float32)  # (C, T)
                self._cache[key] = full
            if frames is None:
                return full[:, start:] if start else full
            return full[:, start : start + frames]
        x, sr = read_wav(self._path(name, source), start, frames)
        if x.ndim == 1:
            x = x[:, None]
        return x.T.astype(np.float32)  # (C, T)


class WaveEvalDataset(_MUSDB18Base):
    """First max_duration of each validation track, zero-padded."""

    def __init__(self, musdb18_root: str, max_duration: float = 10.0,
                 sample_rate: int = SAMPLE_RATE_MUSDB18,
                 sources: Sequence[str] = __sources__, **kwargs):
        kwargs.setdefault("valid_only", True)
        super().__init__(musdb18_root, "train", sources, **kwargs)
        self.max_samples = int(max_duration * sample_rate)

    def __len__(self):
        return len(self.names)

    def __getitem__(self, idx):
        name = self.names[idx]
        mixture = self._load(name, "mixture", 0, self.max_samples)
        srcs = np.stack([self._load(name, s, 0, self.max_samples) for s in self.sources])
        T = mixture.shape[-1]
        if T < self.max_samples:
            pad = self.max_samples - T
            mixture = np.pad(mixture, ((0, 0), (0, pad)))
            srcs = np.pad(srcs, ((0, 0), (0, 0), (0, pad)))
        return mixture[None], srcs


class WaveTestDataset(_MUSDB18Base):
    """Full test tracks with names: (name, mixture (1, C, T), stems (n_src, C, T))."""

    def __init__(self, musdb18_root: str, sources: Sequence[str] = __sources__, **kwargs):
        super().__init__(musdb18_root, "test", sources, **kwargs)

    def __len__(self):
        return len(self.names)

    def __getitem__(self, idx):
        name = self.names[idx]
        mixture = self._load(name, "mixture")
        srcs = np.stack([self._load(name, s) for s in self.sources])
        return name, mixture[None], srcs
