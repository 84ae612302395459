"""MUSDB18-style track datasets for training, evaluation and testing.

The port's own copy of `dnn_based_source_separation_tpu/data/musdb18.py`,
which follows the reference `egs/musdb18/common/src/dataset.py`:
- `WaveTrainDataset`: fixed windows with 50% overlap over the train tracks
  (train.txt minus validation.txt);
- `AugmentationWaveTrainDataset`: a random track and window per source,
  each augmented, summed into the mixture (the reference's random remix);
  an item is a function of (seed, index) alone;
- `WaveEvalDataset`: the first max_duration of each validation track;
- `WaveTestDataset`: whole test tracks with their names.
Items are float32 numpy arrays, (1, C, T) mixtures and (n_src, C, T) stems.

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
from .wsj0mix import _wav_length

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


class WaveTrainDataset(_MUSDB18Base):
    """Fixed windows of `duration` with 50% overlap (or `overlap` samples) over the train
    tracks."""

    def __init__(self, musdb18_root: str, duration: float = 4.0,
                 sample_rate: int = SAMPLE_RATE_MUSDB18, overlap: Optional[int] = None,
                 sources: Sequence[str] = __sources__, **kwargs):
        super().__init__(musdb18_root, "train", sources, **kwargs)
        self.samples = int(duration * sample_rate)
        hop = self.samples - (overlap if overlap is not None else self.samples // 2)
        self.index = []
        for name in self.names:
            T = _wav_length(self._path(name, "mixture"))
            for start in range(0, T - self.samples + 1, hop):
                self.index.append((name, start))

    def __len__(self):
        return len(self.index)

    def __getitem__(self, idx):
        name, start = self.index[idx]
        mixture = self._load(name, "mixture", start, self.samples)
        sources = np.stack([self._load(name, s, start, self.samples) for s in self.sources])
        return mixture[None], sources  # (1, C, T), (n_src, C, T)


class AugmentationWaveTrainDataset(_MUSDB18Base):
    """A random track and window per source from `np.random.default_rng((seed, idx))`,
    each augmented (`augmentation(x, rng)`, the same generator), zero-padded past a short
    track's end and summed into the mixture. `samples_per_epoch` defaults to the train
    tracks' total duration over `duration`."""

    def __init__(self, musdb18_root: str, duration: float = 4.0,
                 sample_rate: int = SAMPLE_RATE_MUSDB18,
                 samples_per_epoch: Optional[int] = None,
                 sources: Sequence[str] = __sources__, augmentation=None,
                 seed: int = 0, **kwargs):
        super().__init__(musdb18_root, "train", sources, **kwargs)
        self.samples = int(duration * sample_rate)
        self.augmentation = augmentation
        self.seed = seed
        self.track_samples = {name: _wav_length(self._path(name, "mixture"))
                              for name in self.names}
        if samples_per_epoch is None:
            total = sum(self.track_samples.values()) / sample_rate
            samples_per_epoch = int(total / duration)
        self.samples_per_epoch = samples_per_epoch

    def __len__(self):
        return self.samples_per_epoch

    def __getitem__(self, idx):
        rng = np.random.default_rng((self.seed, idx))
        sources = []
        for source in self.sources:
            name = self.names[rng.integers(len(self.names))]
            start = int(rng.integers(0, max(self.track_samples[name] - self.samples, 1)))
            x = self._load(name, source, start, self.samples)
            if x.shape[1] < self.samples:
                x = np.pad(x, ((0, 0), (0, self.samples - x.shape[1])))
            if self.augmentation is not None:
                x = self.augmentation(x, rng)
            sources.append(x)
        sources = np.stack(sources)  # (n_src, C, T)
        mixture = sources.sum(axis=0, keepdims=True)
        return mixture.astype(np.float32), sources.astype(np.float32)


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
