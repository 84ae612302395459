"""wsj0-mix style wave datasets (list-file driven, segmenting).

The port's own copy of the wave datasets of
`dnn_based_source_separation_tpu/data/wsj0mix.py` (:27-151 and :225-258),
which follow the reference `egs/wsj0-mix/common/src/dataset.py:13-250`:
  * WaveTrainDataset: fixed-length windows with 50% overlap over each
    utterance;
  * WaveEvalDataset: the first max_samples of each utterance, zero-padded;
  * WaveTestDataset: whole utterances with their IDs.

Layout: wav_root/mix/<id>.wav, wav_root/s1/<id>.wav ... wav_root/s<n>/<id>.wav.
The list file carries one utterance id per line (first whitespace token;
a '.wav' suffix is optional). Items are numpy arrays; the speaker,
spectrogram and variable-source datasets come with later slices.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from .audio_io import read_wav


def _read_list(list_path: str) -> List[str]:
    ids = []
    with open(list_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            utt = line.split()[0]
            if utt.endswith(".wav"):
                utt = utt[:-4]
            ids.append(os.path.basename(utt))
    return ids


def _wav_length(path: str) -> int:
    # A fast length probe through scipy's mmap'd reader.
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        from scipy.io import wavfile

        sr, data = wavfile.read(path, mmap=True)
    return int(data.shape[0])


class _WaveDatasetBase:
    def __init__(self, wav_root: str, list_path: str, n_sources: int = 2):
        self.wav_root = wav_root
        self.n_sources = n_sources
        self.utt_ids = _read_list(list_path)

    def _paths(self, utt_id: str) -> Tuple[str, List[str]]:
        mix = os.path.join(self.wav_root, "mix", utt_id + ".wav")
        srcs = [
            os.path.join(self.wav_root, f"s{idx + 1}", utt_id + ".wav")
            for idx in range(self.n_sources)
        ]
        return mix, srcs

    def _load(self, utt_id: str, start: int = 0, frames: int | None = None):
        mix_path, src_paths = self._paths(utt_id)
        if frames is not None:
            # Fixed-window hot path: one native threaded call reads the
            # mixture and all sources (data/native_loader.py). The native
            # reader takes PCM16 WAVs only; anything else is read with scipy.
            from . import native_loader

            if native_loader.available():
                paths = [mix_path] + src_paths
                try:
                    batch = native_loader.read_segments_batch(
                        paths, [start] * len(paths), frames)
                    return batch[0], batch[1:]
                except (IOError, RuntimeError):
                    pass
        mixture, _ = read_wav(mix_path, start, frames)
        sources = [read_wav(p, start, frames)[0] for p in src_paths]
        return mixture, np.stack(sources)


class WaveTrainDataset(_WaveDatasetBase):
    """Fixed windows of `samples` with hop `samples - overlap` (default 50%).

    `cache_in_memory=True` keeps each utterance's decoded f32 waveforms
    (mixture and all sources) in RAM after first use, so later epochs slice
    numpy arrays with no file IO, at about 4 bytes x (1 + n_sources) x the
    corpus's samples. Opt-in: the reference re-reads per window.
    """

    def __init__(
        self,
        wav_root: str,
        list_path: str,
        samples: int = 32000,
        overlap: int | None = None,
        n_sources: int = 2,
        cache_in_memory: bool = False,
    ):
        super().__init__(wav_root, list_path, n_sources)
        self.samples = samples
        self.overlap = samples // 2 if overlap is None else overlap
        self.cache_in_memory = cache_in_memory
        self._cache: dict = {}
        hop = samples - self.overlap
        self.index: List[Tuple[str, int]] = []
        for utt in self.utt_ids:
            mix_path, _ = self._paths(utt)
            T = _wav_length(mix_path)
            for start in range(0, T - samples + 1, hop):
                self.index.append((utt, start))

    def __len__(self):
        return len(self.index)

    def _load_window(self, utt: str, start: int):
        if not self.cache_in_memory:
            return self._load(utt, start, self.samples)
        hit = self._cache.get(utt)
        if hit is None:
            mix_path, src_paths = self._paths(utt)
            mix = read_wav(mix_path, 0, None)[0].astype(np.float32)
            srcs = np.stack(
                [read_wav(p, 0, None)[0] for p in src_paths]).astype(np.float32)
            hit = (mix, srcs)
            # A dict set is atomic under the GIL; a concurrent duplicate read
            # only wastes one load.
            self._cache[utt] = hit
        mix, srcs = hit
        sl = slice(start, start + self.samples)
        return mix[sl], srcs[:, sl]

    def __getitem__(self, idx):
        utt, start = self.index[idx]
        mixture, sources = self._load_window(utt, start)
        return mixture[None, :].astype(np.float32), sources.astype(np.float32)


class WaveEvalDataset(_WaveDatasetBase):
    """First max_samples of each utterance, zero-padded to a static shape."""

    def __init__(self, wav_root: str, list_path: str, max_samples: int = 64000, n_sources: int = 2):
        super().__init__(wav_root, list_path, n_sources)
        self.max_samples = max_samples

    def __len__(self):
        return len(self.utt_ids)

    def __getitem__(self, idx):
        utt = self.utt_ids[idx]
        mixture, sources = self._load(utt, 0, None)
        T = min(mixture.shape[-1], self.max_samples)
        mix = np.zeros((1, self.max_samples), np.float32)
        src = np.zeros((self.n_sources, self.max_samples), np.float32)
        mix[0, :T] = mixture[:T]
        src[:, :T] = sources[:, :T]
        return mix, src


class WaveTestDataset(_WaveDatasetBase):
    """Full utterances with IDs (batch size 1, like the reference tester)."""

    def __len__(self):
        return len(self.utt_ids)

    def __getitem__(self, idx):
        utt = self.utt_ids[idx]
        mixture, sources = self._load(utt, 0, None)
        return utt, mixture[None, :].astype(np.float32), sources.astype(np.float32)
