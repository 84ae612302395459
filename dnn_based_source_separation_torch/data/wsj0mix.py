"""wsj0-mix style wave datasets (list-file driven, segmenting).

The port's own copy of the wave datasets of
`dnn_based_source_separation_tpu/data/wsj0mix.py` (:27-151 and :225-258),
which follow the reference `egs/wsj0-mix/common/src/dataset.py:13-250`:
  * WaveTrainDataset: fixed-length windows with 50% overlap over each
    utterance;
  * WaveEvalDataset: the first max_samples of each utterance, zero-padded;
  * WaveTestDataset: whole utterances with their IDs;
  * WaveTrainSpeakerDataset (:202): train windows with the utterance's speaker
    rows (`speaker_keys` :153, `create_spk_to_idx` :189), for Wavesplit;
  * SpectrogramTrainDataset and IdealMaskSpectrogramTrainDataset (:260-340):
    host STFTs of the train windows, ideal masks (ibm / irm / wfm) and the
    dB threshold weight, for DANet, ADANet and deep clustering;
  * WaveTrainVariableSourcesDataset (:338-390): train windows of 2+3-speaker
    corpora, the sources zero-padded to `max_sources` with each item's count,
    for ORPIT.

Layout: wav_root/mix/<id>.wav, wav_root/s1/<id>.wav ... wav_root/s<n>/<id>.wav.
The list file carries one utterance id per line (first whitespace token;
a '.wav' suffix is optional). Items are numpy arrays.
"""
from __future__ import annotations

import os
import re
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


_WSJ_UTT_RE = re.compile(r"^[0-9]{3}[0-9a-z]{5}$")


def speaker_keys(utt_id: str, n_sources: int) -> List[str]:
    """Per-source speaker keys from a mixture utterance ID.

    wsj0-mix IDs are `<utt>_<gain>_<utt>_<gain>` pairs, LibriMix IDs `<utt>_<utt>`.
    A key is the SPEAKER: the 3-character prefix of a wsj0 utterance code
    ('011a0101' -> '011'), the leading field of a LibriSpeech code
    ('103-1240-0000' -> '103'), else the token itself.
    """
    tokens = utt_id.split("_")
    if len(tokens) >= 2 * n_sources:
        toks = tokens[0::2][:n_sources]  # utt/gain pairs
    elif len(tokens) == n_sources:
        toks = tokens  # LibriMix style: utt tokens only
    else:
        raise ValueError(f"cannot parse {n_sources} speakers from utterance ID '{utt_id}'")
    keys = []
    for t in toks:
        if _WSJ_UTT_RE.match(t):
            keys.append(t[:3])
        elif "-" in t:
            keys.append(t.split("-")[0])
        else:
            keys.append(t)
    return keys


def create_spk_to_idx(list_path: str, n_sources: int = 2):
    """The speaker table of a list file: the order of first appearance fixes each row."""
    from ..utils.embedding import SpeakerToIndex

    spk_to_idx = SpeakerToIndex()
    for utt in _read_list(list_path):
        for spk in speaker_keys(utt, n_sources):
            spk_to_idx.add(spk)
    return spk_to_idx


class WaveTrainSpeakerDataset(WaveTrainDataset):
    """Train windows plus the utterance's speaker rows: (mixture (1, T), sources (n_src, T),
    spk_idx (n_src,) int32)."""

    def __init__(self, wav_root, list_path, samples=32000, overlap=None, n_sources=2,
                 spk_to_idx=None):
        super().__init__(wav_root, list_path, samples=samples, overlap=overlap,
                         n_sources=n_sources)
        self.spk_to_idx = (spk_to_idx if spk_to_idx is not None
                           else create_spk_to_idx(list_path, n_sources))

    def __getitem__(self, idx):
        mixture, sources = super().__getitem__(idx)
        utt, _ = self.index[idx]
        spk_idx = np.asarray([self.spk_to_idx(s) for s in speaker_keys(utt, self.n_sources)],
                             np.int32)
        return mixture, sources, spk_idx


def np_window(n_fft: int, window_fn: str = "hann") -> np.ndarray:
    """The spectrogram datasets' window: a periodic Hann for 'hann', else rectangular."""
    if window_fn == "hann":
        k = np.arange(n_fft)
        return (0.5 - 0.5 * np.cos(2 * np.pi * k / n_fft)).astype(np.float32)
    return np.ones(n_fft, np.float32)


def _np_stft(x: np.ndarray, n_fft: int, hop_length: int, window: np.ndarray) -> np.ndarray:
    """Host STFT, centred with reflect padding, one-sided: (..., T) -> (..., n_bins, n_frames)
    complex64."""
    pad = n_fft // 2
    x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    n_frames = (x.shape[-1] - n_fft) // hop_length + 1
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(n_fft)[None, :]
    spec = np.fft.rfft(x[..., idx] * window, axis=-1).astype(np.complex64)
    return np.swapaxes(spec, -1, -2)


class SpectrogramTrainDataset(WaveTrainDataset):
    """Complex STFTs of the train windows: (mixture (1, F, S), sources (n_src, F, S))."""

    def __init__(self, wav_root, list_path, n_fft, hop_length=None, window_fn="hann",
                 samples=32000, overlap=None, n_sources=2):
        super().__init__(wav_root, list_path, samples=samples, overlap=overlap,
                         n_sources=n_sources)
        self.n_fft = n_fft
        self.hop_length = hop_length or n_fft // 2
        self.window = np_window(n_fft, window_fn)

    def __getitem__(self, idx):
        mixture, sources = super().__getitem__(idx)
        return (_np_stft(mixture, self.n_fft, self.hop_length, self.window),
                _np_stft(sources, self.n_fft, self.hop_length, self.window))


def ideal_mask_item(mix_spec: np.ndarray, src_spec: np.ndarray, mask_type: str = "ibm",
                    threshold: float = 40.0, eps: float = 1e-12):
    """IdealMaskSpectrogramTrainDataset's item from the complex STFTs of one window,
    mixture (1, F, S) and sources (n_src, F, S): (|mixture|, |sources|, ideal mask, threshold
    weight), all f32."""
    mix_amp, src_amp = np.abs(mix_spec), np.abs(src_spec)
    if mask_type == "ibm":
        mask = np.eye(src_amp.shape[0], dtype=np.float32)[np.argmax(src_amp, axis=0)]
        mask = np.moveaxis(mask, -1, 0)
    elif mask_type == "irm":
        mask = src_amp / (src_amp.sum(axis=0) + eps)
    elif mask_type == "wfm":
        power = src_amp**2
        mask = power / (power.sum(axis=0) + eps)
    else:
        raise NotImplementedError(f"Unsupported mask: {mask_type}")
    log_amp = 20 * np.log10(mix_amp + eps)
    thr = 10 ** ((log_amp.max() - threshold) / 20)
    return (mix_amp.astype(np.float32), src_amp.astype(np.float32), mask.astype(np.float32),
            (mix_amp > thr).astype(np.float32))


class IdealMaskSpectrogramTrainDataset(SpectrogramTrainDataset):
    """(|mixture| (1, F, S), |sources| (n_src, F, S), ideal mask (n_src, F, S), threshold
    weight (1, F, S)), all f32.

    The mask is 'ibm' (one-hot of the loudest source), 'irm' (amplitude ratio) or 'wfm'
    (power ratio); the weight is 1 where |mixture| is within `threshold` dB of its maximum.
    """

    def __init__(self, wav_root, list_path, n_fft, hop_length=None, window_fn="hann",
                 mask_type="ibm", threshold=40.0, samples=32000, overlap=None, n_sources=2,
                 eps=1e-12):
        super().__init__(wav_root, list_path, n_fft, hop_length, window_fn, samples, overlap,
                         n_sources)
        self.mask_type, self.threshold, self.eps = mask_type, threshold, eps

    def __getitem__(self, idx):
        return ideal_mask_item(*super().__getitem__(idx), self.mask_type, self.threshold,
                               self.eps)


class WaveTrainVariableSourcesDataset(_WaveDatasetBase):
    """Train windows over utterances of 2 to `max_sources` speakers, for ORPIT.

    An item is (mixture (1, samples), sources (max_sources, samples) zero beyond the
    utterance's count, count as np.int32). The count comes from `n_sources_per_utt`
    (utterance ID -> count) or from which `sN/` files exist. The JAX package's
    static-shape form of the reference's PackedSequence collate; `criterion/pit.py:orpit`
    reads exactly this.
    """

    def __init__(self, wav_root, list_path, samples=32000, overlap=None, max_sources=3,
                 n_sources_per_utt=None):
        super().__init__(wav_root, list_path, n_sources=max_sources)
        self.samples = samples
        self.overlap = samples // 2 if overlap is None else overlap
        self.max_sources = max_sources
        self.counts = n_sources_per_utt or {}
        hop = samples - self.overlap
        self.index: List[Tuple[str, int]] = []
        for utt in self.utt_ids:
            mix_path, _ = self._paths(utt)
            for start in range(0, _wav_length(mix_path) - samples + 1, hop):
                self.index.append((utt, start))

    def _count(self, utt_id: str) -> int:
        if utt_id in self.counts:
            return self.counts[utt_id]
        return sum(os.path.exists(os.path.join(self.wav_root, f"s{idx + 1}", utt_id + ".wav"))
                   for idx in range(self.max_sources))

    def __len__(self):
        return len(self.index)

    def __getitem__(self, idx):
        utt, start = self.index[idx]
        n = self._count(utt)
        mixture, _ = read_wav(os.path.join(self.wav_root, "mix", utt + ".wav"), start,
                              self.samples)
        sources = np.zeros((self.max_sources, self.samples), np.float32)
        for s in range(n):
            x, _ = read_wav(os.path.join(self.wav_root, f"s{s + 1}", utt + ".wav"), start,
                            self.samples)
            sources[s, : x.shape[0]] = x
        return mixture[None, :].astype(np.float32), sources, np.int32(n)
