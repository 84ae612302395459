"""The pseudo-speech quality corpus, written in the wsj0-mix directory layout.

The port's own copy of `write_quality_corpus`, `_speaker_bank` and
`synth_pseudo_speech` of `dnn_based_source_separation_tpu/data/synthetic.py`
(:73-241), byte for byte in what it writes at a given size: speaker-
conditioned harmonic synthesis (per-speaker f0 base and formants, a
per-utterance f0 contour, a syllable envelope, breath noise) with disjoint
speaker sets per split, as wsj0-2mix keeps its tt speakers unseen in
training. Also the musdb18-layout music corpus (`synth_music_track`,
`write_musdb_quality_corpus`, :228-335), byte for byte as well.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from .audio_io import write_wav


def _speaker_bank(n_speakers: int, seed: int) -> List[Dict[str, np.ndarray]]:
    """Deterministic per-speaker parameter draws."""
    rng = np.random.default_rng(seed)
    speakers = []
    for _ in range(n_speakers):
        speakers.append({
            "f0": float(rng.uniform(85.0, 300.0)),
            "formants": np.sort(rng.uniform(300.0, 3200.0, 3)),
            "bandwidths": rng.uniform(80.0, 300.0, 3),
            "tilt_db_oct": float(rng.uniform(-10.0, -4.0)),  # rolloff per octave
            "rate": float(rng.uniform(2.0, 5.0)),            # syllables per second
            "breath": float(rng.uniform(0.003, 0.015)),
        })
    return speakers


def synth_pseudo_speech(
    speaker: Dict[str, np.ndarray],
    rng: np.random.Generator,
    n_samples: int,
    sample_rate: int = 8000,
) -> np.ndarray:
    """One pseudo-speech utterance: harmonic source-filter and syllable gating.

    Harmonic additive synthesis with a slowly wandering f0 (random-walk
    contour, +-3 semitones), per-harmonic amplitudes from a 3-formant
    resonance envelope with spectral tilt, a syllable-rate raised-cosine
    energy gate, and low-level breath noise.
    """
    sr = sample_rate
    t = np.arange(n_samples) / sr

    # f0 contour: a smooth random walk in log-pitch, +-3 semitones.
    n_ctrl = max(4, int(n_samples / sr * 4))
    walk = np.cumsum(rng.standard_normal(n_ctrl))
    walk = (walk - walk.mean()) / (np.abs(walk).max() + 1e-9)  # [-1, 1]
    contour = np.interp(np.linspace(0, 1, n_samples), np.linspace(0, 1, n_ctrl), walk)
    f0 = speaker["f0"] * 2.0 ** (3.0 * contour / 12.0)
    phase = 2 * np.pi * np.cumsum(f0) / sr

    # Per-harmonic amplitude from the formant envelope and tilt, below Nyquist.
    f0_max = float(f0.max())
    n_harm = max(1, int(0.95 * (sr / 2) / f0_max))
    h = np.arange(1, n_harm + 1, dtype=np.float64)
    freqs = h * speaker["f0"]
    envelope = np.zeros_like(freqs)
    for fc, bw in zip(speaker["formants"], speaker["bandwidths"]):
        envelope += 1.0 / (1.0 + ((freqs - fc) / bw) ** 2)
    tilt = 10.0 ** (speaker["tilt_db_oct"] * np.log2(freqs / freqs[0]) / 20.0)
    amps = (0.05 + envelope) * tilt
    amps = amps / (np.abs(amps).sum() + 1e-9)
    phis = rng.uniform(0, 2 * np.pi, n_harm)

    sig = (amps[:, None] * np.sin(h[:, None] * phase[None, :] + phis[:, None])).sum(axis=0)

    # Syllable-rate energy gate: soft periodic bursts with per-syllable
    # amplitude jitter, and an utterance fade-in and fade-out.
    rate = speaker["rate"] * rng.uniform(0.8, 1.25)
    syl_phase = 2 * np.pi * rate * t + rng.uniform(0, 2 * np.pi)
    gate = 1.0 / (1.0 + np.exp(-6.0 * np.sin(syl_phase)))  # soft square
    syl_idx = np.floor(syl_phase / (2 * np.pi)).astype(np.int64)
    syl_idx -= syl_idx.min()
    syl_amp = rng.uniform(0.5, 1.0, syl_idx.max() + 1)
    env = gate * syl_amp[syl_idx]
    fade = min(int(0.05 * sr), max(n_samples // 8, 1))
    ramp = np.ones(n_samples)
    ramp[:fade] = np.linspace(0, 1, fade)
    ramp[-fade:] = np.linspace(1, 0, fade)
    env = env * ramp

    sig = sig * env + speaker["breath"] * env * rng.standard_normal(n_samples)
    sig = sig / (np.abs(sig).max() + 1e-9)
    return (0.5 * sig).astype(np.float32)


# Durations come from a small set of lengths.
_QUALITY_DURATIONS = (4.0, 4.8, 5.6, 6.4)

# Disjoint speaker-id ranges per split (the wsj0-2mix protocol: tt unseen).
# The first element is either the first speaker, with n_speakers following,
# or a tuple of (first, count) ranges for a non-contiguous speaker set.
_QUALITY_SPLITS = {
    "tr": (0, 30, 1000),   # (first speaker, n_speakers, rng seed base)
    "cv": (30, 8, 2000),
    "tt": (38, 12, 3000),
    # A scaled training split (about 10 h at about 6900 utterances): the 30
    # train speakers plus 70 more (ids 50-119 of a 120-speaker bank), still
    # disjoint from cv (30-37) and tt (38-49).
    "tr_xl": (((0, 30), (50, 70)), 100, 1500),
}


def write_quality_corpus(
    root: str,
    split: str,
    n_utts: int,
    sample_rate: int = 8000,
    n_sources: int = 2,
    total_speakers: int = 50,
) -> Tuple[str, str]:
    """Write `root/<split>/{mix,s1..sN}/*.wav` and `root/<split>.lst`.

    The mixing follows wsj0-2mix creation: distinct speakers per mixture, a
    relative level offset uniform in [0, 5] dB, peak-normalised jointly so
    the relations between sources and mixture (and so SI-SDR) are kept. An
    existing list file is left as it is. Returns (wav_root, list_path).
    """
    first, n_spk, seed = _QUALITY_SPLITS[split]
    ranges = first if isinstance(first, tuple) else ((first, n_spk),)
    total_speakers = max(total_speakers, max(f + n for f, n in ranges))
    bank = _speaker_bank(total_speakers, seed=7)
    speakers = [s for f, n in ranges for s in bank[f:f + n]]
    assert len(speakers) == n_spk

    wav_root = os.path.join(root, split)
    list_path = os.path.join(root, split + ".lst")
    if os.path.exists(list_path):
        return wav_root, list_path
    for sub in ["mix"] + [f"s{i + 1}" for i in range(n_sources)]:
        os.makedirs(os.path.join(wav_root, sub), exist_ok=True)

    rng = np.random.default_rng(seed)
    utt_ids = []
    for i in range(n_utts):
        dur = _QUALITY_DURATIONS[int(rng.integers(len(_QUALITY_DURATIONS)))]
        T = int(dur * sample_rate)
        spk_ids = rng.choice(n_spk, size=n_sources, replace=False)
        gains = 10.0 ** (-rng.uniform(0.0, 5.0, n_sources) / 20.0)
        gains[0] = 1.0
        srcs = []
        for k, sid in enumerate(spk_ids):
            s = synth_pseudo_speech(speakers[int(sid)], rng, T, sample_rate)
            srcs.append(gains[k] * s)
        srcs = np.stack(srcs)
        mix = srcs.sum(axis=0)
        scale = 0.9 / max(float(np.abs(mix).max()), float(np.abs(srcs).max()), 1e-9)
        srcs, mix = (srcs * scale).astype(np.float32), (mix * scale).astype(np.float32)
        utt = f"{split}{i:05d}"
        write_wav(os.path.join(wav_root, "mix", utt + ".wav"), mix, sample_rate)
        for k in range(n_sources):
            write_wav(os.path.join(wav_root, f"s{k + 1}", utt + ".wav"),
                      srcs[k], sample_rate)
        utt_ids.append(utt)
    with open(list_path, "w") as f:
        f.write("\n".join(utt_ids))
    return wav_root, list_path


# ---------------------------------------------------------------------------
# musdb18-layout quality corpus (held-out museval evaluation)
# ---------------------------------------------------------------------------

# Per-split RNG seed + parameter-interpolation knob. `shift=1.0` moves every
# source-generator draw to a range that does NOT overlap the training draw
# (bass register, drum rate, pad base, vocal f0), so test tracks are unseen
# at the track AND generator-parameter level -- the musdb18 arrangement
# (reference egs/musdb18/README.md tables are computed on the 50 held-out
# test songs, disjoint from the 100 train songs).
_MUSDB_QUALITY_SPLITS = {
    "train": (1011, 0.0),
    "valid": (2022, 0.0),
    "test": (3033, 1.0),
}


def _musdb_range(lo: float, hi: float, shift: float) -> Tuple[float, float]:
    """Shift a U(lo, hi) draw window by its own width (disjoint at shift=1)."""
    w = hi - lo
    return lo + shift * w * 1.05, hi + shift * w * 1.05


def synth_music_track(rng: np.random.Generator, T: int, sample_rate: int,
                      shift: float = 0.0) -> Dict[str, np.ndarray]:
    """One 4-stem mono track: spectrally distinct, magnitude-mask learnable.

    bass: tanh-saturated stepped sine glide (low register); drums: periodic
    decaying noise bursts; other: 3-note chord pad with tremolo; vocals:
    vibrato tone + octave partial, syllable-gated. Stems overlap in time but
    occupy distinct spectral regions, like the musdb18 stems a magnitude
    model separates.
    """
    t = np.arange(T) / sample_rate
    stems: Dict[str, np.ndarray] = {}

    f0 = rng.uniform(*_musdb_range(55.0, 110.0, shift))
    # stepped note walk: +-2 semitones every ~2 s
    n_steps = max(int(T / sample_rate / 2.0), 1)
    steps = np.repeat(2.0 ** (rng.integers(-2, 3, n_steps) / 12.0),
                      -(-T // n_steps))[:T]
    ph = 2 * np.pi * np.cumsum(f0 * steps) / sample_rate
    stems["bass"] = 0.25 * np.tanh(3 * np.sin(ph))

    rate = rng.uniform(*_musdb_range(1.5, 2.5, shift))
    env = np.exp(-rng.uniform(8.0, 16.0) * ((t * rate) % 1.0))
    stems["drums"] = 0.3 * env * rng.standard_normal(T)

    base = rng.uniform(*_musdb_range(200.0, 330.0, shift))
    pad = sum(np.sin(2 * np.pi * base * r * t + rng.uniform(0, 2 * np.pi))
              for r in (1.0, 1.25, 1.5))
    stems["other"] = 0.12 * pad * (0.6 + 0.4 * np.sin(
        2 * np.pi * rng.uniform(0.08, 0.15) * t))

    fv = rng.uniform(*_musdb_range(150.0, 260.0, shift))
    vib = fv * (1 + 0.02 * np.sin(2 * np.pi * rng.uniform(4.5, 6.5) * t))
    gate = (np.sin(2 * np.pi * rng.uniform(0.8, 1.6) * t
                   + rng.uniform(0, 2 * np.pi)) > -0.3).astype(np.float64)
    phase_v = 2 * np.pi * np.cumsum(vib) / sample_rate
    stems["vocals"] = 0.2 * gate * (np.sin(phase_v) + 0.5 * np.sin(2.2 * phase_v))
    return stems


def write_musdb_quality_corpus(root: str, n_train: int = 12, n_valid: int = 3,
                               n_test: int = 6, track_sec: float = 40.0,
                               sample_rate: int = 44100) -> str:
    """musdb18-layout corpus with DISJOINT train/valid/test splits.

    Layout (data/musdb18.py:_MUSDB18Base): train/<name>/{stem,mixture}.wav
    for train+valid names (validation.txt marks the valid subset, excluded
    from training windows), test/<name>/... + test.txt for the held-out
    songs. Valid tracks are distinct songs (not a tail-slice of the train
    list); test tracks additionally draw every generator parameter from
    shifted, non-overlapping ranges (`shift=1`).
    """
    marker = os.path.join(root, "test.txt")
    if os.path.exists(marker):
        return root
    T = int(track_sec * sample_rate)
    lists: Dict[str, List[str]] = {"train": [], "valid": [], "test": []}
    counts = {"train": n_train, "valid": n_valid, "test": n_test}
    for split, n in counts.items():
        seed, shift = _MUSDB_QUALITY_SPLITS[split]
        rng = np.random.default_rng(seed)
        subdir = "test" if split == "test" else "train"
        for i in range(n):
            name = f"{split}_song{i:03d}"
            d = os.path.join(root, subdir, name)
            os.makedirs(d, exist_ok=True)
            stems = synth_music_track(rng, T, sample_rate, shift)
            mix = None
            for s, x in stems.items():
                pan = rng.uniform(0.35, 0.65)
                st = np.stack([x * pan, x * (1 - pan)], axis=1).astype(np.float32)
                write_wav(os.path.join(d, f"{s}.wav"), st, sample_rate)
                mix = st if mix is None else mix + st
            write_wav(os.path.join(d, "mixture.wav"), mix, sample_rate)
            lists[split].append(name)
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(lists["train"] + lists["valid"]))
    with open(os.path.join(root, "validation.txt"), "w") as f:
        f.write("\n".join(lists["valid"]))
    with open(marker, "w") as f:
        f.write("\n".join(lists["test"]))
    print(f"musdb quality corpus: {n_train} train + {n_valid} valid + "
          f"{n_test} test songs x {track_sec:.0f}s under {root}", flush=True)
    return root
