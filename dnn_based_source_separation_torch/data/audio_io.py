"""WAV read/write: scipy.io.wavfile and the float32 [-1, 1] convention.

The port's own copy of `dnn_based_source_separation_tpu/data/audio_io.py`,
bit for bit in behaviour: audio stays on the host as float32 numpy in
[-1, 1] and is written as 16-bit PCM.
"""
from __future__ import annotations

import numpy as np
from scipy.io import wavfile


def read_wav(path: str, start: int | None = None, frames: int | None = None):
    """Return (signal float32 (T,) or (T, C) in [-1, 1], sample_rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        x = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    else:
        x = data.astype(np.float32)
    if start is not None:
        end = None if frames is None else start + frames
        x = x[start:end]
    return x, sr


def write_wav(path: str, signal: np.ndarray, sample_rate: int):
    """Write float32 [-1, 1] signal as 16-bit PCM."""
    x = np.clip(np.asarray(signal), -1.0, 1.0)
    wavfile.write(path, sample_rate, (x * 32767.0).astype(np.int16))
