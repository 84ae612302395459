"""ctypes bindings for the native WAV loader (the repo's `native/audioio`).

The port's own copy of `dnn_based_source_separation_tpu/data/native_loader.py`.
It builds `native/audioio/libwavloader.so` on demand with the in-tree
Makefile and reports itself unavailable when the toolchain is missing, so
the datasets read with scipy instead. `native/` belongs to neither package:
both load the same library.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _native_dir() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(os.path.dirname(here)), "native", "audioio")


def _make(target_dir: str) -> bool:
    try:
        subprocess.run(["make", "-C", target_dir], check=True,
                       capture_output=True, timeout=120)
        return True
    except (subprocess.SubprocessError, OSError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = os.path.join(_native_dir(), "libwavloader.so")
    if not os.path.exists(so) and not _make(_native_dir()):
        return None
    try:
        lib = ctypes.CDLL(so)
        if not hasattr(lib, "wav_read_batch_f32"):
            # A stale prebuilt .so from before the batch reader existed:
            # rebuild (the Makefile target depends on the source) and reload.
            del lib
            if not _make(_native_dir()):
                return None
            lib = ctypes.CDLL(so)
            if not hasattr(lib, "wav_read_batch_f32"):
                return None
    except OSError:
        return None
    lib.wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int)]
    lib.wav_info.restype = ctypes.c_int
    lib.wav_read_f32.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                                 ctypes.POINTER(ctypes.c_float)]
    lib.wav_read_f32.restype = ctypes.c_int
    lib.wav_read_f32_multichannel.argtypes = lib.wav_read_f32.argtypes
    lib.wav_read_f32_multichannel.restype = ctypes.c_int
    lib.wav_read_batch_f32.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long),
        ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.wav_read_batch_f32.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def wav_info(path: str) -> Tuple[int, int, int]:
    """Returns (sample_rate, n_frames, n_channels)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native wav loader unavailable")
    sr, frames, ch = ctypes.c_int(), ctypes.c_long(), ctypes.c_int()
    rc = lib.wav_info(path.encode(), ctypes.byref(sr), ctypes.byref(frames), ctypes.byref(ch))
    if rc != 0:
        raise IOError(f"wav_info failed ({rc}) for {path}")
    return sr.value, frames.value, ch.value


def read_segment(path: str, start: int, frames: int, multichannel: bool = False) -> np.ndarray:
    """Read a float32 segment: (frames,) mixed to mono, or (C, frames)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native wav loader unavailable")
    if multichannel:
        _, _, ch = wav_info(path)
        out = np.empty((ch, frames), dtype=np.float32)
        rc = lib.wav_read_f32_multichannel(
            path.encode(), start, frames, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        )
    else:
        out = np.empty((frames,), dtype=np.float32)
        rc = lib.wav_read_f32(
            path.encode(), start, frames, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        )
    if rc != 0:
        raise IOError(f"wav_read failed ({rc}) for {path}")
    return out


def read_segments_batch(paths, starts, frames: int, n_threads: int = 0) -> np.ndarray:
    """Parallel mono-mixed batch read: (n, frames) float32.

    One native call assembles the whole batch with an internal thread pool
    (GIL-free). Failed items raise.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native wav loader unavailable")
    n = len(paths)
    out = np.empty((n, frames), dtype=np.float32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_starts = (ctypes.c_long * n)(*[int(s) for s in starts])
    fails = lib.wav_read_batch_f32(
        c_paths, c_starts, frames, n, n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if fails:
        # The C interface reports only a count; re-probe serially to name the
        # culprits (failure is the cold path).
        bad = []
        for p, s in zip(paths, starts):
            try:
                read_segment(p, int(s), frames)
            except IOError:
                bad.append(p)
        raise IOError(
            f"wav_read_batch failed for {fails}/{n} items "
            f"(non-PCM16 or unreadable): {bad[:4]}")
    return out
