"""Framing and overlap-add (port of `dnn_based_source_separation_tpu/ops/stft.py`).

Only `_frame` and `_fold` are ported so far; the STFT/iSTFT wrappers come
with the spectrogram models.
"""
from __future__ import annotations

import torch


def _frame(x: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """(..., T) -> (..., n_frames, frame_length), n_frames = (T - L)//hop + 1.

    A strided view: no copy, for any hop.
    """
    return x.unfold(-1, frame_length, hop_length)


def _fold(frames: torch.Tensor, hop_length: int, out_length: int) -> torch.Tensor:
    """Overlap-add (..., S, L) frames at stride hop -> (..., out_length).

    Written as slice-adds in a fixed order, so the result is the same on
    every run (no atomics). When hop divides L, frames split into L/hop
    sub-bands that each add as one contiguous slice; otherwise each of the
    L frame positions adds as one strided slice.
    """
    *lead, S, L = frames.shape
    total = (S - 1) * hop_length + L
    y = frames.new_zeros(*lead, total)
    if L % hop_length == 0:
        ratio = L // hop_length
        sub = frames.reshape(*lead, S, ratio, hop_length)
        for r in range(ratio):
            band = sub[..., :, r, :].reshape(*lead, S * hop_length)
            y[..., r * hop_length : r * hop_length + S * hop_length] += band
    else:
        for l in range(L):
            y[..., l : l + (S - 1) * hop_length + 1 : hop_length] += frames[..., :, l]
    return y[..., :out_length] if out_length < total else y
