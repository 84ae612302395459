"""STFT / iSTFT, framing and overlap-add.

Port of `dnn_based_source_separation_tpu/ops/stft.py`, with its semantics
rather than `torch.stft` / `torch.istft`'s: a reflect pad of n_fft // 2 on
both sides (`center`), a window shorter than n_fft zero-padded
symmetrically, the one-sided spectrum (n_fft // 2 + 1 bins), no
normalisation, and an iSTFT normalised by the summed squared window,
clamped at 1e-11, then sliced to `length`. Spectrograms are
(..., n_freq, n_frames) complex64; the DFT is `torch.fft.rfft` / `irfft`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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


def _full_window(window: torch.Tensor | None, n_fft: int, win_length: int, like: torch.Tensor):
    """The analysis window at n_fft samples on `like`'s device: ones if None, a shorter
    one zero-padded symmetrically (torch's convention)."""
    if window is None:
        window = torch.ones(win_length, dtype=torch.float32, device=like.device)
    window = window.to(like.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    return window


def stft(x: torch.Tensor, n_fft: int, hop_length: int | None = None,
         win_length: int | None = None, window: torch.Tensor | None = None,
         center: bool = True, onesided: bool = True) -> torch.Tensor:
    """(..., T) real signal -> (..., n_freq, n_frames) complex spectrogram."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    window = _full_window(window, n_fft, win_length, x).to(x.dtype)
    if center:
        pad = n_fft // 2
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
        x = x.reshape(*lead, x.shape[-1])
    frames = _frame(x, n_fft, hop_length) * window  # (..., S, n_fft)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1) if onesided else torch.fft.fft(
        frames, n=n_fft, dim=-1)
    return spec.transpose(-1, -2)


def istft(spec: torch.Tensor, n_fft: int, hop_length: int | None = None,
          win_length: int | None = None, window: torch.Tensor | None = None,
          center: bool = True, onesided: bool = True, length: int | None = None) -> torch.Tensor:
    """(..., n_freq, n_frames) complex spectrogram -> (..., T) real signal.

    Window-envelope normalised overlap-add. With `length`, the raw
    overlap-add is sliced [pad : pad + length] and zero-padded only past the
    last synthesised sample, as torch.istft does.
    """
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    window = _full_window(window, n_fft, win_length, spec)
    frames_f = spec.transpose(-1, -2)  # (..., S, n_freq)
    if onesided:
        frames = torch.fft.irfft(frames_f, n=n_fft, dim=-1)
    else:
        frames = torch.fft.ifft(frames_f, dim=-1).real
    frames = frames * window

    S = frames.shape[-2]
    total = (S - 1) * hop_length + n_fft
    y = _fold(frames, hop_length, total)
    env = _fold((window * window).expand(S, n_fft), hop_length, total)
    y = y / torch.clamp(env, min=1e-11)

    pad = n_fft // 2 if center else 0
    if length is not None:
        end = pad + length
        y = y[..., pad:min(end, total)]
        if end > total:
            y = F.pad(y, (0, end - total))
    elif center:
        y = y[..., pad : total - pad]
    return y
