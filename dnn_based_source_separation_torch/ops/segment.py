"""Dual-path chunking: segment (unfold) and overlap-add (fold).

Port of `dnn_based_source_separation_tpu/ops/segment.py`. Layout is
channels-last (..., T, N); a sequence is cut into S chunks of K frames at
hop P, and overlap-add sums them back.
"""
from __future__ import annotations

import torch

from .stft import _fold


def segment(x: torch.Tensor, chunk_size: int, hop_size: int) -> torch.Tensor:
    """(..., T, N) -> (..., S, chunk_size, N), a strided view. Requires (T-K) % hop == 0."""
    T = x.shape[-2]
    if T < chunk_size or (T - chunk_size) % hop_size != 0:
        raise ValueError(
            f"T={T} incompatible with chunk_size={chunk_size}, hop={hop_size}; "
            "pad to the chunk grid first (see segment_padding)")
    return x.unfold(-2, chunk_size, hop_size).transpose(-1, -2)


def overlap_add(chunks: torch.Tensor, hop_size: int) -> torch.Tensor:
    """(..., S, K, N) -> (..., T, N) with T = (S-1)*hop + K. Overlaps sum."""
    *_, S, K, _ = chunks.shape
    y = _fold(chunks.movedim(-1, -3), hop_size, (S - 1) * hop_size + K)  # (..., N, T)
    return y.movedim(-2, -1)


def segment_padding(T: int, chunk_size: int, hop_size: int) -> tuple[int, int]:
    """Left/right zero-pad so that segment() tiles T exactly: hop on the left,
    and on the right whatever puts (T_padded - K) on the hop grid, plus hop."""
    rest = (T + hop_size - chunk_size) % hop_size
    right = (hop_size - rest) % hop_size
    return hop_size, right + hop_size
