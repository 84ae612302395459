"""Long-form inference: 50%-overlapping chunks with a triangular crossfade.

Port of `dnn_based_source_separation_tpu/models/longform.py`. The mixture
is cut into chunks of `chunk_samples` at a hop of half a chunk, the model
runs on one chunk at a time (as JAX's `lax.scan` does, so a chunk's
working memory, not the whole recording's, bounds the device memory), and
a triangular window, normalised by the windows' accumulated sum,
crossfades the chunks' outputs in f32.

The chunk count is rounded up to a power of two (`bucket=True`, the
default), as in JAX, where it lets arbitrary lengths reuse a few compiled
programs. Eager PyTorch does not need it, but the padded chunks overlap
the last real chunk's second half, so they change the output in the tail
whenever T > n_real * hop: it stays, for parity with the JAX package.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def chunk_count(T: int, chunk_samples: int, bucket: bool = True) -> int:
    """Chunks of `chunk_samples` at a hop of chunk_samples // 2 that cover T samples."""
    hop = chunk_samples // 2
    n_chunks = max(1, -(-max(T - chunk_samples, 0) // hop) + 1)
    return _next_pow2(n_chunks) if bucket else n_chunks


def separate_longform(apply_fn: Callable[[torch.Tensor], torch.Tensor], mixture: torch.Tensor,
                      chunk_samples: int, n_sources: int, bucket: bool = True) -> torch.Tensor:
    """mixture (B, 1, T) -> (B, n_sources, T) in the mixture's dtype.

    apply_fn((B, 1, chunk)) -> (B, n_sources, chunk), for example a model.
    """
    B, _, T = mixture.shape
    hop = chunk_samples // 2
    n_chunks = chunk_count(T, chunk_samples, bucket)
    total = (n_chunks - 1) * hop + chunk_samples
    x = F.pad(mixture, (0, total - T))

    window = np.bartlett(chunk_samples + 2)[1:-1].astype(np.float32)
    wsum = np.zeros(total, np.float32)
    y = torch.zeros((B, n_sources, total), dtype=torch.float32, device=mixture.device)
    weight = torch.from_numpy(window).to(mixture.device)
    for i in range(n_chunks):
        s = i * hop
        y[..., s:s + chunk_samples] += apply_fn(x[..., s:s + chunk_samples]).float() * weight
        wsum[s:s + chunk_samples] += window
    y = y / torch.from_numpy(np.maximum(wsum, 1e-8)).to(mixture.device)
    return y[..., :T].to(mixture.dtype)
