"""Analysis and synthesis windows.

Port of `dnn_based_source_separation_tpu/ops/windows.py`: periodic windows
(as `torch.hann_window(periodic=True)`) from their closed forms, and the
least-squares optimal synthesis window.
"""
from __future__ import annotations

import math

import torch


def build_window(n: int, kind: str = "hann", dtype=torch.float32, device=None) -> torch.Tensor:
    """A periodic window of length `n`: hann, sine (sqrt-hann), hamming, blackman, rect."""
    k = torch.arange(n, dtype=torch.float32, device=device)
    theta = 2.0 * math.pi * k / n
    kind = kind.lower() if kind else "rect"
    if kind in ("hann", "hanning"):
        w = 0.5 - 0.5 * torch.cos(theta)
    elif kind in ("sine", "sqrt_hann", "cosine"):
        w = torch.sin(math.pi * k / n)
    elif kind == "hamming":
        w = 0.54 - 0.46 * torch.cos(theta)
    elif kind == "blackman":
        w = 0.42 - 0.5 * torch.cos(theta) + 0.08 * torch.cos(2.0 * theta)
    elif kind in ("rect", "rectangular", "boxcar", "none"):
        w = torch.ones_like(k)
    else:
        raise ValueError(f"Unsupported window kind: {kind}")
    return w.to(dtype)


def build_optimal_window(window: torch.Tensor, hop_length: int) -> torch.Tensor:
    """w_syn[n] = w[n] / sum_m w[n + m*hop]^2, the folded sum of squared shifted windows.

    Requires len(window) % hop_length == 0.
    """
    n = window.shape[0]
    if n % hop_length != 0:
        raise ValueError(f"window length {n} must be divisible by hop {hop_length}")
    ratio = n // hop_length
    denom = (window * window).reshape(ratio, hop_length).sum(dim=0).repeat(ratio)
    return window / torch.clamp(denom, min=1e-12)
