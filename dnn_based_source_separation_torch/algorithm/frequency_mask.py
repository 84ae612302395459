"""Ideal time-frequency masks and the multichannel Wiener filter (EM).

Port of `dnn_based_source_separation_tpu/algorithm/frequency_mask.py`: the
six ideal masks (IBM, IRM, WFM, IAM, PSM, ICM) and the local Gaussian model
EM of the reference's norbert-style multichannel Wiener filter, with the
per-source, per-frame loops as batched einsums over complex64 tensors and
one closed-form (C x C) inverse per time-frequency bin. Every statistic is
per frequency bin; only the scale `norm` is global over the mixture.
"""
from __future__ import annotations

import math

import torch

EPS = 1e-12


def _amplitude(x: torch.Tensor) -> torch.Tensor:
    return x.abs() if x.is_complex() else x


def compute_ideal_binary_mask(input: torch.Tensor, source_dim: int = -3) -> torch.Tensor:
    """One-hot mask selecting the dominant source per TF bin (IBM)."""
    amp = _amplitude(input)
    source_dim = source_dim % amp.ndim
    max_idx = amp.argmax(dim=source_dim)
    mask = torch.eye(amp.shape[source_dim], dtype=amp.dtype, device=amp.device)[max_idx]
    return mask.movedim(-1, source_dim)


def _source_dim(x: torch.Tensor, source_dim: int | None) -> int:
    return (0 if x.ndim == 3 else 1) if source_dim is None else source_dim


def compute_ideal_ratio_mask(input: torch.Tensor, source_dim: int | None = None,
                             eps: float = EPS) -> torch.Tensor:
    """IRM: amplitude ratio per TF bin."""
    amp = _amplitude(input)
    norm = amp.sum(dim=_source_dim(amp, source_dim), keepdim=True)
    return amp / (norm + eps)


def compute_wiener_filter_mask(input: torch.Tensor, source_dim: int | None = None,
                               domain: float = 1, eps: float = EPS) -> torch.Tensor:
    """WFM: power-domain ratio; domain=1 amplitude input, 2 power input."""
    amp = _amplitude(input)
    power = amp ** (2 / domain)
    norm = power.sum(dim=_source_dim(amp, source_dim), keepdim=True)
    return power / (norm + eps)


def _mixture(input: torch.Tensor, source_dim: int | None) -> torch.Tensor:
    return input.sum(dim=_source_dim(input, source_dim), keepdim=True)


def compute_ideal_amplitude_mask(input: torch.Tensor, source_dim: int | None = None,
                                 eps: float = EPS) -> torch.Tensor:
    """IAM: |S_n| / |sum_n S_n| (complex input)."""
    return input.abs() / (_mixture(input, source_dim).abs() + eps)


def compute_phase_sensitive_mask(input: torch.Tensor, source_dim: int | None = None,
                                 eps: float = EPS) -> torch.Tensor:
    """PSM: |S_n| cos(angle(S_n) - angle(X)) / |X|."""
    mixture = _mixture(input, source_dim)
    angle = input.angle() - mixture.angle()
    return input.abs() * torch.cos(angle) / (mixture.abs() + eps)


def compute_ideal_complex_mask(input: torch.Tensor, source_dim: int | None = None,
                               eps: float = EPS) -> torch.Tensor:
    """ICM: S_n / X (complex)."""
    mixture = _mixture(input, source_dim)
    denom = torch.where(mixture.abs() < eps, torch.full_like(mixture, eps), mixture)
    return input / denom


# -- multichannel Wiener filter (local Gaussian model EM) -------------------

def _get_stats(y: torch.Tensor, eps: float = EPS):
    """y: (n_src, C, F, T) complex -> psd (n_src, F, T), R (n_src, F, C, C).

    R is the spatial covariance per (source, bin), sum_t y y^H, over sum_t psd.
    """
    psd = (y.abs() ** 2).mean(dim=1)
    cov = torch.einsum("nift,njft->nfij", y, y.conj())
    denom = psd.sum(dim=-1) + eps
    return psd, cov / denom[..., None, None]


def _inv_small(A: torch.Tensor) -> torch.Tensor:
    """Batched inverse of (..., C, C): closed form for C <= 2, `torch.linalg.inv` above."""
    C = A.shape[-1]
    if C == 1:
        return 1.0 / A
    if C == 2:
        a, b = A[..., 0, 0], A[..., 0, 1]
        c, d = A[..., 1, 0], A[..., 1, 1]
        det = a * d - b * c
        row0 = torch.stack([d, -b], dim=-1)
        row1 = torch.stack([-c, a], dim=-1)
        return torch.stack([row0, row1], dim=-2) / det[..., None, None]
    return torch.linalg.inv(A)


def _em_iterations(mixture: torch.Tensor, estimates: torch.Tensor, iteration: int,
                   eps: float) -> torch.Tensor:
    """mixture (C, F, T) complex; estimates (n_src, C, F, T) complex."""
    C = mixture.shape[0]
    eye = torch.eye(C, dtype=mixture.dtype, device=mixture.device)
    for _ in range(iteration):
        v, R = _get_stats(estimates, eps=eps)  # (n, F, T), (n, F, C, C)
        v_c = v.to(R.dtype)
        Cxx = torch.einsum("nft,nfij->ftij", v_c, R)  # (F, T, C, C)
        # A ridge relative to the trace: the closed-form 2x2 determinant
        # a*d - b*c cancels in f32 on near-singular frames of large
        # magnitude (an error of ~1e-7*|ad| swamps any absolute ridge and
        # gives inf or NaN on loud, correlated stereo). 1e-5*tr keeps the
        # smallest eigenvalue >= 1e-5*||Cxx||, at a <= 1e-5 relative bias in
        # the gain.
        trace = Cxx.diagonal(dim1=-2, dim2=-1).sum(dim=-1).real[..., None, None]
        inv_Cxx = _inv_small(Cxx + (math.sqrt(eps) + 1e-5 * trace) * eye)
        gain = torch.einsum("nfik,ftkj->nftij", R, inv_Cxx) * v_c[..., None, None]
        estimates = torch.einsum("nftij,jft->nift", gain, mixture)
    return estimates


def multichannel_wiener_filter(mixture: torch.Tensor, estimated_sources_amplitude: torch.Tensor,
                               iteration: int = 1, eps: float = EPS) -> torch.Tensor:
    """EM refinement of source estimates under a local Gaussian model.

    Args:
      mixture: complex (C, F, T), (1, C, F, T), or batched (B, 1, C, F, T) /
        (B, C, F, T) with batched amplitudes.
      estimated_sources_amplitude: nonnegative (n_src, C, F, T) or batched
        (B, n_src, C, F, T).
    Returns:
      complex estimates of the amplitudes' shape.
    """
    amp = estimated_sources_amplitude
    if amp.ndim == 4:
        if mixture.ndim == 4:
            if mixture.shape[0] != 1:
                raise ValueError(f"a 4-D mixture {tuple(mixture.shape)} needs a leading 1")
            mixture = mixture[0]
        ratio = amp / (amp.sum(dim=0) + eps)
        est = ratio * mixture
        norm = torch.clamp(mixture.abs().max() / 10.0, min=1.0)  # one f32 scale, no host sync
        est = _em_iterations(mixture / norm, est / norm, iteration, eps)
        return norm * est
    if amp.ndim == 5:
        if mixture.ndim == 5:
            mixture = mixture[:, 0]
        return torch.stack([multichannel_wiener_filter(mixture[b], amp[b], iteration, eps)
                            for b in range(amp.shape[0])])
    raise ValueError(f"Unsupported ndim {amp.ndim}")
