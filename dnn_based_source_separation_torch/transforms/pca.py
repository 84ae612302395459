"""Principal component analysis.

Port of `dnn_based_source_separation_tpu/transforms/pca.py`. Each component is defined
up to its sign.
"""
from __future__ import annotations

import torch


def pca(x: torch.Tensor, n_components: int | None = None, center: bool = True):
    """x (n_samples, n_features) -> (projected, components, explained variances), the
    components by decreasing variance."""
    if center:
        x = x - x.mean(dim=0, keepdim=True)
    cov = x.T @ x / (x.shape[0] - 1)
    eigvals, eigvecs = torch.linalg.eigh(cov)
    order = torch.argsort(eigvals, descending=True)
    eigvals, eigvecs = eigvals[order], eigvecs[:, order]
    if n_components is not None:
        eigvals, eigvecs = eigvals[:n_components], eigvecs[:, :n_components]
    return x @ eigvecs, eigvecs, eigvals
