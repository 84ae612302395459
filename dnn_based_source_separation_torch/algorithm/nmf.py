"""NMF, V ~ W H, with the EUC / KL / IS multiplicative updates.

Port of `dnn_based_source_separation_tpu/algorithm/nmf.py`. JAX draws the initial W and
H uniformly in [0.1, 1) with `jax.random` at `PRNGKey(seed)`; the port draws them from a
CPU `torch.Generator` seeded by `seed` (the same distribution, other numbers), as its
KMeans draws its centroids. A call's `init=(W, H)` starts from given factors instead.
"""
from __future__ import annotations

import torch

EPS = 1e-12


class NMF:
    """V (F, T) nonnegative -> basis W (F, K), activation H (K, T)."""

    def __init__(self, n_basis: int, divergence: str = "EUC", n_iterations: int = 100,
                 seed: int = 0):
        if divergence not in ("EUC", "KL", "IS"):
            raise ValueError(f"Unsupported divergence: {divergence}")
        self.n_basis, self.divergence = n_basis, divergence
        self.n_iterations, self.seed = n_iterations, seed

    def _init(self, target: torch.Tensor):
        """The initial (W, H), drawn from the seed's CPU generator."""
        F, T = target.shape
        generator = torch.Generator().manual_seed(self.seed)
        W = 0.1 + 0.9 * torch.rand(F, self.n_basis, generator=generator)
        H = 0.1 + 0.9 * torch.rand(self.n_basis, T, generator=generator)
        return W.to(target), H.to(target)

    def __call__(self, target: torch.Tensor, iteration: int | None = None, init=None):
        iteration = iteration or self.n_iterations
        W, H = self._init(target) if init is None else (x.to(target) for x in init)
        V = target
        for _ in range(iteration):
            WH = W @ H + EPS
            if self.divergence == "EUC":
                W = W * (V @ H.T) / (WH @ H.T + EPS)
                WH = W @ H + EPS
                H = H * (W.T @ V) / (W.T @ WH + EPS)
            elif self.divergence == "KL":
                W = W * ((V / WH) @ H.T) / (H.sum(dim=1)[None, :] + EPS)
                WH = W @ H + EPS
                H = H * (W.T @ (V / WH)) / (W.sum(dim=0)[:, None] + EPS)
            else:  # IS
                W = W * torch.sqrt(((V / WH ** 2) @ H.T) / ((1.0 / WH) @ H.T + EPS))
                WH = W @ H + EPS
                H = H * torch.sqrt((W.T @ (V / WH ** 2)) / (W.T @ (1.0 / WH) + EPS))
        self.basis, self.activation = W, H
        return W, H

    def reconstruct(self) -> torch.Tensor:
        return self.basis @ self.activation
