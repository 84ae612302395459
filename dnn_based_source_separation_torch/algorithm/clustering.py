"""Batched clustering: KMeans, SoftKMeans, SphericalKMeans and a diagonal GMM.

Port of `dnn_based_source_separation_tpu/algorithm/clustering.py` (KMeans :35,
SoftKMeans :73, SphericalKMeans :94, GMMClustering :116), which Wavesplit's and
DANet's inference paths and the deep-clustering tester use to turn embeddings into
centroids. Every algorithm is batched over a leading axis, data (B, n_samples, D),
and runs a fixed number of iterations; assignments are one-hot products, not scatters.

Squared distances are the broadcast difference summed over D, as JAX computes them,
not the ||x||^2 - 2 x.c + ||c||^2 expansion: an assignment near a boundary would
flip with the other rounding.

The initial centroids (kmeans++ or a random choice of distinct samples) are drawn
from a CPU `torch.Generator` seeded by `seed`: kmeans++'s probabilities (B x n values)
come to the host for each draw and the chosen indices go back, so one seed picks the
same samples on every device, as the port's weights are drawn on the CPU. They are not
`jax.random`'s draws. Every `__call__` therefore takes optional
initial centroids `init`: a tensor (B, K, D), or a function of the data that returns
one; `_init(data)` is the one place that draws them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-12


def squared_distances(data: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(B, n, D), (B, K, D) -> (B, n, K): sum over D of the squared broadcast difference."""
    return (data[:, :, None] - centroids[:, None]).square().sum(dim=-1)


def _kmeans_pp_init(data: torch.Tensor, n_clusters: int,
                    generator: torch.Generator) -> torch.Tensor:
    """kmeans++ seeding of every batch item: (B, n, D) -> (B, K, D).

    The first centroid is a uniform draw; each next one is drawn with probability
    d2 / sum(d2) + EPS, d2 the squared distance to the nearest centroid so far (JAX
    samples `categorical(log(probs + EPS))`, the same distribution).
    """
    B, n, _ = data.shape
    rows = torch.arange(B, device=data.device)
    idx = torch.randint(0, n, (B,), generator=generator).to(data.device)
    centroids = data[rows, idx][:, None]
    for _ in range(n_clusters - 1):
        d2 = squared_distances(data, centroids).amin(dim=-1)  # (B, n)
        probs = d2 / (d2.sum(dim=-1, keepdim=True) + EPS) + EPS
        idx = torch.multinomial(probs.float().cpu(), 1, generator=generator)[:, 0]
        centroids = torch.cat([centroids, data[rows, idx.to(data.device)][:, None]], dim=1)
    return centroids


class KMeans:
    """Batched hard KMeans. data: (B, n_samples, D)."""

    def __init__(self, n_clusters: int, init_centroids: str = "kmeans++",
                 n_iterations: int = 10, seed: int = 0):
        self.n_clusters = n_clusters
        self.init_centroids = init_centroids
        self.n_iterations = n_iterations
        self.seed = seed

    def _init(self, data: torch.Tensor) -> torch.Tensor:
        """The initial centroids (B, K, D), drawn from the seed's CPU generator."""
        generator = torch.Generator().manual_seed(self.seed)
        if self.init_centroids == "kmeans++":
            return _kmeans_pp_init(data, self.n_clusters, generator)
        B, n, _ = data.shape
        keys = torch.rand(B, n, generator=generator)
        idx = keys.argsort(dim=-1)[:, :self.n_clusters].to(data.device)  # K distinct samples
        return torch.gather(data, 1, idx[..., None].expand(-1, -1, data.shape[-1]))

    def _start(self, data: torch.Tensor, init) -> torch.Tensor:
        if init is None:
            return self._init(data)
        return (init(data) if callable(init) else init).to(data.dtype)

    def __call__(self, data: torch.Tensor, iteration: int | None = None, init=None):
        """Returns (assignments (B, n_samples) int64, centroids (B, K, D))."""
        iteration = iteration or self.n_iterations
        centroids = self._start(data, init)
        for _ in range(iteration):
            assign = squared_distances(data, centroids).argmin(dim=-1)
            onehot = F.one_hot(assign, self.n_clusters).to(data.dtype)
            counts = onehot.sum(dim=1)  # (B, K)
            sums = torch.einsum("bnk,bnd->bkd", onehot, data)
            new = sums / counts.clamp(min=1.0)[..., None]
            centroids = torch.where(counts[..., None] > 0, new, centroids)
        return squared_distances(data, centroids).argmin(dim=-1), centroids


class SoftKMeans(KMeans):
    """Soft assignments softmax(-beta d2) over the clusters."""

    def __init__(self, n_clusters: int, beta: float = 1.0, **kwargs):
        super().__init__(n_clusters, **kwargs)
        self.beta = beta

    def __call__(self, data, iteration=None, init=None):
        """Returns (responsibilities (B, n, K), centroids (B, K, D))."""
        iteration = iteration or self.n_iterations
        centroids = self._start(data, init)
        for _ in range(iteration):
            gamma = torch.softmax(-self.beta * squared_distances(data, centroids), dim=-1)
            sums = torch.einsum("bnk,bnd->bkd", gamma, data)
            centroids = sums / (gamma.sum(dim=1)[..., None] + EPS)
        gamma = torch.softmax(-self.beta * squared_distances(data, centroids), dim=-1)
        return gamma, centroids


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + EPS)


class SphericalKMeans(KMeans):
    """Cosine-similarity KMeans on unit-normalised data."""

    def __call__(self, data, iteration=None, init=None):
        """Returns (assignments (B, n), centroids (B, K, D)); `init` (a function of it
        sees the normalised data) is normalised as the drawn centroids are."""
        iteration = iteration or self.n_iterations
        data = _unit(data)
        centroids = _unit(self._start(data, init))
        for _ in range(iteration):
            assign = torch.einsum("bnd,bkd->bnk", data, centroids).argmax(dim=-1)
            onehot = F.one_hot(assign, self.n_clusters).to(data.dtype)
            sums = torch.einsum("bnk,bnd->bkd", onehot, data)
            new = sums / (torch.linalg.vector_norm(sums, dim=-1, keepdim=True) + EPS)
            counts = onehot.sum(dim=1)
            centroids = torch.where(counts[..., None] > 0, new, centroids)
        return torch.einsum("bnd,bkd->bnk", data, centroids).argmax(dim=-1), centroids


class GMMClustering:
    """Diagonal-covariance Gaussian mixture by EM, its means started from 5 KMeans steps."""

    def __init__(self, n_clusters: int, n_iterations: int = 20, seed: int = 0):
        self.n_clusters = n_clusters
        self.n_iterations = n_iterations
        self.seed = seed

    def __call__(self, data, iteration=None, init=None):
        """data (B, n, D) -> (responsibilities (B, n, K), means (B, K, D)); `init` is the
        KMeans' initial centroids."""
        iteration = iteration or self.n_iterations
        B, n, D = data.shape
        K = self.n_clusters
        _, means = KMeans(K, n_iterations=5, seed=self.seed)(data, init=init)
        var = data.new_ones(B, K, D)
        pi = data.new_full((B, K), 1.0 / K)
        r = None
        for _ in range(iteration):
            diff2 = (data[:, :, None] - means[:, None]).square()  # (B, n, K, D)
            log_prob = -0.5 * (diff2 / (var[:, None] + EPS)
                               + torch.log(2 * math.pi * var[:, None] + EPS)).sum(dim=-1)
            r = torch.softmax(torch.log(pi[:, None] + EPS) + log_prob, dim=-1)
            nk = r.sum(dim=1) + EPS  # (B, K)
            means = torch.einsum("bnk,bnd->bkd", r, data) / nk[..., None]
            diff2 = (data[:, :, None] - means[:, None]).square()
            var = torch.einsum("bnk,bnkd->bkd", r, diff2) / nk[..., None] + EPS
            pi = nk / n
        return r, means
