"""DANet, the deep attractor network, and its fixed-attractor variant.

Port of `dnn_based_source_separation_tpu/models/danet.py` (after the reference
`src/models/danet.py`: DANet :14, extract_latent :76-146, FixedAttractorDANet :353),
Chen et al., arXiv:1611.08930. A stacked (Bi)LSTM over the frames of the log
amplitude (`ops/rnn.py`, the port's recurrence kernels on the card) and `fc` give an
embedding of D for every time-frequency bin. Training takes the attractors from the
oracle assignment (optionally weighted by the threshold weight); inference takes them
from batched KMeans over the embeddings (`algorithm/clustering.py`); the mask is
sigmoid (or softmax over sources) of attractor . embedding. Parameter names are the
reference's torch names, `rnn.*` and `fc`, so a port checkpoint opens in JAX's hub
(`hub/torch_convert.py:convert_danet`).
"""
from __future__ import annotations

import torch
from torch import nn

from ..algorithm.clustering import KMeans
from ..ops.params import Linear, orthogonal_parameter
from ..ops.rnn import choose_rnn
from .base import SeparationModelMixin, register_model
from .deep_clustering import spectral_features

EPS = 1e-12


def embed_bins(rnn: nn.Module, fc: nn.Module, input: torch.Tensor, embed_dim: int,
               take_log: bool, take_db: bool, eps: float) -> torch.Tensor:
    """(B, 1, F, T) amplitude -> latent (B, F * T, D); fc's output is read as (D, F)."""
    if take_log and take_db:
        raise ValueError("Either take_log or take_db should be False.")
    B, _, F, T = input.shape
    x = rnn(spectral_features(input[:, 0], take_log, take_db, eps).transpose(1, 2))
    x = fc(x).view(B, T, embed_dim, F)
    return x.permute(0, 2, 3, 1).reshape(B, embed_dim, F * T).transpose(1, 2)


def mask_from_attractor(attractor: torch.Tensor, latent: torch.Tensor, shape,
                        mask_nonlinear: str) -> torch.Tensor:
    """attractor (B, S, D), latent (B, F * T, D) -> mask (B, S, F, T)."""
    B, _, F, T = shape
    similarity = torch.einsum("bsd,bnd->bsn", attractor, latent).reshape(B, -1, F, T)
    if mask_nonlinear == "sigmoid":
        return torch.sigmoid(similarity)
    if mask_nonlinear == "softmax":
        return torch.softmax(similarity, dim=1)
    raise ValueError(f"Unsupported mask nonlinearity: {mask_nonlinear}")


@register_model
class DANet(SeparationModelMixin, nn.Module):
    def __init__(self, n_bins: int, embed_dim: int = 20, hidden_channels: int = 300,
                 num_blocks: int = 4, dropout: float = 0.0, causal: bool = False,
                 mask_nonlinear: str = "sigmoid", take_log: bool = True, take_db: bool = False,
                 iter_clustering: int = 10, eps: float = EPS, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = {k: v for k, v in locals().items()
                        if k not in ("self", "generator", "device", "__class__")}
        for k, v in self._config.items():
            setattr(self, k, v)
        self.rnn = choose_rnn("lstm", n_bins, hidden_channels, num_layers=num_blocks,
                              bidirectional=not causal, dropout=dropout, generator=generator,
                              device=device)
        self.fc = Linear(hidden_channels * (1 if causal else 2), n_bins * embed_dim,
                         generator=generator, device=device)

    def _embed(self, input: torch.Tensor) -> torch.Tensor:
        return embed_bins(self.rnn, self.fc, input, self.embed_dim, self.take_log,
                          self.take_db, self.eps)

    def forward(self, input, assignment=None, threshold_weight=None, n_sources=None):
        return self.extract_latent(input, assignment, threshold_weight, n_sources)[0]

    def extract_latent(self, input, assignment=None, threshold_weight=None, n_sources=None):
        """input (B, 1, F, T) amplitude -> (output (B, n_src, F, T), latent (B, F, T, D),
        attractor (B, n_src, D)).

        With `assignment` (B, n_src, F, T) the attractors are the (threshold-weighted)
        means of the embeddings assigned to each source; without it, KMeans centroids of
        `n_sources` clusters.
        """
        B, _, F, T = input.shape
        latent = self._embed(input)
        if assignment is None:
            if n_sources is None:
                raise ValueError("Specify n_sources for clustering inference.")
            _, attractor = KMeans(n_sources, n_iterations=self.iter_clustering)(latent)
        else:
            a = assignment.reshape(B, assignment.shape[1], F * T)
            if threshold_weight is not None:
                a = threshold_weight.reshape(B, 1, F * T) * a
            attractor = torch.einsum("bsn,bnd->bsd", a, latent) / (
                a.sum(dim=2, keepdim=True) + self.eps)
        mask = mask_from_attractor(attractor, latent, input.shape, self.mask_nonlinear)
        return mask * input, latent.reshape(B, F, T, self.embed_dim), attractor

    def extract_latent_by_attractor(self, input, attractor):
        """Separate with given attractors, (n_src, D) or (B, n_src, D)."""
        B, _, F, T = input.shape
        latent = self._embed(input)
        if attractor.dim() == 2:
            attractor = attractor.expand(B, *attractor.shape)
        mask = mask_from_attractor(attractor, latent, input.shape, self.mask_nonlinear)
        return mask * input, latent.reshape(B, F, T, self.embed_dim)


@register_model
class FixedAttractorDANet(SeparationModelMixin, nn.Module):
    """DANet whose attractors are learned parameters, `attractor` (n_sources, D)."""

    def __init__(self, n_bins: int, embed_dim: int = 20, hidden_channels: int = 300,
                 num_blocks: int = 4, n_sources: int = 2, dropout: float = 0.0,
                 causal: bool = False, mask_nonlinear: str = "sigmoid", take_log: bool = True,
                 take_db: bool = False, eps: float = EPS, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = {k: v for k, v in locals().items()
                        if k not in ("self", "generator", "device", "__class__")}
        self.base = DANet(n_bins, embed_dim, hidden_channels, num_blocks, dropout, causal,
                          mask_nonlinear, take_log, take_db, eps=eps, generator=generator,
                          device=device)
        self.attractor = orthogonal_parameter((n_sources, embed_dim), generator, device)

    def forward(self, input):
        return self.base.extract_latent_by_attractor(input, self.attractor)[0]
