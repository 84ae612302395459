"""Wavesplit: a speaker stack and a FiLM-conditioned separation stack.

Port of `dnn_based_source_separation_tpu/models/wavesplit.py` (`_ConvUnit` :34,
`SpeakerStack` :67, `SeparationStack` :99, `WaveSplit` :148, the losses :245-300),
after Zeghidour & Grangier, arXiv:2002.08933. A dilated TCN emits unit-norm speaker
vectors for every sample and source; training orders them per sample by a PIT
speaker loss against learned speaker embeddings (`forward_train`), inference
clusters them with the batched `KMeans`; the centroids condition every layer of a
second dilated TCN by FiLM, and each layer's skip head is a source estimate.

The stacks compute channels-first, (B, C, T), where a depthwise conv is one cuDNN
call and a dense layer over channels one batched product; gLN's statistics over
(C, T) are the same in either layout. Parameter names follow the JAX tree (the JAX
package has no reference-layout converter for Wavesplit): `speaker_stack.layer{i}`,
`separation_stack.conv_in`, `separation_stack.block{b}_layer{l}`, `film_gamma_{b}_{l}`,
`film_beta_{b}_{l}`, `skip_{b}_{l}`, `out_{b}_{l}` and `spk_embedding`; a unit's
`depthwise` (Conv1d (C, 1, K)) and `pointwise` (Linear) or `conv`, and `norm`
(gamma / beta (1, N, 1)). `hub/from_jax.py:wavesplit_state_dict_from_jax` maps JAX
weights onto them.

`speaker_distance_loss` compares every speaker vector with every row of the
embedding table. JAX writes that as a broadcast difference (B, T, S, n_train, D),
which XLA reduces without storing; eager PyTorch would store it (about 53 GB at
the recipe's B = 4 x 4 s and 101 speakers) and keep it for the backward, so the
table term is ||v||^2 - 2 v.e + ||e||^2. The per-source term (B, T, S, S) keeps
the broadcast difference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..algorithm.clustering import KMeans
from ..criterion.pit import permutation_table
from ..ops.norms import choose_layer_norm, cumulative_layer_norm, global_layer_norm
from .base import SeparationModelMixin, register_model
from .modules import Conv1d, Linear, choose_nonlinear

EPS = 1e-12


def _dense(layer: Linear, x: torch.Tensor) -> torch.Tensor:
    """A dense layer over the channels of (B, C_in, T) -> (B, C_out, T)."""
    return torch.matmul(layer.weight, x) + layer.bias[:, None]


class _ConvUnit(nn.Module):
    """(separable) dilated conv -> [nonlinear] -> [gLN or cLN], (B, C, T) -> (B, out, T)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 dilation: int = 1, separable: bool = True, causal: bool = False,
                 nonlinear: str | None = None, norm: bool = True, eps: float = EPS, *,
                 generator=None, device=None):
        super().__init__()
        self.kernel_size, self.dilation, self.causal = kernel_size, dilation, causal
        self.separable = separable
        if separable:
            self.depthwise = Conv1d(in_channels, in_channels, kernel_size, dilation=dilation,
                                    groups=in_channels, generator=generator, device=device)
            self.pointwise = Linear(in_channels, out_channels, generator=generator,
                                    device=device)
        else:
            self.conv = Conv1d(in_channels, out_channels, kernel_size, dilation=dilation,
                               generator=generator, device=device)
        self.nonlinear = choose_nonlinear(nonlinear)
        self.norm = (choose_layer_norm("cLN" if causal else "gLN", out_channels, causal=causal,
                                       eps=eps, device=device) if norm else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = (self.kernel_size - 1) * self.dilation
        h = F.pad(x, (pad, 0) if self.causal else (pad // 2, pad - pad // 2))
        if self.separable:
            dw = self.depthwise
            h = F.conv1d(h, dw.weight, dw.bias, dilation=self.dilation, groups=dw.groups)
            h = _dense(self.pointwise, h)
        else:
            h = F.conv1d(h, self.conv.weight, self.conv.bias, dilation=self.dilation)
        h = self.nonlinear(h)
        if self.norm is None:
            return h
        if self.causal:  # cumulative statistics over time, channels-last
            gamma, beta = self.norm.affine()
            return cumulative_layer_norm(h.transpose(1, 2), gamma, beta,
                                         self.norm.eps).transpose(1, 2)
        return global_layer_norm(h, self.norm.gamma, self.norm.beta, self.norm.eps)


class SpeakerStack(nn.Module):
    """(B, 1, T) -> unit-norm speaker vectors (B, T, n_sources, latent_dim)."""

    def __init__(self, latent_dim: int = 512, kernel_size: int = 3, num_layers: int = 14,
                 dilated: bool = True, separable: bool = True, causal: bool = False,
                 nonlinear: str | None = None, norm: bool = True, n_sources: int = 2,
                 eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        self.latent_dim, self.num_layers, self.n_sources, self.eps = (
            latent_dim, num_layers, n_sources, eps)
        in_channels = 1
        for idx in range(num_layers):
            out = n_sources * latent_dim if idx == num_layers - 1 else latent_dim
            self.add_module(f"layer{idx}", _ConvUnit(
                in_channels, out, kernel_size, dilation=2**idx if dilated else 1,
                separable=separable, causal=causal, nonlinear=nonlinear, norm=norm, eps=eps,
                generator=generator, device=device))
            in_channels = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for idx in range(self.num_layers):
            y = getattr(self, f"layer{idx}")(x)
            x = y + x if y.shape[1] == x.shape[1] else y
        B, _, T = x.shape
        v = x.view(B, self.n_sources, self.latent_dim, T).permute(0, 3, 1, 2)
        return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + self.eps)


class SeparationStack(nn.Module):
    """(B, 1, T) and centroids (B, n_src, D) -> estimates (B, n_src, T), or every layer's
    (B, num_blocks * num_layers, n_src, T) with `return_all`."""

    def __init__(self, latent_dim: int = 512, kernel_size_in: int = 4, kernel_size: int = 3,
                 num_blocks: int = 4, num_layers: int = 10, dilated: bool = True,
                 separable: bool = True, causal: bool = False, nonlinear: str | None = None,
                 norm: bool = True, n_sources: int = 2, eps: float = EPS, *, generator=None,
                 device=None):
        super().__init__()
        self.kernel_size_in, self.num_blocks, self.num_layers = (
            kernel_size_in, num_blocks, num_layers)
        D = latent_dim
        kw = dict(generator=generator, device=device)
        self.conv_in = Conv1d(1, D, kernel_size_in, **kw)
        for b in range(num_blocks):
            for l in range(num_layers):
                self.add_module(f"film_gamma_{b}_{l}", Linear(n_sources * D, D, **kw))
                self.add_module(f"film_beta_{b}_{l}", Linear(n_sources * D, D, **kw))
                self.add_module(f"block{b}_layer{l}", _ConvUnit(
                    D, D, kernel_size, dilation=2**l if dilated else 1, separable=separable,
                    causal=causal, nonlinear=nonlinear, norm=norm, eps=eps, **kw))
                self.add_module(f"skip_{b}_{l}", Linear(D, n_sources, **kw))
                if not (b == num_blocks - 1 and l == num_layers - 1):
                    self.add_module(f"out_{b}_{l}", Linear(D, D, **kw))

    def forward(self, x: torch.Tensor, spk_centroids: torch.Tensor,
                return_all: bool = False) -> torch.Tensor:
        pad = self.kernel_size_in - 1
        h = F.conv1d(F.pad(x, (pad // 2, pad - pad // 2)), self.conv_in.weight,
                     self.conv_in.bias)
        cond = spk_centroids.reshape(spk_centroids.shape[0], -1)  # (B, n_src * D)
        skips = []
        for b in range(self.num_blocks):
            for l in range(self.num_layers):
                gamma = getattr(self, f"film_gamma_{b}_{l}")(cond)
                beta = getattr(self, f"film_beta_{b}_{l}")(cond)
                y = getattr(self, f"block{b}_layer{l}")(h)
                y = gamma[:, :, None] * y + beta[:, :, None]  # FiLM
                skips.append(_dense(getattr(self, f"skip_{b}_{l}"), y))
                out = getattr(self, f"out_{b}_{l}", None)
                if out is not None:
                    h = h + _dense(out, y)
        return torch.stack(skips, dim=1) if return_all else skips[-1]


def _sort_by_index(v: torch.Tensor, sorted_idx: torch.Tensor) -> torch.Tensor:
    """v (B, T, S, D), sorted_idx (B, T, S_out) -> v[b, t, sorted_idx[b, t, o]]."""
    onehot = F.one_hot(sorted_idx.long(), v.shape[2]).to(v.dtype)  # (B, T, S_out, S_in)
    return torch.einsum("btos,btsd->btod", onehot, v)


def _centroids(v: torch.Tensor, sorted_idx: torch.Tensor) -> torch.Tensor:
    """The mean over T of the sorted speaker vectors, (B, S, D), without storing them."""
    onehot = F.one_hot(sorted_idx.long(), v.shape[2]).to(v.dtype)
    return torch.einsum("btos,btsd->bod", onehot, v) / v.shape[1]


@register_model
class WaveSplit(SeparationModelMixin, nn.Module):
    """(B, 1, T) -> (B, n_sources, T).

    `sorted_idx` (B, T, n_src), from the speaker loss, gives the oracle order of the
    speaker vectors; without it batched KMeans over the speaker vectors gives the
    centroids.
    """

    def __init__(self, latent_dim: int = 512, n_sources: int = 2, n_training_sources: int = 10,
                 spk_kernel_size: int = 3, spk_num_layers: int = 14, sep_kernel_size_in: int = 4,
                 sep_kernel_size: int = 3, sep_num_blocks: int = 4, sep_num_layers: int = 10,
                 dilated: bool = True, separable: bool = True, causal: bool = False,
                 nonlinear: str | None = None, norm: bool = True, iter_clustering: int = 10,
                 eps: float = EPS, *, generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = {k: v for k, v in locals().items()
                        if k not in ("self", "generator", "device", "__class__")}
        for k, v in self._config.items():
            setattr(self, k, v)
        common = dict(dilated=dilated, separable=separable, causal=causal,
                      nonlinear=nonlinear, norm=norm, n_sources=n_sources, eps=eps,
                      generator=generator, device=device)
        self.speaker_stack = SpeakerStack(latent_dim, spk_kernel_size, spk_num_layers,
                                          **common)
        self.separation_stack = SeparationStack(latent_dim, sep_kernel_size_in,
                                                sep_kernel_size, sep_num_blocks,
                                                sep_num_layers, **common)
        self.spk_embedding = nn.Parameter(torch.randn(
            n_training_sources, latent_dim, generator=generator).to(device))

    def forward(self, mixture: torch.Tensor, sorted_idx: torch.Tensor | None = None,
                return_all_layers: bool = False, return_spk_vector: bool = False):
        v = self.speaker_stack(mixture)  # (B, T, S, D)
        B, T, S, D = v.shape
        if sorted_idx is not None:
            centroids = _centroids(v, sorted_idx)
            sorted_v = _sort_by_index(v, sorted_idx) if return_spk_vector else None
        else:
            _, centroids = KMeans(self.n_sources, n_iterations=self.iter_clustering)(
                v.reshape(B, T * S, D))
            sorted_v = v
        est = self.separation_stack(mixture, centroids, return_all=return_all_layers)
        return (est, sorted_v) if return_spk_vector else est

    def forward_train(self, mixture: torch.Tensor, spk_idx: torch.Tensor,
                      gaussian: bool = False):
        """The training forward: (every layer's estimates (B, n_layers, n_src, T), the
        speaker loss (B,)). The speaker vectors are sorted per sample by the speaker loss's
        winning permutation (an integer argmin: no gradient through the order)."""
        v = self.speaker_stack(mixture)
        emb = self.spk_embedding[spk_idx.long()]  # (B, n_src, D)
        spk_loss, sorted_idx = speaker_distance_loss(v, emb, self.spk_embedding, spk_idx,
                                                     gaussian=gaussian, eps=self.eps)
        est_all = self.separation_stack(mixture, _centroids(v, sorted_idx), return_all=True)
        return est_all, spk_loss


def entropy_regularization_loss(spk_embedding: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """-sum over rows of log(distance to the nearest other row): pushes the rows apart.

    The distance is sqrt(d2 + eps): the plain norm's gradient is NaN at the zero
    diagonal, which is masked by adding twice the largest distance.
    """
    n = spk_embedding.shape[0]
    sq = (spk_embedding[:, None] - spk_embedding[None]).square().sum(dim=-1)
    d = torch.sqrt(sq + eps)
    d = d + 2.0 * d.max() * torch.eye(n, dtype=d.dtype, device=d.device)
    return -torch.log(d.amin(dim=-1) + eps).sum()


def speaker_distance_loss(spk_vector: torch.Tensor, spk_embedding: torch.Tensor,
                          all_spk_embedding: torch.Tensor, spk_idx=None, gaussian: bool = False,
                          scale=None, bias=None, eps: float = EPS):
    """Per-sample PIT speaker loss.

    spk_vector (B, T, S, D) unit-norm; spk_embedding (B, S, D), the utterance's table
    rows; all_spk_embedding (n_train, D), the table for the contrastive term; spk_idx is
    unused (the rows come gathered). Returns (loss (B,), sorted_idx (B, T, S)):
    sorted_idx[o] is the vector that belongs to source o, the inverse of the winning
    permutation (the same permutation only at 2 sources).
    """
    S = spk_vector.shape[2]

    def scaled(d):
        return scale.abs() * d + bias if gaussian and scale is not None else d

    pair = scaled((spk_vector[:, :, :, None] - spk_embedding[:, None, None]).square().sum(-1))
    table = all_spk_embedding.to(spk_vector.dtype)
    d_all = scaled(spk_vector.square().sum(-1, keepdim=True)
                   - 2.0 * torch.matmul(spk_vector, table.t()) + table.square().sum(-1))
    logz = torch.logsumexp(-d_all, dim=-1)  # (B, T, S)

    perms = torch.as_tensor(permutation_table(S), device=spk_vector.device)  # (P, S)
    P = perms.shape[0]
    index = perms.view(P, 1, 1, S, 1).expand(P, *pair.shape[:3], 1)
    sel = torch.gather(pair.unsqueeze(0).expand(P, *pair.shape), -1, index)[..., 0]
    per_perm = (sel + logz).sum(dim=-1)  # (P, B, T)
    loss, best = per_perm.min(dim=0)
    sorted_idx = perms.argsort(dim=-1)[best]  # (B, T, S)
    return loss.mean(dim=-1), sorted_idx
