"""ADANet: the anchored deep attractor network.

Port of `dnn_based_source_separation_tpu/models/adanet.py` (after the reference
`src/models/adanet.py:14`), Luo et al., "Speaker-independent speech separation with
deep attractor network". DANet's embedding trunk (`rnn.*`, `fc`) plus learned
`anchor` (num_anchors, D): every combination (or, with `permute_anchors`,
permutation) of n_sources anchors softly assigns the bins and yields attractors; the
one whose largest pairwise attractor similarity is smallest is kept. The patterns
are evaluated in one batched product over a (P, n_sources) index table, as JAX maps
over them. The names are the reference's, so a port checkpoint opens in JAX's hub
(`hub/torch_convert.py:convert_adanet`).
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
from torch import nn

from ..ops.params import Linear, orthogonal_parameter
from ..ops.rnn import choose_rnn
from .base import SeparationModelMixin, register_model
from .danet import embed_bins, mask_from_attractor

EPS = 1e-12


@register_model
class ADANet(SeparationModelMixin, nn.Module):
    def __init__(self, n_bins: int, embed_dim: int = 20, hidden_channels: int = 600,
                 num_blocks: int = 4, num_anchors: int = 6, dropout: float = 0.5,
                 causal: bool = False, mask_nonlinear: str = "sigmoid", take_log: bool = True,
                 take_db: bool = False, permute_anchors: bool = False, eps: float = EPS, *,
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
        self.anchor = orthogonal_parameter((num_anchors, embed_dim), generator, device)

    def patterns(self, n_sources: int) -> np.ndarray:
        """(P, n_sources) anchor indices, in itertools order."""
        pick = itertools.permutations if self.permute_anchors else itertools.combinations
        return np.asarray(list(pick(range(self.num_anchors), n_sources)), np.int64)

    def forward(self, input, threshold_weight=None, n_sources: int = 2):
        return self.extract_latent(input, threshold_weight, n_sources)[0]

    def extract_latent(self, input, threshold_weight=None, n_sources: int = 2):
        """input (B, 1, F, T) amplitude -> (output (B, n_src, F, T), latent (B, F, T, D),
        attractor (B, n_src, D))."""
        B, _, F, T = input.shape
        latent = embed_bins(self.rnn, self.fc, input, self.embed_dim, self.take_log,
                            self.take_db, self.eps)  # (B, F * T, D)
        patterns = torch.as_tensor(self.patterns(n_sources), device=input.device)
        anchors = self.anchor[patterns]  # (P, S, D)
        assign = torch.softmax(torch.einsum("psd,bnd->pbsn", anchors, latent), dim=2)
        if threshold_weight is not None:
            assign = threshold_weight.reshape(B, 1, F * T) * assign
        attractors = torch.einsum("pbsn,bnd->pbsd", assign, latent) / (
            assign.sum(dim=3, keepdim=True) + self.eps)
        sim = torch.einsum("pbsd,pbtd->pbst", attractors, attractors)
        max_sim = torch.triu(sim, diagonal=1).flatten(2).amax(dim=2)  # (P, B)
        best = max_sim.argmin(dim=0)  # (B,)
        attractor = attractors[best, torch.arange(B, device=input.device)]  # (B, S, D)
        mask = mask_from_attractor(attractor, latent, input.shape, self.mask_nonlinear)
        return mask * input, latent.reshape(B, F, T, self.embed_dim), attractor
