"""Deep clustering: unit-norm time-frequency embeddings, with ChimeraNet's mask head.

Port of `dnn_based_source_separation_tpu/models/deep_clustering.py` (DeepEmbedding,
ChimeraNet, DeepEmbeddingPlus; after the reference `src/models/deep_clustering.py`
:14, :390, :307). Hershey et al., arXiv:1508.04306; Luo et al., arXiv:1611.06265.
Each model reads an amplitude spectrogram (B, 1, F, T), takes its log (or dB), runs a
stacked (Bi)LSTM over the frames (`ops/rnn.py`, the port's recurrence kernels on the
card) and maps every frame to F embeddings of D. Parameter names are the reference's
torch names: `rnn.*` (nn.LSTM's), `fc` (or `fc_embedding` and `fc_mask`).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.params import Linear
from ..ops.rnn import choose_rnn
from .base import SeparationModelMixin, register_model

EPS = 1e-12


def spectral_features(input: torch.Tensor, take_log: bool, take_db: bool,
                      eps: float) -> torch.Tensor:
    """log(|X| + eps), its dB, or |X| itself, as the models' front end reads it."""
    if take_log:
        return torch.log(input + eps)
    if take_db:
        return 20.0 * torch.log10(input + eps)
    return input


def unit_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


class _Embedding(SeparationModelMixin, nn.Module):
    """The shared trunk: config, the (Bi)LSTM over frames and its output width."""

    def _trunk(self, n_bins, hidden_channels, num_layers, causal, rnn_type, generator, device):
        self.rnn = choose_rnn(rnn_type, n_bins, hidden_channels, num_layers=num_layers,
                              bidirectional=not causal, generator=generator, device=device)
        return hidden_channels * (1 if causal else 2)

    def _frames(self, input: torch.Tensor, take_db: bool) -> torch.Tensor:
        """(B, 1, F, T) or (B, F, T) amplitude -> the recurrence's output (B, T, D * H)."""
        x = input[:, 0] if input.dim() == 4 else input
        return self.rnn(spectral_features(x, self.take_log, take_db, self.eps).transpose(1, 2))

    def _config_of(self, local_vars: dict) -> None:
        self._config = {k: v for k, v in local_vars.items()
                        if k not in ("self", "generator", "device", "__class__")}
        for k, v in self._config.items():
            setattr(self, k, v)


@register_model
class DeepEmbedding(_Embedding):
    """(B, 1, F, T) amplitude -> unit-norm embeddings (B, F, T, D)."""

    def __init__(self, n_bins: int, hidden_channels: int = 300, embed_dim: int = 40,
                 num_layers: int = 2, causal: bool = False, rnn_type: str = "lstm",
                 take_log: bool = True, take_db: bool = False, eps: float = EPS, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config_of(locals())
        width = self._trunk(n_bins, hidden_channels, num_layers, causal, rnn_type, generator,
                            device)
        self.fc = Linear(width, n_bins * embed_dim, generator=generator, device=device)

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        B, _, F, T = input.shape
        x = self.fc(self._frames(input, self.take_db)).view(B, T, F, self.embed_dim)
        return unit_norm(x.transpose(1, 2), self.eps)


@register_model
class ChimeraNet(_Embedding):
    """Deep-clustering embeddings and a mask head: (mask (B, n_src, F, T), embeddings
    (B, F, T, D))."""

    def __init__(self, n_bins: int, hidden_channels: int = 300, embed_dim: int = 20,
                 num_layers: int = 2, n_sources: int = 2, causal: bool = False,
                 rnn_type: str = "lstm", take_log: bool = True, take_db: bool = False,
                 mask_nonlinear: str = "softmax", eps: float = EPS, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config_of(locals())
        if mask_nonlinear not in ("softmax", "sigmoid"):
            raise ValueError(f"Unsupported mask nonlinearity: {mask_nonlinear}")
        width = self._trunk(n_bins, hidden_channels, num_layers, causal, rnn_type, generator,
                            device)
        kw = dict(generator=generator, device=device)
        self.fc_embedding = Linear(width, n_bins * embed_dim, **kw)
        self.fc_mask = Linear(width, n_bins * n_sources, **kw)

    def forward(self, input: torch.Tensor):
        B, _, F, T = input.shape
        h = self._frames(input, False)  # ChimeraNet reads log or linear amplitudes only
        emb = torch.tanh(self.fc_embedding(h)).view(B, T, F, self.embed_dim)
        emb = unit_norm(emb.transpose(1, 2), self.eps)
        mask = self.fc_mask(h).view(B, T, self.n_sources, F).permute(0, 2, 3, 1)
        mask = torch.softmax(mask, dim=1) if self.mask_nonlinear == "softmax" else torch.sigmoid(
            mask)
        return mask, emb


@register_model
class DeepEmbeddingPlus(_Embedding):
    """DC++'s embedding head: sigmoid of the unit-norm embeddings, (B, F, T, D). The
    enhancement sub-net's widths are kept in the config; its forward is the identity, as
    the reference's."""

    def __init__(self, n_bins: int, hidden_channels: int = 300, embed_dim: int = 40,
                 num_layers: int = 4, enh_hidden_channels: int = 600, enh_num_layers: int = 2,
                 causal: bool = False, rnn_type: str = "lstm", take_log: bool = True,
                 take_db: bool = False, eps: float = EPS, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config_of(locals())
        width = self._trunk(n_bins, hidden_channels, num_layers, causal, rnn_type, generator,
                            device)
        self.fc = Linear(width, n_bins * embed_dim, generator=generator, device=device)

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        F, T = input.shape[-2:]
        x = self.fc(self._frames(input, self.take_db)).view(-1, T, F, self.embed_dim)
        return torch.sigmoid(unit_norm(x.transpose(1, 2), self.eps))


DeepEmbedding_pp = DeepEmbeddingPlus  # the reference's name
