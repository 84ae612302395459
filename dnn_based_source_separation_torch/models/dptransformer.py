"""The dual-path transformer: DPTNet's improved transformer and its block stack.

Port of `dnn_based_source_separation_tpu/models/dptnet.py:28-101`
(`ImprovedTransformer`, `DualPathTransformerBlock`) and of
`dnn_based_source_separation_tpu/models/dptransformer.py` (the standalone
backbone `DualPathTransformer`, blocks `net.{i}`). Chunks are (B, S, K, N)
channels-last; module and parameter names are the reference torch model's
(`{intra,inter}_chunk_block.transformer.{multihead_attn_block.{multihead_attn,
norm1d},subnet.{rnn,fc,norm1d}}`).

The improved transformer is multi-head attention, dropout, the residual
and a gLN (cLN when causal) over each (L, E) sequence, then a feed-forward
block whose first layer is an LSTM (bidirectional unless causal), the
nonlinearity, dropout and `fc`, the residual and the norm. The intra-chunk
block is never causal; the inter-chunk block follows `causal`. As in the
JAX package and the reference, the attention gets no causal mask even when
causal: the inter-chunk attention sees every chunk, future ones included.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.attention import MultiheadAttention
from ..ops.dropout import Dropout
from ..ops.norms import choose_layer_norm
from ..ops.rnn import choose_rnn
from .modules import Linear, choose_nonlinear

EPS = 1e-12


def _norm(norm: bool, num_features: int, causal: bool, eps: float, device):
    if not norm:
        return None
    return choose_layer_norm("cLN" if causal else "gLN", num_features, causal=causal, eps=eps,
                             device=device)


class MultiheadAttentionBlock(nn.Module):
    """Attention, dropout, residual, norm over each (L, E) sequence."""

    def __init__(self, num_features: int, num_heads: int, norm: bool, dropout: float,
                 causal: bool, eps: float, *, generator=None, device=None):
        super().__init__()
        # No causal mask, as the JAX package and the reference (module docstring).
        self.multihead_attn = MultiheadAttention(num_features, num_heads, dropout=dropout,
                                                 generator=generator, device=device)
        self.dropout1d = Dropout(dropout)
        self.norm1d = _norm(norm, num_features, causal, eps, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dropout1d(self.multihead_attn(x)) + x
        return h if self.norm1d is None else self.norm1d(h)


class FeedForwardBlock(nn.Module):
    """LSTM (bidirectional unless causal), nonlinearity, dropout, fc, residual, norm."""

    def __init__(self, num_features: int, hidden_channels: int, norm: bool, nonlinear: str,
                 dropout: float, causal: bool, eps: float, *, generator=None, device=None):
        super().__init__()
        self.rnn = choose_rnn("lstm", num_features, hidden_channels, bidirectional=not causal,
                              generator=generator, device=device)
        self.nonlinear = choose_nonlinear(nonlinear)
        self.dropout1d = Dropout(dropout)
        directions = 1 if causal else 2
        self.fc = Linear(directions * hidden_channels, num_features, generator=generator,
                         device=device)
        self.norm1d = _norm(norm, num_features, causal, eps, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc(self.dropout1d(self.nonlinear(self.rnn(x)))) + x
        return h if self.norm1d is None else self.norm1d(h)


class ImprovedTransformer(nn.Module):
    """(B', L, E) -> (B', L, E): the attention block, then the LSTM feed-forward block."""

    def __init__(self, num_features: int, hidden_channels: int, num_heads: int = 4,
                 norm: bool = True, nonlinear: str = "relu", dropout: float = 0.0,
                 causal: bool = False, eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        self.multihead_attn_block = MultiheadAttentionBlock(
            num_features, num_heads, norm, dropout, causal, eps, generator=generator,
            device=device)
        self.subnet = FeedForwardBlock(num_features, hidden_channels, norm, nonlinear, dropout,
                                       causal, eps, generator=generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.subnet(self.multihead_attn_block(x))


class IntraChunkTransformer(nn.Module):
    """The B·S chunks of (B, S, K, N) as sequences of K frames; never causal."""

    def __init__(self, num_features: int, hidden_channels: int, **kwargs):
        super().__init__()
        self.transformer = ImprovedTransformer(num_features, hidden_channels, causal=False,
                                               **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, K, N = x.shape
        return self.transformer(x.reshape(B * S, K, N)).view(B, S, K, N)


class InterChunkTransformer(nn.Module):
    """The B·K chunk positions of (B, S, K, N) as sequences of S chunks."""

    def __init__(self, num_features: int, hidden_channels: int, causal: bool = False, **kwargs):
        super().__init__()
        self.transformer = ImprovedTransformer(num_features, hidden_channels, causal=causal,
                                               **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, K, N = x.shape
        h = self.transformer(x.transpose(1, 2).reshape(B * K, S, N))
        return h.view(B, K, S, N).transpose(1, 2)


class DualPathTransformerBlock(nn.Module):
    """(B, S, K, N) -> (B, S, K, N): the intra-chunk, then the inter-chunk transformer."""

    def __init__(self, num_features: int, hidden_channels: int, num_heads: int = 4,
                 norm: bool = True, nonlinear: str = "relu", dropout: float = 0.0,
                 causal: bool = False, eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        common = dict(num_heads=num_heads, norm=norm, nonlinear=nonlinear, dropout=dropout,
                      eps=eps, generator=generator, device=device)
        self.intra_chunk_block = IntraChunkTransformer(num_features, hidden_channels, **common)
        self.inter_chunk_block = InterChunkTransformer(num_features, hidden_channels,
                                                       causal=causal, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.inter_chunk_block(self.intra_chunk_block(x))


class DualPathTransformer(nn.Module):
    """(B, S, K, N) -> (B, S, K, N) stack of dual-path transformer blocks."""

    def __init__(self, num_features: int, hidden_channels: int, num_blocks: int = 6,
                 num_heads: int = 4, norm: bool = True, nonlinear: str = "relu",
                 dropout: float = 0.0, causal: bool = False, eps: float = EPS, *,
                 generator=None, device=None):
        super().__init__()
        self.net = nn.ModuleList([
            DualPathTransformerBlock(num_features, hidden_channels, num_heads=num_heads,
                                     norm=norm, nonlinear=nonlinear, dropout=dropout,
                                     causal=causal, eps=eps, generator=generator, device=device)
            for _ in range(num_blocks)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.net:
            x = block(x)
        return x
