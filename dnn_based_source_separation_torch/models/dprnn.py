"""DPRNN: dual-path recurrent backbone (intra-chunk BiLSTM + inter-chunk RNN).

Port of `dnn_based_source_separation_tpu/models/dprnn.py` (offline path).
Chunks are (B, S, K, N) channels-last. The intra pass runs B*S sequences of
K steps, the inter pass B*K sequences of S steps. gLN statistics span the
whole (S*K, N) extent; the causal inter-chunk cLN runs over the chunk-major
flattening (position k*S + s), as the reference does. Module and parameter
names follow the reference torch model (`separator.dprnn.net.{i}.*`).

Luo et al., "Dual-path RNN: efficient long sequence modeling for
time-domain single-channel speech separation", arXiv:1910.06379.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.norms import choose_layer_norm
from ..ops.rnn import choose_rnn
from .modules import Linear

EPS = 1e-12


def _refuse_stream_safe(stream_safe: bool) -> None:
    if stream_safe:
        raise NotImplementedError("stream_safe=True (exact streaming) is not ported yet")


class IntraChunkRNN(nn.Module):
    """Per-chunk BiLSTM + fc + gLN + residual."""

    def __init__(self, num_features: int, hidden_channels: int, norm: bool = True,
                 rnn_type: str = "lstm", stream_safe: bool = False, eps: float = EPS, *,
                 generator=None, device=None):
        super().__init__()
        _refuse_stream_safe(stream_safe)
        self.norm = norm
        self.rnn = choose_rnn(rnn_type, num_features, hidden_channels, bidirectional=True,
                              generator=generator, device=device)
        self.fc = Linear(2 * hidden_channels, num_features, generator=generator, device=device)
        if norm:
            self.norm1d = choose_layer_norm("gLN", num_features, eps=eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, K, N = x.shape
        h = self.fc(self.rnn(x.reshape(B * S, K, N))).view(B, S * K, N)
        if self.norm:
            h = self.norm1d(h)
        return h.view(B, S, K, N) + x


class InterChunkRNN(nn.Module):
    """Across-chunk (Bi)LSTM + fc + norm + residual; unidirectional and cLN when causal."""

    def __init__(self, num_features: int, hidden_channels: int, causal: bool = False,
                 norm: bool = True, rnn_type: str = "lstm", stream_safe: bool = False,
                 eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        _refuse_stream_safe(stream_safe)
        self.norm = norm
        directions = 1 if causal else 2
        self.rnn = choose_rnn(rnn_type, num_features, hidden_channels,
                              bidirectional=not causal, generator=generator, device=device)
        self.fc = Linear(directions * hidden_channels, num_features, generator=generator,
                         device=device)
        if norm:
            self.norm1d = choose_layer_norm("cLN" if causal else "gLN", num_features,
                                            causal=causal, eps=eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, K, N = x.shape
        # (B, S, K, N) -> (B, K, S, N) -> (B*K, S, N): the recurrence runs over chunks.
        h = self.rnn(x.transpose(1, 2).reshape(B * K, S, N))
        h = self.fc(h).view(B, K * S, N)  # chunk-major flattening, as the reference
        if self.norm:
            h = self.norm1d(h)
        return h.view(B, K, S, N).transpose(1, 2) + x


class DPRNNBlock(nn.Module):
    def __init__(self, num_features: int, hidden_channels: int, causal: bool = False,
                 norm: bool = True, rnn_type: str = "lstm", stream_safe: bool = False,
                 eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        self.intra_chunk_block = IntraChunkRNN(
            num_features, hidden_channels, norm=norm, rnn_type=rnn_type,
            stream_safe=stream_safe, eps=eps, generator=generator, device=device)
        self.inter_chunk_block = InterChunkRNN(
            num_features, hidden_channels, causal=causal, norm=norm, rnn_type=rnn_type,
            stream_safe=stream_safe, eps=eps, generator=generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.inter_chunk_block(self.intra_chunk_block(x))


class DPRNN(nn.Module):
    """Stack of num_blocks dual-path blocks; (B, S, K, N) -> (B, S, K, N)."""

    def __init__(self, num_features: int, hidden_channels: int, num_blocks: int = 6,
                 norm: bool = True, causal: bool = False, rnn_type: str = "lstm",
                 stream_safe: bool = False, eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        self.net = nn.ModuleList([
            DPRNNBlock(num_features, hidden_channels, causal=causal, norm=norm,
                       rnn_type=rnn_type, stream_safe=stream_safe, eps=eps,
                       generator=generator, device=device)
            for _ in range(num_blocks)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.net:
            x = block(x)
        return x
