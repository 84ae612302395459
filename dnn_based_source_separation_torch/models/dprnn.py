"""DPRNN: dual-path recurrent backbone (intra-chunk BiRNN + inter-chunk RNN).

Port of `dnn_based_source_separation_tpu/models/dprnn.py`. Chunks are
(B, S, K, N) channels-last. The intra pass runs B*S sequences of K steps,
the inter pass B*K sequences of S steps. Module and parameter names follow
the reference torch model (`separator.dprnn.net.{i}.*`).

Two norm profiles:
- reference parity (`stream_safe=False`): the intra norm is a gLN over the
  whole (S*K, N) extent; the causal inter-chunk cLN runs over the
  chunk-major flattening (position k*S + s), as the reference does;
- `stream_safe=True` (causal only): both norms are cLNs over the time-major
  flattening (position s*K + k), so chunk s sees only chunks <= s and the
  stack streams exactly (`stream`, with the inter-chunk RNN state carried).

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


class IntraChunkRNN(nn.Module):
    """Per-chunk BiRNN + fc + norm (gLN, or time-major cLN when stream-safe) + residual."""

    def __init__(self, num_features: int, hidden_channels: int, norm: bool = True,
                 rnn_type: str = "lstm", stream_safe: bool = False, eps: float = EPS, *,
                 generator=None, device=None):
        super().__init__()
        self.norm = norm
        self.rnn = choose_rnn(rnn_type, num_features, hidden_channels, bidirectional=True,
                              generator=generator, device=device)
        self.fc = Linear(2 * hidden_channels, num_features, generator=generator, device=device)
        if norm:
            self.norm1d = choose_layer_norm("cLN" if stream_safe else "gLN", num_features,
                                            causal=stream_safe, eps=eps, device=device)

    def _rnn_fc(self, x: torch.Tensor) -> torch.Tensor:
        B, S, K, N = x.shape
        # Chunk-local: the recurrence never carries state across streamed calls.
        return self.fc(self.rnn(x.reshape(B * S, K, N))).view(B, S * K, N)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self._rnn_fc(x)
        if self.norm:
            h = self.norm1d(h)
        return h.view(x.shape) + x

    def stream(self, x: torch.Tensor, state: dict):
        h = self._rnn_fc(x)
        new = {}
        if self.norm:
            h, new["norm"] = self.norm1d.stream(h, state.get("norm"))
        return h.view(x.shape) + x, new


class InterChunkRNN(nn.Module):
    """Across-chunk (Bi)RNN + fc + norm + residual; unidirectional and cLN when causal."""

    def __init__(self, num_features: int, hidden_channels: int, causal: bool = False,
                 norm: bool = True, rnn_type: str = "lstm", stream_safe: bool = False,
                 eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        self.norm, self.stream_safe = norm, stream_safe
        directions = 1 if causal else 2
        self.rnn = choose_rnn(rnn_type, num_features, hidden_channels,
                              bidirectional=not causal, generator=generator, device=device)
        self.fc = Linear(directions * hidden_channels, num_features, generator=generator,
                         device=device)
        if norm:
            self.norm1d = choose_layer_norm("cLN" if causal else "gLN", num_features,
                                            causal=causal, eps=eps, device=device)

    @staticmethod
    def _across_chunks(x: torch.Tensor) -> torch.Tensor:
        # (B, S, K, N) -> (B, K, S, N) -> (B*K, S, N): the recurrence runs over chunks.
        B, S, K, N = x.shape
        return x.transpose(1, 2).reshape(B * K, S, N)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, K, N = x.shape
        h = self.fc(self.rnn(self._across_chunks(x))).view(B, K, S, N)
        if self.norm:
            if self.stream_safe:  # time-major flattening, position s*K + k
                h = self.norm1d(h.transpose(1, 2).reshape(B, S * K, N))
                h = h.view(B, S, K, N).transpose(1, 2)
            else:  # chunk-major flattening, position k*S + s, as the reference
                h = self.norm1d(h.reshape(B, K * S, N)).view(B, K, S, N)
        return h.transpose(1, 2) + x

    def stream(self, x: torch.Tensor, state: dict):
        B, S, K, N = x.shape
        h, rnn_state = self.rnn.stream(self._across_chunks(x), state.get("rnn"))
        h = self.fc(h).view(B, K, S, N).transpose(1, 2).reshape(B, S * K, N)
        new = {"rnn": rnn_state}
        if self.norm:
            h, new["norm"] = self.norm1d.stream(h, state.get("norm"))
        return h.view(B, S, K, N) + x, new


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
        if stream_safe and not causal:
            raise ValueError("stream_safe=True requires causal=True")
        self.net = nn.ModuleList([
            DPRNNBlock(num_features, hidden_channels, causal=causal, norm=norm,
                       rnn_type=rnn_type, stream_safe=stream_safe, eps=eps,
                       generator=generator, device=device)
            for _ in range(num_blocks)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.net:
            x = block(x)
        return x

    def stream(self, x: torch.Tensor, state: dict):
        """Exact streaming of a stream-safe stack over the next chunks of a stream.

        `state` maps "{i}.intra" / "{i}.inter" to each block's carried state
        (missing = stream start): the two cLNs' running statistics and the
        inter-chunk RNN's per-layer state. Returns (chunks, new state).
        """
        new = {}
        for i, block in enumerate(self.net):
            x, new[f"{i}.intra"] = block.intra_chunk_block.stream(x, state.get(f"{i}.intra", {}))
            x, new[f"{i}.inter"] = block.inter_chunk_block.stream(x, state.get(f"{i}.inter", {}))
        return x, new
