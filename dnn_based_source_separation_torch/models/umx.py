"""Open-Unmix (UMX): BLSTM spectrogram masking for music source separation.

Port of `dnn_based_source_separation_tpu/models/umx.py` (TransformBlock1d,
OpenUnmix, ParallelOpenUnmix). Stoeter et al., "Open-Unmix -- A Reference
Implementation for Music Source Separation". I/O: a (B, C, n_bins, n_frames)
magnitude spectrogram -> the same-shape masked magnitude; internally
channels-last (B, frames, features), the features laid out C-major.

Parameter and buffer names are the reference torch model's, those that
`hub/torch_convert.py:convert_open_unmix` reads: `scale_in`, `bias_in`,
`scale_out`, `bias_out`, `block.fc.weight`, `block.norm1d.*`, `rnn.*`,
`net.0.*`, `net.1.*`. The recurrence is the port's `ops/rnn.py` (the fused
kernels on the card): hidden // 2 per direction, or hidden for the causal,
unidirectional model.

Serving only: BatchNorm uses its running statistics, and a module in train
mode raises (BatchNorm's batch statistics and the LSTM's dropout come with
training). A `dropout` config loads and is ignored in eval mode.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.params import Weight
from ..ops.rnn import choose_rnn
from .base import SeparationModelMixin, register_model

EPS = 1e-12
SAMPLE_RATE_MUSDB18 = 44100
__sources__ = ["bass", "drums", "other", "vocals"]


class TransformBlock1d(nn.Module):
    """Linear (no bias) -> BatchNorm (eps 1e-5; flax momentum 0.9 is torch's 0.1) ->
    optional tanh or relu, over (B, T, F)."""

    def __init__(self, in_features: int, out_features: int, nonlinear: Optional[str] = None,
                 *, generator=None, device=None):
        super().__init__()
        if nonlinear not in (None, "tanh", "relu"):
            raise ValueError(f"Unsupported nonlinearity: {nonlinear}")
        self.nonlinear = nonlinear
        self.fc = Weight((out_features, in_features), in_features, generator, device)
        self.norm1d = nn.BatchNorm1d(out_features, eps=1e-5, momentum=0.1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("UMX BatchNorm in train mode is not ported yet (it comes "
                                      "with musdb18 training); call .eval() to serve")
        y = F.linear(x, self.fc.weight)
        y = self.norm1d(y.reshape(-1, y.shape[-1])).reshape(y.shape)
        if self.nonlinear == "tanh":
            return torch.tanh(y)
        if self.nonlinear == "relu":
            return F.relu(y)
        return y


def config_of(local_vars: dict) -> dict:
    """A model's config from its __init__'s locals(): the JAX dataclass fields."""
    config = {k: v for k, v in local_vars.items()
              if k not in ("self", "generator", "device", "__class__")}
    if config.get("n_bins") is None:
        raise ValueError("Specify `n_bins`.")
    if "sources" in config:
        config["sources"] = tuple(config["sources"])
    return config


@register_model
class OpenUnmix(SeparationModelMixin, nn.Module):
    """(B, C, n_bins, n_frames) magnitude -> the same shape, masked.

    `encode` (the input affine and block) and `decode` (the output blocks,
    affine and mask) are X-UMX's per-source halves too.
    """

    def __init__(self, in_channels: int, hidden_channels: int = 512, num_layers: int = 3,
                 n_bins: Optional[int] = None, max_bin: Optional[int] = None,
                 dropout: Optional[float] = None, causal: bool = False, rnn_type: str = "lstm",
                 eps: float = EPS, *, generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = config_of(locals())
        C, H = in_channels, hidden_channels
        self.n_bins, self.max_bin, self.eps = n_bins, max_bin or n_bins, eps
        self.scale_in = nn.Parameter(torch.ones(self.max_bin, device=device))
        self.bias_in = nn.Parameter(torch.zeros(self.max_bin, device=device))
        self.scale_out = nn.Parameter(torch.ones(n_bins, device=device))
        self.bias_out = nn.Parameter(torch.zeros(n_bins, device=device))
        self.block = TransformBlock1d(C * self.max_bin, H, nonlinear="tanh",
                                      generator=generator, device=device)
        self.rnn = choose_rnn(rnn_type, H, H if causal else H // 2, num_layers=num_layers,
                              bidirectional=not causal, dropout=dropout or 0.0,
                              generator=generator, device=device)
        self.net = nn.ModuleList([
            TransformBlock1d(2 * H, H, nonlinear="relu", generator=generator, device=device),
            TransformBlock1d(H, C * n_bins, generator=generator, device=device),
        ])

    def encode(self, input: torch.Tensor) -> torch.Tensor:
        """(B, C, n_bins, T) -> the input block's output (B, T, H)."""
        B, C, _, T = input.shape
        x = input[:, :, :self.max_bin]
        x = (x - self.bias_in[:, None]) / (self.scale_in[:, None].abs() + self.eps)
        return self.block(x.permute(0, 3, 1, 2).reshape(B, T, C * self.max_bin))

    def decode(self, h: torch.Tensor, input: torch.Tensor) -> torch.Tensor:
        """The output blocks on (B, T, 2H) -> the masked input (B, C, n_bins, T)."""
        B, C, _, T = input.shape
        x = self.net[1](self.net[0](h)).reshape(B, T, C, self.n_bins).permute(0, 2, 3, 1)
        x = self.scale_out[:, None] * x + self.bias_out[:, None]
        return F.relu(x) * input

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        h = self.encode(input)
        return self.decode(torch.cat([h, self.rnn(h)], dim=-1), input)


def backbones(sources, *args, **kwargs) -> nn.ModuleDict:
    """`backbone.<source>`: one OpenUnmix per stem."""
    return nn.ModuleDict({source: OpenUnmix(*args, **kwargs) for source in sources})


@register_model
class ParallelOpenUnmix(SeparationModelMixin, nn.Module):
    """One OpenUnmix per stem, `backbone.<source>`:
    (B, 1, C, n_bins, n_frames) -> (B, n_sources, C, n_bins, n_frames)."""

    def __init__(self, in_channels: int, hidden_channels: int = 512, num_layers: int = 3,
                 n_bins: Optional[int] = None, max_bin: Optional[int] = None,
                 dropout: Optional[float] = None, causal: bool = False, rnn_type: str = "lstm",
                 sources: Sequence[str] = tuple(__sources__), eps: float = EPS, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = config_of(locals())
        self.sources = self._config["sources"]
        self.backbone = backbones(self.sources, in_channels, hidden_channels, num_layers,
                                  n_bins=n_bins, max_bin=max_bin, dropout=dropout,
                                  causal=causal, rnn_type=rnn_type, eps=eps,
                                  generator=generator, device=device)

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        x = input[:, 0]
        return torch.stack([self.backbone[source](x) for source in self.sources], dim=1)
