"""FurcaNet: a gated-conv front end and a stacked BiLSTM separator over raw samples.

Port of `dnn_based_source_separation_tpu/models/furcanet.py` (after the
reference's `src/models/furcanet.py`). No encoder: each of the
`num_conv_blocks` blocks is a K-tap conv times its gate's nonlinearity over
the samples, then a gLN (cLN when causal); the stacked bidirectional LSTM
(`rnn_blocks`, H = `rnn_hidden_channels` a direction) runs over every sample
and a dense layer `fc` regresses the n_sources waveforms directly.

FurcaNet has no converter of the reference layout in the JAX package, so the
parameter names follow the JAX tree: `gcn.conv{i}`, `gcn.gate{i}` (Conv1d
weight (out, in, K) and bias), `gcn.norm{i}.gamma` / `beta`, `rnn_blocks.*`
(nn.LSTM's names) and `fc`; `hub/from_jax.py:furcanet_state_dict_from_jax`
maps JAX weights onto them.

The recurrences run one step a sample: at the recipe's B = 4 x 2 s and
8 kHz a layer is 4 sequences of 16000 steps on each chain, through the
port's LSTM kernels (`ops/lstm_scan.py`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import choose_layer_norm
from ..ops.rnn import choose_rnn
from .base import SeparationModelMixin, register_model
from .modules import Conv1d, Linear, choose_nonlinear

EPS = 1e-12


class GatedConvNet(nn.Module):
    """Stacked gated conv blocks on channels-last (B, T, C) -> (B, T, hidden_channels)."""

    def __init__(self, in_channels: int, hidden_channels: int, num_blocks: int = 10,
                 kernel_size: int = 3, nonlinear: str = "sigmoid", norm: bool = True,
                 causal: bool = False, eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        self.num_blocks, self.kernel_size, self.causal = num_blocks, kernel_size, causal
        self.nonlinear = choose_nonlinear(nonlinear)
        for idx in range(num_blocks):
            c_in = in_channels if idx == 0 else hidden_channels
            for name in ("conv", "gate"):
                self.add_module(f"{name}{idx}", Conv1d(c_in, hidden_channels, kernel_size,
                                                       generator=generator, device=device))
            if norm:
                self.add_module(f"norm{idx}", choose_layer_norm(
                    "cLN" if causal else "gLN", hidden_channels, causal=causal, eps=eps,
                    device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.kernel_size - 1
        pl, pr = (pad, 0) if self.causal else (pad // 2, pad - pad // 2)
        for idx in range(self.num_blocks):
            h = F.pad(x, (0, 0, pl, pr))
            x = getattr(self, f"conv{idx}")(h) * self.nonlinear(getattr(self, f"gate{idx}")(h))
            norm = getattr(self, f"norm{idx}", None)
            if norm is not None:
                x = norm(x)
        return x


@register_model
class FurcaNet(SeparationModelMixin, nn.Module):
    """(B, 1, T) -> (B, n_sources, T) direct-regression separator."""

    def __init__(self, conv_hidden_channels: int = 64, rnn_hidden_channels: int = 64,
                 num_conv_blocks: int = 10, num_rnn_blocks: int = 2, kernel_size: int = 3,
                 nonlinear: str = "sigmoid", norm: bool = True, causal: bool = False,
                 n_sources: int = 2, eps: float = EPS, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = {k: v for k, v in locals().items()
                        if k not in ("self", "generator", "device", "__class__")}
        for k, v in self._config.items():
            setattr(self, k, v)
        self.gcn = GatedConvNet(1, conv_hidden_channels, num_conv_blocks, kernel_size,
                                nonlinear, norm, causal, eps=eps, generator=generator,
                                device=device)
        # Bidirectional whether causal or not, as in the JAX model.
        self.rnn_blocks = choose_rnn("lstm", conv_hidden_channels, rnn_hidden_channels,
                                     num_layers=num_rnn_blocks, bidirectional=True,
                                     generator=generator, device=device)
        self.fc = Linear(2 * rnn_hidden_channels, n_sources, generator=generator,
                         device=device)

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        x = self.rnn_blocks(self.gcn(input.transpose(1, 2)))
        return self.fc(x).transpose(1, 2)
