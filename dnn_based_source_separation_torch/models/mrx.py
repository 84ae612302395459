"""MRX (Cocktail-fork): a multi-resolution cross-network with its STFT inside the model.

Port of `dnn_based_source_separation_tpu/models/mrx.py` (after the reference's
`src/models/mrx.py`; Petermann et al., arXiv:2110.09958). One encoder a STFT
resolution, all at one hop so their frames align; X-UMX-style bridging means
across the resolutions; a mask decoder per source and resolution, whose
iSTFTs sum in the time domain.

The in-model STFT is the reference's, not the usual one: the wave is
zero-padded by (n_fft / 2, n_fft / 2 + hop) and framed with `center=False`,
which gives one more trailing frame than a centred STFT; the window is
rectangular where hop == n_fft (a Hann window would zero the frame edges and
the iSTFT's window sum would divide by about 0). The iSTFT is the centred
one, sliced to the input's length. As in the reference (and JAX), the
encoders' input affine is not applied: the encoders read |STFT| directly.

Parameter and buffer names are those `hub/torch_convert.py:convert_mrx`
reads: `encoder_blocks.{i}.block.*` (TransformBlock1d), `encoder_blocks.{i}.rnn.*`,
`decoder_blocks.{source}.{i}.{net.0,net.1,scale_out,bias_out}`. Train mode
runs BatchNorm on the batch's statistics, as `models/umx.py` does.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.rnn import choose_rnn
from ..ops.stft import istft, stft
from ..ops.windows import build_window
from .base import SeparationModelMixin, register_model
from .umx import TransformBlock1d

EPS = 1e-12
__sources__ = ["music", "speech", "sfx"]


class EncoderBlock(nn.Module):
    """One resolution's input block (C * n_bins -> H, tanh) and its recurrence."""

    def __init__(self, in_features: int, hidden_channels: int, num_layers: int, causal: bool,
                 rnn_type: str, *, generator=None, device=None):
        super().__init__()
        H = hidden_channels
        self.block = TransformBlock1d(in_features, H, nonlinear="tanh", generator=generator,
                                      device=device)
        self.rnn = choose_rnn(rnn_type, H, H if causal else H // 2, num_layers=num_layers,
                              bidirectional=not causal, generator=generator, device=device)


class DecoderBlock(nn.Module):
    """One source's mask at one resolution: 2H -> H (relu) -> C * n_bins, then the output
    affine and a relu."""

    def __init__(self, hidden_channels: int, out_features: int, n_bins: int, *,
                 generator=None, device=None):
        super().__init__()
        H = hidden_channels
        self.net = nn.ModuleList([
            TransformBlock1d(2 * H, H, nonlinear="relu", generator=generator, device=device),
            TransformBlock1d(H, out_features, generator=generator, device=device)])
        self.scale_out = nn.Parameter(torch.ones(n_bins, device=device))
        self.bias_out = nn.Parameter(torch.zeros(n_bins, device=device))

    def forward(self, h: torch.Tensor, channels: int) -> torch.Tensor:
        """(B, S, 2H) -> the mask (B, C, n_bins, S)."""
        B, S, _ = h.shape
        x = self.net[1](self.net[0](h)).reshape(B, S, channels, -1).permute(0, 2, 3, 1)
        return F.relu(self.scale_out[:, None] * x + self.bias_out[:, None])


@register_model
class MultiResolutionCrossNet(SeparationModelMixin, nn.Module):
    """(B, in_channels, T) waveform -> (B, n_sources, in_channels, T)."""

    def __init__(self, in_channels: int, hidden_channels: int = 512, num_layers: int = 3,
                 n_fft: Sequence[int] = (512, 1024, 2048), hop_length: int = 256,
                 window_fn: str = "hann", causal: bool = False, rnn_type: str = "lstm",
                 sources: Tuple[str, ...] = tuple(__sources__), eps: float = EPS, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = {k: v for k, v in locals().items()
                        if k not in ("self", "generator", "device", "__class__")}
        self._config.update(n_fft=tuple(n_fft), sources=tuple(sources))
        for k, v in self._config.items():
            setattr(self, k, v)
        C, H = in_channels, hidden_channels
        self.encoder_blocks = nn.ModuleList([
            EncoderBlock(C * (nf // 2 + 1), H, num_layers, causal, rnn_type,
                         generator=generator, device=device) for nf in self.n_fft])
        self.decoder_blocks = nn.ModuleDict({
            source: nn.ModuleList([
                DecoderBlock(H, C * (nf // 2 + 1), nf // 2 + 1, generator=generator,
                             device=device) for nf in self.n_fft])
            for source in self.sources})
        for i, nf in enumerate(self.n_fft):  # outside the state dict, as JAX computes them
            window = (torch.ones(nf, device=device) if hop_length == nf
                      else build_window(nf, window_fn, device=device))
            self.register_buffer(f"window{i}", window, persistent=False)

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        B, C, T = input.shape
        hop = self.hop_length
        latents, feats = [], []
        for i, (nf, enc) in enumerate(zip(self.n_fft, self.encoder_blocks)):
            xp = F.pad(input, (nf // 2, nf // 2 + hop))
            spec = stft(xp, nf, hop, window=getattr(self, f"window{i}"), center=False)
            latents.append(spec)  # (B, C, F, S)
            amp = spec.abs().to(input.dtype)
            S = amp.shape[-1]
            feats.append(enc.block(amp.permute(0, 3, 1, 2).reshape(B, S, -1)))
        x_mean = torch.stack(feats).mean(dim=0)  # (B, S, H)
        head = torch.stack([torch.cat([f, enc.rnn(x_mean)], dim=-1)
                            for f, enc in zip(feats, self.encoder_blocks)]).mean(dim=0)
        outputs = []
        for source in self.sources:
            y = 0.0
            for i, (nf, dec) in enumerate(zip(self.n_fft, self.decoder_blocks[source])):
                y = y + istft(dec(head, C) * latents[i], nf, hop,
                              window=getattr(self, f"window{i}"), length=T)
            outputs.append(y)
        return torch.stack(outputs, dim=1)
