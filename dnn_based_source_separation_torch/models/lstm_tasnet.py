"""LSTM-TasNet: the original TasNet, a gated encoder and stacked (Bi)LSTMs.

Port of `dnn_based_source_separation_tpu/models/lstm_tasnet.py`: `Separator`
(:24), `LSTMTasNet` (:65) with its alias `TasNet`, and `TasNetBase` (:112).
The encoder (gated or trainable) -> a per-frame affine norm over the N
channels -> `num_blocks` stacked (Bi)LSTMs of `num_layers` layers each, whose
outputs are summed as skips -> `fc` to n_src x N -> softmax (over the
sources) or sigmoid mask -> the fused mask x latent decode.

The separator's norm is the reference's, copied exactly:
gamma (x - mean) / (sqrt(var) + eps) + beta, with var = mean(x^2) - mean^2 in
one pass and eps = 1e-12 outside the root (JAX :42-45). Its statistics are
computed in f32 whatever x's dtype. Parameter names are the reference torch
model's, those `hub/torch_convert.py:convert_lstm_tasnet` reads:
`separator.{gamma,beta}` (N,), `separator.rnn.{i}.*` (nn.LSTM names, one
stack per block), `separator.fc.{weight,bias}` (nn.Linear).

Every part of the causal separator is frame-local but for the unidirectional
LSTMs, which carry (h, c) from call to call, so causal LSTM-TasNet with the
trainable encoder streams exactly (`Separator.stream`,
`models/streaming.py`). The gated encoder L2-normalises over the whole
utterance and is not streamed.

Luo & Mesgarani, "TasNet: time-domain audio separation network for
real-time, single-channel speech separation", arXiv:1711.00541.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.filterbank import FourierDecoder, FourierEncoder, choose_filterbank, compute_valid_basis
from ..ops.params import constant_parameter
from ..ops.rnn import choose_rnn
from .base import SeparationModelMixin, register_model
from .modules import Linear
from .skeleton import LatentMaskingMixin

EPS = 1e-12

_MASKS = {
    "softmax": lambda x: torch.softmax(x, dim=2),  # over the sources of (B, T', n_src, N)
    "sigmoid": torch.sigmoid,
}


class Separator(nn.Module):
    """(B, T', N) -> masks (B, n_src, T', N)."""

    def __init__(self, n_basis: int, num_blocks: int, num_layers: int, hidden_channels: int,
                 causal: bool = False, mask_nonlinear: str = "softmax", rnn_type: str = "lstm",
                 n_sources: int = 2, eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        if mask_nonlinear not in _MASKS:
            raise ValueError(f"Unsupported mask nonlinearity: {mask_nonlinear}")
        self.n_basis, self.n_sources, self.eps = n_basis, n_sources, eps
        self.mask_nonlinear = mask_nonlinear
        self.gamma = constant_parameter((n_basis,), 1.0, device)
        self.beta = constant_parameter((n_basis,), 0.0, device)
        directions = 1 if causal else 2
        self.rnn = nn.ModuleList([
            choose_rnn(rnn_type, n_basis if i == 0 else directions * hidden_channels,
                       hidden_channels, num_layers=num_layers, bidirectional=not causal,
                       generator=generator, device=device)
            for i in range(num_blocks)])
        self.fc = Linear(directions * hidden_channels, n_sources * n_basis, generator=generator,
                         device=device)

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        """gamma (x - mean) / (sqrt(mean(x^2) - mean^2) + eps) + beta over the channels."""
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.square().mean(dim=-1, keepdim=True) - mean.square()
        y = self.gamma.float() * (xf - mean) / (torch.sqrt(var) + self.eps) + self.beta.float()
        return y.to(x.dtype)

    def _mask(self, skip: torch.Tensor) -> torch.Tensor:
        B, T, _ = skip.shape
        h = self.fc(skip).view(B, T, self.n_sources, self.n_basis)
        # A strided view (B, n_src, T', N): the decode kernel reads it in place.
        return _MASKS[self.mask_nonlinear](h).transpose(1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, skip = self._norm(x), 0.0
        for rnn in self.rnn:
            h = rnn(h)
            skip = h + skip
        return self._mask(skip)

    def stream(self, x: torch.Tensor, state: dict):
        """Exact streaming of the causal separator over the next latent frames of a stream.

        `state` maps "rnn{i}" to block i's per-layer LSTM state (missing = stream start);
        everything else is frame-local. Returns (masks, new state).
        """
        h, skip, new = self._norm(x), 0.0, {}
        for i, rnn in enumerate(self.rnn):
            h, new[f"rnn{i}"] = rnn.stream(h, state.get(f"rnn{i}"))
            skip = h + skip
        return self._mask(skip), new


@register_model
class LSTMTasNet(LatentMaskingMixin, SeparationModelMixin, nn.Module):
    """Full LSTM-TasNet: forward takes (B, C_in=1, T), returns (B, n_sources, T)."""

    def __init__(self, n_basis: int, kernel_size: int = 40, stride: Optional[int] = None,
                 enc_basis: str = "trainableGated", dec_basis: str = "trainable",
                 sep_num_blocks: int = 2, sep_num_layers: int = 2,
                 sep_hidden_channels: int = 500, mask_nonlinear: str = "softmax",
                 causal: bool = False, rnn_type: str = "lstm", n_sources: int = 2,
                 eps: float = EPS, in_channels: int = 1, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = {k: v for k, v in locals().items()
                        if k not in ("self", "generator", "device", "__class__")}
        stride = stride or kernel_size // 2
        if kernel_size % stride:
            raise ValueError("kernel_size must be divisible by stride")
        if enc_basis not in ("trainable", "trainableGated") or dec_basis != "trainable":
            raise ValueError("LSTM-TasNet takes enc_basis 'trainable' or 'trainableGated' and "
                             "dec_basis 'trainable'")
        self._stride = stride
        for k, v in self._config.items():
            setattr(self, k, v)
        self.encoder, self.decoder = choose_filterbank(
            n_basis, kernel_size=kernel_size, stride=stride, enc_basis=enc_basis,
            dec_basis=dec_basis, enc_nonlinear=None, in_channels=in_channels,
            generator=generator, device=device)
        self.separator = Separator(
            n_basis, num_blocks=sep_num_blocks, num_layers=sep_num_layers,
            hidden_channels=sep_hidden_channels, causal=causal, mask_nonlinear=mask_nonlinear,
            rnn_type=rnn_type, n_sources=n_sources, eps=eps, generator=generator,
            device=device)


# The reference's alias (src/models/lstm_tasnet.py).
TasNet = LSTMTasNet


class TasNetBase(SeparationModelMixin, nn.Module):
    """Fourier analysis/synthesis autoencoder: (B, 1, T) -> (B, 1, T).

    Pads to the stride grid, encodes with the (optionally trainable) Fourier
    filterbank and resynthesises: the filterbank harness of the reference's
    `_test_fourier`.
    """

    def __init__(self, hidden_channels: int, kernel_size: int, stride: Optional[int] = None,
                 window_fn: str = "hann", enc_trainable: bool = False,
                 dec_trainable: bool = False, onesided: bool = True,
                 return_complex: bool = True, *, device=None):
        super().__init__()
        self._config = {k: v for k, v in locals().items()
                        if k not in ("self", "device", "__class__")}
        stride = stride or kernel_size // 2
        if kernel_size % stride:
            raise ValueError("kernel_size must be divisible by stride")
        self.kernel_size, self._stride = kernel_size, stride
        n_basis = compute_valid_basis(hidden_channels, onesided, return_complex)
        self.encoder = FourierEncoder(n_basis, kernel_size, stride, window_fn=window_fn,
                                      trainable=enc_trainable, onesided=onesided,
                                      return_complex=return_complex, device=device)
        self.decoder = FourierDecoder(n_basis, kernel_size, stride, window_fn=window_fn,
                                      trainable=dec_trainable, onesided=onesided, device=device)

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return self.extract_latent(input)[0]

    def extract_latent(self, input: torch.Tensor):
        """(B, 1, T) -> (output (B, 1, T), latent (B, T', F))."""
        T = input.shape[-1]
        stride = self._stride
        padding = (stride - (T - self.kernel_size) % stride) % stride
        pl, pr = padding // 2, padding - padding // 2
        x = F.pad(input, (pl, pr)).transpose(1, 2)
        latent = self.encoder(x)
        y = self.decoder(latent).transpose(1, 2)  # (B, 1, T_pad)
        return y[..., pl:y.shape[-1] - pr], latent
