"""DPTNet: the TasNet skeleton with a dual-path transformer separator.

Port of `dnn_based_source_separation_tpu/models/dptnet.py` (:28-217):
encoder -> 1x1 bottleneck -> symmetric pad to the chunk grid -> segment ->
gLN/cLN over each sample's (S·K, C) -> dual-path transformer blocks ->
overlap-add -> crop -> PReLU -> 1x1 map to n_src x N -> GTU -> mask ->
fused mask x latent decode. Config field names and defaults are those of
the JAX dataclass; parameter names those of the reference torch model
(`separator.dptransformer.net.{i}.{intra,inter}_chunk_block.transformer.*`,
`separator.{bottleneck_conv1d,norm2d,prelu,map,gtu.map,gtu.map_gate}`), the
names `hub/torch_convert.py:convert_dptnet` reads.

The blocks are `models/dptransformer.py`'s. As in the JAX package and the
reference, their attention gets no causal mask even in causal DPTNet: the
inter-chunk attention sees every chunk of the sequence, future ones
included, so causal DPTNet is not streamable (`models/streaming.py`
refuses it).

Chen et al., "Dual-Path Transformer Network", arXiv:2007.13975.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.filterbank import choose_filterbank
from ..ops.norms import choose_layer_norm
from ..ops.segment import overlap_add, segment
from .base import SeparationModelMixin, register_model
from .dptransformer import EPS, DualPathTransformer
from .modules import Pointwise, PReLU
from .skeleton import LatentMaskingMixin

_MASKS = {
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=2),  # over sources of (B, T', n_src, N)
}


class GTU(nn.Module):
    """Gated tanh unit over the last axis: tanh(map(x)) * sigmoid(map_gate(x))."""

    def __init__(self, num_features: int, *, generator=None, device=None):
        super().__init__()
        self.map = Pointwise(num_features, num_features, generator=generator, device=device)
        self.map_gate = Pointwise(num_features, num_features, generator=generator,
                                  device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.map(x)) * torch.sigmoid(self.map_gate(x))


class Separator(nn.Module):
    """Mask estimator via dual-path chunking. (B, T', N) -> masks (B, n_src, T', N)."""

    def __init__(self, num_features: int, bottleneck_channels: int = 64,
                 hidden_channels: int = 256, chunk_size: int = 100,
                 hop_size: Optional[int] = None, num_blocks: int = 6, num_heads: int = 4,
                 norm: bool = True, nonlinear: str = "relu", dropout: float = 0.0,
                 mask_nonlinear: str = "relu", causal: bool = False, n_sources: int = 2,
                 eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        if mask_nonlinear not in _MASKS:
            raise ValueError(f"Unsupported mask nonlinearity: {mask_nonlinear}")
        self.num_features, self.n_sources = num_features, n_sources
        self.chunk_size, self.hop_size = chunk_size, hop_size or chunk_size // 2
        self.mask_nonlinear = mask_nonlinear
        self.bottleneck_conv1d = Pointwise(num_features, bottleneck_channels,
                                           generator=generator, device=device)
        self.norm2d = choose_layer_norm("cLN" if causal else "gLN", bottleneck_channels,
                                        causal=causal, eps=eps, device=device)
        self.dptransformer = DualPathTransformer(
            bottleneck_channels, hidden_channels, num_blocks=num_blocks, num_heads=num_heads,
            norm=norm, nonlinear=nonlinear, dropout=dropout, causal=causal, eps=eps,
            generator=generator, device=device)
        self.prelu = PReLU(device=device)
        self.map = Pointwise(bottleneck_channels, n_sources * num_features, generator=generator,
                             device=device)
        self.gtu = GTU(num_features, generator=generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        K, P = self.chunk_size, self.hop_size
        h = self.bottleneck_conv1d(x)
        # The reference's padding: symmetric, to the chunk grid.
        padding = (P - (T - K) % P) % P
        pl, pr = padding // 2, padding - padding // 2
        h = segment(F.pad(h, (0, 0, pl, pr)), K, P)  # (B, S, K, C)
        _, S, _, C = h.shape
        # One norm over each sample's whole (S·K, C) extent (JAX :136-141).
        h = self.norm2d(h.reshape(B, S * K, C)).view(B, S, K, C)
        h = overlap_add(self.dptransformer(h), P)[:, pl:pl + T]  # (B, T', C)
        h = self.map(self.prelu(h)).view(B, T, self.n_sources, self.num_features)
        # A strided view (B, n_src, T', N): the decode kernel reads it in place.
        return _MASKS[self.mask_nonlinear](self.gtu(h)).transpose(1, 2)


@register_model
class DPTNet(LatentMaskingMixin, SeparationModelMixin, nn.Module):
    """Full DPTNet: forward takes (B, C_in=1, T), returns (B, n_sources, T)."""

    def __init__(self, n_basis: int, kernel_size: int, stride: Optional[int] = None,
                 enc_basis: Optional[str] = "trainable", dec_basis: Optional[str] = "trainable",
                 enc_nonlinear: Optional[str] = None, window_fn: str = "hann",
                 enc_onesided: bool = True, enc_return_complex: bool = True,
                 sep_bottleneck_channels: int = 64, sep_hidden_channels: int = 256,
                 sep_chunk_size: int = 100, sep_hop_size: Optional[int] = None,
                 sep_num_blocks: int = 6, sep_num_heads: int = 4, sep_norm: bool = True,
                 sep_nonlinear: str = "relu", sep_dropout: float = 0.0,
                 mask_nonlinear: str = "relu", causal: bool = False, n_sources: int = 2,
                 eps: float = EPS, in_channels: int = 1, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = {k: v for k, v in locals().items()
                        if k not in ("self", "generator", "device", "__class__")}
        stride = stride or kernel_size // 2
        if kernel_size % stride:
            raise ValueError("kernel_size must be divisible by stride")
        self._stride = stride
        for k, v in self._config.items():
            setattr(self, k, v)
        self.encoder, self.decoder = choose_filterbank(
            n_basis, kernel_size=kernel_size, stride=stride, enc_basis=enc_basis,
            dec_basis=dec_basis, enc_nonlinear=enc_nonlinear, window_fn=window_fn,
            enc_onesided=enc_onesided, enc_return_complex=enc_return_complex,
            in_channels=in_channels, generator=generator, device=device)
        self.separator = Separator(
            n_basis, bottleneck_channels=sep_bottleneck_channels,
            hidden_channels=sep_hidden_channels, chunk_size=sep_chunk_size,
            hop_size=sep_hop_size, num_blocks=sep_num_blocks, num_heads=sep_num_heads,
            norm=sep_norm, nonlinear=sep_nonlinear, dropout=sep_dropout,
            mask_nonlinear=mask_nonlinear, causal=causal, n_sources=n_sources, eps=eps,
            generator=generator, device=device)
