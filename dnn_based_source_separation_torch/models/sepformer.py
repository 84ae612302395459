"""SepFormer: the TasNet skeleton with a dual-path transformer separator.

Port of `dnn_based_source_separation_tpu/models/sepformer.py`: `_PathTransformer`
(:29), `SepFormerBlock` (:63), `Separator` (:101) and `SepFormer` (:174). The
encoder -> gLN (cLN when causal) over the N channels -> 1x1 bottleneck ->
symmetric pad to the chunk grid -> segment -> `num_blocks` x (an intra-chunk
transformer stack over the B·S chunks, an inter-chunk one over the B·K chunk
positions, each with its residual) -> overlap-add -> crop -> PReLU -> 1x1
map to n_src x N -> GTU -> 1x1 `bottleneck_conv1d_out` -> mask -> the fused
mask x latent decode.

Each path's stack adds the interleaved sinusoidal encoding to twice its
input, 2x + pe: the reference adds `x + PE(x)` where its PE already returns
x + pe, and the JAX package keeps that for checkpoint parity; then
post-norm `TransformerEncoderLayer`s (`ops/attention.py`) and, with `norm`, a
gLN over each (L, E) sequence. As in the JAX package, the attention gets no
causal mask: causal SepFormer differs from the non-causal one only in its
first norm (a cLN), and every emitted frame depends on the whole input, so it
is not streamable (`models/streaming.py` refuses it).

Parameter names are the reference torch model's, those
`hub/torch_convert.py:convert_sepformer` reads: `separator.{norm1d,
bottleneck_conv1d_in,prelu,map,gtu.map,gtu.map_gate,bottleneck_conv1d_out}` and
`separator.dptransformer.net.{b}.{intra,inter}_transformer.transformer.{layers.{l}.*,
norm.norm1d}`.

Subakan et al., "Attention is All You Need in Speech Separation", arXiv:2010.13154.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import TransformerEncoderLayer, positional_encoding
from ..ops.filterbank import choose_filterbank
from ..ops.norms import choose_layer_norm
from ..ops.segment import overlap_add, segment
from .base import SeparationModelMixin, register_model
from .dptnet import GTU
from .modules import Pointwise, PReLU
from .skeleton import LatentMaskingMixin

EPS = 1e-12

_MASKS = {
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=2),  # over the sources of (B, T', n_src, N)
}


class _NormWrapper(nn.Module):
    """The reference's LayerNormWrapper: a gLN named `norm1d`."""

    def __init__(self, num_features: int, eps: float, device=None):
        super().__init__()
        self.norm1d = choose_layer_norm("gLN", num_features, eps=eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm1d(x)


class _TransformerStack(nn.Module):
    """`layers` of post-norm transformer encoder layers, then the optional gLN `norm`."""

    def __init__(self, num_features: int, num_layers: int, num_heads: int, d_ff: int,
                 norm: bool, nonlinear: str, dropout: float, eps: float, *, generator=None,
                 device=None):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(num_features, num_heads, d_ff=d_ff, nonlinear=nonlinear,
                                    dropout=dropout, generator=generator, device=device)
            for _ in range(num_layers)])
        self.norm = _NormWrapper(num_features, eps, device) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x if self.norm is None else self.norm(x)


class _PathTransformer(nn.Module):
    """(B', L, E) -> (B', L, E): 2x + the positional encoding, then the stack."""

    def __init__(self, num_features: int, num_layers: int = 8, num_heads: int = 8,
                 d_ff: int = 1024, norm: bool = True, nonlinear: str = "relu",
                 dropout: float = 0.0, eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        self.transformer = _TransformerStack(num_features, num_layers, num_heads, d_ff, norm,
                                             nonlinear, dropout, eps, generator=generator,
                                             device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, L, E = x.shape
        pe = positional_encoding(L, E, device=x.device, dtype=x.dtype)
        return self.transformer(2.0 * x + pe)


class SepFormerBlock(nn.Module):
    """(B, S, K, N) -> (B, S, K, N): the intra-chunk stack over the B·S chunks, then the
    inter-chunk stack over the B·K chunk positions, each with its residual."""

    def __init__(self, num_features: int, num_layers_intra: int = 8, num_layers_inter: int = 8,
                 num_heads_intra: int = 8, num_heads_inter: int = 8, d_ff_intra: int = 1024,
                 d_ff_inter: int = 1024, norm: bool = True, nonlinear: str = "relu",
                 dropout: float = 0.0, causal: bool = False, eps: float = EPS, *,
                 generator=None, device=None):
        super().__init__()
        common = dict(norm=norm, nonlinear=nonlinear, dropout=dropout, eps=eps,
                      generator=generator, device=device)
        self.intra_transformer = _PathTransformer(num_features, num_layers_intra,
                                                  num_heads_intra, d_ff_intra, **common)
        self.inter_transformer = _PathTransformer(num_features, num_layers_inter,
                                                  num_heads_inter, d_ff_inter, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, K, N = x.shape
        x = self.intra_transformer(x.reshape(B * S, K, N)).view(B, S, K, N) + x
        h = self.inter_transformer(x.transpose(1, 2).reshape(B * K, S, N))
        return h.view(B, K, S, N).transpose(1, 2) + x


class _DualPathStack(nn.Module):
    """The blocks, as the reference's `dptransformer.net`."""

    def __init__(self, blocks):
        super().__init__()
        self.net = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.net:
            x = block(x)
        return x


class Separator(nn.Module):
    """Mask estimator via dual-path chunking. (B, T', N) -> masks (B, n_src, T', N)."""

    def __init__(self, num_features: int, bottleneck_channels: int = 256, chunk_size: int = 250,
                 hop_size: int = 125, num_blocks: int = 2, num_layers_intra: int = 8,
                 num_layers_inter: int = 8, num_heads_intra: int = 8, num_heads_inter: int = 8,
                 d_ff_intra: int = 1024, d_ff_inter: int = 1024, norm: bool = True,
                 nonlinear: str = "relu", dropout: float = 0.0, mask_nonlinear: str = "relu",
                 causal: bool = False, n_sources: int = 2, eps: float = EPS, *,
                 generator=None, device=None):
        super().__init__()
        if mask_nonlinear not in _MASKS:
            raise ValueError(f"Unsupported mask nonlinearity: {mask_nonlinear}")
        self.num_features, self.n_sources = num_features, n_sources
        self.chunk_size, self.hop_size = chunk_size, hop_size
        self.mask_nonlinear = mask_nonlinear
        self.norm1d = choose_layer_norm("cLN" if causal else "gLN", num_features, causal=causal,
                                        eps=eps, device=device)
        self.bottleneck_conv1d_in = Pointwise(num_features, bottleneck_channels,
                                              generator=generator, device=device)
        self.dptransformer = _DualPathStack([
            SepFormerBlock(bottleneck_channels, num_layers_intra=num_layers_intra,
                           num_layers_inter=num_layers_inter, num_heads_intra=num_heads_intra,
                           num_heads_inter=num_heads_inter, d_ff_intra=d_ff_intra,
                           d_ff_inter=d_ff_inter, norm=norm, nonlinear=nonlinear,
                           dropout=dropout, causal=causal, eps=eps, generator=generator,
                           device=device)
            for _ in range(num_blocks)])
        self.prelu = PReLU(device=device)
        self.map = Pointwise(bottleneck_channels, n_sources * num_features, generator=generator,
                             device=device)
        self.gtu = GTU(num_features, generator=generator, device=device)
        self.bottleneck_conv1d_out = Pointwise(num_features, num_features, generator=generator,
                                               device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        K, P = self.chunk_size, self.hop_size
        h = self.bottleneck_conv1d_in(self.norm1d(x))
        # The reference's padding: symmetric, to the chunk grid.
        padding = (P - (T - K) % P) % P
        pl, pr = padding // 2, padding - padding // 2
        h = segment(F.pad(h, (0, 0, pl, pr)), K, P)  # (B, S, K, C)
        h = overlap_add(self.dptransformer(h), P)[:, pl:pl + T]  # (B, T', C)
        h = self.map(self.prelu(h)).view(B, T, self.n_sources, self.num_features)
        h = self.bottleneck_conv1d_out(self.gtu(h))
        # A strided view (B, n_src, T', N): the decode kernel reads it in place.
        return _MASKS[self.mask_nonlinear](h).transpose(1, 2)


@register_model
class SepFormer(LatentMaskingMixin, SeparationModelMixin, nn.Module):
    """Full SepFormer: forward takes (B, C_in=1, T), returns (B, n_sources, T)."""

    def __init__(self, n_basis: int, kernel_size: int, stride: Optional[int] = None,
                 enc_basis: str = "trainable", dec_basis: str = "trainable",
                 enc_nonlinear: Optional[str] = "relu", window_fn: str = "hann",
                 enc_onesided: bool = True, enc_return_complex: bool = True,
                 sep_bottleneck_channels: int = 256, sep_chunk_size: int = 250,
                 sep_hop_size: int = 125, sep_num_blocks: int = 2,
                 sep_num_layers_intra: int = 8, sep_num_layers_inter: int = 8,
                 sep_num_heads_intra: int = 8, sep_num_heads_inter: int = 8,
                 sep_d_ff_intra: int = 1024, sep_d_ff_inter: int = 1024, sep_norm: bool = True,
                 sep_nonlinear: str = "relu", sep_dropout: float = 0.0,
                 mask_nonlinear: str = "relu", causal: bool = False, n_sources: int = 2,
                 eps: float = EPS, in_channels: int = 1, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = {k: v for k, v in locals().items()
                        if k not in ("self", "generator", "device", "__class__")}
        stride = stride or kernel_size // 2
        self._stride = stride
        for k, v in self._config.items():
            setattr(self, k, v)
        self.encoder, self.decoder = choose_filterbank(
            n_basis, kernel_size=kernel_size, stride=stride, enc_basis=enc_basis,
            dec_basis=dec_basis, enc_nonlinear=enc_nonlinear, window_fn=window_fn,
            enc_onesided=enc_onesided, enc_return_complex=enc_return_complex,
            in_channels=in_channels, generator=generator, device=device)
        self.separator = Separator(
            n_basis, bottleneck_channels=sep_bottleneck_channels, chunk_size=sep_chunk_size,
            hop_size=sep_hop_size, num_blocks=sep_num_blocks,
            num_layers_intra=sep_num_layers_intra, num_layers_inter=sep_num_layers_inter,
            num_heads_intra=sep_num_heads_intra, num_heads_inter=sep_num_heads_inter,
            d_ff_intra=sep_d_ff_intra, d_ff_inter=sep_d_ff_inter, norm=sep_norm,
            nonlinear=sep_nonlinear, dropout=sep_dropout, mask_nonlinear=mask_nonlinear,
            causal=causal, n_sources=n_sources, eps=eps, generator=generator, device=device)
