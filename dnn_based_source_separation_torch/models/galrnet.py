"""GALR / GALRNet: the globally attentive, locally recurrent dual-path network.

Port of `dnn_based_source_separation_tpu/models/galrnet.py`:
`_galr_positional_encoding` (:32), `GloballyAttentiveBlock` (:40), `GALRBlock`
(:88), `GALR` (:115), `Separator` (:141) and `GALRNet` (:197). The encoder ->
symmetric pad to the chunk grid -> segment -> gLN (cLN when causal) over
each sample's (S·K, N) -> `num_blocks` GALR blocks -> overlap-add -> crop ->
PReLU -> 1x1 map to n_src x N -> GTU -> mask -> the fused mask x latent
decode.

A GALR block is DPRNN's intra-chunk block (`models/dprnn.py:IntraChunkRNN`:
the biLSTM over the B·S chunks, `fc`, a gLN and the residual), then the
globally attentive block: in the low-dimension variant `fc_map` maps the chunk
axis K -> Q first (and `fc_inv` maps it back at the end); a LayerNorm over the
channels (`norm2d_in`, eps 1e-12; torch's two-pass form, `ops/attention.py`);
the positional encoding, which here concatenates [sin | cos] over the S·Q
positions and is reshaped to (S, Q, N) (the transformer's interleaves); the
attention over the B·Q sequences of S chunks, with its residual; a gLN (cLN
when causal) over each sample's (S·Q, N); the block's residual. As in the JAX
package the attention gets no causal mask: causal GALRNet differs only in its
cLNs and is not streamable (`models/streaming.py` refuses it).

Parameter names are the reference torch model's, those
`hub/torch_convert.py:convert_galrnet` reads: `separator.{norm2d,prelu,map,
gtu.map,gtu.map_gate}` and `separator.galr.net.{i}.intra_chunk_block.{rnn,fc,
norm1d}`, `separator.galr.net.{i}.inter_chunk_block.{fc_map,fc_inv,
norm2d_in.norm,multihead_attn,norm2d_out}`. `GALRNet`'s class default is
causal, as the JAX package's.

Lam et al., "Effective low-cost time-domain audio separation using globally
attentive locally recurrent networks", arXiv:2101.05014.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import MultiheadAttention, encoding_on
from ..ops.filterbank import choose_filterbank
from ..ops.norms import choose_layer_norm
from ..ops.segment import overlap_add, segment
from .base import SeparationModelMixin, register_model
from .dprnn import IntraChunkRNN as LocallyRecurrentBlock
from .dptnet import GTU
from .modules import Linear, Pointwise, PReLU
from .skeleton import LatentMaskingMixin

EPS = 1e-12

_MASKS = {
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=2),  # over the sources of (B, T', n_src, N)
}


def _concatenated_encoding(length: int, dimension: int, base: float) -> np.ndarray:
    position = np.arange(length, dtype=np.float32)[:, None]
    index = (np.arange(dimension // 2, dtype=np.float32) / dimension)[None, :]
    indices = position / base ** index
    return np.concatenate([np.sin(indices), np.cos(indices)], axis=1)


def _galr_positional_encoding(length: int, dimension: int, base: float = 10000.0, *,
                              device=None, dtype=torch.float32) -> torch.Tensor:
    """(length, dimension) = [sin | cos] concatenated (reference galr.py:63-78), computed
    on the host in f32 with numpy as the JAX package computes it, kept on `device`."""
    return encoding_on(_concatenated_encoding, int(length), int(dimension), float(base),
                       device=torch.device(device or "cpu"), dtype=dtype)


class _ChannelNorm(nn.Module):
    """The reference's LayerNormAlongChannel: a LayerNorm over the channels named `norm`."""

    def __init__(self, num_features: int, eps: float, device=None):
        super().__init__()
        self.norm = nn.LayerNorm(num_features, eps=eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


class GloballyAttentiveBlock(nn.Module):
    """(B, S, K, N) -> (B, S, K, N): attention across the chunks, optionally over Q < K
    positions a chunk (`down_chunk_size`; None: every K)."""

    def __init__(self, num_features: int, chunk_size: Optional[int] = None,
                 down_chunk_size: Optional[int] = None, num_heads: int = 8,
                 causal: bool = False, norm: bool = True, eps: float = EPS, *, generator=None,
                 device=None):
        super().__init__()
        self.low_dimension = down_chunk_size is not None
        if self.low_dimension:
            if chunk_size is None:
                raise ValueError("the low-dimension block needs chunk_size")
            self.fc_map = Linear(chunk_size, down_chunk_size, generator=generator,
                                 device=device)
            self.fc_inv = Linear(down_chunk_size, chunk_size, generator=generator,
                                 device=device)
        self.norm = norm
        if norm:
            self.norm2d_in = _ChannelNorm(num_features, eps, device)
            self.norm2d_out = choose_layer_norm("cLN" if causal else "gLN", num_features,
                                                causal=causal, eps=eps, device=device)
        self.multihead_attn = MultiheadAttention(num_features, num_heads, generator=generator,
                                                 device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, K, N = x.shape
        h = x
        if self.low_dimension:  # the chunk axis K -> Q
            h = self.fc_map(h.transpose(2, 3)).transpose(2, 3)
        Q = h.shape[2]
        if self.norm:
            h = self.norm2d_in(h)
        h = h + _galr_positional_encoding(S * Q, N, device=x.device,
                                          dtype=h.dtype).view(S, Q, N)
        h = h.transpose(1, 2).reshape(B * Q, S, N)  # sequences of S chunks
        h = (self.multihead_attn(h) + h).view(B, Q, S, N).transpose(1, 2)  # (B, S, Q, N)
        if self.norm:
            h = self.norm2d_out(h.reshape(B, S * Q, N)).view(B, S, Q, N)
        if self.low_dimension:
            h = self.fc_inv(h.transpose(2, 3)).transpose(2, 3)
        return h + x


class GALRBlock(nn.Module):
    """The locally recurrent (intra-chunk biLSTM) block, then the globally attentive one."""

    def __init__(self, num_features: int, hidden_channels: int, num_heads: int = 8,
                 norm: bool = True, low_dimension: bool = True, chunk_size: Optional[int] = None,
                 down_chunk_size: Optional[int] = None, causal: bool = False, eps: float = EPS,
                 *, generator=None, device=None):
        super().__init__()
        self.intra_chunk_block = LocallyRecurrentBlock(
            num_features, hidden_channels, norm=norm, eps=eps, generator=generator,
            device=device)
        self.inter_chunk_block = GloballyAttentiveBlock(
            num_features, chunk_size=chunk_size,
            down_chunk_size=down_chunk_size if low_dimension else None, num_heads=num_heads,
            causal=causal, norm=norm, eps=eps, generator=generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.inter_chunk_block(self.intra_chunk_block(x))


class GALR(nn.Module):
    """(B, S, K, N) -> (B, S, K, N) stack of GALR blocks, `net.{i}`."""

    def __init__(self, num_features: int, hidden_channels: int, num_blocks: int = 6,
                 num_heads: int = 8, norm: bool = True, low_dimension: bool = True,
                 chunk_size: Optional[int] = None, down_chunk_size: Optional[int] = None,
                 causal: bool = False, eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        self.net = nn.ModuleList([
            GALRBlock(num_features, hidden_channels, num_heads=num_heads, norm=norm,
                      low_dimension=low_dimension, chunk_size=chunk_size,
                      down_chunk_size=down_chunk_size, causal=causal, eps=eps,
                      generator=generator, device=device)
            for _ in range(num_blocks)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.net:
            x = block(x)
        return x


class Separator(nn.Module):
    """Mask estimator via dual-path chunking. (B, T', N) -> masks (B, n_src, T', N)."""

    def __init__(self, num_features: int, hidden_channels: int = 128, chunk_size: int = 100,
                 hop_size: int = 50, down_chunk_size: Optional[int] = None, num_blocks: int = 6,
                 num_heads: int = 4, norm: bool = True, mask_nonlinear: str = "relu",
                 low_dimension: bool = True, causal: bool = True, n_sources: int = 2,
                 eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        if mask_nonlinear not in _MASKS:
            raise ValueError(f"Unsupported mask nonlinearity: {mask_nonlinear}")
        self.num_features, self.n_sources = num_features, n_sources
        self.chunk_size, self.hop_size = chunk_size, hop_size
        self.mask_nonlinear = mask_nonlinear
        self.norm2d = choose_layer_norm("cLN" if causal else "gLN", num_features, causal=causal,
                                        eps=eps, device=device)
        self.galr = GALR(num_features, hidden_channels, num_blocks=num_blocks,
                         num_heads=num_heads, norm=norm, low_dimension=low_dimension,
                         chunk_size=chunk_size, down_chunk_size=down_chunk_size, causal=causal,
                         eps=eps, generator=generator, device=device)
        self.prelu = PReLU(device=device)
        self.map = Pointwise(num_features, n_sources * num_features, generator=generator,
                             device=device)
        self.gtu = GTU(num_features, generator=generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, N = x.shape
        K, P = self.chunk_size, self.hop_size
        # The reference's padding: symmetric, to the chunk grid.
        padding = (P - (T - K) % P) % P
        pl, pr = padding // 2, padding - padding // 2
        h = segment(F.pad(x, (0, 0, pl, pr)), K, P)  # (B, S, K, N)
        S = h.shape[1]
        # One norm over each sample's whole (S·K, N) extent (JAX :160-163).
        h = self.norm2d(h.reshape(B, S * K, N)).view(B, S, K, N)
        h = overlap_add(self.galr(h), P)[:, pl:pl + T]  # (B, T', N)
        h = self.map(self.prelu(h)).view(B, T, self.n_sources, self.num_features)
        # A strided view (B, n_src, T', N): the decode kernel reads it in place.
        return _MASKS[self.mask_nonlinear](self.gtu(h)).transpose(1, 2)


@register_model
class GALRNet(LatentMaskingMixin, SeparationModelMixin, nn.Module):
    """Full GALRNet: forward takes (B, C_in=1, T), returns (B, n_sources, T)."""

    def __init__(self, n_basis: int, kernel_size: int, stride: Optional[int] = None,
                 enc_basis: str = "trainable", dec_basis: str = "trainable",
                 enc_nonlinear: Optional[str] = "relu", window_fn: str = "hann",
                 enc_onesided: bool = True, enc_return_complex: bool = True,
                 sep_hidden_channels: int = 128, sep_chunk_size: int = 100,
                 sep_hop_size: int = 50, sep_down_chunk_size: Optional[int] = None,
                 sep_num_blocks: int = 6, sep_num_heads: int = 4, sep_norm: bool = True,
                 mask_nonlinear: str = "relu", low_dimension: bool = True, causal: bool = True,
                 n_sources: int = 2, eps: float = EPS, in_channels: int = 1, *,
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
            n_basis, hidden_channels=sep_hidden_channels, chunk_size=sep_chunk_size,
            hop_size=sep_hop_size, down_chunk_size=sep_down_chunk_size,
            num_blocks=sep_num_blocks, num_heads=sep_num_heads, norm=sep_norm,
            mask_nonlinear=mask_nonlinear, low_dimension=low_dimension, causal=causal,
            n_sources=n_sources, eps=eps, generator=generator, device=device)
