"""DPRNN-TasNet: the TasNet skeleton with a dual-path recurrent separator.

Port of `dnn_based_source_separation_tpu/models/dprnn_tasnet.py` (offline
path): encoder -> gLN/cLN + 1x1 bottleneck -> symmetric pad to the chunk
grid -> segment -> DPRNN -> overlap-add -> unpad -> PReLU -> 1x1 mask head
-> fused mask x latent decode -> overlap-add. Config field names are those
of the JAX dataclass (defaults included, `causal=True` among them);
parameter names those of the reference torch model.

Luo et al., arXiv:1910.06379.
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
from .dprnn import DPRNN, _refuse_stream_safe
from .modules import Pointwise, PReLU
from .skeleton import LatentMaskingMixin

EPS = 1e-12
_MASKS = {
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=2),  # over sources of (B, T', n_src, N)
    "relu": F.relu,
}


class Separator(nn.Module):
    """Mask estimator via dual-path chunking. (B, T', N) -> masks (B, n_src, T', N)."""

    def __init__(self, num_features: int, bottleneck_channels: int = 64,
                 hidden_channels: int = 128, chunk_size: int = 100, hop_size: int = 50,
                 num_blocks: int = 6, norm: bool = True, mask_nonlinear: str = "sigmoid",
                 causal: bool = True, rnn_type: str = "lstm", stream_safe: bool = False,
                 n_sources: int = 2, eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        if mask_nonlinear not in _MASKS:
            raise ValueError(f"Unsupported mask nonlinearity: {mask_nonlinear}")
        _refuse_stream_safe(stream_safe)
        self.num_features, self.n_sources = num_features, n_sources
        self.chunk_size, self.hop_size = chunk_size, hop_size
        self.mask_nonlinear = mask_nonlinear
        self.norm1d = choose_layer_norm("cLN" if causal else "gLN", num_features,
                                        causal=causal, eps=eps, device=device)
        self.bottleneck_conv1d = Pointwise(num_features, bottleneck_channels,
                                           generator=generator, device=device)
        self.dprnn = DPRNN(bottleneck_channels, hidden_channels, num_blocks=num_blocks,
                           norm=norm, causal=causal, rnn_type=rnn_type, eps=eps,
                           generator=generator, device=device)
        self.prelu = PReLU(device=device)
        self.mask_conv1d = Pointwise(bottleneck_channels, n_sources * num_features,
                                     generator=generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, N = x.shape
        K, P = self.chunk_size, self.hop_size
        h = self.bottleneck_conv1d(self.norm1d(x))
        # The reference's offline padding: symmetric, to the chunk grid.
        padding = (P - (T - K) % P) % P
        pl, pr = padding // 2, padding - padding // 2
        h = F.pad(h, (0, 0, pl, pr))
        h = overlap_add(self.dprnn(segment(h, K, P)), P)  # (B, T + padding, F)
        h = self.prelu(h[:, pl:pl + T])
        h = self.mask_conv1d(h).view(B, T, self.n_sources, self.num_features)
        # A strided view (B, n_src, T', N): the decode kernel reads it in place.
        return _MASKS[self.mask_nonlinear](h).transpose(1, 2)


@register_model
class DPRNNTasNet(LatentMaskingMixin, SeparationModelMixin, nn.Module):
    """Full DPRNN-TasNet: forward takes (B, C_in=1, T), returns (B, n_sources, T)."""

    def __init__(self, n_basis: int, kernel_size: int, stride: Optional[int] = None,
                 enc_basis: Optional[str] = "trainable", dec_basis: Optional[str] = "trainable",
                 enc_nonlinear: Optional[str] = None, window_fn: str = "hann",
                 enc_onesided: bool = True, enc_return_complex: bool = True,
                 sep_bottleneck_channels: int = 64, sep_hidden_channels: int = 128,
                 sep_chunk_size: int = 100, sep_hop_size: int = 50, sep_num_blocks: int = 6,
                 sep_norm: bool = True, mask_nonlinear: str = "sigmoid", causal: bool = True,
                 rnn_type: str = "lstm", stream_safe: bool = False, n_sources: int = 2,
                 eps: float = EPS, in_channels: int = 1, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = {k: v for k, v in locals().items()
                        if k not in ("self", "generator", "device", "__class__")}
        _refuse_stream_safe(stream_safe)
        stride = stride or kernel_size // 2
        if kernel_size % stride:
            raise ValueError("kernel_size must be divisible by stride")
        self._stride = stride
        for k, v in self._config.items():
            setattr(self, k, v)
        self.encoder, self.decoder = choose_filterbank(
            n_basis, kernel_size=kernel_size, stride=stride, enc_basis=enc_basis,
            dec_basis=dec_basis, enc_nonlinear=enc_nonlinear, in_channels=in_channels,
            generator=generator, device=device)
        self.separator = Separator(
            n_basis, bottleneck_channels=sep_bottleneck_channels,
            hidden_channels=sep_hidden_channels, chunk_size=sep_chunk_size,
            hop_size=sep_hop_size, num_blocks=sep_num_blocks, norm=sep_norm,
            mask_nonlinear=mask_nonlinear, causal=causal, rnn_type=rnn_type,
            n_sources=n_sources, eps=eps, generator=generator, device=device)
