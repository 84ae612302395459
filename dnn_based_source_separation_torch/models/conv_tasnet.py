"""Conv-TasNet: learned-filterbank masking separator.

Port of `dnn_based_source_separation_tpu/models/conv_tasnet.py`: encoder ->
gLN/cLN + 1x1 bottleneck -> TDCN -> PReLU -> 1x1 mask head ->
sigmoid/softmax -> fused mask x latent decode -> overlap-add. Config
field names are those of the JAX dataclass; parameter names those of the
reference torch model. A causal model streams exactly
(`Separator.stream`, driven by `models/streaming.py`).

Luo & Mesgarani, "Conv-TasNet: Surpassing Ideal Time-Frequency Magnitude
Masking for Speech Separation", arXiv:1809.07454.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.filterbank import choose_filterbank
from ..ops.norms import choose_layer_norm
from .base import SeparationModelMixin, register_model
from .modules import Pointwise, PReLU
from .skeleton import LatentMaskingMixin
from .tdcn import TimeDilatedConvNet, fold_mode

EPS = 1e-12


class Separator(nn.Module):
    """Mask estimator. (B, T', N) -> masks (B, n_src, T', N)."""

    def __init__(self, num_features: int, bottleneck_channels: int = 128,
                 hidden_channels: int = 256, skip_channels: int = 128, kernel_size: int = 3,
                 num_blocks: int = 3, num_layers: int = 8, dilated: bool = True,
                 separable: bool = True, causal: bool = True, nonlinear: str = "prelu",
                 norm: bool = True, mask_nonlinear: str = "sigmoid", n_sources: int = 2,
                 fold_norm_affine=False, remat: str = "none", eps: float = EPS, *,
                 generator=None, device=None):
        super().__init__()
        if mask_nonlinear not in ("sigmoid", "softmax"):
            raise ValueError(f"Unsupported mask nonlinearity: {mask_nonlinear}")
        self.num_features, self.n_sources = num_features, n_sources
        self.mask_nonlinear = mask_nonlinear
        mode = fold_mode(fold_norm_affine)
        # The separator-level norm feeds the bottleneck pad-free, so it folds
        # in both 'heads' and 'all' modes.
        fold = mode != "none" and not causal
        self.norm1d = choose_layer_norm("cLN" if causal else "gLN", num_features,
                                        causal=causal, eps=eps, affine=not fold, device=device)
        self.bottleneck_conv1d = Pointwise(num_features, bottleneck_channels,
                                           generator=generator, device=device)
        self.tdcn = TimeDilatedConvNet(
            bottleneck_channels, hidden_channels, skip_channels, kernel_size=kernel_size,
            num_blocks=num_blocks, num_layers=num_layers, dilated=dilated,
            separable=separable, causal=causal, nonlinear=nonlinear, norm=norm,
            fold_affine=mode if not causal else "none", remat=remat, eps=eps,
            generator=generator, device=device)
        self.prelu = PReLU(device=device)
        self.mask_conv1d = Pointwise(skip_channels, n_sources * num_features,
                                     generator=generator, device=device)

    def _masks(self, x: torch.Tensor) -> torch.Tensor:
        """TDCN skip sum (B, T', Sc) -> masks (B, n_src, T', N)."""
        B, T, _ = x.shape
        x = self.mask_conv1d(self.prelu(x)).view(B, T, self.n_sources, self.num_features)
        if self.mask_nonlinear == "sigmoid":
            x = torch.sigmoid(x)
        else:
            x = torch.softmax(x, dim=2)
        # A strided view (B, n_src, T', N): the decode kernel reads it in place.
        return x.transpose(1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._masks(self.tdcn(self.bottleneck_conv1d(self.norm1d(x))))

    def stream(self, x: torch.Tensor, state: dict):
        """Exact streaming of the causal separator (JAX `models/tdcn.py:185-198`).

        x (B, T', N) holds the next latent frames, any number. `state` (a
        dict, empty at the stream start) carries the top cLN's statistics
        (`norm`) and each residual block's left context and cLN statistics
        (`tdcn`), all f32. Returns (masks (B, n_src, T', N), new state): one
        mask frame per latent frame, with no lag.
        """
        h, norm = self.norm1d.stream(x, state.get("norm"))
        skip, tdcn = self.tdcn.stream(self.bottleneck_conv1d(h), state.get("tdcn"))
        return self._masks(skip), {"norm": norm, "tdcn": tdcn}


@register_model
class ConvTasNet(LatentMaskingMixin, SeparationModelMixin, nn.Module):
    """Full Conv-TasNet: forward takes (B, C_in=1, T), returns (B, n_sources, T)."""

    def __init__(self, n_basis: int, kernel_size: int, stride: Optional[int] = None,
                 enc_basis: Optional[str] = "trainable", dec_basis: Optional[str] = "trainable",
                 enc_nonlinear: Optional[str] = None, window_fn: str = "hann",
                 enc_onesided: bool = True, enc_return_complex: bool = True,
                 sep_hidden_channels: int = 256, sep_bottleneck_channels: int = 128,
                 sep_skip_channels: int = 128, sep_kernel_size: int = 3,
                 sep_num_blocks: int = 3, sep_num_layers: int = 8, dilated: bool = True,
                 separable: bool = True, sep_nonlinear: str = "prelu", sep_norm: bool = True,
                 mask_nonlinear: str = "sigmoid", causal: bool = True, n_sources: int = 2,
                 fold_norm_affine=False, sep_remat: str = "none", eps: float = EPS,
                 in_channels: int = 1, *, generator: torch.Generator | None = None,
                 device=None):
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
        # The separator sees n_basis features whatever the basis: a Fourier
        # encoder's DFT size is chosen so that its latent has n_basis channels.
        self.separator = Separator(
            n_basis, bottleneck_channels=sep_bottleneck_channels,
            hidden_channels=sep_hidden_channels, skip_channels=sep_skip_channels,
            kernel_size=sep_kernel_size, num_blocks=sep_num_blocks,
            num_layers=sep_num_layers, dilated=dilated, separable=separable, causal=causal,
            nonlinear=sep_nonlinear, norm=sep_norm, mask_nonlinear=mask_nonlinear,
            n_sources=n_sources, fold_norm_affine=fold_norm_affine, remat=sep_remat,
            eps=eps, generator=generator, device=device)
