"""Time-dilated convolutional network (Conv-TasNet separator backbone).

Port of `dnn_based_source_separation_tpu/models/tdcn.py`: R blocks x X
layers of dilated depthwise-separable residual units with dual
residual/skip heads. Channels-last (B, T, C); 1x1 convs are `F.linear`.

Module and parameter names follow the reference torch layout read by
`hub/torch_convert.py:convert_conv_tasnet`:
`net.{r}.net.{x}.{bottleneck_conv1d, nonlinear1d, norm1d, separable_conv1d.*}`.

Not ported yet: the non-separable residual block, the non-dilated
(stride-2) variant, the exact-streaming left context, and rematerialisation
(training only).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.norms import choose_layer_norm
from ..ops.params import uniform_parameter
from .modules import Pointwise, PReLU

EPS = 1e-12


def fold_mode(v) -> str:
    """Normalize a fold_affine flag: False->'none', True->'all', str kept.

    'heads' folds only the pad-free affines (separator gLN into the
    bottleneck, each separable-conv gLN into its output/skip heads); 'all'
    also folds each block gLN into its depthwise conv, with the -beta/gamma
    padding fill.
    """
    if v is True:
        return "all"
    if v is False or v is None:
        return "none"
    if v in ("none", "heads", "all"):
        return v
    raise ValueError(f"Unsupported fold_affine mode: {v!r}")


def _nonlinear(name: Optional[str], device):
    if name == "prelu":
        return PReLU(device=device)
    if name is not None:
        raise ValueError(f"Unsupported nonlinearity: {name}")
    return None


class DepthwiseConv1dShift(nn.Module):
    """Stride-1 dilated depthwise conv as K shifted multiply-adds.

    weight (C, 1, K) and bias (C,) in the torch depthwise Conv1d layout.
    Input is already padded: (..., T, C) -> (..., T - (K-1)*dilation, C).
    """

    def __init__(self, in_channels: int, kernel_size: int = 3, dilation: int = 1, *,
                 generator=None, device=None):
        super().__init__()
        self.kernel_size, self.dilation = kernel_size, dilation
        self.weight = uniform_parameter((in_channels, 1, kernel_size), kernel_size,
                                        generator, device)
        self.bias = uniform_parameter((in_channels,), kernel_size, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        K, d = self.kernel_size, self.dilation
        T_out = x.shape[-2] - (K - 1) * d
        y = self.bias
        for k in range(K):
            y = y + x[..., k * d : k * d + T_out, :] * self.weight[:, 0, k]
        return y


class DepthwiseSeparableConv1d(nn.Module):
    """depthwise (dilated) -> [prelu] -> [norm] -> pointwise output/skip heads."""

    def __init__(self, in_channels: int, out_channels: int, skip_channels: int,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 causal: bool = True, nonlinear: Optional[str] = None, norm: bool = True,
                 dual_head: bool = True, fold_affine=False, eps: float = EPS, *,
                 generator=None, device=None):
        super().__init__()
        if stride != 1:
            raise NotImplementedError("strided depthwise conv (dilated=False) is not ported yet")
        C = in_channels
        self.depthwise_conv1d = DepthwiseConv1dShift(C, kernel_size, dilation,
                                                     generator=generator, device=device)
        self.nonlinear1d = _nonlinear(nonlinear, device)
        self.norm1d = None
        if norm:
            # The pre-heads norm folds in both 'heads' and 'all' modes: pad-free.
            affine = not (fold_mode(fold_affine) != "none" and not causal)
            self.norm1d = choose_layer_norm("cLN" if causal else "gLN", C, causal=causal,
                                            eps=eps, affine=affine, device=device)
        self.output_pointwise_conv1d = None
        if dual_head:
            self.output_pointwise_conv1d = Pointwise(C, out_channels, generator=generator,
                                                     device=device)
        self.skip_pointwise_conv1d = Pointwise(C, skip_channels, generator=generator,
                                               device=device)

    def forward(self, x: torch.Tensor):
        x = self.depthwise_conv1d(x)
        if self.nonlinear1d is not None:
            x = self.nonlinear1d(x)
        if self.norm1d is not None:
            x = self.norm1d(x)
        output = None
        if self.output_pointwise_conv1d is not None:
            output = self.output_pointwise_conv1d(x)
        return output, self.skip_pointwise_conv1d(x)


class ResidualBlock1d(nn.Module):
    """1x1 bottleneck -> [prelu][norm] -> pad -> separable conv -> heads (+ residual)."""

    def __init__(self, num_features: int, hidden_channels: int = 256, skip_channels: int = 256,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 separable: bool = False, causal: bool = True,
                 nonlinear: Optional[str] = None, norm: bool = True, dual_head: bool = True,
                 fold_affine=False, eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        if not separable:
            raise NotImplementedError("the non-separable residual block is not ported yet")
        self.kernel_size, self.stride, self.dilation = kernel_size, stride, dilation
        self.causal = causal
        self.bottleneck_conv1d = Pointwise(num_features, hidden_channels, generator=generator,
                                           device=device)
        self.nonlinear1d = _nonlinear(nonlinear, device)
        # The pre-depthwise norm folds only in 'all' mode: it needs the
        # -beta/gamma padding fill.
        self.fold = fold_mode(fold_affine) == "all" and norm and not causal
        self.norm1d = None
        if norm:
            self.norm1d = choose_layer_norm("cLN" if causal else "gLN", hidden_channels,
                                            causal=causal, eps=eps, affine=not self.fold,
                                            device=device)
        self.separable_conv1d = DepthwiseSeparableConv1d(
            hidden_channels, num_features, skip_channels, kernel_size=kernel_size,
            stride=stride, dilation=dilation, causal=causal, nonlinear=nonlinear, norm=norm,
            dual_head=dual_head, fold_affine=fold_affine, eps=eps, generator=generator,
            device=device)

    def forward(self, x: torch.Tensor):
        T = x.shape[-2]
        residual = x
        h = self.bottleneck_conv1d(x)
        if self.nonlinear1d is not None:
            h = self.nonlinear1d(h)
        padding = (T - 1) * self.stride - T + (self.kernel_size - 1) * self.dilation + 1
        if self.causal:
            pl, pr = padding, 0
        else:
            pl, pr = padding // 2, padding - padding // 2
        if self.fold:
            h = self.norm1d(h, pad=(pl, pr))  # pads with -beta/gamma
        else:
            if self.norm1d is not None:
                h = self.norm1d(h)
            h = nn.functional.pad(h, (0, 0, pl, pr))
        output, skip = self.separable_conv1d(h)
        if output is not None:
            output = output + residual
        return output, skip


class TimeDilatedConvBlock1d(nn.Module):
    """X layers with dilation 2^i and summed skip head."""

    def __init__(self, num_features: int, hidden_channels: int = 256, skip_channels: int = 256,
                 kernel_size: int = 3, num_layers: int = 10, dilated: bool = True,
                 separable: bool = False, causal: bool = True,
                 nonlinear: Optional[str] = None, norm: bool = True, dual_head: bool = True,
                 fold_affine=False, remat: str = "none", eps: float = EPS, *,
                 generator=None, device=None):
        super().__init__()
        if remat != "none":
            raise NotImplementedError(f"remat={remat!r} is training-only and not ported")
        layers = []
        for idx in range(num_layers):
            last = (not dual_head) and idx == num_layers - 1
            layers.append(ResidualBlock1d(
                num_features, hidden_channels, skip_channels, kernel_size=kernel_size,
                stride=1 if dilated else 2, dilation=2**idx if dilated else 1,
                separable=separable, causal=causal, nonlinear=nonlinear, norm=norm,
                dual_head=not last, fold_affine=fold_affine, eps=eps,
                generator=generator, device=device))
        self.net = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor):
        skip_connection = 0.0
        for layer in self.net:
            x_out, skip = layer(x)
            skip_connection = skip_connection + skip
            if x_out is not None:
                x = x_out
        return x, skip_connection


class TimeDilatedConvNet(nn.Module):
    """R blocks of X dilated layers; output is the sum of the skip heads."""

    def __init__(self, num_features: int, hidden_channels: int = 256, skip_channels: int = 256,
                 kernel_size: int = 3, num_blocks: int = 3, num_layers: int = 10,
                 dilated: bool = True, separable: bool = False, causal: bool = True,
                 nonlinear: Optional[str] = None, norm: bool = True, fold_affine=False,
                 remat: str = "none", eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        self.net = nn.ModuleList(
            TimeDilatedConvBlock1d(
                num_features, hidden_channels, skip_channels, kernel_size=kernel_size,
                num_layers=num_layers, dilated=dilated, separable=separable, causal=causal,
                nonlinear=nonlinear, norm=norm, dual_head=idx != num_blocks - 1,
                fold_affine=fold_affine, remat=remat, eps=eps, generator=generator,
                device=device)
            for idx in range(num_blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip_connection = 0.0
        for block in self.net:
            x, skip = block(x)
            skip_connection = skip_connection + skip
        return skip_connection
