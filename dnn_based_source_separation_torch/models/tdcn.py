"""Time-dilated convolutional network (Conv-TasNet separator backbone).

Port of `dnn_based_source_separation_tpu/models/tdcn.py`: R blocks x X
layers of residual units with dual residual/skip heads, dilated (stride 1)
or, with `dilated=False`, strided (stride 2); depthwise-separable, or with
`separable=False` full dilated output and skip convs. Channels-last
(B, T, C); 1x1 convs are `F.linear`.

Module and parameter names follow the reference torch layout read by
`hub/torch_convert.py:convert_conv_tasnet`:
`net.{r}.net.{x}.{bottleneck_conv1d, nonlinear1d, norm1d, separable_conv1d.*}`
(non-separable: `output_conv1d`, `skip_conv1d`).

A causal stride-1 model also streams (`stream` methods): each residual
block carries its last (kernel_size - 1) * dilation post-norm frames as the
left context of the next call, and its cLNs their running statistics, so
a stream fed call by call gives the offline output (JAX
`models/tdcn.py:185-198`). The zero start state is the offline zero pad.
Carried state is f32 whatever the model dtype.

Not ported: rematerialisation (training only).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
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
    """Dilated depthwise conv: stride 1 as K shifted multiply-adds, else a grouped conv.

    weight (C, 1, K) and bias (C,) in the torch depthwise Conv1d layout.
    Input is already padded: (..., T, C) -> (..., (T - (K-1)*dilation - 1) // stride + 1, C).
    """

    def __init__(self, in_channels: int, kernel_size: int = 3, dilation: int = 1,
                 stride: int = 1, *, generator=None, device=None):
        super().__init__()
        self.kernel_size, self.dilation, self.stride = kernel_size, dilation, stride
        self.weight = uniform_parameter((in_channels, 1, kernel_size), kernel_size,
                                        generator, device)
        self.bias = uniform_parameter((in_channels,), kernel_size, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        K, d = self.kernel_size, self.dilation
        if self.stride != 1:
            return _conv(x, self.weight, self.bias, self.stride, d, groups=x.shape[-1])
        T_out = x.shape[-2] - (K - 1) * d
        y = self.bias
        for k in range(K):
            y = y + x[..., k * d : k * d + T_out, :] * self.weight[:, 0, k]
        return y


def _conv(x: torch.Tensor, weight, bias, stride: int, dilation: int, groups: int = 1):
    """Channels-last (B, T, C_in) valid conv with a torch Conv1d weight (C_out, C_in/groups, K)."""
    y = F.conv1d(x.transpose(1, 2), weight, bias, stride=stride, dilation=dilation,
                 groups=groups)
    return y.transpose(1, 2)


class DilatedConv1d(nn.Module):
    """A full (not depthwise) dilated, strided conv, torch Conv1d parameters:
    weight (out, in, K), bias (out,). Channels-last, input already padded."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1, *, generator=None, device=None):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        fan_in = in_channels * kernel_size
        self.weight = uniform_parameter((out_channels, in_channels, kernel_size), fan_in,
                                        generator, device)
        self.bias = uniform_parameter((out_channels,), fan_in, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv(x, self.weight, self.bias, self.stride, self.dilation)


class DepthwiseSeparableConv1d(nn.Module):
    """depthwise (dilated) -> [prelu] -> [norm] -> pointwise output/skip heads."""

    def __init__(self, in_channels: int, out_channels: int, skip_channels: int,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 causal: bool = True, nonlinear: Optional[str] = None, norm: bool = True,
                 dual_head: bool = True, fold_affine=False, eps: float = EPS, *,
                 generator=None, device=None):
        super().__init__()
        C = in_channels
        self.depthwise_conv1d = DepthwiseConv1dShift(C, kernel_size, dilation, stride,
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

    def forward(self, x: torch.Tensor, norm_stats=None, stream: bool = False):
        """Padded (B, T, C) -> (output or None, skip); with `stream`, also the cLN's
        statistics, continued from `norm_stats` (None: the stream start)."""
        x = self.depthwise_conv1d(x)
        if self.nonlinear1d is not None:
            x = self.nonlinear1d(x)
        if self.norm1d is not None:
            if stream:
                x, norm_stats = self.norm1d.stream(x, norm_stats)
            else:
                x = self.norm1d(x)
        output = None
        if self.output_pointwise_conv1d is not None:
            output = self.output_pointwise_conv1d(x)
        skip = self.skip_pointwise_conv1d(x)
        return (output, skip, norm_stats) if stream else (output, skip)


class ResidualBlock1d(nn.Module):
    """1x1 bottleneck -> [prelu][norm] -> pad -> (separable) conv -> heads (+ residual)."""

    def __init__(self, num_features: int, hidden_channels: int = 256, skip_channels: int = 256,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 separable: bool = False, causal: bool = True,
                 nonlinear: Optional[str] = None, norm: bool = True, dual_head: bool = True,
                 fold_affine=False, eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        self.kernel_size, self.stride, self.dilation = kernel_size, stride, dilation
        self.causal, self.separable = causal, separable
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
        if separable:
            self.separable_conv1d = DepthwiseSeparableConv1d(
                hidden_channels, num_features, skip_channels, kernel_size=kernel_size,
                stride=stride, dilation=dilation, causal=causal, nonlinear=nonlinear,
                norm=norm, dual_head=dual_head, fold_affine=fold_affine, eps=eps,
                generator=generator, device=device)
        else:
            conv = dict(kernel_size=kernel_size, stride=stride, dilation=dilation,
                        generator=generator, device=device)
            self.output_conv1d = (DilatedConv1d(hidden_channels, num_features, **conv)
                                  if dual_head else None)
            self.skip_conv1d = DilatedConv1d(hidden_channels, skip_channels, **conv)

    def _bottleneck(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bottleneck_conv1d(x)
        return h if self.nonlinear1d is None else self.nonlinear1d(h)

    def _heads(self, h: torch.Tensor, residual: torch.Tensor, sep_norm=None,
               stream: bool = False):
        """Padded h -> (output + residual or None, skip, the separable cLN's statistics)."""
        if not self.separable:
            output = None if self.output_conv1d is None else self.output_conv1d(h)
            skip = self.skip_conv1d(h)
        elif stream:
            output, skip, sep_norm = self.separable_conv1d(h, sep_norm, stream=True)
        else:
            output, skip = self.separable_conv1d(h)
        if output is not None:
            output = output + residual
        return output, skip, sep_norm

    def forward(self, x: torch.Tensor):
        T = x.shape[-2]
        h = self._bottleneck(x)
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
            h = F.pad(h, (0, 0, pl, pr))
        return self._heads(h, x)[:2]

    def stream(self, x: torch.Tensor, state: dict | None):
        """Exact streaming of a causal stride-1 block: x (B, T, F) the next frames.

        `state` (None at the stream start) holds `ctx`, the last
        (kernel_size - 1) * dilation post-norm frames (f32), and the two
        cLNs' statistics (`norm`, `sep_norm`). Returns (output or None, skip, state).
        """
        if not self.causal:
            raise ValueError("exact streaming requires a causal model")
        if self.stride != 1:
            raise NotImplementedError("exact streaming requires stride-1 residual blocks")
        state = state or {}
        h = self._bottleneck(x)
        norm = None
        if self.norm1d is not None:
            h, norm = self.norm1d.stream(h, state.get("norm"))
        pl = (self.kernel_size - 1) * self.dilation
        ctx = state.get("ctx")
        if ctx is None:
            ctx = torch.zeros(h.shape[:-2] + (pl, h.shape[-1]), dtype=torch.float32,
                              device=h.device)
        h = torch.cat([ctx.to(h.dtype), h], dim=-2)
        ctx = h[..., h.shape[-2] - pl:, :].float()
        output, skip, sep_norm = self._heads(h, x, state.get("sep_norm"), stream=True)
        return output, skip, {"ctx": ctx, "norm": norm, "sep_norm": sep_norm}


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

    def stream(self, x: torch.Tensor, states: list | None):
        """Exact streaming: `states` one per layer (None at the stream start)."""
        states = states or [None] * len(self.net)
        skip_connection, new_states = 0.0, []
        for layer, state in zip(self.net, states):
            x_out, skip, state = layer.stream(x, state)
            skip_connection = skip_connection + skip
            new_states.append(state)
            if x_out is not None:
                x = x_out
        return x, skip_connection, new_states


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

    def stream(self, x: torch.Tensor, states: list | None):
        """Exact streaming of a causal dilated network: (skip sum, states), one per block."""
        states = states or [None] * len(self.net)
        skip_connection, new_states = 0.0, []
        for block, state in zip(self.net, states):
            x, skip, state = block.stream(x, state)
            skip_connection = skip_connection + skip
            new_states.append(state)
        return skip_connection, new_states
