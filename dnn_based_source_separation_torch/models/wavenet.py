"""WaveNet: gated dilated (causal) convolutions with residual and skip heads.

Port of `dnn_based_source_separation_tpu/models/wavenet.py` (after the
reference's `src/models/wavenet.py`; van den Oord et al., arXiv:1609.03499):
a 1x1 input conv, `num_blocks` x `num_layers` gated units (tanh(conv) x
sigmoid(conv), dilation 2^i, causal or centred padding) with 1x1 residual and
skip heads, then relu / 1x1 / relu / 1x1 and an optional output softmax or
sigmoid. Global conditioning adds a dense map of one embedding a sequence to
both gates; local conditioning upsamples (B, T_enc, enc_dim) features by a
transposed conv, as flax's `nn.ConvTranspose` with 'SAME' padding computes it,
and adds their 1x1 maps.

No CLI of the JAX package builds WaveNet. It has no converter of the
reference layout either, so the parameter names follow the JAX tree
(`causal_conv1d`, `block{i}.gated{j}.{tanh,sigmoid}_conv1d`, `block{i}.res{j}`,
`block{i}.skip{j}`, `end0`, `end1`, the conditioning's `embed_*`; Conv1d
weights (out, in, K), no biases); `hub/from_jax.py:wavenet_state_dict_from_jax`
maps JAX weights onto them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.params import uniform_parameter
from .base import SeparationModelMixin, register_model
from .modules import Conv1d, Linear

EPS = 1e-12


class ConvTransposeSame(nn.Module):
    """flax `nn.ConvTranspose(features, (K,), strides=(s,), padding='SAME', use_bias=False)`
    on (B, T, C_in) -> (B, T * s, C_out): the input dilated by s, padded as
    `lax.conv_transpose` pads 'SAME', correlated with the unflipped kernel. `weight` is
    kept as a Conv1d's (out, in, K)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int, *,
                 generator=None, device=None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.weight = uniform_parameter((out_channels, in_channels, kernel_size),
                                        in_channels * kernel_size, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size, self.stride
        B, T, C = x.shape
        dilated = x.new_zeros(B, (T - 1) * s + 1, C)
        dilated[:, ::s] = x
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
        h = F.pad(dilated, (0, 0, pad_a, pad_len - pad_a))
        return F.conv1d(h.transpose(1, 2), self.weight).transpose(1, 2)


class GatedConv1d(nn.Module):
    """(B, T, C) -> (B, T, out_channels): tanh(conv) * sigmoid(conv), with conditioning."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 dilation: int = 1, causal: bool = True, conditioning: Optional[str] = None,
                 enc_dim: Optional[int] = None, enc_kernel_size: Optional[int] = None,
                 enc_stride: Optional[int] = None, *, generator=None, device=None):
        super().__init__()
        self.kernel_size, self.dilation, self.causal = kernel_size, dilation, causal
        self.conditioning = conditioning
        kw = dict(generator=generator, device=device)
        for gate in ("tanh", "sigmoid"):
            self.add_module(f"{gate}_conv1d", Conv1d(in_channels, out_channels, kernel_size,
                                                     dilation, bias=False, **kw))
            if conditioning == "global":
                self.add_module(f"embed_{gate}_linear", Linear(enc_dim, out_channels, **kw))
            elif conditioning == "local":
                self.add_module(f"embed_{gate}_map", ConvTransposeSame(
                    enc_dim, enc_dim, enc_kernel_size, enc_stride, **kw))
                self.add_module(f"embed_{gate}_conv1d", Conv1d(enc_dim, out_channels, 1,
                                                               bias=False, **kw))
            elif conditioning is not None:
                raise ValueError(f"Unsupported conditioning: {conditioning}")

    def forward(self, x: torch.Tensor, enc_h: Optional[torch.Tensor] = None) -> torch.Tensor:
        pad = (self.kernel_size - 1) * self.dilation
        xp = F.pad(x, (0, 0, *((pad, 0) if self.causal else (pad // 2, pad - pad // 2))))
        gates = []
        for gate in ("tanh", "sigmoid"):
            y = getattr(self, f"{gate}_conv1d")(xp)
            if self.conditioning == "global":  # enc_h (B, enc_dim): one embedding a sequence
                y = y + getattr(self, f"embed_{gate}_linear")(enc_h)[:, None]
            elif self.conditioning == "local":  # enc_h (B, T_enc, enc_dim), upsampled
                up = getattr(self, f"embed_{gate}_map")(enc_h)
                y = y + getattr(self, f"embed_{gate}_conv1d")(up)[:, :y.shape[1]]
            gates.append(y)
        return torch.tanh(gates[0]) * torch.sigmoid(gates[1])


class ResidualConvBlock1d(nn.Module):
    """`num_layers` gated units, each with a 1x1 residual and a 1x1 skip head ->
    (x, the skips summed)."""

    def __init__(self, hidden_channels: int, skip_channels: int, kernel_size: int = 3,
                 num_layers: int = 10, dilated: bool = True, causal: bool = True,
                 conditioning: Optional[str] = None, enc_dim: Optional[int] = None,
                 enc_kernel_size: Optional[int] = None, enc_stride: Optional[int] = None, *,
                 generator=None, device=None):
        super().__init__()
        self.num_layers = num_layers
        kw = dict(generator=generator, device=device)
        for idx in range(num_layers):
            self.add_module(f"gated{idx}", GatedConv1d(
                hidden_channels, hidden_channels, kernel_size, 2 ** idx if dilated else 1,
                causal, conditioning, enc_dim, enc_kernel_size, enc_stride, **kw))
            self.add_module(f"res{idx}", Conv1d(hidden_channels, hidden_channels, 1,
                                                bias=False, **kw))
            self.add_module(f"skip{idx}", Conv1d(hidden_channels, skip_channels, 1, bias=False,
                                                 **kw))

    def forward(self, x: torch.Tensor, enc_h: Optional[torch.Tensor] = None):
        skip_total = 0.0
        for idx in range(self.num_layers):
            h = getattr(self, f"gated{idx}")(x, enc_h)
            x = getattr(self, f"res{idx}")(h) + x
            skip_total = skip_total + getattr(self, f"skip{idx}")(h)
        return x, skip_total


@register_model
class WaveNet(SeparationModelMixin, nn.Module):
    """(B, in_channels, T) -> (B, out_channels, T)."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int = 256,
                 skip_channels: int = 256, kernel_size: int = 3, num_blocks: int = 3,
                 num_layers: int = 10, dilated: bool = True, causal: bool = True,
                 output_nonlinear: Optional[str] = None, conditioning: Optional[str] = None,
                 enc_dim: Optional[int] = None, enc_kernel_size: Optional[int] = None,
                 enc_stride: Optional[int] = None, eps: float = EPS, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = {k: v for k, v in locals().items()
                        if k not in ("self", "generator", "device", "__class__")}
        if output_nonlinear not in (None, "softmax", "sigmoid"):
            raise ValueError(f"Unsupported output nonlinearity: {output_nonlinear}")
        self.num_blocks, self.output_nonlinear = num_blocks, output_nonlinear
        kw = dict(generator=generator, device=device)
        self.causal_conv1d = Conv1d(in_channels, hidden_channels, 1, bias=False, **kw)
        for idx in range(num_blocks):
            self.add_module(f"block{idx}", ResidualConvBlock1d(
                hidden_channels, skip_channels, kernel_size, num_layers, dilated, causal,
                conditioning, enc_dim, enc_kernel_size, enc_stride, **kw))
        self.end0 = Conv1d(skip_channels, hidden_channels, 1, bias=False, **kw)
        self.end1 = Conv1d(hidden_channels, out_channels, 1, bias=False, **kw)

    def forward(self, input: torch.Tensor, enc_h: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.causal_conv1d(input.transpose(1, 2))
        skip_total = 0.0
        for idx in range(self.num_blocks):
            x, skip = getattr(self, f"block{idx}")(x, enc_h)
            skip_total = skip_total + skip
        h = self.end1(F.relu(self.end0(F.relu(skip_total))))
        if self.output_nonlinear == "softmax":
            h = torch.softmax(h, dim=-1)
        elif self.output_nonlinear == "sigmoid":
            h = torch.sigmoid(h)
        return h.transpose(1, 2)
