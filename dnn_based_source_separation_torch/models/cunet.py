"""Conditioned U-Net (CUNet): a U-Net whose encoder blocks a control network modulates.

Port of `dnn_based_source_separation_tpu/models/cunet.py` (ControlDenseNet,
ControlConvNet, ConditionedEncoderBlock2d, ConditionedUNet2d), after the reference
`src/models/cunet.py` (Meseguer-Brocal & Peeters, arXiv:1907.01277; the PoCM variants of
LaSAFT). A control network maps a one-hot instrument vector to each encoder layer's
(gamma, beta); an encoder block is pad -> strided conv (no bias) -> BN -> conditioning ->
nonlinearity; the decoders are `models/unet.py:DecoderBlock2d`; the output is cropped (or
padded) to the input's size and, with `masking`, multiplies it. NCHW; FiLM and PoCM act
on dim 1 (`models/film.py`).

Names follow the JAX tree: `control_net.dense{i}`, `control_net.fc_weight{i}` /
`fc_bias{i}` (`nn.Linear` layout), `encoder.{i}.conv2d` / `norm2d`, `bottleneck`,
`decoder.{i}.deconv2d` / `norm2d` (`hub/from_jax.py:cunet_state_dict_from_jax`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.norms import BatchNorm2d
from ..ops.params import Linear, uniform_parameter
from .base import SeparationModelMixin, register_model
from .film import film, gpocm, pocm
from .m_densenet import _pair, config_of, conv2d, crop2d, pad2d
from .modules import choose_nonlinear
from .unet import EPS, DecoderBlock2d, _decoder_channels, _per_layer, encoder_pad

CONDITIONING = {"film": film, "pocm": pocm, "gpocm": gpocm}


class _ControlHeads(nn.Module):
    """The per-layer heads: gamma (c, or c x c for PoCM) and beta (c) of each encoder
    layer's c channels, from the control network's last features."""

    def _heads(self, features: int, out_channels, gamma_shape: str, generator, device):
        self.out_channels, self.gamma_shape = list(out_channels), gamma_shape
        for i, c in enumerate(self.out_channels):
            self.add_module(f"fc_weight{i}", Linear(
                features, c * c if gamma_shape == "matrix" else c, generator=generator,
                device=device))
            self.add_module(f"fc_bias{i}", Linear(features, c, generator=generator,
                                                  device=device))

    def gammas_betas(self, x):
        gammas, betas = [], []
        for i, c in enumerate(self.out_channels):
            g = getattr(self, f"fc_weight{i}")(x)
            gammas.append(g.reshape(-1, c, c) if self.gamma_shape == "matrix" else g)
            betas.append(getattr(self, f"fc_bias{i}")(x))
        return gammas, betas


class ControlDenseNet(_ControlHeads):
    """One-hot latent (B, L) -> stacked dense layers -> per-layer (gammas, betas)."""

    def __init__(self, channels: Sequence[int], out_channels: Sequence[int], nonlinear="relu",
                 gamma_shape: str = "vector", *, generator=None, device=None):
        super().__init__()
        n = len(channels) - 1
        self.n_blocks, self.nonlinear = n, _per_layer(nonlinear, n)
        for i in range(n):
            self.add_module(f"dense{i}", Linear(channels[i], channels[i + 1],
                                                generator=generator, device=device))
        self._heads(channels[-1], out_channels, gamma_shape, generator, device)

    def forward(self, latent):
        x = latent
        for i in range(self.n_blocks):
            x = choose_nonlinear(self.nonlinear[i])(getattr(self, f"dense{i}")(x))
        return self.gammas_betas(x)


class ControlConvNet(_ControlHeads):
    """A conditioning sequence (B, T, C_in) -> strided 1-D convs -> the mean over time ->
    per-layer (gammas, betas) (the reference ControlConvNet; flax's `nn.Conv` pads
    'SAME': `ceil(T / s)` outputs, the pad split with its smaller half first)."""

    def __init__(self, channels: Sequence[int], out_channels: Sequence[int],
                 kernel_size: int = 3, stride: int = 2, nonlinear="relu",
                 gamma_shape: str = "vector", *, generator=None, device=None):
        super().__init__()
        n = len(channels) - 1
        self.n_blocks, self.nonlinear = n, _per_layer(nonlinear, n)
        self.kernel_size, self.stride = kernel_size, stride
        for i in range(n):
            conv = nn.Conv1d(channels[i], channels[i + 1], kernel_size, stride=stride,
                             device="meta")
            fan_in = channels[i] * kernel_size
            conv.weight = uniform_parameter(conv.weight.shape, fan_in, generator, device)
            conv.bias = uniform_parameter((channels[i + 1],), fan_in, generator, device)
            self.add_module(f"conv{i}", conv)
        self._heads(channels[-1], out_channels, gamma_shape, generator, device)

    def forward(self, latent):
        x = latent.transpose(1, 2)  # (B, C, T)
        for i in range(self.n_blocks):
            T = x.shape[2]
            out = -(-T // self.stride)
            pad = max((out - 1) * self.stride + self.kernel_size - T, 0)
            x = nn.functional.pad(x, (pad // 2, pad - pad // 2))
            x = choose_nonlinear(self.nonlinear[i])(getattr(self, f"conv{i}")(x))
        return self.gammas_betas(x.mean(dim=2))


class ConditionedEncoderBlock2d(nn.Module):
    """pad -> conv (no bias) -> BN -> conditioning(gamma, beta) -> nonlinear."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=None,
                 dilation=1, nonlinear: Optional[str] = "leaky-relu", conditioning: str = "film",
                 eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride if stride is not None else kernel_size)
        dh, dw = _pair(dilation)
        self.ek = ((kh - 1) * dh + 1, (kw - 1) * dw + 1)
        self.nonlinear, self.conditioning = nonlinear, conditioning
        self.conv2d = conv2d(in_channels, out_channels, (kh, kw), stride=self.stride,
                             dilation=(dh, dw), bias=False, generator=generator,
                             device=device)
        self.norm2d = BatchNorm2d(out_channels, eps=eps, device=device)

    def forward(self, x, gamma, beta):
        ph = encoder_pad(x.shape[2], self.ek[0], self.stride[0])
        pw = encoder_pad(x.shape[3], self.ek[1], self.stride[1])
        x = self.norm2d(self.conv2d(pad2d(x, ph, pw)))
        x = CONDITIONING[self.conditioning](x, gamma, beta)
        return choose_nonlinear(self.nonlinear)(x)


@register_model
class ConditionedUNet2d(SeparationModelMixin, nn.Module):
    """(input (B, C, H, W), latent (B, latent_dim) one-hot) -> the same shape as the
    input (times the input with `masking`)."""

    def __init__(self, channels: Sequence[int], kernel_size, stride=None,
                 control_channels: Sequence[int] = (4, 16, 64), enc_nonlinear="leaky-relu",
                 dec_nonlinear="leaky-relu", out_channels: Optional[int] = None,
                 conditioning: str = "film", masking: bool = False, eps: float = EPS, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = config_of(locals())
        channels = list(channels)
        n = len(channels) - 1
        enc_nl, dec_nl = _per_layer(enc_nonlinear, n), _per_layer(dec_nonlinear, n)
        dec_channels = _decoder_channels(channels, out_channels)
        self.masking = masking
        common = dict(eps=eps, generator=generator, device=device)
        self.control_net = ControlDenseNet(
            control_channels, channels[1:],
            gamma_shape="matrix" if conditioning in ("pocm", "gpocm") else "vector",
            generator=generator, device=device)
        self.encoder = nn.ModuleList([ConditionedEncoderBlock2d(
            channels[i], channels[i + 1], kernel_size, stride, nonlinear=enc_nl[i],
            conditioning=conditioning, **common) for i in range(n)])
        self.bottleneck = conv2d(channels[-1], channels[-1], 1, generator=generator,
                                 device=device)
        self.decoder = nn.ModuleList([DecoderBlock2d(
            dec_channels[i] + (channels[n - i] if i else 0), dec_channels[i + 1], kernel_size,
            stride, nonlinear=dec_nl[i], **common) for i in range(n)])

    def forward(self, input, latent):
        gammas, betas = self.control_net(latent)
        x, skips = input, []
        for block, gamma, beta in zip(self.encoder, gammas, betas):
            x = block(x, gamma, beta)
            skips.append(x)
        x = self.bottleneck(x)
        for i, block in enumerate(self.decoder):
            x = block(x, None if i == 0 else skips[-1 - i])
        dh, dw = x.shape[2] - input.shape[2], x.shape[3] - input.shape[3]
        x = crop2d(x, x.shape[2] - max(0, dh), x.shape[3] - max(0, dw))
        x = pad2d(x, max(0, -dh), max(0, -dw))
        return x * input if self.masking else x
