"""Learned analysis-synthesis filterbanks (TasNet encoder/decoder).

Port of `dnn_based_source_separation_tpu/ops/filterbank.py:27-124`. A
stride-S kernel-L Conv1d over the input channels is "frame into
(B, T', C*L), then matmul C*L -> N"; the decoder is the synthesis matmul
followed by overlap-add. Latents are channels-last (B, T', N).

Parameter names and shapes follow the reference torch layout that
`hub/torch_convert.py:convert_conv_tasnet` reads: `conv1d.weight` (N, C, L)
for the encoder and `conv_transpose1d.weight` (N, C, L) for the decoder.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .mask_decode import fused_mask_decode, fused_mask_decode_reference
from .params import Weight
from .stft import _fold, _frame

EPS = 1e-12


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., T', frame_length), T' = (T - L)//hop + 1."""
    return _frame(x, frame_length, hop)


def unfold_apply(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Inverse of frame_signal by summation: (..., T', L) -> (..., T)."""
    *lead, S, L = frames.shape
    return _fold(frames, hop, (S - 1) * hop + L)


class ConvEncoder(nn.Module):
    """Trainable analysis filterbank. (B, T, C_in) -> latent (B, T', n_basis)."""

    def __init__(self, n_basis: int, kernel_size: int, stride: int, in_channels: int = 1,
                 nonlinear: Optional[str] = None, *, generator=None, device=None):
        super().__init__()
        if nonlinear not in (None, "relu"):
            raise ValueError(f"Unsupported encoder nonlinearity: {nonlinear}")
        self.n_basis, self.kernel_size, self.stride = n_basis, kernel_size, stride
        self.in_channels, self.nonlinear = in_channels, nonlinear
        self.conv1d = Weight((n_basis, in_channels, kernel_size), in_channels * kernel_size,
                             generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        frames = frame_signal(x.transpose(1, 2), self.kernel_size, self.stride)  # (B, C, T', L)
        frames = frames.transpose(1, 2).reshape(B, -1, C * self.kernel_size)
        y = F.linear(frames, self.conv1d.weight.reshape(self.n_basis, -1))
        if self.nonlinear == "relu":
            y = F.relu(y)
        return y


class ConvDecoder(nn.Module):
    """Trainable synthesis filterbank (transposed conv).

    forward(w, mask): latent w (B, T', N) and masks (B, S, T', N) ->
    signals (B, S, T, out_channels) float32. The masking and the synthesis
    matmul run as one fused kernel (ops/mask_decode.py), then overlap-add.
    Under autograd (training) the same function runs as plain differentiable
    ops, `fused_mask_decode_reference`, as the JAX decoder computes it: the
    kernel has no backward.
    """

    def __init__(self, n_basis: int, kernel_size: int, stride: int, out_channels: int = 1,
                 *, generator=None, device=None):
        super().__init__()
        self.n_basis, self.kernel_size, self.stride = n_basis, kernel_size, stride
        self.out_channels = out_channels
        self.conv_transpose1d = Weight((n_basis, out_channels, kernel_size),
                                       out_channels * kernel_size, generator, device)

    def forward(self, w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        kernel = self.conv_transpose1d.weight.reshape(self.n_basis, -1)  # (N, C*L)
        recording = torch.is_grad_enabled() and any(
            t.requires_grad for t in (w, mask, kernel))
        if recording:
            frames = fused_mask_decode_reference(w, mask, kernel)  # (B, S, T', C*L)
        else:  # the kernel reads rows with a contiguous last dimension, any other stride
            w, mask = (t if t.stride(-1) == 1 else t.contiguous() for t in (w, mask))
            frames = fused_mask_decode(w, mask, kernel)
        *lead, S, _ = frames.shape
        frames = frames.reshape(*lead, S, self.out_channels, self.kernel_size)
        frames = frames.movedim(-2, -3)  # (B, S, C, T', L)
        y = unfold_apply(frames, self.stride)  # (B, S, C, T)
        return y.movedim(-2, -1)  # (B, S, T, C)


def choose_filterbank(hidden_channels: int, kernel_size: int, stride: int | None = None,
                      enc_basis: str = "trainable", dec_basis: str = "trainable",
                      *, generator=None, device=None, **kwargs):
    """(encoder, decoder) for the basis names; only 'trainable'/'trainable' is ported."""
    if enc_basis != "trainable" or dec_basis != "trainable":
        raise NotImplementedError(
            f"filterbank {enc_basis!r}/{dec_basis!r} is not ported yet (trainable only)")
    in_channels = kwargs.get("in_channels") or 1
    stride = stride or kernel_size // 2
    encoder = ConvEncoder(hidden_channels, kernel_size, stride, in_channels=in_channels,
                          nonlinear=kwargs.get("enc_nonlinear"), generator=generator,
                          device=device)
    decoder = ConvDecoder(hidden_channels, kernel_size, stride, out_channels=in_channels,
                          generator=generator, device=device)
    return encoder, decoder
