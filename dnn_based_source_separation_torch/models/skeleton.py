"""Shared TasNet forward: pad -> encode -> mask -> decode -> unpad.

Port of `dnn_based_source_separation_tpu/models/skeleton.py`. Models
provide `encoder`, `decoder`, `separator`, `kernel_size` and `_stride`.
The complex-latent (Fourier encoder) and pinv-decoder branches are not
ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


class LatentMaskingMixin:
    """Forward pass shared by every time-domain masking TasNet."""

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        """(B, C_in, T) -> (B, n_sources, T) float32 (or (B, n_sources, C_in, T))."""
        output, _, _ = self._separate(input)
        return output

    def extract_latent(self, input: torch.Tensor):
        """(B, C_in, T) -> (output, latent w * mask (B, n_src, T', N))."""
        output, w, mask = self._separate(input)
        return output, w[:, None] * mask

    def _separate(self, input: torch.Tensor):
        B, C_in, T = input.shape
        stride = self._stride
        padding = (stride - (T - self.kernel_size) % stride) % stride
        pl, pr = padding // 2, padding - padding // 2
        x = F.pad(input, (pl, pr)).transpose(1, 2)  # channels-last (B, T, C_in)

        w = self.encoder(x)  # (B, T', N)
        if w.is_complex():
            raise NotImplementedError("complex latents (Fourier encoders) are not ported yet")
        mask = self.separator(w)  # (B, n_src, T', N)
        x_hat = self.decoder(w, mask)  # (B, n_src, T_pad, C) float32
        if x_hat.shape[-1] == 1:
            x_hat = x_hat[..., 0]
        else:
            x_hat = x_hat.movedim(-1, 2)  # (B, n_src, C, T_pad)
        end = x_hat.shape[-1] - pr
        return x_hat[..., pl:end], w, mask
