"""Shared TasNet forward: pad -> encode -> mask -> decode -> unpad.

Port of `dnn_based_source_separation_tpu/models/skeleton.py`. Models
provide `encoder`, `decoder`, `separator`, `kernel_size`, `_stride` and
`dec_basis`. A real latent with the trainable decoder decodes through the
fused mask x latent kernel (`ConvDecoder`); a complex latent (a Fourier
encoder) is masked on its magnitude and keeps its phase; `dec_basis='pinv'`
decodes through the encoder's `pinv_decode`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.filterbank import ConvDecoder


def masked_latent(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """w (B, T', N) real or complex and masks (B, n_src, T', N) -> w_hat (B, n_src, T', N).

    A complex w is masked on |w| and keeps its phase: |w| mask exp(i angle(w)).
    """
    if w.is_complex():
        return w.abs()[:, None] * mask * torch.exp(1j * w.angle()[:, None])
    return w[:, None] * mask


class LatentMaskingMixin:
    """Forward pass shared by every time-domain masking TasNet."""

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        """(B, C_in, T) -> (B, n_sources, T) float32 (or (B, n_sources, C_in, T))."""
        output, _, _ = self._separate(input)
        return output

    def extract_latent(self, input: torch.Tensor):
        """(B, C_in, T) -> (output, latent w_hat (B, n_src, T', N))."""
        output, w, mask = self._separate(input)
        return output, masked_latent(w, mask)

    def decode(self, w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Latent w (B, T', N) and masks (B, n_src, T', N) -> (B, n_src, T_pad, C_out)."""
        if self.dec_basis == "pinv":
            return self.encoder.pinv_decode(masked_latent(w, mask))
        if isinstance(self.decoder, ConvDecoder):
            if w.is_complex():
                raise NotImplementedError(
                    "a complex latent (Fourier encoder) needs a Fourier decoder: the trainable "
                    "decoder would return a complex signal")
            return self.decoder(w, mask)
        return self.decoder(masked_latent(w, mask))

    def _separate(self, input: torch.Tensor):
        B, C_in, T = input.shape
        stride = self._stride
        padding = (stride - (T - self.kernel_size) % stride) % stride
        pl, pr = padding // 2, padding - padding // 2
        x = F.pad(input, (pl, pr)).transpose(1, 2)  # channels-last (B, T, C_in)

        w = self.encoder(x)  # (B, T', N), complex for a Fourier encoder
        mask = self.separator(w.abs().to(x.dtype) if w.is_complex() else w)  # (B, n_src, T', N)
        x_hat = self.decode(w, mask)  # (B, n_src, T_pad, C)
        if x_hat.shape[-1] == 1:
            x_hat = x_hat[..., 0]
        else:
            x_hat = x_hat.movedim(-1, 2)  # (B, n_src, C, T_pad)
        end = x_hat.shape[-1] - pr
        return x_hat[..., pl:end], w, mask
