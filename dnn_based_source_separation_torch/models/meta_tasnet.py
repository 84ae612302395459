"""Meta-TasNet: a TasNet whose separator weights are generated from instrument embeddings.

Port of `dnn_based_source_separation_tpu/models/meta_tasnet.py` (after the
reference's `src/models/meta_tasnet.py`; Samuel et al., "Meta-learning
Extractors for Music Source Separation", arXiv:2002.07016): a learned
embedding per source goes through a bottleneck MLP that emits each layer's
conv kernels and norm affines, and every source runs the separator with its
own generated weights. One stage of the reference's multi-rate cascade.

JAX maps the per-source convs over the source axis (`jax.vmap`); here all
sources run as one grouped `conv1d` (groups = n_sources, each group one
source's kernel), and the shared depthwise conv over sources folded into
the batch. The decoder is `ops/filterbank.py:ConvDecoder`, the fused mask x
latent kernel.

The JAX package has no converter of the reference layout for Meta-TasNet, so
the parameter names follow the JAX tree (`instrument_embedding`,
`encoder.conv1d`, `in_conv`, `block{b}_{l}.{bottleneck_conv,norm1,depthwise,
norm2,out_conv,skip_conv}`, `mask_conv`, `decoder.conv_transpose1d`; each
generator's `bottleneck`, `linear`, `linear_scale`, `linear_bias` Dense layers
as nn.Linear); `hub/from_jax.py:meta_tasnet_state_dict_from_jax` maps JAX
weights onto them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.filterbank import ConvDecoder, ConvEncoder
from .base import SeparationModelMixin, register_model
from .modules import Conv1d, Linear

EPS = 1e-12


class Conv1dGenerated(nn.Module):
    """Per-source conv with kernels generated from the embeddings: x (B, n_src, T, C_in),
    embedding (n_src, E) -> (B, n_src, T', C_out); no padding."""

    def __init__(self, embed_dim: int, in_channels: int, out_channels: int,
                 kernel_size: int = 1, stride: int = 1, dilation: int = 1,
                 use_bias: bool = False, bottleneck_channels: int = 32, *, generator=None,
                 device=None):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = kernel_size
        self.stride, self.dilation = stride, dilation
        self.bottleneck = Linear(embed_dim, bottleneck_channels, generator=generator,
                                 device=device)
        self.linear = Linear(bottleneck_channels, out_channels * in_channels * kernel_size,
                             generator=generator, device=device)
        self.linear_bias = (Linear(bottleneck_channels, out_channels, generator=generator,
                                   device=device) if use_bias else None)

    def forward(self, x: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
        B, S, T, _ = x.shape
        h = self.bottleneck(embedding)
        # JAX's layout (n_src, K, C_in, C_out) -> grouped conv1d's (n_src * C_out, C_in, K).
        kernel = self.linear(h).view(S, self.kernel_size, self.in_channels, self.out_channels)
        kernel = kernel.permute(0, 3, 2, 1).reshape(S * self.out_channels, self.in_channels,
                                                    self.kernel_size)
        y = F.conv1d(x.permute(0, 1, 3, 2).reshape(B, S * self.in_channels, T), kernel,
                     stride=self.stride, dilation=self.dilation, groups=S)
        y = y.view(B, S, self.out_channels, -1).transpose(2, 3)
        if self.linear_bias is not None:
            y = y + self.linear_bias(h)[None, :, None, :]
        return y


class GroupNormGenerated(nn.Module):
    """Per-source GroupNorm over (T, C / groups) whose affine comes from the embeddings."""

    def __init__(self, embed_dim: int, num_features: int, groups: int = 1,
                 bottleneck_channels: int = 32, eps: float = EPS, *, generator=None,
                 device=None):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.bottleneck = Linear(embed_dim, bottleneck_channels, generator=generator,
                                 device=device)
        self.linear_scale = Linear(bottleneck_channels, num_features, generator=generator,
                                   device=device)
        self.linear_bias = Linear(bottleneck_channels, num_features, generator=generator,
                                  device=device)

    def forward(self, x: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
        h = self.bottleneck(embedding)
        B, S, T, C = x.shape
        xg = x.view(B, S, T, self.groups, C // self.groups)
        mean = xg.mean(dim=(2, 4), keepdim=True)
        var = (xg - mean).square().mean(dim=(2, 4), keepdim=True)
        x = ((xg - mean) / torch.sqrt(var + self.eps)).view(B, S, T, C)
        return self.linear_scale(h)[None, :, None, :] * x + self.linear_bias(h)[None, :, None, :]


class GeneratedResidualBlock(nn.Module):
    """Dilated separable residual unit with generated 1x1 convs and norms; its depthwise
    conv is shared by the sources. -> (x + out, skip)."""

    def __init__(self, embed_dim: int, hidden_channels: int, num_features: int,
                 skip_channels: int, kernel_size: int = 3, dilation: int = 1,
                 bottleneck_channels: int = 32, eps: float = EPS, *, generator=None,
                 device=None):
        super().__init__()
        self.kernel_size, self.dilation = kernel_size, dilation
        kw = dict(bottleneck_channels=bottleneck_channels, generator=generator, device=device)
        self.bottleneck_conv = Conv1dGenerated(embed_dim, num_features, hidden_channels, 1, **kw)
        self.norm1 = GroupNormGenerated(embed_dim, hidden_channels, eps=eps, **kw)
        self.depthwise = Conv1d(hidden_channels, hidden_channels, kernel_size, dilation,
                                groups=hidden_channels, generator=generator, device=device)
        self.norm2 = GroupNormGenerated(embed_dim, hidden_channels, eps=eps, **kw)
        self.out_conv = Conv1dGenerated(embed_dim, hidden_channels, num_features, 1, **kw)
        self.skip_conv = Conv1dGenerated(embed_dim, hidden_channels, skip_channels, 1, **kw)

    def forward(self, x: torch.Tensor, embedding: torch.Tensor):
        h = self.norm1(F.relu(self.bottleneck_conv(x, embedding)), embedding)
        pad = (self.kernel_size - 1) * self.dilation
        B, S, T, C = h.shape
        h = F.pad(h.reshape(B * S, T, C), (0, 0, pad // 2, pad - pad // 2))
        h = self.norm2(F.relu(self.depthwise(h)).view(B, S, T, C), embedding)
        return self.out_conv(h, embedding) + x, self.skip_conv(h, embedding)


@register_model
class MetaTasNet(SeparationModelMixin, nn.Module):
    """Single-stage Meta-TasNet: (B, 1, T) -> (B, n_sources, T)."""

    def __init__(self, n_basis: int = 64, kernel_size: int = 16, stride: Optional[int] = None,
                 embed_dim: int = 32, bottleneck_channels: int = 32,
                 sep_hidden_channels: int = 64, sep_bottleneck_channels: int = 32,
                 sep_skip_channels: int = 32, sep_kernel_size: int = 3, sep_num_blocks: int = 2,
                 sep_num_layers: int = 4, n_sources: int = 4, eps: float = EPS, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = {k: v for k, v in locals().items()
                        if k not in ("self", "generator", "device", "__class__")}
        for k, v in self._config.items():
            setattr(self, k, v)
        self._stride = stride or kernel_size // 2
        E = embed_dim
        kw = dict(bottleneck_channels=bottleneck_channels, generator=generator, device=device)
        # flax's normal(1.0), as JAX initialises it.
        self.instrument_embedding = nn.Parameter(
            torch.empty(n_sources, E).normal_(generator=generator).to(device))
        self.encoder = ConvEncoder(n_basis, kernel_size, self._stride, generator=generator,
                                   device=device)
        self.in_conv = Conv1dGenerated(E, n_basis, sep_bottleneck_channels, 1, **kw)
        self.blocks = [f"block{b}_{l}" for b in range(sep_num_blocks)
                       for l in range(sep_num_layers)]
        for name in self.blocks:
            self.add_module(name, GeneratedResidualBlock(
                E, sep_hidden_channels, sep_bottleneck_channels, sep_skip_channels,
                kernel_size=sep_kernel_size, dilation=2 ** int(name.split("_")[1]), eps=eps,
                **kw))
        self.mask_conv = Conv1dGenerated(E, sep_skip_channels, n_basis, 1, **kw)
        self.decoder = ConvDecoder(n_basis, kernel_size, self._stride, generator=generator,
                                   device=device)

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        stride, T = self._stride, input.shape[-1]
        pad = (stride - (T - self.kernel_size) % stride) % stride
        x = F.pad(input, (pad // 2, pad - pad // 2)).transpose(1, 2)  # (B, T, 1)
        w = F.relu(self.encoder(x))  # (B, T', N), shared by the sources
        embedding = self.instrument_embedding
        h = self.in_conv(w[:, None].expand(-1, self.n_sources, -1, -1), embedding)
        skip_sum = 0.0
        for name in self.blocks:
            h, skip = getattr(self, name)(h, embedding)
            skip_sum = skip_sum + skip
        mask = torch.sigmoid(self.mask_conv(F.relu(skip_sum), embedding))
        y = self.decoder(w, mask)[..., 0]  # (B, n_src, T_pad)
        return y[..., pad // 2:y.shape[-1] - (pad - pad // 2)]
