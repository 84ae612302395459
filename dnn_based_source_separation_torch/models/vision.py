"""Vision-style models: MLP-Mixer, MetaFormer / PoolFormer, ViT.

Port of `dnn_based_source_separation_tpu/models/vision.py` (reference
`src/models/mlp_mixer.py`, `metaformer.py`, `poolformer.py`, `vit.py` and
`transform.py:SplitToPatch`). Images or spectrograms come in NCHW, (B, C, H, W), where
JAX's come channels-last; tokens are (B, N, D) in both, and a staged PoolFormer's token
grids (B, H', W', D) are channels-last as JAX's.

- A patch embedding flattens each non-overlapping patch in (row, column, channel) order,
  JAX's, and applies one dense layer `proj`; the overlapped one is a strided conv with
  "same" padding (flax's: (p // 2, p - p // 2) of p = max((n' - 1) s + k - n, 0), by hand).
- Layer norms are torch's at flax's eps (1e-6); gelu is the tanh approximation (flax's).
- A MetaFormer block is x + mixer(norm1(x)), then + fc2(gelu(fc1(norm2(x)))); the pooling
  mixers average an edge-padded window and subtract the identity; ViT's mixer is
  `ops/attention.py:MultiheadAttention` (`attn{i}` of block i), its tokens a zero `cls_token`
  and the patches plus `positional_encoding`.
- Dropout (`ops/dropout.py`, flax's rule from an explicit generator) only in train mode.

The models are sized at construction, where JAX reads the input: `in_channels`, and
MLPMixer's `image_size` (its token count). The names follow the JAX tree (`embed.proj`,
`block{i}.{norm1,token_fc1,...}`, `down{s}.conv`, `stage{s}_block{i}`, `norm`, `head`), and
`hub/from_jax.py:tree_state_dict_from_jax` maps one onto the other.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import MultiheadAttention, positional_encoding
from ..ops.dropout import Dropout
from ..ops.params import Linear
from .m_densenet import _pair, conv2d

LN_EPS = 1e-6  # flax nn.LayerNorm's default


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _layer_norm(dim: int, device):
    return nn.LayerNorm(dim, eps=LN_EPS, device=device)


def split_to_patch(x: torch.Tensor, patch_size) -> torch.Tensor:
    """(B, C, H, W) -> (B, n_patches, ph * pw * C), each patch flattened (row, column,
    channel), the patches row-major."""
    ph, pw = _pair(patch_size)
    B, C, H, W = x.shape
    if H % ph or W % pw:
        raise ValueError(f"image {H} x {W} is not a whole number of {ph} x {pw} patches")
    x = x.reshape(B, C, H // ph, ph, W // pw, pw).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(B, (H // ph) * (W // pw), ph * pw * C)


class PatchEmbedding2d(nn.Module):
    """(B, C, H, W) -> (B, n_patches, embed_dim), or the grid (B, H / ph, W / pw, embed_dim)
    without `to_1d`."""

    def __init__(self, in_channels: int, embed_dim: int, patch_size=(4, 4), to_1d: bool = True,
                 *, generator=None, device=None):
        super().__init__()
        self.patch_size, self.to_1d = _pair(patch_size), to_1d
        ph, pw = self.patch_size
        self.proj = Linear(ph * pw * in_channels, embed_dim, generator=generator,
                           device=device)

    def forward(self, x):
        h = self.proj(split_to_patch(x, self.patch_size))
        if self.to_1d:
            return h
        ph, pw = self.patch_size
        return h.reshape(x.shape[0], x.shape[2] // ph, x.shape[3] // pw, -1)


def _same_pad(n: int, k: int, s: int):
    p = max((-(-n // s) - 1) * s + k - n, 0)
    return p // 2, p - p // 2


class OverlappedPatchEmbedding2d(nn.Module):
    """A strided conv with "same" padding: (B, C, H, W) -> (B, H' W', embed_dim), or the grid
    (B, H', W', embed_dim) without `to_1d`; H' = ceil(H / stride)."""

    def __init__(self, in_channels: int, embed_dim: int, patch_size=(7, 7), stride=None,
                 to_1d: bool = True, *, generator=None, device=None):
        super().__init__()
        self.kernel = _pair(patch_size)
        self.stride = _pair(stride if stride is not None else patch_size)
        self.to_1d = to_1d
        self.conv = conv2d(in_channels, embed_dim, self.kernel, stride=self.stride,
                           generator=generator, device=device)

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel, self.stride
        x = F.pad(x, (*_same_pad(x.shape[3], kw, sw), *_same_pad(x.shape[2], kh, sh)))
        x = self.conv(x).permute(0, 2, 3, 1)  # (B, H', W', D)
        return x.flatten(1, 2) if self.to_1d else x


class MixerBlock(nn.Module):
    """Token-mixing then channel-mixing MLP, each residual: (B, N, D) -> (B, N, D)."""

    def __init__(self, num_tokens: int, dim: int, tokens_hidden: int, channels_hidden: int,
                 dropout: float = 0.0, *, generator=None, device=None):
        super().__init__()
        common = dict(generator=generator, device=device)
        self.norm1 = _layer_norm(dim, device)
        self.token_fc1 = Linear(num_tokens, tokens_hidden, **common)
        self.token_fc2 = Linear(tokens_hidden, num_tokens, **common)
        self.norm2 = _layer_norm(dim, device)
        self.ch_fc1 = Linear(dim, channels_hidden, **common)
        self.ch_fc2 = Linear(channels_hidden, dim, **common)
        self.dropout1, self.dropout2 = Dropout(dropout), Dropout(dropout)

    def forward(self, x):
        h = self.norm1(x).transpose(1, 2)
        h = self.token_fc2(_gelu(self.token_fc1(h))).transpose(1, 2)
        x = x + self.dropout1(h)
        h = self.ch_fc2(_gelu(self.ch_fc1(self.norm2(x))))
        return x + self.dropout2(h)


def pool_tokens(x: torch.Tensor, pooling: str = "avg", dim: int = 1) -> torch.Tensor:
    """A sequence's pooling head: the mean, the max or the first (cls) token."""
    if pooling == "avg":
        return x.mean(dim=dim)
    if pooling == "max":
        return x.amax(dim=dim)
    if pooling == "cls":
        return x.select(dim, 0)
    raise ValueError(f"Not support pooling={pooling}")


class MLPMixer(nn.Module):
    """(B, in_channels, H, W), (H, W) = `image_size` -> (B, num_classes)."""

    def __init__(self, in_channels: int, image_size, patch_size=(4, 4), dim: int = 64,
                 depth: int = 4, tokens_hidden: int = 32, channels_hidden: int = 128,
                 num_classes: int = 10, pooling: str = "avg", dropout: float = 0.0,
                 bias_head: bool = True, *, generator=None, device=None):
        super().__init__()
        (H, W), (ph, pw) = _pair(image_size), _pair(patch_size)
        common = dict(generator=generator, device=device)
        self.depth, self.pooling = depth, pooling
        self.embed = PatchEmbedding2d(in_channels, dim, patch_size, **common)
        for idx in range(depth):
            self.add_module(f"block{idx}", MixerBlock(
                (H // ph) * (W // pw), dim, tokens_hidden, channels_hidden, dropout, **common))
        self.norm = _layer_norm(dim, device)
        self.head = Linear(dim, num_classes, bias=bias_head, **common)

    def forward(self, x):
        x = self.embed(x)
        for idx in range(self.depth):
            x = getattr(self, f"block{idx}")(x)
        return self.head(pool_tokens(self.norm(x), self.pooling))


class MetaFormerBlock(nn.Module):
    """x + mixer(norm1(x)), then + fc2(gelu(fc1(norm2(x)))), over the last dim. A mixer that
    is a module is registered as `mixer_name`."""

    def __init__(self, dim: int, token_mixer: Callable, mlp_hidden: int, dropout: float = 0.0,
                 mixer_name: str = "token_mixer", *, generator=None, device=None):
        super().__init__()
        common = dict(generator=generator, device=device)
        self.norm1 = _layer_norm(dim, device)
        self.mixer_name = mixer_name
        if isinstance(token_mixer, nn.Module):
            self.add_module(mixer_name, token_mixer)
        else:
            self.mixer_fn = token_mixer
        self.norm2 = _layer_norm(dim, device)
        self.fc1 = Linear(dim, mlp_hidden, **common)
        self.fc2 = Linear(mlp_hidden, dim, **common)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        mixer = (self._modules[self.mixer_name] if self.mixer_name in self._modules
                 else self.mixer_fn)
        x = x + mixer(self.norm1(x))
        return x + self.fc2(self.dropout(_gelu(self.fc1(self.norm2(x)))))


def _windows_mean(h: torch.Tensor, shapes, pool_size: int, dims) -> torch.Tensor:
    """The mean of the pool_size^len(dims) windows of an edge-padded `h`."""
    views = [h]
    for dim, n in zip(dims, shapes):
        views = [v.narrow(dim, i, n) for v in views for i in range(pool_size)]
    return torch.stack(views, dim=0).mean(dim=0)


def pool1d_mixer(pool_size: int = 3):
    """Token averaging over the sequence (B, N, D), edge-padded, minus the identity."""

    def mixer(x):
        pad = pool_size // 2
        h = F.pad(x.transpose(1, 2), (pad, pad), mode="replicate").transpose(1, 2)
        return _windows_mean(h, (x.shape[1],), pool_size, (1,)) - x

    return mixer


def pool2d_mixer(pool_size: int = 3):
    """Token averaging over a grid (B, H', W', D), edge-padded, minus the identity."""

    def mixer(x):
        pad = pool_size // 2
        h = F.pad(x.permute(0, 3, 1, 2), (pad,) * 4, mode="replicate").permute(0, 2, 3, 1)
        return _windows_mean(h, x.shape[1:3], pool_size, (1, 2)) - x

    return mixer


class MetaFormer(nn.Module):
    """A MetaFormer classifier with a pluggable mixer factory: (B, C, H, W) -> (B,
    num_classes)."""

    def __init__(self, in_channels: int, token_mixer_factory: Callable = pool1d_mixer,
                 patch_size=(4, 4), dim: int = 64, depth: int = 4, mlp_hidden: int = 128,
                 num_classes: int = 10, pooling: str = "avg", dropout: float = 0.0,
                 overlapped_embedding: bool = False, *, generator=None, device=None):
        super().__init__()
        common = dict(generator=generator, device=device)
        self.depth, self.pooling = depth, pooling
        embed = OverlappedPatchEmbedding2d if overlapped_embedding else PatchEmbedding2d
        self.embed = embed(in_channels, dim, patch_size, **common)
        for idx in range(depth):
            self.add_module(f"block{idx}", MetaFormerBlock(dim, token_mixer_factory(),
                                                           mlp_hidden, dropout, **common))
        self.norm = _layer_norm(dim, device)
        self.head = Linear(dim, num_classes, **common)

    def forward(self, x):
        x = self.embed(x)
        for idx in range(self.depth):
            x = getattr(self, f"block{idx}")(x)
        return self.head(pool_tokens(self.norm(x), self.pooling))


class PoolFormer(MetaFormer):
    """MetaFormer with the pooling mixer. With `stage_dims` (and `stage_depths`), the staged
    backbone: stage s > 0 halves the token grid by an overlapped 3x3 stride-2 embedding
    (`down{s}`) and widens it to stage_dims[s]; blocks `stage{s}_block{i}` over the grid,
    their hidden width max(mlp_hidden, 2 stage_dims[s])."""

    def __init__(self, in_channels: int, patch_size=(4, 4), dim: int = 64, depth: int = 4,
                 mlp_hidden: int = 128, pool_size: int = 3, num_classes: int = 10,
                 pooling: str = "avg", dropout: float = 0.0,
                 stage_dims: Optional[Sequence[int]] = None,
                 stage_depths: Optional[Sequence[int]] = None, *, generator=None, device=None):
        if stage_dims is None:
            super().__init__(in_channels, lambda: pool1d_mixer(pool_size), patch_size, dim,
                             depth, mlp_hidden, num_classes, pooling, dropout,
                             generator=generator, device=device)
            self.stages = None
            return
        nn.Module.__init__(self)
        common = dict(generator=generator, device=device)
        self.pooling = pooling
        depths = list(stage_depths or [depth] * len(stage_dims))
        self.stages = list(zip(stage_dims, depths))
        for s, (sdim, sdepth) in enumerate(self.stages):
            if s == 0:
                self.embed = PatchEmbedding2d(in_channels, sdim, patch_size, to_1d=False,
                                              **common)
            else:
                self.add_module(f"down{s}", OverlappedPatchEmbedding2d(
                    stage_dims[s - 1], sdim, (3, 3), stride=(2, 2), to_1d=False, **common))
            for idx in range(sdepth):
                self.add_module(f"stage{s}_block{idx}", MetaFormerBlock(
                    sdim, pool2d_mixer(pool_size), max(mlp_hidden, 2 * sdim), dropout,
                    **common))
        self.norm = _layer_norm(stage_dims[-1], device)
        self.head = Linear(stage_dims[-1], num_classes, **common)

    def forward(self, x):
        if self.stages is None:
            return super().forward(x)
        for s, (_, sdepth) in enumerate(self.stages):
            x = self.embed(x) if s == 0 else getattr(self, f"down{s}")(x.permute(0, 3, 1, 2))
            for idx in range(sdepth):
                x = getattr(self, f"stage{s}_block{idx}")(x)
        return self.head(pool_tokens(self.norm(x.flatten(1, 2)), self.pooling))


class ViT(nn.Module):
    """Vision transformer with a cls token: (B, C, H, W) -> (B, num_classes)."""

    def __init__(self, in_channels: int, patch_size=(4, 4), dim: int = 64, depth: int = 4,
                 num_heads: int = 4, mlp_hidden: int = 128, num_classes: int = 10,
                 pooling: str = "cls", dropout: float = 0.0, *, generator=None, device=None):
        super().__init__()
        common = dict(generator=generator, device=device)
        self.depth, self.pooling = depth, pooling
        self.embed = PatchEmbedding2d(in_channels, dim, patch_size, **common)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        for idx in range(depth):
            self.add_module(f"block{idx}", MetaFormerBlock(
                dim, MultiheadAttention(dim, num_heads, **common), mlp_hidden, dropout,
                mixer_name=f"attn{idx}", **common))
        self.norm = _layer_norm(dim, device)
        self.head = Linear(dim, num_classes, **common)

    def forward(self, x):
        x = self.embed(x)
        B, N, D = x.shape
        x = torch.cat([self.cls_token.expand(B, 1, D), x], dim=1)
        x = x + positional_encoding(N + 1, D, device=x.device, dtype=x.dtype)
        for idx in range(self.depth):
            x = getattr(self, f"block{idx}")(x)
        return self.head(pool_tokens(self.norm(x), self.pooling))
