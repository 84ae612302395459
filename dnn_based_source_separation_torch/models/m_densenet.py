"""Multi-scale DenseNet (MDenseNet): the dense blocks and the single-band model.

Port of `dnn_based_source_separation_tpu/models/m_densenet.py` (ConvBlock2d,
DenseBlock, DownSampleDenseBlock, UpSampleDenseBlock, MDenseNetBackbone, GLU2d,
MDenseNet). Takahashi & Mitsufuji, "Multi-scale Multi-band DenseNets for Audio Source
Separation". NCHW throughout: (B, C, n_bins, n_frames), so JAX's channel slices
`x[..., :c]` are `x[:, :c]` here and its spatial pads and crops act on dims 2 and 3 with
the same offsets (`p // 2` before, the rest after).

- A conv pads by hand (`F.pad`, then a conv with no padding of its own): flax pads
  `(p // 2, p - p // 2)`, uneven for an even kernel (`kernel_size: [4, 3]`), which
  `nn.Conv2d` cannot.
- flax's `nn.ConvTranspose` does not flip its kernel; torch's does. The port keeps
  torch's layout and semantics (`hub/torch_convert.py:conv_transpose2d_weight` flips
  the spatial dims between the two), so the reference's checkpoints load as they are.
- BatchNorm is `ops/norms.py:BatchNorm2d` (flax's train mode, momentum 0.9, biased
  variance; eps 1e-5 as JAX's blocks set it).

Parameter names are the reference torch model's, those `hub/torch_convert.py:
convert_mm_densenet` reads: `net.{i}.norm2d` / `net.{i}.conv2d` of a dense block,
`conv2d`, `encoder.net.{i}.dense_block`, `bottleneck_conv2d`,
`decoder.net.{j}.{norm2d,upsample2d,dense_block}`, `pointwise_conv2d.{0,1}` of a
backbone, `glu2d.map` / `glu2d.map_gate` of the head.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import BatchNorm2d
from ..ops.params import uniform_parameter
from .base import SeparationModelMixin, register_model
from .modules import choose_nonlinear

EPS = 1e-12


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _expand(v, depth, kinds):
    """A per-stage setting: a list of `depth`, or one value repeated."""
    if isinstance(v, (list, tuple)):
        assert len(v) == depth, f"length mismatch: {v} vs depth {depth}"
        return list(v)
    assert isinstance(v, kinds) or v is None
    return [v] * depth


def conv2d(in_channels, out_channels, kernel_size, *, stride=1, dilation=1, bias=True,
           transpose=False, generator=None, device=None):
    """`nn.Conv2d` (or `nn.ConvTranspose2d`) with no padding of its own, its weights
    drawn from `generator` on the CPU as torch initialises them (uniform in
    +-1/sqrt(fan_in)) and moved to `device`."""
    cls = nn.ConvTranspose2d if transpose else nn.Conv2d
    conv = cls(in_channels, out_channels, _pair(kernel_size), stride=_pair(stride),
               dilation=_pair(dilation), bias=bias, device="meta")
    kh, kw = _pair(kernel_size)
    fan_in = (out_channels if transpose else in_channels) * kh * kw
    conv.weight = uniform_parameter(conv.weight.shape, fan_in, generator, device)
    if bias:
        conv.bias = uniform_parameter((out_channels,), fan_in, generator, device)
    return conv


def pad2d(x, ph: int, pw: int):
    """Pad dims 2 and 3 by (p // 2, p - p // 2), flax's split."""
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))


def crop2d(x, H: int, W: int):
    """Crop dims 2 and 3 to (H, W), dropping (d // 2) before and the rest after."""
    dh, dw = x.shape[2] - H, x.shape[3] - W
    return x[:, :, dh // 2: x.shape[2] - (dh - dh // 2), dw // 2: x.shape[3] - (dw - dw // 2)]


def pad_to_scale(x, scale):
    """Pad dims 2 and 3 up to multiples of `scale`."""
    sh, sw = _pair(scale)
    return pad2d(x, (sh - x.shape[2] % sh) % sh, (sw - x.shape[3] % sw) % sw)


def scaled(n: int, s: int, levels: int) -> int:
    """A length after `levels` rounds of padding up to a multiple of `s` and pooling by
    `s` (the encoders' bins at each scale)."""
    for _ in range(levels):
        n = -(-n // s)
    return n


class ConvBlock2d(nn.Module):
    """BN -> nonlinear -> pad -> conv (reference ConvBlock2d)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=(3, 3), dilation=1,
                 norm=True, nonlinear: Optional[str] = "relu", eps: float = EPS, *,
                 generator=None, device=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        dh, dw = _pair(dilation)
        self.pads = ((kh - 1) * dh, (kw - 1) * dw)
        self.nonlinear = nonlinear
        self.norm2d = BatchNorm2d(in_channels, eps=1e-5, device=device) if norm else None
        self.conv2d = conv2d(in_channels, out_channels, (kh, kw), dilation=(dh, dw),
                             generator=generator, device=device)

    def forward(self, x):
        if self.norm2d is not None:
            x = self.norm2d(x)
        if self.nonlinear:
            x = choose_nonlinear(self.nonlinear)(x)
        return self.conv2d(pad2d(x, *self.pads))


class DenseBlock(nn.Module):
    """Split-accumulate dense block (reference DenseBlock): block i emits
    sum(growth_rate[i:]) channels; the running residual's first growth_rate[i - 1]
    channels feed block i and the rest accumulate. Out: growth_rate[-1] channels."""

    def __init__(self, in_channels: int, growth_rate, kernel_size=(3, 3),
                 depth: Optional[int] = None, dilated=False, norm=True, nonlinear="relu",
                 eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        if isinstance(growth_rate, int):
            assert depth is not None
            growth_rate = [growth_rate] * depth
        self.growth_rate = list(growth_rate)
        depth = len(self.growth_rate)
        dilated = _expand(dilated, depth, bool)
        norm = _expand(norm, depth, (bool, str))
        nonlinear = _expand(nonlinear, depth, (bool, str))
        self.net = nn.ModuleList([
            ConvBlock2d(in_channels if idx == 0 else self.growth_rate[idx - 1],
                        sum(self.growth_rate[idx:]), kernel_size,
                        dilation=2 ** idx if dilated[idx] else 1, norm=norm[idx],
                        nonlinear=nonlinear[idx], eps=eps, generator=generator, device=device)
            for idx in range(depth)])
        self.out_channels = self.growth_rate[-1]

    def forward(self, x):
        x_residual = 0.0
        for idx, block in enumerate(self.net):
            if idx > 0:
                c = self.growth_rate[idx - 1]
                x, x_residual = x_residual[:, :c], x_residual[:, c:]
            x_residual = x_residual + block(x)
        return x_residual


class _Stages(nn.Module):
    """A backbone's encoder or decoder: its blocks as `net.{i}`."""

    def __init__(self, blocks):
        super().__init__()
        self.net = nn.ModuleList(blocks)


class DownSampleBlock(nn.Module):
    """Pad to the scale -> the stage's block (`slot`) -> (avg-pooled, skip cropped back)
    (JAX DownSampleDenseBlock, and the same steps inline in the D3Net and MDenseRNN
    backbones)."""

    def __init__(self, block: nn.Module, scale, slot: str = "dense_block"):
        super().__init__()
        self.scale, self.slot = _pair(scale), slot
        self.add_module(slot, block)
        self.out_channels = block.out_channels

    def forward(self, x):
        H, W = x.shape[2], x.shape[3]
        x = pad_to_scale(x, self.scale)
        x = getattr(self, self.slot)(x)
        return F.avg_pool2d(x, self.scale), crop2d(x, H, W)


class UpSampleBlock(nn.Module):
    """BN -> transposed conv (kernel = stride = scale) -> crop to the skip -> concat
    [x, skip] -> the stage's block (`slot`) (JAX UpSampleDenseBlock, and the same steps
    inline in the D3Net and MDenseRNN backbones)."""

    def __init__(self, in_channels: int, make_block, scale, slot: str = "dense_block", *,
                 skip_channels: int, generator=None, device=None):
        super().__init__()
        self.slot = slot
        self.norm2d = BatchNorm2d(in_channels, eps=1e-5, device=device)
        self.upsample2d = conv2d(in_channels, in_channels, scale, stride=scale, transpose=True,
                                 generator=generator, device=device)
        block = make_block(in_channels + skip_channels)
        self.add_module(slot, block)
        self.out_channels = block.out_channels

    def forward(self, x, skip):
        x = crop2d(self.upsample2d(self.norm2d(x)), skip.shape[2], skip.shape[3])
        return getattr(self, self.slot)(torch.cat([x, skip], dim=1))


class Backbone(nn.Module):
    """Pad -> conv -> encoder (down-sampling blocks) -> bottleneck block -> decoder
    (up-sampling blocks with skips) -> optional BN + 1x1 conv head (JAX
    MDenseNetBackbone; D3NetBackbone and MDenseRNNBackbone are its instances with other
    blocks). `make_block(stage, in_channels, bins)` builds stage `stage`'s block over
    maps `bins` high; `slot(stage)` names it in its encoder or decoder stage (the
    bottleneck is always `bottleneck_conv2d`)."""

    def __init__(self, in_channels: int, num_features: int, n_stages: int, make_block, slot,
                 kernel_size=(3, 3), scale=(2, 2), out_channels: Optional[int] = None,
                 in_bins: int = 0, *, generator=None, device=None):
        super().__init__()
        assert n_stages % 2 == 1, "`len(growth_rate)` must be odd."
        n_enc = n_stages // 2
        kh, kw = _pair(kernel_size)
        sh = _pair(scale)[0]
        self.pads = (kh - 1, kw - 1)
        self.conv2d = conv2d(in_channels, num_features, (kh, kw), generator=generator,
                             device=device)
        encoders, skips, channels = [], [], num_features
        for idx in range(n_enc):
            block = make_block(idx, channels, scaled(in_bins, sh, idx))
            encoders.append(DownSampleBlock(block, scale, slot(idx)))
            channels = block.out_channels
            skips.append(channels)
        self.encoder = _Stages(encoders)
        self.bottleneck_conv2d = make_block(n_enc, channels, scaled(in_bins, sh, n_enc))
        channels = self.bottleneck_conv2d.out_channels
        decoders = []
        for j, idx in enumerate(range(n_enc + 1, n_stages)):
            bins = scaled(in_bins, sh, n_enc - 1 - j)
            decoders.append(UpSampleBlock(
                channels, lambda c, idx=idx, bins=bins: make_block(idx, c, bins), scale,
                slot(idx), skip_channels=skips[n_enc - 1 - j], generator=generator,
                device=device))
            channels = decoders[-1].out_channels
        self.decoder = _Stages(decoders)
        self.pointwise_conv2d = None
        if out_channels is not None:
            self.pointwise_conv2d = nn.Sequential(
                BatchNorm2d(channels, eps=1e-5, device=device),
                conv2d(channels, out_channels, 1, generator=generator, device=device))
            channels = out_channels
        self.out_channels = channels

    def forward(self, x):
        x = self.conv2d(pad2d(x, *self.pads))
        skips = []
        for block in self.encoder.net:
            x, skip = block(x)
            skips.append(skip)
        x = self.bottleneck_conv2d(x)
        for block, skip in zip(self.decoder.net, reversed(skips)):
            x = block(x, skip)
        if self.pointwise_conv2d is not None:
            x = self.pointwise_conv2d(x)
        return x


class MDenseNetBackbone(Backbone):
    """Initial conv -> dense encoder -> bottleneck dense block -> dense decoder (+1x1
    head) (JAX MDenseNetBackbone)."""

    def __init__(self, in_channels: int, num_features: int, growth_rate: Sequence[int],
                 kernel_size=(3, 3), scale=(2, 2), dilated=False, norm=True, nonlinear="relu",
                 depth=None, out_channels: Optional[int] = None, eps: float = EPS, *,
                 generator=None, device=None):
        growth_rate = list(growth_rate)
        n = len(growth_rate)
        depth = _expand(depth, n, int)
        dilated = _expand(dilated, n, bool)
        norm = _expand(norm, n, (bool, str))
        nonlinear = _expand(nonlinear, n, (bool, str))

        def make_block(idx, channels, bins):
            return DenseBlock(channels, growth_rate[idx], kernel_size, depth=depth[idx],
                              dilated=dilated[idx], norm=norm[idx], nonlinear=nonlinear[idx],
                              eps=eps, generator=generator, device=device)

        super().__init__(in_channels, num_features, n, make_block, lambda idx: "dense_block",
                         kernel_size, scale, out_channels, generator=generator, device=device)


class GLU2d(nn.Module):
    """map(x) * sigmoid(map_gate(x)), two 1x1 convs (reference src/modules/glu.py)."""

    def __init__(self, in_channels: int, out_channels: int, *, generator=None, device=None):
        super().__init__()
        self.map = conv2d(in_channels, out_channels, 1, generator=generator, device=device)
        self.map_gate = conv2d(in_channels, out_channels, 1, generator=generator,
                               device=device)

    def forward(self, x):
        return self.map(x) * torch.sigmoid(self.map_gate(x))


def band_config(cfg, band):
    """A band's entry of a per-band setting (a mapping keyed by band), or the setting."""
    return cfg[band] if isinstance(cfg, dict) else cfg


def config_of(local_vars: dict) -> dict:
    """A model's config from its __init__'s locals(): JAX's dataclass fields, lists as
    tuples (flax keeps its list attributes so)."""
    def frozen(v):
        if isinstance(v, dict):
            return {k: frozen(u) for k, u in v.items()}
        return tuple(frozen(u) for u in v) if isinstance(v, (list, tuple)) else v

    return {k: frozen(v) for k, v in local_vars.items()
            if k not in ("self", "generator", "device", "__class__")}


class SpectrogramHead(nn.Module):
    """The input affine, the model's body, the head (a final block, BN, GLU2d over
    `in_channels`), the output affine and a relu; the bins past the model's (`max_bin`
    or the sections' total) pass through (JAX MDenseNet / MMDenseNet / D3Net /
    MMDenseRNN's shared frame). `body(x)` and `final` are the subclass's."""

    def _head_init(self, in_channels: int, n_valid: int, final: nn.Module, *, final_slot,
                   generator=None, device=None):
        self.n_valid = n_valid
        self.scale_in = nn.Parameter(torch.ones(n_valid, device=device))
        self.bias_in = nn.Parameter(torch.zeros(n_valid, device=device))
        self.scale_out = nn.Parameter(torch.ones(n_valid, device=device))
        self.bias_out = nn.Parameter(torch.zeros(n_valid, device=device))
        self.final_slot = final_slot
        self.add_module(final_slot, final)
        self.norm2d = BatchNorm2d(final.out_channels, eps=1e-5, device=device)
        self.glu2d = GLU2d(final.out_channels, in_channels, generator=generator, device=device)

    def forward(self, input):
        n_frames = input.shape[3]
        x_valid, x_invalid = input[:, :, :self.n_valid], input[:, :, self.n_valid:]
        x = (x_valid - self.bias_in[:, None]) / (self.scale_in[:, None].abs() + self.eps)
        h = getattr(self, self.final_slot)(self.body(x))
        h = self.glu2d(self.norm2d(h))
        h = F.relu(self.scale_out[:, None] * h + self.bias_out[:, None])
        h = crop2d(h, self.n_valid, n_frames)
        return h if x_invalid.shape[2] == 0 else torch.cat([h, x_invalid], dim=2)


@register_model
class MDenseNet(SeparationModelMixin, SpectrogramHead):
    """Single-band multi-scale DenseNet: (B, in_channels, n_bins, n_frames) amplitude ->
    the same shape."""

    def __init__(self, in_channels: int, num_features: int, growth_rate: Sequence[int],
                 kernel_size=(3, 3), max_bin: int = 1367, scale=(2, 2), dilated=False,
                 norm=True, nonlinear="relu", depth=None, growth_rate_final=None,
                 kernel_size_final=None, dilated_final=False, norm_final=True,
                 nonlinear_final="relu", depth_final=None, eps: float = EPS, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = config_of(locals())
        self.eps = eps
        self.net = MDenseNetBackbone(in_channels, num_features, growth_rate, kernel_size,
                                     scale=scale, dilated=dilated, norm=norm,
                                     nonlinear=nonlinear, depth=depth, eps=eps,
                                     generator=generator, device=device)
        final = DenseBlock(self.net.out_channels, growth_rate_final,
                           kernel_size_final or kernel_size, depth=depth_final,
                           dilated=dilated_final, norm=norm_final, nonlinear=nonlinear_final,
                           eps=eps, generator=generator, device=device)
        self._head_init(in_channels, max_bin, final, final_slot="dense_block",
                        generator=generator, device=device)

    def body(self, x):
        return self.net(x)
