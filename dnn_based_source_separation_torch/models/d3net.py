"""D3Net: multi-band densely connected multi-dilated DenseNets, one per stem in
ParallelD3Net.

Port of `dnn_based_source_separation_tpu/models/d3net.py` (D2Block, D3Block,
D3NetBackbone, D3Net, ParallelD3Net), after the reference `src/models/d3net.py` and
`src/models/d2net.py`. Takahashi & Mitsufuji, "D3Net" (arXiv:2010.01733). A D2Block is a
split-accumulate dense block whose layer i dilates by 2^i; a D3Block applies the same
split-accumulate pattern across D2Blocks. Deep levels dilate past their maps' size (up
to 128 at depth 8): the pads are then wider than the map, as in JAX.

Parameter names are those `hub/torch_convert.py:convert_d3net` reads: a D2Block's
`net.{i}.{norm2d,conv2d}`, a D3Block's `net.{k}`, a backbone's `conv2d`,
`encoder.net.{i}.d3block`, `bottleneck_conv2d`, `decoder.net.{j}.{norm2d,upsample2d,
d3block}`, `pointwise_conv2d.{0,1}`, and the head's `d2block`, `norm2d`, `glu2d`;
ParallelD3Net's stems `net.{source}.*`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .base import SeparationModelMixin, register_model
from .m_densenet import (
    EPS, Backbone, DenseBlock, SpectrogramHead, _expand, band_config, config_of,
)
from .mm_densenet import FULL, MMDenseNet, _Parallel


class D2Block(DenseBlock):
    """A dense block with layer i dilated by 2^i (reference d2net.py D2Block)."""

    def __init__(self, in_channels: int, growth_rate, kernel_size=(3, 3), dilated=True,
                 norm=True, nonlinear="relu", depth: Optional[int] = None, eps: float = EPS, *,
                 generator=None, device=None):
        super().__init__(in_channels, growth_rate, kernel_size, depth=depth, dilated=dilated,
                         norm=norm, nonlinear=nonlinear, eps=eps, generator=generator,
                         device=device)


class D3Block(nn.Module):
    """Split-accumulate over D2Blocks (reference D3Block): D2Block k emits
    sum(growth_rate[k:]) channels. Out: growth_rate[-1] channels."""

    def __init__(self, in_channels: int, growth_rate, kernel_size=(3, 3),
                 num_blocks: Optional[int] = None, dilated=True, norm=True, nonlinear="relu",
                 depth: Optional[int] = None, eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        if isinstance(growth_rate, int):
            assert num_blocks is not None
            growth_rate = [growth_rate] * num_blocks
        self.growth_rate = list(growth_rate)
        n = len(self.growth_rate)
        dilated = _expand(dilated, n, (bool, str))
        norm = _expand(norm, n, (bool, str))
        nonlinear = _expand(nonlinear, n, (bool, str))
        self.net = nn.ModuleList([
            D2Block(in_channels if idx == 0 else self.growth_rate[idx - 1],
                    sum(self.growth_rate[idx:]), kernel_size, dilated=dilated[idx],
                    norm=norm[idx], nonlinear=nonlinear[idx], depth=depth, eps=eps,
                    generator=generator, device=device)
            for idx in range(n)])
        self.out_channels = self.growth_rate[-1]

    forward = DenseBlock.forward


class D3NetBackbone(Backbone):
    """conv -> D3 encoder -> D3 bottleneck -> D3 decoder (+1x1 head) (JAX D3NetBackbone)."""

    def __init__(self, in_channels: int, num_features: int, growth_rate: Sequence[int],
                 kernel_size=(3, 3), scale=(2, 2), num_d2blocks=None, dilated=True, norm=True,
                 nonlinear="relu", depth=None, out_channels: Optional[int] = None,
                 eps: float = EPS, *, generator=None, device=None):
        growth_rate = list(growth_rate)
        n = len(growth_rate)
        num_d2 = _expand(num_d2blocks, n, int)
        depth = _expand(depth, n, int)
        dilated = _expand(dilated, n, (bool, str))
        norm = _expand(norm, n, (bool, str))
        nonlinear = _expand(nonlinear, n, (bool, str))

        def make_block(idx, channels, bins):
            return D3Block(channels, growth_rate[idx], kernel_size, num_blocks=num_d2[idx],
                           dilated=dilated[idx], norm=norm[idx], nonlinear=nonlinear[idx],
                           depth=depth[idx], eps=eps, generator=generator, device=device)

        super().__init__(in_channels, num_features, n, make_block, lambda idx: "d3block",
                         kernel_size, scale, out_channels, generator=generator, device=device)


@register_model
class D3Net(SeparationModelMixin, SpectrogramHead):
    """(B, in_channels, n_bins, n_frames) amplitude -> the same shape. Per-band settings
    are dicts keyed by band and 'full' (`egs/musdb18/d3net/config/vocals.yaml`)."""

    def __init__(self, in_channels: int, num_features, growth_rate, kernel_size,
                 bands: Sequence[str] = ("low", "middle"), sections: Sequence[int] = (256, 1344),
                 scale=(2, 2), num_d2blocks=None, dilated=True, norm=True, nonlinear="relu",
                 depth=None, growth_rate_final=None, kernel_size_final=None,
                 dilated_final=True, depth_final=None, norm_final=True,
                 nonlinear_final="relu", eps: float = EPS, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = config_of(locals())
        self.eps, self.bands, self.sections = eps, list(bands), list(sections)
        out_channels = max(band_config(growth_rate, b)[-1] for b in bands)

        def backbone(band, extra=None):
            cfg = {k: band_config(v, band) for k, v in dict(
                num_features=num_features, growth_rate=growth_rate, kernel_size=kernel_size,
                scale=scale, num_d2blocks=num_d2blocks, dilated=dilated, norm=norm,
                nonlinear=nonlinear, depth=depth).items()}
            return D3NetBackbone(in_channels, out_channels=extra, eps=eps,
                                 generator=generator, device=device, **cfg)

        self.net = nn.ModuleDict()
        for band in bands:
            gr = band_config(growth_rate, band)
            self.net[band] = backbone(band, out_channels if gr[-1] < out_channels else None)
        self.net[FULL] = backbone(FULL)
        final = D2Block(out_channels + self.net[FULL].out_channels, growth_rate_final,
                        kernel_size_final or kernel_size, dilated=dilated_final,
                        norm=norm_final, nonlinear=nonlinear_final, depth=depth_final, eps=eps,
                        generator=generator, device=device)
        self._head_init(in_channels, sum(sections), final, final_slot="d2block",
                        generator=generator, device=device)

    body = MMDenseNet.body


@register_model
class ParallelD3Net(_Parallel):
    """One D3Net per stem (reference ParallelD3Net)."""

    def __init__(self, in_channels: int, num_features, growth_rate, kernel_size,
                 bands: Sequence[str] = ("low", "middle"), sections: Sequence[int] = (256, 1344),
                 scale=(2, 2), num_d2blocks=None, dilated=True, norm=True, nonlinear="relu",
                 depth=None, growth_rate_final=None, kernel_size_final=None,
                 dilated_final=True, depth_final=None, norm_final=True,
                 nonlinear_final="relu", sources: Sequence[str] = ("bass", "drums", "other",
                                                                   "vocals"),
                 eps: float = EPS, *, generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = config_of(locals())
        kwargs = {k: v for k, v in self._config.items() if k != "sources"}
        self.sources = list(sources)
        self.net = nn.ModuleDict({source: D3Net(**kwargs, generator=generator, device=device)
                                  for source in self.sources})
