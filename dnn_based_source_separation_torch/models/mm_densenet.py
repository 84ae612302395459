"""MMDenseNet: multi-band multi-scale DenseNets, one per stem in ParallelMMDenseNet.

Port of `dnn_based_source_separation_tpu/models/mm_densenet.py` (MMDenseNet,
ParallelMMDenseNet, TimeDomainWrapper), after the reference `src/models/mm_densenet.py`.
One MDenseNet backbone a band over its bins (`bands`, `sections`) and one over the full
band; the bands' outputs concatenate along bins, the full band's along channels, then a
final dense block, BN and GLU2d. Per-band settings are dicts keyed by band name and
'full', as in the recipe YAML (`egs/musdb18/mm-densenet/config/paper.yaml`).

Parameter names: `net.{band}.*` (`models/m_densenet.py:MDenseNetBackbone`),
`dense_block`, `norm2d`, `glu2d`, `scale_in` / `bias_in` / `scale_out` / `bias_out`, as
`hub/torch_convert.py:convert_mm_densenet` reads them; ParallelMMDenseNet's stems
`net.{source}.*`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.stft import istft, stft
from ..ops.windows import build_window
from .base import SeparationModelMixin, register_model
from .m_densenet import (
    EPS, DenseBlock, MDenseNetBackbone, SpectrogramHead, band_config, config_of,
)

FULL = "full"


def band_outputs(bands, growth_rate) -> int:
    """The channels every band's backbone ends with: the most of their last stages'."""
    return max(band_config(growth_rate, b)[-1] for b in bands)


@register_model
class MMDenseNet(SeparationModelMixin, SpectrogramHead):
    """(B, in_channels, n_bins, n_frames) amplitude -> the same shape."""

    def __init__(self, in_channels: int, num_features, growth_rate, kernel_size,
                 bands: Sequence[str] = ("low", "middle"), sections: Sequence[int] = (512, 513),
                 scale=(2, 2), dilated=False, norm=True, nonlinear="relu", depth=None,
                 growth_rate_final=None, kernel_size_final=None, dilated_final=False,
                 norm_final=True, nonlinear_final="relu", depth_final=None, eps: float = EPS,
                 *, generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = config_of(locals())
        self.eps, self.bands, self.sections = eps, list(bands), list(sections)
        out_channels = band_outputs(bands, growth_rate)

        def backbone(band, extra=None):
            cfg = {k: band_config(v, band) for k, v in dict(
                num_features=num_features, growth_rate=growth_rate, kernel_size=kernel_size,
                scale=scale, dilated=dilated, norm=norm, nonlinear=nonlinear,
                depth=depth).items()}
            return MDenseNetBackbone(in_channels, out_channels=extra, eps=eps,
                                     generator=generator, device=device, **cfg)

        self.net = nn.ModuleDict()
        for band in bands:
            gr = band_config(growth_rate, band)
            self.net[band] = backbone(band, out_channels if gr[-1] < out_channels else None)
        self.net[FULL] = backbone(FULL)
        final = DenseBlock(out_channels + self.net[FULL].out_channels, growth_rate_final,
                           kernel_size_final or kernel_size, depth=depth_final,
                           dilated=dilated_final, norm=norm_final, nonlinear=nonlinear_final,
                           eps=eps, generator=generator, device=device)
        self._head_init(in_channels, sum(sections), final, final_slot="dense_block",
                        generator=generator, device=device)

    def body(self, x):
        bands = torch.cat([self.net[band](xb) for band, xb in
                           zip(self.bands, torch.split(x, self.sections, dim=2))], dim=2)
        return torch.cat([bands, self.net[FULL](x)], dim=1)


class _Parallel(SeparationModelMixin, nn.Module):
    """One model a stem, `net.{source}`: (B, 1, C, n_bins, n_frames) -> (B, n_sources, C,
    n_bins, n_frames)."""

    def forward(self, input):
        x = input[:, 0]
        return torch.stack([self.net[source](x) for source in self.sources], dim=1)


@register_model
class ParallelMMDenseNet(_Parallel):
    """One MMDenseNet per stem (reference ParallelMMDenseNet)."""

    def __init__(self, in_channels: int, num_features, growth_rate, kernel_size,
                 bands: Sequence[str] = ("low", "middle"), sections: Sequence[int] = (512, 513),
                 scale=(2, 2), dilated=False, norm=True, nonlinear="relu", depth=None,
                 growth_rate_final=None, kernel_size_final=None, dilated_final=False,
                 norm_final=True, nonlinear_final="relu", depth_final=None,
                 sources: Sequence[str] = ("bass", "drums", "other", "vocals"),
                 eps: float = EPS, *, generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = config_of(locals())
        kwargs = {k: v for k, v in self._config.items() if k != "sources"}
        self.sources = list(sources)
        self.net = nn.ModuleDict({source: MMDenseNet(**kwargs, generator=generator,
                                                     device=device)
                                  for source in self.sources})


class TimeDomainWrapper(nn.Module):
    """STFT -> magnitude -> the model -> the mixture's phase -> iSTFT: (B, C, T) ->
    (B, C, T) for a model of (B, C, F, S) magnitudes (JAX TimeDomainWrapper)."""

    def __init__(self, model: nn.Module, n_fft: int, hop_length: Optional[int] = None,
                 window_fn: str = "hann"):
        super().__init__()
        self.model, self.n_fft = model, n_fft
        self.hop_length = hop_length or n_fft // 4
        device = next(model.parameters()).device
        self.register_buffer("window", build_window(n_fft, window_fn, device=device),
                             persistent=False)

    def forward(self, input):
        spec = stft(input, self.n_fft, self.hop_length, window=self.window)
        est = self.model(spec.abs())
        return istft(torch.polar(est, torch.angle(spec)), self.n_fft, self.hop_length,
                     window=self.window, length=input.shape[-1])
