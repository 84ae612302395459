"""MMDenseRNN / MMDenseLSTM: multi-band DenseNets with frame-axis recurrences.

Port of `dnn_based_source_separation_tpu/models/mm_dense_rnn.py` (FrameRNN,
DenseRNNBlock, MDenseRNNBackbone, MMDenseRNN, MMDenseLSTM, ParallelMMDenseLSTM), after
the reference `src/models/mm_dense_rnn.py`, `mm_dense_lstm.py` and `dense_rnn.py`.
Takahashi et al., "MMDenseLSTM" (arXiv:1805.02410). A FrameRNN reads a 1-channel 1x1
bottleneck of the map as a sequence over frames whose features are the bins at that
scale, runs the port's recurrence (`ops/rnn.py:choose_rnn`: on the card the LSTM is
`lstm_scan_bidir`, or `lstm_scan` when causal; `rnn_type="gru"` the GRU kernels) and maps
its output back to the bins as one more channel. The bins at each scale are known when
the model is built (the sections, halved and rounded up per level), so the recurrence's
input width is too.

Parameter names are those `hub/torch_convert.py:convert_mm_dense_rnn` reads. A stage's
block sits under `dense_block` (no recurrence: a DenseBlock's `net.{i}`) or
`dense_rnn_block` (with one), the bottleneck under `bottleneck_conv2d`; a block with a
recurrence keeps the recurrence's `bottleneck_conv2d`, `rnn`, `linear` flat beside its
`dense_block`, and at depth 0 is the recurrence alone.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.params import Linear
from ..ops.rnn import choose_rnn
from .base import SeparationModelMixin, register_model
from .m_densenet import (
    EPS, Backbone, DenseBlock, SpectrogramHead, _expand, band_config, config_of, conv2d,
)
from .mm_densenet import FULL, MMDenseNet, _Parallel

POSITIONS = ("parallel", "after", "before")


class FrameRNN(nn.Module):
    """1x1 bottleneck -> a recurrence over frames with the `bins` as features -> linear
    back to the bins: (B, C, bins, W) -> (B, 1, bins, W) (reference dense_rnn.py RNNBlock)."""

    def __init__(self, in_channels: int, bins: int, hidden_channels: int,
                 rnn_type: str = "lstm", causal: bool = False, *, generator=None, device=None):
        super().__init__()
        self.bottleneck_conv2d = conv2d(in_channels, 1, 1, generator=generator, device=device)
        self.rnn = choose_rnn(rnn_type, bins, hidden_channels, bidirectional=not causal,
                              generator=generator, device=device)
        directions = 1 if causal else 2
        self.linear = Linear(directions * hidden_channels, bins, generator=generator,
                             device=device)
        self.out_channels = 1

    def recur(self, x):
        h = self.bottleneck_conv2d(x)[:, 0].transpose(1, 2)  # (B, W, bins): frames as time
        return self.linear(self.rnn(h)).transpose(1, 2)[:, None]

    forward = recur


class DenseRNNBlock(FrameRNN):
    """A DenseBlock and a FrameRNN side by side (`parallel`: both read x; their outputs
    concatenate along channels), after (`after`: the recurrence reads the block's output)
    or before (`before`: the block reads [x, recurrence(x)])."""

    def __init__(self, in_channels: int, bins: int, growth_rate, kernel_size,
                 hidden_channels: int, depth: Optional[int] = None, dilated=False, norm=True,
                 nonlinear="relu", causal: bool = False, rnn_type: str = "lstm",
                 rnn_position: str = "parallel", eps: float = EPS, *, generator=None,
                 device=None):
        if rnn_position not in POSITIONS:
            raise ValueError(f"Unsupported rnn_position: {rnn_position}")
        dense_in = in_channels + 1 if rnn_position == "before" else in_channels
        dense = DenseBlock(dense_in, growth_rate, kernel_size, depth=depth, dilated=dilated,
                           norm=norm, nonlinear=nonlinear, eps=eps, generator=generator,
                           device=device)
        rnn_in = dense.out_channels if rnn_position == "after" else in_channels
        super().__init__(rnn_in, bins, hidden_channels, rnn_type, causal,
                         generator=generator, device=device)
        self.dense_block, self.rnn_position = dense, rnn_position
        self.out_channels = dense.out_channels + (rnn_position != "before")

    def forward(self, x):
        if self.rnn_position == "parallel":
            return torch.cat([self.dense_block(x), self.recur(x)], dim=1)
        if self.rnn_position == "after":
            y = self.dense_block(x)
            return torch.cat([y, self.recur(y)], dim=1)
        return self.dense_block(torch.cat([x, self.recur(x)], dim=1))


def dense_rnn_block(in_channels, bins, growth_rate, kernel_size, hidden_channels=0, depth=None,
                    dilated=False, norm=True, nonlinear="relu", causal=False, rnn_type="lstm",
                    rnn_position="parallel", eps=EPS, *, generator=None, device=None):
    """JAX DenseRNNBlock's three forms: a DenseBlock (no recurrence), a FrameRNN alone
    (depth 0 with one: the paper config's high-band bottleneck) or a DenseRNNBlock."""
    dense = dict(dilated=dilated, norm=norm, nonlinear=nonlinear, eps=eps,
                 generator=generator, device=device)
    depth_of = len(growth_rate) if isinstance(growth_rate, (list, tuple)) else depth
    if depth_of == 0 and hidden_channels > 0:
        return FrameRNN(in_channels, bins, hidden_channels, rnn_type, causal,
                        generator=generator, device=device)
    if hidden_channels <= 0:
        return DenseBlock(in_channels, growth_rate, kernel_size, depth=depth, **dense)
    return DenseRNNBlock(in_channels, bins, growth_rate, kernel_size, hidden_channels, depth,
                         causal=causal, rnn_type=rnn_type, rnn_position=rnn_position, **dense)


class MDenseRNNBackbone(Backbone):
    """MDenseNetBackbone with DenseRNN blocks over maps `in_bins` high (JAX
    MDenseRNNBackbone)."""

    def __init__(self, in_channels: int, in_bins: int, num_features: int,
                 growth_rate: Sequence[int], hidden_channels: Sequence[int], kernel_size=(3, 3),
                 scale=(2, 2), dilated=False, norm=True, nonlinear="relu", depth=None,
                 causal: bool = False, rnn_type: str = "lstm", rnn_position: str = "parallel",
                 out_channels: Optional[int] = None, eps: float = EPS, *, generator=None,
                 device=None):
        growth_rate, hidden = list(growth_rate), list(hidden_channels)
        n = len(growth_rate)
        assert len(hidden) == n
        depth = _expand(depth, n, int)
        dilated = _expand(dilated, n, bool)
        norm = _expand(norm, n, (bool, str))
        nonlinear = _expand(nonlinear, n, (bool, str))

        def make_block(idx, channels, bins):
            return dense_rnn_block(channels, bins, growth_rate[idx], kernel_size, hidden[idx],
                                   depth[idx], dilated[idx], norm[idx], nonlinear[idx], causal,
                                   rnn_type, rnn_position, eps, generator=generator,
                                   device=device)

        def slot(idx):
            return "dense_rnn_block" if hidden[idx] > 0 else "dense_block"

        super().__init__(in_channels, num_features, n, make_block, slot, kernel_size, scale,
                         out_channels, in_bins, generator=generator, device=device)


@register_model
class MMDenseRNN(SeparationModelMixin, SpectrogramHead):
    """(B, in_channels, n_bins, n_frames) amplitude -> the same shape."""

    def __init__(self, in_channels: int, num_features, growth_rate, hidden_channels,
                 kernel_size, bands: Sequence[str] = ("low", "middle"),
                 sections: Sequence[int] = (512, 513), scale=(2, 2), dilated=False, norm=True,
                 nonlinear="relu", depth=None, growth_rate_final=None,
                 hidden_channels_final: int = 0, kernel_size_final=None, dilated_final=False,
                 norm_final=True, nonlinear_final="relu", depth_final=None,
                 causal: bool = False, rnn_type: str = "rnn", rnn_position: str = "parallel",
                 eps: float = EPS, *, generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = config_of(locals())
        self.eps, self.bands, self.sections = eps, list(bands), list(sections)
        out_channels = max(band_config(growth_rate, b)[-1] for b in bands)
        rnn = dict(causal=causal, rnn_type=rnn_type, rnn_position=rnn_position, eps=eps,
                   generator=generator, device=device)

        def backbone(band, bins, extra=None):
            cfg = {k: band_config(v, band) for k, v in dict(
                num_features=num_features, growth_rate=growth_rate,
                hidden_channels=hidden_channels, kernel_size=kernel_size, scale=scale,
                dilated=dilated, norm=norm, nonlinear=nonlinear, depth=depth).items()}
            return MDenseRNNBackbone(in_channels, bins, out_channels=extra, **cfg, **rnn)

        self.net = nn.ModuleDict()
        for band, bins in zip(bands, sections):
            gr = band_config(growth_rate, band)
            self.net[band] = backbone(band, bins,
                                      out_channels if gr[-1] < out_channels else None)
        self.net[FULL] = backbone(FULL, sum(sections))
        final = dense_rnn_block(out_channels + self.net[FULL].out_channels, sum(sections),
                                growth_rate_final, kernel_size_final or kernel_size,
                                hidden_channels_final, depth_final, dilated_final, norm_final,
                                nonlinear_final, **rnn)
        self._head_init(in_channels, sum(sections), final, final_slot="dense_block",
                        generator=generator, device=device)

    body = MMDenseNet.body


@register_model
class MMDenseLSTM(MMDenseRNN):
    """MMDenseRNN with LSTM recurrences (reference mm_dense_lstm.py MMDenseLSTM)."""

    def __init__(self, *args, rnn_type: str = "lstm", **kwargs):
        super().__init__(*args, rnn_type=rnn_type, **kwargs)


@register_model
class ParallelMMDenseLSTM(_Parallel):
    """One MMDenseLSTM per stem (reference mm_dense_lstm.py ParallelMMDenseLSTM)."""

    def __init__(self, in_channels: int, num_features, growth_rate, hidden_channels,
                 kernel_size, bands: Sequence[str] = ("low", "middle"),
                 sections: Sequence[int] = (512, 513), scale=(2, 2), dilated=False, norm=True,
                 nonlinear="relu", depth=None, growth_rate_final=None,
                 hidden_channels_final: int = 0, kernel_size_final=None, dilated_final=False,
                 norm_final=True, nonlinear_final="relu", depth_final=None,
                 causal: bool = False, rnn_position: str = "parallel", rnn_type: str = "lstm",
                 sources: Sequence[str] = ("bass", "drums", "other", "vocals"),
                 eps: float = EPS, *, generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = config_of(locals())
        kwargs = {k: v for k, v in self._config.items() if k != "sources"}
        self.sources = list(sources)
        self.net = nn.ModuleDict({source: MMDenseLSTM(**kwargs, generator=generator,
                                                      device=device)
                                  for source in self.sources})
