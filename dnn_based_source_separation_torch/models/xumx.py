"""X-UMX (CrossNet-Open-Unmix): UMX backbones bridged across sources.

Port of `dnn_based_source_separation_tpu/models/xumx.py:CrossNetOpenUnmix`.
Per-source input blocks; with `bridge`, every source's LSTM takes the MEAN
of the blocks' outputs, and every source's output blocks take the MEAN of
the concatenated [block, LSTM] outputs. Sawata et al., arXiv:2010.04228.

Names are `backbone.<source>.*`, each an OpenUnmix's (`models/umx.py`), as
`hub/torch_convert.py:convert_xumx` reads them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .base import SeparationModelMixin, register_model
from .umx import EPS, __sources__, backbones, config_of


@register_model
class CrossNetOpenUnmix(SeparationModelMixin, nn.Module):
    """(B, 1, C, n_bins, n_frames) -> (B, n_sources, C, n_bins, n_frames)."""

    def __init__(self, in_channels: int, hidden_channels: int = 512, num_layers: int = 3,
                 n_bins: Optional[int] = None, max_bin: Optional[int] = None,
                 dropout: Optional[float] = None, causal: bool = False, rnn_type: str = "lstm",
                 bridge: bool = True, sources: Sequence[str] = tuple(__sources__),
                 eps: float = EPS, *, generator: torch.Generator | None = None, device=None):
        super().__init__()
        self._config = config_of(locals())
        self.sources, self.bridge = self._config["sources"], bridge
        self.backbone = backbones(self.sources, in_channels, hidden_channels, num_layers,
                                  n_bins=n_bins, max_bin=max_bin, dropout=dropout,
                                  causal=causal, rnn_type=rnn_type, eps=eps,
                                  generator=generator, device=device)

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        x = input[:, 0]  # (B, C, n_bins, T)
        nets = [self.backbone[source] for source in self.sources]
        blocks = [net.encode(x) for net in nets]
        if self.bridge:
            rnn_in = torch.stack(blocks).mean(dim=0)  # the first bridging mean
        cat = [torch.cat([h, net.rnn(rnn_in if self.bridge else h)], dim=-1)
               for net, h in zip(nets, blocks)]
        if self.bridge:
            head_in = torch.stack(cat).mean(dim=0)  # the second
        return torch.stack([net.decode(head_in if self.bridge else h, x)
                            for net, h in zip(nets, cat)], dim=1)
