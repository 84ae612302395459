"""Stacked, optionally bidirectional LSTM with torch `nn.LSTM` parameters.

Port of `dnn_based_source_separation_tpu/ops/rnn.py:LSTM` (offline path).
The input projection of every timestep is one matmul,
`xw = x @ W_ih^T + (b_ih + b_hh)`, cast to the parameter dtype; the
recurrence runs in `ops/lstm_scan.py` (the fused kernels on CUDA tensors).
A bidirectional layer feeds the backward chain the time-reversed input and
flips its hidden states back, as the JAX package does.

Parameters keep `nn.LSTM`'s names and shapes: `weight_ih_l{k}` (4H, F),
`weight_hh_l{k}` (4H, H), `bias_ih_l{k}`, `bias_hh_l{k}` (4H,), and the
`_reverse` variants. GRU, vanilla RNN and SRU, and the carried state of
exact streaming, are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .lstm_scan import lstm_scan, lstm_scan_bidir
from .params import uniform_parameter


class LSTM(nn.Module):
    """(B, T, F) -> (B, T, D * H), D = 2 if bidirectional; zero initial state.

    `dropout` follows `nn.LSTM`: it would apply between layers in training
    only. Training is not ported, so a module with dropout > 0 raises in
    train mode and ignores it in eval mode.
    """

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False, dropout: float = 0.0, *, generator=None,
                 device=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers, self.bidirectional, self.dropout = num_layers, bidirectional, dropout
        H = hidden_size
        directions = 2 if bidirectional else 1
        for layer in range(num_layers):
            in_features = input_size if layer == 0 else directions * H
            for sfx in self._suffixes(layer):
                # nn.LSTM's initialisation: every tensor uniform in +-1/sqrt(H).
                for name, shape in (("weight_ih", (4 * H, in_features)),
                                    ("weight_hh", (4 * H, H)),
                                    ("bias_ih", (4 * H,)), ("bias_hh", (4 * H,))):
                    self.register_parameter(f"{name}{sfx}",
                                            uniform_parameter(shape, H, generator, device))

    def _suffixes(self, layer: int):
        return [f"_l{layer}"] + ([f"_l{layer}_reverse"] if self.bidirectional else [])

    def _chain(self, x: torch.Tensor, sfx: str):
        """(xw, W_hh^T) of one direction: xw (B, T, 4H) in the parameter dtype."""
        w_ih = getattr(self, f"weight_ih{sfx}")
        bias = getattr(self, f"bias_ih{sfx}") + getattr(self, f"bias_hh{sfx}")
        xw = F.linear(x, w_ih, bias).to(w_ih.dtype).contiguous()
        return xw, getattr(self, f"weight_hh{sfx}").t().contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.dropout > 0.0:
            raise NotImplementedError("LSTM dropout is a training feature; training is not "
                                      "ported yet (call .eval())")
        for layer in range(self.num_layers):
            fwd, *rev = self._suffixes(layer)
            xw_f, whh_f = self._chain(x, fwd)
            if rev:
                xw_b, whh_b = self._chain(x.flip(1), rev[0])
                hs_f, hs_b = lstm_scan_bidir(xw_f, xw_b, whh_f, whh_b)
                del xw_f, xw_b  # the (B, T, 4H) gates are the largest tensors here
                x = torch.cat([hs_f, hs_b.flip(1)], dim=-1)
            else:
                x = lstm_scan(xw_f, whh_f)
        return x


def choose_rnn(name: str, input_size: int, hidden_size: int, num_layers: int = 1,
               bidirectional: bool = False, dropout: float = 0.0, *, generator=None,
               device=None) -> nn.Module:
    """Factory mirroring `ops/rnn.py:choose_rnn`; only 'lstm' is ported."""
    if name == "lstm":
        return LSTM(input_size, hidden_size, num_layers=num_layers, bidirectional=bidirectional,
                    dropout=dropout, generator=generator, device=device)
    if name == "gru":
        raise NotImplementedError("rnn_type 'gru' is not ported yet: it comes with the "
                                  "gru_scan_bidir kernel, the next DPRNN-TasNet slice")
    if name in ("rnn", "sru"):
        raise NotImplementedError(f"rnn_type {name!r} is not ported yet (rest of slice B)")
    raise NotImplementedError(f"Unsupported rnn type: {name}")
