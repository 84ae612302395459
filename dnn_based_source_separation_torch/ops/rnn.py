"""Stacked, optionally bidirectional LSTM and GRU with torch `nn.LSTM` / `nn.GRU` parameters.

Port of `dnn_based_source_separation_tpu/ops/rnn.py:LSTM` and `GRU`. The
input projection of every timestep is one matmul, cast to the parameter
dtype; the recurrence runs in `ops/lstm_scan.py` / `ops/gru_scan.py` (the
fused kernels on CUDA tensors). A bidirectional layer feeds the backward
chain the time-reversed input and flips its hidden states back, as the JAX
package does.

- LSTM: `xw = x @ W_ih^T + (b_ih + b_hh)`; both biases sit outside the
  recurrent product, so their sum goes into xw. JAX trains that sum as one
  bias `b` per chain: here `bias_hh` stays a registered parameter (names,
  `state_dict` and checkpoints are torch's) but is frozen
  (`requires_grad=False`), so only `bias_ih` trains and the sum moves as
  JAX's `b` does under the same optimizer.
- GRU: `xw = x @ W_ih^T + b_ih`, and b_hh goes into the kernel: its n-part
  sits inside the reset gate, `n = tanh(x_n + r * (W_hn h + b_hn))`.

Parameters keep torch's names and shapes: `weight_ih_l{k}` (G*H, F),
`weight_hh_l{k}` (G*H, H), `bias_ih_l{k}`, `bias_hh_l{k}` (G*H,), and the
`_reverse` variants, with G = 4 (LSTM) or 3 (GRU).

`stream(x, state)` is exact streaming (JAX `ops/rnn.py:140-151`, `:207-216`):
a unidirectional stack continues from the carried per-layer state, held in
f32, and returns the final one. It runs the plain step loops
(`lstm_steps` / `gru_steps`), as the JAX package runs its carried scans
outside Pallas. Vanilla RNN and SRU are not ported yet.

Training: the LSTM and GRU recurrences are differentiable on both devices
(`ops/lstm_scan.py`, `ops/gru_scan.py`, backward kernels on CUDA). Both GRU
biases train, as in JAX. `dropout` applies to every layer's output but the
last, in train mode only, by flax's rule (JAX `ops/rnn.py:173-174`,
`:233-234`): `where(mask, x / keep, 0)` with keep = 1 - dropout and the mask
drawn from the module's explicit `torch.Generator` on its device
(`set_dropout_generator`; `F.dropout` takes none). A bidirectional layer's
mask multiplies the concatenated [forward, flipped-back backward] output,
so the backward kernels receive the masked cotangent.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .dropout import Dropout, dropout
from .gru_scan import gru_scan, gru_scan_bidir, gru_steps
from .lstm_scan import lstm_scan, lstm_scan_bidir, lstm_steps
from .params import uniform_parameter


class _StackedRNN(nn.Module):
    """(B, T, F) -> (B, T, D * H), D = 2 if bidirectional; zero initial state.

    `dropout` applies between layers in train mode only; its masks come from
    `self.generator` (a `torch.Generator` on the input's device), which must
    be set (`set_dropout_generator`) before a train-mode forward with
    dropout > 0, as JAX requires a 'dropout' rng.
    """

    GATES = 0

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False, dropout: float = 0.0, *, generator=None,
                 device=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers, self.bidirectional, self.dropout = num_layers, bidirectional, dropout
        self.generator: torch.Generator | None = None
        H, G = hidden_size, self.GATES
        directions = 2 if bidirectional else 1
        for layer in range(num_layers):
            in_features = input_size if layer == 0 else directions * H
            for sfx in self._suffixes(layer):
                # torch's initialisation: every tensor uniform in +-1/sqrt(H).
                for name, shape in (("weight_ih", (G * H, in_features)),
                                    ("weight_hh", (G * H, H)),
                                    ("bias_ih", (G * H,)), ("bias_hh", (G * H,))):
                    self.register_parameter(f"{name}{sfx}",
                                            uniform_parameter(shape, H, generator, device))

    def _suffixes(self, layer: int):
        return [f"_l{layer}"] + ([f"_l{layer}_reverse"] if self.bidirectional else [])

    def _dropout(self, x: torch.Tensor) -> torch.Tensor:
        """flax's nn.Dropout: where(mask, x / keep, 0), mask ~ Bernoulli(keep)."""
        return dropout(x, self.dropout, self.generator, type(self).__name__)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in range(self.num_layers):
            fwd, *rev = self._suffixes(layer)
            if rev:
                hs_f, hs_b = self._bidir(self._chain(x, fwd), self._chain(x.flip(1), rev[0]))
                x = torch.cat([hs_f, hs_b.flip(1)], dim=-1)
            else:
                x = self._single(self._chain(x, fwd))
            if self.training and self.dropout > 0.0 and layer < self.num_layers - 1:
                x = self._dropout(x)
        return x

    def stream(self, x: torch.Tensor, state: list | None = None):
        """Continue a unidirectional stack from `state` (one entry per layer; None = zeros).

        Returns (hs (B, T, H), the final state). A backward chain cannot stream.
        """
        if self.training and self.dropout > 0.0:
            raise NotImplementedError(f"{type(self).__name__}.stream has no dropout: call "
                                      ".eval() to stream")
        if self.bidirectional:
            raise NotImplementedError(
                f"exact streaming requires a unidirectional (causal) {type(self).__name__}")
        state = state or [None] * self.num_layers
        final = []
        for layer in range(self.num_layers):
            x, s = self._steps(self._chain(x, f"_l{layer}"), state[layer])
            final.append(s)
        return x, final


class LSTM(_StackedRNN):
    GATES = 4

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for layer in range(self.num_layers):
            for sfx in self._suffixes(layer):
                getattr(self, f"bias_hh{sfx}").requires_grad_(False)

    def _chain(self, x: torch.Tensor, sfx: str):
        """(xw, W_hh^T) of one direction: xw (B, T, 4H) in the parameter dtype."""
        w_ih = getattr(self, f"weight_ih{sfx}")
        bias = getattr(self, f"bias_ih{sfx}") + getattr(self, f"bias_hh{sfx}")
        xw = F.linear(x, w_ih, bias).to(w_ih.dtype).contiguous()
        return xw, getattr(self, f"weight_hh{sfx}").t().contiguous()

    def _bidir(self, fwd, rev):
        return lstm_scan_bidir(fwd[0], rev[0], fwd[1], rev[1])

    def _single(self, chain):
        return lstm_scan(*chain)

    def _steps(self, chain, state):
        return lstm_steps(*chain, state)


class GRU(_StackedRNN):
    GATES = 3

    def _chain(self, x: torch.Tensor, sfx: str):
        """(xw, W_hh^T, b_hh) of one direction: xw (B, T, 3H) in the parameter dtype."""
        w_ih = getattr(self, f"weight_ih{sfx}")
        xw = F.linear(x, w_ih, getattr(self, f"bias_ih{sfx}")).to(w_ih.dtype).contiguous()
        return (xw, getattr(self, f"weight_hh{sfx}").t().contiguous(),
                getattr(self, f"bias_hh{sfx}").contiguous())

    def _bidir(self, fwd, rev):
        return gru_scan_bidir(fwd[0], rev[0], fwd[1], rev[1], fwd[2], rev[2])

    def _single(self, chain):
        return gru_scan(*chain)

    def _steps(self, chain, state):
        return gru_steps(*chain, state)


def set_dropout_generator(module: nn.Module, generator: torch.Generator | None) -> None:
    """Give every LSTM, GRU and `Dropout` inside `module` the generator its dropout masks
    come from (None: no generator; a train-mode forward with dropout > 0 then raises)."""
    for m in module.modules():
        if isinstance(m, (_StackedRNN, Dropout)):
            m.generator = generator


def choose_rnn(name: str, input_size: int, hidden_size: int, num_layers: int = 1,
               bidirectional: bool = False, dropout: float = 0.0, *, generator=None,
               device=None) -> nn.Module:
    """Factory mirroring `ops/rnn.py:choose_rnn`; 'lstm' and 'gru' are ported."""
    table = {"lstm": LSTM, "gru": GRU}
    if name in table:
        return table[name](input_size, hidden_size, num_layers=num_layers,
                           bidirectional=bidirectional, dropout=dropout, generator=generator,
                           device=device)
    if name in ("rnn", "sru"):
        raise NotImplementedError(f"rnn_type {name!r} is not ported yet (rest of slice B)")
    raise NotImplementedError(f"Unsupported rnn type: {name}")
