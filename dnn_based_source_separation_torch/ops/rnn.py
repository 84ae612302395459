"""Stacked, optionally bidirectional LSTM, GRU, vanilla RNN and SRU.

Port of `dnn_based_source_separation_tpu/ops/rnn.py:LSTM`, `GRU`, `RNN` and
`SRU`, with `choose_rnn`. The
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

- RNN: `h = tanh(x @ W_ih^T + b_ih + b_hh + h @ W_hh^T)` from zeros, one
  step at a time (`rnn_steps`; JAX `_rnn_scan` has no kernel either). JAX
  keeps one bias, so `bias_hh` is frozen, as the LSTM's.
- SRU (JAX `ops/rnn.py:260`): one projection `x @ W^T` (3H, no bias) split
  into x~, f', r'; f = sigmoid(f' + b_f), r = sigmoid(r' + b_r); the linear
  recurrence `c_t = f_t c_{t-1} + (1 - f_t) x~_t` solved in f32 by a doubling
  scan (`sru_linear_scan`: ceil(log2 T) rounds, not T steps) and cast back to
  the input's dtype; `h = r c + (1 - r) hw` with the highway hw = x when F == H,
  else `x @ W_hx^T`.

Parameters keep torch's names and shapes: `weight_ih_l{k}` (G*H, F),
`weight_hh_l{k}` (G*H, H), `bias_ih_l{k}`, `bias_hh_l{k}` (G*H,), and the
`_reverse` variants, with G = 4 (LSTM), 3 (GRU) or 1 (RNN). SRU, which has
no torch module, names JAX's `w_ih`, `b` and `w_hx` in the same manner:
`weight_ih_l{k}` (3H, F), `bias_l{k}` (2H,) and, when F != H, `weight_hx_l{k}`
(H, F).

`stream(x, state)` is exact streaming (JAX `ops/rnn.py:140-151`, `:207-216`):
a unidirectional stack continues from the carried per-layer state, held in
f32, and returns the final one. It runs the plain step loops
(`lstm_steps` / `gru_steps`), as the JAX package runs its carried scans
outside Pallas. RNN and SRU do not stream: JAX's accept `stream_state` and
ignore it, so a chunked JAX run restarts their recurrence at every call and
is not the offline output; their `stream` raises.

Training: every recurrence is differentiable on both devices
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
    FROZEN_BIAS_HH = False  # JAX trains one bias, b = b_ih + b_hh: bias_hh stays fixed

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False, dropout: float = 0.0, *, generator=None,
                 device=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers, self.bidirectional, self.dropout = num_layers, bidirectional, dropout
        self.generator: torch.Generator | None = None
        directions = 2 if bidirectional else 1
        for layer in range(num_layers):
            in_features = input_size if layer == 0 else directions * hidden_size
            for sfx in self._suffixes(layer):
                # torch's initialisation: every tensor uniform in +-1/sqrt(H).
                for name, shape in self._shapes(in_features):
                    self.register_parameter(f"{name}{sfx}",
                                            uniform_parameter(shape, hidden_size, generator,
                                                              device))
                if self.FROZEN_BIAS_HH:
                    getattr(self, f"bias_hh{sfx}").requires_grad_(False)

    def _shapes(self, in_features: int):
        """(name, shape) of one layer's parameters in one direction."""
        H, G = self.hidden_size, self.GATES
        return (("weight_ih", (G * H, in_features)), ("weight_hh", (G * H, H)),
                ("bias_ih", (G * H,)), ("bias_hh", (G * H,)))

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
    FROZEN_BIAS_HH = True

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


def rnn_steps(xw: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """The vanilla RNN from zeros, one step at a time: xw (B, T, H), w_hh (H, H) (W_hh^T)
    -> hs (B, T, H), h_t = tanh(xw_t + h_{t-1} @ w_hh), in xw's dtype as JAX's `_rnn_scan`."""
    h = xw.new_zeros(xw.shape[0], w_hh.shape[0])
    hs = []
    for t in range(xw.shape[1]):
        h = torch.tanh(xw[:, t] + h @ w_hh)
        hs.append(h)
    return torch.stack(hs, dim=1)


class _Unstreamed(_StackedRNN):
    """A recurrence that the JAX package does not stream: its `stream_state` is ignored."""

    def stream(self, x: torch.Tensor, state: list | None = None):
        raise NotImplementedError(
            f"exact streaming of rnn_type {type(self).__name__.lower()!r} is not defined: the "
            "JAX package's RNN and SRU ignore the carried state, so their chunked output "
            "restarts the recurrence at every call; use rnn_type 'lstm' or 'gru'")


class RNN(_Unstreamed):
    GATES = 1
    FROZEN_BIAS_HH = True

    def _chain(self, x: torch.Tensor, sfx: str):
        """(xw, W_hh^T) of one direction: xw (B, T, H) in the parameter dtype."""
        w_ih = getattr(self, f"weight_ih{sfx}")
        bias = getattr(self, f"bias_ih{sfx}") + getattr(self, f"bias_hh{sfx}")
        return F.linear(x, w_ih, bias).to(w_ih.dtype), getattr(self, f"weight_hh{sfx}").t()

    def _bidir(self, fwd, rev):
        return rnn_steps(*fwd), rnn_steps(*rev)

    def _single(self, chain):
        return rnn_steps(*chain)


def sru_linear_scan(f: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """c_t = f_t c_{t-1} + z_t from c_0 = 0 over dim 1, in f32, cast back to z's dtype.

    A doubling (Hillis-Steele) scan of the affine maps c -> f_t c + z_t: round d
    composes each map with the one d steps before it, so ceil(log2 T) rounds of
    elementwise ops replace T dependent steps. JAX (`_sru_linear_scan`) composes the
    same maps in `lax.associative_scan`'s tree order: the two round apart.
    """
    a, b = f.float(), z.float()
    d, T = 1, a.shape[1]
    while d < T:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < T:  # the last round needs no products of the gates
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b.to(z.dtype)


class SRU(_Unstreamed):
    """Simple Recurrent Unit (Lei et al. 2018): the recurrence is elementwise, so a
    direction is one projection and one `sru_linear_scan`."""

    def _shapes(self, in_features: int):
        H = self.hidden_size
        shapes = [("weight_ih", (3 * H, in_features)), ("bias", (2 * H,))]
        if in_features != H:
            shapes.append(("weight_hx", (H, in_features)))
        return shapes

    def _chain(self, x: torch.Tensor, sfx: str) -> torch.Tensor:
        """One direction's hidden states (B, T, H)."""
        w = getattr(self, f"weight_ih{sfx}")
        xt, fp, rp = F.linear(x, w).chunk(3, dim=-1)
        bf, br = getattr(self, f"bias{sfx}").chunk(2)
        f, r = torch.sigmoid(fp + bf), torch.sigmoid(rp + br)
        c = sru_linear_scan(f, (1.0 - f) * xt)
        w_hx = getattr(self, f"weight_hx{sfx}", None)
        hw = x if w_hx is None else F.linear(x, w_hx)
        return r * c + (1.0 - r) * hw

    def _bidir(self, fwd, rev):
        return fwd, rev

    def _single(self, chain):
        return chain


def set_dropout_generator(module: nn.Module, generator: torch.Generator | None) -> None:
    """Give every recurrence and `Dropout` inside `module` the generator its dropout masks
    come from (None: no generator; a train-mode forward with dropout > 0 then raises)."""
    for m in module.modules():
        if isinstance(m, (_StackedRNN, Dropout)):
            m.generator = generator


def choose_rnn(name: str, input_size: int, hidden_size: int, num_layers: int = 1,
               bidirectional: bool = False, dropout: float = 0.0, *, generator=None,
               device=None) -> nn.Module:
    """Factory mirroring `ops/rnn.py:choose_rnn`: 'rnn', 'lstm', 'gru' or 'sru'."""
    table = {"rnn": RNN, "lstm": LSTM, "gru": GRU, "sru": SRU}
    if name not in table:
        raise NotImplementedError(f"Unsupported rnn type: {name}")
    return table[name](input_size, hidden_size, num_layers=num_layers,
                       bidirectional=bidirectional, dropout=dropout, generator=generator,
                       device=device)
