"""The port's MMDenseLSTM / MMDenseRNN against the JAX package (CPU).

Two bands and the full band at tiny widths and odd map sizes, frame recurrences in the
bottlenecks and decoders (features: the bins at that scale), the high band's bottleneck a
recurrence alone (depth 0, as the paper config's), and a final block with a recurrence:
the recurrence after, beside or before the dense block, bidirectional LSTM, causal LSTM
(`lstm_scan` on the card) and GRU, in train mode (the forward, the updated BatchNorm
statistics; the gradients of the two LSTMs) and, for the bidirectional and causal LSTM
models, in eval mode with a port state dict read back through JAX's `convert_mm_dense_rnn`
bit for bit; ParallelMMDenseLSTM's eval forward. Random weights at the JAX init's shapes,
carried over by `hub/from_jax.py:mm_dense_rnn_state_dict_from_jax`; JAX under `jax.jit`
with its LSTM on `lax.scan` (`DNNTPU_PALLAS_LSTM=0`); 1e-4 x max|ref|
(`test_torch_dense_family.py`'s helpers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.hub import (
    mm_dense_rnn_state_dict_from_jax, parallel_state_dict_from_jax,
)
from dnn_based_source_separation_torch.models.mm_dense_rnn import (
    DenseRNNBlock, FrameRNN, MMDenseLSTM, ParallelMMDenseLSTM,
)
from dnn_based_source_separation_tpu.hub.torch_convert import convert_mm_dense_rnn
from dnn_based_source_separation_tpu.models import mm_dense_rnn as jrnn
from test_torch_dense_family import close, held, spec

CONFIG = dict(
    in_channels=2, num_features={"low": 4, "high": 3, "full": 3},
    growth_rate={"low": (3, 3, 3), "high": (2, 0, 2), "full": (3, 2, 3)},
    hidden_channels={"low": (0, 4, 0), "high": (0, 3, 0), "full": (0, 0, 4)},
    kernel_size={"low": 3, "high": 3, "full": 3}, bands=("low", "high"), sections=(5, 6),
    scale={"low": 2, "high": 2, "full": 2},
    depth={"low": (2, 1, 1), "high": (1, 0, 1), "full": (1, 1, 1)},
    growth_rate_final=3, kernel_size_final=3, depth_final=1)
VARIANTS = {  # rnn_position, causal, rnn_type, hidden_channels_final; what is held
    "after": ("after", False, "lstm", 0, dict(eval_mode=False)),
    "causal": ("after", True, "lstm", 2, dict(eval_mode=False)),
    "gru-parallel": ("parallel", False, "gru", 2, dict(eval_mode=False, grads=False)),
    "before": ("before", False, "lstm", 0, dict(eval_mode=False, grads=False)),
}  # gradients: the bidirectional and the causal LSTM (the GRU's: test_torch_gru_grad.py);
# eval forwards: test_port_state_dict_reads_back_through_jax_convert_mm_dense_rnn


@pytest.fixture(autouse=True)
def _plain_lstm(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", "0")


def _config(variant, **over):
    position, causal, rnn_type, final, _ = VARIANTS[variant]
    return dict(CONFIG, rnn_position=position, causal=causal, rnn_type=rnn_type,
                hidden_channels_final=final, **over)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mmdenselstm_matches_jax(variant):
    config = _config(variant)
    x = spec((2, 2, 11, 9), len(variant))
    port = MMDenseLSTM(**config)
    # The blocks' forms: the high band's bottleneck is a recurrence alone.
    assert type(port.net["high"].bottleneck_conv2d) is FrameRNN
    assert type(port.net["full"].decoder.net[0].dense_rnn_block) is DenseRNNBlock
    assert port.net["low"].bottleneck_conv2d.rnn.input_size == 3  # 5 bins -> 3 at scale 2
    assert port.net["low"].bottleneck_conv2d.rnn.bidirectional == (not config["causal"])
    convert = lambda v: mm_dense_rnn_state_dict_from_jax(v, config)  # noqa: E731
    held(port, jrnn.MMDenseLSTM(**config), convert, x, 1, **VARIANTS[variant][-1])


def test_parallel_mmdenselstm_matches_jax():
    config = _config("after", sources=("drums", "vocals"))
    x = spec((1, 1, 2, 11, 7), 2)
    convert = lambda v: parallel_state_dict_from_jax(  # noqa: E731
        mm_dense_rnn_state_dict_from_jax, v, config)
    port = ParallelMMDenseLSTM(**config)
    held(port, jrnn.ParallelMMDenseLSTM(**config), convert, x, 2, train_mode=False)
    assert port.eval()(torch.from_numpy(x)).shape == (1, 2, 2, 11, 7)


@pytest.mark.parametrize("variant", ["after", "causal"])
def test_port_state_dict_reads_back_through_jax_convert_mm_dense_rnn(variant):
    config = _config(variant)
    port = MMDenseLSTM(**config, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for name, buf in port.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    variables = convert_mm_dense_rnn(state, port.get_config())
    back = mm_dense_rnn_state_dict_from_jax(variables, port.get_config())
    state = port.state_dict()
    for name, value in state.items():
        if name.endswith("num_batches_tracked"):
            continue
        if ".bias_ih_" in name:  # JAX keeps b = b_ih + b_hh; it comes back as (b, 0)
            value = value + state[name.replace(".bias_ih_", ".bias_hh_")]
        elif ".bias_hh_" in name:
            value = torch.zeros_like(value)
        assert torch.equal(back[name], value), name
    x = spec((1, 2, 11, 9), 4)
    y = jax.jit(jrnn.MMDenseLSTM(**config).apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        close(port.eval()(torch.from_numpy(x)), y)
