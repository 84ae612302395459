"""The vanilla RNN and the SRU of the port against the JAX package (CPU).

- `ops/rnn.py:RNN` and `SRU` alone, one and two layers, one and two directions, with
  F == H (SRU's highway is x) and F != H (its `weight_hx`), forward and gradients;
- `sru_linear_scan`, the doubling scan, against JAX's `lax.associative_scan` on a long
  sequence of gates near 1: the two compose the affine maps in different orders, held
  to SCAN_TOL x max|ref|; in bf16 it scans in f32 and rounds once;
- DPRNN-TasNet (causal or not) and LSTM-TasNet with `rnn_type` 'rnn' and 'sru', weights
  from `hub/from_jax.py`, forward and the gradients of every parameter;
- exact streaming refused for both (JAX's ignore the carried state), and the train
  CLI with `--rnn_type sru`, its checkpoint served.

Parity is held at TOL x max|ref| in f32, the repo's 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.hub import (
    dprnn_tasnet_state_dict_from_jax, lstm_tasnet_state_dict_from_jax,
)
from dnn_based_source_separation_torch.hub.from_jax import _RNN
from dnn_based_source_separation_torch.models import DPRNNTasNet, LSTMTasNet
from dnn_based_source_separation_torch.models.streaming import ExactStreamingSeparator
from dnn_based_source_separation_torch.ops.rnn import RNN, SRU, sru_linear_scan
from dnn_based_source_separation_tpu.models import DPRNNTasNet as JDPRNNTasNet
from dnn_based_source_separation_tpu.models import LSTMTasNet as JLSTMTasNet
from dnn_based_source_separation_tpu.ops import rnn as jrnn

TOL = 1e-4
# The doubling scan and the associative scan's tree round differently: over 2000 steps of
# gates in (0.95, 1) (a memory of about 40 steps), about 1e-6 x max|ref| apart.
SCAN_TOL = 1e-5
MODULES = {"rnn": (RNN, jrnn.RNN), "sru": (SRU, jrnn.SRU)}
DPRNN = dict(n_basis=16, kernel_size=4, enc_nonlinear="relu", sep_bottleneck_channels=8,
             sep_hidden_channels=12, sep_chunk_size=10, sep_hop_size=5, sep_num_blocks=2,
             n_sources=2)
LSTM_TASNET = dict(n_basis=12, kernel_size=8, sep_num_blocks=2, sep_num_layers=2,
                   sep_hidden_channels=8, mask_nonlinear="softmax")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), np.abs(got - ref).max()


def _scramble(tree, rng):
    """Non-zero biases and non-identity norm affines, so that every parameter matters."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _scramble(v, rng)
            continue
        v = np.asarray(v)
        if k == "gamma":
            v = 0.5 + rng.random(v.shape)
        elif k in ("beta", "bias") or k.startswith("b"):
            v = 0.3 * rng.standard_normal(v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


def _check_grads(port, jgrads, convert, what):
    """Every trainable port parameter's gradient against the JAX gradient tree mapped by
    the weight converter (a map of transposes, so it maps gradients alike)."""
    ref = convert(jgrads)
    for name, p in port.named_parameters():
        if p.requires_grad:
            assert p.grad is not None, f"{what}: {name} got no gradient"
            _close(p.grad, ref[name])


def _cotangent(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["rnn", "sru"])
# F != H (SRU's weight_hx) bidirectional, and F == H (the highway is x) at both layers.
@pytest.mark.parametrize("F,H,layers,bidirectional", [(6, 8, 2, True), (8, 8, 2, False)])
def test_module_forward_and_grads_match_jax(kind, F, H, layers, bidirectional):
    port_cls, jax_cls = MODULES[kind]
    x = np.random.default_rng(F + H).standard_normal((3, 37, F)).astype(np.float32)
    jmodule = jax_cls(hidden_size=H, num_layers=layers, bidirectional=bidirectional)
    params = _scramble(jax.tree_util.tree_map(
        np.asarray, jmodule.init(jax.random.PRNGKey(layers), jnp.asarray(x))["params"]),
        np.random.default_rng(H))
    port = port_cls(F, H, num_layers=layers, bidirectional=bidirectional)
    convert = lambda tree: {k[2:]: v for k, v in _sd(kind, tree).items()}  # noqa: E731
    port.load_state_dict(convert(params))
    y = np.asarray(jax.jit(jmodule.apply)({"params": params}, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt)
    _close(got, y)
    g = _cotangent(y.shape, 7)

    def loss(p, xin):
        return jnp.sum(jmodule.apply({"params": p}, xin) * g)

    jgrads, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    (got * torch.from_numpy(g)).sum().backward()
    _close(xt.grad, jgx)
    _check_grads(port, jgrads, convert, f"{kind} F={F} H={H}")
    if kind == "rnn":  # JAX trains one bias: bias_hh is frozen at 0, as the LSTM's
        assert not any(p.requires_grad for n, p in port.named_parameters() if "bias_hh" in n)


def _sd(kind, tree):
    sd = {}
    _RNN[kind](sd, "r", tree)
    return sd


def test_sru_linear_scan_matches_jax_associative_scan():
    rng = np.random.default_rng(3)
    f = (0.95 + 0.05 * rng.random((2, 2000, 8))).astype(np.float32)
    z = rng.standard_normal((2, 2000, 8)).astype(np.float32)
    ref = np.asarray(jax.jit(jrnn._sru_linear_scan)(jnp.asarray(f), jnp.asarray(z)))
    got = sru_linear_scan(torch.from_numpy(f), torch.from_numpy(z))
    _close(got, ref, SCAN_TOL)
    # The sequential recurrence in float64: both scans within SCAN_TOL of it.
    c, seq = np.zeros((2, 8)), np.empty(f.shape)
    for t in range(f.shape[1]):
        c = f[:, t] * c + z[:, t]
        seq[:, t] = c
    _close(got, seq, SCAN_TOL)
    # bf16 in, bf16 out; the scan itself in f32, one rounding at the end.
    fb, zb = torch.from_numpy(f).bfloat16(), torch.from_numpy(z).bfloat16()
    got_bf16 = sru_linear_scan(fb, zb)
    assert got_bf16.dtype == torch.bfloat16
    assert torch.equal(got_bf16, sru_linear_scan(fb.float(), zb.float()).bfloat16())
    for T in (1, 2, 3, 5):  # short sequences: every round count
        _close(sru_linear_scan(torch.from_numpy(f[:, :T]), torch.from_numpy(z[:, :T])),
               seq[:, :T], SCAN_TOL)


def _model_pair(jax_cls, port_cls, convert, config, x, seed):
    jmodel = jax_cls(**config)
    params = _scramble(jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]),
        np.random.default_rng(seed))
    port = port_cls(**config).eval()
    port.load_state_dict(convert({"params": params}, config))
    return jmodel, params, port


@pytest.mark.parametrize("model,kind,causal", [
    ("dprnn-tasnet", "rnn", False), ("dprnn-tasnet", "rnn", True), ("dprnn-tasnet", "sru", False),
    ("dprnn-tasnet", "sru", True), ("lstm-tasnet", "rnn", True), ("lstm-tasnet", "sru", False)])
def test_models_with_rnn_and_sru_match_jax(model, kind, causal):
    if model == "dprnn-tasnet":
        jax_cls, port_cls, convert, base = (JDPRNNTasNet, DPRNNTasNet,
                                            dprnn_tasnet_state_dict_from_jax, DPRNN)
    else:
        jax_cls, port_cls, convert, base = (JLSTMTasNet, LSTMTasNet,
                                            lstm_tasnet_state_dict_from_jax, LSTM_TASNET)
    config = dict(base, rnn_type=kind, causal=causal)
    x = np.random.default_rng(int(causal)).standard_normal((2, 1, 203)).astype(np.float32)
    jmodel, params, port = _model_pair(jax_cls, port_cls, convert, config, x, 2 + causal)
    y = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x)))
    got = port(torch.from_numpy(x))
    _close(got, y)
    g = _cotangent(y.shape, 11)

    def loss(p):
        return jnp.sum(jmodel.apply({"params": p}, jnp.asarray(x)) * g)

    jgrads = jax.jit(jax.grad(loss))(params)
    (got * torch.from_numpy(g)).sum().backward()
    _check_grads(port, {"params": jgrads}, lambda t: convert(t, config), f"{model} {kind}")


@pytest.mark.parametrize("kind", ["rnn", "sru"])
def test_exact_streaming_refuses_rnn_and_sru(kind):
    dprnn = DPRNNTasNet(**dict(DPRNN, rnn_type=kind, causal=True), stream_safe=True).eval()
    tasnet = LSTMTasNet(**dict(LSTM_TASNET, rnn_type=kind, causal=True,
                               enc_basis="trainable")).eval()
    for model, hop in ((dprnn, 16), (tasnet, 16)):
        with pytest.raises(NotImplementedError, match=kind):
            ExactStreamingSeparator(model, hop_samples=hop)
    with pytest.raises(NotImplementedError, match="carried state"):
        dprnn.separator.dprnn.net[0].inter_chunk_block.rnn.stream(torch.zeros(1, 3, 8))
