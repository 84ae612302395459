"""One train step of whole models, the port against the JAX package (CPU).

JAX weights go into the port through `hub/from_jax.py`; the port takes one
`make_train_step`, and the JAX side computes the same step's loss and
gradients (`jax.value_and_grad` of the loss function of its
`make_train_step`, steps.py:138-156, with the Pallas LSTM and GRU kernels
in interpret mode, `DNNTPU_PALLAS_LSTM=1`, so their `custom_vjp` is the
reference; the GRU DPRNN-TasNet also against `DNNTPU_PALLAS_LSTM=0`, where
JAX differentiates its `lax.scan` GRU). The JAX gradients are carried into
the port's layout with `hub/from_jax.py`, which is linear: transposes,
reshapes, and the LSTM's single `b` going to `bias_ih` with zeros for the
frozen `bias_hh`, which gets no gradient. Both GRU biases train. f32: loss
within 1e-5 relative, each gradient within 1e-3 x max|g| of its tensor.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnn_based_source_separation_torch.criterion import NegSISDR, PIT1d
from dnn_based_source_separation_torch.hub import (
    conv_tasnet_state_dict_from_jax, dprnn_tasnet_state_dict_from_jax,
)
from dnn_based_source_separation_torch.models import ConvTasNet, DPRNNTasNet
from dnn_based_source_separation_torch.ops.rnn import LSTM
from dnn_based_source_separation_torch.train import make_optimizer, make_train_step
from dnn_based_source_separation_tpu.criterion import NegSISDR as JNegSISDR
from dnn_based_source_separation_tpu.criterion import PIT1d as JPIT1d
from dnn_based_source_separation_tpu.hub.torch_convert import lstm_params
from dnn_based_source_separation_tpu.models import ConvTasNet as JConvTasNet
from dnn_based_source_separation_tpu.models import DPRNNTasNet as JDPRNNTasNet
from dnn_based_source_separation_tpu.ops import rnn as jrnn
from dnn_based_source_separation_tpu.train.steps import make_optimizer as jax_make_optimizer
from dnn_based_source_separation_tpu.train.steps import make_train_step as jax_make_train_step

CONV = dict(n_basis=16, kernel_size=8, stride=4, enc_nonlinear="relu", sep_num_blocks=2,
            sep_num_layers=3, sep_hidden_channels=20, sep_bottleneck_channels=12,
            sep_skip_channels=12, causal=False, n_sources=2)
DPRNN = dict(n_basis=16, kernel_size=4, enc_nonlinear="relu", sep_bottleneck_channels=8,
             sep_hidden_channels=12, sep_chunk_size=10, sep_hop_size=5, sep_num_blocks=2,
             n_sources=2)
MODELS = {
    "conv-tasnet": (CONV, JConvTasNet, ConvTasNet, conv_tasnet_state_dict_from_jax),
    **{f"dprnn-tasnet{'-gru' if rnn == 'gru' else ''}{'-causal' if causal else ''}": (
        dict(DPRNN, causal=causal, rnn_type=rnn), JDPRNNTasNet, DPRNNTasNet,
        dprnn_tasnet_state_dict_from_jax)
       for rnn in ("lstm", "gru") for causal in (False, True)},
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scramble(tree, rng):
    """Non-identity norm affines and non-zero biases, so every parameter matters."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _scramble(v, rng)
            continue
        v = np.asarray(v)
        if k == "gamma":
            v = 0.5 + rng.random(v.shape)
        elif k in ("beta", "bias", "b") or k.startswith("b_"):
            v = 0.3 * rng.standard_normal(v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


def _batch(seed, B=2, T=160):
    rng = np.random.default_rng(seed)
    sources = 0.3 * rng.standard_normal((B, 2, T)).astype(np.float32)
    return sources.sum(axis=1, keepdims=True), sources


def _pair(name, seed):
    config, jcls, pcls, from_jax = MODELS[name]
    mixture, sources = _batch(seed)
    jmodel = jcls(**config)
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(mixture)))
    variables = {"params": _scramble(variables["params"], np.random.default_rng(seed))}
    port = pcls(**config)
    port.load_state_dict(from_jax(variables, config))
    return jmodel, variables, port, mixture, sources


def _jax_loss_and_grads(name, jmodel, variables, mixture, sources, compute_dtype=None):
    """The loss function of the JAX `make_train_step` (steps.py:138-156) and its gradient,
    the gradient carried into the port's layout."""
    criterion = JPIT1d(JNegSISDR(), n_sources=2)

    def loss_fn(p):
        mix = jnp.asarray(mixture)
        if compute_dtype is not None:
            p = jax.tree_util.tree_map(lambda a: a.astype(compute_dtype), p)
            mix = mix.astype(compute_dtype)
        est = jmodel.apply({"params": p}, mix).astype(jnp.float32)
        return criterion(est, jnp.asarray(sources))[0]

    config, *_, from_jax = MODELS[name]
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), from_jax(jax.tree_util.tree_map(np.asarray, grads), config)


def _port_loss_and_grads(name, port, mixture, sources, compute_dtype=None):
    """One port `make_train_step` (SGD at lr 0, no clipping: the weights stay and the
    gradients stay in .grad); the frozen LSTM `bias_hh` reads as a zero gradient."""
    config = MODELS[name][0]
    optimizer = make_optimizer("sgd", 0.0, params=port.parameters())
    step = make_train_step(port, PIT1d(NegSISDR(), n_sources=2), optimizer, compute_dtype)
    loss = float(step(torch.from_numpy(mixture), torch.from_numpy(sources)))
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)) for k, p in
             port.named_parameters()}
    for k, p in port.named_parameters():
        frozen = config.get("rnn_type") == "lstm" and k.split(".")[-1].startswith("bias_hh")
        assert (p.grad is None) == frozen, k
    return loss, grads


def _assert_grads_match(grads, j_grads):
    assert sorted(grads) == sorted(j_grads)
    for k, g in j_grads.items():
        got, g = grads[k].numpy(), g.numpy()
        assert got.shape == g.shape, k
        assert np.abs(got - g).max() <= 1e-3 * np.abs(g).max(), (k, np.abs(g).max())


@pytest.mark.parametrize("name", list(MODELS))
def test_train_step_matches_jax(monkeypatch, name):
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", "1")
    jmodel, variables, port, mixture, sources = _pair(name, seed=3)
    j_loss, j_grads = _jax_loss_and_grads(name, jmodel, variables, mixture, sources)
    loss, grads = _port_loss_and_grads(name, port, mixture, sources)
    assert abs(loss - j_loss) <= 1e-5 * abs(j_loss), (loss, j_loss)
    _assert_grads_match(grads, j_grads)


@pytest.mark.parametrize("name", ["dprnn-tasnet-gru", "dprnn-tasnet-gru-causal"])
def test_gru_train_step_matches_the_jax_lax_scan_gru(monkeypatch, name):
    # The JAX GRU without Pallas: every recurrence a lax.scan, differentiated by JAX.
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", "0")
    jmodel, variables, port, mixture, sources = _pair(name, seed=6)
    j_loss, j_grads = _jax_loss_and_grads(name, jmodel, variables, mixture, sources)
    loss, grads = _port_loss_and_grads(name, port, mixture, sources)
    assert abs(loss - j_loss) <= 1e-5 * abs(j_loss), (loss, j_loss)
    _assert_grads_match(grads, j_grads)


def _flat(grads) -> np.ndarray:
    """Every gradient, in name order, as one f32 vector."""
    return np.concatenate([grads[k].float().numpy().ravel() for k in sorted(grads)])


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("name", ["conv-tasnet", "dprnn-tasnet", "dprnn-tasnet-gru",
                                  "dprnn-tasnet-gru-causal"])
def test_bf16_train_step_stays_close_to_jax(monkeypatch, name):
    """compute_dtype=bf16 on both sides: f32 masters cast inside the step.

    The two round at other places (JAX's bf16 dots return bf16 and its
    causal GRU runs its lax.scan in bf16; the port decodes in f32 and carries
    the LSTM and GRU state in f32), and single bf16
    gradients of summed parameters are noise-dominated on both sides (JAX's
    own Conv-TasNet PReLU-slope gradient is 2x off its f32 one), so the
    check is on the whole gradient vector: within 15% (relative L2) of JAX's
    bf16 one, and no further from the f32 step's gradient than 1.5x JAX's
    bf16 gradient is. The loss is held to 1%.
    """
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", "1")
    jmodel, variables, port, mixture, sources = _pair(name, seed=4)
    j_loss, j_grads = _jax_loss_and_grads(name, jmodel, variables, mixture, sources,
                                          jnp.bfloat16)
    _, f32_grads = _port_loss_and_grads(name, port, mixture, sources)
    loss, grads = _port_loss_and_grads(name, port, mixture, sources, torch.bfloat16)
    assert abs(loss - j_loss) <= 1e-2 * abs(j_loss), (loss, j_loss)
    got, ref, exact = _flat(grads), _flat(j_grads), _flat(f32_grads)
    assert _rel(got, ref) <= 0.15, _rel(got, ref)
    assert _rel(got, exact) <= 1.5 * _rel(ref, exact), (_rel(got, exact), _rel(ref, exact))
    for p in port.parameters():
        assert p.dtype == torch.float32  # the masters stay f32


def test_lstm_bias_trains_as_jax_one_bias():
    """Five Adam steps: the port's bias_ih + bias_hh must move as JAX's b does.

    Both nn.LSTM biases receive the gradient of b; if both trained, Adam would
    give each a full step and their sum would move twice as far as b (about
    5e-3 here, against the 1e-4 allowed). Adam's first step is about
    lr * sign(g) whatever |g|, so elements whose gradient is at the rounding
    level of the sums (below 1e-3 x max|g|) are left out; they are few.
    """
    F, H = 6, 8
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, F)).astype(np.float32)
    target = rng.standard_normal((3, 7, 2 * H)).astype(np.float32)
    port = LSTM(F, H, bidirectional=True, generator=torch.Generator().manual_seed(1))
    jparams = lstm_params({k: v.detach() for k, v in port.state_dict().items()}, "",
                          bidirectional=True)
    jmodel = jrnn.LSTM(hidden_size=H, bidirectional=True)
    bias_hh = {k: v.detach().clone() for k, v in port.named_parameters() if "bias_hh" in k}

    optimizer = make_optimizer("adam", 1e-3, params=port.parameters())
    step = make_train_step(port, lambda est, tgt: (est - tgt).square().mean(), optimizer)
    jopt = jax_make_optimizer("adam", 1e-3)
    state = jopt.init(jparams)

    def jloss(p):
        return jnp.mean(jnp.square(jmodel.apply({"params": p}, jnp.asarray(x)) - target))

    first = jax.grad(jloss)(jparams)
    for _ in range(5):
        step(torch.from_numpy(x), torch.from_numpy(target))
        updates, state = jopt.update(jax.grad(jloss)(jparams), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    for sfx in ("_l0", "_l0_reverse"):
        torch.testing.assert_close(getattr(port, f"bias_hh{sfx}"), bias_hh[f"bias_hh{sfx}"],
                                   rtol=0, atol=0)
        total = (getattr(port, f"bias_ih{sfx}") + getattr(port, f"bias_hh{sfx}")).detach()
        g = np.abs(np.asarray(first[f"b{sfx}"]))
        kept = g > 1e-3 * g.max()
        assert kept.mean() > 0.9
        np.testing.assert_allclose(total.numpy()[kept], np.asarray(jparams[f"b{sfx}"])[kept],
                                   rtol=0, atol=1e-4)


def test_jax_train_step_runs_on_the_same_pair(monkeypatch):
    # The JAX package's own jitted step takes the pair the comparisons above
    # use and returns the loss the port's step returns.
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", "0")
    jmodel, variables, port, mixture, sources = _pair("conv-tasnet", seed=5)
    jopt = optax.sgd(0.0)
    step = jax_make_train_step(jmodel, JPIT1d(JNegSISDR(), n_sources=2), jopt, donate=False)
    params = jax.tree_util.tree_map(jnp.asarray, variables)
    _, _, j_loss = step(params, jopt.init(params["params"]), jnp.asarray(mixture),
                        jnp.asarray(sources))
    loss, _ = _port_loss_and_grads("conv-tasnet", port, mixture, sources)
    assert abs(loss - float(j_loss)) <= 1e-5 * abs(float(j_loss))
