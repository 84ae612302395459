"""Port's LSTM-TasNet against the JAX package: separator norm, model, streaming, weights (CPU).

JAX weights (a non-identity norm affine, non-zero biases) go into the port
through `hub/from_jax.py:lstm_tasnet_state_dict_from_jax`; the separator and
the whole model, with the gated and the trainable encoder, causal and not,
softmax and sigmoid masks (and a GRU stack), run on the same inputs as their
JAX counterparts and must agree within 1e-4 x max|ref| in f32. The JAX
references run under `jax.jit` on the `lax.scan` recurrences
(`DNNTPU_PALLAS_LSTM=0`). The gradient of a PIT SI-SDR loss for every
parameter is held to 1e-4 x max|g| of its tensor; the state dict round-trips
JAX's tree bit for bit through `convert_lstm_tasnet`; a port checkpoint
reopens in the port and in JAX. Exact streaming of causal LSTM-TasNet with the
trainable encoder matches the port's offline output and JAX's
`ExactStreamingSeparator`, and refuses the gated encoder and a non-causal model
as JAX does. `TasNetBase` (the Fourier harness) matches JAX's. The recipe
config's parameter count matches `jax.eval_shape` of JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.criterion import NegSISDR, PIT1d
from dnn_based_source_separation_torch.hub import lstm_tasnet_state_dict_from_jax
from dnn_based_source_separation_torch.hub.from_jax import _filterbank
from dnn_based_source_separation_torch.models import LSTMTasNet, TasNet, TasNetBase
from dnn_based_source_separation_torch.models.base import load_model, save_model
from dnn_based_source_separation_torch.models.lstm_tasnet import Separator
from dnn_based_source_separation_torch.models.streaming import ExactStreamingSeparator
from dnn_based_source_separation_tpu.criterion import NegSISDR as JNegSISDR
from dnn_based_source_separation_tpu.criterion import PIT1d as JPIT1d
from dnn_based_source_separation_tpu.hub.torch_convert import (
    build_from_torch_checkpoint, convert_lstm_tasnet,
)
from dnn_based_source_separation_tpu.models import LSTMTasNet as JLSTMTasNet
from dnn_based_source_separation_tpu.models import TasNetBase as JTasNetBase
from dnn_based_source_separation_tpu.models.lstm_tasnet import Separator as JSeparator
from dnn_based_source_separation_tpu.models.streaming import (
    ExactStreamingSeparator as JExactStreamingSeparator,
)

TOL = 1e-4  # x max|ref|, f32
N, H, BLOCKS, LAYERS = 16, 16, 2, 2
CFG = dict(n_basis=N, kernel_size=8, stride=4, sep_num_blocks=BLOCKS, sep_num_layers=LAYERS,
           sep_hidden_channels=H, n_sources=2)
T = 203  # off the stride grid: pads 1, T' = 50


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", "0")


def _scramble(tree, rng):
    """Non-identity norm affine and non-zero biases, so every parameter matters."""
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


@pytest.fixture(scope="module")
def pair():
    """(causal, enc_basis, mask_nonlinear, rnn_type) -> (config, jax model, jax variables
    (numpy), port model (eval)), each made once for the module."""
    made = {}

    def make(causal, enc_basis="trainableGated", mask_nonlinear="softmax", rnn_type="lstm"):
        key = (causal, enc_basis, mask_nonlinear, rnn_type)
        if key not in made:
            config = dict(CFG, causal=causal, enc_basis=enc_basis,
                          mask_nonlinear=mask_nonlinear, rnn_type=rnn_type)
            jmodel = JLSTMTasNet(**config)
            variables = jax.jit(jmodel.init)(jax.random.PRNGKey(int(causal)),
                                             jnp.zeros((1, 1, T)))
            variables = {"params": _scramble(
                jax.tree_util.tree_map(np.asarray, variables["params"]),
                np.random.default_rng(len(made)))}
            port = LSTMTasNet(**config).eval()
            port.load_state_dict(lstm_tasnet_state_dict_from_jax(variables, config))
            made[key] = config, jmodel, variables, port
        return made[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DNNTPU_PALLAS_LSTM", "0")
        yield make


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), np.abs(got - ref).max()


def _apply(jmodule, variables, x):
    return np.asarray(jax.jit(jmodule.apply)(variables, jnp.asarray(x)))


def _port(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(x)).numpy()


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_separator_norm_is_the_references():
    """gamma (x - mean) / (sqrt(mean(x^2) - mean^2) + eps) + beta, eps outside the root."""
    sep = Separator(N, num_blocks=1, num_layers=1, hidden_channels=4, eps=1e-3)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        sep.gamma.copy_(torch.from_numpy(0.5 + rng.random(N).astype(np.float32)))
        sep.beta.copy_(torch.from_numpy(rng.standard_normal(N).astype(np.float32)))
    for x in (_x((2, 5, N), 1), np.abs(_x((2, 5, N), 2)) + 1.0):
        xd = x.astype(np.float64)
        mean = xd.mean(-1, keepdims=True)
        var = (xd ** 2).mean(-1, keepdims=True) - mean ** 2
        want = sep.gamma.detach().double().numpy() * (xd - mean) / (np.sqrt(var) + 1e-3) \
            + sep.beta.detach().double().numpy()
        with torch.no_grad():
            got = sep._norm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max())
    # bf16 input: the statistics are f32, the output bf16.
    with torch.no_grad():
        assert sep.bfloat16()._norm(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


@pytest.mark.parametrize("causal", [False, True])
def test_separator_matches_jax(pair, causal):
    _, _, variables, port = pair(causal)
    jsep = JSeparator(n_basis=N, num_blocks=BLOCKS, num_layers=LAYERS, hidden_channels=H,
                      causal=causal)
    x = np.abs(_x((2, 37, N), seed=3))  # (B, T', N), non-negative as the gated latent is
    masks = _port(port.separator, x)
    assert masks.shape == (2, 2, 37, N)
    _close(masks, _apply(jsep, {"params": variables["params"]["separator"]}, x))


@pytest.mark.parametrize("enc_basis", ["trainableGated", "trainable"])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_jax(pair, causal, enc_basis):
    _, jmodel, variables, port = pair(causal, enc_basis)
    x = _x((2, 1, T), seed=4)
    got = _port(port, x)
    assert got.shape == (2, 2, T)
    _close(got, _apply(jmodel, variables, x))


@pytest.mark.parametrize("mask_nonlinear,rnn_type", [("sigmoid", "lstm"), ("softmax", "gru")])
def test_sigmoid_masks_and_gru_match_jax(pair, mask_nonlinear, rnn_type):
    _, jmodel, variables, port = pair(False, "trainableGated", mask_nonlinear, rnn_type)
    x = _x((1, 1, 157), seed=5)
    _close(_port(port, x), _apply(jmodel, variables, x))


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax(pair, causal):
    config, jmodel, variables, port = pair(causal)
    rng = np.random.default_rng(6)
    sources = 0.3 * rng.standard_normal((2, 2, 160)).astype(np.float32)
    mixture = sources.sum(axis=1, keepdims=True)
    jcriterion = JPIT1d(JNegSISDR(), n_sources=2)

    def loss_fn(p):
        est = jmodel.apply({"params": p}, jnp.asarray(mixture))
        return jcriterion(est, jnp.asarray(sources))[0]

    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    j_grads = lstm_tasnet_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, j_grads),
                                              config)
    port.train()
    try:
        port.zero_grad()
        loss = PIT1d(NegSISDR(), n_sources=2)(port(torch.from_numpy(mixture)),
                                               torch.from_numpy(sources))[0]
        loss.backward()
    finally:
        port.eval()
    assert abs(float(loss.detach()) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    named = dict(port.named_parameters())
    assert sorted(named) == sorted(j_grads)
    for name, g in j_grads.items():
        p = named[name]
        frozen = name.rsplit(".", 1)[-1].startswith("bias_hh")
        assert (p.grad is None) == frozen, name
        _close((torch.zeros_like(p) if frozen else p.grad).numpy(), g.numpy())
        p.grad = None


@pytest.mark.parametrize("enc_basis", ["trainableGated", "trainable"])
@pytest.mark.parametrize("causal", [False, True])
def test_state_dict_round_trips_the_jax_tree_bit_exactly(pair, causal, enc_basis):
    config, _, variables, port = pair(causal, enc_basis)
    back = convert_lstm_tasnet(port.state_dict(), config)
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=str(path))


@pytest.mark.parametrize("causal", [False, True])
def test_checkpoint_reopens_in_the_port_and_in_jax(pair, tmp_path, causal):
    _, _, _, port = pair(causal)
    path = str(tmp_path / "lstm_tasnet.ckpt")
    save_model(path, port)
    loaded = load_model(path)
    assert type(loaded) is LSTMTasNet and loaded.get_config() == port.get_config()
    x = _x((1, 1, T), seed=7)
    np.testing.assert_array_equal(_port(loaded, x), _port(port, x))
    jmodel, jparams = build_from_torch_checkpoint(path)
    assert type(jmodel) is JLSTMTasNet and jmodel.causal == causal
    _close(_port(port, x), _apply(jmodel, jparams, x))


def _stream(stream, x, hop):
    outs = [stream.process(x[lo:lo + hop]) for lo in range(0, len(x) // hop * hop, hop)]
    return outs


@pytest.mark.parametrize("hop", [400, 160])
def test_exact_streaming_matches_offline_and_jax(pair, hop):
    _, jmodel, variables, port = pair(True, "trainable")
    x = 0.5 * _x((4000,), seed=8)
    offline = _port(port, x[None, None])[0]
    stream = ExactStreamingSeparator(port, hop_samples=hop)
    got = torch.cat(_stream(stream, x, hop) + [stream.flush()], dim=-1).numpy()
    assert got.shape == offline.shape
    assert np.abs(got - offline).max() <= 1e-5 * np.abs(offline).max()
    jstream = JExactStreamingSeparator(jmodel, variables, hop_samples=hop)
    j_outs = [np.asarray(jstream.process(x[lo:lo + hop])) for lo in range(0, 4000, hop)]
    j_got = np.concatenate(j_outs + [np.asarray(jstream.flush())], axis=-1)
    _close(got, j_got)
    # finish() drains a last partial block on the stride grid, as the offline pad does.
    stream.reset()
    n = 3 * hop + 44  # 44 = 40 + 4: on the grid of L = 8, S = 4
    head = torch.cat(_stream(stream, x[:n], hop) + [stream.finish(x[n // hop * hop:n])], -1)
    np.testing.assert_allclose(head.numpy(), _port(port, x[None, None, :n])[0], rtol=0,
                               atol=1e-5 * np.abs(offline).max())


def test_streaming_refusals_match_jax(pair):
    for key, error in (((True, "trainableGated"), NotImplementedError),
                       ((False, "trainable"), ValueError)):
        _, jmodel, variables, port = pair(*key)
        with pytest.raises(error) as port_error:
            ExactStreamingSeparator(port, hop_samples=400)
        with pytest.raises(error) as jax_error:
            JExactStreamingSeparator(jmodel, variables, hop_samples=400)
        assert str(port_error.value) == str(jax_error.value)


@pytest.mark.parametrize("trainable", [False, True])
def test_tasnet_base_matches_jax(trainable):
    config = dict(hidden_channels=9, kernel_size=16, enc_trainable=trainable,
                  dec_trainable=trainable)
    jmodel = JTasNetBase(**config)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, T))))
    if trainable:  # move the frequencies off their initial DFT grid
        rng = np.random.default_rng(9)
        for part in ("encoder", "decoder"):
            f = variables["params"][part]["frequency"]
            variables["params"][part]["frequency"] = (f + 0.01 * rng.standard_normal(f.shape)
                                                      ).astype(np.float32)
    port = TasNetBase(**config)
    sd = {}
    _filterbank(sd, variables["params"], 1)
    port.load_state_dict({k: v for k, v in sd.items()})
    x = _x((2, 1, T), seed=10)
    with torch.no_grad():
        out, latent = port.extract_latent(torch.from_numpy(x))
    j_out, j_latent = jax.jit(lambda v, a: jmodel.apply(v, a, method="extract_latent"))(
        variables, jnp.asarray(x))
    _close(out.numpy(), np.asarray(j_out))
    _close(latent.numpy(), np.asarray(j_latent))
    assert out.shape == (2, 1, T) and torch.is_complex(latent)
    if not trainable:  # the fixed Fourier pair reconstructs the input away from its ends
        np.testing.assert_allclose(out.numpy()[..., 16:-16], x[..., 16:-16], rtol=0, atol=1e-4)


def test_alias_generator_and_parameter_counts(pair):
    assert TasNet is LSTMTasNet
    a = LSTMTasNet(**CFG, generator=torch.Generator().manual_seed(7))
    b = LSTMTasNet(**CFG, generator=torch.Generator().manual_seed(7))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    _, _, variables, _ = pair(False)
    n_lstm_bias = sum(p.numel() for n, p in a.named_parameters() if "bias_hh" in n)
    assert a.num_parameters() == sum(np.size(p) for p in jax.tree_util.tree_leaves(variables)) \
        + n_lstm_bias


@pytest.mark.parametrize("causal", [False, True])
def test_recipe_parameter_count_matches_jax(causal):
    """egs/wsj0-mix/lstm-tasnet/train.sh: N500 L40, the gated encoder, 2 x 2 layers, H500."""
    config = dict(n_basis=500, kernel_size=40, enc_basis="trainableGated",
                  sep_num_blocks=2, sep_num_layers=2, sep_hidden_channels=500,
                  mask_nonlinear="softmax", causal=causal)
    shapes = jax.eval_shape(JLSTMTasNet(**config).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 1, 800)))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    port = LSTMTasNet(**config, device="meta")
    n_lstm_bias = sum(p.numel() for n, p in port.named_parameters() if "bias_hh" in n)
    assert port.num_parameters() == n_jax + n_lstm_bias
