"""Port's DPRNN-TasNet against the JAX package: forward, weights, checkpoints (CPU).

The JAX side runs both of its recurrence paths: `DNNTPU_PALLAS_LSTM=0`
(`lax.scan`) and `=1` (the Pallas kernels in interpret mode). Forward
parity is held at atol 1e-4 in f32, the repo's parity tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.hub import dprnn_tasnet_state_dict_from_jax
from dnn_based_source_separation_torch.models import DPRNNTasNet
from dnn_based_source_separation_torch.models.base import load_model, save_model
from dnn_based_source_separation_tpu.hub.torch_convert import (
    build_from_torch_checkpoint, convert_dprnn_tasnet,
)
from dnn_based_source_separation_tpu.models import DPRNNTasNet as JDPRNNTasNet

ATOL = 1e-4
CFG = dict(
    n_basis=16, kernel_size=4, enc_nonlinear="relu", sep_bottleneck_channels=8,
    sep_hidden_channels=12, sep_chunk_size=10, sep_hop_size=5, sep_num_blocks=2,
    causal=False, n_sources=2,
)
# egs/wsj0-mix/dprnn-tasnet/train.sh:22 with the CLI defaults (cli/train_wsj0mix.py:41-70).
RECIPE = dict(
    n_basis=64, kernel_size=2, enc_nonlinear="relu", sep_bottleneck_channels=64,
    sep_hidden_channels=128, sep_chunk_size=250, sep_hop_size=125, sep_num_blocks=6,
    causal=False, n_sources=2,
)


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
        elif k == "beta" or k == "bias" or k.startswith("b_"):
            v = 0.3 * rng.standard_normal(v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


def _pair(config, T, seed=0, batch=2):
    """(jax model, jax variables (numpy), port model, input (B, 1, T)) with one set of weights."""
    x = np.random.default_rng(seed).standard_normal((batch, 1, T)).astype(np.float32)
    jmodel = JDPRNNTasNet(**config)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(seed),
                                                               jnp.asarray(x)))
    variables = {"params": _scramble(variables["params"], np.random.default_rng(seed))}
    port = DPRNNTasNet(**config).eval()
    port.load_state_dict(dprnn_tasnet_state_dict_from_jax(variables, config))
    return jmodel, variables, port, x


def _forward(port, x):
    with torch.no_grad():
        return port(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("pallas", ["0", "1"])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_jax(monkeypatch, causal, pallas):
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", pallas)
    config = dict(CFG, causal=causal)
    # T=203: T' = 100 latent frames, off the (K=10, P=5) chunk grid: pads 5.
    jmodel, variables, port, x = _pair(config, T=203, seed=int(pallas) + 2 * causal)
    expected = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    got = _forward(port, x)
    assert got.shape == expected.shape == (2, 2, 203)
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)


@pytest.mark.parametrize("mask_nonlinear", ["softmax", "relu"])
def test_extract_latent_and_other_masks_match_jax(mask_nonlinear):
    jmodel, variables, port, x = _pair(dict(CFG, mask_nonlinear=mask_nonlinear), T=157, seed=5)
    j_out, j_latent = jax.jit(lambda v, x: jmodel.apply(v, x, method=jmodel.extract_latent))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        out, latent = port.extract_latent(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0, atol=ATOL)
    np.testing.assert_allclose(latent.numpy(), np.asarray(j_latent), rtol=0, atol=ATOL)


def test_masks_are_a_strided_view_for_the_decode_kernel():
    _, _, port, x = _pair(CFG, T=120, seed=6)
    with torch.no_grad():
        w = port.encoder(torch.from_numpy(x).transpose(1, 2))
        mask = port.separator(w)
    B, Tp, N = w.shape
    assert mask.shape == (B, 2, Tp, N) and not mask.is_contiguous()
    assert mask.stride() == (Tp * 2 * N, N, 2 * N, 1)


@pytest.mark.parametrize("causal", [False, True])
def test_state_dict_round_trips_the_jax_tree_bit_exactly(causal):
    config = dict(CFG, causal=causal)
    _, variables, port, _ = _pair(config, T=120, seed=3)
    back = convert_dprnn_tasnet(port.state_dict(), config)
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=str(path))
        assert np.asarray(flat_b[path]).shape == leaf.shape


@pytest.mark.parametrize("causal", [False, True])
def test_port_checkpoint_opens_in_jax(tmp_path, causal):
    # Random port weights with separate b_ih and b_hh: the JAX side sums them.
    config = dict(CFG, causal=causal)
    port = DPRNNTasNet(**config, generator=torch.Generator().manual_seed(4)).eval()
    x = np.random.default_rng(4).standard_normal((2, 1, 181)).astype(np.float32)
    path = str(tmp_path / "model.pth")
    save_model(path, port)
    jmodel, jparams = build_from_torch_checkpoint(path)
    assert type(jmodel).__name__ == "DPRNNTasNet" and jmodel.causal == causal
    expected = np.asarray(jax.jit(jmodel.apply)(jparams, jnp.asarray(x)))
    np.testing.assert_allclose(_forward(port, x), expected, rtol=0, atol=ATOL)

    loaded = load_model(path)
    assert type(loaded) is DPRNNTasNet and loaded.get_config() == port.get_config()
    np.testing.assert_array_equal(_forward(loaded, x), _forward(port, x))


def test_generator_initialisation_is_reproducible():
    a = DPRNNTasNet(**CFG, generator=torch.Generator().manual_seed(7))
    b = DPRNNTasNet(**CFG, generator=torch.Generator().manual_seed(7))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    jmodel = JDPRNNTasNet(**CFG)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 120)))
    n_jax = sum(p.size for p in jax.tree_util.tree_leaves(jparams))
    # The port keeps nn.LSTM's two biases where JAX keeps their sum.
    n_lstm_bias = sum(p.numel() for n, p in a.named_parameters() if "bias_hh" in n)
    assert a.num_parameters() == n_jax + n_lstm_bias


def test_unported_options_raise():
    # 'rnn' and 'sru' are ported (tests/test_torch_rnn_sru.py); an unknown type still raises.
    with pytest.raises(NotImplementedError, match="transformer"):
        DPRNNTasNet(**CFG, rnn_type="transformer")
    with pytest.raises(ValueError):
        DPRNNTasNet(**CFG, mask_nonlinear="tanh")


def test_stream_safe_requires_causal():
    with pytest.raises(ValueError, match="causal"):
        DPRNNTasNet(**dict(CFG, causal=False), stream_safe=True)


@pytest.mark.parametrize("pallas", ["0", "1"])
@pytest.mark.parametrize("causal", [False, True])
def test_gru_forward_matches_jax(monkeypatch, causal, pallas):
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", pallas)
    config = dict(CFG, causal=causal, rnn_type="gru")
    jmodel, variables, port, x = _pair(config, T=203, seed=10 + int(pallas) + 2 * causal)
    expected = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    got = _forward(port, x)
    assert got.shape == expected.shape == (2, 2, 203)
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)


@pytest.mark.parametrize("pallas", ["0", "1"])
@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_stream_safe_forward_matches_jax(monkeypatch, rnn_type, pallas):
    # The serving profile: time-major cLNs and the constant K - P left pad.
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", pallas)
    config = dict(CFG, causal=True, stream_safe=True, rnn_type=rnn_type)
    jmodel, variables, port, x = _pair(config, T=203, seed=20 + int(pallas))
    expected = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    got = _forward(port, x)
    assert got.shape == expected.shape == (2, 2, 203)
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_stream_safe_jax_tree_sets_every_port_parameter(rnn_type):
    # The intra-chunk norm of a stream-safe tree is CumulativeLayerNorm_0:
    # every port parameter, its affine included, must come from the tree.
    config = dict(CFG, causal=True, stream_safe=True, rnn_type=rnn_type)
    _, variables, port, _ = _pair(config, T=120, seed=30)
    sd = dprnn_tasnet_state_dict_from_jax(variables, config)
    assert set(sd) == set(port.state_dict())
    intra = variables["params"]["separator"]["dprnn"]["block1"]["intra_chunk_block"]
    np.testing.assert_array_equal(
        sd["separator.dprnn.net.1.intra_chunk_block.norm1d.gamma"].numpy().ravel(),
        intra["CumulativeLayerNorm_0"]["gamma"])
    assert not np.allclose(intra["CumulativeLayerNorm_0"]["gamma"], 1.0)


def test_converter_raises_when_the_config_names_a_missing_norm():
    # A stream-safe tree read as reference-parity: the intra gLN is not there.
    config = dict(CFG, causal=True, stream_safe=True)
    _, variables, _, _ = _pair(config, T=120, seed=31)
    with pytest.raises(KeyError, match="GlobalLayerNorm_0"):
        dprnn_tasnet_state_dict_from_jax(variables, dict(config, stream_safe=False))


@pytest.mark.parametrize("variant", [dict(rnn_type="gru", causal=False),
                                     dict(rnn_type="gru", causal=True),
                                     dict(rnn_type="lstm", causal=True, stream_safe=True),
                                     dict(rnn_type="gru", causal=True, stream_safe=True)],
                         ids=["gru", "gru-causal", "lstm-stream-safe", "gru-stream-safe"])
def test_port_checkpoint_round_trips(tmp_path, variant):
    port = DPRNNTasNet(**dict(CFG, **variant), generator=torch.Generator().manual_seed(5)).eval()
    x = np.random.default_rng(5).standard_normal((2, 1, 181)).astype(np.float32)
    path = str(tmp_path / "model.pth")
    save_model(path, port)
    loaded = load_model(path)
    assert type(loaded) is DPRNNTasNet and loaded.get_config() == port.get_config()
    np.testing.assert_array_equal(_forward(loaded, x), _forward(port, x))


@pytest.mark.slow
@pytest.mark.parametrize("causal", [False, True])
def test_recipe_config_forward_matches_jax(causal):
    config = dict(RECIPE, causal=causal)
    jmodel, variables, port, x = _pair(config, T=4000, seed=8, batch=1)  # 0.5 s at 8 kHz
    expected = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    np.testing.assert_allclose(_forward(port, x), expected, rtol=0, atol=ATOL)
