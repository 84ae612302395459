"""Port's Conv-TasNet against the JAX package: forward, fold, weights, checkpoints (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.hub import conv_tasnet_state_dict_from_jax
from dnn_based_source_separation_torch.models import ConvTasNet
from dnn_based_source_separation_torch.models.base import load_model, save_model
from dnn_based_source_separation_torch.models.fold import fold_for_serving, fold_gln_affine
from dnn_based_source_separation_tpu.hub.torch_convert import (
    build_from_torch_checkpoint, convert_conv_tasnet,
)
from dnn_based_source_separation_tpu.models import ConvTasNet as JConvTasNet
from dnn_based_source_separation_tpu.models.fold import fold_gln_affine as jax_fold

ATOL = 1e-4
CFG = dict(
    n_basis=16, kernel_size=8, stride=4, enc_nonlinear="relu", sep_num_blocks=2,
    sep_num_layers=3, sep_hidden_channels=20, sep_bottleneck_channels=12,
    sep_skip_channels=12, causal=False, n_sources=2,
)
PAPER = dict(
    n_basis=512, kernel_size=16, stride=8, enc_nonlinear="relu", sep_hidden_channels=512,
    sep_bottleneck_channels=128, sep_skip_channels=128, sep_kernel_size=3,
    sep_num_blocks=3, sep_num_layers=8, causal=False, n_sources=2,
)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scramble(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _scramble(v, rng)
            continue
        v = np.asarray(v)
        if k == "gamma":
            v = 0.5 + rng.random(v.shape)
        elif k in ("beta", "bias"):
            v = 0.3 * rng.standard_normal(v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


def _pair(config, T, seed=0, batch=2):
    """(jax model, jax variables (numpy), port model, input (B, 1, T)) with one set of weights."""
    x = np.random.default_rng(seed).standard_normal((batch, 1, T)).astype(np.float32)
    jmodel = JConvTasNet(**config)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(seed),
                                                               jnp.asarray(x)))
    variables = {"params": _scramble(variables["params"], np.random.default_rng(seed))}
    port = ConvTasNet(**config).eval()
    port.load_state_dict(conv_tasnet_state_dict_from_jax(variables, config))
    return jmodel, variables, port, x


def _forward(port, x):
    with torch.no_grad():
        return port(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_jax(causal):
    config = dict(CFG, causal=causal)
    jmodel, variables, port, x = _pair(config, T=643)  # off the stride grid: pads
    expected = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    got = _forward(port, x)
    assert got.shape == expected.shape == (2, 2, 643)
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)


def test_extract_latent_matches_jax():
    jmodel, variables, port, x = _pair(dict(CFG, mask_nonlinear="softmax"), T=402, seed=1)
    j_out, j_latent = jax.jit(lambda v, x: jmodel.apply(v, x, method=jmodel.extract_latent))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        out, latent = port.extract_latent(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0, atol=ATOL)
    np.testing.assert_allclose(latent.numpy(), np.asarray(j_latent), rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["heads", "all"])
def test_fold_matches_jax(mode):
    jmodel, variables, port, x = _pair(CFG, T=640, seed=2)
    jfolded, jvars = jax_fold(jmodel, variables, mode=mode)
    expected = np.asarray(jax.jit(jfolded.apply)(jvars, jnp.asarray(x)))

    folded, sd = fold_gln_affine(port, port.state_dict(), mode=mode)
    assert folded.fold_norm_affine == mode
    jvars_np = jax.tree_util.tree_map(np.asarray, jvars)
    for k, v in conv_tasnet_state_dict_from_jax(jvars_np, CFG).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(_forward(folded, x), expected, rtol=0, atol=ATOL)
    np.testing.assert_allclose(_forward(folded, x), _forward(port, x), rtol=0, atol=ATOL)


@pytest.mark.parametrize("variant,folds", [
    (dict(), True),
    (dict(causal=True), False),
    (dict(fold_norm_affine="heads"), False),
    (dict(separable=False), False),
    (dict(separable=False, sep_norm=False), True),
], ids=["non-causal", "causal", "saved-folded", "non-separable", "non-separable-no-norm"])
def test_fold_for_serving_folds_where_the_cli_folds(variant, folds):
    port = ConvTasNet(**dict(CFG, **variant), generator=torch.Generator().manual_seed(0))
    served = fold_for_serving(port)
    assert (served is not port) == folds
    if folds:
        assert served.fold_norm_affine == "heads"
        x = np.random.default_rng(0).standard_normal((2, 1, 203)).astype(np.float32)
        np.testing.assert_allclose(_forward(served, x), _forward(port, x), rtol=0, atol=ATOL)


def test_fold_refuses_folded_and_causal_models():
    port = ConvTasNet(**CFG, generator=torch.Generator().manual_seed(0))
    folded, sd = fold_gln_affine(port, port.state_dict())
    with pytest.raises(ValueError, match="already folded"):
        fold_gln_affine(folded, sd)
    causal = ConvTasNet(**dict(CFG, causal=True))
    with pytest.raises(ValueError, match="non-causal"):
        fold_gln_affine(causal, causal.state_dict())
    before = {k: v.clone() for k, v in port.state_dict().items()}
    fold_gln_affine(port, port.state_dict(), mode="all")
    for k, v in port.state_dict().items():  # the input is never mutated
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_state_dict_round_trips_the_jax_tree_bit_exactly(causal):
    config = dict(CFG, causal=causal)
    _, variables, port, _ = _pair(config, T=320, seed=3)
    back = convert_conv_tasnet(port.state_dict(), config)
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=str(path))
        assert np.asarray(flat_b[path]).shape == leaf.shape


def test_port_checkpoint_opens_in_jax(tmp_path):
    _, _, port, x = _pair(CFG, T=517, seed=4)
    path = str(tmp_path / "model.pth")
    save_model(path, port)
    jmodel, jparams = build_from_torch_checkpoint(path)
    expected = np.asarray(jax.jit(jmodel.apply)(jparams, jnp.asarray(x)))
    np.testing.assert_allclose(_forward(port, x), expected, rtol=0, atol=ATOL)

    loaded = load_model(path)
    assert loaded.get_config() == port.get_config()
    np.testing.assert_array_equal(_forward(loaded, x), _forward(port, x))


def test_generator_initialisation_is_reproducible():
    a = ConvTasNet(**CFG, generator=torch.Generator().manual_seed(7))
    b = ConvTasNet(**CFG, generator=torch.Generator().manual_seed(7))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    jmodel = JConvTasNet(**CFG)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 320)))
    assert a.num_parameters() == sum(p.size for p in jax.tree_util.tree_leaves(jparams))


@pytest.mark.parametrize("basis", [
    dict(n_basis=17, enc_basis="Fourier", dec_basis="Fourier"),
    dict(dec_basis="pinv"),
], ids=["fourier", "pinv"])
def test_complex_and_pinv_filterbanks_are_not_ported(basis):
    # Both are ported now: the complex latent (masked on its magnitude, its
    # phase kept) and the pinv decode match JAX; extract_latent returns the
    # masked latent, complex for the Fourier encoder.
    config = dict(CFG, **basis)
    jmodel, variables, port, x = _pair(config, T=402, seed=3)
    j_out, j_latent = jax.jit(lambda v, x: jmodel.apply(v, x, method=jmodel.extract_latent))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        out, latent = port.extract_latent(torch.from_numpy(x))
    assert latent.is_complex() == np.iscomplexobj(j_latent)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0, atol=ATOL)
    np.testing.assert_allclose(latent.numpy(), np.asarray(j_latent), rtol=0, atol=ATOL)
    assert port.num_parameters() == sum(a.size for a in jax.tree_util.tree_leaves(variables))


@pytest.mark.slow
def test_paper_config_forward_matches_jax():
    jmodel, variables, port, x = _pair(PAPER, T=4000, seed=5, batch=1)  # 0.5 s at 8 kHz
    expected = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    np.testing.assert_allclose(_forward(port, x), expected, rtol=0, atol=ATOL)
