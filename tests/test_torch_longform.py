"""Port's long-form separation against the JAX package's (CPU).

`separate_longform` with and without the power-of-two chunk bucketing, on
an identity model, a single short chunk, tiny Conv-TasNet and tiny
DPRNN-TasNet with the same weights in both packages, at the repo's parity
tolerance 1e-4; and `cli/separate.py --chunk_duration` against the JAX CLI.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.cli import separate as tsep
from dnn_based_source_separation_torch.hub import (
    conv_tasnet_state_dict_from_jax, dprnn_tasnet_state_dict_from_jax,
)
from dnn_based_source_separation_torch.models import ConvTasNet, DPRNNTasNet
from dnn_based_source_separation_torch.models.base import save_model
from dnn_based_source_separation_torch.models.longform import chunk_count, separate_longform
from dnn_based_source_separation_tpu.cli import separate as jsep
from dnn_based_source_separation_tpu.data.audio_io import read_wav, write_wav
from dnn_based_source_separation_tpu.models import ConvTasNet as JConvTasNet
from dnn_based_source_separation_tpu.models import DPRNNTasNet as JDPRNNTasNet
from dnn_based_source_separation_tpu.models.base import save_model as jax_save_model
from dnn_based_source_separation_tpu.models.longform import (
    separate_longform as jax_separate_longform,
)

ATOL = 1e-4
WAV_STEP = 1.0 / 32768  # one 16-bit quantization step
CONV = dict(
    n_basis=16, kernel_size=8, stride=4, enc_nonlinear="relu", sep_hidden_channels=8,
    sep_bottleneck_channels=8, sep_skip_channels=8, sep_num_blocks=1, sep_num_layers=2,
    causal=False, n_sources=2,
)
DPRNN = dict(
    n_basis=16, kernel_size=4, enc_nonlinear="relu", sep_bottleneck_channels=8,
    sep_hidden_channels=8, sep_chunk_size=10, sep_hop_size=5, sep_num_blocks=2, n_sources=2,
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


def _pair(jcls, tcls, convert, config, seed=0):
    jmodel = jcls(**config)
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1, 512), jnp.float32)))
    variables = {"params": _scramble(variables["params"], np.random.default_rng(seed))}
    port = tcls(**config).eval()
    port.load_state_dict(convert(variables, config))
    return jmodel, variables, port


def _mixture(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(jax_apply, port_apply, x, chunk, bucket):
    expected = np.asarray(jax_separate_longform(jax_apply, None, jnp.asarray(x), chunk, 2,
                                                bucket=bucket))
    with torch.no_grad():
        got = separate_longform(port_apply, torch.from_numpy(x), chunk, 2, bucket=bucket)
    assert got.dtype == torch.float32
    return got.numpy(), expected


@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("chunk", [512, 511])
def test_identity_model_matches_jax_and_is_transparent(bucket, chunk):
    x = _mixture((1, 1, 3000), 0)
    got, expected = _both(lambda p, c: jnp.concatenate([c, c], axis=1),
                          lambda c: torch.cat([c, c], dim=1), x, chunk, bucket)
    assert got.shape == expected.shape == (1, 2, 3000)
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[:, 1], x[:, 0], rtol=0, atol=ATOL)


def test_short_input_is_one_chunk():
    x = _mixture((2, 1, 100), 2)
    assert chunk_count(100, 256) == 1
    got, expected = _both(lambda p, c: jnp.stack([c[:, 0], -c[:, 0]], axis=1),
                          lambda c: torch.stack([c[:, 0], -c[:, 0]], dim=1), x, 256, True)
    assert got.shape == (2, 2, 100)
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[:, 0], x[:, 0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("model", ["conv_tasnet", "dprnn_tasnet"])
def test_model_longform_matches_jax(model, bucket):
    if model == "conv_tasnet":
        jmodel, variables, port = _pair(JConvTasNet, ConvTasNet, conv_tasnet_state_dict_from_jax,
                                        CONV)
    else:
        jmodel, variables, port = _pair(JDPRNNTasNet, DPRNNTasNet,
                                        dprnn_tasnet_state_dict_from_jax, DPRNN, seed=1)
    # 7 real chunks of 512 at hop 256 cover 2000 samples; bucketed to 8, and the
    # eighth overlaps the seventh's second half, past 7 x 256 = 1792.
    assert (chunk_count(2000, 512, bucket=False), chunk_count(2000, 512)) == (7, 8)
    x = _mixture((1, 1, 2000), 3)
    got, expected = _both(lambda p, c: jmodel.apply(variables, c), port, x, 512, bucket)
    assert got.shape == expected.shape == (1, 2, 2000)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)


def test_bfloat16_longform_keeps_the_mixture_dtype():
    _, _, port = _pair(JConvTasNet, ConvTasNet, conv_tasnet_state_dict_from_jax, CONV)
    x = torch.from_numpy(_mixture((1, 1, 1500), 4))
    with torch.no_grad():
        f32 = separate_longform(port, x, 512, 2)
        bf16 = separate_longform(port.to(torch.bfloat16), x.to(torch.bfloat16), 512, 2)
    assert bf16.dtype == torch.bfloat16 and bf16.shape == f32.shape
    snr = 10 * torch.log10(f32.square().sum() / (bf16.float() - f32).square().sum())
    assert snr > 20.0, snr


def test_cli_chunk_duration_writes_the_same_wavs_as_jax(tmp_path):
    jmodel, variables, port = _pair(JConvTasNet, ConvTasNet, conv_tasnet_state_dict_from_jax,
                                    dict(CONV, causal=True))
    jax_ckpt, port_ckpt = str(tmp_path / "model.ckpt"), str(tmp_path / "model.pth")
    jax_save_model(jax_ckpt, jmodel, variables, {})
    save_model(port_ckpt, port)
    wav = str(tmp_path / "mix.wav")
    write_wav(wav, 0.1 * _mixture(4321, 5), 8000)
    args = ["--input", wav, "--chunk_duration", "0.1"]  # 800-sample chunks: 10 real, 16
    jsep.main(["--model_path", jax_ckpt, "--out_dir", str(tmp_path / "jax"), *args])
    est = tsep.main(["--model_path", port_ckpt, "--out_dir", str(tmp_path / "port"),
                     "--device", "cpu", *args])
    expected, got = (np.stack([read_wav(os.path.join(tmp_path, d, f"source{s}.wav"))[0]
                               for s in range(2)]) for d in ("jax", "port"))
    assert got.shape == expected.shape == est.shape == (2, 4321)
    assert np.abs(got - expected).max() <= 2 * WAV_STEP
