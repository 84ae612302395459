"""Port's separate CLI against the JAX CLI on the same weights (CPU)."""
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
from dnn_based_source_separation_torch.models.fold import fold_gln_affine
from dnn_based_source_separation_tpu.cli import separate as jsep
from dnn_based_source_separation_tpu.data.audio_io import read_wav, write_wav
from dnn_based_source_separation_tpu.models import ConvTasNet as JConvTasNet
from dnn_based_source_separation_tpu.models import DPRNNTasNet as JDPRNNTasNet
from dnn_based_source_separation_tpu.models.base import save_model as jax_save_model

CFG = dict(
    n_basis=16, kernel_size=8, stride=4, enc_nonlinear="relu", sep_num_blocks=2,
    sep_num_layers=3, sep_hidden_channels=20, sep_bottleneck_channels=12,
    sep_skip_channels=12, causal=False, n_sources=2,
)
DPRNN_CFG = dict(
    n_basis=16, kernel_size=4, enc_nonlinear="relu", sep_bottleneck_channels=8,
    sep_hidden_channels=12, sep_chunk_size=10, sep_hop_size=5, sep_num_blocks=2,
    n_sources=2,
)
WAV_STEP = 1.0 / 32768  # one 16-bit quantization step


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(jax checkpoint, port checkpoint, mixture wav) holding one set of weights."""
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    jmodel = JConvTasNet(**CFG)
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 320), jnp.float32)))
    params = variables["params"]
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = path[-1].key
        parent = params
        for p in path[:-1]:
            parent = parent[p.key]
        if name == "gamma":
            parent[name] = (0.5 + rng.random(leaf.shape)).astype(np.float32)
        elif name == "beta":
            parent[name] = rng.standard_normal(leaf.shape).astype(np.float32)
    jax_ckpt = str(tmp / "model.ckpt")
    jax_save_model(jax_ckpt, jmodel, variables, {})

    port = ConvTasNet(**CFG)
    port.load_state_dict(conv_tasnet_state_dict_from_jax(variables, CFG))
    port_ckpt = str(tmp / "model.pth")
    save_model(port_ckpt, port)

    wav = str(tmp / "mix.wav")
    write_wav(wav, 0.1 * rng.standard_normal(3001), 8000)
    return jax_ckpt, port_ckpt, wav, port


def _read_sources(out_dir):
    assert sorted(os.listdir(out_dir)) == ["source0.wav", "source1.wav"]
    return np.stack([read_wav(os.path.join(out_dir, f"source{s}.wav"))[0] for s in range(2)])


def test_separate_writes_the_same_wavs_as_jax(checkpoints, tmp_path):
    jax_ckpt, port_ckpt, wav, _ = checkpoints
    jsep.main(["--model_path", jax_ckpt, "--input", wav, "--out_dir", str(tmp_path / "jax")])
    est = tsep.main(["--model_path", port_ckpt, "--input", wav,
                     "--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    expected = _read_sources(tmp_path / "jax")
    got = _read_sources(tmp_path / "port")
    assert got.shape == expected.shape == (2, 3001) and est.shape == (2, 3001)
    assert np.abs(got - expected).max() <= 2 * WAV_STEP


def test_separate_leaves_a_folded_checkpoint_unfolded_again(checkpoints, tmp_path):
    _, port_ckpt, wav, port = checkpoints
    folded, _ = fold_gln_affine(port, port.state_dict(), mode="heads")
    folded_ckpt = str(tmp_path / "folded.pth")
    save_model(folded_ckpt, folded)
    a = tsep.main(["--model_path", port_ckpt, "--input", wav, "--out_dir",
                   str(tmp_path / "a"), "--device", "cpu"])
    b = tsep.main(["--model_path", folded_ckpt, "--input", wav, "--out_dir",
                   str(tmp_path / "b"), "--device", "cpu"])
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def test_separate_bfloat16_stays_close_to_float32(checkpoints, tmp_path):
    _, port_ckpt, wav, _ = checkpoints
    args = ["--model_path", port_ckpt, "--input", wav, "--device", "cpu"]
    f32 = tsep.main(args + ["--out_dir", str(tmp_path / "f32")])
    bf16 = tsep.main(args + ["--out_dir", str(tmp_path / "bf16"), "--dtype", "bfloat16"])
    assert np.isfinite(bf16).all()
    snr = 10 * np.log10(np.sum(f32 ** 2) / np.sum((bf16 - f32) ** 2))
    assert snr > 25.0, snr


@pytest.mark.parametrize("flag", [["--chunk_duration", "0.5"], ["--streaming_hop", "0.05"]])
def test_unported_serving_modes_raise(checkpoints, tmp_path, flag):
    _, port_ckpt, wav, _ = checkpoints
    with pytest.raises(NotImplementedError):
        tsep.main(["--model_path", port_ckpt, "--input", wav, "--out_dir", str(tmp_path),
                   "--device", "cpu", *flag])


def test_cuda_without_a_card_raises(checkpoints, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, port_ckpt, wav, _ = checkpoints
    with pytest.raises(RuntimeError, match="CUDA"):
        tsep.main(["--model_path", port_ckpt, "--input", wav, "--out_dir", str(tmp_path)])


@pytest.fixture(scope="module", params=[False, True], ids=["noncausal", "causal"])
def dprnn_checkpoints(request, tmp_path_factory):
    """(jax checkpoint, port checkpoint, mixture wav) of a tiny DPRNN-TasNet."""
    config = dict(DPRNN_CFG, causal=request.param)
    tmp = tmp_path_factory.mktemp("cli_dprnn")
    rng = np.random.default_rng(1)
    jmodel = JDPRNNTasNet(**config)
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 1, 320), jnp.float32)))
    for path, leaf in jax.tree_util.tree_flatten_with_path(variables["params"])[0]:
        parent = variables["params"]
        for p in path[:-1]:
            parent = parent[p.key]
        if path[-1].key in ("gamma", "beta"):
            parent[path[-1].key] = (0.5 + rng.random(leaf.shape)).astype(np.float32)
    jax_ckpt = str(tmp / "model.ckpt")
    jax_save_model(jax_ckpt, jmodel, variables, {})

    port = DPRNNTasNet(**config)
    port.load_state_dict(dprnn_tasnet_state_dict_from_jax(variables, config))
    port_ckpt = str(tmp / "model.pth")
    save_model(port_ckpt, port)

    wav = str(tmp / "mix.wav")
    write_wav(wav, 0.1 * rng.standard_normal(1601), 8000)
    return jax_ckpt, port_ckpt, wav


def test_separate_dprnn_tasnet_writes_the_same_wavs_as_jax(dprnn_checkpoints, tmp_path,
                                                            monkeypatch):
    jax_ckpt, port_ckpt, wav = dprnn_checkpoints

    def no_fold(*args, **kwargs):
        raise AssertionError("a DPRNN-TasNet checkpoint must not be folded")

    monkeypatch.setattr(tsep, "fold_gln_affine", no_fold)
    jsep.main(["--model_path", jax_ckpt, "--input", wav, "--out_dir", str(tmp_path / "jax")])
    est = tsep.main(["--model_path", port_ckpt, "--input", wav,
                     "--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    expected = _read_sources(tmp_path / "jax")
    got = _read_sources(tmp_path / "port")
    assert got.shape == expected.shape == (2, 1601) and est.shape == (2, 1601)
    assert np.isfinite(est).all()
    assert np.abs(got - expected).max() <= 2 * WAV_STEP


def test_separate_dprnn_tasnet_bfloat16_stays_close_to_float32(dprnn_checkpoints, tmp_path):
    _, port_ckpt, wav = dprnn_checkpoints
    args = ["--model_path", port_ckpt, "--input", wav, "--device", "cpu"]
    f32 = tsep.main(args + ["--out_dir", str(tmp_path / "f32")])
    bf16 = tsep.main(args + ["--out_dir", str(tmp_path / "bf16"), "--dtype", "bfloat16"])
    assert bf16.shape == f32.shape == (2, 1601) and np.isfinite(bf16).all()
    assert _read_sources(tmp_path / "bf16").shape == (2, 1601)
    snr = 10 * np.log10(np.sum(f32 ** 2) / np.sum((bf16 - f32) ** 2))
    assert snr > 20.0, snr


@pytest.mark.parametrize("flag", [["--chunk_duration", "0.5"], ["--streaming_hop", "0.05"]])
def test_unported_serving_modes_raise_for_dprnn_tasnet(dprnn_checkpoints, tmp_path, flag):
    _, port_ckpt, wav = dprnn_checkpoints
    with pytest.raises(NotImplementedError):
        tsep.main(["--model_path", port_ckpt, "--input", wav, "--out_dir", str(tmp_path),
                   "--device", "cpu", *flag])
