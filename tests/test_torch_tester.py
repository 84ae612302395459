"""Port's wsj0-mix evaluation (Tester, cli/test_wsj0mix.py) against the JAX package's (CPU).

One tiny test list of three utterances whose lengths are multiples of
neither the encoder stride nor the DPRNN chunk. For Conv-TasNet and
DPRNN-TasNet (LSTM and GRU) the JAX model's weights are saved as a JAX
checkpoint, carried into the port through `hub/from_jax.py` and saved as a
port checkpoint; both CLIs then evaluate the same WAVs. Each utterance is
evaluated through a list of its own, so the summary each CLI returns is that
utterance's metrics at full precision.

Tolerances per utterance: loss and SI-SDRi 1e-3 dB, SDRi, SIRi and SAR
1e-2 dB (BSS-Eval solves a 1024 x 1024 system per projection, which can
amplify the estimates' last-bit differences). Observed worst cases over
the three models and three utterances: loss 1.9e-06 dB, SI-SDRi 1.8e-06 dB,
SDRi 5.6e-07 dB, SIRi 7.8e-07 dB, SAR 1.8e-07 dB.
"""
import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.cli import test_wsj0mix as ttest
from dnn_based_source_separation_torch.data.audio_io import read_wav, write_wav
from dnn_based_source_separation_torch.hub import (
    conv_tasnet_state_dict_from_jax, dprnn_tasnet_state_dict_from_jax,
)
from dnn_based_source_separation_torch.models import ConvTasNet, DPRNNTasNet
from dnn_based_source_separation_torch.models.base import save_model
from dnn_based_source_separation_torch.ops import gru_scan as gs
from dnn_based_source_separation_torch.ops import lstm_scan as ls
from dnn_based_source_separation_torch.ops import mask_decode as md
from dnn_based_source_separation_torch.utils.bss import bss_eval_sources
from dnn_based_source_separation_tpu.cli import test_wsj0mix as jtest
from dnn_based_source_separation_tpu.models import ConvTasNet as JConvTasNet
from dnn_based_source_separation_tpu.models import DPRNNTasNet as JDPRNNTasNet
from dnn_based_source_separation_tpu.models.base import save_model as jax_save_model
from dnn_based_source_separation_tpu.utils.bss import bss_eval_sources as jax_bss_eval_sources

CONV = dict(n_basis=16, kernel_size=8, stride=4, enc_nonlinear="relu", sep_num_blocks=2,
            sep_num_layers=3, sep_hidden_channels=20, sep_bottleneck_channels=12,
            sep_skip_channels=12, causal=False, n_sources=2)
DPRNN = dict(n_basis=16, kernel_size=4, enc_nonlinear="relu", sep_bottleneck_channels=8,
             sep_hidden_channels=12, sep_chunk_size=10, sep_hop_size=5, sep_num_blocks=2,
             causal=False, n_sources=2)
MODELS = {
    "conv-tasnet": (CONV, JConvTasNet, ConvTasNet, conv_tasnet_state_dict_from_jax),
    "dprnn-tasnet-lstm": (dict(DPRNN, rnn_type="lstm"), JDPRNNTasNet, DPRNNTasNet,
                          dprnn_tasnet_state_dict_from_jax),
    "dprnn-tasnet-gru": (dict(DPRNN, rnn_type="gru"), JDPRNNTasNet, DPRNNTasNet,
                         dprnn_tasnet_state_dict_from_jax),
}
LENGTHS = (1237, 2003, 1511)  # samples: off the stride-4 grid and the chunk grid
TOL = {"loss": 1e-3, "loss_improvement": 1e-3, "sdr_improvement": 1e-2,
       "sir_improvement": 1e-2, "sar": 1e-2}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """wav_root with mix/, s1/, s2/ and one list file per utterance."""
    root = tmp_path_factory.mktemp("tt")
    rng = np.random.default_rng(0)
    for sub in ("mix", "s1", "s2"):
        os.makedirs(root / sub)
    lists = []
    for i, T in enumerate(LENGTHS):
        t = np.arange(T) / 8000
        s1 = 0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t) + 0.02 * rng.standard_normal(T)
        s2 = 0.2 * rng.standard_normal(T)
        utt = f"tt{i}"
        write_wav(str(root / "s1" / f"{utt}.wav"), s1, 8000)
        write_wav(str(root / "s2" / f"{utt}.wav"), s2, 8000)
        write_wav(str(root / "mix" / f"{utt}.wav"), s1 + s2, 8000)
        (root / f"{utt}.lst").write_text(utt + "\n")
        lists.append(str(root / f"{utt}.lst"))
    return root, lists


def _checkpoints(name, tmp):
    config, jcls, pcls, from_jax = MODELS[name]
    rng = np.random.default_rng(1)
    jmodel = jcls(**config)
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 1, 320), jnp.float32)))
    for path, leaf in jax.tree_util.tree_flatten_with_path(variables["params"])[0]:
        parent = variables["params"]
        for p in path[:-1]:
            parent = parent[p.key]
        if path[-1].key in ("gamma", "beta"):  # non-identity norms, so they matter
            parent[path[-1].key] = (0.5 + rng.random(leaf.shape)).astype(np.float32)
    jax_ckpt = str(tmp / "model.ckpt")
    jax_save_model(jax_ckpt, jmodel, variables, {})
    port = pcls(**config)
    port.load_state_dict(from_jax(variables, config))
    port_ckpt = str(tmp / "model.pth")
    save_model(port_ckpt, port)
    return jax_ckpt, port_ckpt


def _args(root, list_path, ckpt, *extra):
    return ["--test_wav_root", str(root), "--test_list_path", list_path, "--model_path", ckpt,
            *extra]


def _launches():
    return md.LAUNCHES + sum(ls.LAUNCHES.values()) + sum(gs.LAUNCHES.values())


@pytest.mark.parametrize("name", list(MODELS))
def test_cli_matches_jax_per_utterance(corpus, tmp_path, name):
    root, lists = corpus
    jax_ckpt, port_ckpt = _checkpoints(name, tmp_path)
    before = _launches()
    for i, list_path in enumerate(lists):
        jax_out, port_out = tmp_path / f"jax{i}", tmp_path / f"port{i}"
        expected = jtest.main(_args(root, list_path, jax_ckpt, "--out_dir", str(jax_out)))
        got = ttest.main(_args(root, list_path, port_ckpt, "--out_dir", str(port_out),
                               "--device", "cpu"))
        for key, tol in TOL.items():
            assert np.isfinite(got[key]), (key, got)
            assert abs(got[key] - expected[key]) <= tol, (name, i, key, got[key], expected[key])
        assert np.isnan(got["pesq"]) and np.isnan(expected["pesq"])
        # --out_dir writes the same WAVs, within one 16-bit step of each other.
        files = sorted(os.listdir(port_out / f"tt{i}"))
        assert files == sorted(os.listdir(jax_out / f"tt{i}")) == [
            "mixture.wav", "source0.wav", "source1.wav"]
        for f in files:
            a, b = (read_wav(str(d / f"tt{i}" / f))[0] for d in (port_out, jax_out))
            assert a.shape == b.shape == (LENGTHS[i],)
            assert np.abs(a - b).max() <= 2.0 / 32768, f
    assert _launches() == before  # CPU tensors never reach a CUDA kernel


def test_bss_eval_sources_equals_jax_bit_for_bit():
    rng = np.random.default_rng(2)
    refs = rng.standard_normal((2, 1500))
    ests = refs[::-1] + 0.3 * rng.standard_normal((2, 1500))
    for kwargs in ({}, {"compute_permutation": False, "filt_len": 64}):
        got = bss_eval_sources(refs, ests, **kwargs)
        expected = jax_bss_eval_sources(refs, ests, **kwargs)
        for a, b in zip(got, expected):
            assert np.array_equal(a, b)


def test_spec_kind_raises(corpus, tmp_path):
    root, lists = corpus
    _, port_ckpt = _checkpoints("conv-tasnet", tmp_path)
    with pytest.raises(NotImplementedError, match="slice F"):
        ttest.main(_args(root, lists[0], port_ckpt, "--spec_kind", "danet", "--device", "cpu"))
    # The spectrogram flags come with --spec_kind: until then they are refused, not ignored.
    for flag in ("--n_fft", "--hop_length", "--window_fn", "--iter_clustering"):
        with pytest.raises(SystemExit):
            ttest.main(_args(root, lists[0], port_ckpt, flag, "1", "--device", "cpu"))


def test_cuda_without_a_card_raises(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    root, lists = corpus
    _, port_ckpt = _checkpoints("conv-tasnet", tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttest.main(_args(root, lists[0], port_ckpt))


def _stub(path, body):
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def test_pesq_is_parsed_and_a_failing_tool_scores_the_floor(corpus, tmp_path):
    root, lists = corpus
    jax_ckpt, port_ckpt = _checkpoints("conv-tasnet", tmp_path)
    good = _stub(tmp_path / "pesq_ok", 'echo "P.862 Prediction (Raw MOS, MOS-LQO):  = 3.217"\n')
    bad = _stub(tmp_path / "pesq_bad", "exit 3\n")
    for tool, score in ((good, 3.217), (bad, -0.5)):
        got = ttest.main(_args(root, lists[0], port_ckpt, "--pesq_bin", tool, "--device", "cpu"))
        expected = jtest.main(_args(root, lists[0], jax_ckpt, "--pesq_bin", tool))
        assert got["pesq"] == expected["pesq"] == pytest.approx(score)
