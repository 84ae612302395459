"""Port's musdb18 evaluation path against the JAX package (CPU): corpus, datasets,
BSS-Eval v4, the Evaluater and cli/test_musdb18.py end to end.

Host code is held bit for bit (or byte for byte); the CLI's stems at 1e-4 x
max|ref| and its medians within 0.01 dB, at tiny widths (n_fft 64, hidden
16, 2 layers, max_bin 20, 4 sources) on a corpus of two 2.5 s tracks at
8 kHz.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.cli import test_musdb18 as cli
from dnn_based_source_separation_torch.data import musdb18 as musdb
from dnn_based_source_separation_torch.data.synthetic import (
    synth_music_track, write_musdb_quality_corpus,
)
from dnn_based_source_separation_torch.hub import (
    parallel_open_unmix_state_dict_from_jax, xumx_state_dict_from_jax,
)
from dnn_based_source_separation_torch.models import (
    CrossNetOpenUnmix, ParallelOpenUnmix, SpectrogramMaskingWrapper,
)
from dnn_based_source_separation_torch.models.base import save_model
from dnn_based_source_separation_torch.train.tester import Evaluater, framewise_sdr
from dnn_based_source_separation_torch.utils.bss import bss_eval_v4
from dnn_based_source_separation_tpu.cli import test_musdb18 as jcli
from dnn_based_source_separation_tpu.data import musdb18 as jmusdb
from dnn_based_source_separation_tpu.data import synthetic as jsynthetic
from dnn_based_source_separation_tpu.models import umx as jumx
from dnn_based_source_separation_tpu.models import wrappers as jwrappers
from dnn_based_source_separation_tpu.models import xumx as jxumx
from dnn_based_source_separation_tpu.models.base import save_model as jax_save_model
from dnn_based_source_separation_tpu.train import tester as jtester
from dnn_based_source_separation_tpu.utils.bss import bss_eval_v4 as jax_bss_eval_v4

SR = 8000
TRACK_SEC = 2.5
N_FFT, HOP = 64, 16
CFG = dict(in_channels=2, hidden_channels=16, num_layers=2, n_bins=N_FFT // 2 + 1, max_bin=20,
           sources=("bass", "drums", "other", "vocals"))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _corpus(root, writer):
    return writer(str(root), n_train=2, n_valid=1, n_test=2, track_sec=TRACK_SEC,
                  sample_rate=SR)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _corpus(tmp_path_factory.mktemp("musdb"), write_musdb_quality_corpus)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_corpus_is_byte_for_byte_jax_s(corpus, tmp_path):
    jroot = _corpus(tmp_path / "jax", jsynthetic.write_musdb_quality_corpus)
    assert _files(corpus) == _files(jroot)
    assert len(_files(corpus)) == 3 + 5 * 5  # three lists; 5 tracks x 4 stems + mixture
    for rel in _files(corpus):
        with open(os.path.join(corpus, rel), "rb") as a, open(os.path.join(jroot, rel), "rb") as b:
            assert a.read() == b.read(), rel


@pytest.mark.parametrize("shift", [0.0, 1.0])
def test_synth_music_track_matches_jax(shift):
    got = synth_music_track(np.random.default_rng(4), 3001, SR, shift)
    ref = jsynthetic.synth_music_track(np.random.default_rng(4), 3001, SR, shift)
    assert list(got) == list(ref)
    for name in got:
        np.testing.assert_array_equal(got[name], ref[name])


@pytest.mark.parametrize("cache", [False, True])
def test_datasets_match_jax(corpus, cache):
    test, jtest = (m.WaveTestDataset(corpus, cache_in_memory=cache) for m in (musdb, jmusdb))
    assert test.names == jtest.names == ["test_song000", "test_song001"]
    for i in range(len(test)):
        (name, mix, srcs), (jname, jmix, jsrcs) = test[i], jtest[i]
        assert name == jname and mix.shape == (1, 2, int(TRACK_SEC * SR))
        np.testing.assert_array_equal(mix, jmix)
        np.testing.assert_array_equal(srcs, jsrcs)
    for max_duration in (1.0, 4.0):  # a cut and a zero pad
        ev, jev = (m.WaveEvalDataset(corpus, max_duration=max_duration, sample_rate=SR,
                                     cache_in_memory=cache) for m in (musdb, jmusdb))
        assert ev.names == jev.names == ["valid_song000"]
        for a, b in zip(ev[0], jev[0]):
            assert a.shape[-1] == int(max_duration * SR)
            np.testing.assert_array_equal(a, b)
    for subset in ("train", "valid"):
        assert (musdb._MUSDB18Base(corpus, subset).names
                == jmusdb._MUSDB18Base(corpus, subset).names)


def _signals(seed, lead, T):
    rng = np.random.default_rng(seed)
    refs = rng.standard_normal((*lead, T)).astype(np.float32)
    est = refs + 0.3 * rng.standard_normal(refs.shape).astype(np.float32)
    return refs, est


@pytest.mark.parametrize("channels", [None, 2])
def test_bss_eval_v4_is_bit_for_bit_jax_s(channels):
    refs, est = _signals(1, (3,), 2600)
    if channels:
        refs, est = (np.stack([x, 0.5 * x + 0.1 * np.roll(x, 7, -1)], axis=-1)
                     for x in (refs, est))
    refs[1, :1000] = 0.0  # silent frames: NaN in both
    got = bss_eval_v4(refs, est, 1000, filt_len=32)
    ref = jax_bss_eval_v4(refs, est, 1000, filt_len=32)
    assert sorted(got) == sorted(ref) == ["ISR", "SAR", "SDR", "SIR"]
    for k in got:
        assert got[k].shape == (3, 2)
        np.testing.assert_array_equal(got[k], ref[k])


def test_evaluater_and_framewise_sdr_are_bit_for_bit_jax_s():
    ours, theirs = (Evaluater(sources=["a", "b"], sample_rate=500, filt_len=16),
                    jtester.Evaluater(sources=["a", "b"], sample_rate=500, filt_len=16))
    for seed in (2, 3, 4):
        refs, est = _signals(seed, (2,), 1700)
        refs, est = refs[..., None].repeat(2, -1), est[..., None].repeat(2, -1)
        framewise = ours.add_track(refs, est)
        jframewise = theirs.add_track(refs, est)
        for k in framewise:
            np.testing.assert_array_equal(framewise[k], jframewise[k])
    assert ours.aggregate() == theirs.aggregate()
    refs, est = _signals(5, (2,), 1700)
    np.testing.assert_array_equal(framewise_sdr(refs, est, 500, filt_len=16),
                                  jtester.framewise_sdr(refs, est, 500, filt_len=16))


def _checkpoints(tmp_path, kind):
    """The same seeded, scrambled weights as a JAX checkpoint and a port checkpoint of a
    SpectrogramMaskingWrapper around ParallelOpenUnmix or bridged X-UMX."""
    jbase, base, to_port = {
        "umx": (jumx.ParallelOpenUnmix, ParallelOpenUnmix, parallel_open_unmix_state_dict_from_jax),
        "xumx": (jxumx.CrossNetOpenUnmix, CrossNetOpenUnmix, xumx_state_dict_from_jax)}[kind]
    jmodel = jwrappers.SpectrogramMaskingWrapper(base=jbase(**CFG), n_fft=N_FFT, hop_length=HOP)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 2, 400), jnp.float32))
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, v: np.asarray(
            0.5 + rng.random(v.shape) if str(path[-1].key) in ("var", "scale") else
            0.1 * rng.standard_normal(v.shape) if str(path[-1].key) in ("mean", "bias") else
            v, np.float32), dict(variables))
    jpath = str(tmp_path / f"{kind}_jax.ckpt")
    jax_save_model(jpath, jmodel, variables)
    port = SpectrogramMaskingWrapper(base(**CFG), n_fft=N_FFT, hop_length=HOP)
    port.base.load_state_dict(to_port({k: v["base"] for k, v in variables.items()}, CFG))
    path = str(tmp_path / f"{kind}.pth")
    save_model(path, port)
    return jpath, path


def _record_estimates(monkeypatch, evaluater_cls):
    """Keep each add_track's float estimates (n_src, T, C) as the CLI hands them over."""
    seen = []
    add_track = evaluater_cls.add_track

    def recording(self, references, estimates):
        seen.append(np.array(estimates))
        return add_track(self, references, estimates)

    monkeypatch.setattr(evaluater_cls, "add_track", recording)
    return seen


CLI_FLAGS = ["--sample_rate", str(SR), "--duration", "1.0", "--filt_len", "64"]


@pytest.mark.parametrize("kind", ["umx", "xumx"])
def test_cli_matches_jax_cli(monkeypatch, corpus, tmp_path, kind):
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", "0")
    jpath, path = _checkpoints(tmp_path, kind)
    jseen = _record_estimates(monkeypatch, jtester.Evaluater)
    seen = _record_estimates(monkeypatch, Evaluater)
    jtable = jcli.main(["--musdb18_root", corpus, "--model_path", jpath, *CLI_FLAGS])
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)  # PyTorch's default
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    table, stats = cli.run(["--musdb18_root", corpus, "--model_path", path, "--device", "cpu",
                            "--out_dir", str(tmp_path / "out"), *CLI_FLAGS])
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    assert len(seen) == len(jseen) == 2
    for got, ref in zip(seen, jseen):
        assert got.shape == ref.shape == (4, int(TRACK_SEC * SR), 2)
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    assert list(table) == list(jtable) == list(CFG["sources"])
    for source, row in table.items():
        for metric in Evaluater.METRICS:
            assert abs(row[metric] - jtable[source][metric]) <= 0.01, (source, metric)
    assert [s["chunks"] for s in stats] == [3, 3]  # 2.5 s in 1 s chunks, the last padded
    assert sorted(os.listdir(tmp_path / "out" / "test_song000")) == [
        f"{s}.wav" for s in CFG["sources"]]


def test_cli_raises_on_non_finite_estimates(corpus, tmp_path):
    model = SpectrogramMaskingWrapper(ParallelOpenUnmix(**CFG), n_fft=N_FFT, hop_length=HOP)
    with torch.no_grad():
        model.base.backbone["vocals"].bias_out[3] = float("nan")
    path = str(tmp_path / "nan.pth")
    save_model(path, model)
    with pytest.raises(RuntimeError, match=r"test_song000: \d+ non-finite samples"):
        cli.main(["--musdb18_root", corpus, "--model_path", path, "--device", "cpu",
                  *CLI_FLAGS])


def test_cli_refuses_a_missing_card(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--musdb18_root", corpus, "--model_path", str(tmp_path / "none.pth")])
