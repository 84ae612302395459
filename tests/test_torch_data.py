"""The port's own copies of the JAX package's framework-free host code (CPU).

The port imports nothing of the JAX package, so it keeps copies of the data
pipeline it uses: audio IO, the native loader's bindings, the wsj0-mix wave
datasets, the `DataLoader` and the quality-corpus synthesiser. Each must
behave as the original does, byte for byte and batch for batch.
"""
import os

import numpy as np
import pytest

from dnn_based_source_separation_torch.data import audio_io, loader, native_loader, synthetic
from dnn_based_source_separation_torch.data import wsj0mix
from dnn_based_source_separation_tpu.data import audio_io as jaudio_io
from dnn_based_source_separation_tpu.data import loader as jloader
from dnn_based_source_separation_tpu.data import native_loader as jnative_loader
from dnn_based_source_separation_tpu.data import synthetic as jsynthetic
from dnn_based_source_separation_tpu.data import wsj0mix as jwsj0mix


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same quality corpus written by the port's synthesiser and the JAX package's."""
    port, jax_root = tmp_path_factory.mktemp("port"), tmp_path_factory.mktemp("jax")
    for split, n in (("tr", 3), ("tt", 2)):
        synthetic.write_quality_corpus(str(port), split, n)
        jsynthetic.write_quality_corpus(str(jax_root), split, n)
    return port, jax_root


def test_write_quality_corpus_writes_the_same_bytes(corpora):
    port, jax_root = corpora
    files = _files(port)
    assert files == _files(jax_root) and "tr.lst" in files and len(files) == 2 + 3 * (3 + 2)
    for f in files:
        assert (port / f).read_bytes() == (jax_root / f).read_bytes(), f


def test_write_quality_corpus_keeps_an_existing_list(corpora, tmp_path):
    port, _ = corpora
    assert synthetic.write_quality_corpus(str(port), "tt", 7) == (
        str(port / "tt"), str(port / "tt.lst"))
    assert len((port / "tt.lst").read_text().split()) == 2


def test_synth_pseudo_speech_equals_jax():
    speaker = synthetic._speaker_bank(3, seed=7)[2]
    assert speaker.keys() == jsynthetic._speaker_bank(3, seed=7)[2].keys()
    got = synthetic.synth_pseudo_speech(speaker, np.random.default_rng(1), 1234)
    expected = jsynthetic.synth_pseudo_speech(speaker, np.random.default_rng(1), 1234)
    assert got.dtype == np.float32 and np.array_equal(got, expected)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_data_loader_yields_the_batches_of_jax(corpora, num_workers):
    port, _ = corpora
    root, lst = str(port / "tr"), str(port / "tr.lst")
    ours = loader.DataLoader(wsj0mix.WaveTrainDataset(root, lst, samples=8000), batch_size=2,
                             shuffle=True, seed=5, num_workers=num_workers)
    theirs = jloader.DataLoader(jwsj0mix.WaveTrainDataset(root, lst, samples=8000),
                                batch_size=2, shuffle=True, seed=5, num_workers=num_workers)
    assert len(ours) == len(theirs) >= 3
    for _ in range(2):  # two epochs: the shuffle advances the same way
        got, expected = list(ours), list(theirs)
        assert len(got) == len(expected) == len(ours)
        for a, b in zip(got, expected):
            assert len(a) == len(b) == 2
            for x, y in zip(a, b):
                assert x.dtype == y.dtype == np.float32 and np.array_equal(x, y)


def test_wave_datasets_equal_jax(corpora):
    port, _ = corpora
    root, lst = str(port / "tt"), str(port / "tt.lst")
    pairs = [
        (wsj0mix.WaveTrainDataset(root, lst, samples=4000, cache_in_memory=True),
         jwsj0mix.WaveTrainDataset(root, lst, samples=4000, cache_in_memory=True)),
        (wsj0mix.WaveEvalDataset(root, lst, max_samples=40000),
         jwsj0mix.WaveEvalDataset(root, lst, max_samples=40000)),
        (wsj0mix.WaveTestDataset(root, lst), jwsj0mix.WaveTestDataset(root, lst)),
    ]
    for ours, theirs in pairs:
        assert len(ours) == len(theirs) > 0
        for i in range(len(ours)):
            for x, y in zip(ours[i], theirs[i]):
                if isinstance(x, str):
                    assert x == y
                else:
                    assert x.dtype == y.dtype and np.array_equal(x, y)
    assert wsj0mix._read_list(lst) == jwsj0mix._read_list(lst)


def test_audio_io_and_native_loader_equal_jax(tmp_path):
    rng = np.random.default_rng(6)
    signal = 0.4 * rng.standard_normal(3001)
    audio_io.write_wav(str(tmp_path / "a.wav"), signal, 8000)
    jaudio_io.write_wav(str(tmp_path / "b.wav"), signal, 8000)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    for start, frames in ((None, None), (17, 500), (2990, None)):
        x, sr = audio_io.read_wav(str(tmp_path / "a.wav"), start, frames)
        y, jsr = jaudio_io.read_wav(str(tmp_path / "a.wav"), start, frames)
        assert sr == jsr == 8000 and np.array_equal(x, y)
    assert native_loader.available() == jnative_loader.available()
    if native_loader.available():
        paths = [str(tmp_path / "a.wav")] * 2
        assert np.array_equal(native_loader.read_segments_batch(paths, [0, 100], 700),
                              jnative_loader.read_segments_batch(paths, [0, 100], 700))
        assert native_loader.wav_info(paths[0]) == jnative_loader.wav_info(paths[0])
