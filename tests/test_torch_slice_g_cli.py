"""The port's oracle-mask and create-mixtures CLIs against the JAX package's (CPU).

- `cli/test_oracle_masks.py --device cpu` and JAX's CLI on one corpus, for each of the
  four masks: every utterance's printed SI-SDRi within 1e-3 dB (the prints carry three
  decimals) and the returned means within 1e-3 dB;
- `cli/create_mixtures.py` and JAX's on one task list, `--length min` and `max`: every
  written WAV bit for bit.
"""
import os
import re

import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.cli import create_mixtures as mix_cli
from dnn_based_source_separation_torch.cli import test_oracle_masks as oracle_cli
from dnn_based_source_separation_tpu.cli import create_mixtures as jmix_cli
from dnn_based_source_separation_tpu.cli import test_oracle_masks as joracle_cli
from dnn_based_source_separation_tpu.data.audio_io import write_wav

LINE = re.compile(r"^(\S+), SI-SDRi: (-?[0-9.]+)$", re.M)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three two-speaker utterances of 0.3-0.5 s: harmonic sources with noise."""
    root = tmp_path_factory.mktemp("oracle")
    rng = np.random.default_rng(0)
    for sub in ("mix", "s1", "s2"):
        os.makedirs(root / "tt" / sub)
    utts = []
    for i, T in enumerate((4000, 3001, 2400)):
        t = np.arange(T) / 8000.0
        srcs = np.stack([0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(T)
                         for f in (180.0 + 40 * i, 610.0)])
        utt = f"tt_{i}"
        for s in range(2):
            write_wav(str(root / "tt" / f"s{s + 1}" / f"{utt}.wav"), srcs[s], 8000)
        write_wav(str(root / "tt" / "mix" / f"{utt}.wav"), srcs.sum(axis=0), 8000)
        utts.append(utt)
    (root / "tt.lst").write_text("\n".join(utts))
    return root


@pytest.mark.parametrize("mask", ["ibm", "irm", "wfm", "psm"])
def test_oracle_masks_cli_matches_jax(corpus, capsys, mask, monkeypatch):
    argv = ["--test_wav_root", str(corpus / "tt"), "--test_list_path", str(corpus / "tt.lst"),
            "--n_fft", "64", "--hop_length", "16", "--mask", mask]
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)  # PyTorch's default
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    mean = oracle_cli.main(argv + ["--device", "cpu"])
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    got = dict(LINE.findall(capsys.readouterr().out))
    j_mean = joracle_cli.main(argv)
    want = dict(LINE.findall(capsys.readouterr().out))
    assert sorted(got) == sorted(want) == ["tt_0", "tt_1", "tt_2"]
    for utt, value in want.items():
        assert abs(float(got[utt]) - float(value)) <= 1e-3 + 1e-9, (utt, got[utt], value)
    assert abs(mean - j_mean) <= 1e-3 and mean > 3.0


@pytest.mark.parametrize("length", ["min", "max"])
def test_create_mixtures_cli_writes_jax_files_bit_for_bit(tmp_path, length):
    rng = np.random.default_rng(11)
    src_dir = tmp_path / "wsj0"
    os.makedirs(src_dir)
    entries = []
    for i in range(3):
        for spk, T in (("a", 4000 + 37 * i), ("b", 3500)):
            write_wav(str(src_dir / f"{spk}{i}.wav"), 0.1 * rng.standard_normal(T), 8000)
        entries.append(f"a{i}.wav {1.5 * i:.1f} b{i}.wav -2.5")
    lst = tmp_path / "tasks.txt"
    lst.write_text("\n".join(entries))
    for cli, out in ((mix_cli, "port"), (jmix_cli, "jax")):
        cli.main(["--list_path", str(lst), "--wav_root", str(src_dir),
                  "--out_root", str(tmp_path / out), "--length", length])
    for sub in ("mix", "s1", "s2"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert names == sorted(os.listdir(tmp_path / "port" / sub)) and len(names) == 3
        for name in names:
            assert (tmp_path / "port" / sub / name).read_bytes() == \
                (tmp_path / "jax" / sub / name).read_bytes(), (sub, name)
