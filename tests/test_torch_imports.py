"""The port and chip_smoke.py import no JAX and nothing of the JAX package.

The card's machine has no JAX, and the port keeps its own copies of the
framework-free host code it uses (data, BSS-Eval, the PESQ hook).
"""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "dnn_based_source_separation_torch"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def test_importing_every_port_module_leaves_jax_out():
    modules = _modules()
    assert "dnn_based_source_separation_torch.ops.mask_decode" in modules
    assert "dnn_based_source_separation_torch.ops.lstm_scan" in modules
    assert "dnn_based_source_separation_torch.ops.gru_scan" in modules
    assert "dnn_based_source_separation_torch.models.streaming" in modules
    for new in ("criterion.sdr", "criterion.pit", "train.steps", "train.trainer",
                "data.loader", "cli.model_factory", "cli.train_wsj0mix", "ops.quantize",
                "train.tester", "cli.test_wsj0mix", "utils.bss", "utils.audio",
                "data.wsj0mix", "data.synthetic", "data.audio_io", "data.native_loader",
                "models.longform", "ops.windows", "entry", "bench", "ops.stft", "models.umx",
                "models.xumx", "models.wrappers", "algorithm.frequency_mask", "data.musdb18",
                "cli.test_musdb18", "hub.from_jax", "criterion.distance", "criterion.combination",
                "criterion.spectral", "criterion.multidomain", "augmentation",
                "cli.train_musdb18", "utils.embedding", "algorithm.clustering",
                "models.wavesplit", "train.wavesplit", "cli.train_wsj0mix_wavesplit",
                "criterion.deep_clustering", "models.deep_clustering", "models.danet",
                "models.adanet", "train.attractor", "cli.train_wsj0mix_spec",
                "models.m_densenet", "models.mm_densenet", "models.mm_dense_rnn",
                "models.d3net", "models.resnet", "models.hrnet", "models.film",
                "models.unet", "models.cunet", "utils.config", "ops.norms",
                "criterion.hungarian", "criterion.mixit", "criterion.divergence",
                "criterion.entropy", "criterion.metric_learn", "algorithm.griffin_lim",
                "algorithm.misi", "algorithm.nmf", "transforms", "transforms.cepstrum",
                "transforms.pca", "cli.test_oracle_masks", "cli.create_mixtures",
                "hub.torch_checkpoint", "hub.pretrained", "ops.activation", "ops.complex_conv",
                "ops.pool", "ops.multidilated", "models.densenet", "models.cunet_choi",
                "models.lasaft", "models.vision"):
        assert f"dnn_based_source_separation_torch.{new}" in modules, new
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'flax', 'jaxlib', 'yaml', 'dnn_based_source_separation_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _sources():
    return list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_source_file_names_jax():
    pattern = re.compile(r"^\s*(import jax|from jax|import flax|from flax)", re.M)
    offenders = [str(f) for f in _sources() if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_no_source_file_imports_yaml():
    # The card's machine has no PyYAML: utils/config.py reads the recipe YAMLs itself.
    pattern = re.compile(r"^\s*(import yaml|from yaml)", re.M)
    offenders = [str(f) for f in _sources() if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_no_source_file_imports_the_jax_package():
    # Docstrings and comments may cite the JAX package; import lines may not.
    pattern = re.compile(r"^\s*(import|from)\s+dnn_based_source_separation_tpu\b"
                         r"|import_module\(\s*[\"']dnn_based_source_separation_tpu", re.M)
    offenders = [str(f) for f in _sources() if pattern.search(f.read_text())]
    assert not offenders, offenders
    assert pattern.search("from dnn_based_source_separation_tpu.data import audio_io")
    assert pattern.search("    import dnn_based_source_separation_tpu")


def test_chip_smoke_refuses_to_run_without_a_card():
    # Without a CUDA card the script must fail and print no result.
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
