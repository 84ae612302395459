"""The port and chip_smoke.py import no JAX: the card's machine has none."""
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
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'jaxlib'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_file_names_jax():
    pattern = re.compile(r"^\s*(import jax|from jax|import flax|from flax)", re.M)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_chip_smoke_refuses_to_run_without_a_card():
    # Without a CUDA card the script must fail and print no result.
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
