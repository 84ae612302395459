"""PESQ harness hook.

The port's own copy of `evaluate_pesq` of
`dnn_based_source_separation_tpu/utils/audio.py:38`: a subprocess call of a
PESQ command-line tool (the repo's `native/pesq` build, or the ITU tool),
as the reference's `src/utils/audio.py:72-91` does.
"""
from __future__ import annotations

import subprocess


def evaluate_pesq(pesq_bin: str, reference_path: str, estimated_path: str, sample_rate: int) -> float:
    """Run `pesq_bin +<rate> ref est` and parse the score on its 'Prediction' line.

    Mirrors the reference recipe's TesterBase; output with no such line
    raises RuntimeError, which callers score as the metric's floor.
    """
    command = [pesq_bin, f"+{sample_rate}", reference_path, estimated_path]
    out = subprocess.check_output(command, text=True)
    for line in out.splitlines():
        if "Prediction" in line:
            return float(line.rstrip().split()[-1])
    raise RuntimeError(f"PESQ produced no prediction: {out[:200]}")
