"""The device an entry point runs on, with float32 kept in float32.

PyTorch computes a float32 convolution through cuDNN in TF32 by default
(`torch.backends.cudnn.allow_tf32` is True; TF32 keeps about three decimal digits), and
a float32 matmul in TF32 wherever `torch.backends.cuda.matmul.allow_tf32` is set. The
JAX package computes both in float32, and so does the port: every CLI and the bench
resolve their `--device` here, which turns both flags off for the process.
"""
from __future__ import annotations

import sys

import torch

TF32_OFF = ("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
            "torch.backends.cudnn.allow_tf32 = False")


def resolve_device(name: str, stream=sys.stdout) -> torch.device:
    """`--device` -> torch.device; raises where CUDA is asked for and missing. Turns TF32
    off for float32 matmuls and convolutions in this process and, unless `stream` is
    None, says so on it as one line (a CLI's first)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name} asked for, but CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if stream is not None:
        print(f"device {device}; {TF32_OFF}", file=stream, flush=True)
    return device
