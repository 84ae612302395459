"""Whole-array symmetric int8 quantization of weights.

Port of `dnn_based_source_separation_tpu/ops/pallas_kernels.py:quantize_int8`,
`dequantize_int8`, `quantize_params` and `dequantize_params` (:45-104). On
CUDA tensors `quantize_int8` launches the hand-written Hopper kernel of
`csrc/quantize.cu`; on CPU tensors the plain PyTorch version runs. There is
no fallback from one to the other: a CUDA call the kernel cannot take raises.

Semantics: `scale = max(max|x| * f32(1 / 127), 1e-12)` (XLA rewrites the
kernel's division by the constant 127 into that product) and
`q = round_half_even(x / scale)` as int8, bit for bit the Pallas kernel's
under XLA; or, stochastic, `q = floor(x / scale + u)` with u uniform on
[0, 1), evaluated as
`floor(s) + (u < s - floor(s))` and saturated to [-128, 127]. The kernel
draws u from an in-kernel Philox generator keyed by `seed`; the plain
version draws it from a `torch.Generator` (seeded by `seed` when none is
given). The two give different bits, so only the distribution is compared.
(The JAX package's interpreter path rounds deterministically even when asked
for stochastic rounding; this port rounds stochastically on both devices.)
"""
from __future__ import annotations

import ctypes
from typing import Dict, Mapping

import torch

from ._build import load_library

# Launches of the CUDA kernel in this process. Only the launch below
# increments it; callers reset it to 0 to count a run.
LAUNCHES = {"quantize_int8": 0}

_INV_127 = 1.0 / 127.0  # rounds to the f32 of 1.0f / 127.0f

_LIB = None


def quantize_int8_reference(x: torch.Tensor, stochastic: bool = False,
                            generator: torch.Generator | None = None):
    """Plain version of `quantize_int8`: x f32 -> (values int8 of x's shape, scale (1, 1) f32)."""
    scale = torch.clamp_min(x.abs().max() * torch.tensor(_INV_127, dtype=torch.float32), 1e-12)
    scaled = x / scale
    if stochastic:
        u = torch.rand(x.shape, generator=generator, dtype=torch.float32, device=x.device)
        low = torch.floor(scaled)
        q = (low + (u < scaled - low).to(torch.float32)).clamp(-128.0, 127.0)
    else:
        q = torch.round(scaled)
    return q.to(torch.int8), scale.reshape(1, 1)


def _library():
    global _LIB
    if _LIB is None:
        lib = load_library("quantize")
        p = ctypes.c_void_p
        lib.quantize_int8_launch.argtypes = [p, ctypes.c_longlong, p, p, p, ctypes.c_int,
                                             ctypes.c_ulonglong, p]
        lib.quantize_int8_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def build() -> None:
    """Build (or load) the CUDA kernel now instead of at its first launch."""
    _library()


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"quantize_int8 takes float32, not {x.dtype}")
    if x.numel() < 1:
        raise ValueError("quantize_int8 needs at least one element")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x is not 16-byte aligned")


def quantize_int8(x: torch.Tensor, seed: int = 0, stochastic: bool = False):
    """x f32 (M, N) -> (values int8 (M, N), scale (1, 1) f32) over the whole array.

    CPU tensors take the plain version (u from a generator seeded by `seed`);
    CUDA tensors launch the kernel or raise.
    """
    if x.device.type == "cpu":
        generator = torch.Generator().manual_seed(seed) if stochastic else None
        return quantize_int8_reference(x, stochastic, generator)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8 runs on cpu or cuda, not {x.device}")
    _check(x)
    values = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((1, 1), dtype=torch.float32, device=x.device)
    scratch = torch.empty((1,), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().quantize_int8_launch(
            x.data_ptr(), x.numel(), values.data_ptr(), scale.data_ptr(), scratch.data_ptr(),
            int(bool(stochastic)), seed % 2 ** 64, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize_int8 kernel launch failed: cudaError {err}")
    LAUNCHES["quantize_int8"] += 1
    return values, scale


def dequantize_int8(values: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return values.to(torch.float32) * scale.reshape(())


def quantizable(t: torch.Tensor) -> bool:
    """Whether `quantize_params` quantizes this tensor's counterpart in the JAX tree.

    JAX quantizes the float32 leaves of two or more dimensions. The port
    stores some vectors with size-1 dimensions around them (the norms'
    gamma and beta are (1, N, 1), JAX's (N,)), so the rank that decides is
    the rank of the squeezed shape.
    """
    return t.dtype == torch.float32 and sum(n > 1 for n in t.shape) >= 2


def quantize_state_dict(state_dict: Mapping[str, torch.Tensor], stochastic: bool = False) -> Dict:
    """Quantize the float32 weight tensors of a state dict to {"q": int8, "scale": (1, 1)}.

    The tensors quantized are those whose JAX leaf `quantize_params`
    quantizes (see `quantizable`). Each is quantized as a whole, reshaped to
    (shape[0], -1), with seed = its index in the state dict; other entries
    pass through.
    """
    out = {}
    for i, (name, t) in enumerate(state_dict.items()):
        if quantizable(t):
            values, scale = quantize_int8(t.contiguous().reshape(t.shape[0], -1), seed=i,
                                          stochastic=stochastic)
            out[name] = {"q": values.reshape(t.shape), "scale": scale}
        else:
            out[name] = t
    return out


def dequantize_state_dict(qstate: Mapping) -> Dict[str, torch.Tensor]:
    """The inverse of `quantize_state_dict`, up to the rounding: a state dict to load."""
    return {name: dequantize_int8(v["q"], v["scale"]) if isinstance(v, dict) else v
            for name, v in qstate.items()}
