"""Complex-aware and concatenated activations.

Port of `dnn_based_source_separation_tpu/ops/activation.py` (reference
`src/modules/activation.py`: ConcatReLU, ModReLU, ComplexReLU, ZReLU). The complex ones take
complex tensors (complex64 on the card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .params import constant_parameter


def concat_relu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """CReLU: concat(relu(x), relu(-x)) along `dim`."""
    return torch.cat([F.relu(x), F.relu(-x)], dim=dim)


def complex_relu(z: torch.Tensor) -> torch.Tensor:
    """ReLU of the real and imaginary parts independently."""
    return torch.complex(F.relu(z.real), F.relu(z.imag))


def zrelu(z: torch.Tensor) -> torch.Tensor:
    """z where both its real and imaginary parts are positive, else 0."""
    keep = (z.real > 0) & (z.imag > 0)
    return torch.where(keep, z, torch.zeros((), dtype=z.dtype, device=z.device))


class ModReLU(nn.Module):
    """relu(|z| + b) * z / (|z| + eps), a learnable `bias` b of shape (features,) (zeros)
    over the last dim."""

    def __init__(self, features: int, eps: float = 1e-12, *, device=None):
        super().__init__()
        self.eps = eps
        self.bias = constant_parameter((features,), 0.0, device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        mag = z.abs()
        return (F.relu(mag + self.bias) / (mag + self.eps)) * z
