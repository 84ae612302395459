"""Model registry and the config-in-checkpoint contract.

Port of `dnn_based_source_separation_tpu/models/base.py`. A checkpoint is
the reference implementation's `.pth` layout, `{**config, "state_dict": ...}`
written with `torch.save`, plus a `model_class` key, so
`hub/torch_convert.py:build_from_torch_checkpoint` opens it in JAX. A
training checkpoint adds an `extra` key (optimizer state, epoch, counters,
loss history) that `load_model` and the JAX loader ignore.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch

_MODEL_REGISTRY: Dict[str, type] = {}


def register_model(cls):
    """Class decorator: make a model reconstructible by name from checkpoints."""
    _MODEL_REGISTRY[cls.__name__] = cls
    return cls


def get_model_class(name: str) -> type:
    return _MODEL_REGISTRY[name]


class SeparationModelMixin:
    """get_config / num_parameters for models that keep their config in `_config`."""

    def get_config(self) -> Dict[str, Any]:
        return dict(self._config)

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.parameters())


_NOT_CONFIG = ("model_class", "state_dict", "extra")


def save_model(path: str, model, extra: Dict[str, Any] | None = None) -> None:
    """Write `{model_class, **config, state_dict}` (tensors on the CPU) to `path`.

    `extra`, if given, is stored under its own key (tensors, numbers, strings,
    lists and dicts only, so it loads with `weights_only=True`).
    """
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    blob = {"model_class": type(model).__name__, **model.get_config(), "state_dict": state}
    if extra is not None:
        blob["extra"] = extra
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(blob, path)


def read_checkpoint(path: str) -> Dict[str, Any]:
    """The raw checkpoint dict, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_model(path: str, device="cpu"):
    """Rebuild the model a `save_model` checkpoint holds, with its weights, on `device`."""
    blob = read_checkpoint(path)
    config = {k: v for k, v in blob.items() if k not in _NOT_CONFIG}
    model = get_model_class(blob["model_class"])(**config, device=device)
    model.load_state_dict(blob["state_dict"])
    return model.eval()
