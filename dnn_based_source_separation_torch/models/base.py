"""Model registry and the config-in-checkpoint contract.

Port of `dnn_based_source_separation_tpu/models/base.py`. A checkpoint is
the reference implementation's `.pth` layout, `{**config, "state_dict": ...}`
written with `torch.save`, plus a `model_class` key, so
`hub/torch_convert.py:build_from_torch_checkpoint` opens it in JAX.
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


def save_model(path: str, model) -> None:
    """Write `{model_class, **config, state_dict}` (tensors on the CPU) to `path`."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    blob = {"model_class": type(model).__name__, **model.get_config(), "state_dict": state}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(blob, path)


def load_model(path: str, device="cpu"):
    """Rebuild the model a `save_model` checkpoint holds, with its weights, on `device`."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    config = {k: v for k, v in blob.items() if k not in ("model_class", "state_dict")}
    model = get_model_class(blob["model_class"])(**config, device=device)
    model.load_state_dict(blob["state_dict"])
    return model.eval()
