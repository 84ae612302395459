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
        """The config; a nested model (a wrapper's `base`) as {"__model__", "config"},
        as the JAX package's `get_config` writes it."""
        return {k: {"__model__": type(v).__name__, "config": v.get_config()}
                if isinstance(v, SeparationModelMixin) else v
                for k, v in self._config.items()}

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


def _rebuild_config(config: Dict[str, Any], device) -> Dict[str, Any]:
    """Nested {"__model__", "config"} entries -> models on `device`."""
    return {k: get_model_class(v["__model__"])(**_rebuild_config(v["config"], device),
                                               device=device)
            if isinstance(v, dict) and "__model__" in v else v
            for k, v in config.items()}


def load_model(path: str, device="cpu"):
    """Rebuild the model a `save_model` checkpoint holds, with its weights, on `device`."""
    blob = read_checkpoint(path)
    config = _rebuild_config({k: v for k, v in blob.items() if k not in _NOT_CONFIG}, device)
    model = get_model_class(blob["model_class"])(**config, device=device)
    model.load_state_dict(blob["state_dict"])
    return model.eval()
