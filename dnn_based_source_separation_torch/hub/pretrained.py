"""build_from_pretrained with a pluggable fetcher.

Port of `dnn_based_source_separation_tpu/hub/pretrained.py` (reference
`src/models/conv_tasnet.py:238-310` build_from_pretrained and `src/utils/utils.py:36-47`'s
download). Nothing is fetched here: pass a `fetcher`, called with the keywords `task`,
`sample_rate`, `n_sources` and `model_choice` and returning a local `.pth` path, or point
`root` at reference checkpoints laid out `<root>/<task>/sr<sr>/<n>speakers/<choice>.pth`, the
reference's download layout. The file opens through `hub/torch_checkpoint.py`.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

from .torch_checkpoint import build_from_torch_checkpoint


def build_from_pretrained(task: str = "wsj0-mix", sample_rate: int = 8000, n_sources: int = 2,
                          model_choice: str = "best", root: str = "./pretrained",
                          fetcher: Optional[Callable[..., str]] = None, device="cuda"):
    """The model of a reference pretrained checkpoint, in eval mode on `device`."""
    if fetcher is not None:
        path = fetcher(task=task, sample_rate=sample_rate, n_sources=n_sources,
                       model_choice=model_choice)
    else:
        path = os.path.join(root, task, f"sr{sample_rate}", f"{n_sources}speakers",
                            f"{model_choice}.pth")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"pretrained checkpoint not found: {path}. Download it per the "
            "reference PRETRAINED.md and place it there (no egress here).")
    return build_from_torch_checkpoint(path, device=device)
