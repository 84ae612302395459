"""The flagship model and a forward on it: the port of `__graft_entry__.py:17-51`.

    from dnn_based_source_separation_torch.entry import entry
    forward, (model, mixture) = entry()      # on the card
    estimates = forward(model, mixture)      # (1, 2, 32000)

`flagship()` builds paper-config Conv-TasNet, N512 L16 B128 H512 Sc128 P3
X8 R3, non-causal, relu encoder and sigmoid masks (reference
egs/wsj0-mix/conv-tasnet/README.md:5), with weights from a
`torch.Generator`; `tiny=True` gives a narrow one of the same kind for
tests. The multi-device dry run (`dryrun_multichip`) comes with data
parallelism.
"""
from __future__ import annotations

import torch

from .models import ConvTasNet
from .utils.device import resolve_device

SAMPLE_RATE = 8000

PAPER = dict(
    n_basis=512, kernel_size=16, stride=8, enc_basis="trainable", dec_basis="trainable",
    enc_nonlinear="relu", sep_hidden_channels=512, sep_bottleneck_channels=128,
    sep_skip_channels=128, sep_kernel_size=3, sep_num_blocks=3, sep_num_layers=8,
    causal=False, n_sources=2,
)
TINY = dict(
    n_basis=16, kernel_size=8, stride=4, enc_basis="trainable", dec_basis="trainable",
    enc_nonlinear="relu", sep_hidden_channels=16, sep_bottleneck_channels=8,
    sep_skip_channels=8, sep_num_blocks=1, sep_num_layers=2, causal=False, n_sources=2,
)


def flagship(tiny: bool = False, *, device, generator: torch.Generator | None = None,
             **overrides) -> ConvTasNet:
    """Paper-config Conv-TasNet (or the tiny one) on `device`; `overrides` change config
    fields, e.g. causal=True."""
    config = dict(TINY if tiny else PAPER, **overrides)
    return ConvTasNet(**config, generator=generator, device=device).eval()


def entry(device="cuda"):
    """(forward, (model, mixture)): the flagship forward on one 4 s mixture of zeros."""
    device = resolve_device(device, stream=None)
    model = flagship(device=device, generator=torch.Generator().manual_seed(0))
    mixture = torch.zeros((1, 1, 4 * SAMPLE_RATE), device=device)

    def forward(model, mixture):
        with torch.inference_mode():
            return model(mixture)

    return forward, (model, mixture)


if __name__ == "__main__":
    fn, args = entry()
    print(f"entry forward: {tuple(fn(*args).shape)}")
