"""Inference-time gLN affine folding for the non-causal Conv-TasNet.

Port of `dnn_based_source_separation_tpu/models/fold.py`. Each gLN's
affine (gamma * xhat + beta) feeds a linear op, so gamma folds into the
next weights and beta into the next bias:

  1x1 conv W (out, in, 1):   W' = W * gamma[in],  b' = b + W @ beta
  depthwise w (C, 1, K):     w' = gamma_c * w,    b'_c = b_c + beta_c * sum_k w[c, 0, k]

The depthwise case ('all' mode) pads the normalized frames with
-beta/gamma instead of zeros (`GlobalLayerNorm(affine=False)`), so gamma
and beta stay in the state dict.
"""
from __future__ import annotations

from typing import Dict

import torch

from .tdcn import fold_mode


def _fold_into_pointwise(sd, norm: str, head: str) -> None:
    gamma, beta = sd[f"{norm}.gamma"].reshape(-1), sd[f"{norm}.beta"].reshape(-1)
    weight = sd[f"{head}.weight"]  # (out, in, 1)
    sd[f"{head}.bias"] = sd[f"{head}.bias"] + weight[..., 0] @ beta
    sd[f"{head}.weight"] = weight * gamma[None, :, None]


def _fold_into_depthwise(sd, norm: str, dw: str) -> None:
    gamma, beta = sd[f"{norm}.gamma"].reshape(-1), sd[f"{norm}.beta"].reshape(-1)
    weight = sd[f"{dw}.weight"]  # (C, 1, K)
    sd[f"{dw}.bias"] = sd[f"{dw}.bias"] + beta * weight.sum(dim=(1, 2))
    sd[f"{dw}.weight"] = weight * gamma[:, None, None]


def fold_gln_affine(model, state_dict: Dict[str, torch.Tensor], mode: str = "heads"):
    """Fold the gLN affines of a non-causal Conv-TasNet into the adjacent weights.

    Returns (folded_model, folded_state_dict); the folded model is built on the
    device of `state_dict` and holds the folded weights. `state_dict` must be
    unfolded: a model whose config already says folded is refused, because
    folding twice applies the affine twice.
    """
    mode = fold_mode(mode)
    config = model.get_config()
    if fold_mode(config.get("fold_norm_affine")) != "none":
        raise ValueError("model is already folded "
                         f"(fold_norm_affine={config['fold_norm_affine']!r}); folding twice "
                         "would apply the gLN affines twice")
    if mode == "none":
        return model, state_dict
    if config.get("causal", True):
        raise ValueError("gLN affine folding requires a non-causal model (cLN is causal)")
    if config.get("sep_norm", True) and not config.get("separable", True):
        raise NotImplementedError("affine folding is implemented for the separable TDCN")

    sd = {k: v.clone() for k, v in state_dict.items()}
    _fold_into_pointwise(sd, "separator.norm1d", "separator.bottleneck_conv1d")
    if config.get("sep_norm", True):
        for r in range(config["sep_num_blocks"]):
            for x in range(config["sep_num_layers"]):
                layer = f"separator.tdcn.net.{r}.net.{x}"
                conv = f"{layer}.separable_conv1d"
                if mode == "all":
                    _fold_into_depthwise(sd, f"{layer}.norm1d", f"{conv}.depthwise_conv1d")
                for head in ("output_pointwise_conv1d", "skip_pointwise_conv1d"):
                    if f"{conv}.{head}.weight" in sd:
                        _fold_into_pointwise(sd, f"{conv}.norm1d", f"{conv}.{head}")

    device = next(iter(sd.values())).device
    folded = type(model)(**dict(config, fold_norm_affine=mode), device=device)
    folded.load_state_dict(sd)
    folded.train(model.training)
    return folded, sd


def fold_for_serving(model):
    """`model` with its gLN affines folded ('heads' mode) where the separate CLIs fold:
    a non-causal Conv-TasNet, separable or without separator norms, not folded yet.
    Any other model (a causal one, DPRNN-TasNet, a checkpoint saved folded) comes back
    as it was."""
    from .conv_tasnet import ConvTasNet

    if (isinstance(model, ConvTasNet) and not model.causal
            and (model.separable or not model.sep_norm)
            and fold_mode(model.fold_norm_affine) == "none"):
        model, _ = fold_gln_affine(model, model.state_dict(), mode="heads")
    return model
