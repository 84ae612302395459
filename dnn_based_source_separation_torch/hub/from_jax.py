"""JAX param tree -> port state_dict: the inverse of `hub/torch_convert.py`.

`conv_tasnet_state_dict_from_jax` and `dprnn_tasnet_state_dict_from_jax`
undo `dnn_based_source_separation_tpu/hub/torch_convert.py:convert_conv_tasnet`
and `convert_dprnn_tasnet` exactly (transposes and reshapes only, and the
LSTM's single bias split as b + 0), so JAX-trained weights load into the
port, and converting back gives the same tree bit for bit.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _pointwise(sd: Dict, prefix: str, dense: Mapping) -> None:
    """Dense {kernel (in, out), bias} -> 1x1 Conv1d weight (out, in, 1), bias."""
    sd[f"{prefix}.weight"] = _t(np.asarray(dense["kernel"]).T[..., None])
    sd[f"{prefix}.bias"] = _t(dense["bias"])


def _norm(sd: Dict, prefix: str, norm: Mapping) -> None:
    """{gamma, beta} (N,) -> gamma/beta (1, N, 1)."""
    for name in ("gamma", "beta"):
        sd[f"{prefix}.{name}"] = _t(np.asarray(norm[name]).reshape(1, -1, 1))


def _prelu(sd: Dict, prefix: str, prelu: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(prelu["alpha"]).reshape(1))


def conv_tasnet_state_dict_from_jax(params: Mapping, config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ConvTasNet variables ({"params": ...} or the bare tree) -> port state_dict."""
    p = params["params"] if "params" in params else params
    causal = bool(config.get("causal", False))
    norm_cls = "CumulativeLayerNorm_0" if causal else "GlobalLayerNorm_0"
    C = int(config.get("in_channels", 1) or 1)
    sd: Dict[str, torch.Tensor] = {}

    enc = np.asarray(p["encoder"]["kernel"])  # (C*L, N)
    sd["encoder.conv1d.weight"] = _t(enc.T.reshape(enc.shape[1], C, -1))
    dec = np.asarray(p["decoder"]["kernel"])  # (N, C*L)
    sd["decoder.conv_transpose1d.weight"] = _t(dec.reshape(dec.shape[0], C, -1))

    sep = p["separator"]
    _norm(sd, "separator.norm1d", sep[norm_cls])
    _pointwise(sd, "separator.bottleneck_conv1d", sep["bottleneck_conv1d"])
    for r in range(int(config.get("sep_num_blocks", 3))):
        for x in range(int(config.get("sep_num_layers", 8))):
            layer = sep["tdcn"][f"block{r}"][f"layer{x}"]
            ref = f"separator.tdcn.net.{r}.net.{x}"
            _pointwise(sd, f"{ref}.bottleneck_conv1d", layer["bottleneck_conv1d"])
            _prelu(sd, f"{ref}.nonlinear1d", layer["nonlinear1d"])
            _norm(sd, f"{ref}.norm1d", layer[norm_cls])
            conv, sc = layer["separable_conv1d"], f"{ref}.separable_conv1d"
            dw = conv["depthwise_conv1d"]
            sd[f"{sc}.depthwise_conv1d.weight"] = _t(np.transpose(np.asarray(dw["kernel"]), (2, 1, 0)))
            sd[f"{sc}.depthwise_conv1d.bias"] = _t(dw["bias"])
            _prelu(sd, f"{sc}.nonlinear1d", conv["nonlinear1d"])
            _norm(sd, f"{sc}.norm1d", conv[norm_cls])
            if "output_pointwise_conv1d" in conv:
                _pointwise(sd, f"{sc}.output_pointwise_conv1d", conv["output_pointwise_conv1d"])
            _pointwise(sd, f"{sc}.skip_pointwise_conv1d", conv["skip_pointwise_conv1d"])
    _prelu(sd, "separator.prelu", sep["prelu"])
    _pointwise(sd, "separator.mask_conv1d", sep["mask_conv1d"])
    return sd


def _linear(sd: Dict, prefix: str, dense: Mapping) -> None:
    """Dense {kernel (in, out), bias} -> nn.Linear weight (out, in), bias."""
    sd[f"{prefix}.weight"] = _t(np.asarray(dense["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(dense["bias"])


def _lstm(sd: Dict, prefix: str, rnn: Mapping) -> None:
    """ops.rnn.LSTM {w_ih (F, 4H), w_hh (H, 4H), b (4H,)} per layer and direction ->
    nn.LSTM weight_ih (4H, F), weight_hh (4H, H), bias_ih, bias_hh.

    JAX keeps one bias, b = b_ih + b_hh (`hub/torch_convert.py:lstm_params`):
    it goes to bias_ih and bias_hh is zero, so converting back sums to b exactly.
    """
    for name in rnn:
        if not name.startswith("w_ih"):
            continue
        sfx = name[len("w_ih"):]
        bias = _t(rnn[f"b{sfx}"])
        sd[f"{prefix}.weight_ih{sfx}"] = _t(np.asarray(rnn[name]).T)
        sd[f"{prefix}.weight_hh{sfx}"] = _t(np.asarray(rnn[f"w_hh{sfx}"]).T)
        sd[f"{prefix}.bias_ih{sfx}"] = bias
        sd[f"{prefix}.bias_hh{sfx}"] = torch.zeros_like(bias)


def dprnn_tasnet_state_dict_from_jax(params: Mapping, config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX DPRNNTasNet variables ({"params": ...} or the bare tree) -> port state_dict.

    The inverse of `hub/torch_convert.py:convert_dprnn_tasnet`.
    """
    p = params["params"] if "params" in params else params
    causal = bool(config.get("causal", True))
    top_norm = "CumulativeLayerNorm_0" if causal else "GlobalLayerNorm_0"
    C = int(config.get("in_channels", 1) or 1)
    sd: Dict[str, torch.Tensor] = {}

    enc = np.asarray(p["encoder"]["kernel"])  # (C*L, N)
    sd["encoder.conv1d.weight"] = _t(enc.T.reshape(enc.shape[1], C, -1))
    dec = np.asarray(p["decoder"]["kernel"])  # (N, C*L)
    sd["decoder.conv_transpose1d.weight"] = _t(dec.reshape(dec.shape[0], C, -1))

    sep = p["separator"]
    _norm(sd, "separator.norm1d", sep[top_norm])
    _pointwise(sd, "separator.bottleneck_conv1d", sep["bottleneck_conv1d"])
    for i in range(int(config.get("sep_num_blocks", 6))):
        block = sep["dprnn"][f"block{i}"]
        for part, norm_name in (("intra_chunk_block", "GlobalLayerNorm_0"),
                                ("inter_chunk_block", top_norm)):
            ref = f"separator.dprnn.net.{i}.{part}"
            _lstm(sd, f"{ref}.rnn", block[part]["rnn"])
            _linear(sd, f"{ref}.fc", block[part]["fc"])
            if norm_name in block[part]:
                _norm(sd, f"{ref}.norm1d", block[part][norm_name])
    _prelu(sd, "separator.prelu", sep["prelu"])
    _pointwise(sd, "separator.mask_conv1d", sep["mask_conv1d"])
    return sd
