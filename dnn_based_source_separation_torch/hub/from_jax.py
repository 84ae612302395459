"""JAX param tree -> port state_dict: the inverse of `hub/torch_convert.py`.

`conv_tasnet_state_dict_from_jax`, `dprnn_tasnet_state_dict_from_jax`,
`open_unmix_state_dict_from_jax` and `xumx_state_dict_from_jax` undo
`dnn_based_source_separation_tpu/hub/torch_convert.py:convert_conv_tasnet`,
`convert_dprnn_tasnet`, `convert_open_unmix` and `convert_xumx` exactly
(transposes and reshapes only, and the LSTM's single bias split as b + 0),
so JAX-trained weights load into the port, and converting back gives the
same tree bit for bit. GRU and stream-safe DPRNN-TasNet trees, which
`convert_dprnn_tasnet` does not write, load the same way; so do GRU UMX
trees, and ParallelOpenUnmix's (`parallel_open_unmix_state_dict_from_jax`).
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


def _filterbank(sd: Dict, p: Mapping, C: int) -> None:
    """The encoder's and decoder's entries: trainable, gated, Fourier (or none, pinv)."""
    enc = p["encoder"]
    if "kernel" in enc:  # (C*L, N)
        kernel = np.asarray(enc["kernel"])
        sd["encoder.conv1d.weight"] = _t(kernel.T.reshape(kernel.shape[1], C, -1))
    elif "kernel_U" in enc:  # gated: reference names encoder.conv1d_U / conv1d_V
        for gate in ("U", "V"):
            kernel = np.asarray(enc[f"kernel_{gate}"])
            sd[f"encoder.conv1d_{gate}.weight"] = _t(kernel.T.reshape(kernel.shape[1], C, -1))
    for name in ("frequency", "window", "phase"):  # Fourier
        if name in enc:
            sd[f"encoder.{name}"] = _t(enc[name])
    dec = p.get("decoder", {})  # none for pinv: it rides the encoder's kernel
    if "kernel" in dec:  # (N, C*L)
        kernel = np.asarray(dec["kernel"])
        sd["decoder.conv_transpose1d.weight"] = _t(kernel.reshape(kernel.shape[0], C, -1))
    for name in ("frequency", "optimal_window", "phase"):  # Fourier
        if name in dec:
            sd[f"decoder.{name}"] = _t(dec[name])


def _conv(sd: Dict, prefix: str, conv: Mapping) -> None:
    """flax nn.Conv {kernel (K, in, out), bias} -> torch Conv1d weight (out, in, K), bias."""
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(conv["kernel"]), (2, 1, 0)))
    sd[f"{prefix}.bias"] = _t(conv["bias"])


def conv_tasnet_state_dict_from_jax(params: Mapping, config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ConvTasNet variables ({"params": ...} or the bare tree) -> port state_dict.

    Every filterbank of `choose_filterbank`, separable and non-separable
    residual blocks, dilated or strided; norms and PReLUs where the config has them.
    """
    p = params["params"] if "params" in params else params
    causal = bool(config.get("causal", False))
    norm_cls = "CumulativeLayerNorm_0" if causal else "GlobalLayerNorm_0"
    C = int(config.get("in_channels", 1) or 1)
    sd: Dict[str, torch.Tensor] = {}
    _filterbank(sd, p, C)

    sep = p["separator"]
    _norm(sd, "separator.norm1d", sep[norm_cls])
    _pointwise(sd, "separator.bottleneck_conv1d", sep["bottleneck_conv1d"])
    for r in range(int(config.get("sep_num_blocks", 3))):
        for x in range(int(config.get("sep_num_layers", 8))):
            layer = sep["tdcn"][f"block{r}"][f"layer{x}"]
            ref = f"separator.tdcn.net.{r}.net.{x}"
            _pointwise(sd, f"{ref}.bottleneck_conv1d", layer["bottleneck_conv1d"])
            if "nonlinear1d" in layer:
                _prelu(sd, f"{ref}.nonlinear1d", layer["nonlinear1d"])
            if norm_cls in layer:
                _norm(sd, f"{ref}.norm1d", layer[norm_cls])
            if "separable_conv1d" not in layer:  # non-separable: dilated output / skip convs
                for head in ("output_conv1d", "skip_conv1d"):
                    if head in layer:
                        _conv(sd, f"{ref}.{head}", layer[head])
                continue
            conv, sc = layer["separable_conv1d"], f"{ref}.separable_conv1d"
            dw = conv["depthwise_conv1d"]  # (K, 1, C), shifted or strided
            sd[f"{sc}.depthwise_conv1d.weight"] = _t(np.transpose(np.asarray(dw["kernel"]), (2, 1, 0)))
            sd[f"{sc}.depthwise_conv1d.bias"] = _t(dw["bias"])
            if "nonlinear1d" in conv:
                _prelu(sd, f"{sc}.nonlinear1d", conv["nonlinear1d"])
            if norm_cls in conv:
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


def _gru(sd: Dict, prefix: str, rnn: Mapping) -> None:
    """ops.rnn.GRU {w_ih (F, 3H), w_hh (H, 3H), b_ih, b_hh (3H,)} per layer and direction ->
    nn.GRU weight_ih (3H, F), weight_hh (3H, H), bias_ih, bias_hh: transposes only."""
    for name in rnn:
        if not name.startswith("w_ih"):
            continue
        sfx = name[len("w_ih"):]
        sd[f"{prefix}.weight_ih{sfx}"] = _t(np.asarray(rnn[name]).T)
        sd[f"{prefix}.weight_hh{sfx}"] = _t(np.asarray(rnn[f"w_hh{sfx}"]).T)
        sd[f"{prefix}.bias_ih{sfx}"] = _t(rnn[f"b_ih{sfx}"])
        sd[f"{prefix}.bias_hh{sfx}"] = _t(rnn[f"b_hh{sfx}"])


_RNN = {"lstm": _lstm, "gru": _gru}


def dprnn_tasnet_state_dict_from_jax(params: Mapping, config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX DPRNNTasNet variables ({"params": ...} or the bare tree) -> port state_dict.

    The inverse of `hub/torch_convert.py:convert_dprnn_tasnet`, for
    `rnn_type` 'lstm' or 'gru'. Each norm's flax name follows from the
    config (JAX `models/dprnn.py`): the intra-chunk norm is a cLN when
    `stream_safe`, else a gLN; the inter-chunk and top norms are cLNs when
    `causal`. With `sep_norm`, a missing norm raises KeyError.
    """
    p = params["params"] if "params" in params else params
    causal = bool(config.get("causal", True))
    stream_safe = bool(config.get("stream_safe", False))
    norm = bool(config.get("sep_norm", True))
    rnn_type = config.get("rnn_type", "lstm")
    if rnn_type not in _RNN:
        raise NotImplementedError(f"rnn_type {rnn_type!r} has no port converter")
    top_norm = "CumulativeLayerNorm_0" if causal else "GlobalLayerNorm_0"
    intra_norm = "CumulativeLayerNorm_0" if stream_safe else "GlobalLayerNorm_0"
    C = int(config.get("in_channels", 1) or 1)
    sd: Dict[str, torch.Tensor] = {}

    _filterbank(sd, p, C)

    sep = p["separator"]
    _norm(sd, "separator.norm1d", sep[top_norm])
    _pointwise(sd, "separator.bottleneck_conv1d", sep["bottleneck_conv1d"])
    for i in range(int(config.get("sep_num_blocks", 6))):
        block = sep["dprnn"][f"block{i}"]
        for part, norm_name in (("intra_chunk_block", intra_norm),
                                ("inter_chunk_block", top_norm)):
            ref = f"separator.dprnn.net.{i}.{part}"
            _RNN[rnn_type](sd, f"{ref}.rnn", block[part]["rnn"])
            _linear(sd, f"{ref}.fc", block[part]["fc"])
            if norm:
                if norm_name not in block[part]:
                    raise KeyError(f"block{i}.{part} has no {norm_name} for this config "
                                   f"(causal={causal}, stream_safe={stream_safe}); it holds "
                                   f"{sorted(block[part])}")
                _norm(sd, f"{ref}.norm1d", block[part][norm_name])
    _prelu(sd, "separator.prelu", sep["prelu"])
    _pointwise(sd, "separator.mask_conv1d", sep["mask_conv1d"])
    return sd


def _transform_block(sd: Dict, prefix: str, params: Mapping, stats: Mapping) -> None:
    """umx.TransformBlock1d {linear {kernel (in, out)}, norm {scale, bias}} and its
    batch_stats {norm {mean, var}} -> fc.weight (out, in) and the BatchNorm1d entries."""
    sd[f"{prefix}.fc.weight"] = _t(np.asarray(params["linear"]["kernel"]).T)
    sd[f"{prefix}.norm1d.weight"] = _t(params["norm"]["scale"])
    sd[f"{prefix}.norm1d.bias"] = _t(params["norm"]["bias"])
    sd[f"{prefix}.norm1d.running_mean"] = _t(stats["norm"]["mean"])
    sd[f"{prefix}.norm1d.running_var"] = _t(stats["norm"]["var"])
    sd[f"{prefix}.norm1d.num_batches_tracked"] = torch.tensor(0)


def _unmix(sd: Dict, prefix: str, p: Mapping, s: Mapping, names: Mapping,
           rnn_type: str) -> None:
    """One OpenUnmix backbone; `names` maps the port's names (scale_in, ..., block,
    net.0, net.1, rnn) to the JAX tree's."""
    for name in ("scale_in", "bias_in", "scale_out", "bias_out"):
        sd[f"{prefix}{name}"] = _t(p[names[name]])
    for ours in ("block", "net.0", "net.1"):
        _transform_block(sd, f"{prefix}{ours}", p[names[ours]], s[names[ours]])
    _RNN[rnn_type](sd, f"{prefix}rnn", p[names["rnn"]])


_UNMIX_NAMES = {n: n for n in ("scale_in", "bias_in", "scale_out", "bias_out", "block", "rnn")}
_UNMIX_NAMES.update({"net.0": "net0", "net.1": "net1"})


def open_unmix_state_dict_from_jax(variables: Mapping, config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX OpenUnmix variables {"params", "batch_stats"} -> port state_dict.

    The inverse of `hub/torch_convert.py:convert_open_unmix`: Dense kernels
    transposed, BatchNorm's scale and bias from params and its running mean
    and variance from batch_stats, the LSTM's single bias into bias_ih with a
    zero bias_hh (`_lstm`); `rnn_type` 'gru' too.
    """
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _unmix(sd, "", p, s, _UNMIX_NAMES, config.get("rnn_type", "lstm"))
    return sd


def parallel_open_unmix_state_dict_from_jax(variables: Mapping,
                                            config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ParallelOpenUnmix variables (`backbone_<source>` subtrees) -> port state_dict
    (`backbone.<source>.*`)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for source in config["sources"]:
        key = f"backbone_{source}"
        _unmix(sd, f"backbone.{source}.", p[key], s[key], _UNMIX_NAMES,
               config.get("rnn_type", "lstm"))
    return sd


def xumx_state_dict_from_jax(variables: Mapping, config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX CrossNetOpenUnmix variables (`scale_in_<source>`, `block_<source>`, ...,
    `rnn_<source>`) -> port state_dict (`backbone.<source>.*`): the inverse of
    `hub/torch_convert.py:convert_xumx`."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for source in config["sources"]:
        names = {ours: f"{jax}_{source}" for ours, jax in _UNMIX_NAMES.items()}
        _unmix(sd, f"backbone.{source}.", p, s, names, config.get("rnn_type", "lstm"))
    return sd
