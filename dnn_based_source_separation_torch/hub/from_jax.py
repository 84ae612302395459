"""JAX param tree -> port state_dict: the inverse of `hub/torch_convert.py`.

`conv_tasnet_state_dict_from_jax`, `dprnn_tasnet_state_dict_from_jax`,
`dptnet_state_dict_from_jax`, `lstm_tasnet_state_dict_from_jax`,
`sepformer_state_dict_from_jax`, `galrnet_state_dict_from_jax`,
`open_unmix_state_dict_from_jax` and `xumx_state_dict_from_jax` undo
`dnn_based_source_separation_tpu/hub/torch_convert.py:convert_conv_tasnet`,
`convert_dprnn_tasnet`, `convert_dptnet`, `convert_lstm_tasnet`, `convert_sepformer`,
`convert_galrnet`, `convert_open_unmix` and `convert_xumx` exactly
(transposes and reshapes only, and the LSTM's single bias split as b + 0),
so JAX-trained weights load into the port, and converting back gives the
same tree bit for bit. GRU, RNN, SRU and stream-safe DPRNN-TasNet trees,
which `convert_dprnn_tasnet` does not write, load the same way; so do GRU
UMX trees, and ParallelOpenUnmix's (`parallel_open_unmix_state_dict_from_jax`).
`mrx_state_dict_from_jax` undoes `convert_mrx`. FurcaNet, Meta-TasNet and
WaveNet have no converter in the JAX package: `furcanet_state_dict_from_jax`,
`meta_tasnet_state_dict_from_jax` and `wavenet_state_dict_from_jax` map their
JAX trees onto the port's names, which follow those trees; so does
`wavesplit_state_dict_from_jax`. `danet_state_dict_from_jax` and
`adanet_state_dict_from_jax` undo `convert_danet` / `convert_adanet` (the
reference's `rnn.*`, `fc`, `anchor`); `deep_embedding_state_dict_from_jax` maps
DeepEmbedding, DeepEmbeddingPlus and ChimeraNet (`fc_embedding`, `fc_mask`) onto
the same torch names, and FixedAttractorDANet's `base` and `attractor`.
`d3net_state_dict_from_jax`, `mm_densenet_state_dict_from_jax` and
`mm_dense_rnn_state_dict_from_jax` undo `convert_d3net`, `convert_mm_densenet` and
`convert_mm_dense_rnn` (the transposed convs' kernels flipped back), so the port's state
dicts go back into JAX through them; `m_densenet_state_dict_from_jax` maps the single-band
MDenseNet onto the same names, and `parallel_state_dict_from_jax` any of them stem by stem.
HRNet, the U-Nets and CUNet have no converter in the JAX package:
`hrnet_state_dict_from_jax`, `unet_state_dict_from_jax` and `cunet_state_dict_from_jax`
map their JAX trees onto the port's names, which follow those trees.
"""
from __future__ import annotations

import re
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
    """flax nn.Conv (or nn.ConvTranspose) {kernel (K, in, out), bias if it has one} -> torch
    Conv1d weight (out, in, K), bias."""
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(conv["kernel"]), (2, 1, 0)))
    if "bias" in conv:
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


def _sru(sd: Dict, prefix: str, rnn: Mapping) -> None:
    """ops.rnn.SRU {w_ih (F, 3H), b (2H,), w_hx (F, H) when F != H} per layer and direction
    -> weight_ih (3H, F), bias (2H,), weight_hx (H, F): transposes only."""
    for name in rnn:
        if not name.startswith("w_ih"):
            continue
        sfx = name[len("w_ih"):]
        sd[f"{prefix}.weight_ih{sfx}"] = _t(np.asarray(rnn[name]).T)
        sd[f"{prefix}.bias{sfx}"] = _t(rnn[f"b{sfx}"])
        if f"w_hx{sfx}" in rnn:
            sd[f"{prefix}.weight_hx{sfx}"] = _t(np.asarray(rnn[f"w_hx{sfx}"]).T)


# The vanilla RNN's tree is the LSTM's at one gate: {w_ih, w_hh, b} -> the same names.
_RNN = {"lstm": _lstm, "gru": _gru, "rnn": _lstm, "sru": _sru}


def dprnn_tasnet_state_dict_from_jax(params: Mapping, config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX DPRNNTasNet variables ({"params": ...} or the bare tree) -> port state_dict.

    The inverse of `hub/torch_convert.py:convert_dprnn_tasnet`, for
    every `rnn_type` ('lstm', 'gru', 'rnn', 'sru'). Each norm's flax name follows from the
    config (JAX `models/dprnn.py`): the intra-chunk norm is a cLN when
    `stream_safe`, else a gLN; the inter-chunk and top norms are cLNs when
    `causal`. With `sep_norm`, a missing norm raises KeyError.
    """
    p = params["params"] if "params" in params else params
    causal = bool(config.get("causal", True))
    stream_safe = bool(config.get("stream_safe", False))
    norm = bool(config.get("sep_norm", True))
    rnn_type = config.get("rnn_type", "lstm")
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


def _mha(sd: Dict, prefix: str, mha: Mapping) -> None:
    """ops.attention.MultiheadAttention {in_proj, out_proj} -> torch nn.MultiheadAttention's
    in_proj_weight (3E, E), in_proj_bias, out_proj.{weight,bias} (the inverse of
    `hub/torch_convert.py:_mha_params`)."""
    sd[f"{prefix}.in_proj_weight"] = _t(np.asarray(mha["in_proj"]["kernel"]).T)
    sd[f"{prefix}.in_proj_bias"] = _t(mha["in_proj"]["bias"])
    _linear(sd, f"{prefix}.out_proj", mha["out_proj"])


def _layer_norm(sd: Dict, prefix: str, norm: Mapping) -> None:
    """flax nn.LayerNorm {scale, bias} -> torch nn.LayerNorm weight, bias."""
    sd[f"{prefix}.weight"] = _t(norm["scale"])
    sd[f"{prefix}.bias"] = _t(norm["bias"])


def _improved_transformer(sd: Dict, prefix: str, p: Mapping, norm_cls: str,
                          norm: bool) -> None:
    """models.dptnet.ImprovedTransformer {multihead_attn {in_proj, out_proj}, <norm>_0, rnn,
    fc, <norm>_1} -> {prefix}.{multihead_attn_block.{multihead_attn,norm1d},
    subnet.{rnn,fc,norm1d}} (the inverse of `hub/torch_convert.py:_improved_transformer_params`)."""
    _mha(sd, f"{prefix}.multihead_attn_block.multihead_attn", p["multihead_attn"])
    _lstm(sd, f"{prefix}.subnet.rnn", p["rnn"])
    _linear(sd, f"{prefix}.subnet.fc", p["fc"])
    if norm:
        _norm(sd, f"{prefix}.multihead_attn_block.norm1d", p[f"{norm_cls}_0"])
        _norm(sd, f"{prefix}.subnet.norm1d", p[f"{norm_cls}_1"])


def _dual_path_head(sd: Dict, sep: Mapping) -> None:
    """The PReLU, `map` and GTU shared by DPTNet, SepFormer and GALRNet."""
    _prelu(sd, "separator.prelu", sep["prelu"])
    _pointwise(sd, "separator.map", sep["map"])
    _pointwise(sd, "separator.gtu.map", sep["gtu_tanh"])
    _pointwise(sd, "separator.gtu.map_gate", sep["gtu_sigmoid"])


def dptnet_state_dict_from_jax(params: Mapping, config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX DPTNet variables ({"params": ...} or the bare tree) -> port state_dict.

    The inverse of `hub/torch_convert.py:convert_dptnet`, causal or not: the
    intra-chunk blocks are never causal (gLNs, a bidirectional LSTM); when
    `causal` the top and inter-chunk norms are cLNs (`CumulativeLayerNorm_0/1`)
    and the inter-chunk LSTM has one direction.
    """
    p = params["params"] if "params" in params else params
    causal = bool(config.get("causal", False))
    norm = bool(config.get("sep_norm", True))
    top_norm = "CumulativeLayerNorm" if causal else "GlobalLayerNorm"
    C = int(config.get("in_channels", 1) or 1)
    sd: Dict[str, torch.Tensor] = {}
    _filterbank(sd, p, C)

    sep = p["separator"]
    _pointwise(sd, "separator.bottleneck_conv1d", sep["bottleneck_conv1d"])
    _norm(sd, "separator.norm2d", sep[f"{top_norm}_0"])
    for i in range(int(config.get("sep_num_blocks", 6))):
        block, ref = sep[f"block{i}"], f"separator.dptransformer.net.{i}"
        _improved_transformer(sd, f"{ref}.intra_chunk_block.transformer",
                              block["intra_chunk_block"], "GlobalLayerNorm", norm)
        _improved_transformer(sd, f"{ref}.inter_chunk_block.transformer",
                              block["inter_chunk_block"], top_norm, norm)
    _dual_path_head(sd, sep)
    return sd


def lstm_tasnet_state_dict_from_jax(params: Mapping,
                                    config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX LSTMTasNet variables ({"params": ...} or the bare tree) -> port state_dict.

    The inverse of `hub/torch_convert.py:convert_lstm_tasnet`: the gated
    (`conv1d_U` / `conv1d_V`) or trainable encoder, the separator's norm
    `gamma` / `beta` (N,), one stacked (Bi)LSTM a block (`separator.rnn.{i}`;
    a GRU tree too) and `fc`.
    """
    p = params["params"] if "params" in params else params
    rnn_type = config.get("rnn_type", "lstm")
    sd: Dict[str, torch.Tensor] = {}
    _filterbank(sd, p, int(config.get("in_channels", 1) or 1))
    sep = p["separator"]
    for name in ("gamma", "beta"):
        sd[f"separator.{name}"] = _t(sep[name])
    for i in range(int(config.get("sep_num_blocks", 2))):
        _RNN[rnn_type](sd, f"separator.rnn.{i}", sep[f"rnn{i}"])
    _linear(sd, "separator.fc", sep["fc"])
    return sd


def sepformer_state_dict_from_jax(params: Mapping, config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX SepFormer variables ({"params": ...} or the bare tree) -> port state_dict.

    The inverse of `hub/torch_convert.py:convert_sepformer`, causal or not
    (the first norm a cLN or a gLN): each block's intra and inter stacks of
    `TransformerEncoderLayer`s (`layer{l}` -> `transformer.layers.{l}`, torch
    names) and their final gLN (`transformer.norm.norm1d`) where `sep_norm`.
    """
    p = params["params"] if "params" in params else params
    causal = bool(config.get("causal", False))
    top_norm = "CumulativeLayerNorm_0" if causal else "GlobalLayerNorm_0"
    sd: Dict[str, torch.Tensor] = {}
    _filterbank(sd, p, int(config.get("in_channels", 1) or 1))
    sep = p["separator"]
    _norm(sd, "separator.norm1d", sep[top_norm])
    _pointwise(sd, "separator.bottleneck_conv1d_in", sep["bottleneck_conv1d_in"])
    for b in range(int(config.get("sep_num_blocks", 2))):
        for path in ("intra_transformer", "inter_transformer"):
            tree = sep[f"block{b}"][path]
            ref = f"separator.dptransformer.net.{b}.{path}.transformer"
            layers = sorted((k for k in tree if k.startswith("layer")), key=lambda k: int(k[5:]))
            for l, name in enumerate(layers):
                layer, lref = tree[name], f"{ref}.layers.{l}"
                _mha(sd, f"{lref}.self_attn", layer["self_attn"])
                for part in ("linear1", "linear2"):
                    _linear(sd, f"{lref}.{part}", layer[part])
                for part in ("norm1", "norm2"):
                    _layer_norm(sd, f"{lref}.{part}", layer[part])
            if "GlobalLayerNorm_0" in tree:
                _norm(sd, f"{ref}.norm.norm1d", tree["GlobalLayerNorm_0"])
    _dual_path_head(sd, sep)
    _pointwise(sd, "separator.bottleneck_conv1d_out", sep["bottleneck_conv1d_out"])
    return sd


def galrnet_state_dict_from_jax(params: Mapping, config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX GALRNet variables ({"params": ...} or the bare tree) -> port state_dict.

    The inverse of `hub/torch_convert.py:convert_galrnet`, causal (the JAX
    class default) or not: per block the intra-chunk biLSTM, `fc` and gLN,
    then the globally attentive block's `norm_in` (-> `norm2d_in.norm`), the
    attention, its gLN or cLN (-> `norm2d_out`) and, in the low-dimension
    variant, `fc_map` / `fc_inv`.
    """
    p = params["params"] if "params" in params else params
    causal = bool(config.get("causal", True))
    top_norm = "CumulativeLayerNorm_0" if causal else "GlobalLayerNorm_0"
    sd: Dict[str, torch.Tensor] = {}
    _filterbank(sd, p, int(config.get("in_channels", 1) or 1))
    sep = p["separator"]
    _norm(sd, "separator.norm2d", sep[top_norm])
    for i in range(int(config.get("sep_num_blocks", 6))):
        block, ref = sep["galr"][f"block{i}"], f"separator.galr.net.{i}"
        intra, inter = block["intra_chunk_block"], block["inter_chunk_block"]
        _lstm(sd, f"{ref}.intra_chunk_block.rnn", intra["rnn"])
        _linear(sd, f"{ref}.intra_chunk_block.fc", intra["fc"])
        if "GlobalLayerNorm_0" in intra:
            _norm(sd, f"{ref}.intra_chunk_block.norm1d", intra["GlobalLayerNorm_0"])
        gref = f"{ref}.inter_chunk_block"
        for part in ("fc_map", "fc_inv"):
            if part in inter:
                _linear(sd, f"{gref}.{part}", inter[part])
        if "norm_in" in inter:
            _layer_norm(sd, f"{gref}.norm2d_in.norm", inter["norm_in"])
            _norm(sd, f"{gref}.norm2d_out", inter[top_norm])
        _mha(sd, f"{gref}.multihead_attn", inter["multihead_attn"])
    _dual_path_head(sd, sep)
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


def furcanet_state_dict_from_jax(params: Mapping, config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX FurcaNet variables ({"params": ...} or the bare tree) -> port state_dict.

    The JAX package has no converter of the reference layout for FurcaNet; the
    port's names follow the JAX tree: `gcn.conv{i}` / `gcn.gate{i}` from flax
    Convs, `gcn.norm{i}` from the i-th `GlobalLayerNorm` (`CumulativeLayerNorm`
    when causal), `rnn_blocks` from the stacked BiLSTM, `fc` from the Dense.
    """
    p = params["params"] if "params" in params else params
    norm_cls = "CumulativeLayerNorm" if config.get("causal", False) else "GlobalLayerNorm"
    sd: Dict[str, torch.Tensor] = {}
    gcn = p["gcn"]
    for idx in range(int(config.get("num_conv_blocks", 10))):
        _conv(sd, f"gcn.conv{idx}", gcn[f"conv{idx}"])
        _conv(sd, f"gcn.gate{idx}", gcn[f"gate{idx}"])
        if f"{norm_cls}_{idx}" in gcn:
            _norm(sd, f"gcn.norm{idx}", gcn[f"{norm_cls}_{idx}"])
    _lstm(sd, "rnn_blocks", p["rnn_blocks"])
    _linear(sd, "fc", p["fc"])
    return sd


def mrx_state_dict_from_jax(variables: Mapping, config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX MultiResolutionCrossNet variables {"params", "batch_stats"} -> port state_dict:
    the inverse of `hub/torch_convert.py:convert_mrx` (`enc_block{i}`, `rnn{i}`,
    `dec_<source>_<i>_net0/1`, `scale_out_<source>_<i>`, `bias_out_<source>_<i>`)."""
    p, s = variables["params"], variables["batch_stats"]
    rnn = _RNN[config.get("rnn_type", "lstm")]
    sd: Dict[str, torch.Tensor] = {}
    for i in range(len(config["n_fft"])):
        _transform_block(sd, f"encoder_blocks.{i}.block", p[f"enc_block{i}"],
                         s[f"enc_block{i}"])
        rnn(sd, f"encoder_blocks.{i}.rnn", p[f"rnn{i}"])
    for source in config["sources"]:
        for i in range(len(config["n_fft"])):
            ref = f"decoder_blocks.{source}.{i}"
            for ours, name in (("net.0", "net0"), ("net.1", "net1")):
                key = f"dec_{source}_{i}_{name}"
                _transform_block(sd, f"{ref}.{ours}", p[key], s[key])
            sd[f"{ref}.scale_out"] = _t(p[f"scale_out_{source}_{i}"])
            sd[f"{ref}.bias_out"] = _t(p[f"bias_out_{source}_{i}"])
    return sd


def _generated(sd: Dict, prefix: str, tree: Mapping) -> None:
    """A generated conv or norm: each of its Dense layers -> nn.Linear."""
    for name in ("bottleneck", "linear", "linear_scale", "linear_bias"):
        if name in tree:
            _linear(sd, f"{prefix}.{name}", tree[name])


def meta_tasnet_state_dict_from_jax(params: Mapping, config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX MetaTasNet variables ({"params": ...} or the bare tree) -> port state_dict.

    The JAX package has no converter of the reference layout for Meta-TasNet; the port's
    names follow the JAX tree (`models/meta_tasnet.py`): the embedding, the trainable
    encoder and decoder (`_filterbank`), each generated conv's and norm's Dense layers,
    each block's shared depthwise conv.
    """
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {"instrument_embedding": _t(p["instrument_embedding"])}
    _filterbank(sd, p, 1)
    for name in ("in_conv", "mask_conv"):
        _generated(sd, name, p[name])
    for b in range(int(config.get("sep_num_blocks", 2))):
        for l in range(int(config.get("sep_num_layers", 4))):
            block, ref = p[f"block{b}_{l}"], f"block{b}_{l}"
            for name in ("bottleneck_conv", "norm1", "norm2", "out_conv", "skip_conv"):
                _generated(sd, f"{ref}.{name}", block[name])
            _conv(sd, f"{ref}.depthwise", block["depthwise"])
    return sd


def wavenet_state_dict_from_jax(params: Mapping, config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX WaveNet variables ({"params": ...} or the bare tree) -> port state_dict, named as
    the JAX tree is (`models/wavenet.py`); the conditioning's Dense layers and convs too."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    for name in ("causal_conv1d", "end0", "end1"):
        _conv(sd, name, p[name])
    for b in range(int(config.get("num_blocks", 3))):
        block = p[f"block{b}"]
        for l in range(int(config.get("num_layers", 10))):
            ref = f"block{b}"
            for head in ("res", "skip"):
                _conv(sd, f"{ref}.{head}{l}", block[f"{head}{l}"])
            for name, tree in block[f"gated{l}"].items():
                if name.endswith("_linear"):
                    _linear(sd, f"{ref}.gated{l}.{name}", tree)
                else:
                    _conv(sd, f"{ref}.gated{l}.{name}", tree)
    return sd


def _conv_unit(sd: Dict, prefix: str, unit: Mapping) -> None:
    """Wavesplit's _ConvUnit: depthwise conv {kernel (K, 1, C)} and pointwise Dense, or one
    conv; its gLN or cLN {gamma, beta} (N,) -> `norm.gamma` / `norm.beta` (1, N, 1)."""
    if "depthwise" in unit:
        _conv(sd, f"{prefix}.depthwise", unit["depthwise"])
        _linear(sd, f"{prefix}.pointwise", unit["pointwise"])
    else:
        _conv(sd, f"{prefix}.conv", unit["conv"])
    for name in ("GlobalLayerNorm_0", "CumulativeLayerNorm_0"):
        if name in unit:
            _norm(sd, f"{prefix}.norm", unit[name])


def wavesplit_state_dict_from_jax(params: Mapping, config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX WaveSplit variables ({"params": ...} or the bare tree) -> port state_dict, named
    as the JAX tree is (`models/wavesplit.py`); the JAX package has no converter of the
    reference layout for Wavesplit."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {"spk_embedding": _t(p["spk_embedding"])}
    spk, sep = p["speaker_stack"], p["separation_stack"]
    for i in range(int(config.get("spk_num_layers", 14))):
        _conv_unit(sd, f"speaker_stack.layer{i}", spk[f"layer{i}"])
    _conv(sd, "separation_stack.conv_in", sep["conv_in"])
    for name, tree in sep.items():
        if name.startswith("block"):
            _conv_unit(sd, f"separation_stack.{name}", tree)
        elif name != "conv_in":
            _linear(sd, f"separation_stack.{name}", tree)
    return sd


def deep_embedding_state_dict_from_jax(params: Mapping,
                                       config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX DeepEmbedding, DeepEmbeddingPlus or ChimeraNet variables -> port state_dict:
    `rnn.*` (an LSTM, or the config's `rnn_type`) and `fc` or `fc_embedding` / `fc_mask`."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    _RNN[config.get("rnn_type", "lstm")](sd, "rnn", p["rnn"])
    for name in ("fc", "fc_embedding", "fc_mask"):
        if name in p:
            _linear(sd, name, p[name])
    return sd


def danet_state_dict_from_jax(params: Mapping, config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX DANet variables -> port state_dict (the inverse of `convert_danet`); a
    FixedAttractorDANet's tree (`base`, `attractor`) too."""
    p = params["params"] if "params" in params else params
    if "base" in p:
        sd = {f"base.{k}": v for k, v in danet_state_dict_from_jax(p["base"], config).items()}
        sd["attractor"] = _t(p["attractor"])
        return sd
    sd: Dict[str, torch.Tensor] = {}
    _lstm(sd, "rnn", p["rnn"])
    _linear(sd, "fc", p["fc"])
    return sd


def adanet_state_dict_from_jax(params: Mapping, config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ADANet variables -> port state_dict (the inverse of `convert_adanet`)."""
    p = params["params"] if "params" in params else params
    sd = danet_state_dict_from_jax(p, config)
    sd["anchor"] = _t(p["anchor"])
    return sd


def _conv2d(sd: Dict, prefix: str, conv: Mapping) -> None:
    """flax nn.Conv {kernel (kh, kw, in, out), bias if it has one} -> Conv2d weight (out,
    in, kh, kw), bias."""
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(conv["kernel"]), (3, 2, 0, 1)))
    if "bias" in conv:
        sd[f"{prefix}.bias"] = _t(conv["bias"])


def _conv_transpose2d(sd: Dict, prefix: str, conv: Mapping) -> None:
    """flax nn.ConvTranspose {kernel (kh, kw, in, out), bias} -> ConvTranspose2d weight (in,
    out, kh, kw), its spatial dims flipped: flax does not flip its kernel, torch does (the
    inverse of `hub/torch_convert.py:conv_transpose2d_weight`)."""
    kernel = np.asarray(conv["kernel"])[::-1, ::-1]
    sd[f"{prefix}.weight"] = _t(np.transpose(kernel, (2, 3, 0, 1)))
    if "bias" in conv:
        sd[f"{prefix}.bias"] = _t(conv["bias"])


def _batch_norm(sd: Dict, prefix: str, params: Mapping, stats: Mapping) -> None:
    """flax BatchNorm {scale, bias} and its batch_stats {mean, var} -> torch BatchNorm's
    weight, bias, running_mean, running_var (and a zero num_batches_tracked)."""
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _count(tree: Mapping, stem: str) -> int:
    return sum(1 for k in tree if k.startswith(stem) and k[len(stem):].isdigit())


def _dense_block(sd: Dict, prefix: str, p: Mapping, s: Mapping) -> None:
    """m_densenet.DenseBlock {conv_block{i}: {norm2d (if normed), conv2d}} ->
    `net.{i}.norm2d`, `net.{i}.conv2d`."""
    for i in range(_count(p, "conv_block")):
        block, stats = p[f"conv_block{i}"], s.get(f"conv_block{i}", {})
        if "norm2d" in block:
            _batch_norm(sd, f"{prefix}.net.{i}.norm2d", block["norm2d"], stats["norm2d"])
        _conv2d(sd, f"{prefix}.net.{i}.conv2d", block["conv2d"])


def _d3_block(sd: Dict, prefix: str, p: Mapping, s: Mapping) -> None:
    """d3net.D3Block {d2block{k}: {dense: DenseBlock}} -> `net.{k}.net.{i}.*`."""
    for k in range(_count(p, "d2block")):
        _dense_block(sd, f"{prefix}.net.{k}", p[f"d2block{k}"]["dense"],
                     s[f"d2block{k}"]["dense"])


def _dense_rnn_block(rnn_type: str):
    """mm_dense_rnn.DenseRNNBlock {dense_block?, rnn_block?} -> the port's block at
    `prefix`: a DenseBlock, a FrameRNN (`bottleneck_conv2d`, `rnn`, `linear`) or both,
    the DenseBlock under `dense_block`."""
    def convert(sd: Dict, prefix: str, p: Mapping, s: Mapping) -> None:
        if "rnn_block" not in p:
            _dense_block(sd, prefix, p["dense_block"], s["dense_block"])
            return
        if "dense_block" in p:
            _dense_block(sd, f"{prefix}.dense_block", p["dense_block"], s["dense_block"])
        rnn = p["rnn_block"]
        _conv2d(sd, f"{prefix}.bottleneck_conv2d", rnn["bottleneck_conv2d"])
        _RNN[rnn_type](sd, f"{prefix}.rnn", rnn["rnn"])
        _linear(sd, f"{prefix}.linear", rnn["linear"])
    return convert


def _backbone(sd: Dict, prefix: str, p: Mapping, s: Mapping, block, slot,
              nested: bool = False) -> None:
    """A backbone's tree -> `conv2d`, `encoder.net.{i}.<slot>`, `bottleneck_conv2d`,
    `decoder.net.{j}.{norm2d,upsample2d,<slot>}`, `pointwise_conv2d.{0,1}`. MDenseNet's
    encoder and decoder nest their blocks (`nested`: `encoder{i}.dense_block`,
    `decoder{j}.norm2d`); D3Net's and MDenseRNN's keep them flat (`encoder{i}`,
    `decoder{j}_norm`). `slot(tree)` names a stage's block in the port."""
    _conv2d(sd, f"{prefix}.conv2d", p["conv2d"])
    for i in range(_count(p, "encoder")):
        tree, stats = p[f"encoder{i}"], s.get(f"encoder{i}", {})
        if nested:
            tree, stats = tree["dense_block"], stats["dense_block"]
        block(sd, f"{prefix}.encoder.net.{i}.{slot(p[f'encoder{i}'])}", tree, stats)
    block(sd, f"{prefix}.bottleneck_conv2d", p["bottleneck"], s.get("bottleneck", {}))
    for j in range(_count(p, "decoder")):
        ref = f"{prefix}.decoder.net.{j}"
        tree, stats = p[f"decoder{j}"], s.get(f"decoder{j}", {})
        if nested:
            norm, norm_stats, up = tree["norm2d"], stats["norm2d"], tree["upsample2d"]
            tree, stats = tree["dense_block"], stats["dense_block"]
        else:
            norm, norm_stats = p[f"decoder{j}_norm"], s[f"decoder{j}_norm"]
            up = p[f"decoder{j}_up"]
        _batch_norm(sd, f"{ref}.norm2d", norm, norm_stats)
        _conv_transpose2d(sd, f"{ref}.upsample2d", up)
        block(sd, f"{ref}.{slot(p[f'decoder{j}'])}", tree, stats)
    if "pointwise_conv2d" in p:
        _batch_norm(sd, f"{prefix}.pointwise_conv2d.0", p["pointwise_norm"],
                    s["pointwise_norm"])
        _conv2d(sd, f"{prefix}.pointwise_conv2d.1", p["pointwise_conv2d"])


def _spectrogram_head(sd: Dict, p: Mapping, s: Mapping, final: str, block) -> None:
    """The affines, the final block (JAX `final`, the port's same name but D3Net's
    `d2block`), `norm2d` and GLU2d's `map` / `gate` (the port's `map_gate`)."""
    for name in ("scale_in", "bias_in", "scale_out", "bias_out"):
        sd[name] = _t(p[name])
    block(sd, final, p[final], s.get(final, {}))
    _batch_norm(sd, "norm2d", p["norm2d"], s["norm2d"])
    _conv2d(sd, "glu2d.map", p["glu2d"]["map"])
    _conv2d(sd, "glu2d.map_gate", p["glu2d"]["gate"])


def _bands(config: Mapping):
    return [*config["bands"], "full"]


def mm_densenet_state_dict_from_jax(variables: Mapping,
                                    config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX MMDenseNet variables {"params", "batch_stats"} -> port state_dict: the inverse of
    `hub/torch_convert.py:convert_mm_densenet` (convs transposed, transposed convs flipped
    and transposed, BatchNorm from params and batch_stats)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for band in _bands(config):
        _backbone(sd, f"net.{band}", p[f"net_{band}"], s[f"net_{band}"], _dense_block,
                  lambda tree: "dense_block", nested=True)
    _spectrogram_head(sd, p, s, "dense_block", _dense_block)
    return sd


def m_densenet_state_dict_from_jax(variables: Mapping,
                                   config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX MDenseNet (one band) variables -> port state_dict (`net.*` its backbone)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _backbone(sd, "net", p["net"], s["net"], _dense_block, lambda tree: "dense_block",
              nested=True)
    _spectrogram_head(sd, p, s, "dense_block", _dense_block)
    return sd


def d3net_state_dict_from_jax(variables: Mapping, config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX D3Net variables -> port state_dict: the inverse of
    `hub/torch_convert.py:convert_d3net`."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for band in _bands(config):
        _backbone(sd, f"net.{band}", p[f"net_{band}"], s[f"net_{band}"], _d3_block,
                  lambda tree: "d3block")
    for name in ("scale_in", "bias_in", "scale_out", "bias_out"):
        sd[name] = _t(p[name])
    _dense_block(sd, "d2block", p["d2block"]["dense"], s["d2block"]["dense"])
    _batch_norm(sd, "norm2d", p["norm2d"], s["norm2d"])
    _conv2d(sd, "glu2d.map", p["glu2d"]["map"])
    _conv2d(sd, "glu2d.map_gate", p["glu2d"]["gate"])
    return sd


def mm_dense_rnn_state_dict_from_jax(variables: Mapping,
                                     config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX MMDenseRNN / MMDenseLSTM variables -> port state_dict: the inverse of
    `hub/torch_convert.py:convert_mm_dense_rnn` (a recurrence's single LSTM bias into
    bias_ih with a zero bias_hh, `_lstm`; `rnn_type` 'gru' or 'rnn' too)."""
    p, s = variables["params"], variables["batch_stats"]
    block = _dense_rnn_block(config.get("rnn_type", "lstm"))
    sd: Dict[str, torch.Tensor] = {}
    for band in _bands(config):
        _backbone(sd, f"net.{band}", p[f"net_{band}"], s[f"net_{band}"], block,
                  lambda tree: "dense_rnn_block" if "rnn_block" in tree else "dense_block")
    _spectrogram_head(sd, p, s, "dense_block", block)
    return sd


def parallel_state_dict_from_jax(convert, variables: Mapping,
                                 config: Mapping) -> Dict[str, torch.Tensor]:
    """A Parallel model's JAX variables (`net_<source>` subtrees) -> port state_dict
    (`net.<source>.*`), each stem through `convert` (one of the converters above)."""
    sd: Dict[str, torch.Tensor] = {}
    for source in config["sources"]:
        sub = {k: v[f"net_{source}"] for k, v in variables.items()}
        sd.update({f"net.{source}.{k}": t for k, t in convert(sub, config).items()})
    return sd


_INDEXED = re.compile(r"(encoder|decoder|unet)(\d+)")


def _tree(sd: Dict, prefix: str, p: Mapping, s: Mapping) -> None:
    """A JAX tree whose submodules the port names alike (`encoder3` -> `encoder.3`, the
    lists the port keeps as ModuleLists): flax Conv (2-D or 1-D kernel) -> Conv2d /
    Conv1d, ConvTranspose (`deconv*`) -> ConvTranspose2d / 1d flipped, Dense -> Linear,
    BatchNorm -> torch BatchNorm with the batch_stats."""
    for name, sub in p.items():
        match = _INDEXED.fullmatch(name)
        path = prefix + (f"{match.group(1)}.{match.group(2)}" if match else name)
        if "kernel" in sub:
            ndim = np.ndim(sub["kernel"])
            if name.startswith("deconv") and ndim == 4:
                _conv_transpose2d(sd, path, sub)
            elif name.startswith("deconv"):  # (K, in, out) -> (in, out, K), flipped
                kernel = np.asarray(sub["kernel"])[::-1]
                sd[f"{path}.weight"] = _t(np.transpose(kernel, (1, 2, 0)))
                sd[f"{path}.bias"] = _t(sub["bias"])
            elif ndim == 4:
                _conv2d(sd, path, sub)
            elif ndim == 3:
                _conv(sd, path, sub)
            else:
                _linear(sd, path, sub)
        elif "scale" in sub:
            _batch_norm(sd, path, sub, s[name])
        else:
            _tree(sd, f"{path}.", sub, s.get(name, {}))


def _tree_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    _tree(sd, "", variables["params"], variables.get("batch_stats", {}))
    return sd


def hrnet_state_dict_from_jax(variables: Mapping, config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX HRNet variables -> port state_dict. The JAX package has no converter of the
    reference layout for HRNet; the port's names follow the JAX tree (`conv2d_in.block0`,
    `stage{s}_stack{k}_level{l}`, `mix{s}.down_{o}_{i}`, `concat_up{l}`, ...)."""
    return _tree_state_dict(variables)


def unet_state_dict_from_jax(variables: Mapping, config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX UNet2d / UNet1d / EnsembleUNet2d / EnsembleUNet1d variables -> port state_dict
    (`encoder.{i}`, `bottleneck`, `decoder.{i}`, an ensemble's `unet.{k}`)."""
    return _tree_state_dict(variables)


def cunet_state_dict_from_jax(variables: Mapping, config: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ConditionedUNet2d variables -> port state_dict (`control_net.dense{i}`,
    `control_net.fc_weight{i}` / `fc_bias{i}`, `encoder.{i}`, `bottleneck`,
    `decoder.{i}`)."""
    return _tree_state_dict(variables)
