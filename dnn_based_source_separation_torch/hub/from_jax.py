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
JAX trees onto the port's names, which follow those trees.
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
