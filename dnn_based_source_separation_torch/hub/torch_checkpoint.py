"""Open a reference `.pth` checkpoint (its config and `state_dict`, no `model_class`).

Port of `dnn_based_source_separation_tpu/hub/torch_convert.py:build_from_torch_checkpoint`
(:165-432). The reference's checkpoints keep only the model's config keys beside its
`state_dict` (and an `optim_dict`), so the family is inferred as JAX infers it, by the same
rules in the same order, and built with JAX's constructor arguments and defaults:

1. a band-structured state (`bands` in the config or `net.full.*` keys): D3Net where a key
   holds `d3block`, else MMDenseLSTM / MMDenseRNN (by `rnn_type`) where the config has
   `hidden_channels`, else MMDenseNet;
2. `backbone.*` keys: X-UMX (CrossNetOpenUnmix, `bridge` from the config, default on);
3. `encoder_blocks.*` keys: MRX;
4. `separator.rnn.0.weight_ih_l0`: LSTM-TasNet;  5. `separator.galr.*`: GALRNet;
6. a `multihead_attn_block` key: DPTNet;  7. `sep_num_layers_intra` (or an
   `intra_transformer` key): SepFormer;  8. `sep_chunk_size` and a `dprnn` key:
   DPRNN-TasNet;  9. `anchor` and `rnn.weight_ih_l0`: ADANet;  10. `embed_dim` and
   `rnn.weight_ih_l0`: DANet;  11. `n_bins` and `rnn.weight_ih_l0`: Open-Unmix;
12. anything else: Conv-TasNet.

The port keeps the reference's parameter names, so the weights load with
`load_state_dict(strict=True)`, no key renamed or added. One family needs a map: the
reference's MRX encoders hold an input affine that its forward never applies, which JAX's
converter drops and the port's MRX has no place for (`UNAPPLIED`); those keys, by name, are
left out of the load and no other. JAX's hazards are
mirrored, not repaired: ParallelOpenUnmix's `backbone.*` state, which X-UMX's fits, opens
as a bridged X-UMX; a DPRNN-TasNet checkpoint is built with neither `rnn_type` nor
`stream_safe`, so a GRU or stream-safe one fails the strict load (JAX builds an LSTM model
whose forward fails on the GRU's parameter shapes). The port's own checkpoints open with
`models/base.py:load_model`.
"""
from __future__ import annotations

import torch

from ..models import base


def _band_family(config, state_dict):
    common = dict(
        in_channels=config["in_channels"], num_features=config["num_features"],
        growth_rate=config["growth_rate"], kernel_size=config.get("kernel_size", 3),
        bands=list(config["bands"]), sections=config["sections"],
        scale=config.get("scale", 2), depth=config.get("depth"),
        growth_rate_final=config.get("growth_rate_final"),
        kernel_size_final=config.get("kernel_size_final", 3),
        depth_final=config.get("depth_final"), norm_final=config.get("norm_final", True),
        nonlinear_final=config.get("nonlinear_final", "relu"),
    )
    if any("d3block" in k for k in state_dict):
        return "D3Net", dict(
            num_d2blocks=config.get("num_d2blocks"), dilated=config.get("dilated", True),
            norm=config.get("norm", True), nonlinear=config.get("nonlinear", "relu"),
            dilated_final=config.get("dilated_final", True), **common)
    common.update(dilated=config.get("dilated", False), norm=config.get("norm", True),
                  nonlinear=config.get("nonlinear", "relu"),
                  dilated_final=config.get("dilated_final", False))
    if "hidden_channels" not in config:
        return "MMDenseNet", common
    rnn_type = config.get("rnn_type", "lstm")
    kwargs = dict(hidden_channels=config["hidden_channels"],
                  hidden_channels_final=int(config.get("hidden_channels_final") or 0),
                  causal=config.get("causal", False),
                  rnn_position=config.get("rnn_position", "parallel"), **common)
    if rnn_type == "lstm":
        return "MMDenseLSTM", kwargs
    return "MMDenseRNN", dict(kwargs, rnn_type=rnn_type)


def _tasnet_common(config, enc_basis="trainable"):
    return dict(n_basis=config["n_basis"], kernel_size=config["kernel_size"],
                stride=config.get("stride"), enc_basis=config.get("enc_basis", enc_basis),
                dec_basis=config.get("dec_basis", "trainable"))


def infer_family(config, state_dict):
    """(the port's class name, its constructor arguments) by JAX's dispatch."""
    keys = list(state_dict)
    has = lambda part: any(part in k for k in keys)  # noqa: E731
    starts = lambda stem: any(k.startswith(stem) for k in keys)  # noqa: E731
    if "bands" in config or starts("net.full."):
        return _band_family(config, state_dict)
    if starts("backbone."):
        return "CrossNetOpenUnmix", dict(
            in_channels=config["in_channels"],
            hidden_channels=config.get("hidden_channels", 512),
            num_layers=config.get("num_layers", 3), n_bins=config["n_bins"],
            max_bin=config.get("max_bin"), dropout=config.get("dropout"),
            causal=config.get("causal", False), bridge=config.get("bridge", True),
            sources=tuple(config["sources"]))
    if starts("encoder_blocks."):
        num_layers = config.get("num_layers", 3)
        if isinstance(num_layers, (list, tuple)):
            num_layers = int(num_layers[0])
        rnn_type = config.get("rnn_type", "lstm")
        if isinstance(rnn_type, (list, tuple)):
            rnn_type = rnn_type[0]
        return "MultiResolutionCrossNet", dict(
            in_channels=config["in_channels"],
            hidden_channels=config.get("hidden_channels", 512), num_layers=num_layers,
            n_fft=tuple(config["n_fft"]), hop_length=config["hop_length"],
            window_fn=config.get("window_fn", "hann"), causal=config.get("causal", False),
            rnn_type=rnn_type, sources=tuple(config["sources"]))
    if "separator.rnn.0.weight_ih_l0" in state_dict:
        return "LSTMTasNet", dict(
            _tasnet_common(config, "trainableGated"),
            sep_num_blocks=config.get("sep_num_blocks", 2),
            sep_num_layers=config.get("sep_num_layers", 2),
            sep_hidden_channels=config.get("sep_hidden_channels", 500),
            mask_nonlinear=config.get("mask_nonlinear", "softmax"),
            causal=config.get("causal", False), rnn_type=config.get("rnn_type", "lstm"),
            n_sources=config.get("n_sources", 2))
    if starts("separator.galr."):
        return "GALRNet", dict(
            _tasnet_common(config), enc_nonlinear=config.get("enc_nonlinear"),
            sep_hidden_channels=config.get("sep_hidden_channels", 128),
            sep_chunk_size=config.get("sep_chunk_size", 100),
            sep_hop_size=config.get("sep_hop_size", 50),
            sep_down_chunk_size=config.get("sep_down_chunk_size"),
            sep_num_blocks=config.get("sep_num_blocks", 6),
            sep_num_heads=config.get("sep_num_heads", 4),
            mask_nonlinear=config.get("mask_nonlinear", "relu"),
            low_dimension=config.get("low_dimension", True),
            causal=config.get("causal", True), n_sources=config.get("n_sources", 2))
    if has("multihead_attn_block"):
        return "DPTNet", dict(
            _tasnet_common(config), enc_nonlinear=config.get("enc_nonlinear"),
            sep_bottleneck_channels=config.get("sep_bottleneck_channels", 64),
            sep_hidden_channels=config.get("sep_hidden_channels", 256),
            sep_chunk_size=config.get("sep_chunk_size", 100),
            sep_hop_size=config.get("sep_hop_size"),
            sep_num_blocks=config.get("sep_num_blocks", 6),
            sep_num_heads=config.get("sep_num_heads", 4),
            mask_nonlinear=config.get("mask_nonlinear", "relu"),
            causal=config.get("causal", False), n_sources=config.get("n_sources", 2))
    if "sep_num_layers_intra" in config or has("intra_transformer"):
        layers, heads = config.get("sep_num_layers", 8), config.get("sep_num_heads", 8)
        return "SepFormer", dict(
            n_basis=config["n_basis"], kernel_size=config["kernel_size"],
            stride=config.get("stride"), enc_nonlinear=config.get("enc_nonlinear"),
            sep_bottleneck_channels=config.get("sep_bottleneck_channels", 256),
            sep_chunk_size=config.get("sep_chunk_size", 250),
            sep_hop_size=config.get("sep_hop_size", 125),
            sep_num_blocks=config.get("sep_num_blocks", 2),
            sep_num_layers_intra=config.get("sep_num_layers_intra", layers),
            sep_num_layers_inter=config.get("sep_num_layers_inter", layers),
            sep_num_heads_intra=config.get("sep_num_heads_intra", heads),
            sep_num_heads_inter=config.get("sep_num_heads_inter", heads),
            sep_d_ff_intra=config.get("sep_d_ff_intra", 1024),
            sep_d_ff_inter=config.get("sep_d_ff_inter", 1024),
            mask_nonlinear=config.get("mask_nonlinear", "relu"),
            causal=config.get("causal", False), n_sources=config.get("n_sources", 2))
    if "sep_chunk_size" in config and has("dprnn"):
        return "DPRNNTasNet", dict(
            _tasnet_common(config), enc_nonlinear=config.get("enc_nonlinear"),
            sep_bottleneck_channels=config.get("sep_bottleneck_channels", 64),
            sep_hidden_channels=config.get("sep_hidden_channels", 128),
            sep_chunk_size=config.get("sep_chunk_size", 100),
            sep_hop_size=config.get("sep_hop_size", 50),
            sep_num_blocks=config.get("sep_num_blocks", 6),
            mask_nonlinear=config.get("mask_nonlinear", "sigmoid"),
            causal=config.get("causal", False), n_sources=config.get("n_sources", 2))
    spectrogram = dict(causal=config.get("causal", False),
                       mask_nonlinear=config.get("mask_nonlinear", "sigmoid"),
                       take_log=config.get("take_log", True),
                       take_db=config.get("take_db", False))
    if "anchor" in state_dict and "rnn.weight_ih_l0" in state_dict:
        return "ADANet", dict(
            n_bins=config["n_bins"], embed_dim=config["embed_dim"],
            hidden_channels=config.get("hidden_channels", 600),
            num_blocks=config.get("num_blocks", 4), num_anchors=config.get("num_anchors", 6),
            permute_anchors=config.get("permute_anchors", False), **spectrogram)
    if "embed_dim" in config and "rnn.weight_ih_l0" in state_dict:
        return "DANet", dict(
            n_bins=config["n_bins"], embed_dim=config["embed_dim"],
            hidden_channels=config.get("hidden_channels", 300),
            num_blocks=config.get("num_blocks", 4), **spectrogram)
    if "n_bins" in config and "rnn.weight_ih_l0" in state_dict:
        return "OpenUnmix", dict(
            in_channels=config["in_channels"],
            hidden_channels=config.get("hidden_channels", 512),
            num_layers=config.get("num_layers", 3), n_bins=config["n_bins"],
            max_bin=config.get("max_bin"), dropout=config.get("dropout"),
            causal=config.get("causal", False))
    return "ConvTasNet", dict(
        _tasnet_common(config), enc_nonlinear=config.get("enc_nonlinear"),
        sep_hidden_channels=config.get("sep_hidden_channels", 256),
        sep_bottleneck_channels=config.get("sep_bottleneck_channels", 128),
        sep_skip_channels=config.get("sep_skip_channels", 128),
        sep_kernel_size=config.get("sep_kernel_size", 3),
        sep_num_blocks=config.get("sep_num_blocks", 3),
        sep_num_layers=config.get("sep_num_layers", 8),
        dilated=config.get("dilated", True), separable=config.get("separable", True),
        sep_nonlinear=config.get("sep_nonlinear", "prelu"),
        sep_norm=config.get("sep_norm", True),
        mask_nonlinear=config.get("mask_nonlinear", "sigmoid"),
        causal=config.get("causal", False), n_sources=config.get("n_sources", 2))


def _mrx_unapplied(config):
    # The reference's MRX keeps an input affine in each resolution's encoder,
    # `encoder_blocks.{i}.scale_in` and `encoder_blocks.{i}.bias_in`, that its forward never
    # applies (it reads |STFT| directly). JAX's `convert_mrx` (hub/torch_convert.py:1136-1139)
    # drops them for that reason, and the port's MRX has no such parameters.
    return {f"encoder_blocks.{i}.{name}" for i in range(len(config["n_fft"]))
            for name in ("scale_in", "bias_in")}


# The reference's keys that a family's port model has no place for, by the port's class
# name: a function of the config -> the keys left out of the strict load.
UNAPPLIED = {"MultiResolutionCrossNet": _mrx_unapplied}


def build_from_torch_checkpoint(path: str, device="cuda") -> torch.nn.Module:
    """The model a reference checkpoint at `path` holds, its weights loaded strictly, in
    eval mode on `device` (the card unless the caller asks for the CPU)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} was asked for, but CUDA is not available")
    blob = base.read_checkpoint(path)
    config = {k: v for k, v in blob.items() if k not in ("state_dict", "optim_dict")}
    state_dict = blob["state_dict"]
    name, kwargs = infer_family(config, state_dict)
    if name in UNAPPLIED:
        unapplied = UNAPPLIED[name](config)
        state_dict = {k: v for k, v in state_dict.items() if k not in unapplied}
    model = base.get_model_class(name)(**kwargs, device=device)
    try:
        model.load_state_dict(state_dict, strict=True)
    except RuntimeError as err:
        raise RuntimeError(f"{path}: the reference checkpoint's weights do not fit the "
                           f"{name} its keys select: {err}") from err
    return model.eval()
