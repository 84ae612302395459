"""Recipe model factory: --model flag + argparse namespace -> model on a device.

Port of `dnn_based_source_separation_tpu/cli/model_factory.py:build_wsj0mix_model`:
every model it builds, with the JAX factory's arguments and defaults. The weights are
drawn from `args.seed`, so one seed gives the same model on every device.
"""
from __future__ import annotations

import torch

from ..models import ConvTasNet, DPRNNTasNet, DPTNet, FurcaNet, GALRNet, LSTMTasNet, SepFormer


def build_wsj0mix_model(args, device) -> torch.nn.Module:
    name = args.model.replace("_", "-")
    common = dict(
        n_basis=args.n_basis, kernel_size=args.kernel_size, stride=args.stride,
        enc_basis=args.enc_basis, dec_basis=args.dec_basis,
        enc_nonlinear=args.enc_nonlinear or None, causal=args.causal,
        mask_nonlinear=args.mask_nonlinear, n_sources=args.n_sources,
        generator=torch.Generator().manual_seed(args.seed), device=device,
    )
    if name == "conv-tasnet":
        return ConvTasNet(
            sep_hidden_channels=args.sep_hidden_channels,
            sep_bottleneck_channels=args.sep_bottleneck_channels,
            sep_skip_channels=args.sep_skip_channels, sep_kernel_size=args.sep_kernel_size,
            sep_num_blocks=args.sep_num_blocks, sep_num_layers=args.sep_num_layers, **common)
    if name == "dprnn-tasnet":
        return DPRNNTasNet(
            sep_bottleneck_channels=args.sep_bottleneck_channels,
            sep_hidden_channels=args.sep_hidden_channels,
            sep_chunk_size=args.sep_chunk_size, sep_hop_size=args.sep_hop_size,
            sep_num_blocks=args.sep_num_blocks, rnn_type=getattr(args, "rnn_type", "lstm"),
            **common)
    if name == "lstm-tasnet":  # no encoder nonlinearity; the gated encoder unless given
        common.pop("enc_nonlinear")
        common.update(enc_basis=args.enc_basis or "trainableGated", dec_basis="trainable")
        return LSTMTasNet(
            sep_num_blocks=args.sep_num_blocks, sep_num_layers=args.sep_num_layers,
            sep_hidden_channels=args.sep_hidden_channels, **common)
    if name in ("dptnet", "sepformer", "galrnet"):  # the JAX factory passes no filterbank kinds
        for key in ("enc_basis", "dec_basis"):
            common.pop(key)
    if name == "dptnet":  # ... and no hop size
        return DPTNet(
            sep_bottleneck_channels=args.sep_bottleneck_channels,
            sep_hidden_channels=args.sep_hidden_channels, sep_chunk_size=args.sep_chunk_size,
            sep_num_blocks=args.sep_num_blocks, sep_num_heads=args.sep_num_heads, **common)
    if name == "sepformer":  # one depth and head count for both paths
        return SepFormer(
            sep_bottleneck_channels=args.sep_bottleneck_channels,
            sep_chunk_size=args.sep_chunk_size, sep_hop_size=args.sep_hop_size,
            sep_num_blocks=args.sep_num_blocks,
            sep_num_layers_intra=args.sep_num_layers, sep_num_layers_inter=args.sep_num_layers,
            sep_num_heads_intra=args.sep_num_heads, sep_num_heads_inter=args.sep_num_heads,
            **common)
    if name == "galrnet":
        return GALRNet(
            sep_hidden_channels=args.sep_hidden_channels, sep_chunk_size=args.sep_chunk_size,
            sep_hop_size=args.sep_hop_size, sep_down_chunk_size=args.sep_down_chunk_size,
            sep_num_blocks=args.sep_num_blocks, sep_num_heads=args.sep_num_heads, **common)
    if name == "furcanet":  # no filterbank: the gated convs read the samples
        return FurcaNet(
            conv_hidden_channels=args.conv_hidden_channels,
            rnn_hidden_channels=args.rnn_hidden_channels,
            num_conv_blocks=args.num_conv_blocks, num_rnn_blocks=args.num_rnn_blocks,
            kernel_size=args.sep_kernel_size, nonlinear=args.mask_nonlinear,
            causal=args.causal, n_sources=args.n_sources, generator=common["generator"],
            device=device)
    raise ValueError(f"Unsupported model: {args.model}")
