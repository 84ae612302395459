"""wsj0-mix training CLI (Conv-TasNet, DPRNN-TasNet, DPTNet, LSTM-TasNet, SepFormer, GALRNet,
FurcaNet).

Port of `dnn_based_source_separation_tpu/cli/train_wsj0mix.py`: the same
flag names and defaults (its `build_parser`, :26-117), plus `--device`
(default `cuda`), as the port's `cli/separate.py` has. A CUDA device that is
not there is an error, never a silent CPU run. The loss is PIT over negative
SI-SDR, the optimizer optax's rules (`train/steps.py`), the Trainer the JAX
package's (`train/trainer.py`). `--mixed_precision 1` runs bf16 compute over
f32 master weights as the JAX step does. `--warmup_steps N` (N > 0) trains
with the DPTNet recipe's schedule (`train/steps.py:make_warmup_optimizer`,
d_model = `--sep_bottleneck_channels`, an epoch = the train loader's length),
as the JAX CLI does (its :191-197); the cv-plateau halving then does nothing.

`--criterion orpit` trains one-and-rest PIT over 2+3-speaker corpora (the JAX
CLI's :140-166): `--n_sources` is read as the most speakers an utterance has,
the model estimates the (one, rest) pair, the datasets are
`WaveTrainVariableSourcesDataset` and the Trainer `ORPITTrainer`. `--pit
hungarian|prob|sink` trains with `HungarianLoss` (its assignment solved on the
host), `ProbPIT` at `--pit_gamma` or `SinkPIT` in place of exhaustive PIT.
`--device_resident_data` and `--n_devices` are not ported and raise
NotImplementedError when set. DPRNN-TasNet trains with `--rnn_type lstm`, `gru` or
`sru` on either device. FurcaNet takes `-Hc`, `-Hr`, `-Bc`, `-Br`,
`--sep_kernel_size` and `--mask_nonlinear` (its gate). As in the JAX factory,
LSTM-TasNet takes `--enc_basis` (its recipe `trainableGated`) and no encoder
nonlinearity, and
SepFormer (`--sep_num_layers` layers and `--sep_num_heads` heads in both
paths) and GALRNet (`-Q` / `--sep_down_chunk_size`) take no filterbank kinds.

    python -m dnn_based_source_separation_torch.cli.train_wsj0mix \
        --model dprnn-tasnet -N 64 -L 2 -H 128 -B 64 -K 250 --sep_hop_size 125 -R 6 \
        --train_wav_root ... --train_list_path ... --valid_wav_root ... \
        --valid_list_path ... --exp_dir exp [--device cuda] [--mixed_precision 1]
"""
from __future__ import annotations

import argparse

import torch

from ..criterion import ORPIT, HungarianLoss, NegSISDR, PIT1d, ProbPIT, SinkPIT
from ..data import (
    DataLoader, WaveEvalDataset, WaveTrainDataset, WaveTrainVariableSourcesDataset,
)
from ..train import ORPITTrainer, Trainer, TrainerConfig, make_optimizer, make_warmup_optimizer
from ..utils import set_seed
from ..utils.device import resolve_device
from .model_factory import build_wsj0mix_model


def build_parser():
    p = argparse.ArgumentParser("train_wsj0mix")
    # data
    p.add_argument("--train_wav_root", type=str, required=True)
    p.add_argument("--train_list_path", type=str, required=True)
    p.add_argument("--valid_wav_root", type=str, required=True)
    p.add_argument("--valid_list_path", type=str, required=True)
    p.add_argument("--sample_rate", type=int, default=8000)
    p.add_argument("--duration", type=float, default=4.0)
    p.add_argument("--valid_duration", type=float, default=8.0)
    p.add_argument("--n_sources", type=int, default=2)
    # model
    p.add_argument("--model", type=str, default="conv-tasnet")
    p.add_argument("--n_basis", "-N", type=int, default=512)
    p.add_argument("--kernel_size", "-L", type=int, default=16)
    p.add_argument("--stride", type=int, default=None)
    p.add_argument("--enc_basis", type=str, default="trainable")
    p.add_argument("--dec_basis", type=str, default="trainable")
    p.add_argument("--enc_nonlinear", type=str, default="relu")
    p.add_argument("--sep_hidden_channels", "-H", type=int, default=512)
    p.add_argument("--sep_bottleneck_channels", "-B", type=int, default=128)
    p.add_argument("--sep_skip_channels", "-Sc", type=int, default=128)
    p.add_argument("--sep_kernel_size", "-P", type=int, default=3)
    p.add_argument("--sep_num_blocks", "-R", type=int, default=3)
    p.add_argument("--sep_num_layers", "-X", type=int, default=8)
    p.add_argument("--sep_chunk_size", "-K", type=int, default=100)
    p.add_argument("--sep_hop_size", type=int, default=50)
    p.add_argument("--sep_down_chunk_size", "-Q", type=int, default=32)
    p.add_argument("--sep_num_heads", type=int, default=4)
    p.add_argument("--rnn_type", type=str, default="lstm", choices=["lstm", "gru", "sru"],
                   help="dprnn-tasnet recurrence")
    p.add_argument("--conv_hidden_channels", "-Hc", type=int, default=128,
                   help="furcanet gated-conv hidden channels")
    p.add_argument("--rnn_hidden_channels", "-Hr", type=int, default=128,
                   help="furcanet BiLSTM hidden channels per direction")
    p.add_argument("--num_conv_blocks", "-Bc", type=int, default=6,
                   help="furcanet gated-conv blocks")
    p.add_argument("--num_rnn_blocks", "-Br", type=int, default=6,
                   help="furcanet BiLSTM layers")
    p.add_argument("--causal", type=int, default=0)
    p.add_argument("--mask_nonlinear", type=str, default="sigmoid")
    # optimization
    p.add_argument("--criterion", type=str, default="sisdr")
    p.add_argument("--pit", type=str, default="exhaustive",
                   choices=["exhaustive", "hungarian", "prob", "sink"],
                   help="permutation search: exhaustive n!-table PIT (the reference's), "
                        "hungarian O(n^3) matching (n_sources > 5), prob soft-min ProbPIT, "
                        "sink Sinkhorn relaxation")
    p.add_argument("--pit_gamma", type=float, default=1.0,
                   help="ProbPIT temperature (--pit prob)")
    p.add_argument("--optimizer", type=str, default="adam")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="> 0: Adam under the DPTNet recipe's warmup schedule (--lr unused)")
    p.add_argument("--k1", type=float, default=2e-1, help="warmup ramp coefficient")
    p.add_argument("--k2", type=float, default=4e-4, help="post-warmup decay coefficient")
    p.add_argument("--max_norm", type=float, default=5.0)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--epochs", type=int, default=100)
    # infra
    p.add_argument("--exp_dir", type=str, default="./exp")
    p.add_argument("--continue_from", type=str, default=None)
    p.add_argument("--overwrite", type=int, default=0)
    p.add_argument("--seed", type=int, default=111)
    p.add_argument("--num_workers", type=int, default=0, help="background loader threads")
    p.add_argument("--cache_in_memory", type=int, default=0,
                   help="cache decoded waveforms in RAM after first use")
    p.add_argument("--device_resident_data", type=int, default=0,
                   help="the whole corpus in device memory (not ported)")
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel size (not ported: one device)")
    p.add_argument("--mixed_precision", type=int, default=0,
                   help="bf16 compute, f32 master params")
    p.add_argument("--time_budget_min", type=float, default=None,
                   help="stop after this many wall-clock minutes (epoch boundary; last.ckpt "
                        "still written, resumable)")
    p.add_argument("--device", type=str, default="cuda")
    return p


def _refuse_unported(args) -> None:
    refusals = [
        (bool(args.device_resident_data), "--device_resident_data"),
        (args.n_devices is not None, "--n_devices (data parallelism, slice H)"),
    ]
    for refused, what in refusals:
        if refused:
            raise NotImplementedError(f"{what} is not ported yet")
    if args.criterion not in ("sisdr", "orpit"):
        raise ValueError(f"Unsupported criterion: {args.criterion}")


def _pit_criterion(args):
    """The permutation search of `--pit` over negative SI-SDR (the JAX CLI's :203-214)."""
    if args.pit == "hungarian":
        return HungarianLoss(NegSISDR())
    if args.pit == "prob":
        return ProbPIT(NegSISDR(), n_sources=args.n_sources, gamma=args.pit_gamma)
    if args.pit == "sink":
        return SinkPIT(NegSISDR(), n_sources=args.n_sources)
    return PIT1d(NegSISDR(), n_sources=args.n_sources)


def _train_orpit(args, device, config):
    """One-and-rest PIT (the JAX CLI's :140-166): `--n_sources` is the most speakers an
    utterance has; the model estimates the (one, rest) pair."""
    max_sources = args.n_sources
    args.n_sources = 2
    train_ds = WaveTrainVariableSourcesDataset(
        args.train_wav_root, args.train_list_path,
        samples=int(args.duration * args.sample_rate), max_sources=max_sources)
    valid_ds = WaveTrainVariableSourcesDataset(
        args.valid_wav_root, args.valid_list_path,
        samples=int(args.valid_duration * args.sample_rate), max_sources=max_sources)
    print(f"Training dataset includes {len(train_ds)} samples.", flush=True)
    print(f"Valid dataset includes {len(valid_ds)} samples.", flush=True)
    train_loader = DataLoader(train_ds, batch_size=args.batch_size, shuffle=True,
                              seed=args.seed, num_workers=args.num_workers)
    valid_loader = DataLoader(valid_ds, batch_size=args.batch_size)
    model = build_wsj0mix_model(args, device)
    optimizer = make_optimizer(args.optimizer, args.lr, max_norm=args.max_norm,
                               params=model.parameters())
    trainer = ORPITTrainer(model, train_loader, valid_loader, ORPIT(NegSISDR()), optimizer,
                           config, device)
    trainer.run()
    return trainer


def main(args=None):
    args = build_parser().parse_args(args)
    args.causal = bool(args.causal)
    device = resolve_device(args.device)
    _refuse_unported(args)
    set_seed(args.seed)
    config = TrainerConfig(
        epochs=args.epochs, exp_dir=args.exp_dir, continue_from=args.continue_from,
        overwrite=bool(args.overwrite), sample_rate=args.sample_rate,
        time_budget_sec=args.time_budget_min * 60.0 if args.time_budget_min else None)
    if args.criterion == "orpit":
        return _train_orpit(args, device, config)

    train_ds = WaveTrainDataset(args.train_wav_root, args.train_list_path,
                                samples=int(args.duration * args.sample_rate),
                                n_sources=args.n_sources,
                                cache_in_memory=bool(args.cache_in_memory))
    valid_ds = WaveEvalDataset(args.valid_wav_root, args.valid_list_path,
                               max_samples=int(args.valid_duration * args.sample_rate),
                               n_sources=args.n_sources)
    print(f"Training dataset includes {len(train_ds)} samples.", flush=True)
    print(f"Valid dataset includes {len(valid_ds)} samples.", flush=True)
    train_loader = DataLoader(train_ds, batch_size=args.batch_size, shuffle=True, seed=args.seed,
                              num_workers=args.num_workers)
    valid_loader = DataLoader(valid_ds, batch_size=1)

    model = build_wsj0mix_model(args, device)
    if args.warmup_steps > 0:
        optimizer = make_warmup_optimizer(
            args.k1, args.k2, d_model=args.sep_bottleneck_channels,
            warmup_steps=args.warmup_steps, steps_per_epoch=len(train_loader),
            max_norm=args.max_norm, params=model.parameters())
    else:
        optimizer = make_optimizer(args.optimizer, args.lr, max_norm=args.max_norm,
                                   params=model.parameters())
    trainer = Trainer(model, train_loader, valid_loader, _pit_criterion(args), optimizer,
                      config, device,
                      compute_dtype=torch.bfloat16 if args.mixed_precision else None)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
