"""wsj0-mix Wavesplit training CLI.

Port of `dnn_based_source_separation_tpu/cli/train_wsj0mix_wavesplit.py`: the same
flags and defaults (its `build_parser`, :27-74), plus `--device` (default `cuda`; a
CUDA device that is not there is an error, never a silent CPU run). The speaker table
is built from the training list (`data/wsj0mix.py:create_spk_to_idx`); the loss is
every layer's `--reconst_criterion` (negative SDR or SI-SDR) plus the speaker-distance
loss (and, with `--reg_criterion entropy`, the embedding table's entropy term);
validation runs the KMeans path under PIT over negative SI-SDR
(`train/wavesplit.py`). `--n_devices` (data parallelism, slice H) raises
NotImplementedError when set.

    python -m dnn_based_source_separation_torch.cli.train_wsj0mix_wavesplit \
        --train_wav_root ... --train_list_path ... --valid_wav_root ... \
        --valid_list_path ... -D 512 --spk_num_layers 14 --sep_num_blocks 4 \
        --sep_num_layers 10 --exp_dir exp [--device cuda]
"""
from __future__ import annotations

import argparse

import torch

from ..criterion import NegSDR, NegSISDR, PIT1d
from ..data import DataLoader, WaveEvalDataset, WaveTrainSpeakerDataset
from ..data.wsj0mix import create_spk_to_idx
from ..models.wavesplit import WaveSplit
from ..train import TrainerConfig, make_optimizer
from ..train.wavesplit import WaveSplitTrainer
from ..utils import set_seed


def build_parser():
    p = argparse.ArgumentParser("train_wsj0mix_wavesplit")
    p.add_argument("--train_wav_root", type=str, required=True)
    p.add_argument("--train_list_path", type=str, required=True)
    p.add_argument("--valid_wav_root", type=str, required=True)
    p.add_argument("--valid_list_path", type=str, required=True)
    p.add_argument("--sample_rate", type=int, default=8000)
    p.add_argument("--duration", type=float, default=4.0)
    p.add_argument("--valid_duration", type=float, default=8.0)
    p.add_argument("--n_sources", type=int, default=2)

    p.add_argument("--latent_dim", "-D", type=int, default=512)
    p.add_argument("--spk_kernel_size", type=int, default=3)
    p.add_argument("--spk_num_layers", type=int, default=14)
    p.add_argument("--sep_kernel_size_in", type=int, default=4)
    p.add_argument("--sep_kernel_size", type=int, default=3)
    p.add_argument("--sep_num_blocks", type=int, default=4)
    p.add_argument("--sep_num_layers", type=int, default=10)
    p.add_argument("--dilated", type=int, default=1)
    p.add_argument("--separable", type=int, default=1)
    p.add_argument("--causal", type=int, default=0)
    p.add_argument("--nonlinear", type=str, default="")
    p.add_argument("--norm", type=int, default=1)

    p.add_argument("--reconst_criterion", type=str, default="sdr", choices=["sdr", "sisdr"])
    p.add_argument("--spk_criterion", type=str, default="distance", choices=["distance"])
    p.add_argument("--reg_criterion", type=str, default="none", choices=["none", "entropy"])
    p.add_argument("--optimizer", type=str, default="adam")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--max_norm", type=float, default=5.0)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--epochs", type=int, default=100)

    p.add_argument("--exp_dir", type=str, default="./exp")
    p.add_argument("--continue_from", type=str, default=None)
    p.add_argument("--overwrite", type=int, default=0)
    p.add_argument("--seed", type=int, default=111)
    p.add_argument("--num_workers", type=int, default=0)
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel size (not ported: one device)")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(args=None):
    args = build_parser().parse_args(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device} asked for, but CUDA is not available")
    if args.n_devices is not None:
        raise NotImplementedError("--n_devices (data parallelism, slice H) is not ported yet")
    set_seed(args.seed)

    spk_to_idx = create_spk_to_idx(args.train_list_path, args.n_sources)
    train_ds = WaveTrainSpeakerDataset(
        args.train_wav_root, args.train_list_path, samples=int(args.duration * args.sample_rate),
        n_sources=args.n_sources, spk_to_idx=spk_to_idx)
    valid_ds = WaveEvalDataset(args.valid_wav_root, args.valid_list_path,
                               max_samples=int(args.valid_duration * args.sample_rate),
                               n_sources=args.n_sources)
    print(f"Training dataset includes {len(train_ds)} samples. {len(spk_to_idx)} speakers.",
          flush=True)
    print(f"Valid dataset includes {len(valid_ds)} samples.", flush=True)
    train_loader = DataLoader(train_ds, batch_size=args.batch_size, shuffle=True, seed=args.seed,
                              num_workers=args.num_workers)
    valid_loader = DataLoader(valid_ds, batch_size=1)

    model = WaveSplit(
        latent_dim=args.latent_dim, n_sources=args.n_sources, n_training_sources=len(spk_to_idx),
        spk_kernel_size=args.spk_kernel_size, spk_num_layers=args.spk_num_layers,
        sep_kernel_size_in=args.sep_kernel_size_in, sep_kernel_size=args.sep_kernel_size,
        sep_num_blocks=args.sep_num_blocks, sep_num_layers=args.sep_num_layers,
        dilated=bool(args.dilated), separable=bool(args.separable), causal=bool(args.causal),
        nonlinear=args.nonlinear or None, norm=bool(args.norm),
        generator=torch.Generator().manual_seed(args.seed), device=device)
    reconst = NegSDR() if args.reconst_criterion == "sdr" else NegSISDR()
    optimizer = make_optimizer(args.optimizer, args.lr, max_norm=args.max_norm,
                               params=model.parameters())
    config = TrainerConfig(epochs=args.epochs, exp_dir=args.exp_dir,
                           continue_from=args.continue_from, overwrite=bool(args.overwrite),
                           sample_rate=args.sample_rate)
    trainer = WaveSplitTrainer(model, train_loader, valid_loader, reconst,
                               PIT1d(NegSISDR(), n_sources=args.n_sources), optimizer, config,
                               device, entropy_reg=args.reg_criterion == "entropy")
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
