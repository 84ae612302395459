"""wsj0-mix spectrogram-domain training CLI: DANet, ADANet and deep clustering.

Port of `dnn_based_source_separation_tpu/cli/train_wsj0mix_spec.py`: the same flags
and defaults (its `build_parser`, :30-82), plus `--device` (default `cuda`; a CUDA
device that is not there is an error, never a silent CPU run). The data are
`IdealMaskSpectrogramTrainDataset` items (n_fft / hop STFTs, the ideal mask and the
threshold weight); DANet and ADANet train PIT over the L2 distance of the amplitude
estimates (`--criterion se` or `l2loss`), deep clustering the affinity loss
(`--criterion affinity`); the optimizers are optax's rules (`train/steps.py`,
`rmsprop` included, as the DANet recipe trains). ADANet's `--dropout` draws its masks
from a generator seeded by `--seed`. `--n_devices` (data parallelism, slice H) raises
NotImplementedError when set.

    python -m dnn_based_source_separation_torch.cli.train_wsj0mix_spec --model danet \
        --train_wav_root ... --train_list_path ... --valid_wav_root ... \
        --valid_list_path ... -K 20 -H 300 -B 4 --optimizer rmsprop --lr 1e-4 \
        --exp_dir exp [--device cuda]
"""
from __future__ import annotations

import argparse

import torch

from ..criterion import AffinityLoss, L2Loss, PIT2d
from ..data import DataLoader, IdealMaskSpectrogramTrainDataset
from ..models import ADANet, DANet, DeepEmbedding
from ..train import TrainerConfig, make_optimizer
from ..train.attractor import AnchoredAttractorTrainer, AttractorTrainer, EmbeddingTrainer
from ..utils import set_seed
from ..utils.device import resolve_device


def build_parser():
    p = argparse.ArgumentParser("train_wsj0mix_spec")
    # data
    p.add_argument("--train_wav_root", type=str, required=True)
    p.add_argument("--train_list_path", type=str, required=True)
    p.add_argument("--valid_wav_root", type=str, required=True)
    p.add_argument("--valid_list_path", type=str, required=True)
    p.add_argument("--sample_rate", type=int, default=8000)
    p.add_argument("--duration", type=float, default=0.8)
    p.add_argument("--n_sources", type=int, default=2)
    # STFT front end
    p.add_argument("--n_fft", type=int, default=256)
    p.add_argument("--hop_length", type=int, default=64)
    p.add_argument("--window_fn", type=str, default="hann")
    p.add_argument("--ideal_mask", type=str, default="ibm", choices=["ibm", "irm", "wfm"])
    p.add_argument("--threshold", type=float, default=40.0)
    # model
    p.add_argument("--model", type=str, default="danet",
                   choices=["danet", "adanet", "deep-clustering"])
    p.add_argument("--embed_dim", "-K", type=int, default=20)
    p.add_argument("--hidden_channels", "-H", type=int, default=300)
    p.add_argument("--num_blocks", "-B", type=int, default=4)
    p.add_argument("--num_anchors", "-N", type=int, default=6)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--causal", type=int, default=0)
    p.add_argument("--mask_nonlinear", type=str, default="sigmoid")
    p.add_argument("--take_log", type=int, default=1)
    p.add_argument("--take_db", type=int, default=0)
    p.add_argument("--iter_clustering", type=int, default=10)
    # optimization
    p.add_argument("--criterion", type=str, default="se",
                   help="se/l2loss (mask family) or affinity (deep clustering)")
    p.add_argument("--optimizer", type=str, default="rmsprop")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--max_norm", type=float, default=0.0)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=150)
    # infra
    p.add_argument("--exp_dir", type=str, default="./exp")
    p.add_argument("--continue_from", type=str, default=None)
    p.add_argument("--overwrite", type=int, default=0)
    p.add_argument("--seed", type=int, default=111)
    p.add_argument("--num_workers", type=int, default=0, help="background loader threads")
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel size (not ported: one device)")
    p.add_argument("--device", type=str, default="cuda")
    return p


def build_spec_model(args, n_bins: int, device) -> torch.nn.Module:
    """The JAX `build_spec_model`'s model, its weights drawn from `args.seed`."""
    common = dict(n_bins=n_bins, embed_dim=args.embed_dim, hidden_channels=args.hidden_channels,
                  causal=bool(args.causal), take_log=bool(args.take_log),
                  take_db=bool(args.take_db),
                  generator=torch.Generator().manual_seed(args.seed), device=device)
    if args.model == "danet":
        return DANet(num_blocks=args.num_blocks, dropout=args.dropout,
                     mask_nonlinear=args.mask_nonlinear, iter_clustering=args.iter_clustering,
                     **common)
    if args.model == "adanet":
        return ADANet(num_blocks=args.num_blocks, num_anchors=args.num_anchors,
                      dropout=args.dropout, mask_nonlinear=args.mask_nonlinear, **common)
    if args.model == "deep-clustering":
        return DeepEmbedding(num_layers=args.num_blocks, **common)
    raise ValueError(f"Unsupported model: {args.model}")


def main(args=None):
    args = build_parser().parse_args(args)
    device = resolve_device(args.device)
    if args.n_devices is not None:
        raise NotImplementedError("--n_devices (data parallelism, slice H) is not ported yet")
    set_seed(args.seed)

    ds_kwargs = dict(n_fft=args.n_fft, hop_length=args.hop_length, window_fn=args.window_fn,
                     mask_type=args.ideal_mask, threshold=args.threshold,
                     samples=int(args.duration * args.sample_rate), n_sources=args.n_sources)
    train_ds = IdealMaskSpectrogramTrainDataset(args.train_wav_root, args.train_list_path,
                                                **ds_kwargs)
    valid_ds = IdealMaskSpectrogramTrainDataset(args.valid_wav_root, args.valid_list_path,
                                                **ds_kwargs)
    print(f"Training dataset includes {len(train_ds)} samples.", flush=True)
    print(f"Valid dataset includes {len(valid_ds)} samples.", flush=True)
    train_loader = DataLoader(train_ds, batch_size=args.batch_size, shuffle=True, seed=args.seed,
                              num_workers=args.num_workers)
    valid_loader = DataLoader(valid_ds, batch_size=args.batch_size)

    model = build_spec_model(args, args.n_fft // 2 + 1, device)
    optimizer = make_optimizer(args.optimizer, args.lr, max_norm=args.max_norm or None,
                               momentum=args.momentum, params=model.parameters())
    config = TrainerConfig(epochs=args.epochs, exp_dir=args.exp_dir,
                           continue_from=args.continue_from, overwrite=bool(args.overwrite),
                           sample_rate=args.sample_rate, save_valid_wavs=0)
    common = dict(n_sources=args.n_sources, hop_length=args.hop_length)
    if args.model == "deep-clustering":
        if args.criterion != "affinity":
            raise ValueError("deep-clustering expects --criterion affinity")
        trainer = EmbeddingTrainer(model, train_loader, valid_loader, AffinityLoss(), optimizer,
                                   config, device, **common)
    else:
        if args.criterion not in ("se", "l2loss"):
            raise ValueError(f"Unsupported criterion for {args.model}: {args.criterion}")
        criterion = PIT2d(L2Loss(), n_sources=args.n_sources)
        if args.model == "danet":
            trainer = AttractorTrainer(model, train_loader, valid_loader, criterion, optimizer,
                                       config, device, **common)
        else:
            generator = (torch.Generator(device=device).manual_seed(args.seed)
                         if args.dropout > 0 else None)
            trainer = AnchoredAttractorTrainer(model, train_loader, valid_loader, criterion,
                                               optimizer, config, device, **common,
                                               dropout_generator=generator)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
