"""MUSDB18 training CLI: Open-Unmix (one model per stem), X-UMX (bridged), the 2-D dense /
U-Net spectrogram models (D3Net, MMDenseNet, MMDenseLSTM, HRNet, CUNet) and the waveform
models (stereo Conv-TasNet, MRX, Meta-TasNet).

Port of `dnn_based_source_separation_tpu/cli/train_musdb18.py` (after the
reference `egs/musdb18/{umx,x-umx}/local/train.py`): the same flag names
and defaults (its `build_parser`, :31-95), plus `--device` (default `cuda`),
as the port's `cli/train_wsj0mix.py` has. A CUDA device that is not there
is an error, never a silent CPU run.

- The loaders ship waveforms: by default the random-remix dataset with a
  random flip of the channels and a random gain per source
  (`--augmentation 1`), else fixed windows with 50% overlap. The STFT, the
  magnitude, the model and the loss run on the device.
- `--model umx`: ParallelOpenUnmix trains the magnitude MSE against the
  targets' STFT. `--model xumx`: bridged CrossNetOpenUnmix trains the
  multi-domain loss (`--weight_time`, `--weight_frequency`,
  `--combination`). `--model d3net` (`--d3net_config`), `mm-densenet` and
  `mm-dense-lstm` (`--mmdense_config`): one model a stem (ParallelD3Net,
  ParallelMMDenseNet, ParallelMMDenseLSTM) from the band-structured recipe YAML
  (`utils/config.py`), magnitude MSE. `--model hrnet`: one HRNet (`--hrnet_hidden`) for
  the stem `--target` alone (the loaders ship only it) under
  `SingleStemSpectrogramWrapper`, magnitude MAE. `--model cunet`: a FiLM / PoCM / GPoCM
  conditioned U-Net (`--cunet_channels`, `--cunet_control_channels`, `--conditioning`,
  5 x 5 kernels of stride 2, masking) under `ConditionedSpectrogramWrapper`, every stem's
  one-hot in one batch, magnitude MAE. `--model conv-tasnet`: Conv-TasNet with trainable
  filterbanks over both channels (`in_channels=2`, `-N -L -HH -B -Sc -X -R`)
  under `WaveChannelAdapter`, the waveform MSE over time and no PIT (the
  stems' order is fixed). `--model mrx`: MultiResolutionCrossNet
  (`--mrx_n_fft`, `--hop_length`, `--hidden_channels`, `--num_layers`) under
  `WaveChannelAdapter`, negative SI-SDR. `--model meta-tasnet`: one stage of
  Meta-TasNet on the mono downmix (`MonoWaveAdapter`), negative SI-SDR
  against the downmixed targets (`MonoTargetAdapter`). `--criterion
  mse|mae|l1loss` overrides any of them, in the model's output domain.
- The models train in f32 with Adam (`--optimizer`, `--lr`, `--max_norm`);
  dropout between the LSTM layers (`--dropout`) draws its masks from a
  generator on the device seeded with `--seed`, as the JAX CLI passes
  `dropout_rng` for umx and xumx.

`--n_devices` raises NotImplementedError naming the slice of the port that brings it. The
waveform models are validated here, on the valid split's loss; `cli/test_musdb18.py`
evaluates the spectrogram models with a stem list (not HRNet or CUNet), as JAX's does.

    python -m dnn_based_source_separation_torch.cli.train_musdb18 \
        --musdb18_root ... --model umx --exp_dir exp [--device cuda]
"""
from __future__ import annotations

import argparse

import torch

from ..augmentation import RandomFlip, RandomGain, SequentialAugmentation
from ..criterion import (
    MAELoss, MonoTargetAdapter, MSELoss, MultiDomainLoss, NegSISDR, SpectralTargetAdapter,
)
from ..data import DataLoader
from ..data import musdb18 as musdb
from ..models import (
    ConditionedSpectrogramWrapper, ConditionedUNet2d, ConvTasNet, CrossNetOpenUnmix, HRNet,
    MetaTasNet, MonoWaveAdapter, MultiResolutionCrossNet, ParallelOpenUnmix,
    SingleStemSpectrogramWrapper, SpectrogramMaskingWrapper, WaveChannelAdapter,
)
from ..ops.windows import build_window
from ..train import Trainer, TrainerConfig, make_optimizer
from ..utils import set_seed
from ..utils.config import (
    build_d3net_from_config, build_mmdenselstm_from_config, build_mmdensenet_from_config,
)
from ..utils.device import resolve_device

WAVE_MODELS = ("conv-tasnet", "mrx", "meta-tasnet")
BAND_MODELS = {"d3net": ("d3net_config", build_d3net_from_config),
               "mm-densenet": ("mmdense_config", build_mmdensenet_from_config),
               "mm-dense-lstm": ("mmdense_config", build_mmdenselstm_from_config)}
SPEC_MODELS = ("umx", "xumx", *BAND_MODELS, "hrnet", "cunet")


def build_parser():
    p = argparse.ArgumentParser("train_musdb18")
    p.add_argument("--musdb18_root", type=str, required=True)
    p.add_argument("--sample_rate", type=int, default=44100)
    p.add_argument("--duration", type=float, default=6.0)
    p.add_argument("--valid_duration", type=float, default=10.0)
    p.add_argument("--samples_per_epoch", type=int, default=None)
    p.add_argument("--augmentation", type=int, default=1)
    p.add_argument("--model", type=str, default="umx",
                   choices=[*SPEC_MODELS, *WAVE_MODELS])
    p.add_argument("--d3net_config", type=str, default=None,
                   help="band-structured YAML (egs/musdb18/d3net/config)")
    p.add_argument("--mmdense_config", type=str, default=None,
                   help="band-structured YAML (egs/musdb18/mm-densenet or mm-dense-lstm config)")
    p.add_argument("--criterion", type=str, default=None,
                   help="override the model's default: mse, mae or l1loss")
    # conv-tasnet / meta-tasnet (time domain) hyperparameters
    p.add_argument("--n_basis", "-N", type=int, default=256)
    p.add_argument("--kernel_size", "-L", type=int, default=20)
    p.add_argument("--sep_hidden_channels", "-HH", type=int, default=512)
    p.add_argument("--sep_bottleneck_channels", "-B", type=int, default=256)
    p.add_argument("--sep_skip_channels", "-Sc", type=int, default=128)
    p.add_argument("--sep_num_layers", "-X", type=int, default=10)
    p.add_argument("--sep_num_blocks", "-R", type=int, default=4)
    # hrnet (one stem), cunet and mrx
    p.add_argument("--target", type=str, default="vocals")
    p.add_argument("--hrnet_hidden", type=str, default="16,32,64")
    p.add_argument("--cunet_channels", type=str, default="2,16,32,64,128,256")
    p.add_argument("--cunet_control_channels", type=str, default="4,16,64")
    p.add_argument("--conditioning", type=str, default="film",
                   choices=["film", "pocm", "gpocm"])
    p.add_argument("--mrx_n_fft", type=str, default="512,1024,2048")
    # the spectrogram models
    p.add_argument("--n_fft", type=int, default=4096)
    p.add_argument("--hop_length", type=int, default=1024)
    p.add_argument("--window_fn", type=str, default="hann")
    p.add_argument("--hidden_channels", type=int, default=512)
    p.add_argument("--num_layers", type=int, default=3)
    p.add_argument("--max_bin", type=int, default=1487)
    p.add_argument("--dropout", type=float, default=0.4)
    p.add_argument("--sources", type=str, default="bass,drums,other,vocals")
    # loss weights (X-UMX)
    p.add_argument("--weight_time", type=float, default=10.0)
    p.add_argument("--weight_frequency", type=float, default=1.0)
    p.add_argument("--combination", type=int, default=1)
    # optimization
    p.add_argument("--optimizer", type=str, default="adam")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--max_norm", type=float, default=None)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--exp_dir", type=str, default="./exp")
    p.add_argument("--continue_from", type=str, default=None)
    p.add_argument("--time_budget_sec", type=float, default=None,
                   help="stop after this wall-clock budget (checked at epoch boundaries)")
    p.add_argument("--overwrite", type=int, default=0)
    p.add_argument("--seed", type=int, default=111)
    p.add_argument("--num_workers", type=int, default=0, help="background loader threads")
    p.add_argument("--cache_in_memory", type=int, default=0,
                   help="cache decoded stems in RAM after first use "
                        "(~4B x channels x corpus samples x (1+n_src); "
                        "full musdb18 train split ~40 GB)")
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel size (not ported: one device)")
    p.add_argument("--device", type=str, default="cuda")
    return p


def _refuse_unported(args) -> None:
    if args.n_devices is not None:
        raise NotImplementedError("--n_devices (data parallelism, slice H) is not ported yet")


def _wave_model(args, sources, device):
    """The waveform models (JAX `main`, :190-239) under their musdb18 adapters."""
    generator = torch.Generator().manual_seed(args.seed)
    sep = dict(sep_hidden_channels=args.sep_hidden_channels,
               sep_bottleneck_channels=args.sep_bottleneck_channels,
               sep_skip_channels=args.sep_skip_channels, sep_num_blocks=args.sep_num_blocks,
               sep_num_layers=args.sep_num_layers, n_sources=len(sources),
               generator=generator, device=device)
    if args.model == "conv-tasnet":
        base = ConvTasNet(n_basis=args.n_basis, kernel_size=args.kernel_size,
                          enc_basis="trainable", dec_basis="trainable", causal=False,
                          in_channels=2, **sep)
        return WaveChannelAdapter(base, device=device), MSELoss(dim=-1)
    if args.model == "mrx":
        base = MultiResolutionCrossNet(
            in_channels=2, hidden_channels=args.hidden_channels, num_layers=args.num_layers,
            n_fft=tuple(int(v) for v in args.mrx_n_fft.split(",")),
            hop_length=args.hop_length, sources=tuple(sources), generator=generator,
            device=device)
        return WaveChannelAdapter(base, device=device), NegSISDR()
    base = MetaTasNet(n_basis=args.n_basis, kernel_size=args.kernel_size, **sep)
    return MonoWaveAdapter(base, device=device), MonoTargetAdapter(NegSISDR())


def _spectrogram_model(args, sources, device, generator):
    """The slice-E spectrogram models (JAX `main`, :161-189 and :240-266) in their
    wrappers -> (model, the default criterion's key: mse or mae)."""
    stft_args = (args.n_fft, args.hop_length, args.window_fn)
    if args.model in BAND_MODELS:
        flag, build = BAND_MODELS[args.model]
        path = getattr(args, flag)
        if not path:
            raise ValueError(f"--{flag} is required for --model {args.model}")
        base = build(path, parallel=True, sources=tuple(sources), generator=generator,
                     device=device)
        return SpectrogramMaskingWrapper(base, *stft_args, device=device), "mse"
    if args.model == "hrnet":
        base = HRNet(in_channels=2,
                     hidden_channels=tuple(int(v) for v in args.hrnet_hidden.split(",")),
                     generator=generator, device=device)
        return SingleStemSpectrogramWrapper(base, *stft_args, device=device), "mae"
    base = ConditionedUNet2d(
        channels=tuple(int(v) for v in args.cunet_channels.split(",")), kernel_size=(5, 5),
        stride=(2, 2),
        control_channels=tuple(int(v) for v in args.cunet_control_channels.split(",")),
        conditioning=args.conditioning, masking=True, generator=generator, device=device)
    return ConditionedSpectrogramWrapper(base, *stft_args, n_sources=len(sources),
                                         device=device), "mae"


def build_model_and_criterion(args, sources, device):
    """The wrapped model on `device` and its criterion (JAX `main`, :144-266, and the
    override table by output domain, :268-289)."""
    if args.model in WAVE_MODELS:
        model, criterion = _wave_model(args, sources, device)
        table = {"mse": MSELoss(dim=-1), "mae": MAELoss(dim=-1)}
        if args.model == "meta-tasnet":  # its estimates are of the mono downmix
            table = {k: MonoTargetAdapter(v) for k, v in table.items()}
        table["l1loss"] = table["mae"]
        return model, table.get(args.criterion, criterion)
    n_bins = args.n_fft // 2 + 1
    base_kwargs = dict(in_channels=2, hidden_channels=args.hidden_channels,
                       num_layers=args.num_layers, n_bins=n_bins,
                       max_bin=min(args.max_bin, n_bins), dropout=args.dropout,
                       sources=tuple(sources), generator=torch.Generator().manual_seed(args.seed),
                       device=device)
    stft_args = (args.n_fft, args.hop_length, args.window_fn)
    table = {"mse": SpectralTargetAdapter(MSELoss(dim=(-2, -1)), *stft_args),
             "mae": SpectralTargetAdapter(MAELoss(dim=(-2, -1)), *stft_args)}
    table["l1loss"] = table["mae"]
    if args.model not in ("umx", "xumx"):
        model, default = _spectrogram_model(args, sources, device,
                                            torch.Generator().manual_seed(args.seed))
        return model, table.get(args.criterion, table[default])
    if args.model == "umx":
        base = ParallelOpenUnmix(**base_kwargs)
        criterion = table["mse"]
    else:
        base = CrossNetOpenUnmix(**base_kwargs)
        criterion = SpectralTargetAdapter(
            MultiDomainLoss(args.n_fft, args.hop_length,
                            window=build_window(args.n_fft, args.window_fn, device=device),
                            weight_time=args.weight_time,
                            weight_frequency=args.weight_frequency,
                            combination=bool(args.combination)),
            *stft_args, complex_target=True)
    if args.criterion in table:
        criterion = table[args.criterion]
    model = SpectrogramMaskingWrapper(base, *stft_args, device=device)
    return model, criterion


def main(args=None):
    args = build_parser().parse_args(args)
    device = resolve_device(args.device)
    _refuse_unported(args)
    set_seed(args.seed)
    sources = args.sources.split(",")
    if args.model == "hrnet":  # one stem: the loaders ship only the target
        if args.target not in sources:
            raise ValueError(f"--target {args.target} not in --sources {args.sources}")
        sources = [args.target]

    if args.augmentation:
        augmentation = SequentialAugmentation(RandomFlip(flip_rate=0.5, axis=0),
                                              RandomGain(0.25, 1.25))
        train_ds = musdb.AugmentationWaveTrainDataset(
            args.musdb18_root, duration=args.duration, sample_rate=args.sample_rate,
            samples_per_epoch=args.samples_per_epoch, sources=sources,
            augmentation=augmentation, seed=args.seed,
            cache_in_memory=bool(args.cache_in_memory))
    else:
        train_ds = musdb.WaveTrainDataset(
            args.musdb18_root, duration=args.duration, sample_rate=args.sample_rate,
            sources=sources, cache_in_memory=bool(args.cache_in_memory))
    valid_ds = musdb.WaveEvalDataset(args.musdb18_root, max_duration=args.valid_duration,
                                     sample_rate=args.sample_rate, sources=sources)
    print(f"Training dataset includes {len(train_ds)} samples.", flush=True)
    print(f"Valid dataset includes {len(valid_ds)} samples.", flush=True)
    train_loader = DataLoader(train_ds, batch_size=args.batch_size, shuffle=True, seed=args.seed,
                              num_workers=args.num_workers)
    valid_loader = DataLoader(valid_ds, batch_size=1)

    model, criterion = build_model_and_criterion(args, sources, device)
    optimizer = make_optimizer(args.optimizer, args.lr, max_norm=args.max_norm,
                               params=model.parameters())
    config = TrainerConfig(
        epochs=args.epochs, exp_dir=args.exp_dir, continue_from=args.continue_from,
        overwrite=bool(args.overwrite), sample_rate=args.sample_rate, save_valid_wavs=0,
        time_budget_sec=args.time_budget_sec)
    # Only UMX and X-UMX have dropout, as the JAX CLI passes dropout_rng for them alone.
    generator = (torch.Generator(device=device).manual_seed(args.seed)
                 if args.model in ("umx", "xumx") and args.dropout > 0.0 else None)
    trainer = Trainer(model, train_loader, valid_loader, criterion, optimizer, config, device,
                      dropout_generator=generator)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
