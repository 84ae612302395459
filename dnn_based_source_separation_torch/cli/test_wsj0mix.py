"""wsj0-mix evaluation CLI.

Port of `dnn_based_source_separation_tpu/cli/test_wsj0mix.py`: its flags (its
`build_parser`, :19-38) plus `--device` (default `cuda`; a CUDA device that is not
there is an error, never a silent CPU run) and `--dtype`, as `cli/separate.py` has. It
rebuilds the model from the port checkpoint alone, then reports per-utterance SI-SDRi,
SDRi, SIRi and SAR (and PESQ* through `--pesq_bin`) and writes the estimates with
`--out_dir`. Waveform models (Wavesplit too, on its KMeans path) go through `Tester`;
`--spec_kind danet|adanet|embedding` evaluates a spectrogram-domain checkpoint through
`AttractorTester` (`--n_fft`, `--hop_length`, `--window_fn`, `--iter_clustering`): the
mixture's STFT, clustering inference, resynthesis with the mixture's phase.

    python -m dnn_based_source_separation_torch.cli.test_wsj0mix \
        --test_wav_root ... --test_list_path ... --model_path best.ckpt \
        [--spec_kind danet --n_fft 256 --hop_length 64] [--out_dir out] [--device cuda] \
        [--dtype bfloat16]
"""
from __future__ import annotations

import argparse

import torch

from ..criterion import NegSISDR, PIT1d
from ..data import WaveTestDataset
from ..models.base import load_model
from ..train.tester import AttractorTester, Tester
from ..utils import set_seed
from ..utils.device import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_parser():
    p = argparse.ArgumentParser("test_wsj0mix")
    p.add_argument("--test_wav_root", type=str, required=True)
    p.add_argument("--test_list_path", type=str, required=True)
    p.add_argument("--sample_rate", type=int, default=8000)
    p.add_argument("--n_sources", type=int, default=2)
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--out_dir", type=str, default=None)
    p.add_argument("--pesq_bin", type=str, default=None)
    p.add_argument("--filt_len", type=int, default=512)
    p.add_argument("--seed", type=int, default=111)
    # spectrogram-domain models (DANet / ADANet / deep clustering): the clustering
    # inference and mixture-phase resynthesis path
    p.add_argument("--spec_kind", type=str, default=None,
                   choices=[None, "danet", "adanet", "embedding"])
    p.add_argument("--n_fft", type=int, default=256)
    p.add_argument("--hop_length", type=int, default=64)
    p.add_argument("--window_fn", type=str, default="hann")
    p.add_argument("--iter_clustering", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dtype", type=str, default="float32", choices=sorted(DTYPES))
    return p


def main(args=None):
    args = build_parser().parse_args(args)
    device = resolve_device(args.device)
    set_seed(args.seed)

    model = load_model(args.model_path, device=device).to(DTYPES[args.dtype]).eval()
    dataset = WaveTestDataset(args.test_wav_root, args.test_list_path, n_sources=args.n_sources)
    criterion = PIT1d(NegSISDR(), n_sources=args.n_sources)
    common = dict(sample_rate=args.sample_rate, out_dir=args.out_dir, pesq_bin=args.pesq_bin,
                  filt_len=args.filt_len)
    if args.spec_kind:
        tester = AttractorTester(model, dataset, criterion, n_fft=args.n_fft,
                                 hop_length=args.hop_length, window_fn=args.window_fn,
                                 kind=args.spec_kind, n_sources=args.n_sources,
                                 iter_clustering=args.iter_clustering, **common)
    else:
        tester = Tester(model, dataset, criterion, **common)
    return tester.run()


if __name__ == "__main__":
    main()
