"""Oracle ideal-mask evaluation: the upper bound of a mask, with no model.

Port of `dnn_based_source_separation_tpu/cli/test_oracle_masks.py` (the reference's
`egs/wsj0-mix/frequency-mask/local/test.py`), with its flags plus `--device` (default
`cuda`; a CUDA device that is not there is an error, never a silent CPU run). Each test
utterance goes to the device; the mask (`--mask` ibm, irm, wfm or psm, from
`algorithm/frequency_mask.py`) of the sources' STFTs scales the mixture's complex STFT,
the iSTFT resynthesises the estimates, and the CLI prints the SI-SDR improvement over
the mixture per utterance and their mean, which it returns.

    python -m dnn_based_source_separation_torch.cli.test_oracle_masks \
        --test_wav_root ... --test_list_path ... --mask ibm --n_fft 256 --hop_length 64
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..algorithm.frequency_mask import (
    compute_ideal_binary_mask, compute_ideal_ratio_mask, compute_phase_sensitive_mask,
    compute_wiener_filter_mask,
)
from ..criterion.sdr import sisdr
from ..data import WaveTestDataset
from ..ops.stft import istft, stft
from ..ops.windows import build_window
from ..utils.device import resolve_device

MASKS = {
    "ibm": compute_ideal_binary_mask,
    "irm": compute_ideal_ratio_mask,
    "wfm": compute_wiener_filter_mask,
    "psm": compute_phase_sensitive_mask,
}


def build_parser():
    p = argparse.ArgumentParser("test_oracle_masks")
    p.add_argument("--test_wav_root", type=str, required=True)
    p.add_argument("--test_list_path", type=str, required=True)
    p.add_argument("--n_sources", type=int, default=2)
    p.add_argument("--n_fft", type=int, default=256)
    p.add_argument("--hop_length", type=int, default=64)
    p.add_argument("--mask", type=str, default="ibm", choices=sorted(MASKS))
    p.add_argument("--device", type=str, default="cuda")
    return p


@torch.no_grad()
def oracle_sisdr(mixture: torch.Tensor, sources: torch.Tensor, make_mask, n_fft: int,
                 hop_length: int, window: torch.Tensor):
    """mixture (1, T), sources (n, T) -> (mean SI-SDR of the masked estimates, of the
    mixture), 0-d tensors on the inputs' device."""
    T = mixture.shape[-1]
    mix_spec = stft(mixture[0], n_fft, hop_length, window=window)
    src_spec = stft(sources, n_fft, hop_length, window=window)
    est = istft(make_mask(src_spec) * mix_spec[None], n_fft, hop_length, window=window,
                length=T)
    return sisdr(est, sources).mean(), sisdr(mixture.expand_as(sources), sources).mean()


def main(args=None):
    args = build_parser().parse_args(args)
    device = resolve_device(args.device)
    window = build_window(args.n_fft, "hann", device=device)
    make_mask = MASKS[args.mask]
    improvements = []
    for utt_id, mixture, sources in WaveTestDataset(args.test_wav_root, args.test_list_path,
                                                    n_sources=args.n_sources):
        si_est, si_mix = oracle_sisdr(torch.from_numpy(mixture).to(device),
                                      torch.from_numpy(sources).to(device), make_mask,
                                      args.n_fft, args.hop_length, window)
        improvements.append(float(si_est) - float(si_mix))
        print(f"{utt_id}, SI-SDRi: {improvements[-1]:.3f}", flush=True)
    mean_imp = float(np.mean(improvements))
    print(f"Oracle {args.mask.upper()} SI-SDRi: {mean_imp:.3f} dB", flush=True)
    return mean_imp


if __name__ == "__main__":
    main()
