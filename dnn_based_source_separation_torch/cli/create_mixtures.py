"""Create wsj0-mix style mixtures from a task list.

Port of `dnn_based_source_separation_tpu/cli/create_mixtures.py` (numpy on the host,
over the port's `data/audio_io.py`; the same files bit for bit). Each line of the list
is the official wsj0-2mix TaskFile format,

    <path_s1> <snr_db_1> <path_s2> <snr_db_2> [...more pairs]

The sources are scaled to the given levels relative to unit RMS, cut or zero-padded
to the shortest (`--length min`) or longest (`max`) one, peak-normalised jointly with
their sum (so the mixture stays the sum of the sources), and written to
out_root/{mix,s1,s2,...}/<id>.wav, the ID the sources' names joined by '_'.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.audio_io import read_wav, write_wav


def build_parser():
    p = argparse.ArgumentParser("create_mixtures")
    p.add_argument("--list_path", type=str, required=True)
    p.add_argument("--wav_root", type=str, default="", help="prefix for list paths")
    p.add_argument("--out_root", type=str, required=True)
    p.add_argument("--length", type=str, default="min", choices=["min", "max"])
    p.add_argument("--sample_rate", type=int, default=8000)
    return p


def _mix_id(paths):
    return "_".join(os.path.splitext(os.path.basename(p))[0] for p in paths)


def main(args=None):
    args = build_parser().parse_args(args)
    with open(args.list_path) as f:
        lines = [ln.split() for ln in f if ln.strip()]

    n_sources = len(lines[0]) // 2
    os.makedirs(os.path.join(args.out_root, "mix"), exist_ok=True)
    for s in range(n_sources):
        os.makedirs(os.path.join(args.out_root, f"s{s + 1}"), exist_ok=True)

    for tokens in lines:
        paths = [os.path.join(args.wav_root, tokens[2 * i]) for i in range(n_sources)]
        snrs = [float(tokens[2 * i + 1]) for i in range(n_sources)]
        sigs = []
        for p, snr in zip(paths, snrs):
            x, _ = read_wav(p)
            if x.ndim > 1:
                x = x.mean(axis=1)
            rms = np.sqrt(np.mean(np.square(x)) + 1e-12)  # the level relative to unit RMS
            sigs.append(x / rms * (10.0 ** (snr / 20.0)))
        T = min(len(s) for s in sigs) if args.length == "min" else max(len(s) for s in sigs)
        sigs = [np.pad(s[:T], (0, T - min(T, len(s)))) for s in sigs]
        mixture = np.sum(sigs, axis=0)
        # Joint peak normalisation keeps mixture = sum of the sources exact.
        peak = max(np.abs(mixture).max(), max(np.abs(s).max() for s in sigs)) + 1e-9
        scale = 0.9 / peak
        utt = _mix_id(paths)
        write_wav(os.path.join(args.out_root, "mix", f"{utt}.wav"), mixture * scale,
                  args.sample_rate)
        for i, s in enumerate(sigs):
            write_wav(os.path.join(args.out_root, f"s{i + 1}", f"{utt}.wav"), s * scale,
                      args.sample_rate)
    print(f"wrote {len(lines)} mixtures ({n_sources} sources) to {args.out_root}", flush=True)


if __name__ == "__main__":
    main()
