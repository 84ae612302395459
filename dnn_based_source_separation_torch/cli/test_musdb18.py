"""MUSDB18 evaluation CLI: chunked full-track inference, Wiener EM, museval medians.

Port of `dnn_based_source_separation_tpu/cli/test_musdb18.py` (:30-155),
after the reference `egs/musdb18/umx/src/adhoc_driver.py:243-416`. Each
test track is cut into `--duration` chunks (the last zero-padded); per
chunk the spectrogram model (a `SpectrogramMaskingWrapper` checkpoint)
runs at B = 1 and the mixture chunk's STFT is taken. The chunks'
magnitudes and spectra are concatenated along frames, the multichannel
Wiener EM refines the whole track at once, the iSTFT resynthesises each
chunk's span, and the `Evaluater` reports museval-v4 medians of medians.
Everything up to the host copy of the stems stays on `--device` in
complex64 and float32.

Flags: the JAX CLI's, plus `--device` (default `cuda`; a CUDA device that
is not there is an error). A non-finite estimate raises, naming the track
and the count (the JAX CLI retries and zero-fills).

    python -m dnn_based_source_separation_torch.cli.test_musdb18 \
        --musdb18_root ... --model_path best.pth [--out_dir out] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..algorithm.frequency_mask import multichannel_wiener_filter
from ..data import musdb18 as musdb
from ..data.audio_io import write_wav
from ..models.base import load_model
from ..ops.stft import istft
from ..train.tester import Evaluater
from ..utils import set_seed

STAGES = ("forward", "stft", "wiener", "istft")


def build_parser():
    p = argparse.ArgumentParser("test_musdb18")
    p.add_argument("--musdb18_root", type=str, required=True)
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--sample_rate", type=int, default=44100)
    p.add_argument("--duration", type=float, default=10.0, help="chunk seconds")
    p.add_argument("--max_duration", type=float, default=None, help="cap per track")
    p.add_argument("--iter_wiener", type=int, default=1)
    p.add_argument("--out_dir", type=str, default=None)
    p.add_argument("--filt_len", type=int, default=512)
    p.add_argument("--win", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=111)
    p.add_argument("--device", type=str, default="cuda")
    return p


class StageClock:
    """Device time by stage: CUDA events on the card (read once the track is on the
    host, so nothing waits between stages), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = [(None, self._now())]

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def mark(self, stage: str) -> None:
        """The stage that ran since the last mark ends here."""
        self.marks.append((stage, self._now()))

    def ms(self) -> dict:
        out = dict.fromkeys(STAGES, 0.0)
        for (_, a), (stage, b) in zip(self.marks, self.marks[1:]):
            out[stage] += a.elapsed_time(b) if self.cuda else (b - a) * 1e3
        return out


def separate_track(model, mixture: torch.Tensor, chunk: int, iter_wiener: int):
    """mixture (1, C, T) on the model's device -> (stems (n_src, C, T) f32 on the device,
    stage ms, the Wiener EM's peak of allocated bytes on the card, else None)."""
    n_fft, hop, window = model.n_fft, model.hop_length, model.window
    T = mixture.shape[-1]
    n_chunks = -(-T // chunk)
    mix_p = torch.nn.functional.pad(mixture, (0, n_chunks * chunk - T))
    clock = StageClock(mixture.device)
    amps, specs = [], []
    for i in range(n_chunks):
        seg = mix_p[..., i * chunk : (i + 1) * chunk]  # (1, C, chunk)
        amps.append(model(seg[None])[0])  # (n_src, C, F, S)
        clock.mark("forward")
        specs.append(model.spectrogram(seg[0]))  # (C, F, S) complex
        clock.mark("stft")
    est_amp, mix_spec = torch.cat(amps, dim=-1), torch.cat(specs, dim=-1)
    peak = None
    if mixture.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mixture.device)
    est = multichannel_wiener_filter(mix_spec, est_amp, iteration=iter_wiener)
    if mixture.device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(mixture.device)
    clock.mark("wiener")
    S = amps[0].shape[-1]
    waves = [istft(est[..., i * S : (i + 1) * S], n_fft, hop, window=window, length=chunk)
             for i in range(n_chunks)]
    wave = torch.cat(waves, dim=-1)[..., :T]
    clock.mark("istft")
    return wave, clock, peak


def run(args=None):
    """Evaluate every test track -> (the Evaluater's table, per-track stats: audio
    seconds, chunks, stage ms, separation and evaluation wall seconds, EM peak bytes)."""
    args = build_parser().parse_args(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device} asked for, but CUDA is not available")
    set_seed(args.seed)

    model = load_model(args.model_path, device=device).eval()
    sources = list(model.base.sources)
    dataset = musdb.WaveTestDataset(args.musdb18_root, sources=sources)
    evaluater = Evaluater(sources=sources, sample_rate=args.sample_rate,
                          win=args.win, hop=args.win, filt_len=args.filt_len)
    chunk = int(args.duration * args.sample_rate)

    stats = []
    for name, mixture, refs in dataset:
        # mixture (1, C, T); refs (n_src, C, T)
        T = mixture.shape[-1]
        if args.max_duration is not None:
            T = min(T, int(args.max_duration * args.sample_rate))
            mixture, refs = mixture[..., :T], refs[..., :T]

        start = time.perf_counter()
        with torch.inference_mode():
            wave, clock, peak = separate_track(
                model, torch.from_numpy(np.ascontiguousarray(mixture)).to(device), chunk,
                args.iter_wiener)
            est_wave = wave.cpu().numpy()
        separate_s = time.perf_counter() - start
        bad = int((~np.isfinite(est_wave)).sum())
        if bad:
            raise RuntimeError(f"{name}: {bad} non-finite samples in the estimates")

        start = time.perf_counter()
        evaluater.add_track(refs.transpose(0, 2, 1), est_wave.transpose(0, 2, 1))
        evaluate_s = time.perf_counter() - start
        if args.out_dir:
            d = os.path.join(args.out_dir, name)
            os.makedirs(d, exist_ok=True)
            for s, src_name in enumerate(sources):
                write_wav(os.path.join(d, f"{src_name}.wav"), est_wave[s].T, args.sample_rate)
        ms = clock.ms()
        stats.append(dict(name=name, seconds=T / args.sample_rate, chunks=-(-T // chunk),
                          separate_s=separate_s, evaluate_s=evaluate_s, wiener_peak_bytes=peak,
                          **{f"{k}_ms": v for k, v in ms.items()}))
        print(f"{name}: done ({T / args.sample_rate:.1f}s); " +
              ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items()) +
              f"; separated in {separate_s:.2f} s, evaluated in {evaluate_s:.2f} s", flush=True)

    table = evaluater.aggregate()
    for metric in Evaluater.METRICS:
        print(
            f"{metric} (median of medians):",
            ", ".join(f"{k}: {v[metric]:.2f}" for k, v in table.items()),
            flush=True,
        )
    return table, stats


def main(args=None):
    return run(args)[0]


if __name__ == "__main__":
    main()
