"""How far the multichannel Wiener EM moves musdb18 stems when the model's magnitudes move
by rounding.

Runs the PyTorch port's musdb18 path (paper-config seed-0 ParallelOpenUnmix as
`chip_smoke.py` phase 11 builds it, the same synthetic corpus of two 20 s
tracks) on the CPU and compares the stems of:
  * the f32 forward and EM (what `cli/test_musdb18.py --device cpu` computes);
  * the f32 forward with the EM in float64: the EM's own f32 rounding;
  * a float64 forward cast to f32, with the f32 EM: rounding-level changes of
    the magnitudes (about 1e-6 of their max), as another device's kernels
    give them.
Each line: the largest change of the stems over max|stems|, and of the
magnitudes over max|magnitudes|; for the float64 forward also the largest
change of the EM's starting ratio mask a_j / (sum_j a_j + eps) and the
mixture's |X| in that bin (where every stem's mask but one is relu-zero, a
mask crossing zero moves the whole bin between that stem and none).

    PYTHONPATH=. python3 scripts/probe_musdb_em_sensitivity.py [--model umx|xumx]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke as cs  # noqa: E402
from dnn_based_source_separation_torch.algorithm.frequency_mask import (  # noqa: E402
    multichannel_wiener_filter,
)
from dnn_based_source_separation_torch.data.musdb18 import WaveTestDataset  # noqa: E402
from dnn_based_source_separation_torch.data.synthetic import (  # noqa: E402
    write_musdb_quality_corpus,
)
from dnn_based_source_separation_torch.ops.stft import istft  # noqa: E402


def stems(model, spec, amps, chunk, S):
    est = multichannel_wiener_filter(spec, amps)
    window = model.window.to(est.real.dtype)
    return torch.cat([istft(est[..., i * S:(i + 1) * S], model.n_fft, model.hop_length,
                            window=window, length=chunk)
                      for i in range(amps.shape[-1] // S)], dim=-1).double().numpy()


def main(argv=None):
    p = argparse.ArgumentParser("probe_musdb_em_sensitivity")
    p.add_argument("--model", choices=["umx", "xumx"], default="umx")
    args = p.parse_args(argv)
    model = cs.umx_wrapper(args.model, device="cpu")
    model64 = cs.umx_wrapper(args.model, device="cpu").double()
    chunk = int(cs.MUSDB_CHUNK_SECONDS * cs.MUSDB_SAMPLE_RATE)
    with tempfile.TemporaryDirectory() as root, torch.inference_mode():
        write_musdb_quality_corpus(root, n_train=0, n_valid=0, n_test=cs.MUSDB_TRACKS,
                                   track_sec=cs.MUSDB_TRACK_SECONDS,
                                   sample_rate=cs.MUSDB_SAMPLE_RATE)
        for idx, (name, mixture, _) in enumerate(WaveTestDataset(root)):
            x = torch.from_numpy(mixture)
            segs = [x[None, ..., i:i + chunk] for i in range(0, x.shape[-1], chunk)]
            amps = torch.cat([model(s)[0] for s in segs], dim=-1)
            amps64 = torch.cat([model64(s.double())[0] for s in segs], dim=-1).float()
            spec = torch.cat([model.spectrogram(s[0, 0]) for s in segs], dim=-1)
            S = amps.shape[-1] // len(segs)
            ref = stems(model, spec, amps, chunk, S)
            scale = np.abs(ref).max()
            runs = {"EM in float64": stems(model, spec.to(torch.complex128), amps.double(),
                                           chunk, S),
                    "float64 forward, f32 EM": stems(model, spec, amps64, chunk, S)}
            moved = float((amps64 - amps).abs().max() / amps.abs().max())
            eps = 1e-12
            ratio = (amps / (amps.sum(0) + eps) - amps64 / (amps64.sum(0) + eps)).abs()
            at = np.unravel_index(int(ratio.argmax()), ratio.shape)
            for what, got in runs.items():
                print(f"{name} ({args.model}): {what}: stems moved "
                      f"{np.abs(got - ref).max() / scale:.3e} of max|stems| {scale:.3e}"
                      + (f"; magnitudes moved {moved:.3e} of their max; ratio mask moved "
                         f"{float(ratio.max()):.3e} at (source, channel, bin, frame) "
                         f"{tuple(int(i) for i in at)}, |X| {float(spec.abs()[at[1:]]):.3e} "
                         f"there (max|X| {float(spec.abs().max()):.3e})"
                         if "forward" in what else ""), flush=True)


if __name__ == "__main__":
    main()
