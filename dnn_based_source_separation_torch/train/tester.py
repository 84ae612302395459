"""wsj0-mix Tester: per-utterance metrics over a test list.

Port of `dnn_based_source_separation_tpu/train/tester.py:Tester` (:29-157),
which follows the reference recipe's TesterBase: per utterance, the PIT loss
of the estimates, its improvement over the mixture tiled to every source
(SI-SDRi for negative SI-SDR), BSS Eval SDRi / SIRi / SAR on the host,
optionally PESQ* through a command-line tool, one CSV line each and the
averages at the end. The forward runs under
`torch.no_grad()` on the model's device and in its dtype, at each
utterance's exact length. `Evaluater` and `AttractorTester` come with
slices C and F.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..data.audio_io import write_wav
from ..utils.audio import evaluate_pesq
from ..utils.bss import bss_eval_sources


class Tester:
    """wsj0-mix style tester over a WaveTestDataset-like iterable of (id, mixture, sources)."""

    def __init__(
        self,
        model: torch.nn.Module,
        dataset,
        pit_criterion: Callable,
        sample_rate: int = 8000,
        out_dir: Optional[str] = None,
        pesq_bin: Optional[str] = None,
        filt_len: int = 512,
    ):
        self.model = model
        self.dataset = dataset
        self.pit_criterion = pit_criterion
        self.sample_rate = sample_rate
        self.out_dir = out_dir
        self.pesq_bin = pesq_bin
        self.filt_len = filt_len
        param = next(model.parameters())
        self.device, self.dtype = param.device, param.dtype

    def run(self, verbose: bool = True):
        """Returns a dict of averaged metrics; prints a CSV line per utterance.

        Beside the JAX Tester's metrics the dict holds `forward_ms` (the
        forward and the losses, up to the estimates on the host) and
        `bss_eval_ms`, each averaged per utterance: where the evaluation's
        wall time goes.
        """
        results = {"loss": [], "loss_improvement": [], "sdr_improvement": [],
                   "sir_improvement": [], "sar": [], "pesq": [], "forward_ms": [],
                   "bss_eval_ms": []}
        if verbose:
            # PESQ* = the repo's calibrated P.862-style tool, not the certified
            # ITU binary (native/pesq/CALIBRATION.md); starred so the column is
            # not compared with published certified scores.
            print("ID, Loss, Loss improvement, SDR improvement, SIR improvement, SAR, PESQ*",
                  flush=True)

        for utt_id, mixture, sources in self.dataset:
            start = time.perf_counter()
            with torch.no_grad():
                mixture_t = torch.from_numpy(np.asarray(mixture)).to(self.device)[None]  # (1, 1, T)
                sources_t = torch.from_numpy(np.asarray(sources)).to(self.device)[None]
                estimates = self.model(mixture_t.to(self.dtype)).float()
                loss, _ = self.pit_criterion(estimates, sources_t)
                n_src = sources.shape[0]
                loss_mix, _ = self.pit_criterion(mixture_t.repeat(1, n_src, 1), sources_t)
                loss, loss_mix = float(loss), float(loss_mix)
                est_np = estimates[0].cpu().numpy()
            loss_improvement = loss_mix - loss  # SI-SDRi for NegSISDR
            results["forward_ms"].append((time.perf_counter() - start) * 1e3)

            src_np = np.asarray(sources)
            mix_np = np.tile(np.asarray(mixture), (n_src, 1))
            sdr, sir, sar, perm = bss_eval_sources(src_np, est_np, filt_len=self.filt_len)
            sdr0, sir0, _, _ = bss_eval_sources(src_np, mix_np, filt_len=self.filt_len)
            sdr_i, sir_i = float(np.mean(sdr - sdr0)), float(np.mean(sir - sir0))
            results["bss_eval_ms"].append((time.perf_counter() - start) * 1e3
                                          - results["forward_ms"][-1])

            pesq_score = self._pesq(src_np, est_np, perm) if self.pesq_bin else float("nan")

            results["loss"].append(loss)
            results["loss_improvement"].append(loss_improvement)
            results["sdr_improvement"].append(sdr_i)
            results["sir_improvement"].append(sir_i)
            results["sar"].append(float(np.mean(sar)))
            results["pesq"].append(pesq_score)
            if verbose:
                print(f"{utt_id}, {loss:.3f}, {loss_improvement:.3f}, {sdr_i:.3f}, {sir_i:.3f}, "
                      f"{float(np.mean(sar)):.3f}, {pesq_score:.3f}", flush=True)
            if self.out_dir:
                self._dump(utt_id, np.asarray(mixture), est_np)

        summary = {}
        for k, v in results.items():
            arr = np.asarray(v, dtype=float)
            valid = arr.size and not np.all(np.isnan(arr))
            summary[k] = float(np.nanmean(arr)) if valid else float("nan")
        if verbose:
            print(f"Loss: {summary['loss']:.3f}, Loss improvement: "
                  f"{summary['loss_improvement']:.3f}, "
                  f"SDR improvement: {summary['sdr_improvement']:.3f}, "
                  f"SIR improvement: {summary['sir_improvement']:.3f}, "
                  f"SAR: {summary['sar']:.3f}, PESQ*: {summary['pesq']:.3f}", flush=True)
        return summary

    def _pesq(self, references: np.ndarray, estimates: np.ndarray, perm) -> float:
        """PESQ through the command-line tool; a failure scores the floor, -0.5
        (as the reference recipe's TesterBase scores it)."""
        scores = []
        tmp = tempfile.mkdtemp()
        try:
            for j, p in enumerate(perm):
                ref_path = os.path.join(tmp, f"ref{j}.wav")
                est_path = os.path.join(tmp, f"est{j}.wav")
                ref = references[p] / (np.abs(references[p]).max() + 1e-9)
                est = estimates[j] / (np.abs(estimates[j]).max() + 1e-9)
                write_wav(ref_path, ref, self.sample_rate)
                write_wav(est_path, est, self.sample_rate)
                try:
                    scores.append(evaluate_pesq(self.pesq_bin, ref_path, est_path,
                                                self.sample_rate))
                except (subprocess.CalledProcessError, RuntimeError, OSError):
                    scores.append(-0.5)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return float(np.mean(scores))

    def _dump(self, utt_id, mixture, estimates):
        out = os.path.join(self.out_dir, utt_id)
        os.makedirs(out, exist_ok=True)
        mix = mixture.reshape(-1)
        write_wav(os.path.join(out, "mixture.wav"), mix / (np.abs(mix).max() + 1e-9),
                  self.sample_rate)
        for s in range(estimates.shape[0]):
            est = estimates[s] / (np.abs(estimates[s]).max() + 1e-9)
            write_wav(os.path.join(out, f"source{s}.wav"), est, self.sample_rate)
