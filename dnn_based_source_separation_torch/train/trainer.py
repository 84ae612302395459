"""Epoch-loop Trainer with LR halving, early stop, best/last checkpoints and resume.

Port of `dnn_based_source_separation_tpu/train/trainer.py:35-315`, which
follows the reference recipe's epoch loop:
  * a valid loss below the best so far saves best.ckpt and resets the counter;
  * a valid loss >= the previous epoch's adds one to `no_improvement`:
    at 10 training stops, from 3 on the learning rate halves each time;
  * last.ckpt every epoch, loss.png when matplotlib is present, and the
    first validation batches' estimates as WAVs;
  * --continue_from restores weights, optimizer state, epoch, counters and
    the loss history.

Training losses stay on the device until the epoch ends, as the JAX
trainer keeps them (`trainer.py:177-180`): reading one every step would
make the host wait for the card. `ORPITTrainer` (JAX :318-370) trains on
(mixture, padded sources, counts) batches with the ORPIT criterion.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..data.audio_io import write_wav
from ..data.loader import prefetch_to_device
from ..models.base import read_checkpoint, save_model
from .steps import (
    Optimizer, get_learning_rate, make_eval_step, make_train_step, set_learning_rate,
)


@dataclasses.dataclass
class TrainerConfig:
    epochs: int = 100
    exp_dir: str = "exp"
    continue_from: Optional[str] = None
    overwrite: bool = False
    lr_halving_patience: int = 3
    early_stop_patience: int = 10
    save_valid_wavs: int = 5
    sample_rate: int = 8000
    log_interval: int = 100
    # Stop after this many wall-clock seconds, checked at epoch boundaries
    # (last.ckpt is still written, so --continue_from resumes cleanly).
    time_budget_sec: Optional[float] = None


class Trainer:
    """Drives epoch training of a separation model on one device."""

    samples_per_step = 1  # audio samples per step of a batch's last axis (a hop for frames)

    def __init__(self, model: torch.nn.Module, train_loader, valid_loader, criterion: Callable,
                 optimizer: Optimizer, config: TrainerConfig, device,
                 compute_dtype: Optional[torch.dtype] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        self.model, self.optimizer, self.config = model, optimizer, config
        self.train_loader, self.valid_loader = train_loader, valid_loader
        self.device = torch.device(device)
        self.last_epoch_stats = None  # pipeline stats of the latest train epoch
        self.model_dir = os.path.join(config.exp_dir, "model")
        self.loss_dir = os.path.join(config.exp_dir, "loss")
        self.sample_dir = os.path.join(config.exp_dir, "sample")
        for d in (self.model_dir, self.loss_dir, self.sample_dir):
            os.makedirs(d, exist_ok=True)

        # dropout_generator (a torch.Generator on `device`) draws the models' dropout
        # masks, as the JAX trainer's dropout_rng does.
        self.train_step = make_train_step(model, criterion, optimizer, compute_dtype=compute_dtype,
                                          generator=dropout_generator)
        self.eval_step = make_eval_step(model, criterion)

        if config.continue_from:
            blob = read_checkpoint(config.continue_from)
            model.load_state_dict(blob["state_dict"])
            extra = blob["extra"]
            optimizer.load_state_dict(extra["optim"])
            self.start_epoch = int(extra["epoch"]) + 1
            self.best_loss = float(extra["best_loss"])
            self.prev_loss = float(extra["prev_loss"])
            self.no_improvement = int(extra["no_improvement"])
            self.train_loss = list(extra["train_loss"])
            self.valid_loss = list(extra["valid_loss"])
        else:
            best = os.path.join(self.model_dir, "best.ckpt")
            if os.path.exists(best) and not config.overwrite:
                raise ValueError(f"{best} already exists; set overwrite=True to continue.")
            self.start_epoch = 0
            self.best_loss = float("inf")
            self.prev_loss = float("inf")
            self.no_improvement = 0
            self.train_loss = []
            self.valid_loss = []

    # -- epoch loop -------------------------------------------------------
    def run(self) -> None:
        cfg = self.config
        run_start = time.time()
        for epoch in range(self.start_epoch, cfg.epochs):
            start = time.time()
            train_loss = self.run_one_epoch_train(epoch)
            valid_loss = self.run_one_epoch_eval(epoch)
            print(f"[Epoch {epoch + 1}/{cfg.epochs}] loss (train): {train_loss:.5f}, "
                  f"loss (valid): {valid_loss:.5f}, {time.time() - start:.3f} [sec]", flush=True)
            self.train_loss.append(train_loss)
            self.valid_loss.append(valid_loss)

            stop = False
            if valid_loss < self.best_loss:
                self.best_loss = valid_loss
                self.no_improvement = 0
                self.save_checkpoint(epoch, os.path.join(self.model_dir, "best.ckpt"))
            elif valid_loss >= self.prev_loss:
                self.no_improvement += 1
                if self.no_improvement >= cfg.early_stop_patience:
                    print("Stop training")
                    stop = True
                elif self.no_improvement >= cfg.lr_halving_patience:
                    prev_lr = get_learning_rate(self.optimizer)
                    lr = 0.5 * prev_lr
                    print(f"Learning rate: {prev_lr} -> {lr}")
                    set_learning_rate(self.optimizer, lr)
            else:
                self.no_improvement = 0

            self.prev_loss = valid_loss
            self.save_checkpoint(epoch, os.path.join(self.model_dir, "last.ckpt"))
            self.draw_loss_curve()
            if stop:
                break
            if cfg.time_budget_sec is not None and time.time() - run_start >= cfg.time_budget_sec:
                print(f"Time budget reached ({cfg.time_budget_sec:.0f} s); "
                      "stopping after checkpoint.", flush=True)
                break

    def run_one_epoch_train(self, epoch: int) -> float:
        cfg = self.config
        epoch_start = time.time()
        audio_seconds = 0.0
        device_losses = []
        # Time spent waiting for the next staged batch (host pipeline and
        # copies) against the whole iteration: the step itself only queues
        # work, so a loader too slow for the card shows up here.
        fetch_seconds = 0.0
        iter_seconds = []
        batches = iter(prefetch_to_device(self.train_loader, self.device, size=2))
        idx = 0
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            fetch_seconds += time.perf_counter() - t0
            device_losses.append(self.train_step(*batch))
            iter_seconds.append(time.perf_counter() - t0)
            audio_seconds += (batch[0].shape[0] * batch[0].shape[-1] * self.samples_per_step
                              / cfg.sample_rate)
            idx += 1
            if idx % cfg.log_interval == 0:
                running = float(torch.stack(device_losses).mean())
                print(f"[Epoch {epoch + 1}] iter {idx}/{len(self.train_loader)} "
                      f"loss: {running:.5f}", flush=True)
        total = float(torch.stack(device_losses).sum()) if device_losses else 0.0
        elapsed = time.time() - epoch_start
        if audio_seconds and elapsed > 0:
            its = np.sort(np.asarray(iter_seconds))
            self.last_epoch_stats = {
                "audio_sec_per_sec": audio_seconds / elapsed,
                "fetch_frac": fetch_seconds / elapsed,
                "iter_p50_ms": float(its[len(its) // 2]) * 1e3,
                "iter_p99_ms": float(its[min(len(its) - 1, int(len(its) * 0.99))]) * 1e3,
                "n_batches": len(iter_seconds),
            }
            stats = self.last_epoch_stats
            print(f"[Epoch {epoch + 1}] training throughput: {stats['audio_sec_per_sec']:.1f} "
                  f"audio-seconds/sec (iter p50 {stats['iter_p50_ms']:.1f} ms, "
                  f"p99 {stats['iter_p99_ms']:.1f} ms, loader-stall {stats['fetch_frac']:.1%})",
                  flush=True)
        return total / max(len(device_losses), 1)

    def run_one_epoch_eval(self, epoch: int) -> float:
        total, n_batches = 0.0, 0
        for idx, (mixture, sources) in enumerate(prefetch_to_device(self.valid_loader,
                                                                    self.device, size=2)):
            loss, estimates = self.eval_step(mixture, sources)
            total += float(loss)
            n_batches += 1
            if idx < self.config.save_valid_wavs:
                self._dump_samples(epoch, idx, mixture, estimates)
        return total / max(n_batches, 1)

    def _dump_samples(self, epoch: int, idx: int, mixture, estimates) -> None:
        out_dir = os.path.join(self.sample_dir, f"{idx}")
        os.makedirs(out_dir, exist_ok=True)
        sr = self.config.sample_rate
        mix = mixture[0].float().cpu().numpy().reshape(-1)
        write_wav(os.path.join(out_dir, "mixture.wav"), mix / (np.abs(mix).max() + 1e-9), sr)
        est = estimates[0].float().cpu().numpy()
        for s in range(est.shape[0]):
            write_wav(os.path.join(out_dir, f"epoch{epoch + 1}_source{s}.wav"),
                      est[s] / (np.abs(est[s]).max() + 1e-9), sr)

    # -- persistence ------------------------------------------------------
    def save_checkpoint(self, epoch: int, path: str) -> None:
        extra = {
            "optim": self.optimizer.state_dict(),
            "epoch": epoch,
            "best_loss": self.best_loss,
            "prev_loss": self.prev_loss,
            "no_improvement": self.no_improvement,
            "train_loss": list(self.train_loss),
            "valid_loss": list(self.valid_loss),
        }
        save_model(path, self.model, extra)

    def draw_loss_curve(self) -> None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        fig, ax = plt.subplots()
        epochs = np.arange(1, len(self.train_loss) + 1)
        ax.plot(epochs, self.train_loss, label="train")
        ax.plot(epochs, self.valid_loss, label="valid")
        ax.set_xlabel("epoch")
        ax.set_ylabel("loss")
        ax.legend()
        fig.savefig(os.path.join(self.loss_dir, "loss.png"), bbox_inches="tight")
        plt.close(fig)


class ORPITTrainer(Trainer):
    """One-and-Rest PIT over variable source counts (the reference's ORPIT recipe driver).

    Batches are (mixture, zero-padded sources, counts) from
    `WaveTrainVariableSourcesDataset`; the model estimates the (one, rest) pair and the
    criterion (`criterion.ORPIT`) reads the counts: `make_train_step` and `make_eval_step`
    hand the batch's third field to it. Validation returns the mean loss over the valid
    batches and writes no WAVs, as JAX's does; it runs under `torch.no_grad()`, so on
    the card the decoder takes the `fused_mask_decode` kernel.
    """

    def run_one_epoch_eval(self, epoch: int) -> float:
        total, n_batches = 0.0, 0
        for mixture, sources, counts in prefetch_to_device(self.valid_loader, self.device,
                                                            size=2):
            loss, _ = self.eval_step(mixture, sources, counts)
            total += float(loss)
            n_batches += 1
        return total / max(n_batches, 1)
