"""Wavesplit's trainer: the speaker loss and every layer's reconstruction loss together.

Port of `dnn_based_source_separation_tpu/train/wavesplit.py:WaveSplitTrainer` (after the
reference `egs/wsj0-mix/wavesplit/src/adhoc_driver.py`). The train loader yields
(mixture, sources, speaker rows); a step runs `WaveSplit.forward_train` (the per-sample
PIT speaker loss against the utterance's embedding rows orders the speaker vectors,
whose means condition the separation stack) and minimises the reconstruction loss of
all num_blocks x num_layers skip heads against the sources, plus the mean speaker
loss, plus, with `entropy_reg`, the embedding table's entropy regulariser. Validation
runs the KMeans inference path under `eval_criterion` (PIT over negative SI-SDR in
the CLI), through the base Trainer's eval step.
"""
from __future__ import annotations

import torch

from ..models.wavesplit import entropy_regularization_loss
from .steps import _loss_of
from .trainer import Trainer


class WaveSplitTrainer(Trainer):
    def __init__(self, model, train_loader, valid_loader, reconst_criterion, eval_criterion,
                 optimizer, config, device, entropy_reg: bool = False):
        super().__init__(model, train_loader, valid_loader, eval_criterion, optimizer, config,
                         device)

        def step(mixture, sources, spk_idx) -> torch.Tensor:
            model.train()
            optimizer.zero_grad()
            est_all, spk_loss = model.forward_train(mixture, spk_idx)
            # every layer's skip head regresses the sources: no output PIT
            loss = _loss_of(reconst_criterion(est_all, sources[:, None])) + spk_loss.mean()
            if entropy_reg:
                loss = loss + entropy_regularization_loss(model.spk_embedding)
            loss.backward()
            optimizer.step()
            return loss.detach()

        self.train_step = step
