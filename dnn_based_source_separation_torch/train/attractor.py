"""Trainers of the spectrogram-domain family: DANet, ADANet and deep clustering.

Port of `dnn_based_source_separation_tpu/train/attractor.py` (after the reference
AttractorTrainer / AnchoredAttractorTrainer, `egs/wsj0-mix/common/src/driver.py:400-596`).
The loaders yield (|mixture| (B, 1, F, T), |sources| (B, n, F, T), ideal mask
(B, n, F, T), threshold weight (B, 1, F, T)) from `IdealMaskSpectrogramTrainDataset`.

- `AttractorTrainer` (DANet): oracle attractors from the batch's mask in training
  (`make_attractor_train_step`), KMeans attractors in validation;
- `AnchoredAttractorTrainer` (ADANet): the anchors pick the attractors in both; with a
  dropout generator the step runs in train mode (dropout between the LSTM layers, masks
  from the generator), as JAX's step runs with a dropout rng; without one in eval mode;
- `EmbeddingTrainer` (deep clustering): the affinity loss of the embeddings against the
  ideal binary assignment, masked by the threshold weight, in training and validation.

Validation returns the mean loss over the valid batches and writes no WAVs.
"""
from __future__ import annotations

import torch

from ..data.loader import prefetch_to_device
from ..ops.rnn import set_dropout_generator
from .steps import _loss_of, make_attractor_train_step
from .trainer import Trainer


class AttractorTrainer(Trainer):
    """DANet: `hop_length` converts frames to audio seconds in the throughput log."""

    def __init__(self, model, train_loader, valid_loader, criterion, optimizer, config, device,
                 n_sources: int = 2, hop_length: int = 1):
        super().__init__(model, train_loader, valid_loader, criterion, optimizer, config, device)
        self.criterion, self.n_sources, self.samples_per_step = criterion, n_sources, hop_length
        self.train_step = make_attractor_train_step(model, criterion, optimizer)

    def batch_loss(self, mixture, sources, assignment, threshold_weight) -> torch.Tensor:
        """The clustering inference path: no oracle assignment."""
        return _loss_of(self.criterion(self.model(mixture, None, None, self.n_sources), sources))

    @torch.no_grad()
    def run_one_epoch_eval(self, epoch: int) -> float:
        self.model.eval()
        total, n_batches = 0.0, 0
        for batch in prefetch_to_device(self.valid_loader, self.device, size=2):
            total += float(self.batch_loss(*batch))
            n_batches += 1
        return total / max(n_batches, 1)


class AnchoredAttractorTrainer(AttractorTrainer):
    """ADANet: the model reads (|mixture|, threshold weight, n_sources); the batch's mask is
    not used."""

    def __init__(self, model, train_loader, valid_loader, criterion, optimizer, config, device,
                 n_sources: int = 2, hop_length: int = 1,
                 dropout_generator: torch.Generator | None = None):
        super().__init__(model, train_loader, valid_loader, criterion, optimizer, config, device,
                         n_sources, hop_length)
        set_dropout_generator(model, dropout_generator)
        train_mode = dropout_generator is not None

        def step(mixture, sources, assignment, threshold_weight) -> torch.Tensor:
            model.train(train_mode)
            optimizer.zero_grad()
            loss = _loss_of(criterion(model(mixture, threshold_weight, n_sources), sources))
            loss.backward()
            optimizer.step()
            return loss.detach()

        self.train_step = step

    def batch_loss(self, mixture, sources, assignment, threshold_weight) -> torch.Tensor:
        return _loss_of(self.criterion(self.model(mixture, None, self.n_sources), sources))


class EmbeddingTrainer(AttractorTrainer):
    """Deep clustering: loss = AffinityLoss(V, Y, weight), V the model's (B, F, T, D)
    embeddings as (B, F * T, D), Y the ideal mask as (B, F * T, n)."""

    def __init__(self, model, train_loader, valid_loader, criterion, optimizer, config, device,
                 n_sources: int = 2, hop_length: int = 1):
        super().__init__(model, train_loader, valid_loader, criterion, optimizer, config, device,
                         n_sources, hop_length)

        def step(mixture, sources, assignment, threshold_weight) -> torch.Tensor:
            model.eval()  # no dropout in these models; JAX's step has no train flag
            optimizer.zero_grad()
            loss = self.batch_loss(mixture, sources, assignment, threshold_weight)
            loss.backward()
            optimizer.step()
            return loss.detach()

        self.train_step = step

    def batch_loss(self, mixture, sources, assignment, threshold_weight) -> torch.Tensor:
        emb = self.model(mixture)
        B, F, T, D = emb.shape
        Y = assignment.permute(0, 2, 3, 1).reshape(B, F * T, assignment.shape[1])
        return self.criterion(emb.reshape(B, F * T, D), Y,
                              binary_mask=threshold_weight.reshape(B, F * T))
