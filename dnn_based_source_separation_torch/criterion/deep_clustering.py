"""Deep-clustering affinity loss ||V V^T - Y Y^T||_F^2, degree-normalised, in low-rank form.

Port of `dnn_based_source_separation_tpu/criterion/deep_clustering.py:AffinityLoss`
(after the reference `src/criterion/deep_clustering.py:11-49`), arXiv:1508.04306.
The n x n affinities are never formed: with D = 1 / sqrt(Y Y^T 1), the loss is
||V^T D V||^2 + ||Y^T D Y||^2 - 2 ||V^T D Y||^2 over (D1, D1), (D2, D2) and (D1, D2)
products. An optional binary (threshold) weight masks time-frequency bins out of both.
"""
from __future__ import annotations

import dataclasses

import torch

EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class AffinityLoss:
    eps: float = EPS
    maximize: bool = dataclasses.field(default=False, init=False)

    def __call__(self, input, target, binary_mask=None, batch_mean: bool = True):
        """input V (B, n_samples, D1) embeddings; target Y (B, n_samples, D2) one-hot."""
        V, Y = input, target
        if binary_mask is not None:
            V = binary_mask[..., None] * V
            Y = binary_mask[..., None] * Y
        Ysum = Y.sum(dim=1, keepdim=True)  # (B, 1, D2)
        D = 1.0 / torch.sqrt((Y * Ysum).sum(dim=2) + self.eps)  # (B, n)
        VD = V.transpose(1, 2) * D[:, None, :]  # (B, D1, n)
        YD = Y.transpose(1, 2) * D[:, None, :]
        loss = (torch.matmul(VD, V).square().sum(dim=(1, 2))
                + torch.matmul(YD, Y).square().sum(dim=(1, 2))
                - 2.0 * torch.matmul(VD, Y).square().sum(dim=(1, 2)))
        return loss.mean(dim=0) if batch_mean else loss
