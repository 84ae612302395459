"""Training criteria: the SDR family, the PIT family (exhaustive, ORPIT, SinkPIT, ProbPIT,
Hungarian), MixIT, distances, divergences, entropies, metric-learning losses, subset
combinations, the spectral adapters with X-UMX's multi-domain loss, and deep clustering's
affinity loss."""

from .combination import CombinationLoss, subset_matrix
from .deep_clustering import AffinityLoss
from .distance import CosineSimilarityLoss, L1Loss, L2Loss, MAELoss, MSELoss
from .divergence import (
    beta_divergence, generalized_kl_divergence, is_divergence, kl_divergence,
)
from .entropy import BinaryCrossEntropy, CategoricalCrossEntropy, DiceLoss
from .hungarian import HungarianLoss, hungarian_pit
from .metric_learn import (
    AdditiveAngularMarginLoss, ContrastiveLoss, ContrastiveWithDistanceLoss, TripletLoss,
    TripletWithDistanceLoss, arcface_logits,
)
from .mixit import MixIT, mixit, mixture_assignment_table
from .multidomain import MultiDomainLoss
from .pit import (
    ORPIT, PIT, PIT1d, PIT2d, ProbPIT, SinkPIT, orpit, permutation_table, pit, prob_pit,
    sinkpit,
)
from .sdr import (
    SDR, SISDR, NegSDR, NegSISDR, NegThresholdedSNR, NegWeightedSDR, WeightedSDR, sdr, sisdr,
    thresholded_snr, weighted_sdr,
)
from .spectral import MonoTargetAdapter, SpectralTargetAdapter

__all__ = ["AffinityLoss", "CombinationLoss", "subset_matrix", "CosineSimilarityLoss",
           "L1Loss", "L2Loss", "MAELoss", "MSELoss", "beta_divergence",
           "generalized_kl_divergence", "is_divergence", "kl_divergence", "BinaryCrossEntropy",
           "CategoricalCrossEntropy", "DiceLoss", "HungarianLoss", "hungarian_pit",
           "AdditiveAngularMarginLoss", "ContrastiveLoss", "ContrastiveWithDistanceLoss",
           "TripletLoss", "TripletWithDistanceLoss", "arcface_logits", "MixIT", "mixit",
           "mixture_assignment_table", "MultiDomainLoss", "ORPIT", "PIT", "PIT1d", "PIT2d",
           "ProbPIT", "SinkPIT", "orpit", "permutation_table", "pit", "prob_pit", "sinkpit",
           "SDR", "SISDR", "NegSDR", "NegSISDR", "NegThresholdedSNR", "NegWeightedSDR",
           "WeightedSDR", "sdr", "sisdr", "thresholded_snr", "weighted_sdr",
           "MonoTargetAdapter", "SpectralTargetAdapter"]
