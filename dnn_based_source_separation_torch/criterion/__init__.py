"""Training criteria: the SDR family, exhaustive PIT, distances, subset combinations, the
spectral adapters with X-UMX's multi-domain loss, and deep clustering's affinity loss."""

from .combination import CombinationLoss, subset_matrix
from .deep_clustering import AffinityLoss
from .distance import CosineSimilarityLoss, L1Loss, L2Loss, MAELoss, MSELoss
from .multidomain import MultiDomainLoss
from .pit import PIT, PIT1d, PIT2d, permutation_table, pit
from .sdr import (
    SDR, SISDR, NegSDR, NegSISDR, NegWeightedSDR, WeightedSDR, sdr, sisdr, weighted_sdr,
)
from .spectral import MonoTargetAdapter, SpectralTargetAdapter

__all__ = ["AffinityLoss", "CombinationLoss", "subset_matrix", "CosineSimilarityLoss",
           "L1Loss", "L2Loss", "MAELoss", "MSELoss", "MultiDomainLoss", "PIT", "PIT1d", "PIT2d",
           "permutation_table", "pit", "SDR", "SISDR", "NegSDR", "NegSISDR", "NegWeightedSDR",
           "WeightedSDR", "sdr", "sisdr", "weighted_sdr", "MonoTargetAdapter",
           "SpectralTargetAdapter"]
