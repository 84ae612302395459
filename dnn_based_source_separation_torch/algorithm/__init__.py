"""Classical algorithms: ideal masks, the multichannel Wiener filter, phase reconstruction
(Griffin-Lim, MISI), clustering and NMF."""

from .clustering import GMMClustering, KMeans, SoftKMeans, SphericalKMeans
from .frequency_mask import (
    compute_ideal_amplitude_mask, compute_ideal_binary_mask, compute_ideal_complex_mask,
    compute_ideal_ratio_mask, compute_phase_sensitive_mask, compute_wiener_filter_mask,
    multichannel_wiener_filter,
)
from .griffin_lim import FastGriffinLim, GriffinLim, fast_griffin_lim, griffin_lim
from .misi import MISI, misi
from .nmf import NMF

__all__ = ["GMMClustering", "KMeans", "SoftKMeans", "SphericalKMeans",
           "compute_ideal_amplitude_mask", "compute_ideal_binary_mask",
           "compute_ideal_complex_mask", "compute_ideal_ratio_mask",
           "compute_phase_sensitive_mask", "compute_wiener_filter_mask",
           "multichannel_wiener_filter", "FastGriffinLim", "GriffinLim", "fast_griffin_lim",
           "griffin_lim", "MISI", "misi", "NMF"]
