"""Classical algorithms: ideal masks and the multichannel Wiener filter."""

from .frequency_mask import (
    compute_ideal_amplitude_mask, compute_ideal_binary_mask, compute_ideal_complex_mask,
    compute_ideal_ratio_mask, compute_phase_sensitive_mask, compute_wiener_filter_mask,
    multichannel_wiener_filter,
)

__all__ = ["compute_ideal_amplitude_mask", "compute_ideal_binary_mask",
           "compute_ideal_complex_mask", "compute_ideal_ratio_mask",
           "compute_phase_sensitive_mask", "compute_wiener_filter_mask",
           "multichannel_wiener_filter"]
