"""Training criteria: the SDR family and exhaustive PIT."""

from .pit import PIT, PIT1d, permutation_table, pit
from .sdr import SDR, SISDR, NegSDR, NegSISDR, sdr, sisdr

__all__ = ["PIT", "PIT1d", "permutation_table", "pit", "SDR", "SISDR", "NegSDR", "NegSISDR",
           "sdr", "sisdr"]
