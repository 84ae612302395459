"""Data: audio IO, the wsj0-mix wave datasets, the batch pipeline and host -> device prefetch.

Framework-free host code the port keeps its own copy of (the JAX package's
`data` package is the reference), plus the prefetch onto the card.
"""

from .audio_io import read_wav, write_wav
from .loader import DataLoader, prefetch_to_device
from .wsj0mix import (
    IdealMaskSpectrogramTrainDataset, SpectrogramTrainDataset, WaveEvalDataset, WaveTestDataset,
    WaveTrainDataset, WaveTrainSpeakerDataset,
)

__all__ = ["DataLoader", "IdealMaskSpectrogramTrainDataset", "SpectrogramTrainDataset",
           "WaveEvalDataset", "WaveTestDataset", "WaveTrainDataset", "WaveTrainSpeakerDataset",
           "prefetch_to_device", "read_wav", "write_wav"]
