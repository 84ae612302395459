"""Data: the host pipeline is the JAX package's framework-free `data` package
(`DataLoader`, `WaveTrainDataset`, `WaveEvalDataset`, ...); this package adds
the host -> device prefetch."""

from .loader import prefetch_to_device

__all__ = ["prefetch_to_device"]
