"""Waveform augmentations: random flip, gain and sign, their sequence and factory.

The port's own copy of `dnn_based_source_separation_tpu/augmentation.py:1-82`
(reference `src/augmentation.py:9-90` and `src/utils/augmentation.py:3-27`).
numpy on the host; every op takes an explicit np.random.Generator, so data
workers stay reproducible.
"""
from __future__ import annotations

import numpy as np

MINSCALE = 0.25
MAXSCALE = 1.25


def apply_random_flip(input: np.ndarray, rng: np.random.Generator, flip_rate: float = 0.5, axis: int = 0):
    if rng.random() < flip_rate:
        return np.flip(input, axis=axis).copy()
    return input


def apply_random_gain(input: np.ndarray, rng: np.random.Generator, min: float = MINSCALE, max: float = MAXSCALE):
    return rng.uniform(min, max) * input


def apply_random_sign(input: np.ndarray, rng: np.random.Generator, rate: float = 0.5):
    return -input if rng.random() < rate else input


class RandomFlip:
    def __init__(self, flip_rate: float = 0.5, axis: int = 0, dim: int | None = None):
        self.flip_rate = flip_rate
        self.axis = dim if dim is not None else axis  # `dim` = reference name

    def __call__(self, input, rng: np.random.Generator):
        return apply_random_flip(input, rng, self.flip_rate, self.axis)


class RandomGain:
    def __init__(self, min: float = MINSCALE, max: float = MAXSCALE):
        self.min, self.max = min, max

    def __call__(self, input, rng: np.random.Generator):
        return apply_random_gain(input, rng, self.min, self.max)


# Deprecated alias kept for parity (reference RandomScaling).
RandomScaling = RandomGain


class RandomSign:
    def __init__(self, rate: float = 0.5):
        self.rate = rate

    def __call__(self, input, rng: np.random.Generator):
        return apply_random_sign(input, rng, self.rate)


class SequentialAugmentation:
    def __init__(self, *processes):
        self.processes = list(processes)

    def append(self, process):
        self.processes.append(process)

    def __call__(self, input, rng: np.random.Generator):
        x = input
        for process in self.processes:
            x = process(x, rng)
        return x


def choose_augmentation(name: str, **kwargs):
    """Mirror of reference `src/utils/augmentation.py:20-27`."""
    if name == "random_flip":
        return RandomFlip(**kwargs)
    if name in ("random_scaling", "random_gain"):
        return RandomGain(**kwargs)
    if name == "random_sign":
        return RandomSign(**kwargs)
    raise NotImplementedError(f"Unsupported augmentation: {name}")
