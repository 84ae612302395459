"""Models. Importing this package registers them for `models.base.load_model`."""

from .conv_tasnet import ConvTasNet, Separator
from .dprnn_tasnet import DPRNNTasNet
from .umx import OpenUnmix, ParallelOpenUnmix
from .wrappers import SpectrogramMaskingWrapper
from .xumx import CrossNetOpenUnmix

__all__ = ["ConvTasNet", "CrossNetOpenUnmix", "DPRNNTasNet", "OpenUnmix", "ParallelOpenUnmix",
           "Separator", "SpectrogramMaskingWrapper"]
