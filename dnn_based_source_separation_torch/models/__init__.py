"""Models. Importing this package registers them for `models.base.load_model`."""

from .conv_tasnet import ConvTasNet, Separator
from .dprnn_tasnet import DPRNNTasNet
from .dptnet import DPTNet
from .galrnet import GALRNet
from .lstm_tasnet import LSTMTasNet, TasNet, TasNetBase
from .sepformer import SepFormer
from .umx import OpenUnmix, ParallelOpenUnmix
from .wrappers import SpectrogramMaskingWrapper
from .xumx import CrossNetOpenUnmix

__all__ = ["ConvTasNet", "CrossNetOpenUnmix", "DPRNNTasNet", "DPTNet", "GALRNet", "LSTMTasNet",
           "OpenUnmix", "ParallelOpenUnmix", "SepFormer", "Separator",
           "SpectrogramMaskingWrapper", "TasNet", "TasNetBase"]
