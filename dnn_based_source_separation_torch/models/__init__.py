"""Models. Importing this package registers them for `models.base.load_model`."""

from .conv_tasnet import ConvTasNet, Separator
from .dprnn_tasnet import DPRNNTasNet
from .dptnet import DPTNet
from .furcanet import FurcaNet
from .galrnet import GALRNet
from .lstm_tasnet import LSTMTasNet, TasNet, TasNetBase
from .meta_tasnet import MetaTasNet
from .mrx import MultiResolutionCrossNet
from .sepformer import SepFormer
from .umx import OpenUnmix, ParallelOpenUnmix
from .wavenet import WaveNet
from .wrappers import MonoWaveAdapter, SpectrogramMaskingWrapper, WaveChannelAdapter
from .xumx import CrossNetOpenUnmix

__all__ = ["ConvTasNet", "CrossNetOpenUnmix", "DPRNNTasNet", "DPTNet", "FurcaNet", "GALRNet",
           "LSTMTasNet", "MetaTasNet", "MonoWaveAdapter", "MultiResolutionCrossNet",
           "OpenUnmix", "ParallelOpenUnmix", "SepFormer", "Separator",
           "SpectrogramMaskingWrapper", "TasNet", "TasNetBase", "WaveChannelAdapter", "WaveNet"]
