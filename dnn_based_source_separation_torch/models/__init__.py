"""Models. Importing this package registers them for `models.base.load_model`."""

from .adanet import ADANet
from .conv_tasnet import ConvTasNet, Separator
from .danet import DANet, FixedAttractorDANet
from .deep_clustering import ChimeraNet, DeepEmbedding, DeepEmbeddingPlus
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
from .wavesplit import WaveSplit
from .wrappers import (
    MonoWaveAdapter, SpectrogramMaskingWrapper, SpectrogramSeparator, WaveChannelAdapter,
)
from .xumx import CrossNetOpenUnmix

__all__ = ["ADANet", "ChimeraNet", "ConvTasNet", "CrossNetOpenUnmix", "DANet", "DPRNNTasNet",
           "DPTNet", "DeepEmbedding", "DeepEmbeddingPlus", "FixedAttractorDANet", "FurcaNet",
           "GALRNet", "LSTMTasNet", "MetaTasNet", "MonoWaveAdapter", "MultiResolutionCrossNet",
           "OpenUnmix", "ParallelOpenUnmix", "SepFormer", "Separator",
           "SpectrogramMaskingWrapper", "SpectrogramSeparator", "TasNet", "TasNetBase",
           "WaveChannelAdapter", "WaveNet", "WaveSplit"]
