"""Models. Importing this package registers them for `models.base.load_model`."""

from .adanet import ADANet
from .conv_tasnet import ConvTasNet, Separator
from .cunet import ConditionedUNet2d
from .d3net import D3Net, ParallelD3Net
from .danet import DANet, FixedAttractorDANet
from .deep_clustering import ChimeraNet, DeepEmbedding, DeepEmbeddingPlus
from .dprnn_tasnet import DPRNNTasNet
from .dptnet import DPTNet
from .furcanet import FurcaNet
from .galrnet import GALRNet
from .hrnet import HRNet
from .lstm_tasnet import LSTMTasNet, TasNet, TasNetBase
from .m_densenet import MDenseNet
from .meta_tasnet import MetaTasNet
from .mm_dense_rnn import MMDenseLSTM, MMDenseRNN, ParallelMMDenseLSTM
from .mm_densenet import MMDenseNet, ParallelMMDenseNet
from .mrx import MultiResolutionCrossNet
from .sepformer import SepFormer
from .umx import OpenUnmix, ParallelOpenUnmix
from .unet import EnsembleUNet1d, EnsembleUNet2d, UNet1d, UNet2d
from .wavenet import WaveNet
from .wavesplit import WaveSplit
from .wrappers import (
    ConditionedSpectrogramWrapper, MonoWaveAdapter, SingleStemSpectrogramWrapper,
    SpectrogramMaskingWrapper, SpectrogramSeparator, WaveChannelAdapter,
)
from .xumx import CrossNetOpenUnmix

__all__ = ["ADANet", "ChimeraNet", "ConditionedSpectrogramWrapper", "ConditionedUNet2d",
           "ConvTasNet", "CrossNetOpenUnmix", "D3Net", "DANet", "DPRNNTasNet", "DPTNet",
           "DeepEmbedding", "DeepEmbeddingPlus", "EnsembleUNet1d", "EnsembleUNet2d",
           "FixedAttractorDANet", "FurcaNet", "GALRNet", "HRNet", "LSTMTasNet", "MDenseNet",
           "MMDenseLSTM", "MMDenseNet", "MMDenseRNN", "MetaTasNet", "MonoWaveAdapter",
           "MultiResolutionCrossNet", "OpenUnmix", "ParallelD3Net", "ParallelMMDenseLSTM",
           "ParallelMMDenseNet", "ParallelOpenUnmix", "SepFormer", "Separator",
           "SingleStemSpectrogramWrapper", "SpectrogramMaskingWrapper", "SpectrogramSeparator",
           "TasNet", "TasNetBase", "UNet1d", "UNet2d", "WaveChannelAdapter", "WaveNet",
           "WaveSplit"]
