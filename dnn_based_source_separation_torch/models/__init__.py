"""Models. Importing this package registers them for `models.base.load_model`."""

from .conv_tasnet import ConvTasNet, Separator
from .dprnn_tasnet import DPRNNTasNet

__all__ = ["ConvTasNet", "DPRNNTasNet", "Separator"]
