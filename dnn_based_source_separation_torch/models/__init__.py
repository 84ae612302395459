"""Models. Importing this package registers them for `models.base.load_model`."""

from .conv_tasnet import ConvTasNet, Separator

__all__ = ["ConvTasNet", "Separator"]
