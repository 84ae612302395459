"""The older TCN naming (Meta-TasNet's era).

Port of `dnn_based_source_separation_tpu/models/tcn.py` (after the reference's
`src/models/tcn.py:19`, TemporalConvNet): an earlier spelling of the dilated
depthwise TCN of `models/tdcn.py`, kept for the reference's import surface.
"""
from .tdcn import (  # noqa: F401
    DepthwiseSeparableConv1d,
    ResidualBlock1d,
    TimeDilatedConvBlock1d,
    TimeDilatedConvNet,
)

TemporalConvNet = TimeDilatedConvNet
