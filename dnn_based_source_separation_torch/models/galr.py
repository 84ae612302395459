"""The standalone GALR backbone's import surface.

Port of `dnn_based_source_separation_tpu/models/galr.py`, which keeps the
reference's import surface (`src/models/galr.py`: GALR, GALRBlock,
GloballyAttentiveBlock, LocallyRecurrentBlock); the modules live in
`models/galrnet.py`.
"""
from .dprnn import IntraChunkRNN as LocallyRecurrentBlock
from .galrnet import GALR, GALRBlock, GloballyAttentiveBlock

__all__ = ["GALR", "GALRBlock", "GloballyAttentiveBlock", "LocallyRecurrentBlock"]
