"""PyTorch / CUDA port of `dnn_based_source_separation_tpu`, for one NVIDIA H100.

Same layout as the JAX package: ops/ (filterbanks, norms, and the
hand-written Hopper kernels with their plain PyTorch versions), models/,
hub/ (weights from the JAX package), cli/. Kernel sources live in csrc/
and are built with nvcc at first use into _build/ (ops/_build.py).
"""

__version__ = "0.1.0"
