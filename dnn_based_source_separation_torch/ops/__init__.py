"""DSP and NN primitives, and the CUDA kernels' wrappers."""
