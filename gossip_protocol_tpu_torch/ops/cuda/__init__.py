"""Hand-written CUDA kernels (csrc/dense_tick.cu) and their wrappers.

Each wrapper takes its plain PyTorch version for CPU tensors and
launches its kernel for CUDA tensors (or raises); each counts its
launches in a ``launches`` attribute on the wrapper function.
"""
