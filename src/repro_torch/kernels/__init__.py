"""Kernels of the port: CUDA C++ for sm_90a with plain PyTorch versions."""
