"""Hand-written CUDA kernels and their plain PyTorch versions.

Each kernel module keeps: the CUDA source under ``photon_tpu_torch/csrc``
(built with ``nvcc`` at first use, never at import), a wrapper that
launches it for CUDA tensors and takes the plain version for CPU
tensors, the plain version itself, and a launch count.
"""
