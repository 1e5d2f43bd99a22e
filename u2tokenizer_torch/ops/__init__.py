"""Tensor ops of the port: plain PyTorch functions and the wrappers of the
hand-written CUDA kernels (``flash_attention``, ``decode_attention``)."""
