"""repro_torch: the FractalCloud system in PyTorch, for one NVIDIA H100.

A port of the JAX package ``repro`` (which stays the reference): the
fractal partition, block-parallel point ops whose kernels are written by
hand in CUDA (``kernels/csrc``), the PNN models and the bucketed serving
engine.  Kernel selection follows the device: CPU tensors run each
kernel's plain PyTorch version, CUDA tensors launch the kernel.
"""
