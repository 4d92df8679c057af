"""Point kernels: hand-written CUDA (``csrc/``), each beside its plain
PyTorch version and a launch counter; ``ops`` is the public layer."""
