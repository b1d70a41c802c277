"""Hand-written CUDA kernels of the port (``csrc/``), their plain
PyTorch versions, and the checked wrappers in ``ops``."""
