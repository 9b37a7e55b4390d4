"""Hand-written CUDA consensus kernels (``csrc/``), their plain PyTorch
versions (``ref``) and device-dispatching wrappers (``ops``)."""
