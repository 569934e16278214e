"""Hand-written CUDA kernels for the port's attention, each with its plain
PyTorch version beside it.

A wrapper takes the plain version only for tensors that lie on the CPU; for
CUDA tensors it launches its kernel (built from `csrc/` at first use) or
raises. Each wrapper counts its kernel launches in `<wrapper>.launches`.
"""
