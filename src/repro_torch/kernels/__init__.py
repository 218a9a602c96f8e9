"""Hand-written Hopper kernels of the port (CUDA C++ under ``*/csrc``,
built by ``_build``), each beside its plain PyTorch version."""
