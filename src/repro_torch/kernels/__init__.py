"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``), each
beside its plain PyTorch version. Kernels build at first launch, never at
import."""
