"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions.
Kernels are built and loaded at first launch, never at import."""
