"""PyTorch/CUDA port of the TimeFloats system for NVIDIA Hopper.

Mirrors ``src/repro`` module for module. Plain tensor code is PyTorch; every
Pallas kernel of the JAX package is a hand-written CUDA kernel under
``csrc/`` (K1 and K2: kernels/timefloats_matmul.py, K3: kernels/sampling.py,
K4 and K5: kernels/paged_attn.py, K6: kernels/paged.py), with its plain
PyTorch version beside it. The package never imports JAX or ``repro``.
"""
