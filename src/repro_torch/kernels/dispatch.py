"""Kernel dispatch: ONE place that decides hand kernel vs plain version.

The rule is the tensor's device. A CUDA tensor goes to the hand-written
kernel, which launches or raises; a CPU tensor goes to the kernel's plain
PyTorch version (the CPU tests, which run where there is no card). The one
exception is the scoped ``override(kernels=False)``: it routes CUDA tensors
through the plain versions too, so a caller can run a reference drain on the
card and compare it with the kernel drain. The serving path never sets it,
and no environment variable does.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

_KERNELS_OFF: list = []  # stack of active overrides (innermost last)


def use_kernel(t: torch.Tensor) -> bool:
    """True when the hand kernel must run for ``t``."""
    return t.is_cuda and not _KERNELS_OFF


@contextlib.contextmanager
def override(*, kernels: bool) -> Iterator[None]:
    """Scoped policy: ``kernels=False`` sends CUDA tensors to the plain
    versions for the duration of the block. It is the only policy."""
    if kernels:
        raise ValueError("override(kernels=False) is the only override")
    _KERNELS_OFF.append(True)
    try:
        yield
    finally:
        _KERNELS_OFF.pop()
