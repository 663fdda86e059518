"""Counter-based random numbers: the port's stand-in for the part of
``jax.random`` that the serving engine uses, as ``tree.py`` stands in for
``jax.tree``.

A key is an int64 tensor ``(..., 2)`` holding two uint32 words, as a raw
``jax.random.PRNGKey`` holds them; leading dims batch keys (the engine
keeps one per slot). Every function reproduces the reference's bits:

- ``threefry2x32``: the Threefry-2x32 block cipher, 20 rounds with the
  rotation constants (13, 15, 26, 6) / (17, 29, 16, 24) and key-schedule
  parity 0x1BD11BDA, as ``jax._src.prng._threefry2x32_lowering``. Words
  live in int64 and are masked to 32 bits after every add and shift.
- ``PRNGKey(seed)``: ``[0, seed mod 2^32]`` (a 32-bit seed, as JAX builds
  it with 64-bit types off).
- ``fold_in(key, data)``: the cipher of the count pair ``(0, data)``.
- ``random_bits(key, shape)``: 32-bit draws in the partitionable layout
  (``jax_threefry_partitionable``, on by default since JAX 0.5): element
  ``i`` of the flattened shape is ``x0 ^ x1`` of the cipher of the count
  pair ``(i >> 32, i & 0xFFFFFFFF)``.
- ``uniform``: the top 23 bits as the mantissa of a float in [1, 2), minus
  1, scaled to [minval, maxval) and floored at ``minval``.
- ``gumbel``: ``-log(-log(u))`` for u uniform in [tiny, 1), in float32 (the
  reference's default "low" mode). The log is the reference CPU backend's
  own (``core/float8._log_f32``, the replayed Cephes routine), so the
  noise is bitwise the reference's on the CPU.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.float8 import _log_f32

Tensor = torch.Tensor
_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY_F32 = float(torch.finfo(torch.float32).tiny)
_ONE_BITS = 0x3F800000  # 1.0f


def _rotl(x: Tensor, d: int) -> Tensor:
    return ((x << d) & _MASK) | (x >> (32 - d))


def threefry2x32(key: Tensor, x0: Tensor, x1: Tensor) -> tuple:
    """Threefry-2x32 of the count pairs ``(x0, x1)`` (int64 tensors of
    uint32 values) under ``key (..., 2)``; key and counts broadcast.
    Returns the two output words."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int, device="cpu") -> Tensor:
    """The raw key of ``jax.random.PRNGKey(seed)`` for a 32-bit seed."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def fold_in(key: Tensor, data) -> Tensor:
    """``jax.random.fold_in``: a new key from ``key (..., 2)`` and 32-bit
    ``data`` (an int or an integer tensor broadcasting against the key's
    leading dims)."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _MASK
    o0, o1 = threefry2x32(key, torch.zeros_like(data), data)
    return torch.stack((o0, o1), dim=-1)


def random_bits(key: Tensor, shape) -> Tensor:
    """``jax.random.bits(key, shape)`` for 32 bits: int64 values in
    [0, 2^32), shape ``key.shape[:-1] + shape``."""
    shape = tuple(shape)
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    o0, o1 = threefry2x32(key.reshape(lead + (1, 2)), i >> 32, i & _MASK)
    return (o0 ^ o1).reshape(lead + shape)


def uniform(key: Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> Tensor:
    """``jax.random.uniform`` in float32: [minval, maxval)."""
    bits = (random_bits(key, shape) >> 9) | _ONE_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # Filled on the device, not copied from the host: a captured step
    # (CUDA graph) may draw noise.
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: Tensor, shape) -> Tensor:
    """``jax.random.gumbel(key, shape, float32)`` ("low" mode), bitwise on
    the CPU."""
    u = uniform(key, shape, _TINY_F32, 1.0)
    return -_log_f32(-_log_f32(u))
