"""LR schedules (port of ``repro.optim.schedules``): functions of the step
that return the rate as a 0-dim f32 tensor on the host.

The reference computes the rate inside its jitted update, so the value
training sees is the one XLA's CPU backend computes, not the one of its
ops taken one by one. That backend divides by a constant through its f32
reciprocal, folds ``(1 - min_ratio) * 0.5`` into one constant, contracts
``(1 + cos) * 0.45 + 0.1`` into one fused multiply-add and takes the f32
cosine of the C library (glibc's ``cosf``, which works in double). The
warmup-cosine below replays exactly those operations in numpy f32, with
``_cosf`` and ``_fma_f32`` for the two that numpy lacks, so every step's
rate is the reference's bit for bit (tests/test_torch_optim.py holds 400
steps of a 100/10000 schedule).
"""
from __future__ import annotations

import math
from fractions import Fraction
from typing import Callable

import numpy as np
import torch

Schedule = Callable[[int], torch.Tensor]
_F32 = np.float32

# glibc's sincosf tables (sysdeps/ieee754/flt-32/s_sincosf.h): pi/2 and its
# inverse scaled by 2^24, the cosine and sine polynomials' coefficients.
_H = float.fromhex
_HPI_INV = _H("0x1.45F306DC9C883p+23")
_HPI = _H("0x1.921FB54442D18p0")
_COS = (_H("0x1p0"), _H("-0x1.ffffffd0c621cp-2"), _H("0x1.55553e1068f19p-5"),
        _H("-0x1.6c087e89a359dp-10"), _H("0x1.99343027bf8c3p-16"))
_SIN = (_H("-0x1.555545995a603p-3"), _H("0x1.1107605230bc4p-7"),
        _H("-0x1.994eb3774cf24p-13"))


def _top12(y: np.float32) -> int:
    return (int(np.float32(y).view(np.uint32)) >> 20) & 0x7FF


def _sinf_poly(x: float, x2: float, c: tuple, n: int) -> np.float32:
    """glibc's ``sinf_poly``: the sine (n even) or cosine polynomial in
    double, rounded once to f32."""
    if n & 1 == 0:
        x3 = x * x2
        s1 = _SIN[1] + x2 * _SIN[2]
        x7 = x3 * x2
        s = x + x3 * _SIN[0]
        return _F32(s + x7 * s1)
    x4 = x2 * x2
    c2 = c[3] + x2 * c[4]
    c1 = c[0] + x2 * c[1]
    x6 = x4 * x2
    return _F32(c1 + x4 * c[2] + x6 * c2)


def _cosf(y: np.float32) -> np.float32:
    """glibc's ``cosf`` for |y| < 120 (the schedule's argument lies in
    [0, pi]): a quadrant reduction by pi/2 and a polynomial, in double."""
    y = _F32(y)
    x = float(y)
    if _top12(y) < _top12(_F32(math.pi / 4)):
        if _top12(y) < _top12(_F32(2.0 ** -12)):
            return _F32(1.0)
        return _sinf_poly(x, x * x, _COS, 1)
    if _top12(y) >= _top12(_F32(120.0)):
        raise ValueError(f"_cosf replays |y| < 120 only, got {y}")
    n = (int(x * _HPI_INV) + 0x800000) >> 24
    x = x - n * _HPI
    sign = (1.0, -1.0, -1.0, 1.0)[n & 3]
    c = _COS if not n & 2 else tuple(-v for v in _COS)
    return _sinf_poly(x * sign, x * x, c, n ^ 1)


def _fma_f32(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """``a * b + c`` rounded once to f32 (ties to even)."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = _F32(float(exact))
    best = None
    for v in (np.nextafter(r, _F32(-np.inf)), r, np.nextafter(r, _F32(np.inf))):
        d = abs(Fraction(float(v)) - exact)
        even = int(v.view(np.uint32)) & 1 == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, v)
    return best[1]


def constant(lr: float) -> Schedule:
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine(lr: float, warmup: int, total: int,
                  min_ratio: float = 0.1) -> Schedule:
    lr32 = _F32(lr)
    inv_warm = _F32(1) / _F32(max(warmup, 1))
    inv_span = _F32(1) / _F32(max(total - warmup, 1))
    half_span = _F32((1 - min_ratio) * 0.5)

    def f(step: int) -> torch.Tensor:
        st = _F32(step)
        if st < _F32(warmup):
            rate = min(st * inv_warm, _F32(1)) * lr32
        else:
            frac = min(_F32(1), max(_F32(0), (st - _F32(warmup)) * inv_span))
            c = _cosf(frac * _F32(math.pi)) + _F32(1)
            rate = _fma_f32(c, half_span, _F32(min_ratio)) * lr32
        return torch.tensor(rate, dtype=torch.float32)

    return f


def get(name: str, lr: float, warmup: int = 100,
        total: int = 10000) -> Schedule:
    if name == "constant":
        return constant(lr)
    if name == "warmup_cosine":
        return warmup_cosine(lr, warmup, total)
    raise ValueError(name)
