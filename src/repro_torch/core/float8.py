"""FP8 (E4M4-style) codec used by TimeFloats, in PyTorch.

Port of ``repro.core.float8``. A value is

    value = sign * (1 + mantissa / 2^man_bits) * 2^(exponent - bias)

with ``exponent`` the stored (biased) code in [0, 2^exp_bits - 1]. Zero is
the all-zero code, subnormals flush to zero and overflow saturates to the
largest finite code. Decomposed fields are the common currency of the
TimeFloats pipeline: the crossbar MAC consumes integer significands
m̂ = 2^man_bits + mantissa.

Everything here is plain tensor code and runs on whatever device its input
lies on. The arithmetic follows the JAX reference op for op, so fields,
scales and prescale exponents agree with it bit for bit (tests pin this).
Stochastic rounding draws its noise from a ``torch.Generator``, not from a
JAX key, so it matches the reference in distribution only.
"""
from __future__ import annotations

import dataclasses
import math
import struct
from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """A generic small-float format with implicit leading one."""

    exp_bits: int = 4
    man_bits: int = 4

    @property
    def bias(self) -> int:
        return (1 << (self.exp_bits - 1)) - 1

    @property
    def max_exp_code(self) -> int:
        return (1 << self.exp_bits) - 1

    @property
    def max_man_code(self) -> int:
        return (1 << self.man_bits) - 1

    @property
    def significand_scale(self) -> int:
        """Integer significand m̂ = significand * 2^man_bits ∈ [2^m, 2^(m+1))."""
        return 1 << self.man_bits

    @property
    def max_value(self) -> float:
        return (1.0 + self.max_man_code / self.significand_scale) * 2.0 ** (
            self.max_exp_code - self.bias
        )

    @property
    def min_normal(self) -> float:
        return 2.0 ** (-self.bias)


E4M4 = FloatFormat(exp_bits=4, man_bits=4)
E4M3 = FloatFormat(exp_bits=4, man_bits=3)
E5M2 = FloatFormat(exp_bits=5, man_bits=2)


class F8Fields(NamedTuple):
    """Decomposed FP8 tensor: int8 sign (+1/-1), stored exponent code and
    stored mantissa code, and a bool ``nonzero`` plane."""

    sign: Tensor
    exp: Tensor
    man: Tensor
    nonzero: Tensor

    @property
    def shape(self):
        return self.sign.shape

    def significand(self, fmt: FloatFormat) -> Tensor:
        """Integer significand m̂ = 2^m + man, zeroed where value==0 (int32)."""
        mhat = self.man.to(torch.int32) + fmt.significand_scale
        return torch.where(self.nonzero, mhat, 0)


def decompose(x: Tensor, fmt: FloatFormat = E4M4, *,
              generator: Optional[torch.Generator] = None) -> F8Fields:
    """Quantization of ``x`` to ``fmt``, as fields: round to nearest even,
    or stochastic rounding with uniform noise from ``generator``."""
    x = x.to(torch.float32)
    m, e = torch.frexp(x.abs())  # |x| = m * 2^e, m in [0.5, 1)
    sig, uexp = m * 2.0, e - 1
    scale = fmt.significand_scale
    frac = (sig - 1.0) * scale  # in [0, scale)
    if generator is not None:
        noise = torch.rand(x.shape, generator=generator,
                           dtype=torch.float32, device=x.device)
        man = torch.floor(frac + noise)
    else:
        man = torch.round(frac)  # ties to even, like jnp.round
    # mantissa round-up overflow: sig -> 2.0 means exp += 1, man = 0
    carry = man >= scale
    man = torch.where(carry, 0.0, man)
    uexp = uexp + carry.to(uexp.dtype)
    stored = uexp + fmt.bias
    # Underflow flushes to zero; NaN/inf and zeros carry no fields.
    nonzero = (stored >= 0) & torch.isfinite(x) & (x != 0.0)
    over = stored > fmt.max_exp_code
    stored = stored.clamp(0, fmt.max_exp_code)
    man = torch.where(over, float(fmt.max_man_code), man)
    sign = torch.where(torch.signbit(x), -1, 1).to(torch.int8)
    exp = torch.where(nonzero, stored, 0).to(torch.int8)
    man_i = torch.where(nonzero, man, 0.0).to(torch.int8)
    return F8Fields(sign=sign, exp=exp, man=man_i, nonzero=nonzero)


def exp2i(e: Tensor) -> Tensor:
    """2^e as f32 for integer ``e``, built from the exponent bits so it is
    exact on every device. Like the reference on its CPU backend (which
    flushes subnormal results to zero), e < -126 gives 0 and e > 127 inf."""
    e = e.to(torch.int32)
    bits = (e.clamp(-126, 128) + 127) << 23
    out = bits.view(torch.float32)
    return torch.where(e < -126, 0.0, out)


def compose(fields: F8Fields, fmt: FloatFormat = E4M4) -> Tensor:
    """Fields -> f32 values."""
    sig = 1.0 + fields.man.to(torch.float32) / fmt.significand_scale
    val = sig * exp2i(fields.exp.to(torch.int32) - fmt.bias)
    val = val * fields.sign.to(torch.float32)
    return torch.where(fields.nonzero, val, 0.0)


def quantize(x: Tensor, fmt: FloatFormat = E4M4) -> Tensor:
    """Fake-quantize: f32 -> fmt -> f32."""
    return compose(decompose(x, fmt), fmt)


def quantize_stochastic(x: Tensor, generator: torch.Generator,
                        fmt: FloatFormat = E4M4) -> Tensor:
    return compose(decompose(x, fmt, generator=generator), fmt)


# ---------------------------------------------------------------------------
# floor(log2(amax)) exactly as the reference computes it. The pow2 amax
# scale hinges on that floor, and near a power of two it is decided by the
# last ulp of log2. The reference lowers jnp.log2 to log(x) * (1/ln 2) and
# its CPU backend evaluates log with the Cephes polynomial below, using
# fused multiply-adds. Both are replayed here (the fma through float64:
# the f32 product is exact there, so only a rare double rounding of the
# sum could differ). Activations in bf16 round the log to bf16 before the
# division by the bf16 constant ln 2, as the reference does in that dtype.
# ---------------------------------------------------------------------------

def _f32(v: float) -> float:
    """``v`` rounded to the nearest f32, as a Python float."""
    return struct.unpack("f", struct.pack("f", v))[0]


_LOG_P = tuple(_f32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
_SQRTHF = _f32(0.707106781186547524)
_LN2_F32 = _f32(math.log(2.0))
_INV_LN2_F32 = _f32(1.0 / _LN2_F32)  # equals the f32 quotient 1/ln 2
_LN2_BF16 = 0.69140625                # ln 2 rounded to bf16


def _fma(a: Tensor, b, c) -> Tensor:
    """f32 fused multiply-add via float64, where the product is exact.
    ``b``/``c`` are f32 tensors or f32-exact Python floats."""
    return (a.double() * b + c).float()


def _log_f32(x: Tensor) -> Tensor:
    """Natural log of positive normal f32 values, bitwise as the reference."""
    m, e = torch.frexp(x)
    e = e.to(torch.float32)
    small = m < _SQRTHF
    t = m - 1.0
    e = e - small.to(torch.float32)
    t = t + torch.where(small, m, 0.0)
    t2 = t * t
    t3 = (t2 * t).double()
    p0 = torch.full_like(t, _LOG_P[0])
    y = _fma(p0, t, _LOG_P[1])
    y1 = _fma(torch.full_like(t, _LOG_P[3]), t, _LOG_P[4])
    y2 = _fma(torch.full_like(t, _LOG_P[6]), t, _LOG_P[7])
    y = _fma(y, t, _LOG_P[2])
    y1 = _fma(y1, t, _LOG_P[5])
    y2 = _fma(y2, t, _LOG_P[8])
    y = _fma(y, t3, y1)
    y = _fma(y, t3, y2)
    y = _fma(y, t3, e * _LOG_Q1)
    t = t - t2 * 0.5
    t = t + y
    return t + e * _LOG_Q2


def log2_floor(amax: Tensor) -> Tensor:
    """``floor(log2(max(amax, 1e-30)))`` in amax's dtype (f32 or bf16),
    bitwise as the reference computes it."""
    dt = amax.dtype
    ln = _log_f32(torch.clamp_min(amax, 1e-30).to(torch.float32))
    if dt == torch.float32:
        return torch.floor(ln * _INV_LN2_F32)
    # A device tensor, not a host scalar: CUDA would divide by a host
    # scalar through its reciprocal.
    ln2 = torch.full((), _LN2_BF16, dtype=dt, device=ln.device)
    return torch.floor(ln.to(dt) / ln2)


def pow2_amax_scale(x: Tensor, fmt: FloatFormat = E4M4) -> Tensor:
    """Per-tensor power-of-two scale mapping amax near the top of the format
    range (the programmable reference V_B on the chip). Exact (pow2)."""
    amax = x.to(torch.float32).abs().max()
    target = fmt.max_exp_code - 1 - fmt.bias
    log2a = log2_floor(amax)
    return torch.where(amax > 0, exp2i((target - log2a).to(torch.int32)),
                       torch.ones((), dtype=torch.float32, device=x.device))


def quantize_scaled(x: Tensor, fmt: FloatFormat = E4M4,
                    generator: Optional[torch.Generator] = None) -> Tensor:
    """Scale-aware fake-quantization Q(x*s)/s with the per-tensor pow2 amax
    scale: codes live on the E4M4 grid relative to the tensor's reference,
    as the in-situ weight store holds them. ``generator`` selects
    stochastic rounding."""
    s = pow2_amax_scale(x, fmt)
    xs = x.to(torch.float32) * s
    q = (quantize_stochastic(xs, generator, fmt) if generator is not None
         else quantize(xs, fmt))
    return (q / s).to(x.dtype)


# ---------------------------------------------------------------------------
# Packing: one uint8 code (exponent << man_bits | mantissa) per value and a
# separate sign plane whose second bit marks the nonzero values, as the
# reference packs them. The at-rest form of in-situ FP8 weights and of
# packed checkpoint leaves.
# ---------------------------------------------------------------------------


class PackedF8(NamedTuple):
    code: Tensor     # uint8: (exp << man_bits) | man; 0 where the value is 0
    signbit: Tensor  # uint8: bit 0 the sign, bit 1 set for nonzero values


def pack(fields: F8Fields, fmt: FloatFormat = E4M4) -> PackedF8:
    exp = fields.exp.to(torch.uint8)
    man = fields.man.to(torch.uint8)
    code = torch.where(fields.nonzero, (exp << fmt.man_bits) | man,
                       0).to(torch.uint8)
    signbit = torch.where(fields.sign < 0, 1, 0).to(torch.uint8)
    signbit = signbit | torch.where(fields.nonzero, 2, 0).to(torch.uint8)
    return PackedF8(code=code, signbit=signbit)


def unpack(p: PackedF8, fmt: FloatFormat = E4M4) -> F8Fields:
    exp = (p.code >> fmt.man_bits).to(torch.int8)
    man = (p.code & fmt.max_man_code).to(torch.int8)
    nonzero = (p.signbit & 2) != 0
    sign = torch.where((p.signbit & 1) != 0, -1, 1).to(torch.int8)
    return F8Fields(sign=sign, exp=torch.where(nonzero, exp, 0),
                    man=torch.where(nonzero, man, 0), nonzero=nonzero)
