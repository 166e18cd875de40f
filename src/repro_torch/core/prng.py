"""Threefry2x32 counter-based random numbers, bit for bit ``jax.random``'s.

Counterpart of the ``jax.random`` calls the reference makes while
serving and in its macro models: ``PRNGKey``, ``fold_in``, ``split``,
``bits``, ``uniform``, ``bernoulli``, ``randint``, ``normal``,
``gumbel`` and ``categorical``, under jax's default
``jax_threefry_partitionable=True`` scheme:

  * a key is two uint32 words; here a ``(..., 2)`` int64 tensor holding
    them (torch's uint32 lacks most arithmetic), on the device it is
    made on.  Leading key axes batch every function, as ``jax.vmap``
    over the key does;
  * ``bits(key, shape)`` hashes the 64-bit flat index of every element
    (high word, low word) with the key and returns the xor of the two
    output words;
  * ``split`` hashes the indices 0..n-1 and keeps both output words as
    the new keys ("foldlike"); ``fold_in`` hashes the pair (0, data).

Every integer step is an int64 op masked to 32 bits, so bits, keys and
uniforms equal jax's exactly, on the CPU and on the card.  The float
transforms are written as XLA writes them:

  * ``uniform``: the top 23 bits as the mantissa of a float in [1, 2),
    minus 1, scaled, then ``max(lo, .)``;
  * ``randint``: two 32-bit draws (under the two halves of a split key)
    folded into [lo, hi) with uint32 arithmetic, ``2^32 mod span`` as
    the high draw's multiplier;
  * ``normal``: ``sqrt(2) * erf_inv(u)``, u uniform in
    (nextafter(-1, 0), 1), with XLA's float32 ``erf_inv`` (Giles: two
    9-term polynomials in ``w = -log1p(-u^2)``, Horner with fused
    multiply-adds, +-inf at |u| == 1);
  * ``gumbel`` (mode "low"): ``-log(-log(u))``, u uniform in (tiny, 1);
  * ``categorical``: the argmax of logits + gumbel.

``log`` and ``log1p`` are XLA's CPU float32 approximations (Cephes'
logf polynomial and log1p's rational function), operation for
operation, with the multiply-adds fused where the CPU compiler fuses
them: a fused multiply-add is evaluated in float64 from float32
operands (the product is exact there) and rounded once to float32.
Square roots are taken in float64 and rounded (torch's float32 CPU
sqrt is not always correctly rounded).  Every float step is then one
IEEE operation, so the card and the CPU give the same floats, and over
the parity test's draws they equal jax's
(``tests/test_torch_prng.py``).  No function reads a tensor back to
the host, so a captured CUDA graph can replay any of them.
"""
from __future__ import annotations

import functools
import math
import struct
from typing import Sequence, Tuple, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# XLA's float32 erf_inv coefficients (highest degree first), for
# w < 5 and for w >= 5
_ERFINV_SMALL = tuple(float(np.float32(c)) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941))
_ERFINV_LARGE = tuple(float(np.float32(c)) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
    2.83297682))

_F32 = torch.float32
_TINY = float(np.finfo(np.float32).tiny)
_SQRT2 = float(np.float32(np.sqrt(2.0)))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds) of the counter pair
    (x0, x1) under the key (k0, k1); int64 tensors holding uint32
    values, broadcast together."""
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


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The key of an integer seed, as ``jax.random.PRNGKey`` makes it with
    64-bit types off: the seed taken modulo 2^32 as the low word, a zero
    high word (so -1 gives (0, 2^32 - 1))."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def _words(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if key.shape[-1] != 2 or key.dtype != torch.int64:
        raise ValueError(f"a key is a (..., 2) int64 tensor, got "
                         f"{tuple(key.shape)} {key.dtype}")
    return key[..., 0], key[..., 1]


def fold_in(key: torch.Tensor, data: Union[int, torch.Tensor]
            ) -> torch.Tensor:
    """A new key from ``key`` and a 32-bit ``data`` word (an int in
    [0, 2^32) or an int64 tensor of such, broadcast against the key's
    leading axes)."""
    if isinstance(data, int) and not 0 <= data <= _MASK:
        raise ValueError(f"fold_in data {data} is not a uint32")
    k0, k1 = _words(key)
    d = (data & _MASK if isinstance(data, torch.Tensor)
         else torch.full((), data, dtype=torch.int64, device=key.device))
    o0, o1 = threefry2x32(k0, k1, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def _hash(key: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both output words of the counters (hi, lo) under every key of
    ``key`` (..., 2): shape key.shape[:-1] + hi.shape."""
    k0, k1 = _words(key)
    expand = (...,) + (None,) * hi.dim()
    return threefry2x32(k0[expand], k1[expand], hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys from ``key`` (..., 2) -> (..., num, 2)."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    o0, o1 = _hash(key, torch.zeros_like(idx), idx)
    return torch.stack([o0, o1], dim=-1)


def bits_at(key: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The 32 random bits (int64 in [0, 2^32)) that ``bits(key, shape)``
    puts at the flat indices ``index`` (an int64 tensor): any slice or
    re-layout of a draw, without drawing the rest."""
    o0, o1 = _hash(key, index >> 32, index & _MASK)
    return o0 ^ o1


def bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32 random bits per element of ``shape``, int64 in [0, 2^32);
    shape key.shape[:-1] + shape."""
    shape = _shape(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device).reshape(shape)
    return bits_at(key, idx)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (taken in float64: torch's
    float32 CPU sqrt is not always correctly rounded)."""
    return torch.sqrt(x.to(torch.float64)).to(_F32)


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once (b and c float32 values, tensors or
    Python floats): the product is exact in float64, the sum rounds in
    float64, then once to float32."""
    b = b.to(torch.float64) if isinstance(b, torch.Tensor) else b
    c = c.to(torch.float64) if isinstance(c, torch.Tensor) else c
    return (a.to(torch.float64) * b + c).to(_F32)


class _Analytic(torch.autograd.Function):
    """An elementwise function whose value is computed operation for
    operation (bit views, clamps) and whose gradient is the analytic
    one, ``grad(x, y)`` times the cotangent, as jax's rule gives it."""

    @staticmethod
    def forward(ctx, x, value, grad):
        y = value(x)
        ctx.grad = grad
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return ctx.grad(g, x, y), None, None


def analytic_grad(grad):
    """Decorator: where autograd records, ``fn(x)`` runs inside
    ``_Analytic`` with the cotangent rule ``grad(g, x, y)``; elsewhere
    the plain function runs."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(x):
            if torch.is_grad_enabled() and x.requires_grad:
                return _Analytic.apply(x, fn, grad)
            return fn(x)
        return call
    return wrap


def _unit(b: torch.Tensor) -> torch.Tensor:
    """Bits -> float32 in [0, 1): the top 23 bits as the mantissa of a
    float in [1, 2), minus 1 (exact)."""
    m = ((b >> 9) | 0x3F800000).to(torch.int32)
    return m.view(_F32) - 1.0


def uniform_from_bits(b: torch.Tensor, lo: float = 0.0, hi: float = 1.0
                      ) -> torch.Tensor:
    """``uniform``'s transform of drawn bits: float32 in [lo, hi)."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    scale = float(np.float32(hi32 - lo32))
    return torch.clamp_min(fma(_unit(b), scale, float(lo32)), float(lo32))


def uniform(key: torch.Tensor, shape: Shape, lo: float = 0.0,
            hi: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [lo, hi) of ``shape`` (after the key's leading
    axes), ``jax.random.uniform``'s."""
    return uniform_from_bits(bits(key, shape), lo, hi)


def bernoulli(key: torch.Tensor, p: float, shape: Shape) -> torch.Tensor:
    """bool draws of ``shape``, True with probability ``p``:
    ``jax.random.bernoulli``'s (mode "low"), a float32 uniform compared
    with ``p`` rounded to float32 (the dtype jax gives a Python float)."""
    return uniform(key, shape) < float(np.float32(p))


def _f32(hex_double: str) -> float:
    """A float32 constant given as the hex of its double (LLVM IR's
    spelling of a float)."""
    return float(np.float32(struct.unpack(">d", bytes.fromhex(hex_double))[0]))


# XLA's CPU logf (Cephes): the polynomial in the reduced mantissa, the
# split ln 2 and sqrt(1/2); and its log1p's rational approximation for
# |x| < sqrt(2) - 1
_LOG_P = tuple(_f32(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000",
    "BFBFCBA9E0000000", "3FC23D37E0000000", "BFC555CA00000000",
    "3FC999D580000000", "BFCFFFFF80000000", "3FD5555540000000"))
_LOG_Q1, _LOG_Q2 = _f32("BF2BD01060000000"), _f32("3FE6300000000000")
_SQRTHF = _f32("3FE6A09E60000000")
_LOG1P_DEN = tuple(_f32(h) for h in (
    "402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
    "4073519460000000", "406B0DB140000000", "404E0F3040000000"))
_LOG1P_NUM = tuple(_f32(h) for h in (
    "3F07BC0960000000", "3FDFE818A0000000", "401A509F40000000",
    "403DE97380000000", "404E798EC0000000", "404C8E75A0000000",
    "40340A2020000000"))
_LOG1P_SMALL = _f32("3FDA8279A0000000")


@analytic_grad(lambda g, x, y: g / x)
def log(v: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 log, operation for operation (its multiply-adds
    fused as the CPU compiler fuses them): v = 2^e * m, m in [sqrt(1/2),
    sqrt(2)), a degree-8 polynomial in m - 1, e * ln 2 in two parts; -inf
    at 0 and at subnormals, which that code reads as 0."""
    b = torch.clamp_min(v, _TINY).view(torch.int32)
    e = ((b >> 23) - 127).to(_F32) + 1.0
    m = ((b & 0x7FFFFF) | 0x3F000000).view(_F32)           # [0.5, 1)
    lt = m < _SQRTHF
    x = (m - 1.0) + torch.where(lt, m, 0.0)
    e = e - torch.where(lt, 1.0, 0.0)
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y, y1, y2 = fma(x, p[0], p[1]), fma(x, p[3], p[4]), fma(x, p[6], p[7])
    y, y1, y2 = fma(y, x, p[2]), fma(y1, x, p[5]), fma(y2, x, p[8])
    y = fma(fma(y, x3, y1), x3, y2)
    y = fma(y, x3, e * _LOG_Q1)
    r = fma(e, _LOG_Q2, (x - x2 * 0.5) + y)
    r = torch.where(v > 0, r, float("nan"))
    # XLA's CPU code treats subnormal inputs as zero: their log is -inf
    r = torch.where((v >= 0) & (v < _TINY), float("-inf"), r)
    return torch.where(v == float("inf"), float("inf"), r)


# XLA's CPU expf (Cephes): the input range, log2(e), ln 2 in two parts
# and the polynomial of e^a on (-ln 2 / 2, ln 2 / 2)
_EXP_LO, _EXP_HI = _f32("C055F33340000000"), _f32("4056333340000000")
_LOG2E = _f32("3FF7154760000000")
_EXP_C1, _EXP_C2 = _f32("3FE6300000000000"), _f32("BF2BD01060000000")
_EXP_P = tuple(_f32(h) for h in (
    "3F2A0D2CE0000000", "3F56E879C0000000", "3F81112100000000",
    "3FA5553820000000", "3FC5555540000000"))


@analytic_grad(lambda g, x, y: g * y)
def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 exp, operation for operation (its multiply-adds
    fused as the CPU compiler fuses them): x clamped to [-87.8, 88.8], n =
    floor(x log2(e) + 1/2) clamped to [-127, 127], a = x - n ln 2 in two
    parts, e^a by a degree-5 polynomial, times 2^n built in the exponent
    bits; results below the smallest normal flushed to 0, as that code
    runs with denormals off.  Equal to jax's jitted exp on 1.5 M inputs
    in [-100, 17]; torch's float32 exp differs on about a sixth of
    them."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    a = fma(n, -_EXP_C1, x)
    a = fma(n, -_EXP_C2, a)
    z = fma(a, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        z = fma(z, a, c)
    z = 1.0 + fma(fma(z, a, 0.5), a * a, a)
    r = z * ((n.to(torch.int32) + 127) << 23).view(_F32)
    return torch.where(r.abs() < _TINY, 0.0, r)


# XLA's CPU float32 tanh (Eigen's rational approximation): the clamp at
# which it reaches exactly +-1 with fused multiply-adds, the odd
# numerator's and the even denominator's coefficients in x^2
_TANH_CLAMP = 7.99881172180175781
_TANH_SMALL = 0.0004
_TANH_NUM = tuple(float(np.float32(c)) for c in (
    -2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
    5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
    4.89352455891786e-03))
_TANH_DEN = tuple(float(np.float32(c)) for c in (
    1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
    4.89352518554385e-03))


@analytic_grad(lambda g, x, y: (g + g * y) * (1.0 - y))
def tanh(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 tanh, operation for operation: x clamped to
    +-7.9988, x * P(x^2) / Q(x^2) with the polynomials' multiply-adds
    fused, and x itself where |x| < 0.0004.  Equal to jax's jitted tanh
    on 5.4 M inputs in [-12, 12]; torch's differs on more than half of
    them."""
    xc = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    num = torch.full_like(x2, _TANH_NUM[0])
    for c in _TANH_NUM[1:]:
        num = fma(x2, num, c)
    den = torch.full_like(x2, _TANH_DEN[0])
    for c in _TANH_DEN[1:]:
        den = fma(x2, den, c)
    return torch.where(x.abs() < _TANH_SMALL, x, (xc * num) / den)


@analytic_grad(lambda g, x, y: g / (x + 1.0))
def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 log1p: log(1 + x), or for |x| < sqrt(2) - 1
    x - x^2/2 + x^3 * P(x)/Q(x)."""
    den = x + _LOG1P_DEN[0]
    for c in _LOG1P_DEN[1:]:
        den = fma(den, x, c)
    num = torch.full_like(x, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = fma(num, x, c)
    x2 = x * x
    small = x + fma(x2, -0.5, (x * x2) * (num / den))
    return torch.where(x.abs() < _LOG1P_SMALL, small, log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 inverse error function of float32 ``x``."""
    w = -log1p(-(x * x))
    small = w < 5.0
    w = torch.where(small, w - 2.5, sqrt(w) - 3.0)
    coef = lambda i: torch.where(small, _ERFINV_SMALL[i], _ERFINV_LARGE[i])
    p = coef(0).to(_F32)
    for i in range(1, len(_ERFINV_SMALL)):
        p = fma(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal_from_bits(b: torch.Tensor) -> torch.Tensor:
    """``normal``'s transform of drawn bits: float32 standard normals."""
    return erf_inv(uniform_from_bits(b, _NORMAL_LO, 1.0)) * _SQRT2


def scaled_normal_fma(b: torch.Tensor, scale: float, addend: torch.Tensor
                     ) -> torch.Tensor:
    """``addend + scale * normal`` of drawn bits as XLA compiles it inside
    ``jax.jit``: the constant ``scale`` folds into the normal's sqrt(2)
    (one float32 constant), and the add fuses with that multiply:
    fma(erf_inv(u), f32(sqrt(2) * scale), addend).  (Op by op, outside
    ``jit``, the product is rounded before the add.)"""
    c = float(np.float32(_SQRT2) * np.float32(scale))
    return fma(erf_inv(uniform_from_bits(b, _NORMAL_LO, 1.0)), c, addend)


def normal(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """float32 standard normals of ``shape`` (after the key's leading
    axes), ``jax.random.normal``'s (equal over the parity tests'
    draws)."""
    return normal_from_bits(bits(key, shape))


_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def _rem(a: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """uint32 remainder as XLA defines it: a mod n, and a where n is 0."""
    return torch.where(n == 0, a, a % torch.where(n == 0, 1, n))


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of a * b for a, b in [0, 2^32), in int64 without
    overflow: b taken in 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = (a * (b >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _MASK


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """int32 integers in [minval, maxval) of ``shape`` (after the key's
    leading axes), ``jax.random.randint``'s with its default int32 type:
    the bounds clipped to int32 (a ``maxval`` above it widens the span by
    one, so int32's maximum can be drawn), span 1 where maxval <= minval,
    and the offset (hi mod span) * (2^32 mod span) + lo mod span, mod
    span, in uint32, from 32 bits under each of ``split(key)``."""
    shape = _shape(shape)
    over = maxval > _I32_MAX
    lo_v = min(max(int(minval), _I32_MIN), _I32_MAX)
    hi_v = min(max(int(maxval), _I32_MIN), _I32_MAX)
    span = (hi_v - lo_v) & _MASK
    if hi_v <= lo_v:
        span = 1
    elif over:
        span = (span + 1) & _MASK
    k = split(key)
    higher, lower = bits(k[..., 0, :], shape), bits(k[..., 1, :], shape)
    n = torch.full((), span, dtype=torch.int64, device=key.device)
    mult = _rem(torch.full_like(n, 1 << 16), n)
    mult = _rem(_mul32(mult, mult), n)
    off = _rem((_mul32(_rem(higher, n), mult) + _rem(lower, n)) & _MASK, n)
    v = (lo_v + off) & _MASK
    return torch.where(v > _I32_MAX, v - (1 << 32), v).to(torch.int32)


def gumbel(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """float32 standard Gumbel draws (``jax.random.gumbel``, mode
    "low")."""
    return -log(-log(uniform(key, shape, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor, axis: int = -1
                ) -> torch.Tensor:
    """Samples of the categorical distributions ``softmax(logits)`` along
    ``axis``: argmax(logits + gumbel), int64, the logits' shape without
    ``axis``.  A key with leading axes draws one row per key (the
    reference's ``vmap`` over per-row keys): then those axes must be the
    logits' own leading axes and the draw covers the rest."""
    lead = key.dim() - 1
    g = gumbel(key, logits.shape[lead:])
    return torch.argmax(g + logits, dim=axis)
