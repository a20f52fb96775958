"""The threefry2x32 counter-based generator of `jax.random` (JAX 0.9 with
`jax_threefry_partitionable` on, its default), so that the port draws the
same numbers from the same keys as the JAX package.

  * a key is a pair of uint32 words, held here as a tuple of two Python
    ints; `PRNGKey(seed)` is (seed >> 32, seed & 0xFFFFFFFF);
  * `split(key, n)` hashes the counters (0, i), i < n: key i is the
    hash's two words (jax/_src/prng.py `_threefry_split_foldlike`);
  * `bits(key, shape)` hashes the counters (i >> 32, i & 0xFFFFFFFF) of
    the flat row-major index i and XORs the two words
    (`_threefry_random_bits_partitionable`);
  * `uniform(key, shape)` keeps the top 23 bits as an f32 mantissa in
    [1, 2) and subtracts 1 (jax/_src/random.py `_uniform`);
  * `normal(key, shape)` scales that uniform to [nextafter(-1, 0), 1)
    as jax's `uniform(minval, maxval)` does and returns sqrt(2) erfinv
    of it (`_normal_real`).  The uniform is jax's to the bit.  erfinv is
    XLA's f32 form (`erfinv_xla`: Giles' polynomials), not
    torch.special.erfinv, which is closer to the true erfinv but lies up
    to ~80 ulp from XLA's in the tails; the two forms differ by FMA
    contraction only (2 ulp at most on the CPU).

The arithmetic is int64 with 32-bit masks: torch has no uint32 add,
shift or compare (ROADMAP C.1).  Key chains run on the host; `bits` and
`uniform` run on the device of the caller's choosing, and `start`
gives the flat index of a block's first element, so a large draw can be
made a block of rows at a time with the counters the whole shape has.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: int, k2: int, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter words x0, x1
    (int64 tensors of uint32 values) under the key (k1, k2); returns the
    two output words (jax/_src/prng.py `_threefry2x32_lowering`)."""
    ks = (k1 & _M32, k2 & _M32, (k1 ^ k2 ^ 0x1BD11BDA) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def PRNGKey(seed: int) -> tuple:
    """jax.random.PRNGKey(seed) for a seed in [0, 2^31)."""
    return ((seed >> 32) & _M32, seed & _M32)


def split(key: tuple, num: int = 2) -> list:
    """jax.random.split(key, num), as a list of keys."""
    lo = torch.arange(num, dtype=torch.int64)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return list(zip(b1.tolist(), b2.tolist()))


def _counters(shape, start: int, device):
    n = math.prod(shape)
    i = torch.arange(start, start + n, dtype=torch.int64, device=device)
    return i >> 32, i & _M32


def bits(key: tuple, shape=(), start: int = 0, device="cpu"):
    """jax.random.bits(key, shape, uint32) as int64 tensor values, or
    elements [start, start + prod(shape)) of a larger draw's flat order.
    shape () gives a Python int."""
    hi, lo = _counters(shape, start, device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    out = (b1 ^ b2).reshape(shape)
    return int(out) if shape == () else out


def uniform(key: tuple, shape, start: int = 0, device="cpu"):
    """jax.random.uniform(key, shape) in f32 over [0, 1), or the block of
    a larger draw's flat order starting at `start`."""
    b = bits(key, tuple(shape), start, device)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


# XLA's f32 erf_inv (xla/hlo/builder/lib/math.cc ErfInv32; M. Giles,
# "Approximating the erfinv function", 2012): a degree-8 polynomial in
# w - 2.5 for w = -log1p(-x^2) < 5, else in sqrt(w) - 3
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def erfinv_xla(x):
    """erfinv of an f32 tensor as XLA evaluates lax.erf_inv: the
    polynomials of _ERFINV_CENTRAL / _ERFINV_TAIL by Horner in f32,
    times x; +-inf at +-1."""
    w = -torch.log1p(-x * x)
    central = w < 5.0
    w = torch.where(central, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for c, t in zip(_ERFINV_CENTRAL, _ERFINV_TAIL):
        c = torch.where(central, float(np.float32(c)), float(np.float32(t)))
        p = c if p is None else c + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


# jax's normal draws its uniform over [nextafter(-1, 0), 1) in f32
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_NORMAL_SPAN = float(np.float32(1.0) - np.float32(_NORMAL_LO))
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))


def normal(key: tuple, shape, start: int = 0, device="cpu"):
    """jax.random.normal(key, shape) in f32, or the block of a larger
    draw's flat order starting at `start`: u = max(lo, uniform * (1 -
    lo) + lo) with lo = nextafter(-1, 0), each step rounded to f32 as
    jax rounds it, then sqrt(2) * erfinv(u) (jax/_src/random.py
    `_normal_real`), erfinv as XLA evaluates it (`erfinv_xla`)."""
    u = uniform(key, shape, start, device)
    u = torch.clamp(u * _NORMAL_SPAN + _NORMAL_LO, min=_NORMAL_LO)
    return _SQRT2_F32 * erfinv_xla(u)


def mulmod32(a, b):
    """uint32 a*b mod 2^32 for int64 tensors (or ints) of uint32 values:
    the product split into 16-bit halves of `a`, so that no partial
    product reaches 2^63."""
    hi = ((a >> 16) * b) & 0xFFFF
    return ((hi << 16) + (a & 0xFFFF) * b) & _M32


def randint(key: tuple, minval: int, maxval: int) -> int:
    """jax.random.randint(key, (), minval, maxval) for the default int32
    (jax/_src/random.py `_randint`): two 32-bit words from the key's two
    halves, reduced modulo the span with uint32 arithmetic that wraps.
    A maxval past the int32 range is clipped to its maximum and the span
    widened by one."""
    i32max = 2 ** 31 - 1
    k1, k2 = split(key)
    hi, lo = bits(k1), bits(k2)
    out_of_range = maxval > i32max
    minval = min(max(minval, -2 ** 31), i32max)
    maxval = min(max(maxval, -2 ** 31), i32max)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    if out_of_range and maxval > minval:
        span = (span + 1) & _M32

    def rem(x):                 # XLA: an unsigned x % 0 is x
        return x % span if span else x

    mult = rem(rem(2 ** 16) * rem(2 ** 16) & _M32)
    off = rem((rem(hi) * mult + rem(lo)) & _M32)
    v = (minval + off) & _M32
    return v - 2 ** 32 if v > i32max else v
