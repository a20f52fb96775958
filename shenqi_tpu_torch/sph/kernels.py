"""SPH smoothing kernels (Price 2011, arXiv:1012.1885 B-splines):
shenqi_tpu/sph/kernels.py on tensors.

Same math as the reference kernel module (libgadget/densitykernel.hpp):
H is the full support radius ("sml"); q = u * support/2 with u = r/H;
wk(u) = sigma * (support/2/H)^3 * wk_int(q); dwk has one extra factor of
support/2/H.  Branchless forms: `where`, not control flow.  The integer
powers are products in the order XLA's integer_pow takes them (square
and multiply), so the f32 values are the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NUMDIMS = 3
NORMCOEFF = 4.0 / 3 * np.pi


class KernelSpec(NamedTuple):
    name: str
    support: int     # support in units of 2h (cubic: 4, quartic 5, quintic 6)
    sigma: float


# 3D sigmas (Price 2011 table; reference cbsigma/quarsigma/quinsigma[2])
CUBIC = KernelSpec("cubic", 4, 1.0 / np.pi)
QUARTIC = KernelSpec("quartic", 5, 1.0 / (20 * np.pi))
QUINTIC = KernelSpec("quintic", 6, 1.0 / (120 * np.pi))

KERNELS = {k.name: k for k in (CUBIC, QUARTIC, QUINTIC)}


def desnumngb(spec: KernelSpec, eta: float) -> float:
    """Expected neighbor number for resolution eta (Price eq. 12)."""
    return NORMCOEFF * (spec.support / 2.0 * eta) ** NUMDIMS


def _ipow(x, n: int):
    """x**n for a small positive integer n by square and multiply."""
    out = None
    sq = x
    while n:
        if n & 1:
            out = sq if out is None else sq * out
        n >>= 1
        if n:
            sq = sq * sq
    return out


def _p(x, n):
    return _ipow(torch.where(x > 0, x, 0.0), n)


def _wk_int(spec: KernelSpec, q):
    if spec.name == "cubic":
        return 0.25 * _p(2 - q, 3) - _p(1 - q, 3)
    if spec.name == "quartic":
        return (_p(2.5 - q, 4) - 5 * _p(1.5 - q, 4)
                + 10 * _p(0.5 - q, 4))
    if spec.name == "quintic":
        return _p(3 - q, 5) - 6 * _p(2 - q, 5) + 15 * _p(1 - q, 5)
    raise ValueError(spec.name)


def _dwk_int(spec: KernelSpec, q):
    if spec.name == "cubic":
        return -0.75 * _p(2 - q, 2) + 3 * _p(1 - q, 2)
    if spec.name == "quartic":
        return (-4 * _p(2.5 - q, 3) + 20 * _p(1.5 - q, 3)
                - 40 * _p(0.5 - q, 3))
    if spec.name == "quintic":
        return -5 * _p(3 - q, 4) + 30 * _p(2 - q, 4) - 75 * _p(1 - q, 4)
    raise ValueError(spec.name)


def _norm(spec: KernelSpec, H):
    s2 = spec.support / 2.0
    return spec.sigma * _ipow(s2 / H, NUMDIMS)


def wk(spec: KernelSpec, u, H):
    """Kernel W(r=uH, H); normalized so that integral W dV = 1."""
    return _norm(spec, H) * _wk_int(spec, u * (spec.support / 2.0))


def dwk(spec: KernelSpec, u, H):
    """dW/dr at r = uH."""
    s2 = spec.support / 2.0
    return _norm(spec, H) * (s2 / H) * _dwk_int(spec, u * s2)


def dW_dH(spec: KernelSpec, u, H):
    """dW/dH at fixed r (the grad-h term): -(3 W/H + u dW/dr)."""
    return -(NUMDIMS * wk(spec, u, H) / H + u * dwk(spec, u, H))


def volume(H):
    return NORMCOEFF * _ipow(H, NUMDIMS)
