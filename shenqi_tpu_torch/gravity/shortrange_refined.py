"""The pieces of shenqi_tpu/gravity/shortrange_refined.py that the grid
stencil uses (`stencil.py` imports them): capacity rounding, tier
bounds and the one-rsqrt pair factor.  The refined tree schedule itself
is not part of this slice.
"""

from __future__ import annotations

import torch

from .shortrange import (PolyWindow, clenshaw, host_coeffs, spline_force,
                         short_range_window)


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _pair_fac(r2, mass, h, cellsize, window_tables, want_pot: bool):
    """(force factor, potential factor) with ONE rsqrt and no divide.

    force = dx * fac.  Identical math to shortrange.spline_force +
    short_range_window: the spline's 1/u^3 and 1/u terms are rewritten
    exactly in rinv (h^-3 u^-3 == rinv^3, (h u)^-1 == rinv).
    """
    rinv = torch.where(r2 > 0, torch.rsqrt(r2), 0.0)
    r = r2 * rinv
    rinv3 = rinv * rinv * rinv
    fac_n = mass * rinv3

    hinv = 1.0 / h
    h3i = hinv * hinv * hinv
    u = r * hinv
    fac_in = mass * h3i * (10.666666666667 + u * u * (32.0 * u - 38.4))
    fac_out = (mass * h3i * (21.333333333333 - 48.0 * u
                             + 38.4 * u * u
                             - 10.666666666667 * u * u * u)
               - 0.066666666667 * mass * rinv3)
    soft = r2 < h * h
    fac = torch.where(soft, torch.where(u < 0.5, fac_in, fac_out), fac_n)

    if not isinstance(window_tables, PolyWindow):
        raise ValueError("_pair_fac needs the Chebyshev window; "
                         "_pair_fac_any takes the erfc form")
    xmax, cf, cp = window_tables
    x = r * (1.0 / cellsize)
    t = torch.clamp(2.0 * (x / xmax) - 1.0, -1.0, 1.0)
    inrange = x < xmax
    fw = torch.where(inrange, torch.clamp(
        clenshaw(t, host_coeffs(cf)), 0.0, 1.0), 0.0)
    pw = torch.where(inrange, torch.clamp(
        clenshaw(t, host_coeffs(cp)), 0.0, 1.0), 0.0) if want_pot else None

    if not want_pot:
        return fac * fw, None
    pot_n = -mass * rinv
    wp_in = -2.8 + u * u * (5.333333333333 + u * u * (6.4 * u - 9.6))
    wp_out = (-3.2 + u * u * (10.666666666667
                              + u * (-16.0 + u * (9.6
                                     - 2.133333333333 * u))))
    pot_soft = mass * hinv * torch.where(u < 0.5, wp_in, wp_out) \
        + torch.where(u < 0.5, 0.0, 0.066666666667 * mass * rinv)
    facpot = torch.where(soft, pot_soft, pot_n)
    return fac * fw, facpot * pw


def _pair_fac_any(r2, mass, params, window_tables, want_pot):
    """Dispatch: fast FMA form for PolyWindow, reference form else."""
    if isinstance(window_tables, PolyWindow):
        return _pair_fac(r2, mass, params.softening, params.cellsize,
                         window_tables, want_pot)
    fac, facpot = spline_force(r2, mass, params.softening)
    fw, pw = short_range_window(torch.sqrt(r2), params.cellsize,
                                params.asmth, window_tables)
    return fac * fw, (facpot * pw if want_pot else None)


def tier_bounds(nbs: int):
    """Static cumulative tier boundaries over the count-sorted
    sub-blocks: [50%, 75%, 87.5%, 100%]."""
    return (nbs // 2, (3 * nbs) // 4, (7 * nbs) // 8, nbs)


def _round_cap(x: int, align: int = 128) -> int:
    """Static QUAD-row cap: next multiple of the dense-pass chunk.
    128 quad rows = 512 particle lanes."""
    if x <= 32:
        return 32
    if x <= 64:
        return 64
    return ((x + align - 1) // align) * align
