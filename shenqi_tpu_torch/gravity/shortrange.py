"""Short-range force law: parameters, spline softening and the window
(shenqi_tpu/gravity/shortrange.py:39-132 in torch, without the octree
walk).

Physics identical to the reference short-range solver
(libgadget/gravshort2.hpp:326-356): a spline-softened Newtonian kernel
times the short-range window, which is the PM-calibrated Chebyshev fit
(`PolyWindow`, window.window_polynomials) or the analytic erfc form
(`ErfcWindow`, ShortRangeForceWindowType erfc).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# beyond this many mesh cells the short-range window is identically zero
# (the reference's NGRAVTAB*dx table range, shortrange-kernel.c)
TABLE_RANGE_CELLS = 511.0 * 2.935420743639786e-02


class PolyWindow(NamedTuple):
    """Chebyshev form of the short-range window (window.window_polynomials).
    xmax is the float32 value of the fit range in mesh cells, as a
    Python float; cf/cp are f32 tensors on the device."""
    xmax: float
    cf: torch.Tensor    # force-window coefficients
    cp: torch.Tensor    # potential-window coefficients


class ErfcWindow(NamedTuple):
    """The analytic erfc window (ShortRangeForceWindowType erfc; the JAX
    package passes no tables for it): u = r / cellsize * 0.5 / asmth,
    force window erfc(u) + 2u / sqrt(pi) exp(-u^2), potential window
    erfc(u), both zero at r >= xmax cells (TABLE_RANGE_CELLS), no clip.
    The pair kernel reads xmax as the Chebyshev window's fit range."""
    asmth: float
    xmax: float = TABLE_RANGE_CELLS


class ShortRangeParams(NamedTuple):
    boxsize: float
    cellsize: float        # mesh cell size (BoxSize/Nmesh)
    rcut: float            # in internal length units (TreeRcut * cellsize)
    asmth: float           # in mesh cells
    err_tol_force_acc: float = 0.002
    bh_opening_angle: float = 0.175
    use_bh: int = 0        # 1: BH angle only; 0: acceleration criterion
    softening: float = 1.0  # spline softening h (2.8 x Plummer-equivalent)
    G: float = 43007.1


def clenshaw(t: torch.Tensor, c) -> torch.Tensor:
    """Chebyshev series sum_k c[k] T_k(t) by Clenshaw's recursion, in
    the JAX package's operation order.  `c` is a sequence of f32
    scalars (a host list, so no device read per term)."""
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for k in range(len(c) - 1, 0, -1):
        b1, b2 = c[k] + 2.0 * t * b1 - b2, b1
    return c[0] + t * b1 - b2


def host_coeffs(c: torch.Tensor):
    """f32 coefficients as Python floats (exactly representable)."""
    return [float(x) for x in c.detach().cpu().numpy().astype(np.float32)]


def poly_window(t, cf, cp=None):
    """The calibrated window's Chebyshev fits at t = 2 r / (cellsize
    xmax) - 1, clamped to [-1, 1]: (force window, potential window or
    None), each clamped to [0, 1].  cf, cp: the coefficients as host
    floats (host_coeffs)."""
    t = torch.clamp(t, -1.0, 1.0)
    fw = torch.clamp(clenshaw(t, cf), 0.0, 1.0)
    pw = torch.clamp(clenshaw(t, cp), 0.0, 1.0) if cp is not None else None
    return fw, pw


def erfc_window(u, want_pot=True):
    """The analytic window at u = r / cellsize * 0.5 / asmth: (erfc(u) +
    2u/sqrt(pi) exp(-u^2), erfc(u) or None), in the JAX package's
    operation order."""
    e = torch.special.erfc(u)
    fw = e + 2.0 * u / np.sqrt(np.pi) * torch.exp(-u * u)
    return fw, (e if want_pot else None)


def short_range_window(r, cellsize, asmth, tables=None):
    """(force_window, pot_window); zero beyond the table range.

    With a PolyWindow evaluates the Chebyshev fits of the PM-calibrated
    window; with an ErfcWindow or no tables the analytic erfc window (an
    ErfcWindow's asmth is the one `asmth` names).  (The JAX package's
    linear-table form has no caller in the port.)
    """
    if isinstance(tables, PolyWindow):
        xmax, cf, cp = tables
        x = r / cellsize
        fw, pw = poly_window(2.0 * (x / xmax) - 1.0, host_coeffs(cf),
                             host_coeffs(cp))
        inrange = x < xmax
        return torch.where(inrange, fw, 0.0), torch.where(inrange, pw, 0.0)
    if tables is not None and not isinstance(tables, ErfcWindow):
        raise TypeError("the port evaluates the Chebyshev (PolyWindow) or "
                        "the analytic erfc (ErfcWindow) window")
    fw, pw = erfc_window(r / cellsize * (0.5 / asmth))
    inrange = r < TABLE_RANGE_CELLS * cellsize
    return torch.where(inrange, fw, 0.0), torch.where(inrange, pw, 0.0)


def spline_force(r2, mass, h):
    """Softened 1/r^3 force factor and potential (Gadget W2 spline).

    Returns (fac, facpot) with force = dx * fac, pot += facpot.
    Matches apply_accn (gravshort2.hpp:326-356).
    """
    r = torch.sqrt(r2)
    rinv = torch.where(r > 0, 1.0 / torch.clamp(r, min=1e-35), 0.0)
    fac_newton = mass * rinv * rinv * rinv
    pot_newton = -mass * rinv

    u = r / h
    h3_inv = 1.0 / (h * h * h)
    fac_in = mass * h3_inv * (10.666666666667 + u * u * (32.0 * u - 38.4))
    wp_in = -2.8 + u * u * (5.333333333333 + u * u * (6.4 * u - 9.6))
    u_safe = torch.clamp(u, min=1e-10)
    fac_out = mass * h3_inv * (21.333333333333 - 48.0 * u + 38.4 * u * u
                               - 10.666666666667 * u * u * u
                               - 0.066666666667 / (u_safe * u_safe * u_safe))
    wp_out = (-3.2 + 0.066666666667 / u_safe
              + u * u * (10.666666666667
                         + u * (-16.0 + u * (9.6 - 2.133333333333 * u))))
    fac_soft = torch.where(u < 0.5, fac_in, fac_out)
    wp = torch.where(u < 0.5, wp_in, wp_out)
    pot_soft = mass / h * wp

    soft = r2 < h * h
    return (torch.where(soft, fac_soft, fac_newton),
            torch.where(soft, pot_soft, pot_newton))
