"""TreePM gravity configuration (shenqi_tpu/gravity/treepm.py:20-82):
PM long-range + short-range complement within Rcut
(libgadget/run.cpp:538-566).  The port has one short-range engine so
far, the grid stencil with the hand-written pair kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .pm import PMConfig
from .shortrange import ErfcWindow, ShortRangeParams


class GravityConfig(NamedTuple):
    boxsize: float
    nmesh: int
    G: float
    asmth: float = 1.5
    rcut_cells: float = 6.0
    err_tol_force_acc: float = 0.002
    bh_opening_angle: float = 0.175
    use_bh: int = 0
    softening: float = 1.0     # spline softening h
    tree_nlevels: int = 8
    tree_ncrit: int = 32
    # 'exact': PM-calibrated window (Chebyshev form); 'erfc': the
    # analytic form (ShortRangeForceWindowType erfc); the pair kernel
    # evaluates both
    window_type: str = "exact"
    # 'stencil' only: the tree engines of the JAX package are not ported
    engine: str = "stencil"
    refine_sub: int = 32
    block: int = 128
    maxi: int = 1024
    maxl: int = 512

    def pm(self) -> PMConfig:
        return PMConfig(nmesh=self.nmesh, boxsize=self.boxsize, G=self.G,
                        asmth=self.asmth)

    def short(self, use_bh=None) -> ShortRangeParams:
        cellsize = self.boxsize / self.nmesh
        return ShortRangeParams(
            boxsize=self.boxsize, cellsize=cellsize,
            rcut=self.rcut_cells * cellsize, asmth=self.asmth,
            err_tol_force_acc=self.err_tol_force_acc,
            bh_opening_angle=self.bh_opening_angle,
            use_bh=self.use_bh if use_bh is None else use_bh,
            softening=self.softening, G=self.G)


def default_softening(boxsize: float, npart_total: int,
                      fraction: float = 1.0 / 30) -> float:
    """Spline softening h = 2.8 * (fraction * mean interparticle sep),
    the reference default (gravity.h:24-26, FractionalGravitySoftening).

    Kept as in the JAX package (treepm.py:62; ADVICE.md): callers pass
    the TOTAL particle count, not the DM count, so with gas the
    softening is set by all species.  A fix belongs in both packages."""
    mean_sep = boxsize / np.cbrt(npart_total)
    return 2.8 * fraction * mean_sep


def get_window_tables(cfg: GravityConfig, device=None):
    """The short-range window the pair kernel evaluates: the calibrated
    window (or its cached fit) on `device` in Chebyshev form, or for
    window_type 'erfc' the analytic form, where the JAX package returns
    None (its stencil then takes the XLA pair pass)."""
    if cfg.window_type == "erfc":
        return ErfcWindow(cfg.asmth)
    if cfg.window_type != "exact":
        raise ValueError(f"unknown window_type {cfg.window_type!r}")
    from .window import window_polynomials
    return window_polynomials(cfg.asmth, device=device)
