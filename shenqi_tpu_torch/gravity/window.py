"""Short-range force window calibrated against the port's own PM solver
(shenqi_tpu/gravity/window.py:35-157 in torch).

The erfc window is only the continuum ideal: the PM force also carries
CIC deconvolution and finite-difference effects, so the exact
complement differs from erfc by a few 1e-3 in the matching region.  As
in the JAX package, a unit point mass is deposited, the PM force is
read out at many directions and radii, and

    W_force(r) = 1 - F_pm(r) / F_newton(r)

is tabulated direction-averaged, in mesh cells.  The calibration runs
`pm_forces` of this package on the requested device; the fit is host
float64 numpy, identical to the JAX package's.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .._device import resolve_device
from .pm import PMConfig, pm_forces
from .shortrange import PolyWindow
from ..core.particles import float_to_ipos

NTAB = 512
RMAX_CELLS = 15.0


def calibrated_window_table(asmth: float, nmesh: int = 128,
                            nsamples_dir: int = 96, seed: int = 12345,
                            device=None):
    """Measure 1 - F_pm/F_newton on a radial grid (mesh-cell units).

    Returns (dx_cells, force_window[NTAB] f32 numpy) with entries for
    r = i * dx_cells mesh cells; entry 0 is 1.0.  Cached per device.
    """
    return _calibrated_window_table(asmth, nmesh, nsamples_dir, seed,
                                    str(resolve_device(device)))


@lru_cache(maxsize=4)
def _calibrated_window_table(asmth, nmesh, nsamples_dir, seed, device):
    box = float(nmesh)  # box units = mesh cells
    G = 1.0
    cfg = PMConfig(nmesh=nmesh, boxsize=box, G=G, asmth=asmth)

    rng = np.random.RandomState(seed)
    # average over source sub-cell offsets (CIC phase) and directions
    # (16 x 96 at 128^3, as in the JAX package)
    nsrc = 16
    dx = RMAX_CELLS / (NTAB - 1)
    radii = np.arange(1, NTAB) * dx
    dirs = rng.normal(size=(nsamples_dir // 2, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs = np.concatenate([dirs, -dirs])

    acc_radial = np.zeros((len(radii), len(dirs)))
    for _ in range(nsrc):
        src = box / 2 + rng.uniform(0, 1, 3)
        targets = (src[None, None, :]
                   + radii[:, None, None] * dirs[None, :, :])
        tpos = targets.reshape(-1, 3) % box
        pos = np.concatenate([[src], tpos])
        # unit mass at src, zero-mass test particles elsewhere
        mass = np.zeros(len(pos), np.float32)
        mass[0] = 1.0
        ipos = float_to_ipos(pos, box, device=device)
        accel, _, _ = pm_forces(ipos, torch.from_numpy(mass).to(device),
                                cfg, want_potential=False)
        acc = accel[1:].double().cpu().numpy().reshape(
            len(radii), len(dirs), 3)
        acc_radial += np.einsum("rds,ds->rd", acc, -dirs) / nsrc
    f_newton = G / radii ** 2
    ratio = acc_radial.mean(axis=1) / f_newton
    window = np.concatenate([[1.0], 1.0 - ratio])
    window = np.clip(window, 0.0, None)
    # blend the noise-dominated far tail to erfc beyond r = 6 asmth
    from scipy.special import erfc
    r = np.arange(NTAB) * dx
    u = r * 0.5 / asmth
    w_erfc = erfc(u) + 2 * u / np.sqrt(np.pi) * np.exp(-u * u)
    blend = r > 6.0 * asmth
    window[blend] = w_erfc[blend]
    return dx, window.astype(np.float32)


def _window_arrays_np(asmth: float, device):
    from scipy.special import erfc
    dx, wf = calibrated_window_table(asmth, device=device)
    r = np.arange(NTAB) * dx
    u = r * 0.5 / asmth
    wp = erfc(u).astype(np.float32)
    return float(dx), wf, wp


def window_polynomials(asmth: float, degree: int = None,
                       xmax_cells: float = None, device=None):
    """Chebyshev fits of the calibrated window.

    degree=None picks the smallest degree whose fit residual is within
    3e-4 of the degree-29 residual floor, as in the JAX package;
    xmax_cells truncates the fit range (default: the full 15-cell
    table).  Returns a PolyWindow(xmax_cells, cf [deg+1], cp [deg+1])
    whose polynomials take t = 2*(r_cells/xmax) - 1.
    """
    dev = resolve_device(device)
    dx, wf, wp = _window_arrays_np(asmth, dev)
    wf = np.asarray(wf, np.float64)
    wp = np.asarray(wp, np.float64)
    x = np.arange(NTAB) * dx
    if xmax_cells is not None:
        keep = x <= xmax_cells
        x, wf, wp = x[keep], wf[keep], wp[keep]
    xmax = x[-1]
    t = 2.0 * (x / xmax) - 1.0
    cheb = np.polynomial.chebyshev

    def fit(w, deg):
        if deg is not None:
            return cheb.chebfit(t, w, deg)
        floor = np.abs(cheb.chebval(t, cheb.chebfit(t, w, 29))
                       - w).max()
        for d in range(8, 30, 2):
            c = cheb.chebfit(t, w, d)
            if np.abs(cheb.chebval(t, c) - w).max() < floor + 3e-4:
                return c
        return cheb.chebfit(t, w, 29)

    cf = fit(wf, degree)
    cp = fit(wp, degree)
    return PolyWindow(
        xmax=float(np.float32(xmax)),
        cf=torch.from_numpy(cf.astype(np.float32)).to(dev),
        cp=torch.from_numpy(cp.astype(np.float32)).to(dev))
