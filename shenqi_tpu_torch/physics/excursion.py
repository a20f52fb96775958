"""Excursion-set reionization: J21 grids from filtered star/SFR fields
(uvbg.cpp analog, the Meraxes/21cmFAST find_HII_bubbles scheme;
shenqi_tpu/physics/excursion.py in torch on the device).

Entirely FFT-based, so it maps directly onto the PM machinery:

  1. CIC-deposit three grids: total mass, fesc-weighted stellar mass,
     fesc-weighted SFR.
  2. For a ladder of filter radii R (Rmax -> Rmin, dividing by
     ReionDeltaRFactor), smooth all three in k-space (real-space
     top-hat / sharp-k / Gaussian filters, uvbg.cpp:218-254).
  3. A cell is ionized at the LARGEST R where the filtered collapsed
     fraction exceeds 1/ReionEfficiency (Sobacchi & Messinger 2013
     eqn 7 barrier, uvbg.cpp:341-348); its J21 records the local SFR
     density at that first crossing (uvbg.cpp:436-447).
  4. On the last (smallest-R) step, not-crossed cells get partial
     ionization xHI = 1 - f_coll * ReionEfficiency.
  5. Particles read out the MAX J21 over their 8 CIC cells and record
     z_reion at first ionization (uvbg.cpp:461-472).

Escape fractions follow the halo-mass power law fesc =
EscapeFractionNorm * (M_halo / 1e10 Msun/h)^EscapeFractionScaling,
clamped to [0, 1] (uvbg.cpp:474-508).

The JAX package passes each rung's R, R-to-mass and J21 constant into its
jitted step as f32 scalars, so the ladder's arithmetic with them is f32;
here they are 0-d f32 tensors for the same rounding.  The FFTs are
torch.fft (cuFFT on the card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..utils.constants import (HYDROGEN_MASSFRAC, PLANCK, PROTONMASS,
                               SEC_PER_YEAR, SOLAR_MASS)
from ..core.particles import u32, POS_SCALE
from ..ops.cic import cic_deposit
from ..gravity.pm import _kpos_1d


@dataclass(frozen=True)
class ExcursionSetParams:
    UVBGdim: int = 64
    ReionRBubbleMax: float = 20340.0     # internal length
    ReionRBubbleMin: float = 406.8
    ReionDeltaRFactor: float = 1.1
    ReionFilterType: int = 0             # 0 real TH, 1 sharp-k, 2 gauss
    RtoMFilterType: int = 0              # 0 top-hat, 1 gaussian
    ReionGammaHaloBias: float = 2.0
    ReionNionPhotPerBary: float = 4000.0
    AlphaUV: float = 3.0
    EscapeFractionNorm: float = 0.2      # at 1e10 Msun/h
    EscapeFractionScaling: float = 0.5
    ReionUseParticleSFR: int = 0
    ReionSFRTimescale: float = 0.1


class ExcursionResult(NamedTuple):
    j21_grid: torch.Tensor           # [N,N,N]
    xhi_grid: torch.Tensor           # [N,N,N] neutral fraction
    j21_particles: torch.Tensor      # [Np] per-gas J21 (max of CIC cells)
    vol_weighted_xhi: torch.Tensor   # scalar
    mass_weighted_xhi: torch.Tensor  # scalar


def escape_fractions(halo_mass, par: ExcursionSetParams,
                     unit_mass_in_g, hubble_param):
    """fesc(M_halo) power law; zero for particles outside halos
    (uvbg.cpp:474-508)."""
    conv = unit_mass_in_g / SOLAR_MASS / 1e10 / hubble_param
    f = (par.EscapeFractionNorm
         * torch.clamp(halo_mass * conv, min=1e-35)
         ** par.EscapeFractionScaling)
    return torch.where(halo_mass > 0, torch.clamp(f, 0.0, 1.0), 0.0)


def _filter_k(k_mag, R, filter_type):
    """k-space smoothing filters (uvbg.cpp:218-254)."""
    kR = k_mag * R
    if filter_type == 0:      # real-space top-hat
        kRs = torch.clamp(kR, min=1e-4)
        w = 3.0 * (torch.sin(kRs) / kRs ** 3 - torch.cos(kRs) / kRs ** 2)
        return torch.where(kR > 1e-4, w, 1.0)
    elif filter_type == 1:    # sharp-k, volume-matched
        return torch.where(kR * 0.413566994 > 1, 0.0, 1.0)
    elif filter_type == 2:    # gaussian, volume-matched
        kRg = kR * 0.643
        return torch.exp(-kRg * kRg / 2.0)
    raise ValueError(f"ReionFilterType {filter_type} undefined")


def _r_to_m(R, par: ExcursionSetParams, omega0, rhocrit):
    if par.RtoMFilterType == 0:
        return 4.0 / 3.0 * np.pi * R ** 3 * omega0 * rhocrit
    return (2 * np.pi) ** 1.5 * omega0 * rhocrit * R ** 3


def radius_ladder(par: ExcursionSetParams, boxsize):
    """Rmax -> Rmin dividing by ReionDeltaRFactor (host-side)."""
    rmax = min(par.ReionRBubbleMax, boxsize / 2)
    radii = []
    r = rmax
    while r > par.ReionRBubbleMin:
        radii.append(r)
        r /= par.ReionDeltaRFactor
    radii.append(par.ReionRBubbleMin)
    return radii


def calculate_uvbg(ipos, mass, ptype, sfr, fesc, atime, CP, units,
                   boxsize, par: ExcursionSetParams,
                   mask=None) -> ExcursionResult:
    """One excursion-set pass on the device the inputs lie on; returns
    the grids and the per-gas J21.

    ipos: [Np,3] int32 bit patterns of the fixed-point positions (ALL
    particles); sfr: [Np] internal SFR (gas rows; zero elsewhere);
    fesc: [Np] per-particle escape fraction (stars + sf gas).
    """
    n = par.UVBGdim
    dev = ipos.device
    f32 = torch.float32
    if mask is None:
        mask = mass > 0
    live = mask
    is_gas = live & (ptype == 0)
    is_star = live & (ptype == 4)

    m_all = torch.where(live, mass, 0.0)
    m_star = torch.where(is_star, mass * fesc, 0.0)
    if par.ReionUseParticleSFR:
        src_sfr = torch.where(is_gas, sfr * fesc, 0.0)
    else:
        src_sfr = torch.zeros_like(sfr)

    grid_mass = cic_deposit(ipos, m_all, n)
    grid_star = cic_deposit(ipos, m_star, n)
    mass_k = torch.fft.rfftn(grid_mass)
    star_k = torch.fft.rfftn(grid_star)
    sfr_k = (torch.fft.rfftn(cic_deposit(ipos, src_sfr, n))
             if par.ReionUseParticleSFR else None)

    kx = _kpos_1d(n, dev)[:, None, None]
    ky = _kpos_1d(n, dev)[None, :, None]
    kz = _kpos_1d(n, dev, half=True)[None, None, :]
    k_mag = torch.sqrt(kx * kx + ky * ky + kz * kz) * (
        2 * np.pi / boxsize)

    redshift = 1.0 / atime - 1.0
    y_he = 1.0 - HYDROGEN_MASSFRAC
    baryon_frac = CP.OmegaBaryon / CP.Omega0
    reion_eff = (1.0 / baryon_frac * par.ReionNionPhotPerBary
                 / (1.0 - 0.75 * y_he))
    tot_cells = float(n) ** 3
    pixvol = (boxsize / n) ** 3
    deltax_conv = tot_cells / (CP.RhoCrit * CP.Omega0 * boxsize ** 3)
    hubble_time = 1.0 / (float(CP.hubble_function(atime))
                         * CP.HubbleParam)
    sfr_unit_conv = (1.0 / (units.UnitMass_in_g / SOLAR_MASS)
                     * (units.UnitTime_in_s / SEC_PER_YEAR))

    radii = radius_ladder(par, boxsize)

    def j21_const(R):
        return ((1 + redshift) ** 2 / (4 * np.pi) * par.AlphaUV
                * PLANCK * 1e21 * R * units.UnitLength_in_cm
                * par.ReionNionPhotPerBary / PROTONMASS
                * units.UnitMass_in_g / units.UnitLength_in_cm ** 3
                / units.UnitTime_in_s)

    def step(j21, xhi, R, rtom, jc, last):
        filt = _filter_k(k_mag, R, par.ReionFilterType)
        m_real = torch.clamp(torch.fft.irfftn(mass_k * filt, s=(n, n, n)),
                             min=0.0)
        s_real = torch.clamp(torch.fft.irfftn(star_k * filt, s=(n, n, n)),
                             min=0.0)
        dom = torch.clamp(m_real * deltax_conv, min=1e-35)
        fcoll = (s_real / (rtom * dom)
                 * (4.0 / 3.0) * np.pi * R ** 3 / pixvol)
        if par.ReionUseParticleSFR:
            f_real = torch.clamp(torch.fft.irfftn(sfr_k * filt,
                                                  s=(n, n, n)), min=0.0)
            sfr_density = f_real / pixvol * sfr_unit_conv
        else:
            sfr_density = s_real / (par.ReionSFRTimescale
                                    * hubble_time) / pixvol
        j21_aux = sfr_density * jc
        ionized = fcoll > 1.0 / reion_eff
        j21 = torch.where(ionized & (xhi > 1e-6), j21_aux, j21)
        xhi = torch.where(ionized, 0.0, xhi)
        if last:
            xhi = torch.where(~ionized & (xhi > 1e-6),
                              torch.clamp(1.0 - fcoll * reion_eff, 0.0,
                                          1.0), xhi)
        return j21, xhi

    def s32(x):
        return torch.tensor(np.float32(x), dtype=f32, device=dev)

    j21 = torch.zeros((n, n, n), dtype=f32, device=dev)
    xhi = torch.ones((n, n, n), dtype=f32, device=dev)
    for i, R in enumerate(radii):
        j21, xhi = step(j21, xhi, s32(R),
                        s32(_r_to_m(R, par, CP.Omega0, CP.RhoCrit)),
                        s32(j21_const(R)), i == len(radii) - 1)

    # global neutral fractions (uvbg.cpp:425-458)
    dom = grid_mass * deltax_conv
    vol_xhi = torch.mean(xhi)
    mass_xhi = torch.sum(xhi * dom) / torch.clamp(torch.sum(dom), min=1e-35)

    # particle readout: max J21 over the 8 CIC corner cells, from the f32
    # rounding of the unsigned position (ROADMAP C.1): a value that rounds
    # up to 2^32 lands on cell n, which the modulo wraps to 0
    cell = u32(ipos).to(f32) * float(np.float32(n / POS_SCALE))
    i0 = torch.floor(cell).long()
    j21f = j21.reshape(-1)
    j21p = torch.zeros(ipos.shape[0], dtype=f32, device=dev)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ii = (i0[:, 0] + dx) % n
                jj = (i0[:, 1] + dy) % n
                kk = (i0[:, 2] + dz) % n
                j21p = torch.maximum(j21p, j21f[(ii * n + jj) * n + kk])
    j21p = torch.where(is_gas, j21p, 0.0)

    return ExcursionResult(j21_grid=j21, xhi_grid=xhi,
                           j21_particles=j21p,
                           vol_weighted_xhi=vol_xhi,
                           mass_weighted_xhi=mass_xhi)
