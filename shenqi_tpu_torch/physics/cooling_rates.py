"""Primordial cooling/heating rate network (cooling_rates.cpp analog;
shenqi_tpu/physics/cooling_rates.py in torch).

Katz, Weinberg & Hernquist 1996 H/He network with the Sherwood
calibration (Bolton et al 2016): Verner & Ferland 96 recombination,
Voronov 97 collisional ionization, Cen 92 collisional excitation with
the softened high-T correction, Spitzer free-free, inverse Compton, and
Rahmati 2012 self-shielding.  The UV background comes from a TREECOOL
table (same file format as the reference).

The rate fits, the ionization equilibrium and the implicit solver are
f32 torch ops on the caller's tensors; the UVB interpolation at the
current redshift is host float64 (`TreeCool`, `UVBG`, `CoolingParams`
and `self_shield_dens` are copies of the JAX package's host code).
`get_equilib_ne` keeps the JAX package's fixed 40 + 1 iterations.  The
solver's bracket (at most 45 steps) and bisection (at most 50) stop at
the first step that moves no row, as the reference's loops stop
(cooling.cpp:57-135), where the JAX package runs both to their counts:
each step reads one flag on the host, and the steps left out would
only re-evaluate the rate at an unchanged point (`do_cooling`).  On a
card each rate evaluation replays a captured CUDA graph
(`heatingcooling_rate`).  The UVB rates are host floats or, under the
fluctuating UVB, [rows] tensors
(uv_fluctuations.local_uvbg).  Where a host rate is zero its term is left
out on the host, where the JAX package selects 0.0 for it on the device;
where all three are zero (no TREECOOL file, as in star-small) the
self-shielding factor multiplies nothing and is not computed.  With a
metal cooling table the rate subtracts Z times its lookup
(cooling_rates.py:304-353 of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..utils.constants import (BOLEVK, BOLTZMANN, PROTONMASS,
                               GAMMA_MINUS1, EV_IN_ERGS, THOMPSON,
                               RAD_CONST, ELECTRONMASS, LIGHTCGS)


# All cooling/heating rates are carried in units of 1e-24 erg cm^3/s so
# that f32 intermediates stay near unity (the JAX package's scale).
LAMSCALE = 1e24


class UVBG(NamedTuple):
    """Photoionization (1/s) + photoheating (erg/s) rates at fixed z."""
    gJH0: float = 0.0
    gJHe0: float = 0.0
    gJHep: float = 0.0
    epsH0: float = 0.0
    epsHe0: float = 0.0
    epsHep: float = 0.0
    self_shield_dens: float = 1e10
    zreion: float = 8.0


@dataclass
class CoolingParams:
    CMBTemperature: float = 2.7255
    MinGasTemp: float = 5.0
    PhotoIonizeFactor: float = 1.0
    SelfShieldingOn: bool = True
    PhotoIonizationOn: bool = True
    UVRedshiftThreshold: float = -1.0
    fBar: float = 0.17
    recomb: str = "Verner96"       # or 'Cen92'
    cooling: str = "Sherwood"      # or 'KWH92'
    HeliumHeatOn: bool = False
    HeliumHeatThresh: float = 10.0
    HeliumHeatAmp: float = 1.0
    HeliumHeatExp: float = 0.0
    rho_crit_baryon: float = 0.0


class TreeCool:
    """TREECOOL table: log10(1+z) -> photoionization/heating rates."""

    def __init__(self, path: str, photo_factor: float = 1.0):
        data = np.loadtxt(path)
        self.log1z = data[:, 0]
        self.rates = np.log10(np.maximum(data[:, 1:7], 1e-300))
        self.photo_factor = photo_factor

    def uvbg(self, redshift: float, params: CoolingParams,
             gray_opac_z=None) -> UVBG:
        log1z = np.log10(1 + redshift)
        if log1z >= self.log1z[-1]:
            return UVBG()
        if params.UVRedshiftThreshold >= 0 and \
                redshift > params.UVRedshiftThreshold:
            return UVBG()
        vals = [10.0 ** np.interp(log1z, self.log1z, self.rates[:, i])
                * self.photo_factor for i in range(6)]
        zreion = 10 ** self.log1z[-1] - 1
        if params.UVRedshiftThreshold >= 0:
            zreion = params.UVRedshiftThreshold
        uv = UVBG(gJH0=vals[0], gJHe0=vals[1], gJHep=vals[2],
                  epsH0=vals[3], epsHe0=vals[4], epsHep=vals[5],
                  zreion=zreion)
        ssdens = self_shield_dens(redshift, uv, params)
        return uv._replace(self_shield_dens=ssdens)


# Gray opacity for the FG2009 UVB (cooling_rates.cpp:967-969)
_GRAYOPAC_Z = np.array([0., 1, 2, 3, 4, 5])
_GRAYOPAC = np.array([2.59e-18, 2.37e-18, 2.27e-18, 2.15e-18, 2.02e-18,
                      1.94e-18])


def self_shield_dens(redshift: float, uvbg: UVBG,
                     params: CoolingParams) -> float:
    """Rahmati 2012 eq. 13 critical density (atoms/cm^3)."""
    if uvbg.gJH0 == 0:
        return 1e10
    g12 = uvbg.gJH0 / 1e-12
    greyopac = np.interp(np.clip(redshift, 0, 5), _GRAYOPAC_Z, _GRAYOPAC)
    return (6.73e-3 * (greyopac / 2.49e-18) ** (-2. / 3)
            * g12 ** (2. / 3) * (params.fBar / 0.17) ** (-1. / 3))


def per_row(uvbg: UVBG) -> bool:
    """Whether the UVBG's fields are per-row tensors."""
    return torch.is_tensor(uvbg.gJH0)


def uvbg_take(uvbg: UVBG, idx) -> UVBG:
    """The UVBG of the rows `idx` (host-float fields stay as they are)."""
    return UVBG(*(v[idx] if torch.is_tensor(v) else v for v in uvbg))


def _uvbg_cat(uvbg: UVBG, times: int) -> UVBG:
    return UVBG(*(torch.cat([v] * times) if torch.is_tensor(v) else v
                  for v in uvbg))


def _photo_on(uvbg: UVBG) -> bool:
    if per_row(uvbg):
        return True
    return uvbg.gJH0 > 0 or uvbg.gJHe0 > 0 or uvbg.gJHep > 0


def _photorate(g, ne_safe, photofac):
    """The photoionization term of one species: left out where a host
    rate is 0, selected per row where the rates are tensors (the JAX
    package's jnp.where)."""
    if torch.is_tensor(g):
        return torch.where(g > 0, g / ne_safe * photofac, 0.0)
    return g / ne_safe * photofac if g > 0 else None


# ---------------- rate fits (f32 tensors) ----------------

def _verner96(temp, aa, bb, t0, t1):
    s0 = torch.sqrt(temp / t0)
    s1 = torch.sqrt(temp / t1)
    return aa / (s0 * (1 + s0) ** (1 - bb) * (1 + s1) ** (1 + bb))


def recomb_alphaHp(temp):
    return _verner96(temp, 7.982e-11, 0.748, 3.148, 7.036e5)


def recomb_alphaHep(temp):
    low = _verner96(temp, 3.294e-11, 0.6910, 1.554e1, 3.676e7)
    high = _verner96(temp, 9.356e-10, 0.7892, 4.266e-2, 4.677e6)
    lower, upper = 6e5, 8e5
    interp = (low * (upper - temp) + high * (temp - lower)) / 2e5
    return torch.where(temp < lower, low,
                       torch.where(temp > upper, high, interp))


def recomb_alphad(temp):
    """Dielectronic recombination (Meiksin-corrected Black 1981)."""
    t = torch.clamp(temp, min=1.0)
    return (1.23e-3 / t ** 1.5 * torch.exp(-4.72e5 / t)
            * (1 + 0.3 * torch.exp(-9.4e4 / t)))


def recomb_alphaHepd(temp):
    return recomb_alphad(temp) + recomb_alphaHep(temp)


def recomb_alphaHepp(temp):
    return _verner96(temp, 1.891e-10, 0.7524, 9.370, 2.774e6)


# the smallest normal f32: XLA flushes subnormal results to zero (and a
# TPU has none), torch keeps them
_FLT_MIN = float(np.finfo(np.float32).tiny)


def _voronov97(temp, dE, PP, AA, XX, KK):
    uu = dE / (BOLEVK * torch.clamp(temp, min=1.0))
    r = (AA * (1 + PP * torch.sqrt(uu)) / (XX + uu) * uu ** KK
         * torch.exp(-torch.clamp(uu, max=70.0)))
    # below ~3000 K the product is subnormal; the JAX package's is 0, and
    # the callers scale it by up to 1e13 into the normal range
    return torch.where(r < _FLT_MIN, 0.0, r)


def recomb_GammaeH0(temp):
    return _voronov97(temp, 13.6, 0, 0.291e-07, 0.232, 0.39)


def recomb_GammaeHe0(temp):
    return _voronov97(temp, 24.6, 0, 0.175e-07, 0.180, 0.35)


def recomb_GammaeHep(temp):
    return _voronov97(temp, 54.4, 1, 0.205e-08, 0.265, 0.25)


def _t5(temp):
    """Sherwood high-T correction (t0=5e7; KWH92 would use 1e5)."""
    return 1 + torch.sqrt(temp / 5e7)


def cool_CollisionalH0(temp):
    """Rate * LAMSCALE (all cool_* return scaled rates)."""
    excite = (7.5e-19 * LAMSCALE) \
        * torch.exp(-torch.clamp(118348.0 / temp, max=70.)) / _t5(temp)
    ionize = (13.5984 * EV_IN_ERGS * LAMSCALE) * recomb_GammaeH0(temp)
    return excite + ionize


def cool_CollisionalHe0(temp):
    excite = ((9.1e-27 * LAMSCALE) * temp ** (-0.1687)
              * torch.exp(-torch.clamp(473638.0 / temp, max=70.))
              / _t5(temp))
    ionize = (24.5874 * EV_IN_ERGS * LAMSCALE) * recomb_GammaeHe0(temp)
    return excite + ionize


def cool_CollisionalHeP(temp):
    excite = ((5.54e-17 * LAMSCALE) * temp ** (-0.397)
              * torch.exp(-torch.clamp(473638.0 / temp, max=70.))
              / _t5(temp))
    ionize = (54.417760 * EV_IN_ERGS * LAMSCALE) \
        * recomb_GammaeHep(temp)
    return excite + ionize


def cool_RecombHp(temp):
    return (0.75 * BOLTZMANN * LAMSCALE) * temp * recomb_alphaHp(temp)


def cool_RecombHeP(temp):
    return ((0.75 * BOLTZMANN * LAMSCALE) * temp
            * recomb_alphaHep(temp)
            + (6.526e-11 * LAMSCALE) * recomb_alphad(temp))


def cool_RecombHePP(temp):
    return (0.75 * BOLTZMANN * LAMSCALE) * temp \
        * recomb_alphaHepp(temp)


def cool_FreeFree1(temp):
    """Free-free with the Spitzer 78 gaunt factor (zz=1)."""
    gff = 1.1 + 0.34 * torch.exp(-(5.5 - torch.log10(temp)) ** 2 / 3.0)
    return (1.426e-27 * LAMSCALE) * torch.sqrt(temp) * gff


def cool_InverseCompton(temp, redshift, tcmb0):
    tcmb = tcmb0 * (1 + redshift)
    return (4 * THOMPSON * RAD_CONST / (ELECTRONMASS * LIGHTCGS)
            * tcmb ** 4 * BOLTZMANN * LAMSCALE * (temp - tcmb))


# ---------------- ionization equilibrium ----------------

def get_temp_from_u(nebynh, u_cgs, helium, min_temp):
    """T(K) from specific internal energy (erg/g) and ne/nH."""
    hy_mass = 1 - helium
    mu_u = 4 / (hy_mass * (3 + 4 * nebynh) + 1) * u_cgs
    temp = GAMMA_MINUS1 * PROTONMASS / BOLTZMANN * mu_u
    return torch.clamp(temp, min=min_temp)


def self_shield_corr(nh, logt, ssdens, enabled: bool):
    """Rahmati 2012 eq. 14 photoionization suppression."""
    if not enabled:
        return torch.ones_like(nh)
    t4 = torch.exp(0.17 * (logt - float(np.log(1e4))))
    nssh = 1.003 * ssdens * t4
    corr = (0.98 * (1 + (nh / nssh) ** 1.64) ** (-2.28)
            + 0.02 * (1 + nh / nssh) ** (-0.84))
    return torch.where(nh < ssdens * 0.01, 1.0, corr)


def _photofac(nh, logt, uvbg: UVBG, params: CoolingParams):
    if not _photo_on(uvbg):
        return None
    return self_shield_corr(nh, logt, uvbg.self_shield_dens,
                            params.SelfShieldingOn)


# the four Verner fits (alphaHp, alphaHep's two, alphaHepp) and the three
# Voronov fits (GammaeH0, GammaeHe0, GammaeHep) of `_species`, as rows of
# constants: each fit family is evaluated for all its rows at once, the
# same operations in the same order as one fit at a time, in a third of
# the kernel launches
_VERNER = ((7.982e-11, 0.748, 3.148, 7.036e5),
           (3.294e-11, 0.6910, 1.554e1, 3.676e7),
           (9.356e-10, 0.7892, 4.266e-2, 4.677e6),
           (1.891e-10, 0.7524, 9.370, 2.774e6))
_VORONOV = ((13.6, 0, 0.291e-07, 0.232, 0.39),
            (24.6, 0, 0.175e-07, 0.180, 0.35),
            (54.4, 1, 0.205e-08, 0.265, 0.25))
_FIT_CONSTS = {}


def _fit_consts(device):
    c = _FIT_CONSTS.get(device)
    if c is None:
        def col(rows, f):
            return torch.tensor([f(*r) for r in rows], dtype=torch.float32,
                                device=device)[:, None]
        v, w = _VERNER, _VORONOV
        c = _FIT_CONSTS[device] = dict(
            aa=col(v, lambda a, b, t0, t1: a),
            bm=col(v, lambda a, b, t0, t1: 1 - b),
            bp=col(v, lambda a, b, t0, t1: 1 + b),
            t0=col(v, lambda a, b, t0, t1: t0),
            t1=col(v, lambda a, b, t0, t1: t1),
            dE=col(w, lambda dE, P, A, X, K: dE),
            PP=col(w, lambda dE, P, A, X, K: P),
            AA=col(w, lambda dE, P, A, X, K: A),
            XX=col(w, lambda dE, P, A, X, K: X),
            KK=col(w, lambda dE, P, A, X, K: K))
    return c


def _fits(temp):
    """(alphaHp, GammaeH0, alphaHepd, alphaHepp, GammaeHe0, GammaeHep) at
    temp: the rate fits above, the Verner and Voronov families stacked."""
    c = _fit_consts(temp.device)
    s0 = torch.sqrt(temp / c["t0"])
    s1 = torch.sqrt(temp / c["t1"])
    ver = c["aa"] / (s0 * (1 + s0) ** c["bm"] * (1 + s1) ** c["bp"])
    uu = c["dE"] / (BOLEVK * torch.clamp(temp, min=1.0))
    vor = (c["AA"] * (1 + c["PP"] * torch.sqrt(uu)) / (c["XX"] + uu)
           * uu ** c["KK"] * torch.exp(-torch.clamp(uu, max=70.0)))
    vor = torch.where(vor < _FLT_MIN, 0.0, vor)
    low, high = ver[1], ver[2]
    lower, upper = 6e5, 8e5
    interp = (low * (upper - temp) + high * (temp - lower)) / 2e5
    a_hep = torch.where(temp < lower, low,
                        torch.where(temp > upper, high, interp))
    return (ver[0], vor[0], recomb_alphad(temp) + a_hep, ver[3], vor[1],
            vor[2])


def _species(nh, logt, ne, uvbg: UVBG, photofac):
    """(nH0, nHp, nHe0/nh, nHep/nh, nHepp/nh shapes per KWH 33-37)."""
    temp = torch.exp(logt)
    aHp, gH0, aHep, aHepp, gHe0, gHep = _fits(temp)
    ne_safe = torch.clamp(ne, min=1e-50)
    den = aHp + gH0
    r = _photorate(uvbg.gJH0, ne_safe, photofac)
    if r is not None:
        den = den + r
    nH0 = aHp / den
    nHp = torch.clamp(1.0 - nH0, min=0.0)

    r = _photorate(uvbg.gJHe0, ne_safe, photofac)
    if r is not None:
        gHe0 = gHe0 + r
    r = _photorate(uvbg.gJHep, ne_safe, photofac)
    if r is not None:
        gHep = gHep + r
    has_ion = gHe0 > 1e-50
    gHe0_s = torch.where(has_ion, gHe0, 1.0)
    nHep = torch.where(has_ion, nh / (1 + aHep / gHe0_s + gHep / aHepp),
                       0.0)
    nHe0 = torch.where(has_ion, nHep * aHep / gHe0_s, nh)
    nHepp = torch.where(has_ion, nHep * gHep / aHepp, 0.0)
    return nH0, nHp, nHe0, nHep, nHepp


def get_equilib_ne(nh_total, u_cgs, helium, uvbg: UVBG,
                   params: CoolingParams, ne_init=None, niter: int = 40):
    """Equilibrium ne (cgs cm^-3) via damped fixed-point iteration.

    nh_total: total hydrogen number density (cm^-3) = rho(1-Y)/mp.
    Returns (ne, logt).
    """
    nh = nh_total
    yy = helium / 4 / (1 - helium)
    ne = (torch.ones_like(nh) * nh if ne_init is None
          else torch.clamp(ne_init, min=0.0))

    def body(ne):
        nebynh = ne / nh
        logt = torch.log(get_temp_from_u(nebynh, u_cgs, helium,
                                         params.MinGasTemp))
        photofac = _photofac(nh, logt, uvbg, params)
        nH0, nHp, nHe0, nHep, nHepp = _species(nh, logt, ne, uvbg,
                                               photofac)
        ne_new = nh * nHp + yy * nHep + 2 * yy * nHepp
        # mild damping for robust convergence of the whole array
        return 0.5 * (ne + ne_new)

    for _ in range(niter):
        ne = body(ne)
    # one undamped polish
    ne = body(ne) * 2 - ne
    ne = torch.clamp(ne, min=0.0)
    logt = torch.log(get_temp_from_u(ne / nh, u_cgs, helium,
                                     params.MinGasTemp))
    return ne, logt


def get_heatingcooling_rate(rho_cgs, u_cgs, helium, redshift,
                            uvbg: UVBG, params: CoolingParams,
                            ne_init=None, metallicity=None,
                            metal_cool=None, extra_heat=0.0):
    """Net heating - cooling in erg/s/g (reference return convention).

    rho_cgs: physical density in g/cm^3 (converted internally to
    protons/cm^3 like the reference caller).  metallicity + metal_cool
    (a uv_fluctuations.MetalCoolingTable): subtract the cloudy net metal
    cooling scaled by Z (cooling_rates.cpp:1154).  extra_heat:
    additional heating in erg/s/g, a float or a per-row tensor.  Returns (lambda_net, ne/nh).
    """
    density = rho_cgs / PROTONMASS   # protons/cm^3
    nh = density * (1 - helium)
    ne, logt = get_equilib_ne(nh, u_cgs, helium, uvbg, params,
                              ne_init=ne_init)
    nebynh = ne / nh
    temp = get_temp_from_u(nebynh, u_cgs, helium, params.MinGasTemp)
    photofac = _photofac(nh, logt, uvbg, params)
    yy = helium / 4 / (1 - helium)
    nH0, nHp, nHe0, nHep, nHepp = _species(nh, logt, ne, uvbg, photofac)
    nHe0 = nHe0 * yy / nh
    nHep = nHep * yy / nh
    nHepp = nHepp * yy / nh

    lam_collis = nebynh * (cool_CollisionalH0(temp) * nH0
                           + cool_CollisionalHe0(temp) * nHe0
                           + cool_CollisionalHeP(temp) * nHep)
    lam_recomb = nebynh * (cool_RecombHp(temp) * nHp
                           + cool_RecombHeP(temp) * nHep
                           + cool_RecombHePP(temp) * nHepp)
    cff = cool_FreeFree1(temp)
    lam_ff = nebynh * (cff * (nHp + nHep) + 4 * cff * nHepp)
    lam_cmptn = nebynh * cool_InverseCompton(
        temp, redshift, params.CMBTemperature) / nh
    lam = lam_collis + lam_recomb + lam_ff + lam_cmptn

    heat = (nH0 * (uvbg.epsH0 * LAMSCALE)
            + nHe0 * (uvbg.epsHe0 * LAMSCALE)
            + nHep * (uvbg.epsHep * LAMSCALE)) / nh
    lambda_net = heat - lam
    # (scaled) erg/s cm^3 per proton -> erg/s/g; the scale constant is
    # computed in float64 on the host so no f32 intermediate leaves
    # [1e-10, 1e10]
    conv = (1 - helium) ** 2 / (LAMSCALE * PROTONMASS)
    out = lambda_net * conv * density
    if metal_cool is not None and metallicity is not None:
        out = out - metallicity * metal_cool.eval(redshift, temp, nh)
    return out + extra_heat, nebynh


def get_neutral_fraction(rho_cgs, u_cgs, helium, uvbg: UVBG,
                         params: CoolingParams, ne_init=None):
    """nH0/nH (the reference get_neutral_fraction_phys_cgs)."""
    density = rho_cgs / PROTONMASS
    nh = density * (1 - helium)
    ne, logt = get_equilib_ne(nh, u_cgs, helium, uvbg, params,
                              ne_init=ne_init)
    photofac = _photofac(nh, logt, uvbg, params)
    nH0, *_ = _species(nh, logt, ne, uvbg, photofac)
    return nH0


# ---------------- the rate evaluation on the card ----------------
#
# One rate evaluation (40 + 1 damped ionization iterations, then the
# rates) is thousands of kernel launches in torch ops, and the implicit
# solver makes up to 96 of them: 6-11 s of host dispatch per call at 96
# on an H100 (tools/torch_cooling_bench.py), where the JAX package runs
# one fused XLA program.  On a CUDA device the evaluation is captured as
# a CUDA graph per row bucket (a power of two) and parameter set, and
# replayed: the same kernels without the host dispatch.  The redshift is a device
# buffer of the graph, and so are the metallicity (with a metal cooling
# table, whose lookup the graph holds) and per-row UV rates (the
# fluctuating UVB).  Host-float UV rates are baked in, so a bucket's
# graph is captured again when they change (a TREECOOL run: once a
# step); the graph's key holds whether the metal and per-row branches
# are on.

_GRAPHS = {}


def _bucket(n: int) -> int:
    return max(256, 1 << (n - 1).bit_length())


class _RateGraph:
    """get_heatingcooling_rate over `nb` rows as a captured CUDA graph:
    static input buffers (rho, u, ne; the redshift; the metallicity and
    the per-row UV rates when on) and its outputs."""

    def __init__(self, nb, device, helium, uvbg, params, extra_heat,
                 metal_cool=None):
        def buf(v):
            return torch.full((nb,), v, dtype=torch.float32, device=device)

        # benign rows for the padding lanes
        self.rho, self.u, self.ne = buf(1e-26), buf(1e12), buf(1.0)
        self.z = torch.zeros((), dtype=torch.float32, device=device)
        self.met = buf(0.0) if metal_cool is not None else None
        # helium's long-mean-free-path heat, when it is per row
        self.xh = buf(0.0) if torch.is_tensor(extra_heat) else None
        xh_run = self.xh if self.xh is not None else extra_heat
        self.uv = (UVBG(*(buf(1e10 if f == "self_shield_dens" else 0.0)
                          for f in UVBG._fields))
                   if per_row(uvbg) else None)
        uv_run = self.uv if self.uv is not None else uvbg

        def run():
            return get_heatingcooling_rate(
                self.rho, self.u, helium, self.z, uv_run, params,
                ne_init=self.ne, metallicity=self.met,
                metal_cool=metal_cool, extra_heat=xh_run)

        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = run()

    def __call__(self, rho_cgs, u_cgs, ne, redshift, metallicity=None,
                 uvbg=None, extra_heat=None):
        n = u_cgs.shape[0]
        self.rho[:n].copy_(rho_cgs)
        self.u[:n].copy_(u_cgs)
        self.ne[:n].copy_(ne)
        self.z.fill_(float(redshift))
        if self.met is not None:
            self.met[:n].copy_(metallicity)
        if self.uv is not None:
            for b, v in zip(self.uv, uvbg):
                b[:n].copy_(v)
        if self.xh is not None:
            self.xh[:n].copy_(extra_heat)
        self.graph.replay()
        return self.out[0][:n].clone(), self.out[1][:n].clone()


def heatingcooling_rate(rho_cgs, u_cgs, helium, redshift, uvbg: UVBG,
                        params: CoolingParams, ne_init, metallicity=None,
                        metal_cool=None, extra_heat=0.0):
    """get_heatingcooling_rate, replayed from a CUDA graph when the rows
    lie on a card (see above), run op by op elsewhere."""
    if metallicity is None:
        metal_cool = None
    if u_cgs.device.type != "cuda" or u_cgs.shape[0] == 0:
        return get_heatingcooling_rate(rho_cgs, u_cgs, helium, redshift,
                                       uvbg, params, ne_init=ne_init,
                                       metallicity=metallicity,
                                       metal_cool=metal_cool,
                                       extra_heat=extra_heat)
    if ne_init is None:
        # get_equilib_ne's start, ne = nH
        ne_init = rho_cgs / PROTONMASS * (1 - helium)
    nb = _bucket(u_cgs.shape[0])
    rows = per_row(uvbg)
    xh_rows = torch.is_tensor(extra_heat)
    key = (u_cgs.device, nb, helium, tuple(vars(params).items()),
           "rows" if xh_rows else float(extra_heat), rows,
           None if metal_cool is None else id(metal_cool))
    # the graph holds the host rates it was captured with
    uv_now = None if rows else tuple(uvbg)
    uv, g = _GRAPHS.get(key, (None, None))
    if g is None or uv != uv_now:
        g = None
        _GRAPHS[key] = (None, None)     # free the old graph's pool first
        g = _RateGraph(nb, u_cgs.device, helium, uvbg, params, extra_heat,
                       metal_cool)
        _GRAPHS[key] = (uv_now, g)
    return g(rho_cgs, u_cgs, ne_init, redshift, metallicity,
             uvbg if rows else None, extra_heat if xh_rows else None)


BISECT_ITERS = 50
BRACKET_ITERS = 45


def do_cooling(u_old_cgs, rho_cgs, dt_s, helium, redshift, uvbg: UVBG,
               params: CoolingParams, min_egyspec_cgs=0.0, ne_init=None,
               metallicity=None, metal_cool=None, extra_heat=0.0):
    """Implicit cooling update: solve u = u_old + LambdaNet(u) dt.

    Vectorized version of the reference bisection (cooling.cpp:57-135):
    geometric bracket growth by 1.1x, then bisection.  Each loop ends at
    its count (BRACKET_ITERS, BISECT_ITERS, the JAX package's) or at the
    first step in which no row's bracket moved: a later step would
    evaluate the rate at the same point again, from the ne it returned
    there, and change ne by rounding alone.  `do_cooling.evaluations`
    counts the rate evaluations (1 + the bracket's + the bisection's;
    96 at the full counts) and `do_cooling.calls` the solves.
    metallicity/metal_cool are forwarded to the rate (metal cooling);
    `uvbg` and `extra_heat` may hold per-row tensors.  Returns
    (u_new_cgs, ne/nh at the solution).
    """
    u_old = torch.clamp(u_old_cgs, min=min_egyspec_cgs)
    rho_cgs, dt_s = (torch.broadcast_to(torch.as_tensor(
        x, dtype=torch.float32, device=u_old.device), u_old.shape)
        for x in (rho_cgs, dt_s))
    if metal_cool is None:
        metallicity = None
    elif metallicity is not None:
        metallicity = torch.broadcast_to(metallicity, u_old.shape)

    def lamdt(u, ne, rho=rho_cgs, dt=dt_s, met=metallicity, uv=uvbg,
              xh=extra_heat):
        ln, nebynh = heatingcooling_rate(
            rho, u, helium, redshift, uv, params, ne_init=ne,
            metallicity=met, metal_cool=metal_cool, extra_heat=xh)
        return ln * dt, nebynh

    ne = (torch.ones_like(u_old) if ne_init is None else ne_init)
    f0, ne = lamdt(u_old, ne)
    do_cooling.calls += 1
    do_cooling.evaluations += 1
    heating = (u_old - u_old - f0) < 0   # -f0 < 0 means heating

    lo = torch.where(heating, u_old, u_old / 1.1)
    hi = torch.where(heating, u_old * 1.1, u_old)
    # the bracket evaluates both ends in one call of twice the rows, each
    # end's ionization solve starting from the carried ne (the JAX
    # package starts the lower end's from the upper end's result; both
    # run the damped 41 iterations to the same equilibrium)
    n = u_old.shape[0]
    rho2, dt2 = torch.cat([rho_cgs, rho_cgs]), torch.cat([dt_s, dt_s])
    met2 = None if metallicity is None else torch.cat([metallicity] * 2)
    uv2 = _uvbg_cat(uvbg, 2)
    xh2 = (torch.cat([extra_heat] * 2) if torch.is_tensor(extra_heat)
           else extra_heat)
    for _ in range(BRACKET_ITERS):
        f2, ne_ = lamdt(torch.cat([hi, lo]), torch.cat([ne, ne]), rho2, dt2,
                        met2, uv2, xh2)
        f_hi, f_lo, ne2 = f2[:n], f2[n:], ne_[n:]
        need_up = heating & (hi - u_old - f_hi < 0)
        need_dn = (~heating) & (lo - u_old - f_lo > 0) \
            & (hi > min_egyspec_cgs)
        lo_n = torch.where(need_up, hi, torch.where(need_dn, lo / 1.1, lo))
        # the upper end moves with the NEW lower end, as the JAX body's
        # second where reads the reassigned `lo`
        hi = torch.where(need_up, hi * 1.1, torch.where(need_dn,
                                                        lo_n * 1.1, hi))
        lo, ne = lo_n, ne2
        do_cooling.evaluations += 1
        if not bool((need_up | need_dn).any()):
            break
    lo = torch.clamp(lo, min=min_egyspec_cgs * 0.1 + 1e-30)

    for _ in range(BISECT_ITERS):
        u = 0.5 * (lo + hi)
        f, ne = lamdt(u, ne)
        do_cooling.evaluations += 1
        above = (u - u_old - f) > 0
        # a row is settled once the midpoint rounds to an end of its
        # bracket (f32 neighbours, ~22 halvings of the 1.1x bracket)
        moved = torch.where(above, u != hi, u != lo)
        hi = torch.where(above, u, hi)
        lo = torch.where(above, lo, u)
        if not bool(moved.any()):
            break
    u = torch.clamp(0.5 * (lo + hi), min=min_egyspec_cgs)
    return u, ne


do_cooling.calls = 0
do_cooling.evaluations = 0
