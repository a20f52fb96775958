"""Massive-neutrino background density Omega_nu(a).

Host-side (numpy/scipy, float64) evaluation of the energy density of up to
three massive neutrino species by Fermi-Dirac integration, with the
relativistic and non-relativistic limits handled analytically.  Functionally
equivalent to the reference neutrino background module
(libgadget/omega_nu_single.cpp): same temperature ratio TNUCMB, same
rho_nu integral rho = 4/(2 pi^2) (kT_nu)^4/(hbar c)^3 * integral, same
hybrid particle/analytic split.

A copy of shenqi_tpu/cosmology/neutrinos.py (no JAX in it) so that the PyTorch port
imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
from scipy.integrate import quad
from scipy.interpolate import CubicSpline

from ..utils.constants import (BOLEVK, TNUCMB, NUSPECIES, LIGHTCGS, PLANCK,
                               EV_IN_ERGS, GRAVITY, HUBBLE)

# Conversion factor from the FD momentum integral (in eV^4) to g/cm^3:
# rho = g * 4 pi / (2 pi hbar)^3 * integral  with g = 2 (nu + antinu),
# i.e. a prefactor of 1/pi^2 in hbar=c=1 units; q enters in eV, so
# convert eV^4 -> erg^4, divide by (hbar c)^3 and c^2.
_HBAR = PLANCK / (2 * np.pi)


def _rho_nu_conversion():
    """Convert the FD momentum integral (in eV^4) to g/cm^3 (comoving)."""
    return (1.0 / np.pi ** 2
            * EV_IN_ERGS ** 4
            / (_HBAR * LIGHTCGS) ** 3
            / LIGHTCGS ** 2)


# Mass (in units of kT_nu) above which a neutrino is treated as fully
# non-relativistic via the series expansion.
_NU_SW = 100.0


def _rho_nu_relativistic(a, kT):
    """Massless limit: rho = 7/8 (pi^2/15) (kT/a)^4 (energy density /c^2)."""
    return 7.0 * (np.pi * kT / a) ** 4 / 120.0 * _rho_nu_conversion()


def _rho_nu_nonrelativistic(a, mnu, kT):
    """Non-relativistic series expansion of the FD integral in (kT a/m)^2.

    rho ~ m n + 15/2 * n * kT^2/m * ... ; coefficients are Riemann-zeta
    ratios (same expansion as the reference's rho_nu_nr).
    """
    amnu = a * mnu
    kTamnu2 = (kT * a / mnu) ** 2
    z3 = 1.202056903159594     # zeta(3)
    z5 = 1.0369277551433704    # zeta(5)
    z7 = 1.0083492773819229    # zeta(7)
    z9 = 1.0020083928260826    # zeta(9)
    return (amnu * kT ** 3 / a ** 4
            * (1.5 * z3
               + kTamnu2 * 45.0 / 4.0 * z5
               + 2835.0 / 32.0 * kTamnu2 ** 2 * z7
               + 80325.0 / 32.0 * kTamnu2 ** 3 * z9)
            * _rho_nu_conversion())


def _rho_nu_integral(a, mnu, kT):
    """Direct FD integration: integrand q^2 sqrt(q^2 + (a m)^2) f0(q/kT).

    Non-dimensionalized with x = q/kT so the integrand is O(1) (the raw
    integral is ~kT^4 ~ 1e-15 eV^4, far below scipy's default epsabs).
    """
    r = a * mnu / kT   # mass in units of kT

    def integrand(x):
        eps = np.sqrt(x * x + r * r)
        return x * x * eps / (np.exp(x) + 1.0)

    result, _ = quad(integrand, 0, 500.0, limit=200, epsrel=1e-12)
    return result * kT ** 4 / a ** 4 * _rho_nu_conversion()


class _RhoNuSingle:
    """Tabulated rho_nu(a) for one massive species (log-spline in loga)."""

    NPOINTS = 1024

    def __init__(self, a0: float, mnu: float, kT: float):
        self.mnu = mnu
        self.kT = kT
        self.spline = None
        if mnu <= 0:
            return
        if a0 * mnu < 1e-6 * kT:
            a0 = 1e-6 * kT / mnu
        loga0 = np.log(a0)
        logaf = np.log(_NU_SW * kT / mnu) + np.log(1.2)
        if mnu < 1e-6 * kT or logaf < loga0:
            return  # always in a limit regime
        logas = np.linspace(loga0, logaf, self.NPOINTS)
        rhos = np.array([_rho_nu_integral(np.exp(la), mnu, kT)
                         for la in logas])
        self.loga0, self.logaf = loga0, logaf
        self.spline = CubicSpline(logas, rhos)

    def rho(self, a: float) -> float:
        kT, mnu = self.kT, self.mnu
        amnu = a * mnu
        if mnu == 0.0 or kT == 0.0:
            return _rho_nu_relativistic(a, kT)
        # heavily non-relativistic: series converges for kT/amnu < 1/NU_SW
        if amnu > _NU_SW * kT:
            return _rho_nu_nonrelativistic(a, mnu, kT)
        # heavily relativistic (includes massless)
        if amnu < 1e-6 * kT:
            return _rho_nu_relativistic(a, kT)
        loga = np.log(a)
        if self.spline is not None and self.loga0 <= loga <= self.logaf:
            return float(self.spline(loga))
        # below the table: assume relativistic (early times, low accuracy ok)
        if self.spline is not None and loga < self.loga0:
            return _rho_nu_relativistic(a, kT)
        return _rho_nu_integral(a, mnu, kT)


def nufrac_low(qc: float) -> float:
    """Fraction of the FD distribution with q < qc (dimensionless momenta).

    Integral of q^2/(e^q+1) from 0 to qc, normalized by the total
    3/2 zeta(3)/2... total integral = 3 zeta(3)/2.
    """
    if qc <= 0:
        return 0.0
    result, _ = quad(lambda q: q * q / (np.exp(q) + 1.0), 0, qc)
    total = 1.5 * 1.202056903159594
    return result / total


class HybridNu:
    """Hybrid particle/analytic neutrino bookkeeping.

    The SLOW neutrinos (below the critical z=0 velocity) become N-body
    particles once a > nu_crit_time — they are the ones that cluster
    nonlinearly; the fast tail stays in the linear response
    (omega_nu_single.cpp init_hybrid_nu / particle_nu_fraction).
    """

    def __init__(self, enabled=False, mnu=(0, 0, 0), vcrit=0.0,
                 light_internal=1.0, nu_crit_time=0.0, kBtnu=1.0):
        self.enabled = enabled
        self.nu_crit_time = nu_crit_time
        self.vcrit = vcrit / light_internal
        self.nufrac_low = np.zeros(NUSPECIES)
        if enabled:
            for i in range(NUSPECIES):
                if mnu[i] > 0:
                    qc = mnu[i] * vcrit / light_internal / kBtnu
                    self.nufrac_low[i] = nufrac_low(qc)

    def particle_fraction(self, a: float, i: int) -> float:
        """Fraction of the species' mass in live particles — the
        BELOW-vcrit share (omega_nu_single.cpp:229-238; an earlier
        revision here returned the complement, which would have put
        the free-streaming tail into particles)."""
        if not self.enabled or a <= self.nu_crit_time:
            return 0.0
        return self.nufrac_low[i]


class OmegaNu:
    """Total neutrino matter density Omega_nu(a) for three species."""

    def __init__(self, MNu, a0: float, HubbleParam: float, tcmb0: float):
        self.kBtnu = BOLEVK * TNUCMB * tcmb0
        self.tcmb0 = tcmb0
        # critical density in g/cm^3 (h factors included like reference)
        self.rhocrit = (3 * (HUBBLE * HubbleParam) ** 2
                        / (8 * np.pi * GRAVITY))
        self.MNu = tuple(MNu)
        # group degenerate species
        self.nu_degeneracies = []
        self.tables = []
        masses = list(MNu)
        used = [False] * NUSPECIES
        for i in range(NUSPECIES):
            if used[i]:
                continue
            deg = 1
            for j in range(i + 1, NUSPECIES):
                if not used[j] and masses[j] == masses[i]:
                    used[j] = True
                    deg += 1
            used[i] = True
            self.nu_degeneracies.append(deg)
            self.tables.append(_RhoNuSingle(a0, masses[i], self.kBtnu))
        self.hybnu = HybridNu()

    def get_omega_nu(self, a: float) -> float:
        rhonu = 0.0
        for deg, tab in zip(self.nu_degeneracies, self.tables):
            rhonu += deg * tab.rho(a)
        return rhonu / self.rhocrit

    def get_omega_nu_nopart(self, a: float) -> float:
        """Omega_nu excluding the part followed by live particles."""
        omega = self.get_omega_nu(a)
        part = (self.get_omega_nu(1.0)
                * self.hybnu.particle_fraction(a, 0) / a ** 3)
        return omega - part

    def get_omegag(self, a: float) -> float:
        """Photon density at scale factor a (from the CMB temperature)."""
        from ..utils.constants import STEFAN_BOLTZMANN
        rho_gamma = (4 * STEFAN_BOLTZMANN * self.tcmb0 ** 4
                     / LIGHTCGS ** 3)   # g/cm^3
        return rho_gamma / self.rhocrit / a ** 4
