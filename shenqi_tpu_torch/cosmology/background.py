"""Cosmological background: H(a), growth factor, drift/kick integrals.

A copy of shenqi_tpu/cosmology/background.py (host numpy/scipy, no JAX)
so that the PyTorch port imports nothing of the JAX package.

Host-side float64 (numpy/scipy).  These quantities parameterize the jitted
device code (they enter as scalars), so there is no reason to trace them.

Physics matches the reference background module (libgadget/cosmology.cpp):
  * H(a)^2/H0^2 = OmegaL + Omega_fld(a) + OmegaK/a^2 + (Ocdm+Ob)/a^3
                  + [radiation: OmegaG/a^4 + Omega_nu(a)] + Omega_ur/a^4
  * growth factor from the 2nd-order ODE D'' + (a'/a) D' = 1.5 (a'/a)^2 D
    integrated from matter domination
  * F_Omega = dlnD/dlna (Zel'dovich velocity prefactor)
"""

from __future__ import annotations

import numpy as np
from dataclasses import dataclass, field
from scipy.integrate import solve_ivp, quad

from ..utils.constants import (GRAVITY, HUBBLE, STEFAN_BOLTZMANN, LIGHTCGS)
from ..utils.units import UnitSystem
from .neutrinos import OmegaNu


@dataclass
class Cosmology:
    # primary parameters (same names/semantics as the reference Cosmology)
    Omega0: float = 0.3
    OmegaLambda: float = 0.7
    OmegaBaryon: float = 0.045
    HubbleParam: float = 0.7
    CMBTemperature: float = 2.7255
    RadiationOn: int = 1
    Omega_fld: float = 0.0
    w0_fld: float = -1.0
    wa_fld: float = 0.0
    Omega_ur: float = 0.0
    MNu: tuple = (0.0, 0.0, 0.0)
    MassiveNuLinRespOn: int = 0
    HybridNeutrinosOn: int = 0
    HybridVcrit: float = 0.0
    HybridNuPartTime: float = 0.0
    use_class_radiation_convention: int = 1

    # derived (filled by init())
    OmegaCDM: float = field(default=0.0, init=False)
    OmegaG: float = field(default=0.0, init=False)
    OmegaK: float = field(default=0.0, init=False)
    Hubble: float = field(default=0.0, init=False)     # H0 in internal units
    GravInternal: float = field(default=0.0, init=False)
    RhoCrit: float = field(default=0.0, init=False)
    UnitTime_in_s: float = field(default=0.0, init=False)
    ONu: OmegaNu = field(default=None, init=False, repr=False)

    def init(self, TimeBegin: float, units: UnitSystem) -> "Cosmology":
        self.Hubble = HUBBLE * units.UnitTime_in_s
        self.UnitTime_in_s = units.UnitTime_in_s
        self.GravInternal = (GRAVITY / units.UnitLength_in_cm ** 3
                             * units.UnitMass_in_g * units.UnitTime_in_s ** 2)
        self.RhoCrit = (3.0 * self.Hubble ** 2
                        / (8.0 * np.pi * self.GravInternal))
        self.OmegaG = (4 * STEFAN_BOLTZMANN * self.CMBTemperature ** 4
                       * (8 * np.pi * GRAVITY)
                       / (3 * LIGHTCGS ** 3 * HUBBLE ** 2)
                       / self.HubbleParam ** 2)
        self.ONu = OmegaNu(self.MNu, TimeBegin, self.HubbleParam,
                           self.CMBTemperature)
        self.OmegaCDM = self.Omega0 - self.OmegaBaryon
        if sum(self.MNu) > 0:
            self.OmegaCDM -= self.ONu.get_omega_nu(1.0)
        self.OmegaK = 1.0 - self.Omega0 - self.OmegaLambda - self.Omega_fld
        if self.use_class_radiation_convention:
            self.OmegaK = (1.0 - self.OmegaCDM - self.OmegaBaryon
                           - self.OmegaLambda - self.Omega_fld
                           - self.Omega_ur - self.OmegaG
                           - self.ONu.get_omega_nu(1.0))
        return self

    # ---- background expansion ----
    def omega_fld(self, a: float) -> float:
        """Dark-energy fluid density with CPL w(a) = w0 + (1-a) wa."""
        if self.Omega_fld == 0.0:
            return 0.0
        return (self.Omega_fld
                * a ** (-3 * (1 + self.w0_fld + self.wa_fld))
                * np.exp(-3 * self.wa_fld * (1 - a)))

    def hubble_function(self, a):
        """H(a) in internal units (dimension of self.Hubble)."""
        a = np.asarray(a, dtype=np.float64)
        h2 = (self.OmegaLambda
              + self.omega_fld(a)
              + self.OmegaK / a ** 2
              + (self.OmegaCDM + self.OmegaBaryon) / a ** 3
              + self.Omega_ur / a ** 4)
        if self.RadiationOn:
            h2 = h2 + self.OmegaG / a ** 4
            if a.ndim == 0:
                h2 = h2 + self.ONu.get_omega_nu(float(a))
            else:
                h2 = h2 + np.array([self.ONu.get_omega_nu(float(x))
                                    for x in a])
        else:
            h2 = h2 + self.ONu.get_omega_nu(1.0)
        return self.Hubble * np.sqrt(h2)

    def efunc(self, a) -> float:
        """Dimensionless H(a)/H0."""
        return self.hubble_function(a) / self.Hubble

    def hybrid_nu_tracer(self, atime: float) -> bool:
        return bool(self.HybridNeutrinosOn
                    and atime <= self.HybridNuPartTime)

    # ---- growth factor ----
    def _growth(self, a: float):
        """Return (D(a), dD/da) from the growth ODE.

        State: y = [D, F] with F = a^3 H/H0 dD/da;
        dD/da = F/(a^3 E), dF/da = 1.5 a Omega_m(a->0 part)/a^3 /E * D.
        IC at matter domination: D ~ a with EdS radiation-corrected start.
        """
        curtime = 1e-5
        if a < curtime:
            curtime = a / 10.0
        om = self.OmegaCDM + self.OmegaBaryon

        y0 = 1.5 * om / curtime ** 2
        if self.RadiationOn:
            y0 += (self.OmegaG / curtime ** 4
                   + self.ONu.get_omega_nu(curtime))
        f0 = (curtime ** 3 * self.efunc(curtime)
              * 1.5 * om / curtime ** 3)

        def rhs(av, y):
            e = self.efunc(av)
            dD = y[1] / av ** 3 / e
            dF = y[0] * 1.5 * av * om / av ** 3 / e
            return [dD, dF]

        sol = solve_ivp(rhs, (curtime, a), [y0, f0], rtol=1e-8, atol=1e-8,
                        method="RK45", dense_output=False)
        if not sol.success:
            raise RuntimeError("growth ODE integration failed")
        D = sol.y[0, -1]
        dDda = sol.y[1, -1] / a ** 3 / self.efunc(a)
        return D, dDda

    def growth_factor(self, astart: float, aend: float) -> float:
        """Linear growth D(astart)/D(aend) (reference GrowthFactor order)."""
        return self._growth(astart)[0] / self._growth(aend)[0]

    def F_Omega(self, a: float) -> float:
        """Zel'dovich prefactor f1 = dlnD/dlna."""
        D, dDda = self._growth(a)
        return a / D * dDda

    # ---- exact drift/kick factors (timebinmgr.h:185-218 math) ----
    def exact_drift_factor(self, a0: float, a1: float) -> float:
        """integral of dt/a^2 = da /(H a^3) between scale factors."""
        if a0 == a1:
            return 0.0
        val, _ = quad(lambda a: 1.0 / (self.hubble_function(a) * a ** 3),
                      a0, a1, epsrel=1e-12, limit=100)
        return val

    def exact_gravkick_factor(self, a0: float, a1: float) -> float:
        """integral of dt/a = da /(H a^2)."""
        if a0 == a1:
            return 0.0
        val, _ = quad(lambda a: 1.0 / (self.hubble_function(a) * a ** 2),
                      a0, a1, epsrel=1e-12, limit=100)
        return val

    def exact_hydrokick_factor(self, a0: float, a1: float) -> float:
        """integral of da / (H a^{3(gamma-1)} a), gamma=5/3 -> 1/(H a^3)."""
        from ..utils.constants import GAMMA_MINUS1
        if a0 == a1:
            return 0.0
        # Kept as in shenqi_tpu/cosmology/background.py:180: this quad
        # can emit scipy's IntegrationWarning (epsrel 1e-12 is below
        # what 100 subintervals reach).  The port matches the reference
        # factor and does not silence or retune it; a fix belongs in
        # both packages together.
        val, _ = quad(lambda a: 1.0 / (self.hubble_function(a)
                                       * a ** (3 * GAMMA_MINUS1) * a),
                      a0, a1, epsrel=1e-12, limit=100)
        return val

    def age_myr(self, a0: float, a1: float) -> float:
        """Cosmic time elapsed between scale factors, in Myr.

        t = int da / (a H(a)); internal time -> seconds via
        UnitTime_in_s / h (the internal time unit carries 1/h, as the
        length unit is kpc/h; cf. the reference's atime_integ usage in
        libgadget/metal_return.cpp:258).
        """
        if a1 <= a0:
            return 0.0
        val, _ = quad(lambda a: 1.0 / (self.hubble_function(a) * a),
                      a0, a1, epsrel=1e-8, limit=100)
        from ..utils.constants import SEC_PER_MEGAYEAR
        return (val * self.UnitTime_in_s / self.HubbleParam
                / SEC_PER_MEGAYEAR)

    def comoving_distance(self, a0: float, a1: float,
                          UnitVelocity_in_cm_per_s: float) -> float:
        """Comoving distance between scale factors in internal length."""
        c_internal = LIGHTCGS / UnitVelocity_in_cm_per_s
        val, _ = quad(lambda a: c_internal
                      / (self.hubble_function(a) * a * a),
                      min(a0, a1), max(a0, a1), epsrel=1e-10, limit=100)
        return val


def tophat_sigma(k: np.ndarray, pk: np.ndarray, R: float) -> float:
    """sqrt of the top-hat-filtered variance of a tabulated P(k).

    sigma^2(R) = int 4 pi k^2 W^2(kR) P(k) dk with
    W(x) = 3 (sin x / x^3 - cos x / x^2).  Log-log interpolation between
    table points, matching the reference normalization integral.
    """
    logk, logp = np.log(k), np.log(pk)

    def pk_eval(kk):
        if kk <= k[0]:
            return pk[0]
        if kk >= k[-1]:
            return pk[-1]
        return np.exp(np.interp(np.log(kk), logk, logp))

    def integrand(kk):
        kr = R * kk
        if kr < 1e-8:
            return 0.0
        w = 3 * (np.sin(kr) / kr ** 3 - np.cos(kr) / kr ** 2)
        return 4 * np.pi * kk * kk * w * w * pk_eval(kk)

    val, _ = quad(integrand, 0, 500.0 / R, limit=500)
    return np.sqrt(val)
