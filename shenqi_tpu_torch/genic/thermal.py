"""Thermal velocities for neutrino/WDM particles (libgenic/thermal.cpp).

Samples speeds from the relativistic Fermi-Dirac distribution
  f(v) dv ~ v^2 / (exp(v/v_amp) + 1) dv
with v_amp the characteristic thermal velocity today scaled to the IC
redshift, and adds them with isotropic random directions.

  NU_V0  = 150 (1+z) (1 eV/m_nu) * (T_nu/T_gamma0 scaling) km/s
  WDM_V0 = thermal WDM velocity from the Bode et al 2001 scaling.

A copy of shenqi_tpu/genic/thermal.py (host numpy, no JAX) so that the
PyTorch port imports nothing of the JAX package;
tests/test_torch_genic_nu.py pins its draws equal, bit for bit.
"""

from __future__ import annotations

import numpy as np

from ..utils.constants import BOLEVK, TNUCMB, LIGHTCGS

MAX_FERMI_DIRAC = 17.0


def NU_V0(redshift: float, mnu_ev: float,
          unit_velocity_cm_s: float) -> float:
    """Characteristic neutrino thermal velocity at z (internal units).

    v = kT_nu/m_nu c (1+z) — thermal.h:20-30 convention:
    150 km/s (1+z) (1.5/TNu...)  Using the exact kT form."""
    if mnu_ev <= 0:
        return 0.0
    kt_nu_ev = BOLEVK * TNUCMB * 2.7255
    v_cms = (kt_nu_ev / mnu_ev) * LIGHTCGS * (1 + redshift)
    return v_cms / unit_velocity_cm_s


def WDM_V0(redshift: float, mwdm_kev: float, omega_wdm: float,
           hubble: float, unit_velocity_cm_s: float) -> float:
    """Bode, Ostriker & Turok 2001 eq. A9 WDM thermal velocity."""
    if mwdm_kev <= 0:
        return 0.0
    v_kms = (0.012 * (1 + redshift)
             * (omega_wdm / 0.3) ** (1.0 / 3)
             * (hubble / 0.65) ** (2.0 / 3)
             * (1.0 / mwdm_kev) ** (4.0 / 3))
    return v_kms * 1e5 / unit_velocity_cm_s


class FermiDiracSampler:
    """Inverse-CDF sampler for the FD speed distribution."""

    NBINS = 2048

    def __init__(self, v_amp: float, max_v: float = None):
        self.v_amp = v_amp
        # full-range table (for nufrac: mass fraction below the cap)
        x = np.linspace(0, MAX_FERMI_DIRAC, self.NBINS)
        pdf = x * x / (np.exp(x) + 1)
        cdf = np.cumsum(pdf)
        cdf /= cdf[-1]
        self.x = x
        self.cdf = cdf
        self.max_v = max_v
        # sampling table TRUNCATED at the cap (libgenic/thermal.cpp
        # init_thermalvel builds the CDF only up to max_fd): particles
        # sample the conditional distribution below max_v, rather than
        # clamping — clamping would pile the excluded tail's mass at
        # exactly the cap speed.
        xcap = MAX_FERMI_DIRAC
        if max_v is not None and v_amp > 0:
            xcap = min(max_v / v_amp, MAX_FERMI_DIRAC)
        xs = np.linspace(0, xcap, self.NBINS)
        pdfs = xs * xs / (np.exp(xs) + 1)
        cdfs = np.cumsum(pdfs)
        cdfs /= cdfs[-1]
        self._x_samp = xs
        self._cdf_samp = cdfs

    def sample_speeds(self, rng: np.random.RandomState, n: int):
        u = rng.uniform(0, 1, n)
        return np.interp(u, self._cdf_samp, self._x_samp) * self.v_amp

    def mean_speed(self) -> float:
        """<v> = v_amp * int x^3 f / int x^2 f = v_amp * 3.151..."""
        x = self.x
        pdf = x * x / (np.exp(x) + 1)
        return self.v_amp * float((x * pdf).sum() / pdf.sum())

    def nufrac(self) -> float:
        """Fraction of the FD distribution below max_v — the share of
        neutrino MASS carried by particles when velocities are capped
        (init_thermalvel's return, libgenic/thermal.cpp)."""
        if self.max_v is None:
            return 1.0
        xcap = min(self.max_v / max(self.v_amp, 1e-300),
                   MAX_FERMI_DIRAC)
        x = self.x
        pdf = x * x / (np.exp(x) + 1)
        return float(pdf[x <= xcap].sum() / pdf.sum())


def add_thermal_speeds(vel: np.ndarray, rng: np.random.RandomState,
                       v_amp: float, max_v: float = None) -> np.ndarray:
    """Add isotropic FD thermal velocities to vel (in place copy)."""
    n = len(vel)
    sampler = FermiDiracSampler(v_amp, max_v)
    speeds = sampler.sample_speeds(rng, n)
    # isotropic directions
    mu = rng.uniform(-1, 1, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    s = np.sqrt(1 - mu * mu)
    dirs = np.stack([s * np.cos(phi), s * np.sin(phi), mu], axis=-1)
    return vel + speeds[:, None] * dirs
