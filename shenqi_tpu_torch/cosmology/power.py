"""Input linear power spectrum / transfer functions for IC generation.

Equivalent scope to the reference's genic power module (libgenic/power.cpp):
  * tabulated matter power (CAMB/CLASS text files: columns k [h/Mpc],
    P(k) [(Mpc/h)^3]) stored as log10 sqrt(P);
  * Eisenstein & Hu 1998 analytic fallback;
  * normalization by Sigma8 and/or growth from InputPowerRedshift to the
    IC redshift;
  * optional per-species transfer-function ratios and scale-dependent
    velocity growth (CLASS transfer tables).

All host-side float64; the IC generator pulls dense per-mode tables onto
the device afterwards.

A copy of shenqi_tpu/cosmology/power.py (host numpy, no JAX) so that the
PyTorch port imports nothing of the JAX package; tests/test_torch_genic_nu.py
pins the transfer-function readers equal.
"""

from __future__ import annotations

import numpy as np
from dataclasses import dataclass, field
from typing import Optional

from ..utils.constants import CM_PER_MPC, LIGHTCGS
from .background import Cosmology, tophat_sigma

# transfer types (column roles), matching the reference enum order
DELTA_BAR, DELTA_CDM, DELTA_NU, DELTA_CB = 0, 1, 2, 3
VEL_BAR, VEL_CDM, VEL_NU, VEL_CB, VEL_TOT = 4, 5, 6, 7, 8
DELTA_TOT = 9


def eisenstein_hu(k_hmpc, CP: Cosmology):
    """EH98 zero-baryon-wiggle transfer function T(k); k in h/Mpc."""
    omegam = CP.Omega0
    ob = CP.OmegaBaryon
    h = CP.HubbleParam
    theta = CP.CMBTemperature / 2.7
    ommh2 = omegam * h * h
    obh2 = ob * h * h
    # sound horizon (EH98 eq 26)
    s = 44.5 * np.log(9.83 / ommh2) / np.sqrt(1 + 10 * obh2 ** 0.75)
    alpha = (1 - 0.328 * np.log(431 * ommh2) * ob / omegam
             + 0.38 * np.log(22.3 * ommh2) * (ob / omegam) ** 2)
    gamma_eff = omegam * h * (alpha + (1 - alpha)
                              / (1 + (0.43 * k_hmpc * s * h) ** 4))
    q = k_hmpc * theta ** 2 / gamma_eff
    L0 = np.log(2 * np.e + 1.8 * q)
    C0 = 14.2 + 731.0 / (1 + 62.5 * q)
    return L0 / (L0 + C0 * q * q)


@dataclass
class InputPower:
    """sqrt(P(k)) evaluator in internal units.

    delta_spec(k_internal) returns sqrt(P) in internal_length^{3/2},
    multiplied by the normalization (Sigma8 / InputPowerRedshift growth).
    """

    CP: Cosmology
    unit_length_in_cm: float
    logk: Optional[np.ndarray] = None      # log10 k [h/Mpc]
    logD: Optional[np.ndarray] = None      # log10 sqrt(P [(Mpc/h)^3])
    primordial_index: float = 1.0          # EH tilt
    norm: float = 1.0
    # optional per-species transfer ratios T_type/T_tot on self.logk grid
    transfer_ratio: Optional[dict] = None  # {type: np.ndarray}
    growth_ratio: Optional[dict] = None    # {type: np.ndarray} for dlogGrowth
    scale_dep_velocity: bool = False

    @property
    def mpc_scale(self) -> float:
        return CM_PER_MPC / self.unit_length_in_cm

    # ---- constructors ----
    @classmethod
    def from_file(cls, path: str, CP: Cosmology, unit_length_in_cm: float,
                  **kw) -> "InputPower":
        """Read a 'k P(k)' text table (CAMB matterpow / CLASS pk format,
        Mpc/h units)."""
        tab = np.loadtxt(path)
        k, p = tab[:, 0], tab[:, 1]
        if np.any(k < 0):  # table already in log10
            logk, logD = k, p / 2
        else:
            logk, logD = np.log10(k), np.log10(p + 1e-30) / 2
        return cls(CP=CP, unit_length_in_cm=unit_length_in_cm,
                   logk=logk, logD=logD, **kw)

    @classmethod
    def analytic_eh(cls, CP: Cosmology, unit_length_in_cm: float,
                    primordial_index: float = 1.0, **kw) -> "InputPower":
        return cls(CP=CP, unit_length_in_cm=unit_length_in_cm,
                   primordial_index=primordial_index, **kw)

    # ---- normalization ----
    def normalize(self, sigma8: float = -1.0,
                  input_power_redshift: float = -1.0,
                  time_ic: float = 1.0):
        """Set self.norm: rescale to Sigma8 (z=0) and/or evolve the input
        P(k) from input_power_redshift to the IC time with the growth
        factor (libgenic/power.cpp:387-402 semantics)."""
        self.norm = 1.0
        if sigma8 > 0 or input_power_redshift >= 0:
            R8 = 8.0 * self.mpc_scale  # 8 Mpc/h in internal units
            if sigma8 > 0:
                res = self._tophat_sigma(R8)
                if not np.isfinite(res) or res <= 0:
                    raise ValueError(f"cannot normalize to sigma8: {res}")
                self.norm = sigma8 / res
            if input_power_redshift >= 0:
                dplus = self.CP.growth_factor(
                    time_ic, 1.0 / (1 + input_power_redshift))
                self.norm *= dplus
        return self

    def _tophat_sigma(self, R_internal: float) -> float:
        # Kept as in shenqi_tpu/cosmology/power.py:116-126: the k grid
        # starts at mpc_scale * 1e-5 where 1e-5 / mpc_scale (1e-5 h/Mpc
        # in internal units) was meant, so a Sigma8 normalization comes
        # out ~1e3 too high with kpc units.  The port matches the
        # reference and does not fix it; a fix belongs in both packages.
        kmax = 500.0 / R_internal
        k = np.logspace(np.log10(self.mpc_scale * 1e-5),
                        np.log10(kmax), 4096)
        d = self.delta_spec(k)
        # integrate 4 pi /(2 pi)^3 k^2 W^2 delta^2 dk
        kr = R_internal * k
        w = np.where(kr > 1e-8,
                     3 * (np.sin(kr) / kr ** 3 - np.cos(kr) / kr ** 2), 1.0)
        integrand = (4 * np.pi / (2 * np.pi) ** 3 * k * k * (w * d) ** 2)
        return np.sqrt(np.trapezoid(integrand, k))

    # ---- evaluation ----
    def delta_spec(self, k_internal, ttype: int = DELTA_TOT) -> np.ndarray:
        """sqrt(P(k)) in internal units; k in internal (e.g. h/kpc)."""
        k_internal = np.asarray(k_internal, dtype=np.float64)
        k_hmpc = k_internal * self.mpc_scale
        safe = np.where(k_hmpc > 0, k_hmpc, 1.0)
        if self.logk is not None:
            logk = np.log10(safe)
            lo, hi = self.logk[0], self.logk[-1]
            intlogk = np.clip(logk, lo, hi)
            logD = np.interp(intlogk, self.logk, self.logD)
            # beyond the table: P ~ k^-3 log^2(k) like the reference
            logD = logD + np.where(
                logk > hi,
                -1.5 * (logk - intlogk)
                + 0.5 * np.log10(np.maximum(logk, 1e-10)
                                 / np.maximum(intlogk, 1e-10)),
                0.0)
            delta_mpc = 10.0 ** logD
            if self.transfer_ratio and ttype in self.transfer_ratio:
                tr = np.interp(intlogk, self.logk,
                               self.transfer_ratio[ttype])
                delta_mpc = delta_mpc * tr
        else:
            # EH analytic: Delta = sqrt(k T^2(k) k^{n-1}); normalization
            # entirely from sigma8
            t = eisenstein_hu(safe, self.CP)
            delta_mpc = np.sqrt(
                safe * t * t * safe ** (self.primordial_index - 1.0))
        # (Mpc/h)^{3/2} -> internal^{3/2}
        out = delta_mpc * self.mpc_scale ** 1.5 * self.norm
        return np.where(k_hmpc > 0, out, 0.0)

    def load_transfer(self, path: str, time_ic: float):
        """Load a CLASS transfer table ('extra metric transfer
        functions=y' format, 22 columns) and build per-species
        delta/velocity ratios relative to the total
        (libgenic/power.cpp parse_transfer + init_transfer_table).
        """
        tab = np.loadtxt(path)
        ncol = tab.shape[1]
        defld = 1 if ncol > 22 else 0
        nnu = int(round((ncol - 1 - 15 - defld * 2) / 2))
        k = tab[:, 0]
        t = tab[:, 1:]
        CP = self.CP

        d_bar = -t[:, 1]
        d_cdm = -t[:, 2]
        d_nu = np.zeros_like(k)
        onu = CP.ONu.get_omega_nu(time_ic)
        for j in range(nnu):
            om_j = (CP.ONu.nu_degeneracies[min(
                j, len(CP.ONu.nu_degeneracies) - 1)]
                * CP.ONu.tables[min(j, len(CP.ONu.tables) - 1)].rho(
                    time_ic) / CP.ONu.rhocrit)
            d_nu += -t[:, 4 + j + defld] * om_j
        if onu > 0:
            d_nu /= onu
        v_bar = t[:, 12 + nnu + defld].copy()
        v_cdm = 0.5 * t[:, 8 + nnu + defld]
        v_nu = np.zeros_like(k)
        for j in range(nnu):
            om_j = (CP.ONu.nu_degeneracies[min(
                j, len(CP.ONu.nu_degeneracies) - 1)]
                * CP.ONu.tables[min(j, len(CP.ONu.tables) - 1)].rho(
                    time_ic) / CP.ONu.rhocrit)
            v_nu += t[:, 13 + nnu + defld * 2 + j] * om_j
        if onu > 0:
            v_nu /= onu

        # velocity normalization: / (a H(a)/H0 * 100 h / c[km/s])
        fac = (time_ic * CP.hubble_function(time_ic) / CP.Hubble
               * 100 * CP.HubbleParam / (LIGHTCGS / 1e5))
        v_cdm /= fac
        v_bar /= fac
        v_nu /= fac
        v_bar += v_cdm
        v_nu += v_cdm

        omega0a3 = CP.OmegaBaryon + CP.OmegaCDM
        d_cb = (CP.OmegaBaryon * d_bar + CP.OmegaCDM * d_cdm) / omega0a3
        v_cb = (CP.OmegaBaryon * v_bar + CP.OmegaCDM * v_cdm) / omega0a3
        onua3 = onu * time_ic ** 3
        t_tot = (CP.OmegaBaryon * d_bar + CP.OmegaCDM * d_cdm)
        v_tot = (CP.OmegaBaryon * v_bar + CP.OmegaCDM * v_cdm)
        omega_tot = omega0a3
        # neutrinos enter the totals only when MASSIVE
        # (init_transfer_table counts nnu from CP->MNu, power.cpp:285)
        if sum(CP.MNu) > 0 and onu > 0:
            t_tot = t_tot + onua3 * d_nu
            v_tot = v_tot + onua3 * v_nu
            omega_tot = omega0a3 + onua3
        t_tot /= omega_tot
        v_tot /= omega_tot

        safe = np.where(np.abs(t_tot) > 0, t_tot, 1.0)
        self.transfer_ratio = {
            DELTA_BAR: d_bar / safe, DELTA_CDM: d_cdm / safe,
            DELTA_NU: d_nu / safe, DELTA_CB: d_cb / safe}
        self.growth_ratio = {
            VEL_BAR: v_bar / safe, VEL_CDM: v_cdm / safe,
            VEL_NU: v_nu / safe, VEL_CB: v_cb / safe,
            VEL_TOT: v_tot / safe}
        self._transfer_logk = np.log10(k)
        # re-grid the ratios onto the power table's logk grid
        if self.logk is not None:
            for d in (self.transfer_ratio, self.growth_ratio):
                for key in d:
                    d[key] = np.interp(self.logk, self._transfer_logk,
                                       d[key])
        else:
            self.logk = self._transfer_logk
        self.scale_dep_velocity = True
        return self

    def dlog_growth(self, k_internal, ttype: int = DELTA_TOT) -> np.ndarray:
        """Scale-dependent velocity factor sqrt(P)*f(k) (VEL_* columns).
        Falls back to delta_spec when no transfer table is loaded."""
        if not self.scale_dep_velocity or not self.growth_ratio:
            return self.delta_spec(k_internal)
        k_internal = np.asarray(k_internal, dtype=np.float64)
        k_hmpc = k_internal * self.mpc_scale
        vtype = ttype
        if DELTA_BAR <= ttype <= DELTA_CB:
            vtype = VEL_BAR + (ttype - DELTA_BAR)
        else:
            vtype = VEL_TOT
        base = self.delta_spec(k_internal, DELTA_TOT)
        logk = np.log10(np.where(k_hmpc > 0, k_hmpc, 1.0))
        intlogk = np.clip(logk, self.logk[0], self.logk[-1])
        gr = np.interp(intlogk, self.logk, self.growth_ratio[vtype])
        return base * gr
