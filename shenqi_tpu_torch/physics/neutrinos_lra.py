"""Massive-neutrino linear response (neutrinos_lra.cpp analog).

Ali-Haimoud & Bird 2013 integral-equation method: follow delta_nu(k)
sourced by the measured total-matter delta(k) history through the
free-streaming kernel

  delta_nu(k,a) = J(k F(a_tr,a)/(m/kT)) delta_nu_init (1 + ...)        (IC)
    + prefac * int dloga' F(a',a)/(a' H(a')) J(k F(a',a)/(m/kT))
                 delta_tot(k,a')

with F the free-streaming length integral and J the Fermi-Dirac-averaged
sinc (fit accurate to 3%).  All host-side float64 (one evaluation per PM
step on ~nk bins — tiny).

The result feeds the PM potential multiplier
  nufac(k) = 1 + prefac * delta_nu(k)/delta_cdm(k)
(gravpm.cpp:412-424) and the saved total power normalization.

A copy of shenqi_tpu/physics/neutrinos_lra.py (host numpy and scipy, no
JAX) so that the PyTorch port imports nothing of the JAX package; `save`
and `load` go through the port's io/bigfile.py and write the same
Neutrino/{Deltas,Scalefact,Wavenum,DeltaNuInit} blocks.
tests/test_torch_neutrinos.py pins it equal.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
from scipy.integrate import quad
from scipy.interpolate import PchipInterpolator

from ..utils.constants import HUBBLE, LIGHTCGS


def specialJ_fit(x):
    """FD-averaged sinc fit (neutrinos_lra.cpp specialJ_fit):
    accurate to <3% rel, 0.07% abs."""
    x = np.asarray(x, dtype=np.float64)
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    out = ((1. + 0.0168 * x2 + 0.0407 * x4)
           / (1. + 2.1734 * x2 + 1.6787 * np.exp(4.1811 * np.log(
               np.maximum(x, 1e-30))) + 0.1467 * x8))
    return np.where(x <= 0, 1.0, out)


FD_NORM = 1.5 * 1.202056903159594    # integral q^2/(e^q+1) dq, 0..inf


def nufrac_low(qc: float) -> float:
    """Mass fraction of the FD distribution below dimensionless
    momentum qc (omega_nu_single.cpp:198): the share of neutrinos a
    hybrid run follows as particles."""
    if qc <= 0:
        return 0.0
    val, _ = quad(lambda q: q * q / (np.exp(q) + 1), 0, qc,
                  epsrel=1e-10, limit=200)
    return val / FD_NORM


def _II(x, qc, n):
    """Asymptotic series term for the truncated FD fourier transform
    (neutrinos_lra.cpp:575, YAH appendix)."""
    from scipy.special import j0
    return ((n * n + n ** 3 * qc + n * qc * x * x - x * x) * qc
            * j0(qc * x)
            + (2 * n + n * n * qc + qc * x * x) * np.cos(qc * x))


def Jfrac_high(x, qc, nufrac_lo):
    """Fourier transform of the q > qc tail of the FD distribution
    (neutrinos_lra.cpp Jfrac_high): the free-streaming kernel when
    the slow neutrinos are followed as particles instead."""
    x = np.asarray(x, np.float64)
    integ = np.zeros_like(x)
    for n in range(1, 20):
        integ += (-((-1.0) ** n) * np.exp(-n * qc)
                  / (n * n + x * x) ** 2 * _II(x, qc, n))
    return integ / (FD_NORM * (1 - nufrac_lo))


def specialJ(x, qc: float = -1.0, nufrac_lo: float = 0.0):
    """Free-streaming kernel; truncated at qc for hybrid runs
    (neutrinos_lra.cpp:603)."""
    if qc > 0:
        return Jfrac_high(x, qc, nufrac_lo)
    return specialJ_fit(x)


def fslength(CP, logai, logaf, light):
    """Free-streaming length x (m/kT) from ai to af, in internal length
    (neutrinos_lra.cpp fslength)."""
    if logai >= logaf:
        return 0.0
    val, _ = quad(lambda loga: 1.0 / np.exp(loga)
                  / (np.exp(loga) * CP.hubble_function(np.exp(loga))),
                  logai, logaf, epsrel=1e-8, limit=100)
    return light * val


@dataclass
class DeltaTotTable:
    """History of total-matter delta(k) + neutrino response state."""

    CP: object
    wavenum: np.ndarray            # [nk] internal units
    time_transfer: float           # a at initialization
    light: float                   # c in internal velocity units
    delta_nu_prefac: float = 0.0
    omeganonu: float = 0.0
    scalefact: List[float] = field(default_factory=list)   # log a
    delta_tot: Optional[np.ndarray] = None   # [nk, Na]
    delta_nu_init: Optional[np.ndarray] = None
    delta_nu_last: Optional[np.ndarray] = None
    # optional per-k delta_nu/delta_cdm IC ratio (from the CLASS
    # transfer table) used at first initialization
    init_ratio: Optional[np.ndarray] = None

    @classmethod
    def create(cls, CP, wavenum, time_transfer, unit_time_in_s,
               unit_velocity) -> "DeltaTotTable":
        light = LIGHTCGS / unit_velocity
        tab = cls(CP=CP, wavenum=np.asarray(wavenum, np.float64),
                  time_transfer=time_transfer, light=light)
        tab.delta_nu_prefac = (1.5 * CP.Omega0 * HUBBLE * HUBBLE
                               * unit_time_in_s ** 2 / light)
        tab.omeganonu = CP.Omega0 - CP.ONu.get_omega_nu(1.0)
        return tab

    def enable_hybrid(self, vcrit_kms: float, nu_crit_time: float,
                      unit_velocity: float):
        """init_hybrid_nu analog; vcrit in km/s at z=0 scale.
        Installs the shared HybridNu on CP.ONu so the background
        (get_omega_nu_nopart) and the response see the same split."""
        from ..cosmology.neutrinos import HybridNu
        self.CP.ONu.hybnu = HybridNu(
            enabled=True, mnu=self.CP.MNu,
            vcrit=vcrit_kms * 1e5, light_internal=LIGHTCGS,
            nu_crit_time=nu_crit_time, kBtnu=self.CP.ONu.kBtnu)

    def particle_nu_fraction(self, a) -> float:
        """Fraction of neutrino mass in N-body particles at a
        (omega_nu_single.cpp:229)."""
        return self.CP.ONu.hybnu.particle_fraction(a, 0)

    @property
    def vcrit_c(self) -> float:
        return self.CP.ONu.hybnu.vcrit

    @property
    def nufrac_lo(self) -> float:
        return float(self.CP.ONu.hybnu.nufrac_low[0])

    def _get_delta_tot(self, delta_nu, delta_cdm, a):
        """neutrinos_lra.cpp:69-73 exactly: the nu share of delta_tot
        shrinks when part of Omega_nu gravitates as particles."""
        onu_a3 = self.CP.ONu.get_omega_nu_nopart(a) * a ** 3
        onu1 = self.CP.ONu.get_omega_nu(1.0)
        partnu = self.particle_nu_fraction(a)
        fcdm = 1 - onu_a3 / (self.omeganonu + onu1)
        return fcdm * (delta_cdm + delta_nu * onu_a3
                       / (self.omeganonu + onu1 * partnu))

    def initialize(self, delta_cdm_init, t_nu_by_t_nonu=1.0):
        """First call: set ICs at time_transfer
        (neutrinos_lra.cpp:103-132)."""
        self.delta_nu_init = (np.asarray(delta_cdm_init, np.float64)
                              * t_nu_by_t_nonu)
        d0 = self._get_delta_tot(self.delta_nu_init, delta_cdm_init,
                                 self.time_transfer)
        self.delta_tot = d0[:, None].copy()
        self.scalefact = [np.log(self.time_transfer)]
        self.delta_nu_last = self.delta_nu_init.copy()

    def get_delta_nu(self, a, mnu):
        """delta_nu(k) for one species of mass mnu at scale factor a."""
        kT = self.CP.ONu.kBtnu
        mnubykT = mnu / kT if kT > 0 else 0.0
        loga_tr = np.log(self.time_transfer)
        loga = np.log(a)
        fsl_a0a = fslength(self.CP, loga_tr, loga, self.light)
        deriv_prefac = (self.time_transfer
                        * (self.CP.hubble_function(self.time_transfer)
                           / self.light) * self.time_transfer)
        # hybrid: once particles carry the slow neutrinos, the LRA
        # integrates only the q > qc tail (neutrinos_lra.cpp:660-668)
        partnu = self.particle_nu_fraction(a)
        qc = self.vcrit_c * mnubykT if partnu > 0 else -1.0
        x = self.wavenum * fsl_a0a / (mnubykT if mnubykT > 0 else 1.0)
        delta_nu = (specialJ(x, qc, self.nufrac_lo)
                    * self.delta_nu_init
                    * (1. + deriv_prefac * fsl_a0a))
        if partnu > 0 and 1 - partnu < 1e-3:
            return delta_nu       # everything is particles

        na = self.delta_tot.shape[1]
        if na > 1 and mnubykT > 0:
            # free-streaming length spline over the history
            nfs = max(na * 16, 32)
            fsscales = np.linspace(loga_tr, loga, nfs)
            fslengths = np.array([fslength(self.CP, la, loga,
                                           self.light)
                                  for la in fsscales])
            fs_sp = PchipInterpolator(fsscales, fslengths)
            logas = np.asarray(self.scalefact)
            for ik, k in enumerate(self.wavenum):
                if na >= 3:
                    dtot_sp = PchipInterpolator(logas,
                                                self.delta_tot[ik])
                else:
                    dtot_sp = lambda x_, ik=ik: np.interp(
                        x_, logas, self.delta_tot[ik])

                def integrand(logai):
                    fsl = float(fs_sp(logai))
                    ai = np.exp(logai)
                    sj = float(specialJ(k * fsl / mnubykT, qc,
                                        self.nufrac_lo))
                    return (fsl / (ai * self.CP.hubble_function(ai))
                            * sj * float(dtot_sp(logai)))

                val, _ = quad(integrand, loga_tr, loga, epsrel=1e-6,
                              limit=200)
                delta_nu[ik] += self.delta_nu_prefac * val
        return delta_nu

    def get_delta_nu_combined(self, a):
        """Degeneracy-weighted combination over massive species."""
        onu_nopart = self.CP.ONu.get_omega_nu_nopart(a)
        total = np.zeros_like(self.wavenum)
        for deg, tabl in zip(self.CP.ONu.nu_degeneracies,
                             self.CP.ONu.tables):
            if tabl.mnu <= 0:
                continue
            omega_i = deg * tabl.rho(a) / self.CP.ONu.rhocrit
            total += (self.get_delta_nu(a, tabl.mnu)
                      * omega_i / max(onu_nopart, 1e-35))
        return total

    def update(self, a, delta_cdm):
        """Per PM step: compute delta_nu and append the new delta_tot
        (update_delta_tot + get_delta_nu_combined protocol)."""
        delta_cdm = np.asarray(delta_cdm, np.float64)
        if self.delta_tot is None:
            r = 1.0 if self.init_ratio is None else self.init_ratio
            self.initialize(delta_cdm, t_nu_by_t_nonu=r)
            return self.delta_nu_last
        loga = np.log(a)
        delta_nu = self.get_delta_nu_combined(a)
        if loga > self.scalefact[-1] + 1e-10:
            dt = self._get_delta_tot(delta_nu, delta_cdm, a)
            self.delta_tot = np.concatenate(
                [self.delta_tot, dt[:, None]], axis=1)
            self.scalefact.append(loga)
        self.delta_nu_last = delta_nu
        return delta_nu

    def save(self, snapdir: str):
        """Write the delta_tot history into a snapshot
        (petaio_save_neutrinos analog, neutrinos_lra.cpp:267): blocks
        Neutrino/{Deltas,Scalefact,Wavenum,DeltaNuInit}."""
        from ..io.bigfile import BigFile
        if self.delta_tot is None:
            return
        bf = BigFile(snapdir)
        nk, na = self.delta_tot.shape

        def put(name, arr):
            arr = np.asarray(arr, np.float64).ravel()
            blk = bf.create_block(f"Neutrino/{name}", "f8", len(arr))
            blk.write(0, arr)
            blk.flush()

        put("Deltas", self.delta_tot)          # row-major [nk, na]
        put("Scalefact", self.scalefact)
        put("Wavenum", self.wavenum)
        put("DeltaNuInit", self.delta_nu_init)

    def load(self, snapdir: str) -> bool:
        """Restore the history written by save(); returns success.
        Resuming without this would restart delta_nu from scratch and
        bias the late-time neutrino suppression."""
        from ..io.bigfile import BigFile
        bf = BigFile(snapdir)
        if "Neutrino/Deltas" not in bf:
            return False
        scale = np.asarray(bf["Neutrino/Scalefact"].read())
        wav = np.asarray(bf["Neutrino/Wavenum"].read())
        deltas = np.asarray(bf["Neutrino/Deltas"].read())
        self.wavenum = wav
        self.scalefact = list(scale)
        self.delta_tot = deltas.reshape(len(wav), len(scale))
        self.delta_nu_init = np.asarray(
            bf["Neutrino/DeltaNuInit"].read())
        self.time_transfer = float(np.exp(scale[0]))
        self.delta_nu_last = self.get_delta_nu_combined(
            float(np.exp(scale[-1])))
        return True

    def potential_factor(self, a, delta_cdm):
        """Multiplier 1 + prefac * delta_nu/delta_cdm for the PM
        potential (gravpm.cpp:202-209,412-424); with hybrid particle
        neutrinos the particle share moves to the denominator."""
        delta_nu = self.delta_nu_last
        onu_nop = self.CP.ONu.get_omega_nu_nopart(a)
        omega_hybrid = (self.CP.ONu.get_omega_nu(1.0)
                        * self.particle_nu_fraction(a) / a ** 3)
        prefac = onu_nop / (self.omeganonu / a ** 3 + omega_hybrid)
        ratio = np.where(np.asarray(delta_cdm) > 0,
                         delta_nu / np.maximum(delta_cdm, 1e-35), 0.0)
        return 1.0 + prefac * ratio
