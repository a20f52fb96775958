"""QSO-driven HeII -> HeIII reionization (cooling_qso_lightup.cpp
analog; shenqi_tpu/physics/helium_reion.py copied, host numpy).

Model: between heIIIreion_start and the end of the supplied history
table, quasars light up sequentially inside FOF halos in a chosen mass
band.  Each quasar instantly ionizes (flags HeIII) and heats all gas
within a Gaussian-random bubble radius around the halo center until
the global HeIII fraction tracks the tabulated history; once the
desired fraction exceeds heIIIreion_finish_frac, all remaining gas is
flash-ionized.  Not-yet-ionized gas additionally receives the uniform
long-mean-free-path photon heating from the third table column.

Host-side driver (quasars are rare events at FOF cadence); the bubble
membership test and heating are vectorized numpy over the gas.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..utils.constants import (GAMMA_MINUS1, HYDROGEN_MASSFRAC,
                               PROTONMASS)

E0_HEII = 54.4         # HeII ionization potential, eV
HEMASS = 4.002602      # helium mass, amu
EV_IN_ERGS = 1.60218e-12


def q_inst(emax_ev: float, alpha_q: float) -> float:
    """Mean instantaneous heating per ionization from short-mean-free-
    path photons, in ergs (cooling_qso_lightup.cpp:113-121)."""
    intflux = ((emax_ev ** (-alpha_q + 1) - E0_HEII ** (-alpha_q + 1))
               / (emax_ev ** -alpha_q - E0_HEII ** -alpha_q))
    return EV_IN_ERGS * (alpha_q / (alpha_q - 1.0) * intflux - E0_HEII)


@dataclass
class QSOLightupParams:
    QSOLightupOn: bool = True
    qso_candidate_min_mass: float = 100.0   # internal mass units
    qso_candidate_max_mass: float = 1000.0  # params.cpp:300 default
    mean_bubble: float = 20000.0            # internal length units
    var_bubble: float = 1e6
    heIIIreion_finish_frac: float = 0.995   # params.cpp QSOHeIIIReionFinishFrac


@dataclass
class HeliumReion:
    """Reionization history + sequential quasar driver state."""

    par: QSOLightupParams
    a_hist: np.ndarray            # increasing scale factors
    xheiii: np.ndarray            # target HeIII fraction
    lmfp: np.ndarray              # uniform heating, erg/s/cm^3
    inst_heating: float           # ergs per He atom
    events: list = field(default_factory=list)

    @classmethod
    def load(cls, path: str, par: Optional[QSOLightupParams] = None
             ) -> "HeliumReion":
        """Parse the reionization history text file: spectral index,
        threshold energy, then (redshift, XHeIII, LMFP heating) rows
        (cooling_qso_lightup.cpp:123-183; example:
        examples/HeIIReionizationTable)."""
        alpha_q = None
        emax = None
        rows = []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts or parts[0].startswith("#"):
                    continue
                if alpha_q is None:
                    alpha_q = float(parts[0])
                elif emax is None:
                    emax = float(parts[0])
                else:
                    z, xhe, lm = (float(parts[0]), float(parts[1]),
                                  float(parts[2]))
                    rows.append((1.0 / (1.0 + z), xhe, lm))
        if len(rows) <= 2:
            raise ValueError(f"reionization history {path} too short")
        rows.sort(key=lambda r: r[0])
        arr = np.array(rows)
        return cls(par=par or QSOLightupParams(), a_hist=arr[:, 0],
                   xheiii=arr[:, 1], lmfp=arr[:, 2],
                   inst_heating=q_inst(emax, alpha_q))

    @property
    def start_redshift(self) -> float:
        return 1.0 / self.a_hist[0] - 1.0

    def desired_ion_frac(self, atime: float) -> float:
        return float(np.interp(atime, self.a_hist, self.xheiii))

    def during(self, redshift: float) -> bool:
        if not self.par.QSOLightupOn:
            return False
        if redshift > self.start_redshift:
            return False
        return redshift >= 1.0 / self.a_hist[-1] - 1.0

    def lmfp_heating_per_gram(self, redshift: float,
                              rho_crit_baryon_cgs: float) -> float:
        """Uniform long-MFP heating for NOT-yet-ionized gas, erg/s/g
        (cooling.cpp:46-50 conversion by the mean baryon density)."""
        if not self.during(redshift):
            return 0.0
        atime = 1.0 / (1.0 + redshift)
        h = float(np.interp(atime, self.a_hist, self.lmfp))
        return h / (rho_crit_baryon_cgs * (1 + redshift) ** 3)

    def delta_entropy(self, density, a3inv, uu_in_cgs):
        """Entropy increment for a newly HeIII-ionized particle
        (ionize_single_particle math)."""
        nheperg = (1 - HYDROGEN_MASSFRAC) / (PROTONMASS * HEMASS)
        deltau = self.inst_heating * nheperg        # erg/g
        entropytou = (np.maximum(density, 1e-35)
                      * a3inv) ** GAMMA_MINUS1 / GAMMA_MINUS1
        return deltau / uu_in_cgs / entropytou

    def turn_on_quasars(self, rng: np.random.RandomState, atime: float,
                        group_masses, group_cm, gas_pos, gas_density,
                        gas_alive, heiii_flag, entropy, boxsize,
                        uu_in_cgs):
        """One reionization update at FOF cadence.

        Mutates nothing: returns (heiii_flag', entropy', n_ionized).
        group_masses/group_cm: FOF catalog arrays; gas_pos in internal
        length units.  Mirrors turn_on_quasars (sequential bubbles,
        flash finish, candidate-without-replacement).
        """
        heiii = np.array(heiii_flag, dtype=bool)
        ent = np.array(entropy, dtype=np.float32)
        alive = np.asarray(gas_alive, dtype=bool)
        dens = np.asarray(gas_density)
        n_gas = max(int(alive.sum()), 1)
        desired = self.desired_ion_frac(atime)
        a3inv = 1.0 / atime ** 3

        def ionize(rows):
            fresh = rows & alive & ~heiii
            if not fresh.any():
                return 0
            ent[fresh] += self.delta_entropy(dens[fresh], a3inv,
                                             uu_in_cgs)
            heiii[fresh] = True
            return int(fresh.sum())

        total = 0
        if desired > self.par.heIIIreion_finish_frac:
            total += ionize(np.ones_like(heiii))
            return heiii, ent, total

        cur = heiii[alive].sum() / n_gas
        cand = np.nonzero(
            (np.asarray(group_masses) > self.par.qso_candidate_min_mass)
            & (np.asarray(group_masses)
               < self.par.qso_candidate_max_mass))[0]
        cand = list(cand)
        pos = np.asarray(gas_pos)
        cm = np.asarray(group_cm)
        it = 0
        while cur < desired and cand and it < 10000:
            it += 1
            pick = cand.pop(rng.randint(len(cand)))
            bubble = rng.normal(self.par.mean_bubble,
                                np.sqrt(self.par.var_bubble))
            if bubble <= 0:
                continue
            d = pos - cm[pick]
            d -= boxsize * np.round(d / boxsize)
            inside = (d * d).sum(axis=1) < bubble * bubble
            n = ionize(inside)
            total += n
            cur += n / n_gas
            self.events.append((atime, tuple(cm[pick]), cur, n))
        return heiii, ent, total
