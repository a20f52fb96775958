"""Star formation: Springel & Hernquist 2003 effective EOS (sfr_eff.cpp
analog; shenqi_tpu/physics/sfr.py in torch).

The multiphase subgrid model: above the physical density threshold, gas
is a two-phase medium of cold clouds (mass fraction x = cloudfrac) and
hot SN-heated ambient gas.  Star formation converts cloud mass on the
timescale tsfr = MaxSfrTimescale sqrt(rho_th/rho); the entropy relaxes
toward the effective EOS on trelax.  Star particles spawn
probabilistically with mass m*/Generations.

`CoolingUnits` and `SFRParams` are host float64 (copies of the JAX
package's), `SFRParams.init` runs its one cooling-time evaluation on
host f32 tensors as the JAX package runs it eagerly.  The per-particle
work is f32 torch ops on the caller's device.  The cooling solves run
only on the rows whose results the step keeps (the eEOS cooling time
on the rows on the effective EOS, the implicit solver on the active
gas off it): each is elementwise, so the kept values are the ones a
pass over every row gives, as the JAX package computes them.  Each
subset costs one host sync.  The random draws are the JAX package's
(`utils/threefry.py`, and the id hash of physics/winds.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..utils.constants import (GAMMA_MINUS1, BOLTZMANN, PROTONMASS,
                               HYDROGEN_MASSFRAC, SOLAR_MASS,
                               SEC_PER_YEAR)
from ..utils import threefry
from .cooling_rates import (UVBG, CoolingParams, heatingcooling_rate,
                            do_cooling, uvbg_take)

METAL_YIELD = 0.02


@dataclass
class CoolingUnits:
    """Internal <-> cgs conversions for the cooling calls
    (cooling.cpp coolunits)."""
    density_in_phys_cgs: float   # internal density -> g/cm^3 (physical)
    uu_in_cgs: float             # internal specific energy -> erg/g
    tt_in_s: float               # internal time -> s

    @classmethod
    def create(cls, units, hubble_param):
        return cls(
            density_in_phys_cgs=units.UnitDensity_in_cgs
            * hubble_param ** 2,
            uu_in_cgs=units.UnitInternalEnergy_in_cgs,
            tt_in_s=units.UnitTime_in_s / hubble_param)


def entropy_to_u(density, a3inv):
    """Entropy A -> specific internal energy at physical density."""
    return (density * a3inv) ** GAMMA_MINUS1 / GAMMA_MINUS1


def get_cooling_time(redshift, u_internal, rho_internal, uvbg: UVBG,
                     cp: CoolingParams, cu: CoolingUnits, ne_init=None,
                     helium=1 - HYDROGEN_MASSFRAC):
    """Cooling time in internal units; 0 where net heating
    (cooling.cpp GetCoolingTime)."""
    rho_cgs = rho_internal * cu.density_in_phys_cgs
    u_cgs = u_internal * cu.uu_in_cgs
    lam, ne = heatingcooling_rate(rho_cgs, u_cgs, helium, redshift, uvbg,
                                  cp, ne_init)
    tcool = torch.where(lam < 0, u_cgs / torch.clamp(-lam, min=1e-35), 0.0)
    return tcool / cu.tt_in_s, ne


@dataclass
class SFRParams:
    CritOverDensity: float = 57.7
    CritPhysDensity: float = 0.0        # H atoms/cm^3; 0 -> derive
    FactorSN: float = 0.1
    FactorEVP: float = 1000.0
    TempSupernova: float = 1e8
    TempClouds: float = 1000.0
    MaxSfrTimescale: float = 1.5
    Generations: int = 4
    MinGasTemp: float = 5.0
    QuickLymanAlphaProbability: float = 0.0
    QuickLymanAlphaTempThresh: float = 1e5
    # StarformationCriterion bits (sfr_eff.h:17-19): 1=density,
    # 3=density+h2 (Krumholz-Gnedin molecular fraction)
    Criterion: int = 1
    # eEOS gas heated far above the EOS relaxes on the COOLING time
    # instead of trelax (sfr_eff.cpp:641-662, params.cpp:258):
    # 1 = BH-heated or u > 5e6 gas, 3 = all eEOS gas
    BHFeedbackUseTcool: int = 1
    # derived (init())
    temp_to_u: float = 0.0
    EgySpecCold: float = 0.0
    EgySpecSN: float = 0.0
    OverDensThresh: float = 0.0
    PhysDensThresh: float = 0.0
    UnitSfr_in_solar_per_year: float = 0.0
    avg_baryon_mass: float = 0.0
    tau_fmol_unit: float = 0.0

    def init(self, CP, units, avg_baryon_mass, uvbg0: UVBG,
             coolpar: CoolingParams):
        """Derived thresholds (init_cooling_and_star_formation math)."""
        cu = CoolingUnits.create(units, CP.HubbleParam)
        self.temp_to_u = ((1.0 / GAMMA_MINUS1)
                          * (BOLTZMANN / PROTONMASS)
                          / units.UnitInternalEnergy_in_cgs)
        self.UnitSfr_in_solar_per_year = (
            (units.UnitMass_in_g / SOLAR_MASS)
            / (units.UnitTime_in_s / SEC_PER_YEAR))
        self.avg_baryon_mass = avg_baryon_mass
        self.OverDensThresh = (self.CritOverDensity * CP.OmegaBaryon
                               * CP.RhoCrit)
        # column-density unit for the H2 fit (sfr_eff.cpp:196)
        self.tau_fmol_unit = (units.UnitDensity_in_cgs
                              * CP.HubbleParam
                              * units.UnitLength_in_cm)
        mw_neutral = 4.0 / (1 + 3 * HYDROGEN_MASSFRAC)
        self.EgySpecCold = (self.temp_to_u / mw_neutral
                            * self.TempClouds)
        mw_ion = 4 / (8 - 5 * (1 - HYDROGEN_MASSFRAC))
        self.EgySpecSN = self.temp_to_u / mw_ion * self.TempSupernova

        self.PhysDensThresh = (self.CritPhysDensity * PROTONMASS
                               / HYDROGEN_MASSFRAC
                               / (units.UnitMass_in_g
                                  / units.UnitLength_in_cm ** 3))
        if self.PhysDensThresh == 0:
            # derive self-consistently at z=0, no UVB, like the reference
            egyhot = self.EgySpecSN / self.FactorEVP
            u4 = self.temp_to_u / mw_ion * 1.0e4
            dens = 1.0e6 * CP.RhoCrit
            f32 = torch.float32
            tcool, _ = get_cooling_time(
                0.0, torch.tensor([egyhot], dtype=f32),
                torch.tensor([dens], dtype=f32), UVBG(), coolpar, cu,
                ne_init=torch.tensor([1.0], dtype=f32))
            tcool = float(tcool[0])
            coolrate = egyhot / tcool / dens
            x = (egyhot - u4) / (egyhot - self.EgySpecCold)
            self.PhysDensThresh = (
                x / (1 - x) ** 2
                * (self.FactorSN * self.EgySpecSN
                   - (1 - self.FactorSN) * self.EgySpecCold)
                / (self.MaxSfrTimescale * coolrate))
        return self

    def min_egyspec(self):
        mw_neutral = 4.0 / (1 + 3 * HYDROGEN_MASSFRAC)
        return self.temp_to_u / mw_neutral * self.MinGasTemp


class EEQOSData(NamedTuple):
    on_eeqos: torch.Tensor    # bool — gas on the effective EOS
    tsfr: torch.Tensor
    egyhot: torch.Tensor
    cloudfrac: torch.Tensor
    trelax: torch.Tensor
    ne: torch.Tensor


def sfreff_on_eeqos(density, egywt_density, a3inv, sp: SFRParams):
    """Is this gas on the effective EOS? (sfr_eff.cpp:502-527)."""
    return (density * a3inv >= sp.PhysDensThresh) \
        & (density >= sp.OverDensThresh)


def _cooling_time_on(mask, redshift, u, rho, uvbg, cp, cu, ne, fill):
    """get_cooling_time on the rows of `mask` (one host sync); the other
    rows take `fill` (tcool) and `ne` (ne)."""
    sel = torch.nonzero(mask).squeeze(1)
    tcool = torch.full_like(u, fill)
    ne_out = ne.clone()
    if sel.numel():
        t_, n_ = get_cooling_time(redshift, u[sel], rho[sel],
                                  uvbg_take(uvbg, sel), cp,
                                  cu, ne_init=ne[sel])
        tcool[sel] = t_
        ne_out[sel] = n_
    return tcool, ne_out


def get_sfr_eeqos(density, ne, metallicity, dtime, a3inv, redshift,
                  uvbg: UVBG, sp: SFRParams, coolpar: CoolingParams,
                  cu: CoolingUnits, on_eeqos) -> EEQOSData:
    """Vectorized eEOS parameters (sfr_eff.cpp get_sfr_eeqos); the
    cooling time of the hot phase only where on_eeqos."""
    physdens = density * a3inv
    rel_dens = torch.clamp(physdens / sp.PhysDensThresh, min=1e-10)
    tsfr = torch.sqrt(1.0 / rel_dens) * sp.MaxSfrTimescale
    tsfr = torch.where((tsfr < dtime) & (dtime > 0), dtime, tsfr)
    factor_evp = rel_dens ** (-0.8) * sp.FactorEVP
    egyhot = sp.EgySpecSN / (1 + factor_evp) + sp.EgySpecCold

    tcool, ne_new = _cooling_time_on(on_eeqos, redshift, egyhot,
                                     physdens, uvbg, coolpar, cu, ne,
                                     1.0)
    tcool = torch.clamp(tcool, min=1e-30)
    y = (tsfr / tcool * egyhot
         / (sp.FactorSN * sp.EgySpecSN
            - (1 - sp.FactorSN) * sp.EgySpecCold))
    y = torch.clamp(y, min=1e-10)
    cloudfrac = 1 + 1 / (2 * y) - torch.sqrt(1 / y + 1 / (4 * y * y))
    cloudfrac = torch.clamp(cloudfrac, 0.0, 1.0)
    trelax = (tsfr * (1 - cloudfrac) / torch.clamp(cloudfrac, min=1e-10)
              / (sp.FactorSN * (1 + factor_evp)))
    zero = torch.zeros_like(density)
    return EEQOSData(
        on_eeqos=on_eeqos,
        tsfr=torch.where(on_eeqos, tsfr, sp.MaxSfrTimescale),
        egyhot=torch.where(on_eeqos, egyhot, sp.EgySpecCold),
        cloudfrac=torch.where(on_eeqos, cloudfrac, zero),
        trelax=torch.where(on_eeqos, trelax, sp.MaxSfrTimescale),
        ne=torch.where(on_eeqos, ne_new, ne))


def sfr_factor_due_to_h2(gradrho_mag, hsml, density, metallicity,
                         atime, sp: SFRParams):
    """Krumholz & Gnedin (2011) molecular-fraction SFR multiplier
    (sfr_eff.cpp get_sfr_factor_due_to_h2 / ev_NH_from_GradRho)."""
    a2 = atime * atime
    zoverzsun = metallicity / METAL_YIELD
    ev_nh = torch.where(gradrho_mag > 0,
                        density * density
                        / torch.clamp(gradrho_mag, min=1e-35), 0.0)
    ev_nh = ev_nh + density * hsml
    tau_fmol = ev_nh / a2 * (0.1 + zoverzsun)
    tau_fmol = tau_fmol * (434.78 * sp.tau_fmol_unit)
    y = 0.756 * (1 + 3.1 * torch.clamp(zoverzsun, min=1e-30) ** 0.365)
    y = torch.log(1 + 0.6 * y + 0.01 * y * y) \
        / (0.6 * torch.clamp(tau_fmol, min=1e-35))
    y = 1 - 0.75 * y / (1 + 0.25 * y)
    y = torch.clamp(y, 0.0, 1.0)
    return torch.where(tau_fmol > 0, y, 1.0)


class SFResult(NamedTuple):
    sfr: torch.Tensor            # Msun/yr per particle
    entropy: torch.Tensor        # updated entropy (relaxed / cooled)
    ne: torch.Tensor
    metallicity: torch.Tensor
    form_star: torch.Tensor      # bool — particle spawns/converts a star
    mass_of_star: torch.Tensor   # stellar mass to take
    convert_whole: torch.Tensor  # bool — convert whole particle (vs split)


def starformation_step(key, density, egywt_density, entropy, mass, ne,
                       metallicity, generation, dtime, a3inv, redshift,
                       uvbg: UVBG, sp: SFRParams, coolpar: CoolingParams,
                       cu: CoolingUnits, is_gas, gradrho_mag=None,
                       hsml=None, pids=None, bh_heated=None,
                       extra_heat=0.0) -> SFResult:
    """One SF + cooling source step for all gas (vectorized).

    Implements cooling_and_starformation's per-particle work
    (sfr_eff.cpp:200-330, 700-770): eEOS gas relaxes toward the
    effective EOS and forms stars stochastically; other gas cools
    radiatively (do_cooling).  key: a threefry key (utils/threefry.py);
    pids: int32 bit patterns of the low id words, whose draws key the
    metals and the spawning as the JAX package's `pids` path does.
    """
    from .winds import idhash_uniform
    on = sfreff_on_eeqos(density, egywt_density, a3inv, sp) & is_gas
    data = get_sfr_eeqos(density, ne, metallicity, dtime, a3inv,
                         redshift, uvbg, sp, coolpar, cu, on)

    # --- star formation rate ---
    cloudmass = data.cloudfrac * mass
    rate = (1 - sp.FactorSN) * cloudmass / torch.clamp(data.tsfr,
                                                       min=1e-30)
    # molecular-H2 criterion (sfr_eff.cpp:821-825)
    if (sp.Criterion & 2) and gradrho_mag is not None \
            and hsml is not None:
        atime = (1.0 / a3inv) ** (1.0 / 3.0)
        rate = rate * sfr_factor_due_to_h2(
            gradrho_mag, hsml, density, metallicity, atime, sp)
    rate = torch.where(on, rate, 0.0)
    sm = rate * dtime
    p = sm / torch.clamp(mass, min=1e-30)
    frac = 1 - torch.exp(-p)
    dM = mass * frac
    sfr_out = torch.where(dtime > 0, dM / torch.clamp(dtime, min=1e-30),
                          rate) * sp.UnitSfr_in_solar_per_year

    # --- entropy update ---
    # PLAIN density for the entropy<->u conversion, like the
    # reference (sfr_eff.cpp:637 entropy_to_u(SPHP(i).Density))
    densityfac = entropy_to_u(torch.clamp(density, min=1e-35), a3inv)
    egycurrent = entropy * densityfac
    # relaxed cooling for eEOS gas
    egyeff = (sp.EgySpecCold * data.cloudfrac
              + (1 - data.cloudfrac) * data.egyhot)
    # gas heated far above the EOS relaxes on the cooling time
    # (sfr_eff.cpp:641-667)
    trelax_eff = data.trelax
    if sp.BHFeedbackUseTcool in (1, 3):
        if sp.BHFeedbackUseTcool == 3:
            gate = torch.ones_like(on)
        else:
            heated = bh_heated if bh_heated is not None \
                else torch.zeros_like(on)
            gate = heated | (egycurrent > 5e6)
        # only the eEOS rows' cooling time is read (`use` below)
        tcool_cur, _ = _cooling_time_on(
            on, redshift, egycurrent, density * a3inv, uvbg, coolpar,
            cu, ne, 0.0)
        use = (on & gate & (egycurrent > egyeff)
               & (tcool_cur > 0) & (tcool_cur < data.trelax))
        trelax_eff = torch.where(use, tcool_cur, data.trelax)
    relaxfac = torch.exp(-dtime / torch.clamp(trelax_eff, min=1e-30))
    egy_relaxed = egyeff + (egycurrent - egyeff) * relaxfac
    # direct radiative cooling for the active gas off the eEOS
    upd = is_gas & (dtime > 0)
    cool = torch.nonzero(upd & ~on).squeeze(1)
    egy_new = egy_relaxed.clone()
    ne_cool = ne.clone()
    if cool.numel():
        u_cgs = egycurrent[cool] * cu.uu_in_cgs
        rho_cgs = density[cool] * a3inv * cu.density_in_phys_cgs
        min_egy_cgs = sp.min_egyspec() * cu.uu_in_cgs
        u_cooled_cgs, ne_c = do_cooling(
            u_cgs, rho_cgs, dtime[cool] * cu.tt_in_s,
            1 - HYDROGEN_MASSFRAC, redshift, uvbg_take(uvbg, cool),
            coolpar, min_egyspec_cgs=min_egy_cgs, ne_init=ne[cool],
            extra_heat=(extra_heat[cool] if torch.is_tensor(extra_heat)
                        else extra_heat))
        egy_new[cool] = u_cooled_cgs / cu.uu_in_cgs
        ne_cool[cool] = ne_c
    entropy_new = torch.where(upd, egy_new / densityfac, entropy)
    ne_new = torch.where(on, data.ne, ne_cool)
    # inactive rows (dtime 0 — not at their bin's kick boundary) keep
    # their state; the reference only touches active particles
    ne_new = torch.where(upd, ne_new, ne)

    # --- metal enrichment from unresolved SN (sfr_eff.cpp:741) ---
    k1, k2, k3 = threefry.split(key, 3)
    dev = mass.device
    if pids is not None:
        salt = threefry.bits(k1)
        pid = pids.long() & 0xFFFFFFFF
        w = idhash_uniform(salt, pid, 0)
        u_form = idhash_uniform(salt, (pid + 1) & 0xFFFFFFFF, 0)
    else:
        w = threefry.uniform(k1, mass.shape, device=dev)
        u_form = threefry.uniform(k2, mass.shape, device=dev)
    metallicity_new = metallicity + torch.where(
        on, w * METAL_YIELD * frac / sp.Generations, 0.0)

    # --- stochastic star spawning ---
    mass_of_star = torch.clamp(mass, max=sp.avg_baryon_mass
                               / sp.Generations)
    whole = (mass < 2 * mass_of_star) | (generation > sp.Generations)
    mass_of_star = torch.where(whole, mass, mass_of_star)
    prob = dM / torch.clamp(mass_of_star, min=1e-30)
    form = (u_form < prob) & on
    # remainder metals for particles that did not convert entirely
    keeps_gas = (~form) | (~whole)
    metallicity_new = metallicity_new + torch.where(
        on & keeps_gas, (1 - w) * METAL_YIELD * frac / sp.Generations,
        0.0)
    convert_whole = form & (mass < 1.1 * mass_of_star)

    return SFResult(sfr=sfr_out, entropy=entropy_new, ne=ne_new,
                    metallicity=metallicity_new, form_star=form,
                    mass_of_star=mass_of_star,
                    convert_whole=convert_whole)
