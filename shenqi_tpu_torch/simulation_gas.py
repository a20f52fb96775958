"""Gas stages for the Simulation driver (shenqi_tpu/simulation_gas.py in
torch, run.cpp's gas sections).

Per step (run.cpp:458-681):
  * density with adaptive smoothing lengths (run.cpp:488) and the hydro
    force (run.cpp:505), both on the grid stencil and for the active
    gas only; sources are always all gas at predicted quantities, but
    for the hydro-decoupled wind rows, which exert and feel no hydro
    force;
  * the hydro kick and entropy update in Simulation._apply_half_kick;
  * Strang-split source terms after the kick (run.cpp:604-681):
    radiative cooling, the SH03 effective EOS with star formation
    (gas -> star conversion: a whole particle flips its ptype, a split
    spawns a star on a free row), winds (subgrid kicks, or new stars
    kicking their gas neighbours as ofjt10 does, with the DM velocity
    dispersion refreshed each PM step), and metal return from the star
    rows to the gas around them.

Gas rows occupy the array prefix [0, ngas); stars converted from gas
keep their row, spawned stars take free rows anywhere.  The
pressure-entropy IC fixed point (`setup_density_indep_entropy`) runs on
the blocked octree walk, as in the JAX package.  Black holes live in the
gas prefix too: seeding flips a gas row's ptype to BH (resumed type-5
rows lie past the prefix), and `blackhole_step` runs accretion, thermal
feedback, swallowing, mergers, the accretion drag and dynamical friction
after the cooling stage.  The cooling solve takes per-row UV rates (the
excursion set's J21, else the fluctuating UVB's `zreion_table`),
metal-line cooling (`metal_cool`) and helium's long-mean-free-path heat
for the rows not yet HeIII.  Helium reionization (`helium_step`, QSO
bubbles at FOF cadence) and the excursion set (`excursion_step`, J21 at
PM-step cadence) run as in the JAX package.

The random streams are the JAX package's: GasPhysics holds a threefry key
(utils/threefry.py) seeded 42 whatever the paramfile's seed, as
simulation_gas.py:294-300 of the JAX package does (ROADMAP C.4), and
splits it the same way, so each draw is the JAX package's.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from typing import Optional

from ._device import resolve_device
from .core.particles import GAS, DM, STAR, BH, wrap_i32, ipos_to_float
from .core.timeline import TIMEBINS
from .core.integrate import predictor_tables
from .ops.tree import build_octree
from .physics.blackhole import (BHParams, bh_gas_environment, bh_accretion,
                                bh_thermal_feedback, bh_swallow_gas,
                                bh_mergers, bh_soundspeed, bh_drag_accel,
                                dynamical_friction)
from .physics.cooling_rates import (CoolingParams, TreeCool, UVBG,
                                    do_cooling, uvbg_take)
from .physics.metal_return import metal_return_step
from .physics.sfr import (SFRParams, CoolingUnits, starformation_step,
                          entropy_to_u)
from .physics.uv_fluctuations import local_uvbg, uvbg_from_j21
from .physics.excursion import calculate_uvbg, escape_fractions
from .physics.veldisp import dm_velocity_dispersion
from .physics.winds import (WindParams, WIND_SUBGRID, WIND_FIXED_EFFICIENCY,
                            winds_subgrid_step, winds_star_feedback,
                            winds_decay, is_decoupled)
from .sph.kernels import CUBIC
from .sph.density import density as sph_density, density_walk_blocked
from .sph.hydro import (HydroParams, HydroResult, hydro_time_factors,
                        balsara_f1, pressure_predict)
from .sph.stencil_hydro import stencil_hydro_walk, hydro_cover_patch
from .utils import threefry
from .utils.constants import (GAMMA, GAMMA_MINUS1, HYDROGEN_MASSFRAC,
                              LIGHTCGS, GRAVITY, HUBBLE)
from .utils.units import default_units

# the full-length star arrays slots_gc cuts with the particle arrays
_STAR_ROWS = ("birth_a", "last_enrich_myr", "mass0", "total_returned",
              "star_metallicity")
# split spawns the device conversion takes per step; more (or too few
# free rows) take the host path, which grows the arrays
_KSPAWN = 512
# black holes the device census pulls to the host at once; more take the
# host path (simulation_gas.py:1145-1162 of the JAX package)
_KBH = 64


def _sf_stats_reduce(gas_alive, sfr, form, whole, mstar, dtime,
                     mask_full):
    """The per-step SF bookkeeping sums as one f32 tensor (one host pull):
    [sfr_sum, sm_sum, spawned_mass, n_sf, n_act, dt_sum, n_split,
     n_whole, n_free] (counts < 2^24, exact)."""
    f = torch.float32
    z = torch.zeros((), dtype=f, device=sfr.device)
    return torch.stack([
        torch.sum(torch.where(gas_alive, sfr, z)),
        torch.sum(torch.where(gas_alive, sfr * dtime, z)),
        torch.sum(torch.where(gas_alive & form, mstar, z)),
        torch.sum(gas_alive & (sfr > 0)).to(f),
        torch.sum(gas_alive & (dtime > 0)).to(f),
        torch.sum(torch.where(gas_alive, dtime, z)),
        torch.sum(form & ~whole).to(f),
        torch.sum(form & whole).to(f),
        torch.sum(~mask_full).to(f)])


def _interp(x, xp, fp):
    """jnp.interp in f32 (constant ends), for a 1-D grid xp."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1,
                    xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    f = fp[i - 1] + (delta / dx) * df
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _metal_return_act(mask, ptype, birth, last, ag, tg, atime,
                      min_window):
    """The enrichment-activity decision (metal_return.cpp's stellar-age
    gating): stellar ages from the t(a) grid, active where the age
    window since the last enrichment exceeds min_window.  Returns
    (active mask, ages)."""
    t1 = _interp(torch.clamp(atime, min=ag[0]), ag, tg)
    t0 = _interp(torch.clamp(birth, min=ag[0]), ag, tg)
    age = torch.where(birth > 0, t1 - t0, 0.0)
    star = mask & (ptype == STAR) & (birth > 0)
    return star & (age - last > min_window), age


@dataclass
class GasState:
    """SoA gas fields for the [0, ngas) prefix rows (every field of the
    JAX GasState; the subgrid ones keep their initial values in a run
    whose GasPhysics leaves the stage that changes them off)."""

    ngas: int
    entropy: torch.Tensor
    density: torch.Tensor
    egy_wt_density: torch.Tensor
    dhsml_egy: torch.Tensor
    div_vel: torch.Tensor
    curl_vel: torch.Tensor
    hydro_accel: torch.Tensor
    dt_entropy: torch.Tensor
    max_signal_vel: torch.Tensor
    dt_hsml: torch.Tensor
    ne: torch.Tensor
    metallicity: torch.Tensor
    sfr: torch.Tensor
    delay_time: torch.Tensor
    generation: torch.Tensor
    vdisp: torch.Tensor
    # star and black-hole bookkeeping, full length [ntot]
    birth_a: torch.Tensor
    last_enrich_myr: torch.Tensor
    mass0: torch.Tensor
    total_returned: torch.Tensor
    bh_mass: torch.Tensor
    bh_mdot: torch.Tensor
    heiii: torch.Tensor
    star_metallicity: torch.Tensor
    local_j21: torch.Tensor
    zreion_p: torch.Tensor
    gradrho_mag: torch.Tensor

    @classmethod
    def create(cls, ngas: int, entropy0, ntot: int = None,
               device=None) -> "GasState":
        """ntot: the full particle-array length (>= ngas); the state lies
        on `device` (CUDA unless the caller asks for the CPU)."""
        if ntot is None:
            ntot = ngas
        dev = resolve_device(device)

        def full(n, v, dtype=torch.float32):
            return torch.full((n,), v, dtype=dtype, device=dev)

        z, zt = (lambda: full(ngas, 0.0)), (lambda: full(ntot, 0.0))
        return cls(
            ngas=ngas,
            entropy=torch.as_tensor(entropy0, dtype=torch.float32,
                                    device=dev),
            density=z(), egy_wt_density=z(), dhsml_egy=z(), div_vel=z(),
            curl_vel=z(),
            hydro_accel=torch.zeros((ngas, 3), dtype=torch.float32,
                                    device=dev),
            dt_entropy=z(), max_signal_vel=z(), dt_hsml=z(),
            ne=full(ngas, 1.0), metallicity=z(), sfr=z(), delay_time=z(),
            generation=full(ngas, 0, torch.int32), vdisp=full(ngas, 100.0),
            birth_a=zt(), last_enrich_myr=zt(), mass0=zt(),
            total_returned=zt(), bh_mass=zt(), bh_mdot=zt(),
            heiii=full(ngas, False, torch.bool), star_metallicity=zt(),
            local_j21=z(), zreion_p=full(ngas, -1.0), gradrho_mag=z())

    def replace(self, **kw) -> "GasState":
        return dataclasses.replace(self, **kw)


@dataclass
class GasPhysics:
    """Configuration + stage implementations for gas."""

    density_independent_sph: bool = True
    eta: float = 1.0
    ngb_deviation: float = 2.0
    art_bulk_visc: float = 0.75
    density_contrast_limit: float = 100.0
    kernel: object = CUBIC
    # the subgrid master switches and their parameters
    cooling_on: bool = False
    sfr_on: bool = False
    winds_on: bool = False
    metal_return_on: bool = False
    coolpar: Optional[CoolingParams] = None
    treecool: Optional[TreeCool] = None
    sfrpar: Optional[SFRParams] = None
    windpar: Optional[WindParams] = None
    coolunits: Optional[CoolingUnits] = None
    metals: object = None        # physics.metal_return.MetalReturn
    min_enrich_window_myr: float = 1.0
    bh_on: bool = False
    bhpar: Optional[BHParams] = None
    bh_dynfric_on: bool = False
    zreion_table: object = None  # physics.uv_fluctuations.ZreionTable
    metal_cool: object = None    # physics.uv_fluctuations.MetalCoolingTable
    helium: object = None        # physics.helium_reion.HeliumReion
    excursion: object = None     # physics.excursion.ExcursionSetParams
    j21_coeffs: object = None    # physics.uv_fluctuations.J21Coeffs
    excursion_zstop: float = 5.0
    units: object = None         # utils.units.UnitSystem
    # the threefry key the source terms draw from (utils/threefry.py)
    rng_key: Optional[tuple] = None

    def __post_init__(self):
        if self.rng_key is None:
            # PRNGKey(42) whatever the run's seed, as the JAX package
            # (simulation_gas.py:294-300; ROADMAP C.4)
            self.rng_key = threefry.PRNGKey(42)
        self._density_caps = {}
        self._hydro_stencil_caps = {}
        # what the last IC fixed point did (host numbers it synced for
        # its stop test anyway)
        self.last_fixed_point = {}
        # sfr.txt inputs of the last source step (None once written)
        self.last_sfr_stats = None
        # the last BH step's counts: BHs, swallowed rows, mergers
        self.last_bh_stats = None
        self._t_grid = None

    def next_key(self):
        self.rng_key, sub = threefry.split(self.rng_key)
        return sub

    # ---------- density + hydro ----------
    def density_hydro(self, sim, gas: GasState, active=None) -> GasState:
        """Density (adaptive hsml) then the hydro force, on the grid
        stencil (simulation_gas.py:319-618 of the JAX package with its
        default engines; the stencil uses no octree, so the JAX deep-tree
        retry has nothing to retry).

        Velocities and entropies enter at the drift time (VelPred /
        EntVarPred, density.c semantics): with individual timesteps a
        neighbour's kicked quantities live at its own Ti_kick, so they
        are advanced by signed kick factors first.  `active`: optional
        device mask over ALL rows; only the active gas is walked
        (run.cpp:488-505 ActiveParticles), inactive rows keep their
        stored hsml/density/accel.
        """
        p = sim.particles
        ng = gas.ngas
        dev = p.device
        gas_alive = (p.mask & (p.ptype == GAS))[:ng]
        ipos_g = p.ipos[:ng]
        gk, hk, de, gk_pm = predictor_tables(sim.CP, sim.timeline,
                                             sim.times, device=dev)
        bins = p.timebin[:ng].long()
        vel_g = (p.vel[:ng] + p.grav_accel[:ng] * gk[bins][:, None]
                 + p.grav_pm[:ng] * float(np.float32(gk_pm))
                 + gas.hydro_accel * hk[bins][:, None])
        ent_pred = gas.entropy + gas.dt_entropy * de[bins]
        # floor: the prediction must never drive entropy negative
        ent_pred = torch.maximum(ent_pred, 0.25 * gas.entropy)
        mass_g = torch.where(gas_alive, p.mass[:ng], 0.0)
        entvar = torch.pow(torch.clamp(ent_pred, min=1e-35), 1.0 / GAMMA)

        asel = gas_alive if active is None else (active[:ng] & gas_alive)
        n_act, n_alive = torch.stack([asel.sum(), gas_alive.sum()]).tolist()
        if n_act == 0:
            return gas
        sub_act = active is not None and n_act < n_alive
        sel = torch.nonzero(asel).squeeze(1) if sub_act else None

        def pick(a):
            return a[sel] if sub_act else a

        def merge(old, new):
            return old.index_put((sel,), new) if sub_act else new

        payload = {"ipos": ipos_g, "mass": mass_g, "vel": vel_g,
                   "entvar": entvar}
        dout = sph_density(payload, pick(ipos_g), pick(vel_g),
                           pick(entvar), pick(p.hsml[:ng]), sim.boxsize,
                           self.kernel, eta=self.eta,
                           ngb_deviation=self.ngb_deviation,
                           do_egy_density=self.density_independent_sph,
                           caps=self._density_caps)
        hsml = merge(p.hsml[:ng], dout.hsml)
        gas = gas.replace(
            density=merge(gas.density, dout.density),
            egy_wt_density=merge(gas.egy_wt_density, dout.egy_wt_density),
            dhsml_egy=merge(gas.dhsml_egy, dout.dhsml_egy_density_factor),
            div_vel=merge(gas.div_vel, dout.div_vel),
            curl_vel=merge(gas.curl_vel, dout.curl_vel),
            dt_hsml=merge(gas.dt_hsml, dout.dt_hsml),
            gradrho_mag=merge(gas.gradrho_mag,
                              torch.linalg.norm(dout.grad_rho, dim=-1)))
        sim.particles = p.replace(hsml=torch.cat([hsml, p.hsml[ng:]]))

        # ---- hydro force ----
        atime = sim.atime()
        # hydro-decoupled wind rows neither exert nor feel hydro forces
        # (simulation_gas.py:466-572 of the JAX package)
        decoupled = (is_decoupled(gas.delay_time, gas.density,
                                  1.0 / atime ** 3, self.windpar)
                     if (self.winds_on and self.windpar) else
                     torch.zeros(ng, dtype=torch.bool, device=dev))
        par = HydroParams(boxsize=sim.boxsize,
                          art_bulk_visc_const=self.art_bulk_visc,
                          density_contrast_limit=self.density_contrast_limit,
                          density_independent_sph=(
                              self.density_independent_sph))
        tf = hydro_time_factors(atime,
                                float(sim.CP.hubble_function(atime)))
        eom_dens = (gas.egy_wt_density if self.density_independent_sph
                    else gas.density)
        eom_c = torch.clamp(eom_dens, min=1e-35)
        press = pressure_predict(eom_c, entvar)
        cs = torch.sqrt(GAMMA * press / eom_c)
        f1 = balsara_f1(gas.div_vel, gas.curl_vel, cs, hsml, tf["fac_mu"])
        # per-row timebin dloga feeds the viscosity limiter
        # (hydratree2.hpp:334-343: dloga = 2 max(bin_i, bin_j)); bin 0
        # (fresh rows) gives dloga = 0, the limiter off
        dl_bin = np.zeros(TIMEBINS + 1, np.float32)
        for b in range(1, TIMEBINS + 1):
            dl_bin[b] = sim.timeline.get_dloga_for_bin(
                b, sim.times.ti_current)
        dloga_tab = torch.from_numpy(dl_bin).to(dev)[
            torch.clamp(bins, 0, TIMEBINS)]
        src = {"ipos": ipos_g, "mass": mass_g, "hsml": hsml, "vel": vel_g,
               "density": gas.density, "eomdensity": eom_dens,
               "entvar": entvar, "pressure": press, "divvel": gas.div_vel,
               "curlvel": gas.curl_vel, "dhsml_egy": gas.dhsml_egy,
               "dloga": dloga_tab, "decoupled": decoupled}
        mass_src = torch.where(decoupled, 0.0, mass_g)
        fields = torch.stack(
            [mass_src, hsml, vel_g[:, 0], vel_g[:, 1], vel_g[:, 2],
             gas.density, eom_dens, entvar, press, gas.div_vel,
             gas.curl_vel, gas.dhsml_egy, dloga_tab], dim=1).to(
                 torch.float32)
        targets = {"ipos": ipos_g, "vel": vel_g, "hsml": hsml,
                   "mass": mass_g, "density": gas.density,
                   "egyrho": eom_dens, "entvar": entvar, "pressure": press,
                   "f1": f1, "dhsml": gas.dhsml_egy, "dloga": dloga_tab}
        targets = {k: pick(v) for k, v in targets.items()}
        tvalid = pick(gas_alive & (hsml > 0))
        hres, cover, n_cover, _ = stencil_hydro_walk(
            ipos_g, fields, targets, par, spec=self.kernel,
            tier_cache=self._hydro_stencil_caps, tf=tf, tvalid=tvalid)
        if n_cover:
            # redo the flagged targets on one-target stencils that hold
            # their reach (the JAX package redoes them against every
            # source, oracle_patch, simulation_gas.py:513-540)
            cs_ = torch.nonzero(cover).squeeze(1)
            hs = hydro_cover_patch(
                ipos_g, fields, {k: v[cs_] for k, v in targets.items()},
                par, src, spec=self.kernel,
                tier_cache=self._hydro_stencil_caps, tf=tf,
                tvalid=tvalid[cs_])
            hres = HydroResult(*(a.index_put((cs_,), b)
                                 for a, b in zip(hres, hs)))
        live = pick(gas_alive & ~decoupled)
        return gas.replace(
            hydro_accel=merge(gas.hydro_accel,
                              torch.where(live[:, None], hres.accel, 0.0)),
            dt_entropy=merge(gas.dt_entropy,
                             torch.where(live, hres.dt_entropy, 0.0)),
            max_signal_vel=merge(gas.max_signal_vel, hres.max_signal_vel))

    def setup_density_indep_entropy(self, sim, gas: GasState,
                                    u_init: float) -> GasState:
        """Pressure-entropy IC fixed point (init.cpp:403-449
        setup_density_indep_entropy): iterate
        entropy = (g-1) u / (EgyWtDensity/a^3)^(g-1)  followed by an
        EgyWtDensity recomputation until the density converges
        (rel 1e-3, <= 100 iterations; one more after the stop).  Starts
        from EgyWtDensity = Density, which the reference found converges
        best.  The walks are the blocked octree walk's, at the current
        smoothing lengths."""
        p = sim.particles
        ng = gas.ngas
        dev = p.device
        gas_alive = (p.mask & (p.ptype == GAS))[:ng]
        ipos_g = p.ipos[:ng]
        mass_g = torch.where(gas_alive, p.mass[:ng], 0.0)
        hsml = p.hsml[:ng]
        a3 = sim.atime() ** 3
        egywt = torch.clamp(gas.density, min=1e-35)
        tree = build_octree(ipos_g, mass_g, gas_alive, sim.boxsize,
                            nlevels=sim.gravity.tree_nlevels,
                            ncrit=sim.gravity.tree_ncrit)
        order = tree.order
        vel0 = torch.zeros((ng, 3), dtype=torch.float32, device=dev)
        stop = False
        entropy = gas.entropy
        diffs = []
        for _ in range(100):
            entropy = (GAMMA_MINUS1 * u_init / torch.pow(
                torch.clamp(egywt / a3, min=1e-35), GAMMA_MINUS1))
            entvar = torch.pow(torch.clamp(entropy, min=1e-35), 1.0 / GAMMA)
            payload = {"ipos": tree.ipos_s, "mass": tree.mass_s,
                       "vel": vel0[order], "entvar": entvar[order]}
            res, _ = density_walk_blocked(
                tree, payload, ipos_g, vel0, hsml, sim.boxsize,
                self.kernel, ncrit=sim.gravity.tree_ncrit, block=64)
            new_egywt = torch.clamp(res.egy_rho, min=1e-35) \
                / torch.clamp(entvar, min=1e-35)
            if stop:
                egywt = new_egywt
                break
            maxdiff = float(torch.amax(torch.where(
                gas_alive, torch.abs(new_egywt - egywt)
                / torch.clamp(new_egywt, min=1e-35), 0.0)))
            diffs.append(maxdiff)
            egywt = new_egywt
            if maxdiff < 1e-3:
                stop = True     # one more iteration, then stop
        self.last_fixed_point = {"iterations": len(diffs),
                                 "converged": stop, "maxdiff": diffs}
        return gas.replace(entropy=entropy, egy_wt_density=egywt)

    # ---------- source terms (Strang split) ----------
    def source_terms(self, sim, gas: GasState, dtime):
        """Cooling + star formation + winds after the kick
        (simulation_gas.py:683-901 of the JAX package).

        dtime is per-row (the particle's own timebin dloga/hubble, zero
        when the row's bin is not at a kick boundary: the reference
        applies sources to ACTIVE particles only) or a scalar.  Returns
        (gas, stars formed).
        """
        if not (self.cooling_on or self.sfr_on):
            return gas, 0
        p = sim.particles
        ng = gas.ngas
        dev = p.device
        gas_alive = (p.mask & (p.ptype == GAS))[:ng]
        dtime = torch.broadcast_to(torch.as_tensor(
            dtime, dtype=torch.float32, device=dev), gas.entropy.shape)
        atime = sim.atime()
        a3inv = 1.0 / atime ** 3
        redshift = 1.0 / atime - 1.0
        uvbg = (self.treecool.uvbg(redshift, self.coolpar)
                if self.treecool else UVBG())
        if (self.excursion is not None and self.j21_coeffs is not None
                and redshift > self.excursion_zstop):
            # the excursion set's per-row J21 UVB (simulation_gas.py:
            # 703-711 of the JAX package): it takes precedence over the
            # zreion table
            uvbg = uvbg_from_j21(uvbg, gas.local_j21, gas.zreion_p,
                                 redshift, self.excursion.AlphaUV,
                                 self.j21_coeffs,
                                 fbar=self.coolpar.fBar
                                 if self.coolpar else 0.17)
        elif self.zreion_table is not None:
            # fluctuating UVB: per-row rates gated on z_reion
            # (simulation_gas.py:713-719 of the JAX package)
            uvbg = local_uvbg(uvbg, self.zreion_table.zreion(
                ipos_to_float(p.ipos[:ng], sim.boxsize)), redshift)
        # HeII long-mean-free-path heating for the gas not yet HeIII
        # (simulation_gas.py:720-730)
        extra_heat = 0.0
        if self.helium is not None and self.helium.during(redshift):
            h0 = sim.CP.HubbleParam * HUBBLE
            rho_crit_b = (3 * h0 * h0 / (8 * np.pi * GRAVITY)
                          * sim.CP.OmegaBaryon)
            lm = self.helium.lmfp_heating_per_gram(redshift, rho_crit_b)
            extra_heat = torch.where(gas.heiii, 0.0,
                                     float(np.float32(lm)))
        if not self.sfr_on:
            return self._pure_cooling(gas, gas_alive, dtime, a3inv,
                                      redshift, uvbg, extra_heat), 0

        res = starformation_step(
            self.next_key(), gas.density, gas.egy_wt_density, gas.entropy,
            p.mass[:ng], gas.ne, gas.metallicity, gas.generation, dtime,
            a3inv, redshift, uvbg, self.sfrpar, self.coolpar,
            self.coolunits, gas_alive, gradrho_mag=gas.gradrho_mag,
            hsml=p.hsml[:ng], pids=p.id_lo[:ng], extra_heat=extra_heat)
        gas = gas.replace(entropy=res.entropy, ne=res.ne,
                          metallicity=res.metallicity, sfr=res.sfr)
        # sfr.txt's inputs and the conversion's counts: one host pull
        sv = _sf_stats_reduce(gas_alive, res.sfr, res.form_star,
                              res.convert_whole, res.mass_of_star, dtime,
                              p.mask).tolist()
        n_split, n_whole, n_free = int(sv[6]), int(sv[7]), int(sv[8])
        if n_split == 0 and n_whole == 0:
            nstars = 0
        elif n_split <= _KSPAWN and n_free >= n_split:
            nstars = self._convert_stars_device(sim, gas, res, atime)
        else:
            if n_free < n_split:
                self._grow_star_capacity(sim, gas,
                                         max(n_split - n_free, 1))
            nstars = self._convert_stars(sim, gas, res, atime)
        unit_sfr = max(self.sfrpar.UnitSfr_in_solar_per_year, 1e-35)
        n_sf, n_act = int(sv[3]), int(sv[4])
        self.last_sfr_stats = {
            "total_sm": sv[1] / unit_sfr, "totsfrrate": sv[0],
            "rate_in_msunperyear": sv[0], "total_sum_mass_stars": sv[2],
            "avg_dtime": sv[5] / max(n_act, 1), "total_sum_part": n_sf,
            "tot_newstars": nstars}
        if self.winds_on and self.windpar:
            gas = self._winds(sim, gas, res, gas_alive, dtime, atime,
                              a3inv, nstars)
        return gas, nstars

    def _pure_cooling(self, gas, gas_alive, dtime, a3inv, redshift, uvbg,
                      extra_heat=0.0):
        """Radiative cooling through the implicit solver, without star
        formation, with the metal-line term when a table is loaded
        (simulation_gas.py:877-900 of the JAX package); the solver runs on
        the active gas rows."""
        cu = self.coolunits
        dfac = entropy_to_u(torch.clamp(
            gas.egy_wt_density if self.density_independent_sph
            else gas.density, min=1e-35), a3inv)
        upd = gas_alive & (dfac > 0) & (dtime > 0)
        sel = torch.nonzero(upd).squeeze(1)
        if not sel.numel():
            return gas
        u = gas.entropy[sel] * dfac[sel]
        min_egy = (self.sfrpar.min_egyspec() * cu.uu_in_cgs
                   if self.sfrpar else 0.0)
        u_cgs, ne = do_cooling(
            u * cu.uu_in_cgs,
            gas.density[sel] * a3inv * cu.density_in_phys_cgs,
            dtime[sel] * cu.tt_in_s, 1 - HYDROGEN_MASSFRAC, redshift,
            uvbg_take(uvbg, sel), self.coolpar, min_egyspec_cgs=min_egy,
            ne_init=gas.ne[sel], metallicity=gas.metallicity[sel],
            metal_cool=self.metal_cool,
            extra_heat=(extra_heat[sel] if torch.is_tensor(extra_heat)
                        else extra_heat))
        ent = gas.entropy.clone()
        ne_all = gas.ne.clone()
        ent[sel] = (u_cgs / cu.uu_in_cgs) / torch.clamp(dfac[sel],
                                                         min=1e-35)
        ne_all[sel] = ne
        return gas.replace(entropy=ent, ne=ne_all)

    def _winds(self, sim, gas, res, gas_alive, dtime, atime, a3inv,
               nstars):
        """The wind kicks after star formation and the decoupling clocks'
        decay (simulation_gas.py:808-901 of the JAX package)."""
        ng = gas.ngas
        if self.windpar.has(WIND_SUBGRID):
            sm = res.sfr * dtime / max(
                self.sfrpar.UnitSfr_in_solar_per_year, 1e-35)
            p = sim.particles
            wres = winds_subgrid_step(
                self.next_key(), p.vel[:ng], gas.entropy, gas.density,
                gas.delay_time, p.mass[:ng], sm, gas.vdisp, atime, a3inv,
                self.windpar,
                # the reference queues gas that formed mass but did NOT
                # convert (sfr_eff.cpp:271); converting rows are stars
                eligible=gas_alive & (res.sfr > 0) & ~res.form_star,
                pids=p.id_lo[:ng])
            vel3, ent, delay0 = wres.vel, wres.entropy, wres.delay_time
        elif nstars == 0:
            # no new stars: no kicks; only the clocks' decay below
            vel3 = sim.particles.vel[:ng]
            ent, delay0 = gas.entropy, gas.delay_time
        else:
            # new stars kick their gas neighbours; the star count is
            # padded to a power-of-two bucket of at least 8 lanes, whose
            # padding lanes (row 0, mass 0) kick nothing, because the
            # JAX package's full-shape draw is over the bucket
            # (source_terms passes no ids: ROADMAP C.4)
            sidx = torch.nonzero(res.form_star).squeeze(1)
            ns0 = sidx.shape[0]
            nbkt = max(8, 1 << (ns0 - 1).bit_length())
            smask = torch.arange(nbkt, device=sidx.device) < ns0
            sidx = torch.nn.functional.pad(sidx, (0, nbkt - ns0))
            p2 = sim.particles
            # split spawns carry mass_of_star, not the parent's full mass
            star_m = torch.where(res.convert_whole, p2.mass[:ng],
                                 res.mass_of_star)
            vel3, ent, delay0 = winds_star_feedback(
                self.next_key(), p2.ipos[sidx],
                torch.clamp(p2.hsml[sidx], min=1e-3),
                torch.where(smask, star_m[sidx], 0.0), gas.vdisp[sidx],
                p2.ipos[:ng], p2.mass[:ng], p2.vel[:ng], gas.entropy,
                gas.density, gas.delay_time, gas_alive & ~res.form_star,
                sim.boxsize, atime, a3inv, self.windpar)
        p = sim.particles
        sim.particles = p.replace(vel=torch.cat([vel3, p.vel[ng:]]))
        delay = winds_decay(delay0, gas.density, a3inv, dtime,
                            self.windpar)
        return gas.replace(entropy=ent, delay_time=delay)

    # ---------- metal return (metal_return.cpp analog) ----------
    def _age_grid(self, sim):
        """The t(a) grid of the activity decision, on the device: 257
        scale factors from 0.01 to 1 and the cosmic time at each (Myr)."""
        if self._t_grid is None:
            ag = np.geomspace(0.01, 1.0, 257)
            tg = np.zeros_like(ag)
            for i in range(1, len(ag)):
                tg[i] = tg[i - 1] + sim.CP.age_myr(ag[i - 1], ag[i])
            dev = sim.device
            self._t_grid = (
                torch.tensor(ag, dtype=torch.float32, device=dev),
                torch.tensor(tg, dtype=torch.float32, device=dev))
        return self._t_grid

    def metal_return(self, sim, gas: GasState) -> GasState:
        """Return stellar ejecta mass and metals to the gas around each
        star (metal_return.cpp; simulation_gas.py:903-1046 of the JAX
        package).

        Per active star, the IMF-weighted AGB + SNII yields and the Sn1a
        DTD over the age window since its last enrichment (host scipy,
        `MetalReturn.star_return`), then a kernel-weighted scatter onto
        the gas within the star's smoothing length.  The weights' sum
        comes from `bh_gas_environment` with the cubic kernel while the
        scatter uses the run's kernel, and the smoothing length is the
        progenitor gas row's: both as the JAX package does (ROADMAP
        C.4).  One host pull of the active count, one of the active
        stars' scalars."""
        if not (self.metal_return_on and self.metals):
            return gas
        p = sim.particles
        ng = gas.ngas
        ntot = p.n
        dev = p.device
        atime = sim.atime()
        ag, tg = self._age_grid(sim)
        act, age = _metal_return_act(
            p.mask, p.ptype, gas.birth_a, gas.last_enrich_myr, ag, tg,
            torch.tensor(atime, dtype=torch.float32, device=dev),
            self.min_enrich_window_myr)
        idx = torch.nonzero(act).squeeze(1)
        ns0 = idx.shape[0]
        if ns0 == 0:
            return gas
        # the active stars in a power-of-two bucket of at least 8 lanes,
        # padding lanes at the last row with zero hsml (as the JAX
        # package's bucket)
        nbkt = max(8, 1 << (ns0 - 1).bit_length())
        lane = torch.arange(nbkt, device=dev) < ns0
        idx = torch.nn.functional.pad(idx, (0, nbkt - ns0), value=ntot)
        idx_c = torch.clamp(idx, max=ntot - 1)
        gas_alive = (p.mask & (p.ptype == GAS))[:ng]
        star_ipos = p.ipos[idx_c]
        star_hsml = torch.where(lane, torch.clamp(p.hsml[idx_c], min=1e-3),
                                0.0)
        gmass = torch.where(gas_alive, p.mass[:ng], 0.0)
        env = bh_gas_environment(star_ipos, star_hsml, p.ipos[:ng], gmass,
                                 gas.density, p.vel[:ng], gas_alive,
                                 sim.boxsize)
        fw, zmet_s, last_h, age_s, m0_s, totret_h = [
            x.cpu().numpy().copy() for x in torch.stack([
                env.feedback_weight, gas.star_metallicity[idx_c],
                gas.last_enrich_myr[idx_c], age[idx_c], gas.mass0[idx_c],
                gas.total_returned[idx_c]])]
        # a star with no gas inside its hsml cannot scatter; its
        # enrichment waits for a later step, so the returned mass stays
        # with it
        has_ngb = fw > 1e-30
        h = sim.CP.HubbleParam
        mret = np.zeros(nbkt, np.float32)
        zret = np.zeros(nbkt, np.float32)
        upd = np.zeros(nbkt, bool)
        for j in range(ns0):
            if not has_ngb[j]:
                continue
            mfrac, zfrac, _ = self.metals.star_return(
                float(zmet_s[j]), float(last_h[j]), float(age_s[j]), h)
            # cap: never return more than 90% of the birth mass total
            mfrac = min(mfrac, max(0.9 - totret_h[j], 0.0))
            mret[j] = mfrac * m0_s[j]
            zret[j] = min(zfrac, mfrac) * m0_s[j]
            totret_h[j] += mfrac
            last_h[j] = age_s[j]
            upd[j] = True

        def t(a):
            return torch.from_numpy(a).to(dev)

        mret_t, zret_t = t(mret), t(zret)
        tgt_u = torch.where(lane & t(upd), idx, ntot)
        last = torch.cat([gas.last_enrich_myr, gas.last_enrich_myr[:1]])
        last[tgt_u] = t(last_h)
        totret = torch.cat([gas.total_returned, gas.total_returned[:1]])
        totret[tgt_u] = t(totret_h)
        gas.last_enrich_myr = last[:ntot]
        gas.total_returned = totret[:ntot]
        if mret.sum() <= 0:
            return gas
        dm, dz = metal_return_step(star_ipos, star_hsml, mret_t, zret_t,
                                   env.feedback_weight, p.ipos[:ng], gmass,
                                   gas_alive, sim.boxsize, self.kernel)
        new_metal = torch.where(
            gas_alive, (gas.metallicity * gmass + dz)
            / (torch.clamp(gmass, min=1e-35) + dm), gas.metallicity)
        new_mass = p.mass.clone()
        new_mass[:ng] += torch.where(gas_alive, dm, 0.0)
        # the stars give up what they returned, down to a tenth of their
        # birth mass
        val = torch.maximum(new_mass[idx_c] - mret_t, 0.1 * t(m0_s))
        new_mass = torch.cat([new_mass, new_mass[:1]])
        new_mass[torch.where(lane, idx, ntot)] = val
        sim.particles = p.replace(mass=new_mass[:ntot])
        return gas.replace(metallicity=new_metal)

    # ---------- DM velocity dispersion (veldisp2.cpp analog) ----------
    def update_vdisp(self, sim, gas: GasState) -> GasState:
        """Refresh the per-gas DM velocity dispersion of the sigma-based
        wind models (run.cpp:662-663: once per PM step)."""
        if not (self.winds_on and self.windpar) or \
                self.windpar.has(WIND_FIXED_EFFICIENCY):
            return gas
        p = sim.particles
        ng = gas.ngas
        didx = torch.nonzero(p.mask & (p.ptype == DM)).squeeze(1)
        if not didx.numel():
            return gas
        gas_alive = (p.mask & (p.ptype == GAS))[:ng]
        sigma, _, _ = dm_velocity_dispersion(
            p.ipos[didx], p.vel[didx], p.mass[didx],
            torch.ones(didx.shape[0], dtype=torch.bool, device=p.device),
            p.ipos[:ng], torch.clamp(p.hsml[:ng] * 2, min=1e-3),
            sim.boxsize, sim.atime(), nlevels=sim.gravity.tree_nlevels,
            ncrit=sim.gravity.tree_ncrit)
        return gas.replace(vdisp=torch.where(gas_alive, sigma, gas.vdisp))

    # ---------- excursion-set reionization (uvbg.cpp analog) -------
    def excursion_step(self, sim, gas: GasState, halo_mass) -> GasState:
        """One find_HII_bubbles pass (PM-step cadence while redshift >
        ExcursionSetZStop; simulation_gas.py:1047-1081 of the JAX
        package).  halo_mass: [N] per-row FOF halo mass (0 outside
        halos), for the escape fractions.  Each gas row keeps the
        maximum J21 it has read (uvbg.cpp:461-472) and records z_reion
        at its first ionization."""
        if self.excursion is None:
            return gas
        atime = sim.atime()
        redshift = 1.0 / atime - 1.0
        if redshift <= self.excursion_zstop:
            return gas
        t0 = time.perf_counter()
        p = sim.particles
        ng = gas.ngas
        units = self.units or default_units()
        # halo_mass is sized at the last FOF: rows a capacity growth added
        # since hold no FOF mass (what the next FOF gives them), rows
        # slots_gc cut were dead.  The JAX package fails on the shape
        # here (ROADMAP C.4)
        halo_mass = halo_mass[:p.n]
        halo_mass = torch.nn.functional.pad(
            halo_mass, (0, p.n - halo_mass.shape[0]))
        fesc = escape_fractions(halo_mass.to(torch.float32),
                                self.excursion, units.UnitMass_in_g,
                                sim.CP.HubbleParam)
        sfr = torch.zeros(p.n, dtype=torch.float32, device=p.device)
        sfr[:ng] = gas.sfr
        res = calculate_uvbg(p.ipos, p.mass, p.ptype, sfr, fesc, atime,
                             sim.CP, units, sim.boxsize, self.excursion,
                             mask=p.mask)
        j21g = res.j21_particles[:ng]
        newj = torch.maximum(gas.local_j21, j21g)
        newz = torch.where((gas.zreion_p < 0) & (j21g > 0),
                           float(np.float32(redshift)), gas.zreion_p)
        sim.excursion_xhi = tuple(torch.stack(
            [res.vol_weighted_xhi, res.mass_weighted_xhi]).tolist())
        # the pull above waited for the pass: its seconds, for the logs
        self.last_excursion_s = time.perf_counter() - t0
        return gas.replace(local_j21=newj, zreion_p=newz)

    # ---------- HeII reionization (cooling_qso_lightup analog) -----
    def helium_step(self, sim, gas: GasState, group_masses,
                    group_cm) -> GasState:
        """QSO bubble HeIII ionization at FOF cadence
        (do_heiii_reionization; simulation_gas.py:1083-1110 of the JAX
        package): host numpy over the gas, with the bubbles drawn from a
        RandomState seeded by randint(next_key(), (), 0, 2**31), the key
        taken at the same place of the stream as the JAX package takes
        it.  group_masses/group_cm: the FOF catalogue's."""
        if self.helium is None or self.coolunits is None:
            return gas
        atime = sim.atime()
        redshift = 1.0 / atime - 1.0
        if not self.helium.during(redshift):
            return gas
        p = sim.particles
        ng = gas.ngas
        gas_alive = ((p.mask[:ng] & (p.ptype[:ng] == GAS)).cpu().numpy())
        pos = ipos_to_float(p.ipos[:ng], sim.boxsize).cpu().numpy()
        rng = np.random.RandomState(
            threefry.randint(self.next_key(), 0, 2 ** 31))
        nev = len(self.helium.events)
        heiii, ent, nion = self.helium.turn_on_quasars(
            rng, atime, group_masses, group_cm, pos,
            gas.density.cpu().numpy(), gas_alive, gas.heiii.cpu().numpy(),
            gas.entropy.cpu().numpy(), sim.boxsize,
            self.coolunits.uu_in_cgs)
        self.last_helium = {"a": atime, "bubbles":
                            len(self.helium.events) - nev, "ionized": nion}
        if nion == 0:
            return gas
        dev = gas.entropy.device
        return gas.replace(heiii=torch.from_numpy(heiii).to(dev),
                           entropy=torch.from_numpy(ent).to(dev))

    # ---------- black holes (blackhole.cpp analog) ----------
    def seed_bh(self, sim, gas: GasState, rows) -> GasState:
        """Convert the given gas rows to black holes (fof_seed's
        conversion; simulation_gas.py:1112-1127 of the JAX package): the
        row becomes ptype BH and keeps its dynamic mass; its subgrid mass
        starts at the seed mass."""
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        if rows.size == 0:
            return gas
        p = sim.particles
        r = torch.from_numpy(rows).to(p.device)
        ptype = p.ptype.clone()
        ptype[r] = BH
        sim.particles = p.replace(ptype=ptype)
        bhm = gas.bh_mass.clone()
        bhm[r] = float(np.float32(self.bhpar.SeedBlackHoleMass))
        return gas.replace(bh_mass=bhm)

    @staticmethod
    def _bh_census(p):
        """The alive BH rows in ascending order, from one host pull of the
        count and the first _KBH rows (the JAX package's device census);
        beyond _KBH the host path (simulation_gas.py:1145-1162)."""
        bh = p.mask & (p.ptype == BH)
        n = bh.shape[0]
        pos = torch.cumsum(bh.to(torch.int32), 0) - 1
        slot = torch.where(bh & (pos < _KBH), pos, _KBH).long()
        buf = torch.full((_KBH + 1,), n, dtype=torch.int64,
                         device=bh.device)
        buf.scatter_(0, slot, torch.arange(n, device=bh.device))
        # slot _KBH collects every other row: its value is not read
        got = torch.cat([bh.sum().reshape(1), buf[:_KBH]]).tolist()
        nbh = int(got[0])
        if nbh <= _KBH:
            return np.asarray(got[1:1 + nbh], np.int64)
        return np.nonzero(bh.cpu().numpy())[0]

    def blackhole_step(self, sim, gas: GasState, dtime) -> GasState:
        """Accretion, feedback, swallowing, mergers, drag and dynamical
        friction (simulation_gas.py:1129-1280 of the JAX package).

        BH rows live in the gas prefix (gas flipped to ptype BH by
        seed_bh; resumed type-5 rows lie past it).  The order is
        blackhole.cpp's: environment gather -> accretion -> feedback ->
        swallow draw (one key, drawn after the source terms' keys) ->
        mergers (host) -> the BH_DRAG kick -> dynamical friction.
        `dtime` is the gas prefix's per-row dtime; a BH takes its own
        row's, and a row past the prefix the prefix's last (the JAX
        package's gather clamps an index out of range)."""
        if not (self.bh_on and self.bhpar):
            return gas
        par = self.bhpar
        p = sim.particles
        ng = gas.ngas
        dev = p.device
        # the census cap of 64 with its host path is the JAX package's
        # (ROADMAP C.4)
        idx_np = self._bh_census(p)
        nbh = idx_np.size
        self.last_bh_stats = {"nbh": nbh, "swallowed": 0, "mergers": 0}
        if nbh == 0:
            return gas
        idx = torch.from_numpy(idx_np).to(dev)
        dtime = torch.broadcast_to(torch.as_tensor(
            dtime, dtype=torch.float32, device=dev), gas.entropy.shape)
        # a resumed BH row past the prefix reads the prefix's last dtime, as
        # the JAX package's clamped gather does (ROADMAP C.4)
        dtime = dtime[torch.clamp(idx, max=ng - 1)]
        atime = sim.atime()
        a3inv = 1.0 / atime ** 3
        G = sim.gravity.G
        gas_alive = (p.mask & (p.ptype == GAS))[:ng]
        gmass = torch.where(gas_alive, p.mass[:ng], 0.0)
        hsml_bh = torch.clamp(p.hsml[idx] * par.BlackHoleNgbFactor,
                              min=1e-3)
        hsml_bh = torch.clamp(hsml_bh, max=par.BlackHoleMaxAccretionRadius)
        bh_ipos, bh_vel = p.ipos[idx], p.vel[idx]
        bhm, bh_dynmass = gas.bh_mass[idx], p.mass[idx]
        gipos = p.ipos[:ng]

        env = bh_gas_environment(bh_ipos, hsml_bh, gipos, gmass, gas.entropy,
                                 p.vel[:ng], gas_alive, sim.boxsize)
        mdot = bh_accretion(bhm, bh_vel, env, atime, G, par)
        bhm_new = bhm + mdot * dtime
        c_int = LIGHTCGS / par.UnitVelocity_in_cm_per_s
        energy = (par.BlackHoleFeedbackFactor * 0.1 * mdot * dtime
                  * c_int ** 2)
        dent = bh_thermal_feedback(
            bh_ipos, hsml_bh, energy, env.feedback_weight, gipos, gmass,
            torch.clamp(gas.density, min=1e-35), gas_alive, sim.boxsize,
            a3inv)
        swallowed_by, gain = bh_swallow_gas(
            self.next_key(), bh_ipos, hsml_bh, bhm_new, bh_dynmass, env,
            gipos, gmass, gas_alive, sim.boxsize)
        # accretion-momentum drag (blackhole.cpp:418-429)
        adrag = bh_drag_accel(bh_vel, env.gas_vel, mdot, bh_dynmass, bhm,
                              atime, par)
        bh_mass = gas.bh_mass.clone()
        bh_mass[idx] = bhm_new
        bh_mdot = gas.bh_mdot.clone()
        bh_mdot[idx] = mdot
        entropy = torch.where(gas_alive, gas.entropy + dent, gas.entropy)

        # swallowed rows: mask off, mass 0, their mass to the BH
        eaten = swallowed_by >= 0
        cs = bh_soundspeed(env.entropy, env.density, atime)
        (n_eaten, *host) = torch.cat([
            eaten.sum().reshape(1).to(torch.float64),
            torch.stack([bhm_new, cs, hsml_bh], 1).double().reshape(-1),
            ]).tolist()
        n_eaten = int(n_eaten)
        bhm_h, cs_h, hsml_h = np.asarray(host, np.float64).reshape(
            nbh, 3).astype(np.float32).T
        mass, mask = p.mass, p.mask
        if n_eaten:
            mass = torch.cat([torch.where(eaten, 0.0, mass[:ng]), mass[ng:]])
            mask = torch.cat([torch.where(eaten, False, mask[:ng]),
                              mask[ng:]])
            mass = mass.index_add(0, idx, gain)

        # BH-BH mergers (host; blackhole.py:238-292 of the JAX package,
        # kept: ROADMAP C.4)
        lo, hi = (w[idx].cpu().numpy().view(np.uint32).astype(np.uint64)
                  for w in (p.id_lo, p.id_hi))
        ids64 = (hi << np.uint64(32)) | lo
        eaten_by, msub2, mdyn2 = bh_mergers(
            ipos_to_float(bh_ipos, sim.boxsize).cpu().numpy(),
            bh_vel.cpu().numpy(), hsml_h, bhm_h,
            mass[idx].cpu().numpy(), ids64, atime, cs_h, sim.boxsize)
        merged = eaten_by >= 0
        if merged.any():
            bh_mass[idx] = torch.from_numpy(msub2).to(dev)
            mass = mass.clone() if mass is p.mass else mass
            mass[idx] = torch.from_numpy(mdyn2).to(dev)
            dead = torch.from_numpy(idx_np[merged]).to(dev)
            mask = mask.clone() if mask is p.mask else mask
            mask[dead] = False
            mass[dead] = 0.0
        if n_eaten or merged.any():
            sim.particles = p.replace(mass=mass, mask=mask)
        self.last_bh_stats.update(swallowed=n_eaten,
                                  mergers=int(merged.sum()))

        # accretion-momentum drag kick (blackhole.cpp BH_DRAG)
        if par.BH_DRAG:
            pall = sim.particles
            vel = pall.vel.clone()
            vel[idx] += adrag * dtime[:, None]
            sim.particles = pall.replace(vel=vel)

        # dynamical friction from the collisionless background: DM and
        # stars, with method 1 as the JAX package
        # (simulation_gas.py:1258-1278; ROADMAP C.4)
        if self.bh_dynfric_on:
            pall = sim.particles
            didx = torch.nonzero(pall.mask & (pall.ptype != GAS)
                                 & (pall.ptype != BH)).squeeze(1)
            nd = didx.shape[0]
            if nd:
                sep = sim.boxsize / max(nd, 1) ** (1 / 3)
                sigma, _, rho = dm_velocity_dispersion(
                    pall.ipos[didx], pall.vel[didx], pall.mass[didx],
                    torch.ones(nd, dtype=torch.bool, device=dev),
                    pall.ipos[idx],
                    torch.full((nbh,), float(np.float32(2 * sep)),
                               dtype=torch.float32, device=dev),
                    sim.boxsize, atime, nlevels=sim.gravity.tree_nlevels,
                    ncrit=sim.gravity.tree_ncrit)
                adf = dynamical_friction(pall.vel[idx], rho, sigma,
                                         gas.bh_mass[idx], atime, G)
                vel = pall.vel.clone()
                vel[idx] += adf * dtime[:, None]
                sim.particles = pall.replace(vel=vel)
        return gas.replace(entropy=entropy, bh_mass=bh_mass,
                           bh_mdot=bh_mdot)

    # ---------- gas -> star conversion ----------
    def _convert_stars_device(self, sim, gas: GasState, res, atime) -> int:
        """Gas -> star conversion on the device (make_particle_star +
        slots_split_particle, sfr_eff.cpp:604; the JAX package's
        `_convert_stars_kernel`, simulation_gas.py:65-137).  Whole
        conversions flip the gas row in place; splits copy the parent row
        onto the first free rows in ascending order, take mass_of_star
        from the parent, bump the parent's generation and tag the child
        ID with the generation in its top byte.  The caller guarantees
        enough free rows (at most _KSPAWN splits)."""
        p = sim.particles
        n = p.n
        ng = gas.ngas
        dev = p.device
        conv_w = res.form_star & res.convert_whole
        conv_s = res.form_star & ~res.convert_whole
        full_w = torch.zeros(n, dtype=torch.bool, device=dev)
        full_w[:ng] = conv_w
        gmet_full = torch.zeros(n, dtype=gas.metallicity.dtype, device=dev)
        gmet_full[:ng] = gas.metallicity
        at32 = float(np.float32(atime))
        ptype = torch.where(full_w, STAR, p.ptype).to(p.ptype.dtype)
        birth = torch.where(full_w, at32, gas.birth_a)
        enr = torch.where(full_w, 0.0, gas.last_enrich_myr)
        m0 = torch.where(full_w, p.mass, gas.mass0)
        smet = torch.where(full_w, gmet_full, gas.star_metallicity)
        sfr = torch.where(conv_w, 0.0, gas.sfr)
        src = torch.nonzero(conv_s).squeeze(1)
        nspawn = src.shape[0]
        ipos, vel, hsml, tb = p.ipos, p.vel, p.hsml, p.timebin
        idlo, idhi, mass, mask = p.id_lo, p.id_hi, p.mass, p.mask
        gen, delay = gas.generation, gas.delay_time
        bhm, bhmd = gas.bh_mass, gas.bh_mdot
        if nspawn:
            dst = torch.nonzero(~mask).squeeze(1)[:nspawn]
            ms = res.mass_of_star[src]
            gen_child = gen[src] + 1
            mass = mass.clone()
            mass[src] = mass[src] - ms
            gen = gen.clone()
            gen[src] = gen_child
            mask = mask.clone()
            mask[dst] = True
            ptype[dst] = STAR
            mass[dst] = ms
            ipos, vel, hsml, tb, idlo = (a.clone() for a in
                                         (ipos, vel, hsml, tb, idlo))
            ipos[dst] = ipos[src]
            vel[dst] = vel[src]
            hsml[dst] = hsml[src]
            tb[dst] = tb[src]
            idlo[dst] = idlo[src]
            idhi = idhi.clone()
            idhi[dst] = wrap_i32((idhi[src].long() & 0xFFFFFFFF)
                                 | (gen_child.long() << 24))
            birth[dst] = at32
            enr[dst] = 0.0
            m0[dst] = ms
            smet[dst] = gas.metallicity[src]
            # reused gas-prefix rows become stars: scrub stale gas state
            dst_g = dst[dst < ng]
            sfr[dst_g] = 0.0
            delay, bhm, bhmd = delay.clone(), bhm.clone(), bhmd.clone()
            delay[dst_g] = 0.0
            bhm[dst_g] = 0.0
            bhmd[dst_g] = 0.0
        sim.particles = p.replace(
            ipos=ipos, vel=vel, hsml=hsml, timebin=tb, id_lo=idlo,
            id_hi=idhi, mass=mass, mask=mask, ptype=ptype)
        gas.birth_a, gas.last_enrich_myr, gas.mass0 = birth, enr, m0
        gas.star_metallicity, gas.generation, gas.sfr = smet, gen, sfr
        gas.delay_time, gas.bh_mass, gas.bh_mdot = delay, bhm, bhmd
        nstars = int(torch.sum(conv_w)) + nspawn
        sim.star_formation_times = getattr(
            sim, "star_formation_times", []) + [atime] * nstars
        return nstars

    def _convert_stars(self, sim, gas: GasState, res, atime) -> int:
        """Gas -> star conversion through host arrays (the JAX package's
        `_convert_stars`, simulation_gas.py:1347-1465, the path it takes
        when the device conversion's spawn cap or its free rows run
        out): the same rows as `_convert_stars_device`, growing the
        arrays when the free rows are too few."""
        convert = res.form_star.cpu().numpy()
        if not convert.any():
            return 0
        ng = gas.ngas
        whole = res.convert_whole.cpu().numpy()
        mstar = res.mass_of_star.cpu().numpy()
        idx_whole = np.nonzero(convert & whole)[0]
        idx_split = np.nonzero(convert & ~whole)[0]
        nspawn = len(idx_split)
        if nspawn and int((~sim.particles.mask).sum()) < nspawn:
            self._grow_star_capacity(
                sim, gas, max(nspawn - int((~sim.particles.mask).sum()), 1))
        p = sim.particles
        dev = p.device

        def h(x):
            return x.cpu().numpy().copy()

        ptype, mask, massv = h(p.ptype), h(p.mask), h(p.mass)
        birth, enr, m0 = h(gas.birth_a), h(gas.last_enrich_myr), h(gas.mass0)
        smet, gmet = h(gas.star_metallicity), h(gas.metallicity)
        gen, sfr = h(gas.generation), h(gas.sfr)
        delay, bhm, bhmd = h(gas.delay_time), h(gas.bh_mass), h(gas.bh_mdot)
        at32 = np.float32(atime)
        # --- whole conversions: flip in place ---
        ptype[idx_whole] = STAR
        birth[idx_whole] = at32
        enr[idx_whole] = 0.0
        m0[idx_whole] = massv[idx_whole]
        smet[idx_whole] = gmet[idx_whole]
        sfr[idx_whole] = 0.0
        new = {"ptype": ptype, "mask": mask, "mass": massv}
        if nspawn:
            rows = np.nonzero(~mask)[0][:nspawn]
            # scrub stale gas state on reused gas-prefix rows
            reused = rows[rows < ng]
            sfr[reused] = 0.0
            delay[reused] = 0.0
            bhm[reused] = 0.0
            bhmd[reused] = 0.0
            ipos, vel, hsml = h(p.ipos), h(p.vel), h(p.hsml)
            tb, idlo, idhi = h(p.timebin), h(p.id_lo), h(p.id_hi)
            ms = mstar[idx_split]
            ipos[rows] = ipos[idx_split]
            vel[rows] = vel[idx_split]
            hsml[rows] = hsml[idx_split]
            tb[rows] = tb[idx_split]
            massv[rows] = ms
            massv[idx_split] -= ms
            mask[rows] = True
            ptype[rows] = STAR
            # child id: the parent's with the generation in the top byte
            gen_child = gen[idx_split] + 1
            idlo[rows] = idlo[idx_split]
            idhi[rows] = (idhi[idx_split].view(np.uint32)
                          | (gen_child.astype(np.uint32) << 24)
                          ).view(np.int32)
            gen[idx_split] = gen_child
            birth[rows] = at32
            enr[rows] = 0.0
            m0[rows] = ms
            smet[rows] = gmet[idx_split]
            new.update(ipos=ipos, vel=vel, hsml=hsml, timebin=tb,
                       id_lo=idlo, id_hi=idhi)
        sim.particles = p.replace(**{k: torch.from_numpy(v).to(dev)
                                     for k, v in new.items()})
        for name, v in (("birth_a", birth), ("last_enrich_myr", enr),
                        ("mass0", m0), ("star_metallicity", smet),
                        ("generation", gen), ("sfr", sfr),
                        ("delay_time", delay), ("bh_mass", bhm),
                        ("bh_mdot", bhmd)):
            setattr(gas, name, torch.from_numpy(v).to(dev))
        nstars = len(idx_whole) + nspawn
        sim.star_formation_times = getattr(
            sim, "star_formation_times", []) + [atime] * nstars
        return nstars

    def _grow_star_capacity(self, sim, gas: GasState, need: int):
        """Add spare rows (SlotsIncreaseFactor analog, run.cpp:236):
        every particle array and the star bookkeeping arrays take
        max(n/8, need, 1024) dead rows more, rounded up to 128."""
        p = sim.particles
        old = p.n
        extra = max(old // 8, need, 1024)
        extra = ((extra + 127) // 128) * 128

        def pad(a):
            z = torch.zeros((extra,) + tuple(a.shape[1:]), dtype=a.dtype,
                            device=a.device)
            return torch.cat([a, z])

        sim.particles = p.replace(**{
            f.name: pad(getattr(p, f.name)) for f in dataclasses.fields(p)
            if getattr(p, f.name).shape[0] == old})
        for name in _STAR_ROWS:
            setattr(gas, name, pad(getattr(gas, name)))

    def slots_gc(self, sim, gas: GasState):
        """Compact the spare tail (slots_gc, slotsmanager.cpp:133): the
        arrays shrink when the rows past the last alive one are more
        than a quarter of the total (run.cpp:704 runs it before
        outputs)."""
        p = sim.particles
        alive = torch.nonzero(p.mask)
        last = int(alive[-1, 0]) + 1 if alive.numel() else 0
        new_n = max(last, sim.n_real, gas.ngas)
        new_n = ((new_n + 127) // 128) * 128
        if new_n >= p.n or (p.n - new_n) < p.n // 4:
            return
        new = {f.name: getattr(p, f.name)[:new_n]
               for f in dataclasses.fields(p)
               if getattr(p, f.name).shape[0] == p.n}
        sim.particles = p.replace(**new)
        for name in _STAR_ROWS:
            v = getattr(gas, name)
            if v.shape[0] > new_n:
                setattr(gas, name, v[:new_n])
