"""Gas stages for the Simulation driver (shenqi_tpu/simulation_gas.py in
torch, run.cpp's gas sections), adiabatic gas only.

Per step (run.cpp:458-681):
  * density with adaptive smoothing lengths (run.cpp:488) and the hydro
    force (run.cpp:505), both on the grid stencil and for the active
    gas only; sources are always all gas at predicted quantities;
  * the hydro kick and entropy update in Simulation._apply_half_kick.

Gas rows occupy the array prefix [0, ngas).  The pressure-entropy IC
fixed point (`setup_density_indep_entropy`) runs on the blocked octree
walk, as in the JAX package.  Cooling, star formation, winds, black
holes, metal return, helium and excursion-set reionization are ROADMAP
A.8: GasPhysics refuses any of their switches, and with all of them off
the source terms leave the state as the JAX package does (each of its
stages returns early).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ._device import resolve_device
from .core.particles import GAS
from .core.timeline import TIMEBINS
from .core.integrate import predictor_tables
from .ops.tree import build_octree
from .sph.kernels import CUBIC
from .sph.density import density as sph_density, density_walk_blocked
from .sph.hydro import (HydroParams, HydroResult, hydro_time_factors,
                        hydro_walk_dense, balsara_f1, pressure_predict)
from .sph.stencil_hydro import stencil_hydro_walk
from .utils.constants import GAMMA, GAMMA_MINUS1

# the full-length star arrays slots_gc cuts with the particle arrays
_STAR_ROWS = ("birth_a", "last_enrich_myr", "mass0", "total_returned",
              "star_metallicity")


@dataclass
class GasState:
    """SoA gas fields for the [0, ngas) prefix rows (every field of the
    JAX GasState; the subgrid ones stay at their initial values until
    ROADMAP A.8 brings the stages that change them)."""

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
    """Configuration + stage implementations for adiabatic gas."""

    density_independent_sph: bool = True
    eta: float = 1.0
    ngb_deviation: float = 2.0
    art_bulk_visc: float = 0.75
    density_contrast_limit: float = 100.0
    kernel: object = CUBIC
    # the subgrid master switches (ROADMAP A.8): refused when on
    cooling_on: bool = False
    sfr_on: bool = False
    winds_on: bool = False
    bh_on: bool = False
    metal_return_on: bool = False
    helium: object = None
    excursion: object = None

    def __post_init__(self):
        on = [n for n in ("cooling_on", "sfr_on", "winds_on", "bh_on",
                          "metal_return_on", "helium", "excursion")
              if getattr(self, n)]
        if on:
            raise NotImplementedError(
                f"GasPhysics: {', '.join(on)}: subgrid physics is not "
                f"ported yet (ROADMAP A.8)")
        self._density_caps = {}
        self._hydro_stencil_caps = {}
        # what the last IC fixed point did (host numbers it synced for
        # its stop test anyway)
        self.last_fixed_point = {}

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
               "dloga": dloga_tab}
        fields = torch.stack(
            [mass_g, hsml, vel_g[:, 0], vel_g[:, 1], vel_g[:, 2],
             gas.density, eom_dens, entvar, press, gas.div_vel,
             gas.curl_vel, gas.dhsml_egy, dloga_tab], dim=1).to(
                 torch.float32)
        targets = {"ipos": ipos_g, "vel": vel_g, "hsml": hsml,
                   "mass": mass_g, "density": gas.density,
                   "egyrho": eom_dens, "entvar": entvar, "pressure": press,
                   "f1": f1, "dhsml": gas.dhsml_egy, "dloga": dloga_tab}
        targets = {k: pick(v) for k, v in targets.items()}
        hres, cover, n_cover, _ = stencil_hydro_walk(
            ipos_g, fields, targets, par, spec=self.kernel,
            tier_cache=self._hydro_stencil_caps, tf=tf,
            tvalid=pick(gas_alive & (hsml > 0)))
        if n_cover:
            # redo the flagged targets against every source (the JAX
            # package's oracle_patch, simulation_gas.py:513-540)
            cs_ = torch.nonzero(cover).squeeze(1)
            hs = hydro_walk_dense(src, {k: v[cs_] for k, v in
                                        targets.items()},
                                  par, self.kernel, tf=tf)
            hres = HydroResult(*(a.index_put((cs_,), b)
                                 for a, b in zip(hres, hs)))
        live = pick(gas_alive)
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
