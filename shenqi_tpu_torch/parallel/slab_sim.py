"""The multi-device slab simulation loop, its dark-matter half
(shenqi_tpu/parallel/slab_sim.py in torch.distributed).

Each rank is a process that owns the rows of its x-slab
(parallel/domain.py) as a ParticleData of exactly those rows.  The
stage order is the single-device loop's (core/step_protocol.py, shared
through simulation.Simulation); this class swaps in the distributed
stages (slab_sim.py:2074-2164):

  forces  on PM steps the random box offset (slab_sim.py:372-398) and,
          on cost-balanced slabs, new cuts from the drifted column
          histogram (_rebalance_cuts, :2055); then EVERY step the
          exchange that re-homes rows (run.cpp:434-451); the slab PM with
          the pencil FFT on PM steps (pfft.pm_forces_slab; with the
          neutrino linear response, one deposit serves the CDM power
          and the forces, :615-746); the grid-stencil short range on
          this rank's rows plus the rcut ghosts (sharded.
          stencil_forces_slab), per hierarchical level with the level's
          rows as the only sources (:1718-2053)
  steps   drift and kicks are per row; every decision the host takes
          from data comes from all-reduced values, so every rank takes
          the same branch: the bin histograms (hence the largest active
          bin, the push-down, the levels and their counts), the PM
          step's rms-velocity criterion, the bad-timestep count, the
          cost-balance histogram; the offset is drawn from the integer
          timeline, which every rank shares

  gas     with gas rows (from_species, :271-365), each rank's gas rows
          are the prefix [0, ngas) of its rows, as on one device, so the
          single-device GasState, hydro kick, entropy update, MaxGasVel
          cap and Courant limit (simulation.py) run unchanged on it; the
          gas columns travel in the exchange and a stable gas-first
          partition rebuilds the prefix after it.  Every step, after the
          exchange and before PM, the gas stage (_gas_density_hydro,
          :781-1005) runs the slab density loop and hydro on ALL the
          rank's gas rows (parallel/sph_slab.py), with the IC entropy
          fixed point at fixed hsml on the first step.

The JAX loop's fixed caps (SlabCaps, :101-121) and their regrow
protocol (_grow_from_diag, :543) are gone: exchanges have exact split
sizes, and the stencil sizes its caps per rank at run time.  The
subgrid, black-hole, helium and excursion stages (:1006-1717) are later
slices (ROADMAP A.9.3-A.9.4).

Where the slab gas departs from the single-device loop, it follows the
JAX slab loop: the first hsml is 1.5 mean gas separations (2 on one
device), the drift does not predict hsml (:1718-1727), density and
hydro walk every gas row each step (:801, :826-835), and the first
step's hydro force takes the fixed point's entropy (the single-device
loop's takes u, ROADMAP C.4).  The hsml bracket ceiling is the
single-device one (sph_slab.density_slab).  The JAX slab loop runs its
gas stage after the force program, so its predictors read this step's
PM and tree accelerations; the port runs it before PM, as run.cpp:
482-505 and the single-device loop do, so they read the previous
step's, as the JAX method's docstring says they should.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..core.integrate import DriftKickTimes, TimestepParams
from ..core.particles import (DM, GAS, ParticleData, float_to_ipos, u32,
                              u32_numpy_to_i32)
from ..core.timeline import TIMEBINS
from ..gravity.pm import finalize_power
from ..gravity.treepm import (GravityConfig, default_softening,
                              get_window_tables)
from ..simulation import Simulation
from ..utils.constants import CM_PER_MPC, GAMMA
from . import collectives as cc
from .domain import (balance_cuts, collect_alive, cuts_fp_from_planes,
                     distribute_slabs, exchange)
from .pfft import pm_depose_slab, pm_forces_from_rhok, pm_forces_slab
from .sharded import stencil_forces_slab

# x-column granularity of the cost-balance histogram (the topleaf
# count analog): fine enough to split a clustered mesh plane
_BALANCE_COLS = 4096
# the GasState columns the slab gas carries with its rows (those A.9.2
# reads; the subgrid ones start at their defaults after each exchange)
_GAS_ROWS = ("entropy", "density", "egy_wt_density", "dhsml_egy",
             "div_vel", "curl_vel", "hydro_accel", "dt_entropy",
             "max_signal_vel", "dt_hsml", "gradrho_mag")


def _column_hist(ipos_x, alive, device) -> np.ndarray:
    """The x-column histogram of the alive rows, summed over ranks."""
    cols = (u32(ipos_x[alive]) * _BALANCE_COLS) >> 32
    hist = torch.bincount(cols, minlength=_BALANCE_COLS).to(device)
    return cc.all_sum(hist).cpu().numpy()


class SharedHCI:
    """The human control interface of a slab run: rank 0 polls the files
    and the clock (hci.cpp's rank-0 semantics) and every rank acts on
    its answer."""

    def __init__(self, hci, device):
        self.hci, self.device = hci, device

    def query(self) -> int:
        action = self.hci.query() if cc.rank() == 0 else 0
        return cc.broadcast_int(action, self.device)


@dataclass
class SlabSimulation(Simulation):
    """Distributed DM TreePM run over the ranks of the process group."""
    ndev: int = 1
    balance_domains: bool = False   # cost-balanced slab cuts
    cuts_planes: Optional[np.ndarray] = None   # [D+1] column cuts
    cuts_fp: Optional[np.ndarray] = None       # [D-1] uint32 cuts
    # (step, kind, targets on this rank, ghosts, host seconds) of each
    # short-range call; kind is 'full' or 'level'
    force_log: list = field(default_factory=list)
    # (step, rows this rank sent, host seconds) of each exchange
    exchange_log: list = field(default_factory=list)
    # per gas stage: step, this rank's gas rows, density and hydro
    # ghosts, hsml-loop iterations and strips, fixed-point iterations,
    # host seconds of density, the fixed point and hydro
    sph_log: list = field(default_factory=list)
    # what the last IC fixed point did: iterations, converged, maxdiff
    last_fixed_point: dict = field(default_factory=dict)
    # the slab loop's drift does not predict hsml (slab_sim.py:1718-1727)
    _DRIFT_HSML = False

    def __post_init__(self):
        if self.gravity.engine != "stencil":
            raise NotImplementedError(
                f"engine {self.gravity.engine!r} on --mesh: the slab run "
                "has the stencil engine only (ROADMAP A.10)")

    @classmethod
    def from_arrays(cls, pos, vel, mass, ids, CP, boxsize, nmesh,
                    timeline, atime, tsp: Optional[TimestepParams] = None,
                    gravity_kw: Optional[dict] = None,
                    balance_domains: bool = True, device=None, ptype=None):
        """This rank's part of a DM run from the GLOBAL host arrays, which
        every rank reads (slab_sim.py:212-268): the cost-balanced cuts
        from the x-column histogram when there is more than one rank,
        then the rows of this rank's slab, Morton-sorted.  ptype: each
        row's type, routed with its row (every row DM when None)."""
        dev = resolve_device(device)
        D, me = cc.world_size(), cc.rank()
        n = len(pos)
        ipos = float_to_ipos(pos, boxsize, device="cpu").numpy()
        mass = (np.asarray(mass, np.float32) if np.ndim(mass)
                else np.full(n, mass, np.float32))
        ids = np.asarray(ids, np.uint64)
        balance = balance_domains and D > 1
        cuts_planes = cuts = None
        if balance:
            ipx = ipos[:, 0].view(np.uint32)[mass > 0]
            cols = (ipx.astype(np.uint64) * np.uint64(_BALANCE_COLS)
                    >> np.uint64(32)).astype(np.int64)
            cuts_planes = balance_cuts(
                np.bincount(cols, minlength=_BALANCE_COLS), D)
            cuts = cuts_fp_from_planes(cuts_planes, _BALANCE_COLS)
        loc = distribute_slabs(
            {"ipos": ipos, "vel": np.asarray(vel, np.float32),
             "mass": mass,
             "id_lo": u32_numpy_to_i32(
                 (ids & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
             "id_hi": u32_numpy_to_i32(
                 (ids >> np.uint64(32)).astype(np.uint32)),
             "ptype": (np.full(n, DM, np.int8) if ptype is None
                       else np.asarray(ptype, np.int8))},
            D, me, cuts)
        nl = len(loc["mass"])

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        p = ParticleData.zeros(nl, device=dev).replace(
            ipos=t(loc["ipos"].view(np.int32)), vel=t(loc["vel"]),
            mass=t(loc["mass"]),
            mask=torch.ones(nl, dtype=torch.bool, device=dev),
            ptype=t(loc["ptype"]),
            timebin=torch.ones(nl, dtype=torch.int8, device=dev),
            id_lo=t(loc["id_lo"]), id_hi=t(loc["id_hi"]))
        gkw = dict(boxsize=boxsize, nmesh=nmesh, G=CP.GravInternal,
                   softening=default_softening(boxsize, n),
                   tree_nlevels=min(20, max(6, int(np.ceil(
                       np.log(max(n // D, 8) / 16) / np.log(8))) + 4)),
                   tree_ncrit=32)
        if gravity_kw:
            gkw.update(gravity_kw)
        ti = timeline.ti_from_loga(np.log(atime))
        sim = cls(CP=CP, boxsize=boxsize, timeline=timeline,
                  times=DriftKickTimes.init(ti),
                  gravity=GravityConfig(**gkw), tsp=tsp or TimestepParams(),
                  particles=p, ndev=D, balance_domains=balance,
                  cuts_planes=cuts_planes, cuts_fp=cuts)
        sim.n_real = nl
        return sim

    @classmethod
    def from_species(cls, species, CP, boxsize, nmesh, timeline, atime,
                     tsp=None, gravity_kw=None, gas_u0=None,
                     gas_physics=None, balance_domains: bool = True,
                     device=None):
        """This rank's part of a multi-species run (slab_sim.py:271-365):
        species = [(ptype, pos, vel, mass, ids), ...], every rank reading
        the global arrays.  The ptype column travels with its rows; the
        rank's gas rows move to the prefix, their first hsml 1.5 mean
        gas separations; the entropy holds u0 (gas_u0, internal units)
        until the first density pass converts it (the init_gas_entropy
        protocol, init.cpp:230).  gas_physics: the SPH configuration
        (simulation_gas.GasPhysics); only its SPH part runs here."""
        pos = np.concatenate([np.asarray(s_[1]) for s_ in species])
        vel = np.concatenate([np.asarray(s_[2]) for s_ in species])
        mass = np.concatenate([
            np.full(len(s_[1]), s_[3], np.float32) if np.ndim(s_[3]) == 0
            else np.asarray(s_[3], np.float32) for s_ in species])
        ids = np.concatenate([np.asarray(s_[4], np.uint64)
                              for s_ in species])
        ptype = np.concatenate([np.full(len(s_[1]), s_[0], np.int8)
                                for s_ in species])
        sim = cls.from_arrays(pos, vel, mass, ids, CP, boxsize, nmesh,
                              timeline, atime, tsp=tsp,
                              gravity_kw=gravity_kw,
                              balance_domains=balance_domains,
                              device=device, ptype=ptype)
        n_gas = int((ptype == GAS).sum())
        if n_gas:
            p = sim.particles
            is_gas = p.ptype == GAS
            sep = boxsize / n_gas ** (1.0 / 3.0)
            sim.particles = p.replace(hsml=torch.where(
                is_gas, float(np.float32(1.5 * sep)), 0.0))
            u0 = 1.0 if gas_u0 is None else float(np.float32(gas_u0))
            sim._gas_first({"entropy": torch.where(is_gas, u0, 0.0)})
            sim._gas_entropy_is_u = gas_u0 is not None
            sim.gas_physics = gas_physics
        return sim

    # ------------------------------------------------- rank reductions
    def _sum_ranks(self, v: int) -> int:
        return cc.sum_int(v, self.device)

    def _bin_hist(self, bins, *masks) -> np.ndarray:
        h = super()._bin_hist(bins, *masks)
        return cc.all_sum(torch.from_numpy(h).to(self.device)).cpu().numpy()

    @staticmethod
    def _reduce_type_stats(stats):
        """Sum the (sum v^2, count) columns and take the min mass."""
        return torch.cat([cc.all_sum(stats[:, :2]),
                          cc.all_min(stats[:, 2:])], dim=1)

    # --------------------------------------------------------- domain
    def _exchange(self):
        """Re-home every row to its owner slab; each row keeps all its
        fields, its gas columns included, and the gas rows move back to
        the prefix (_gas_first).  One rank has nothing to move."""
        if self.ndev == 1:
            return 0
        p = self.particles
        fields = {f.name: getattr(p, f.name)
                  for f in dataclasses.fields(p)}
        g = self.gas
        if g is not None:
            for name in _GAS_ROWS:
                v = getattr(g, name)
                fields["gas_" + name] = torch.cat(
                    [v, v.new_zeros((p.n - g.ngas,) + v.shape[1:])])
        fields, info = exchange(fields, self.ndev, self.cuts_fp)
        cols = {n: fields.pop("gas_" + n) for n in _GAS_ROWS
                if "gas_" + n in fields}
        self.particles = ParticleData(**fields)
        if g is not None:
            self._gas_first(cols)
        self.n_real = self.particles.n
        return info["sent"]

    def _gas_first(self, cols: dict):
        """Partition this rank's rows stably, alive gas first, and make
        the GasState of the new prefix from cols, [n] columns of
        _GAS_ROWS over all rows (the missing ones start at GasState's
        defaults)."""
        from ..simulation_gas import GasState
        p = self.particles
        is_gas = (p.ptype == GAS) & p.mask
        perm = torch.argsort((~is_gas).to(torch.int32), stable=True)
        ng = int(is_gas.sum())
        self.particles = ParticleData(**{
            f.name: getattr(p, f.name)[perm] for f in dataclasses.fields(p)})
        g = GasState.create(ng, cols["entropy"][perm][:ng], ntot=p.n,
                            device=p.device)
        self.gas = g.replace(**{n: v[perm][:ng] for n, v in cols.items()})

    def _rebalance_cuts(self):
        """New cuts from the drifted column histogram (slab_sim.py:
        2055-2071), summed over ranks so every rank cuts alike; the
        exchange that follows moves the rows."""
        p = self.particles
        self.cuts_planes = balance_cuts(
            _column_hist(p.ipos[:, 0], p.mask, self.device), self.ndev)
        self.cuts_fp = cuts_fp_from_planes(self.cuts_planes, _BALANCE_COLS)

    # --------------------------------------------------------- forces
    def _compute_pm(self, record_power=True):
        p = self.particles
        cfg = self.gravity.pm()
        if self.nu_table is not None:
            rho_k, ps_cdm, ctx = pm_depose_slab(
                p.ipos, p.mass, cfg, self.ndev, 2, p.mask, self.cuts_fp)
            nu_k, nu_fac = self._nu_factor_tables(ps_cdm)
            accel, ps = pm_forces_from_rhok(rho_k, ctx, cfg, self.ndev,
                                            nu_k, nu_fac, want_power=True)
        else:
            accel, ps = pm_forces_slab(p.ipos, p.mass, cfg, self.ndev, 2,
                                       p.mask, True, self.cuts_fp)
        self.particles = p.replace(grav_pm=accel)
        if record_power:
            mpc = CM_PER_MPC / 3.085678e21
            kk, power, nmodes = finalize_power(ps, cfg, self.boxsize / mpc)
            self.power_history.append((self.atime(), kk, power, nmodes))

    def _nu_factor_tables(self, ps):
        """The neutrino response of this PM solve from the CDM power
        (slab_sim.py:682-745): advance the delta_nu integral on the host
        and return the (|k|, factor) knots the pencil interpolates; a
        knot at k = 0 carries (Mtot/Mcdm) for the DC mode
        (gravpm.cpp:412,431), one just above it the flat left clamp."""
        nt = self.nu_table
        kk = ps.k.double().cpu().numpy() * (2 * np.pi / self.boxsize)
        pw = ps.power.double().cpu().numpy()
        nm = ps.nmodes.double().cpu().numpy()
        sel = nm > 0
        delta_meas = np.sqrt(pw[sel] / nm[sel] / max(float(ps.norm), 1e-300))
        delta_cdm = np.interp(nt.wavenum, kk[sel], delta_meas)
        atime = self.atime()
        nt.update(atime, delta_cdm)
        fac1d = nt.potential_factor(atime, delta_cdm)
        mtot_by_mcdm = self.CP.Omega0 / (
            self.CP.Omega0
            - atime ** 3 * self.CP.ONu.get_omega_nu_nopart(atime))
        w0 = float(np.asarray(nt.wavenum)[0])
        k_tab = np.concatenate([[0.0, 1e-3 * w0], np.asarray(nt.wavenum)])
        f_tab = np.concatenate([[mtot_by_mcdm, fac1d[0]], np.asarray(fac1d)])
        return (torch.from_numpy(k_tab.astype(np.float32)).to(self.device),
                torch.from_numpy(f_tab.astype(np.float32)).to(self.device))

    def _slab_stencil(self, mass, sp, kind: str):
        if self.window_tables is None and \
                self.gravity.window_type == "exact":
            self.window_tables = get_window_tables(self.gravity,
                                                   device=self.device)
        t0 = time.perf_counter()
        acc, info = stencil_forces_slab(
            {"ipos": self.particles.ipos, "mass": mass}, sp,
            self.window_tables, self.ndev, self.cuts_fp,
            sub=self.gravity.refine_sub, tier_cache=self._tier_cache,
            caps_cache=self._caps_cache, _plain=self._plain_p2p)
        self.force_log.append((self.step_count, kind, info["targets"],
                               info["ghosts"], time.perf_counter() - t0))
        return acc

    def _compute_tree(self, first_step: bool):
        """The short range with every alive row a target (the JAX slab
        loop's; the single-device loop may take only the active rows)."""
        p = self.particles
        acc = self._slab_stencil(
            torch.where(p.mask, p.mass, 0.0),
            self.gravity.short(use_bh=1 if first_step else None), "full")
        self.particles = p.replace(grav_accel=acc)
        self.last_n_targets = None

    def _active_source_accel(self, sel, n_act: int):
        return self._slab_stencil(
            torch.where(sel, self.particles.mass, 0.0),
            self.gravity.short(), "level")

    # ------------------------------------------------------------ gas
    def _gas_density_hydro(self, first: bool):
        """Density with adaptive hsml, then the hydro force, on every gas
        row of this rank (slab_sim.py:781-1005): velocities and entropies
        predicted to the drift time from the last kicks, the slab density
        loop, on the first step the IC entropy fixed point
        (_fixed_point), then the Balsara and viscosity-limiter inputs and
        the slab hydro pass.  Hydro-decoupled wind rows are A.9.3: no row
        is decoupled here."""
        from ..core.integrate import predictor_tables
        from ..sph.hydro import (HydroParams, balsara_f1,
                                 hydro_time_factors, pressure_predict)
        from .sph_slab import density_slab, hydro_slab
        p, gas, gp = self.particles, self.gas, self.gas_physics
        ng, dev = gas.ngas, self.device
        rec = {"step": self.step_count, "gas": ng, "fp_iter": 0,
               "fp_s": 0.0}
        t0 = time.perf_counter()
        gk, hk, de, gk_pm = predictor_tables(self.CP, self.timeline,
                                             self.times, device=dev)
        bins = p.timebin[:ng].long()
        vel_g = (p.vel[:ng] + p.grav_accel[:ng] * gk[bins][:, None]
                 + p.grav_pm[:ng] * float(np.float32(gk_pm))
                 + gas.hydro_accel * hk[bins][:, None])
        # floor: the prediction must never drive entropy negative
        ent_pred = torch.maximum(gas.entropy + gas.dt_entropy * de[bins],
                                 0.25 * gas.entropy)
        entvar = torch.pow(torch.clamp(ent_pred, min=1e-35), 1.0 / GAMMA)
        ipos_g, mass_g = p.ipos[:ng], p.mass[:ng]
        dout, dinfo = density_slab(
            {"ipos": ipos_g, "mass": mass_g, "vel": vel_g,
             "entvar": entvar}, p.hsml[:ng], self.boxsize, self.ndev,
            self.cuts_fp, spec=gp.kernel, eta=gp.eta,
            ngb_deviation=gp.ngb_deviation,
            do_egy_density=gp.density_independent_sph,
            caps=gp._density_caps)
        hsml = dout.hsml
        gas = gas.replace(
            density=dout.density, egy_wt_density=dout.egy_wt_density,
            dhsml_egy=dout.dhsml_egy_density_factor,
            div_vel=dout.div_vel, curl_vel=dout.curl_vel,
            dt_hsml=dout.dt_hsml,
            gradrho_mag=torch.linalg.norm(dout.grad_rho, dim=-1))
        self.particles = p.replace(hsml=torch.cat([hsml, p.hsml[ng:]]))
        rec.update(dens_ghosts=dinfo["ghosts"], dens_cover=dinfo["cover"],
                   niter=dinfo["niter"],
                   strips=dinfo["exchanges"],
                   density_s=time.perf_counter() - t0)
        if self._gas_entropy_is_u and first:
            t1 = time.perf_counter()
            gas = self._fixed_point(gas, hsml, dinfo["level"])
            # the hydro force takes the converted entropy (slab_sim.py:
            # 943-944)
            entvar = torch.pow(torch.clamp(gas.entropy, min=1e-35),
                               1.0 / GAMMA)
            rec.update(fp_iter=self.last_fixed_point["iterations"],
                       fp_s=time.perf_counter() - t1)

        t2 = time.perf_counter()
        atime = self.atime()
        par = HydroParams(boxsize=self.boxsize,
                          art_bulk_visc_const=gp.art_bulk_visc,
                          density_contrast_limit=gp.density_contrast_limit,
                          density_independent_sph=gp.density_independent_sph)
        tf = hydro_time_factors(atime, float(self.CP.hubble_function(atime)))
        eom = (gas.egy_wt_density if gp.density_independent_sph
               else gas.density)
        eom_c = torch.clamp(eom, min=1e-35)
        press = pressure_predict(eom_c, entvar)
        f1 = balsara_f1(gas.div_vel, gas.curl_vel,
                        torch.sqrt(GAMMA * press / eom_c), hsml,
                        tf["fac_mu"])
        # the viscosity limiter's per-row bin dloga (hydratree2.hpp:
        # 334-343); bin 0 gives 0, the limiter off
        dl_bin = np.zeros(TIMEBINS + 1, np.float32)
        for b in range(1, TIMEBINS + 1):
            dl_bin[b] = self.timeline.get_dloga_for_bin(
                b, self.times.ti_current)
        dloga = torch.from_numpy(dl_bin).to(dev)[
            torch.clamp(bins, 0, TIMEBINS)]
        src = {"ipos": ipos_g, "mass": mass_g, "vel": vel_g, "hsml": hsml,
               "density": gas.density, "eomdensity": eom, "entvar": entvar,
               "pressure": press, "divvel": gas.div_vel,
               "curlvel": gas.curl_vel, "dhsml_egy": gas.dhsml_egy,
               "dloga": dloga,
               "decoupled": torch.zeros(ng, dtype=torch.bool, device=dev)}
        targets = {"ipos": ipos_g, "vel": vel_g, "hsml": hsml,
                   "mass": mass_g, "density": gas.density, "egyrho": eom,
                   "entvar": entvar, "pressure": press, "f1": f1,
                   "dhsml": gas.dhsml_egy, "dloga": dloga}
        hres, hinfo = hydro_slab(src, targets, par, tf, self.boxsize,
                                 self.ndev, self.cuts_fp, spec=gp.kernel,
                                 k=dinfo["level"],
                                 caps=gp._hydro_stencil_caps,
                                 tvalid=hsml > 0)
        self.gas = gas.replace(hydro_accel=hres.accel,
                               dt_entropy=hres.dt_entropy,
                               max_signal_vel=hres.max_signal_vel)
        rec.update(hydro_ghosts=hinfo["ghosts"], hydro_cover=hinfo["cover"],
                   long_reach=hinfo["long"],
                   hydro_s=time.perf_counter() - t2)
        self.sph_log.append(rec)

    def _fixed_point(self, gas, hsml, k: int):
        """The IC entropy fixed point of the rank's gas at fixed hsml
        (sph_slab.entropy_fixed_point); the entropy holds u0 until
        here."""
        from .sph_slab import entropy_fixed_point
        gp = self.gas_physics
        ng = gas.ngas
        p = self.particles
        entropy, egywt, self.last_fixed_point = entropy_fixed_point(
            {"ipos": p.ipos[:ng], "mass": p.mass[:ng]}, gas.entropy,
            gas.density, hsml, self.atime() ** 3, self.boxsize, self.ndev,
            self.cuts_fp, spec=gp.kernel, k=k, caps=gp._density_caps,
            density_independent=gp.density_independent_sph)
        self._gas_entropy_is_u = False
        return gas.replace(entropy=entropy, egy_wt_density=egywt)

    def _slots_gc(self):
        """A rank holds exactly its rows: nothing to reclaim."""

    def proto_forces(self, is_pm, first):
        if is_pm:
            # the reference redraws the box shift at each full domain
            # decomposition, i.e. every PM step (run.cpp:426-428)
            self._apply_random_offset()
            if self.balance_domains and not first:
                self._rebalance_cuts()
        t0 = time.perf_counter()
        sent = self._exchange()
        self.exchange_log.append((self.step_count, sent,
                                  time.perf_counter() - t0))
        self._wt("Domain")
        if self.gas is not None and self.gas_physics is not None:
            # on the freshly slab-owned gas (run.cpp:482-505)
            self._gas_density_hydro(first)
            self._wt("SPH")
        if is_pm:
            self._compute_pm()
            self._wt("PMgrav")
        if self.hierarchical and not first:
            self._hier_second_half()
        else:
            self._compute_tree(first_step=first)
        self._wt("Tree")

    # ------------------------------------------------------ host views
    def gather_alive(self) -> dict:
        """Every rank's alive rows on every rank as host numpy, with the
        64-bit ids under 'id' (slab_sim.py:2165-2171)."""
        p = self.particles
        out = collect_alive({"mass": p.mass, "ipos": p.ipos, "vel": p.vel,
                             "timebin": p.timebin, "id_lo": p.id_lo,
                             "id_hi": p.id_hi})
        out["ipos"] = out["ipos"].view(np.uint32)
        out["id"] = ((out.pop("id_hi").view(np.uint32).astype(np.uint64)
                      << np.uint64(32))
                     | out.pop("id_lo").view(np.uint32).astype(np.uint64))
        return out
