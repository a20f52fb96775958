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

  sources with CoolingOn or StarformationOn (proto_sources, :2114-2148),
          after the kick: on PM steps the DM velocity dispersion of the
          gas (_update_vdisp_slab, :1691-1715); cooling and star
          formation row by row on the rank's gas, whole conversions
          flipped in place and split children appended to their
          parent's rank (_gas_source_terms, :1006-1148), then the winds
          (_slab_winds, :1343-1394); the black holes, their pack
          gathered from every rank in 64-bit id order
          (_slab_blackhole_step, :1516-1689); the metal return, each
          rank's active stars' yields on the host and only their pack
          gathered (_slab_metal_return, :1412-1497).  The passes over
          the gathered sources are parallel/subgrid_slab.py.  Every
          GasState column travels with its row, and after every source
          stage the dead rows (swallowed, merged) go and the alive gas
          rows are the prefix again (_set_rows).  The threefry key
          sequence is the JAX slab loop's: one split per star formation,
          one per wind call whether or not a star formed, one per BH
          salt, from PRNGKey(42) (ROADMAP C.4).

The JAX loop's fixed caps (SlabCaps, :101-121) and their regrow
protocol (_grow_from_diag, :543) are gone: exchanges have exact split
sizes, and the stencil sizes its caps per rank at run time.  Helium and
the excursion set (:1150-1341) are ROADMAP A.9.4.

Where the slab gas departs from the single-device loop, it follows the
JAX slab loop: the first hsml is 1.5 mean gas separations (2 on one
device), the drift does not predict hsml (:1718-1727), density and
hydro walk every gas row each step (:801, :826-835), and the first
step's hydro force takes the fixed point's entropy (the single-device
loop's takes u, ROADMAP C.4).  The hsml bracket ceiling is the
single-device one (sph_slab.density_slab).  The hydro-decoupled wind rows
(delay > 0 and still dense, :973-1001) are hydro sources of no force and
take no hydro acceleration or entropy change.  The wind's velocity
dispersion starts at 0 (:335-357) where one device starts it at 100
(ROADMAP C.4).  The JAX slab loop runs its
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
from ..core.integrate import (DriftKickTimes, TimestepParams,
                               active_bins_mask)
from ..core.particles import (BH, DM, GAS, STAR, ParticleData,
                              float_to_ipos, ipos_to_float, u32,
                              u32_numpy_to_i32)
from ..core.timeline import TIMEBINS
from ..gravity.pm import finalize_power
from ..gravity.treepm import (GravityConfig, default_softening,
                              get_window_tables)
from ..simulation import Simulation
from ..simulation_gas import GasState
from ..sph.kernels import CUBIC
from ..utils.constants import CM_PER_MPC, GAMMA
from . import collectives as cc
from .domain import (balance_cuts, collect_alive, cuts_fp_from_planes,
                     distribute_slabs, exchange)
from .pfft import pm_depose_slab, pm_forces_from_rhok, pm_forces_slab
from .sharded import stencil_forces_slab

# x-column granularity of the cost-balance histogram (the topleaf
# count analog): fine enough to split a clustered mesh plane
_BALANCE_COLS = 4096
# the GasState columns over every row (stars and black holes) and those
# of the gas rows only; both travel with their rows
_FULL_ROWS = ("birth_a", "last_enrich_myr", "mass0", "total_returned",
              "bh_mass", "bh_mdot", "star_metallicity")
_GAS_ROWS = tuple(f.name for f in dataclasses.fields(GasState)
                  if f.name != "ngas" and f.name not in _FULL_ROWS)
_PART_ROWS = tuple(f.name for f in dataclasses.fields(ParticleData))
# the source passes (BH environment, feedback, swallow, metal return) take
# the cubic kernel whatever DensityKernelType is, as the JAX slab loop's
# (its from_species sets kernel = CUBIC, slab_sim.py:361-362)
_SOURCE_KERNEL = CUBIC


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
    # per source stage: step, stage, gathered pack size, collectives the
    # stage ran, host seconds (the chip check prints them per step)
    source_log: list = field(default_factory=list)
    # (step, a, BHs seeded over the ranks) of each seeding
    seed_log: list = field(default_factory=list)
    star_count: int = 0
    # the t(a) grid of the metal return's stellar ages (host float64)
    _t_grid: object = None
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
            # every row starts with the JAX slab's columns (slab_sim.py:
            # 335-357): ne 1, vdisp 0, the rest at GasState's defaults
            g = GasState.create(p.n, torch.where(is_gas, u0, 0.0), ntot=p.n,
                                device=p.device)
            sim.gas = g.replace(vdisp=torch.zeros_like(g.vdisp))
            sim._set_rows(sim._rows())
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
        """Re-home every row to its owner slab with all its columns, the
        GasState's included (_set_rows puts the gas rows back in the
        prefix).  One rank has nothing to move."""
        if self.ndev == 1:
            return 0
        rows, info = exchange(self._rows(), self.ndev, self.cuts_fp)
        self._set_rows(rows)
        return info["sent"]

    def _rows(self) -> dict:
        """This rank's rows as one dict of [n, ...] columns: every
        ParticleData field and every GasState column under its own name,
        the gas rows' ones zero past the prefix."""
        p = self.particles
        rows = {k: getattr(p, k) for k in _PART_ROWS}
        g = self.gas
        if g is not None:
            pad = p.n - g.ngas
            for k in _GAS_ROWS:
                v = getattr(g, k)
                rows[k] = torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
            for k in _FULL_ROWS:
                rows[k] = getattr(g, k)
        return rows

    def _set_rows(self, rows: dict):
        """The state from a dict of row columns: the dead rows (mask
        false: swallowed gas, merged black holes) go, and a stable
        partition puts the alive gas rows in the prefix that GasState
        covers (the conversions, seeds and spawned children of a source
        stage leave it)."""
        keep = torch.nonzero(rows["mask"]).squeeze(1)
        is_gas = rows["ptype"][keep] == GAS
        perm = keep[torch.argsort((~is_gas).to(torch.int32), stable=True)]
        self.particles = ParticleData(**{k: rows[k][perm]
                                         for k in _PART_ROWS})
        self.n_real = self.particles.n
        if self.gas is not None:
            ng = int(is_gas.sum())
            self.gas = GasState(
                ngas=ng, **{k: rows[k][perm][:ng] for k in _GAS_ROWS},
                **{k: rows[k][perm] for k in _FULL_ROWS})

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
        if self.window_tables is None:
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
        the slab hydro pass.  The hydro-decoupled wind rows (delay > 0 at
        a density above the recoupling one, :973-1001) exert no hydro
        force and take no hydro acceleration or entropy change."""
        from ..core.integrate import predictor_tables
        from ..physics.winds import is_decoupled
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
        decoupled = torch.zeros(ng, dtype=torch.bool, device=dev)
        if gp.winds_on and gp.windpar is not None:
            decoupled = is_decoupled(gas.delay_time, gas.density,
                                     1.0 / atime ** 3, gp.windpar)
        src = {"ipos": ipos_g, "mass": mass_g, "vel": vel_g, "hsml": hsml,
               "density": gas.density, "eomdensity": eom, "entvar": entvar,
               "pressure": press, "divvel": gas.div_vel,
               "curlvel": gas.curl_vel, "dhsml_egy": gas.dhsml_egy,
               "dloga": dloga, "decoupled": decoupled}
        targets = {"ipos": ipos_g, "vel": vel_g, "hsml": hsml,
                   "mass": mass_g, "density": gas.density, "egyrho": eom,
                   "entvar": entvar, "pressure": press, "f1": f1,
                   "dhsml": gas.dhsml_egy, "dloga": dloga}
        hres, hinfo = hydro_slab(src, targets, par, tf, self.boxsize,
                                 self.ndev, self.cuts_fp, spec=gp.kernel,
                                 k=dinfo["level"],
                                 caps=gp._hydro_stencil_caps,
                                 tvalid=hsml > 0)
        self.gas = gas.replace(
            hydro_accel=torch.where(decoupled[:, None], 0.0, hres.accel),
            dt_entropy=torch.where(decoupled, 0.0, hres.dt_entropy),
            max_signal_vel=hres.max_signal_vel)
        rec.update(decoupled=int(decoupled.sum()),
                   hydro_ghosts=hinfo["ghosts"], hydro_cover=hinfo["cover"],
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

    # -------------------------------------------------------- sources
    @staticmethod
    def _n_collectives() -> int:
        return sum(v for k, v in cc.COUNTS.items()
                   if k == "all_reduce" or k.endswith("_calls"))

    def _log_source(self, stage: str, pack: int, c0: int, t0: float,
                    **more):
        self.source_log.append({
            "step": self.step_count, "stage": stage, "pack": pack,
            "collectives": self._n_collectives() - c0,
            "s": time.perf_counter() - t0, **more})

    @staticmethod
    def _row_dtime(timebin, dtime):
        """Each row's dtime: a number for every row, or a table over the
        time bins read at the row's own bin (proto_sources)."""
        if torch.is_tensor(dtime):
            return dtime[torch.clamp(timebin.long(), 1, TIMEBINS)]
        return torch.full(timebin.shape, float(np.float32(dtime)),
                          dtype=torch.float32, device=timebin.device)

    def proto_sources(self, is_pm, first):
        """The source stage after the kick (slab_sim.py:2114-2148), with
        CoolingOn or StarformationOn only, as the JAX slab loop: on PM
        steps the wind's DM velocity dispersion, then cooling, star
        formation and winds, the black holes and the metal return, each
        row with its own bin's dtime (zero off its kick boundary), timed
        as Cooling, BH and MetalReturn."""
        gp = self.gas_physics
        if self.gas is None or gp is None or first or not (
                gp.cooling_on or gp.sfr_on):
            return
        times = self.times
        if is_pm:
            # sigma-based winds refresh vdisp once per PM step
            # (run.cpp:662-663)
            self._update_vdisp_slab()
        hubble = float(self.CP.hubble_function(self.atime()))
        dt_tab = np.array(
            [self.timeline.get_dloga_for_bin(b, times.ti_current) / hubble
             for b in range(TIMEBINS + 1)], np.float32)
        dt_tab *= active_bins_mask(times.ti_current)
        dt_tab = torch.from_numpy(dt_tab).to(self.device)
        self._gas_source_terms(dt_tab)
        self._wt("Cooling")
        self._slab_blackhole_step(dt_tab)
        self._wt("BH")
        self._slab_metal_return()
        self._wt("MetalReturn")

    def _gas_source_terms(self, dtime):
        """Cooling, star formation and winds on this rank's gas
        (cooling_and_starformation, run.cpp:604-681; slab_sim.py:
        1006-1148): row by row through starformation_step / do_cooling,
        whose draws are keyed by the row's id; a whole conversion flips
        its row in place, a split spawns its child on the parent's rank
        (subgrid_slab.spawn_stars_slab), then _slab_winds.  dtime: a
        number or the per-bin table of proto_sources."""
        from ..physics.cooling_rates import UVBG
        from ..physics.sfr import starformation_step
        from ..physics.uv_fluctuations import local_uvbg
        from .subgrid_slab import spawn_stars_slab
        gp, p, g = self.gas_physics, self.particles, self.gas
        if not (gp.cooling_on or gp.sfr_on):
            return
        t0, c0 = time.perf_counter(), self._n_collectives()
        ng = g.ngas
        gas_alive = (p.mask & (p.ptype == GAS))[:ng]
        dt_g = self._row_dtime(p.timebin[:ng], dtime)
        atime = self.atime()
        a3inv = 1.0 / atime ** 3
        redshift = 1.0 / atime - 1.0
        uvbg = (gp.treecool.uvbg(redshift, gp.coolpar) if gp.treecool
                else UVBG())
        if gp.zreion_table is not None:
            # the fluctuating UVB: per-row rates gated on z_reion
            uvbg = local_uvbg(uvbg, gp.zreion_table.zreion(
                ipos_to_float(p.ipos[:ng], self.boxsize)), redshift)
        if not gp.sfr_on:
            self.gas = gp._pure_cooling(g, gas_alive, dt_g, a3inv, redshift,
                                        uvbg)
            self._log_source("cooling", 0, c0, t0)
            return
        res = starformation_step(
            gp.next_key(), g.density, g.egy_wt_density, g.entropy,
            p.mass[:ng], g.ne, g.metallicity, g.generation, dt_g, a3inv,
            redshift, uvbg, gp.sfrpar, gp.coolpar, gp.coolunits, gas_alive,
            gradrho_mag=g.gradrho_mag, hsml=p.hsml[:ng], pids=p.id_lo[:ng])
        self.gas = g.replace(entropy=res.entropy, ne=res.ne,
                             metallicity=res.metallicity, sfr=res.sfr)
        rows = self._rows()
        n = p.n

        def full(v, fill=False):
            return torch.cat([v, torch.full((n - ng,), fill, dtype=v.dtype,
                                            device=v.device)])

        form = full(gas_alive & res.form_star)
        conv = form & full(res.convert_whole)
        split = form & ~conv
        at32 = float(np.float32(atime))
        rows["ptype"] = torch.where(conv, STAR, rows["ptype"]).to(
            rows["ptype"].dtype)
        rows["birth_a"] = torch.where(conv, at32, rows["birth_a"])
        rows["sfr"] = torch.where(conv, 0.0, rows["sfr"])
        rows["mass0"] = torch.where(conv, rows["mass"], rows["mass0"])
        rows["star_metallicity"] = torch.where(conv, rows["metallicity"],
                                               rows["star_metallicity"])
        rows["last_enrich_myr"] = torch.where(conv, 0.0,
                                              rows["last_enrich_myr"])
        on = gas_alive & (res.sfr > 0)
        rho = torch.where(gas_alive, g.density * a3inv, 0.0)
        n_conv, n_split, n_on, n_act = cc.all_sum(torch.stack([
            conv.sum(), split.sum(), on.sum(),
            (gas_alive & (dt_g > 0)).sum()])).tolist()
        rho_max = float(cc.all_max(rho.max() if ng else rho.new_zeros(())))
        nstars = int(n_conv)
        if n_split:
            rows, n_sp = spawn_stars_slab(rows, split,
                                          full(res.mass_of_star, 0.0), atime)
            nstars += n_sp
        self.star_count += nstars
        pack = kicks = 0
        if gp.winds_on and gp.windpar is not None:
            # the children are no wind sources and no gas
            extra = rows["mass"].shape[0] - n
            form = torch.cat([form, form.new_zeros(extra)])
            is_gas = torch.cat([gas_alive, gas_alive.new_zeros(n - ng + extra)])
            was = rows["delay_time"] > 0
            rows, pack = self._slab_winds(rows, form, is_gas, atime, a3inv,
                                          dtime)
            kicks = int(((rows["delay_time"] > 0) & ~was).sum())
        self._set_rows(rows)
        self._log_source("sf", pack, c0, t0, whole=int(n_conv),
                         split=int(n_split), kicks=kicks, on_eeos=int(n_on),
                         active=int(n_act),
                         rho_max=rho_max / gp.sfrpar.PhysDensThresh)

    def _slab_winds(self, rows, form, is_gas, atime, a3inv, dtime):
        """The wind kicks after star formation (winds_make_after_sf /
        sfr_wind_feedback; slab_sim.py:1343-1394).  The subgrid model
        kicks the star-forming rows themselves (id-keyed draws); the
        others gather the rows that formed a star this step (the parents
        of splits, the flipped rows) from every rank and kick the gas
        around them (subgrid_slab.winds_slab).  Either draws one key,
        stars or none.  Returns (rows, stars gathered)."""
        from ..physics.winds import (WIND_SUBGRID, winds_decay,
                                     winds_subgrid_step)
        from .subgrid_slab import gather_rows, winds_slab
        gp = self.gas_physics
        wp = gp.windpar
        dt = self._row_dtime(rows["timebin"], dtime)
        gas_rows = (rows["ptype"] == GAS) & (rows["mass"] > 0)
        pack = 0
        if wp.has(WIND_SUBGRID):
            sm = rows["sfr"] * dt / max(gp.sfrpar.UnitSfr_in_solar_per_year,
                                        1e-35)
            wres = winds_subgrid_step(
                gp.next_key(), rows["vel"], rows["entropy"],
                rows["density"], rows["delay_time"], rows["mass"], sm,
                rows["vdisp"], atime, a3inv, wp,
                eligible=is_gas & (rows["sfr"] > 0) & ~form,
                pids=rows["id_lo"])
            vel, ent, delay0 = wres.vel, wres.entropy, wres.delay_time
            gsel = None
        else:
            stars, counts = gather_rows(
                {"ipos": rows["ipos"], "hsml": rows["hsml"],
                 "mass": rows["mass"], "vdisp": rows["vdisp"],
                 "pid": rows["id_lo"]}, form)
            pack = int(sum(counts))
            stars["hsml"] = torch.clamp(stars["hsml"], min=1e-3)
            key = gp.next_key()
            gsel = torch.nonzero(gas_rows).squeeze(1)
            g = {k: rows[k][gsel] for k in ("ipos", "mass", "vel")}
            g.update(entropy=rows["entropy"][gsel],
                     density=rows["density"][gsel],
                     delay=rows["delay_time"][gsel],
                     eligible=(is_gas & ~form)[gsel],
                     pid=rows["id_lo"][gsel])
            if pack:
                vel, ent, delay0 = winds_slab(key, g, stars, wp,
                                              self.boxsize, atime, a3inv)
            else:
                vel, ent, delay0 = g["vel"], g["entropy"], g["delay"]
        if gsel is None:
            gsel = torch.nonzero(gas_rows).squeeze(1)
            vel, ent, delay0 = vel[gsel], ent[gsel], delay0[gsel]
        delay = winds_decay(delay0, rows["density"][gsel], a3inv, dt[gsel],
                            wp)
        rows = dict(rows)
        for k, v in (("vel", vel), ("entropy", ent), ("delay_time", delay)):
            col = rows[k].clone()
            col[gsel] = v
            rows[k] = col
        return rows, pack

    def _update_vdisp_slab(self):
        """The DM velocity dispersion of every gas row for the
        sigma-based winds, once per PM step (run.cpp:662-663;
        slab_sim.py:1691-1715): subgrid_slab.veldisp_slab from twice the
        row's hsml."""
        from ..physics.winds import WIND_FIXED_EFFICIENCY
        from .subgrid_slab import veldisp_slab
        gp = self.gas_physics
        if not (gp.winds_on and gp.windpar is not None) or \
                gp.windpar.has(WIND_FIXED_EFFICIENCY):
            return
        t0, c0 = time.perf_counter(), self._n_collectives()
        p, g = self.particles, self.gas
        ng = g.ngas
        alive = p.mask & (p.mass > 0)
        is_gas = alive & (p.ptype == GAS)
        radius0 = torch.where(is_gas, torch.clamp(p.hsml * 2, min=1e-3), 0.0)
        sigma, _, _, info = veldisp_slab(
            {"ipos": p.ipos, "vel": p.vel,
             "mass": torch.where(alive & (p.ptype == DM), p.mass, 0.0)},
            radius0, self.boxsize, self.atime(), self.ndev, self.cuts_fp,
            nlevels=self.gravity.tree_nlevels,
            ncrit=self.gravity.tree_ncrit)
        self.gas = g.replace(vdisp=torch.where(is_gas[:ng], sigma[:ng],
                                               g.vdisp))
        self._log_source("veldisp", info["ghosts"], c0, t0,
                         iterations=info["iterations"])

    def _slab_blackhole_step(self, dtime):
        """Accretion, feedback, swallowing, mergers and dynamical friction
        (blackhole.cpp; slab_sim.py:1516-1689).  The black holes of every
        rank are gathered in 64-bit id order, so every rank holds the same
        pack; their gas environment is summed over the ranks
        (subgrid_slab.source_env_slab); accretion and the drag act on
        each rank's own BH rows; the feedback and the id-keyed swallow
        act on each rank's gas (bh_feedback_slab, bh_swallow_slab); the
        mergers run on the host over the pack, with the same result on
        every rank; the dynamical friction takes subgrid_slab.
        veldisp_slab over the collisionless rows."""
        gp = self.gas_physics
        par = gp.bhpar
        if not (gp.bh_on and par is not None):
            return
        from ..physics.blackhole import (BHEnv, bh_accretion, bh_drag_accel,
                                         bh_mergers, bh_soundspeed,
                                         dynamical_friction)
        from ..utils import threefry
        from ..utils.constants import LIGHTCGS
        from .subgrid_slab import (bh_feedback_slab, bh_swallow_slab,
                                   gather_rows, source_env_slab, veldisp_slab)
        t0, c0 = time.perf_counter(), self._n_collectives()
        rows = dict(self._rows())
        dev = self.device
        bh_rows = rows["mask"] & (rows["ptype"] == BH)
        mine = torch.nonzero(bh_rows).squeeze(1)
        dt = self._row_dtime(rows["timebin"], dtime)
        pk, counts = gather_rows(
            {"ipos": rows["ipos"], "hsml": rows["hsml"], "vel": rows["vel"],
             "mass": rows["mass"], "bhm": rows["bh_mass"], "dt": dt,
             "id_lo": rows["id_lo"], "id_hi": rows["id_hi"]}, bh_rows)
        ns = int(sum(counts))
        if ns == 0:
            return
        ids = ((u32(pk["id_hi"]) << 32) | u32(pk["id_lo"])).cpu().numpy()
        order = torch.from_numpy(np.argsort(ids.view(np.uint64),
                                            kind="stable")).to(dev)
        pk = {k: v[order] for k, v in pk.items()}
        ids = ids[order.cpu().numpy()]
        # this rank's BH rows: their slots in the id-ordered pack
        off = int(sum(counts[:cc.rank()]))
        inv = torch.empty_like(order)
        inv[order] = torch.arange(ns, device=dev)
        slot = inv[off:off + mine.numel()]
        atime = self.atime()
        a3inv = 1.0 / atime ** 3
        hsml_bh = torch.clamp(torch.clamp(pk["hsml"] * par.BlackHoleNgbFactor,
                                          min=1e-3),
                              max=par.BlackHoleMaxAccretionRadius)
        is_gas = rows["mask"] & (rows["ptype"] == GAS)
        mass_gas = torch.where(is_gas, rows["mass"], 0.0)
        dens, sent, svel, fw = source_env_slab(
            {"ipos": rows["ipos"], "mass": mass_gas,
             "entropy": rows["entropy"], "vel": rows["vel"]},
            {"ipos": pk["ipos"], "hsml": hsml_bh}, self.boxsize, _SOURCE_KERNEL)
        env = BHEnv(density=dens, entropy=sent, gas_vel=svel,
                    feedback_weight=fw)
        mdot = bh_accretion(pk["bhm"], pk["vel"], env, atime,
                            self.gravity.G, par)
        bhm_new = pk["bhm"] + mdot * pk["dt"]
        vel = rows["vel"]
        if par.BH_DRAG:
            adrag = bh_drag_accel(pk["vel"], env.gas_vel, mdot, pk["mass"],
                                  pk["bhm"], atime, par)
            vel = vel.clone()
            vel[mine] += adrag[slot] * pk["dt"][slot][:, None]
        # thermal feedback: E = eps_f 0.1 Mdot c^2 dt (internal)
        c_int = LIGHTCGS / par.UnitVelocity_in_cm_per_s
        energy = par.BlackHoleFeedbackFactor * 0.1 * mdot * pk["dt"] \
            * c_int ** 2
        dent = bh_feedback_slab(
            {"ipos": rows["ipos"], "mass": mass_gas,
             "density": rows["density"]},
            {"ipos": pk["ipos"], "hsml": hsml_bh, "energy": energy,
             "fw": fw}, self.boxsize, a3inv, _SOURCE_KERNEL)
        entropy = torch.where(is_gas, rows["entropy"] + dent, rows["entropy"])
        dg = dent[is_gas]
        heat = (float(dg.min()) if dg.numel() else 0.0, int((dg > 0).sum()))
        # stochastic swallowing closes the subgrid/dynamic mass gap
        salt = threefry.bits(gp.next_key())
        deficit = torch.clamp(bhm_new - pk["mass"], min=0.0)
        swallowed_by, gain = bh_swallow_slab(
            salt, {"ipos": rows["ipos"], "mass": mass_gas,
                   "pid": rows["id_lo"]},
            {"ipos": pk["ipos"], "hsml": hsml_bh, "deficit": deficit,
             "rho": torch.clamp(dens, min=1e-35)}, self.boxsize, _SOURCE_KERNEL)
        eaten = swallowed_by >= 0
        mass = torch.where(eaten, 0.0, rows["mass"])
        mass[mine] += gain[slot]
        mask = rows["mask"] & ~eaten
        # BH-BH mergers on the host over the id-ordered pack: every rank
        # reaches the same result
        cs = bh_soundspeed(env.entropy, env.density, atime)
        host = {k: v.cpu().numpy() for k, v in dict(
            pos=ipos_to_float(pk["ipos"], self.boxsize), vel=pk["vel"],
            hsml=hsml_bh, bhm=bhm_new, mass=pk["mass"] + gain, cs=cs).items()}
        eaten_by, msub2, mdyn2 = bh_mergers(
            host["pos"], host["vel"], host["hsml"], host["bhm"],
            host["mass"], ids, atime, host["cs"], self.boxsize)
        merged = eaten_by >= 0
        bh_mass = rows["bh_mass"].clone()
        bh_mdot = rows["bh_mdot"].clone()
        if merged.any():
            bh_mass[mine] = torch.from_numpy(
                np.asarray(msub2, np.float32)).to(dev)[slot]
            mass[mine] = torch.from_numpy(
                np.asarray(mdyn2, np.float32)).to(dev)[slot]
            gone = torch.from_numpy(merged).to(dev)[slot]
            mass[mine[gone]] = 0.0
            mask[mine[gone]] = False
        else:
            bh_mass[mine] = bhm_new[slot]
        bh_mdot[mine] = mdot[slot]
        rows.update(vel=vel, entropy=entropy, mass=mass, mask=mask,
                    bh_mass=bh_mass, bh_mdot=bh_mdot)
        # dynamical friction from the collisionless background
        if gp.bh_dynfric_on:
            alive = rows["mask"] & (rows["mass"] > 0)
            coll = alive & (rows["ptype"] != GAS) & (rows["ptype"] != BH)
            n_coll = cc.sum_int(int(coll.sum()), dev)
            if n_coll:
                sep = self.boxsize / max(n_coll, 1) ** (1.0 / 3.0)
                bh_m = alive & (rows["ptype"] == BH)
                sigma, _, rho, _ = veldisp_slab(
                    {"ipos": rows["ipos"], "vel": rows["vel"],
                     "mass": torch.where(coll, rows["mass"], 0.0)},
                    torch.where(bh_m, float(np.float32(2 * sep)), 0.0),
                    self.boxsize, atime, self.ndev, self.cuts_fp,
                    nlevels=self.gravity.tree_nlevels,
                    ncrit=self.gravity.tree_ncrit)
                adf = dynamical_friction(rows["vel"], rho, sigma,
                                         rows["bh_mass"], atime,
                                         self.gravity.G)
                rows["vel"] = torch.where(bh_m[:, None],
                                          rows["vel"] + adf * dt[:, None],
                                          rows["vel"])
        self.last_bh_stats = {"nbh": ns, "swallowed": cc.sum_int(
            int(eaten.sum()), dev), "mergers": int(merged.sum())}
        self._set_rows(rows)
        self._log_source("bh", ns, c0, t0, dent_min=heat[0], heated=heat[1],
                         **self.last_bh_stats)

    def _age_myr(self, a0, a1):
        """Cosmic time between scale factors (Myr) through the JAX slab
        loop's t(a) grid (slab_sim.py:1396-1410): 257 host float64 knots
        from min(a of the first stars, 0.01) to 1, made at the first
        metal return."""
        ag, tg = self._t_grid
        t0 = np.interp(np.maximum(a0, ag[0]), ag, tg)
        t1 = np.interp(np.maximum(a1, ag[0]), ag, tg)
        return t1 - t0

    def _slab_metal_return(self):
        """Stellar ejecta mass and metals to the gas around each star
        (metal_return.cpp; slab_sim.py:1412-1497): each rank selects its
        own active stars and integrates their yields on the host
        (MetalReturn.star_return, float64, as the JAX slab loop), only
        their pack is gathered, their gas environment summed over the
        ranks (source_env_slab) and their ejecta scattered onto each
        rank's gas (metal_return_slab)."""
        gp = self.gas_physics
        if not (gp.metal_return_on and gp.metals):
            return
        from .subgrid_slab import (gather_rows, metal_return_slab,
                                   source_env_slab)
        t0, c0 = time.perf_counter(), self._n_collectives()
        rows = dict(self._rows())
        dev = self.device
        star = rows["mask"] & (rows["ptype"] == STAR) & (rows["birth_a"] > 0)
        sidx = torch.nonzero(star).squeeze(1)
        birth = rows["birth_a"][sidx].double().cpu().numpy()
        if self._t_grid is None:
            a_min = cc.all_min(torch.tensor(
                [birth.min() if birth.size else np.inf], dtype=torch.float64,
                device=dev)).item()
            if not np.isfinite(a_min):
                return
            ag = np.geomspace(min(a_min, 0.01), 1.0, 257)
            tg = np.zeros_like(ag)
            for i in range(1, len(ag)):
                tg[i] = tg[i - 1] + self.CP.age_myr(ag[i - 1], ag[i])
            self._t_grid = (ag, tg)
        atime = self.atime()
        # the float32 ages and enrichment times of the JAX slab loop
        birth = birth.astype(np.float32)
        age_now = self._age_myr(birth, np.full(birth.size, atime))
        last = rows["last_enrich_myr"][sidx].double().cpu().numpy()
        act_np = age_now - last > gp.min_enrich_window_myr
        act = torch.zeros_like(star)
        aidx = sidx[torch.from_numpy(act_np).to(dev)]
        act[aidx] = True
        nloc = int(aidx.numel())
        pk, counts = gather_rows({"ipos": rows["ipos"], "hsml": rows["hsml"]},
                                 act)
        ns = int(sum(counts))
        if ns == 0:
            return
        s_hsml = torch.clamp(pk["hsml"], min=1e-3)
        is_gas = rows["mask"] & (rows["ptype"] == GAS)
        mass_gas = torch.where(is_gas, rows["mass"], 0.0)
        _, _, _, fw = source_env_slab(
            {"ipos": rows["ipos"], "mass": mass_gas,
             "entropy": rows["entropy"], "vel": rows["vel"]},
            {"ipos": pk["ipos"], "hsml": s_hsml}, self.boxsize, _SOURCE_KERNEL)
        off = int(sum(counts[:cc.rank()]))
        has_ngb = (fw[off:off + nloc] > 1e-30).cpu().numpy()
        zmet = rows["star_metallicity"][aidx].cpu().numpy()
        m0 = rows["mass0"][aidx].cpu().numpy()
        totret = rows["total_returned"][aidx].double().cpu().numpy()
        last_a = last[act_np]
        age_a = age_now[act_np]
        h = self.CP.HubbleParam
        mret = np.zeros(ns, np.float32)
        zret = np.zeros(ns, np.float32)
        for j in range(nloc):
            if not has_ngb[j]:
                continue
            mfrac, zfrac, _ = gp.metals.star_return(
                float(zmet[j]), float(last_a[j]), float(age_a[j]), h)
            # never return more than 90% of the birth mass in total
            mfrac = min(mfrac, max(0.9 - totret[j], 0.0))
            mret[off + j] = mfrac * m0[j]
            zret[off + j] = min(zfrac, mfrac) * m0[j]
            totret[j] += mfrac
            last_a[j] = age_a[j]

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        enr = rows["last_enrich_myr"].clone()
        enr[aidx] = t(last_a.astype(np.float32))
        tret = rows["total_returned"].clone()
        tret[aidx] = t(totret.astype(np.float32))
        rows.update(last_enrich_myr=enr, total_returned=tret)
        # each lane has one rank's value and zeros elsewhere: exact sums
        ret = cc.all_sum(t(np.stack([mret, zret])))
        if float(ret[0].sum()) > 0:
            dm, dz = metal_return_slab(
                {"ipos": rows["ipos"], "mass": mass_gas},
                {"ipos": pk["ipos"], "hsml": s_hsml, "mret": ret[0],
                 "zret": ret[1], "fw": fw}, self.boxsize, _SOURCE_KERNEL)
            rows["metallicity"] = torch.where(
                is_gas, (rows["metallicity"] * mass_gas + dz)
                / (torch.clamp(mass_gas, min=1e-35) + dm),
                rows["metallicity"])
            mass = rows["mass"] + torch.where(is_gas, dm, 0.0)
            # the stars give up what they returned, down to a tenth of
            # their birth mass
            mass[aidx] = torch.maximum(mass[aidx] - ret[0][off:off + nloc],
                                       0.1 * t(m0))
            rows["mass"] = mass
        self._set_rows(rows)
        self._log_source("metal_return", ns, c0, t0)

    def _seed_bh_rows(self, rows_local):
        """Turn the given gas rows of this rank into black holes (the
        fof_seed conversion; slab_sim.py:1499-1514): ptype BH, the
        dynamic mass kept, the subgrid mass the seed's."""
        gp = self.gas_physics
        r = torch.as_tensor(np.atleast_1d(np.asarray(rows_local, np.int64)),
                            device=self.device)
        rows = dict(self._rows())
        ptype = rows["ptype"].clone()
        ptype[r] = BH
        bhm = rows["bh_mass"].clone()
        bhm[r] = float(np.float32(gp.bhpar.SeedBlackHoleMass))
        rows.update(ptype=ptype, bh_mass=bhm)
        self._set_rows(rows)
        self.seed_log.append((self.step_count, self.atime(),
                              cc.sum_int(int(r.numel()), self.device)))

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
