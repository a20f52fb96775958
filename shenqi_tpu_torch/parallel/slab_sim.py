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

The JAX loop's fixed caps (SlabCaps, :101-121) and their regrow
protocol (_grow_from_diag, :543) are gone: exchanges have exact split
sizes, and the stencil sizes its caps per rank at run time.  The gas,
subgrid, black-hole, helium and excursion stages (:781-1717) and
from_species (:271) are later slices (ROADMAP A.9.2-A.9.4).
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
from ..core.particles import (DM, ParticleData, float_to_ipos, u32,
                              u32_numpy_to_i32)
from ..gravity.pm import finalize_power
from ..gravity.treepm import (GravityConfig, default_softening,
                              get_window_tables)
from ..simulation import Simulation
from ..utils.constants import CM_PER_MPC
from . import collectives as cc
from .domain import (balance_cuts, collect_alive, cuts_fp_from_planes,
                     distribute_slabs, exchange)
from .pfft import pm_depose_slab, pm_forces_from_rhok, pm_forces_slab
from .sharded import stencil_forces_slab

# x-column granularity of the cost-balance histogram (the topleaf
# count analog): fine enough to split a clustered mesh plane
_BALANCE_COLS = 4096


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

    def __post_init__(self):
        if self.gravity.engine != "stencil":
            raise NotImplementedError(
                f"engine {self.gravity.engine!r} on --mesh: the slab run "
                "has the stencil engine only (ROADMAP A.10)")

    @classmethod
    def from_arrays(cls, pos, vel, mass, ids, CP, boxsize, nmesh,
                    timeline, atime, tsp: Optional[TimestepParams] = None,
                    gravity_kw: Optional[dict] = None,
                    balance_domains: bool = True, device=None):
        """This rank's part of a DM run from the GLOBAL host arrays, which
        every rank reads (slab_sim.py:212-268): the cost-balanced cuts
        from the x-column histogram when there is more than one rank,
        then the rows of this rank's slab, Morton-sorted."""
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
                 (ids >> np.uint64(32)).astype(np.uint32))},
            D, me, cuts)
        nl = len(loc["mass"])

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        p = ParticleData.zeros(nl, device=dev).replace(
            ipos=t(loc["ipos"].view(np.int32)), vel=t(loc["vel"]),
            mass=t(loc["mass"]),
            mask=torch.ones(nl, dtype=torch.bool, device=dev),
            ptype=torch.full((nl,), DM, dtype=torch.int8, device=dev),
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
        fields."""
        p = self.particles
        fields = {f.name: getattr(p, f.name)
                  for f in dataclasses.fields(p)}
        fields, info = exchange(fields, self.ndev, self.cuts_fp)
        self.particles = ParticleData(**fields)
        self.n_real = self.particles.n
        return info["sent"]

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
