"""TreePM + SPH simulation driver (shenqi_tpu/simulation.py:52-960 in
torch): the reference main loop (run.cpp:331-822) with PM long-range
gravity, the grid-stencil short-range force, adiabatic SPH and
individual timesteps.

  loop:
    ti_next = min active-bin kick time (clamped to PM step end)
    drift ALL particles to ti_next (and the gas smoothing lengths)
    [forces: density + hydro for the active gas; PM on PM steps;
     short range for the active set]
    apply_half_kick       (completes the previous half step)
    update_kick_times
    [PM step] apply_PM_half_kick  (completes the previous PM half)
    [outputs at sync points]
    find_timesteps -> new bins, new PM length
    apply_half_kick       (starts the new half step)
    [PM step] apply_PM_half_kick  (starts the new PM half)

The port runs the stencil engine, both timestep schemes
(`hierarchical`, Gadget-4 split gravity, is what the CLI turns on), the
massive-neutrino linear response (`nu_table`), the random box offset,
the human control interface (HCI) and gas (`from_species` with a
GasPhysics: simulation_gas.py), with cooling, star formation, winds and
metal return as the source stages after the kick, black holes, and
helium and excursion-set reionization.  The short-range force takes the
calibrated (Chebyshev) or the analytic erfc window.  The tree engines
raise NotImplementedError (ROADMAP A.10).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ._device import resolve_device
from .core.particles import (ParticleData, POS_SCALE, DM, GAS,
                             u32_numpy_to_i32, wrap_i32)
from .core.timeline import Timeline, TIMEBINS, dti_from_timebin, \
    round_down_power_of_two
from .core.integrate import (DriftKickTimes, TimestepParams,
                             active_bins_mask, gravity_dloga,
                             long_range_dloga, assign_timebins,
                             gravkick_tables, kick_gravity, kick_hydro,
                             kick_pm, hydro_dloga, is_timebin_active)
from .core.step_protocol import run_protocol
from .cosmology.background import Cosmology
from .gravity.treepm import (GravityConfig, get_window_tables,
                             default_softening)
from .gravity.pm import pm_forces, finalize_power, measure_cdm_power
from .gravity.stencil import stencilgrav, stencilgrav_fused
from .utils.constants import CM_PER_MPC, GAMMA_MINUS1


def _drift(ipos, vel, alive, driftfac, pos_scale_over_box):
    """ipos += trunc(vel * driftfac * 2^32/box), wrapping as uint32."""
    dx = vel * driftfac * pos_scale_over_box
    newpos = wrap_i32(ipos.long() + dx.to(torch.int32).long())
    return torch.where(alive[:, None], newpos, ipos)


@dataclass
class Simulation:
    CP: Cosmology
    boxsize: float
    timeline: Timeline
    times: DriftKickTimes
    gravity: GravityConfig
    tsp: TimestepParams
    particles: ParticleData
    fast_particle_type: int = 2
    step_count: int = 0
    power_history: list = field(default_factory=list)
    snapshots: list = field(default_factory=list)
    window_tables: object = None
    hierarchical: bool = False   # Gadget-4 split gravity timesteps
    on_snapshot: object = None   # callback(sim, atime)
    on_step: object = None       # callback(sim) at end of each step
    on_pm_step: object = None    # callback(sim) on PM steps but the first
    # optional object with .measure(name): stage boundaries in run()
    # are charged to the reference timer names (PMgrav/Tree/...)
    walltime: object = None
    on_drift: object = None      # callback(sim, a0, a1) after drifts
    # human control interface (utils/hci.HCI), polled on PM steps;
    # on_checkpoint(sim, atime) writes its unplanned dumps, hci_exit
    # records why the loop ended
    hci: object = None
    on_checkpoint: object = None
    hci_exit: str = ""
    resumed: bool = False
    # grow-only stencil caps, so steady-state steps reuse their shapes
    _tier_cache: dict = field(default_factory=dict)
    _caps_cache: dict = field(default_factory=dict)
    n_real: int = 0
    # anti-correlation random box shift (partmanager.h:79-82, applied
    # run.cpp:426-428): fraction of the box drawn each PM step; the
    # uint32 offset is exact, so it subtracts out losslessly at output
    random_offset_frac: float = 0.0
    _offset_u32: Optional[np.ndarray] = None
    # pair pass through the plain version on any device: only the
    # on-card parity check sets it
    _plain_p2p: bool = False
    # short-range targets of the last force pass (None: all live rows)
    last_n_targets: Optional[int] = None

    # massive-neutrino linear response (physics/neutrinos_lra
    # DeltaTotTable), set by the CLI when MassiveNuLinRespOn
    nu_table: object = None
    # adiabatic gas (simulation_gas.GasState / GasPhysics); the entropy
    # holds the initial u until the first density pass converts it
    gas: object = None
    gas_physics: object = None
    _gas_entropy_is_u: bool = False
    # every row's FOF halo mass at the last FOF (the CLI's fof_physics)
    halo_mass: object = None
    excursion_xhi: object = None   # (volume, mass)-weighted xHI, last pass
    # (a0, a1, crossings, host seconds) of each drift, with a lightcone
    lightcone_log: object = None

    # the drift predicts the gas smoothing lengths (the slab loop's does
    # not: parallel/slab_sim.py)
    _DRIFT_HSML = True

    def __post_init__(self):
        if self.gravity.engine != "stencil":
            raise NotImplementedError(
                f"engine {self.gravity.engine!r}: only 'stencil' is ported")

    @property
    def device(self) -> torch.device:
        return self.particles.device

    def _wt(self, name: str):
        if self.walltime is not None:
            self.walltime.measure(name)

    def _apply_random_offset(self):
        """Re-draw the internal particle offset (update_random_offset,
        partmanager.c:45-62): decorrelates tree-opening errors between
        PM steps.  The draw is the JAX package's, from
        RandomState(ti_current & 0x7FFFFFFF), so the offsets are the
        same bits; positions shift by (new - old) exactly, added in
        uint32 through wrap_i32.  Writers subtract `_offset_u32` again
        (output_ipos)."""
        if not self.random_offset_frac:
            return
        rng = np.random.RandomState(
            int(self.times.ti_current) & 0x7FFFFFFF)
        rr = rng.uniform(0, 1, 3) * self.random_offset_frac
        new_u = (rr * 2 ** 32).astype(np.int64).astype(np.uint32)
        old_u = self._offset_u32 if self._offset_u32 is not None \
            else np.zeros(3, np.uint32)
        delta = torch.from_numpy((new_u - old_u).astype(np.int64)).to(
            self.device)
        p = self.particles
        self.particles = p.replace(
            ipos=wrap_i32(p.ipos.long() + delta[None, :]))
        self._offset_u32 = new_u

    def output_ipos(self) -> torch.Tensor:
        """Positions with the internal random shift removed
        (petaio.cpp:678 convention), int32 bit patterns."""
        if self._offset_u32 is None:
            return self.particles.ipos
        off = torch.from_numpy(self._offset_u32.astype(np.int64)).to(
            self.device)
        return wrap_i32(self.particles.ipos.long() - off[None, :])

    @classmethod
    def from_arrays(cls, pos, vel, mass, ids, CP, boxsize, nmesh,
                    timeline, atime, tsp: Optional[TimestepParams] = None,
                    gravity_kw: Optional[dict] = None,
                    extra_capacity: int = 0, device=None):
        """Build a DM simulation from host arrays; its tensors live on
        `device` (CUDA unless the caller passes device='cpu')."""
        dev = resolve_device(device)
        from .core.particles import float_to_ipos
        n = len(pos)
        ncap = ((n + extra_capacity + 127) // 128) * 128
        ipos_np = np.zeros((ncap, 3), np.int32)
        ipos_np[:n] = float_to_ipos(pos, boxsize, device="cpu").numpy()
        vel_np = np.zeros((ncap, 3), np.float32)
        vel_np[:n] = vel
        mass_np = np.zeros(ncap, np.float32)
        mass_np[:n] = mass if np.ndim(mass) else np.full(n, mass)
        mask_np = np.zeros(ncap, bool)
        mask_np[:n] = True
        ids_np = np.zeros(ncap, np.uint64)
        ids_np[:n] = ids
        lo = (ids_np & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (ids_np >> np.uint64(32)).astype(np.uint32)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        p = ParticleData.zeros(ncap, device=dev).replace(
            ipos=t(ipos_np), vel=t(vel_np), mass=t(mass_np),
            mask=t(mask_np),
            ptype=torch.full((ncap,), DM, dtype=torch.int8, device=dev),
            timebin=torch.ones(ncap, dtype=torch.int8, device=dev),
            id_lo=t(u32_numpy_to_i32(lo)), id_hi=t(u32_numpy_to_i32(hi)))
        soft = default_softening(boxsize, n)
        gkw = dict(boxsize=boxsize, nmesh=nmesh, G=CP.GravInternal,
                   softening=soft,
                   tree_nlevels=min(20, max(6, int(np.ceil(
                       np.log(max(n, 8) / 16) / np.log(8))) + 3)),
                   tree_ncrit=32)
        if gravity_kw:
            gkw.update(gravity_kw)
        gravity = GravityConfig(**gkw)
        ti = timeline.ti_from_loga(np.log(atime))
        sim = cls(CP=CP, boxsize=boxsize, timeline=timeline,
                  times=DriftKickTimes.init(ti), gravity=gravity,
                  tsp=tsp or TimestepParams(), particles=p)
        sim.n_real = n
        return sim

    @classmethod
    def from_species(cls, species, CP, boxsize, nmesh, timeline, atime,
                     tsp=None, gravity_kw=None, gas_u0=None,
                     gas_physics=None, star_headroom: int = 0,
                     device=None):
        """Build a simulation from per-type particle sets.

        species: list of (ptype, pos, vel, mass, ids); gas (type 0) rows
        are placed first so the gas fields align to the array prefix.
        gas_u0: the initial specific internal energy of the gas (internal
        units), converted to entropy after the first density pass."""
        species = sorted(species, key=lambda s_: s_[0])
        pos = np.concatenate([s_[1] for s_ in species])
        vel = np.concatenate([s_[2] for s_ in species])
        mass = np.concatenate([
            np.full(len(s_[1]), s_[3]) if np.ndim(s_[3]) == 0 else s_[3]
            for s_ in species])
        ids = np.concatenate([s_[4] for s_ in species])
        ptypes = np.concatenate([np.full(len(s_[1]), s_[0], dtype=np.int8)
                                 for s_ in species])
        sim = cls.from_arrays(pos, vel, mass, ids, CP, boxsize, nmesh,
                              timeline, atime, tsp=tsp,
                              gravity_kw=gravity_kw,
                              extra_capacity=star_headroom, device=device)
        dev = sim.device
        ptype_arr = np.full(sim.particles.n, DM, dtype=np.int8)
        ptype_arr[:len(ptypes)] = ptypes
        sim.particles = sim.particles.replace(
            ptype=torch.from_numpy(ptype_arr).to(dev))
        ngas = int((ptypes == GAS).sum())
        if ngas > 0:
            from .simulation_gas import GasState
            # initial hsml guess: twice the mean gas separation
            sep = boxsize / max(ngas, 1) ** (1.0 / 3)
            hsml0 = sim.particles.hsml.clone()
            hsml0[:ngas] = float(np.float32(2.0 * sep))
            sim.particles = sim.particles.replace(hsml=hsml0)
            ent0 = np.full(ngas, 1.0 if gas_u0 is None else gas_u0,
                           np.float32)
            sim.gas = GasState.create(ngas, ent0, ntot=sim.particles.n,
                                      device=dev)
            sim._gas_entropy_is_u = gas_u0 is not None
            sim.gas_physics = gas_physics
        return sim

    def init_gas_entropy(self):
        """After the first density pass, convert the stored u0 into
        entropy (init.cpp uniform-temperature setup).  With
        pressure-entropy SPH the conversion is a fixed point, entropy
        depending on EgyWtDensity and EgyWtDensity on entropy:
        setup_density_indep_entropy (init.cpp:403-449); otherwise one
        A = u (g-1)/(rho a^-3)^(g-1)."""
        if self.gas is None or not self._gas_entropy_is_u:
            return
        gp = self.gas_physics
        u0 = self.gas.entropy    # holds u until this conversion
        if gp is not None and gp.density_independent_sph:
            # u0 is uniform at init; the JAX package takes its median
            u_init = float(np.median(u0.cpu().numpy()))
            self.gas = gp.setup_density_indep_entropy(self, self.gas,
                                                      u_init)
        else:
            a3inv = 1.0 / self.atime() ** 3
            rho = torch.clamp(self.gas.density, min=1e-35) * a3inv
            ent = u0 * GAMMA_MINUS1 / torch.pow(rho, GAMMA_MINUS1)
            self.gas = self.gas.replace(entropy=ent)
        self._gas_entropy_is_u = False

    # ---------- pieces ----------
    def atime(self) -> float:
        return self.timeline.atime_from_ti(self.times.ti_current)

    def _drift_all(self, ti_next: int):
        a0 = self.atime()
        fac = self.timeline.exact_drift_factor(self.CP,
                                               self.times.ti_current,
                                               ti_next)
        p = self.particles
        # f32 scalars, as the JAX package passes them
        fac32 = float(np.float32(fac))
        p = p.replace(ipos=_drift(
            p.ipos, p.vel, p.mask, fac32,
            float(np.float32(POS_SCALE / self.boxsize))))
        if self.gas is not None and self._DRIFT_HSML:
            # predict smoothing lengths through the drift (drift.cpp:55-66,
            # Gadget-4 style: Hsml += DtHsml * ddrift, capped), so the
            # density bisection starts near its answer
            ng = self.gas.ngas
            h0 = p.hsml[:ng]
            h1 = h0 + self.gas.dt_hsml * fac32
            h1 = torch.minimum(torch.maximum(h1, 0.5 * h0), 2.0 * h0)
            is_gas = (p.ptype[:ng] == GAS) & p.mask[:ng]
            p = p.replace(hsml=torch.cat([
                torch.where(is_gas & (h0 > 0), h1, h0), p.hsml[ng:]]))
        self.particles = p
        if self.on_drift is not None:
            self.on_drift(self, a0, self.timeline.atime_from_ti(ti_next))
        self.times.ti_current = ti_next
        for b in range(TIMEBINS + 1):
            if is_timebin_active(b, ti_next):
                self.times.ti_lastactivedrift[b] = ti_next

    def _compute_pm(self, record_power=True):
        p = self.particles
        nu_factor = None
        if self.nu_table is not None:
            nu_factor = self._nu_factor()
        accel, pot, ps = pm_forces(p.ipos, p.mass, self.gravity.pm(),
                                   mask=p.mask, nu_factor=nu_factor)
        self.particles = p.replace(grav_pm=accel, potential=pot)
        if record_power:
            mpc = CM_PER_MPC / 3.085678e21
            kk, power, nmodes = finalize_power(ps, self.gravity.pm(),
                                               self.boxsize / mpc)
            self.power_history.append((self.atime(), kk, power, nmodes))

    def _nu_factor(self) -> torch.Tensor:
        """The neutrino linear response of this PM solve
        (compute_neutrino_power, gravpm.cpp:308; simulation.py:295-338 of
        the JAX package): measure the CDM power, advance the delta_nu
        integral on the host, and build the per-mode multiplier
        1 + f_nu delta_nu/delta_cdm on the host from |k| in the rfftn
        half-spectrum layout; one copy to the device per PM step."""
        nt = self.nu_table
        p = self.particles
        cfg = self.gravity.pm()
        psc = measure_cdm_power(p.ipos, p.mass, cfg, mask=p.mask)
        kk = psc.k.double().cpu().numpy() * (2 * np.pi / self.boxsize)
        pw = psc.power.double().cpu().numpy()
        nm = psc.nmodes.double().cpu().numpy()
        sel = nm > 0
        delta_meas = np.sqrt(pw[sel] / nm[sel]
                             / max(float(psc.norm), 1e-300))
        delta_cdm = np.interp(nt.wavenum, kk[sel], delta_meas)
        atime = self.atime()
        nt.update(atime, delta_cdm)
        fac1d = nt.potential_factor(atime, delta_cdm)
        n = cfg.nmesh
        kx = np.fft.fftfreq(n, 1.0 / n)[:, None, None]
        ky = np.fft.fftfreq(n, 1.0 / n)[None, :, None]
        kz = np.arange(n // 2 + 1)[None, None, :]
        kmag = np.sqrt(kx ** 2 + ky ** 2 + kz ** 2) \
            * (2 * np.pi / self.boxsize)
        nu3d = np.interp(kmag.ravel(), nt.wavenum, fac1d,
                         left=fac1d[0], right=fac1d[-1]).reshape(kmag.shape)
        # DC mode: no response at k = 0; the P(k) norm (|rho_k(0)|^2)
        # carries (Mtot/Mcdm)^2 instead (gravpm.cpp:412,431)
        nu3d[0, 0, 0] = self.CP.Omega0 / (
            self.CP.Omega0
            - atime ** 3 * self.CP.ONu.get_omega_nu_nopart(atime))
        return torch.from_numpy(nu3d.astype(np.float32)).to(self.device)

    def _stencil(self, mass, sp, active=None, n_act: int = None):
        """One grid-stencil short-range call (simulation.py:353-412 of the
        JAX package) with all rows of nonzero `mass` as sources, and the
        rows of `active` (n_act of them) as the only targets when given.
        Steady state takes the fused path with cached caps and a device
        `ok` flag; on overflow the cap-regrowing slow path redoes it."""
        if self.window_tables is None:
            self.window_tables = get_window_tables(self.gravity,
                                                   device=self.device)
        kw = dict(sub=self.gravity.refine_sub, tier_cache=self._tier_cache,
                  caps_cache=self._caps_cache, want_pot=False,
                  _plain=self._plain_p2p)
        if active is not None:
            kw.update(n_targets=max(n_act, 1), active=active)
        ipos = self.particles.ipos
        acc, _, ok = stencilgrav_fused(ipos, mass, sp, self.window_tables,
                                       **kw)
        if not bool(ok):
            acc, _, _ = stencilgrav(ipos, mass, sp, self.window_tables, **kw)
        return acc

    def _compute_tree(self, first_step: bool):
        """The short-range force of the plain scheme.  Only active-bin
        particles are targets when they are fewer than half the live
        ones; inactive rows keep their last-sync acceleration (run.cpp:488
        ActiveParticles).  Sources are always all particles."""
        p = self.particles
        active = None
        n_act = None
        if not first_step:
            act = self._active_mask()
            n_all = int(p.mask.sum())
            n_act = int(act.sum())
            if n_act < n_all // 2:
                active = act
        self.last_n_targets = n_act if active is not None else None
        acc = self._stencil(torch.where(p.mask, p.mass, 0.0),
                            self.gravity.short(
                                use_bh=1 if first_step else None),
                            active, n_act)
        if active is not None:
            # inactive rows keep their stored (last-sync) accel
            acc = torch.where(active[:, None], acc, p.grav_accel)
        self.particles = p.replace(grav_accel=acc)

    # ---------- hierarchical (split) gravity, Gadget-4 scheme ----------
    # simulation.py:442-661 of the JAX package, DM and stencil only.  The
    # level masks stay on the device; the counts per level come from one
    # histogram of the bins copied to the host per half step.

    def _largest_active_bin(self) -> int:
        times = self.times
        for b in range(TIMEBINS, -1, -1):
            if is_timebin_active(b, times.ti_current) and \
                    dti_from_timebin(b) <= max(times.pm_length, 1):
                return b
        return TIMEBINS

    # a one-rank run's identity; the slab run sums over its ranks
    # (parallel/slab_sim.py), so every rank takes the same branch
    _reduce_type_stats = None

    def _sum_ranks(self, v: int) -> int:
        return v

    def _bin_hist(self, bins, *masks) -> np.ndarray:
        """[len(masks), TIMEBINS+1] host counts of `bins` over each mask,
        in one copy."""
        b = bins.long()
        return torch.stack([
            torch.bincount(torch.where(m, b, TIMEBINS + 1),
                           minlength=TIMEBINS + 2)[:TIMEBINS + 1]
            for m in masks]).cpu().numpy()

    def _active_source_accel(self, sel, n_act: int):
        """Short-range force with only the selected rows as sources and
        as targets (force_tree_active_moments semantics: at each level
        both are the active set, which makes the scheme conserve
        momentum).  `sel` is a device mask, `n_act` its count on the
        host."""
        return self._stencil(torch.where(sel, self.particles.mass, 0.0),
                             self.gravity.short(), sel, n_act)

    def _hier_grav_kick(self, sel, accel, ti: int, largest: int):
        """Half a step forward for bin ti, half a step back for ti+1
        (apply_hierarchical_grav_kick, timestep.cpp:247-289): the factor
        in float64 on the host, applied in f32."""
        times = self.times
        dti = dti_from_timebin(ti)
        gk = self.timeline.exact_gravkick_factor(
            self.CP, times.ti_kick[ti], times.ti_kick[ti] + dti // 2)
        if ti < largest:
            lower = dti_from_timebin(ti + 1)
            gk -= self.timeline.exact_gravkick_factor(
                self.CP, times.ti_kick[ti + 1],
                times.ti_kick[ti + 1] + lower // 2)
        p = self.particles
        fac = torch.where(sel & p.mask, float(np.float32(gk)), 0.0)
        self.particles = p.replace(vel=p.vel + accel * fac[:, None])

    def _hier_second_half(self):
        """Closing gravity kicks with a force of the active sources at
        each level (hierarchical_gravity_accelerations,
        timestep.cpp:483-566)."""
        largest = self._largest_active_bin()
        active = self._active_mask()
        tb = self.particles.timebin.long()
        below = np.cumsum(self._bin_hist(tb, active)[0])  # tb <= ti
        accel = None
        last_count = -1
        for ti in range(largest, max(self.times.mintimebin, 1) - 1, -1):
            cnt = int(below[ti])
            if cnt == 0:
                break
            sel = active & (tb <= ti)
            if cnt != last_count:
                accel = self._active_source_accel(sel, cnt)
                last_count = cnt
            self._hier_grav_kick(sel, accel, ti, largest)
            if ti == largest:
                # the top-level (all-active) force is the stored one the
                # next step's timesteps use
                self.particles = self.particles.replace(grav_accel=accel)
                self.last_n_targets = cnt

    def _hier_first_half(self, first_step: bool) -> int:
        """Assign the gravity timebins and do the opening kicks
        (hierarchical_gravity_and_timesteps, timestep.cpp:307-480).
        Returns the count of bad timesteps.  The timebins follow the JAX
        package's integer logic exactly, its push-down of a sparse top
        bin on PM steps included."""
        times = self.times
        is_pm = times.is_pm()
        p = self.particles
        if is_pm:
            self._new_pm_step()
        largest = self._largest_active_bin()
        dloga, oldacc = self._gravity_dloga()
        active = p.mask if first_step else self._active_mask()
        act = active & p.mask
        newbins, bad = assign_timebins(dloga, p.timebin, act, times,
                                       self.timeline,
                                       self.tsp.MinSizeTimestep)
        # every row, the inactive ones too, is clamped to the largest
        # active bin, as the JAX package does (simulation.py:613): after
        # a sub-step the bins above it collapse into it (ROADMAP C.4)
        newbins = torch.clamp(newbins.long(), max=largest)
        h_act, h_all = self._bin_hist(newbins, act, p.mask)

        # push-down: on PM steps a sparse top bin collapses into the one
        # below, so the top-level force need not be recomputed
        if is_pm:
            counts = h_act.copy()
            push_down = largest
            for ti in range(largest, 0, -1):
                if counts[ti] // 3 <= counts[ti - 1]:
                    push_down = ti - 1
                    counts[ti - 1] += counts[ti]
                else:
                    break
            if push_down != largest and push_down >= 1:
                newbins = torch.clamp(newbins, max=push_down)
                for h in (h_act, h_all):
                    h[push_down] += h[push_down + 1:].sum()
                    h[push_down + 1:] = 0
                largest = push_down
        self.particles = p.replace(old_acc=oldacc,
                                   timebin=newbins.to(torch.int8))
        occupied = np.nonzero(h_all)[0]
        if occupied.size:
            times.mintimebin = int(occupied.min())
            times.maxtimebin = int(occupied.max())
        if is_pm:
            self._pm_length_floor()

        # opening kicks: the top bin takes the stored force
        below = np.cumsum(h_act)       # active rows with bin <= ti
        if below[-1] > 0:
            self._hier_grav_kick(act & (newbins <= largest),
                                 self.particles.grav_accel, largest, largest)
        accel = None
        last_count = -1
        for ti in range(largest - 1, 0, -1):
            cnt = int(below[ti])
            if cnt == 0:
                times.mintimebin = max(times.mintimebin, ti + 1)
                break
            sel = act & (newbins <= ti)
            if cnt != last_count:
                accel = self._active_source_accel(sel, cnt)
                last_count = cnt
            self._hier_grav_kick(sel, accel, ti, largest)
        return self._sum_ranks(bad)

    def _apply_half_kick(self, skip_grav: bool = False):
        """The tree-gravity half kick (unless the hierarchy kicks by
        level) and, for the gas rows, the hydro kick, the MaxGasVel cap
        and the entropy update (do_hydro_kick)."""
        gk, hk, dte = gravkick_tables(self.CP, self.timeline, self.times,
                                      device=self.device)
        p = self.particles
        vel = p.vel if skip_grav else kick_gravity(
            p.vel, p.grav_accel, p.timebin, p.mask, gk)
        if self.gas is not None:
            ng = self.gas.ngas
            vg, ent = kick_hydro(
                vel[:ng], self.gas.entropy, self.gas.hydro_accel,
                self.gas.dt_entropy, p.timebin[:ng],
                (p.mask & (p.ptype == GAS))[:ng], hk, dte, self.atime(),
                self.tsp.MaxGasVel)
            vel = torch.cat([vg, vel[ng:]])
            self.gas = self.gas.replace(entropy=ent)
        self.particles = p.replace(vel=vel)

    def _apply_pm_half_kick(self):
        t0 = self.times.pm_kick
        t1 = t0 + self.times.pm_length // 2
        fac = self.timeline.exact_gravkick_factor(self.CP, t0, t1)
        p = self.particles
        self.particles = p.replace(vel=kick_pm(
            p.vel, p.grav_pm, p.mask, float(np.float32(fac))))
        self.times.pm_kick = t1

    def _new_pm_step(self):
        """The next PM step's length from the rms displacement criterion,
        clamped to the next sync point (timestep.cpp:114+)."""
        times = self.times
        p = self.particles
        asmth_internal = (self.gravity.asmth * self.boxsize
                          / self.gravity.nmesh)
        dloga_pm = long_range_dloga(
            p.vel, p.mass, p.ptype, p.mask, self.atime(), self.CP,
            self.boxsize, asmth_internal, self.tsp,
            reduce=self._reduce_type_stats)
        dti = round_down_power_of_two(
            self.timeline.dti_from_dloga(dloga_pm, times.ti_current))
        dti_max = (self.timeline.find_next_ti_sync(times.ti_current)
                   - times.pm_kick)
        times.pm_length = min(dti, dti_max)
        times.pm_start = times.pm_kick

    def _pm_length_floor(self):
        """A PM step never shorter than the largest occupied bin."""
        times = self.times
        if times.pm_length < dti_from_timebin(times.maxtimebin):
            times.pm_length = dti_from_timebin(times.maxtimebin)

    def _gravity_dloga(self):
        """(dloga [N] of the gravity criterion, old_acc [N] for the next
        step's opening criterion) from the total acceleration."""
        p = self.particles
        atime = self.atime()
        hubble = float(self.CP.hubble_function(atime))
        accel_tot = p.grav_accel + p.grav_pm
        dloga = gravity_dloga(accel_tot, atime, hubble,
                              self.gravity.softening,
                              self.tsp.ErrTolIntAccuracy)
        if self.gas is not None:
            # the hydro Courant limit folded into the gas rows' one bin
            # (simulation.py:592-601 and 726-736 of the JAX package)
            ng = self.gas.ngas
            dl_h = hydro_dloga(p.hsml[:ng], self.gas.max_signal_vel,
                               self.gas.dt_hsml, atime, hubble,
                               self.tsp.CourantFac)
            dg = dloga[:ng]
            dloga = torch.cat([torch.where(p.ptype[:ng] == GAS,
                                           torch.minimum(dg, dl_h), dg),
                               dloga[ng:]])
        return dloga, torch.linalg.norm(accel_tot, dim=-1) / self.gravity.G

    def _find_timesteps(self, first_step: bool):
        times = self.times
        is_pm = times.is_pm()
        p = self.particles
        if is_pm:
            self._new_pm_step()
        dloga, oldacc = self._gravity_dloga()
        active = p.mask if first_step else self._active_mask()
        newbins, bad = assign_timebins(dloga, p.timebin, active & p.mask,
                                       times, self.timeline,
                                       self.tsp.MinSizeTimestep)
        self.particles = p.replace(old_acc=oldacc, timebin=newbins)
        occupied = np.nonzero(self._bin_hist(newbins, p.mask)[0])[0]
        if occupied.size:
            times.mintimebin = int(occupied.min())
            times.maxtimebin = int(occupied.max())
        if is_pm:
            self._pm_length_floor()
        return self._sum_ranks(bad)

    def _active_mask(self):
        bins_active = torch.as_tensor(active_bins_mask(self.times.ti_current),
                                      device=self.device)
        return bins_active[self.particles.timebin.long()] & \
            self.particles.mask

    # ---------- the main loop ----------
    def run(self, max_steps: int = 10 ** 9):
        """Evolve until the last sync point (or max_steps); the stage
        order lives in core/step_protocol.run_protocol."""
        return run_protocol(self, max_steps)

    # ---------- step-protocol adapters (core/step_protocol) -------
    def proto_drift(self, ti_next):
        self._drift_all(ti_next)

    def proto_forces(self, is_pm, first):
        """Gas first (density with adaptive hsml + hydro,
        run.cpp:482-505), then gravity."""
        if is_pm:
            # the reference redraws the box shift at each full domain
            # decomposition, i.e. every PM step (run.cpp:426-428)
            self._apply_random_offset()
        if self.gas is not None and self.gas_physics is not None:
            # density and hydro take only the active-bin gas
            # (run.cpp:488-505 ActiveParticles); the first step takes all
            self.gas = self.gas_physics.density_hydro(
                self, self.gas, active=None if first
                else self._active_mask())
            if self._gas_entropy_is_u:
                # first pass: convert the initial u to entropy.  This
                # pass's hydro force took u as the entropy, as the JAX
                # package's does (simulation.py:878-881; ROADMAP C.4)
                self.init_gas_entropy()
            self._wt("SPH")
        if is_pm:
            self._compute_pm()
            self._wt("PMgrav")
        if self.hierarchical and not first:
            # per-level active-source closing kicks; the first step's
            # force is the full one
            self._hier_second_half()
        else:
            self._compute_tree(first_step=first)
        self._wt("Tree")

    def proto_sources(self, is_pm, first):
        """Strang-split sources (run.cpp:604-681; simulation.py:896-941
        of the JAX package): the DM velocity dispersion on PM steps,
        then cooling, star formation and winds on the active gas with
        each row's own bin's dtime, then black holes (accretion,
        feedback, swallowing, mergers, drag, dynamical friction) with the
        same dtime, then metal return, timed as Cooling, BH and
        MetalReturn (simulation.py:934-941).  Adiabatic gas has no source
        stage: with every switch off each of the JAX package's stages
        returns its input."""
        gp = self.gas_physics
        if self.gas is None or gp is None or first or not (
                gp.cooling_on or gp.sfr_on or gp.metal_return_on
                or gp.bh_on or gp.excursion is not None):
            return
        times = self.times
        if is_pm:
            # sigma-based winds refresh vdisp once per PM step
            # (run.cpp:662-663)
            self.gas = gp.update_vdisp(self, self.gas)
            # the excursion set's J21 at PM cadence once a FOF has given
            # the halo masses (simulation.py:906-912 of the JAX package)
            if self.halo_mass is not None and gp.excursion is not None:
                self.gas = gp.excursion_step(self, self.gas, self.halo_mass)
        # sources act on ACTIVE rows with their OWN bin's dloga
        # (sfr_eff.cpp cooling_and_starformation: get_dloga_for_bin)
        hubble = float(self.CP.hubble_function(self.atime()))
        dt_tab = np.array(
            [self.timeline.get_dloga_for_bin(b, times.ti_current) / hubble
             for b in range(TIMEBINS + 1)], np.float32)
        dt_tab *= active_bins_mask(times.ti_current)
        ng = self.gas.ngas
        sbins = torch.clamp(self.particles.timebin[:ng].long(), 1, TIMEBINS)
        dtime = torch.from_numpy(dt_tab).to(self.device)[sbins]
        self.gas, _ = gp.source_terms(self, self.gas, dtime)
        self._wt("Cooling")
        self.gas = gp.blackhole_step(self, self.gas, dtime)
        self._wt("BH")
        self.gas = gp.metal_return(self, self.gas)
        self._wt("MetalReturn")

    def _slots_gc(self):
        # reclaim dead rows before writing (run.cpp:704 runs slots_gc
        # ahead of the snapshot)
        if self.gas is not None and self.gas_physics is not None:
            self.gas_physics.slots_gc(self, self.gas)

    def proto_snapshot(self, atime):
        self._slots_gc()
        if self.on_snapshot:
            self.on_snapshot(self, atime)

    def proto_checkpoint(self, cb, atime):
        self._slots_gc()
        cb(self, atime)

    def proto_pre_timestep(self):
        """No diagnostics before find-timesteps in the DM slice."""

    def proto_bad_timestep(self, bad):
        # emergency dump before aborting (run.cpp:794-797)
        if getattr(self, "on_bad_timestep", None):
            self.on_bad_timestep(self)
        raise RuntimeError(f"{bad} bad timesteps at step "
                           f"{self.step_count}")
