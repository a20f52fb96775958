"""Individual timesteps: criteria, bins, KDK kicks
(shenqi_tpu/core/integrate.py:35-321 in torch).

Host-side DriftKickTimes bookkeeping (Python ints on the 2^46-tick
timeline) plus per-particle criteria and kicks on the device: the
per-particle kick factor is a gather from a [TIMEBINS+1] factor table
by timebin.

Criteria (timestep.cpp:99-137, 1012-1040):
  * gravity: dt = sqrt(2 ErrTolIntAccuracy atime eps / |a_phys|),
    eps = FORCE_SOFTENING/2.8, a_phys = (a_tree + a_pm)/atime^2
  * hydro (gas): the Courant condition on the signal velocity and the
    smoothing-length change rate
  * PM step: MaxRMSDisplacementFac hubble atime^2 min(asmth, dmean)
    / sqrt(<v^2>) per type, min over types
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .timeline import TIMEBINS, TIMEBASE, Timeline, dti_from_timebin
from ..utils.constants import GAMMA


@dataclass
class TimestepParams:
    ErrTolIntAccuracy: float = 0.02
    CourantFac: float = 0.15
    MaxRMSDisplacementFac: float = 0.2
    MaxSizeTimestep: float = 0.1
    MinSizeTimestep: float = 0.0
    MaxGasVel: float = 3e5
    ForceEqualTimesteps: bool = False
    FastParticleType: int = 2


@dataclass
class DriftKickTimes:
    """Host-side integer kick/drift bookkeeping (timestep.h:10-26)."""

    ti_current: int = 0
    ti_kick: list = field(default_factory=lambda: [0] * (TIMEBINS + 1))
    ti_lastactivedrift: list = field(
        default_factory=lambda: [0] * (TIMEBINS + 1))
    pm_kick: int = 0
    pm_start: int = 0
    pm_length: int = 0
    mintimebin: int = TIMEBINS
    maxtimebin: int = 0

    @classmethod
    def init(cls, ti: int) -> "DriftKickTimes":
        t = cls(ti_current=ti)
        t.ti_kick = [ti] * (TIMEBINS + 1)
        t.ti_lastactivedrift = [ti] * (TIMEBINS + 1)
        t.pm_kick = ti
        t.pm_start = ti
        t.pm_length = 0   # first step is always a PM step
        t.mintimebin = 0
        t.maxtimebin = 0
        return t

    def is_pm(self) -> bool:
        if self.ti_current > self.pm_start + self.pm_length:
            raise RuntimeError("passed end of PM step")
        return self.ti_current == self.pm_start + self.pm_length


def is_timebin_active(bin: int, ti: int) -> bool:
    if bin <= 0 or ti <= 0:
        return True
    return ti % dti_from_timebin(bin) == 0


def active_bins_mask(ti: int) -> np.ndarray:
    """[TIMEBINS+1] bool: which bins are active at integer time ti."""
    return np.array([is_timebin_active(b, ti)
                     for b in range(TIMEBINS + 1)])


def find_next_kick(ti: int, mintimebin: int) -> int:
    return ti + dti_from_timebin(max(mintimebin, 1))


# ---------- device-side criteria ----------

def gravity_dloga(accel_total, atime, hubble, softening,
                  err_tol_int_acc):
    """sqrt(2 eta a eps/|a_phys|) * H  (timestep.cpp:1028-1040), f32."""
    a2inv = 1.0 / (atime * atime)
    ac2 = torch.sum((accel_total * a2inv) ** 2, dim=-1)
    ac = torch.sqrt(torch.clamp(ac2, min=1e-60))
    eps = softening / 2.8
    dt = torch.sqrt(2 * err_tol_int_acc * atime * eps / ac)
    return dt * hubble


def hydro_dloga(hsml, max_signal_vel, dt_hsml, atime, hubble,
                courant_fac):
    """Courant + Hsml-change criteria; returns dloga."""
    fac3 = atime ** (3 * (1 - GAMMA) / 2.0)
    dt_courant = (2 * courant_fac * atime * hsml
                  / (fac3 * torch.clamp(max_signal_vel, min=1e-35)))
    dt_hsml_c = (courant_fac * atime * atime
                 * torch.abs(hsml / (dt_hsml + 1e-20)))
    return torch.minimum(dt_courant, dt_hsml_c) * hubble


def long_range_dloga(vel, mass, ptype, alive, atime, CP, boxsize,
                     asmth_internal, params: TimestepParams, reduce=None):
    """Global PM timestep from RMS displacement (timestep.cpp:114+).

    Per-type reductions on the device in float64; the combination
    across types is host arithmetic as in the JAX package.  `reduce`,
    when given, combines the [6, 3] per-type (sum v^2, count, min mass)
    table across ranks (the slab run's all_reduce)."""
    vel = vel.double()
    mass = mass.double()
    hubble = CP.hubble_function(atime)
    v_sum = np.zeros(6)
    count = np.zeros(6, dtype=np.int64)
    min_mass = np.full(6, 1e30)
    v2 = torch.sum(vel * vel, dim=-1)
    stats = []
    for t in range(6):
        sel = alive & (ptype == t)
        pos_m = sel & (mass > 0)
        stats.append(torch.stack([
            torch.sum(torch.where(sel, v2, 0.0)),
            torch.sum(sel.double()),
            torch.amin(torch.where(pos_m, mass, 1e30)),
        ]))
    stats = torch.stack(stats)
    if reduce is not None:
        stats = reduce(stats)
    stats = stats.cpu().numpy()
    for t in range(6):
        v_sum[t] = stats[t, 0]
        count[t] = int(stats[t, 1])
        min_mass[t] = stats[t, 2]
    # combine baryonic species
    v_sum[0] += v_sum[4]
    count[0] += count[4]
    v_sum[4], count[4] = v_sum[0], count[0]
    v_sum[0] += v_sum[5]
    count[0] += count[5]
    v_sum[5], count[5] = v_sum[0], count[0]
    min_mass[5] = min_mass[0]

    dloga = params.MaxSizeTimestep
    for t in range(6):
        if count[t] == 0:
            continue
        if t in (0, 4, 5):
            omega = CP.OmegaBaryon
        elif t == 2:
            omega = CP.ONu.get_omega_nu(1.0)
        else:
            omega = CP.OmegaCDM
        if omega <= 0:
            omega = CP.OmegaCDM if CP.OmegaCDM > 0 else CP.Omega0
        dmean = (min_mass[t] / (omega * CP.RhoCrit)) ** (1.0 / 3)
        dloga1 = (params.MaxRMSDisplacementFac * hubble * atime ** 2
                  * min(asmth_internal, dmean)
                  / np.sqrt(v_sum[t] / count[t]))
        if t != params.FastParticleType and dloga1 < dloga:
            dloga = dloga1
    return max(dloga, params.MinSizeTimestep)


def _floor_log2(dti: torch.Tensor) -> torch.Tensor:
    """Exact floor(log2(dti)) for int64 dti >= 1 (the bit length - 1)."""
    b = torch.floor(torch.log2(dti.double())).long()
    one = torch.ones_like(dti)
    b = torch.where(torch.bitwise_left_shift(one, b + 1) <= dti, b + 1, b)
    return torch.where(torch.bitwise_left_shift(one, b) > dti, b - 1, b)


def assign_timebins(dloga, timebin_old, active, times: DriftKickTimes,
                    timeline: Timeline, min_dloga: float = 0.0):
    """dloga [N] -> new power-of-two timebins, on the device.

    A particle's bin may only grow to a bin that is active now
    (synchronization rule); dti is clamped to the PM step length.
    The JAX package walks the active particles one by one; since the
    active bins at any time are {0..bmax}, the walk down from bin b to
    the first active bin above the old one is max(old, min(b, bmax)),
    which is what this computes for every particle at once.
    Returns (new_timebins [N] int8 tensor, bad_count int).
    """
    dev = dloga.device
    dloga = dloga.double()
    old = timebin_old.long()
    dti_max = times.pm_length
    ti = times.ti_current
    dloga_per_ti = timeline.dloga_interval_ti(ti)
    if dloga_per_ti <= 0:
        return timebin_old.clone(), 0
    dloga_c = torch.clamp(dloga, min=min_dloga)
    # an UNCONSTRAINED step (|acc|=0 -> dloga=inf) clamps to the PM
    # step; only NaN falls through to the bad-timestep count
    dloga_cap = float(dti_max) * dloga_per_ti
    dloga_c = torch.where(dloga_c > dloga_cap, dloga_cap, dloga_c)
    q = dloga_c / dloga_per_ti
    nan = torch.isnan(q)
    # numpy's float -> int64 cast of NaN gives INT64_MIN
    dti = torch.where(nan, torch.iinfo(torch.int64).min,
                      torch.where(nan, 0.0, q).long())
    dti = torch.clamp(torch.clamp(dti, max=dti_max), min=0)
    bins = torch.where(dti > 0, _floor_log2(torch.clamp(dti, min=1)), 0)
    bins = torch.clamp(bins, 0, TIMEBINS)
    bad = int(torch.sum(active & ((dti <= 1) | (dti > TIMEBASE))))
    act = active_bins_mask(ti)
    bmax = int(np.nonzero(act)[0].max())
    grown = torch.maximum(old, torch.clamp(bins, max=bmax))
    b = torch.where(bins > old, grown, bins)
    b = torch.clamp(b, min=1)
    new = torch.where(active, b, old)
    return new.to(timebin_old.dtype).to(dev), bad


# ---------- device-side kicks ----------

def kick_gravity(vel, accel, timebin, active_mask, gravkick_table):
    """v += a_tree * gravkick[bin] for active particles."""
    fac = gravkick_table[timebin.long()]
    fac = torch.where(active_mask, fac, 0.0)
    return vel + accel * fac[:, None]


def kick_hydro(vel, entropy, hydro_accel, dt_entropy_rate, timebin,
               is_gas, hydrokick_table, dt_entr_table, atime, max_gas_vel):
    """Hydro kick + entropy update + the MaxGasVel cap for gas rows
    (do_hydro_kick, timestep.cpp:988-998)."""
    bin_i = timebin.long()
    hk = torch.where(is_gas, hydrokick_table[bin_i], 0.0)
    vel = vel + hk[:, None] * hydro_accel
    # hard velocity limit
    vv = torch.linalg.norm(vel, dim=-1)
    over = is_gas & (vv / atime > max_gas_vel) & (vv > 0)
    scale = torch.where(over, max_gas_vel * atime
                        / torch.clamp(vv, min=1e-35), 1.0)
    vel = vel * scale[:, None]
    entropy = entropy + torch.where(is_gas, dt_entr_table[bin_i],
                                    0.0) * dt_entropy_rate
    return vel, entropy


def kick_pm(vel, grav_pm, alive, fac):
    return vel + torch.where(alive[:, None], grav_pm * fac, 0.0)


def gravkick_tables(CP, timeline: Timeline, times: DriftKickTimes,
                    device=None):
    """Per-bin (gravkick, hydrokick, dt_entr) half-step factor tables,
    f32 tensors on `device`.

    Factors from Ti_kick[bin] to Ti_kick[bin]+dti/2 for active bins
    (apply_half_kick, timestep.cpp:842-880); zeros for inactive bins.
    """
    grav = np.zeros(TIMEBINS + 1)
    hyd = np.zeros(TIMEBINS + 1)
    dte = np.zeros(TIMEBINS + 1)
    for b in range(TIMEBINS + 1):
        if not is_timebin_active(b, times.ti_current):
            continue
        t0 = times.ti_kick[b]
        t1 = t0 + dti_from_timebin(b) // 2
        if t1 == t0:
            continue
        grav[b] = timeline.exact_gravkick_factor(CP, t0, t1)
        hyd[b] = timeline.exact_hydrokick_factor(CP, t0, t1)
        dte[b] = timeline.dloga_from_dti(dti_from_timebin(b) // 2,
                                         times.ti_current)
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=device)
                 for x in (grav, hyd, dte))


def predictor_tables(CP, timeline: Timeline, times: DriftKickTimes,
                     device=None):
    """Per-bin drift-time predictor factors (density.c VelPred /
    EntVarPred semantics): an inactive particle's velocity sits at its
    last half-kick time Ti_kick[bin]; neighbour interactions predict it
    forward to ti_current with these signed factors.

    Returns (gravkick[TB+1], hydrokick[TB+1], dloga[TB+1], gk_pm).
    """
    grav = np.zeros(TIMEBINS + 1)
    hyd = np.zeros(TIMEBINS + 1)
    dte = np.zeros(TIMEBINS + 1)
    for b in range(TIMEBINS + 1):
        t0 = times.ti_kick[b]
        if t0 == times.ti_current:
            continue
        grav[b] = timeline.exact_gravkick_factor(CP, t0, times.ti_current)
        hyd[b] = timeline.exact_hydrokick_factor(CP, t0, times.ti_current)
        dte[b] = timeline.dloga_from_dti(times.ti_current - t0,
                                         times.ti_current)
    gk_pm = timeline.exact_gravkick_factor(CP, times.pm_kick,
                                           times.ti_current)
    return (*(torch.as_tensor(x, dtype=torch.float32, device=device)
              for x in (grav, hyd, dte)), float(gk_pm))


def update_kick_times(times: DriftKickTimes):
    """Advance Ti_kick for active bins by half their step."""
    if times.mintimebin == 0 and times.maxtimebin == 0:
        return
    for b in range(times.mintimebin, TIMEBINS + 1):
        if is_timebin_active(b, times.ti_current):
            times.ti_kick[b] += dti_from_timebin(b) // 2
    for b in range(1, times.mintimebin):
        times.ti_kick[b] += dti_from_timebin(times.mintimebin) // 2
