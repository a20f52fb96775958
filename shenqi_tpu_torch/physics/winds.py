"""Kinetic stellar winds (winds.cpp analog; shenqi_tpu/physics/winds.py
in torch).

Two paths, as in the JAX package:
  * the SUBGRID wind (winds_make_after_sf + wind_do_kick): the
    star-forming gas particle itself is kicked with a probability;
  * the neighbour kick (sfr_wind_feedback_ngbiter, winds.cpp:514-566):
    each new star kicks the gas inside its smoothing length, a dense
    [gas x new-star bucket] pass (`winds_star_feedback`), which the
    ofjt10 model of star-small takes.
Both velocity scalings are implemented: SH03 fixed efficiency and the
halo-based VS08/ofjt10 (wind speed from the DM velocity dispersion).
Decoupled wind particles (DelayTime > 0) skip hydro forces until they
recouple.

The id hash is bit-identical to the JAX package's: its uint32 products
go through `utils/threefry.mulmod32`, whose partial products stay below
2^63 in int64.  The full-shape uniforms are threefry draws
(`utils/threefry.py`); the dense pass runs a block of gas rows at a time
when the pair count is large, drawing each block's counters of the
whole [gas x bucket] shape.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..utils import threefry
from ..utils.constants import GAMMA_MINUS1, SEC_PER_MEGAYEAR

# WindModel flags (winds.h:14-21)
WIND_SUBGRID = 1
WIND_DECOUPLE_SPH = 2
WIND_USE_HALO = 4
WIND_FIXED_EFFICIENCY = 8
WIND_ISOTROPIC = 512
# canonical combinations (gadget/params.cpp:234-243)
WIND_MODEL_SH03 = WIND_SUBGRID | WIND_DECOUPLE_SPH | WIND_FIXED_EFFICIENCY
WIND_MODEL_VS08 = WIND_FIXED_EFFICIENCY
WIND_MODEL_OFJT10 = WIND_USE_HALO | WIND_DECOUPLE_SPH

_M32 = 0xFFFFFFFF
# pairs of one block of the dense star-feedback pass
_PAIR_BLOCK = 1 << 24


def _mix32(a, b):
    """Counter-based avalanche hash of two uint32 streams (the
    get_random_number(ID + i) analog): int64 tensors (or ints) holding
    uint32 values, the JAX package's bits."""
    x = threefry.mulmod32(a, 0x9E3779B9) ^ threefry.mulmod32(b, 0x85EBCA6B)
    x = threefry.mulmod32(x ^ (x >> 16), 0x7FEB352D)
    x = threefry.mulmod32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def idhash_uniform(salt, pid_u32, lane: int):
    """Uniform [0,1) f32 draw keyed by (per-step salt, particle id,
    lane).  salt: a uint32 value (int); pid_u32: int64 tensor of uint32
    ids."""
    x = _mix32((pid_u32 + (lane * 0x27D4EB2F & _M32)) & _M32, salt)
    return x.to(torch.float32) * float(2.0 ** -32)


@dataclass
class WindParams:
    WindModel: int = 0
    WindEfficiency: float = 2.0
    WindEnergyFraction: float = 1.0
    WindSigma0: float = 353.0
    WindSpeedFactor: float = 3.7
    WindThermalFactor: float = 0.0
    MinWindVelocity: float = 0.0
    WindFreeTravelLength: float = 20.0
    WindFreeTravelDensFac: float = 0.1
    MaxWindFreeTravelTime: float = 60.0    # Myr (converted in init)
    # derived
    WindSpeed: float = 0.0
    WindFreeTravelDensThresh: float = 0.0

    def init(self, factor_sn, egy_spec_sn, phys_dens_thresh,
             unit_time_in_s):
        self.WindSpeed = np.sqrt(2 * self.WindEnergyFraction * factor_sn
                                 * egy_spec_sn / (1 - factor_sn))
        self.MaxWindFreeTravelTime = (self.MaxWindFreeTravelTime
                                      * SEC_PER_MEGAYEAR
                                      / unit_time_in_s)
        self.WindFreeTravelDensThresh = (self.WindFreeTravelDensFac
                                         * phys_dens_thresh)
        return self

    def has(self, flag):
        return (self.WindModel & flag) != 0


def ever_decouple(wp: WindParams) -> bool:
    return wp.has(WIND_DECOUPLE_SPH) and wp.MaxWindFreeTravelTime > 0


def is_decoupled(delay_time, density, a3inv, wp: WindParams):
    """winds_is_particle_decoupled: in the wind phase and still dense."""
    if not ever_decouple(wp):
        return torch.zeros_like(delay_time, dtype=torch.bool)
    return ((delay_time > 0)
            & (density * a3inv > wp.WindFreeTravelDensThresh))


def wind_params_for(vdisp, atime, wp: WindParams):
    """(kick velocity, efficiency, utherm) per particle
    (get_wind_params math)."""
    vphys = vdisp / atime
    utherm = wp.WindThermalFactor * 1.5 * vphys * vphys
    if wp.has(WIND_FIXED_EFFICIENCY):
        windeff = torch.full_like(vdisp, wp.WindEfficiency)
        vel = torch.full_like(vdisp, wp.WindSpeed * atime)
    else:  # WIND_USE_HALO (VS08)
        windeff = wp.WindSigma0 ** 2 / torch.clamp(
            vphys * vphys + 2 * utherm, min=1e-35)
        vel = wp.WindSpeedFactor * vdisp
    vel = torch.clamp(vel, min=wp.MinWindVelocity * atime)
    return vel, windeff, utherm


class WindResult(NamedTuple):
    vel: torch.Tensor          # updated velocities [N,3]
    entropy: torch.Tensor      # updated entropy
    delay_time: torch.Tensor   # updated decoupling clocks


def winds_subgrid_step(key, vel3, entropy, density, delay_time, mass,
                       sm, vdisp, atime, a3inv, wp: WindParams,
                       eligible, pids=None) -> WindResult:
    """Subgrid wind kicks after star formation (winds_make_after_sf).

    sm: stellar mass formed this step per particle; eligible: gas mask;
    pids: int32 bit patterns of the low id words, keying every draw by
    (step salt, id) as the JAX package's `pids` path does.  Without
    pids the JAX package draws jax.random.normal directions, which this
    port does not carry: the caller gives ids.
    """
    if not wp.has(WIND_SUBGRID) or wp.WindModel == 1:  # nowind
        return WindResult(vel3, entropy, delay_time)
    if pids is None:
        raise NotImplementedError(
            "winds_subgrid_step: the id-keyed draws only (pids)")
    kick_v, windeff, utherm = wind_params_for(vdisp, atime, wp)
    pw = windeff * sm / torch.clamp(mass, min=1e-35)
    prob = 1 - torch.exp(-pw)
    salt = threefry.bits(key)
    pid = pids.long() & _M32
    u_kick = idhash_uniform(salt, pid, 0)
    # isotropic direction from two id-keyed uniforms
    z = 2.0 * idhash_uniform(salt, pid, 1) - 1.0
    phi = 2.0 * np.pi * idhash_uniform(salt, pid, 2)
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    dirs = torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], dim=-1)
    do_kick = (u_kick < prob) & eligible & (kick_v > 0)
    vel_new = vel3 + torch.where(do_kick[:, None],
                                 kick_v[:, None] * dirs, 0.0)
    enttou = (density * a3inv) ** GAMMA_MINUS1 / GAMMA_MINUS1
    ent_new = entropy + torch.where(do_kick, utherm
                                    / torch.clamp(enttou, min=1e-35), 0.0)
    if ever_decouple(wp):
        delay = wp.WindFreeTravelLength / torch.clamp(kick_v / atime,
                                                      min=1e-35)
        delay = torch.clamp(delay, max=wp.MaxWindFreeTravelTime)
        delay_new = torch.where(do_kick, delay, delay_time)
    else:
        delay_new = delay_time
    return WindResult(vel_new, ent_new, delay_new)


def winds_star_feedback(key, star_ipos, star_hsml, star_mass,
                        star_vdisp, gas_ipos, gas_mass, gas_vel,
                        gas_entropy, gas_density, gas_delay,
                        gas_alive, boxsize, atime, a3inv,
                        wp: WindParams, gas_pids=None, star_pids=None,
                        total_weight=None, pair_block: int = _PAIR_BLOCK):
    """Non-subgrid winds: new stars kick neighbouring gas
    (sfr_wind_feedback_ngbiter, winds.cpp:514-566).

    Two passes over the dense [Ngas x Nstar] pair grid: (1) total
    eligible gas mass within each star's Hsml (wk=1 weighting); (2) per
    pair, kick probability p = windeff * M_star / TotalWeight; a gas
    particle hit by several stars takes the NEAREST one.  Kicked gas
    gains an isotropic random velocity of magnitude v, thermal energy
    utherm, and a decoupling delay time.

    Without ids the draws are the JAX package's full-shape ones:
    jax.random.uniform of the whole [Ngas, Nstar] shape and two of
    [Ngas] from split(key, 3) (the JAX `source_terms` passes no ids;
    ROADMAP C.4).  With gas_pids and star_pids (int32 bit patterns of
    the low id words) every draw is keyed by (step salt, id) through
    idhash_uniform, salt = bits(key, (2,)): the hit of a pair by the
    mixed (gas, star) ids, the direction by the gas id, so the draws do
    not depend on the row layout or the rank count (the slab winds).
    total_weight: the per-star eligible gas mass from the caller (the
    slab winds sum it over ranks); summed here when None.  Gas rows are
    taken `pair_block` pairs at a time, each block with its counters of
    the whole shape.  Returns (vel, entropy, delay_time).
    """
    from ..ops.treewalk import pair_dist
    ns = star_ipos.shape[0]
    ng = gas_ipos.shape[0]
    if ns == 0:
        return gas_vel, gas_entropy, gas_delay
    dev = gas_ipos.device
    rows = max(1, pair_block // ns)
    eligible = gas_alive & (gas_delay <= 0)
    h2 = star_hsml[None, :] ** 2

    def block_r2(g0, g1):
        _, r2 = pair_dist(gas_ipos[g0:g1, None, :], star_ipos[None, :, :],
                          boxsize)
        return r2, (r2 < h2) & eligible[g0:g1, None]

    if total_weight is None:
        # pass 1: eligible gas mass inside each star's hsml
        total_weight = torch.zeros(ns, dtype=torch.float32, device=dev)
        for g0 in range(0, ng, rows):
            g1 = min(g0 + rows, ng)
            _, inside = block_r2(g0, g1)
            total_weight += torch.sum(
                torch.where(inside, gas_mass[g0:g1, None], 0.0), dim=0)
    v, windeff, utherm = wind_params_for(star_vdisp, atime, wp)
    pstar = windeff * star_mass / torch.clamp(total_weight, min=1e-35)
    pok = (total_weight > 0) & (v > 0)

    if gas_pids is not None:
        salt = threefry.bits(key, (2,))
        s0, s1 = int(salt[0]), int(salt[1])
        gpid = gas_pids.long() & _M32
        spid = star_pids.long() & _M32
    else:
        k1, k2, k3 = threefry.split(key, 3)
    kicked = torch.zeros(ng, dtype=torch.bool, device=dev)
    best = torch.zeros(ng, dtype=torch.int64, device=dev)
    for g0 in range(0, ng, rows):
        g1 = min(g0 + rows, ng)
        r2, inside = block_r2(g0, g1)
        p = torch.where(inside & pok[None, :], pstar[None, :], 0.0)
        if gas_pids is not None:
            u_hit = idhash_uniform(
                s0, _mix32(gpid[g0:g1, None], spid[None, :]), 0)
        else:
            u_hit = threefry.uniform(k1, (g1 - g0, ns), start=g0 * ns,
                                     device=dev)
        hit = u_hit < p
        # nearest hitting star per gas particle
        r2m = torch.where(hit, r2, float("inf"))
        best[g0:g1] = torch.argmin(r2m, dim=1)
        kicked[g0:g1] = torch.any(hit, dim=1)
    if gas_pids is not None:
        u_th = idhash_uniform(s1, gpid, 1)
        u_ph = idhash_uniform(s1, gpid, 2)
    else:
        u_th = threefry.uniform(k2, (ng,), device=dev)
        u_ph = threefry.uniform(k3, (ng,), device=dev)
    vkick = v[best]
    ukick = utherm[best]

    theta = torch.arccos(2 * u_th - 1)
    phi = 2 * np.pi * u_ph
    direc = torch.stack([torch.sin(theta) * torch.cos(phi),
                         torch.sin(theta) * torch.sin(phi),
                         torch.cos(theta)], -1)
    kickedf = kicked.to(torch.float32)
    vel = gas_vel + (kickedf * vkick)[:, None] * direc
    enttou = torch.clamp(gas_density * a3inv, min=1e-35) ** GAMMA_MINUS1 \
        / GAMMA_MINUS1
    entropy = gas_entropy + torch.where(kicked, ukick / enttou, 0.0)
    if ever_decouple(wp):
        delay = torch.clamp(
            wp.WindFreeTravelLength
            / torch.clamp(vkick / atime, min=1e-35),
            max=wp.MaxWindFreeTravelTime)
        gas_delay = torch.where(kicked, delay, gas_delay)
    return vel, entropy, gas_delay


def winds_decay(delay_time, density, a3inv, dtime, wp: WindParams):
    """Advance decoupling clocks; recouple when diffuse
    (winds_decoupled_hydro semantics)."""
    if not ever_decouple(wp):
        return delay_time
    delay = torch.clamp(delay_time - dtime, min=0.0)
    recouple = density * a3inv < wp.WindFreeTravelDensThresh
    return torch.where(recouple, 0.0, delay)
