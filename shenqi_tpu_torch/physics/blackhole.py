"""Black hole accretion and feedback (blackhole.cpp analog;
shenqi_tpu/physics/blackhole.py in torch).

Black holes are rare, so dense [gas x BH] kernel sums replace the
reference's two-pass treewalk, a block of pairs at a time:

  * the BH-centred SPH environment: kernel-weighted gas density, smoothed
    entropy and velocity, feedback weight sums (also the metal return's
    weight sums);
  * Bondi-Hoyle accretion with the Eddington cap (blackhole.cpp:377-410);
  * thermal feedback: E = eps_f 0.1 Mdot c^2 dt, kernel-weighted onto the
    gas within the BH's hsml (blackhole_feedback_ngbiter);
  * stochastic gas swallowing (the Mtrack scheme), its draws the JAX
    package's `jax.random.uniform(key, (ng, nb))` through the port's
    threefry stream, counter for counter;
  * BH-BH mergers, the drag of the accreted momentum and Chandrasekhar
    dynamical friction;
  * the FOF seeding decision (host numpy, copied).

`BHParams`, `bh_mergers` and `seed_black_holes` are copies of the JAX
package's host code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..sph.kernels import KernelSpec, CUBIC, wk as kern_wk
from ..utils import threefry
from ..utils.constants import (GAMMA, GAMMA_MINUS1, GRAVITY, LIGHTCGS,
                               PROTONMASS, THOMPSON)

# pairs of one block of the dense [points x gas] passes
_PAIR_BLOCK = 1 << 24
# the feedback pass's BH chunk (the JAX package's BH_CHUNK): each gas row
# sums its shares chunk by chunk, as there
_BH_CHUNK = 256


@dataclass
class BHParams:
    BlackHoleAccretionFactor: float = 100.0
    BlackHoleEddingtonFactor: float = 2.1
    BH_DRAG: int = 1
    BlackHoleFeedbackFactor: float = 0.05
    SeedBlackHoleMass: float = 2e-5
    SeedBHDynMass: float = -1.0
    MinFoFMassForNewSeed: float = 2.0
    MinMStarForNewSeed: float = 5e-4
    BlackHoleNgbFactor: float = 2.0
    BlackHoleMaxAccretionRadius: float = 99999.0
    # units
    UnitTime_in_s: float = 3.085678e16
    UnitVelocity_in_cm_per_s: float = 1e5
    HubbleParam: float = 0.7


def bh_soundspeed(entropy, rho, atime):
    """Physical sound speed from entropy + comoving density
    (blackhole.cpp:147-156)."""
    cs = torch.sqrt(GAMMA * entropy
                    * torch.clamp(rho, min=1e-35) ** GAMMA_MINUS1)
    return torch.where(rho > 0, cs * atime ** (-1.5 * GAMMA_MINUS1), 0.0)


def eddington_rate(bh_mass, par: BHParams):
    """Eddington accretion rate in internal units (blackhole.cpp:379)."""
    return (4 * np.pi * GRAVITY * LIGHTCGS * PROTONMASS
            / (0.1 * LIGHTCGS ** 2 * THOMPSON) * bh_mass
            * par.UnitTime_in_s / par.HubbleParam)


def bondi_rate(bh_mass, rho, cs, bhvel, atime, G, par: BHParams):
    """Bondi-Hoyle rate with the comoving density conversion
    (blackhole.cpp:397-408): rho_phys = rho a^-3, v in physical."""
    rho_phys = rho / atime ** 3
    norm = (cs * cs + bhvel * bhvel) ** 1.5
    mdot = torch.where(norm > 0,
                       4 * np.pi * par.BlackHoleAccretionFactor * G * G
                       * bh_mass * bh_mass * rho_phys
                       / torch.clamp(norm, min=1e-35), 0.0)
    medd = eddington_rate(bh_mass, par)
    return torch.minimum(mdot, par.BlackHoleEddingtonFactor * medd)


class BHEnv(NamedTuple):
    """Kernel-weighted gas environment at each point."""
    density: torch.Tensor          # [Nb]
    entropy: torch.Tensor          # [Nb] smoothed entropy / density
    gas_vel: torch.Tensor          # [Nb,3] smoothed velocity / density
    feedback_weight: torch.Tensor  # [Nb] sum m_j wk


def _kernel_weights(tipos, sipos, H, ok, boxsize, spec):
    """wk(r/H, H) of every (target, source) pair of the broadcast shapes,
    zero outside H or where `ok` is false (the JAX package's form)."""
    from ..ops.treewalk import pair_dist
    _, r2 = pair_dist(tipos, sipos, boxsize)
    inside = (r2 < H * H) & ok
    Hs = torch.clamp(H, min=1e-35)
    u = torch.clamp(torch.sqrt(r2) / Hs, max=1.0)
    return torch.where(inside, kern_wk(spec, u, Hs), 0.0)


def bh_gas_environment(bh_ipos, bh_hsml, gas_ipos, gas_mass,
                       gas_entropy, gas_vel, gas_alive, boxsize,
                       spec: KernelSpec = CUBIC) -> BHEnv:
    """Dense [Nb x Ngas] kernel sums, a block of gas rows at a time (the
    JAX package scans chunks of 8192)."""
    nb = bh_ipos.shape[0]
    ng = gas_ipos.shape[0]
    dev = bh_ipos.device
    dens = torch.zeros(nb, dtype=torch.float32, device=dev)
    sent = torch.zeros_like(dens)
    svel = torch.zeros((nb, 3), dtype=torch.float32, device=dev)
    H = bh_hsml[:, None]
    cols = max(1, _PAIR_BLOCK // max(nb, 1))
    for g0 in range(0, ng, cols):
        g = slice(g0, min(g0 + cols, ng))
        gm = gas_mass[g]
        w = _kernel_weights(bh_ipos[:, None, :], gas_ipos[g][None, :, :], H,
                            gas_alive[g][None, :] & (gm[None, :] > 0),
                            boxsize, spec)
        mw = gm[None, :] * w
        dens += torch.sum(mw, 1)
        sent += torch.sum(mw * gas_entropy[g][None, :], 1)
        svel += mw @ gas_vel[g]
    dsafe = torch.clamp(dens, min=1e-35)
    # the JAX package sums the feedback weight apart from the density,
    # the same sum
    return BHEnv(density=dens, entropy=sent / dsafe,
                 gas_vel=svel / dsafe[:, None], feedback_weight=dens.clone())


def bh_accretion(bh_mass, bh_vel, env: BHEnv, atime, G, par: BHParams):
    """Mdot of each BH."""
    cs = bh_soundspeed(env.entropy, env.density, atime)
    dv = (bh_vel - env.gas_vel) / atime  # physical relative velocity
    bhvel = torch.linalg.norm(dv, dim=-1)
    return bondi_rate(bh_mass, env.density, cs, bhvel, atime, G, par)


def bh_thermal_feedback(bh_ipos, bh_hsml, bh_energy, bh_fw, gas_ipos,
                        gas_mass, gas_density, gas_alive, boxsize, a3inv,
                        spec: KernelSpec = CUBIC):
    """Distribute feedback energy kernel-weighted onto the gas; returns
    the per-gas entropy increments (blackhole_feedback_ngbiter math:
    deltaU = wk m / FeedbackWeightSum * E / m_gas).  Each gas row sums its
    shares over chunks of 256 BHs in order, as the JAX package's scan."""
    nb = bh_ipos.shape[0]
    ng = gas_ipos.shape[0]
    du = torch.zeros(ng, dtype=torch.float32, device=gas_ipos.device)
    rows = max(1, _PAIR_BLOCK // _BH_CHUNK)
    gm_safe = torch.clamp(gas_mass, min=1e-35)
    for c0 in range(0, nb, _BH_CHUNK):
        c = slice(c0, min(c0 + _BH_CHUNK, nb))
        H = bh_hsml[c][None, :]
        be = bh_energy[c][None, :]
        bw = torch.clamp(bh_fw[c], min=1e-35)[None, :]
        for g0 in range(0, ng, rows):
            g = slice(g0, min(g0 + rows, ng))
            w = _kernel_weights(gas_ipos[g][:, None, :],
                                bh_ipos[c][None, :, :], H,
                                gas_alive[g][:, None] & (be > 0), boxsize,
                                spec)
            # energy share: m_gas wk / weightsum * E; as specific energy
            share = w * gas_mass[g][:, None] / bw * be
            du[g] += torch.sum(share, 1) / gm_safe[g]
    # specific energy -> entropy increment
    enttou = (gas_density * a3inv) ** GAMMA_MINUS1 / GAMMA_MINUS1
    return du / torch.clamp(enttou, min=1e-35)


def bh_swallow_gas(key, bh_ipos, bh_hsml, bh_mass_subgrid, bh_mass_dyn,
                   env: BHEnv, gas_ipos, gas_mass, gas_alive, boxsize,
                   spec: KernelSpec = CUBIC, return_margin: bool = False):
    """Stochastic gas swallowing (blackhole.cpp accretion ngbiter).

    When the subgrid mass runs ahead of the dynamic mass, each gas
    neighbour is swallowed with probability
        p_j = (M_subgrid - M_dyn) * wk_j / rho_bh
    so that the expected swallowed mass closes the gap.  The draws are
    `jax.random.uniform(key, (ng, nb))`'s, made a block of gas rows at a
    time with the whole shape's counters.  A gas row goes to the first BH
    that hits, in array order (blackhole.py:230-232 of the JAX package,
    kept in place of the reference's swallow-ID arbitration; ROADMAP C.4).

    Returns (swallowed_by [Ng] int32: BH index or -1, dyn_mass_gain
    [Nb]); with return_margin also min |draw - p| per gas row over the
    pairs inside a kernel (inf elsewhere), which tells how near a hit
    was to an f32 tie.
    """
    nb = bh_ipos.shape[0]
    ng = gas_ipos.shape[0]
    dev = gas_ipos.device
    deficit = torch.clamp(bh_mass_subgrid - bh_mass_dyn, min=0.0)
    rho = torch.clamp(env.density, min=1e-35)
    H = bh_hsml[None, :]
    swallowed_by = torch.full((ng,), -1, dtype=torch.int32, device=dev)
    margin = torch.full((ng,), float("inf"), dtype=torch.float32,
                        device=dev)
    rows = max(1, _PAIR_BLOCK // max(nb, 1))
    for g0 in range(0, ng, rows):
        g1 = min(g0 + rows, ng)
        g = slice(g0, g1)
        w = _kernel_weights(gas_ipos[g][:, None, :], bh_ipos[None, :, :], H,
                            gas_alive[g][:, None]
                            & (gas_mass[g][:, None] > 0), boxsize, spec)
        p = torch.clamp(deficit[None, :] * w / rho[None, :], 0.0, 1.0)
        draw = threefry.uniform(key, (g1 - g0, nb), start=g0 * nb,
                                device=dev)
        hit = (draw < p).to(torch.int32)
        first = torch.argmax(hit, dim=1).to(torch.int32)
        swallowed_by[g] = torch.where(hit.any(dim=1), first, -1)
        if return_margin:
            margin[g] = torch.amin(torch.where(
                w > 0, torch.abs(draw - p), float("inf")), dim=1)
    hit_rows = swallowed_by >= 0
    gain = torch.zeros(nb, dtype=torch.float32, device=dev).index_add_(
        0, torch.clamp(swallowed_by, min=0).long(),
        torch.where(hit_rows, gas_mass, 0.0))
    if return_margin:
        return swallowed_by, gain, margin
    return swallowed_by, gain


def bh_mergers(pos, vel, hsml, mass_subgrid, mass_dyn, ids, atime,
               csnd, boxsize):
    """Host-side BH-BH mergers (blackhole.cpp swallow-BH logic; a copy of
    shenqi_tpu/physics/blackhole.py:238-292, kept as it is: ROADMAP C.4).

    BHs are rare, so an O(Nb^2) numpy pass suffices: BH j is swallowed
    by i when their separation is inside either kernel and the physical
    relative velocity is below the local sound speed (the reference's
    boundness proxy); ties resolve to the smaller ID (which survives).
    Swallow chains are flattened so mass lands on the final survivor.

    Returns (eaten_by [Nb] int: survivor index or -1,
             new_subgrid_mass, new_dyn_mass) as numpy arrays.
    """
    pos = np.asarray(pos, dtype=np.float64)
    vel = np.asarray(vel)
    hsml = np.asarray(hsml)
    msub = np.array(mass_subgrid, dtype=np.float64)
    mdyn = np.array(mass_dyn, dtype=np.float64)
    ids = np.asarray(ids)
    csnd = np.asarray(csnd)
    nb = len(pos)
    eaten_by = np.full(nb, -1, np.int64)
    for j in range(nb):
        best = -1
        for i in range(nb):
            if i == j or ids[i] >= ids[j]:
                continue
            d = pos[i] - pos[j]
            d -= boxsize * np.round(d / boxsize)
            r = np.linalg.norm(d)
            if r > max(hsml[i], hsml[j]):
                continue
            dv = np.linalg.norm(vel[i] - vel[j]) / atime
            if dv > max(csnd[i], csnd[j], 1e-30):
                continue
            if best < 0 or ids[i] < ids[best]:
                best = i
        eaten_by[j] = best
    # flatten chains (a->b->c: a lands on c)
    for j in range(nb):
        k = eaten_by[j]
        seen = set()
        while k >= 0 and eaten_by[k] >= 0 and k not in seen:
            seen.add(k)
            k = eaten_by[k]
        if eaten_by[j] >= 0:
            eaten_by[j] = k
    for j in range(nb):
        k = eaten_by[j]
        if k >= 0:
            msub[k] += msub[j]
            mdyn[k] += mdyn[j]
            msub[j] = 0.0
            mdyn[j] = 0.0
    return eaten_by, msub.astype(np.float32), mdyn.astype(np.float32)


def bh_drag_accel(bh_vel, env_gas_vel, mdot, dyn_mass, bh_mass, atime,
                  par: BHParams):
    """Accretion-momentum drag on the BH (blackhole.cpp:418-429):
    a_BH = (v_gas - v_BH) * Mdot/M.  BH_DRAG 1 scales by Mdot/M_dyn, 2 by
    the Eddington rate over the subgrid mass.  The acceleration is in the
    internal a^2 dx/dt velocity convention: the caller multiplies by the
    BH's dtime."""
    dv_phys = (bh_vel - env_gas_vel) / atime
    if par.BH_DRAG == 2:
        fac = (par.BlackHoleEddingtonFactor * eddington_rate(bh_mass, par)
               / torch.clamp(bh_mass, min=1e-35))
    else:
        fac = mdot / torch.clamp(dyn_mass, min=1e-35)
    return -dv_phys * fac[..., None] * atime


def dynamical_friction(bh_vel, star_dm_density, sigma_1d, bh_mass, atime,
                       G, coulomb_log=4.0):
    """Chandrasekhar dynamical friction (bhdynfric.cpp math).

    a_DF = -4 pi G^2 M_BH rho ln(Lambda)
           [erf(x) - 2x/sqrt(pi) exp(-x^2)] v / |v|^3
    with x = |v| / (sqrt(2) sigma), everything in physical units;
    converted back to the internal a^2 dx/dt velocity convention.
    """
    vphys = bh_vel / atime
    vmag = torch.linalg.norm(vphys, dim=-1)
    sig = torch.clamp(sigma_1d, min=1e-10)
    sqrt2 = float(np.float32(np.sqrt(2.0)))
    sqrtpi = float(np.float32(np.sqrt(np.pi)))
    x = vmag / (sqrt2 * sig)
    fx = torch.special.erf(x) - 2.0 * x / sqrtpi * torch.exp(-x * x)
    rho_phys = star_dm_density / atime ** 3
    amag = (4 * np.pi * G * G * bh_mass * rho_phys
            * coulomb_log * fx / torch.clamp(vmag, min=1e-20) ** 3)
    return -amag[:, None] * vphys * atime


def seed_black_holes(groups, star_mass_by_group, bh_count_by_group,
                     par: BHParams):
    """Host-side FOF seeding decision (blackhole.cpp fof_seed): groups
    above MinFoFMass with enough stellar mass and no BH.  Returns the
    group indices to seed."""
    want = ((groups.masses > par.MinFoFMassForNewSeed)
            & (star_mass_by_group > par.MinMStarForNewSeed)
            & (bh_count_by_group == 0))
    return np.nonzero(want)[0]
