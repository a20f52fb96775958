"""The rare-source subgrid passes over the slab domain
(shenqi_tpu/parallel/subgrid_slab.py in torch.distributed).

The reference runs winds, metal return and black holes through its
distributed treewalk (winds.cpp, metal_return.c, blackhole.cpp over MPI
exports).  As in the JAX package, the sources are FEW (the stars formed
this step, the enriching stars, the black holes) against MANY gas rows
spread over the ranks: the sources are gathered onto every rank in rank
order (`gather_rows`), each rank sums its own gas rows' share of each
source and the per-source sums are all-reduced, and each rank applies
the scatter to its own gas rows.  Per rank the work is O(N/D x S) and
the traffic O(S).

Every random draw is keyed by particle id (physics/winds.idhash_uniform,
the get_random_number(ID) scheme of winds.cpp:542), so the kicks and
swallows do not depend on the rank count or the row layout.

What differs from the JAX layer: its fixed per-device pack `cap` with
the overflow count the caller retries on, and the spawn's search for
dead rows of a fixed capacity, are shape devices of jit; here the packs
have exact counts and a spawned child is appended to its parent's rank
(a child sits at its parent's position, so it belongs to that slab).

The one many-target pass is the DM velocity dispersion around gas or
black holes (veldisp2.cpp; `veldisp_slab`): the single-device blocked
walk of physics/veldisp.py over this rank's DM plus the DM ghosts within
the strip, inside the same adaptive-radius bisection.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.particles import STAR, wrap_i32
from ..ops.tree import MAX_DEEP, build_octree
from ..ops.treewalk import TreeTooShallow
from ..physics.blackhole import _kernel_weights, bh_thermal_feedback
from ..physics.metal_return import metal_return_step
from ..physics.veldisp import _veldisp_walk_blocked
from ..physics.winds import _M32, _mix32, winds_star_feedback
from ..sph.density import HsmlState, update_hsml
from ..sph.kernels import CUBIC, KernelSpec
from . import collectives as cc
from .domain import halo_exchange
from .sph_slab import _amax, ghost_width_fp

# pairs of one block of the dense [gas x source] passes
_PAIR_BLOCK = 1 << 24
# the row columns a spawned child starts at zero (make_spawn_pass's
# zeroed fields, in the port's names)
_CHILD_ZERO = ("last_enrich_myr", "total_returned", "sfr", "delay_time",
               "bh_mass", "bh_mdot", "entropy", "density",
               "egy_wt_density", "dhsml_egy", "div_vel", "curl_vel",
               "dt_entropy", "max_signal_vel", "dt_hsml", "gradrho_mag",
               "hydro_accel")


def _blocks(ng: int, ns: int):
    rows = max(1, _PAIR_BLOCK // max(ns, 1))
    for g0 in range(0, ng, rows):
        yield slice(g0, min(g0 + rows, ng))


# ---------------------------------------------------------------- gather

def gather_rows(fields: dict, mask):
    """Every rank's masked rows on every rank, concatenated in rank order
    (make_gather_pass, subgrid_slab.py:50-96, without its per-device cap):
    one all_gather of the rows packed as one int32 matrix.  fields: a
    dict of [n, ...] tensors.  Returns (dict of [S, ...] tensors, the
    per-rank counts)."""
    sel = torch.nonzero(mask).squeeze(1)
    mat, spec = cc.pack_rows({k: v[sel] for k, v in fields.items()})
    allm, counts = cc.all_gather_rows(mat)
    return cc.unpack_rows(allm, spec), counts


# ---------------------------------------------------------------- spawn

def spawn_stars_slab(rows: dict, spawn, mstar, atime: float):
    """Star children of the masked gas parents (slots_split_particle,
    slotsmanager.cpp:103; make_spawn_pass, subgrid_slab.py:104-206).

    rows: this rank's row columns, every ParticleData field and every
    GasState column at full length under its own name; spawn, mstar:
    [n] mask and star mass.  Each child copies its parent's row, then
    takes the star mass, ptype STAR, the incremented generation, the
    parent's id with that generation in its top 8 bits ((id_hi &
    0x00FFFFFF) + gen << 24), birth_a = atime, mass0 = its mass,
    star_metallicity = the parent's metallicity, and zero in
    _CHILD_ZERO; the parent loses the child's mass and its generation
    rises by one.  The children are appended after this rank's rows: a
    child lies at its parent's position, in its parent's slab.  Returns
    (rows', the number of children over all ranks)."""
    par = torch.nonzero(spawn).squeeze(1)
    n_local = int(par.numel())
    out = dict(rows)
    if n_local:
        ms = mstar[par].to(torch.float32)
        gen_child = rows["generation"][par] + 1
        child = {k: v[par].clone() for k, v in rows.items()}
        child["mass"] = ms
        child["mask"] = torch.ones_like(child["mask"])
        child["ptype"] = torch.full_like(child["ptype"], STAR)
        child["generation"] = gen_child
        child["id_hi"] = wrap_i32(
            (rows["id_hi"][par].long() & 0x00FFFFFF)
            + (gen_child.long() << 24))
        child["birth_a"] = torch.full_like(ms, float(np.float32(atime)))
        child["mass0"] = ms.clone()
        child["star_metallicity"] = rows["metallicity"][par].clone()
        for k in _CHILD_ZERO:
            if k in child:
                child[k] = torch.zeros_like(child[k])
        mass = rows["mass"].clone()
        mass[par] = mass[par] - ms
        gen = rows["generation"].clone()
        gen[par] = gen_child
        out.update(mass=mass, generation=gen)
        out = {k: torch.cat([out[k], child[k]]) for k in out}
    return out, cc.sum_int(n_local, rows["mass"].device)


# ---------------------------------------------------------------- winds

def winds_slab(key, gas: dict, stars: dict, wp, boxsize: float, atime,
               a3inv):
    """The neighbour-kick winds (sfr_wind_feedback, winds.cpp:514-566;
    make_winds_pass, subgrid_slab.py:213-270): the eligible gas mass
    inside each gathered star's hsml summed over ranks, then the id-keyed
    winds_star_feedback on this rank's gas.  gas: this rank's ipos, mass,
    vel, entropy, density, delay, eligible (alive gas that did not just
    form a star), pid (int32 bits of the low id word); stars: the
    gathered ipos, hsml, mass, vdisp, pid.  Returns (vel, entropy,
    delay) of the rank's gas."""
    from ..ops.treewalk import pair_dist
    ns = stars["hsml"].shape[0]
    ng = gas["ipos"].shape[0]
    dev = gas["ipos"].device
    elig = gas["eligible"] & (gas["delay"] <= 0)
    h2 = stars["hsml"][None, :] ** 2
    local_w = torch.zeros(ns, dtype=torch.float32, device=dev)
    for g in _blocks(ng, ns):
        _, r2 = pair_dist(gas["ipos"][g][:, None, :],
                          stars["ipos"][None, :, :], boxsize)
        inside = (r2 < h2) & elig[g][:, None]
        local_w += torch.sum(torch.where(inside, gas["mass"][g][:, None],
                                         0.0), 0)
    tw = cc.all_sum(local_w)
    return winds_star_feedback(
        key, stars["ipos"], stars["hsml"], stars["mass"], stars["vdisp"],
        gas["ipos"], gas["mass"], gas["vel"], gas["entropy"],
        gas["density"], gas["delay"], gas["eligible"], boxsize, atime,
        a3inv, wp, gas_pids=gas["pid"], star_pids=stars["pid"],
        total_weight=tw)


# ---------------------------------------------------------- environment

def source_env_slab(gas: dict, src: dict, boxsize: float,
                    spec: KernelSpec = CUBIC):
    """The kernel-weighted gas environment of gathered sources
    (bh_gas_environment over the ranks; make_source_env_pass,
    subgrid_slab.py:278-326): each rank's sums of m wk, m wk A and
    m wk v over its gas rows, all-reduced as one [S, 5] tensor.  gas:
    this rank's ipos, mass (0 = not gas), entropy, vel; src: ipos, hsml.
    Returns (density, smoothed entropy, smoothed vel, feedback weight),
    the same on every rank."""
    ns = src["hsml"].shape[0]
    ng = gas["ipos"].shape[0]
    dev = gas["ipos"].device
    acc = torch.zeros((ns, 5), dtype=torch.float32, device=dev)
    H = src["hsml"][:, None]
    for g in _blocks(ng, ns):
        gm = gas["mass"][g]
        w = _kernel_weights(src["ipos"][:, None, :],
                            gas["ipos"][g][None, :, :], H,
                            (gm > 0)[None, :], boxsize, spec)
        mw = gm[None, :] * w
        acc[:, 0] += torch.sum(mw, 1)
        acc[:, 1] += torch.sum(mw * gas["entropy"][g][None, :], 1)
        acc[:, 2:] += mw @ gas["vel"][g]
    acc = cc.all_sum(acc)
    dens = acc[:, 0].contiguous()
    dsafe = torch.clamp(dens, min=1e-35)
    return dens, acc[:, 1] / dsafe, acc[:, 2:] / dsafe[:, None], dens.clone()


# ---------------------------------------------------------- metal return

def metal_return_slab(gas: dict, stars: dict, boxsize: float,
                      spec: KernelSpec = CUBIC):
    """The ejecta of the gathered stars scattered onto this rank's gas
    (metal_return.c; make_metal_return_pass, subgrid_slab.py:333-366):
    gas: ipos, mass (0 = not gas); stars: ipos, hsml, mret, zret and fw
    (from source_env_slab, all ranks' gas).  Returns (dmass, dmetalmass)
    of the rank's gas rows; no collective."""
    return metal_return_step(stars["ipos"], stars["hsml"], stars["mret"],
                             stars["zret"], stars["fw"], gas["ipos"],
                             gas["mass"], gas["mass"] > 0, boxsize, spec)


# ---------------------------------------------------------- black holes

def bh_feedback_slab(gas: dict, bh: dict, boxsize: float, a3inv,
                     spec: KernelSpec = CUBIC):
    """The thermal feedback's entropy increments of this rank's gas
    (bh_thermal_feedback over the ranks; make_bh_feedback_pass,
    subgrid_slab.py:375-423): gas: ipos, mass (0 = not gas), density;
    bh: the gathered ipos, hsml, energy, fw.  No collective: the
    weights fw are all-reduced already."""
    return bh_thermal_feedback(bh["ipos"], bh["hsml"], bh["energy"],
                               bh["fw"], gas["ipos"], gas["mass"],
                               torch.clamp(gas["density"], min=1e-35),
                               gas["mass"] > 0, boxsize, a3inv, spec)


def bh_swallow_slab(salt: int, gas: dict, bh: dict, boxsize: float,
                    spec: KernelSpec = CUBIC):
    """Stochastic swallowing (bh_swallow_gas over the ranks;
    make_bh_swallow_pass, subgrid_slab.py:426-482): each gas row inside a
    BH's hsml is swallowed with p = deficit wk / rho_bh, its draw
    idhash_uniform(salt + slot, pid, 3), so any rank count draws alike;
    the first hitting slot of the pack (ordered by 64-bit id) claims the
    row.  gas: this rank's ipos, mass (0 = not gas), pid; bh: the
    gathered ipos, hsml, deficit, rho.  Returns (swallowed_by [n] int32
    slot or -1, dynamic mass gain [S] summed over ranks)."""
    ns = bh["hsml"].shape[0]
    ng = gas["ipos"].shape[0]
    dev = gas["ipos"].device
    swallowed_by = torch.full((ng,), -1, dtype=torch.int32, device=dev)
    gain = torch.zeros(ns, dtype=torch.float32, device=dev)
    H = bh["hsml"][None, :]
    rho = torch.clamp(bh["rho"], min=1e-35)[None, :]
    salts = (int(salt) + torch.arange(ns, device=dev)) & _M32
    pid3 = (gas["pid"].long() + (3 * 0x27D4EB2F & _M32)) & _M32
    for g in _blocks(ng, ns):
        gm = gas["mass"][g]
        w = _kernel_weights(gas["ipos"][g][:, None, :], bh["ipos"][None, :, :],
                            H, (gm > 0)[:, None], boxsize, spec)
        prob = torch.clamp(bh["deficit"][None, :] * w / rho, 0.0, 1.0)
        draw = _mix32(pid3[g][:, None], salts[None, :]).to(
            torch.float32) * float(2.0 ** -32)
        hit = draw < prob
        any_hit = torch.any(hit, 1)
        first = torch.argmax(hit.to(torch.int8), 1)
        swallowed_by[g] = torch.where(any_hit, first, -1).to(torch.int32)
        gain.index_add_(0, first, torch.where(any_hit, gm, 0.0))
    return swallowed_by, cc.all_sum(gain)


# -------------------------------------------------------------- veldisp

def veldisp_slab(fields: dict, radius0, boxsize: float, atime: float,
                 ndev: int, cuts_in=None, nlevels: int = 8, ncrit: int = 32,
                 target_ngb: float = 40.0, maxiter: int = 20):
    """The DM velocity dispersion of this rank's targets over the ranks
    (dm_velocity_dispersion distributed; veldisp_slab, subgrid_slab.py:
    489-645): the adaptive-radius bisection of physics/veldisp.py, each
    iteration the single-device blocked walk over this rank's DM plus the
    DM ghosts within the strip, with the octree one level deeper whenever
    a leaf overflows (C.5's retry, local: it changes no collective).

    fields: this rank's ipos, mass (DM mass, 0 for every other row), vel;
    radius0: [n] starting radii, 0 for rows that are not targets.  The
    bracket is [0, boxsize] as on one device and a radius stops at
    max(8 DM separations, 2 largest radius0) as in the JAX layer.  Every
    decision a collective depends on reads all-reduced values: the strip
    (twice the largest radius of any rank, at most that ceiling; the
    ghosts are exchanged again only when a radius outgrows it) and the
    stop (no rank has an unfinished target).  Returns (sigma_1d, radius,
    rho) [n] (zero for non-targets) and info (iterations, exchanges,
    ghosts, tree levels)."""
    dev = fields["ipos"].device
    n = fields["ipos"].shape[0]
    src = fields["mass"] > 0
    n_src = cc.sum_int(int(src.sum()), dev)
    sep = boxsize / max(n_src, 1) ** (1.0 / 3.0)
    rmax0 = max(float(cc.all_max(_amax(radius0))), sep)
    hmax_allowed = max(8.0 * sep, 2.0 * rmax0)
    tidx = torch.nonzero(radius0 > 0).squeeze(1)
    t = int(tidx.numel())
    tipos = fields["ipos"][tidx]
    local = {k: fields[k][src] for k in ("ipos", "mass", "vel")}
    st = {"reach": 0.0, "tree": None, "nlv": nlevels, "ghosts": 0,
          "exchanges": 0}

    def build():
        comb = st["comb"]
        alive = torch.ones(comb["mass"].shape[0], dtype=torch.bool,
                           device=dev)
        tree = build_octree(comb["ipos"], comb["mass"], alive, boxsize,
                            nlevels=st["nlv"], ncrit=ncrit)
        o = tree.order
        st["tree"] = (tree, {"ipos": tree.ipos_s, "mass": tree.mass_s,
                             "vel": comb["vel"][o], "alive": alive[o]})

    def walk(rad):
        need = float(cc.all_max(_amax(rad)))
        if need > st["reach"]:
            st["reach"] = min(2.0 * need, max(hmax_allowed, need))
            ghosts = halo_exchange(local, ghost_width_fp(st["reach"],
                                                         boxsize),
                                   ndev, cuts_in)
            st["comb"] = {k: torch.cat([local[k], ghosts[k]])
                          for k in local}
            st["ghosts"] = int(ghosts["mass"].shape[0])
            st["exchanges"] += 1
            st["tree"] = None
        z = torch.zeros(t, dtype=torch.float32, device=dev)
        if t == 0 or st["comb"]["mass"].shape[0] == 0:
            return z, z.clone(), torch.zeros((t, 3), device=dev), z.clone()
        while True:
            if st["tree"] is None:
                build()
            tree, payload = st["tree"]
            try:
                return _veldisp_walk_blocked(tree, payload, tipos, rad,
                                             boxsize, ncrit)
            except TreeTooShallow:
                if st["nlv"] >= MAX_DEEP:
                    raise
                st["nlv"] += 1
                st["tree"] = None

    state = HsmlState(
        hsml=radius0[tidx].to(torch.float32),
        left=torch.zeros(t, dtype=torch.float32, device=dev),
        right=torch.full((t,), float(boxsize), dtype=torch.float32,
                         device=dev),
        done=torch.zeros(t, dtype=torch.bool, device=dev))
    it = 0
    for it in range(1, maxiter + 1):
        ngb = walk(state.hsml)[0]
        state = update_hsml(state, ngb, -3.0 * ngb / torch.clamp(
            state.hsml, min=1e-35), ngb, target_ngb, 2.0, boxsize)
        state = state._replace(hsml=torch.clamp(state.hsml,
                                                max=hmax_allowed))
        if cc.sum_int(int((~state.done).sum()), dev) == 0:
            break
    ngb, msum, vsum, v2sum = walk(state.hsml)
    msafe = torch.clamp(msum, min=1e-35)
    vmean = vsum / msafe[:, None]
    var3d = torch.clamp(v2sum / msafe - torch.sum(vmean ** 2, -1), min=0.0)
    vol = 4.0 / 3.0 * np.pi * torch.clamp(state.hsml, min=1e-35) ** 3

    def full(v):
        out = torch.zeros(n, dtype=torch.float32, device=dev)
        out[tidx] = v
        return out

    info = {"iterations": it, "exchanges": st["exchanges"],
            "ghosts": st["ghosts"], "nlevels": st["nlv"]}
    return (full(torch.sqrt(var3d / 3.0) / atime), full(state.hsml),
            full(msum / vol), info)
