"""Local DM velocity dispersion around gas (veldisp2.cpp analog;
shenqi_tpu/physics/veldisp.py in torch, `engine="blocked"`).

Computes the 1-D dark-matter velocity dispersion within an adaptive
radius around each gas particle, used by the sigma-dependent wind
models (OFJT10/VS08): the wind speed is WindSpeedFactor * sigma_DM and
the mass loading sigma0^2/sigma^2.

The radius is iterated until it encloses the target weighted neighbour
number (vdispeffdmradius, veldisp2.cpp:216) by the hsml bisection of
sph/density.update_hsml, each iteration a kernel-weighted blocked walk
over the DM octree (ops/treewalk.run_walk_blocked) that accumulates
sum(m), sum(m v), sum(m v^2).  A walk that meets a leaf with more than
ncrit rows rebuilds the tree one level deeper and starts again, up to
20 levels, as the JAX package's does.  Its per-particle `engine="walk"`
(run_walk) is ROADMAP A.10.  Run once per PM step (run.cpp:662-663).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.tree import MAX_DEEP, build_octree
from ..ops.treewalk import TreeTooShallow, run_walk_blocked
from ..sph.kernels import CUBIC, wk as kern_wk, volume
from ..sph.density import HsmlState, update_hsml


def _veldisp_accum(carry, extra, src, dist, r2, live):
    ngb, msum, vsum, v2sum = carry
    H = extra["radius"][..., None]
    inside = live & (r2 < H * H) & src["alive"]
    w = inside.to(torch.float32)
    Hs = torch.clamp(H, min=1e-35)
    u = torch.clamp(torch.sqrt(r2) / Hs, max=1.0)
    wk = kern_wk(CUBIC, u, Hs)
    m = src["mass"]
    wm = w * m
    vel = src["vel"]
    ngb = ngb + torch.sum(w * wk, -1) * volume(H[..., 0])
    msum = msum + torch.sum(wm, -1)
    vsum = vsum + torch.sum(wm[..., None] * vel, -2)
    v2sum = v2sum + torch.sum(wm * torch.sum(vel ** 2, -1), -1)
    return ngb, msum, vsum, v2sum


def _veldisp_walk_blocked(tree, payload, target_ipos, radius, boxsize,
                          ncrit):
    t = target_ipos.shape[0]
    dev = target_ipos.device

    def z(*s):
        return torch.zeros((t,) + s, dtype=torch.float32, device=dev)

    out, info = run_walk_blocked(
        tree, payload, target_ipos, radius, {"radius": radius},
        (z(), z(), z(3), z()), _veldisp_accum, boxsize, ncrit=ncrit,
        level=4)
    if bool(info["leaf_truncated"]):
        raise TreeTooShallow("veldisp: leaf > ncrit")
    return out


def dm_velocity_dispersion(dm_ipos, dm_vel, dm_mass, dm_alive,
                           gas_ipos, radius0, boxsize, atime,
                           nlevels=6, ncrit=32, target_ngb=40.0,
                           maxiter=20):
    """1-D physical velocity dispersion of DM around each gas target.

    radius0: initial search radii (e.g. 2x gas hsml), f32 tensor.
    Returns (sigma_1d [T] physical internal units, radius [T],
    density [T] comoving mean DM density inside the radius).
    """
    t = gas_ipos.shape[0]
    dev = gas_ipos.device
    while True:
        tree = build_octree(dm_ipos, dm_mass, dm_alive, boxsize,
                            nlevels=nlevels, ncrit=ncrit)
        order = tree.order
        payload = {"ipos": tree.ipos_s, "mass": tree.mass_s,
                   "vel": dm_vel[order], "alive": dm_alive[order]}
        state = HsmlState(
            hsml=radius0.to(torch.float32),
            left=torch.zeros(t, dtype=torch.float32, device=dev),
            right=torch.full((t,), float(boxsize), dtype=torch.float32,
                             device=dev),
            done=torch.zeros(t, dtype=torch.bool, device=dev))
        try:
            for _ in range(maxiter):
                out = _veldisp_walk_blocked(tree, payload, gas_ipos,
                                            state.hsml, boxsize, ncrit)
                ngb = out[0]
                # density bisection with a rough dNgb/dR (3 Ngb/R)
                state = update_hsml(
                    state, ngb, -3.0 * ngb / torch.clamp(
                        state.hsml, min=1e-35), ngb, target_ngb, 2.0,
                    boxsize)
                if bool(torch.all(state.done)):
                    break
            out = _veldisp_walk_blocked(tree, payload, gas_ipos,
                                        state.hsml, boxsize, ncrit)
            break
        except TreeTooShallow:
            # past level 10 the tree takes two-word keys
            # (shenqi_tpu/physics/veldisp.py:135-138 retries to 20)
            if nlevels >= MAX_DEEP:
                raise
            nlevels += 1
    ngb, msum, vsum, v2sum = out
    msafe = torch.clamp(msum, min=1e-35)
    vmean = vsum / msafe[:, None]
    v2mean = v2sum / msafe
    var3d = torch.clamp(v2mean - torch.sum(vmean ** 2, -1), min=0.0)
    # internal velocity v = a^2 dx/dt; peculiar v_pec = v/a
    sigma_1d = torch.sqrt(var3d / 3.0) / atime
    vol = 4.0 / 3.0 * np.pi * torch.clamp(state.hsml, min=1e-35) ** 3
    return sigma_1d, state.hsml, msum / vol
