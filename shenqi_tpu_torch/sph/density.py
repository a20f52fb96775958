"""SPH density with adaptive smoothing lengths (shenqi_tpu/sph/density.py
in torch, the density2.cpp analog).

Physics identical to the reference density walk
(libgadget/densitytree2.hpp:362-425):
  per neighbor j within H_i:   u = r/H,  wk, dwk from the spline kernel
    Ngb      += wk * V(H)
    Rho      += m_j wk
    DhsmlRho += m_j dW/dH
    EgyRho   += m_j A_j^{1/gamma} wk        (pressure-entropy SPH)
    DhsmlEgy += m_j A_j^{1/gamma} dW/dH
    Div      += -m_j dwk/r (dist . dv)      (dist: j->i, dv = v_i - v_j)
    Rot      += m_j dwk/r (dv x dist)
    GradRho  += m_j dwk/r dist

and the adaptive-H loop (densitytree2.hpp:177-283 density_check_neighbours)
as a masked fixed point: bisection bounds per particle, geometric-mean
updates, kernel-gradient bracket expansion.  The first walk takes every
target; later ones only the targets whose H changed.

Only the grid-stencil engine (`engine="stencil"`, the JAX package's
default) is ported; the tree engines stay with ROADMAP A.10.  Targets
whose stencil window is too small (`cover`) are redone one target per
sub-block on a window that holds their reach (`cover_patch`); the JAX
package redoes them against every source.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops.blockwalk import auto_block_level
from ..ops.treewalk import run_walk_dense, run_walk_blocked
from .kernels import (KernelSpec, CUBIC, wk as kern_wk, dwk as kern_dwk,
                      volume, desnumngb, NUMDIMS)

MAXITER = 60


class DensityResult(NamedTuple):
    ngb: torch.Tensor          # kernel-weighted neighbor number
    rho: torch.Tensor
    dhsml_rho: torch.Tensor    # sum m dW/dH (raw)
    egy_rho: torch.Tensor
    dhsml_egy: torch.Tensor
    div: torch.Tensor
    rot: torch.Tensor          # [T,3]
    grad_rho: torch.Tensor     # [T,3]


def _zeros_result(shape, device) -> tuple:
    """The eight zero accumulators of targets of `shape` (int or tuple)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)

    def z(*s):
        return torch.zeros(shape + s, dtype=torch.float32, device=device)
    return (z(), z(), z(), z(), z(), z(), z(3), z(3))


def _density_accum(spec: KernelSpec):
    """The density accumulator over a tensor of pairs (ops/treewalk.py
    protocol): targets [...], sources [..., S]."""
    def accumulate(carry, extra, src, dist, r2, live):
        (ngb, rho, dh, egy, dhe, div, rot, grad) = carry
        H = extra["hsml"][..., None]
        vel_i = extra["vel"][..., None, :]
        m = src["mass"]
        inside = live & (r2 < H * H) & (m > 0)
        w = inside.to(torch.float32)
        r = torch.sqrt(r2)
        u = torch.clamp(r / H, max=1.0)
        wkv = kern_wk(spec, u, H)
        dwkv = kern_dwk(spec, u, H)
        dWdH = -(NUMDIMS * wkv / H + u * dwkv)
        ngb = ngb + torch.sum(w * wkv, -1) * volume(H[..., 0])
        wm = w * m
        rho = rho + torch.sum(wm * wkv, -1)
        dh = dh + torch.sum(wm * dWdH, -1)
        # sanitize BEFORE weighting: excluded (dead/non-gas) rows can
        # carry non-finite entvar, and 0 * NaN = NaN
        wme = wm * torch.where(inside, src["entvar"], 0.0)
        egy = egy + torch.sum(wme * wkv, -1)
        dhe = dhe + torch.sum(wme * dWdH, -1)
        del wme, dWdH, wkv
        # velocity derivatives (skip r == 0)
        fac = torch.where(r > 0, m * dwkv / torch.clamp(r, min=1e-30),
                          0.0) * w
        del dwkv, r, u, w, wm
        # sanitize the j-side velocity BEFORE differencing: excluded
        # (dead) rows can carry non-finite predictions
        dv = vel_i - torch.where(inside[..., None], src["vel"], 0.0)
        div = div - torch.sum(fac * torch.sum(dist * dv, -1), -1)
        cx = dv[..., 1] * dist[..., 2] - dv[..., 2] * dist[..., 1]
        cy = dv[..., 2] * dist[..., 0] - dv[..., 0] * dist[..., 2]
        cz = dv[..., 0] * dist[..., 1] - dv[..., 1] * dist[..., 0]
        rot = rot + torch.stack([torch.sum(fac * cx, -1),
                                 torch.sum(fac * cy, -1),
                                 torch.sum(fac * cz, -1)], -1)
        grad = grad + torch.sum(fac[..., None] * dist, -2)
        return (ngb, rho, dh, egy, dhe, div, rot, grad)

    return accumulate


def density_walk_dense(payload, target_ipos, target_vel, hsml, boxsize,
                       spec: KernelSpec = CUBIC) -> DensityResult:
    """One density evaluation against EVERY source (the run_walk_dense
    oracle): the accumulator masks by radius, so the physics is the
    walk's.  Used for the cover targets the stencil engine flags."""
    t = target_ipos.shape[0]
    extra = {"hsml": hsml, "vel": target_vel}
    out = run_walk_dense(payload, target_ipos, extra,
                         _zeros_result(t, target_ipos.device),
                         _density_accum(spec), boxsize)
    return DensityResult(*out)


def density_walk_blocked(tree, payload, target_ipos, target_vel, hsml,
                         boxsize, spec: KernelSpec = CUBIC,
                         ncrit: int = 32, block: int = 64):
    """Blocked-walk density evaluation over the octree (the IC fixed
    point's engine).  payload holds tree-sorted ipos, mass, vel, entvar.
    Returns (DensityResult, info) as ops/treewalk.run_walk_blocked."""
    t = target_ipos.shape[0]
    extra = {"hsml": hsml, "vel": target_vel}
    out, info = run_walk_blocked(
        tree, payload, target_ipos, hsml, extra,
        _zeros_result(t, target_ipos.device), _density_accum(spec),
        boxsize, block=block, ncrit=ncrit,
        level=auto_block_level(t, block))
    return DensityResult(*out), info


# candidate cells (targets x W^3) per stencil call of the cover patch:
# bounds its [targets, W^3, 3] int64 arrays to 200 MB
_COVER_CELLS = 1 << 23


def cover_patch(grid, payload, t_ipos, t_vel, hsml, boxsize, k: int,
                spec: KernelSpec, caps: dict) -> DensityResult:
    """The targets the stencil flags `cover` (their sub-block's bbox + H
    outgrew the W^3 window), each redone on its own stencil: sub-blocks
    of one target, whose window W = floor(2 max H / cell) + 2 holds its
    whole reach.  Every neighbour within H is found, so the sums are
    those of the JAX package's patch against every source
    (_oracle_patch, density.py:285), which costs a pass over all sources
    per target.  That pass remains where the window would hold an eighth
    of the grid or more (a reach of a quarter box: the hmax ceiling of a
    small subset of targets allows it)."""
    from .stencil_density import stencil_density_walk
    n = t_ipos.shape[0]
    cell = boxsize / (1 << k)
    W = int(2 * float(hsml.max()) / cell) + 2
    if 8 * W ** 3 >= 8 ** k:
        return density_walk_dense(payload, t_ipos, t_vel, hsml, boxsize,
                                  spec)
    out = list(_zeros_result(n, t_ipos.device))
    chunk = max(1, _COVER_CELLS // W ** 3)
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(c0 + chunk, n))
        res, cover, nc = stencil_density_walk(
            grid, t_ipos[sl], t_vel[sl], hsml[sl], boxsize, k, spec=spec,
            sub=1, W=W, tier_cache=caps)
        if nc:
            raise RuntimeError(f"cover_patch: window {W} too small")
        for o, r in zip(out, res):
            o[sl] = r
    return DensityResult(*out)


class HsmlState(NamedTuple):
    hsml: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor
    done: torch.Tensor


def _cbrt(x):
    """f32 cube root, rounded from float64 (torch has no cbrt)."""
    return torch.pow(x.double(), 1.0 / 3.0).to(torch.float32)


def update_hsml(state: HsmlState, ngb, dhsml_rho, rho, des_numngb,
                ngb_deviation, boxsize) -> HsmlState:
    """Vectorized density_check_neighbours (densitytree2.hpp:196-283)."""
    hsml, left, right, done = state
    out_of_range = (ngb < des_numngb - ngb_deviation) | \
                   (ngb > des_numngb + ngb_deviation)
    need_update = out_of_range & (~done)

    # degenerate bracket: accept Right
    tight = (right - left) < 1e-5 * right
    hsml_tight = right

    left_n = torch.where(need_update & (ngb < des_numngb), hsml, left)
    right_n = torch.where(need_update & (ngb >= des_numngb), hsml, right)

    # geometric-mean bisection when bracketed
    bracketed = (right_n < boxsize) & (left_n > 0)
    hsml_bis = _cbrt(0.5 * (left_n * left_n * left_n
                            + right_n * right_n * right_n))

    # kernel-gradient guess when not bracketed
    densfac_raw = dhsml_rho * hsml / (NUMDIMS * torch.clamp(rho, min=1e-35))
    densfac = 1.0 / (1.0 + densfac_raw)
    fac = torch.where(ngb > 0,
                      1.0 - (ngb - des_numngb)
                      / (NUMDIMS * torch.clamp(ngb, min=1e-35)) * densfac,
                      1.26)
    fac = torch.where((right_n > 0.99 * boxsize) & (left_n > 0)
                      & ((densfac <= 0)
                         | (torch.abs(ngb - des_numngb)
                            >= 0.5 * des_numngb)
                         | (fac > 1.26)),
                      1.26, fac)
    fac = torch.where((right_n < 0.99 * boxsize) & (left_n == 0)
                      & ((densfac <= 0) | (fac < 1.0 / 3)),
                      1.0 / 3, fac)
    hsml_grow = hsml * fac

    hsml_new = torch.where(bracketed | (hsml * 1.26 > 0.99 * boxsize),
                           hsml_bis, hsml_grow)
    hsml_new = torch.where(tight, hsml_tight, hsml_new)
    hsml_out = torch.where(need_update & (~tight), hsml_new,
                           torch.where(need_update & tight, hsml_tight,
                                       hsml))
    done_out = done | (~out_of_range) | tight
    return HsmlState(hsml=hsml_out, left=left_n, right=right_n,
                     done=done_out)


@dataclass
class DensityOutput:
    hsml: torch.Tensor
    numngb: torch.Tensor
    density: torch.Tensor
    dhsml_density_factor: torch.Tensor
    egy_wt_density: torch.Tensor
    dhsml_egy_density_factor: torch.Tensor
    div_vel: torch.Tensor
    curl_vel: torch.Tensor
    grad_rho: torch.Tensor
    dt_hsml: torch.Tensor
    niter: int
    # targets whose bisection hit the hmax_allowed bracket ceiling
    n_hmax_capped: int = 0


def stencil_walker(payload, boxsize, k: int, spec: KernelSpec, caps: dict,
                   stats: dict = None):
    """walk(t_ipos, t_vel, hsml) -> the eight density sums (a list) of
    the given targets over the pair-packed grid of `payload`, with the
    targets the stencil flags `cover` redone by cover_patch (counted in
    stats["cover"] when stats is given)."""
    from .stencil_density import build_grid_sph, stencil_density_walk
    grid = build_grid_sph(payload["ipos"], payload["mass"], payload["vel"],
                          payload["entvar"], k)

    def walk(t_ipos, t_vel, hsml):
        if t_ipos.shape[0] == 0:
            return list(_zeros_result(0, t_ipos.device))
        res, cover, nc = stencil_density_walk(
            grid, t_ipos, t_vel, hsml, boxsize, k, spec=spec,
            tier_cache=caps)
        res = list(res)
        if nc:
            sel = torch.nonzero(cover).squeeze(1)
            if stats is not None:
                stats["cover"] = stats.get("cover", 0) + sel.shape[0]
            sub = cover_patch(grid, payload, t_ipos[sel], t_vel[sel],
                              hsml[sel], boxsize, k, spec, caps)
            for j in range(len(res)):
                res[j] = res[j].index_put((sel,), sub[j])
        return res
    return walk


def stencil_level(boxsize: float, n_src: int) -> int:
    """The SPH grid level of n_src sources: cells of ~2.4 mean
    separations."""
    sep_src = boxsize / max(n_src, 1) ** (1.0 / 3.0)
    return int(np.clip(round(np.log2(boxsize / (2.4 * sep_src))), 1, 10))


def hsml_loop(walk, target_ipos, target_vel, state: HsmlState, des,
              ngb_deviation, boxsize, hmax32, maxiter: int = MAXITER,
              agree=None):
    """The adaptive-H iterations (do_hsml_loop): the first walk takes
    every target, later ones only the targets whose H changed (the
    reference re-queues only unconverged particles); each target's
    stored result is always that of its latest H, so no final full walk
    is needed.  agree(changed, hsml) -> int, when given, replaces the
    local count of changed targets in the stop test (the slab run's
    all-reduced decision, parallel/sph_slab.py).  Returns (the eight
    sums, the final state, iterations)."""
    t = target_ipos.shape[0]
    res = walk(target_ipos, target_vel, state.hsml)
    it = 0
    for it in range(maxiter):
        hsml_prev = state.hsml
        state = update_hsml(state, res[0], res[2], res[1], des,
                            ngb_deviation, boxsize)
        state = state._replace(hsml=torch.clamp(state.hsml, max=hmax32))
        changed = state.hsml != hsml_prev
        nch = int(changed.sum())
        if (nch if agree is None else agree(changed, state.hsml)) == 0:
            break
        if nch == 0:
            continue
        if nch > t // 2:
            res = walk(target_ipos, target_vel, state.hsml)
            continue
        sel = torch.nonzero(changed).squeeze(1)
        sub = walk(target_ipos[sel], target_vel[sel], state.hsml[sel])
        for k in range(len(res)):
            res[k] = res[k].index_put((sel,), sub[k])
    return res, state, it + 1


def density_output(res: DensityResult, hsml, target_entvar,
                   do_egy_density: bool, niter: int,
                   n_capped: int = 0) -> "DensityOutput":
    """The derived density fields of the sums at the final H
    (density.py:380-410 of the JAX package)."""
    rho = torch.clamp(res.rho, min=1e-35)
    dhsml_fac = res.dhsml_rho * hsml / (NUMDIMS * rho)
    dhsml_fac = 1.0 / (1.0 + dhsml_fac)
    div_vel = res.div / rho
    curl_vel = torch.linalg.norm(res.rot, dim=-1) / rho
    dt_hsml = (1.0 / NUMDIMS) * div_vel * hsml

    if do_egy_density:
        egy_rho = torch.clamp(res.egy_rho, min=1e-35)
        dhsml_egy = res.dhsml_egy * hsml / (NUMDIMS * egy_rho)
        dhsml_egy = -dhsml_egy * dhsml_fac
        egy_wt_density = egy_rho / torch.clamp(target_entvar, min=1e-35)
    else:
        dhsml_egy = dhsml_fac
        egy_wt_density = rho
    return DensityOutput(
        hsml=hsml, numngb=res.ngb, density=res.rho,
        dhsml_density_factor=dhsml_fac, egy_wt_density=egy_wt_density,
        dhsml_egy_density_factor=dhsml_egy, div_vel=div_vel,
        curl_vel=curl_vel, grad_rho=res.grad_rho, dt_hsml=dt_hsml,
        niter=niter, n_hmax_capped=n_capped)


def density(payload, target_ipos, target_vel, target_entvar, hsml0,
            boxsize, spec: KernelSpec = CUBIC, eta: float = 1.0,
            ngb_deviation: float = 2.0, do_egy_density: bool = True,
            maxiter: int = MAXITER, caps: dict = None) -> DensityOutput:
    """Full adaptive-H density loop (do_hsml_loop analog, host-driven)
    on the grid-stencil engine (density.py:242 of the JAX package with
    engine="stencil").

    payload: source ipos, mass, vel, entvar (A^{1/gamma} predictions;
    ones when not using pressure-entropy SPH), in any row order.
    hsml0: the targets' starting smoothing lengths (a tensor).
    """
    des = float(desnumngb(spec, eta))
    t = target_ipos.shape[0]
    dev = target_ipos.device
    # bracket ceiling: physical smoothing lengths sit at a few mean
    # separations; with right = boxsize a void particle's probe would
    # cover the box
    sep = boxsize / max(t, 1) ** (1.0 / 3.0)
    hmax_allowed = min(boxsize / 2.0,
                       max(8.0 * sep, 2.0 * float(hsml0.max())))
    state = HsmlState(hsml=hsml0.to(torch.float32),
                      left=torch.zeros(t, dtype=torch.float32, device=dev),
                      right=torch.full((t,), hmax_allowed,
                                       dtype=torch.float32, device=dev),
                      done=torch.zeros(t, dtype=torch.bool, device=dev))
    if caps is None:
        caps = {}
    walk = stencil_walker(payload, boxsize,
                          stencil_level(boxsize, payload["ipos"].shape[0]),
                          spec, caps)
    hmax32 = float(np.float32(hmax_allowed))
    res, state, niter = hsml_loop(walk, target_ipos, target_vel, state, des,
                                  ngb_deviation, boxsize, hmax32, maxiter)
    hsml = state.hsml
    n_capped = int(torch.sum(
        hsml >= float(np.float32(hmax32) * np.float32(0.999))))
    if n_capped:
        print(f"density: {n_capped} targets at the hmax bracket "
              f"ceiling {hmax_allowed:g} (may be under-neighboured)")
    return density_output(DensityResult(*res), hsml, target_entvar,
                          do_egy_density, niter, n_capped)


def make_gas_payload(tree, vel, entvar):
    """Sort per-particle gas fields into tree order for the walk."""
    order = tree.order
    return {"ipos": tree.ipos_s, "mass": tree.mass_s, "vel": vel[order],
            "entvar": entvar[order]}
