"""SPH density and hydro over the slab domain
(shenqi_tpu/parallel/sph_slab.py in torch.distributed).

The reference runs density and hydro distributed (density2.cpp,
hydra2.cpp: treewalk export/import).  Here each rank's gas rows are the
targets, and the sources are its gas rows plus the ghost gas rows of the
other slabs within the ghost strip, which arrive through
domain.halo_exchange; the single-device grid-stencil passes
(sph/stencil_density.py, sph/stencil_hydro.py) then run on
[local + ghosts].  A pair is summed only inside its reach (r < H_i for
density, r < max(H_i, H_j) for hydro), so a strip as wide as the largest
smoothing length of any rank holds every source the single-device pass
would sum for a local target, and each rank's sums equal that pass's up
to f32 summation order.

What the JAX layer does differently, and why:
  * its strip is 3 hmax0 quantized to box/32 and doubled on
    `width_exceeded`, to bound shard_map recompiles; the port has no
    compiles, so the strip is sized from the all-reduced largest hsml (of
    the targets for density, of every gas row for hydro, whose pairs act
    within max(h_i, h_j)) plus 2^16 of slack: exactly that for hydro and
    the fixed point's passes, twice that (at most the bracket ceiling)
    in the density loop, which exchanges again only when an iteration's
    largest hsml outgrows its strip;
  * its cover-overflow targets send the whole pass to the octree walk
    (make_density_pass :70, make_hydro_pass :140, ROADMAP A.10); the
    port redoes them with the single-device cover patches
    (sph/density.cover_patch, stencil_hydro.hydro_cover_patch), on the
    same [local + ghosts] sources;
  * its static caps (maxl, nlv, nb, TBC, pcaps, lcap) and their regrow
    loops are gone: the stencils size per rank at run time, with the
    grow-only caches the single-device passes keep.

Every host decision that a collective depends on reads all-reduced
values, so every rank leaves the loops together: the hsml loop's stop
(the largest count of changed targets over ranks) and so its iteration
count, the strip widths and so the exchanges.  A rank without gas still
joins each exchange and reduction.  The cover patches, tier caps and
long-reach passes are local: no collective runs inside them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sph.density import (DensityResult, HsmlState, density_output,
                           hsml_loop, stencil_level, stencil_walker, MAXITER)
from ..sph.hydro import HydroResult
from ..sph.kernels import KernelSpec, CUBIC, desnumngb
from ..sph.stencil_hydro import hydro_cover_patch, stencil_hydro_walk
from ..utils.constants import GAMMA, GAMMA_MINUS1
from . import collectives as cc
from .domain import halo_exchange

# the hydro sources' columns (make_hydro_pass's ghost_names)
HYDRO_SOURCE = ("ipos", "mass", "vel", "hsml", "density", "eomdensity",
                "entvar", "pressure", "divvel", "curlvel", "dhsml_egy",
                "dloga", "decoupled")


def ghost_width_fp(h: float, boxsize: float) -> int:
    """The ghost strip in fixed point of a pass whose pairs reach at most
    h: h itself plus 2^16 (1.5e-5 of the box) for the f32 rounding of the
    pair distance."""
    return int(np.ceil(float(h) / boxsize * 2 ** 32)) + (1 << 16)


def _amax(x: torch.Tensor) -> torch.Tensor:
    """Largest entry as a float64 scalar tensor, 0 for no entries."""
    if x.numel() == 0:
        return torch.zeros((), dtype=torch.float64, device=x.device)
    return x.max().double()


def _ghost_payload(fields: dict, h: float, boxsize: float, ndev: int,
                   cuts_in):
    """[local + ghosts] of the density source columns, the ghosts those
    within the strip of reach h.  Returns (payload, ghost count)."""
    ghosts = halo_exchange(fields, ghost_width_fp(h, boxsize), ndev,
                           cuts_in)
    return ({k: torch.cat([fields[k], ghosts[k]]) for k in fields},
            int(ghosts["mass"].shape[0]))


def density_slab(fields: dict, hsml0: torch.Tensor, boxsize: float,
                 ndev: int, cuts_in=None, spec: KernelSpec = CUBIC,
                 eta: float = 1.0, ngb_deviation: float = 2.0,
                 do_egy_density: bool = True, maxiter: int = MAXITER,
                 caps: dict = None, k: int = None):
    """The adaptive-hsml density loop of this rank's gas rows
    (sph_slab.py:683-833 do_hsml_loop over the ranks).  fields: ipos,
    mass, vel, entvar of this rank's gas rows (all of them targets and
    sources); hsml0: their starting smoothing lengths.

    The grid level from the global gas count, the bracket ceiling
    min(box/2, max(8 mean separations, 2 hmax0)) from the global count
    and the global largest hsml0, at most `maxiter` update rounds, as the
    single-device density; k: the grid level (from the global gas count
    when None).  The JAX slab loop caps the ceiling at box/4
    (sph_slab.py:714) to keep its halo's recompiles few; a coarse box's
    smoothing lengths can lie above that (2 x 8^3 in 128 Mpc/h: 0.37 of
    the box), where the cap would clamp them.  Returns
    (sph.density.DensityOutput, info) with info the iterations, the ghost
    rows of the last strip, the exchanges, the cover-patched targets and
    the grid level."""
    dev = fields["ipos"].device
    caps = {} if caps is None else caps
    t = fields["ipos"].shape[0]
    n_tot = cc.sum_int(t, dev)
    h0 = float(cc.all_max(_amax(hsml0)))
    sep = boxsize / max(n_tot, 1) ** (1.0 / 3.0)
    hmax_allowed = min(boxsize / 2.0, max(8.0 * sep, 2.0 * h0))
    k = stencil_level(boxsize, n_tot) if k is None else k
    des = float(desnumngb(spec, eta))
    state = HsmlState(hsml=hsml0.to(torch.float32),
                      left=torch.zeros(t, dtype=torch.float32, device=dev),
                      right=torch.full((t,), hmax_allowed,
                                       dtype=torch.float32, device=dev),
                      done=torch.zeros(t, dtype=torch.bool, device=dev))
    strip = {"exchanges": 0, "cover": 0}

    def exchange(h):
        """The strip of reach min(2 h, ceiling): the bisection's growth
        (at most x1.26 an iteration) rarely outgrows it.  One rank has
        no ghosts, whatever the reach."""
        reach = min(2.0 * h, hmax_allowed)
        payload, strip["ghosts"] = _ghost_payload(fields, reach, boxsize,
                                                  ndev, cuts_in)
        strip["h"] = reach if ndev > 1 else np.inf
        strip["walk"] = stencil_walker(payload, boxsize, k, spec, caps,
                                       strip)
        strip["exchanges"] += 1
    exchange(h0)

    def walk(t_ipos, t_vel, hsml):
        return strip["walk"](t_ipos, t_vel, hsml)

    def agree(changed, hsml):
        """Any rank's changed targets, and a wider strip (one more
        exchange) where the largest hsml of any rank outgrew it."""
        v = cc.all_max(torch.stack([changed.sum().double(), _amax(hsml)]))
        nch, hmax = v.tolist()
        if hmax > strip["h"]:
            exchange(hmax)
        return int(nch)

    res, state, niter = hsml_loop(walk, fields["ipos"], fields["vel"],
                                  state, des, ngb_deviation, boxsize,
                                  float(np.float32(hmax_allowed)), maxiter,
                                  agree=agree)
    out = density_output(DensityResult(*res), state.hsml, fields["entvar"],
                         do_egy_density, niter)
    return out, {"niter": niter, "ghosts": strip["ghosts"],
                 "exchanges": strip["exchanges"], "cover": strip["cover"],
                 "level": k}


def density_pass_slab(fields: dict, hsml: torch.Tensor, boxsize: float,
                      ndev: int, cuts_in=None, spec: KernelSpec = CUBIC,
                      k: int = None, caps: dict = None):
    """One density evaluation of this rank's gas rows at fixed hsml
    (sph_slab.py:543-583; the IC entropy fixed point's pass), the strip
    the global largest hsml.  k: the grid level (from the global gas
    count when None).  Returns (DensityResult, ghost rows)."""
    dev = fields["ipos"].device
    if k is None:
        k = stencil_level(boxsize, cc.sum_int(fields["ipos"].shape[0], dev))
    h = float(cc.all_max(_amax(hsml)))
    payload, ng = _ghost_payload(fields, h, boxsize, ndev, cuts_in)
    walk = stencil_walker(payload, boxsize, k, spec,
                          {} if caps is None else caps)
    return DensityResult(*walk(fields["ipos"], fields["vel"], hsml)), ng


def entropy_fixed_point(fields: dict, u0, density, hsml, a3: float,
                        boxsize: float, ndev: int, cuts_in=None,
                        spec: KernelSpec = CUBIC, k: int = None,
                        caps: dict = None, density_independent: bool = True,
                        tol: float = 1e-3, maxiter: int = 100):
    """The IC entropy of this rank's gas rows at fixed hsml (slab_sim.py:
    873-944; setup_density_indep_entropy, init.cpp:403-449): entropy =
    (g-1) u0 / (EgyWtDensity/a^3)^(g-1), EgyWtDensity from a density
    pass with that entropy, from EgyWtDensity = Density, until the
    largest relative change over every rank's gas is below `tol`, then
    one more pass; density-entropy SPH converts once.  fields: ipos and
    mass of the rows; u0, density, hsml: theirs.  Every rank runs the
    same passes, each with its exchange.  Returns (entropy, EgyWtDensity,
    {iterations, converged, maxdiff})."""
    egywt = torch.clamp(density, min=1e-35)
    fields = dict(fields, vel=torch.zeros((density.shape[0], 3),
                                          dtype=torch.float32,
                                          device=density.device))
    stop, diffs = False, []
    for _ in range(maxiter):
        entropy = (GAMMA_MINUS1 * u0 / torch.pow(
            torch.clamp(egywt / a3, min=1e-35), GAMMA_MINUS1))
        if not density_independent:
            break
        entvar = torch.pow(torch.clamp(entropy, min=1e-35), 1.0 / GAMMA)
        res, _ = density_pass_slab(dict(fields, entvar=entvar), hsml,
                                   boxsize, ndev, cuts_in, spec=spec, k=k,
                                   caps=caps)
        new = (torch.clamp(res.egy_rho, min=1e-35)
               / torch.clamp(entvar, min=1e-35))
        if stop:
            egywt = new
            break
        maxdiff = float(cc.all_max(_amax(
            torch.abs(new - egywt) / torch.clamp(new, min=1e-35))))
        diffs.append(maxdiff)
        egywt = new
        if maxdiff < tol:
            stop = True     # one more pass, then stop
    return entropy, torch.clamp(egywt, min=1e-35), {
        "iterations": len(diffs), "converged": stop, "maxdiff": diffs}


def hydro_slab(src: dict, targets: dict, par, tf, boxsize: float,
               ndev: int, cuts_in=None, spec: KernelSpec = CUBIC,
               k: int = None, caps: dict = None, tvalid=None):
    """The hydro force on this rank's gas rows (sph_slab.py:586-680).
    src: HYDRO_SOURCE columns of this rank's gas rows (decoupled rows
    exert no force: their mass folds to 0 in the source table); targets:
    sph/hydro.hydro_walk_dense's target dict of the same rows.  The strip
    is the global largest hsml of the sources.  Returns (HydroResult with
    dt_entropy converted, info: ghost rows, cover targets, long-reach
    sources)."""
    dev = src["ipos"].device
    caps = {} if caps is None else caps
    t = src["ipos"].shape[0]
    if k is None:
        k = stencil_level(boxsize, cc.sum_int(t, dev))
    h = float(cc.all_max(_amax(src["hsml"])))
    ghosts = halo_exchange(src, ghost_width_fp(h, boxsize), ndev, cuts_in)
    comb = {n: torch.cat([src[n], ghosts[n]]) for n in HYDRO_SOURCE}
    info = {"ghosts": int(ghosts["mass"].shape[0]), "cover": 0, "long": 0}
    if t == 0:
        return HydroResult(torch.zeros((0, 3), device=dev),
                           torch.zeros(0, device=dev),
                           torch.zeros(0, device=dev)), info
    mass_src = torch.where(comb["decoupled"], 0.0, comb["mass"])
    v = comb["vel"]
    table = torch.stack(
        [mass_src, comb["hsml"], v[:, 0], v[:, 1], v[:, 2], comb["density"],
         comb["eomdensity"], comb["entvar"], comb["pressure"],
         comb["divvel"], comb["curlvel"], comb["dhsml_egy"], comb["dloga"]],
        dim=1).to(torch.float32)
    hres, cover, n_cover, n_long = stencil_hydro_walk(
        comb["ipos"], table, targets, par, spec=spec, k=k, tier_cache=caps,
        tf=tf, tvalid=tvalid)
    if n_cover:
        cs = torch.nonzero(cover).squeeze(1)
        hs = hydro_cover_patch(
            comb["ipos"], table, {n: x[cs] for n, x in targets.items()},
            par, comb, spec=spec, k=k, tier_cache=caps, tf=tf,
            tvalid=None if tvalid is None else tvalid[cs])
        hres = HydroResult(*(a.index_put((cs,), b)
                             for a, b in zip(hres, hs)))
    info.update(cover=int(n_cover), long=int(n_long))
    return hres, info
