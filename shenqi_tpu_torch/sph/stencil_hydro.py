"""Grid-stencil SPH hydro force (shenqi_tpu/sph/stencil_hydro.py in eager
torch; the hydratree2.hpp analog without an octree).

The hydro pair is SYMMETRIC: i and j interact when r < max(H_i, H_j)
(libgadget/hydratree2.hpp pair condition), so the cell enumeration
covers both reaches:

  * the i-side reach (max target H in a sub-block) widens the candidate
    window exactly like the density stencil;
  * the j-side reach is bounded PER CELL: cellh[c] = max hsml of the
    REGULAR sources in cell c — a candidate cell is kept when it lies
    within max(hblk, cellh[c]) of the bbox (the grid analog of the
    octree's node hmax);
  * sources with hsml > hcut = 2 cells ("long-reach": rare void
    particles) cannot be covered by the W^3 window from the j side —
    they are compacted into a flat list and evaluated against ALL
    targets in one dense pass, and EXCLUDED from the stencil pass by
    the H_j <= hcut test (each pair found exactly once);
  * sub-blocks whose own hblk outgrows the window are flagged `cover`
    for the caller's all-sources patch.

Sources pack 16 fields = one 64-byte int32 row per particle (x y z mass
hsml vx vy vz density eomdensity entvar pressure divvel curlvel
dhsml_egy dloga); decoupled sources fold to mass = 0.  The pair physics
is sph/hydro._hydro_accum, the one the walks use.
"""

from __future__ import annotations

import numpy as np
import torch

from ..gravity.stencil import (_cell_morton, _cell_of, _round_tbc,
                               default_tbc, grow_tier_caps)
from ..gravity.shortrange_refined import _next_pow2
from ..ops.blockwalk import _MAX_LANES
from ..ops.treewalk import pair_dist, take
from .kernels import KernelSpec, CUBIC
from .hydro import (HydroResult, _hydro_accum, _hydro_extra, entropy_rate,
                    hydro_walk_dense)
from .stencil_density import (target_blocks, tier_order, tier_slices,
                              pack_rows, _BIG)

def build_grid_hydro(ipos, fields, k: int, hcut):
    """Sort sources by level-k Morton cell; one packed row each.

    fields: [n, 13] f32 = (mass, hsml, vx, vy, vz, density, eomdensity,
    entvar, pressure, divvel, curlvel, dhsml_egy, dloga) with mass
    already zeroed for dead/decoupled rows.

    Returns (stab [n+1, 16] int32, smeta [NC, 2] (start, count), cellh
    [NC] f32 max REGULAR-source hsml, long_rows [n_long, 16] int32 the
    long-reach sources in sorted-row order, n_long host int).  The JAX
    package caps long_rows at a grow-only `lcap`; here it is exact."""
    n = ipos.shape[0]
    dev = ipos.device
    NC = 8 ** k
    mass = fields[:, 0]
    hsml = fields[:, 1]
    alive = mass > 0
    cid = torch.where(alive, _cell_of(ipos, k), NC)
    order = torch.argsort(cid, stable=True)
    cid_s = cid[order]
    f_s = fields[order].to(torch.float32)
    f_s[:, 0] = torch.where(alive[order], f_s[:, 0], 0.0)
    cstart = torch.searchsorted(
        cid_s, torch.arange(NC + 1, dtype=torch.int64, device=dev))
    rows = torch.cat([ipos[order], f_s.view(torch.int32)], dim=1)  # [n, 16]
    stab = torch.zeros((n + 1, 16), dtype=torch.int32, device=dev)
    stab[:n] = rows
    smeta = torch.stack([cstart[:NC], torch.diff(cstart)], dim=1)

    # per-cell j-side reach over REGULAR sources only
    hreg = torch.where((hsml <= hcut) & alive, hsml, 0.0)
    cellh = torch.zeros(NC + 1, dtype=torch.float32, device=dev)
    cellh.scatter_reduce_(0, torch.clamp(cid, max=NC), hreg, reduce="amax",
                          include_self=True)
    is_long_s = ((hsml > hcut) & alive)[order]
    long_rows = rows[is_long_s]
    return stab, smeta, cellh[:NC], long_rows, long_rows.shape[0]


def _unpack_src(srow):
    """[..., 16] int32 rows -> the source dict of _hydro_accum."""
    f = srow[..., 3:].view(torch.float32)
    return {"ipos": srow[..., :3], "mass": f[..., 0], "hsml": f[..., 1],
            "vel": f[..., 2:5], "density": f[..., 5],
            "eomdensity": f[..., 6], "entvar": f[..., 7],
            "pressure": f[..., 8], "divvel": f[..., 9],
            "curlvel": f[..., 10], "dhsml_egy": f[..., 11],
            "dloga": f[..., 12]}


def _hydro_count(tgt_ipos, tgt_hsml, tvalid_in, smeta, cellh, box, hcut,
                 k: int, sub: int, W: int, CAND: int, T: int, TBC: int):
    """Sub-block assembly + symmetric-reach classification."""
    dev = tgt_ipos.device
    tgt_idx, tgt_valid, bb_lo, bb_hi, live, tb_total = target_blocks(
        tgt_ipos, tvalid_in, k, sub, T, TBC, box)
    hb = tgt_hsml[tgt_idx.reshape(-1)].reshape(TBC, sub)
    hblk = torch.amax(torch.where(tgt_valid, hb, 0.0), dim=1)

    # the enumeration radius covers BOTH reaches: the block's own hblk
    # and the j-side bound hcut (cells farther than hcut cannot hold a
    # regular source that reaches the bbox)
    S = 1 << k
    cell = box / S
    inv = 1.0 / cell
    r_enum = torch.clamp(hblk, min=float(np.float32(hcut)))[:, None]
    base = torch.floor(bb_lo * inv - r_enum * inv).long()
    need = torch.floor(bb_hi * inv + r_enum * inv).long() - base + 1
    cover = live & torch.any(need > W, dim=-1)

    r = torch.arange(W, dtype=torch.int64, device=dev)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       dim=-1).reshape(-1, 3)
    coords = base[:, None, :] + offs[None, :, :]
    lane = torch.all(offs[None, :, :] < need[:, None, :], dim=-1)
    cid = _cell_morton(torch.remainder(coords, S), k)
    sst0 = smeta[:, 0][cid]
    scn0 = smeta[:, 1][cid]
    ch = cellh[cid]

    ccen = (coords.to(torch.float32) + 0.5) * cell
    c = 0.5 * (bb_lo + bb_hi)[:, None, :]
    h = 0.5 * (bb_hi - bb_lo)[:, None, :]
    d = torch.abs(ccen - c)
    dcell = torch.clamp(d - h - 0.5 * cell, min=0.0)
    d2 = torch.sum(dcell * dcell, dim=-1)
    reach = torch.maximum(hblk[:, None], ch)
    keep = lane & live[:, None] & (scn0 > 0) & (d2 < reach * reach)

    skey = torch.where(keep, sst0, _BIG)
    scn = torch.where(keep, scn0, 0)
    if CAND > W ** 3:
        pad = CAND - W ** 3
        skey = torch.nn.functional.pad(skey, (0, pad), value=_BIG)
        scn = torch.nn.functional.pad(scn, (0, pad))
    skey, perm = torch.sort(skey, dim=1, stable=True)
    scn = torch.gather(scn, 1, perm)
    counts = torch.sum(scn, dim=1)
    sst = torch.where(scn > 0, skey, 0)
    scn = torch.where(cover[:, None], 0, scn)
    order_s, tier_c = tier_order(counts, cover, TBC)
    diag = torch.stack([*tier_c, torch.sum(cover.long()), tb_total])
    return tgt_idx, tgt_valid, sst, scn, order_s, cover, diag


def _zero_carry(shape, dev):
    return (torch.zeros(shape + (3,), dtype=torch.float32, device=dev),
            torch.zeros(shape, dtype=torch.float32, device=dev),
            torch.zeros(shape, dtype=torch.float32, device=dev))


def _hydro_eval(stab, extra, tgt_ipos, tgt_idx, tgt_valid, sst, scn, sel,
                box, hcut, accum, sub: int, pcap: int, out):
    """Packed dense hydro evaluation of the sub-blocks `sel`, pcap in
    SINGLE source rows, written into the [t+1] outputs `out` (row t
    takes the padding lanes)."""
    t = tgt_ipos.shape[0]
    NT = stab.shape[0] - 1
    hcut32 = float(np.float32(hcut))
    bbs = max(1, _MAX_LANES // (sub * pcap))
    for lo in range(0, sel.shape[0], bbs):
        sel_b = sel[lo:lo + bbs]
        tidx = tgt_idx[sel_b]                    # [bb, sub]
        tval = tgt_valid[sel_b]
        rows, pvalid = pack_rows(sst[sel_b], scn[sel_b], pcap, NT)
        src = _unpack_src(stab[rows][:, None])   # [bb, 1, pcap]
        # the stencil pass excludes long-reach sources (H_j > hcut):
        # the dense long pass takes them, exactly once
        live = (pvalid & (src["hsml"][:, 0] <= hcut32))[:, None, :] \
            & tval[:, :, None]
        dist, r2 = pair_dist(tgt_ipos[tidx][:, :, None, :], src["ipos"],
                             box)
        acc, dts, mv = accum(_zero_carry(tidx.shape, tidx.device),
                             take(extra, tidx), src, dist, r2, live)
        del dist, r2, src, live
        dst = torch.where(tval, tidx, t).reshape(-1)
        out[0][dst] = acc.reshape(-1, 3)
        out[1][dst] = dts.reshape(-1)
        out[2][dst] = mv.reshape(-1)


# rows of a block of the long-reach pass (targets and long sources alike)
_LONG_BLK = 64


def _morton_blocks(ipos, hsml, box):
    """Morton-ordered blocks of _LONG_BLK rows: (rows [nb, B] int64 with
    n for padding, their bbox centres and half-widths [nb, 3] float64 in
    box units, and their largest hsml [nb])."""
    from ..core.particles import POS_SCALE, u32
    from ..ops.morton import morton_key
    n = ipos.shape[0]
    B = _LONG_BLK
    nb = (n + B - 1) // B
    order = torch.argsort(morton_key(ipos), stable=True)
    rows = torch.nn.functional.pad(order, (0, nb * B - n),
                                   value=n).reshape(nb, B)
    valid = rows < n
    rc = torch.clamp(rows, max=n - 1)
    pos = u32(ipos[rc]).double() * (box / POS_SCALE)        # [nb, B, 3]
    big = torch.tensor(np.inf, dtype=torch.float64, device=ipos.device)
    lo = torch.amin(torch.where(valid[..., None], pos, big), 1)
    hi = torch.amax(torch.where(valid[..., None], pos, -big), 1)
    hmax = torch.amax(torch.where(valid, hsml[rc].double(), 0.0), 1)
    return rows, 0.5 * (lo + hi), 0.5 * (hi - lo), hmax


def _hydro_long_eval(long_rows, extra, tgt_ipos, tvalid, box, accum):
    """Every target against the long-reach sources within reach: targets
    and long sources in Morton blocks of _LONG_BLK, a block pair kept
    when the periodic distance of their boxes is below the larger of
    their largest smoothing lengths (the pair cut is r < max(H_i, H_j);
    the box test keeps a margin of 1e-4 of the reach), the kept pairs
    evaluated in batches within the lane budget.  The sums are those of
    every target against every long source, up to their order."""
    t = tgt_ipos.shape[0]
    dev = tgt_ipos.device
    out = _zero_carry((t + 1,), dev)
    src_all = _unpack_src(long_rows)
    trow, tc, th, thm = _morton_blocks(tgt_ipos, extra["hsml"], box)
    lrow, lc, lh, lhm = _morton_blocks(src_all["ipos"], src_all["hsml"],
                                       box)
    nl = long_rows.shape[0]
    d = torch.abs(tc[:, None, :] - lc[None, :, :])
    d = torch.minimum(d, box - d) - th[:, None, :] - lh[None, :, :]
    gap2 = torch.sum(torch.clamp(d, min=0.0) ** 2, -1)
    reach = torch.maximum(thm[:, None], lhm[None, :]) * (1 + 1e-4)
    ti, li = torch.nonzero(gap2 < reach * reach, as_tuple=True)
    B = _LONG_BLK
    chunk = max(1, _MAX_LANES // (B * B))
    for c0 in range(0, ti.shape[0], chunk):
        tr = trow[ti[c0:c0 + chunk]]                      # [k, B]
        lr = lrow[li[c0:c0 + chunk]]
        trc = torch.clamp(tr, max=t - 1)
        src = {name: v[torch.clamp(lr, max=nl - 1)][:, None]
               for name, v in src_all.items()}            # [k, 1, B]
        dist, r2 = pair_dist(tgt_ipos[trc][:, :, None, :], src["ipos"],
                             box)
        live = ((tr < t) & tvalid[trc])[:, :, None] & (lr < nl)[:, None, :]
        acc, dts, mv = accum(_zero_carry(tr.shape, dev), take(extra, trc),
                             src, dist, r2, live)
        del dist, r2
        idx = tr.reshape(-1)
        out[0].index_add_(0, idx, acc.reshape(-1, 3))
        out[1].index_add_(0, idx, dts.reshape(-1))
        out[2].scatter_reduce_(0, idx, mv.reshape(-1), reduce="amax")
    return tuple(o[:t] for o in out)


def stencil_hydro_walk(ipos_src, src_fields, targets, par,
                       spec: KernelSpec = CUBIC, k: int = None,
                       sub: int = 32, W: int = 7, tier_cache: dict = None,
                       tf=None, tvalid=None):
    """Hydro force over the source grid.

    ipos_src [n,3] int32 bits; src_fields [n,13] f32 (build_grid_hydro;
    mass pre-zeroed for dead/decoupled rows).  targets: the dict of
    sph/hydro.hydro_walk_dense.  Returns (HydroResult, cover [t] bool,
    n_cover host int, n_long host int): cover targets must be redone
    against every source.
    """
    t = targets["ipos"].shape[0]
    dev = targets["ipos"].device
    if tier_cache is None:
        tier_cache = {}
    box = float(par.boxsize)
    if k is None:
        n_src = ipos_src.shape[0]
        sep = box / max(n_src, 1) ** (1.0 / 3.0)
        k = int(np.clip(round(np.log2(box / (2.4 * sep))), 1, 10))
    cell = box / (1 << k)
    hcut = 2.0 * cell
    CAND = _next_pow2(W ** 3) if W ** 3 & (W ** 3 - 1) else W ** 3
    T = ((t + sub - 1) // sub) * sub
    accum = _hydro_accum(spec, par)

    stab, smeta, cellh, long_rows, n_long = build_grid_hydro(
        ipos_src, src_fields, k, hcut)

    tvalid_t = (targets["hsml"] > 0) if tvalid is None \
        else (tvalid & (targets["hsml"] > 0))
    # capacity per power-of-two class of the target count (as the
    # density walk's)
    tbc_key = ("hyst_tbc", k, sub, _next_pow2(T))
    TBC = tier_cache.get(tbc_key, default_tbc(T, sub))
    while True:
        (tgt_idx, tgt_valid, sst, scn, order_s, cover,
         diag) = _hydro_count(targets["ipos"], targets["hsml"], tvalid_t,
                              smeta, cellh, box, hcut, k, sub, W, CAND, T,
                              TBC)
        c1, c2, c3, c4, n_busy, n_cover, tb_total = diag.tolist()
        if tb_total <= TBC:
            break
        TBC = _round_tbc(tb_total + 256)
    tier_cache[tbc_key] = TBC

    key = ("hyst", k, sub, W, TBC)
    pcaps = grow_tier_caps((c1, c2, c3, c4),
                           tier_cache.get(key, (0, 0, 0, 0)), 16, 128)
    tier_cache[key] = pcaps

    extra = _hydro_extra(targets, par, tf)
    out = _zero_carry((t + 1,), dev)
    for lo, hi, pcap in tier_slices(TBC, n_busy, pcaps):
        sel = torch.sort(order_s[lo:hi]).values
        _hydro_eval(stab, extra, targets["ipos"], tgt_idx, tgt_valid, sst,
                    scn, sel, box, hcut, accum, sub, pcap, out)
    acc, dts, mv = (o[:t] for o in out)
    if n_long > 0:
        la, ld, lm = _hydro_long_eval(long_rows, extra, targets["ipos"],
                                      tvalid_t, box, accum)
        acc = acc + la
        dts = dts + ld
        mv = torch.maximum(mv, lm)

    cover_t = torch.zeros(t + 1, dtype=torch.bool, device=dev)
    cover_t[torch.where(tgt_valid & cover[:, None], tgt_idx, t)] = True
    return (HydroResult(accel=acc,
                        dt_entropy=entropy_rate(dts, targets["density"],
                                                par, tf),
                        max_signal_vel=mv), cover_t[:t], int(n_cover),
            n_long)


# candidate cells (targets x W^3) per call of the cover patch: bounds its
# [targets, W^3, 3] int64 arrays to 200 MB (sph/density.py's bound)
_COVER_CELLS = 1 << 23


def hydro_cover_patch(ipos_src, src_fields, targets, par, dense_src,
                      spec: KernelSpec = CUBIC, k: int = None,
                      tier_cache: dict = None, tf=None,
                      tvalid=None) -> HydroResult:
    """The targets stencil_hydro_walk flags `cover`, each redone on its
    own stencil: sub-blocks of one target, whose window W =
    floor(2 max(H, hcut) / cell) + 2 holds its reach and the regular
    sources' (the long-reach sources come in as in the walk).  Every pair
    within max(h_i, h_j) is found, so the sums are those of the JAX
    package's patch against every source (oracle_patch,
    simulation_gas.py:513-540) up to the order of summation, which costs
    a pass over all sources per target.  That pass (hydro_walk_dense over
    `dense_src`) remains where the window would hold an eighth of the
    grid or more.  k: the grid level (stencil_hydro_walk's default when
    None)."""
    t = targets["ipos"].shape[0]
    box = float(par.boxsize)
    if k is None:
        sep = box / max(ipos_src.shape[0], 1) ** (1.0 / 3.0)
        k = int(np.clip(round(np.log2(box / (2.4 * sep))), 1, 10))
    cell = box / (1 << k)
    W = int(2 * max(float(targets["hsml"].max()), 2.0 * cell) / cell) + 2
    if 8 * W ** 3 >= 8 ** k:
        return hydro_walk_dense(dense_src, targets, par, spec, tf=tf)
    chunk = max(1, _COVER_CELLS // W ** 3)
    parts = []
    for c0 in range(0, t, chunk):
        sl = slice(c0, min(c0 + chunk, t))
        res, _, nc, _ = stencil_hydro_walk(
            ipos_src, src_fields, {n: v[sl] for n, v in targets.items()},
            par, spec=spec, k=k, sub=1, W=W, tier_cache=tier_cache, tf=tf,
            tvalid=None if tvalid is None else tvalid[sl])
        if nc:
            raise RuntimeError(f"hydro_cover_patch: window {W} too small")
        parts.append(res)
    return HydroResult(*(torch.cat(x) for x in zip(*parts)))
