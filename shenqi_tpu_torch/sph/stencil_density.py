"""Grid-stencil SPH density: the direct-P3M neighbour scheme for gas
(shenqi_tpu/sph/stencil_density.py in eager torch).

Density is a gather over the neighbours within H_i
(libgadget/densitytree2.hpp:362-425), so the cell-grid enumeration of
the gravity stencil applies directly:

  * gas sources sort by level-k Morton cell; per cell, the 8 fields a
    density pair needs (ipos xyz, mass, vel xyz, entvar) are
    PAIR-packed into an interleaved [*, 16] int32 table (2 particles
    per 64-byte row; f32 fields as their bits, `.view`);
  * targets pack into cell-anchored sub-blocks of `sub` lanes (bbox
    inside one 2x2x2-cell box by construction);
  * each sub-block keeps the cells within max_i(H_i) of its bbox
    (minimum-image cell geometry) — the radius is PER BLOCK, since
    smoothing lengths are adaptive;
  * kept candidates pack with the boundary-scatter + cummax fill and
    are evaluated in count-sorted tiers with grow-only caps, each batch
    of sub-blocks over its whole source range at once, within the lane
    budget of ops/blockwalk;
  * sub-blocks whose bbox+H outgrows the W^3 window are flagged `cover`
    and left to the caller's all-sources patch.

The pair physics is sph/density._density_accum, the one the walks use.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.particles import POS_SCALE, u32
from ..gravity.stencil import (_cell_morton, _cell_of, _round_tbc,
                               default_tbc, grow_tier_caps)
from ..gravity.shortrange_refined import _next_pow2, tier_bounds
from ..ops.blockwalk import _MAX_LANES
from ..ops.treewalk import pair_dist
from .kernels import KernelSpec, CUBIC
from .density import DensityResult, _density_accum, _zeros_result

_BIG = 2 ** 30


def build_grid_sph(ipos, mass, vel, entvar, k: int):
    """Sort gas by level-k Morton cell; build the pair-packed table.

    Returns (order, ipos_s, cid_s, ptab [PT+1, 16] int32, pmeta [NC, 2]
    int64 = (pstart, pc) per cell in PAIR-row units, n_alive).  Each
    ptab row interleaves 2 particles x 8 fields (ipos xyz | mass | vel
    xyz | entvar) as int32 bits.
    """
    n = ipos.shape[0]
    dev = ipos.device
    NC = 8 ** k
    alive = mass > 0
    cid = torch.where(alive, _cell_of(ipos, k), NC)
    order = torch.argsort(cid, stable=True)
    cid_s = cid[order]
    ipos_s = ipos[order]
    mass_s = torch.where(alive[order], mass[order], 0.0).to(torch.float32)
    vel_s = vel[order].to(torch.float32)
    entv_s = entvar[order].to(torch.float32)

    cstart = torch.searchsorted(
        cid_s, torch.arange(NC + 1, dtype=torch.int64, device=dev))
    n_alive = cstart[NC]
    pcount = torch.diff(torch.cat([cstart, cstart.new_tensor([n])]))[:NC]
    pc = (pcount + 1) >> 1                 # pair rows per cell
    pstart = torch.cumsum(pc, 0) - pc

    # per-particle table slot via boundary fill (group=2): B = 2*pstart
    # - cstart is nondecreasing
    B = 2 * pstart - cstart[:NC]
    dst = torch.where(pcount > 0, cstart[:NC], n)
    bf = torch.zeros(n + 1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, dst, B, reduce="amax", include_self=True)
    bf = torch.cummax(bf[:n], 0).values
    p = torch.arange(n, dtype=torch.int64, device=dev)
    PT = n // 2 + NC + 1
    slot = torch.where(p < n_alive, torch.clamp(bf + p, max=2 * PT - 1),
                       2 * PT)

    rows = torch.cat([ipos_s, mass_s.view(torch.int32)[:, None],
                      vel_s.view(torch.int32),
                      entv_s.view(torch.int32)[:, None]], dim=1)  # [n, 8]
    flat = torch.zeros((2 * PT + 2, 8), dtype=torch.int32, device=dev)
    flat[slot] = rows
    ptab = flat[: 2 * (PT + 1)].reshape(PT + 1, 16)
    ptab[PT] = 0
    pmeta = torch.stack([pstart, pc], dim=1)
    return order, ipos_s, cid_s, ptab, pmeta, n_alive


def _sph_classify(bb_lo, bb_hi, live, pmeta, k: int, box, radius, W: int,
                  CAND: int):
    """Per-block-radius candidate classification (gravity's _classify
    with the radius of each sub-block: its largest target hsml).

    Returns (pst, pcn [nbs, CAND], counts [nbs], cover_ovf [nbs])."""
    dev = bb_lo.device
    S = 1 << k
    cell = box / S
    inv = 1.0 / cell
    r_ = radius[:, None]
    base = torch.floor(bb_lo * inv - r_ * inv).long()
    need = torch.floor(bb_hi * inv + r_ * inv).long() - base + 1
    cover_ovf = live & torch.any(need > W, dim=-1)

    r = torch.arange(W, dtype=torch.int64, device=dev)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       dim=-1).reshape(-1, 3)
    coords = base[:, None, :] + offs[None, :, :]
    lane = torch.all(offs[None, :, :] < need[:, None, :], dim=-1)
    cid = _cell_morton(torch.remainder(coords, S), k)
    pst0 = pmeta[:, 0][cid]
    pcn0 = pmeta[:, 1][cid]

    ccen = (coords.to(torch.float32) + 0.5) * cell
    c = 0.5 * (bb_lo + bb_hi)[:, None, :]
    h = 0.5 * (bb_hi - bb_lo)[:, None, :]
    d = torch.abs(ccen - c)
    dcell = torch.clamp(d - h - 0.5 * cell, min=0.0)
    d2 = torch.sum(dcell * dcell, dim=-1)
    keep = lane & live[:, None] & (pcn0 > 0) & (d2 < r_ * r_)

    skey = torch.where(keep, pst0, _BIG)
    pcn = torch.where(keep, pcn0, 0)
    if CAND > W ** 3:
        pad = CAND - W ** 3
        skey = torch.nn.functional.pad(skey, (0, pad), value=_BIG)
        pcn = torch.nn.functional.pad(pcn, (0, pad))
    skey, perm = torch.sort(skey, dim=1, stable=True)
    pcn = torch.gather(pcn, 1, perm)
    counts = torch.sum(pcn, dim=1)
    pst = torch.where(pcn > 0, skey, 0)
    return pst, pcn, counts, cover_ovf


def target_blocks(tgt_ipos, tvalid_in, k: int, sub: int, T: int, TBC: int,
                  box):
    """Cell-anchored sub-blocks of the valid targets (the assembly both
    SPH stencils share, stencil_density.py:127-156 of the JAX package):
    targets sort by their own level-k cell and split into runs at
    level-(k-1) boundaries, `sub` lanes each.

    Returns (tgt_idx, tgt_valid [TBC, sub], bb_lo, bb_hi [TBC, 3], live
    [TBC], tb_total) with tb_total the true block count (device)."""
    t = tgt_ipos.shape[0]
    dev = tgt_ipos.device
    tcid = _cell_of(tgt_ipos, k)
    lanes = torch.arange(T, dtype=torch.int64, device=dev)
    key = torch.where(tvalid_in, tcid, _BIG)
    torder = torch.argsort(key, stable=True)
    tgt_rows = torder[torch.clamp(lanes, max=t - 1)]
    tvalid = tvalid_in[tgt_rows] & (lanes < t) \
        & (lanes < torch.sum(tvalid_in.long()))

    jcell = torch.where(tvalid, tcid[tgt_rows] >> 3, _BIG)
    prev = torch.cat([jcell.new_tensor([-2]), jcell[:-1]])
    rs = jcell != prev
    run_start = torch.cummax(torch.where(rs, lanes, 0), 0).values
    rank = lanes - run_start
    newblk = (rs | (rank % sub == 0)) & tvalid
    blk = torch.cumsum(newblk.long(), 0) - 1
    tb_total = torch.max(torch.where(tvalid, blk, -1)) + 1
    dst = torch.where(tvalid & (blk < TBC), blk * sub + rank % sub,
                      TBC * sub)
    tgt_idx = torch.zeros(TBC * sub + 1, dtype=torch.int64, device=dev)
    tgt_idx[dst] = tgt_rows
    tgt_idx = tgt_idx[:TBC * sub].reshape(TBC, sub)
    tgt_valid = torch.zeros(TBC * sub + 1, dtype=torch.bool, device=dev)
    tgt_valid[dst] = tvalid
    tgt_valid = tgt_valid[:TBC * sub].reshape(TBC, sub)

    to_f = float(np.float32(box / POS_SCALE))
    tf = u32(tgt_ipos[tgt_idx.reshape(-1)]).to(torch.float32).reshape(
        TBC, sub, 3) * to_f
    BIGF = float(np.float32(3.4e38))
    vv = tgt_valid[..., None]
    bb_lo = torch.amin(torch.where(vv, tf, BIGF), dim=1)
    bb_hi = torch.amax(torch.where(vv, tf, -BIGF), dim=1)
    live = torch.any(tgt_valid, dim=1)
    bb_lo = torch.where(live[:, None], bb_lo, 0.0)
    bb_hi = torch.where(live[:, None], bb_hi, 0.0)
    return tgt_idx, tgt_valid, bb_lo, bb_hi, live, tb_total


def tier_order(counts, cover, nbs: int):
    """(order_s, diag): the sub-blocks by source count with the cover
    ones zeroed, and [each tier's largest count, the count of sub-blocks
    with sources].  The sub-blocks without sources (padding, cover) come
    first in order_s; the JAX package evaluates them with its static
    shapes, the port skips them (their lanes stay zero either way)."""
    counts = torch.where(cover, 0, counts)
    order_s = torch.argsort(counts, stable=True)
    zero = counts.new_zeros(())
    tier_c = [counts[order_s[b - 1]] if b > 0 else zero
              for b in tier_bounds(nbs)]
    return order_s, tier_c + [torch.sum((counts > 0).long())]


def tier_slices(nbs: int, n_busy: int, pcaps):
    """(lo, hi, pcap) of each tier over order_s, less the sub-blocks
    without sources."""
    lo = 0
    first = nbs - n_busy
    for b, pcap in zip(tier_bounds(nbs), pcaps):
        start = max(lo, first)
        if b > start:
            yield start, b, pcap
        lo = b


def _sph_count(grid, tgt_ipos, tgt_hsml, box, k: int, sub: int, W: int,
               CAND: int, T: int, TBC: int):
    """Target sub-block assembly + classification.  Targets are
    independent of the source grid: the subset walks of the hsml loop
    pass a gathered subset.  diag = [c1..c4, n_busy, n_cover, tb_total]
    is read by the caller in one host sync."""
    pmeta = grid[4]
    tgt_idx, tgt_valid, bb_lo, bb_hi, live, tb_total = target_blocks(
        tgt_ipos, tgt_hsml > 0, k, sub, T, TBC, box)
    hb = tgt_hsml[tgt_idx.reshape(-1)].reshape(TBC, sub)
    hblk = torch.amax(torch.where(tgt_valid, hb, 0.0), dim=1)
    pst, pcn, counts, cover = _sph_classify(bb_lo, bb_hi, live, pmeta, k,
                                            box, hblk, W, CAND)
    pcn = torch.where(cover[:, None], 0, pcn)
    order_s, tier_c = tier_order(counts, cover, TBC)
    diag = torch.stack([*tier_c, torch.sum(cover.long()), tb_total])
    return tgt_idx, tgt_valid, pst, pcn, order_s, cover, diag


def pack_rows(s0, sn, cap: int, last: int):
    """The boundary-scatter + cummax fill (stencil_density.py:253-278):
    the candidate runs (start s0, count sn) [bb, CAND] of each sub-block
    laid end to end into `cap` table rows.  Returns (rows [bb, cap],
    valid [bb, cap]); rows past a block's total are `last` (a zero
    row)."""
    bb = s0.shape[0]
    dev = s0.device
    cum = torch.cumsum(sn, 1)
    excl = cum - sn
    total = cum[:, -1]
    v = torch.where(sn > 0, s0 - excl, 0)
    dst = torch.where(sn > 0, torch.clamp(excl, max=cap), cap)
    flat = torch.arange(bb, dtype=torch.int64, device=dev)[:, None] \
        * (cap + 1) + dst
    buf = torch.zeros(bb * (cap + 1), dtype=torch.int64, device=dev)
    buf.scatter_reduce_(0, flat.reshape(-1), v.reshape(-1), reduce="amax",
                        include_self=True)
    vf = torch.cummax(buf.reshape(bb, cap + 1)[:, :cap], 1).values
    p = torch.arange(cap, dtype=torch.int64, device=dev)[None, :]
    valid = p < total[:, None]
    rows = torch.where(valid, torch.clamp(vf + p, max=last - 1), last)
    return rows, valid


def _sph_eval(ptab, tgt_ipos, tgt_vel, tgt_hsml, tgt_idx, tgt_valid, pst,
              pcn, sel, box, spec: KernelSpec, sub: int, pcap: int, out):
    """Packed dense density evaluation of the sub-blocks `sel`, pcap in
    PAIR rows, written into the [t+1] accumulators `out` (row t takes
    the padding lanes).  Batches of sub-blocks hold at most the lane
    budget of pairs and are evaluated over their whole source range."""
    t = tgt_ipos.shape[0]
    PT = ptab.shape[0] - 1
    accum = _density_accum(spec)
    bbs = max(1, _MAX_LANES // (sub * 2 * pcap))
    for lo in range(0, sel.shape[0], bbs):
        sel_b = sel[lo:lo + bbs]
        tidx = tgt_idx[sel_b]                    # [bb, sub]
        tval = tgt_valid[sel_b]
        rows, _ = pack_rows(pst[sel_b], pcn[sel_b], pcap, PT)
        srow = ptab[rows].reshape(rows.shape[0], 1, 2 * pcap, 8)
        sf = srow.view(torch.float32)
        src = {"mass": sf[..., 3], "vel": sf[..., 4:7],
               "entvar": sf[..., 7]}
        dist, r2 = pair_dist(tgt_ipos[tidx][:, :, None, :], srow[..., :3],
                             box)
        del srow, sf
        extra = {"hsml": torch.clamp(tgt_hsml[tidx], min=1e-30),
                 "vel": tgt_vel[tidx]}
        acc = accum(_zeros_result(tidx.shape, tidx.device), extra, src,
                    dist, r2, torch.ones(r2.shape, dtype=torch.bool,
                                         device=r2.device))
        del dist, r2
        dst = torch.where(tval, tidx, t).reshape(-1)
        for o, a in zip(out, acc):
            o[dst] = a.reshape((-1,) + a.shape[2:])


def stencil_density_walk(grid, tgt_ipos, tgt_vel, tgt_hsml, boxsize, k: int,
                         spec: KernelSpec = CUBIC, sub: int = 32, W: int = 7,
                         tier_cache: dict = None):
    """One density evaluation at given smoothing lengths over the
    pair-packed source grid (build_grid_sph's output, fixed across the
    hsml loop).

    Returns (DensityResult, cover [t] bool, n_cover host int):
    cover-marked targets were NOT evaluated (their bbox+H outgrew the
    W^3 window); the caller redoes them against every source.  n_cover
    comes from the same host sync as the cap diagnostics.
    """
    t = tgt_ipos.shape[0]
    dev = tgt_ipos.device
    if tier_cache is None:
        tier_cache = {}
    box = float(boxsize)
    CAND = _next_pow2(W ** 3) if W ** 3 & (W ** 3 - 1) else W ** 3
    T = ((t + sub - 1) // sub) * sub

    # the capacity is kept per power-of-two class of the target count, so
    # that the hsml loop's small subsets do not evaluate the capacity of
    # its full walks (padding only: the sums are the same)
    tbc_key = ("sphst_tbc", k, sub, _next_pow2(T))
    TBC = tier_cache.get(tbc_key, default_tbc(T, sub))
    while True:
        (tgt_idx, tgt_valid, pst, pcn, order_s, cover,
         diag) = _sph_count(grid, tgt_ipos, tgt_hsml, box, k, sub, W, CAND,
                            T, TBC)
        c1, c2, c3, c4, n_busy, n_cover, tb_total = diag.tolist()
        if tb_total <= TBC:
            break
        TBC = _round_tbc(tb_total + 256)
    tier_cache[tbc_key] = TBC

    key = ("sphst", k, sub, W, TBC)
    pcaps = grow_tier_caps((c1, c2, c3, c4),
                           tier_cache.get(key, (0, 0, 0, 0)), 8, 64,
                           align=64)
    tier_cache[key] = pcaps

    out = list(_zeros_result(t + 1, dev))
    for lo, hi, pcap in tier_slices(TBC, n_busy, pcaps):
        sel = torch.sort(order_s[lo:hi]).values
        _sph_eval(grid[3], tgt_ipos, tgt_vel, tgt_hsml, tgt_idx, tgt_valid,
                  pst, pcn, sel, box, spec, sub, pcap, out)
    # cover sub-blocks have no candidates: their lanes are zeros, as the
    # JAX package leaves them
    cover_t = torch.zeros(t + 1, dtype=torch.bool, device=dev)
    cover_t[torch.where(tgt_valid & cover[:, None], tgt_idx, t)] = True
    return (DensityResult(*(o[:t] for o in out)), cover_t[:t],
            int(n_cover))
