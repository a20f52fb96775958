"""Grid-stencil short-range gravity: a direct-P3M neighbour scheme
(shenqi_tpu/gravity/stencil.py:58-845 in eager torch).

  * particles sort by level-k Morton cell id; per cell, sources are
    quad-packed into an interleaved [*, 16] int32 table (4 particles of
    (x, y, z, mass bits) per row);
  * targets form cell-anchored sub-blocks of `sub` lanes; each tests
    the fixed W^3 stencil of cells around its bbox with pure
    arithmetic geometry, and keeps the cells within rcut
    (minimum-image, gravshort-tree.c rcut semantics);
  * kept candidates are sorted by table start and packed with the
    boundary-scatter + cummax fill, then evaluated in count-sorted
    tiers with static caps;
  * sub-blocks whose bbox is too wide for the W^3 window fall back to
    per-target stencils (W=5 suffices for a point).

Every pair is evaluated with the exact spline and window by the pair
kernel (ops/p2p.py: CUDA on the card, its plain version on the CPU),
as the JAX package's `engine="pallas"` path does; with the erfc window
(ErfcWindow) the JAX package takes its XLA pair pass with the same
spline and window (stencil.py:296-310 of the JAX package), which the
kernel's erfc instantiation evaluates.  The XLA engine's
capped-Newton/near-cell split and its `mxu` variant are not ported:
the kernel does without them (stencil.py:283-289 of the JAX package),
so the near-cell classification and its caps are not built either.

`stencilgrav` syncs one diagnostic vector per call to grow its
grow-only caps; `stencilgrav_fused` runs with the cached caps and no
host sync and returns a device `ok` flag: False when any tier count
exceeded its cap, a sub-block overflowed the capacity, or the
per-target fallback was needed.  The caller then redoes the call with
`stencilgrav`.  Both share one eager body.

The private `_plain` argument makes the pair pass use the plain version
on any device; only the on-card parity check uses it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.particles import POS_SCALE, lshr, u32
from ..ops.morton import _expand_bits10
from ..ops.p2p import p2p_blocked, p2p_blocked_reference
from .shortrange import ErfcWindow, ShortRangeParams, PolyWindow
from .shortrange_refined import _next_pow2, _round_cap, tier_bounds


def _round_tbc(x):
    """Sub-block capacity rounded to 1k multiples (not pow2): dead
    padding blocks ride tier 0's dense eval, so slack is pure waste."""
    return max((x + 1023) // 1024 * 1024, 1024)


def default_tbc(T: int, sub: int) -> int:
    """Initial sub-block capacity estimate for T padded targets."""
    return _round_tbc(T // sub + max(T // (4 * sub), 64))


def grow_tier_caps(counts, cached, margin, bump, align: int = 128):
    """Grow-only tier caps with drift hysteresis: counts jitter a few
    units per step as particles move.  Sufficiency rule everywhere:
    need = count + 1."""
    caps = []
    hi = 0
    for c, cc in zip(counts, cached):
        need = int(c) + 1
        if need > cc:
            g = _round_cap(need + margin, align=align)
            if cc:
                g = max(g, cc + bump)       # growth event: headroom
        else:
            g = cc
        hi = max(hi, g)
        caps.append(hi)
    return tuple(caps)


def _cell_morton(coords, k: int):
    """Morton cell id (int64) from integer cell coords [..., 3]."""
    cx = _expand_bits10(coords[..., 0])
    cy = _expand_bits10(coords[..., 1])
    cz = _expand_bits10(coords[..., 2])
    return (cx << 2) | (cy << 1) | cz


def _cell_of(ipos, k: int):
    """Level-k Morton cell id (int64) of fixed-point positions [N,3]."""
    return _cell_morton(lshr(ipos, 32 - k), k)


def build_grid(ipos, mass, k: int):
    """Sort by level-k Morton cell; build cell + quad-packed tables.

    Returns (order [n] int64, ipos_s, mass_s, qtab [QT+1,16] int32,
    qmeta [NC, 2] int32 = (qstart, qc) per cell, n_alive [] int64).
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

    cstart = torch.searchsorted(
        cid_s, torch.arange(NC + 1, dtype=torch.int64, device=dev))
    n_alive = cstart[NC]
    pcount = torch.diff(torch.cat([cstart, cstart.new_tensor([n])]))[:NC]
    qc = (pcount + 3) >> 2
    qstart = torch.cumsum(qc, 0) - qc

    # per-particle table slot via boundary fill: B = 4*qstart - cstart
    # scattered at each nonempty cell's first particle, cummax-filled
    # (B is nondecreasing: 4*ceil(pc/4) >= pc)
    B = 4 * qstart - cstart[:NC]
    dst = torch.where(pcount > 0, cstart[:NC], n)
    bf = torch.zeros(n + 1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, dst, B, reduce="amax", include_self=True)
    bf = torch.cummax(bf[:n], 0).values
    p = torch.arange(n, dtype=torch.int64, device=dev)
    QT = n // 4 + NC + 1
    slot = torch.where(p < n_alive, torch.clamp(bf + p, max=4 * QT - 1),
                       4 * QT)

    rows = torch.cat([ipos_s, mass_s.view(torch.int32)[:, None]], dim=1)
    flat = torch.zeros((4 * QT + 4, 4), dtype=torch.int32, device=dev)
    flat[slot] = rows
    qtab = flat[: 4 * (QT + 1)].reshape(QT + 1, 16)
    qtab[QT] = 0
    qmeta = torch.stack([qstart, qc], dim=1).to(torch.int32)
    return order, ipos_s, mass_s, qtab, qmeta, n_alive


def _classify(bb_lo, bb_hi, live, qmeta, k: int, box, rcut, W: int,
              CAND: int):
    """Candidate stencil classification for [nbs] bboxes.

    Candidates are the W^3 cells from floor((bb_lo - rcut)/cell); one is
    kept when its box lies within rcut of the bbox (minimum-image).
    Kept candidates' (qstart, qc) come back SORTED by qstart with
    dropped lanes forced to (0, 0).

    Returns (qst, qcn [nbs, CAND] int64, counts [nbs], cover_ovf [nbs]).
    """
    dev = bb_lo.device
    S = 1 << k
    cell = box / S
    inv = 1.0 / cell
    base = torch.floor(bb_lo * inv - rcut * inv).long()
    need = (torch.floor(bb_hi * inv + rcut * inv).long() - base + 1)
    cover_ovf = live & torch.any(need > W, dim=-1)

    r = torch.arange(W, dtype=torch.int64, device=dev)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       dim=-1).reshape(-1, 3)          # [W^3, 3]
    coords = base[:, None, :] + offs[None, :, :]       # [nbs, W^3, 3]
    lane = torch.all(offs[None, :, :] < need[:, None, :], dim=-1)
    cid = _cell_morton(torch.remainder(coords, S), k)  # [nbs, W^3]
    qst0 = qmeta[:, 0].long()[cid]
    qcn0 = qmeta[:, 1].long()[cid]

    # unwrapped geometry: the window was built around the bbox, so
    # centers are already minimum-image
    ccen = (coords.to(torch.float32) + 0.5) * cell
    c = 0.5 * (bb_lo + bb_hi)[:, None, :]
    h = 0.5 * (bb_hi - bb_lo)[:, None, :]
    d = torch.abs(ccen - c)
    dcell = torch.clamp(d - h - 0.5 * cell, min=0.0)
    d2 = torch.sum(dcell * dcell, dim=-1)
    keep = lane & live[:, None] & (qcn0 > 0) & (d2 <= rcut * rcut)

    BIG = 2 ** 30
    skey = torch.where(keep, qst0, BIG)
    qcn = torch.where(keep, qcn0, 0)
    if CAND > W ** 3:
        pad = CAND - W ** 3
        skey = torch.nn.functional.pad(skey, (0, pad), value=BIG)
        qcn = torch.nn.functional.pad(qcn, (0, pad))
    # equal keys carry equal payloads (BIG/0, or one cell seen twice
    # through the periodic wrap), so any sort order gives one result
    skey, perm = torch.sort(skey, dim=1, stable=True)
    qcn = torch.gather(qcn, 1, perm)
    counts = torch.sum(qcn, dim=1)
    qst = torch.where(qcn > 0, skey, 0)
    return qst, qcn, counts, cover_ovf


def _stencil_count(ipos, mass, active, params: ShortRangeParams, k: int,
                   sub: int, W: int, CAND: int, T: int, compact: bool,
                   TBC: int):
    """Grid build, target compaction, cell-anchored sub-blocks, stencil
    classification and tier order.

    Targets are packed into sub-blocks that split a Morton run whenever
    it crosses a level-(k-1) cell boundary (or fills `sub` lanes), so
    every bbox fits one 2x2x2-cell box and the W=7 window covers it.
    TBC is the sub-block capacity; diag = [c1..c4, n_cover, tb_total]
    (tier max counts, coverage-overflow count, true block count) is a
    device tensor the caller reads once.
    """
    n = ipos.shape[0]
    dev = ipos.device
    order, ipos_s, mass_s, qtab, qmeta, n_alive = build_grid(ipos, mass, k)
    alive_s = mass_s > 0
    lanes = torch.arange(T, dtype=torch.int64, device=dev)
    if compact:
        act_s = active[order] & alive_s
        order2 = torch.argsort(torch.where(act_s, 0, 1).to(torch.int8),
                               stable=True)
        tgt_rows = order2[torch.clamp(lanes, max=n - 1)]
        tvalid = act_s[tgt_rows] & (lanes < n)
    else:
        tgt_rows = torch.clamp(lanes, max=n - 1)
        tvalid = alive_s[tgt_rows] & (lanes < n)

    # ---- cell-anchored sub-block assignment ----
    cid_s = _cell_of(ipos_s, k)
    jcell = torch.where(tvalid, cid_s[tgt_rows] >> 3, 2 ** 30)
    prev = torch.cat([jcell.new_tensor([-2]), jcell[:-1]])
    rs = jcell != prev
    run_start = torch.cummax(torch.where(rs, lanes, 0), 0).values
    rank = lanes - run_start
    newblk = (rs | (rank % sub == 0)) & tvalid
    blk = torch.cumsum(newblk.long(), 0) - 1
    tb_total = torch.max(torch.where(tvalid, blk, -1)) + 1
    lane_in = rank % sub
    dst = torch.where(tvalid & (blk < TBC), blk * sub + lane_in, TBC * sub)
    nbs = TBC
    tgt_idx = torch.zeros(TBC * sub + 1, dtype=torch.int64, device=dev)
    tgt_idx[dst] = tgt_rows
    tgt_idx = tgt_idx[:TBC * sub].reshape(nbs, sub)
    tgt_valid = torch.zeros(TBC * sub + 1, dtype=torch.bool, device=dev)
    tgt_valid[dst] = tvalid
    tgt_valid = tgt_valid[:TBC * sub].reshape(nbs, sub)

    box = params.boxsize
    to_f = float(np.float32(box / POS_SCALE))
    tpos = ipos_s[tgt_idx.reshape(-1)].reshape(nbs, sub, 3)
    tf = u32(tpos).to(torch.float32) * to_f
    BIGF = float(np.float32(3.4e38))
    vv = tgt_valid[..., None]
    bb_lo = torch.amin(torch.where(vv, tf, BIGF), dim=1)
    bb_hi = torch.amax(torch.where(vv, tf, -BIGF), dim=1)
    live = torch.any(tgt_valid, dim=1)
    bb_lo = torch.where(live[:, None], bb_lo, 0.0)
    bb_hi = torch.where(live[:, None], bb_hi, 0.0)

    qst, qcn, counts, cover = _classify(bb_lo, bb_hi, live, qmeta, k, box,
                                        params.rcut, W, CAND)
    # coverage-overflow subs are evaluated per target elsewhere:
    # zero them here so their tier slots cost nothing
    qcn = torch.where(cover[:, None], 0, qcn)
    counts = torch.where(cover, 0, counts)

    order_s = torch.argsort(counts, stable=True)
    zero = counts.new_zeros(())
    tier_c = [counts[order_s[b - 1]] if b > 0 else zero
              for b in tier_bounds(nbs)]
    n_cover = torch.sum(cover.long())
    diag = torch.stack([*tier_c, n_cover, tb_total])
    return (order, ipos_s, qtab, qmeta, tgt_idx, tgt_valid, qst, qcn,
            order_s, cover, diag)


def _cover_units(ipos_s, qmeta, tgt_idx, tgt_valid, cover, params, k: int,
                 PP: int):
    """Expand coverage-overflow sub-blocks into per-target units and
    classify each with its own W=5 stencil (always sufficient for a
    point).  Returns (u_idx [PP,1], u_valid [PP,1], qst/qcn [PP, 128],
    counts [PP], n_units, max count) with the last two on the device."""
    box = params.boxsize
    to_f = float(np.float32(box / POS_SCALE))
    umask = (cover[:, None] & tgt_valid).reshape(-1)
    rows = tgt_idx.reshape(-1)
    ord2 = torch.argsort(torch.where(umask, 0, 1).to(torch.int8),
                         stable=True)[:PP]
    u_idx = rows[ord2][:, None]                       # [PP, 1]
    u_valid = umask[ord2][:, None]
    n_units = torch.sum(umask.long())

    tf = u32(ipos_s[u_idx[:, 0]]).to(torch.float32) * to_f
    lo = torch.where(u_valid, tf, 0.0)
    qst, qcn, counts, _ = _classify(lo, lo, u_valid[:, 0], qmeta, k, box,
                                    params.rcut, 5, 128)
    return u_idx, u_valid, qst, qcn, counts, n_units, torch.max(counts)


def _stencil_eval(ipos_s, qtab, tgt_idx, tgt_valid, qst, qcn, sel,
                  params: ShortRangeParams, window, sub: int,
                  pcap: int, nsel: int, batch: int = 1024,
                  want_pot: bool = False, _plain: bool = False):
    """Packed dense evaluation of the selected stencil sub-blocks.

    tgt_idx [nbs, sub] rows into ipos_s; qst/qcn [nbs, CAND] sorted
    candidate meta; sel [nsel] sub-block ids; pcap in QUAD rows.  The
    pair pass is the kernel (p2p_blocked) over [bbs, sub] targets and
    [bbs, 4*pcap] packed source lanes per batch.
    Returns (acc [nsel, sub, 3], pot [nsel, sub]) * G in sel order.
    """
    dev = ipos_s.device
    box = params.boxsize
    # bound the batch's packed-table footprint: bbs*pcap quad rows
    bbs = min(batch, nsel, max(64, (1 << 22) // max(pcap, 1)))
    while nsel % bbs:
        bbs //= 2
    QT = qtab.shape[0] - 1
    sch = 512
    while (4 * pcap) % sch:
        sch //= 2
    pair = p2p_blocked_reference if _plain else p2p_blocked
    ar = torch.arange(bbs, dtype=torch.int64, device=dev)[:, None]
    p = torch.arange(pcap, dtype=torch.int64, device=dev)[None, :]

    def pack(q0, qn):
        cum = torch.cumsum(qn, 1)
        excl = cum - qn
        total = cum[:, -1]
        v = torch.where(qn > 0, q0 - excl, 0)
        dst = torch.where(qn > 0, torch.clamp(excl, max=pcap), pcap)
        flat = ar * (pcap + 1) + dst
        buf = torch.zeros(bbs * (pcap + 1), dtype=torch.int64, device=dev)
        buf.scatter_reduce_(0, flat.reshape(-1), v.reshape(-1),
                            reduce="amax", include_self=True)
        vf = torch.cummax(buf.reshape(bbs, pcap + 1)[:, :pcap], 1).values
        valid = p < total[:, None]
        pidx = torch.where(valid, torch.clamp(vf + p, max=QT - 1), QT)
        srow = qtab[pidx].reshape(bbs, pcap * 4, 4)
        spos = srow[:, :, :3].contiguous()
        smass = srow[:, :, 3].contiguous().view(torch.float32)
        return spos, smass

    accs, pots = [], []
    for lo in range(0, nsel, bbs):
        sel_b = sel[lo:lo + bbs]
        tval = tgt_valid[sel_b]
        tgt = ipos_s[tgt_idx[sel_b]].contiguous()        # [bbs, sub, 3]
        spos, smass = pack(qst[sel_b], qcn[sel_b])
        acc, pp = pair(tgt, spos, smass, box, params.softening,
                       params.cellsize, window, 1.0, want_pot=want_pot,
                       sch=sch, blk=sub)
        accs.append(torch.where(tval[..., None], acc, 0.0))
        pots.append(torch.where(tval, pp, 0.0) if pp is not None
                    else torch.zeros((bbs, sub), dtype=torch.float32,
                                     device=dev))
    return torch.cat(accs) * params.G, torch.cat(pots) * params.G


def _resolve(n, params, n_targets, sub, k, W, compact):
    """Static (k, CAND, T): level, padded candidate count, padded
    target lanes."""
    if n_targets is None:
        n_targets = n
    if k is None:
        # cell in [rcut/2, rcut): finest power-of-two grid whose
        # stencil halfwidth stays 2
        k = int(np.ceil(np.log2(params.boxsize / params.rcut)))
    k = min(k, 10)
    CAND = _next_pow2(W ** 3) if W ** 3 & (W ** 3 - 1) else W ** 3
    T = min(_next_pow2(max(int(n_targets), sub)), n) if compact else n
    T = ((T + sub - 1) // sub) * sub       # padded lanes (dup n-1)
    return k, CAND, T


def _eval_tiers(cnt, n, params, window, sub, pcaps, want_pot, batch,
                _plain):
    """One packed eval per non-empty tier, scattered into sub-block
    lanes.  Returns (acc_bs [nbs, sub, 3], pot_bs [nbs, sub])."""
    (order, ipos_s, qtab, qmeta, tgt_idx, tgt_valid, qst, qcn, order_s,
     cover, diag) = cnt
    dev = ipos_s.device
    nbs = tgt_idx.shape[0]
    acc_bs = torch.zeros((nbs, sub, 3), dtype=torch.float32, device=dev)
    pot_bs = torch.zeros((nbs, sub), dtype=torch.float32, device=dev)
    lo = 0
    for b, pcap in zip(tier_bounds(nbs), pcaps):
        nsel = b - lo
        if nsel <= 0:
            lo = b
            continue
        sel = torch.sort(order_s[lo:b]).values
        a, pp = _stencil_eval(ipos_s, qtab, tgt_idx, tgt_valid, qst, qcn,
                              sel, params, window, sub, pcap, nsel,
                              batch=batch, want_pot=want_pot,
                              _plain=_plain)
        acc_bs[sel] = a
        pot_bs[sel] = pp
        lo = b
    return acc_bs, pot_bs


def _scatter_back(cnt, n, acc_bs, pot_bs, acc_u=None, pot_u=None):
    """Sub-block lanes -> sorted rows -> original particle order."""
    order, tgt_idx, tgt_valid, cover = cnt[0], cnt[4], cnt[5], cnt[9]
    dev = acc_bs.device
    flat_idx = torch.where(tgt_valid & ~cover[:, None], tgt_idx, n
                           ).reshape(-1)
    acc_sorted = torch.zeros((n + 1, 3), dtype=torch.float32, device=dev)
    acc_sorted[flat_idx] = acc_bs.reshape(-1, 3)
    pot_sorted = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    pot_sorted[flat_idx] = pot_bs.reshape(-1)
    if acc_u is not None:
        acc_sorted = acc_sorted + acc_u
        pot_sorted = pot_sorted + pot_u
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    acc[order] = acc_sorted[:n]
    pot = torch.zeros(n, dtype=torch.float32, device=dev)
    pot[order] = pot_sorted[:n]
    return acc, pot


def _check_window(window):
    if not isinstance(window, (PolyWindow, ErfcWindow)):
        raise TypeError("stencil gravity needs the Chebyshev window "
                        "(window.window_polynomials) or the erfc window "
                        "(ErfcWindow): the pair kernel evaluates no other "
                        "form")


def stencilgrav(ipos, mass, params: ShortRangeParams, window_tables,
                n_targets: int = None, sub: int = 32, k: int = None,
                W: int = 7, active=None, tier_cache: dict = None,
                caps_cache: dict = None, want_pot: bool = False,
                batch: int = 1024, pp_cap: int = 1024,
                _plain: bool = False):
    """Short-range gravity via the grid stencil (module docstring).

    Returns (acc [n,3], pot [n], None) in ORIGINAL particle order, with
    one host sync of the diagnostic vector to grow the cached caps.
    """
    _check_window(window_tables)
    n = ipos.shape[0]
    compact = active is not None
    k, CAND, T = _resolve(n, params, n_targets, sub, k, W, compact)
    if not compact:
        active = None
    if tier_cache is None:
        tier_cache = {}

    tbc_key = ("stencil_tbc", k, sub)
    TBC = tier_cache.get(tbc_key, default_tbc(T, sub))
    while True:
        cnt = _stencil_count(ipos, mass, active, params, k, sub, W, CAND,
                             T, compact, TBC)
        c1, c2, c3, c4, n_cover, tb_total = cnt[-1].tolist()
        if tb_total <= TBC:
            break
        TBC = _round_tbc(tb_total + 256)   # drift headroom
    tier_cache[tbc_key] = TBC

    key = ("stencil", k, sub, W, TBC)
    pcaps = grow_tier_caps((c1, c2, c3, c4),
                           tier_cache.get(key, (0, 0, 0, 0)), 16, 128)
    tier_cache[key] = pcaps
    acc_bs, pot_bs = _eval_tiers(cnt, n, params, window_tables, sub, pcaps,
                                 want_pot, batch, _plain)

    # ---- per-target fallback for coverage-overflow sub-blocks ----
    acc_u = pot_u = None
    if n_cover > 0:
        ipos_s, qmeta, tgt_idx, tgt_valid, cover = (cnt[1], cnt[3], cnt[4],
                                                    cnt[5], cnt[9])
        if caps_cache is not None:
            pp_cap = max(pp_cap, caps_cache.get("pp", 0))
        PP = min(max(_next_pow2(32 * n_cover), pp_cap), T)
        while True:
            (u_idx, u_valid, uqst, uqcn, ucounts, n_units,
             ucmax) = _cover_units(ipos_s, qmeta, tgt_idx, tgt_valid,
                                   cover, params, k, PP)
            if int(n_units) <= PP or PP >= T:
                break
            PP = min(PP * 2, T)
        if caps_cache is not None:
            caps_cache["pp"] = PP
        ucap = max(_round_cap(int(ucmax) + 1),
                   tier_cache.get(key + ("pp",), 0))
        tier_cache[key + ("pp",)] = ucap
        ua, up = _stencil_eval(
            ipos_s, cnt[2], u_idx, u_valid, uqst, uqcn,
            torch.arange(PP, dtype=torch.int64, device=ipos.device),
            params, window_tables, 1, ucap, PP, batch=min(batch * 8, PP),
            want_pot=want_pot, _plain=_plain)
        # scatter per-target results into sorted rows
        flat_u = torch.where(u_valid[:, 0], torch.clamp(u_idx[:, 0],
                                                        max=n - 1), n)
        acc_u = torch.zeros((n + 1, 3), dtype=torch.float32,
                            device=ipos.device)
        acc_u[flat_u] = ua.reshape(PP, 3)
        pot_u = torch.zeros(n + 1, dtype=torch.float32, device=ipos.device)
        pot_u[flat_u] = up.reshape(PP)
    acc, pot = _scatter_back(cnt, n, acc_bs, pot_bs, acc_u, pot_u)
    return acc, pot, None


def stencil_fused_config(n, params: ShortRangeParams, tier_cache,
                         n_targets=None, sub: int = 32, k: int = None,
                         W: int = 7, compact: bool = False):
    """Resolve the static configuration (k, T, CAND, TBC, pcaps) for the
    fused path from a tier_cache seeded by at least one stencilgrav call
    at the same shapes.  Returns None if the cache has no entry yet."""
    k, CAND, T = _resolve(n, params, n_targets, sub, k, W, compact)
    TBC = tier_cache.get(("stencil_tbc", k, sub))
    if TBC is None:
        return None
    pcaps = tier_cache.get(("stencil", k, sub, W, TBC))
    if pcaps is None:
        return None
    return dict(k=k, sub=sub, W=W, CAND=CAND, T=T, compact=compact,
                TBC=TBC, pcaps=pcaps)


def stencilgrav_fused(ipos, mass, params: ShortRangeParams, window_tables,
                      n_targets: int = None, sub: int = 32, k: int = None,
                      W: int = 7, active=None, tier_cache: dict = None,
                      caps_cache: dict = None, want_pot: bool = False,
                      batch: int = 1024, _plain: bool = False):
    """Steady-state stencil gravity with cached caps and no host sync.

    Returns (acc, pot, ok) where ok is a DEVICE bool scalar.  If it is
    False the result must be discarded and the call redone with
    stencilgrav, which grows the caches.  On a cold cache this calls
    stencilgrav directly and returns ok=True.
    """
    _check_window(window_tables)
    if tier_cache is None:
        tier_cache = {}
    n = ipos.shape[0]
    compact = active is not None
    cfg = stencil_fused_config(n, params, tier_cache, n_targets=n_targets,
                               sub=sub, k=k, W=W, compact=compact)
    if cfg is None:
        acc, pot, _ = stencilgrav(
            ipos, mass, params, window_tables, n_targets=n_targets,
            sub=sub, k=k, W=W, active=active, tier_cache=tier_cache,
            caps_cache=caps_cache, want_pot=want_pot, batch=batch,
            _plain=_plain)
        return acc, pot, torch.ones((), dtype=torch.bool, device=ipos.device)
    cnt = _stencil_count(ipos, mass, active, params, cfg["k"], sub, W,
                         cfg["CAND"], cfg["T"], compact, cfg["TBC"])
    diag = cnt[-1]
    pcaps = cfg["pcaps"]
    # same sufficiency rule as grow_tier_caps: need = count + 1
    ok = (diag[5] <= cfg["TBC"]) & (diag[4] == 0)
    for i in range(4):
        ok = ok & (diag[i] + 1 <= pcaps[i])
    acc_bs, pot_bs = _eval_tiers(cnt, n, params, window_tables, sub, pcaps,
                                 want_pot, batch, _plain)
    acc, pot = _scatter_back(cnt, n, acc_bs, pot_bs)
    return acc, pot, ok
