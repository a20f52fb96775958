"""Slab domain decomposition and row exchanges over the ranks
(shenqi_tpu/parallel/domain.py in torch.distributed).

The reference's domain layer (libgadget/domain.cpp toptree segments,
exchange.hpp MPI_Alltoallv migration, treewalk2.h:307-362 ghosts):

  * space is cut into D x-slabs (D a power of two, domain.py:40-44):
    rank d owns the fixed-point x with x >> (32 - log2 D) == d, or,
    with cost-balanced cuts, the x between its two interior cuts
    (slab_index, balance_cuts, cuts_fp_from_planes);
  * `exchange` migrates rows to their owner (domain.py:128), one
    all_to_all with exact split sizes: a rank holds exactly its rows,
    the kept ones in their order, then the arrivals in (source rank,
    source row) order, which is the JAX order whenever its kcap does
    not overflow.  No capacity, no dead rows, nothing unsent;
  * `halo_exchange` ships the rows within `width_fp` of a slab to its
    owner as ghosts (domain.py:249): the multi-hop ppermute ring for
    uniform slabs narrow enough for it, else `_halo_a2a` (domain.py:191)
    with one private bucket per (source, destination) pair;
  * `route_rows` / `route_back` (domain.py:324, 375): the round-trip
    layout exchange of the PM stage on cost-balanced slabs.

Positions are int32 bit patterns of uint32 (core/particles.py); every
unsigned comparison, shift and wrap goes through int64 (`u32`, `lshr`),
so x >= 2^31 lands on the right slab.  A cut array is an int64 tensor
or numpy array of the unsigned values.  Rows are "alive" when their
mass is positive: ghosts carry only those (the hierarchical levels zero
the mass of the rows a level leaves out).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.particles import lshr, u32
from ..ops.morton import morton_key
from . import collectives as cc

_TWO32 = 1 << 32
_MASK = _TWO32 - 1


def _log2(ndev: int) -> int:
    l = int(np.log2(ndev))
    if 2 ** l != ndev:
        raise ValueError(f"device count {ndev} must be a power of two")
    return l


def slab_index(ipos_x, ndev: int, cuts_in=None) -> torch.Tensor:
    """Owner rank (int64) of int32 x bit patterns: the logical shift for
    uniform slabs, a searchsorted rank on the sorted [ndev-1] unsigned
    interior cuts of cost-balanced ones (domain.cpp:620 analog)."""
    if cuts_in is not None:
        cuts = torch.as_tensor(np.asarray(cuts_in, np.int64),
                               device=ipos_x.device)
        return torch.searchsorted(cuts, u32(ipos_x), right=True)
    l = _log2(ndev)
    if l == 0:
        return torch.zeros(ipos_x.shape, dtype=torch.int64,
                           device=ipos_x.device)
    return lshr(ipos_x, 32 - l)


def balance_cuts(plane_costs, ndev: int) -> np.ndarray:
    """Slab boundaries [ndev+1] over x-columns that equalize the summed
    column cost, each slab at least one column (host numpy, a copy of
    domain.py:65-95)."""
    plane_costs = np.asarray(plane_costs, np.float64)
    nplanes = len(plane_costs)
    if nplanes < ndev:
        raise ValueError(f"{nplanes} planes < {ndev} devices")
    cum = np.cumsum(plane_costs)
    total = cum[-1]
    cuts = [0]
    for d in range(1, ndev):
        target = total * d / ndev
        c = int(np.searchsorted(cum, target)) + 1
        c = max(c, cuts[-1] + 1)
        c = min(c, nplanes - (ndev - d))
        cuts.append(c)
    cuts.append(nplanes)
    return np.asarray(cuts, np.int64)


def cuts_fp_from_planes(cut_planes, nplanes: int) -> np.ndarray:
    """Interior fixed-point boundaries [ndev-1] (uint32) from column
    cuts; nplanes must divide 2^32 (domain.py:98-108)."""
    if _TWO32 % nplanes:
        raise ValueError(f"nplanes {nplanes} must divide 2^32")
    step = _TWO32 // nplanes
    inner = np.asarray(cut_planes, np.int64)[1:-1]
    return (inner * step).astype(np.uint32)


def slab_lo(me: int, ndev: int) -> int:
    """First fixed-point x of rank `me`'s uniform slab."""
    l = _log2(ndev)
    return (me << (32 - l)) & _MASK if l else 0


def _alive(fields: dict) -> torch.Tensor:
    return fields["mass"] > 0


def exchange(fields: dict, ndev: int, cuts_in=None):
    """Migrate every row to its owner slab (domain_exchange).  fields: a
    dict of [n, ...] tensors with 'ipos'.  Returns (new fields, info)
    with info = {'sent': rows this rank shipped, 'n_total': rows on
    all ranks} (the second an all-reduced count)."""
    ipos = fields["ipos"]
    dev = ipos.device
    if ndev == 1:
        return fields, {"sent": 0, "n_total": ipos.shape[0]}
    me = cc.rank()
    dest = slab_index(ipos[:, 0], ndev, cuts_in)
    leaving = dest != me
    keep = torch.nonzero(~leaving).squeeze(1)
    lv = torch.nonzero(leaving).squeeze(1)
    order = lv[torch.argsort(dest[lv], stable=True)]
    counts = torch.bincount(dest[lv], minlength=ndev).tolist()
    mat, spec = cc.pack_rows(fields)
    recv, _ = cc.all_to_all_rows(mat[order], counts, tag="exchange")
    new = torch.cat([mat[keep], recv])
    n_total = cc.sum_int(new.shape[0], dev)
    return cc.unpack_rows(new, spec), {"sent": int(lv.numel()),
                                       "n_total": n_total}


def _interval(d: int, ndev: int, cuts_in):
    """(lo, size) of rank d's x interval as unsigned ints; the last
    balanced slab wraps to 2^32."""
    if cuts_in is None:
        l = _log2(ndev)
        return (d << (32 - l)), _TWO32 >> l
    cuts = np.asarray(cuts_in, np.int64)
    lo = int(cuts[d - 1]) if d > 0 else 0
    hi = int(cuts[d]) if d < ndev - 1 else 0
    return lo, (hi - lo) & _MASK or _TWO32


def _halo_a2a(fields: dict, width_fp: int, ndev: int, cuts_in=None):
    """Ship each alive row to EVERY other slab within `width_fp` of it,
    one all_to_all (the arbitrary-rank export of treewalk2.h:307-362;
    domain.py:191-246).  Each (source, destination) pair has its own
    bucket, so a row reaches a slab once however wide the halo.
    Returns the ghosts, grouped by source rank."""
    me = cc.rank()
    x = u32(fields["ipos"][:, 0])
    alive = _alive(fields)
    idx, counts = [], []
    for d in range(ndev):
        if d == me:
            counts.append(0)
            continue
        lo, size = _interval(d, ndev, cuts_in)
        a_off = (x - lo) & _MASK
        inside = a_off < size
        d_below = (-a_off) & _MASK
        d_above = (a_off - (size - 1)) & _MASK
        dist = torch.where(inside, 0, torch.minimum(d_below, d_above))
        sel = torch.nonzero(alive & (dist < width_fp)).squeeze(1)
        idx.append(sel)
        counts.append(int(sel.numel()))
    mat, spec = cc.pack_rows(fields)
    send = mat[torch.cat(idx)] if idx else mat[:0]
    recv, _ = cc.all_to_all_rows(send, counts, tag="halo")
    return cc.unpack_rows(recv, spec)


def halo_exchange(fields: dict, width_fp: int, ndev: int, cuts_in=None):
    """The ghost rows within `width_fp` of this rank's slab
    (domain.py:249-321).  Uniform slabs use the ppermute ring, hop h
    shipping the strip (h-1) to h slabs away from both faces, while
    2 width <= (ndev-1) slab (a wider halo would reach one slab from both
    sides); otherwise, and on cost-balanced slabs, `_halo_a2a`.  With
    one rank there are no ghosts: min-image distances already see every
    row once.  Ghosts are ordered hop by hop, left then right."""
    ipos = fields["ipos"]
    if ndev == 1:
        return {k: v[:0] for k, v in fields.items()}
    l = _log2(ndev)
    slab_fp = _TWO32 >> l
    if cuts_in is not None or 2 * width_fp > (ndev - 1) * slab_fp:
        return _halo_a2a(fields, width_fp, ndev, cuts_in)
    me = cc.rank()
    nhops = int(np.ceil(width_fp / slab_fp))
    off = (u32(ipos[:, 0]) - slab_lo(me, ndev)) & _MASK
    alive = _alive(fields)
    mat, spec = cc.pack_rows(fields)
    parts = []
    for h in range(1, nhops + 1):
        w_lo = min(width_fp - (h - 1) * slab_fp, slab_fp)
        near_lo = torch.nonzero(alive & (off < w_lo)).squeeze(1)
        near_hi = torch.nonzero(alive & (off >= slab_fp - w_lo)).squeeze(1)
        # my low strip goes h slabs left, so my right-side ghosts come
        # from the low strip of the rank h to my right
        from_right = cc.ring_shift(mat[near_lo], -h, tag="halo")
        from_left = cc.ring_shift(mat[near_hi], h, tag="halo")
        parts.extend([from_left, from_right])
    return cc.unpack_rows(torch.cat(parts), spec)


def route_rows(fields: dict, dest, valid, ndev: int):
    """Ship the valid rows whose `dest` is another rank there, for a
    computation whose per-row results come back with route_back (the
    petapm.cpp:79-87 region exchange; domain.py:324-372).  The sender
    keeps its rows.  Returns (received dict, state)."""
    me = cc.rank()
    lv = torch.nonzero(valid & (dest != me)).squeeze(1)
    perm = lv[torch.argsort(dest[lv], stable=True)]
    counts = torch.bincount(dest[perm], minlength=ndev).tolist()
    mat, spec = cc.pack_rows(fields)
    recv, rcounts = cc.all_to_all_rows(mat[perm], counts, tag="route")
    n = next(iter(fields.values())).shape[0]
    return cc.unpack_rows(recv, spec), (perm, counts, rcounts, n)


def route_back(res: torch.Tensor, state) -> torch.Tensor:
    """Per-row results of route_rows' deliveries back to the senders, in
    their row order; rows that were not shipped get zeros
    (domain.py:375-395)."""
    perm, counts, rcounts, n = state
    back, _ = cc.all_to_all_rows(res, rcounts, tag="route")
    out = torch.zeros((n,) + tuple(res.shape[1:]), dtype=res.dtype,
                      device=res.device)
    out[perm] = back
    return out


# ------------------------------------------------------------ host side

def distribute_slabs(fields: dict, ndev: int, me: int, cuts_in=None):
    """Rank `me`'s rows of the global host arrays (domain.py:400-443):
    the rows of its slab, Morton-sorted (the local order the stencil's
    grid and the octree like).  fields: dict of [N, ...] numpy arrays
    with 'ipos' as uint32 or int32 bits.  Returns a dict of numpy
    arrays."""
    ipos = np.asarray(fields["ipos"]).view(np.uint32)
    x = torch.from_numpy(ipos[:, 0].view(np.int32).copy())
    dest = slab_index(x, ndev, cuts_in).numpy()
    rows = np.nonzero(dest == me)[0]
    keys = morton_key(torch.from_numpy(
        ipos[rows].view(np.int32).copy())).numpy()
    rows = rows[np.argsort(keys, kind="stable")]
    return {name: np.asarray(a)[rows] for name, a in fields.items()}


def collect_alive(fields: dict) -> dict:
    """Every rank's alive rows on every rank, in rank order, as host
    numpy (tests and outputs; domain.py:446-450)."""
    alive = _alive(fields)
    out = {}
    for name, a in fields.items():
        rows, _ = cc.all_gather_rows(a[alive])
        out[name] = rows.cpu().numpy()
    return out
