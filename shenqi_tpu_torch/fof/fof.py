"""Friends-of-friends halo finder (shenqi_tpu/fof/fof.py in torch, the
fof.cpp analog), with the JAX package's production engine, "blocked".

Same definition as the reference (libgadget/fof.cpp): particles within
b = FOFHaloLinkingLength * mean-DM-separation of each other belong to
the same group (primary linking over DM/star types); gas/BH attach to
the group of their nearest primary particle (secondary linking); groups
shorter than FOFHaloMinLength are dropped; group numbers are assigned
by descending length.

The union-find is the JAX package's fixpoint iteration
  label_i <- min(label_i, label_j : r_ij < b)   (neighbours)
  label   <- label[label]  (x 3)                (pointer jumping)
over labels that are particle indices.  The neighbour pairs come from
one blocked traversal (ops/blockwalk.py) and one pass over each block's
sources; that pass records the pairs within b, a pair that links both
ways once, so every iteration after it is a gather and a scatter-min in
both directions over those pairs rather than a new pass over all pair
lanes.  Where the pairs would exceed _MAX_LINKS, every iteration runs
the pass again instead.  The labels are the same either way: the
minimum over a block's list does not depend on its order or on how the
blocks are batched.

Labels are uint32 in the JAX package with 0xFFFFFFFF as "none"
(fof.py:38,115,139); torch has no uint32 min or compare, so they are
int64 here with the same values and the same sentinel.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.tree import Octree, build_octree
from ..ops.blockwalk import (make_blocks_from_tree, block_traverse_bfs,
                             block_sources)
from ..ops.morton import morton_key
from ..core.particles import POS_SCALE, u32

NO_LABEL = 0xFFFFFFFF
_BLOCK = 128
_NCRIT = 32
# the pairs within b are kept while there are at most this many (two
# int32 rows each: 256 MB); past it, every iteration runs the pair pass
# again, the JAX package's form, in the memory of one batch
_MAX_LINKS = 1 << 25
# link rows per scatter-min, so that its int64 indices take 32 MB
_LINK_CHUNK = 1 << 22


def _r2(spos, tpos, to_f):
    """Squared minimum-image distance in f32 of sources [bb, 1, S, 3]
    and targets [bb, blk, 1, 3], computed as fof.py:122-124 computes
    it: the wrapped int32 difference, then f32, then times box/2^32,
    then the sum over x, y, z in that order.  One axis at a time and in
    place, so that one [bb, blk, S] int64 and two f32 buffers exist."""
    r2 = None
    for c in range(3):
        d = spos[..., c].long() - tpos[..., c].long()
        # the int32 bit pattern of d, as wrap_i32 gives it
        d.add_(1 << 31).bitwise_and_(0xFFFFFFFF).sub_(1 << 31)
        df = d.to(torch.float32)
        del d
        df.mul_(to_f)
        df.mul_(df)
        if r2 is None:
            r2 = df
        else:
            r2.add_(df)
        del df
    return r2


def _shortcut(labels):
    """Pointer jumping: label = label[label] three times."""
    for _ in range(3):
        labels = labels[labels]
    return labels


@dataclass
class FOFStats:
    """What one fof_label call did, for the stage printout."""
    tree_s: float = 0.0
    traverse_s: float = 0.0
    pairs_s: float = 0.0
    iterations: int = 0
    iterate_s: float = 0.0
    syncs: int = 0
    blocks: int = 0
    leaves: int = 0
    pair_lanes: int = 0
    links: int = 0
    repass: bool = False
    attach_s: float = 0.0
    compile_s: float = 0.0


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _PairPass:
    """One blocked traversal (_blocked_neighbor_lists) and the r2 < b*b
    test of _blocked_min_label over the blocks' sources, in sorted rows:
    targets are the live rows, sources every live row of a listed leaf
    (at most ncrit per leaf)."""

    def __init__(self, tree: Octree, n_live: int, alive_s, b: float,
                 boxsize, stats: FOFStats):
        self.tree, self.alive_s = tree, alive_s
        self.bb_lo, self.bb_hi, self.tgt_idx, self.tgt_valid = \
            make_blocks_from_tree(tree, n_live, _BLOCK, boxsize)
        self.nb = self.bb_lo.shape[0]
        b32 = np.float32(b)
        radius = torch.where(self.tgt_valid.any(1), float(b32), 0.0)
        self.lists = block_traverse_bfs(tree, self.bb_lo, self.bb_hi,
                                        radius, boxsize)
        stats.blocks += self.nb
        stats.leaves += self.lists.leaf.numel()
        self.to_f = float(np.float32(boxsize / POS_SCALE))
        self.b2 = float(b32 * b32)
        # each row's listed leaf, where it is among the leaf's first
        # ncrit rows (-1 elsewhere), each target row's block, and the
        # key the lists are sorted by (block_traverse_bfs), for mirrored
        dev = alive_s.device
        self.n = n = tree.ipos_s.shape[0]
        leaf = torch.unique(self.lists.leaf)
        cnt = torch.clamp(tree.pcount[leaf], max=_NCRIT)
        rows = torch.repeat_interleave(
            tree.pstart[leaf] - (torch.cumsum(cnt, 0) - cnt), cnt) \
            + torch.arange(int(cnt.sum()), device=dev)
        self.leaf_of = torch.full((n,), -1, dtype=torch.int64, device=dev)
        self.leaf_of[rows] = torch.repeat_interleave(leaf, cnt)
        self.block_of = torch.full((n,), -1, dtype=torch.int64, device=dev)
        blk = torch.arange(self.nb, device=dev)[:, None].expand_as(
            self.tgt_idx)
        self.block_of[self.tgt_idx[self.tgt_valid]] = blk[self.tgt_valid]
        self.key = self.lists.block * (n + 1) \
            + tree.pstart[self.lists.leaf]

    def batches(self):
        """(target rows [bb, blk], source rows [bb, S], near [bb, blk, S])
        per batch of blocks."""
        for batch in block_sources(self.tree, self.lists, self.nb, _NCRIT,
                                   _BLOCK):
            t_idx = self.tgt_idx[batch.blocks]
            ipos = self.tree.ipos_s
            r2 = _r2(ipos[batch.src][:, None, :, :],
                     ipos[t_idx][:, :, None, :], self.to_f)
            ok = batch.valid & self.alive_s[batch.src]
            near = (r2 < self.b2) & ok[:, None, :] \
                & self.tgt_valid[batch.blocks][:, :, None]
            yield t_idx, batch.src, near, r2.numel()

    def mirrored(self, t, s):
        """Whether the pair (target t, source s) is also found as (target
        s, source t): s is a target (a live row), and t is a source in
        s's block's list (a listed leaf holds t among its first ncrit
        rows).  r2 is the same both ways (the f32 difference only
        changes sign), so a mirrored pair links both ways."""
        lt, bs = self.leaf_of[t], self.block_of[s]
        key = bs * (self.n + 1) + self.tree.pstart[lt.clamp(min=0)]
        i = torch.searchsorted(self.key, key).clamp(
            max=max(self.key.numel() - 1, 0))
        return (lt >= 0) & (bs >= 0) & (self.key[i] == key)


def _blocked_links(pp: _PairPass, stats: FOFStats):
    """The pairs within b as [2, L] int32 sorted rows: (t, s) with s < t
    for the pairs that link both ways, each once, and (t, s) for those
    that link only t to s (t is past the first ncrit rows of its leaf,
    so no list holds it as a source); None when there are more than
    _MAX_LINKS of them."""
    und, one, nlinks = [], [], 0
    for t_idx, src, near, lanes in pp.batches():
        stats.pair_lanes += lanes
        ib, it, js = torch.nonzero(near, as_tuple=True)
        t, s = t_idx[ib, it], src[ib, js]
        del ib, it, js
        m = pp.mirrored(t, s)
        keep_u = m & (s < t)
        keep_1 = ~m
        und.append(torch.stack([t[keep_u], s[keep_u]]).to(torch.int32))
        one.append(torch.stack([t[keep_1], s[keep_1]]).to(torch.int32))
        nlinks += und[-1].shape[1] + one[-1].shape[1]
        if nlinks > _MAX_LINKS:
            return None
    e = torch.zeros(2, 0, dtype=torch.int32, device=pp.tree.ipos_s.device)
    und, one = torch.cat(und + [e], 1), torch.cat(one + [e], 1)
    stats.links += und.shape[1] + one.shape[1]
    return und, one


def _scatter_min(best, dst, src, lab_s):
    """best[dst] = min(best[dst], lab_s[src]) over int32 row pairs, in
    chunks, so that the int64 indices never exceed _LINK_CHUNK rows."""
    for lo in range(0, dst.numel(), _LINK_CHUNK):
        d = dst[lo:lo + _LINK_CHUNK].long()
        best.scatter_reduce_(0, d, lab_s[src[lo:lo + _LINK_CHUNK].long()],
                             "amin", include_self=True)


def _fof_label_tree(ipos, alive, b, boxsize, stats: FOFStats, nlevels=8,
                    ncrit=_NCRIT, maxiter=200, engine="blocked"):
    if engine != "blocked":
        raise NotImplementedError(
            f"fof engine={engine!r}: only 'blocked' is ported; the "
            "per-particle engine needs ops/treewalk.run_walk (ROADMAP "
            "A.10)")
    dev = ipos.device
    n = ipos.shape[0]
    alive = alive.to(torch.bool)
    t0 = time.perf_counter()
    tree = build_octree(ipos, torch.ones(n, device=dev), alive, boxsize,
                        nlevels=nlevels, ncrit=ncrit)
    _sync(dev)
    t1 = time.perf_counter()
    stats.tree_s += t1 - t0
    order = tree.order
    n_live = int(alive.sum())
    stats.syncs += 1
    pp = _PairPass(tree, n_live, alive[order], b, boxsize, stats)
    _sync(dev)
    t0 = time.perf_counter()
    stats.traverse_s += t0 - t1
    links = _blocked_links(pp, stats)
    _sync(dev)
    t1 = time.perf_counter()
    stats.pairs_s += t1 - t0
    stats.repass = links is None
    labels = torch.arange(n, dtype=torch.int64, device=dev)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)
    for _ in range(maxiter):
        stats.iterations += 1
        lab_s = labels[order]
        best = torch.full((n,), NO_LABEL, dtype=torch.int64, device=dev)
        if links is None:
            # the JAX package's form: every pair lane again
            for t_idx, src, near, _ in pp.batches():
                cand = torch.where(near, lab_s[src][:, None, :], NO_LABEL)
                best.scatter_reduce_(0, t_idx.reshape(-1),
                                     cand.amin(2).reshape(-1), "amin",
                                     include_self=True)
        else:
            (ua, ub), (ot, os_) = links
            _scatter_min(best, ua, ub, lab_s)
            _scatter_min(best, ub, ua, lab_s)
            _scatter_min(best, ot, os_, lab_s)
        new = torch.minimum(best[inv], labels)
        new = torch.where(alive, new, labels)
        new = _shortcut(new)
        changed = bool(torch.any(new != labels))
        stats.syncs += 1
        labels = new
        if not changed:
            break
    _sync(dev)
    stats.iterate_s += time.perf_counter() - t1
    return labels, tree


def fof_label(ipos, alive, b, boxsize, nlevels=8, ncrit=_NCRIT,
              maxiter=200, engine="blocked"):
    """Group labels for the primary-linking particle set: int64 labels in
    [0, n), the smallest particle index in each connected component.
    Dead particles keep their own index."""
    return _fof_label_tree(ipos, alive, b, boxsize, FOFStats(), nlevels,
                           ncrit, maxiter, engine)[0]


def _nearest_pass(tree: Octree, labels_sorted, alive_sorted, tpos_blk,
                  lists, boxsize, ncrit: int, block: int):
    """Nearest-primary label per target over the blocked leaf lists
    (_blocked_nearest_pass): the first source of least r2 in list order,
    among all live sources of the lists (no radius cut)."""
    dev = tpos_blk.device
    nb = tpos_blk.shape[0]
    to_f = float(np.float32(boxsize / POS_SCALE))
    br = torch.full((nb, block), float("inf"), device=dev)
    bl = torch.full((nb, block), NO_LABEL, dtype=torch.int64, device=dev)
    for batch in block_sources(tree, lists, nb, ncrit, block):
        ok = batch.valid & alive_sorted[batch.src]
        spos = tree.ipos_s[batch.src]
        tpos = tpos_blk[batch.blocks]
        r2 = _r2(spos[:, None, :, :], tpos[:, :, None, :], to_f)
        r2 = torch.where(ok[:, None, :], r2, float("inf"))
        rj, j = torch.min(r2, dim=2)
        lj = labels_sorted[torch.gather(batch.src, 1, j)]
        br[batch.blocks] = rj
        bl[batch.blocks] = torch.where(torch.isfinite(rj), lj, NO_LABEL)
    return br, bl


def fof_attach_secondary_blocked(tree_primary: Octree,
                                 primary_labels_sorted,
                                 primary_alive_sorted, target_ipos,
                                 boxsize, rmax, block=_BLOCK,
                                 ncrit=_NCRIT):
    """Blocked nearest-primary attach.  Targets are grouped into blocks
    of their own Morton order (they are not in the primary tree); the
    radius doubles for blocks with a miss, re-traversing only then.

    The JAX loop also spends one of its 6 rounds on each list overflow
    (and doubles its list cap); the traversal here has no cap, so every
    round is a radius round.  The two differ only where a target needs
    more than 5 doublings and a list overflowed on the way."""
    dev = target_ipos.device
    t = target_ipos.shape[0]
    order = torch.argsort(morton_key(target_ipos), stable=True)
    nb = (t + block - 1) // block
    pad = nb * block - t
    idx = torch.cat([order, order[-1:].repeat(pad)])
    tpos = target_ipos[idx].reshape(nb, block, 3)
    to_f = float(np.float32(boxsize / POS_SCALE))
    posf = u32(tpos).to(torch.float32) * to_f
    bb_lo = posf.amin(1)
    bb_hi = posf.amax(1)

    best_r2 = torch.full((nb, block), float("inf"), device=dev)
    best_l = torch.full((nb, block), NO_LABEL, dtype=torch.int64,
                        device=dev)
    radius = torch.full((nb,), float(np.float32(rmax)), device=dev)
    for _ in range(6):
        lists = block_traverse_bfs(tree_primary, bb_lo, bb_hi, radius,
                                   boxsize)
        br, bl = _nearest_pass(tree_primary, primary_labels_sorted,
                               primary_alive_sorted, tpos, lists,
                               boxsize, ncrit, block)
        better = br < best_r2
        best_r2 = torch.where(better, br, best_r2)
        best_l = torch.where(better, bl, best_l)
        missing = (~torch.isfinite(best_r2)).any(1)
        if not bool(missing.any()):
            break
        radius = torch.where(missing, radius * 2.0, radius)
    # unscatter the target order (padded lanes repeat the last target,
    # so their duplicate writes carry identical values)
    labels = torch.zeros(t, dtype=torch.int64, device=dev)
    labels[idx] = best_l.reshape(-1)
    found = torch.zeros(t, dtype=torch.bool, device=dev)
    found[idx] = torch.isfinite(best_r2).reshape(-1)
    return labels, found


@dataclass
class FOFGroups:
    """Halo catalog (fof_compile_catalogue analog)."""

    ngroups: int
    lengths: np.ndarray       # [G]
    masses: np.ndarray        # [G]
    cm: np.ndarray            # [G,3] periodic-aware center of mass
    vel: np.ndarray           # [G,3] mass-weighted mean velocity
    mass_by_type: np.ndarray  # [G,6]
    length_by_type: np.ndarray  # [G,6]
    group_id: np.ndarray      # [N] per-particle group number (0 = none)
    first_pos: np.ndarray     # [G,3] position of the minimum-id particle
    sfr: Optional[np.ndarray] = None
    stats: Optional[FOFStats] = None   # what fof() did, when it ran


def compile_groups(labels, ipos, vel, mass, ptype, alive, boxsize,
                   min_length=32, sfr=None) -> FOFGroups:
    """Reduce particle labels into a group catalog (host-side numpy; a
    copy of shenqi_tpu/fof/fof.py:364).  `ipos` is the uint32 position
    array on the host.

    Group numbering: 1..G by descending length (fof_assign_grnr).
    CM uses the periodic unwrap relative to the minimum-label particle
    (fof_finish_group_properties).
    """
    labels = np.asarray(labels)
    alive = np.asarray(alive)
    ptype_np = np.asarray(ptype)
    mass_np = np.asarray(mass, dtype=np.float64)
    vel_np = np.asarray(vel, dtype=np.float64)
    pos = np.asarray(ipos, dtype=np.float64) * (boxsize / POS_SCALE)

    lab = np.where(alive, labels, 0xFFFFFFFF)
    uniq, inv = np.unique(lab, return_inverse=True)
    # drop the dead-sentinel group if present
    ngr_all = len(uniq)
    counts = np.bincount(inv, weights=alive.astype(np.float64),
                         minlength=ngr_all)
    keep = (counts >= min_length) & (uniq != 0xFFFFFFFF)
    # order groups by length descending (ties by label)
    order = np.lexsort((uniq[keep], -counts[keep]))
    kept_idx = np.nonzero(keep)[0][order]
    G = len(kept_idx)
    # map group slot -> 1-based group number
    grnr_of_slot = np.zeros(ngr_all, dtype=np.int64)
    grnr_of_slot[kept_idx] = np.arange(1, G + 1)
    group_id = np.where(alive, grnr_of_slot[inv], 0)

    lengths = counts[kept_idx].astype(np.int64)
    masses = np.zeros(G)
    cm = np.zeros((G, 3))
    vcm = np.zeros((G, 3))
    mass_by_type = np.zeros((G, 6))
    length_by_type = np.zeros((G, 6), dtype=np.int64)
    first_pos = np.zeros((G, 3))
    sfr_g = np.zeros(G)

    gi = group_id - 1  # -1 for ungrouped
    sel = gi >= 0
    gsel = gi[sel]
    msel = mass_np[sel] * alive[sel]
    np.add.at(masses, gsel, msel)
    # unwrap positions about the minimum-label particle of each group
    minlab_particle = uniq[kept_idx]  # the min particle index per group
    ref = pos[minlab_particle.astype(np.int64)]
    first_pos[:] = ref
    d = pos[sel] - ref[gsel]
    d -= boxsize * np.round(d / boxsize)
    for k in range(3):
        np.add.at(cm[:, k], gsel, msel * d[:, k])
        np.add.at(vcm[:, k], gsel, msel * vel_np[sel][:, k])
    cm /= np.maximum(masses, 1e-35)[:, None]
    cm = (cm + ref) % boxsize
    vcm /= np.maximum(masses, 1e-35)[:, None]
    for t in range(6):
        tsel = sel & (ptype_np == t)
        if tsel.any():
            np.add.at(mass_by_type[:, t], gi[tsel], mass_np[tsel])
            np.add.at(length_by_type[:, t], gi[tsel], 1)
    if sfr is not None:
        sfr_np = np.asarray(sfr, dtype=np.float64)
        gas_sel = sel & (ptype_np == 0)
        if gas_sel.any():
            np.add.at(sfr_g, gi[gas_sel], sfr_np[gas_sel])

    return FOFGroups(ngroups=G, lengths=lengths, masses=masses, cm=cm,
                     vel=vcm, mass_by_type=mass_by_type,
                     length_by_type=length_by_type, group_id=group_id,
                     first_pos=first_pos, sfr=sfr_g)


def fof(ipos, vel, mass, ptype, alive, boxsize, mean_separation,
        linking_length=0.2, min_length=32, primary_mask=None,
        sfr=None) -> FOFGroups:
    """Full FOF: primary link over DM(+stars), secondary attach, catalog.

    ipos: [N,3] int32 bit patterns on the device FOF runs on; vel, mass,
    ptype, alive and primary_mask: host arrays or tensors.
    primary_mask: which particles define the linking set (default:
    types 1 and 4, the reference's DM+star primary).  The catalogue's
    `stats` holds the stage times and counts.
    """
    dev = ipos.device
    stats = FOFStats()

    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)

    ptype_np = host(ptype)
    alive_np = host(alive).astype(bool)
    if primary_mask is None:
        primary_mask = (ptype_np == 1) | (ptype_np == 4)
    primary_np = host(primary_mask).astype(bool) & alive_np
    primary = torch.from_numpy(primary_np).to(dev)
    b = linking_length * mean_separation

    labels, tree = _fof_label_tree(ipos, primary, b, boxsize, stats)

    # secondary: attach gas/BH to the nearest primary
    secondary = alive_np & ~primary_np
    if secondary.any():
        t0 = time.perf_counter()
        # the JAX package builds this tree anew from the same inputs
        order = tree.order
        sec_idx = torch.from_numpy(np.nonzero(secondary)[0]).to(dev)
        sec_labels, found = fof_attach_secondary_blocked(
            tree, labels[order], primary[order], ipos[sec_idx], boxsize,
            rmax=b)
        labels[sec_idx] = torch.where(found, sec_labels, labels[sec_idx])
        _sync(dev)
        stats.attach_s += time.perf_counter() - t0

    t0 = time.perf_counter()
    out = compile_groups(labels.cpu().numpy(),
                         ipos.cpu().numpy().view(np.uint32), host(vel),
                         host(mass), ptype_np, alive_np, boxsize,
                         min_length=min_length,
                         sfr=None if sfr is None else host(sfr))
    stats.compile_s += time.perf_counter() - t0
    out.stats = stats
    return out
