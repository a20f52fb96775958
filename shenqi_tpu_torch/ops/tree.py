"""SoA octree over Morton-sorted particles (shenqi_tpu/ops/tree.py:79
`build_octree` in torch, the forcetree.cpp analog).

Particles are sorted by Morton key once; every octree cell is then a
contiguous index range, so the whole tree is built level by level with
segmented reductions (`index_add_` / `scatter_reduce` here, XLA's
segment_sum / segment_min in the JAX package):

  level l:  prefix  p = key >> 3(D-l)
            run starts  f_i = [p_i != p_{i-1}]
            segment id  s_i = cumsum(f) - 1       (dense cell index)
            mass        segment sum of the masses
            ranges      pstart = segment min of the index, pcount the
                        segment count of live rows
            children    contiguous in the next level's segment ids

The keys are two 30-bit words at every depth (the deep branch of
shenqi_tpu/ops/tree.py:83-100,121-129,155-160, which the JAX package
takes past level 10 only), for the deeper trees the velocity dispersion
retries with; up to level 10 they give the 30-bit key's tree.  What
the neighbour traversals of FOF, veldisp and the SPH IC fixed point
read is ported (with the sorted masses).  The centres of mass, sibling
pointers, canonical-leaf flags and hsml maxima of the JAX tree serve
the gravity walks, the sequential walk, the packed-source table and the
symmetric SPH walks; they come with those (ROADMAP A.10).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .morton import morton_key_pair, key_pair_to_cell, MAX_DEPTH
_SENTINEL_KEY = 0xFFFFFFFF
# the deepest tree the two-word keys resolve
MAX_DEEP = 2 * MAX_DEPTH


@dataclass
class Octree:
    """Flat SoA octree: [M] node arrays in level-major order."""

    center: torch.Tensor     # [M,3] f32 geometric cell center
    length: torch.Tensor     # [M]   f32 cell side length
    mass: torch.Tensor       # [M]   f32 total mass
    pstart: torch.Tensor     # [M] int64 first sorted row of the cell
    pcount: torch.Tensor     # [M] int64 live rows in the cell
    child: torch.Tensor      # [M] int64 first child node (-1 if leaf)
    nchild: torch.Tensor     # [M] int64 child count (contiguous)
    is_leaf: torch.Tensor    # [M] bool (pcount <= ncrit or bottom level)
    valid: torch.Tensor      # [M] bool (occupied cell)
    order: torch.Tensor      # [N] int64 sort permutation (sorted <- original)
    ipos_s: torch.Tensor     # [N,3] int32 bits of the sorted positions
    root_child: int          # first node of level 1 (-1: the root is a leaf)
    mass_s: torch.Tensor = None  # [N] f32 sorted masses, 0 for dead rows


def _level_caps(n: int, nlevels: int):
    """Per-level node caps: min(8^l, n+1) (every level can hold one run
    per particle, plus one run of dead rows)."""
    return [int(min(8 ** lv, n + 1)) for lv in range(nlevels + 1)]


def _segment_sum(vals, seg, cap):
    out = torch.zeros((cap,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, seg, vals)


def _segment_min(vals, seg, cap, empty):
    out = torch.full((cap,), empty, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg, vals, "amin", include_self=True)


def build_octree(ipos, mass, alive, boxsize, nlevels: int = 8,
                 ncrit: int = 32) -> Octree:
    """Build the octree on the device the inputs lie on.  Dead particles
    sort to the end with zero mass and form their own (massless) runs
    under a key above every live one."""
    if nlevels > MAX_DEEP:
        raise ValueError(f"build_octree nlevels={nlevels} > {MAX_DEEP}")
    dev = ipos.device
    n = ipos.shape[0]
    # the two-word key of the JAX package's deep branch (shenqi_tpu/ops/
    # tree.py:83-100) at every depth: both words are 30 bits, so the one
    # int64 key hi << 30 | lo sorts exactly as lexsort((klo, khi)); dead
    # rows carry the sentinel in both words and sort last under 2^62.
    # A level-l prefix is key >> 3(20 - l), and hi alone decides every
    # level up to 10, so a shallower tree is the 30-bit key's.
    sent = torch.full_like(alive, _SENTINEL_KEY, dtype=torch.int64)
    khi, klo = morton_key_pair(ipos)
    khi = torch.where(alive, khi, sent)
    klo = torch.where(alive, klo, sent)
    keys = torch.where(alive, (khi << 30) | klo,
                       torch.full_like(khi, 1 << 62))
    # rows of one 30-bit key keep their input order in a tree of at most
    # 10 levels, as the JAX package's argsort of that key leaves them
    order = torch.argsort(keys if nlevels > MAX_DEPTH else keys >> 30,
                          stable=True)
    keys_s = keys[order]
    khi_s, klo_s = khi[order], klo[order]
    ipos_s = ipos[order]
    alive_s = alive[order]
    mass_s = torch.where(alive_s, mass[order].to(torch.float32), 0.0)

    caps = _level_caps(n, nlevels)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    lvl = {k: [] for k in ("center", "length", "mass", "pstart", "pcount",
                           "parent", "valid")}
    segs = []
    for lv in range(nlevels + 1):
        cap = caps[lv]
        pref = keys_s >> (3 * (MAX_DEEP - lv))
        first = torch.ones(n, dtype=torch.int64, device=dev)
        first[1:] = (pref[1:] != pref[:-1]).long()
        seg = torch.clamp(torch.cumsum(first, 0) - 1, max=cap - 1)
        nseg = int(seg[-1]) + 1 if n else 0
        segs.append(seg)

        m = _segment_sum(mass_s, seg, cap)
        # pcount counts live rows only: the all-dead sentinel run counts 0
        ps = _segment_min(idx, seg, cap, n)
        cnt = _segment_sum(alive_s.long(), seg, cap)
        valid = torch.arange(cap, device=dev) < nseg
        ps = torch.where(valid, ps, n)
        psc = torch.clamp(ps, 0, max(n - 1, 0))
        cell = key_pair_to_cell(khi_s[psc], klo_s[psc], lv)
        cell_len = boxsize / (1 << lv)
        cen = (cell.to(torch.float32) + 0.5) * float(np.float32(cell_len))

        lvl["center"].append(cen)
        lvl["length"].append(torch.full((cap,), cell_len,
                                        dtype=torch.float32, device=dev))
        lvl["mass"].append(m)
        lvl["pstart"].append(ps)
        lvl["pcount"].append(cnt)
        lvl["valid"].append(valid)
        if lv == 0:
            lvl["parent"].append(torch.full((cap,), -1, dtype=torch.int64,
                                            device=dev))
        else:
            lvl["parent"].append(torch.where(valid, segs[lv - 1][psc], -1))

    offsets = tuple(int(x) for x in np.concatenate([[0], np.cumsum(caps)]))
    M = offsets[-1]
    cat = {k: torch.cat(v) for k, v in lvl.items() if k != "parent"}
    pcount = cat["pcount"]

    is_leaf = pcount <= ncrit
    is_leaf[offsets[nlevels]:] = True

    child = torch.full((M,), -1, dtype=torch.int64, device=dev)
    nchild = torch.zeros(M, dtype=torch.int64, device=dev)
    for lv in range(nlevels):
        cap, ncap = caps[lv], caps[lv + 1]
        pl = lvl["parent"][lv + 1]
        pl_safe = torch.where(pl >= 0, pl, cap)
        cidx = torch.arange(ncap, dtype=torch.int64, device=dev)
        cstart = _segment_min(cidx, pl_safe, cap + 1, ncap)[:cap]
        has_child = cstart < ncap
        child[offsets[lv]:offsets[lv + 1]] = torch.where(
            has_child, cstart + offsets[lv + 1], -1)
        ccount = _segment_sum(torch.ones(ncap, dtype=torch.int64,
                                         device=dev), pl_safe, cap + 1)
        nchild[offsets[lv]:offsets[lv + 1]] = torch.where(
            has_child, ccount[:cap], 0)
    # nodes below a leaf are unreachable: leaves are childless
    child = torch.where(is_leaf, -1, child)
    nchild = torch.where(is_leaf, 0, nchild)

    return Octree(center=cat["center"], length=cat["length"],
                  mass=cat["mass"], pstart=cat["pstart"], pcount=pcount,
                  child=child, nchild=nchild, is_leaf=is_leaf,
                  valid=cat["valid"], order=order, ipos_s=ipos_s,
                  root_child=int(child[0]), mass_s=mass_s)
