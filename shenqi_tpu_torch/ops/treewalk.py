"""The neighbour walks SPH needs (shenqi_tpu/ops/treewalk.py in torch):
the all-sources pass and the blocked walk over the octree.

The accumulate protocol is the JAX package's, over a whole tensor of
pairs at once rather than one target at a time:

  accumulate(carry, extra, src, dist, r2, live) -> carry
    * carry: tuple of per-target accumulators, shape [...] (+ (3,))
    * extra: dict of per-target tensors, shape [...]
    * src:   dict of per-source tensors broadcastable to [..., S]
    * dist:  [..., S, 3] minimum-image vector from source to target
             (reference get_distance convention: input.Pos - other.Pos)
    * r2:    [..., S] squared distance; live: [..., S] range validity
             (the radius cut is the accumulator's job, ngbiter
             semantics)

The vmapped per-particle walk (`run_walk`) and the sequential block
traversal stay with ROADMAP A.10.  The blocked walk runs on the
port's frontier traversal (`ops/blockwalk.block_traverse_bfs`), whose
lists have no caps: `list_overflow` and `block_overflow` never set, and
the lists are the ones the JAX walk reaches once its caps have grown
enough.
"""

from __future__ import annotations

import numpy as np
import torch

from .blockwalk import block_traverse_bfs, block_sources, _MAX_LANES
from .morton import morton_key
from ..core.particles import POS_SCALE, ipos_delta, u32


class TreeTooShallow(RuntimeError):
    """A blocked neighbour walk hit a leaf with more than ncrit rows
    (bottom-level overflow): the caller must rebuild the octree with
    more levels and retry, or neighbours go missing silently."""


def pair_dist(tipos, sipos, boxsize):
    """(dist [..., 3] f32, r2 [...]) of target and source positions
    (int32 bit patterns, broadcastable): the minimum-image difference of
    core/particles.ipos_delta, one axis at a time so that the int64
    difference of one axis exists at once."""
    comps = [ipos_delta(tipos[..., c], sipos[..., c], boxsize)
             for c in range(3)]
    dist = torch.stack(comps, dim=-1)
    r2 = comps[0] * comps[0] + comps[1] * comps[1] + comps[2] * comps[2]
    return dist, r2


def take(extra, idx):
    """Gather the per-target tensors of `extra` at idx; scalars (values
    shared by every target) stay as they are."""
    return {k: (v[idx] if torch.is_tensor(v) else v)
            for k, v in extra.items()}


def run_walk_dense(payload, target_ipos, target_extra, carry0, accumulate,
                   boxsize: float, src_chunk: int = 8192):
    """Every target against every source in chunks of `src_chunk`
    sources (the JAX package's oracle for the small overflow tails the
    stencil engines flag).  Targets are taken in groups so that one
    group's pairs stay within the lane budget of ops/blockwalk."""
    n = payload["ipos"].shape[0]
    t = target_ipos.shape[0]
    tch = max(1, _MAX_LANES // src_chunk)
    out = [c.clone() for c in carry0]
    for t0 in range(0, t, tch):
        sl = slice(t0, min(t0 + tch, t))
        carry = tuple(c[sl] for c in out)
        extra = take(target_extra, sl)
        tip = target_ipos[sl][:, None, :]
        for s0 in range(0, n, src_chunk):
            src = {k: v[s0:s0 + src_chunk][None] for k, v in payload.items()}
            dist, r2 = pair_dist(tip, src["ipos"], boxsize)
            live = torch.ones(r2.shape, dtype=torch.bool,
                              device=r2.device)
            carry = accumulate(carry, extra, src, dist, r2, live)
        for o, c in zip(out, carry):
            o[sl] = c
    return tuple(out)


def make_target_blocks(target_ipos, block: int, level: int):
    """Group arbitrary targets into Morton blocks that never straddle a
    level-`level` Morton cell (so their bounding boxes stay compact).

    Returns (order [T] int64, the targets in block order; slot [T]
    int64, each ordered target's flat slot block*`block` + lane; bb_lo,
    bb_hi [nb, 3] f32 in integer position units; nb).  The JAX package
    pads to a static `nb` and flags overflow; here nb is what the
    targets need."""
    T = target_ipos.shape[0]
    dev = target_ipos.device
    order = torch.argsort(morton_key(target_ipos), stable=True)
    ipos_o = target_ipos[order]
    gid = morton_key(ipos_o) >> (30 - 3 * level)
    idx = torch.arange(T, dtype=torch.int64, device=dev)
    newcell = torch.ones(T, dtype=torch.bool, device=dev)
    newcell[1:] = gid[1:] != gid[:-1]
    cellstart = torch.cummax(torch.where(newcell, idx, 0), 0).values
    rank = idx - cellstart
    bflag = newcell | (rank % block == 0)
    bid = torch.cumsum(bflag.long(), 0) - 1
    blockstart = torch.cummax(torch.where(bflag, idx, 0), 0).values
    slot = bid * block + (idx - blockstart)
    nb = int(bid[-1]) + 1 if T else 0
    # uint32 -> f32 rounds to nearest, as int64 -> f32 does
    posf = u32(ipos_o).to(torch.float32)
    big = float(np.float32(3.4e38))
    b3 = bid[:, None].expand(-1, 3)
    bb_lo = torch.full((nb, 3), big, device=dev).scatter_reduce_(
        0, b3, posf, "amin")
    bb_hi = torch.full((nb, 3), -big, device=dev).scatter_reduce_(
        0, b3, posf, "amax")
    return order, slot, bb_lo, bb_hi, nb


def run_walk_blocked(tree, payload, target_ipos, target_radius,
                     target_extra, carry0, accumulate, boxsize: float,
                     block: int = 64, ncrit: int = 32, level: int = 4):
    """Blocked form of the neighbour walk (same accumulate protocol).

    One frontier traversal per Morton block of targets emits the leaves
    within the block's largest radius of its bounding box; each block's
    leaf sources (tree-sorted `payload` rows) are evaluated densely
    against its targets, in batches within the lane budget.  Returns
    (carry in original target order, info) with the JAX package's info
    keys: `leaf_truncated` (a listed leaf holds more than ncrit rows, so
    its tail was dropped) as a device bool, the overflow flags False.
    """
    dev = target_ipos.device
    T = target_ipos.shape[0]
    to_f = float(np.float32(boxsize / POS_SCALE))
    order, slot, bb_lo, bb_hi, nb = make_target_blocks(target_ipos, block,
                                                       level)
    # the target of each slot (T: an empty slot)
    slot_t = torch.full((nb * block,), T, dtype=torch.int64, device=dev)
    slot_t[slot] = order
    slot_t = slot_t.reshape(nb, block)
    svalid = slot_t < T
    stc = torch.clamp(slot_t, max=max(T - 1, 0))
    block_rad = torch.amax(torch.where(svalid, target_radius[stc], 0.0),
                           dim=1)
    lists = block_traverse_bfs(tree, bb_lo * to_f, bb_hi * to_f, block_rad,
                               boxsize)
    # row T of each accumulator takes the empty slots' results
    out = [torch.cat([c, c[:1]]) for c in carry0]
    for b in block_sources(tree, lists, nb, ncrit, block):
        ti = stc[b.blocks]                              # [bb, block]
        src = {k: v[b.src][:, None] for k, v in payload.items()}
        dist, r2 = pair_dist(target_ipos[ti][:, :, None, :], src["ipos"],
                             boxsize)
        carry = accumulate(tuple(c[ti] for c in out),
                           take(target_extra, ti),
                           src, dist, r2, b.valid[:, None, :])
        del dist, r2
        dst = torch.where(svalid[b.blocks], ti, T)
        for o, c in zip(out, carry):
            o[dst] = c
    truncated = torch.any(tree.pcount[lists.leaf] > ncrit) \
        if lists.leaf.numel() else torch.zeros((), dtype=torch.bool,
                                               device=dev)
    return tuple(o[:T] for o in out), {"block_overflow": False,
                                       "list_overflow": False,
                                       "leaf_truncated": truncated}

