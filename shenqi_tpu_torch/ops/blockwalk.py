"""Block-based neighbour traversal over the octree: what FOF takes from
shenqi_tpu/ops/blockwalk.py, in torch.

  1. Targets are grouped into cell-anchored blocks of Morton-contiguous
     rows with compact bounding boxes (`make_blocks_from_tree`, :257).
  2. One traversal per block emits the leaves whose cells lie within
     the block's radius of its bounding box.  The JAX FOF runs the
     sequential sibling walk (`block_traverse`, :64, vmapped while
     loops); a per-block while loop has no torch idiom, so this is the
     level-synchronous frontier form (`block_traverse_bfs`, :352,
     mode="neighbor"), which tests/test_bfs_traverse.py already holds to
     the same lists.  The frontier is a flat list of (block, node)
     pairs, so there are no frontier caps and no overflow retries: the
     lists are exactly the leaves the walk would reach.
  3. `block_sources` turns each block's leaves into its packed source
     rows (`gather_leaf_sources`, :328, without the ncrit padding of
     each leaf slot), batched so that a [blocks, block, sources] pass
     stays within a memory budget.
"""

from __future__ import annotations

import math
from typing import Iterator, NamedTuple

import torch

from .tree import Octree
from ..core.particles import POS_SCALE, lshr

# pair lanes of one batch of a per-pair pass: 64 MB per f32 temporary
_MAX_LANES = 1 << 24


class BlockLeaves(NamedTuple):
    """Flat (block, leaf) pairs, sorted by block and then by the leaf's
    first row (the sequential walk's depth-first order)."""
    block: torch.Tensor   # [P] int64
    leaf: torch.Tensor    # [P] int64 node ids


def auto_block_level(n_targets: int, block: int) -> int:
    """The Morton level with ~4 blocks of `block` targets per occupied
    cell on average (ops/blockwalk.py:250 of the JAX package)."""
    return max(1, min(8, round(math.log(max(n_targets, 8) / (4.0 * block),
                                        8))))


def make_blocks_from_tree(tree: Octree, n_targets: int, block: int,
                          boxsize):
    """Cell-anchored target blocks over the first n_targets sorted rows.

    The sorted order is split at Morton-cell boundaries of a level with
    ~4 blocks per cell first (each cell owns a contiguous run), and each run is chunked into
    blocks of up to `block` rows, so a block's bounding box is at most
    one cell wide.  Returns (bb_lo [B,3] f32, bb_hi [B,3] f32, tgt_idx
    [B,block] int64 into the sorted rows, tgt_valid [B,block] bool).
    The JAX package pads B to a power of two with empty blocks (static
    shapes); an empty block reaches no leaf, so they are left out here.
    """
    n = tree.ipos_s.shape[0]
    nt = min(n_targets, n)
    dev = tree.ipos_s.device
    level = auto_block_level(nt, block)
    ipos = tree.ipos_s[:nt]
    c = lshr(ipos, 32 - level)
    gid = (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]
    newrun = torch.ones(nt, dtype=torch.bool, device=dev)
    newrun[1:] = gid[1:] != gid[:-1]
    g_start = torch.nonzero(newrun).squeeze(1)
    g_count = torch.diff(torch.cat([g_start, g_start.new_tensor([nt])]))
    nchunk = (g_count + block - 1) // block
    total = int(nchunk.sum())
    row = torch.repeat_interleave(torch.arange(len(g_start), device=dev),
                                  nchunk)
    first_chunk = torch.repeat_interleave(torch.cumsum(nchunk, 0) - nchunk,
                                          nchunk)
    off = (torch.arange(total, device=dev) - first_chunk) * block
    starts = g_start[row] + off
    counts = torch.clamp(g_count[row] - off, max=block)
    lane = torch.arange(block, device=dev)
    tgt_idx = torch.clamp(starts[:, None] + lane[None, :], 0, n - 1)
    tgt_valid = lane[None, :] < counts[:, None]
    # tight per-block bounding boxes in f64, then f32, as the JAX
    # package computes them on the host
    posf = lshr(ipos, 0).to(torch.float64) * (boxsize / float(POS_SCALE))
    pb = posf[torch.clamp(tgt_idx, 0, nt - 1)]
    v = tgt_valid[..., None]
    bb_hi = torch.where(v, pb, -math.inf).amax(1).to(torch.float32)
    bb_lo = torch.where(v, pb, math.inf).amin(1).to(torch.float32)
    return bb_lo, bb_hi, tgt_idx, tgt_valid


def block_traverse_bfs(tree: Octree, bb_lo, bb_hi, block_radius,
                       boxsize) -> BlockLeaves:
    """The leaves within block_radius [B] of each block's bounding box
    (the neighbour mode of block_traverse / block_traverse_bfs).

    Starting from the root's children, every (block, node) pair of the
    frontier is tested at once; a node whose cell overlaps the inflated
    box is emitted when it is a leaf and replaced by its children when
    it is not.  Massless subtrees hold no live sources and are culled,
    as in both JAX forms.  The f32 arithmetic of the overlap test is
    the JAX package's, term for term.
    """
    dev = bb_lo.device
    B = bb_lo.shape[0]
    c_bb = 0.5 * (bb_lo + bb_hi)
    h_bb = 0.5 * (bb_hi - bb_lo)
    r2 = block_radius * block_radius
    if tree.root_child < 0 or B == 0:
        e = torch.zeros(0, dtype=torch.int64, device=dev)
        return BlockLeaves(e, e)
    roots = tree.root_child + torch.arange(int(tree.nchild[0]),
                                           device=dev)
    fb = torch.arange(B, device=dev).repeat_interleave(len(roots))
    fn = roots.repeat(B)
    out_b, out_l = [], []
    while fb.numel():
        d = tree.center[fn] - c_bb[fb]
        d = d - boxsize * torch.round(d / boxsize)
        dbox = torch.clamp(torch.abs(d) - h_bb[fb], min=0.0)
        dcell = torch.clamp(dbox - 0.5 * tree.length[fn][:, None], min=0.0)
        dc2 = dcell * dcell
        overlap = (dc2[:, 0] + dc2[:, 1] + dc2[:, 2]) < r2[fb]
        live = overlap & (tree.mass[fn] > 0)
        child = tree.child[fn]
        leaf = live & (child < 0)
        out_b.append(fb[leaf])
        out_l.append(fn[leaf])
        down = live & (child >= 0)
        fb, first, cnt = fb[down], child[down], tree.nchild[fn[down]]
        fb = fb.repeat_interleave(cnt)
        start = torch.repeat_interleave(first - (torch.cumsum(cnt, 0) - cnt),
                                        cnt)
        fn = start + torch.arange(int(cnt.sum()), device=dev)
    blk = torch.cat(out_b)
    leaf = torch.cat(out_l)
    # depth-first order within a block = ascending first row
    key = blk * (tree.ipos_s.shape[0] + 1) + tree.pstart[leaf]
    o = torch.argsort(key)
    return BlockLeaves(blk[o], leaf[o])


class SourceBatch(NamedTuple):
    blocks: torch.Tensor   # [bb] int64 block ids of this batch
    src: torch.Tensor      # [bb, S] int64 sorted source rows (0 padding)
    valid: torch.Tensor    # [bb, S] bool


def block_sources(tree: Octree, lists: BlockLeaves, nblocks: int,
                  ncrit: int, block: int) -> Iterator[SourceBatch]:
    """Each block's source rows, the concatenation of its leaves' row
    ranges in list order, padded per batch to the batch's longest list.

    Like gather_leaf_sources, a leaf contributes at most `ncrit` rows:
    a bottom-level leaf holding more (a cell at nlevels deeper than
    ncrit particles) is truncated, as in the JAX package.  Blocks are
    taken longest list first and batched so that bb * block * S stays
    under _MAX_LANES; the result of a per-pair pass does not depend on
    the batching.  Between batches only the flat source rows are held
    (one int64 per source of every list)."""
    dev = tree.ipos_s.device
    cnt = torch.clamp(tree.pcount[lists.leaf], max=ncrit)
    per_block = torch.zeros(nblocks, dtype=torch.int64, device=dev)
    per_block.index_add_(0, lists.block, cnt)
    # blocks longest first, each block's rows one contiguous run of
    # `rows` from start[k] for the k-th block of that order
    order = torch.argsort(per_block, descending=True, stable=True)
    counts_t = per_block[order]
    start = torch.cumsum(counts_t, 0) - counts_t
    start_of = torch.empty_like(start)
    start_of[order] = start
    # each list entry's first position there: its block's start plus
    # the rows of the block's earlier entries (lists are sorted by block)
    ent = torch.cumsum(cnt, 0) - cnt
    blk_first = torch.cumsum(per_block, 0) - per_block
    pos = start_of[lists.block] + ent - blk_first[lists.block]
    # the entries in position order; within an entry, row = position +
    # (its leaf's first row - its first position)
    o = torch.argsort(pos)
    cnt_o = cnt[o]
    nsrc = int(cnt.sum())
    rows = torch.arange(nsrc, device=dev)
    rows += torch.repeat_interleave(tree.pstart[lists.leaf[o]] - pos[o],
                                    cnt_o)
    del cnt, ent, blk_first, pos, o, cnt_o, start_of
    counts = counts_t.tolist()
    i = 0
    while i < nblocks and counts[i] > 0:
        smax = counts[i]
        bb = max(1, min(nblocks - i, _MAX_LANES // (block * smax)))
        lane = torch.arange(smax, device=dev)
        valid = lane[None, :] < counts_t[i:i + bb, None]
        idx = torch.clamp(start[i:i + bb, None] + lane[None, :],
                          max=max(nsrc - 1, 0))
        src = torch.where(valid, rows[idx], 0)
        yield SourceBatch(order[i:i + bb], src, valid)
        i += bb
