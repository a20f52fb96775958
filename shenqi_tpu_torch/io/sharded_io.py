"""Snapshots written and read by every rank of a slab run
(shenqi_tpu/io/sharded_io.py in torch.distributed).

The reference writes a snapshot collectively: each rank writes its own
contiguous row range of every block, at most NumWriters ranks at a
time (petaio.cpp petaio_save_block).  Here the ranks' row counts are
all-gathered into offsets (rank order, a deterministic global order),
rank 0 creates the header and the blocks with their data files at full
size, the ranks write in groups of NUM_WRITERS separated by barriers,
and rank 0 writes the block headers last: bigfile.flush recomputes the
checksums from the data files, so it must follow every rank's write.
The multi-species writer (save_snapshot_sharded_multi, sharded_io.py:99)
comes with the slab gas (ROADMAP A.9.2).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .._device import resolve_device
from ..core.particles import POS_SCALE, float_to_ipos, u32
from ..ops.morton import morton_key
from ..parallel import collectives as cc
from ..parallel.domain import slab_index
from .bigfile import BigBlock, BigFile
from .snapshot import SnapshotHeader

_SPECS = (("Position", "<f8", 3), ("Velocity", "<f4", 3),
          ("Mass", "<f4", 1), ("ID", "<u8", 1))
PTYPE = 1          # the dark-matter slab run writes one species
NUM_WRITERS = 4    # ranks that write at once (the JAX writer's default)
CHUNK = 1 << 20    # rows per piece the loader streams


def save_snapshot_sharded(path: str, header: SnapshotHeader, fields: dict,
                          boxsize: float, atime: float) -> str:
    """Write a PART snapshot of every rank's rows (sharded_io.py:30-96).
    Collective.  fields: this rank's ipos [n,3] (int32 bits), vel, mass
    (0 = not written), pid [n] and pid_hi (the ID's low and high words
    as int32 bits).  Velocities follow the header's UsePeculiarVelocity
    (petaio.cpp:732-745)."""
    dev = fields["mass"].device
    alive = fields["mass"] > 0
    counts, _ = cc.all_gather_rows(torch.tensor(
        [int(alive.sum())], dtype=torch.int64, device=dev))
    counts = counts.cpu().numpy()
    offsets = np.concatenate([[0], np.cumsum(counts)])
    ntot = int(offsets[-1])
    me, D = cc.rank(), cc.world_size()
    header = dataclasses.replace(
        header, TotNumPart=np.where(np.arange(6) == PTYPE, ntot,
                                    0).astype(np.uint64), Time=atime)
    vfac = 1.0 / atime if header.UsePeculiarVelocity else 1.0
    blocks = {name: BigBlock.create(os.path.join(path, f"{PTYPE}/{name}"),
                                    dt, ntot, nmemb=nm)
              for name, dt, nm in _SPECS}
    if me == 0:
        header.write(BigFile(path, create=True))
        for b in blocks.values():
            # every data file at its full size before any rank writes
            for fid, size in enumerate(b.fsize):
                with open(b._fname(fid), "wb") as f:
                    f.truncate(size * np.dtype(b.dtype).itemsize * b.nmemb)
    cc.barrier()
    step = NUM_WRITERS
    for g0 in range(0, D, step):
        if g0 <= me < g0 + step and counts[me]:
            off = int(offsets[me])
            pos = (u32(fields["ipos"][alive]).double()
                   * (boxsize / POS_SCALE)).cpu().numpy()
            blocks["Position"].write(off, pos)
            blocks["Velocity"].write(
                off, (fields["vel"][alive] * vfac).cpu().numpy())
            blocks["Mass"].write(off, fields["mass"][alive].cpu().numpy())
            pid = u32(fields["pid"][alive]) | (u32(fields["pid_hi"][alive])
                                               << 32)
            blocks["ID"].write(off, pid.cpu().numpy().astype(np.uint64))
        cc.barrier()
    if me == 0:
        for b in blocks.values():
            b.flush()
    cc.barrier()
    return path


def load_snapshot_sharded(path: str, boxsize: float, device=None):
    """This rank's rows of a PART snapshot (sharded_io.py:197-294): the
    file streamed in CHUNK-row pieces, keeping the rows of this rank's
    uniform slab, Morton-sorted; peak host memory is one chunk and this
    rank's rows.  Returns a dict of tensors on `device`: ipos (int32
    bits), vel (internal), mass, pid (the ID, int64)."""
    D, me = cc.world_size(), cc.rank()
    bf = BigFile(path)
    hdr = SnapshotHeader.read(bf)
    vfac = float(hdr.Time) if hdr.UsePeculiarVelocity else 1.0
    blk = {name: bf[f"{PTYPE}/{name}"] for name, _, _ in _SPECS}
    ntot = blk["Position"].size
    parts = []
    for s0 in range(0, ntot, CHUNK):
        c = min(CHUNK, ntot - s0)
        ip = float_to_ipos(np.asarray(blk["Position"].read(s0, c))
                           % boxsize, boxsize, device="cpu")
        sel = (slab_index(ip[:, 0], D) == me).numpy()
        parts.append({
            "ipos": ip.numpy()[sel],
            "vel": (np.asarray(blk["Velocity"].read(s0, c))[sel]
                    * vfac).astype(np.float32),
            "mass": np.asarray(blk["Mass"].read(s0, c)).reshape(-1)[sel],
            "pid": (np.asarray(blk["ID"].read(s0, c)).reshape(-1)[sel]
                    .astype(np.int64))})
    out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    order = np.argsort(morton_key(torch.from_numpy(out["ipos"])).numpy(),
                       kind="stable")
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v[order])).to(dev)
            for k, v in out.items()}
