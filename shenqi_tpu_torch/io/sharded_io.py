"""Snapshots written and read by every rank of a slab run
(shenqi_tpu/io/sharded_io.py in torch.distributed).

The reference writes a snapshot collectively: each rank writes its own
contiguous row range of every block, at most NumWriters ranks at a
time (petaio.cpp petaio_save_block).  Here the ranks' per-type row
counts are all-gathered into offsets (rank order, a deterministic global
order), rank 0 creates the header and the blocks with their data files
at full size, the ranks write in groups of NUM_WRITERS separated by
barriers, and rank 0 writes the block headers last: bigfile.flush
recomputes the checksums from the data files, so it must follow every
rank's write.  `save_snapshot_sharded_multi` (sharded_io.py:99) writes
each particle type's blocks and, for the gas, the five SPH blocks;
`save_snapshot_sharded` is its one-type case, the dark-matter slab
run's.  InternalEnergy is the single-device writer's, from the physical
density (gas_internal_energy); the JAX package's multi-species writer
takes the comoving one (sharded_io.py:178-180), a^(3(gamma-1)) apart.
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
from ..utils.constants import GAMMA_MINUS1
from .bigfile import BigBlock, BigFile
from .snapshot import SnapshotHeader

_SPECS = (("Position", "<f8", 3), ("Velocity", "<f4", 3),
          ("Mass", "<f4", 1), ("ID", "<u8", 1))
# the gas blocks of the multi-species writer, with the gas column each
# is written from (InternalEnergy from entropy and density)
_GAS_SPECS = (("SmoothingLength", "<f4", 1), ("Density", "<f4", 1),
              ("EgyWtDensity", "<f4", 1), ("Entropy", "<f4", 1),
              ("InternalEnergy", "<f4", 1))
_GAS_COLS = {"SmoothingLength": "hsml", "Density": "density",
             "EgyWtDensity": "egywt", "Entropy": "entropy"}
PTYPE = 1          # the dark-matter slab run writes one species
NUM_WRITERS = 4    # ranks that write at once (the JAX writer's default)
CHUNK = 1 << 20    # rows per piece the loader streams


def gas_internal_energy(entropy: np.ndarray, density: np.ndarray,
                        atime: float) -> np.ndarray:
    """u = A (rho a^-3)^(gamma-1) / (gamma-1) in host f32, as a snapshot
    writes it (gadget_main.py:1180-1218 of the JAX package)."""
    with np.errstate(invalid="ignore"):
        u = (entropy * np.maximum(density * (1.0 / atime ** 3), 1e-35)
             ** GAMMA_MINUS1 / GAMMA_MINUS1)
    return np.nan_to_num(u).astype(np.float32)


def save_snapshot_sharded_multi(path: str, header: SnapshotHeader,
                                fields: dict, boxsize: float, atime: float,
                                gas: dict = None) -> str:
    """Write a PART snapshot of every rank's rows, each type's blocks
    (sharded_io.py:99-194).  Collective.  fields: this rank's ipos [n,3]
    (int32 bits), vel, mass (0 = not written), pid and pid_hi (the ID's
    low and high words as int32 bits) and ptype; gas: None, or this
    rank's [n] hsml, density, egywt and entropy, of which the type-0 rows
    write the five gas blocks.  Velocities follow the header's
    UsePeculiarVelocity (petaio.cpp:732-745)."""
    dev = fields["mass"].device
    alive = fields["mass"] > 0
    pt = fields["ptype"].long()
    sel_t = [alive & (pt == t) for t in range(6)]
    mine = torch.stack([s_.sum() for s_ in sel_t])[None]
    counts, _ = cc.all_gather_rows(mine.to(torch.int64))
    counts = counts.cpu().numpy()                        # [D, 6]
    offsets = np.concatenate([np.zeros((1, 6), np.int64),
                              np.cumsum(counts, axis=0)])
    ntot = offsets[-1]
    types = [t for t in range(6) if ntot[t]]
    me, D = cc.rank(), cc.world_size()
    header = dataclasses.replace(header, TotNumPart=ntot.astype(np.uint64),
                                 Time=atime)
    vfac = 1.0 / atime if header.UsePeculiarVelocity else 1.0
    blocks = {(t, name): BigBlock.create(os.path.join(path, f"{t}/{name}"),
                                         dt, int(ntot[t]), nmemb=nm)
              for t in types
              for name, dt, nm in _SPECS + (_GAS_SPECS if t == 0 and gas
                                            is not None else ())}
    if me == 0:
        header.write(BigFile(path, create=True))
        for b in blocks.values():
            # every data file at its full size before any rank writes
            for fid, size in enumerate(b.fsize):
                with open(b._fname(fid), "wb") as f:
                    f.truncate(size * np.dtype(b.dtype).itemsize * b.nmemb)
    cc.barrier()
    for g0 in range(0, D, NUM_WRITERS):
        if g0 <= me < g0 + NUM_WRITERS:
            for t in types:
                if not counts[me, t]:
                    continue
                sel, off = sel_t[t], int(offsets[me, t])

                def put(name, a):
                    blocks[(t, name)].write(off, a)
                put("Position", (u32(fields["ipos"][sel]).double()
                                 * (boxsize / POS_SCALE)).cpu().numpy())
                put("Velocity", (fields["vel"][sel] * vfac).cpu().numpy())
                put("Mass", fields["mass"][sel].cpu().numpy())
                pid = u32(fields["pid"][sel]) | (u32(fields["pid_hi"][sel])
                                                 << 32)
                put("ID", pid.cpu().numpy().astype(np.uint64))
                if t == 0 and gas is not None:
                    g = {k: v[sel].cpu().numpy() for k, v in gas.items()}
                    for name, col in _GAS_COLS.items():
                        put(name, g[col])
                    put("InternalEnergy", gas_internal_energy(
                        g["entropy"], g["density"], atime))
        cc.barrier()
    if me == 0:
        for b in blocks.values():
            b.flush()
    cc.barrier()
    return path


def save_snapshot_sharded(path: str, header: SnapshotHeader, fields: dict,
                          boxsize: float, atime: float) -> str:
    """Write a PART snapshot of every rank's rows as one type, PTYPE
    (sharded_io.py:30-96).  Collective.  fields: this rank's ipos [n,3]
    (int32 bits), vel, mass (0 = not written), pid and pid_hi."""
    m = fields["mass"]
    return save_snapshot_sharded_multi(
        path, header, dict(fields, ptype=torch.full(
            m.shape, PTYPE, dtype=torch.int8, device=m.device)),
        boxsize, atime)


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
