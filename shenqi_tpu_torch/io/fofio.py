"""FOF halo catalog output (fofpetaio.cpp analog), shenqi_tpu/io/fofio.py
for the port.

Writes the PIG_NNN bigfile with the reference's group-table block names
(FOFGroups/GroupID, Mass, MassCenterPosition, LengthByType, ...), so the
reference's analysis tools read our catalogs directly.  Host numpy, the
same code as the JAX package's; the member particles come from the
port's ParticleData.
"""

from __future__ import annotations

import numpy as np

from .bigfile import BigFile
from .snapshot import SnapshotHeader


def save_fof(path: str, groups, header: SnapshotHeader, atime: float):
    bf = BigFile(path, create=True)
    # header block with group counts
    hdr = SnapshotHeader(
        TotNumPart=header.TotNumPart, MassTable=header.MassTable,
        Time=atime, BoxSize=header.BoxSize, Omega0=header.Omega0,
        OmegaLambda=header.OmegaLambda, OmegaBaryon=header.OmegaBaryon,
        HubbleParam=header.HubbleParam,
        UnitLength_in_cm=header.UnitLength_in_cm,
        UnitMass_in_g=header.UnitMass_in_g,
        UnitVelocity_in_cm_per_s=header.UnitVelocity_in_cm_per_s,
        UsePeculiarVelocity=header.UsePeculiarVelocity,
        TimeIC=header.TimeIC)
    hdr.extra["NTotal"] = np.array([groups.ngroups], dtype="<u8")
    # total grouped particles per type (fofpetaio.cpp writes this for
    # the PIG header; star-small check_results.py reads it)
    hdr.extra["NumPartInGroupTotal"] = np.asarray(
        groups.length_by_type, dtype="<u8").sum(axis=0)
    hdr.write(bf)

    G = groups.ngroups

    def wblock(name, data, dtype, nmemb=1):
        blk = bf.create_block(f"FOFGroups/{name}", dtype, G, nmemb=nmemb)
        if G:
            blk.write(0, np.asarray(data))
        blk.flush()

    wblock("GroupID", np.arange(1, G + 1, dtype="<u4"), "<u4")
    wblock("Mass", groups.masses.astype("<f4"), "<f4")
    wblock("MassCenterPosition", groups.cm.astype("<f8"), "<f8", 3)
    wblock("MassCenterVelocity",
           (groups.vel / atime).astype("<f4"), "<f4", 3)
    wblock("FirstPos", groups.first_pos.astype("<f4"), "<f4", 3)
    wblock("LengthByType", groups.length_by_type.astype("<u4"), "<u4", 6)
    wblock("MassByType", groups.mass_by_type.astype("<f4"), "<f4", 6)
    if groups.sfr is not None:
        wblock("StarFormationRate", groups.sfr.astype("<f4"), "<f4")
    return path


def save_fof_particles(bf_path: str, groups, particles,
                       boxsize: float = None, atime: float = 1.0):
    """Append member-particle blocks to a PIG catalog
    (fofpetaio.cpp fof_save_particles): particles sorted so each
    group's members are contiguous, ordered by group number.
    `particles` is the port's ParticleData."""
    from ..core.particles import POS_SCALE, u32
    gid = np.asarray(groups.group_id)
    sel = gid > 0
    order = np.argsort(gid[sel], kind="stable")
    idx = np.nonzero(sel)[0][order]
    bf = BigFile(bf_path, create=True)
    pos = (u32(particles.ipos).double().cpu().numpy()
           * (boxsize / POS_SCALE))[idx]
    vel = (particles.vel.cpu().numpy().astype(np.float32) / atime)[idx]
    mass = particles.mass.cpu().numpy().astype(np.float32)[idx]
    ptype_all = particles.ptype.cpu().numpy()
    ptype = ptype_all[idx]
    ids = particles.ids64()[idx]
    grnr = gid[idx].astype("<u4")
    # write all types present among LIVE particles (empty blocks for
    # types with no grouped members, like the reference's collective IO)
    all_types = np.unique(ptype_all[particles.mask.cpu().numpy()])
    for t in all_types:
        tsel = ptype == t
        n = int(tsel.sum())
        for name, data, dtype, nmemb in [
                ("Position", pos[tsel], "<f8", 3),
                ("Velocity", vel[tsel], "<f4", 3),
                ("Mass", mass[tsel], "<f4", 1),
                ("ID", ids[tsel], "<u8", 1),
                ("GroupID", grnr[tsel], "<u4", 1)]:
            blk = bf.create_block(f"{int(t)}/{name}", dtype, n,
                                  nmemb=nmemb)
            if n:
                blk.write(0, data)
            blk.flush()
    return bf_path


def load_fof(path: str):
    """Read a PIG catalog (ours or the reference's)."""
    bf = BigFile(path)
    out = {}
    for name in ["GroupID", "Mass", "MassCenterPosition",
                 "LengthByType", "MassByType", "FirstPos",
                 "StarFormationRate", "MassCenterVelocity"]:
        key = f"FOFGroups/{name}"
        if key in bf:
            out[name] = bf[key].read()
    return out
