"""Snapshot I/O: the petaio equivalent (property registry -> bigfile),
shenqi_tpu/io/snapshot.py for the port.

Disk layout identical to the reference (libgadget/petaio.cpp):
  <path>/Header            — attrs only (TotNumPart, MassTable, Time, ...)
  <path>/<ptype>/<Name>    — one bigfile block per registered property

Conversions happen at the I/O boundary exactly like the reference:
  * positions: uint32 fixed-point -> f8 internal length units
  * velocities: internal a^2 dx/dt -> peculiar (v = a dx/dt) when
    UsePeculiarVelocity, else stored raw (petaio.cpp:36-40,733-760)

The header and the reader are host numpy, the same code as the JAX
package's, so the files are byte-identical.  Every non-empty block is
written, as the JAX package writes it, by the threaded C++ writer
(io/native.py, native/bigfile_io.cpp), which gives the numpy writer's
bytes; empty blocks take the numpy writer.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from . import native
from .bigfile import BigFile
from ..core.particles import NTYPES, u32

@dataclass
class SnapshotHeader:
    TotNumPart: np.ndarray            # [6] u8
    MassTable: np.ndarray             # [6] f8
    Time: float
    BoxSize: float
    Omega0: float
    OmegaLambda: float
    OmegaBaryon: float = 0.0
    HubbleParam: float = 0.7
    UnitLength_in_cm: float = 3.085678e21
    UnitMass_in_g: float = 1.989e43
    UnitVelocity_in_cm_per_s: float = 1e5
    UsePeculiarVelocity: int = 1
    TimeIC: float = 1.0
    TotNumPartInit: Optional[np.ndarray] = None
    CMBTemperature: float = 2.7255
    OmegaFld: float = 0.0
    W0_Fld: float = -1.0
    WA_Fld: float = 0.0
    OmegaUR: float = 0.0
    OmegaK: float = 0.0
    class_radiation_convention: int = 1
    MNu: Optional[np.ndarray] = None
    extra: Dict[str, object] = field(default_factory=dict)

    def write(self, bf: BigFile):
        blk = bf.create_block("Header", "<i8", 0)
        a = blk.attrs
        a["TotNumPart"] = np.asarray(self.TotNumPart, dtype="<u8")
        tni = (self.TotNumPartInit if self.TotNumPartInit is not None
               else self.TotNumPart)
        a["TotNumPartInit"] = np.asarray(tni, dtype="<u8")
        a["MassTable"] = np.asarray(self.MassTable, dtype="<f8")
        a["Time"] = np.asarray([self.Time], dtype="<f8")
        a["TimeIC"] = np.asarray([self.TimeIC], dtype="<f8")
        a["BoxSize"] = np.asarray([self.BoxSize], dtype="<f8")
        a["Omega0"] = np.asarray([self.Omega0], dtype="<f8")
        a["OmegaLambda"] = np.asarray([self.OmegaLambda], dtype="<f8")
        a["OmegaBaryon"] = np.asarray([self.OmegaBaryon], dtype="<f8")
        a["OmegaFld"] = np.asarray([self.OmegaFld], dtype="<f8")
        a["W0_Fld"] = np.asarray([self.W0_Fld], dtype="<f8")
        a["WA_Fld"] = np.asarray([self.WA_Fld], dtype="<f8")
        a["OmegaUR"] = np.asarray([self.OmegaUR], dtype="<f8")
        a["OmegaK"] = np.asarray([self.OmegaK], dtype="<f8")
        a["class_radiation_convention"] = np.asarray(
            [self.class_radiation_convention], dtype="<i4")
        a["CMBTemperature"] = np.asarray([self.CMBTemperature],
                                         dtype="<f8")
        a["HubbleParam"] = np.asarray([self.HubbleParam], dtype="<f8")
        a["UnitLength_in_cm"] = np.asarray([self.UnitLength_in_cm],
                                           dtype="<f8")
        a["UnitMass_in_g"] = np.asarray([self.UnitMass_in_g], dtype="<f8")
        a["UnitVelocity_in_cm_per_s"] = np.asarray(
            [self.UnitVelocity_in_cm_per_s], dtype="<f8")
        a["UsePeculiarVelocity"] = np.asarray([self.UsePeculiarVelocity],
                                              dtype="<i4")
        if self.MNu is not None:
            a["MassiveNuLinRespOn"] = np.asarray([1], dtype="<i4")
        for k, v in self.extra.items():
            a[k] = v
        blk.flush()

    @classmethod
    def read(cls, bf: BigFile) -> "SnapshotHeader":
        a = bf["Header"].attrs

        def get(name, default=None):
            if name in a:
                v = a.raw(name)
                return v[0] if v.size == 1 else v
            return default

        hdr = cls(
            TotNumPart=np.asarray(a["TotNumPart"], dtype=np.uint64),
            MassTable=np.asarray(a["MassTable"], dtype=np.float64),
            Time=float(get("Time")),
            BoxSize=float(get("BoxSize")),
            Omega0=float(get("Omega0", 0.3)),
            OmegaLambda=float(get("OmegaLambda", 0.7)),
            OmegaBaryon=float(get("OmegaBaryon", 0.0)),
            HubbleParam=float(get("HubbleParam", 0.7)),
            UnitLength_in_cm=float(get("UnitLength_in_cm", 3.085678e21)),
            UnitMass_in_g=float(get("UnitMass_in_g", 1.989e43)),
            UnitVelocity_in_cm_per_s=float(
                get("UnitVelocity_in_cm_per_s", 1e5)),
            UsePeculiarVelocity=int(get("UsePeculiarVelocity", 0)),
            TimeIC=float(get("TimeIC", get("Time"))),
        )
        if "TotNumPartInit" in a:
            hdr.TotNumPartInit = np.asarray(a["TotNumPartInit"],
                                            dtype=np.uint64)
        hdr.OmegaFld = float(get("OmegaFld", 0.0))
        hdr.W0_Fld = float(get("W0_Fld", -1.0))
        hdr.WA_Fld = float(get("WA_Fld", 0.0))
        hdr.OmegaUR = float(get("OmegaUR", 0.0))
        hdr.CMBTemperature = float(get("CMBTemperature", 2.7255))
        hdr.class_radiation_convention = int(
            get("class_radiation_convention", 1))
        # keep every other attribute (Seed, FractionNuInParticles,
        # NumPartInGroupTotal, ...) readable via hdr.extra
        known = set(hdr.__dataclass_fields__) | {
            "TotNumPartInit", "OmegaFld", "W0_Fld", "WA_Fld",
            "OmegaUR", "CMBTemperature",
            "class_radiation_convention"}
        for name in a.keys():
            if name not in known:
                hdr.extra[name] = a.raw(name)
        return hdr


# on-disk dtype and width of each block the reference registers
_DTYPES = {
    "Position": ("<f8", 3), "Velocity": ("<f4", 3), "Mass": ("<f4", 1),
    "ID": ("<u8", 1), "Potential": ("<f4", 1),
    "SmoothingLength": ("<f4", 1), "Density": ("<f4", 1),
    "EgyWtDensity": ("<f4", 1), "InternalEnergy": ("<f4", 1),
    "ElectronAbundance": ("<f4", 1), "StarFormationRate": ("<f4", 1),
    "DelayTime": ("<f4", 1), "Metallicity": ("<f4", 1),
    "Metals": ("<f4", 9), "StarFormationTime": ("<f4", 1),
    "BirthDensity": ("<f4", 1), "Generation": ("|u1", 1),
    "BlackholeMass": ("<f4", 1), "BlackholeAccretionRate": ("<f4", 1),
    "BlackholeDensity": ("<f4", 1), "BlackholeMtrack": ("<f4", 1),
    "BlackholeSwallowID": ("<u8", 1), "BlackholeSwallowed": ("<i4", 1),
    "BlackholeMseed": ("<f4", 1), "BlackholeKineticFdbkEnergy":
    ("<f4", 1), "GroupID": ("<u4", 1), "TimeBinGravity": ("<u4", 1),
    "TimeBinHydro": ("<u4", 1),
    "NeutralHydrogenFraction": ("<f4", 1),
}


def write_snapshot(path: str, header: SnapshotHeader,
                   blocks: Dict[int, Dict[str, np.ndarray]],
                   nfile: int = 1, _numpy: bool = False):
    """Write a snapshot.  blocks[ptype][name] = array (host numpy).
    `_numpy` writes every block through the numpy writer: the tests'
    oracle of the C++ writer's bytes."""
    bf = BigFile(path, create=True)
    header.write(bf)
    for ptype, props in blocks.items():
        for name, data in props.items():
            data = np.asarray(data)
            dtype, nmemb = _DTYPES.get(
                name, (data.dtype.str,
                       1 if data.ndim == 1 else data.shape[1]))
            if len(data) and not _numpy:
                native.write_block(os.path.join(path, f"{ptype}/{name}"),
                                   dtype, data, nfile=nfile)
                continue
            blk = bf.create_block(f"{ptype}/{name}", dtype, len(data),
                                  nmemb=nmemb, nfile=nfile)
            blk.write(0, data)
            blk.flush()


def read_snapshot(path: str):
    """Read a snapshot: returns (header, blocks dict)."""
    bf = BigFile(path)
    header = SnapshotHeader.read(bf)
    blocks: Dict[int, Dict[str, np.ndarray]] = {}
    for name in bf.blocks():
        if "/" not in name:
            continue
        tname, _, bname = name.partition("/")
        if not tname.isdigit():
            continue
        ptype = int(tname)
        blk = bf[name]
        if blk.size == 0 and blk.dtype is None:
            continue
        blocks.setdefault(ptype, {})[bname] = blk.read()
    return header, blocks


def state_to_blocks(state, boxsize: float, atime: float,
                    use_peculiar: bool = True):
    """Per-type property dicts of a DM state (`state.particles`, the
    port's ParticleData) on the host.  The gas, star and black-hole
    blocks come with their state (ROADMAP A.7, A.8)."""
    p = state.particles
    mask = p.mask.cpu().numpy()
    ptype = p.ptype.cpu().numpy()
    # f8 positions straight from the integer representation
    pos = (u32(p.ipos).to(torch.float64) * (boxsize / 2 ** 32)
           ).cpu().numpy()
    vel = p.vel.cpu().numpy().astype(np.float32)
    if use_peculiar:
        vel = vel / atime
    mass = p.mass.cpu().numpy().astype(np.float32)
    ids = p.ids64()
    out: Dict[int, Dict[str, np.ndarray]] = {}
    for t in range(NTYPES):
        sel = mask & (ptype == t)
        if not sel.any():
            continue
        out[t] = {"Position": pos[sel], "Velocity": vel[sel],
                  "Mass": mass[sel], "ID": ids[sel]}
    return out
