"""Lightcone output (lightcone.cpp analog; shenqi_tpu/physics/lightcone.py,
host numpy).

Writes particles as they cross the observer's past lightcone: between
two drift times a0 < a1, a particle (in box replica r) crosses if its
comoving distance from the observer falls between the lightcone radii
R(a1) < d <= R(a0), with R(a) the comoving distance light travels from
a to a=1.  Box replicas tile space out to the maximum lightcone radius.

The positions come in as the uint32 fixed point (or its int32 bit
patterns, read as unsigned: ROADMAP C.1).  A replica whose box lies
wholly outside the shell (r_lo, r_hi] holds no crossing and is skipped
before its distances are computed; the rows and their order are those
of the full loop over the (2 nrep + 1)^3 replicas.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..core.particles import POS_SCALE


@dataclass
class Lightcone:
    CP: object
    boxsize: float
    unit_velocity: float
    observer: np.ndarray = None
    max_a: float = 1.0
    # collected crossings (host buffers)
    positions: List[np.ndarray] = field(default_factory=list)
    velocities: List[np.ndarray] = field(default_factory=list)
    ids: List[np.ndarray] = field(default_factory=list)
    atimes: List[np.ndarray] = field(default_factory=list)

    def __post_init__(self):
        if self.observer is None:
            self.observer = np.zeros(3)

    def radius(self, a: float) -> float:
        """Comoving distance from a to max_a (internal length units)."""
        if a >= self.max_a:
            return 0.0
        return self.CP.comoving_distance(a, self.max_a,
                                         self.unit_velocity)

    def nreplica(self, a: float) -> int:
        return int(np.ceil(self.radius(a) / self.boxsize))

    def compute(self, a0: float, a1: float, ipos, vel, ids64, mask):
        """Collect particles crossing the lightcone in (a0, a1]."""
        r_hi = self.radius(a0)   # larger radius (earlier time)
        r_lo = self.radius(a1)
        if r_hi <= 0:
            return 0
        ip = np.asarray(ipos)
        if ip.dtype == np.int32:
            ip = ip.view(np.uint32)
        pos = ip.astype(np.float64) * (self.boxsize / POS_SCALE)
        vel = np.asarray(vel)
        mask = np.asarray(mask)
        nrep = int(np.ceil(r_hi / self.boxsize))
        # a replica is skipped only when its box lies farther than r_hi
        # or nearer than r_lo by more than this margin
        tol = 1e-6 * self.boxsize
        obs = np.asarray(self.observer, np.float64)

        def gap_far(r, k):
            lo = r * self.boxsize - obs[k]
            hi = lo + self.boxsize
            return max(lo, 0.0, -hi), max(abs(lo), abs(hi))

        count = 0
        for rx in range(-nrep, nrep + 1):
            gx, fx = gap_far(rx, 0)
            if gx > r_hi + tol:
                continue
            for ry in range(-nrep, nrep + 1):
                gy, fy = gap_far(ry, 1)
                if np.hypot(gx, gy) > r_hi + tol:
                    continue
                for rz in range(-nrep, nrep + 1):
                    gz, fz = gap_far(rz, 2)
                    if (np.sqrt(gx * gx + gy * gy + gz * gz) > r_hi + tol
                            or np.sqrt(fx * fx + fy * fy + fz * fz)
                            <= r_lo - tol):
                        continue
                    off = np.array([rx, ry, rz]) * self.boxsize
                    d = np.linalg.norm(pos + off - self.observer,
                                       axis=1)
                    cross = mask & (d <= r_hi) & (d > r_lo)
                    if not cross.any():
                        continue
                    # fractional crossing time by interpolating radius
                    frac = np.where(r_hi > r_lo,
                                    (r_hi - d[cross]) / max(
                                        r_hi - r_lo, 1e-30), 0.0)
                    a_cross = a0 + frac * (a1 - a0)
                    self.positions.append(pos[cross] + off)
                    self.velocities.append(vel[cross])
                    self.ids.append(ids64[cross])
                    self.atimes.append(a_cross)
                    count += int(cross.sum())
        return count

    def save(self, path: str):
        """Write collected crossings as a bigfile."""
        from ..io.bigfile import BigFile
        bf = BigFile(path, create=True)
        pos = (np.concatenate(self.positions) if self.positions
               else np.zeros((0, 3)))
        vel = (np.concatenate(self.velocities) if self.velocities
               else np.zeros((0, 3), np.float32))
        ids = (np.concatenate(self.ids) if self.ids
               else np.zeros(0, np.uint64))
        ats = (np.concatenate(self.atimes) if self.atimes
               else np.zeros(0))
        n = len(pos)
        for name, data, dtype, nmemb in [
                ("1/Position", pos, "<f8", 3),
                ("1/Velocity", vel, "<f4", 3),
                ("1/ID", ids, "<u8", 1),
                ("1/Aemit", ats, "<f4", 1)]:
            blk = bf.create_block(name, dtype, n, nmemb=nmemb)
            if n:
                blk.write(0, np.asarray(data))
            blk.flush()
        return path
