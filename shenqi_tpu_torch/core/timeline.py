"""Integer timeline: power-of-two timebins between output sync points.

Semantics match the reference timeline manager (libgadget/timebinmgr.h):
the simulated span is a sequence of sync points (snapshot times); each
adjacent pair is subdivided into TIMEBASE = 2^TIMEBINS integer ticks, so
loga is piecewise-linear in the integer time `ti`.  Timebin n corresponds
to a step of 2^n ticks.

All of this is host-side orchestration (plain Python ints — arbitrary
precision, no int64 overflow concerns); only per-particle *bins* and
precomputed dt factors ever reach the device.

A copy of shenqi_tpu/core/timeline.py (no JAX in it) so that the PyTorch port
imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

TIMEBINS = 46
TIMEBASE = 1 << TIMEBINS
MAXSNAPSHOTS = 1 << (62 - TIMEBINS)


def dti_from_timebin(bin: int) -> int:
    bin = int(bin)   # numpy int32 shifts overflow past bin 31
    return (1 << bin) if bin > 0 else 0


def round_down_power_of_two(dti: int) -> int:
    """Largest power of two <= dti (max TIMEBASE); 0 for dti <= 0."""
    if dti <= 0:
        return 0
    if dti >= TIMEBASE:
        return TIMEBASE
    return 1 << (dti.bit_length() - 1)


def timebin_from_dti(dti: int) -> int:
    """Largest bin with 2^bin <= dti (0 if dti < 1)."""
    if dti <= 0:
        return 0
    return min(dti.bit_length() - 1, TIMEBINS)


@dataclass
class SyncPoint:
    loga: float
    write_snapshot: bool = False
    write_fof: bool = False
    calc_uvbg: bool = False
    write_plane: bool = False
    plane_snapnum: int = -1


@dataclass
class Timeline:
    """The sync-point table + integer<->loga conversions."""

    syncpoints: List[SyncPoint] = field(default_factory=list)

    @classmethod
    def setup(cls, output_times: List[float], TimeIC: float, TimeMax: float,
              no_snapshot_until_time: float = 0.0,
              snapshot_with_fof: bool = False) -> "Timeline":
        """Build the sync point table: TimeIC, each output time, TimeMax.

        Output times outside (TimeIC, TimeMax] are dropped; TimeIC and
        TimeMax always present; snapshots written at requested outputs
        (unless before no_snapshot_until_time).
        """
        times = sorted(set(output_times) | {TimeIC, TimeMax})
        times = [t for t in times if TimeIC <= t <= TimeMax]
        if not times:
            # resume from the final snapshot: float rounding can put
            # the restored Time a hair past TimeMax — degenerate
            # one-point timeline, the run loop exits immediately
            times = [max(TimeIC, TimeMax)]
        sps = []
        for t in times:
            write = (t in output_times) and (t > no_snapshot_until_time)
            sps.append(SyncPoint(loga=float(np.log(t)),
                                 write_snapshot=write,
                                 write_fof=write and snapshot_with_fof))
        if len(sps) > MAXSNAPSHOTS:
            raise ValueError(f"too many sync points ({len(sps)})")
        return cls(syncpoints=sps)

    @property
    def nsync(self) -> int:
        return len(self.syncpoints)

    def find_next_sync_point(self, ti: int) -> Optional[SyncPoint]:
        for i in range(self.nsync):
            if (i << TIMEBINS) > ti:
                return self.syncpoints[i]
        return None

    def find_next_ti_sync(self, ti: int) -> int:
        return ((ti >> TIMEBINS) + 1) << TIMEBINS

    def find_current_sync_point(self, ti: int) -> Optional[SyncPoint]:
        if ti & (TIMEBASE - 1):
            return None
        i = ti >> TIMEBINS
        if 0 <= i < self.nsync:
            return self.syncpoints[i]
        return None

    def dloga_interval_ti(self, ti: int) -> float:
        lastsnap = ti >> TIMEBINS
        if lastsnap >= self.nsync - 1:
            return 0.0
        return (self.syncpoints[lastsnap + 1].loga
                - self.syncpoints[lastsnap].loga) / TIMEBASE

    def loga_from_ti(self, ti: int) -> float:
        lastsnap = min(ti >> TIMEBINS, self.nsync - 1)
        last = self.syncpoints[lastsnap].loga
        if lastsnap >= self.nsync - 1:
            return last               # at/after the final sync point
        dti = ti & (TIMEBASE - 1)
        return last + dti * self.dloga_interval_ti(ti)

    def atime_from_ti(self, ti: int) -> float:
        return float(np.exp(self.loga_from_ti(ti)))

    def ti_from_loga(self, loga: float) -> int:
        if self.nsync < 2:
            # degenerate timeline (e.g. resuming from the final
            # snapshot): everything lives at the last tick
            return 0
        i = 1
        while i < self.nsync - 1 and self.syncpoints[i].loga <= loga:
            i += 1
        dloga_seg = (self.syncpoints[i].loga
                     - self.syncpoints[i - 1].loga) / TIMEBASE
        ti = (i - 1) << TIMEBINS
        ti += int((loga - self.syncpoints[i - 1].loga) / dloga_seg)
        return ti

    def dti_from_dloga(self, dloga: float, ti_current: int) -> int:
        loga = self.loga_from_ti(ti_current)
        lastsnap = min(ti_current >> TIMEBINS, self.nsync - 2)
        if (lastsnap < self.nsync - 2
                and self.syncpoints[lastsnap + 1].loga <= dloga + loga):
            lastsnap += 1
        dloga_seg = (self.syncpoints[lastsnap + 1].loga
                     - self.syncpoints[lastsnap].loga) / TIMEBASE
        tip = (lastsnap << TIMEBINS) + int(
            (dloga + loga - self.syncpoints[lastsnap].loga) / dloga_seg)
        return tip - ti_current

    def dloga_from_dti(self, dti: int, ti_current: int) -> float:
        sign = 1
        if dti < 0:
            dti, sign = -dti, -1
        dti = min(dti, TIMEBASE)
        return self.dloga_interval_ti(ti_current) * dti * sign

    def get_dloga_for_bin(self, timebin: int, ti_current: int) -> float:
        return dti_from_timebin(timebin) * self.dloga_interval_ti(ti_current)

    # ---- exact factors (delegate to cosmology; ti -> a conversion here) ----
    def exact_drift_factor(self, CP, ti0: int, ti1: int) -> float:
        if ti0 == ti1:
            return 0.0
        return CP.exact_drift_factor(self.atime_from_ti(ti0),
                                     self.atime_from_ti(ti1))

    def exact_gravkick_factor(self, CP, ti0: int, ti1: int) -> float:
        if ti0 == ti1:
            return 0.0
        return CP.exact_gravkick_factor(self.atime_from_ti(ti0),
                                        self.atime_from_ti(ti1))

    def exact_hydrokick_factor(self, CP, ti0: int, ti1: int) -> float:
        if ti0 == ti1:
            return 0.0
        return CP.exact_hydrokick_factor(self.atime_from_ti(ti0),
                                         self.atime_from_ti(ti1))
