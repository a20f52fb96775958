"""Hierarchical named walltime timers (walltime.cpp analog).

Timers form a /slash/separated tree; each measure() charges the elapsed
time since the previous measure to the given name (the reference's
semantics).  Per-step and cumulative tables are written to cpu.txt in a
format close enough for tools/parsebench.py-style consumers.

A copy of shenqi_tpu/utils/walltime.py (no JAX in it) so that the PyTorch port
imports nothing of the JAX package; tests/test_torch_genic_io.py pins it.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Optional, TextIO


@dataclass
class Walltime:
    t_last: float = field(default_factory=time.perf_counter)
    step_acc: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    total_acc: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    step_number: int = 0
    t_begin: float = field(default_factory=time.perf_counter)

    def measure(self, name: str) -> float:
        """Charge time since the last measure to `name`."""
        now = time.perf_counter()
        dt = now - self.t_last
        self.t_last = now
        self.step_acc[name] += dt
        self.total_acc[name] += dt
        return dt

    def add(self, name: str, dt: float):
        self.step_acc[name] += dt
        self.total_acc[name] += dt

    def reset_step(self):
        self.step_acc = defaultdict(float)
        self.step_number += 1
        self.t_last = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_begin

    def summary(self, cumulative=True) -> str:
        acc = self.total_acc if cumulative else self.step_acc
        total = sum(acc.values()) or 1.0
        lines = []
        for name in sorted(acc):
            lines.append(f"{name:<30s} {acc[name]:10.3f}  "
                         f"{100 * acc[name] / total:5.1f}%")
        return "\n".join(lines)

    def write_cpu_log(self, f: TextIO, atime: float):
        """One step record in the REFERENCE cpu.txt format
        (walltime.cpp:185-205 header + indented timing tree), so
        tools/parsebench.py reads our logs unchanged."""
        f.write(f"Step {self.step_number}, Time: {atime:g}, "
                f"MPIs: 1 Threads: 1 Elapsed: {self.elapsed():g}\n")
        total = sum(self.step_acc.values()) or 1.0
        for name in sorted(self.step_acc):
            v = self.step_acc[name]
            f.write(f"    {name.lstrip('/'):<26s} {v:10.3f}  "
                    f"{100 * v / total:5.1f}%\n")
        f.flush()
