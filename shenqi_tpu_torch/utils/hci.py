"""Human control interface (hci.cpp analog).

Polls the output directory for control files on PM steps:
  stop        — checkpoint and stop
  checkpoint  — checkpoint and continue
  terminate   — stop without checkpoint
Also predicts whether another PM step fits in the wall-clock budget
(TimeLimitCPU) and auto-checkpoints every AutoCheckpointTime seconds.

A copy of shenqi_tpu/utils/hci.py (no JAX in it) so that the PyTorch port
imports nothing of the JAX package; tests/test_torch_genic_io.py pins it.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Optional

HCI_NO_ACTION = 0
HCI_STOP = 1
HCI_CHECKPOINT = 2
HCI_TERMINATE = 3
HCI_TIMEOUT = 4
HCI_AUTO_CHECKPOINT = 5


@dataclass
class HCI:
    output_dir: str
    time_limit_cpu: float = 86400.0
    auto_checkpoint_time: float = 0.0
    _t_begin: float = field(default_factory=time.monotonic)
    _t_last_query: float = field(default_factory=time.monotonic)
    _t_last_checkpoint: float = field(default_factory=time.monotonic)
    _longest_gap: float = 0.0
    _now_override: Optional[float] = None   # fake clock for tests

    def _now(self) -> float:
        return (self._now_override if self._now_override is not None
                else time.monotonic())

    def override_now(self, t: Optional[float]):
        self._now_override = t

    def _consume(self, name: str) -> bool:
        path = os.path.join(self.output_dir, name)
        if os.path.exists(path):
            try:
                os.remove(path)
            except OSError:
                pass
            return True
        return False

    def query(self) -> int:
        """Call on PM steps; returns the requested action.

        Priority order and semantics follow hci_query
        (libgadget/hci.cpp:131-198): timeout first (stop +
        checkpoint), then `checkpoint` (checkpoint and CONTINUE),
        then `stop` (checkpoint and stop), then `terminate` (stop
        without checkpoint), then the auto-checkpoint clock."""
        now = self._now()
        gap = now - self._t_last_query
        self._longest_gap = max(self._longest_gap, gap)
        self._t_last_query = now

        # wall-clock timeout prediction (hci.cpp:95-115): will the
        # next query likely overrun TimeLimitCPU?  0.95 is the
        # reference's safety tolerance.
        elapsed = now - self._t_begin
        if (elapsed + self._longest_gap
                >= self.time_limit_cpu * 0.95):
            return HCI_TIMEOUT
        if self._consume("checkpoint"):
            self._t_last_checkpoint = now
            return HCI_CHECKPOINT
        if self._consume("stop"):
            return HCI_STOP
        if self._consume("terminate"):
            return HCI_TERMINATE
        if (self.auto_checkpoint_time > 0
                and now - self._t_last_checkpoint
                >= self.auto_checkpoint_time):
            self._t_last_checkpoint = now
            return HCI_AUTO_CHECKPOINT
        return HCI_NO_ACTION


def wants_checkpoint(action: int) -> bool:
    """Does this action write a snapshot (hci.cpp write_snapshot)?"""
    return action in (HCI_STOP, HCI_CHECKPOINT, HCI_TIMEOUT,
                      HCI_AUTO_CHECKPOINT)


def wants_break(action: int) -> bool:
    """Does this action end the main loop (hci_query return 1)?"""
    return action in (HCI_STOP, HCI_TIMEOUT, HCI_TERMINATE)
