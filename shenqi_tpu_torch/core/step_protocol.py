"""The KDK step protocol (shenqi_tpu/core/step_protocol.py:46-143).

The reference has exactly one main loop (libgadget/run.cpp:331-822);
this module owns its stage order and the kick-time bookkeeping:

    drift -> HCI query -> forces -> first half-kick -> FIRST kick-time
    advance (run.cpp:578) -> PM half-kick -> PM-cadence callbacks ->
    sources -> outputs -> HCI checkpoint/stop -> find-timesteps ->
    second half-kick -> SECOND kick-time advance (run.cpp:809) -> PM
    half-kick

The simulation provides the stages through the adapters
proto_drift, proto_forces, proto_sources, proto_snapshot,
proto_checkpoint, proto_pre_timestep and proto_bad_timestep, plus
`times`, `timeline`, `hci`, `step_count`, `resumed`, `hierarchical`,
`snapshots`, `on_pm_step`, `on_step`, `on_snapshot`, `on_checkpoint`,
`_wt`, `_apply_half_kick`, `_apply_pm_half_kick`, `_find_timesteps`
and `_hier_first_half`.
"""

from __future__ import annotations

from .integrate import find_next_kick, update_kick_times
from ..utils import hci as hcimod


def run_protocol(s, max_steps: int = 10 ** 9):
    """Evolve `s` until the last sync point (or max_steps)."""
    first = s.step_count == 0
    while max_steps > 0:
        max_steps -= 1
        times = s.times
        s._wt("Misc")
        if not first:
            ti_next = find_next_kick(times.ti_current, times.mintimebin)
            ti_next = min(ti_next, times.pm_start + times.pm_length)
            s.proto_drift(ti_next)
            s._wt("Drift")
        is_pm = times.is_pm()

        hci_action = 0
        if is_pm and s.hci is not None:
            # query HCI requests only on PM steps, where kicks and
            # drifts are synced (run.cpp:406-413)
            hci_action = s.hci.query()
            if hci_action == hcimod.HCI_TERMINATE:
                # human-triggered termination: no checkpoint
                s.hci_exit = "terminate"
                break

        # forces: PM + short range, in the loop's own order
        # (run.cpp:426-505)
        s.proto_forces(is_pm, first)

        if not first:
            s._apply_half_kick(skip_grav=s.hierarchical)
        # FIRST kick-time advance (run.cpp:578): each active bin
        # advances dti/2 per half-kick
        update_kick_times(times)
        if is_pm and not first:
            s._apply_pm_half_kick()

        # FOF-cadence physics on PM steps (run.cpp:637-660)
        if is_pm and not first and s.on_pm_step is not None:
            s.on_pm_step(s)

        # Strang-split source terms after the kick (run.cpp:604-681)
        s.proto_sources(is_pm, first)

        # sync-point outputs (run.cpp:688-712)
        sp = s.timeline.find_current_sync_point(times.ti_current)
        planned = (sp is not None and sp.write_snapshot
                   and not (first and s.resumed))
        if planned:
            s.proto_snapshot(s.atime())
            s.snapshots.append(s.atime())
            s._wt("Snapshot")

        # HCI-requested checkpoint/stop (run.cpp:700-761): an
        # unplanned dump unless this step just wrote a planned one
        if hci_action:
            if hcimod.wants_checkpoint(hci_action) and not planned:
                cb = s.on_checkpoint or s.on_snapshot
                if cb:
                    s.proto_checkpoint(cb, s.atime())
                s.snapshots.append(s.atime())
                s._wt("Snapshot")
            if hcimod.wants_break(hci_action):
                s.hci_exit = {
                    hcimod.HCI_STOP: "stop",
                    hcimod.HCI_TIMEOUT: "timeout",
                }.get(hci_action, "terminate")
                break

        if s.timeline.find_next_sync_point(times.ti_current) is None:
            break

        s.proto_pre_timestep()
        if s.hierarchical:
            bad = s._hier_first_half(first_step=first)
        else:
            bad = s._find_timesteps(first_step=first)
        s._wt("Timeline")
        if bad:
            s.proto_bad_timestep(bad)
        s._apply_half_kick(skip_grav=s.hierarchical)
        # SECOND kick-time advance (run.cpp:809): without it Ti_kick
        # lags ti_current by half the elapsed time
        update_kick_times(times)
        if is_pm:
            s._apply_pm_half_kick()
        s.step_count += 1
        first = False
        if s.on_step:
            s.on_step(s)
    return s
