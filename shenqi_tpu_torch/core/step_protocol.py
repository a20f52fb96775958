"""The KDK step protocol (shenqi_tpu/core/step_protocol.py:46-143).

The reference has exactly one main loop (libgadget/run.cpp:331-822);
this module owns its stage order and the kick-time bookkeeping:

    drift -> forces -> first half-kick -> FIRST kick-time advance
    (run.cpp:578) -> PM half-kick -> PM-cadence callbacks -> sources
    -> outputs -> find-timesteps -> second half-kick -> SECOND
    kick-time advance (run.cpp:809) -> PM half-kick

The simulation provides the stages through the adapters
proto_drift, proto_forces, proto_sources, proto_snapshot,
proto_pre_timestep and proto_bad_timestep, plus `times`, `timeline`,
`step_count`, `resumed`, `hierarchical`, `snapshots`, `on_pm_step`,
`on_step`, `_wt`, `_apply_half_kick`, `_apply_pm_half_kick` and
`_find_timesteps`.  The human-control (HCI) branch of the JAX package
is not part of the port: a simulation whose `hci` is set is refused.
"""

from __future__ import annotations

from .integrate import find_next_kick, update_kick_times


def run_protocol(s, max_steps: int = 10 ** 9):
    """Evolve `s` until the last sync point (or max_steps)."""
    if getattr(s, "hci", None) is not None:
        raise NotImplementedError("the HCI branch is not ported")
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
        if sp is not None and sp.write_snapshot and not (first
                                                         and s.resumed):
            s.proto_snapshot(s.atime())
            s.snapshots.append(s.atime())
            s._wt("Snapshot")

        if s.timeline.find_next_sync_point(times.ti_current) is None:
            break

        s.proto_pre_timestep()
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
