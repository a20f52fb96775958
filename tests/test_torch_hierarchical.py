"""Hierarchical (split) gravity timesteps, the Gadget-4 momentum-conserving
active-source scheme (timestep.cpp:247-566), in the port against the JAX
package from one clustered state, and the momentum bound of
tests/test_hierarchical.py with analytic-EH ICs in place of its CLASS
table.

Limits: timebins, mintimebin/maxtimebin, pm_length, the kick times and
the count of active-source force calls per step identical (integers);
positions and velocities to the trajectory limits of
__graft_entry__.py:194-206 (positions within 2e-5 of the box, velocity
outliers in under 5e-3 of the particles); |sum m v| under 5e-3 of
sum m|v| per axis (tests/test_hierarchical.py:83).
"""

import numpy as np
import pytest
import torch

from chip_smoke import _sigma8
from shenqi_tpu.core.integrate import TimestepParams as JTsp
from shenqi_tpu.core.timeline import Timeline as JTimeline
from shenqi_tpu.cosmology.background import Cosmology as JCosmology
from shenqi_tpu.simulation import Simulation as JSimulation
from shenqi_tpu.utils.units import get_unitsystem as j_units

from shenqi_tpu_torch.convert import particles_from_numpy, window_from_numpy
from shenqi_tpu_torch.core.integrate import TimestepParams as TTsp
from shenqi_tpu_torch.core.timeline import Timeline as TTimeline
from shenqi_tpu_torch.cosmology.background import Cosmology as TCosmology
from shenqi_tpu_torch.simulation import Simulation as TSimulation
from shenqi_tpu_torch.utils.units import get_unitsystem as t_units

torch.set_num_threads(1)

BOX = 64000.0
UNITS = (3.085678e21, 1.989e43, 1e5)
COSMO = dict(Omega0=0.3, OmegaLambda=0.7, OmegaBaryon=0.05,
             HubbleParam=0.7, CMBTemperature=2.7255, RadiationOn=1)


def _clumps(n_side, seed=1):
    """Half the particles in three tight clumps (rms 1/200 of the box),
    the rest uniform, with the matter density's particle mass: the
    clumps' accelerations put their members several bins below the
    rest, so the hierarchy runs two to five levels."""
    rng = np.random.RandomState(seed)
    n = n_side ** 3
    pos = rng.uniform(0, BOX, (n, 3))
    k = n // 6
    for c in range(3):
        pos[c * k:(c + 1) * k] = (rng.uniform(0, BOX, 3)
                                  + rng.normal(0, BOX / 200, (k, 3))) % BOX
    vel = rng.normal(0, 5.0, (n, 3)).astype(np.float32)
    return pos, vel, np.arange(1, n + 1, dtype=np.uint64)


def _level_calls(monkeypatch, cls, log):
    real = cls._active_source_accel

    def counted(self, sel, n_act=None):
        log.append((self.step_count, n_act))
        return real(self, sel, n_act)
    monkeypatch.setattr(cls, "_active_source_accel", counted)


@pytest.fixture(scope="module")
def pair_steps():
    """Both packages, hierarchical, stepped one step at a time from one
    state (the port's particles and window carried across with
    convert.py); each step's integer bookkeeping and level calls."""
    mp = pytest.MonkeyPatch()
    n_side, nmesh, steps = 8, 16, 7
    pos, vel, ids = _clumps(n_side)
    jcp = JCosmology(**COSMO)
    jcp.init(0.1, j_units(*UNITS))
    tcp = TCosmology(**COSMO)
    tcp.init(0.1, t_units(*UNITS))
    mass = np.full(len(pos), jcp.Omega0 * jcp.RhoCrit * BOX ** 3 / len(pos),
                   np.float32)
    jsim = JSimulation.from_arrays(pos, vel, mass, ids, jcp, BOX, nmesh,
                                   JTimeline.setup([0.5], 0.1, 0.5), 0.1,
                                   tsp=JTsp())
    tsim = TSimulation.from_arrays(pos, vel, mass, ids, tcp, BOX, nmesh,
                                   TTimeline.setup([0.5], 0.1, 0.5), 0.1,
                                   tsp=TTsp(), device="cpu")
    jp = jsim.particles
    tsim.particles = particles_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in
         type(jp).__dataclass_fields__}, device="cpu")
    from shenqi_tpu.gravity.treepm import get_window_tables
    jw = get_window_tables(jsim.gravity)
    jsim.window_tables = jw
    tsim.window_tables = window_from_numpy(np.asarray(jw.cf),
                                           np.asarray(jw.cp),
                                           float(jw.xmax), device="cpu")
    jsim.hierarchical = tsim.hierarchical = True
    jcalls, tcalls = [], []
    _level_calls(mp, JSimulation, jcalls)
    _level_calls(mp, TSimulation, tcalls)
    rec = []
    try:
        for _ in range(steps):
            for sim in (jsim, tsim):
                sim.run(max_steps=1)
            t = []
            for sim in (jsim, tsim):
                tm = sim.times
                t.append(dict(
                    timebin=np.asarray(sim.particles.timebin).copy(),
                    mintimebin=tm.mintimebin, maxtimebin=tm.maxtimebin,
                    pm_length=tm.pm_length, ti_current=tm.ti_current,
                    ti_kick=list(tm.ti_kick)))
            rec.append(t)
    finally:
        mp.undo()
    return jsim, tsim, rec, jcalls, tcalls


def test_hierarchy_engages_and_bins_match(pair_steps):
    jsim, tsim, rec, jcalls, tcalls = pair_steps
    alive = np.asarray(jsim.particles.mask)
    for i, (j, t) in enumerate(rec):
        for key in ("mintimebin", "maxtimebin", "pm_length", "ti_current",
                    "ti_kick"):
            assert t[key] == j[key], (i, key)
        np.testing.assert_array_equal(t["timebin"][alive],
                                      j["timebin"][alive], err_msg=str(i))
    # at least two levels occupied at some step
    assert max(len(np.unique(j["timebin"][alive])) for j, _ in rec) >= 2
    # the same active-source calls per step, at the same target counts
    assert tcalls == jcalls
    per_step = np.bincount([s for s, _ in jcalls])
    assert per_step.max() >= 2


def test_hierarchical_trajectory_matches_jax(pair_steps):
    jsim, tsim, _, _, _ = pair_steps
    assert tsim.step_count == jsim.step_count
    alive = np.asarray(jsim.particles.mask)
    ip1 = np.asarray(jsim.particles.ipos)[alive].astype(np.int64)
    ip2 = tsim.particles.ipos_u32()[alive].astype(np.int64)
    d = np.abs(ip1 - ip2)
    d = np.minimum(d, 2 ** 32 - d)
    assert d.max() < 2e-5 * 2 ** 32, d.max() / 2 ** 32
    v1 = np.asarray(jsim.particles.vel)[alive]
    v2 = tsim.particles.vel.numpy()[alive]
    vs = float(np.median(np.abs(v1))) + 1e-6
    outlier = np.max(np.abs(v1 - v2), axis=1) > 2e-3 * vs + 1e-4
    assert np.mean(outlier) < 5e-3, int(outlier.sum())
    np.testing.assert_allclose(tsim.particles.grav_accel.numpy()[alive],
                               np.asarray(jsim.particles.grav_accel)[alive],
                               rtol=1e-3, atol=1e-4 * float(np.abs(
                                   np.asarray(jsim.particles.grav_accel)
                               ).max()))


def test_hierarchical_momentum_drift_bounded():
    """tests/test_hierarchical.py:76 on the port: 12^3 Zel'dovich ICs
    (analytic EH at sigma8 = 0.8, seed 181170, unitary amplitudes) from
    a = 0.1 to 0.13; the active-source kicks are pairwise-consistent
    per level, so the total momentum stays near zero."""
    from shenqi_tpu.cosmology.power import InputPower
    from shenqi_tpu.genic.ic import generate_dm_ics
    from shenqi_tpu.utils.units import default_units
    units = default_units()
    kw = dict(Omega0=0.288, OmegaLambda=0.712, OmegaBaryon=0.0472,
              HubbleParam=0.7, RadiationOn=1)
    jcp = JCosmology(**kw)
    jcp.init(TimeBegin=0.1, units=units)
    power = InputPower.analytic_eh(jcp, units.UnitLength_in_cm)
    power.norm = 0.8 / _sigma8(power) * jcp.growth_factor(0.1, 1.0)
    pos, vel, ids, mass = generate_dm_ics(
        12, BOX, seed=181170, power=power, CP=jcp, time_ic=0.1,
        unitary=True, use_peculiar=True)
    tcp = TCosmology(**kw)
    tcp.init(0.1, t_units(*UNITS))
    sim = TSimulation.from_arrays(
        pos, vel * 0.1, mass, ids, tcp, BOX, nmesh=24,
        timeline=TTimeline.setup([0.13], 0.1, 0.13), atime=0.1,
        device="cpu")
    sim.hierarchical = True
    sim.run(max_steps=200)
    assert sim.atime() == pytest.approx(0.13, rel=1e-6)
    msk = sim.particles.mask.numpy()
    m = sim.particles.mass.numpy()[msk].astype(np.float64)
    v = sim.particles.vel.numpy()[msk].astype(np.float64)
    ptot = (m[:, None] * v).sum(axis=0)
    prms = np.abs(m[:, None] * v).sum(axis=0)
    assert np.all(np.abs(ptot) < 5e-3 * prms + 1e-8)
    tb = sim.particles.timebin.numpy()[msk]
    assert tb.min() >= 1
    assert sim.times.mintimebin <= sim.times.maxtimebin
