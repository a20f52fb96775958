"""The slice end to end: the port's DM TreePM `Simulation` against the JAX
package's, from the same state, and the kick-time synchronization
replay of tests/test_simulation.py with analytic-EH ICs."""

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
from shenqi_tpu_torch.core.timeline import dti_from_timebin
from shenqi_tpu_torch.cosmology.background import Cosmology as TCosmology
from shenqi_tpu_torch.simulation import Simulation as TSimulation
from shenqi_tpu_torch.utils.units import get_unitsystem as t_units

# one intra-op thread: the suite runs several pytest workers at once,
# and torch's default of one thread per core oversubscribes the host
torch.set_num_threads(1)

BOX = 64000.0
UNITS = (3.085678e21, 1.989e43, 1e5)
COSMO = dict(Omega0=0.3, OmegaLambda=0.7, OmegaBaryon=0.05,
             HubbleParam=0.7, CMBTemperature=2.7255, RadiationOn=1)


def _initial(kind, n_side):
    rng = np.random.RandomState(1)
    n = n_side ** 3
    if kind == "uniform":
        pos = rng.uniform(0, BOX, (n, 3))
    else:
        g = (np.arange(n_side) + 0.5) * BOX / n_side
        lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        c = rng.uniform(0, BOX, (4, 3))
        pull = c[rng.randint(0, 4, n)] - lat
        pull -= BOX * np.round(pull / BOX)
        pos = (lat + 0.6 * pull + rng.normal(0, BOX / 80, (n, 3))) % BOX
    vel = rng.normal(0, 5.0, (n, 3)).astype(np.float32)
    return pos, vel, np.full(n, 1.0, np.float32), \
        np.arange(1, n + 1, dtype=np.uint64)


def _pair(kind, n_side, nmesh, steps):
    """The JAX and the port simulation after `steps` steps from one
    state: the port's particles and window are the JAX ones, carried
    across with convert.py."""
    pos, vel, mass, ids = _initial(kind, n_side)
    jcp = JCosmology(**COSMO)
    jcp.init(0.1, j_units(*UNITS))
    tcp = TCosmology(**COSMO)
    tcp.init(0.1, t_units(*UNITS))
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
    jsim.run(max_steps=steps)
    tsim.run(max_steps=steps)
    return jsim, tsim


@pytest.mark.parametrize("kind,n_side,nmesh", [("uniform", 8, 16),
                                               ("clustered", 16, 32)])
def test_trajectory_matches_jax(kind, n_side, nmesh):
    """Two steps from one state.  Limits (__graft_entry__.py:194-206):
    positions within 2e-5 of the box; velocity outliers (|dv| > 2e-3
    median |v| + 1e-4) in under 5e-3 of the particles, since a
    knife-edge timebin flip kicks one particle with another factor;
    timebins identical except for those outliers."""
    jsim, tsim = _pair(kind, n_side, nmesh, 2)
    assert tsim.step_count == jsim.step_count == 2
    assert tsim.times.ti_current == jsim.times.ti_current
    assert tsim.times.ti_kick == jsim.times.ti_kick
    alive = np.asarray(jsim.particles.mask)
    ip1 = np.asarray(jsim.particles.ipos)[alive].astype(np.int64)
    ip2 = tsim.particles.ipos_u32()[alive].astype(np.int64)
    dpos = np.abs(ip1 - ip2)
    dpos = np.minimum(dpos, 2 ** 32 - dpos)
    assert np.max(dpos) < 2e-5 * 2 ** 32, np.max(dpos) / 2 ** 32
    v1 = np.asarray(jsim.particles.vel)[alive]
    v2 = tsim.particles.vel.numpy()[alive]
    vs = float(np.median(np.abs(v1))) + 1e-6
    outlier = np.max(np.abs(v1 - v2), axis=1) > 2e-3 * vs + 1e-4
    assert np.mean(outlier) < 5e-3, int(outlier.sum())
    tb1 = np.asarray(jsim.particles.timebin)[alive]
    tb2 = tsim.particles.timebin.numpy()[alive]
    assert np.all((tb1 == tb2) | outlier)
    assert np.isfinite(v2).all()


def test_kick_times_stay_synchronized():
    """tests/test_simulation.py:73 on the port, with analytic-EH ICs in
    place of a CLASS table: after any number of steps every occupied
    bin's kick time sits within half its bin period of the current
    time (Ti_kick advances dti/2 at both half-kicks).  The run ends at
    a = 0.16 instead of 0.14: with this spectrum (sigma8 = 0.8) that
    takes 16 steps, and the run has to reach its last sync point within
    max_steps for the invariant to hold at the end."""
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
        timeline=TTimeline.setup([0.16], 0.1, 0.16), atime=0.1,
        device="cpu")
    sim.run(max_steps=25)
    times = sim.times
    tb = sim.particles.timebin.numpy()[sim.particles.mask.numpy()]
    assert sim.step_count >= 10
    for b in np.unique(tb):
        lag = times.ti_current - times.ti_kick[int(b)]
        assert 0 <= lag <= dti_from_timebin(int(b)) // 2, (b, lag)
