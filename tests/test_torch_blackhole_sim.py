"""The black-hole stage of the port's GasPhysics (`seed_bh`,
`blackhole_step`) against the JAX package's on the CPU.

  * From one state, converted across exactly (convert.particles_from_numpy,
    gas_state_from_numpy, bh_params_from, key_from_numpy):
    tests/test_blackhole_sim.py:128's state (6^3 gas + 6^3 DM at a = 0.5,
    one BH seeded at row 0), a state where swallowing and a merger fire
    (three BHs seeded on neighbouring rows, their subgrid masses several
    gas masses above the dynamic ones) and a state of 70 BHs (past the
    device census's 64, the host path).  Dynamical friction on
    (BH_DynFrictionMethod 1, DM and stars), BH_DRAG 1.  Limits: the BH
    rows, ptypes, swallowed rows, masks and merger survivors identical;
    bh_mass, bh_mdot, entropy, mass and velocity within 1e-5 of each
    field's largest value; the key chains at the same state after.
  * One whole gas step with a BH row in the state:
    tests/test_torch_subgrid.py's configuration (cooling, star formation,
    ofjt10 winds, metal return, hierarchical gravity), a BH seeded on the
    densest clump row of both packages after the first step, then one
    step of each.  Limits: those of test_torch_subgrid.py for the
    trajectory (positions within 2e-5 of the box, velocity outliers over
    1e-3 relative under 5e-3 of the rows), the BH's bh_mass and bh_mdot
    within 1e-3 relative, the BH rows and star rows identical, the key
    chains at the same state.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import test_torch_subgrid as S
from shenqi_tpu.core.particles import BH
from shenqi_tpu.core.timeline import Timeline as JTimeline
from shenqi_tpu.cosmology import Cosmology as JCosmology
from shenqi_tpu.physics.blackhole import BHParams as JBHParams
from shenqi_tpu.simulation import Simulation as JSimulation
from shenqi_tpu.simulation_gas import GasPhysics as JGasPhysics
from shenqi_tpu.utils.units import default_units as j_units
from shenqi_tpu_torch.convert import (bh_params_from, gas_state_from_numpy,
                                      key_from_numpy, particles_from_numpy)
from shenqi_tpu_torch.core.timeline import Timeline as TTimeline
from shenqi_tpu_torch.cosmology.background import Cosmology as TCosmology
from shenqi_tpu_torch.simulation import Simulation as TSimulation
from shenqi_tpu_torch.simulation_gas import GasPhysics as TGasPhysics
from shenqi_tpu_torch.utils.units import default_units as t_units

torch.set_num_threads(2)
BOX = 10000.0
N = 6
A_IC = 0.5


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(a, b, rel=1e-5, what=""):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = max(np.abs(a).max(), 1e-300)
    assert np.abs(a - b).max() <= rel * scale, (what, np.abs(a - b).max()
                                                / scale)


def _state(seed_mass_fac, n_jitter=0.1):
    """tests/test_blackhole_sim.py:128-172's state in both packages: the
    JAX one built as there, the port's converted from it."""
    cosmo = dict(Omega0=0.3, OmegaLambda=0.7, OmegaBaryon=0.05,
                 HubbleParam=0.7, RadiationOn=0, CMBTemperature=0.0)
    jcp = JCosmology(**cosmo)
    jcp.init(TimeBegin=A_IC, units=j_units())
    tcp = TCosmology(**cosmo)
    tcp.init(A_IC, t_units())
    rng = np.random.RandomState(2)
    ng = N ** 3
    grid = (np.arange(N) + 0.5) * (BOX / N)
    X, Y, Z = np.meshgrid(grid, grid, grid, indexing="ij")
    gpos = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1)
    gpos += rng.uniform(-n_jitter, n_jitter, gpos.shape) * (BOX / N)
    m_gas = jcp.OmegaBaryon * jcp.RhoCrit * BOX ** 3 / ng
    sp = [(0, gpos % BOX, rng.normal(0, 20, (ng, 3)).astype(np.float32),
           m_gas, np.arange(1, ng + 1)),
          (1, (gpos + 0.5 * BOX / N) % BOX,
           rng.normal(0, 20, (ng, 3)).astype(np.float32),
           (jcp.Omega0 - jcp.OmegaBaryon) * jcp.RhoCrit * BOX ** 3 / ng,
           np.arange(ng + 1, 2 * ng + 1))]
    jpar = JBHParams(SeedBlackHoleMass=seed_mass_fac * m_gas,
                     HubbleParam=0.7)
    jgp = JGasPhysics(bh_on=True, bhpar=jpar, bh_dynfric_on=True)
    tgp = TGasPhysics(bh_on=True, bhpar=bh_params_from(jpar),
                      bh_dynfric_on=True)
    js = JSimulation.from_species(
        sp, jcp, BOX, nmesh=2 * N, timeline=JTimeline.setup([0.6], A_IC,
                                                             0.6),
        atime=A_IC, gas_u0=10.0, gas_physics=jgp)
    ts = TSimulation.from_species(
        sp, tcp, BOX, 2 * N, TTimeline.setup([0.6], A_IC, 0.6), A_IC,
        gas_u0=10.0, gas_physics=tgp, device="cpu")
    mean_rho = m_gas * ng / BOX ** 3
    js.gas = dataclasses.replace(
        js.gas, density=jnp.asarray(rng.uniform(0.5, 2, ng) * mean_rho,
                                    jnp.float32),
        entropy=jnp.asarray(rng.uniform(30, 70, ng), jnp.float32))
    hsml = np.array(js.particles.hsml)
    hsml[:ng] = 1.5 * BOX / N
    js.particles = dataclasses.replace(js.particles, hsml=jnp.asarray(hsml))
    _carry(js, ts)
    return js, ts, m_gas


def _carry(js, ts):
    jp = js.particles
    ts.particles = particles_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in type(jp).__dataclass_fields__},
        device="cpu")
    ts.gas = gas_state_from_numpy(
        {f: (None if getattr(js.gas, f) is None else
             np.asarray(getattr(js.gas, f)))
         for f in type(js.gas).__dataclass_fields__}, device="cpu")
    ts.gas.ngas = js.gas.ngas
    ts.gas_physics.rng_key = key_from_numpy(js.gas_physics.rng_key)


def _bh_step(js, ts, rows, dtime):
    js.gas = js.gas_physics.seed_bh(js, js.gas, rows)
    ts.gas = ts.gas_physics.seed_bh(ts, ts.gas, rows)
    np.testing.assert_array_equal(_np(ts.particles.ptype),
                                  np.asarray(js.particles.ptype))
    np.testing.assert_array_equal(_np(ts.gas.bh_mass),
                                  np.asarray(js.gas.bh_mass))
    before = {"entropy": np.asarray(js.gas.entropy).copy(),
              "mass": np.asarray(js.particles.mass).copy()}
    js.gas = js.gas_physics.blackhole_step(js, js.gas, dtime)
    ts.gas = ts.gas_physics.blackhole_step(ts, ts.gas, dtime)
    return before


def _compare(js, ts):
    jp, tp = js.particles, ts.particles
    for f in ("mask", "ptype"):
        np.testing.assert_array_equal(_np(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)), f)
    for f in ("bh_mass", "bh_mdot", "entropy"):
        _close(getattr(js.gas, f), _np(getattr(ts.gas, f)), what=f)
    _close(jp.mass, _np(tp.mass), what="mass")
    _close(jp.vel, _np(tp.vel), what="vel")
    assert key_from_numpy(js.gas_physics.rng_key) == \
        ts.gas_physics.rng_key


def test_one_bh_step():
    """test_blackhole_sim.py:128's case: accretion grows the subgrid mass,
    feedback heats the gas around it, the mass is conserved."""
    js, ts, m_gas = _state(0.5)
    before = _bh_step(js, ts, [0], 0.01)
    _compare(js, ts)
    ng = N ** 3
    assert float(ts.gas.bh_mdot[0]) > 0
    assert float(ts.gas.bh_mass[0]) > 0.5 * m_gas
    dent = ts.gas.entropy.numpy() - before["entropy"]
    gas = (ts.particles.ptype.numpy()[:ng] == 0)
    assert (dent[gas] >= 0).all() and dent[gas].max() > 0
    assert ts.particles.mass.double().sum().item() == pytest.approx(
        before["mass"].astype(np.float64).sum(), rel=1e-6)


def test_swallow_and_merger_step():
    """Three BHs on neighbouring rows (0, 1, 6: within each other's
    kernels, their relative speed below the gas sound speed), the subgrid
    masses six gas masses above the dynamic ones: gas rows are swallowed
    and the BHs merge onto the smallest ID."""
    js, ts, m_gas = _state(7.0, n_jitter=0.02)
    # slow BHs: the merger's boundness proxy compares their relative speed
    # with the local sound speed
    for s in (js, ts):
        vel = _np(s.particles.vel).copy()
        vel[[0, 1, 6]] = 0.0
        s.particles = (dataclasses.replace(s.particles,
                                           vel=jnp.asarray(vel))
                       if s is js else s.particles.replace(
                           vel=torch.from_numpy(vel)))
    before = _bh_step(js, ts, [0, 1, 6], 0.002)
    _compare(js, ts)
    tp = ts.particles
    gone = ~tp.mask.numpy()
    assert gone.sum() >= 3
    bh_alive = np.nonzero(tp.mask.numpy() & (tp.ptype.numpy() == BH))[0]
    assert list(bh_alive) == [0]
    # the merged and swallowed mass is on the survivor
    assert tp.mass.double().sum().item() == pytest.approx(
        before["mass"].astype(np.float64).sum(), rel=1e-6)
    assert ts.gas_physics.last_bh_stats["mergers"] == 2
    assert ts.gas_physics.last_bh_stats["swallowed"] >= 1


def test_many_bhs_host_census():
    """70 BHs: past the device census's 64 rows, the host path; every BH
    steps as in the JAX package."""
    js, ts, _ = _state(0.5)
    rows = list(range(0, 210, 3))
    assert len(rows) == 70
    _bh_step(js, ts, rows, 0.01)
    _compare(js, ts)
    assert ts.gas_physics.last_bh_stats["nbh"] == 70


@pytest.fixture(scope="module")
def whole_step():
    """test_torch_subgrid.py's pair with black holes on: a first step in
    both, a BH seeded on the densest clump gas row, then one more step."""
    js, ts = S._pair()
    for gp, mk in ((js.gas_physics, JBHParams), (ts.gas_physics, None)):
        gp.bh_on = True
        par = JBHParams(HubbleParam=0.7)
        gp.bhpar = par if mk else bh_params_from(par)
        gp.bh_dynfric_on = True
    js.run(max_steps=1)
    ts.run(max_steps=1)
    ng = js.gas.ngas
    dens = np.asarray(js.gas.density)
    gas = (np.asarray(js.particles.ptype)[:ng] == 0) \
        & np.asarray(js.particles.mask)[:ng]
    row = int(np.nonzero(gas)[0][np.argmax(dens[gas])])
    np.testing.assert_array_equal(ts.particles.ptype.numpy(),
                                  np.asarray(js.particles.ptype))
    js.gas = js.gas_physics.seed_bh(js, js.gas, [row])
    ts.gas = ts.gas_physics.seed_bh(ts, ts.gas, [row])
    js.run(max_steps=1)
    ts.run(max_steps=1)
    return js, ts, row


def test_whole_step_with_bh(whole_step):
    js, ts, row = whole_step
    jp, tp = js.particles, ts.particles
    assert int(tp.ptype[row]) == BH and int(np.asarray(jp.ptype)[row]) == BH
    for f in ("mask", "ptype", "id_lo", "id_hi"):
        a = np.asarray(getattr(jp, f))
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        np.testing.assert_array_equal(getattr(tp, f).numpy(), a, f)
    m = np.asarray(jp.mask)
    d = (np.asarray(jp.ipos).astype(np.int64)
         - tp.ipos.numpy().view(np.uint32).astype(np.int64))
    d = (d + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert np.abs(d[m]).max() < 2e-5 * 2 ** 32
    vj, vt = np.asarray(jp.vel)[m], tp.vel.numpy()[m]
    vrel = (np.linalg.norm(vj - vt, axis=1)
            / np.maximum(np.linalg.norm(vj, axis=1), 1e-30))
    assert (vrel > 1e-3).mean() < 5e-3
    for f in ("bh_mass", "bh_mdot"):
        a = float(np.asarray(getattr(js.gas, f))[row])
        b = float(getattr(ts.gas, f)[row])
        assert a > 0 and abs(a - b) <= 1e-3 * abs(a), f
    assert key_from_numpy(js.gas_physics.rng_key) == \
        ts.gas_physics.rng_key
    ng = ts.gas.ngas
    gas = (np.asarray(jp.ptype)[:ng] == 0) & m[:ng]
    assert not gas[row]
    a = np.asarray(js.gas.entropy, np.float64)[gas]
    b = ts.gas.entropy.numpy()[gas]
    assert (np.abs(a - b) / np.abs(a) < 1e-3).mean() >= 0.99
