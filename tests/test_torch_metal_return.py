"""The port's metal return (shenqi_tpu_torch/physics/metal_return.py, the
environment sums of physics/blackhole.py and GasPhysics.metal_return)
against the JAX package's on the CPU, from one numpy seed.

Limits:
  * the parsed AGB and SNII yield tables of data_yields/ equal;
  * `star_return` (host scipy) within 1e-12 relative;
  * `bh_gas_environment` and `metal_return_step` within 1e-5 relative
    (of each output's max for the per-gas increments);
  * GasPhysics.metal_return on a state with old star rows (flipped gas
    rows and a spawned row past the gas prefix; tests/
    test_metal_return_sim.py's configuration): every mass within 1e-6
    relative, every metallicity within 1e-6 of the largest (a row that
    takes metals only from the edge of a star's kernel differs by up to
    3e-6 of its own value: (3-q)^5 of the quintic kernel magnifies the
    last bit of r there), the enrichment clocks and returned fractions
    within 1e-6 relative, and a second call a no-op.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from shenqi_tpu.core.particles import float_to_ipos as j_ipos
from shenqi_tpu.cosmology.background import Cosmology as JCosmology
from shenqi_tpu.core.timeline import Timeline as JTimeline
from shenqi_tpu.physics import blackhole as jbh, metal_return as jmr
from shenqi_tpu.simulation import Simulation as JSimulation
from shenqi_tpu.simulation_gas import GasPhysics as JGasPhysics
from shenqi_tpu.sph.kernels import QUINTIC as JQUINTIC
from shenqi_tpu.utils.units import default_units as j_units
from shenqi_tpu_torch.convert import (gas_state_from_numpy,
                                      particles_from_numpy)
from shenqi_tpu_torch.core.particles import float_to_ipos as t_ipos
from shenqi_tpu_torch.core.timeline import Timeline as TTimeline
from shenqi_tpu_torch.cosmology.background import Cosmology as TCosmology
from shenqi_tpu_torch.physics import blackhole as tbh, metal_return as tmr
from shenqi_tpu_torch.simulation import Simulation as TSimulation
from shenqi_tpu_torch.simulation_gas import GasPhysics as TGasPhysics
from shenqi_tpu_torch.sph.kernels import QUINTIC
from shenqi_tpu_torch.utils.units import default_units as t_units

torch.set_num_threads(2)
YIELDS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data_yields")
BOX = 20000.0
N = 6


@pytest.fixture(scope="module")
def metals():
    return jmr.MetalReturn.load(YIELDS), tmr.MetalReturn.load(YIELDS)


def test_yield_tables_equal(metals):
    jm, tm = metals
    for name in ("agb", "snii"):
        a, b = getattr(jm, name), getattr(tm, name)
        for f in ("masses", "metallicities", "total_metal", "ejected"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
        assert sorted(a.yields) == sorted(b.yields)
        for sp in a.yields:
            np.testing.assert_array_equal(b.yields[sp], a.yields[sp])
    assert tm.imf_norm == jm.imf_norm


def test_star_return(metals):
    jm, tm = metals
    for z in (1e-4, 0.004, 0.02):
        for t0, t1 in ((0.0, 5.0), (3.0, 40.0), (30.0, 300.0),
                       (100.0, 3000.0)):
            a = np.array(jm.star_return(z, t0, t1, 0.7))
            b = np.array(tm.star_return(z, t0, t1, 0.7))
            assert np.all(np.abs(a - b) <= 1e-12 * np.abs(a)), (z, t0, t1)
    m = np.geomspace(0.1, 100, 50)
    np.testing.assert_array_equal(tmr.chabrier_imf(m), jmr.chabrier_imf(m))
    np.testing.assert_array_equal(tmr.lifetime_myr(m, 0.01),
                                  jmr.lifetime_myr(m, 0.01))
    assert tmr.sn1a_number(50, 500, 0.7) == jmr.sn1a_number(50, 500, 0.7)


def _pairs(seed=0, ns=13, ng=5000):
    rng = np.random.default_rng(seed)
    box = 5000.0
    gpos = rng.uniform(0, box, (ng, 3))
    spos = gpos[rng.choice(ng, ns, replace=False)] \
        + rng.normal(0, 20, (ns, 3))
    spos[0] = [1.0, 2.0, box - 3.0]   # straddles the periodic edge
    return dict(box=box, gpos=gpos, spos=spos % box,
                shsml=rng.uniform(200, 500, ns).astype(np.float32),
                gmass=rng.uniform(1e-3, 3e-3, ng).astype(np.float32),
                gent=rng.uniform(1e-7, 1e-5, ng).astype(np.float32),
                gvel=rng.normal(0, 50, (ng, 3)).astype(np.float32),
                alive=rng.uniform(size=ng) < 0.97,
                mret=rng.uniform(0, 1e-4, ns).astype(np.float32),
                zret=rng.uniform(0, 1e-6, ns).astype(np.float32))


def test_env_and_scatter():
    d = _pairs()
    box = d["box"]
    je = jbh.bh_gas_environment(
        j_ipos(d["spos"], box), jnp.asarray(d["shsml"]),
        j_ipos(d["gpos"], box), jnp.asarray(d["gmass"]),
        jnp.asarray(d["gent"]), jnp.asarray(d["gvel"]),
        jnp.asarray(d["alive"]), box)
    t = {k: torch.from_numpy(v) for k, v in d.items()
         if isinstance(v, np.ndarray) and k not in ("gpos", "spos")}
    ts_, tg_ = t_ipos(d["spos"], box, device="cpu"), \
        t_ipos(d["gpos"], box, device="cpu")
    te = tbh.bh_gas_environment(ts_, t["shsml"], tg_, t["gmass"],
                                t["gent"], t["gvel"], t["alive"], box)
    assert float(np.min(je.feedback_weight)) > 0
    for f in tbh.BHEnv._fields:
        a = np.asarray(getattr(je, f), np.float64)
        b = getattr(te, f).numpy()
        assert (np.abs(a - b) <= 1e-5 * np.abs(a)).all(), f
    jdm, jdz = jmr.metal_return_step(
        j_ipos(d["spos"], box), jnp.asarray(d["shsml"]),
        jnp.asarray(d["mret"]), jnp.asarray(d["zret"]), je.feedback_weight,
        j_ipos(d["gpos"], box), jnp.asarray(d["gmass"]),
        jnp.asarray(d["alive"]), box, JQUINTIC)
    tdm, tdz = tmr.metal_return_step(
        ts_, t["shsml"], t["mret"], t["zret"],
        torch.from_numpy(np.asarray(je.feedback_weight)), tg_, t["gmass"],
        t["alive"], box, QUINTIC)
    for a, b in ((jdm, tdm), (jdz, tdz)):
        a = np.asarray(a, np.float64)
        assert (a > 0).sum() > 100
        assert np.abs(a - b.numpy()).max() <= 1e-5 * np.abs(a).max()


def _cosmo(cls, units, a_ic):
    cp = cls(Omega0=0.3, OmegaLambda=0.7, OmegaBaryon=0.05,
             HubbleParam=0.7, RadiationOn=0, CMBTemperature=0.0)
    cp.init(TimeBegin=a_ic, units=units)
    return cp


def _sims(metals, a_ic=0.5):
    """tests/test_metal_return_sim.py's state in both packages: 6^3 gas
    and DM, three gas rows flipped to stars born at a = 0.2, and one star
    spawned onto the spare tail."""
    rng = np.random.RandomState(0)
    ng = N ** 3
    grid = (np.arange(N) + 0.5) * (BOX / N)
    X, Y, Z = np.meshgrid(grid, grid, grid, indexing="ij")
    gpos = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1)
    gpos += rng.uniform(-0.1, 0.1, gpos.shape) * (BOX / N)
    dpos = (gpos + 0.5 * BOX / N) % BOX
    vel = np.zeros((ng, 3), np.float32)
    jcp = _cosmo(JCosmology, j_units(), a_ic)
    m_gas = jcp.OmegaBaryon * jcp.RhoCrit * BOX ** 3 / ng
    m_dm = (jcp.Omega0 - jcp.OmegaBaryon) * jcp.RhoCrit * BOX ** 3 / ng
    sp = [(0, gpos, vel, m_gas, np.arange(1, ng + 1)),
          (1, dpos, vel, m_dm, np.arange(ng + 1, 2 * ng + 1))]
    jm, tm = metals
    jgp = JGasPhysics(metal_return_on=True, metals=jm, kernel=JQUINTIC)
    tgp = TGasPhysics(metal_return_on=True, metals=tm, kernel=QUINTIC)
    js = JSimulation.from_species(
        sp, jcp, BOX, nmesh=2 * N, timeline=JTimeline.setup([0.6], a_ic,
                                                             0.6),
        atime=a_ic, gas_u0=100.0, gas_physics=jgp, star_headroom=64)
    ts = TSimulation.from_species(
        sp, _cosmo(TCosmology, t_units(), a_ic), BOX, nmesh=2 * N,
        timeline=TTimeline.setup([0.6], a_ic, 0.6), atime=a_ic,
        gas_u0=100.0, gas_physics=tgp, star_headroom=64, device="cpu")
    p = {f: np.array(getattr(js.particles, f))
         for f in type(js.particles).__dataclass_fields__}
    g = {f: (None if getattr(js.gas, f) is None
             else np.array(getattr(js.gas, f)))
         for f in type(js.gas).__dataclass_fields__}
    g["ngas"] = ng
    idx = np.array([5, 77, 140])
    tail = 2 * ng + 3                      # a spare row past the gas
    p["ptype"][idx] = 4
    p["ptype"][tail] = 4
    p["mask"][tail] = True
    p["ipos"][tail] = p["ipos"][100]
    p["mass"][tail] = 0.3 * m_gas
    p["id_lo"][tail] = 100 | (1 << 24)
    p["hsml"][:ng] = 2.0 * BOX / N
    p["hsml"][tail] = 2.0 * BOX / N
    for r in list(idx) + [tail]:
        g["birth_a"][r] = 0.2 if r != tail else 0.3
        g["mass0"][r] = p["mass"][r]
        g["star_metallicity"][r] = 0.01
    g["density"] = np.full(ng, 1e-8, np.float32)
    js.particles = dataclasses.replace(
        js.particles, **{f: jnp.asarray(v) for f, v in p.items()})
    js.gas = dataclasses.replace(
        js.gas, **{f: jnp.asarray(v) for f, v in g.items()
                   if f != "ngas" and v is not None})
    ts.particles = particles_from_numpy(p, device="cpu")
    ts.gas = gas_state_from_numpy(g, device="cpu")
    return js, ts, np.append(idx, tail)


def test_gas_physics_metal_return(metals):
    js, ts, stars = _sims(metals)
    m_before = np.asarray(js.particles.mass, np.float64).copy()
    jg = js.gas_physics.metal_return(js, js.gas)
    tg = ts.gas_physics.metal_return(ts, ts.gas)
    jm = np.asarray(js.particles.mass, np.float64)
    tm = ts.particles.mass.numpy()
    assert (jm[stars] < m_before[stars]).all()
    assert (np.abs(jm - tm) <= 1e-6 * jm).all()
    jz = np.asarray(jg.metallicity, np.float64)
    assert (jz > 0).sum() > 20
    assert np.abs(jz - tg.metallicity.numpy()).max() <= 1e-6 * jz.max()
    for f in ("last_enrich_myr", "total_returned"):
        a = np.asarray(getattr(jg, f), np.float64)
        assert (a[stars] > 0).all()
        assert (np.abs(a - getattr(tg, f).numpy()) <= 1e-6 * a).all(), f
    # a second call at once: the window is below its threshold
    m_snap = tm.copy()
    tg2 = ts.gas_physics.metal_return(ts, tg)
    np.testing.assert_array_equal(ts.particles.mass.numpy(), m_snap)
    assert tg2 is tg
