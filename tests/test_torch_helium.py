"""Helium reionization in the port (shenqi_tpu_torch/physics/helium_reion.py,
the JAX package's host module copied; GasPhysics.helium_step and the
long-mean-free-path heat of the cooling solve) against the JAX package on
the CPU, with the HeII history written by tools/HeII_input_file_maker.py
(--hist linear, z 10 to 6, four rows) in place of the reference's
examples/HeIIReionizationTable:

  * the copied module is the original but for its docstring;
  * the table as both packages load it: identical arrays, q_inst, the
    helium era and the heating per gram;
  * turn_on_quasars on a shared FOF catalogue from one RandomState seed:
    the HeIII flags identical, the entropies within 1e-6 relative, the
    same bubbles;
  * helium_step of both GasPhysics on one gas state, twice: each draws
    its bubble seed with randint(next_key(), (), 0, 2**31) from PRNGKey
    42, so the flags are identical, the entropies within 1e-6 relative
    and the keys left equal;
  * do_cooling with a per-row extra heat (0 on the HeIII rows): u within
    1e-4 relative, as tests/test_torch_cooling.py holds the solver.
"""

import dataclasses
import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import _reion_tables
import shenqi_tpu.physics.helium_reion as jhe
import shenqi_tpu_torch.physics.helium_reion as the
from shenqi_tpu import simulation_gas as jsg
from shenqi_tpu.core.particles import float_to_ipos as j_ipos
from shenqi_tpu.physics import cooling_rates as jc
from shenqi_tpu.physics.sfr import CoolingUnits as JCU
from shenqi_tpu_torch import simulation_gas as tsg
from shenqi_tpu_torch.core.particles import float_to_ipos as t_ipos
from shenqi_tpu_torch.physics import cooling_rates as tc
from shenqi_tpu_torch.physics.sfr import CoolingUnits as TCU
from shenqi_tpu_torch.utils import threefry
from shenqi_tpu_torch.utils.units import default_units

torch.set_num_threads(2)
BOX = 20000.0


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("heii")
    heii, _ = _reion_tables(tmp / "HeII", tmp / "J21", z=(10.0, 6.0))
    return heii


def _code(mod):
    src = inspect.getsource(mod)
    return src[src.index('"""', 3) + 3:]


def test_copied_module_is_the_original():
    assert _code(the) == _code(jhe)


def test_table(table):
    hj, ht = jhe.HeliumReion.load(table), the.HeliumReion.load(table)
    for f in ("a_hist", "xheiii", "lmfp"):
        np.testing.assert_array_equal(getattr(ht, f), getattr(hj, f))
    assert ht.inst_heating == hj.inst_heating == the.q_inst(150.0, 1.7)
    assert ht.start_redshift == pytest.approx(10.0, rel=1e-6)
    for z in (11.0, 9.5, 9.0, 7.0, 5.0):
        assert ht.during(z) == hj.during(z) == (6.0 <= z <= 10.0)
        assert ht.lmfp_heating_per_gram(z, 4e-31) \
            == hj.lmfp_heating_per_gram(z, 4e-31)
    assert ht.lmfp_heating_per_gram(9.0, 4e-31) > 0


def _catalogue(n=5000, seed=0):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, BOX, (n, 3))
    dens = rng.uniform(0.5e-8, 2e-8, n).astype(np.float32)
    ent = rng.uniform(50, 150, n).astype(np.float32)
    alive = rng.uniform(size=n) > 0.02
    gm = np.array([50.0, 80.0, 0.1, 300.0])
    gcm = rng.uniform(0, BOX, (4, 3))
    return pos, dens, ent, alive, gm, gcm


def _par(mod):
    return mod.QSOLightupParams(qso_candidate_min_mass=1.0,
                                qso_candidate_max_mass=1e3,
                                mean_bubble=3000.0, var_bubble=1e5)


def test_turn_on_quasars(table):
    pos, dens, ent, alive, gm, gcm = _catalogue()
    hj = jhe.HeliumReion.load(table, _par(jhe))
    ht = the.HeliumReion.load(table, _par(the))
    a = 1.0 / 9.0
    heiii = np.zeros(len(pos), bool)
    heiii[:40] = True
    rj = hj.turn_on_quasars(np.random.RandomState(5), a, gm, gcm, pos, dens,
                            alive, heiii, ent, BOX, 1e10)
    rt = ht.turn_on_quasars(np.random.RandomState(5), a, gm, gcm, pos, dens,
                            alive, heiii, ent, BOX, 1e10)
    assert rt[2] == rj[2] > 0
    np.testing.assert_array_equal(rt[0], rj[0])
    np.testing.assert_allclose(rt[1], rj[1], rtol=1e-6)
    assert (rt[1][rt[0] & ~heiii] > ent[rt[0] & ~heiii]).all()
    assert ht.events == hj.events


def _sim(ipos, mask, ptype, atime):
    p = types.SimpleNamespace(ipos=ipos, mask=mask, ptype=ptype)
    return types.SimpleNamespace(particles=p, boxsize=BOX,
                                 atime=lambda: atime)


def test_helium_step(table):
    pos, dens, ent, alive, gm, gcm = _catalogue(3000, seed=1)
    n = len(pos)
    units = default_units()
    ptype = np.zeros(n, np.int8)
    gpj = jsg.GasPhysics(helium=jhe.HeliumReion.load(table, _par(jhe)),
                         coolunits=JCU.create(units, 0.7))
    gpt = tsg.GasPhysics(helium=the.HeliumReion.load(table, _par(the)),
                         coolunits=TCU.create(units, 0.7))
    gj = jsg.GasState.create(n, jnp.asarray(ent))
    gj = dataclasses.replace(gj, density=jnp.asarray(dens))
    gt = tsg.GasState.create(n, torch.from_numpy(ent), device="cpu")
    gt = gt.replace(density=torch.from_numpy(dens))
    sj = _sim(jnp.asarray(j_ipos(pos, BOX)), jnp.asarray(alive),
              jnp.asarray(ptype), 1.0 / 9.0)
    st = _sim(t_ipos(pos, BOX, device="cpu"), torch.from_numpy(alive),
              torch.from_numpy(ptype), 1.0 / 9.0)
    real = jax.random.randint

    def randint(key, shape, lo, hi):
        # JAX 0.9 refuses the Python int 2**31 as an int32 argument; a
        # uint32 maxval runs randint's own algorithm
        return real(key, shape, lo, np.uint32(hi) if hi == 2 ** 31 else hi)
    jax.random.randint = randint
    try:
        for _ in range(2):
            gj = gpj.helium_step(sj, gj, gm, gcm)
            gt = gpt.helium_step(st, gt, gm, gcm)
    finally:
        jax.random.randint = real
    assert int(gt.heiii.sum()) > 0
    np.testing.assert_array_equal(gt.heiii.numpy(), np.asarray(gj.heiii))
    np.testing.assert_allclose(gt.entropy.numpy(), np.asarray(gj.entropy),
                               rtol=1e-6)
    assert gpt.rng_key == tuple(int(x) for x in np.asarray(gpj.rng_key))
    assert gpt.last_helium["bubbles"] >= 0
    assert gpt.rng_key != threefry.PRNGKey(42)


def test_cooling_extra_heat_per_row():
    rng = np.random.default_rng(4)
    n = 300
    nh = 10 ** rng.uniform(-6, -2, n)
    rho = (nh / 0.76 * 1.6726e-24).astype(np.float32)
    u = (10 ** rng.uniform(11, 13.5, n)).astype(np.float32)
    dt = (10 ** rng.uniform(13, 15, n)).astype(np.float32)
    heiii = rng.uniform(size=n) < 0.3
    xh = np.where(heiii, 0.0, np.float32(2e-2)).astype(np.float32)
    ju, _ = jc.do_cooling(jnp.asarray(u), jnp.asarray(rho), jnp.asarray(dt),
                          0.24, 8.0, jc.UVBG(), jc.CoolingParams(),
                          min_egyspec_cgs=1e9, extra_heat=jnp.asarray(xh))
    tu, _ = tc.do_cooling(torch.from_numpy(u), torch.from_numpy(rho),
                          torch.from_numpy(dt), 0.24, 8.0, tc.UVBG(),
                          tc.CoolingParams(), min_egyspec_cgs=1e9,
                          extra_heat=torch.from_numpy(xh))
    ju = np.asarray(ju, np.float64)
    assert np.isfinite(tu.numpy()).all()
    assert (np.abs(ju - tu.numpy()) / ju).max() < 1e-4
    # the heat raises u on the rows that get it
    j0, _ = jc.do_cooling(jnp.asarray(u), jnp.asarray(rho), jnp.asarray(dt),
                          0.24, 8.0, jc.UVBG(), jc.CoolingParams(),
                          min_egyspec_cgs=1e9)
    assert (ju[~heiii] > np.asarray(j0)[~heiii]).mean() > 0.5
