"""The port's cooling network (shenqi_tpu_torch/physics/cooling_rates.py)
against the JAX package's on the CPU, from one numpy seed.

Limits:
  * every rate fit over T = 10-1e9 K within 1e-5 relative wherever the
    JAX value exceeds 1e-30;
  * `get_equilib_ne`, `get_neutral_fraction` and `do_cooling` (u and
    ne/nh) within 1e-4
    relative, with no UV background (star-small's case) and with a
    7-column TREECOOL-layout table that the test writes itself; ne/nh
    of nearly neutral gas within 2.4e-7 absolute instead (two f32 ulps
    of 1: the network takes the ionized fraction as 1 - nH0, so that is
    its resolution in both packages);
  * `TreeCool.uvbg` within 1e-12 relative.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from shenqi_tpu.physics import cooling_rates as jc
from shenqi_tpu_torch.physics import cooling_rates as tc

torch.set_num_threads(2)

FITS = ("recomb_alphaHp", "recomb_alphaHep", "recomb_alphad",
        "recomb_alphaHepd", "recomb_alphaHepp", "recomb_GammaeH0",
        "recomb_GammaeHe0", "recomb_GammaeHep", "cool_CollisionalH0",
        "cool_CollisionalHe0", "cool_CollisionalHeP", "cool_RecombHp",
        "cool_RecombHeP", "cool_RecombHePP", "cool_FreeFree1")


def _treecool(path):
    """A TREECOOL-layout table (log10(1+z), then the six rates) with
    smooth made-up rates of the published tables' size, ending at z = 9."""
    lz = np.linspace(0.0, np.log10(10.0), 60)
    z = 10 ** lz - 1
    shape = np.exp(-((z - 2.5) / 2.5) ** 2)
    rates = np.stack([1e-12 * shape, 8e-13 * shape, 5e-15 * shape,
                      6e-24 * shape, 7e-24 * shape, 1e-25 * shape], 1)
    np.savetxt(path, np.column_stack([lz, rates]))
    return str(path)


@pytest.fixture(scope="module")
def uvbgs(tmp_path_factory):
    path = _treecool(tmp_path_factory.mktemp("tc") / "TREECOOL")
    par = jc.CoolingParams(MinGasTemp=5.0, fBar=0.17)
    return {"none": (jc.UVBG(), tc.UVBG()),
            "treecool": (jc.TreeCool(path).uvbg(3.0, par),
                         tc.TreeCool(path).uvbg(3.0, tc.CoolingParams(
                             MinGasTemp=5.0, fBar=0.17))),
            "path": path}


def _ne_close(jne, tne):
    """ne/nh within 1e-4 relative, or 2.4e-7 absolute (the f32
    resolution of 1 - nH0)."""
    jne = np.asarray(jne, np.float64)
    tne = np.asarray(tne, np.float64)
    err = np.abs(jne - tne)
    assert (err <= np.maximum(1e-4 * np.abs(jne), 2.4e-7)).all(), \
        err.max()


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(a), 1e-300)


@pytest.mark.parametrize("name", FITS)
def test_rate_fits(name):
    temp = np.geomspace(10.0, 1e9, 2000).astype(np.float32)
    want = np.asarray(getattr(jc, name)(jnp.asarray(temp)), np.float64)
    got = getattr(tc, name)(torch.from_numpy(temp)).numpy()
    sel = np.abs(want) > 1e-30
    assert sel.sum() > 100
    assert _rel(want[sel], got[sel]).max() < 1e-5


def test_inverse_compton():
    temp = np.geomspace(10.0, 1e9, 500).astype(np.float32)
    want = np.asarray(jc.cool_InverseCompton(jnp.asarray(temp), 9.0,
                                             2.7255))
    got = tc.cool_InverseCompton(torch.from_numpy(temp), 9.0, 2.7255)
    assert _rel(want, got.numpy()).max() < 1e-5


def test_treecool_uvbg(uvbgs):
    path = uvbgs["path"]
    par_j = jc.CoolingParams(fBar=0.2)
    par_t = tc.CoolingParams(fBar=0.2)
    for z in (0.0, 1.3, 2.5, 4.7, 8.9, 9.5):
        a = jc.TreeCool(path, 1.1).uvbg(z, par_j)
        b = tc.TreeCool(path, 1.1).uvbg(z, par_t)
        assert _rel(np.array(a), np.array(b)).max() < 1e-12, z
    assert tc.TreeCool(path).uvbg(9.5, par_t).gJH0 == 0


def _inputs(n=400, seed=0):
    rng = np.random.default_rng(seed)
    nh = 10 ** rng.uniform(-7, 2, n)            # cm^-3
    u = 10 ** rng.uniform(10, 15, n)            # erg/g
    ne = rng.uniform(0.0, 1.2, n) * nh
    return (nh.astype(np.float32), u.astype(np.float32),
            ne.astype(np.float32))


@pytest.mark.parametrize("uv", ["none", "treecool"])
def test_equilib_ne(uvbgs, uv):
    juv, tuv = uvbgs[uv]
    nh, u, ne = _inputs()
    pj = jc.CoolingParams(MinGasTemp=5.0)
    pt = tc.CoolingParams(MinGasTemp=5.0)
    for init in (None, ne):
        jne, jlt = jc.get_equilib_ne(
            jnp.asarray(nh), jnp.asarray(u), 0.24, juv, pj,
            ne_init=None if init is None else jnp.asarray(init))
        tne, tlt = tc.get_equilib_ne(
            torch.from_numpy(nh), torch.from_numpy(u), 0.24, tuv, pt,
            ne_init=None if init is None else torch.from_numpy(init))
        _ne_close(np.asarray(jne, np.float64) / nh, tne.numpy() / nh)
        assert _rel(np.asarray(jlt), tlt.numpy()).max() < 1e-4
    # the neutral fraction nH0/nH through the same equilibrium
    rho = (nh / (1 - 0.24) * 1.6726e-24).astype(np.float32)
    jf = jc.get_neutral_fraction(jnp.asarray(rho), jnp.asarray(u), 0.24,
                                 juv, pj, ne_init=jnp.asarray(ne))
    tf = tc.get_neutral_fraction(torch.from_numpy(rho), torch.from_numpy(u),
                                 0.24, tuv, pt, ne_init=torch.from_numpy(ne))
    _ne_close(jf, tf.numpy())


@pytest.mark.parametrize("uv", ["none", "treecool"])
def test_do_cooling(uvbgs, uv):
    """The implicit solver over a spread of densities, energies and steps
    (a cooling and a heating population), z = 3."""
    juv, tuv = uvbgs[uv]
    nh, u, ne = _inputs(300, seed=1)
    rho = (nh / (1 - 0.24) * 1.6726e-24).astype(np.float32)
    rng = np.random.default_rng(2)
    dt = (10 ** rng.uniform(12, 15.5, len(u))).astype(np.float32)
    nebynh = (ne / nh).astype(np.float32)
    pj = jc.CoolingParams(MinGasTemp=5.0)
    pt = tc.CoolingParams(MinGasTemp=5.0)
    ju, jne = jc.do_cooling(jnp.asarray(u), jnp.asarray(rho),
                            jnp.asarray(dt), 0.24, 3.0, juv, pj,
                            min_egyspec_cgs=1e9,
                            ne_init=jnp.asarray(nebynh))
    tu, tne = tc.do_cooling(torch.from_numpy(u), torch.from_numpy(rho),
                            torch.from_numpy(dt), 0.24, 3.0, tuv, pt,
                            min_egyspec_cgs=1e9,
                            ne_init=torch.from_numpy(nebynh))
    ju = np.asarray(ju, np.float64)
    assert np.isfinite(tu.numpy()).all()
    # the test covers both directions and a real change of u
    assert (ju < 0.5 * u).sum() > 10 and (ju > 1.01 * u).sum() > 0 \
        if uv == "treecool" else (ju < 0.5 * u).sum() > 10
    assert _rel(ju, tu.numpy()).max() < 1e-4
    _ne_close(jne, tne.numpy())


def test_pure_cooling_steps():
    """GasPhysics with CoolingOn alone (the implicit solver on the active
    gas, no star formation) in the port's Simulation against the JAX
    package's: tests/test_torch_gas.py's configuration and state, three
    steps; entropy and ne within 1e-3 relative for >= 99% of the gas rows
    (test_torch_gas.py's limit), and the cooling moved the entropy."""
    import test_torch_gas as G
    from shenqi_tpu.cosmology.background import Cosmology as JC
    from shenqi_tpu.physics.sfr import CoolingUnits as JCU
    from shenqi_tpu.simulation_gas import GasPhysics as JGP
    from shenqi_tpu.sph.kernels import QUINTIC as JQ
    from shenqi_tpu.utils.units import default_units as ju
    from shenqi_tpu_torch.physics.sfr import CoolingUnits as TCU
    from shenqi_tpu_torch.simulation_gas import GasPhysics as TGP
    from shenqi_tpu_torch.sph.kernels import QUINTIC as TQ
    from shenqi_tpu_torch.utils.units import default_units as tu
    cp = JC(**G.COSMO)
    cp.init(G.A_IC, ju())
    fbar = cp.OmegaBaryon / cp.OmegaCDM
    js, ts = G._pair(G._species())
    js.gas_physics = JGP(kernel=JQ, cooling_on=True,
                         coolpar=jc.CoolingParams(fBar=fbar),
                         coolunits=JCU.create(ju(), 0.7))
    ts.gas_physics = TGP(kernel=TQ, cooling_on=True,
                         coolpar=tc.CoolingParams(fBar=fbar),
                         coolunits=TCU.create(tu(), 0.7))
    js.hierarchical = ts.hierarchical = True
    ent0 = None
    for i in range(3):
        js.run(max_steps=1)
        ts.run(max_steps=1)
        if i == 0:
            ent0 = ts.gas.entropy.clone()
    assert js.atime() == ts.atime()
    for a, b in ((js.gas.entropy, ts.gas.entropy), (js.gas.ne, ts.gas.ne)):
        assert (_rel(np.asarray(a), b.numpy()) < 1e-3).mean() >= 0.99
    assert not torch.equal(ts.gas.entropy, ent0)
    assert (ts.gas.ne.numpy() != 1.0).any()
