"""The port's black-hole physics (shenqi_tpu_torch/physics/blackhole.py)
against the JAX package's on the CPU, from seeded numpy inputs, with the
cases of tests/test_blackhole_sim.py, test_bh_drag.py and
test_winds_bh.py:118-176.

Limits: every float result within 1e-5 of the largest value of the
result (the sound speed, the Eddington and Bondi rates, the accretion
rate, the gas environment, the feedback's entropy increments, the
swallowed mass, the drag and dynamical friction); `swallowed_by`,
`bh_mergers`' `eaten_by` and `seed_black_holes` identical.  A swallow
draw that lies within 1e-6 of its probability is an f32 tie between the
packages' kernel weights: those gas rows are left out of the comparison,
and counted (at most 1 in 1000).  BHParams carries over by its fields.
The host writers of blackholes.txt and BlackholeDetails.bin
(`blackhole_statistics`, `bh_details`) write the same bytes.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from shenqi_tpu.core.particles import float_to_ipos as j_ipos
from shenqi_tpu.physics import blackhole as jb
from shenqi_tpu_torch.convert import bh_params_from
from shenqi_tpu_torch.core.particles import float_to_ipos as t_ipos
from shenqi_tpu_torch.physics import blackhole as tb
from shenqi_tpu_torch.utils import threefry

torch.set_num_threads(2)
BOX = 10000.0
G = 43007.1


def _close(a, b, rel=1e-5):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(np.abs(a).max(), 1e-300)
    assert np.abs(a - b).max() <= rel * scale, np.abs(a - b).max() / scale


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _ipos(pos):
    return (jnp.asarray(j_ipos(pos, BOX)), t_ipos(pos, BOX, device="cpu"))


def _gas(seed, ng, nb, r_gas=600.0, r_bh=150.0):
    """A gas cluster around the box centre with `nb` BHs inside it."""
    rng = np.random.RandomState(seed)
    c = np.full(3, BOX / 2)
    gpos = (c + rng.uniform(-r_gas, r_gas, (ng, 3))) % BOX
    bpos = (c + rng.uniform(-r_bh, r_bh, (nb, 3))) % BOX
    return dict(
        gpos=gpos, bpos=bpos,
        gmass=rng.uniform(0.5, 1.5, ng).astype(np.float32) * 0.01,
        gent=rng.uniform(20, 80, ng).astype(np.float32),
        gvel=rng.normal(0, 5, (ng, 3)).astype(np.float32),
        alive=rng.uniform(size=ng) > 0.05,
        hsml=rng.uniform(150, 300, nb).astype(np.float32),
        bvel=rng.normal(0, 20, (nb, 3)).astype(np.float32),
        bmass=rng.uniform(1e-5, 1e-4, nb).astype(np.float32))


def _envs(d):
    gj, gt = _ipos(d["gpos"])
    bj, bt = _ipos(d["bpos"])
    ej = jb.bh_gas_environment(bj, jnp.asarray(d["hsml"]), gj,
                               jnp.asarray(d["gmass"]),
                               jnp.asarray(d["gent"]),
                               jnp.asarray(d["gvel"]),
                               jnp.asarray(d["alive"]), BOX)
    et = tb.bh_gas_environment(bt, _t(d["hsml"]), gt, _t(d["gmass"]),
                               _t(d["gent"]), _t(d["gvel"]),
                               _t(d["alive"], torch.bool), BOX)
    return (gj, gt), (bj, bt), ej, et


@pytest.mark.parametrize("nb", [1, 7])
def test_gas_environment(nb):
    _, _, ej, et = _envs(_gas(3, 4000, nb))
    assert float(ej.density.min()) > 0
    for f in ("density", "entropy", "gas_vel", "feedback_weight"):
        _close(getattr(ej, f), getattr(et, f).numpy())


def test_rates_and_accretion():
    rng = np.random.RandomState(5)
    n = 200
    par = jb.BHParams(BlackHoleAccretionFactor=100,
                      BlackHoleEddingtonFactor=3.0)
    tpar = bh_params_from(par)
    assert tpar == tb.BHParams(**vars(par))
    ent = rng.uniform(1, 1e3, n).astype(np.float32)
    rho = rng.uniform(0, 1e-2, n).astype(np.float32)
    rho[:5] = 0.0
    m = rng.uniform(1e-6, 1e-3, n).astype(np.float32)
    v = rng.uniform(0, 300, n).astype(np.float32)
    for a in (0.1, 0.5, 1.0):
        cj = jb.bh_soundspeed(jnp.asarray(ent), jnp.asarray(rho), a)
        ct = tb.bh_soundspeed(_t(ent), _t(rho), a)
        _close(cj, ct.numpy())
        _close(jb.eddington_rate(jnp.asarray(m), par),
               tb.eddington_rate(_t(m), tpar).numpy())
        _close(jb.bondi_rate(jnp.asarray(m), jnp.asarray(rho), cj,
                             jnp.asarray(v), a, G, par),
               tb.bondi_rate(_t(m), _t(rho), ct, _t(v), a, G,
                             tpar).numpy())
    # test_winds_bh.py:118-135: the Bondi value and the Eddington cap
    mj = jb.bondi_rate(jnp.asarray([5e-5]), jnp.asarray([1e6]),
                       jnp.asarray([10.0]), jnp.asarray([0.0]), 0.5, G, par)
    mt = tb.bondi_rate(_t([5e-5]), _t([1e6]), _t([10.0]), _t([0.0]), 0.5,
                       G, tpar)
    _close(mj, mt.numpy())
    d = _gas(4, 3000, 5)
    _, _, ej, et = _envs(d)
    _close(jb.bh_accretion(jnp.asarray(d["bmass"]), jnp.asarray(d["bvel"]),
                           ej, 0.3, G, par),
           tb.bh_accretion(_t(d["bmass"]), _t(d["bvel"]), et, 0.3, G,
                           tpar).numpy())


@pytest.mark.parametrize("nb", [1, 300])
def test_thermal_feedback(nb):
    """Over one and over two chunks of 256 BHs (test_winds_bh.py:138-176
    for one BH)."""
    d = _gas(6, 2000, nb)
    (gj, gt), (bj, bt), ej, et = _envs(d)
    rng = np.random.RandomState(9)
    energy = rng.uniform(0, 1e-3, nb).astype(np.float32)
    energy[1::4] = 0.0
    dens = rng.uniform(1e-4, 1e-2, 2000).astype(np.float32)
    dj = jb.bh_thermal_feedback(bj, jnp.asarray(d["hsml"]),
                                jnp.asarray(energy), ej.feedback_weight, gj,
                                jnp.asarray(d["gmass"]), jnp.asarray(dens),
                                jnp.asarray(d["alive"]), BOX, a3inv=8.0)
    dt = tb.bh_thermal_feedback(bt, _t(d["hsml"]), _t(energy),
                                et.feedback_weight, gt, _t(d["gmass"]),
                                _t(dens), _t(d["alive"], torch.bool), BOX,
                                a3inv=8.0)
    assert float(jnp.max(dj)) > 0
    _close(dj, dt.numpy())
    np.testing.assert_array_equal(dt.numpy() > 0, np.asarray(dj) > 0)


def _swallow(d, seed, deficit):
    """Both packages' swallow with the subgrid masses `deficit` above the
    dynamic ones."""
    (gj, gt), (bj, bt), ej, et = _envs(d)
    nb = len(d["bpos"])
    mdyn = d["bmass"]
    msub = (mdyn + np.float32(deficit)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    sj, gainj = jb.bh_swallow_gas(key, bj, jnp.asarray(d["hsml"]),
                                  jnp.asarray(msub), jnp.asarray(mdyn), ej,
                                  gj, jnp.asarray(d["gmass"]),
                                  jnp.asarray(d["alive"]), BOX)
    st, gaint, margin = tb.bh_swallow_gas(
        threefry.PRNGKey(seed), bt, _t(d["hsml"]), _t(msub), _t(mdyn), et,
        gt, _t(d["gmass"]), _t(d["alive"], torch.bool), BOX,
        return_margin=True)
    assert st.shape == (len(d["gpos"]),) and gaint.shape == (nb,)
    return np.asarray(sj), st.numpy(), np.asarray(gainj), gaint.numpy(), \
        margin.numpy()


@pytest.mark.parametrize("case", ["one", "overlap"])
def test_swallow_identical(case):
    """The [ng, nb] threefry draw and the first-BH arbitration: the same
    rows swallowed by the same BH, the same mass gained."""
    ties = hits = rows = 0
    for seed in range(12):
        if case == "one":
            # test_blackhole_sim.py:22-58: a deficit of 5 gas masses
            d = _gas(seed, 3000, 1, r_gas=300.0, r_bh=0.0)
            d["hsml"][:] = 250.0
            deficit = 0.05
        else:
            # five BHs whose kernels overlap: a row may be claimed twice
            d = _gas(seed, 3000, 5, r_gas=300.0, r_bh=60.0)
            deficit = 0.03
        sj, st, gj, gt, margin = _swallow(d, seed, deficit)
        near = margin < 1e-6
        ties += int(near.sum())
        rows += len(sj)
        np.testing.assert_array_equal(st[~near], sj[~near])
        hits += int((sj >= 0).sum())
        if not near.any():
            _close(gj, gt)
    assert hits > 40
    assert ties <= rows // 1000


def test_swallow_zero_deficit():
    d = _gas(1, 1000, 2)
    sj, st, gj, gt, _ = _swallow(d, 1, -1e-5)
    assert (sj == -1).all() and (st == -1).all()
    assert (gt == 0).all() and (gj == 0).all()


def _merger_cases():
    """test_blackhole_sim.py:61-107's three cases and seeded clusters."""
    out = []
    pos = np.array([[5000., 5000, 5000], [5050., 5000, 5000],
                    [8000., 8000, 8000]])
    base = dict(pos=pos, vel=np.zeros((3, 3), np.float32),
                hsml=np.array([100., 100, 100], np.float32),
                msub=np.array([1e-4, 2e-4, 3e-4], np.float32),
                mdyn=np.array([1e-3, 1e-3, 1e-3], np.float32),
                ids=np.array([7, 20, 3], np.uint64),
                cs=np.array([50., 50, 50], np.float32))
    out.append(base)
    out.append(dict(base, vel=np.array([[0., 0, 0], [500., 0, 0],
                                        [0., 0, 0]], np.float32)))
    out.append(dict(base, pos=np.array([[5000., 5000, 5000],
                                        [5050., 5000, 5000],
                                        [5100., 5000, 5000]]),
                    hsml=np.full(3, 80.0, np.float32),
                    ids=np.array([1, 2, 3], np.uint64),
                    cs=np.full(3, 100.0, np.float32)))
    for seed in range(4):
        rng = np.random.RandomState(seed)
        n = 12
        out.append(dict(
            pos=(BOX / 2 + rng.uniform(-300, 300, (n, 3))).astype(
                np.float32),
            vel=rng.normal(0, 30, (n, 3)).astype(np.float32),
            hsml=rng.uniform(50, 250, n).astype(np.float32),
            msub=rng.uniform(1e-5, 1e-4, n).astype(np.float32),
            mdyn=rng.uniform(1e-4, 1e-3, n).astype(np.float32),
            ids=rng.permutation(n).astype(np.uint64) + 100,
            cs=rng.uniform(10, 60, n).astype(np.float32)))
    return out


def test_mergers_identical():
    merged = 0
    for c in _merger_cases():
        for atime in (0.3, 1.0):
            args = (c["pos"], c["vel"], c["hsml"], c["msub"], c["mdyn"],
                    c["ids"], atime, c["cs"], BOX)
            ej, msj, mdj = jb.bh_mergers(*args)
            et, mst, mdt = tb.bh_mergers(*args)
            np.testing.assert_array_equal(et, ej)
            np.testing.assert_array_equal(mst, msj)
            np.testing.assert_array_equal(mdt, mdj)
            merged += int((ej >= 0).sum())
    assert merged >= 5


@pytest.mark.parametrize("drag", [1, 2])
def test_drag(drag):
    """test_bh_drag.py's cases and seeded ones, both drag methods."""
    rng = np.random.RandomState(drag)
    n = 50
    par = jb.BHParams(BH_DRAG=drag)
    bv = rng.normal(0, 100, (n, 3)).astype(np.float32)
    gv = rng.normal(0, 30, (n, 3)).astype(np.float32)
    gv[:3] = bv[:3]
    mdot = rng.uniform(0, 2, n).astype(np.float32)
    dyn = rng.uniform(1, 10, n).astype(np.float32)
    bhm = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    for a in (0.3, 0.5, 1.0):
        aj = jb.bh_drag_accel(jnp.asarray(bv), jnp.asarray(gv),
                              jnp.asarray(mdot), jnp.asarray(dyn),
                              jnp.asarray(bhm), a, par)
        at = tb.bh_drag_accel(_t(bv), _t(gv), _t(mdot), _t(dyn), _t(bhm),
                              a, bh_params_from(par))
        _close(aj, at.numpy())
        assert (at.numpy()[:3] == 0).all()


def test_dynamical_friction():
    """test_blackhole_sim.py:110-133's regimes and seeded inputs."""
    rng = np.random.RandomState(11)
    n = 100
    vel = rng.normal(0, 300, (n, 3)).astype(np.float32)
    vel[:2] = [[5.0, 0, 0], [2000.0, 0, 0]]
    rho = rng.uniform(1e-6, 1e-4, n).astype(np.float32)
    sigma = rng.uniform(20, 200, n).astype(np.float32)
    mbh = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    for a in (0.2, 0.5):
        aj = jb.dynamical_friction(jnp.asarray(vel), jnp.asarray(rho),
                                   jnp.asarray(sigma), jnp.asarray(mbh), a,
                                   G)
        at = tb.dynamical_friction(_t(vel), _t(rho), _t(sigma), _t(mbh), a,
                                   G)
        _close(aj, at.numpy())
        # it opposes the motion
        assert (np.sum(at.numpy() * vel, 1) < 0).all()


class _Groups:
    def __init__(self, rng, n):
        self.masses = rng.uniform(0, 5, n)
        self.mass_by_type = np.zeros((n, 6))
        self.mass_by_type[:, 4] = rng.uniform(0, 1e-3, n)
        self.length_by_type = np.zeros((n, 6), np.int64)
        self.length_by_type[:, 5] = rng.uniform(size=n) < 0.2


def test_seed_black_holes_identical():
    rng = np.random.RandomState(2)
    for _ in range(5):
        g = _Groups(rng, 200)
        for par in (jb.BHParams(), jb.BHParams(MinFoFMassForNewSeed=0.5,
                                               MinMStarForNewSeed=1e-4)):
            want = jb.seed_black_holes(g, g.mass_by_type[:, 4],
                                       g.length_by_type[:, 5], par)
            got = tb.seed_black_holes(g, g.mass_by_type[:, 4],
                                      g.length_by_type[:, 5],
                                      bh_params_from(par))
            assert len(want) > 0
            np.testing.assert_array_equal(got, want)


def test_bh_writers_identical(tmp_path):
    """blackholes.txt lines and BlackholeDetails.bin records from host
    arrays (stats.py:186-229 of the JAX package): the same bytes."""
    from shenqi_tpu.utils import stats as js
    from shenqi_tpu.utils.units import default_units as jun
    from shenqi_tpu_torch.utils import stats as ts
    from shenqi_tpu_torch.utils.units import default_units as tun
    rng = np.random.RandomState(4)
    n = 40
    m = rng.uniform(1e-5, 1e-3, n).astype(np.float32)
    m[::3] = 0.0
    md = rng.uniform(0, 1e-4, n).astype(np.float32)
    alive = rng.uniform(size=n) > 0.2
    ids = rng.permutation(n).astype(np.uint64) + (7 << 40)
    dens = rng.uniform(0, 1e-2, n).astype(np.float32)
    pos = rng.uniform(0, BOX, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 50, (n, 3)).astype(np.float32)
    out = {}
    for name, mod, units in (("jax", js, jun()), ("torch", ts, tun())):
        txt, det = tmp_path / f"{name}.txt", tmp_path / f"{name}.bin"
        with open(txt, "w") as f, open(det, "wb") as g:
            for a in (0.12, 0.125):
                mod.blackhole_statistics(f, a, m, md, alive, units)
                got = mod.bh_details(g, a, ids, m, md, dens, pos, vel, alive)
                assert got == int((alive & (m > 0)).sum())
        out[name] = (txt.read_bytes(), det.read_bytes())
    assert out["torch"] == out["jax"]
    rec = np.frombuffer(out["torch"][1], dtype=ts.BH_DETAIL_DTYPE)
    assert len(rec) == 2 * int((alive & (m > 0)).sum())
    assert ts.BH_DETAIL_DTYPE.itemsize == 52
