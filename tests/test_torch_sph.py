"""The port's SPH kernels and density (shenqi_tpu_torch/sph, ops/treewalk)
against the JAX package's on the CPU, from seeded numpy inputs (the sets
of tests/test_stencil_density.py); the hydro force is in
tests/test_torch_sph_hydro.py.

Limits, from the JAX package's own tests: the stencil density
accumulators within 2e-5 of their max (test_stencil_density.py:74); the
hsml loop's hsml within 1e-5 relative
for >= 99% of the targets and 5e-3 for all (a neighbour count one f32
ulp from the MaxNumNgbDeviation edge can send a target down another
bisection path), rho within 2e-4 (test_stencil_density.py:145-149),
niter equal; the kernels to 1e-6 relative; cover flags identical.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from shenqi_tpu.core.particles import float_to_ipos as j_f2i
from shenqi_tpu.ops.tree import build_octree as j_octree
from shenqi_tpu.sph import kernels as jk
from shenqi_tpu.sph import density as jd
from shenqi_tpu.sph import stencil_density as jsd

from shenqi_tpu_torch.ops.tree import build_octree
from shenqi_tpu_torch.sph import kernels as tk
from shenqi_tpu_torch.sph import density as td
from shenqi_tpu_torch.sph import stencil_density as tsd
from tests.test_stencil_density import _gas, BOX

torch.set_num_threads(2)
SPECS = ["cubic", "quartic", "quintic"]


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-20)


@pytest.mark.parametrize("name", SPECS)
def test_kernels(name):
    js, ts = jk.KERNELS[name], tk.KERNELS[name]
    assert tuple(js) == tuple(ts)
    assert tk.desnumngb(ts, 1.3) == jk.desnumngb(js, 1.3)
    rng = np.random.default_rng(3)
    u = np.concatenate([rng.uniform(0, 1, 4000), [0.0, 0.5, 1.0]]
                       ).astype(np.float32)
    H = rng.uniform(50.0, 900.0, len(u)).astype(np.float32)
    for fn in ("wk", "dwk", "dW_dH"):
        a = getattr(jk, fn)(js, jnp.asarray(u), jnp.asarray(H))
        b = getattr(tk, fn)(ts, _t(u), _t(H))
        assert _rel(a, b) < 1e-6, fn
    assert _rel(jk.volume(jnp.asarray(H)), tk.volume(_t(H))) < 1e-6


def _stencil_pair(pos, mass, vel, entvar, hsml, k, spec="cubic"):
    ij = jnp.asarray(j_f2i(pos, BOX))
    g = jsd.build_grid_sph(ij, jnp.asarray(mass), jnp.asarray(vel),
                           jnp.asarray(entvar), k)
    rj, cj, nj = jsd.stencil_density_walk(
        g, ij, jnp.asarray(vel), jnp.asarray(hsml), BOX, k,
        spec=jk.KERNELS[spec])
    it = _t(np.asarray(ij))
    gt = tsd.build_grid_sph(it, _t(mass), _t(vel), _t(entvar), k)
    rt, ct, nt = tsd.stencil_density_walk(gt, it, _t(vel), _t(hsml), BOX,
                                          k, spec=tk.KERNELS[spec])
    return (rj, np.asarray(cj), nj), (rt, ct.numpy(), nt)


def _lattice_gas(ng=9, seed=43):
    """The jittered lattice of test_stencil_density.py:86 (a Poisson box
    has O(30%) shot noise at ~33 neighbours)."""
    rng = np.random.default_rng(seed)
    g1 = (np.arange(ng) + 0.5) * BOX / ng
    X, Y, Z = np.meshgrid(g1, g1, g1, indexing="ij")
    pos = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1)
    pos += rng.uniform(-0.1, 0.1, pos.shape) * (BOX / ng)
    pos = (pos % BOX).astype(np.float32)
    n = len(pos)
    return (pos, rng.uniform(0.5, 1.5, n).astype(np.float32),
            rng.normal(scale=50.0, size=(n, 3)).astype(np.float32),
            rng.uniform(0.8, 1.2, n).astype(np.float32))


@pytest.mark.parametrize("case", ["clustered", "uniform"])
def test_stencil_density_walk_parity(case):
    """Fixed hsml on a clustered set and a uniform (jittered lattice)
    one: every accumulator of the stencil walk, and the cover flags
    (none on the uniform set)."""
    if case == "clustered":
        pos, mass, vel, entvar = _gas(900, 41)
        n = len(pos)
        hsml = np.random.default_rng(42).uniform(1.5, 2.5, n).astype(
            np.float32) * BOX / n ** (1 / 3)
    else:
        pos, mass, vel, entvar = _lattice_gas()
        n = len(pos)
        hsml = np.full(n, 2.0 * BOX / n ** (1 / 3), np.float32)
    (rj, cj, nj), (rt, ct, nt) = _stencil_pair(pos, mass, vel, entvar,
                                               hsml, 3)
    assert nj == nt and np.array_equal(cj, ct)
    ok = ~ct
    assert ok.sum() > 0.9 * n
    if case == "uniform":
        assert nt == 0
    for name, a, b in zip(rj._fields, rj, rt):
        assert _rel(np.asarray(a)[ok], b.numpy()[ok]) < 2e-5, name


def test_cover_flag_and_dense_patch():
    """A void prober (hsml 0.45 box) is flagged cover, not truncated, and
    the all-sources patch the loop gives it matches the JAX one."""
    pos, mass, vel, entvar = _gas(600, 46, clustered=False)
    n = len(pos)
    hsml = np.full(n, 0.02 * BOX, np.float32)
    hsml[5] = 0.45 * BOX
    (rj, cj, nj), (rt, ct, nt) = _stencil_pair(pos, mass, vel, entvar,
                                               hsml, 4)
    assert ct[5] and np.array_equal(cj, ct) and nt == nj >= 1
    sel = np.nonzero(ct)[0]
    ij = jnp.asarray(j_f2i(pos, BOX))
    pj = {"ipos": ij, "mass": jnp.asarray(mass), "vel": jnp.asarray(vel),
          "entvar": jnp.asarray(entvar)}
    dj = jd.density_walk_dense(pj, ij[sel], jnp.asarray(vel)[sel],
                               jnp.asarray(hsml)[sel], BOX)
    pt = {k: _t(np.asarray(v)) for k, v in pj.items()}
    dt = td.density_walk_dense(pt, pt["ipos"][sel], _t(vel)[sel],
                               _t(hsml)[sel], BOX)
    for name, a, b in zip(dj._fields, dj, dt):
        assert _rel(a, b) < 2e-5, name


@pytest.mark.parametrize("spec,egy", [("cubic", True), ("quintic", True),
                                      ("quintic", False)])
def test_density_hsml_loop_parity(spec, egy):
    """The full adaptive-H loop on the stencil engine, from one guess,
    with the pressure-entropy outputs (egy) or the density-entropy ones
    (DensityIndependentSphOn 0)."""
    pos, mass, vel, entvar = _gas(500, 47)
    n = len(pos)
    sep = BOX / n ** (1 / 3)
    hsml0 = np.full(n, 1.8 * sep, np.float32)
    ij = jnp.asarray(j_f2i(pos, BOX))
    tree = j_octree(ij, jnp.asarray(mass), jnp.ones(n, bool), BOX,
                    nlevels=7, ncrit=16)
    payload = jd.make_gas_payload(tree, jnp.asarray(vel),
                                  jnp.asarray(entvar))
    dj = jd.density(tree, payload, ij, jnp.asarray(vel), jnp.asarray(entvar),
                    hsml0, BOX, jk.KERNELS[spec], eta=1.0,
                    ngb_deviation=0.5, do_egy_density=egy, engine="stencil")
    it = _t(np.asarray(ij))
    pt = {"ipos": it, "mass": _t(mass), "vel": _t(vel), "entvar": _t(entvar)}
    dt = td.density(pt, it, _t(vel), _t(entvar), _t(hsml0), BOX,
                    tk.KERNELS[spec], eta=1.0, ngb_deviation=0.5,
                    do_egy_density=egy)
    assert dt.niter == dj.niter
    hj, ht = np.asarray(dj.hsml), dt.hsml.numpy()
    rel = np.abs(ht - hj) / hj
    assert (rel < 1e-5).mean() >= 0.99 and rel.max() < 5e-3, rel.max()
    match = rel < 1e-5
    np.testing.assert_allclose(dt.density.numpy()[match],
                               np.asarray(dj.density)[match], rtol=2e-4)
    for f in ("egy_wt_density", "dhsml_egy_density_factor", "div_vel",
              "dt_hsml"):
        assert _rel(np.asarray(getattr(dj, f))[match],
                    getattr(dt, f).numpy()[match]) < 2e-4, f


def test_density_walk_blocked_parity():
    """The blocked octree walk (the IC fixed point's engine) on a
    clustered set, against the JAX blocked walk."""
    pos, mass, vel, entvar = _gas(700, 48)
    n = len(pos)
    sep = BOX / n ** (1 / 3)
    hsml = np.random.default_rng(49).uniform(1.5, 2.5, n).astype(
        np.float32) * sep
    ij = jnp.asarray(j_f2i(pos, BOX))
    jt = j_octree(ij, jnp.asarray(mass), jnp.ones(n, bool), BOX, nlevels=6,
                  ncrit=16)
    pj = jd.make_gas_payload(jt, jnp.asarray(vel), jnp.asarray(entvar))
    maxl = 64
    while True:
        rj, info = jd.density_walk_blocked(
            jt, pj, ij, jnp.asarray(vel), jnp.asarray(hsml), BOX,
            ncrit=16, maxl=maxl, block=64)
        if not bool(info["list_overflow"]):
            break
        maxl *= 2
    it = _t(np.asarray(ij))
    tt = build_octree(it, _t(mass), torch.ones(n, dtype=torch.bool), BOX,
                      nlevels=6, ncrit=16)
    pt = td.make_gas_payload(tt, _t(vel), _t(entvar))
    rt, tinfo = td.density_walk_blocked(tt, pt, it, _t(vel), _t(hsml), BOX,
                                        ncrit=16, block=64)
    assert bool(tinfo["leaf_truncated"]) == bool(info["leaf_truncated"])
    for name, a, b in zip(rj._fields, rj, rt):
        assert _rel(a, b) < 2e-5, name


def test_update_hsml_parity():
    """One bisection/Newton update from seeded neighbour counts."""
    rng = np.random.default_rng(5)
    n = 4000
    h = rng.uniform(100, 500, n).astype(np.float32)
    ngb = rng.uniform(0, 120, n).astype(np.float32)
    dh = rng.normal(0, 1e-3, n).astype(np.float32)
    rho = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    left = np.where(rng.uniform(size=n) < 0.5, 0.0, 0.5 * h
                    ).astype(np.float32)
    right = np.where(rng.uniform(size=n) < 0.5, BOX, 2.0 * h
                     ).astype(np.float32)
    done = rng.uniform(size=n) < 0.1
    sj = jd.update_hsml(jd.HsmlState(*(jnp.asarray(x) for x in
                                       (h, left, right, done))),
                        jnp.asarray(ngb), jnp.asarray(dh), jnp.asarray(rho),
                        57.9, 2.0, BOX)
    st = td.update_hsml(td.HsmlState(*(_t(x) for x in
                                       (h, left, right, done))),
                        _t(ngb), _t(dh), _t(rho), 57.9, 2.0, BOX)
    for a, b in zip(sj, st):
        a, b = np.asarray(a), b.numpy()
        if a.dtype == bool:
            assert np.array_equal(a, b)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6)


@pytest.mark.parametrize("k, hlo, hhi, branch", [
    (4, 0.12, 0.18, "stencil"),     # W = 7: 8 W^3 < 8^4
    (5, 0.15, 0.2, "stencil"),      # W = 14: 8 W^3 < 8^5
    (4, 0.19, 0.22, "dense"),       # W >= 8: the window holds 8^4 / 8
])
def test_cover_patch_equals_dense_patch(monkeypatch, k, hlo, hhi, branch):
    """Targets whose sub-blocks outgrow the W = 7 window (hsml of a fifth
    of the box) redone one per sub-block on a wider window, or against
    every source where that window would hold an eighth of the grid: the
    sums of the JAX package's all-sources patch either way."""
    pos, mass, vel, entvar = _gas(600, 46, clustered=False)
    n = len(pos)
    rng = np.random.default_rng(50)
    hsml = rng.uniform(hlo, hhi, n).astype(np.float32) * BOX
    ij = jnp.asarray(j_f2i(pos, BOX))
    it = _t(np.asarray(ij))
    pt = {"ipos": it, "mass": _t(mass), "vel": _t(vel),
          "entvar": _t(entvar)}
    grid = tsd.build_grid_sph(it, pt["mass"], pt["vel"], pt["entvar"], k)
    _, cover, nc = tsd.stencil_density_walk(grid, it, pt["vel"], _t(hsml),
                                            BOX, k)
    assert nc > 0 and int(cover.sum()) > 0.25 * n
    sel = torch.nonzero(cover).squeeze(1)
    calls = {"stencil": 0, "dense": 0}
    walk, dense = tsd.stencil_density_walk, td.density_walk_dense

    def one_target_walk(*a, **kw):
        assert kw["sub"] == 1
        calls["stencil"] += 1
        return walk(*a, **kw)

    def all_sources(*a, **kw):
        calls["dense"] += 1
        return dense(*a, **kw)

    monkeypatch.setattr(tsd, "stencil_density_walk", one_target_walk)
    monkeypatch.setattr(td, "density_walk_dense", all_sources)
    got = td.cover_patch(grid, pt, it[sel], pt["vel"][sel],
                         _t(hsml)[sel], BOX, k, tk.CUBIC, {})
    assert calls[branch] > 0 and sum(calls.values()) == calls[branch]
    pj = {"ipos": ij, "mass": jnp.asarray(mass), "vel": jnp.asarray(vel),
          "entvar": jnp.asarray(entvar)}
    s_ = sel.numpy()
    want = jd.density_walk_dense(pj, ij[s_], jnp.asarray(vel)[s_],
                                 jnp.asarray(hsml)[s_], BOX)
    for name, a, b in zip(want._fields, want, got):
        assert _rel(a, b) < 2e-5, name
