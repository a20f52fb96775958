"""The port's deep octree (two-word Morton keys past level 10,
shenqi_tpu_torch/ops/tree.py) against the JAX package's on the CPU, and
the velocity dispersion that retries into it.

  * build_octree at nlevels 11-20: the sort order, cell ranges, live
    counts, topology and geometric centres bit-exact, the cell masses
    within 1e-6 relative (f32 segment sums), dead rows included;
  * dm_velocity_dispersion on a clump of 64 DM particles inside one
    1-unit cube of a 5000-unit box among 2,000 uniform ones: no level-10
    leaf holds fewer than 64 rows there, so the walk retries past level
    10.  sigma, radius and density within 1e-4 relative, as
    tests/test_torch_veldisp.py holds them;
  * the same clump, with stars, through black-hole dynamical friction's
    call (DM and stars, the BH as the target, 2 mean separations as the
    first radius): sigma, density and the friction kick within 1e-4.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from shenqi_tpu.core.particles import float_to_ipos as j_ipos
from shenqi_tpu.ops import tree as jtree
from shenqi_tpu.physics import veldisp as jv
from shenqi_tpu.physics import blackhole as jbh
from shenqi_tpu_torch.core.particles import float_to_ipos as t_ipos
from shenqi_tpu_torch.ops import tree as ttree
from shenqi_tpu_torch.physics import veldisp as tv
from shenqi_tpu_torch.physics import blackhole as tbh
from torch_oracle import JAX_RETRIES, shared

torch.set_num_threads(2)
BOX = 5000.0
RTOL = 1e-4


def _clump(nstar=0, seed=0):
    """2,000 uniform DM rows and 64 (+ nstar) rows in the unit cube at
    (1234.5, 2345.5, 3456.5); velocities ~ N(0, 10) per axis."""
    rng = np.random.RandomState(seed)
    nu, nc = 2000, 64 + nstar
    pos = np.concatenate([rng.uniform(0, BOX, (nu, 3)),
                          np.array([1234.0, 2345.0, 3456.0])
                          + rng.uniform(0, 1, (nc, 3))])
    vel = rng.normal(0, 10.0, (nu + nc, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, nu + nc).astype(np.float32)
    return pos, vel, mass


def _jax_sigma(out, pos, vel, mass, alive, targets, r0, kw):
    js = jv.dm_velocity_dispersion(
        jnp.asarray(j_ipos(pos, BOX)), jnp.asarray(vel), jnp.asarray(mass),
        jnp.asarray(alive), jnp.asarray(j_ipos(targets, BOX)), r0, BOX,
        0.5, **kw)
    return [np.asarray(a, np.float64) for a in js]


def _sigma_both(factory, name, pos, vel, mass, alive, targets, r0, **kw):
    """The JAX package's sigma, radius and density in a spawned process
    (torch_oracle.shared: its veldisp compile at these depths has
    aborted a test worker), and the port's here."""
    js = shared(factory, name, _jax_sigma, pos, vel, mass, alive, targets,
                r0, kw, retries=JAX_RETRIES)
    ts = tv.dm_velocity_dispersion(
        t_ipos(pos, BOX, device="cpu"), torch.from_numpy(vel),
        torch.from_numpy(mass), torch.from_numpy(alive),
        t_ipos(targets, BOX, device="cpu"), torch.from_numpy(r0), BOX,
        0.5, **kw)
    return js, [b.numpy().astype(np.float64) for b in ts]


@pytest.mark.parametrize("nlevels", [11, 14, 17, 20])
def test_deep_octree_parity(nlevels):
    pos, _, mass = _clump()
    rng = np.random.RandomState(nlevels)
    alive = rng.uniform(size=len(pos)) > 0.05
    # positions at 2^31 and above lie in the upper half of every axis
    assert (pos > BOX / 2).any()
    tj = jtree.build_octree(jnp.asarray(j_ipos(pos, BOX)),
                            jnp.asarray(mass), jnp.asarray(alive), BOX,
                            nlevels=nlevels, ncrit=8)
    tt = ttree.build_octree(t_ipos(pos, BOX, device="cpu"),
                            torch.from_numpy(mass), torch.from_numpy(alive),
                            BOX, nlevels=nlevels, ncrit=8)
    np.testing.assert_array_equal(tt.order.numpy(), np.asarray(tj.order))
    for f in ("pstart", "pcount", "child", "nchild", "is_leaf", "valid",
              "center", "length"):
        np.testing.assert_array_equal(
            getattr(tt, f).numpy(), np.asarray(getattr(tj, f)), err_msg=f)
    np.testing.assert_allclose(tt.mass.numpy(), np.asarray(tj.mass),
                               rtol=1e-6)
    assert tt.root_child == int(tj.root_child)
    # the clump's 64 rows share one cell down to level 12 at least
    deepest = tt.pcount[-(len(pos) + 1):].numpy()
    assert deepest.max() < 64 or nlevels <= 12


def test_deep_octree_refuses_past_20():
    pos, _, mass = _clump()
    with pytest.raises(ValueError, match="nlevels=21"):
        ttree.build_octree(t_ipos(pos, BOX, device="cpu"),
                           torch.from_numpy(mass),
                           torch.ones(len(pos), dtype=torch.bool), BOX,
                           nlevels=21)


def test_veldisp_deep_clump(monkeypatch, tmp_path_factory):
    """C.5's reproduction: the port raised TreeTooShallow at level 10."""
    pos, vel, mass = _clump()
    alive = np.ones(len(pos), bool)
    targets = np.array([[1234.5, 2345.5, 3456.5], [400.0, 4000.0, 2500.0]])
    r0 = np.full(2, 20.0, np.float32)
    levels = []
    build = tv.build_octree

    def spy(*a, **kw):
        levels.append(kw["nlevels"])
        return build(*a, **kw)

    monkeypatch.setattr(tv, "build_octree", spy)
    (js, jr, jrho), (ts, tr, trho) = _sigma_both(
        tmp_path_factory, "tree_deep_clump", pos, vel, mass, alive,
        targets, r0)
    for a, b in ((js, ts), (jr, tr), (jrho, trho)):
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, rtol=RTOL)
    assert levels[-1] > ttree.MAX_DEPTH
    # 10 per axis at a = 0.5: a peculiar sigma near 20
    assert (ts > 10).all() and (ts < 30).all()


def test_dynamical_friction_deep_clump(tmp_path_factory):
    """The BH stage's call (simulation_gas.blackhole_step): the DM and
    star rows as sources, a BH at the clump as the target."""
    pos, vel, mass = _clump(nstar=24, seed=1)
    alive = np.ones(len(pos), bool)
    bh_pos = np.array([[1234.5, 2345.5, 3456.5]])
    sep = BOX / len(pos) ** (1 / 3)
    r0 = np.full(1, np.float32(2 * sep), np.float32)
    (js, _, jrho), (ts, _, trho) = _sigma_both(
        tmp_path_factory, "tree_deep_friction", pos, vel, mass, alive,
        bh_pos, r0, nlevels=10, ncrit=32)
    np.testing.assert_allclose(ts, js, rtol=RTOL)
    np.testing.assert_allclose(trho, jrho, rtol=RTOL)
    bh_vel = np.array([[30.0, -20.0, 5.0]], np.float32)
    bh_mass = np.array([2e-4], np.float32)
    G, atime = 43007.1, 0.5
    aj = np.asarray(jbh.dynamical_friction(
        jnp.asarray(bh_vel), jnp.asarray(jrho, jnp.float32),
        jnp.asarray(js, jnp.float32), jnp.asarray(bh_mass), atime, G))
    at = tbh.dynamical_friction(
        torch.from_numpy(bh_vel), torch.from_numpy(trho.astype(np.float32)),
        torch.from_numpy(ts.astype(np.float32)), torch.from_numpy(bh_mass),
        atime, G).numpy()
    assert np.isfinite(at).all() and np.abs(at).max() > 0
    np.testing.assert_allclose(at, aj, rtol=RTOL)
