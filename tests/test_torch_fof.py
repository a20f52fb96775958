"""The port's octree, neighbour traversal and FOF on the CPU: the cases of
tests/test_fof.py on the port, and the port against the JAX package from
the same seeded inputs.  FOF labels, group ids and
lengths are integers and must be identical; the catalogue's f64 sums to
rtol 1e-6 (measured: identical, the same numpy code on the same labels).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from shenqi_tpu.core.particles import float_to_ipos as j_float_to_ipos
from shenqi_tpu.fof import fof as jfof
from shenqi_tpu.ops import tree as jtree
from shenqi_tpu.ops import blockwalk as jbw

from shenqi_tpu_torch.core.particles import float_to_ipos
from shenqi_tpu_torch.fof import fof as tfof
from shenqi_tpu_torch.ops import tree as ttree
from shenqi_tpu_torch.ops import blockwalk as tbw

BOX = 60000.0


def _t(pos, box=BOX):
    return float_to_ipos(pos, box, device="cpu")


def _j(pos, box=BOX):
    return jnp.asarray(j_float_to_ipos(pos, box))


def _line():
    n = 100
    spacing = 50.0
    pos = np.zeros((n, 3))
    pos[:, 0] = (np.arange(n) * spacing) % BOX
    pos[:, 1] = BOX / 2
    pos[:, 2] = BOX / 2
    pos[:, 0] = (pos[:, 0] + BOX - spacing * n / 2) % BOX
    return pos, np.ones(n, np.int8), spacing / 0.15


def _two_clumps():
    rng = np.random.RandomState(5)
    n1, n2, nn = 200, 100, 50
    mean_sep = BOX / 30
    b = 0.2 * mean_sep
    c1 = np.array([BOX / 4] * 3)
    c2 = np.array([3 * BOX / 4] * 3)
    pos = np.concatenate([
        c1 + rng.uniform(-b, b, (n1, 3)) * 0.3,
        c2 + rng.uniform(-b, b, (n2, 3)) * 0.3,
        rng.uniform(0, BOX, (nn, 3))]) % BOX
    return pos, np.ones(len(pos), np.int8), mean_sep


def _corner():
    rng = np.random.RandomState(6)
    pos = rng.uniform(-200, 200, (64, 3)) % BOX
    return pos, np.ones(64, np.int8), 1000.0


def _secondary():
    rng = np.random.RandomState(7)
    ndm, ngas = 100, 40
    c = np.array([BOX / 2] * 3)
    pos = np.concatenate([c + rng.uniform(-100, 100, (ndm, 3)),
                          c + rng.uniform(-150, 150, (ngas, 3))]) % BOX
    ptype = np.concatenate([np.ones(ndm), np.zeros(ngas)]).astype(np.int8)
    return pos, ptype, 2000.0


def _port(pos, ptype, mean_sep, vel=None, mass=None):
    n = len(pos)
    vel = np.zeros((n, 3), np.float32) if vel is None else vel
    mass = np.ones(n, np.float32) if mass is None else mass
    return tfof.fof(_t(pos), vel, mass, ptype, np.ones(n, bool), BOX,
                    mean_sep)


def _jax(pos, ptype, mean_sep, vel, mass):
    return jfof.fof(_j(pos), vel, mass, ptype, np.ones(len(pos), bool), BOX,
                    mean_sep)


def _same_catalogue(gj, gt):
    assert gt.ngroups == gj.ngroups
    np.testing.assert_array_equal(gt.group_id, gj.group_id)
    np.testing.assert_array_equal(gt.lengths, gj.lengths)
    np.testing.assert_array_equal(gt.length_by_type, gj.length_by_type)
    for f in ("masses", "cm", "vel", "mass_by_type", "first_pos"):
        np.testing.assert_allclose(getattr(gt, f), getattr(gj, f),
                                   rtol=1e-6, atol=0, err_msg=f)


def test_fof_line():
    """tests/test_fof.py::test_fof_line on the port: a chain across the
    periodic wrap links into one group."""
    pos, ptype, sep = _line()
    gt = _port(pos, ptype, sep)
    assert gt.ngroups == 1 and gt.lengths[0] == len(pos)
    assert gt.masses[0] == pytest.approx(len(pos), rel=1e-5)
    assert np.all(gt.group_id == 1)


def test_fof_two_clumps_and_noise():
    pos, ptype, sep = _two_clumps()
    rng = np.random.RandomState(5)
    vel = rng.normal(size=(len(pos), 3)).astype(np.float32)
    mass = np.full(len(pos), 2.0, np.float32)
    gt = _port(pos, ptype, sep, vel=vel, mass=mass)
    assert gt.ngroups == 2
    assert list(gt.lengths) == [200, 100]
    np.testing.assert_allclose(gt.masses, [400.0, 200.0], rtol=1e-5)
    b = 0.2 * sep
    np.testing.assert_allclose(gt.cm[0], [BOX / 4] * 3, atol=b)
    np.testing.assert_allclose(gt.cm[1], [3 * BOX / 4] * 3, atol=b)
    assert (gt.group_id[300:] == 0).all()


def test_fof_cm_periodic_wrap():
    pos, ptype, sep = _corner()
    gt = _port(pos, ptype, sep)
    assert gt.ngroups == 1
    d = gt.cm[0] - BOX * np.round(gt.cm[0] / BOX)
    assert np.linalg.norm(d) < 300


def test_fof_secondary_attach():
    pos, ptype, sep = _secondary()
    gt = _port(pos, ptype, sep)
    assert gt.ngroups == 1 and (gt.group_id == 1).all()
    assert gt.length_by_type[0, 0] == 40 and gt.length_by_type[0, 1] == 100
    assert gt.lengths[0] == 140


def _clusters(seed=7, box=20000.0):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0, box, (8, 3))
    return np.vstack([(centers.repeat(50, 0)
                       + rng.normal(0, 40, (400, 3))) % box,
                      rng.uniform(0, box, (300, 3))])


def test_fof_label_engines_agree():
    """tests/test_fof.py::test_fof_label_engines_agree: the port's
    blocked labels equal both JAX engines' labels, with one dead row; the
    per-particle engine is refused on the port."""
    box = 20000.0
    pos = _clusters(box=box)
    n = len(pos)
    alive = np.ones(n, bool)
    alive[5] = False
    b = 0.2 * box / n ** (1 / 3)
    la = np.asarray(jfof.fof_label(_j(pos, box), alive, b, box,
                                   engine="blocked"))
    lb = np.asarray(jfof.fof_label(_j(pos, box), alive, b, box,
                                   engine="perparticle"))
    lt = tfof.fof_label(_t(pos, box), torch.from_numpy(alive), b, box)
    assert np.array_equal(la, lb)
    assert np.array_equal(lt.numpy(), la.astype(np.int64))
    with pytest.raises(NotImplementedError, match="A.10"):
        tfof.fof_label(_t(pos, box), torch.from_numpy(alive), b, box,
                       engine="perparticle")


def _clustered_state(n_side=16, seed=11, box=BOX):
    """Zel'dovich-clustered lattice with a few tight clumps, every
    fourth particle gas (a secondary)."""
    rng = np.random.RandomState(seed)
    n = n_side ** 3
    g = (np.arange(n_side) + 0.5) * box / n_side
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    pos = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1)
    pos += rng.normal(0, 0.3 * box / n_side, (n, 3))
    clump = rng.choice(n, n // 3, replace=False)
    centers = rng.uniform(0, box, (6, 3))
    pos[clump] = centers[np.arange(len(clump)) % 6] \
        + rng.normal(0, 0.08 * box / n_side, (len(clump), 3))
    # positions at and above 2^31 of the box are there (C.1)
    pos = pos % box
    ptype = np.ones(n, np.int8)
    ptype[::4] = 0
    vel = rng.normal(0, 50, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return pos, ptype, vel, mass


def test_octree_order_and_ranges():
    """build_octree: the same sort order, cell ranges, topology and
    live counts as the JAX tree (dead rows included)."""
    pos, ptype, _, mass = _clustered_state()
    alive = ptype == 1
    tj = jtree.build_octree(_j(pos), jnp.asarray(mass), jnp.asarray(alive),
                            BOX, nlevels=8, ncrit=32)
    tt = ttree.build_octree(_t(pos), torch.from_numpy(mass),
                            torch.from_numpy(alive), BOX, nlevels=8,
                            ncrit=32)
    np.testing.assert_array_equal(tt.order.numpy(), np.asarray(tj.order))
    for f in ("pstart", "pcount", "child", "nchild", "is_leaf", "valid"):
        np.testing.assert_array_equal(
            getattr(tt, f).numpy(), np.asarray(getattr(tj, f)), err_msg=f)
    for f in ("center", "length"):
        np.testing.assert_array_equal(
            getattr(tt, f).numpy(), np.asarray(getattr(tj, f)), err_msg=f)
    np.testing.assert_allclose(tt.mass.numpy(), np.asarray(tj.mass),
                               rtol=1e-6)
    assert tt.root_child == int(tj.root_child)
    assert (np.asarray(tj.ipos_s).view(np.uint32)
            == tt.ipos_s.numpy().view(np.uint32)).all()


def test_bfs_lists_equal_walk_lists():
    """The port's frontier traversal gives every block the same set of
    leaves as the JAX sequential walk (block_traverse, the one fof.py
    runs) over the same blocks and radius."""
    pos, ptype, _, _ = _clustered_state()
    alive = ptype == 1
    n = len(pos)
    ones_j = jnp.ones(n, jnp.float32)
    tj = jtree.build_octree(_j(pos), ones_j, jnp.asarray(alive), BOX,
                            nlevels=8, ncrit=32)
    tt = ttree.build_octree(_t(pos), torch.ones(n), torch.from_numpy(alive),
                            BOX, nlevels=8, ncrit=32)
    nl = int(alive.sum())
    bj_lo, bj_hi, tj_idx, tj_valid, nbj = jbw.make_blocks_from_tree(
        tj, nl, 128, BOX)
    bt_lo, bt_hi, tt_idx, tt_valid = tbw.make_blocks_from_tree(
        tt, nl, 128, BOX)
    nb = bt_lo.shape[0]
    np.testing.assert_array_equal(bt_lo.numpy(), np.asarray(bj_lo)[:nb])
    np.testing.assert_array_equal(bt_hi.numpy(), np.asarray(bj_hi)[:nb])
    np.testing.assert_array_equal(tt_valid.numpy(),
                                  np.asarray(tj_valid)[:nb])
    assert not np.asarray(tj_valid)[nb:].any()
    rad = 0.2 * BOX / 16
    lj = jbw.block_traverse(tj, bj_lo, bj_hi,
                            jnp.full(nbj, rad, jnp.float32),
                            jnp.zeros(nbj, jnp.float32), BOX, 0.0, 0.0, 0,
                            maxi=8, maxl=512, mode="neighbor")
    assert not bool(jnp.any(lj.overflow))
    lt = tbw.block_traverse_bfs(tt, bt_lo, bt_hi,
                                torch.full((nb,), np.float32(rad)), BOX)
    ids, cnt = np.asarray(lj.leaf_ids), np.asarray(lj.n_leaves)
    blk, leaf = lt.block.numpy(), lt.leaf.numpy()
    for b in range(nb):
        mine = leaf[blk == b]
        assert set(mine.tolist()) == set(ids[b, :cnt[b]].tolist()), b
        # depth-first (ascending first row) order, as the walk emits
        np.testing.assert_array_equal(mine, ids[b, :cnt[b]])
    assert lt.leaf.numel() > nb


def test_fof_labels_and_catalogue_clustered_with_gas():
    """A seeded clustered 16^3 state with gas secondaries: primary labels,
    the secondary attach and the compiled catalogue all as in the JAX
    package."""
    pos, ptype, vel, mass = _clustered_state()
    n = len(pos)
    primary = ptype == 1
    mean_sep = BOX / 16
    b = 0.2 * mean_sep
    lj = np.asarray(jfof.fof_label(_j(pos), jnp.asarray(primary), b, BOX))
    lt = tfof.fof_label(_t(pos), torch.from_numpy(primary), b, BOX)
    np.testing.assert_array_equal(lt.numpy(), lj.astype(np.int64))
    assert len(np.unique(lj[primary])) < 0.8 * primary.sum()
    # the secondary attach on its own
    tj = jtree.build_octree(_j(pos), jnp.ones(n, jnp.float32),
                            jnp.asarray(primary), BOX, nlevels=8, ncrit=32)
    oj = np.asarray(tj.order)
    sec = np.nonzero(~primary)[0]
    sj, fj = jfof.fof_attach_secondary_blocked(
        tj, jnp.asarray(lj[oj]), jnp.asarray(primary[oj]),
        _j(pos)[sec], BOX, rmax=b)
    tt = ttree.build_octree(_t(pos), torch.ones(n), torch.from_numpy(primary),
                            BOX, nlevels=8, ncrit=32)
    ot = tt.order
    st, ft = tfof.fof_attach_secondary_blocked(
        tt, lt[ot], torch.from_numpy(primary)[ot], _t(pos)[sec], BOX,
        rmax=b)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(st.numpy()[ft.numpy()],
                                  np.asarray(sj)[np.asarray(fj)])
    gj = _jax(pos, ptype, mean_sep, vel, mass)
    gt = _port(pos, ptype, mean_sep, vel=vel, mass=mass)
    assert gt.ngroups >= 2
    assert gt.length_by_type[:, 0].sum() > 0
    _same_catalogue(gj, gt)


@pytest.mark.parametrize("max_links", [1 << 25, 0], ids=["links", "repass"])
def test_fof_labels_dense_clumps(monkeypatch, max_links):
    """Clumps dense enough that bottom-level leaves hold more than ncrit
    particles (whose tails are targets but no block's sources, so they
    link one way only), with the pairs within b kept and with the pass
    run again every iteration (more pairs than _MAX_LINKS): the labels
    equal the JAX package's."""
    monkeypatch.setattr(tfof, "_MAX_LINKS", max_links)
    rng = np.random.RandomState(12)
    box = 60000.0
    n_side = 12
    g = (np.arange(n_side) + 0.5) * box / n_side
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    pos = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1)
    centers = rng.uniform(0, box, (3, 3))
    pos = np.vstack([pos, centers.repeat(300, 0)
                     + rng.normal(0, 60.0, (900, 3))]) % box
    n = len(pos)
    alive = np.ones(n, bool)
    alive[::97] = False
    b = 0.2 * box / n_side
    stats = tfof.FOFStats()
    lt, tree = tfof._fof_label_tree(_t(pos, box), torch.from_numpy(alive),
                                    b, box, stats)
    assert int(tree.pcount[tree.child < 0].max()) > 32
    assert stats.repass == (max_links == 0)
    lj = np.asarray(jfof.fof_label(_j(pos, box), alive, b, box))
    np.testing.assert_array_equal(lt.numpy(), lj.astype(np.int64))
    assert np.bincount(lj[alive]).max() >= 250
