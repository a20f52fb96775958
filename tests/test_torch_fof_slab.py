"""The port's slab FOF (shenqi_tpu_torch/fof/slab.py) on gloo ranks
against the JAX package's single-device fof_label and compile_groups,
on tests/test_fof_slab.py's state (4,000 rows: clumps straddling slab
faces and a filament across several slabs, b = 0.8 mean separations):

  * fof_label_slab's labels, every row's minimum-pid group label, equal
    to the JAX labels bit for bit, on D = 2 with cost-balanced cuts and
    D = 4 uniform slabs (the filament needs cross-rank rounds);
  * compile_groups_slab_distributed's catalogue (each group reduced on
    its owner rank, the centre of mass unwrapped against the group's
    minimum-id row) and compile_groups_from_slab's against the JAX
    compile_groups of the whole state: the same groups and lengths,
    masses to rtol 2e-5, centres within 1e-2 mean separations,
    velocities to rtol 5e-4 (test_fof_slab.py's limits), every row's
    group number.
"""

import numpy as np
import torch

from test_torch_slab_domain import spawn_ranks

BOX = 1000.0


def _config(n=4000, seed=11):
    """tests/test_fof_slab.py's clumps and filament."""
    rng = np.random.RandomState(seed)
    nf = n - n // 2 - 3 * (n // 8)
    pos = np.concatenate([
        rng.uniform(0, BOX, (n // 2, 3)),
        rng.normal([125, 300, 300], 12, (n // 8, 3)) % BOX,
        rng.normal([250, 700, 200], 10, (n // 8, 3)) % BOX,
        rng.normal([500, 500, 500], 15, (n // 8, 3)) % BOX,
        np.stack([rng.uniform(300, 900, nf),
                  np.full(nf, 111.0) + rng.normal(0, 2, nf),
                  np.full(nf, 222.0) + rng.normal(0, 2, nf)],
                 axis=-1) % BOX])
    rng = np.random.RandomState(4)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    vel = rng.normal(0, 5, (n, 3)).astype(np.float32)
    return pos, mass, vel


def _link():
    return 0.2 * BOX / np.cbrt(4000) * 4


def _fof_body(rank, dev, out, ndev, balanced):
    from shenqi_tpu_torch.core.particles import float_to_ipos
    from shenqi_tpu_torch.fof.slab import (compile_groups_from_slab,
                                           compile_groups_slab_distributed,
                                           fof_label_slab)
    from shenqi_tpu_torch.parallel.domain import distribute_slabs
    from test_torch_slab_domain import _cuts
    pos, mass, vel = _config()
    ipos = float_to_ipos(pos, BOX, device="cpu").numpy()
    cuts = _cuts(ipos.view(np.uint32), ndev) if balanced else None
    loc = distribute_slabs({"ipos": ipos, "mass": mass, "vel": vel,
                            "pid": np.arange(len(pos))}, ndev, rank, cuts)
    f = {k: torch.from_numpy(v) for k, v in loc.items()}
    f["ptyp"] = torch.ones(len(loc["mass"]), dtype=torch.int8)
    glabel, info = fof_label_slab(f, _link(), BOX, ndev, cuts_in=cuts)
    g, pid = compile_groups_slab_distributed(glabel, f, BOX, ndev,
                                             min_length=8)
    h, hpid = compile_groups_from_slab(glabel, f, BOX, min_length=8)
    np.savez(f"{out}/rank{rank}.npz", pid=loc["pid"], glabel=glabel.numpy(),
             rounds=info["rounds"], lengths=g.lengths, masses=g.masses,
             cm=g.cm, vel=g.vel, group_id=g.group_id, gid_pid=pid,
             h_lengths=h.lengths, h_masses=h.masses, h_cm=h.cm)


def _canon(lengths, cm):
    """Groups of equal length in a fixed order (the host version numbers
    ties by gathered row, not by id): test_fof_slab.py's key."""
    c = np.round(cm, 3)
    return np.lexsort((c[:, 2], c[:, 1], c[:, 0], -lengths))


def test_slab_fof_matches_jax(tmp_path):
    import jax.numpy as jnp
    from shenqi_tpu.core.particles import float_to_ipos
    from shenqi_tpu.fof.fof import compile_groups, fof_label
    pos, mass, vel = _config()
    n = len(pos)
    ipos = np.asarray(float_to_ipos(pos, BOX))
    lbl = np.asarray(fof_label(jnp.asarray(ipos), jnp.ones(n, bool),
                               _link(), BOX, nlevels=8, ncrit=32))
    ref = np.zeros(n, np.int64)             # min pid of each group
    for root in np.unique(lbl):
        sel = lbl == root
        ref[sel] = np.min(np.nonzero(sel)[0])
    want = compile_groups(ref, ipos, vel, mass, np.ones(n, np.int8),
                          np.ones(n, bool), BOX, min_length=8)
    G = want.ngroups
    assert G > 2
    msep = BOX / np.cbrt(n)
    kw = _canon(want.lengths, want.cm)
    for ndev, balanced in ((2, True), (4, False)):
        res = spawn_ranks(_fof_body, ndev, tmp_path / str(ndev), ndev,
                          balanced)
        got = np.full(n, -1, np.int64)
        for r in res:
            got[r["pid"]] = r["glabel"]
        np.testing.assert_array_equal(got, ref)
        if ndev == 4:
            assert int(res[0]["rounds"]) >= 2   # the filament crossed ranks
        r0 = res[0]
        for pre in ("", "h_"):
            k = _canon(r0[pre + "lengths"], r0[pre + "cm"])
            np.testing.assert_array_equal(r0[pre + "lengths"][k],
                                          want.lengths[kw])
            np.testing.assert_allclose(r0[pre + "masses"][k],
                                       want.masses[kw], rtol=2e-5)
            d = r0[pre + "cm"][k] - want.cm[kw]
            d -= BOX * np.round(d / BOX)
            assert np.abs(d).max() < 1e-2 * msep, pre
        # the distributed catalogue numbers ties by id, as compile_groups
        # does with minimum-id labels: the same order throughout
        np.testing.assert_allclose(r0["masses"], want.masses, rtol=2e-5)
        np.testing.assert_allclose(r0["vel"], want.vel, rtol=5e-4,
                                   atol=1e-3)
        # every rank's rows carry their group numbers
        gid = np.zeros(n, np.int64)
        for r in res:
            gid[r["gid_pid"]] = r["group_id"]
        np.testing.assert_array_equal(
            np.bincount(gid, minlength=G + 1)[1:], want.lengths)
