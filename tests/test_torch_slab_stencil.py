"""The port's slab short range (shenqi_tpu_torch/parallel/sharded.py
stencil_forces_slab) on gloo ranks against the JAX package's
single-device stencilgrav on the same rows, at tests/test_slab_stencil.py's
limit (3e-4 of the largest force) and on its clustered state: 4,096
rows, box 1000, with the hierarchy's masked sources (every third row's
mass 0: ghosts carry only alive rows).  Mesh 32 and TreeRcut 4.5 make
the ghost strip (rcut and one stencil cell, 0.27 of the box) need two
ring hops at D = 4 on uniform slabs; D = 2 on cost-balanced cuts takes
_halo_a2a.  Each rank's rows are targets, its ghosts are not.
"""

import numpy as np
import torch

from test_torch_slab_domain import spawn_ranks

BOX, NMESH = 1000.0, 32
RCUT = 4.5              # TreeRcut: rcut = 0.14 of the box


def _clustered(n=4096, seed=0):
    """tests/test_slab_stencil.py's state: half uniform, half in 8 clumps."""
    rng = np.random.RandomState(seed)
    nu = n // 2
    pos_u = rng.uniform(0, BOX, (nu, 3))
    cc = rng.uniform(0, BOX, (8, 3))
    which = rng.randint(0, 8, n - nu)
    pos_c = (cc[which] + rng.normal(0, BOX / 40, (n - nu, 3))) % BOX
    mass = np.ones(n, np.float32)
    mass[::3] = 0.0
    return np.concatenate([pos_u, pos_c]), mass


def _params():
    from shenqi_tpu_torch.gravity.treepm import GravityConfig
    return GravityConfig(boxsize=BOX, nmesh=NMESH, G=43007.1,
                         softening=BOX / 32 / 30, rcut_cells=RCUT)


def _stencil_body(rank, dev, out, ndev, balanced):
    from shenqi_tpu_torch.core.particles import float_to_ipos
    from shenqi_tpu_torch.gravity.treepm import get_window_tables
    from shenqi_tpu_torch.parallel.domain import distribute_slabs
    from shenqi_tpu_torch.parallel.sharded import stencil_forces_slab
    from test_torch_slab_domain import _cuts
    pos, mass = _clustered()
    ipos = float_to_ipos(pos, BOX, device="cpu").numpy()
    cuts = _cuts(ipos.view(np.uint32), ndev) if balanced else None
    loc = distribute_slabs({"ipos": ipos, "mass": mass,
                            "pid": np.arange(len(pos))}, ndev, rank, cuts)
    g = _params()
    acc, info = stencil_forces_slab(
        {"ipos": torch.from_numpy(loc["ipos"]),
         "mass": torch.from_numpy(loc["mass"])},
        g.short(use_bh=1), get_window_tables(g, device="cpu"), ndev, cuts)
    np.savez(f"{out}/rank{rank}.npz", pid=loc["pid"], acc=acc.numpy(),
             ghosts=info["ghosts"], targets=info["targets"])


def test_slab_stencil_matches_jax_stencilgrav(tmp_path):
    import jax.numpy as jnp
    from shenqi_tpu.core.particles import float_to_ipos
    from shenqi_tpu.gravity.stencil import stencilgrav
    from shenqi_tpu.gravity.treepm import GravityConfig, get_window_tables
    from shenqi_tpu_torch.parallel.sharded import halo_width_fp
    pos, mass = _clustered()
    g = GravityConfig(boxsize=BOX, nmesh=NMESH, G=43007.1,
                      softening=BOX / 32 / 30, rcut_cells=RCUT)
    ref, _, _ = stencilgrav(jnp.asarray(float_to_ipos(pos, BOX)),
                            jnp.asarray(mass), g.short(use_bh=1),
                            get_window_tables(g))
    ref = np.asarray(ref)
    for ndev, balanced in ((2, True), (4, False)):
        res = spawn_ranks(_stencil_body, ndev, tmp_path / str(ndev), ndev,
                          balanced)
        pid = np.concatenate([r["pid"] for r in res])
        acc = np.concatenate([r["acc"] for r in res])
        assert sorted(pid) == list(range(len(pos)))
        alive = mass[pid] > 0
        assert sum(int(r["targets"]) for r in res) == int((mass > 0).sum())
        assert min(int(r["ghosts"]) for r in res) > 0
        np.testing.assert_allclose(acc[alive], ref[pid][alive],
                                   atol=3e-4 * np.abs(ref).max())
        assert not acc[~alive].any()
        w, slab = halo_width_fp(RCUT * BOX / NMESH, BOX), 2 ** 32 // ndev
        ring = not balanced and 2 * w <= (ndev - 1) * slab
        assert ring == (ndev == 4) and int(np.ceil(w / slab)) == ndev // 2
