"""The port's DM velocity dispersion (shenqi_tpu_torch/physics/veldisp.py,
the blocked walk) against the JAX package's blocked engine on the CPU,
from one numpy seed: sigma and radius within 1e-4 relative (and the
mean density inside the radius, which follows from them), on a uniform
Maxwellian field (tests/test_veldisp.py's case) and on a clustered one
whose dense clump overflows the first octree's leaves (the deep-tree
retry).  The clustered case also holds the number of octree levels the
retry reached."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from shenqi_tpu.core.particles import float_to_ipos as j_ipos
from shenqi_tpu.physics import veldisp as jv
from shenqi_tpu_torch.core.particles import float_to_ipos as t_ipos
from shenqi_tpu_torch.physics import veldisp as tv
from shenqi_tpu_torch.ops import tree as ttree

torch.set_num_threads(2)
BOX = 20000.0


def _case(kind):
    rng = np.random.RandomState(0)
    ndm = 4000
    pos = rng.uniform(0, BOX, (ndm, 3))
    if kind == "clump":
        # a quarter of the DM inside a sphere of 2% of the box
        k = ndm // 4
        pos[:k] = 0.4 * BOX + rng.normal(0, 0.01 * BOX, (k, 3))
    vel = rng.normal(0, 50.0, (ndm, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, ndm).astype(np.float32)
    alive = rng.uniform(size=ndm) > 0.02
    gas = np.concatenate([rng.uniform(0.2 * BOX, 0.8 * BOX, (48, 3)),
                          0.4 * BOX + rng.normal(0, 0.01 * BOX, (16, 3))])
    sep = BOX / ndm ** (1 / 3)
    r0 = (2 * sep * rng.uniform(0.5, 1.5, len(gas))).astype(np.float32)
    return pos, vel, mass, alive, gas, r0


@pytest.mark.parametrize("kind", ["uniform", "clump"])
def test_veldisp_parity(kind, monkeypatch):
    pos, vel, mass, alive, gas, r0 = _case(kind)
    js, jr, jrho = jv.dm_velocity_dispersion(
        jnp.asarray(j_ipos(pos, BOX)), jnp.asarray(vel), jnp.asarray(mass),
        jnp.asarray(alive), jnp.asarray(j_ipos(gas, BOX)), r0, BOX, 0.5,
        nlevels=3)
    levels = []
    build = tv.build_octree

    def spy(*a, **kw):
        levels.append(kw["nlevels"])
        return build(*a, **kw)

    monkeypatch.setattr(tv, "build_octree", spy)
    ts, tr, trho = tv.dm_velocity_dispersion(
        t_ipos(pos, BOX, device="cpu"), torch.from_numpy(vel),
        torch.from_numpy(mass), torch.from_numpy(alive),
        t_ipos(gas, BOX, device="cpu"), torch.from_numpy(r0), BOX, 0.5,
        nlevels=3)
    for a, b in ((js, ts), (jr, tr), (jrho, trho)):
        a = np.asarray(a, np.float64)
        assert np.isfinite(b.numpy()).all()
        assert (np.abs(a - b.numpy()) / np.abs(a)).max() < 1e-4
    assert np.median(np.asarray(js)) == pytest.approx(100.0, rel=0.2)
    if kind == "clump":
        assert levels[0] == 3 and len(levels) > 1 \
            and levels[-1] <= ttree.MAX_DEPTH
    else:
        assert levels == [3]
