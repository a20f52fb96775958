"""The port's lensing planes (shenqi_tpu_torch/physics/plane.py) against
the JAX package's on the CPU, mirroring tests/test_plane.py and
tests/test_plane_deposit.py:

  * plane_counts_ipos (torch, int64 on the unsigned positions) against
    the JAX deposit (uint32, 16-bit limbs) and an independent numpy
    reference: counts and n_plane bit-exact, on random uint32 positions
    (half of them 2^31 and above), a slab that wraps the box edge, and
    the whole box;
  * the host float64 functions (omega_source, cut_plane_from_counts,
    cut_plane_gaussian_grid, write_planes_deposit, write_planes, the
    FITS writer and reader) are the JAX package's source, and the FITS
    files of both packages' write_planes_deposit are byte-identical.
"""

import inspect
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from shenqi_tpu.cosmology.background import Cosmology as JCosmology
from shenqi_tpu.physics import plane as jp
from shenqi_tpu.utils.units import get_unitsystem as j_units
from shenqi_tpu_torch.cosmology.background import Cosmology as TCosmology
from shenqi_tpu_torch.physics import plane as tp
from shenqi_tpu_torch.utils.units import get_unitsystem as t_units

BOX = 250.0
RES = 64
CASES = [(0, 60.0, 50.0), (2, 240.0, 40.0), (1, 5.0, 30.0),
         (1, 125.0, 250.0)]


def _ref_counts(ipos, alive, normal, center, thickness):
    d0, d1 = (normal + 1) % 3, (normal + 2) % 3
    off = int(round(((center - thickness / 2) % BOX) / BOX * 2 ** 32))
    rel = (ipos[:, normal].astype(np.uint64)
           - np.uint64(off)) % np.uint64(2 ** 32)
    thick_u = int(round(thickness / BOX * 2 ** 32))
    in_slab = alive & ((rel < np.uint64(thick_u)) | (thickness >= BOX))
    i0 = (ipos[:, d0].astype(np.uint64) * RES) >> np.uint64(32)
    i1 = (ipos[:, d1].astype(np.uint64) * RES) >> np.uint64(32)
    cnt = np.zeros((RES, RES), np.int64)
    np.add.at(cnt, (i0[in_slab].astype(int), i1[in_slab].astype(int)), 1)
    return cnt, int(in_slab.sum())


@pytest.mark.parametrize("case", CASES,
                         ids=["x", "z_edge", "y_wrap", "whole_box"])
def test_plane_counts_bit_exact(case):
    normal, center, thickness = case
    rng = np.random.RandomState(7)
    n = 20000
    ipos = rng.randint(0, 2 ** 32, (n, 3), dtype=np.uint32)
    ipos[:8] = [2 ** 32 - 1, 2 ** 31, 0]
    alive = rng.rand(n) < 0.9
    cj, nj = jp.plane_counts_ipos(jnp.asarray(ipos), jnp.asarray(alive),
                                  BOX, normal, center, thickness, RES)
    ct, nt = tp.plane_counts_ipos(
        torch.from_numpy(ipos.view(np.int32)), torch.from_numpy(alive),
        BOX, normal, center, thickness, RES)
    ref, nref = _ref_counts(ipos, alive, normal, center, thickness)
    assert ct.dtype == torch.int32 and ct.shape == (RES, RES)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(ct.numpy(), ref)
    assert int(nt) == int(nj) == nref == int(ct.sum())


@pytest.mark.parametrize("name", [
    "omega_source", "cut_plane_gaussian_grid", "cut_plane_from_counts",
    "write_planes_deposit", "_fits_card", "write_fits_plane",
    "read_fits_plane", "write_planes"])
def test_host_functions_are_the_originals(name):
    src = [inspect.getsource(getattr(m, name)) for m in (jp, tp)]
    if name == "write_planes_deposit":
        # the docstring names the port's own caller
        src = [s[s.index('"""', s.index('"""') + 3):] for s in src]
    assert src[0] == src[1]
    assert vars(tp.PlaneParams()) == vars(jp.PlaneParams())


def test_fits_bytes(tmp_path):
    kw = dict(Omega0=0.3, OmegaLambda=0.7, OmegaBaryon=0.05,
              HubbleParam=0.7, CMBTemperature=2.7255, RadiationOn=1)
    args = (3.085678e21, 1.989e43, 1e5)
    cj, ct = JCosmology(**kw), TCosmology(**kw)
    cj.init(0.1, j_units(*args))
    ct.init(0.1, t_units(*args))
    rng = np.random.RandomState(3)
    n = 30000
    ipos = rng.randint(0, 2 ** 32, (n, 3), dtype=np.uint32)
    alive = rng.rand(n) < 0.95
    par_j = jp.PlaneParams(Resolution=RES, Thickness=80.0,
                           CutPoints=[60.0, 200.0], Normals=[0, 1, 2])
    par_t = tp.PlaneParams(Resolution=RES, Thickness=80.0,
                           CutPoints=[60.0, 200.0], Normals=[0, 1, 2])

    def dep_j(normal, center, thickness):
        return jp.plane_counts_ipos(jnp.asarray(ipos), jnp.asarray(alive),
                                    BOX, normal, center, thickness, RES)

    def dep_t(normal, center, thickness):
        c, k = tp.plane_counts_ipos(
            torch.from_numpy(ipos.view(np.int32)), torch.from_numpy(alive),
            BOX, normal, center, thickness, RES)
        return c.numpy(), int(k)

    ntot = int(alive.sum())
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    fj = jp.write_planes_deposit(3, 0.5, cj, dep_j, ntot, BOX,
                                 str(tmp_path / "j"), 1e5, 3.085678e21,
                                 par_j)
    ft = tp.write_planes_deposit(3, 0.5, ct, dep_t, ntot, BOX,
                                 str(tmp_path / "t"), 1e5, 3.085678e21,
                                 par_t)
    assert [os.path.basename(f) for f in ft] \
        == [os.path.basename(f) for f in fj]
    assert len(ft) == 6
    for a, b in zip(fj, ft):
        with open(a, "rb") as x, open(b, "rb") as y:
            assert x.read() == y.read(), b
    hdr, data = tp.read_fits_plane(ft[0])
    assert int(hdr["NPART"]) > 0 and np.isfinite(data).all()
