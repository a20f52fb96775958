"""The port's lightcone (shenqi_tpu_torch/physics/lightcone.py, host
numpy) against the JAX package's on the CPU, mirroring
tests/test_lightcone.py: the same crossings (positions, velocities, IDs,
Aemit and their order) from the same drifts, identical, with positions
given as the port's int32 bit patterns (values of 2^31 and above read as
unsigned) and as uint32; the replicas the port skips hold no crossing
(a box smaller than the lightcone radius, several replicas, and the
single-replica regime); masked rows never appear; the LIGHTCONE bigfile
byte-identical, empty or not.

Through both CLIs: a DM run near a = 0.95 (16^3 from the port's
genic_main at z = 0.05, box 256 Mpc/h, larger than the lightcone radius,
so the JAX package's replica loop stays short) with LightconeOn and
WritePlaneOn to a = 0.96 with FOF at 0.955 and 0.96: the LIGHTCONE rows
equal (IDs and their order; Aemit within 1e-6 relative, positions within
1e-9 of the box and velocities within 1e-4 of their max, the two runs'
trajectories being f32 ones), and the FITS planes' headers equal (NPART
the live count) with the potentials within 1e-4 of their max."""

import os

import numpy as np
import pytest
import torch

from chip_smoke import _GENIC, _GADGET, _eh_table
from shenqi_tpu.cli import gadget_main as jg
from shenqi_tpu.cosmology.background import Cosmology as JCosmology
from shenqi_tpu.core.particles import float_to_ipos
from shenqi_tpu.physics.lightcone import Lightcone as JLightcone
from shenqi_tpu.physics.plane import read_fits_plane
from shenqi_tpu.utils.units import default_units as j_units
from shenqi_tpu_torch.cli import gadget_main as tg
from shenqi_tpu_torch.cli.genic_main import run_genic as t_genic
from shenqi_tpu_torch.cosmology.background import Cosmology as TCosmology
from shenqi_tpu_torch.io.bigfile import BigFile
from shenqi_tpu_torch.physics.lightcone import Lightcone as TLightcone
from shenqi_tpu_torch.utils.units import default_units as t_units

torch.set_num_threads(2)
UNIT_V = 1e5
LC_BOX = 256000.0
KW = dict(Omega0=0.3, OmegaLambda=0.7, OmegaBaryon=0.05, HubbleParam=0.7,
          CMBTemperature=0.0, RadiationOn=0)


def _pair(box):
    cj, ct = JCosmology(**KW), TCosmology(**KW)
    cj.init(TimeBegin=0.01, units=j_units())
    ct.init(TimeBegin=0.01, units=t_units())
    return (JLightcone(CP=cj, boxsize=box, unit_velocity=UNIT_V),
            TLightcone(CP=ct, boxsize=box, unit_velocity=UNIT_V))


def _state(n, box, seed):
    rng = np.random.RandomState(seed)
    ipos = float_to_ipos(rng.uniform(0, box, (n, 3)), box)
    vel = rng.normal(0, 50, (n, 3)).astype(np.float32)
    ids = np.arange(7, 7 + n, dtype=np.uint64) + (np.uint64(3) << 32)
    mask = rng.uniform(size=n) > 0.1
    return ipos, vel, ids, mask


@pytest.mark.parametrize("box,n,drifts", [
    (30000.0, 3000, [(0.995, 0.998), (0.998, 0.999)]),
    (4000.0, 3000, [(0.998, 0.999), (0.999, 0.9995)]),
    (1000.0, 500, [(0.998, 0.9982)])],
    ids=["one_replica", "several", "many"])
def test_compute_parity(box, n, drifts):
    lj, lt = _pair(box)
    ipos, vel, ids, mask = _state(n, box, 0)
    assert (ipos >= 2 ** 31).any()
    bits = ipos.view(np.int32)
    for a0, a1 in drifts:
        nj = lj.compute(a0, a1, ipos, vel, ids, mask)
        nt = lt.compute(a0, a1, bits, vel, ids, mask)
        assert nt == nj
    assert sum(len(x) for x in lj.ids) > 0
    for f in ("positions", "velocities", "ids", "atimes"):
        a, b = getattr(lj, f), getattr(lt, f)
        assert len(a) == len(b), f
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x, err_msg=f)
            assert y.dtype == x.dtype
    assert not (np.concatenate(lt.ids)[:, None]
                == ids[~mask][None, :]).any()
    # uint32 positions give the same rows
    _, lu = _pair(box)
    for a0, a1 in drifts:
        lu.compute(a0, a1, ipos, vel, ids, mask)
    np.testing.assert_array_equal(np.concatenate(lu.positions),
                                  np.concatenate(lt.positions))


@pytest.mark.parametrize("nonempty", [True, False])
def test_save_bytes(tmp_path, nonempty):
    box = 4000.0
    lj, lt = _pair(box)
    if nonempty:
        ipos, vel, ids, mask = _state(1500, box, 2)
        lj.compute(0.998, 0.999, ipos, vel, ids, mask)
        lt.compute(0.998, 0.999, ipos.view(np.int32), vel, ids, mask)
    pj = lj.save(str(tmp_path / "LCj"))
    pt = lt.save(str(tmp_path / "LCt"))
    for blk in ("1/Position", "1/Velocity", "1/ID", "1/Aemit"):
        fj = sorted(os.listdir(os.path.join(pj, blk)))
        assert sorted(os.listdir(os.path.join(pt, blk))) == fj
        for f in fj:
            with open(os.path.join(pj, blk, f), "rb") as a, \
                    open(os.path.join(pt, blk, f), "rb") as b:
                assert a.read() == b.read(), (blk, f)


@pytest.fixture(scope="module")
def lc(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lc")
    pk = tmp / "pk.txt"
    _eh_table(pk)
    gp = tmp / "lc.genic"
    gp.write_text(_GENIC.format(out=tmp, ng=16, box=LC_BOX, pk=pk)
                  .replace("Redshift = 9", "Redshift = 0.05"))
    ic = t_genic(str(gp), device="cpu")
    out = {}
    for name, mod in (("jax", jg), ("torch", tg)):
        od = tmp / f"lc_{name}"
        pf = tmp / f"lc_{name}.gadget"
        pf.write_text(_GADGET.format(ic=ic, out=od, a=0.96, fof=1, nmesh=32)
                      .replace("OutputList = 0.96", "OutputList = 0.955,0.96")
                      + "LightconeOn = 1\nWritePlaneOn = 1\n"
                      "PlaneResolution = 64\n")
        out[name] = ((mod.run_gadget(str(pf)) if mod is jg
                      else mod.run_gadget(str(pf), device="cpu")), od)
    return out


def test_lightcone_cli_parity(lc):
    (sj, oj), (st, ot) = lc["jax"], lc["torch"]
    assert st.atime() == pytest.approx(sj.atime())
    assert st.lightcone_log and all(n >= 0 for _, _, n, _ in
                                    st.lightcone_log)
    bj, bt = BigFile(str(oj / "LIGHTCONE")), BigFile(str(ot / "LIGHTCONE"))
    ij, it = bj["1/ID"].read(), bt["1/ID"].read()
    assert len(it) > 0 and bt["1/Position"].dtype == np.dtype("<f8")
    np.testing.assert_array_equal(it, ij)
    for name, rel in (("Aemit", 1e-6), ("Position", 1e-9),
                      ("Velocity", 1e-4)):
        a, b = bj[f"1/{name}"].read(), bt[f"1/{name}"].read()
        assert b.dtype == a.dtype and b.shape == a.shape
        scale = LC_BOX if name == "Position" else np.abs(a).max()
        assert np.abs(b.astype(np.float64) - a).max() <= rel * scale, name


def test_planes_cli_parity(lc):
    (_, oj), (st, ot) = lc["jax"], lc["torch"]
    fj = sorted(f for f in os.listdir(oj) if f.endswith(".fits"))
    ft = sorted(f for f in os.listdir(ot) if f.endswith(".fits"))
    assert ft == fj and len(ft) == 6
    live = int(st.particles.mask.sum())
    for f in ft:
        hj, dj = read_fits_plane(str(oj / f))
        ht, dt = read_fits_plane(str(ot / f))
        assert ht == hj and int(ht["NPART"]) == live
        assert np.isfinite(dt).all()
        assert np.abs(dt.astype(np.float64) - dj).max() \
            <= 1e-4 * np.abs(dj).max()
