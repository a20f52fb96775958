"""The fluctuating UVB and metal-line cooling of the port
(shenqi_tpu_torch/physics/uv_fluctuations.py and the `metallicity` /
`metal_cool` / per-row UVBG branches of physics/cooling_rates.py)
against the JAX package's on the CPU.  The tables are written by
chip_smoke's `_zreion_table` and `_metal_cool_table`, in the bigfile
layouts the loaders read (tests/test_uvfluc_helium.py:18-31, 61-78): a
Zreion table with z_reion = 6 in one octant and 10 elsewhere,
and a MetalCool table of made-up smooth rates on a non-uniform
(z, log nH, log T) grid, sized so that the metal term moves the net rate
by up to its own size, and changing at most half a dex per unit of log
nH or log T (the packages' log10 differ by an f32 ulp on a third of the inputs;
across a steeper cell the trilinear lookup would magnify that past the
limit below).

Limits: `ZreionTable.zreion` and `MetalCoolingTable.eval` within 1e-5
relative (both trilinear in f32); `local_uvbg` identical;
`get_heatingcooling_rate` and `do_cooling` with the metal term and the
per-row UVBG at tests/test_torch_cooling.py's limits (the rate and u
within 1e-4 relative; ne/nh within 1e-4 relative or 2.4e-7 absolute).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from shenqi_tpu.physics import cooling_rates as jc
from shenqi_tpu.physics import uv_fluctuations as ju
from shenqi_tpu_torch.physics import cooling_rates as tc
from shenqi_tpu_torch.physics import uv_fluctuations as tu

import test_torch_cooling as C
from chip_smoke import _zreion_table, _metal_cool_table

torch.set_num_threads(2)
BOX = 20000.0          # kpc/h: the table's 20 Mpc/h
UNIT_L = 3.085678e21


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("uvf")
    zr, mc = _zreion_table(tmp / "UVF", 20.0), _metal_cool_table(tmp / "MC")
    tcpath = C._treecool(tmp / "TREECOOL")
    return {
        "zreion": (ju.ZreionTable.load(zr, BOX, UNIT_L),
                   tu.ZreionTable.load(zr, BOX, UNIT_L)),
        "metal": (ju.MetalCoolingTable.load(mc),
                  tu.MetalCoolingTable.load(mc)),
        "treecool": tcpath}


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(a), 1e-300)


def test_zreion_lookup(tables):
    jz, tz = tables["zreion"]
    rng = np.random.default_rng(3)
    pos = rng.uniform(0, BOX, (2000, 3)).astype(np.float32)
    pos[:3] = [[0.999 * BOX, 0.15 * BOX, 0.15 * BOX], [0, 0, 0],
               [0.25 * BOX, 0.25 * BOX, 0.25 * BOX]]
    want = np.asarray(jz.zreion(jnp.asarray(pos)))
    got = tz.zreion(torch.from_numpy(pos)).numpy()
    assert want.min() < 7 and want.max() > 9.9
    assert _rel(want, got).max() < 1e-5
    assert tz.median_redshift == jz.median_redshift == 7.5
    with pytest.raises(ValueError, match="does not match"):
        tu.ZreionTable.load(str(tables["treecool"]).replace(
            "TREECOOL", "UVF"), 2 * BOX, UNIT_L)


def _uvbgs(tables, redshift, n=300, seed=4):
    """The TREECOOL UVBG at `redshift`, gated per row by the Zreion table
    at seeded positions, in both packages."""
    jz, tz = tables["zreion"]
    path = tables["treecool"]
    g_j = jc.TreeCool(path).uvbg(redshift, jc.CoolingParams())
    g_t = tc.TreeCool(path).uvbg(redshift, tc.CoolingParams())
    pos = np.random.default_rng(seed).uniform(0, BOX, (n, 3)).astype(
        np.float32)
    uj = ju.local_uvbg(g_j, jz.zreion(jnp.asarray(pos)), redshift)
    ut = tu.local_uvbg(g_t, tz.zreion(torch.from_numpy(pos)), redshift)
    return uj, ut


def test_local_uvbg(tables):
    uj, ut = _uvbgs(tables, 7.0)
    assert tc.per_row(ut)
    for f in jc.UVBG._fields:
        a, b = np.asarray(getattr(uj, f)), getattr(ut, f).numpy()
        if f != "zreion":
            np.testing.assert_array_equal(b, a, f)
    on = np.asarray(uj.gJH0) > 0
    assert 0 < on.sum() < len(on)


def test_metal_cooling_eval(tables):
    jm, tm = tables["metal"]
    rng = np.random.default_rng(5)
    n = 3000
    temp = (10 ** rng.uniform(0.5, 10, n)).astype(np.float32)
    nh = (10 ** rng.uniform(-9, 4, n)).astype(np.float32)
    for z in (0.0, 2.0, 3.3, 11.0, 14.0):
        want = np.asarray(jm.eval(z, jnp.asarray(temp), jnp.asarray(nh)))
        got = tm.eval(z, torch.from_numpy(temp), torch.from_numpy(nh))
        assert _rel(want, got.numpy()).max() < 1e-5, z
    # a linear table is interpolated exactly (test_uvfluc_helium.py:61-86)
    assert float(tm.eval(0.5, 10 ** 4.0, 10 ** -4.5)) > 0


@pytest.mark.parametrize("uv", ["rows", "rows+metal", "metal"])
def test_rate_and_do_cooling(tables, uv):
    """The rate and the implicit solver with the per-row UVBG, the metal
    term, or both, at z = 7 (test_torch_cooling.py's inputs)."""
    redshift = 7.0
    nh, u, ne = C._inputs(300, seed=1)
    n = len(u)
    uj, ut = _uvbgs(tables, redshift, n)
    if uv == "metal":
        path = tables["treecool"]
        uj = jc.TreeCool(path).uvbg(redshift, jc.CoolingParams())
        ut = tc.TreeCool(path).uvbg(redshift, tc.CoolingParams())
    jm, tm = tables["metal"] if "metal" in uv else (None, None)
    met = np.random.default_rng(6).uniform(0, 0.04, n).astype(np.float32)
    rho = (nh / (1 - 0.24) * 1.6726e-24).astype(np.float32)
    nebynh = (ne / nh).astype(np.float32)
    pj = jc.CoolingParams(MinGasTemp=5.0)
    pt = tc.CoolingParams(MinGasTemp=5.0)
    lj, nj = jc.get_heatingcooling_rate(
        jnp.asarray(rho), jnp.asarray(u), 0.24, redshift, uj, pj,
        ne_init=jnp.asarray(ne), metallicity=jnp.asarray(met),
        metal_cool=jm)
    lt, nt = tc.get_heatingcooling_rate(
        torch.from_numpy(rho), torch.from_numpy(u), 0.24, redshift, ut, pt,
        ne_init=torch.from_numpy(ne), metallicity=torch.from_numpy(met),
        metal_cool=tm)
    assert _rel(lj, lt.numpy()).max() < 1e-4
    C._ne_close(nj, nt.numpy())
    if jm is not None:
        # the metal term is a sizeable part of the net rate
        l0, _ = jc.get_heatingcooling_rate(
            jnp.asarray(rho), jnp.asarray(u), 0.24, redshift, uj, pj,
            ne_init=jnp.asarray(ne))
        assert (_rel(l0, lj) > 0.1).sum() > 20
    dt = (10 ** np.random.default_rng(2).uniform(12, 15.5, n)).astype(
        np.float32)
    ju_, jne = jc.do_cooling(jnp.asarray(u), jnp.asarray(rho),
                             jnp.asarray(dt), 0.24, redshift, uj, pj,
                             min_egyspec_cgs=1e9,
                             ne_init=jnp.asarray(nebynh),
                             metallicity=jnp.asarray(met), metal_cool=jm)
    tu_, tne = tc.do_cooling(torch.from_numpy(u), torch.from_numpy(rho),
                             torch.from_numpy(dt), 0.24, redshift, ut, pt,
                             min_egyspec_cgs=1e9,
                             ne_init=torch.from_numpy(nebynh),
                             metallicity=torch.from_numpy(met),
                             metal_cool=tm)
    ju_ = np.asarray(ju_, np.float64)
    assert np.isfinite(tu_.numpy()).all()
    assert (ju_ < 0.5 * u).sum() > 10
    assert _rel(ju_, tu_.numpy()).max() < 1e-4
    C._ne_close(jne, tne.numpy())
