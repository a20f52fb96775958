"""Excursion-set reionization in the port (shenqi_tpu_torch/physics/
excursion.py in torch, and uv_fluctuations.J21Coeffs / uvbg_from_j21)
against the JAX package on the CPU, mirroring tests/test_excursion.py,
with the J21 coefficient file written by tools/make_j21coefftable.py in
place of the reference's examples/J21_to_rates_test.txt:

  * radius_ladder identical; _filter_k within 1e-5 of 1 for each filter;
    escape_fractions within 1e-6 relative;
  * calculate_uvbg on test_excursion.py's star cluster (6,000 DM, 600
    stars in one octant, 200 gas rows among them; positions of 2^31 and
    above included), for each filter type: the ionized cells (xHI = 0)
    the same in at least 99.9% of the cells (a cell at the barrier
    fcoll = 1/ReionEfficiency may fall either side in two FFTs), J21
    within 1e-4 of its max where both packages ionize at the same rung,
    the partial xHI = 1 - fcoll ReionEfficiency within 1e-2 in 99% of
    the cells where neither ionizes and within 1e-3 on average (the
    efficiency, ~3e4 here, multiplies the FFTs' rounding where the
    filtered star field is near 0), the global neutral fractions within
    1e-3,
    and the gas rows' J21 readout within 1e-4 of its max on the rows
    whose 8 cells agree;
  * uvbg_from_j21: every rate within 1e-6 relative (the self-shielding
    density within 1e-5: an f32 power), 0 and 1e10 where J21 is 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import _reion_tables
from shenqi_tpu.core.particles import float_to_ipos as j_ipos
from shenqi_tpu.cosmology import Cosmology as JCosmology
from shenqi_tpu.physics import excursion as jx
from shenqi_tpu.physics import uv_fluctuations as juv
from shenqi_tpu.physics.cooling_rates import UVBG as JUVBG
from shenqi_tpu.utils.units import default_units as j_units
from shenqi_tpu_torch.core.particles import float_to_ipos as t_ipos
from shenqi_tpu_torch.cosmology.background import Cosmology as TCosmology
from shenqi_tpu_torch.physics import excursion as tx
from shenqi_tpu_torch.physics import uv_fluctuations as tuv
from shenqi_tpu_torch.physics.cooling_rates import UVBG as TUVBG
from shenqi_tpu_torch.utils.units import default_units as t_units

torch.set_num_threads(2)
BOX = 20000.0
KW = dict(Omega0=0.3, OmegaLambda=0.7, OmegaBaryon=0.05, HubbleParam=0.7,
          RadiationOn=0, CMBTemperature=0.0)


@pytest.fixture(scope="module")
def j21_file(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("j21")
    return _reion_tables(None, tmp / "J21")[1]


def _cosmo():
    cj, ct = JCosmology(**KW), TCosmology(**KW)
    cj.init(TimeBegin=0.1, units=j_units())
    ct.init(TimeBegin=0.1, units=t_units())
    return cj, ct


def test_ladder_filters_fesc():
    par = dict(ReionRBubbleMax=5000.0, ReionRBubbleMin=500.0,
               ReionDeltaRFactor=1.5)
    assert tx.radius_ladder(tx.ExcursionSetParams(**par), BOX) \
        == jx.radius_ladder(jx.ExcursionSetParams(**par), BOX)
    k = np.linspace(0.0, 2.0, 50, dtype=np.float32)
    for ftype in (0, 1, 2):
        a = np.asarray(jx._filter_k(jnp.asarray(k), np.float32(10.0),
                                    ftype))
        b = tx._filter_k(torch.from_numpy(k), torch.tensor(np.float32(10.0)),
                         ftype).numpy()
        assert np.abs(a - b).max() < 1e-5
    units = t_units()
    m = np.array([0.0, 0.1, 1.0, 4.0, 50.0, 1e4], np.float32)
    for scaling in (0.5, -0.5):
        pj = jx.ExcursionSetParams(EscapeFractionScaling=scaling)
        pt = tx.ExcursionSetParams(EscapeFractionScaling=scaling)
        a = np.asarray(jx.escape_fractions(jnp.asarray(m), pj,
                                           units.UnitMass_in_g, 0.7))
        b = tx.escape_fractions(torch.from_numpy(m), pt,
                                units.UnitMass_in_g, 0.7).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-6)
        assert b[0] == 0.0


def _cluster():
    cj, ct = _cosmo()
    rng = np.random.RandomState(0)
    n_dm, n_star, n_gas = 6000, 600, 200
    pos_dm = rng.uniform(0, BOX, (n_dm, 3))
    m_dm = cj.Omega0 * cj.RhoCrit * BOX ** 3 / n_dm
    pos_star = rng.uniform(0.1 * BOX, 0.3 * BOX, (n_star, 3))
    pos_gas = rng.uniform(0.1 * BOX, 0.3 * BOX, (n_gas, 3))
    m_star = m_dm * 0.05
    pos = np.vstack([pos_gas, pos_dm, pos_star])
    mass = np.concatenate([np.full(n_gas, m_star), np.full(n_dm, m_dm),
                           np.full(n_star, m_star)]).astype(np.float32)
    ptype = np.concatenate([np.zeros(n_gas, np.int8), np.ones(n_dm, np.int8),
                            np.full(n_star, 4, np.int8)])
    sfr = np.zeros(len(pos), np.float32)
    sfr[:n_gas] = rng.uniform(0, 1e-3, n_gas)
    fesc = np.concatenate([np.full(n_gas, 0.5), np.zeros(n_dm),
                           np.full(n_star, 1.0)]).astype(np.float32)
    return cj, ct, pos, mass, ptype, sfr, fesc, n_gas


@pytest.mark.parametrize("ftype,use_sfr", [(0, 0), (1, 0), (2, 1)])
def test_calculate_uvbg_parity(ftype, use_sfr):
    cj, ct, pos, mass, ptype, sfr, fesc, n_gas = _cluster()
    par = dict(UVBGdim=32, ReionRBubbleMax=4000.0, ReionRBubbleMin=700.0,
               ReionDeltaRFactor=1.4, ReionNionPhotPerBary=4000.0,
               ReionFilterType=ftype, ReionUseParticleSFR=use_sfr)
    ip = j_ipos(pos, BOX)
    assert (ip >= 2 ** 31).any()
    rj = jx.calculate_uvbg(jnp.asarray(ip), jnp.asarray(mass),
                           jnp.asarray(ptype), jnp.asarray(sfr),
                           jnp.asarray(fesc), 1 / 8.0, cj, j_units(), BOX,
                           jx.ExcursionSetParams(**par))
    rt = tx.calculate_uvbg(t_ipos(pos, BOX, device="cpu"),
                           torch.from_numpy(mass), torch.from_numpy(ptype),
                           torch.from_numpy(sfr), torch.from_numpy(fesc),
                           1 / 8.0, ct, t_units(), BOX,
                           tx.ExcursionSetParams(**par))
    xj, xt = np.asarray(rj.xhi_grid), rt.xhi_grid.numpy()
    jj, jt = np.asarray(rj.j21_grid), rt.j21_grid.numpy()
    ion_j, ion_t = xj == 0, xt == 0
    assert ion_j.any() and (~ion_j).any()
    assert (ion_j == ion_t).mean() >= 0.999
    same = ion_j & ion_t & (np.abs(jj - jt) <= 1e-4 * jj.max())
    assert same.sum() >= 0.999 * ion_j.sum()
    part = ~ion_j & ~ion_t
    dx = np.abs(xj[part] - xt[part])
    assert (dx <= 1e-2).mean() >= 0.99 and abs(dx.mean()) <= 1e-3
    for a, b in ((rj.vol_weighted_xhi, rt.vol_weighted_xhi),
                 (rj.mass_weighted_xhi, rt.mass_weighted_xhi)):
        assert 0 <= float(b) <= 1 and abs(float(a) - float(b)) <= 1e-3
    pj, pt = np.asarray(rj.j21_particles), rt.j21_particles.numpy()
    assert (pt[n_gas:] == 0).all() and (pt[:n_gas] > 0).mean() > 0.5
    # the gas rows whose 8 readout cells agree in both packages
    n = par["UVBGdim"]
    i0 = np.floor(ip.astype(np.float32) * np.float32(n / 2 ** 32)).astype(
        np.int64)[:n_gas]
    ok = np.ones(n_gas, bool)
    for d in np.ndindex(2, 2, 2):
        c = (i0 + np.array(d)) % n
        ok &= np.abs(jj - jt)[c[:, 0], c[:, 1], c[:, 2]] <= 1e-4 * jj.max()
    assert ok.mean() >= 0.95
    assert np.abs(pj[:n_gas][ok] - pt[:n_gas][ok]).max() <= 1e-4 * pj.max()


def test_readout_wraps_at_2_32():
    """A position whose f32 rounds up to 2^32 reads cell n, which wraps to
    cell 0, in both packages (ROADMAP C.1)."""
    cj, ct = _cosmo()
    par = dict(UVBGdim=8, ReionRBubbleMax=6000.0, ReionRBubbleMin=2000.0,
               ReionDeltaRFactor=1.5)
    ip = np.array([[2 ** 32 - 1, 2 ** 32 - 100, 5],
                   [2 ** 31, 1, 2 ** 32 - 7]] * 50, np.uint32)
    ptype = np.array([0, 4] * 50, np.int8)
    mass = np.full(100, 1.0, np.float32)
    fesc = np.where(ptype == 4, 1.0, 0.0).astype(np.float32)
    rj = jx.calculate_uvbg(jnp.asarray(ip), jnp.asarray(mass),
                           jnp.asarray(ptype), jnp.zeros(100, jnp.float32),
                           jnp.asarray(fesc), 1 / 8.0, cj, j_units(), BOX,
                           jx.ExcursionSetParams(**par))
    rt = tx.calculate_uvbg(torch.from_numpy(ip.view(np.int32)),
                           torch.from_numpy(mass), torch.from_numpy(ptype),
                           torch.zeros(100), torch.from_numpy(fesc),
                           1 / 8.0, ct, t_units(), BOX,
                           tx.ExcursionSetParams(**par))
    pj, pt = np.asarray(rj.j21_particles), rt.j21_particles.numpy()
    assert (pt[::2] > 0).all()
    np.testing.assert_allclose(pt, pj, rtol=1e-4)


def test_uvbg_from_j21(j21_file):
    cj_, ct_ = juv.J21Coeffs.load(j21_file), tuv.J21Coeffs.load(j21_file)
    np.testing.assert_array_equal(ct_.rates, cj_.rates)
    j = np.array([0.0, 1e-3, 1.0, 2.0, 37.5], np.float32)
    zr = np.array([-1.0, 7.0, 7.0, 8.0, 9.0], np.float32)
    for z, alpha in ((7.0, 1.0), (2.5, 3.0)):
        a = juv.uvbg_from_j21(JUVBG(), jnp.asarray(j), jnp.asarray(zr), z,
                              alpha_uv=alpha, coeffs=cj_)
        b = tuv.uvbg_from_j21(TUVBG(), torch.from_numpy(j),
                              torch.from_numpy(zr), z, alpha_uv=alpha,
                              coeffs=ct_)
        for f in TUVBG._fields:
            x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
            assert y.dtype == np.float32, f
            tol = 1e-5 if f == "self_shield_dens" else 1e-6
            np.testing.assert_allclose(y, x, rtol=tol, err_msg=f)
        assert b.gJH0[0] == 0 and b.self_shield_dens[0] == 1e10
        assert float(b.gJHep.abs().max()) == 0.0
        assert 1e-5 < float(b.self_shield_dens[2]) < 1.0
