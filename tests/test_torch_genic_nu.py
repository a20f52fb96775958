"""Neutrino particles and per-species transfer functions in genic: the
port against the JAX package.  The copied thermal sampler
(genic/thermal.py), the transfer-table readers of cosmology/power.py on a
CLASS-layout table the test writes (chip_smoke._class_tk_table), and
run_genic with NgridNu and DifferentTransferFunctions = 1 in both
packages, with the checks of tests/test_genic_nu.py: chip_smoke's
_GENIC_NU paramfile at its Ngrid 12, NgridNu 6 (the reference's CLASS
tables replaced by an analytic EH spectrum and the written table).

Limits: the thermal draws bit for bit (the same RandomState stream);
the transfer ratios and growth tables to 1e-12 relative (the same
float64 numpy code); the IC snapshots as tests/test_torch_cli.py's genic
parity holds them (header files byte-identical, IDs identical, positions
within 1e-6 of the box, velocities within 1e-5 of their rms); the mass
split to 1e-3 relative.
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import _GENIC_NU, _class_tk_table, _eh_table
from shenqi_tpu.cosmology.background import Cosmology as JCosmology
from shenqi_tpu.cosmology import power as jpower
from shenqi_tpu.genic import thermal as jthermal
from shenqi_tpu.utils.units import default_units as j_units

from shenqi_tpu_torch.cosmology.background import Cosmology as TCosmology
from shenqi_tpu_torch.cosmology import power as tpower
from shenqi_tpu_torch.genic import thermal as tthermal
from shenqi_tpu_torch.io.snapshot import read_snapshot
from shenqi_tpu_torch.utils.units import default_units as t_units

torch.set_num_threads(1)

MNU = 0.133333333333
COSMO = dict(Omega0=0.288, OmegaLambda=0.712, OmegaBaryon=0.0472,
             HubbleParam=0.7, RadiationOn=1, MNu=(MNU,) * 3)
Z_IC = 99
BOX = 300000.0

def _cosmos():
    a = 1.0 / (1 + Z_IC)
    jcp = JCosmology(**COSMO)
    jcp.init(a, j_units())
    tcp = TCosmology(**COSMO)
    tcp.init(a, t_units())
    return jcp, tcp


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("genic_nu")
    pk, tk = tmp / "pk_eh.txt", tmp / "tk.txt"
    _eh_table(pk)
    _class_tk_table(tk, _cosmos()[1], 1.0 / (1 + Z_IC))
    return tmp, str(pk), str(tk)


def test_thermal_draws_match():
    u = j_units().UnitVelocity_in_cm_per_s
    for z, m in ((99, MNU), (49, 0.06), (9, 0.0)):
        assert tthermal.NU_V0(z, m, u) == jthermal.NU_V0(z, m, u)
    assert tthermal.WDM_V0(99, 1.0, 0.25, 0.7, u) == \
        jthermal.WDM_V0(99, 1.0, 0.25, 0.7, u)
    v0 = jthermal.NU_V0(99, MNU, u)
    js = jthermal.FermiDiracSampler(v0, 5000 * 100.0)
    ts = tthermal.FermiDiracSampler(v0, 5000 * 100.0)
    assert ts.nufrac() == js.nufrac()
    np.testing.assert_array_equal(
        ts.sample_speeds(np.random.RandomState(5), 4000),
        js.sample_speeds(np.random.RandomState(5), 4000))
    base = np.random.RandomState(1).normal(0, 10.0, (3000, 3))
    np.testing.assert_array_equal(
        tthermal.add_thermal_speeds(base.copy(), np.random.RandomState(183),
                                    v0, 5000 * 100.0),
        jthermal.add_thermal_speeds(base.copy(), np.random.RandomState(183),
                                    v0, 5000 * 100.0))


def test_load_transfer_and_dlog_growth_match(tables):
    _, pk, tk = tables
    jcp, tcp = _cosmos()
    a = 1.0 / (1 + Z_IC)
    ul = j_units().UnitLength_in_cm
    jp = jpower.InputPower.from_file(pk, jcp, ul)
    tp = tpower.InputPower.from_file(pk, tcp, ul)
    for p in (jp, tp):
        p.normalize(sigma8=-1, input_power_redshift=0, time_ic=a)
    jp.load_transfer(tk, a)
    tp.load_transfer(tk, a)
    assert tp.scale_dep_velocity and jp.scale_dep_velocity
    for name in ("transfer_ratio", "growth_ratio"):
        jd, td = getattr(jp, name), getattr(tp, name)
        assert sorted(td) == sorted(jd)
        for key in jd:
            np.testing.assert_allclose(td[key], jd[key], rtol=1e-12,
                                       atol=0, err_msg=f"{name}[{key}]")
    k = np.logspace(-7, -2, 300)
    for tt in (tpower.DELTA_TOT, tpower.DELTA_CDM, tpower.DELTA_NU,
               tpower.DELTA_BAR, tpower.DELTA_CB):
        np.testing.assert_allclose(tp.delta_spec(k, tt),
                                   jp.delta_spec(k, tt), rtol=1e-12)
        np.testing.assert_allclose(tp.dlog_growth(k, tt),
                                   jp.dlog_growth(k, tt), rtol=1e-12)
    # the written table's neutrinos free-stream: their ratio falls with k
    r = tp.transfer_ratio[tpower.DELTA_NU]
    assert r[0] > 0.9 and r[-1] < 1e-3
    # ROADMAP C.4: with three equal masses the cosmology keeps one table
    # of degeneracy 3, and load_transfer weights each of the table's
    # three ncdm columns by all three species' density
    # (cosmology/power.py:181-186), so DELTA_NU reads three times the
    # columns' delta; both packages do (1e-4: each ratio is re-gridded
    # onto the spectrum's k grid on its own)
    tab = np.loadtxt(tk)
    want = np.interp(tp.logk, np.log10(tab[:, 0]), 3 * tab[:, 5] / tab[:, 3])
    np.testing.assert_allclose(r / tp.transfer_ratio[tpower.DELTA_CDM], want,
                               rtol=1e-4)


@pytest.fixture(scope="module")
def genic_pair(tables):
    from shenqi_tpu.cli.genic_main import run_genic as j_genic
    from shenqi_tpu_torch.cli.genic_main import run_genic as t_genic
    tmp, pk, tk = tables
    paths = {}
    for name in ("jax", "torch"):
        gp = tmp / f"{name}.genic"
        gp.write_text(_GENIC_NU.format(out=tmp / name, ng=12, ngnu=6, pk=pk,
                                       tk=tk))
        paths[name] = (j_genic(str(gp)) if name == "jax"
                       else t_genic(str(gp), device="cpu"))
    return paths


def test_genic_nu_parity(genic_pair):
    hj, bj = read_snapshot(genic_pair["jax"])
    ht, bt = read_snapshot(genic_pair["torch"])
    hdir = os.path.join(genic_pair["jax"], "Header")
    for f in sorted(os.listdir(hdir)):
        with open(os.path.join(hdir, f), "rb") as a, \
                open(os.path.join(genic_pair["torch"], "Header", f),
                     "rb") as b:
            assert a.read() == b.read(), f
    assert sorted(bt) == sorted(bj) == [1, 2]
    for t in (1, 2):
        np.testing.assert_array_equal(bt[t]["ID"], bj[t]["ID"])
        d = np.abs(bt[t]["Position"] - bj[t]["Position"])
        d = np.minimum(d, BOX - d)
        assert d.max() < 1e-6 * BOX, (t, d.max() / BOX)
        vj = bj[t]["Velocity"].astype(np.float64)
        rms = np.sqrt(np.mean(vj ** 2))
        assert np.abs(bt[t]["Velocity"] - vj).max() < 1e-5 * rms, t


def test_genic_neutrino_species(genic_pair):
    """tests/test_genic_nu.py:37 on the port's snapshot."""
    hdr, blocks = read_snapshot(genic_pair["torch"])
    assert sorted(blocks) == [1, 2]
    assert len(blocks[2]["Position"]) == 6 ** 3
    assert blocks[2]["ID"].min() == 12 ** 3 + 1
    _, tcp = _cosmos()
    onu = tcp.ONu.get_omega_nu(1.0)
    nufrac = float(np.asarray(hdr.extra["FractionNuInParticles"])[0])
    got = (hdr.MassTable[2] * 6 ** 3) / (hdr.MassTable[1] * 12 ** 3)
    assert got == pytest.approx(nufrac * onu / (0.288 - onu), rel=1e-3)
    assert 0.99 < nufrac <= 1.0
    v = np.linalg.norm(blocks[2]["Velocity"], axis=1)
    assert np.median(v) > 3e4
    assert v.max() <= 5000 * 100 * 1.001
    v1 = np.linalg.norm(blocks[1]["Velocity"], axis=1)
    assert np.median(v1) < 300
