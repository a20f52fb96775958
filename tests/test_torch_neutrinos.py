"""The massive-neutrino linear response in the port against the JAX
package: the copied host module (physics/neutrinos_lra.py), its
Neutrino/* snapshot blocks, the PM hooks (measure_cdm_power and
pm_forces' nu_factor) and a Simulation with a nu_table.

Limits: the host float64 code to 1e-12 relative (it is the same numpy
and scipy code); the Neutrino blocks byte-identical, and each package
reads the other's; the PM hooks at tests/test_torch_pm.py's limits
(99th percentile of the force error under 1e-4 of the median |a|,
P(k) to rtol 1e-4, mode counts equal); the run to the trajectory limits
of __graft_entry__.py:194-206 and delta_tot to 1e-6 relative.
"""

import os

import numpy as np
import pytest
import torch

from shenqi_tpu.cosmology.background import Cosmology as JCosmology
from shenqi_tpu.physics import neutrinos_lra as jlra
from shenqi_tpu.utils.units import default_units as j_units

from shenqi_tpu_torch.convert import (nu_table_from_numpy,
                                      particles_from_numpy,
                                      window_from_numpy)
from shenqi_tpu_torch.cosmology.background import Cosmology as TCosmology
from shenqi_tpu_torch.physics import neutrinos_lra as tlra
from shenqi_tpu_torch.utils.units import default_units as t_units

torch.set_num_threads(1)

NU_COSMO = dict(Omega0=0.288, OmegaLambda=0.712, OmegaBaryon=0.0472,
                HubbleParam=0.7, RadiationOn=1, MNu=(0.1, 0.0, 0.0),
                MassiveNuLinRespOn=1)


def _cosmos(a0=0.02):
    jcp = JCosmology(**NU_COSMO)
    jcp.init(TimeBegin=a0, units=j_units())
    tcp = TCosmology(**NU_COSMO)
    tcp.init(a0, t_units())
    return jcp, tcp


def _tables(k, a0=0.02):
    jcp, tcp = _cosmos(a0)
    u = j_units()
    out = []
    for mod, cp in ((jlra, jcp), (tlra, tcp)):
        out.append(mod.DeltaTotTable.create(
            cp, k, time_transfer=a0, unit_time_in_s=u.UnitTime_in_s,
            unit_velocity=u.UnitVelocity_in_cm_per_s))
    return out, jcp, tcp


def _state(tab):
    return {f: getattr(tab, f) for f in tab.__dataclass_fields__
            if f != "CP"}


def test_specialJ_and_fslength_match():
    x = np.concatenate([[0.0, -1.0], np.logspace(-3, 2, 40)])
    np.testing.assert_allclose(tlra.specialJ(x), jlra.specialJ(x),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(tlra.Jfrac_high(x, 2.0, 0.3),
                               jlra.Jfrac_high(x, 2.0, 0.3), rtol=1e-12)
    assert tlra.nufrac_low(2.0) == pytest.approx(jlra.nufrac_low(2.0),
                                                 rel=1e-12)
    jcp, tcp = _cosmos()
    light = 2.99792458e10 / j_units().UnitVelocity_in_cm_per_s
    for a0, a1 in ((0.02, 0.1), (0.05, 0.5), (0.1, 0.1)):
        want = jlra.fslength(jcp, np.log(a0), np.log(a1), light)
        got = tlra.fslength(tcp, np.log(a0), np.log(a1), light)
        assert got == pytest.approx(want, rel=1e-12, abs=0)


def test_delta_tot_update_and_potential_factor_match():
    """The update protocol of tests/test_neutrinos.py:43 on both copies:
    the initial ratio, five updates, the delta_nu, the delta_tot history
    and the potential factor equal to 1e-12 relative."""
    k = np.logspace(-6, -1, 24)
    (jt, tt), jcp, _ = _tables(k)
    jt.init_ratio = tt.init_ratio = np.linspace(0.9, 0.2, len(k))
    d0 = 1e-2 * (k / k[0]) ** -0.3
    for a in (0.02, 0.05, 0.1, 0.2, 0.333):
        g = jcp.growth_factor(a, 0.02)
        np.testing.assert_allclose(tt.update(a, d0 * g), jt.update(a, d0 * g),
                                   rtol=1e-12, atol=0)
    np.testing.assert_allclose(tt.delta_tot, jt.delta_tot, rtol=1e-12)
    assert tt.scalefact == jt.scalefact
    assert tt.delta_tot.shape == (len(k), 5)
    np.testing.assert_allclose(tt.potential_factor(0.333, d0 * g),
                               jt.potential_factor(0.333, d0 * g),
                               rtol=1e-12)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_neutrino_blocks_identical_and_cross_read(tmp_path, writer):
    """`save` by both packages from one history writes the same bytes;
    the other package's `load` restores it and continues identically."""
    from shenqi_tpu.io.bigfile import BigFile as JBigFile
    from shenqi_tpu_torch.io.bigfile import BigFile as TBigFile
    k = np.logspace(-6, -2, 16)
    (jt, tt), jcp, tcp = _tables(k)
    d0 = 1e-2 * (k / k[0]) ** -0.5
    for a in (0.02, 0.05, 0.1, 0.2):
        jt.update(a, d0 * a / 0.02)
        tt.update(a, d0 * a / 0.02)
    paths = {}
    for name, tab, bf in (("jax", jt, JBigFile), ("torch", tt, TBigFile)):
        paths[name] = str(tmp_path / name)
        bf(paths[name], create=True)
        tab.save(paths[name])
    nu = os.path.join("Neutrino")
    for blk in ("Deltas", "Scalefact", "Wavenum", "DeltaNuInit"):
        d_j = os.path.join(paths["jax"], nu, blk)
        d_t = os.path.join(paths["torch"], nu, blk)
        assert sorted(os.listdir(d_j)) == sorted(os.listdir(d_t))
        for f in os.listdir(d_j):
            with open(os.path.join(d_j, f), "rb") as a, \
                    open(os.path.join(d_t, f), "rb") as b:
                assert a.read() == b.read(), (blk, f)
    reader = (tlra, tcp) if writer == "jax" else (jlra, jcp)
    u = j_units()
    back = reader[0].DeltaTotTable.create(
        reader[1], k * 0 + 1, time_transfer=1.0,
        unit_time_in_s=u.UnitTime_in_s,
        unit_velocity=u.UnitVelocity_in_cm_per_s)
    assert back.load(paths[writer])
    src = jt if writer == "jax" else tt
    np.testing.assert_array_equal(back.delta_tot, src.delta_tot)
    np.testing.assert_array_equal(back.scalefact, src.scalefact)
    np.testing.assert_array_equal(back.wavenum, src.wavenum)
    np.testing.assert_array_equal(back.delta_nu_init, src.delta_nu_init)
    np.testing.assert_allclose(back.update(0.25, d0 * 0.25 / 0.02),
                               src.update(0.25, d0 * 0.25 / 0.02),
                               rtol=1e-12)


def test_nu_table_carried_across_exactly():
    k = np.logspace(-6, -2, 8)
    (jt, _), jcp, tcp = _tables(k)
    jt.update(0.02, np.ones_like(k))
    jt.update(0.05, 2 * np.ones_like(k))
    tt = nu_table_from_numpy(_state(jt), tcp)
    assert isinstance(tt, tlra.DeltaTotTable) and tt.CP is tcp
    np.testing.assert_array_equal(tt.delta_tot, jt.delta_tot)
    tt.delta_tot[0, 0] += 1.0       # a copy, not a view
    assert tt.delta_tot[0, 0] != jt.delta_tot[0, 0]


@pytest.fixture(scope="module")
def pm_case():
    import jax.numpy as jnp
    from shenqi_tpu.core.particles import float_to_ipos
    from shenqi_tpu.gravity import pm as jpm
    from shenqi_tpu_torch.gravity import pm as tpm
    box, n, nmesh = 50000.0, 4000, 32
    rng = np.random.RandomState(7)
    pos = rng.uniform(0, box, (n, 3))
    c = rng.uniform(0, box, (6, 3))
    pos[: n // 2] = (c[rng.randint(0, 6, n // 2)]
                     + rng.normal(0, box / 40, (n // 2, 3))) % box
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    mask = rng.rand(n) > 0.05
    ipos = float_to_ipos(pos, box)
    nu = (1.0 + 0.05 * rng.rand(nmesh, nmesh, nmesh // 2 + 1)
          ).astype(np.float32)
    jcfg = jpm.PMConfig(nmesh=nmesh, boxsize=box, G=43007.1, asmth=1.5)
    tcfg = tpm.PMConfig(nmesh=nmesh, boxsize=box, G=43007.1, asmth=1.5)
    tin = (torch.from_numpy(ipos.view(np.int32).copy()),
           torch.from_numpy(mass), torch.from_numpy(mask))
    jin = (jnp.asarray(ipos), jnp.asarray(mass), jnp.asarray(mask))
    return dict(
        mask=mask,
        jcdm=jpm.measure_cdm_power(*jin[:2], jcfg, mask=jin[2]),
        tcdm=tpm.measure_cdm_power(*tin[:2], tcfg, mask=tin[2]),
        jf=jpm.pm_forces(*jin[:2], jcfg, mask=jin[2],
                         nu_factor=jnp.asarray(nu)),
        tf=tpm.pm_forces(*tin[:2], tcfg, mask=tin[2],
                         nu_factor=torch.from_numpy(nu)),
        t0=tpm.pm_forces(*tin[:2], tcfg, mask=tin[2]))


def test_measure_cdm_power_matches(pm_case):
    j, t = pm_case["jcdm"], pm_case["tcdm"]
    np.testing.assert_array_equal(t.nmodes.numpy(), np.asarray(j.nmodes))
    np.testing.assert_allclose(t.k.numpy(), np.asarray(j.k), rtol=1e-4)
    np.testing.assert_allclose(t.power.numpy(), np.asarray(j.power),
                               rtol=1e-4)
    assert float(t.norm) == pytest.approx(float(j.norm), rel=1e-4)
    # the CDM power is the power before the nu factor
    np.testing.assert_allclose(t.power.numpy(),
                               pm_case["t0"][2].power.numpy(), rtol=1e-6)


def test_pm_forces_nu_factor_matches(pm_case):
    mask = pm_case["mask"]
    (ja, jpot, jps), (ta, tpot, tps) = pm_case["jf"], pm_case["tf"]
    ja = np.asarray(ja)[mask]
    ta = ta.numpy()[mask]
    scale = np.median(np.linalg.norm(ja, axis=1))
    err = np.linalg.norm(ta - ja, axis=1) / scale
    assert np.percentile(err, 99) < 1e-4, np.percentile(err, 99)
    jpot = np.asarray(jpot)[mask]
    perr = np.abs(tpot.numpy()[mask] - jpot) / np.median(np.abs(jpot))
    assert np.percentile(perr, 99) < 1e-4
    # the factor is applied before the power is measured
    np.testing.assert_allclose(tps.power.numpy(), np.asarray(jps.power),
                               rtol=1e-4)
    assert not np.allclose(tps.power.numpy(),
                           pm_case["t0"][2].power.numpy(), rtol=1e-3)
    # and it moves the forces
    a0 = pm_case["t0"][0].numpy()[mask]
    assert np.median(np.linalg.norm(ta - a0, axis=1)) > 1e-3 * scale


def test_simulation_with_nu_table_matches_jax():
    """Three PM steps with a nu_table from one state in both packages
    (the port's particles, window and empty table carried across)."""
    from shenqi_tpu.core.timeline import Timeline as JTimeline
    from shenqi_tpu.simulation import Simulation as JSimulation
    from shenqi_tpu.gravity.treepm import get_window_tables
    from shenqi_tpu_torch.core.timeline import Timeline as TTimeline
    from shenqi_tpu_torch.simulation import Simulation as TSimulation
    box, n_side, nmesh = 64000.0, 8, 16
    rng = np.random.RandomState(1)
    n = n_side ** 3
    g = (np.arange(n_side) + 0.5) * box / n_side
    lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pos = (lat + rng.normal(0, box / 60, (n, 3))) % box
    vel = rng.normal(0, 5.0, (n, 3)).astype(np.float32)
    mass = np.ones(n, np.float32)
    ids = np.arange(1, n + 1, dtype=np.uint64)
    jcp, tcp = _cosmos(0.1)
    jsim = JSimulation.from_arrays(pos, vel, mass, ids, jcp, box, nmesh,
                                   JTimeline.setup([0.5], 0.1, 0.5), 0.1)
    tsim = TSimulation.from_arrays(pos, vel, mass, ids, tcp, box, nmesh,
                                   TTimeline.setup([0.5], 0.1, 0.5), 0.1,
                                   device="cpu")
    jp = jsim.particles
    tsim.particles = particles_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in
         type(jp).__dataclass_fields__}, device="cpu")
    jw = get_window_tables(jsim.gravity)
    jsim.window_tables = jw
    tsim.window_tables = window_from_numpy(np.asarray(jw.cf),
                                           np.asarray(jw.cp),
                                           float(jw.xmax), device="cpu")
    u = j_units()
    wavenum = (2 * np.pi / box) * np.arange(1, nmesh // 2 + 1)
    jsim.nu_table = jlra.DeltaTotTable.create(
        jcp, wavenum, time_transfer=0.1, unit_time_in_s=u.UnitTime_in_s,
        unit_velocity=u.UnitVelocity_in_cm_per_s)
    tsim.nu_table = nu_table_from_numpy(_state(jsim.nu_table), tcp)
    jsim.run(max_steps=3)
    tsim.run(max_steps=3)
    assert len(tsim.power_history) == len(jsim.power_history) == 3
    assert tsim.nu_table.delta_tot.shape == jsim.nu_table.delta_tot.shape \
        == (nmesh // 2, 3)
    np.testing.assert_allclose(tsim.nu_table.delta_tot,
                               jsim.nu_table.delta_tot, rtol=1e-6)
    assert tsim.times.ti_current == jsim.times.ti_current
    alive = np.asarray(jp.mask)
    ip1 = np.asarray(jsim.particles.ipos)[alive].astype(np.int64)
    ip2 = tsim.particles.ipos_u32()[alive].astype(np.int64)
    d = np.abs(ip1 - ip2)
    d = np.minimum(d, 2 ** 32 - d)
    assert d.max() < 2e-5 * 2 ** 32, d.max() / 2 ** 32
    v1 = np.asarray(jsim.particles.vel)[alive]
    v2 = tsim.particles.vel.numpy()[alive]
    vs = float(np.median(np.abs(v1))) + 1e-6
    outlier = np.max(np.abs(v1 - v2), axis=1) > 2e-3 * vs + 1e-4
    assert np.mean(outlier) < 5e-3, int(outlier.sum())
    np.testing.assert_array_equal(tsim.particles.timebin.numpy()[alive],
                                  np.asarray(jsim.particles.timebin)[alive])
