"""The star-formation subgrid path in the port's Simulation against the
JAX package's on the CPU: tests/test_torch_gas.py's configuration (8^3
gas + 8^3 DM, box 64000 kpc/h, z = 9, hierarchical gravity, the quintic
kernel, pressure-entropy SPH) with cooling, SH03 star formation, ofjt10
winds and metal return, from one seeded state:

  * a clump of 128 gas rows inside 0.8% of the box sits above the SF
    threshold (CritPhysDensity set to 5e-5 internal, physical), so stars
    form at every step of both packages;
  * four gas rows are old stars (born at a = 0.05), so metal return
    acts from the first step;
  * the DM velocity dispersion is refreshed once (update_vdisp, held to
    the JAX one) and then set to 10 km/s a, so the new stars' winds kick
    their neighbours.

Limits: star counts, the converted and spawned rows, their IDs, types,
masks and generations identical at every step, and the key chains
(convert.key_from_numpy) at one state; the trajectories as
tests/test_torch_gas.py holds them (positions within 2e-5 of the box,
velocity outliers over 1e-3 relative under 5e-3 of the rows, timebins
equal but for them); entropy, density and hsml within 1e-3 relative for
>= 99% of the gas rows; metallicity and the star bookkeeping within 1e-4
relative of their max; the wind-kicked rows identical; total mass equal
to 1e-9.  The device conversion and the host conversion give the same
rows; `_grow_star_capacity` then `slots_gc` keep the state, and an
excursion pass after either reads the last FOF's halo mass at the new
row count.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import test_torch_gas as G
from torch_oracle import both_sides
from shenqi_tpu.cosmology.background import Cosmology as JCosmology
from shenqi_tpu.core.timeline import Timeline as JTimeline
from shenqi_tpu.gravity.treepm import get_window_tables
from shenqi_tpu.physics import (cooling_rates as jcr, sfr as jsfr,
                                winds as jw, metal_return as jmr)
from shenqi_tpu.simulation import Simulation as JSimulation
from shenqi_tpu.simulation_gas import GasPhysics as JGasPhysics
from shenqi_tpu.sph.kernels import QUINTIC as JQUINTIC
from shenqi_tpu.utils.units import default_units as j_units
from shenqi_tpu_torch.convert import (key_from_numpy, particles_from_numpy,
                                      window_from_numpy)
from shenqi_tpu_torch.core.timeline import Timeline as TTimeline
from shenqi_tpu_torch.cosmology.background import Cosmology as TCosmology
from shenqi_tpu_torch.physics import (cooling_rates as tcr, sfr as tsfr,
                                      winds as tw, metal_return as tmr)
from shenqi_tpu_torch.physics.excursion import ExcursionSetParams
from shenqi_tpu_torch.simulation import Simulation as TSimulation
from shenqi_tpu_torch.simulation_gas import GasPhysics as TGasPhysics
from shenqi_tpu_torch.sph.kernels import QUINTIC
from shenqi_tpu_torch.utils.units import default_units as t_units

torch.set_num_threads(2)
BOX, NG, A_IC, A_END = G.BOX, G.NG, G.A_IC, 0.125
STEPS = 5
OLD = np.arange(300, 304)
YIELDS = G.__file__.rsplit("/tests/", 1)[0] + "/data_yields"


def _species():
    sp = G._species()
    rng = np.random.default_rng(5)
    pos = sp[0][1].copy()
    k = 128
    r = 0.008 * BOX * rng.uniform(0, 1, k) ** (1 / 3)
    d = rng.normal(size=(k, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    pos[:k] = np.array([0.3, 0.4, 0.5]) * BOX + r[:, None] * d
    sp[0] = (0, pos, sp[0][2], sp[0][3], sp[0][4])
    return sp


def _physics(jax_side: bool, m_gas):
    cr, sf, wi, mr = ((jcr, jsfr, jw, jmr) if jax_side
                      else (tcr, tsfr, tw, tmr))
    units = j_units() if jax_side else t_units()
    cp = JCosmology(**G.COSMO)
    cp.init(A_IC, j_units())
    coolpar = cr.CoolingParams(fBar=cp.OmegaBaryon / cp.OmegaCDM)
    crit = (5e-5 * units.UnitMass_in_g / units.UnitLength_in_cm ** 3
            * 0.76 / 1.6726e-24)
    sfp = sf.SFRParams(MaxSfrTimescale=0.01, CritPhysDensity=crit).init(
        cp, units, m_gas, cr.UVBG(), coolpar)
    wp = wi.WindParams(WindModel=wi.WIND_MODEL_OFJT10).init(
        sfp.FactorSN, sfp.EgySpecSN, sfp.PhysDensThresh,
        units.UnitTime_in_s)
    gp = (JGasPhysics if jax_side else TGasPhysics)(
        kernel=JQUINTIC if jax_side else QUINTIC, cooling_on=True,
        sfr_on=True, winds_on=True, metal_return_on=True, coolpar=coolpar,
        sfrpar=sfp, windpar=wp,
        coolunits=sf.CoolingUnits.create(units, cp.HubbleParam),
        metals=mr.MetalReturn.load(YIELDS))
    return gp


def _pair():
    sp = _species()
    m_gas = float(sp[0][3])
    jcp = JCosmology(**G.COSMO)
    jcp.init(A_IC, j_units())
    tcp = TCosmology(**G.COSMO)
    tcp.init(A_IC, t_units())
    js = JSimulation.from_species(
        sp, jcp, BOX, 2 * NG, JTimeline.setup([A_END], A_IC, A_END), A_IC,
        gas_u0=G.U0, gas_physics=_physics(True, m_gas), star_headroom=256)
    ts = TSimulation.from_species(
        sp, tcp, BOX, 2 * NG, TTimeline.setup([A_END], A_IC, A_END), A_IC,
        gas_u0=G.U0, gas_physics=_physics(False, m_gas), star_headroom=256,
        device="cpu")
    jp = js.particles
    pt = np.asarray(jp.ptype).copy()
    pt[OLD] = 4
    js.particles = dataclasses.replace(jp, ptype=jnp.asarray(pt))
    ts.particles = particles_from_numpy(
        {f: np.asarray(getattr(js.particles, f))
         for f in type(jp).__dataclass_fields__}, device="cpu")
    m0 = np.asarray(js.gas.mass0).copy()
    m0[OLD] = np.asarray(jp.mass)[OLD]
    for name, val in (("birth_a", 0.05), ("star_metallicity", 0.01),
                      ("mass0", m0)):
        a = np.asarray(getattr(js.gas, name)).copy()
        a[OLD] = val[OLD] if isinstance(val, np.ndarray) else val
        setattr(js.gas, name, jnp.asarray(a))
        setattr(ts.gas, name, torch.from_numpy(a))
    jw_ = get_window_tables(js.gravity)
    js.window_tables = jw_
    ts.window_tables = window_from_numpy(np.asarray(jw_.cf),
                                         np.asarray(jw_.cp),
                                         float(jw_.xmax), device="cpu")
    js.hierarchical = ts.hierarchical = True
    return js, ts


def _star_rows(sim):
    p = sim.particles
    m = np.asarray(p.mask) if not torch.is_tensor(p.mask) \
        else p.mask.numpy()
    pt = np.asarray(p.ptype) if not torch.is_tensor(p.ptype) \
        else p.ptype.numpy()
    return np.nonzero(m & (pt == 4))[0]


@pytest.fixture(scope="module")
def sub_steps(tmp_path_factory):
    """Both packages' five steps, computed once per session, each package
    in its own process (torch_oracle.both_sides), and handed to each
    worker that asks."""
    (js, jrec, jvd), (ts, trec, tvd) = both_sides(tmp_path_factory,
                                                  "subgrid", _sub_steps)
    rec = [{k: (j[k], t[k]) for k in j} for j, t in zip(jrec, trec)]
    return js, ts, rec, (jvd, tvd)


def _host(x):
    return x.numpy().copy() if torch.is_tensor(x) else np.asarray(x).copy()


def _sub_steps(out, side):
    """One package's side of the pair from one seeded state (the two run
    apart: nothing passes between them after _pair)."""
    sim = dict(zip(("jax", "torch"), _pair()))[side]
    sim.gas = sim.gas_physics.update_vdisp(sim, sim.gas)
    vd = _host(sim.gas.vdisp)
    slow = np.full(NG ** 3, 10.0 * A_IC, np.float32)
    sim.gas.vdisp = (jnp.asarray(slow) if side == "jax"
                     else torch.from_numpy(slow))
    rec = []
    for _ in range(STEPS):
        sim.run(max_steps=1)
        rec.append({"a": sim.atime(), "stars": _star_rows(sim),
                    "bins": _host(sim.particles.timebin),
                    "delay": _host(sim.gas.delay_time)})
    return sim, rec, vd


def test_update_vdisp(sub_steps):
    _, _, _, (jv, tv) = sub_steps
    gas = np.ones(NG ** 3, bool)
    gas[OLD] = False
    assert (np.abs(jv - tv) / jv)[gas].max() < 1e-4
    np.testing.assert_array_equal(tv[~gas], jv[~gas])


def test_stars_form_identically(sub_steps):
    js, ts, rec, _ = sub_steps
    counts = [len(r["stars"][0]) for r in rec]
    # stars form at most steps, as split spawns onto the spare rows (the
    # whole conversions are held in test_device_and_host_conversion_agree
    # and tests/test_torch_sfr_winds.py)
    assert counts[-1] > counts[0] >= len(OLD) and counts[-1] >= 12
    for r in rec:
        assert r["a"][0] == r["a"][1]
        np.testing.assert_array_equal(r["stars"][1], r["stars"][0])
    jp, tp = js.particles, ts.particles
    assert (_star_rows(ts) >= ts.gas.ngas).sum() >= 8
    for f in ("mask", "ptype", "id_lo", "id_hi"):
        a = np.asarray(getattr(jp, f))
        b = getattr(tp, f).numpy()
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        np.testing.assert_array_equal(b, a, f)
    np.testing.assert_array_equal(ts.gas.generation.numpy(),
                                  np.asarray(js.gas.generation))
    assert (np.asarray(jp.id_hi)[_star_rows(js)] >> 24).max() >= 1
    # both drew the same keys: the key chains are at the same state
    assert key_from_numpy(js.gas_physics.rng_key) == ts.gas_physics.rng_key
    assert float(np.asarray(jp.mass, np.float64).sum()) == pytest.approx(
        float(tp.mass.double().sum()), rel=1e-9)


def test_subgrid_trajectory(sub_steps):
    js, ts, rec, _ = sub_steps
    jp, tp = js.particles, ts.particles
    m = np.asarray(jp.mask)
    d = (np.asarray(jp.ipos).astype(np.int64)
         - tp.ipos.numpy().view(np.uint32).astype(np.int64))
    d = (d + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert np.abs(d[m]).max() < 2e-5 * 2 ** 32
    vj, vt = np.asarray(jp.vel)[m], tp.vel.numpy()[m]
    vrel = (np.linalg.norm(vj - vt, axis=1)
            / np.maximum(np.linalg.norm(vj, axis=1), 1e-30))
    out = vrel > 1e-3
    assert out.mean() < 5e-3
    for r in rec:
        bj, bt = r["bins"]
        np.testing.assert_array_equal(bj[m][~out], bt[m][~out])
    ng = ts.gas.ngas
    gas = (np.asarray(jp.ptype)[:ng] == 0) & m[:ng]
    for a, b in ((js.gas.entropy, ts.gas.entropy),
                 (js.gas.density, ts.gas.density),
                 (np.asarray(jp.hsml)[:ng], tp.hsml[:ng])):
        a = np.asarray(a, np.float64)[gas]
        b = np.asarray(b)[gas]
        assert (np.abs(a - b) / np.abs(a) < 1e-3).mean() >= 0.99
    for f in ("metallicity", "sfr", "birth_a", "mass0", "star_metallicity",
              "total_returned", "last_enrich_myr"):
        a = np.asarray(getattr(js.gas, f), np.float64)
        b = getattr(ts.gas, f).numpy()
        assert a.max() > 0, f
        assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max(), f
    assert np.isfinite(ts.gas.entropy.numpy()[gas]).all()
    assert (ts.gas.entropy.numpy()[gas] > 0).all()


def test_winds_kick_the_same_rows(sub_steps):
    _, _, rec, _ = sub_steps
    kicked = 0
    for r in rec:
        dj, dt = r["delay"]
        np.testing.assert_array_equal(dt > 0, dj > 0)
        kicked = max(kicked, int((dj > 0).sum()))
    assert kicked > 0


def _sf_result(ts):
    """A star-formation result on the port's end state: a few gas rows
    of the clump form stars, some whole, some split."""
    from shenqi_tpu_torch.physics.sfr import SFResult
    ng = ts.gas.ngas
    p = ts.particles
    gas = (p.ptype[:ng] == 0) & p.mask[:ng]
    rows = torch.nonzero(gas).squeeze(1)[:12]
    form = torch.zeros(ng, dtype=torch.bool)
    form[rows] = True
    whole = torch.zeros(ng, dtype=torch.bool)
    whole[rows[::3]] = True
    mstar = torch.where(whole, p.mass[:ng], 0.25 * p.mass[:ng])
    z = torch.zeros(ng)
    return SFResult(sfr=z, entropy=z, ne=z, metallicity=z, form_star=form,
                    mass_of_star=mstar, convert_whole=whole)


def _state(sim):
    p, g = sim.particles, sim.gas
    out = {f"p.{f}": getattr(p, f).clone()
           for f in type(p).__dataclass_fields__}
    out.update({f"g.{f}": getattr(g, f).clone() for f in
                ("birth_a", "last_enrich_myr", "mass0", "star_metallicity",
                 "generation", "sfr", "delay_time", "total_returned")})
    return out


def test_device_and_host_conversion_agree(sub_steps):
    _, ts, _, _ = sub_steps
    res = _sf_result(ts)
    saved = (ts.particles, dataclasses.replace(ts.gas))
    gp = ts.gas_physics
    out = []
    for fn in (gp._convert_stars_device, gp._convert_stars):
        ts.particles, ts.gas = saved[0], dataclasses.replace(saved[1])
        assert fn(ts, ts.gas, res, ts.atime()) == 12
        out.append(_state(ts))
    ts.particles, ts.gas = saved
    assert sorted(out[0]) == sorted(out[1])
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k


def test_grow_capacity_and_slots_gc(sub_steps):
    _, ts, _, _ = sub_steps
    saved = (ts.particles, dataclasses.replace(ts.gas))
    before = _state(ts)
    n = ts.particles.n
    gp = ts.gas_physics
    gp._grow_star_capacity(ts, ts.gas, 5000)
    grown = ts.particles.n
    assert grown >= n + 5000 and grown % 128 == 0
    for k, v in _state(ts).items():
        if v.shape[0] == grown:
            assert torch.equal(v[:n], before[k]), k
            assert not v[n:].any(), k
    assert not ts.particles.mask[n:].any()
    gp.slots_gc(ts, ts.gas)
    last = int(torch.nonzero(ts.particles.mask)[-1, 0]) + 1
    assert ts.particles.n == ((max(last, ts.n_real) + 127) // 128) * 128
    for k, v in _state(ts).items():
        assert torch.equal(v, before[k][:v.shape[0]]), k
    ts.particles, ts.gas = saved


@pytest.mark.parametrize("change", ["grow", "slots_gc"])
def test_excursion_after_capacity_change(sub_steps, change):
    """An excursion pass after the particle arrays grew or shrank since
    the FOF that sized halo_mass: rows added since hold no halo mass and
    rows cut were dead, so the pass equals one given halo_mass padded
    with zeros or cut to the rows (the JAX package fails on the shape,
    ROADMAP C.4).  The photon budget is raised so that cells ionize."""
    _, ts, _, _ = sub_steps
    saved = (ts.particles, dataclasses.replace(ts.gas))
    gp = dataclasses.replace(
        ts.gas_physics, excursion_zstop=0.0,
        excursion=ExcursionSetParams(UVBGdim=16, ReionNionPhotPerBary=4e6))
    if change == "slots_gc":
        gp._grow_star_capacity(ts, ts.gas, 5000)
    p = ts.particles
    # the FOF's halo mass, at the size the arrays had then
    hm = torch.where(p.mask & ((p.ptype == 0) | (p.ptype == 4)), 0.5, 0.0)
    n = p.n
    if change == "grow":
        gp._grow_star_capacity(ts, ts.gas, 5000)
    else:
        gp.slots_gc(ts, ts.gas)
    m = ts.particles.n
    assert m != n
    want = torch.nn.functional.pad(hm, (0, max(m - n, 0)))[:m]
    got = gp.excursion_step(ts, ts.gas, hm)
    ref = gp.excursion_step(ts, ts.gas, want)
    ts.particles, ts.gas = saved
    assert (ref.local_j21 > 0).any()
    assert torch.equal(got.local_j21, ref.local_j21)
    assert torch.equal(got.zreion_p, ref.zreion_p)
