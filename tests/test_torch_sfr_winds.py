"""The port's star formation and winds (shenqi_tpu_torch/physics/sfr.py,
winds.py) against the JAX package's on the CPU, from one numpy seed.

Limits:
  * identical: every SFRParams.init field but PhysDensThresh, WindParams
    (init), the id hash (`_mix32`, `idhash_uniform`) on ids of 2^31 and
    above, `form_star`, `convert_whole`, `mass_of_star` and the wind kick
    masks;
  * PhysDensThresh within 1e-5 relative: it is derived from one f32
    cooling time, whose exp/log/pow differ in the last bits between XLA
    and torch;
  * entropy, SFR and metallicity within 1e-5 relative, the SFR of an
    active row within 1e-5 relative plus two f32 ulps of 1 in the
    fraction formed, 1 - exp(-p) (2.4e-7 mass/dtime: the reference's
    formula resolves a small p no finer, and exp differs in the last bit
    between XLA and torch), ne/nh within the
    cooling network's limit (tests/test_torch_cooling.py: 1e-4 relative
    or 2.4e-7 absolute), kicked velocities within 1e-5 of max |v|, the
    delay times within 1e-5 relative.
Both packages take one parameter set (the JAX package's, copied) so that
the thresholds are the same.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from shenqi_tpu.cosmology.background import Cosmology as JCosmology
from shenqi_tpu.core.particles import float_to_ipos as j_ipos
from shenqi_tpu.physics import cooling_rates as jc, sfr as jsfr, winds as jw
from shenqi_tpu.utils.units import default_units as j_units
from shenqi_tpu_torch.core.particles import float_to_ipos as t_ipos
from shenqi_tpu_torch.cosmology.background import Cosmology as TCosmology
from shenqi_tpu_torch.physics import (cooling_rates as tc, sfr as tsfr,
                                      winds as tw)
from shenqi_tpu_torch.utils.units import default_units as t_units

torch.set_num_threads(2)
COSMO = dict(Omega0=0.288, OmegaLambda=0.712, OmegaBaryon=0.0472,
             HubbleParam=0.7, RadiationOn=1)
A = 0.1


def _params(crit_phys=0.0):
    jcp = JCosmology(**COSMO)
    jcp.init(A, j_units())
    tcp = TCosmology(**COSMO)
    tcp.init(A, t_units())
    fbar = jcp.OmegaBaryon / jcp.OmegaCDM
    jsp = jsfr.SFRParams(CritPhysDensity=crit_phys).init(
        jcp, j_units(), 3e-3, jc.UVBG(), jc.CoolingParams(fBar=fbar))
    tsp = tsfr.SFRParams(CritPhysDensity=crit_phys).init(
        tcp, t_units(), 3e-3, tc.UVBG(), tc.CoolingParams(fBar=fbar))
    return jsp, tsp, fbar


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(a), 1e-300)


def test_sfr_params_init():
    jsp, tsp, _ = _params()
    for f in dataclasses.fields(jsp):
        a, b = getattr(jsp, f.name), getattr(tsp, f.name)
        if f.name == "PhysDensThresh":
            assert _rel(a, b) < 1e-5
        else:
            assert a == b, f.name
    assert tsp.min_egyspec() == jsp.min_egyspec()
    # an explicit threshold needs no cooling time: identical
    jsp, tsp, _ = _params(crit_phys=0.3)
    assert jsp.PhysDensThresh == tsp.PhysDensThresh
    ju, tu = j_units(), t_units()
    for model in (6, 11, 8):
        jwp = jw.WindParams(WindModel=model).init(
            jsp.FactorSN, jsp.EgySpecSN, jsp.PhysDensThresh,
            ju.UnitTime_in_s)
        twp = tw.WindParams(WindModel=model).init(
            tsp.FactorSN, tsp.EgySpecSN, tsp.PhysDensThresh,
            tu.UnitTime_in_s)
        assert dataclasses.asdict(jwp) == dataclasses.asdict(twp)


def test_idhash_bits():
    rng = np.random.default_rng(0)
    a = rng.integers(2 ** 31, 2 ** 32, 5000, dtype=np.uint64)
    a[:4] = [2 ** 31, 2 ** 32 - 1, 2 ** 31 + 1, 3 * 2 ** 30]
    b = rng.integers(0, 2 ** 32, 5000, dtype=np.uint64)
    ja = jnp.asarray(a.astype(np.uint32))
    jb = jnp.asarray(b.astype(np.uint32))
    ta = torch.from_numpy(a.astype(np.int64))
    tb = torch.from_numpy(b.astype(np.int64))
    np.testing.assert_array_equal(
        tw._mix32(ta, tb).numpy(),
        np.asarray(jw._mix32(ja, jb)).astype(np.int64))
    for salt in (0, 12345, 2 ** 32 - 1):
        for lane in (0, 1, 2):
            want = np.asarray(jw.idhash_uniform(np.uint32(salt), ja, lane))
            got = tw.idhash_uniform(salt, ta, lane).numpy()
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))


def _gas_inputs(jsp, n=600, seed=1):
    """Gas across the SF threshold, some of it inactive (dtime 0), some
    of it not gas, ids from 2^31 up."""
    rng = np.random.default_rng(seed)
    a3inv = 1.0 / A ** 3
    dens = (jsp.PhysDensThresh / a3inv
            * 10 ** rng.uniform(-2, 5, n)).astype(np.float32)
    ent = (10 ** rng.uniform(-1, 3, n)).astype(np.float32)
    mass = np.where(rng.uniform(size=n) < 0.3, 1e-3, 3e-3) \
        * rng.uniform(0.9, 1.1, n)
    d = dict(
        density=dens, egywt=dens * rng.uniform(0.9, 1.1, n),
        entropy=ent, mass=mass.astype(np.float32),
        ne=rng.uniform(0, 1.2, n).astype(np.float32),
        metallicity=rng.uniform(0, 0.02, n).astype(np.float32),
        generation=rng.integers(0, 6, n).astype(np.int32),
        dtime=np.where(rng.uniform(size=n) < 0.2, 0.0,
                       rng.uniform(1e-3, 3e-2, n)).astype(np.float32),
        is_gas=rng.uniform(size=n) < 0.95,
        pids=rng.integers(2 ** 31, 2 ** 32, n, dtype=np.uint64).astype(
            np.uint32))
    return d


@pytest.mark.parametrize("crit_phys", [0.0, 0.3])
def test_starformation_step(crit_phys):
    jsp, _, fbar = _params(crit_phys)
    tsp = tsfr.SFRParams(**dataclasses.asdict(jsp))
    cu_j = jsfr.CoolingUnits.create(j_units(), 0.7)
    cu_t = tsfr.CoolingUnits.create(t_units(), 0.7)
    d = _gas_inputs(jsp)
    key = jax.random.PRNGKey(42)
    for _ in range(3):
        key, sub = jax.random.split(key)
    jr = jsfr.starformation_step(
        sub, jnp.asarray(d["density"]), jnp.asarray(d["egywt"]),
        jnp.asarray(d["entropy"]), jnp.asarray(d["mass"]),
        jnp.asarray(d["ne"]), jnp.asarray(d["metallicity"]),
        jnp.asarray(d["generation"]), jnp.asarray(d["dtime"]), 1 / A ** 3,
        1 / A - 1, jc.UVBG(), jsp, jc.CoolingParams(fBar=fbar), cu_j,
        jnp.asarray(d["is_gas"]), pids=jnp.asarray(d["pids"]))
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()
         if k != "pids"}
    tr = tsfr.starformation_step(
        tuple(int(x) for x in np.asarray(sub)), t["density"], t["egywt"],
        t["entropy"], t["mass"], t["ne"], t["metallicity"],
        t["generation"], t["dtime"], 1 / A ** 3, 1 / A - 1, tc.UVBG(), tsp,
        tc.CoolingParams(fBar=fbar), cu_t, t["is_gas"],
        pids=torch.from_numpy(d["pids"].view(np.int32)))
    form = np.asarray(jr.form_star)
    on = np.asarray(jr.sfr) > 0
    # the inputs reach every branch
    assert form.sum() >= 5 and (form & np.asarray(jr.convert_whole)).any() \
        and (form & ~np.asarray(jr.convert_whole)).any()
    assert on.sum() > 50 and (~on & (d["dtime"] > 0)).sum() > 50
    for k in ("form_star", "convert_whole", "mass_of_star"):
        np.testing.assert_array_equal(getattr(tr, k).numpy(),
                                      np.asarray(getattr(jr, k)), k)
    for k in ("entropy", "metallicity"):
        assert _rel(np.asarray(getattr(jr, k)),
                    getattr(tr, k).numpy()).max() < 1e-5, k
    jsfr_ = np.asarray(jr.sfr, np.float64)
    res = np.where(d["dtime"] > 0, 2.4e-7 * d["mass"]
                   / np.maximum(d["dtime"], 1e-30), 0.0) \
        * jsp.UnitSfr_in_solar_per_year
    assert (np.abs(jsfr_ - tr.sfr.numpy())
            <= 1e-5 * np.abs(jsfr_) + res).all()
    jne, tne = np.asarray(jr.ne, np.float64), tr.ne.numpy()
    assert (np.abs(jne - tne)
            <= np.maximum(1e-4 * np.abs(jne), 2.4e-7)).all()


def _wind_inputs(n=3000, ns=8, seed=2):
    rng = np.random.default_rng(seed)
    box = 5000.0
    gpos = rng.uniform(0, box, (n, 3))
    # stars on gas rows, and a tight group of gas around them
    srows = rng.choice(n, ns - 2, replace=False)
    gpos[:400] = gpos[srows[rng.integers(0, ns - 2, 400)]] \
        + rng.normal(0, 30.0, (400, 3))
    spos = np.concatenate([gpos[srows], gpos[srows[:2]]]) % box
    d = dict(box=box, gpos=gpos % box, spos=spos,
             shsml=rng.uniform(40, 90, ns).astype(np.float32),
             smass=np.concatenate([rng.uniform(1e-3, 3e-3, ns - 2),
                                   [0.0, 0.0]]).astype(np.float32),
             svdisp=rng.uniform(3, 15, ns).astype(np.float32),
             gmass=rng.uniform(2e-3, 3e-3, n).astype(np.float32),
             gvel=rng.normal(0, 30, (n, 3)).astype(np.float32),
             gent=(10 ** rng.uniform(0, 2, n)).astype(np.float32),
             gdens=(10 ** rng.uniform(-6, -3, n)).astype(np.float32),
             gdelay=np.where(rng.uniform(size=n) < 0.05, 0.01,
                             0.0).astype(np.float32),
             galive=rng.uniform(size=n) < 0.97)
    return d


@pytest.mark.parametrize("pair_block", [1 << 24, 1000])
def test_winds_star_feedback(pair_block):
    """The ofjt10 neighbour kick at a bucket of 8 lanes (two of them
    padding, mass 0), in one block and in blocks of 125 gas rows."""
    jsp, _, _ = _params()
    ju = j_units()
    jwp = jw.WindParams(WindModel=jw.WIND_MODEL_OFJT10).init(
        jsp.FactorSN, jsp.EgySpecSN, jsp.PhysDensThresh, ju.UnitTime_in_s)
    twp = tw.WindParams(**dataclasses.asdict(jwp))
    d = _wind_inputs()
    box = d["box"]
    key = jax.random.split(jax.random.PRNGKey(42))[1]
    jres = jw.winds_star_feedback(
        key, j_ipos(d["spos"], box), jnp.asarray(d["shsml"]),
        jnp.asarray(d["smass"]), jnp.asarray(d["svdisp"]),
        j_ipos(d["gpos"], box), jnp.asarray(d["gmass"]),
        jnp.asarray(d["gvel"]), jnp.asarray(d["gent"]),
        jnp.asarray(d["gdens"]), jnp.asarray(d["gdelay"]),
        jnp.asarray(d["galive"]), box, A, 1 / A ** 3, jwp)
    t = {k: torch.from_numpy(v) for k, v in d.items()
         if isinstance(v, np.ndarray) and k not in ("gpos", "spos")}
    tres = tw.winds_star_feedback(
        tuple(int(x) for x in np.asarray(key)),
        t_ipos(d["spos"], box, device="cpu"), t["shsml"], t["smass"],
        t["svdisp"], t_ipos(d["gpos"], box, device="cpu"), t["gmass"],
        t["gvel"], t["gent"], t["gdens"], t["gdelay"], t["galive"], box, A,
        1 / A ** 3, twp, pair_block=pair_block)
    jv, jent, jdel = (np.asarray(x, np.float64) for x in jres)
    tv_, tent, tdel = (x.numpy() for x in tres)
    jkick = np.any(jv != d["gvel"], axis=1)
    tkick = np.any(tv_ != d["gvel"], axis=1)
    assert 20 < jkick.sum() < 390
    np.testing.assert_array_equal(tkick, jkick)
    assert np.abs(jv - tv_).max() < 1e-5 * np.abs(jv).max()
    assert _rel(jent, tent).max() < 1e-5
    assert _rel(jdel, tdel).max() < 1e-5
    a3inv = 1 / A ** 3
    dt = np.full(len(jdel), 0.004, np.float32)
    np.testing.assert_array_equal(
        tw.winds_decay(torch.from_numpy(tdel.astype(np.float32)),
                       t["gdens"], a3inv, torch.from_numpy(dt),
                       twp).numpy() > 0,
        np.asarray(jw.winds_decay(jnp.asarray(tdel.astype(np.float32)),
                                  jnp.asarray(d["gdens"]), a3inv,
                                  jnp.asarray(dt), jwp)) > 0)
    np.testing.assert_array_equal(
        tw.is_decoupled(t["gdelay"], t["gdens"], a3inv, twp).numpy(),
        np.asarray(jw.is_decoupled(jnp.asarray(d["gdelay"]),
                                   jnp.asarray(d["gdens"]), a3inv, jwp)))


def test_winds_subgrid_step():
    """The SH03 subgrid kick with id-keyed draws."""
    jsp, _, _ = _params()
    jwp = jw.WindParams(WindModel=jw.WIND_MODEL_SH03).init(
        jsp.FactorSN, jsp.EgySpecSN, jsp.PhysDensThresh,
        j_units().UnitTime_in_s)
    twp = tw.WindParams(**dataclasses.asdict(jwp))
    d = _wind_inputs()
    n = len(d["gmass"])
    rng = np.random.default_rng(3)
    sm = np.where(rng.uniform(size=n) < 0.3, d["gmass"] * 0.2,
                  0.0).astype(np.float32)
    elig = rng.uniform(size=n) < 0.9
    pids = rng.integers(2 ** 31, 2 ** 32, n, dtype=np.uint64).astype(
        np.uint32)
    key = jax.random.split(jax.random.PRNGKey(7))[1]
    vd = np.full(n, 80.0, np.float32)
    jres = jw.winds_subgrid_step(
        key, jnp.asarray(d["gvel"]), jnp.asarray(d["gent"]),
        jnp.asarray(d["gdens"]), jnp.asarray(d["gdelay"]),
        jnp.asarray(d["gmass"]), jnp.asarray(sm), jnp.asarray(vd), A,
        1 / A ** 3, jwp, eligible=jnp.asarray(elig),
        pids=jnp.asarray(pids))
    tres = tw.winds_subgrid_step(
        tuple(int(x) for x in np.asarray(key)),
        torch.from_numpy(d["gvel"]), torch.from_numpy(d["gent"]),
        torch.from_numpy(d["gdens"]), torch.from_numpy(d["gdelay"]),
        torch.from_numpy(d["gmass"]), torch.from_numpy(sm),
        torch.from_numpy(vd), A, 1 / A ** 3, twp,
        eligible=torch.from_numpy(elig),
        pids=torch.from_numpy(pids.view(np.int32)))
    jv = np.asarray(jres.vel, np.float64)
    tv_ = tres.vel.numpy()
    jkick = np.any(jv != d["gvel"], axis=1)
    assert jkick.sum() > 50
    np.testing.assert_array_equal(np.any(tv_ != d["gvel"], axis=1), jkick)
    assert np.abs(jv - tv_).max() < 1e-5 * np.abs(jv).max()
    assert _rel(jres.entropy, tres.entropy.numpy()).max() < 1e-5
    assert _rel(jres.delay_time, tres.delay_time.numpy()).max() < 1e-5
