"""The port's slab source stage (shenqi_tpu_torch/parallel/slab_sim.py:
proto_sources and its stages) on 1, 2 and 4 gloo ranks against the JAX
SlabSimulation on make_mesh(1), from the same forced states, aligned by
64-bit id.  Each case runs on one world size (the SF case on 1 and 4
ranks; RUNS), so that a test costs one JAX oracle and one spawn.

Each case starts in both packages from one state: the JAX slab loop's
from_species with tests/test_slab_subgrid.py's forcing (by id), its
`fields` carried to every rank through convert.slab_rows_from_numpy.
Cases (2 x 8^3 of _gas_dm_ics, box 1000, NMESH 16):

  * sf: test_slab_subgrid.py:27-116's SF with generation splits and SH03
    subgrid winds, an eighth of the gas at 0.4 of its mass so that those
    rows convert whole, two _gas_source_terms calls at dtime 1e-2 (the
    neighbour-kick winds, subgrid_slab.winds_slab, are held pass by pass
    in test_torch_subgrid_slab.py and through the CLI in
    test_torch_mesh_subgrid_cli.py);
  * metal: test_slab_subgrid.py:119-170's old stars, one
    _slab_metal_return;
  * bh: test_slab_subgrid.py:173-240's black holes, one
    _slab_blackhole_step at dtime 5, with dynamical friction (veldisp_slab
    over the collisionless rows);
  * cool: cooling alone without TreeCool (a = 0.1, warm forced gas);
  * tables: cooling alone with a TREECOOL-layout table, a
    UVFluctuationFile (z_reion 6 in one octant, 10 elsewhere, at z = 6.4)
    and a MetalCoolFile with metal-rich gas, the tables written in
    process;
  * run: the sf state with a quarter of the gas in the wind phase and the
    recoupling density below the gas's, so those rows are hydro-decoupled,
    then two whole `run` steps (density, hydro, gravity, kicks, sources).

Limits: ids, ptype and the gas rows' generation exact (a star's
generation is in its id's top byte); the float columns at
test_slab_subgrid.py's limits (rtol 1e-6 for SF and winds, 1e-5 for the
metal return and the BHs, there with 1e-5 of the column's largest value
too, the single-device limit of test_torch_blackhole_sim.py, since the
kernel's f32 rounding differs between the packages near its edge), but ne
and the cooled entropies within 1e-4 relative (ne or 2.4e-7 absolute),
the limit of the cooling solver's own parity (test_torch_cooling.py);
mass conserved to 1e-5.  The run case holds ids
and ptype exactly and at least 99% of the rows within each limit:
positions within 2e-5 of the box, velocities within 1e-3 (relative, and
of the largest), the gas entropy within 1e-2 (test_torch_mesh_gas_cli.py's
limit for the slab gas: the two packages' hydro passes differ).
The JAX oracle of a case is computed once per worker on first use; the
rank bodies import nothing of JAX and hand their rows back through .npz
files.
"""

import numpy as np
import pytest

from test_torch_slab_domain import SpawnCache, spawn_ranks

BOX, NMESH = 1000.0, 16
CASES = ("sf", "metal", "bh", "cool", "tables", "run")
# (a0, ics seed, gas mass, DM mass) of each case
SETUP = {"sf": (0.25, 11, 1e-3, 4e-3),
         "metal": (0.3, 13, 1e-3, 4e-3), "bh": (0.3, 17, 1e-3, 4e-3),
         "cool": (0.1, 5, 0.4, 1.6), "tables": (0.135, 5, 0.4, 1.6),
         "run": (0.25, 11, 1e-3, 4e-3)}
COSMO = dict(Omega0=0.3, OmegaLambda=0.7, OmegaBaryon=0.05, HubbleParam=0.7,
             CMBTemperature=2.7255, RadiationOn=1)
UNITS = (3.085678e21, 1.989e43, 1e5)
BH = dict(SeedBlackHoleMass=5e-3, BlackHoleAccretionFactor=100.0,
          BlackHoleNgbFactor=2.0, BlackHoleMaxAccretionRadius=200.0,
          BlackHoleFeedbackFactor=0.05, UnitVelocity_in_cm_per_s=1e5)
KEYS = {"sf": 7, "bh": 5, "run": 7}


def _ics(seed):
    """tests/test_slab_gas.py:25-39's 2 x 8^3 lattice ICs."""
    ng = 8
    rng = np.random.RandomState(seed)
    grid = (np.arange(ng) + 0.5) * BOX / ng
    X, Y, Z = np.meshgrid(grid, grid, grid, indexing="ij")
    lat = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1)
    n = len(lat)
    pos_g = (lat + rng.normal(0, BOX / 60, lat.shape)) % BOX
    pos_d = ((lat + 0.5 * BOX / ng) + rng.normal(0, BOX / 60, lat.shape)) % BOX
    vel_g = rng.normal(0, 2.0, lat.shape).astype(np.float32)
    vel_d = rng.normal(0, 2.0, lat.shape).astype(np.float32)
    ids_g = np.arange(1, n + 1, dtype=np.uint64)
    ids_d = np.arange(n + 1, 2 * n + 1, dtype=np.uint64)
    return (pos_g, vel_g, ids_g), (pos_d, vel_d, ids_d), n


def _species(case):
    a0, seed, m_g, m_d = SETUP[case]
    (pg, vg, ig), (pd, vd, idd), _ = _ics(seed)
    return [(0, pg, vg, m_g, ig), (1, pd, vd, m_d, idd)]


def _physics(case, mods, tables=None):
    """The case's configuration from one package's modules (`mods`: a dict
    of that package's cosmology, units, cooling, sfr, winds, blackhole and
    metal return modules): (cosmology, units, coolpar, coolunits, sfrpar,
    windpar, bhpar, metals, treecool, zreion, metal_cool)."""
    a0, _, m_g, _ = SETUP[case]
    units = mods["units"].get_unitsystem(*UNITS)
    cp = mods["cosmo"].Cosmology(**COSMO)
    cp.init(0.1, units)
    cr, sfr, wd = mods["cooling"], mods["sfr"], mods["winds"]
    coolpar = cr.CoolingParams(fBar=cp.OmegaBaryon
                               / max(cp.Omega0 - cp.OmegaBaryon, 1e-10))
    cu = sfr.CoolingUnits.create(units, cp.HubbleParam)
    out = dict(cp=cp, units=units, coolpar=coolpar, cu=cu)
    if case in ("sf", "run"):
        sp = sfr.SFRParams(Generations=4)
        sp.init(cp, units, avg_baryon_mass=m_g, uvbg0=cr.UVBG(),
                coolpar=coolpar)
        wp = wd.WindParams(WindModel=wd.WIND_MODEL_SH03,
                           WindFreeTravelLength=20.0)
        wp.init(sp.FactorSN, sp.EgySpecSN, sp.PhysDensThresh,
                units.UnitTime_in_s)
        out.update(sp=sp, wp=wp)
    if case == "bh":
        out["bhpar"] = mods["bh"].BHParams(**BH)
    if case == "metal":
        import os
        ydir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "data_yields")
        out["metals"] = mods["metal"].MetalReturn.load(ydir)
    if case == "tables":
        uvf = mods["uvf"]
        out.update(treecool=cr.TreeCool(tables["treecool"],
                                        coolpar.PhotoIonizeFactor),
                   zreion=uvf.ZreionTable.load(tables["zreion"], BOX,
                                               UNITS[0]),
                   metal_cool=uvf.MetalCoolingTable.load(tables["metal"]))
    return out


def _tables(tmp):
    from chip_smoke import _metal_cool_table, _zreion_table
    from test_torch_cooling import _treecool
    tmp.mkdir(parents=True, exist_ok=True)
    return {"treecool": _treecool(tmp / "TREECOOL"),
            "zreion": _zreion_table(tmp / "UVF", BOX / 1000.0),
            "metal": _metal_cool_table(tmp / "MC")}


# ------------------------------------------------------------ JAX oracle

_REF = {}


def _jax_mods():
    from shenqi_tpu import cosmology
    from shenqi_tpu.physics import (blackhole, cooling_rates, metal_return,
                                    sfr, uv_fluctuations, winds)
    from shenqi_tpu.utils import units
    return {"cosmo": cosmology, "units": units, "cooling": cooling_rates,
            "sfr": sfr, "winds": winds, "bh": blackhole,
            "metal": metal_return, "uvf": uv_fluctuations}


def _jax_ref(case, tmp):
    """(fields before, alive rows after sorted by id, {stars formed, steps
    taken}, the tables' paths) of a case."""
    if case in _REF:
        return _REF[case]
    import jax
    import jax.numpy as jnp
    from shenqi_tpu.core.integrate import TimestepParams
    from shenqi_tpu.core.timeline import Timeline
    from shenqi_tpu.parallel.sharded import make_mesh
    from shenqi_tpu.parallel.slab_sim import SlabSimulation
    from shenqi_tpu.utils.constants import GAMMA_MINUS1
    a0 = SETUP[case][0]
    a3inv = 1.0 / a0 ** 3
    tables = _tables(tmp / "tables") if case == "tables" else None
    ph = _physics(case, _jax_mods(), tables)
    a_end = a0 + 0.01
    sim = SlabSimulation.from_species(
        make_mesh(1), _species(case), ph["cp"], BOX, NMESH,
        Timeline.setup([a_end], a0, a_end), a0, gas_u0=100.0,
        tsp=TimestepParams())
    f = sim.fields
    is_gas = (f["ptyp"] == 0) & (f["mass"] > 0)
    idl = f["id_lo"]
    if case in ("sf", "run", "cool", "tables"):
        sim.cooling_on = True
        sim.coolpar, sim.coolunits = ph["coolpar"], ph["cu"]
    if case in ("sf", "run"):
        sp = ph["sp"]
        sim.sfr_on = sim.winds_on = True
        sim.sfrpar, sim.windpar = sp, ph["wp"]
        dens = jnp.where(idl % 2 == 0, 20.0, 0.01) * sp.PhysDensThresh / a3inv
        dens = jnp.where(is_gas, dens, 0.0)
        u0 = sp.temp_to_u * 1e4
        ent = u0 * GAMMA_MINUS1 / jnp.maximum(dens * a3inv,
                                              1e-35) ** GAMMA_MINUS1
        f["density"], f["egywt"] = dens, dens
        f["entropy"] = jnp.where(is_gas, ent, f["entropy"])
        f["hsml"] = jnp.where(is_gas, 50.0, f["hsml"])
        if case == "sf":
            # an eighth of the gas at 0.4 of its mass, below two star
            # masses (the mass a row has left after three splits), so
            # those rows convert whole
            f["mass"] = jnp.where(is_gas & (idl % 8 == 0),
                                  jnp.float32(0.4 * SETUP[case][2]),
                                  f["mass"])
        if case == "run":
            # a quarter of the gas in the wind phase, the recoupling
            # density a hundredth of the run's mean gas density
            f["delay"] = jnp.where(is_gas & (idl % 4 == 1), 5e-3, 0.0)
            sim.windpar.WindFreeTravelDensThresh = float(
                1e-2 * SETUP[case][2] * 512 / BOX ** 3 * a3inv)
            sim._entropy_is_u = False
    if case == "metal":
        sim.metal_return_on, sim.metals = True, ph["metals"]
        star = is_gas & (idl % 16 == 0)
        f["ptyp"] = jnp.where(star, jnp.int32(4), f["ptyp"])
        f["birtha"] = jnp.where(star, jnp.float32(0.1), f["birtha"])
        f["m0"] = jnp.where(star, f["mass"], f["m0"])
        f["smet"] = jnp.where(star, jnp.float32(0.01), f["smet"])
        f["hsml"] = jnp.where(f["mass"] > 0, 120.0, f["hsml"])
    if case == "bh":
        sim.bh_on, sim.bhpar, sim.bh_dynfric_on = True, ph["bhpar"], True
        f["density"] = jnp.where(is_gas, 1e-7, 0.0)
        f["entropy"] = jnp.where(is_gas, 50.0, f["entropy"])
        f["hsml"] = jnp.where(is_gas, 80.0, f["hsml"])
        rows = np.nonzero(np.asarray(is_gas)
                          & (np.asarray(idl) % 64 == 0))[0]
        sim._seed_bh_rows(rows)
    if case in ("cool", "tables"):
        rng = np.random.RandomState(3)
        mean = SETUP[case][2] * 512 / BOX ** 3
        dens = jnp.asarray(np.exp(rng.uniform(0, 6, len(idl)))
                           .astype(np.float32) * mean)
        dens = jnp.where(is_gas, dens, 0.0)
        temp = jnp.asarray(10 ** rng.uniform(3.5, 6.0, len(idl))
                           .astype(np.float32))
        u = temp * jnp.float32(1.5 * 1.380649e-16 / 1.6726e-24 / 0.6
                               / 1e10)
        f["density"], f["egywt"] = dens, dens
        f["entropy"] = jnp.where(is_gas, u * GAMMA_MINUS1 / jnp.maximum(
            dens * a3inv, 1e-35) ** GAMMA_MINUS1, f["entropy"])
        if case == "tables":
            sim.treecool = ph["treecool"]
            sim.zreion_table = ph["zreion"]
            sim.metal_cool = ph["metal_cool"]
            f["met"] = jnp.where(is_gas, 0.02, 0.0)
    if case in KEYS:
        sim.rng_key = jax.random.PRNGKey(KEYS[case])
    before = {k: np.asarray(v) for k, v in sim.fields.items()}
    if case == "sf":
        sim._gas_source_terms(dtime=1e-2)
        sim._gas_source_terms(dtime=1e-2)
    elif case in ("cool", "tables"):
        sim._gas_source_terms(dtime=1e-2)
    elif case == "metal":
        sim._slab_metal_return()
    elif case == "bh":
        sim._slab_blackhole_step(dtime=5.0)
    else:
        sim.run(max_steps=2)
    g = sim.gather_alive()
    o = np.argsort(g["id"])
    info = {"stars": sim.star_count, "steps": sim.step_count}
    _REF[case] = (before, {k: v[o] for k, v in g.items()}, info, tables)
    return _REF[case]


# ------------------------------------------------------------ the ranks

def _torch_mods():
    from shenqi_tpu_torch.cosmology import background
    from shenqi_tpu_torch.physics import (blackhole, cooling_rates,
                                          metal_return, sfr, uv_fluctuations,
                                          winds)
    from shenqi_tpu_torch.utils import units
    return {"cosmo": background, "units": units, "cooling": cooling_rates,
            "sfr": sfr, "winds": winds, "bh": blackhole,
            "metal": metal_return, "uvf": uv_fluctuations}


def _body(rank, dev, out, ndev, case, tables):
    import torch
    from shenqi_tpu_torch.convert import slab_rows_from_numpy
    from shenqi_tpu_torch.core.integrate import TimestepParams
    from shenqi_tpu_torch.core.timeline import Timeline
    from shenqi_tpu_torch.parallel.slab_sim import SlabSimulation
    from shenqi_tpu_torch.simulation_gas import GasPhysics
    from shenqi_tpu_torch.utils import threefry
    torch.set_num_threads(1)
    a0 = SETUP[case][0]
    a_end = a0 + 0.01
    ph = _physics(case, _torch_mods(), tables)
    src = case in ("sf", "run", "cool", "tables")
    gp = GasPhysics(
        cooling_on=src, sfr_on="sp" in ph, winds_on="wp" in ph,
        coolpar=ph["coolpar"], coolunits=ph["cu"], sfrpar=ph.get("sp"),
        windpar=ph.get("wp"), metal_return_on="metals" in ph,
        metals=ph.get("metals"), bh_on="bhpar" in ph,
        bhpar=ph.get("bhpar"), bh_dynfric_on="bhpar" in ph,
        treecool=ph.get("treecool"), zreion_table=ph.get("zreion"),
        metal_cool=ph.get("metal_cool"),
        rng_key=threefry.PRNGKey(KEYS.get(case, 42)))
    sim = SlabSimulation.from_species(
        _species(case), ph["cp"], BOX, NMESH,
        Timeline.setup([a_end], a0, a_end), a0, gas_u0=100.0,
        tsp=TimestepParams(), gas_physics=gp, device=dev)
    before = dict(np.load(f"{out}/before.npz"))
    sim._set_rows(slab_rows_from_numpy(before, rank, ndev, sim.cuts_fp,
                                       device=dev))
    if case == "run":
        gp.windpar.WindFreeTravelDensThresh = float(before["thresh"])
        sim._gas_entropy_is_u = False
    if case == "sf":
        sim._gas_source_terms(1e-2)
        sim._gas_source_terms(1e-2)
    elif case in ("cool", "tables"):
        sim._gas_source_terms(1e-2)
    elif case == "metal":
        sim._slab_metal_return()
    elif case == "bh":
        sim._slab_blackhole_step(5.0)
    else:
        sim.run(max_steps=2)
    n_dec = sum(rec.get("decoupled", 0) for rec in sim.sph_log)
    r = sim._rows()
    keep = r["mask"]
    np.savez(f"{out}/rank{rank}.npz", star_count=sim.star_count,
             n_dec=n_dec, steps=sim.step_count, n_src=len(sim.source_log),
             **{k: v[keep].cpu().numpy() for k, v in r.items()})


def _run(tmp, case, ndev):
    before, _, _, tables = _jax_ref(case, tmp.parent)
    tmp.mkdir(parents=True, exist_ok=True)
    extra = {}
    if case == "run":
        a3inv = 1.0 / SETUP[case][0] ** 3
        extra = dict(thresh=1e-2 * SETUP[case][2] * 512 / BOX ** 3 * a3inv)
    np.savez(tmp / "before.npz", **before, **extra)
    ranks = spawn_ranks(_body, ndev, tmp, ndev, case, tables)
    out = {k: np.concatenate([r[k] for r in ranks]) for k in ranks[0]
           if ranks[0][k].ndim}
    for k in ("star_count", "n_dec", "steps", "n_src"):
        out[k] = [int(r[k]) for r in ranks]
    out["id"] = ((out["id_hi"].view(np.uint32).astype(np.uint64)
                  << np.uint64(32))
                 | out["id_lo"].view(np.uint32).astype(np.uint64))
    o = np.argsort(out["id"])
    return {k: (v[o] if isinstance(v, np.ndarray) else v)
            for k, v in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return SpawnCache(tmp_path_factory.mktemp("slab_subgrid"), _run)


# (port column, JAX column, rows it is defined on, rtol, atol as a
# fraction of the column's largest value)
_SF = [("mass", "mass", "all", 1e-6, 0), ("vel", "vel", "all", 1e-6, 1e-6),
       ("entropy", "entropy", "gas", 1e-6, 0),
       ("metallicity", "met", "gas", 1e-6, 0), ("sfr", "sfr", "gas", 1e-6, 0),
       ("ne", "ne", "gas", 1e-4, 0), ("delay_time", "delay", "gas", 1e-6, 0),
       ("birth_a", "birtha", "all", 1e-6, 0), ("mass0", "m0", "all", 1e-6, 0),
       ("star_metallicity", "smet", "all", 1e-6, 0)]
_COOL = [("entropy", "entropy", "gas", 1e-4, 0), ("ne", "ne", "gas", 1e-4, 0)]
_COLS = {
    "sf": _SF,
    "metal": [("mass", "mass", "all", 1e-5, 1e-5),
              ("metallicity", "met", "gas", 1e-5, 1e-5),
              ("total_returned", "tret", "all", 1e-5, 0),
              ("last_enrich_myr", "enr", "all", 1e-5, 0)],
    "bh": [("mass", "mass", "all", 1e-5, 1e-5),
           ("bh_mass", "bhm", "all", 1e-5, 1e-5),
           ("bh_mdot", "bhmd", "all", 1e-5, 1e-5),
           ("entropy", "entropy", "gas", 1e-5, 1e-5),
           ("vel", "vel", "all", 1e-5, 1e-5)],
    "cool": _COOL, "tables": _COOL}


def _check(got, want, case):
    np.testing.assert_array_equal(got["id"], want["id"])
    np.testing.assert_array_equal(got["ptype"], want["ptyp"])
    gas = want["ptyp"] == 0
    np.testing.assert_array_equal(got["generation"][gas], want["gen"][gas])
    if case == "run":
        return
    for pk, jk, on, rtol, afrac in _COLS[case]:
        sel = gas if on == "gas" else slice(None)
        w = want[jk][sel]
        # ne: or 2.4e-7 absolute, the f32 resolution of 1 - nH0
        # (test_torch_cooling.py:57-62)
        atol = max(afrac * np.abs(w).max(), 2.4e-7 if pk == "ne" else 1e-12)
        np.testing.assert_allclose(got[pk][sel], w, rtol=rtol, atol=atol,
                                   err_msg=pk)


# each case on one world size, the SF case on two, every size in use: a
# test is one JAX oracle and one spawn, so workers repeat little
RUNS = (("sf", 1), ("sf", 4), ("metal", 2), ("bh", 4), ("cool", 2),
        ("tables", 1), ("run", 2))


@pytest.mark.parametrize("case,ndev", RUNS,
                         ids=[f"{c}-{n}" for c, n in RUNS])
def test_slab_sources_match_jax(runs, case, ndev):
    before, want, jinfo, _ = _jax_ref(case, runs.tmp)
    got = runs[(case, ndev)]
    _check(got, want, case)
    m0 = float(before["mass"].sum())
    np.testing.assert_allclose(got["mass"].sum(), m0, rtol=1e-5)
    if case == "sf":
        assert jinfo["stars"] > 0
        assert got["star_count"] == [jinfo["stars"]] * ndev
        # split children (the generation in the id's top byte), whole
        # conversions (stars that keep their id) and wind kicks
        star = want["ptyp"] == 4
        assert ((got["id"] >> np.uint64(56)) > 0).sum() > 0
        assert (star & ((got["id"] >> np.uint64(56)) == 0)).sum() > 0
        assert (got["delay_time"][want["ptyp"] == 0] > 0).any()
    if case == "metal":
        stars = want["ptyp"] == 4
        assert (got["total_returned"][stars] > 0).any()
        assert (got["metallicity"][~stars] > 0).any()
    if case == "bh":
        bh = want["ptyp"] == 5
        assert bh.sum() > 0 and (got["bh_mdot"][bh] > 0).any()
        # swallows fired: fewer rows than at the start
        assert len(got["id"]) < (before["mass"] > 0).sum()
    if case in ("cool", "tables"):
        gas = want["ptyp"] == 0
        alive = before["mass"] > 0
        ids0 = ((before["id_hi"][alive].astype(np.uint64) << np.uint64(32))
                | before["id_lo"][alive].astype(np.uint64))
        e0 = before["entropy"][alive][np.argsort(ids0)][gas]
        # the cooling changed the state
        assert not np.allclose(got["entropy"][gas], e0, rtol=1e-3)
    if case == "run":
        # two passes of the loop, the second with a source stage, as the
        # JAX run's (the step count stops short at the last sync point)
        assert got["steps"] == [jinfo["steps"]] * ndev
        assert min(got["n_src"]) > 0 and sum(got["n_dec"]) > 0
        ok = lambda a, b, tol: np.isclose(a, b, rtol=tol,
                                          atol=tol * np.abs(b).max())
        pos = got["ipos"].view(np.uint32).astype(np.int64)
        d = ((pos - want["ipos"].astype(np.int64) + 2 ** 31) % 2 ** 32
             - 2 ** 31) / 2 ** 32
        assert (np.abs(d) < 2e-5).all(axis=1).mean() >= 0.99
        assert ok(got["vel"], want["vel"], 1e-3).all(axis=1).mean() >= 0.99
        gas = want["ptyp"] == 0
        assert ok(got["entropy"][gas], want["entropy"][gas],
                  1e-2).mean() >= 0.99
