"""The gas branches of the port's CLIs against the JAX package's on the
CPU: chip_smoke's travis-hydro paramfiles (validation/travis.py:38-98 with
the subgrid switches off) at Ngrid 8, on chip_smoke's analytic EH table
and CLASS-layout transfer table.

  * genic ProduceGas = 1, with and without DifferentTransferFunctions:
    species, IDs and the mass table identical, positions within 1e-6 of
    the box, velocities within 1e-5 of their rms (tests/test_torch_cli.py's
    IC limits);
  * gadget_main with HydroOn = 1 (the run to a = 0.0105 with snapshots and
    FOF at 0.01 and 0.0105): every gas block of every PART within 1e-4 of
    its max, IDs and masses identical, FOF group counts equal;
  * the gas blocks the port writes from the JAX run's final state
    (convert.gas_state_from_numpy) equal the JAX package's, bit for bit;
  * a RestartFlag 1 resume: the restored gas state equal in both packages
    (bit for bit) and one step on within 1e-3;
  * star-small's subgrid switches (CoolingOn, StarformationOn, WindOn at
    its ofjt10 default, MetalReturnOn; no TREECOOL file, BlackHoleOn 0)
    on one small IC written here: 8^3 gas + 8^3 DM in a 5 Mpc/h box at
    a = 0.1, a clump of 128 gas rows inside 0.5% of the box above the SF
    threshold, and four star rows born at a = 0.05 with their blocks;
    the run to a = 0.1002 with snapshots and FOF at 0.1001 and 0.1002:
    the sfr.txt lines (times and counts identical, the rest within 1e-5
    relative), every star block and the star IDs identical but the
    masses and metallicities (within 1e-5 relative), the gas blocks
    within 1e-4 of their max; a RestartFlag 1 resume from the last
    snapshot that restores the star state bit for bit in both packages
    and steps on;
  * (black holes on the 16^3 version of that IC: test_torch_bh_cli.py)
  * every subgrid switch runs (helium without a ReionHistFile loads no
    history, as in the JAX CLI; the reionization runs with their tables
    are test_torch_reion_cli.py's), and so do a MetalCoolFile with
    MetalCoolingOn and a UVFluctuationFile (tables written by
    chip_smoke's `_metal_cool_table` and `_zreion_table`; the gas state
    after two steps within 1e-4 of the JAX package's max).
"""

import shutil
import types

import numpy as np
import pytest
import torch

from chip_smoke import (_GENIC_GAS, _GADGET_GAS, _eh_table, _class_tk_table,
                        _dm_small_cosmology, _metal_cool_table,
                        _zreion_table)
from shenqi_tpu.cli import gadget_main as jg
from shenqi_tpu.cli.genic_main import run_genic as j_genic

from shenqi_tpu_torch.cli import gadget_main as tg
from shenqi_tpu_torch.cli.genic_main import run_genic as t_genic
from shenqi_tpu_torch.convert import gas_state_from_numpy, particles_from_numpy
from shenqi_tpu_torch.cosmology.background import Cosmology
from shenqi_tpu_torch.io.snapshot import (SnapshotHeader, read_snapshot,
                                          write_snapshot)
from shenqi_tpu_torch.simulation_gas import GasPhysics
from shenqi_tpu_torch.utils.units import default_units
from torch_oracle import JAX_RETRIES, both_sides, shared

torch.set_num_threads(2)
BOX = 128.0
SUBGRID = ("CoolingOn", "StarformationOn", "WindOn", "BlackHoleOn",
           "MetalReturnOn", "QSOLightupOn", "HeliumReionizationOn",
           "ExcursionSetReionOn")
PORTED = SUBGRID
STAR_SMALL = ("CoolingOn", "StarformationOn", "WindOn", "MetalReturnOn")


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gascli")
    pk, tk = tmp / "pk.txt", tmp / "tk.txt"
    _eh_table(pk)
    _class_tk_table(tk, _dm_small_cosmology(), 0.01)
    return tmp, pk, tk


def _genic(tmp, pk, tk, dtf):
    paths = {}
    for name, run in (("jax", j_genic),
                      ("torch", lambda p: t_genic(p, device="cpu"))):
        gp = tmp / f"{name}{dtf}.genic"
        gp.write_text(_GENIC_GAS.format(out=tmp / f"{name}{dtf}", ng=8,
                                        pk=pk, tk=tk, dtf=dtf))
        paths[name] = run(str(gp))
    return paths


@pytest.mark.parametrize("dtf", [0, 1])
def test_genic_produce_gas_parity(tables, dtf):
    tmp, pk, tk = tables
    paths = _genic(tmp, pk, tk, dtf)
    hj, bj = read_snapshot(paths["jax"])
    ht, bt = read_snapshot(paths["torch"])
    assert sorted(bj) == sorted(bt) == [0, 1]
    np.testing.assert_array_equal(ht.MassTable, hj.MassTable)
    np.testing.assert_array_equal(ht.TotNumPart, hj.TotNumPart)
    assert hj.MassTable[0] > 0 and hj.MassTable[1] > 0
    for t in (0, 1):
        np.testing.assert_array_equal(bt[t]["ID"], bj[t]["ID"])
        d = np.abs(bt[t]["Position"] - bj[t]["Position"])
        assert np.minimum(d, BOX - d).max() < 1e-6 * BOX
        v = bj[t]["Velocity"].astype(np.float64)
        assert np.abs(bt[t]["Velocity"] - v).max() \
            < 1e-5 * np.sqrt(np.mean(v ** 2))
    # the gas lattice sits half a cell from the DM's, weighted by mass
    assert bj[0]["ID"].min() == 8 ** 3 + 1


def _gadget(path, ic, out, outputs, a):
    path.write_text(_GADGET_GAS.format(ic=ic, out=out, outputs=outputs,
                                       a=a))
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both gas runs from the JAX package's ICs, computed once per
    session, each package in its own process (torch_oracle.both_sides),
    in directories of their own."""
    tmp, ic = shared(tmp_path_factory, "gas_cli_ic", _runs_ic,
                     retries=JAX_RETRIES)
    out = both_sides(tmp_path_factory, "gas_cli", _run_gas, ic)
    return tmp, ic, dict(zip(("jax", "torch"), out))


def _runs_ic(tmp):
    pk, tk = tmp / "pk.txt", tmp / "tk.txt"
    _eh_table(pk)
    _class_tk_table(tk, _dm_small_cosmology(), 0.01)
    gp = tmp / "jax1.genic"
    gp.write_text(_GENIC_GAS.format(out=tmp / "jax1", ng=8, pk=pk, tk=tk,
                                    dtf=1))
    return tmp, j_genic(str(gp))


def _run_gas(tmp, name, ic):
    od = tmp / f"run_{name}"
    pf = _gadget(tmp / f"{name}.gadget", ic, od, "0.01,0.0105", 0.0105)
    return ((jg.run_gadget(pf) if name == "jax"
             else tg.run_gadget(pf, device="cpu")), od)


def test_gas_run_parity(runs):
    _, _, out = runs
    (sj, oj), (st, ot) = out["jax"], out["torch"]
    assert st.gas is not None and st.hierarchical
    assert st.atime() == pytest.approx(sj.atime())
    for snap in ("PART_000", "PART_001"):
        _, bj = read_snapshot(str(oj / snap))
        _, bt = read_snapshot(str(ot / snap))
        assert sorted(bt[0]) == sorted(bj[0])
        for k in ("ID", "Mass", "Generation", "ElectronAbundance"):
            np.testing.assert_array_equal(bt[0][k], bj[0][k])
        for k in ("SmoothingLength", "Density", "EgyWtDensity",
                  "InternalEnergy", "Velocity"):
            a = np.asarray(bj[0][k], np.float64)
            assert np.abs(np.asarray(bt[0][k]) - a).max() \
                < 1e-4 * np.abs(a).max(), (snap, k)
            assert np.isfinite(bt[0][k]).all()
        for k in ("SmoothingLength", "Density", "EgyWtDensity",
                  "InternalEnergy"):
            assert (bt[0][k] > 0).all()
    for pig in ("PIG_000", "PIG_001"):
        assert (ot / pig).is_dir()


def test_gas_blocks_from_one_state(runs):
    """The port's gas blocks of the JAX run's final state are the JAX
    package's last snapshot's, bit for bit."""
    _, _, out = runs
    sj, oj = out["jax"]
    p = sj.particles
    s = types.SimpleNamespace(
        particles=particles_from_numpy(
            {f: np.asarray(getattr(p, f))
             for f in type(p).__dataclass_fields__}, device="cpu"),
        gas=gas_state_from_numpy(
            {f: (None if getattr(sj.gas, f) is None
                 else np.asarray(getattr(sj.gas, f)))
             for f in type(sj.gas).__dataclass_fields__}, device="cpu"))
    s.gas.ngas = sj.gas.ngas
    sel = np.asarray(p.mask) & (np.asarray(p.ptype) == 0)
    mine = tg._gas_blocks(s, 0, sel, sj.atime())
    _, bj = read_snapshot(str(oj / "PART_001"))
    assert sorted(mine) == sorted(set(bj[0]) - {"Position", "Velocity",
                                                "Mass", "ID"})
    for k, v in mine.items():
        np.testing.assert_array_equal(v, bj[0][k], err_msg=k)
        assert v.dtype == bj[0][k].dtype, k


def test_restart_restores_gas_state(runs, monkeypatch, tmp_path):
    """RestartFlag 1 from the JAX run's last snapshot, in both packages
    (each in its own copy of the output): the restored state is the same,
    and one step on the runs agree."""
    _, ic, out = runs
    tmp = tmp_path
    _, oj = out["jax"]
    restored = {}
    for name, mod in (("jax", jg), ("torch", tg)):
        real = mod._restore_gas_state

        def spy(sim, *a, _real=real, _name=name, **kw):
            _real(sim, *a, **kw)
            g = sim.gas
            restored[_name] = {
                f: np.array(getattr(g, f)) for f in
                ("entropy", "density", "egy_wt_density", "ne")}
            restored[_name]["hsml"] = np.array(sim.particles.hsml)
        monkeypatch.setattr(mod, "_restore_gas_state", spy)
    sims = {}
    for name in ("jax", "torch"):
        od = tmp / f"resume_{name}"
        shutil.copytree(oj, od)
        pf = _gadget(tmp / f"r{name}.gadget", ic, od,
                     "0.01,0.0105,0.011", 0.011)
        sims[name] = (jg.run_gadget(pf, 1, max_steps=2) if name == "jax"
                      else tg.run_gadget(pf, 1, max_steps=2, device="cpu"))
    for k, v in restored["jax"].items():
        np.testing.assert_array_equal(restored["torch"][k], v, err_msg=k)
    sj, st = sims["jax"], sims["torch"]
    assert st.atime() == pytest.approx(sj.atime()) and st.atime() > 0.0105
    for f in ("entropy", "density"):
        a = np.asarray(getattr(sj.gas, f), np.float64)
        b = getattr(st.gas, f).numpy()
        assert (np.abs(a - b) / np.abs(a) < 1e-3).mean() >= 0.99, f


@pytest.mark.parametrize("switch", SUBGRID)
def test_subgrid_switch_refused(runs, switch, tmp_path):
    """Each subgrid switch, once refused, now runs: two steps of the gas
    run with it on (GasPhysics takes helium and the excursion set)."""
    _, ic, _ = runs
    tmp = tmp_path
    pf = tmp / f"refuse_{switch}.gadget"
    text = _GADGET_GAS.format(ic=ic, out=tmp / f"refused_{switch}",
                              outputs="0.0105", a=0.0105)
    if f"{switch} = 0" in text:
        text = text.replace(f"{switch} = 0", f"{switch} = 1")
    else:
        text += f"{switch} = 1\n"
    pf.write_text(text)
    assert switch in PORTED
    sim = tg.run_gadget(str(pf), max_steps=2, device="cpu")
    assert sim.atime() > 0.01
    gp = sim.gas_physics
    if switch in ("QSOLightupOn", "HeliumReionizationOn"):
        # no ReionHistFile: no history is loaded (gadget_main.py:993-1008)
        assert gp.helium is None
        assert GasPhysics(helium=True).helium is True
    elif switch == "ExcursionSetReionOn":
        assert gp.excursion is not None and gp.j21_coeffs is None
    else:
        assert getattr(gp, {
            "CoolingOn": "cooling_on", "StarformationOn": "sfr_on",
            "WindOn": "winds_on", "MetalReturnOn": "metal_return_on",
            "BlackHoleOn": "bh_on"}[switch])


@pytest.mark.parametrize("line", ["MetalCoolFile = x.hdf5\nMetalCoolingOn = 1",
                                  "UVFluctuationFile = x.txt"])
def test_subgrid_file_refused(runs, line, tmp_path):
    """The metal-line cooling and UV fluctuation tables, no longer
    refused: a gas run with CoolingOn and the table (written here, `x`
    standing for its path) runs two steps in both packages, to the same
    gas state within 1e-4 of its max."""
    _, ic, _ = runs
    tmp = tmp_path
    name = line.split(" ")[0]
    table = (_zreion_table(tmp / "UVF", 128.0)
             if name == "UVFluctuationFile" else _metal_cool_table(tmp / "MC"))
    sims = {}
    for pkg, mod in (("jax", jg), ("torch", tg)):
        pf = tmp / f"file_{name}_{pkg}.gadget"
        pf.write_text(_GADGET_GAS.format(
            ic=ic, out=tmp / f"file_{name}_{pkg}", outputs="0.0105",
            a=0.0105).replace("CoolingOn = 0", "CoolingOn = 1")
            + line.replace("x.hdf5", table).replace("x.txt", table) + "\n")
        sims[pkg] = (mod.run_gadget(str(pf), max_steps=2) if pkg == "jax"
                     else mod.run_gadget(str(pf), max_steps=2,
                                         device="cpu"))
    sj, st = sims["jax"], sims["torch"]
    gp = st.gas_physics
    assert (gp.zreion_table if name == "UVFluctuationFile"
            else gp.metal_cool) is not None
    assert st.atime() == pytest.approx(sj.atime()) and st.atime() > 0.01
    for f in ("entropy", "ne", "density"):
        a = np.asarray(getattr(sj.gas, f), np.float64)
        b = getattr(st.gas, f).numpy()
        assert np.isfinite(b).all()
        assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max(), f


# ------------------------------------------------------------ star-small
SS_BOX, SS_NG, SS_A = 5000.0, 8, 0.1


def _star_ic(path, ng=SS_NG, stars_in_clump=0):
    """ng^3 gas + ng^3 DM at a = 0.1 in a 5 Mpc/h box: the gas lattice
    jittered, 128 gas rows in a clump of radius 0.5% of the box around
    (0.3, 0.4, 0.5), four old stars with their blocks (the first
    `stars_in_clump` of them in the clump), and the gas blocks a resume
    reads (so the run starts from that state)."""
    cp = Cosmology(Omega0=0.288, OmegaLambda=0.712, OmegaBaryon=0.0472,
                   HubbleParam=0.7, RadiationOn=1)
    cp.init(SS_A, default_units())
    rng = np.random.default_rng(7)
    n = ng ** 3
    g = (np.arange(ng) + 0.5) * SS_BOX / ng
    lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    gpos = lat + rng.normal(0, 0.05 * SS_BOX / ng, lat.shape)
    k = 128
    r = 0.005 * SS_BOX * rng.uniform(0, 1, k) ** (1 / 3)
    d = rng.normal(size=(k, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    gpos[:k] = np.array([0.3, 0.4, 0.5]) * SS_BOX + r[:, None] * d
    mg = cp.OmegaBaryon * cp.RhoCrit * SS_BOX ** 3 / n
    md = (cp.Omega0 - cp.OmegaBaryon) * cp.RhoCrit * SS_BOX ** 3 / n
    ns = 4
    spos = lat[rng.choice(n, ns, replace=False)] + 0.3
    spos[:stars_in_clump] = (np.array([0.3, 0.4, 0.5]) * SS_BOX
                             + 2.0 * np.arange(stars_in_clump)[:, None])

    def vel(m):
        return rng.normal(0, 5, (m, 3)).astype(np.float32)

    def f32(m, v):
        return np.full(m, v, np.float32)

    blocks = {
        0: {"Position": gpos % SS_BOX, "Velocity": vel(n),
            "Mass": f32(n, mg), "ID": np.arange(1, n + 1, dtype=np.uint64),
            "Density": f32(n, cp.OmegaBaryon * cp.RhoCrit),
            "InternalEnergy": f32(n, 30.0),
            "SmoothingLength": f32(n, 2 * SS_BOX / ng)},
        1: {"Position": (lat + 0.5 * SS_BOX / ng) % SS_BOX,
            "Velocity": vel(n), "Mass": f32(n, md),
            "ID": np.arange(n + 1, 2 * n + 1, dtype=np.uint64)},
        4: {"Position": spos, "Velocity": vel(ns), "Mass": f32(ns, mg / 2),
            "ID": np.arange(2 * n + 1, 2 * n + ns + 1, dtype=np.uint64),
            "StellarFormationTime": f32(ns, 0.05),
            "Metallicity": f32(ns, 0.01),
            "TotalMassReturned": f32(ns, 0.0),
            "LastEnrichmentMyr": f32(ns, 0.0)}}
    write_snapshot(str(path), SnapshotHeader(
        TotNumPart=np.array([n, n, 0, 0, ns, 0], np.uint64),
        MassTable=np.zeros(6), Time=SS_A, BoxSize=SS_BOX, Omega0=0.288,
        OmegaLambda=0.712, OmegaBaryon=0.0472, HubbleParam=0.7,
        UsePeculiarVelocity=1, TimeIC=SS_A), blocks)
    return str(path)


def _star_params(path, ic, out, outputs, a, extra="", switches=STAR_SMALL):
    text = _GADGET_GAS.format(ic=ic, out=out, outputs=outputs, a=a)
    for sw in switches:
        text = text.replace(f"{sw} = 0", f"{sw} = 1")
    path.write_text(text + extra)
    return str(path)


def _sfr_lines(path):
    return [ln.split() for ln in path.read_text().splitlines()
            if not ln.startswith("#")]


@pytest.fixture(scope="module")
def star_runs(tmp_path_factory):
    """Both star-small runs, computed once per session, each package in
    its own process on its own copy of the IC."""
    out = both_sides(tmp_path_factory, "star_small", _star_run)
    (tmp, ic, _), _ = out
    return tmp, ic, {name: r[2] for name, r in zip(("jax", "torch"), out)}


def _star_run(tmp, name):
    ic = _star_ic(tmp / "IC")
    od = tmp / f"run_{name}"
    pf = _star_params(tmp / f"{name}.gadget", ic, od, "0.1001,0.1002",
                      0.1002)
    return tmp, ic, ((jg.run_gadget(pf) if name == "jax"
                      else tg.run_gadget(pf, device="cpu")), od)


def test_star_small_cli_parity(star_runs):
    _, _, out = star_runs
    (sj, oj), (st, ot) = out["jax"], out["torch"]
    assert st.gas_physics.sfr_on and st.gas_physics.winds_on \
        and st.gas_physics.metal_return_on
    assert st.atime() == pytest.approx(sj.atime())
    lj, lt = _sfr_lines(oj / "sfr.txt"), _sfr_lines(ot / "sfr.txt")
    assert len(lt) == len(lj) >= 4 and all(len(r) == 8 for r in lt)
    assert sum(int(r[7]) for r in lj) >= 2
    for rj, rt in zip(lj, lt):
        assert rt[0] == rj[0] and rt[6:] == rj[6:]
        for a, b in zip(rj[1:6], rt[1:6]):
            assert abs(float(b) - float(a)) <= 1e-5 * abs(float(a))
    for snap in ("PART_000", "PART_001"):
        _, bj = read_snapshot(str(oj / snap))
        _, bt = read_snapshot(str(ot / snap))
        assert sorted(bt) == sorted(bj) == [0, 1, 4]
        assert sorted(bt[4]) == sorted(bj[4])
        np.testing.assert_array_equal(bt[4]["ID"], bj[4]["ID"])
        assert len(bj[4]["ID"]) > 4
        for k in ("StellarFormationTime", "TotalMassReturned",
                  "LastEnrichmentMyr", "Metallicity", "Mass"):
            a = np.asarray(bj[4][k], np.float64)
            assert (np.abs(bt[4][k] - a) <= 1e-5 * np.abs(a)).all(), k
        for k in ("ID", "Generation"):
            np.testing.assert_array_equal(bt[0][k], bj[0][k])
        for k in ("SmoothingLength", "Density", "EgyWtDensity",
                  "InternalEnergy", "Velocity", "Metallicity",
                  "StarFormationRate", "DelayTime", "Mass"):
            a = np.asarray(bj[0][k], np.float64)
            assert np.abs(np.asarray(bt[0][k]) - a).max() \
                <= 1e-4 * np.abs(a).max(), (snap, k)
        assert (bt[0]["Metallicity"] > 0).any()
        assert (ot / snap.replace("PART", "PIG")).is_dir()


def test_star_small_restart_restores_stars(star_runs, monkeypatch,
                                           tmp_path):
    """RestartFlag 1 from the JAX run's last snapshot in both packages:
    the restored gas and star state bit for bit the same, and both step
    on."""
    _, ic, out = star_runs
    tmp = tmp_path
    _, oj = out["jax"]
    restored = {}
    for name, mod in (("jax", jg), ("torch", tg)):
        real = mod._restore_gas_state

        def spy(sim, *a, _real=real, _name=name, **kw):
            _real(sim, *a, **kw)
            g = sim.gas
            restored[_name] = {
                f: np.array(getattr(g, f)) for f in
                ("entropy", "density", "metallicity", "birth_a",
                 "star_metallicity", "last_enrich_myr", "total_returned",
                 "mass0")}
        monkeypatch.setattr(mod, "_restore_gas_state", spy)
    sims = {}
    for name in ("jax", "torch"):
        od = tmp / f"resume_{name}"
        shutil.copytree(oj, od)
        pf = _star_params(tmp / f"r{name}.gadget", ic, od,
                          "0.1001,0.1002,0.1003", 0.1003)
        sims[name] = (jg.run_gadget(pf, 1, max_steps=2) if name == "jax"
                      else tg.run_gadget(pf, 1, max_steps=2, device="cpu"))
    _, b4 = read_snapshot(str(oj / "PART_001"))
    for k, v in restored["jax"].items():
        np.testing.assert_array_equal(restored["torch"][k], v, err_msg=k)
    ts_ = sims["torch"]
    assert ts_.atime() == pytest.approx(sims["jax"].atime())
    assert ts_.atime() > 0.1002
    stars = np.nonzero(ts_.particles.ptype.numpy() == 4)[0]
    assert len(stars) >= len(b4[4]["ID"])
    birth = restored["torch"]["birth_a"]
    assert (birth > 0).sum() == len(b4[4]["ID"])
    np.testing.assert_array_equal(np.sort(birth[birth > 0]),
                                  np.sort(b4[4]["StellarFormationTime"]))
