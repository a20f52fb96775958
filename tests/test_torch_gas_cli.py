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
  * the subgrid switches (ROADMAP A.8) refused, each by name.
"""

import shutil
import types

import numpy as np
import pytest
import torch

from chip_smoke import (_GENIC_GAS, _GADGET_GAS, _eh_table, _class_tk_table,
                        _dm_small_cosmology)
from shenqi_tpu.cli import gadget_main as jg
from shenqi_tpu.cli.genic_main import run_genic as j_genic

from shenqi_tpu_torch.cli import gadget_main as tg
from shenqi_tpu_torch.cli.genic_main import run_genic as t_genic
from shenqi_tpu_torch.convert import gas_state_from_numpy, particles_from_numpy
from shenqi_tpu_torch.io.snapshot import read_snapshot
from shenqi_tpu_torch.simulation_gas import GasPhysics

torch.set_num_threads(2)
BOX = 128.0
SUBGRID = ("CoolingOn", "StarformationOn", "WindOn", "BlackHoleOn",
           "MetalReturnOn", "QSOLightupOn", "HeliumReionizationOn",
           "ExcursionSetReionOn")


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
def runs(tables):
    tmp, pk, tk = tables
    ic = _genic(tmp, pk, tk, 1)["jax"]
    out = {}
    for name in ("jax", "torch"):
        od = tmp / f"run_{name}"
        pf = _gadget(tmp / f"{name}.gadget", ic, od, "0.01,0.0105", 0.0105)
        out[name] = ((jg.run_gadget(pf) if name == "jax"
                      else tg.run_gadget(pf, device="cpu")), od)
    return tmp, ic, out


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


def test_restart_restores_gas_state(runs, monkeypatch):
    """RestartFlag 1 from the JAX run's last snapshot, in both packages
    (each in its own copy of the output): the restored state is the same,
    and one step on the runs agree."""
    tmp, ic, out = runs
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
def test_subgrid_switch_refused(runs, switch):
    """A gas run with any subgrid master switch on is refused, naming the
    switch and ROADMAP A.8 (GasPhysics refuses its own switches too)."""
    tmp, ic, _ = runs
    pf = tmp / f"refuse_{switch}.gadget"
    text = _GADGET_GAS.format(ic=ic, out=tmp / "refused", outputs="0.0105",
                              a=0.0105)
    if f"{switch} = 0" in text:
        text = text.replace(f"{switch} = 0", f"{switch} = 1")
    else:
        text += f"{switch} = 1\n"
    pf.write_text(text)
    with pytest.raises(NotImplementedError, match=f"{switch}.*A\\.8"):
        tg.run_gadget(str(pf), device="cpu")
    with pytest.raises(NotImplementedError, match="A.8"):
        GasPhysics(cooling_on=True)
