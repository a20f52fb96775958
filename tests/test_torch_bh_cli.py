"""Black holes through the port's gas CLI against the JAX package's on
the CPU (the star-small IC of tests/test_torch_gas_cli.py at 16^3: 16^3
gas + 16^3 DM at a = 0.1 in a 5 Mpc/h box, a clump of 128 gas rows with
two of the four old stars in it; star-small's switches with BlackHoleOn
and the winds off), with chip_smoke.STARS_REHEARSAL's lowered SF
thresholds and BH_SEEDING's lowered seeding thresholds, to a = 0.1002
with snapshots and FOF at 0.1001 and 0.1002, in both packages.  It lies
apart from test_torch_gas_cli.py so that the two long CPU runs go to two
test workers.

Limits: the seeded rows and BH IDs identical; blackholes.txt's lines
(times and counts identical, the masses and rates within 1e-5
relative); BlackholeDetails.bin's records in the JAX layout with the
same IDs and times, masses and rates within 1e-5 relative; the BH
blocks' IDs identical and their masses within 1e-5 relative; a
RestartFlag 1 resume that restores the BH rows (ptype, BlackholeMass,
BlackholeAccretionRate) exactly in both packages.
"""

import shutil

import numpy as np
import pytest
import torch

from chip_smoke import STARS_REHEARSAL
from shenqi_tpu.cli import gadget_main as jg
from shenqi_tpu_torch.cli import gadget_main as tg
from shenqi_tpu_torch.io.snapshot import read_snapshot
from shenqi_tpu_torch.utils.stats import BH_DETAIL_DTYPE

import test_torch_gas_cli as GC
from torch_oracle import both_sides

torch.set_num_threads(2)

BH_OUT = ("0.1001,0.1002", 0.1002)
# lowered BH seeding thresholds for the clump's group (star-small's are
# MinFoFMassForNewSeed 2, MinMStarForNewSeed 5e-4, in 1e10 Msun/h)
BH_SEEDING = "MinFoFMassForNewSeed = 0.5\nMinMStarForNewSeed = 1e-4\n"
# star-small's switches with black holes, the winds off: their DM
# velocity dispersion takes minutes a PM step on a CPU at 16^3 and is
# held at 8^3 in test_torch_gas_cli.py
BH_SWITCHES = ("CoolingOn", "StarformationOn", "MetalReturnOn",
               "BlackHoleOn")


def _bh_lines(path):
    return [ln.split() for ln in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def bh_runs(tmp_path_factory):
    """Both BH runs, computed once per session, each package in its own
    process on its own copy of the IC (torch_oracle.both_sides)."""
    out = both_sides(tmp_path_factory, "bh_small", _bh_run)
    (tmp, ic, _), _ = out
    return (tmp, ic, {name: r[2] for name, r in zip(("jax", "torch"), out)},
            STARS_REHEARSAL + BH_SEEDING)


def _bh_run(tmp, name):
    ic = GC._star_ic(tmp / "IC", ng=16, stars_in_clump=2)
    od = tmp / f"run_{name}"
    pf = GC._star_params(tmp / f"{name}.gadget", ic, od, *BH_OUT,
                         extra=STARS_REHEARSAL + BH_SEEDING,
                         switches=BH_SWITCHES)
    return tmp, ic, ((jg.run_gadget(pf) if name == "jax"
                      else tg.run_gadget(pf, device="cpu")), od)


def test_bh_small_cli_parity(bh_runs):
    _, _, out, _ = bh_runs
    (sj, oj), (st, ot) = out["jax"], out["torch"]
    assert st.gas_physics.bh_on and st.gas_physics.bh_dynfric_on
    assert st.atime() == pytest.approx(sj.atime())
    bh_t = np.nonzero(st.particles.ptype.numpy() == 5)[0]
    bh_j = np.nonzero(np.asarray(sj.particles.ptype) == 5)[0]
    np.testing.assert_array_equal(bh_t, bh_j)
    assert len(bh_t) >= 1
    lj, lt = _bh_lines(oj / "blackholes.txt"), _bh_lines(ot / "blackholes.txt")
    assert len(lt) == len(lj) >= 2 and all(len(r) == 6 for r in lt)
    for rj, rt in zip(lj, lt):
        assert rt[:2] == rj[:2]
        for a, b in zip(rj[2:], rt[2:]):
            assert abs(float(b) - float(a)) <= 1e-5 * abs(float(a))
    dj = np.fromfile(oj / "BlackholeDetails.bin", dtype=BH_DETAIL_DTYPE)
    dt = np.fromfile(ot / "BlackholeDetails.bin", dtype=BH_DETAIL_DTYPE)
    # the subgrid masses grow by accretion from the seed mass (2e-5, the
    # default SeedBlackHoleMass)
    assert (dt["Mass"] > 2e-5).all() and (dt["Mdot"] > 0).all()
    assert (ot / "BlackholeDetails.bin").stat().st_size \
        == len(dt) * BH_DETAIL_DTYPE.itemsize == len(dj) * 52
    np.testing.assert_array_equal(dt["ID"], dj["ID"])
    np.testing.assert_array_equal(dt["Time"], dj["Time"])
    for k in ("Mass", "Mdot"):
        assert np.all(np.abs(dt[k] - dj[k]) <= 1e-5 * np.abs(dj[k])), k
    ids = st.particles.ids64()[bh_t]
    assert set(dt["ID"].tolist()) == set(ids.tolist())
    last = f"PART_{len(BH_OUT[0].split(',')) - 1:03d}"
    _, bj = read_snapshot(str(oj / last))
    _, bt = read_snapshot(str(ot / last))
    assert 5 in bt and sorted(bt[5]) == sorted(bj[5])
    np.testing.assert_array_equal(bt[5]["ID"], bj[5]["ID"])
    for k in ("BlackholeMass", "BlackholeAccretionRate", "Mass"):
        a = np.asarray(bj[5][k], np.float64)
        assert (np.abs(bt[5][k] - a) <= 1e-5 * np.abs(a)).all(), k
    for k in ("ID", "Generation"):
        np.testing.assert_array_equal(bt[0][k], bj[0][k])


def test_bh_small_restart_restores_bhs(bh_runs, monkeypatch, tmp_path):
    """RestartFlag 1 from the JAX run's last snapshot: the BH rows (type
    5, past the gas prefix) restored bit for bit in both packages, and
    both step on with their black holes."""
    _, ic, out, extra = bh_runs
    tmp = tmp_path
    _, oj = out["jax"]
    restored = {}
    for name, mod in (("jax", jg), ("torch", tg)):
        real = mod._restore_gas_state

        def spy(sim, *a, _real=real, _name=name, **kw):
            _real(sim, *a, **kw)
            pt = np.array(sim.particles.ptype)
            rows = np.nonzero(pt == 5)[0]
            restored[_name] = {
                "rows": rows, "ptype": pt,
                "bh_mass": np.array(sim.gas.bh_mass)[rows],
                "bh_mdot": np.array(sim.gas.bh_mdot)[rows]}
        monkeypatch.setattr(mod, "_restore_gas_state", spy)
    sims = {}
    for name, mod in (("jax", jg), ("torch", tg)):
        od = tmp / f"resume_{name}"
        shutil.copytree(oj, od)
        pf = GC._star_params(tmp / f"r{name}.gadget", ic, od,
                             BH_OUT[0] + ",0.1003", 0.1003, extra=extra,
                             switches=BH_SWITCHES)
        sims[name] = (jg.run_gadget(pf, 1, max_steps=2) if name == "jax"
                      else tg.run_gadget(pf, 1, max_steps=2, device="cpu"))
    last = f"PART_{len(BH_OUT[0].split(',')) - 1:03d}"
    _, saved = read_snapshot(str(oj / last))
    for k, v in restored["jax"].items():
        np.testing.assert_array_equal(restored["torch"][k], v, err_msg=k)
    np.testing.assert_array_equal(restored["torch"]["bh_mass"],
                                  saved[5]["BlackholeMass"])
    np.testing.assert_array_equal(restored["torch"]["bh_mdot"],
                                  saved[5]["BlackholeAccretionRate"])
    st = sims["torch"]
    assert st.atime() == pytest.approx(sims["jax"].atime())
    assert st.atime() > 0.1002
    assert int((st.particles.ptype == 5).sum()) == len(saved[5]["ID"])
