"""Helium and excursion-set reionization through the port's gadget_main
against the JAX package's on the CPU.

  * star-small's IC of tests/test_torch_gas_cli.py at 2 x 16^3 (a clump of
    128 gas rows with two old stars in it, a = 0.1, box 5 Mpc/h) with
    CoolingOn, StarformationOn, MetalReturnOn and subgrid winds at a
    fixed efficiency (WindModel sh03: its kicks are threefry draws, and
    the DM velocity dispersion that ofjt10 needs takes minutes a PM step
    on a CPU at 16^3), STARS_REHEARSAL's lowered SF thresholds, and
    HeliumReionizationOn with a ReionHistFile, ExcursionSetReionOn with a
    J21CoeffFile (both written by the repo's tools/ generators, the
    history linear from z = 10 to 6 so that the run at z = 9 lies in the
    helium era) and UVBGdim 16.  Each PM step runs a FOF, the QSO bubbles
    (their RandomState seeded from the threefry stream) and the
    excursion pass.  Against the JAX run to a = 0.1002 with snapshots and
    FOF at 0.1001 and 0.1002: the HeIII flags, the star rows (ptype, IDs,
    birth times) and the wind kicks (the rows with a decoupling delay)
    identical, so the key stream is taken at the same places; the
    entropies within 1e-4 of their max; local_j21 within 1e-4 of its max
    where both packages ionize; zreion_p identical and set only where
    J21 > 0; sfr.txt's times and counts identical; both snapshots' IDs
    identical and their InternalEnergy within 1e-4 of its max; the QSO
    bubbles identical (time, fraction, rows; the centre within 1e-6 of
    the box).  Each check is a case of its own.  A RestartFlag 1 resume
    from the last snapshot: the restored gas state identical in both
    packages, and two steps on the HeIII flags and star rows identical.
  (The LightconeOn and WritePlaneOn runs are test_torch_lightcone.py's.)

The JAX package's helium_step calls jax.random.randint(key, (), 0,
2**31), which JAX 0.9 (x64 off) refuses with an OverflowError before it
draws; the JAX runs here pass that maxval as a uint32, which runs
randint's own algorithm (tests/test_torch_threefry.py::test_randint).
"""

import shutil

import jax
import numpy as np
import pytest
import torch

from chip_smoke import STARS_REHEARSAL, _reion_tables
from shenqi_tpu.cli import gadget_main as jg
from shenqi_tpu_torch.cli import gadget_main as tg
from shenqi_tpu_torch.io.snapshot import read_snapshot

import test_torch_gas_cli as GC
from torch_oracle import both_sides, shared

torch.set_num_threads(2)

OUT = ("0.1001,0.1002", 0.1002)
SWITCHES = ("CoolingOn", "StarformationOn", "WindOn", "MetalReturnOn")
REION = """HeliumReionizationOn = 1
ReionHistFile = {heii}
QSOMinMass = 0.0
QSOMeanBubble = 600.0
QSOVarBubble = 1e4
ExcursionSetReionOn = 1
J21CoeffFile = {j21}
UVBGdim = 16
WindModel = sh03
"""


def _uint32_randint(real):
    def randint(key, shape, minval, maxval, *a, **kw):
        if isinstance(maxval, int) and maxval == 2 ** 31:
            maxval = np.uint32(maxval)
        return real(key, shape, minval, maxval, *a, **kw)
    return randint


def _run(mod, pf, *a, **kw):
    if mod is tg:
        kw["device"] = "cpu"
    return mod.run_gadget(pf, *a, **kw)


@pytest.fixture(scope="module")
def reion(tmp_path_factory):
    """Both CLI runs, computed once per session, each package in its own
    process (torch_oracle.both_sides), from one set of tables and IC."""
    tmp, ic, extra = shared(tmp_path_factory, "reion_inputs", _inputs)
    runs = both_sides(tmp_path_factory, "reion", _reion, ic, extra)
    return tmp, ic, extra, dict(zip(("jax", "torch"), runs))


def _inputs(tmp):
    heii, j21 = _reion_tables(tmp / "HeII", tmp / "J21", z=(10.0, 6.0))
    ic = GC._star_ic(tmp / "IC", ng=16, stars_in_clump=2)
    return tmp, ic, STARS_REHEARSAL + REION.format(heii=heii, j21=j21)


def _reion(tmp, name, ic, extra):
    mod = {"jax": jg, "torch": tg}[name]
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "randint", _uint32_randint(jax.random.randint))
    try:
        od = tmp / f"run_{name}"
        pf = GC._star_params(tmp / f"{name}.gadget", ic, od, *OUT,
                             extra=extra, switches=SWITCHES)
        return _run(mod, pf), od
    finally:
        mp.undo()


def _host(x):
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


def _close(a, b, rel=1e-4):
    a, b = _host(a).astype(np.float64), _host(b).astype(np.float64)
    assert np.isfinite(b).all()
    assert np.abs(a - b).max() <= rel * max(np.abs(a).max(), 1e-300)


def _both(reion):
    (sj, oj), (st, ot) = reion[3]["jax"], reion[3]["torch"]
    return sj, st, oj, ot


def _check_switches(sj, st, oj, ot):
    gt = st.gas_physics
    assert gt.helium is not None and gt.excursion is not None \
        and gt.j21_coeffs is not None
    assert st.atime() == pytest.approx(sj.atime())


def _check_bubbles(sj, st, oj, ot):
    ej, et = sj.gas_physics.helium.events, st.gas_physics.helium.events
    assert len(et) == len(ej) > 0
    for (aj, cj, fj, nj), (at, ct, ft, nt) in zip(ej, et):
        # the FOF centres of f32 trajectories: within 1e-6 of the box
        assert (at, ft, nt) == (aj, fj, nj)
        assert np.abs(np.subtract(ct, cj)).max() <= 1e-6 * GC.SS_BOX


def _check_heiii(sj, st, oj, ot):
    ht = _host(st.gas.heiii)
    assert ht.sum() > 0
    np.testing.assert_array_equal(ht, _host(sj.gas.heiii))


def _check_star_rows(sj, st, oj, ot):
    for f in ("ptype", "id_lo", "id_hi"):
        np.testing.assert_array_equal(_host(getattr(st.particles, f)),
                                      _host(getattr(sj.particles, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(_host(st.gas.birth_a),
                                  _host(sj.gas.birth_a))
    assert (_host(st.particles.ptype) == 4).sum() > 4


def _check_wind_kicks(sj, st, oj, ot):
    # the wind kicks: the rows with a decoupling delay
    kt = _host(st.gas.delay_time) > 0
    np.testing.assert_array_equal(kt, _host(sj.gas.delay_time) > 0)
    assert kt.any()


def _check_entropy(sj, st, oj, ot):
    _close(sj.gas.entropy, st.gas.entropy)


def _check_j21(sj, st, oj, ot):
    jj, jt = _host(sj.gas.local_j21), _host(st.gas.local_j21)
    assert (jt > 0).any()
    assert all(0 <= x <= 1 for x in st.excursion_xhi)
    both = (jj > 0) & (jt > 0)
    assert both.sum() >= 0.99 * max((jj > 0).sum(), (jt > 0).sum())
    _close(jj[both], jt[both])


def _check_zreion(sj, st, oj, ot):
    zt = _host(st.gas.zreion_p)
    np.testing.assert_array_equal(zt, _host(sj.gas.zreion_p))
    assert ((zt < 0) | (_host(st.gas.local_j21) > 0)).all()


def _check_sfr_txt(sj, st, oj, ot):
    lj = GC._sfr_lines(oj / "sfr.txt")
    lt = GC._sfr_lines(ot / "sfr.txt")
    assert len(lt) == len(lj) > 0
    assert [r[0] for r in lt] == [r[0] for r in lj]
    assert [r[6:] for r in lt] == [r[6:] for r in lj]


def _check_snapshots(sj, st, oj, ot):
    for snap in ("PART_000", "PART_001"):
        _, bj = read_snapshot(str(oj / snap))
        _, bt = read_snapshot(str(ot / snap))
        assert sorted(bt) == sorted(bj)
        for t in bj:
            np.testing.assert_array_equal(bt[t]["ID"], bj[t]["ID"])
        a = np.asarray(bj[0]["InternalEnergy"], np.float64)
        assert np.abs(bt[0]["InternalEnergy"] - a).max() \
            <= 1e-4 * np.abs(a).max()


@pytest.mark.parametrize("check", [
    _check_switches, _check_bubbles, _check_heiii, _check_star_rows,
    _check_wind_kicks, _check_entropy, _check_j21, _check_zreion,
    _check_sfr_txt, _check_snapshots],
    ids=lambda f: f.__name__[7:])
def test_reion_cli_parity(reion, check):
    check(*_both(reion))


@pytest.fixture(scope="module")
def resumed(tmp_path_factory, reion):
    """Both resumes from the JAX run's output, computed once per session,
    each package in its own process."""
    _, ic, extra, out = reion
    res = both_sides(tmp_path_factory, "reion_resume", _resumed, ic, extra,
                     out["jax"][1])
    return ({name: r[0] for name, r in zip(("jax", "torch"), res)},
            {name: r[1] for name, r in zip(("jax", "torch"), res)})


def _resumed(out_dir, name, ic, extra, oj):
    """(the state _restore_gas_state restored, the Simulation three steps
    on) of one package's RestartFlag 1 resume."""
    mod = {"jax": jg, "torch": tg}[name]
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "randint", _uint32_randint(jax.random.randint))
    restored = {}
    real = mod._restore_gas_state

    def spy(sim, *a, **kw):
        real(sim, *a, **kw)
        restored.update({f: _host(getattr(sim.gas, f)) for f in (
            "entropy", "density", "birth_a", "heiii")})
    mp.setattr(mod, "_restore_gas_state", spy)
    try:
        od = out_dir / f"resume_{name}"
        shutil.copytree(oj, od)
        pf = GC._star_params(out_dir / f"r{name}.gadget", ic, od,
                             OUT[0] + ",0.1003", 0.1003, extra=extra,
                             switches=SWITCHES)
        return restored, _run(mod, pf, 1, max_steps=3)
    finally:
        mp.undo()


@pytest.mark.parametrize("field", ["entropy", "density", "birth_a",
                                   "heiii"])
def test_reion_cli_resume_restores(resumed, field):
    """The state a RestartFlag 1 resume restores, identical in both
    packages (HeIII flags are not in a snapshot: all False)."""
    restored, _ = resumed
    np.testing.assert_array_equal(restored["torch"][field],
                                  restored["jax"][field])


def test_reion_cli_resume(resumed):
    """Two steps on from the resume: the HeIII flags and star rows
    identical."""
    _, sims = resumed
    sj, st = sims["jax"], sims["torch"]
    assert st.atime() == pytest.approx(sj.atime()) and st.atime() > OUT[1]
    np.testing.assert_array_equal(_host(st.gas.heiii), _host(sj.gas.heiii))
    np.testing.assert_array_equal(_host(st.particles.ptype),
                                  _host(sj.particles.ptype))
