"""The port's two CLIs against the JAX package's on the CPU: the miniature
of tests/test_cli.py (Ngrid 8, Nmesh 16, a = 0.1 -> 0.125, hierarchical
gravity at its default SplitGravityTimestepsOn = 1) with the
reference's CLASS spectrum replaced by an analytic Eisenstein-Hu table
written into the test's directory, normalized by chip_smoke's own
integral to sigma8 = 0.8 (WhichSpectrum 2, Sigma8 -1, InputPowerRedshift
0: InputPower.normalize applies only the growth factor); the paramfiles
are chip_smoke's, at Ngrid 8, box 64000 kpc/h, Nmesh 16.

Limits, with what these cases measured beside each (CPU, torch
2.13.0+cpu):
  * IC positions within 1e-6 of the box (measured 3.8e-9), velocities
    within 1e-5 of their rms (5.7e-7), IDs and header files identical;
  * the run (4 steps): the trajectory limits of __graft_entry__.py:194-206
    (positions within 2e-5 of the box, measured 9.3e-10; velocity
    outliers under 5e-3, measured 0, the largest difference 7.6e-7 of
    the median |v|);
  * P(k) files: k and N columns equal, P to rtol 1e-4 (8.3e-6; RestartFlag
    4: 7.5e-6); kinetic energy to rtol 1e-3 (identical);
  * FOF of a clustered snapshot: PIG GroupID, LengthByType and member
    blocks identical, masses to rtol 1e-6;
  * MassiveNuLinRespOn = 1 (three 0.1333 eV species, the IC ratio from
    chip_smoke._class_tk_table): the run at the trajectory limits, the
    neutrino history (delta_tot, Scalefact) to rtol 1e-6, and a
    RestartFlag 1 resume that restores the saved history exactly.
"""

import os

import numpy as np
import pytest

from chip_smoke import _GADGET, _GENIC, _eh_table
from shenqi_tpu.cli.genic_main import run_genic as j_genic
from shenqi_tpu.cli.gadget_main import run_gadget as j_gadget

from shenqi_tpu_torch.cli import gadget_main as tg
from shenqi_tpu_torch.cli.genic_main import run_genic as t_genic
from shenqi_tpu_torch.io.bigfile import BigFile
from shenqi_tpu_torch.io.snapshot import (SnapshotHeader, read_snapshot,
                                          write_snapshot)


def _gadget_param(tmp, ic, out, fof=0, extra=""):
    p = tmp / f"{os.path.basename(out)}.gadget"
    p.write_text(_GADGET.format(ic=ic, out=out, a=0.125, fof=fof, nmesh=16)
                 + extra)
    return str(p)


@pytest.fixture(scope="module")
def ics(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    pk = tmp / "pk_eh.txt"
    _eh_table(pk)
    paths = {}
    for name, run in (("jax", j_genic), ("torch", None)):
        gp = tmp / f"{name}.genic"
        gp.write_text(_GENIC.format(out=tmp / name, ng=8, box=64000, pk=pk))
        paths[name] = (run(str(gp)) if run is not None
                       else t_genic(str(gp), device="cpu"))
    return tmp, paths


def test_genic_parity(ics):
    tmp, paths = ics
    hj, bj = read_snapshot(paths["jax"])
    ht, bt = read_snapshot(paths["torch"])
    for f in sorted(os.listdir(os.path.join(paths["jax"], "Header"))):
        with open(os.path.join(paths["jax"], "Header", f), "rb") as a, \
                open(os.path.join(paths["torch"], "Header", f), "rb") as b:
            assert a.read() == b.read(), f
    np.testing.assert_array_equal(bt[1]["ID"], bj[1]["ID"])
    d = np.abs(bt[1]["Position"] - bj[1]["Position"])
    d = np.minimum(d, 64000.0 - d)
    assert d.max() < 1e-6 * 64000.0, d.max() / 64000.0
    vj = bj[1]["Velocity"]
    rms = np.sqrt(np.mean(vj.astype(np.float64) ** 2))
    assert np.abs(bt[1]["Velocity"] - vj).max() < 1e-5 * rms


@pytest.fixture(scope="module")
def runs(ics):
    """Both gadget_main runs from the JAX IC file, with the default
    random box offset."""
    tmp, paths = ics
    out = {}
    for name in ("jax", "torch"):
        od = str(tmp / f"run_{name}")
        pf = _gadget_param(tmp, paths["jax"], od)
        out[name] = (j_gadget(pf) if name == "jax"
                     else tg.run_gadget(pf, device="cpu"), od, pf)
    return out


def test_gadget_run_parity(runs):
    (sj, oj, _), (st, ot, _) = runs["jax"], runs["torch"]
    assert st.random_offset_frac == pytest.approx(8 / 16)
    assert st._offset_u32 is not None
    np.testing.assert_array_equal(st._offset_u32, sj._offset_u32)
    assert st.atime() == pytest.approx(0.125, rel=1e-3)
    assert st.times.ti_current == sj.times.ti_current
    assert st.step_count == sj.step_count
    alive = np.asarray(sj.particles.mask)
    ip1 = np.asarray(sj.particles.ipos)[alive].astype(np.int64)
    ip2 = st.particles.ipos_u32()[alive].astype(np.int64)
    d = np.abs(ip1 - ip2)
    d = np.minimum(d, 2 ** 32 - d)
    assert d.max() < 2e-5 * 2 ** 32, d.max() / 2 ** 32
    v1 = np.asarray(sj.particles.vel)[alive]
    v2 = st.particles.vel.numpy()[alive]
    vs = float(np.median(np.abs(v1))) + 1e-6
    outlier = np.max(np.abs(v1 - v2), axis=1) > 2e-3 * vs + 1e-4
    assert np.mean(outlier) < 5e-3, int(outlier.sum())
    # the snapshots, P(k) files and per-step logs
    hj, bj = read_snapshot(os.path.join(oj, "PART_000"))
    ht, bt = read_snapshot(os.path.join(ot, "PART_000"))
    assert ht.Time == pytest.approx(hj.Time, rel=1e-12)
    np.testing.assert_array_equal(bt[1]["ID"], bj[1]["ID"])
    dp = np.abs(bt[1]["Position"] - bj[1]["Position"])
    assert np.minimum(dp, 64000.0 - dp).max() < 2e-5 * 64000.0
    pks = sorted(f for f in os.listdir(oj) if f.startswith("powerspectrum"))
    assert pks and pks == sorted(
        f for f in os.listdir(ot) if f.startswith("powerspectrum"))
    for f in pks:
        a = np.loadtxt(os.path.join(oj, f))
        b = np.loadtxt(os.path.join(ot, f))
        np.testing.assert_array_equal(b[:, [0, 2]], a[:, [0, 2]])
        np.testing.assert_allclose(b[:, 1], a[:, 1], rtol=1e-4)
    for f in ("energy.txt", "cpu.txt", "LastSnapNum.txt"):
        assert os.path.getsize(os.path.join(ot, f)) > 0, f
    ej = np.loadtxt(os.path.join(oj, "energy.txt"))
    et = np.loadtxt(os.path.join(ot, "energy.txt"))
    assert et.shape == ej.shape
    np.testing.assert_allclose(et[:, 3], ej[:, 3], rtol=1e-3)


def test_restart_power_matches(runs):
    """RestartFlag 4: the P(k) of the IC snapshot from both packages."""
    (_, oj, pj), (_, ot, pt) = runs["jax"], runs["torch"]
    fj = j_gadget(pj, restart_flag=4)
    ft = tg.run_gadget(pt, restart_flag=4, device="cpu")
    assert os.path.basename(fj) == os.path.basename(ft)
    a, b = np.loadtxt(fj), np.loadtxt(ft)
    np.testing.assert_array_equal(b[:, [0, 2]], a[:, [0, 2]])
    np.testing.assert_allclose(b[:, [1, 3]], a[:, [1, 3]], rtol=1e-4)


def _clustered_snapshot(path, n_side=16, box=64000.0, seed=3):
    rng = np.random.RandomState(seed)
    n = n_side ** 3
    pos = rng.uniform(0, box, (n, 3))
    clump = rng.choice(n, n // 2, replace=False)
    centers = rng.uniform(0, box, (10, 3))
    pos[clump] = (centers[np.arange(len(clump)) % 10]
                  + rng.normal(0, 300.0, (len(clump), 3))) % box
    mass = 0.288 * 2.775e1 * box ** 3 / n
    hdr = SnapshotHeader(
        TotNumPart=np.array([0, n, 0, 0, 0, 0], np.uint64),
        MassTable=np.array([0, mass, 0, 0, 0, 0]), Time=0.125,
        BoxSize=box, Omega0=0.288, OmegaLambda=0.712, OmegaBaryon=0.0472,
        HubbleParam=0.7, UsePeculiarVelocity=1, TimeIC=0.1)
    write_snapshot(path, hdr, {1: {
        "Position": pos, "Velocity": rng.normal(0, 30, (n, 3)),
        "Mass": np.full(n, mass, np.float32),
        "ID": np.arange(1, n + 1, dtype=np.uint64)}})


def test_restart_fof_matches(runs, tmp_path):
    """RestartFlag 3 on a clustered snapshot: identical PIG blocks."""
    pigs = {}
    for name in ("jax", "torch"):
        od = tmp_path / name
        od.mkdir()
        _clustered_snapshot(str(od / "PART_005"))
        pf = _gadget_param(tmp_path, "unused", str(od))
        g = (j_gadget(pf, restart_flag=3, snapnum=5) if name == "jax"
             else tg.run_gadget(pf, restart_flag=3, snapnum=5,
                                device="cpu"))
        assert g.ngroups >= 5
        pigs[name] = BigFile(str(od / "PIG_005"))
    for blk in ("FOFGroups/GroupID", "FOFGroups/LengthByType",
                "1/GroupID", "1/ID"):
        np.testing.assert_array_equal(pigs["torch"][blk].read(),
                                      pigs["jax"][blk].read(), err_msg=blk)
    np.testing.assert_allclose(pigs["torch"]["FOFGroups/Mass"].read(),
                               pigs["jax"]["FOFGroups/Mass"].read(),
                               rtol=1e-6)


def test_resume_and_hci_stop(ics, tmp_path):
    """An HCI `stop` file checkpoints at the first PM step and ends the
    run (tests/test_hci_wired.py:70); RestartFlag 1 resumes from
    LastSnapNum.txt and writes the planned snapshot, with FOF at it."""
    _, paths = ics
    od = tmp_path / "out"
    od.mkdir()
    (od / "stop").touch()
    pf = _gadget_param(tmp_path, paths["torch"], str(od), fof=1)
    sim = tg.run_gadget(pf, device="cpu")
    assert sim.hci_exit == "stop"
    assert not (od / "stop").exists()
    assert sim.atime() < 0.12
    assert (od / "PART_000").is_dir() and (od / "PIG_000").is_dir()
    assert (od / "LastSnapNum.txt").read_text() == "0"
    sim2 = tg.run_gadget(pf, restart_flag=1, device="cpu")
    assert sim2.hci_exit == ""
    assert sim2.atime() == pytest.approx(0.125, rel=1e-3)
    assert sorted(d for d in os.listdir(od) if d.startswith("PART_")) \
        == ["PART_000", "PART_001"]
    assert (od / "PIG_001").is_dir()
    h, _ = read_snapshot(str(od / "PART_001"))
    assert h.Time == pytest.approx(0.125, rel=1e-3)


def test_unported_refused(ics, tmp_path):
    """What the port does not run yet is refused, naming its ROADMAP
    item: --mesh (A.9) and RestartFlag 99 (A.10).  The paramfile (gas
    particles with HydroOn, and HeliumReionizationOn, which now runs)
    leaves SplitGravityTimestepsOn at its default.  The erfc short-range
    window, once refused (A.12), runs: three steps of the dark-matter
    miniature with ShortRangeForceWindowType erfc in both packages, the
    port's through the pair kernel's erfc window, positions within 2e-5
    of the box."""
    od = tmp_path / "o"
    od.mkdir()
    n, box = 64, 64000.0
    rng = np.random.RandomState(2)
    hdr = SnapshotHeader(
        TotNumPart=np.array([n, n, 0, 0, 0, 0], np.uint64),
        MassTable=np.zeros(6), Time=0.1, BoxSize=box, Omega0=0.288,
        OmegaLambda=0.712, OmegaBaryon=0.0472, HubbleParam=0.7,
        UsePeculiarVelocity=1, TimeIC=0.1)
    write_snapshot(str(od / "IC_gas"), hdr, {t: {
        "Position": rng.uniform(0, box, (n, 3)),
        "Velocity": np.zeros((n, 3), np.float32),
        "Mass": np.full(n, 1.0, np.float32),
        "ID": np.arange(1 + t * n, 1 + (t + 1) * n, dtype=np.uint64)}
        for t in (0, 1)})
    pf = tmp_path / "gas.gadget"
    pf.write_text(_GADGET.replace("HydroOn = 0", "HydroOn = 1").format(
        ic=od / "IC_gas", out=od, a=0.125, fof=0, nmesh=16)
        + "HeliumReionizationOn = 1\n")
    with pytest.raises(NotImplementedError, match="--mesh.*A.9"):
        tg.run_gadget(str(pf), mesh_devices=8, device="cpu")
    with pytest.raises(NotImplementedError, match="RestartFlag 99.*A.10"):
        tg.run_gadget(str(pf), restart_flag=99, device="cpu")
    from shenqi_tpu_torch.gravity.shortrange import ErfcWindow
    tmp, paths = ics
    sims = {}
    for name in ("jax", "torch"):
        pf = _gadget_param(tmp, paths["jax"], str(tmp / f"erfc_{name}"),
                           extra="ShortRangeForceWindowType = erfc\n")
        sims[name] = (j_gadget(pf, max_steps=3) if name == "jax"
                      else tg.run_gadget(pf, max_steps=3, device="cpu"))
    sj, st = sims["jax"], sims["torch"]
    assert sj.gravity.window_type == st.gravity.window_type == "erfc"
    assert sj.window_tables is None
    assert st.window_tables == ErfcWindow(st.gravity.asmth)
    assert st.step_count == sj.step_count == 3
    assert st.times.ti_current == sj.times.ti_current
    alive = np.asarray(sj.particles.mask)
    d = np.abs(np.asarray(sj.particles.ipos)[alive].astype(np.int64)
               - st.particles.ipos_u32()[alive].astype(np.int64))
    assert np.minimum(d, 2 ** 32 - d).max() < 2e-5 * 2 ** 32


def _nu_params(tmp, ic, out):
    """The CLI paramfile with the neutrino linear response on
    (chip_smoke._GADGET_NU: three 0.1333 eV species, the IC ratio from a
    CLASS-layout transfer table)."""
    from chip_smoke import _GADGET_NU, _class_tk_table, _nu_cosmology
    tk = tmp / "tk.txt"
    if not tk.exists():
        _class_tk_table(tk, _nu_cosmology(), 0.1)
    pf = _gadget_param(tmp, ic, out, extra=_GADGET_NU.format(tk=tk))
    with open(pf) as f:
        s = f.read().replace("MassiveNuLinRespOn = 0",
                             "MassiveNuLinRespOn = 1")
    with open(pf, "w") as f:
        f.write(s)
    return pf


@pytest.fixture(scope="module")
def nu_runs(ics):
    tmp, paths = ics
    out = {}
    for name in ("jax", "torch"):
        od = str(tmp / f"nu_{name}")
        pf = _nu_params(tmp, paths["jax"], od)
        out[name] = (j_gadget(pf) if name == "jax"
                     else tg.run_gadget(pf, device="cpu"), od)
    return out


def test_nu_linear_response_run_parity(nu_runs):
    (sj, oj), (st, ot) = nu_runs["jax"], nu_runs["torch"]
    assert st.nu_table is not None and st.hierarchical
    assert st.atime() == pytest.approx(0.125, rel=1e-3)
    assert st.times.ti_current == sj.times.ti_current
    np.testing.assert_array_equal(st.nu_table.init_ratio,
                                  sj.nu_table.init_ratio)
    assert st.nu_table.delta_tot.shape == sj.nu_table.delta_tot.shape
    assert st.nu_table.delta_tot.shape[1] >= 2
    np.testing.assert_allclose(st.nu_table.scalefact, sj.nu_table.scalefact,
                               rtol=1e-12)
    np.testing.assert_allclose(st.nu_table.delta_tot, sj.nu_table.delta_tot,
                               rtol=1e-6)
    alive = np.asarray(sj.particles.mask)
    ip1 = np.asarray(sj.particles.ipos)[alive].astype(np.int64)
    ip2 = st.particles.ipos_u32()[alive].astype(np.int64)
    d = np.abs(ip1 - ip2)
    d = np.minimum(d, 2 ** 32 - d)
    assert d.max() < 2e-5 * 2 ** 32, d.max() / 2 ** 32
    v1 = np.asarray(sj.particles.vel)[alive]
    v2 = st.particles.vel.numpy()[alive]
    vs = float(np.median(np.abs(v1))) + 1e-6
    outlier = np.max(np.abs(v1 - v2), axis=1) > 2e-3 * vs + 1e-4
    assert np.mean(outlier) < 5e-3, int(outlier.sum())
    # the history rides the snapshot, in the same bytes as the JAX one's
    bj = BigFile(os.path.join(oj, "PART_000"))
    bt = BigFile(os.path.join(ot, "PART_000"))
    for blk in ("Neutrino/Scalefact", "Neutrino/Wavenum"):
        np.testing.assert_array_equal(bt[blk].read(), bj[blk].read())
    np.testing.assert_allclose(bt["Neutrino/Deltas"].read(),
                               bj["Neutrino/Deltas"].read(), rtol=1e-6)


def test_nu_resume_restores_history(ics, tmp_path):
    """An HCI `stop` checkpoints PART_000 with the neutrino history;
    RestartFlag 1 restores it exactly and carries it on."""
    _, paths = ics
    od = tmp_path / "out"
    od.mkdir()
    (od / "stop").touch()
    pf = _nu_params(tmp_path, paths["torch"], str(od))
    sim = tg.run_gadget(pf, device="cpu")
    assert sim.hci_exit == "stop"
    saved = BigFile(str(od / "PART_000"))
    deltas = saved["Neutrino/Deltas"].read()
    scale = saved["Neutrino/Scalefact"].read()
    np.testing.assert_array_equal(deltas, sim.nu_table.delta_tot.ravel())
    sim2 = tg.run_gadget(pf, restart_flag=1, device="cpu")
    nt = sim2.nu_table
    assert sim2.atime() == pytest.approx(0.125, rel=1e-3)
    na = len(scale)
    np.testing.assert_array_equal(nt.scalefact[:na], scale)
    np.testing.assert_array_equal(nt.delta_tot[:, :na],
                                  deltas.reshape(-1, na))
    assert nt.delta_tot.shape[1] > na


def test_energy_statistics_match(runs, tmp_path):
    """energy.txt's line from the end state of both runs: the port's
    device reduction and host sums against the JAX host sums (kinetic and
    potential energy to rtol 1e-5; the states differ by the run's f32
    rounding)."""
    import io
    from shenqi_tpu.utils.stats import energy_statistics as j_energy
    from shenqi_tpu_torch.utils import stats as t_stats
    (sj, _, _), (st, _, _) = runs["jax"], runs["torch"]
    lines = []
    for write, p in ((j_energy, sj.particles),
                     (t_stats.energy_statistics, st.particles),
                     (t_stats.energy_statistics_fast, st.particles)):
        f = io.StringIO()
        write(f, 0.125, p)
        lines.append(np.array(f.getvalue().split(), float))
    for got in lines[1:]:
        np.testing.assert_allclose(got, lines[0], rtol=1e-5, atol=0)
    assert lines[0][2] != 0 and lines[0][3] > 0
