"""`gadget_main --mesh N --device cpu` (the port's slab run on N gloo
ranks) against the JAX package's single-device gadget_main, on
tests/test_torch_cli.py's miniature: Ngrid 8, box 64000 kpc/h, Nmesh
16, a = 0.1 -> 0.125 at the CLI defaults (hierarchical gravity, the
random offset, cost-balanced slabs, snapshots, P(k) and FOF).

Limits: the step count and the offsets equal; PART_000 positions by ID
within 2e-5 of the box, velocity outliers (past 2e-3 of the median |v|
+ 1e-4) under 5e-3 of the rows (tests/test_slab_sim.py:82-116); the
P(k) files' N columns equal, k within rtol 1e-5 (a unit of %g's sixth
digit), P within rtol 1e-4;
the PIG's group count equal, masses to rtol 5e-3, under 10% of the
lengths differing (tests/test_cli_mesh_fof.py:72-80).  The miniature
forms no FOF group by a = 0.125, so its PIGs are both empty;
tests/test_torch_fof_slab.py holds the slab catalogue to the JAX one on
a clustered state.  Each refusal of what --mesh still lacks names its
ROADMAP item, before any rank starts (gas with HydroOn runs since
A.9.2: tests/test_torch_mesh_gas_cli.py).
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import _GADGET, _GENIC, _eh_table
from shenqi_tpu_torch.cli import gadget_main as tg

BOX = 64000.0


def _param(tmp, ic, out, extra=""):
    p = tmp / f"{os.path.basename(out)}.gadget"
    p.write_text(_GADGET.format(ic=ic, out=out, a=0.125, fof=1, nmesh=16)
                 + extra)
    return str(p)


@pytest.fixture(scope="module")
def ic(tmp_path_factory):
    from shenqi_tpu_torch.cli.genic_main import run_genic
    tmp = tmp_path_factory.mktemp("mesh_cli")
    pk = tmp / "pk_eh.txt"
    _eh_table(pk)
    gp = tmp / "p.genic"
    gp.write_text(_GENIC.format(out=tmp / "ic", ng=8, box=BOX, pk=pk))
    return tmp, run_genic(str(gp), device="cpu")


def test_mesh_runs_match_jax(ic):
    from shenqi_tpu.cli.gadget_main import run_gadget as j_gadget
    from shenqi_tpu_torch.io.fofio import load_fof
    from shenqi_tpu_torch.io.snapshot import read_snapshot
    tmp, icpath = ic
    oj = tmp / "jax"
    sj = j_gadget(_param(tmp, icpath, oj))
    hj, bj = read_snapshot(str(oj / "PART_000"))
    oj_ = np.argsort(bj[1]["ID"])
    pks = sorted(f for f in os.listdir(oj) if f.startswith("powerspectrum"))
    assert len(pks) >= 2
    cj = load_fof(str(oj / "PIG_000"))
    for ndev in (2, 4):
        out = tmp / f"mesh{ndev}"
        summ = tg.run_gadget(_param(tmp, icpath, out), device="cpu",
                             mesh_devices=ndev, mesh_timeout=60.0,
                             join_timeout=300.0)
        assert summ["backend"] == "gloo" and summ["world"] == ndev
        assert summ["hierarchical"]
        assert summ["step_count"] == sj.step_count
        assert summ["ti_current"] == sj.times.ti_current
        np.testing.assert_array_equal(summ["offset_u32"], sj._offset_u32)
        assert not os.path.exists(out / ".mesh_store")

        ht, bt = read_snapshot(str(out / "PART_000"))
        assert ht.Time == pytest.approx(hj.Time, rel=1e-12)
        ot_ = np.argsort(bt[1]["ID"])
        np.testing.assert_array_equal(bt[1]["ID"][ot_], bj[1]["ID"][oj_])
        d = np.abs(bt[1]["Position"][ot_] - bj[1]["Position"][oj_])
        assert np.minimum(d, BOX - d).max() < 2e-5 * BOX
        v1, v2 = bj[1]["Velocity"][oj_], bt[1]["Velocity"][ot_]
        vs = float(np.median(np.abs(v1))) + 1e-6
        outlier = np.max(np.abs(v1 - v2), axis=1) > 2e-3 * vs + 1e-4
        assert np.mean(outlier) < 5e-3, (ndev, int(outlier.sum()))

        assert pks == sorted(f for f in os.listdir(out)
                             if f.startswith("powerspectrum"))
        for f in pks:
            a, b = np.loadtxt(oj / f), np.loadtxt(out / f)
            np.testing.assert_allclose(b[:, 0], a[:, 0], rtol=1e-5)
            np.testing.assert_array_equal(b[:, 2], a[:, 2])
            np.testing.assert_allclose(b[:, 1], a[:, 1], rtol=1e-4)

        ct = load_fof(str(out / "PIG_000"))
        m1, m2 = np.sort(cj["Mass"]), np.sort(ct["Mass"])
        assert len(m1) == len(m2)
        np.testing.assert_allclose(m2, m1, rtol=5e-3)
        l1 = np.sort(np.asarray(cj["LengthByType"]).sum(axis=1))
        l2 = np.sort(np.asarray(ct["LengthByType"]).sum(axis=1))
        assert not len(l1) or np.mean(l1 != l2) < 0.1
        with open(out / "LastSnapNum.txt") as f:
            assert f.read().strip() == "0"
        with open(out / "cpu.txt") as f:
            assert f.read().count("Step ") == sj.step_count


def _erfc_hook(event, sim, outdir):
    """Rank hook (module level: pickled to the ranks): the rank's live
    IDs and positions and its window's type at the end of the run."""
    if event == "end":
        from shenqi_tpu_torch.parallel import collectives as cc
        p = sim.particles
        m = p.mask.numpy()
        np.savez(os.path.join(outdir, f"erfc{cc.rank()}.npz"),
                 id=p.ids64()[m], ipos=p.ipos_u32()[m],
                 window=sim.gravity.window_type)


def test_mesh_refusals(ic, tmp_path, monkeypatch):
    """What --mesh does not have yet is refused with its ROADMAP item, and
    a rank count the run cannot take raises, before any rank starts; the
    erfc window runs."""
    from shenqi_tpu_torch.parallel.slab_sim import SlabSimulation
    tmp, icpath = ic
    # the subgrid switches run on --mesh (A.9.3); reionization, lightcones
    # and planes (A.9.4), the 2-D grid (A.9.5) and the force tests (A.10)
    # are refused, with a subgrid switch too
    cases = [
        ("HeliumReionizationOn = 1\n", 2, 2, "--mesh with Helium.*A.9.4"),
        ("QSOLightupOn = 1\n", 2, 2, "--mesh with QSOLightupOn.*A.9.4"),
        ("ExcursionSetReionOn = 1\n", 2, 2, "ExcursionSetReionOn.*A.9.4"),
        ("LightconeOn = 1\n", 2, 2, "LightconeOn.*A.9.4"),
        ("WritePlaneOn = 1\n", 2, 2, "WritePlaneOn.*A.9.4"),
        ("StarformationOn = 1\nExcursionSetReionOn = 1\n", 2, 2,
         "--mesh with ExcursionSetReionOn.*A.9.4"),
        ("CoolingOn = 1\n", "2x2", 2, "--mesh 2x2.*A.9.5"),
        ("BlackHoleOn = 1\n", 2, 99, "RestartFlag 99.*A.10")]
    for extra, mesh, flag, match in cases:
        pf = _param(tmp_path, icpath, tmp_path / "out", extra)
        with pytest.raises(NotImplementedError, match=match):
            tg.run_gadget(pf, flag, mesh_devices=mesh, device="cpu")
    # the erfc window, once refused (A.12), runs on --mesh: two steps on
    # 2 gloo ranks equal to one rank's (the same steps, offsets and
    # integer time, positions by ID within 2e-5 of the box)
    got = {}
    for ndev in (1, 2):
        out = tmp_path / f"erfc{ndev}"
        out.mkdir()
        summ = tg.run_gadget(
            _param(tmp_path, icpath, out,
                   "ShortRangeForceWindowType = erfc\n"),
            max_steps=2, mesh_devices=ndev, device="cpu",
            rank_hook=_erfc_hook, mesh_timeout=60.0, join_timeout=300.0)
        ranks = [dict(np.load(out / f"erfc{r}.npz")) for r in range(ndev)]
        assert all(r["window"] == "erfc" for r in ranks)
        ids = np.concatenate([r["id"] for r in ranks])
        o = np.argsort(ids)
        got[ndev] = (summ, ids[o],
                     np.concatenate([r["ipos"] for r in ranks])[o])
    (s1, i1, p1), (s2, i2, p2) = got[1], got[2]
    assert s2["world"] == 2 and s1["step_count"] == s2["step_count"] == 2
    assert s1["ti_current"] == s2["ti_current"]
    np.testing.assert_array_equal(s2["offset_u32"], s1["offset_u32"])
    np.testing.assert_array_equal(i2, i1)
    d = np.abs(p2.astype(np.int64) - p1.astype(np.int64))
    assert np.minimum(d, 2 ** 32 - d).max() < 2e-5 * 2 ** 32
    # gas rows with HydroOn and the subgrid switches run (A.9.2-A.9.3);
    # with the QSO lightup as well they are refused
    from shenqi_tpu_torch.io.snapshot import read_snapshot, write_snapshot
    hdr, blocks = read_snapshot(icpath)
    n = len(blocks[1]["ID"])
    hdr.TotNumPart = np.array([n, n, 0, 0, 0, 0], np.uint64)
    gas = dict(blocks[1], ID=blocks[1]["ID"] + n)
    write_snapshot(str(tmp_path / "IC_gas"), hdr, {0: gas, 1: blocks[1]})
    pf = _param(tmp_path, tmp_path / "IC_gas", tmp_path / "out",
                "HydroOn = 1\nCoolingOn = 1\nQSOLightupOn = 1\n")
    with pytest.raises(NotImplementedError,
                       match="--mesh with QSOLightupOn.*A.9.4"):
        tg.run_gadget(pf, mesh_devices=4, device="cpu")
    pf = _param(tmp_path, icpath, tmp_path / "out")
    with pytest.raises(NotImplementedError, match=r"--mesh 3x2.*A\.9\.5"):
        tg.main([pf, "--mesh", "3x2", "--device", "cpu"])
    with pytest.raises(ValueError, match="power of two"):
        tg.run_gadget(pf, mesh_devices=3, device="cpu")
    # on cards: one rank per card, never fewer ranks, gloo or the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 cards.*1 present"):
        tg.run_gadget(pf, mesh_devices=2)
    # a gravity engine other than the stencil on the slab run
    from shenqi_tpu_torch.core.timeline import Timeline
    from shenqi_tpu_torch.cosmology.background import Cosmology
    from shenqi_tpu_torch.utils.units import default_units
    cp = Cosmology(Omega0=0.3, OmegaLambda=0.7, OmegaBaryon=0.05,
                   HubbleParam=0.7)
    cp.init(0.1, default_units())
    with pytest.raises(NotImplementedError, match="stencil.*A.10"):
        SlabSimulation.from_arrays(
            np.zeros((8, 3)), np.zeros((8, 3)), np.ones(8), np.arange(8),
            cp, BOX, 16, Timeline.setup([0.5], 0.1, 0.5), 0.1,
            gravity_kw={"engine": "tree"}, device="cpu")


def test_slab_sim_one_rank_in_process():
    """With no process group the slab loop runs in one process as a
    world of one (every collective the identity) and tracks the port's
    single-device Simulation: the same steps and offsets, positions
    within 2e-5 of the box."""
    from shenqi_tpu_torch.core.timeline import Timeline
    from shenqi_tpu_torch.cosmology.background import Cosmology
    from shenqi_tpu_torch.parallel.slab_sim import SlabSimulation
    from shenqi_tpu_torch.simulation import Simulation
    from shenqi_tpu_torch.utils.units import default_units
    cp = Cosmology(Omega0=0.3, OmegaLambda=0.7, OmegaBaryon=0.05,
                   HubbleParam=0.7)
    cp.init(0.1, default_units())
    rng = np.random.RandomState(5)
    g = (np.arange(8) + 0.5) * BOX / 8
    pos = (np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
           + rng.normal(0, BOX / 40, (512, 3))) % BOX
    vel = rng.normal(0, 5, (512, 3)).astype(np.float32)
    mass = np.full(512, cp.Omega0 * cp.RhoCrit * BOX ** 3 / 512, np.float32)
    ids = np.arange(1, 513, dtype=np.uint64)
    sims = [cls.from_arrays(pos, vel, mass, ids, cp, BOX, 16,
                            Timeline.setup([0.5], 0.1, 0.5), 0.1,
                            device="cpu")
            for cls in (Simulation, SlabSimulation)]
    for s in sims:
        s.hierarchical, s.random_offset_frac = True, 0.5
        s.run(max_steps=3)
    one, slab = sims
    assert slab.step_count == one.step_count == 3
    assert slab.times.ti_current == one.times.ti_current
    np.testing.assert_array_equal(slab._offset_u32, one._offset_u32)
    got = slab.gather_alive()
    o1, o2 = np.argsort(one.particles.ids64()[:512]), np.argsort(got["id"])
    d = np.abs(one.particles.ipos_u32()[:512][o1].astype(np.int64)
               - got["ipos"][o2].astype(np.int64))
    assert np.minimum(d, 2 ** 32 - d).max() < 2e-5 * 2 ** 32
