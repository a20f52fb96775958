"""`gadget_main --mesh 2 --device cpu` with the subgrid sources on gloo
ranks against the JAX package's `run_gadget(..., mesh_devices=1)` of the
same paramfile: the star-small IC of tests/test_torch_gas_cli.py at 8^3
(8^3 gas + 8^3 DM at a = 0.1 in a 5 Mpc/h box, a clump of 128 gas rows
with two of the four old stars in it), CoolingOn, StarformationOn,
WindOn (ofjt10), MetalReturnOn and BlackHoleOn with chip_smoke's
STARS_REHEARSAL thresholds and the seeding thresholds of
test_torch_bh_cli.py (the clump's group seeds at the first PM step's
FOF), to a = 0.1002 with snapshots and FOF at 0.1001 and 0.1002.

Limits: the run ends at the same a and integer time; each PART holds the
same types with the same IDs (the new stars, their generation in the ID's
top byte, and the seeded BHs among them); at least 99% of each type's
rows within 2e-5 of the box in position and 1e-3 relative in mass; the
95th percentile of |dv| under 2e-2 of the largest |v|
(test_torch_mesh_gas_cli.py's limit: the two packages' slab hydro and
gravity differ, most in the dense clump, where the gas's p95 reaches
1.4e-2 at a = 0.1002).

A --mesh 2 RestartFlag 1 from a snapshot with stars and a black hole
(the IC with one BH row added, its blocks written) keeps the JAX --mesh
rule (gadget_main.py:876-907; ROADMAP C.4): it reads no gas, star or BH
block, so its star rows come back with birth_a 0 and its BH row with
bh_mass 0, and it steps on with them (two steps, the second with a
source stage that forms stars).
"""

import os

import numpy as np
import pytest

import test_torch_gas_cli as GC
from chip_smoke import STARS_REHEARSAL
from shenqi_tpu_torch.cli import gadget_main as tg
from shenqi_tpu_torch.io.snapshot import read_snapshot
from test_torch_slab_domain import SpawnCache
from torch_oracle import JAX_RETRIES, shared

OUT = ("0.1001,0.1002", 0.1002)
SWITCHES = GC.STAR_SMALL + ("BlackHoleOn",)
EXTRA = STARS_REHEARSAL + ("MinFoFMassForNewSeed = 0.5\n"
                           "MinMStarForNewSeed = 1e-4\n")


def _resume_hook(event, sim, outdir):
    """Rank hook of the resume (module level: pickled to the ranks): the
    star and BH columns the resumed rank starts from, after its step."""
    if event == "end":
        from shenqi_tpu_torch.parallel import collectives as cc
        p, g = sim.particles, sim.gas
        np.savez(os.path.join(outdir, f"resume{cc.rank()}.npz"),
                 id=p.ids64(), ptype=p.ptype.numpy(),
                 birth_a=g.birth_a.numpy(),
                 bh_mass=g.bh_mass.numpy(), steps=sim.step_count)


def _resume_snapshot(ic, path):
    """The IC with one black hole more (a type-5 row beside the clump,
    its BlackholeMass block set): the snapshot the resume starts from,
    with gas, star and BH blocks that a --mesh resume does not read."""
    from shenqi_tpu_torch.io.snapshot import write_snapshot
    hdr, b = read_snapshot(ic)
    n = int(np.sum(hdr.TotNumPart))
    b[5] = {"Position": np.array([[1500.0, 2000.0, 2500.0]]),
            "Velocity": np.zeros((1, 3), np.float32),
            "Mass": b[0]["Mass"][:1].copy(),
            "ID": np.array([n + 1], np.uint64),
            "BlackholeMass": np.array([1e-4], np.float32)}
    hdr.TotNumPart = np.array([len(b[t]["ID"]) if t in b else 0
                               for t in range(6)], np.uint64)
    write_snapshot(str(path), hdr, b)


def _jax_run(tmp):
    """The JAX package's run_gadget(mesh_devices=1) on its own copy of
    the IC (computed once per session: torch_oracle.shared)."""
    from shenqi_tpu.cli.gadget_main import run_gadget as j_gadget
    ic = GC._star_ic(tmp / "IC", ng=8, stars_in_clump=2)
    od = tmp / "jax"
    pf = GC._star_params(tmp / "jax.gadget", ic, od, *OUT, extra=EXTRA,
                         switches=SWITCHES)
    return j_gadget(pf, mesh_devices=1), od


def _make(tmp, what):
    ic = _CACHE["ic"]
    if what == "jax":
        return shared(_CACHE["factory"], "mesh_subgrid_jax", _jax_run,
                      retries=JAX_RETRIES)
    if what == "resume":
        od = tmp / "resume"
        os.makedirs(od)
        _resume_snapshot(ic, od / "PART_000")
        (od / "LastSnapNum.txt").write_text("0")
        pf = GC._star_params(tmp.parent / "resume.gadget", ic, od,
                             "0.1001", 0.1001, extra=EXTRA,
                             switches=SWITCHES)
        summ = tg.run_gadget(pf, 1, max_steps=2, mesh_devices=2,
                             device="cpu", rank_hook=_resume_hook,
                             mesh_timeout=60.0, join_timeout=300.0)
        return summ, od
    od = tmp / f"mesh{what}"
    pf = GC._star_params(tmp.parent / f"mesh{what}.gadget", ic, od, *OUT,
                         extra=EXTRA, switches=SWITCHES)
    return tg.run_gadget(pf, device="cpu", mesh_devices=what,
                         mesh_timeout=60.0, join_timeout=300.0), od


_CACHE = {}
_RUNS = None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    global _RUNS
    tmp = tmp_path_factory.mktemp("mesh_subgrid")
    _CACHE["ic"] = GC._star_ic(tmp / "IC", ng=8, stars_in_clump=2)
    _CACHE["factory"] = tmp_path_factory
    _RUNS = SpawnCache(tmp, _make)
    return _RUNS


def _by_id(blocks):
    o = np.argsort(blocks["ID"])
    return {k: v[o] for k, v in blocks.items()}


def test_mesh_subgrid_matches_jax(runs):
    sj, oj = runs["jax"]
    summ, out = runs[2]
    assert summ["backend"] == "gloo" and summ["world"] == 2
    assert summ["ti_current"] == sj.times.ti_current
    assert summ["atime"] == pytest.approx(OUT[1])
    assert sj.star_count > 0
    for snap in ("PART_000", "PART_001"):
        hj, bj = read_snapshot(str(oj / snap))
        ht, bt = read_snapshot(str(out / snap))
        np.testing.assert_array_equal(ht.TotNumPart, hj.TotNumPart)
        assert sorted(bt) == sorted(bj)
        for t in bj:
            j, g = _by_id(bj[t]), _by_id(bt[t])
            np.testing.assert_array_equal(g["ID"], j["ID"])
            d = (g["Position"] - j["Position"] + GC.SS_BOX / 2) % GC.SS_BOX \
                - GC.SS_BOX / 2
            assert (np.abs(d) < 2e-5 * GC.SS_BOX).all(1).mean() >= 0.99
            dv = np.linalg.norm(g["Velocity"] - j["Velocity"], axis=1)
            vmax = np.linalg.norm(j["Velocity"], axis=1).max()
            assert np.percentile(dv, 95) < 2e-2 * vmax
            ok = np.isclose(g["Mass"], j["Mass"], rtol=1e-3)
            assert ok.mean() >= 0.99
    # the last PART holds the new stars (children among them) and BHs
    _, bj = read_snapshot(str(oj / "PART_001"))
    assert len(bj[4]["ID"]) > 4 and (bj[4]["ID"] >> np.uint64(56)).max() > 0
    assert 5 in bj and len(bj[5]["ID"]) >= 1


def test_mesh_subgrid_resume_rule(runs):
    summ, out = runs["resume"]
    assert summ["world"] == 2 and summ["step_count"] >= 1
    ranks = [dict(np.load(out / f"resume{r}.npz")) for r in range(2)]
    _, b = read_snapshot(str(out / "PART_000"))
    for t, col in ((4, "birth_a"), (5, "bh_mass")):
        ids = np.concatenate([r["id"][r["ptype"] == t] for r in ranks])
        vals = np.concatenate([r[col][r["ptype"] == t] for r in ranks])
        # every star and BH of the snapshot is back without its birth time
        # or subgrid mass (nothing read them), the steps left them so, and
        # the rows born since have theirs.  (A child born after the resume
        # may repeat an earlier child's ID: the resume reads no Generation
        # either, in both packages, ROADMAP C.4)
        assert len(b[t]["ID"]) >= 1
        np.testing.assert_array_equal(np.sort(ids[vals == 0]),
                                      np.sort(b[t]["ID"]))
