"""`gadget_main --mesh N --device cpu` with gas (HydroOn, every subgrid
switch off: the slab SPH run) on N gloo ranks against the JAX package's
single-device gadget_main of the same paramfile: chip_smoke's
travis-hydro paramfiles (validation/travis.py:38-98) at Ngrid 8, 2 x 8^3
particles in 128 Mpc/h, z = 99 to a = 0.011 with snapshots and FOF at
0.01 and 0.011.

Limits (tests/test_slab_gas.py:96-123): IDs and types equal; the gas
entropy finite and positive; its median within rtol 5e-3; at least 95%
of the gas rows within rtol 2e-2 in Density, 4e-2 in SmoothingLength and
1e-2 in entropy (from InternalEnergy and Density, as the single-device
file has no Entropy block); the 95th percentile of |dv| under 2e-2 of
the largest |v|.  The run ends at the same a; the P(k) files have the
same bins, P within rtol 1e-4 at the ICs (test_torch_mesh_cli.py's) and
1e-2 later: from the first step's hydro force on, which the single-device
loop takes with u for the entropy (ROADMAP C.4), the gas moves apart at
a few 1e-6 of the box, which the top bins of a 2 x 8^3 box raise to
~4e-3; the PIGs have the same group count.  The --mesh PART holds the
five gas blocks, its Entropy the one its InternalEnergy and Density
give.

A --mesh 2 RestartFlag 1 from the run's last snapshot starts its gas as
the JAX --mesh run does (gadget_main.py:876-907; ROADMAP C.4): from
InitGasTemp at the snapshot's a and the IC fixed point, not from the
snapshot's entropy; after its one step the gas u is u0(a) (InitGasTemp
-1: the CMB temperature at a), where the snapshot's has cooled
adiabatically from the ICs, (a / A0)^2 below u0(A0): 9% below u0(a).
"""

import os

import numpy as np
import pytest

from chip_smoke import (_GENIC_GAS, _GADGET_GAS, _class_tk_table,
                        _dm_small_cosmology, _eh_table)
from shenqi_tpu_torch.cli import gadget_main as tg
from shenqi_tpu_torch.io.snapshot import read_snapshot
from shenqi_tpu_torch.utils.constants import GAMMA_MINUS1
from test_torch_slab_domain import SpawnCache

BOX, A0, A1 = 128.0, 0.01, 0.011


def _entropy(b, a):
    """The gas entropy of a snapshot's type-0 blocks at a."""
    return (GAMMA_MINUS1 * b["InternalEnergy"].astype(np.float64)
            / (b["Density"].astype(np.float64) / a ** 3) ** GAMMA_MINUS1)


def _param(tmp, ic, out, outputs=f"{A0},{A1}", amax=A1):
    p = tmp / f"{os.path.basename(out)}.gadget"
    p.write_text(_GADGET_GAS.format(ic=ic, out=out, outputs=outputs,
                                    a=amax))
    return str(p)


def _resume_hook(event, sim, outdir):
    """Rank hook of the resume (module level: pickled to the ranks): the
    rank's gas state after its step."""
    if event == "end":
        from shenqi_tpu_torch.parallel import collectives as cc
        g, p = sim.gas, sim.particles
        np.savez(os.path.join(outdir, f"gas{cc.rank()}.npz"),
                 entropy=g.entropy.numpy(), egywt=g.egy_wt_density.numpy(),
                 id=p.ids64()[:g.ngas], a=sim.atime(),
                 fp=sim.last_fixed_point.get("iterations", -1))


def _make(tmp, what):
    ic = _CACHE["ic"]
    if what == "jax":
        from shenqi_tpu.cli.gadget_main import run_gadget as j_gadget
        out = tmp / "jax"
        return j_gadget(_param(tmp.parent, ic, out)), out
    if what == "resume":
        src = _RUNS[2][1]
        out = tmp / "resume"
        os.makedirs(out)
        os.symlink(src / "PART_001", out / "PART_001")
        (out / "LastSnapNum.txt").write_text("1")
        pf = _param(tmp.parent, ic, out, f"{A0},{A1},0.0115", 0.0115)
        summ = tg.run_gadget(pf, 1, max_steps=1, mesh_devices=2,
                             device="cpu", rank_hook=_resume_hook,
                             mesh_timeout=60.0, join_timeout=300.0)
        return summ, out
    out = tmp / f"mesh{what}"
    summ = tg.run_gadget(_param(tmp.parent, ic, out), device="cpu",
                         mesh_devices=what, mesh_timeout=60.0,
                         join_timeout=300.0)
    return summ, out


_CACHE = {}
_RUNS = None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    global _RUNS
    from shenqi_tpu_torch.cli.genic_main import run_genic
    tmp = tmp_path_factory.mktemp("mesh_gas")
    pk, tk = tmp / "pk.txt", tmp / "tk.txt"
    _eh_table(pk)
    _class_tk_table(tk, _dm_small_cosmology(), A0)
    gp = tmp / "p.genic"
    gp.write_text(_GENIC_GAS.format(out=tmp / "ics", ng=8, pk=pk, tk=tk,
                                    dtf=1))
    _CACHE["ic"] = run_genic(str(gp), device="cpu")
    _RUNS = SpawnCache(tmp, _make)
    return _RUNS


@pytest.mark.parametrize("ndev", [2, 4])
def test_mesh_gas_matches_jax(runs, ndev):
    sj, oj = runs["jax"]
    summ, out = runs[ndev]
    assert summ["backend"] == "gloo" and summ["world"] == ndev
    assert summ["ti_current"] == sj.times.ti_current
    assert summ["atime"] == pytest.approx(A1)
    assert not os.path.exists(out / ".mesh_store")
    hj, bj = read_snapshot(str(oj / "PART_001"))
    ht, bt = read_snapshot(str(out / "PART_001"))
    assert ht.Time == pytest.approx(hj.Time, rel=1e-12)
    np.testing.assert_array_equal(ht.TotNumPart, hj.TotNumPart)
    assert sorted(bt) == sorted(bj) == [0, 1]
    for t in (0, 1):
        oj_, ot_ = np.argsort(bj[t]["ID"]), np.argsort(bt[t]["ID"])
        np.testing.assert_array_equal(bt[t]["ID"][ot_], bj[t]["ID"][oj_])
        bj[t] = {k: v[oj_] for k, v in bj[t].items()}
        bt[t] = {k: v[ot_] for k, v in bt[t].items()}
    g1, g2 = bj[0], bt[0]
    assert {"SmoothingLength", "Density", "EgyWtDensity", "Entropy",
            "InternalEnergy"} <= set(g2)
    e1, e2 = _entropy(g1, A1), _entropy(g2, A1)
    np.testing.assert_allclose(g2["Entropy"], e2, rtol=1e-5)
    assert np.isfinite(e2).all() and (e2 > 0).all()
    np.testing.assert_allclose(np.median(e2), np.median(e1), rtol=5e-3)
    for name, a, b, rtol in (("Density", g2["Density"], g1["Density"], 2e-2),
                             ("SmoothingLength", g2["SmoothingLength"],
                              g1["SmoothingLength"], 4e-2),
                             ("entropy", e2, e1, 1e-2)):
        ok = np.isclose(a, b, rtol=rtol).mean()
        assert ok > 0.95, (name, ok)
    v1 = np.concatenate([bj[0]["Velocity"], bj[1]["Velocity"]])
    v2 = np.concatenate([bt[0]["Velocity"], bt[1]["Velocity"]])
    dv = np.linalg.norm(v2 - v1, axis=1)
    assert np.percentile(dv, 95) < 2e-2 * np.abs(v1).max() + 1e-5
    pks = sorted(f for f in os.listdir(oj) if f.startswith("powerspectrum"))
    assert pks and pks == sorted(f for f in os.listdir(out)
                                 if f.startswith("powerspectrum"))
    for i, f in enumerate(pks):
        a, b = np.loadtxt(oj / f), np.loadtxt(out / f)
        np.testing.assert_array_equal(b[:, 2], a[:, 2])
        np.testing.assert_allclose(b[:, 0], a[:, 0], rtol=1e-5)
        np.testing.assert_allclose(b[:, 1], a[:, 1],
                                   rtol=1e-2 if i else 1e-4)
    from shenqi_tpu_torch.io.fofio import load_fof
    for snap in ("PIG_000", "PIG_001"):
        assert len(load_fof(str(out / snap))["Mass"]) == \
            len(load_fof(str(oj / snap))["Mass"])


def test_mesh_gas_resume_starts_from_init_gas_temp(runs):
    from shenqi_tpu_torch.utils import constants as C
    summ, out = runs["resume"]
    assert summ["step_count"] == 1 and summ["world"] == 2
    _, b = read_snapshot(str(out / "PART_001"))
    ranks = [dict(np.load(out / f"gas{r}.npz")) for r in range(2)]
    a = float(ranks[0]["a"])
    assert all(int(r["fp"]) > 0 for r in ranks)      # the fixed point ran
    ids = np.concatenate([r["id"] for r in ranks])
    ent = np.concatenate([r["entropy"] for r in ranks]).astype(np.float64)
    egy = np.concatenate([r["egywt"] for r in ranks]).astype(np.float64)
    assert sorted(ids) == sorted(b[0]["ID"])
    u = ent * (egy / a ** 3) ** GAMMA_MINUS1 / GAMMA_MINUS1
    u0 = (C.BOLTZMANN * 2.7255 / a / (4.0 / (1 + 3 * C.HYDROGEN_MASSFRAC))
          / C.PROTONMASS / C.GAMMA_MINUS1 / 1e10)
    assert abs(np.median(u) / u0 - 1) < 1e-3
    # the snapshot's gas had cooled adiabatically from u0(A0): its u is
    # u0(A0) (A0/a)^2 = u0(a) A0/a, 9% below
    u_snap = np.median(b[0]["InternalEnergy"])
    assert abs(u_snap / u0 * a / A0 - 1) < 1e-2
