"""The port's rare-source slab passes (shenqi_tpu_torch/parallel/
subgrid_slab.py) on 2 and 4 gloo ranks against the JAX package's
subgrid_slab functions on make_mesh(1), from the same rows made from a
numpy seed (tests/test_subgrid_slab.py's states: half uniform, half in a
clump, box 1000), each rank holding the rows of its slab:

  * gather_rows: the masked rows of every rank, exactly the JAX pack's
    valid rows;
  * spawn_stars_slab: children, parents, ids and generations exactly,
    the masses within rtol 1e-6 (test_subgrid_slab.py:101-104);
  * winds_slab (ofjt10, id-keyed, five stars in an 8-lane pack): the
    kicked rows exactly, velocity, entropy and delay within rtol 1e-5
    (test_subgrid_slab.py:207-212);
  * source_env_slab: density, entropy, velocity and feedback weight
    within rtol 2e-5 (test_subgrid_slab.py:243-254);
  * metal_return_slab: within rtol 1e-4 and 1e-5 of the largest
    (test_subgrid_slab.py:277-283);
  * bh_feedback_slab: the entropy increments within rtol 1e-5 and 1e-5
    of the largest (the single-device limit of test_torch_blackhole.py:
    the kernel's f32 rounding differs between the packages near its
    edge);
  * bh_swallow_slab: swallowed_by exactly, the mass gains within rtol
    1e-6;
  * veldisp_slab: sigma and radius within rtol 5e-4, rho 1e-3, each with
    1e-4 of the largest (test_subgrid_slab.py:325-332).

The rank bodies import nothing of JAX and hand their rows back through
.npz files; the JAX results are computed once per worker, and one test a
world size checks every pass.
"""

import numpy as np
import pytest

from test_torch_slab_domain import SpawnCache, spawn_ranks
from torch_oracle import JAX_RETRIES, shared

BOX = 1000.0
PASSES = ("gather", "spawn", "winds", "env", "metal", "bh_feedback",
          "bh_swallow", "veldisp")
ATIME, A3INV = 0.5, 8.0


def _state(n, seed):
    rng = np.random.RandomState(seed)
    pos = np.concatenate([
        rng.uniform(0, BOX, (n // 2, 3)),
        rng.normal([300, 300, 300], 30, (n - n // 2, 3)) % BOX])
    vel = rng.normal(scale=30.0, size=(n, 3)).astype(np.float32)
    return pos, vel


def _ipos(pos):
    return (np.asarray(pos) / BOX * 2.0 ** 32).astype(np.int64).astype(
        np.uint32)


def _inputs():
    """Every pass's rows and sources as numpy (uint32 positions)."""
    out = {}
    pos, vel = _state(2000, 5)
    n = len(pos)
    ip = _ipos(pos)
    pid = np.arange(1, n + 1, dtype=np.uint32)
    sidx = np.array([n // 2 + 1, n // 2 + 7, n // 2 + 19, n // 2 + 23, 11])
    S = 8
    stars = {"ipos": np.zeros((S, 3), np.uint32),
             "hsml": np.zeros(S, np.float32), "mass": np.zeros(S, np.float32),
             "vdisp": np.zeros(S, np.float32), "pid": np.zeros(S, np.uint32)}
    stars["ipos"][:5] = ip[sidx]
    stars["hsml"][:5] = 60.0
    stars["mass"][:5] = 0.01
    stars["vdisp"][:5] = 120.0
    stars["pid"][:5] = pid[sidx]
    elig = np.ones(n, bool)
    elig[sidx] = False
    out["rows"] = {"ipos": ip, "vel": vel, "mass": np.full(n, 0.01, np.float32),
                   "entropy": np.full(n, 50.0, np.float32),
                   "density": np.full(n, 1e-8, np.float32),
                   "delay": np.zeros(n, np.float32), "pid": pid,
                   "eligible": elig}
    out["stars"] = stars
    # sources of the environment, metal return and BH passes: three rows
    # of the clump and one of the field, an 8-lane pack
    src = np.array([n // 2 + 3, n // 2 + 9, n // 2 + 40, 100])
    s = {"ipos": np.zeros((S, 3), np.uint32), "hsml": np.zeros(S, np.float32)}
    s["ipos"][:4] = ip[src]
    s["hsml"][:4] = [70.0, 40.0, 25.0, 90.0]
    mret = np.zeros(S, np.float32)
    mret[:4] = [0.003, 0.001, 0.002, 0.0015]
    s.update(mret=mret, zret=(0.4 * mret).astype(np.float32),
             energy=np.where(s["hsml"] > 0, 3e4, 0.0).astype(np.float32),
             deficit=np.where(s["hsml"] > 0, 0.05, 0.0).astype(np.float32))
    out["src"] = s
    # spawn: a gas state with star bookkeeping
    rng = np.random.RandomState(9)
    out["spawn"] = {"mass": np.full(n, 0.02, np.float32),
                    "gen": rng.randint(0, 3, n).astype(np.int32),
                    "met": rng.uniform(0, 0.02, n).astype(np.float32),
                    "mask": pid % 11 == 0,
                    "mstar": np.full(n, 0.005, np.float32)}
    # veldisp: two thirds DM sources, a third gas targets
    pos3, vel3 = _state(3000, 11)
    n3 = len(pos3)
    ndm = 2 * n3 // 3
    sep = BOX / ndm ** (1 / 3)
    out["veldisp"] = {"ipos": _ipos(pos3), "vel": vel3,
                      "mass": np.where(np.arange(n3) < ndm, 0.05,
                                       0.0).astype(np.float32),
                      "radius0": np.where(np.arange(n3) >= ndm, 2 * sep,
                                          0.0).astype(np.float32),
                      "pid": np.arange(1, n3 + 1, dtype=np.uint32)}
    return out


_REF = {}


def _jax_ref():
    """Every pass of the JAX package on one device (cached per process)."""
    if _REF:
        return _REF
    import jax
    import jax.numpy as jnp
    from shenqi_tpu.parallel.sharded import make_mesh
    from shenqi_tpu.parallel import subgrid_slab as js
    from shenqi_tpu.physics.winds import WindParams, WIND_MODEL_OFJT10
    mesh = make_mesh(1)
    inp = _inputs()
    r, st, s = inp["rows"], inp["stars"], inp["src"]
    J = {k: jnp.asarray(v) for k, v in r.items()}
    n = len(r["pid"])
    g, valid, _ = js.gather_rows(
        mesh, {"pid": J["pid"], "mass": J["mass"], "ipos": J["ipos"]},
        J["pid"] % 7 == 0, cap=512)
    v = np.asarray(valid)
    _REF["gather"] = {k: np.asarray(x)[v] for k, x in g.items()}
    # spawn into the dead rows of a padded state
    sp = inp["spawn"]
    nreq = int(sp["mask"].sum())
    pad = lambda a: np.concatenate([a, np.zeros((nreq,) + a.shape[1:],
                                                a.dtype)])
    idh = np.zeros(n, np.uint32)
    f = {"ipos": pad(r["ipos"]), "vel": pad(r["vel"]), "mass": pad(sp["mass"]),
         "id_lo": pad(r["pid"]), "id_hi": pad(idh), "gen": pad(sp["gen"]),
         "ptyp": pad(np.zeros(n, np.int32)), "birtha": pad(np.zeros(n, np.float32)),
         "tbin": pad(np.full(n, 3, np.int32)), "hsml": pad(np.full(n, 5.0, np.float32)),
         "met": pad(sp["met"]), "sfr": pad(np.ones(n, np.float32)),
         "entropy": pad(r["entropy"]), "m0": pad(np.zeros(n, np.float32)),
         "smet": pad(np.zeros(n, np.float32)), "enr": pad(np.zeros(n, np.float32))}
    f2, n_sp, ovf = js.spawn_stars_slab(
        mesh, {k: jnp.asarray(x) for k, x in f.items()},
        jnp.asarray(pad(sp["mask"])), jnp.asarray(pad(sp["mstar"])),
        atime=0.31, cap=512)
    assert ovf == 0 and n_sp == nreq
    alive = np.asarray(f2["mass"]) > 0
    _REF["spawn"] = {k: np.asarray(x)[alive] for k, x in f2.items()}
    wp = WindParams(WindModel=WIND_MODEL_OFJT10, WindSigma0=353.0,
                    WindSpeedFactor=3.7, WindFreeTravelLength=20.0,
                    MaxWindFreeTravelTime=10.0, WindFreeTravelDensThresh=1e-12)
    vel, ent, delay = js.winds_slab(
        mesh, jax.random.PRNGKey(7),
        {"ipos": J["ipos"], "mass": J["mass"], "vel": J["vel"],
         "entropy": J["entropy"], "density": J["density"],
         "delay": J["delay"], "eligible": J["eligible"], "pid": J["pid"]},
        {k: jnp.asarray(x) for k, x in st.items()}, wp, BOX, ATIME, A3INV)
    _REF["winds"] = {"vel": np.asarray(vel), "entropy": np.asarray(ent),
                     "delay": np.asarray(delay)}
    gas = {"ipos": J["ipos"], "mass": J["mass"], "entropy": J["entropy"],
           "vel": J["vel"]}
    src = {"ipos": jnp.asarray(s["ipos"]), "hsml": jnp.asarray(s["hsml"])}
    env = js.source_env_slab(mesh, gas, src, BOX)
    _REF["env"] = dict(zip(("dens", "sent", "svel", "fw"),
                           map(np.asarray, env)))
    dm, dz = js.metal_return_slab(
        mesh, {"ipos": J["ipos"], "mass": J["mass"]},
        dict(src, mret=jnp.asarray(s["mret"]), zret=jnp.asarray(s["zret"]),
             fw=env[3]), BOX)
    _REF["metal"] = {"dm": np.asarray(dm), "dz": np.asarray(dz)}
    dent = js.bh_feedback_slab(
        mesh, {"ipos": J["ipos"], "mass": J["mass"],
               "density": J["density"]},
        dict(src, energy=jnp.asarray(s["energy"]), fw=env[3]), BOX, A3INV)
    _REF["bh_feedback"] = {"dent": np.asarray(dent)}
    sw, gain = js.bh_swallow_slab(
        mesh, 123456789, {"ipos": J["ipos"], "mass": J["mass"],
                          "pid": J["pid"]},
        dict(src, deficit=jnp.asarray(s["deficit"]),
             rho=jnp.maximum(env[0], 1e-35)), BOX)
    _REF["bh_swallow"] = {"sw": np.asarray(sw), "gain": np.asarray(gain)}
    vd = inp["veldisp"]
    sig, rad, rho, info = js.veldisp_slab(
        mesh, {"ipos": jnp.asarray(vd["ipos"]), "mass": jnp.asarray(vd["mass"]),
               "vel": jnp.asarray(vd["vel"])}, jnp.asarray(vd["radius0"]),
        BOX, ATIME, nlevels=8)
    _REF["veldisp"] = {"sig": np.asarray(sig), "rad": np.asarray(rad),
                       "rho": np.asarray(rho)}
    return _REF


def _body(rank, dev, out, ndev):
    import torch
    from shenqi_tpu_torch.parallel import subgrid_slab as ts
    from shenqi_tpu_torch.parallel.domain import distribute_slabs
    from shenqi_tpu_torch.physics.winds import WindParams, WIND_MODEL_OFJT10
    from shenqi_tpu_torch.utils import threefry
    torch.set_num_threads(1)
    inp = _inputs()
    r, st, s = inp["rows"], inp["stars"], inp["src"]
    i32 = lambda a: np.ascontiguousarray(a).view(np.int32)
    loc = distribute_slabs({**{k: v for k, v in r.items()},
                            "ipos": i32(r["ipos"]), "pid": i32(r["pid"]),
                            **{"sp_" + k: v for k, v in inp["spawn"].items()}},
                           ndev, rank)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in loc.items()}
    res = {"pid": loc["pid"]}
    g, counts = ts.gather_rows({"pid": t["pid"], "mass": t["mass"],
                                "ipos": t["ipos"]}, t["pid"] % 7 == 0)
    res.update({"g_" + k: v.numpy() for k, v in g.items()})
    # spawn over port row columns
    m = len(loc["pid"])
    rows = {"ipos": t["ipos"], "vel": t["vel"], "mass": t["sp_mass"],
            "mask": torch.ones(m, dtype=torch.bool),
            "ptype": torch.zeros(m, dtype=torch.int8), "id_lo": t["pid"],
            "id_hi": torch.zeros(m, dtype=torch.int32),
            "generation": t["sp_gen"], "metallicity": t["sp_met"],
            "birth_a": torch.zeros(m), "mass0": torch.zeros(m),
            "star_metallicity": torch.zeros(m), "entropy": t["entropy"],
            "sfr": torch.ones(m)}
    rows2, nsp = ts.spawn_stars_slab(rows, t["sp_mask"], t["sp_mstar"], 0.31)
    res["nsp"] = nsp
    res.update({"s_" + k: v.numpy() for k, v in rows2.items()})
    wp = WindParams(WindModel=WIND_MODEL_OFJT10, WindSigma0=353.0,
                    WindSpeedFactor=3.7, WindFreeTravelLength=20.0,
                    MaxWindFreeTravelTime=10.0, WindFreeTravelDensThresh=1e-12)
    stars = {k: torch.from_numpy(i32(v) if v.dtype == np.uint32 else v)
             for k, v in st.items()}
    vel, ent, delay = ts.winds_slab(
        threefry.PRNGKey(7), {k: t[k] for k in (
            "ipos", "mass", "vel", "entropy", "density", "delay",
            "eligible", "pid")}, stars, wp, BOX, ATIME, A3INV)
    res.update(w_vel=vel.numpy(), w_ent=ent.numpy(), w_delay=delay.numpy())
    src = {"ipos": torch.from_numpy(i32(s["ipos"])),
           "hsml": torch.from_numpy(s["hsml"])}
    gas = {k: t[k] for k in ("ipos", "mass", "entropy", "vel")}
    dens, sent, svel, fw = ts.source_env_slab(gas, src, BOX)
    res.update(e_dens=dens.numpy(), e_sent=sent.numpy(), e_svel=svel.numpy(),
               e_fw=fw.numpy())
    f = lambda k: torch.from_numpy(s[k])
    dm, dz = ts.metal_return_slab(
        {"ipos": t["ipos"], "mass": t["mass"]},
        dict(src, mret=f("mret"), zret=f("zret"), fw=fw), BOX)
    res.update(m_dm=dm.numpy(), m_dz=dz.numpy())
    dent = ts.bh_feedback_slab(
        {"ipos": t["ipos"], "mass": t["mass"], "density": t["density"]},
        dict(src, energy=f("energy"), fw=fw), BOX, A3INV)
    res["b_dent"] = dent.numpy()
    sw, gain = ts.bh_swallow_slab(
        123456789, {"ipos": t["ipos"], "mass": t["mass"], "pid": t["pid"]},
        dict(src, deficit=f("deficit"), rho=torch.clamp(dens, min=1e-35)),
        BOX)
    res.update(b_sw=sw.numpy(), b_gain=gain.numpy())
    vd = inp["veldisp"]
    lv = distribute_slabs({"ipos": i32(vd["ipos"]), "vel": vd["vel"],
                           "mass": vd["mass"], "radius0": vd["radius0"],
                           "pid": i32(vd["pid"])}, ndev, rank)
    tv = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in lv.items()
          if k != "pid"}
    sig, rad, rho, info = ts.veldisp_slab(
        {k: tv[k] for k in ("ipos", "mass", "vel")}, tv["radius0"], BOX,
        ATIME, ndev, nlevels=8)
    res.update(v_pid=lv["pid"], v_sig=sig.numpy(), v_rad=rad.numpy(),
               v_rho=rho.numpy(), v_ghosts=info["ghosts"],
               v_iter=info["iterations"])
    np.savez(f"{out}/rank{rank}.npz", **res)


def _run(tmp, ndev):
    return spawn_ranks(_body, ndev, tmp, ndev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return SpawnCache(tmp_path_factory.mktemp("subgrid_slab"), _run)


def _cat(ranks, k):
    return np.concatenate([r[k] for r in ranks])


def _by_pid(ranks, k, pidk="pid"):
    """A per-row result of every rank in the order of pid 1..n."""
    pid = _cat(ranks, pidk).view(np.uint32).astype(np.int64)
    v = _cat(ranks, k)
    out = np.zeros((pid.max(),) + v.shape[1:], v.dtype)
    out[pid - 1] = v
    return out


def _jax_ref_body(out):
    return _jax_ref()


@pytest.mark.parametrize("ndev", [2, 4])
def test_subgrid_passes_match_jax(runs, ndev, tmp_path_factory):
    """Every pass of one world against the JAX package (one test a world
    size: each spawn costs once a worker; the JAX passes once a session,
    in a spawned process: torch_oracle.shared, since their veldisp
    compile has aborted a test worker)."""
    ranks = runs[ndev]
    ref = shared(tmp_path_factory, "subgrid_slab_jax", _jax_ref_body,
                 retries=JAX_RETRIES)
    for name in PASSES:
        _check_pass(ranks, ndev, name, ref[name])


def _check_pass(ranks, ndev, name, ref):
    if name == "gather":
        for r in ranks:
            # every rank holds the same pack, in rank order
            np.testing.assert_array_equal(r["g_pid"], ranks[0]["g_pid"])
        got = ranks[0]
        o = np.argsort(got["g_pid"].view(np.uint32))
        w = np.argsort(ref["pid"])
        np.testing.assert_array_equal(got["g_pid"].view(np.uint32)[o],
                                      ref["pid"][w])
        np.testing.assert_array_equal(got["g_ipos"].view(np.uint32)[o],
                                      ref["ipos"][w])
        np.testing.assert_array_equal(got["g_mass"][o], ref["mass"][w])
    elif name == "spawn":
        assert [int(r["nsp"]) for r in ranks] == [len(ref["mass"])
                                                  - 2000] * ndev
        ids = (_cat(ranks, "s_id_hi").view(np.uint32).astype(np.uint64)
               << np.uint64(32)) | _cat(ranks, "s_id_lo").view(
                   np.uint32).astype(np.uint64)
        wid = (ref["id_hi"].astype(np.uint64) << np.uint64(32)) \
            | ref["id_lo"].astype(np.uint64)
        o, w = np.argsort(ids), np.argsort(wid)
        np.testing.assert_array_equal(ids[o], wid[w])
        np.testing.assert_array_equal(_cat(ranks, "s_ptype")[o],
                                      ref["ptyp"][w])
        np.testing.assert_array_equal(_cat(ranks, "s_generation")[o],
                                      ref["gen"][w])
        for pk, jk in (("mass", "mass"), ("birth_a", "birtha"),
                       ("mass0", "m0"), ("star_metallicity", "smet"),
                       ("metallicity", "met")):
            np.testing.assert_allclose(_cat(ranks, "s_" + pk)[o], ref[jk][w],
                                       rtol=1e-6, err_msg=pk)
        np.testing.assert_array_equal(
            _cat(ranks, "s_ipos").view(np.uint32)[o], ref["ipos"][w])
    elif name == "winds":
        delay = _by_pid(ranks, "w_delay")
        np.testing.assert_array_equal(delay > 0, ref["delay"] > 0)
        assert (ref["delay"] > 0).sum() > 0
        for k, want in (("w_vel", ref["vel"]), ("w_ent", ref["entropy"]),
                        ("w_delay", ref["delay"])):
            np.testing.assert_allclose(_by_pid(ranks, k), want, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    elif name == "env":
        for k in ("dens", "sent", "svel", "fw"):
            for r in ranks:
                np.testing.assert_allclose(r["e_" + k], ref[k], rtol=2e-5,
                                           atol=1e-30, err_msg=k)
    elif name == "metal":
        for k in ("dm", "dz"):
            want = ref[k]
            np.testing.assert_allclose(
                _by_pid(ranks, "m_" + k), want, rtol=1e-4,
                atol=1e-5 * np.abs(want).max(), err_msg=k)
        assert _cat(ranks, "m_dm").sum() == pytest.approx(
            float(_inputs()["src"]["mret"].sum()), rel=1e-4)
    elif name == "bh_feedback":
        assert (ref["dent"] > 0).sum() > 0
        np.testing.assert_allclose(_by_pid(ranks, "b_dent"), ref["dent"],
                                   rtol=1e-5,
                                   atol=1e-5 * np.abs(ref["dent"]).max())
    elif name == "bh_swallow":
        sw = _by_pid(ranks, "b_sw")
        assert (ref["sw"] >= 0).sum() > 0
        np.testing.assert_array_equal(sw, ref["sw"])
        for r in ranks:
            np.testing.assert_allclose(r["b_gain"], ref["gain"], rtol=1e-6)
    else:
        assert min(int(r["v_ghosts"]) for r in ranks) > 0
        assert len({int(r["v_iter"]) for r in ranks}) == 1
        tgt = _inputs()["veldisp"]["radius0"] > 0
        for k, rk, rt in (("sig", "v_sig", 5e-4), ("rad", "v_rad", 5e-4),
                          ("rho", "v_rho", 1e-3)):
            got = _by_pid(ranks, rk, "v_pid")[tgt]
            want = ref[k][tgt]
            np.testing.assert_allclose(got, want, rtol=rt,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=k)
