"""The port's slab SPH (shenqi_tpu_torch/parallel/sph_slab.py) on gloo
ranks against the JAX package's single-device functions on the same
rows, at tests/test_sph_slab.py's limits:

  * density_slab, the adaptive-hsml loop with its ghosts, against
    shenqi_tpu.sph.density.density (its octree engine): hsml, Density
    and EgyWtDensity within rtol 3e-5 (test_sph_slab.py:81-88), the
    iteration count equal;
  * hydro_slab on the JAX density's state against hydro_walk_blocked:
    accelerations within rtol 1e-4 and 3e-5 of the largest, the signal
    velocity within rtol 1e-5 (test_sph_slab.py:180-183), dt_entropy
    within rtol 2e-4 and 1e-5 of the largest (test_sph_slab.py:283-286);
  * entropy_fixed_point at the JAX density's hsml against the JAX
    GasPhysics.setup_density_indep_entropy: the iterations equal, the
    entropy and EgyWtDensity within rtol 3e-5.

Cases, 2,000 rows in a box of 1000: a smooth state (half uniform, half
in two clumps, the first hsml twice the mean separation) on 2 ranks with
cost-balanced cuts (the all_to_all halo), and a clustered one (nine
tenths in four tight clumps, the first hsml one mean separation) on 4
uniform slabs (the ring), whose voids force cover patches and a wider
strip during the hsml loop.  The slab passes run at grid level 3 (K).
The ranks run from a module cache computed on first use; rank bodies
import nothing of JAX and hand their arrays back through .npz files.
"""

import numpy as np
import pytest

from test_torch_slab_domain import SpawnCache, spawn_ranks

BOX, N, A = 1000.0, 2000, 0.05
# the grid level of the slab passes: at the default level 2 of 2,000 rows
# the 7^3 window of a far-reaching block holds cells twice (ROADMAP C.4,
# in both packages' stencils), which the octree walks do not
K = 3
KEYS = [(2, True, "smooth"), (4, False, "clustered")]


def _state(case):
    """(pos, vel, mass, entvar, hsml0, u0) of a case, from a seed."""
    rng = np.random.RandomState(9 if case == "smooth" else 5)
    if case == "smooth":
        pos = np.concatenate([
            rng.uniform(0, BOX, (N // 2, 3)),
            rng.normal([125, 300, 300], 20, (N // 4, 3)),
            rng.normal([600, 600, 600], 25, (N - N // 2 - N // 4, 3))])
    else:
        cen = rng.uniform(0, BOX, (4, 3))
        nc = 9 * N // 10
        pos = np.concatenate([cen[rng.randint(0, 4, nc)]
                              + rng.normal(0, BOX / 60, (nc, 3)),
                              rng.uniform(0, BOX, (N - nc, 3))])
    pos %= BOX
    vel = rng.normal(0, 30.0, (N, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, N).astype(np.float32)
    entvar = rng.uniform(0.8, 1.2, N).astype(np.float32)
    sep = BOX / N ** (1 / 3)
    hsml0 = np.full(N, (2.0 if case == "smooth" else 1.0) * sep, np.float32)
    return pos, vel, mass, entvar, hsml0, np.float32(350.0)


_REF = {}


def _jax_ref(case):
    """The JAX single-device density, hydro and fixed point of a case, with
    the hydro inputs the ranks take (cached per worker)."""
    if case in _REF:
        return _REF[case]
    import dataclasses
    import types
    import jax.numpy as jnp
    from shenqi_tpu.core.particles import float_to_ipos
    from shenqi_tpu.ops.tree import build_octree
    from shenqi_tpu.simulation_gas import GasPhysics, GasState
    from shenqi_tpu.sph.density import density, make_gas_payload
    from shenqi_tpu.sph.hydro import (HydroParams, balsara_f1,
                                      hydro_time_factors, hydro_walk_blocked,
                                      pressure_predict)
    from shenqi_tpu.utils.constants import GAMMA
    pos, vel, mass, entvar, hsml0, u0 = _state(case)
    ip = jnp.asarray(float_to_ipos(pos, BOX))
    ms, vl, ev = jnp.asarray(mass), jnp.asarray(vel), jnp.asarray(entvar)
    alive = jnp.ones(N, bool)
    tree = build_octree(ip, ms, alive, BOX, nlevels=8, ncrit=32)
    d = density(tree, make_gas_payload(tree, vl, ev), ip, vl, ev, hsml0,
                BOX)
    hsml, dens = jnp.asarray(d.hsml), jnp.asarray(d.density)
    egyr = jnp.asarray(d.egy_wt_density)
    press = pressure_predict(jnp.maximum(egyr, 1e-35), ev)
    atime, hubble = 0.5, 0.15
    par = HydroParams(boxsize=BOX)
    tf = hydro_time_factors(atime, hubble)
    cs = jnp.sqrt(GAMMA * press / jnp.maximum(egyr, 1e-35))
    f1 = balsara_f1(jnp.asarray(d.div_vel), jnp.asarray(d.curl_vel), cs,
                    hsml, tf["fac_mu"])
    dloga = jnp.asarray(np.random.RandomState(2).choice(
        [0.0, 0.01, 0.02], N).astype(np.float32))
    cols = {"hsml": hsml, "density": dens, "eomdensity": egyr,
            "pressure": press, "divvel": jnp.asarray(d.div_vel),
            "curlvel": jnp.asarray(d.curl_vel),
            "dhsml_egy": jnp.asarray(d.dhsml_egy_density_factor),
            "dloga": dloga, "f1": f1}
    tree2 = build_octree(ip, ms, alive, BOX, nlevels=8, ncrit=32, hsml=hsml)
    o = tree2.order
    payload = {"ipos": tree2.ipos_s, "mass": tree2.mass_s, "vel": vl[o],
               "entvar": ev[o], "decoupled": jnp.zeros(N, bool)[o],
               **{k: v[o] for k, v in cols.items() if k != "f1"}}
    targets = {"ipos": ip, "vel": vl, "hsml": hsml, "mass": ms,
               "density": dens, "egyrho": egyr, "entvar": ev,
               "pressure": press, "f1": f1,
               "dhsml": cols["dhsml_egy"], "dloga": dloga}
    maxl = 512
    while True:
        h, info = hydro_walk_blocked(tree2, payload, targets, par, maxl=maxl,
                                     tf=tf)
        if not bool(info["list_overflow"]):
            break
        maxl *= 2
    # the IC fixed point at the density's hsml (a = A, u0 uniform)
    parts = types.SimpleNamespace(ipos=ip, mass=ms, hsml=hsml, mask=alive,
                                  ptype=jnp.zeros(N, jnp.int32))
    sim = types.SimpleNamespace(
        particles=parts, boxsize=BOX, atime=lambda: A,
        gravity=types.SimpleNamespace(tree_nlevels=8, tree_ncrit=32))
    gas = dataclasses.replace(GasState.create(N, jnp.full(N, u0)),
                              density=dens)
    fp = GasPhysics().setup_density_indep_entropy(sim, gas, float(u0))
    _REF[case] = {
        "density": d, "hydro": h, "tf": {k: float(v) for k, v in tf.items()},
        "cols": {k: np.asarray(v) for k, v in cols.items()},
        "entropy": np.asarray(fp.entropy),
        "egywt": np.asarray(fp.egy_wt_density)}
    return _REF[case]


def _sph_body(rank, dev, out, ndev, balanced, case):
    import torch
    from shenqi_tpu_torch.core.particles import float_to_ipos
    from shenqi_tpu_torch.parallel.domain import distribute_slabs
    from shenqi_tpu_torch.parallel.sph_slab import (density_slab,
                                                    entropy_fixed_point,
                                                    hydro_slab)
    from shenqi_tpu_torch.sph.hydro import HydroParams
    from test_torch_slab_domain import _cuts
    pos, vel, mass, entvar, hsml0, u0 = _state(case)
    cols = dict(np.load(f"{out}/cols.npz"))
    tf = {k: float(v) for k, v in np.load(f"{out}/tf.npz").items()}
    ipos = float_to_ipos(pos, BOX, device="cpu").numpy()
    cuts = _cuts(ipos.view(np.uint32), ndev) if balanced else None
    loc = distribute_slabs({"ipos": ipos, "vel": vel, "mass": mass,
                            "entvar": entvar, "hsml0": hsml0,
                            "pid": np.arange(N), **cols}, ndev, rank, cuts)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in loc.items()}
    d, dinfo = density_slab(
        {k: t[k] for k in ("ipos", "mass", "vel", "entvar")}, t["hsml0"],
        BOX, ndev, cuts, k=K)
    n = t["mass"].shape[0]
    src = {"ipos": t["ipos"], "mass": t["mass"], "vel": t["vel"],
           "entvar": t["entvar"],
           "decoupled": torch.zeros(n, dtype=torch.bool),
           **{k: t[k] for k in ("hsml", "density", "eomdensity", "pressure",
                                "divvel", "curlvel", "dhsml_egy", "dloga")}}
    targets = {"ipos": t["ipos"], "vel": t["vel"], "hsml": t["hsml"],
               "mass": t["mass"], "density": t["density"],
               "egyrho": t["eomdensity"], "entvar": t["entvar"],
               "pressure": t["pressure"], "f1": t["f1"],
               "dhsml": t["dhsml_egy"], "dloga": t["dloga"]}
    h, hinfo = hydro_slab(src, targets, HydroParams(boxsize=BOX), tf, BOX,
                          ndev, cuts, k=K)
    ent, egy, fp = entropy_fixed_point(
        {"ipos": t["ipos"], "mass": t["mass"]}, torch.full((n,), float(u0)),
        t["density"], t["hsml"], A ** 3, BOX, ndev, cuts, k=K)
    np.savez(f"{out}/rank{rank}.npz", pid=loc["pid"], hsml=d.hsml.numpy(),
             rho=d.density.numpy(), egy=d.egy_wt_density.numpy(),
             niter=dinfo["niter"], strips=dinfo["exchanges"],
             dcover=dinfo["cover"], ghosts=dinfo["ghosts"],
             acc=h.accel.numpy(), dts=h.dt_entropy.numpy(),
             mvs=h.max_signal_vel.numpy(), hghosts=hinfo["ghosts"],
             hcover=hinfo["cover"], ent=ent.numpy(), egywt=egy.numpy(),
             fp_iter=fp["iterations"])


def _run(tmp, ndev, balanced, case):
    ref = _jax_ref(case)
    tmp.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / "cols.npz", **ref["cols"])
    np.savez(tmp / "tf.npz", **ref["tf"])
    ranks = spawn_ranks(_sph_body, ndev, tmp, ndev, balanced, case)
    out = {k: np.concatenate([r[k] for r in ranks])
           for k in ("pid", "hsml", "rho", "egy", "acc", "dts", "mvs", "ent",
                     "egywt")}
    for k in ("niter", "strips", "dcover", "ghosts", "hghosts", "hcover",
              "fp_iter"):
        out[k] = [int(r[k]) for r in ranks]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return SpawnCache(tmp_path_factory.mktemp("sph_slab"), _run)


@pytest.mark.parametrize("key", KEYS, ids=lambda k: f"{k[0]}{k[2]}"
                         + ("_balanced" if k[1] else ""))
def test_slab_sph_matches_jax(runs, key):
    ndev, _, case = key
    got, ref = runs[key], _jax_ref(key[2])
    pid = got["pid"]
    assert sorted(pid) == list(range(N))
    # every rank leaves the loop with the same count, the single device's
    d = ref["density"]
    assert got["niter"] == [d.niter] * ndev
    assert min(got["ghosts"]) > 0 and min(got["hghosts"]) > 0
    for name, want in (("hsml", d.hsml), ("rho", d.density),
                       ("egy", d.egy_wt_density)):
        np.testing.assert_allclose(got[name], np.asarray(want)[pid],
                                   rtol=3e-5, atol=1e-8, err_msg=name)
    h = ref["hydro"]
    acc = np.asarray(h.accel)[pid]
    np.testing.assert_allclose(got["acc"], acc, rtol=1e-4,
                               atol=3e-5 * np.abs(acc).max())
    np.testing.assert_allclose(got["mvs"], np.asarray(h.max_signal_vel)[pid],
                               rtol=1e-5, atol=1e-6)
    dts = np.asarray(h.dt_entropy)[pid]
    np.testing.assert_allclose(got["dts"], dts, rtol=2e-4,
                               atol=1e-5 * np.abs(dts).max())
    assert len(set(got["fp_iter"])) == 1 and got["fp_iter"][0] > 1
    np.testing.assert_allclose(got["ent"], ref["entropy"][pid], rtol=3e-5)
    np.testing.assert_allclose(got["egywt"], ref["egywt"][pid], rtol=3e-5)
    if case == "clustered":
        # the voids' probes outgrow the stencil window and the first strip
        assert sum(got["dcover"]) > 0 and got["strips"][0] > 1
        assert len(set(got["strips"])) == 1
