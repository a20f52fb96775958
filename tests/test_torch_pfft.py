"""The port's pencil FFT and slab PM (shenqi_tpu_torch/parallel/pfft.py,
ops/cic.py's slab deposit and readout) on 4 gloo ranks at N = 32
(tests/test_pfft.py's size), against the JAX package:

  * pfft_r2c's pencils against the JAX pfft_r2c under shard_map on 4
    devices (and np.fft.rfftn), the round trip within 1e-4;
  * pm_forces_slab on uniform and on cost-balanced slabs (the deposit
    rows routed to their FFT slab and the forces routed back),
    pm_forces_pencil, and the neutrino split (pm_depose_slab, then
    pm_forces_from_rhok with a response table) against the JAX
    single-device pm_forces within test_pfft.py's 1e-4 of the largest
    force; the pencil P(k) (and measure_cdm_power_slab's) against its
    measure_power (modes equal, power to rtol 1e-4).
"""

import numpy as np
import torch

from test_torch_slab_domain import spawn_ranks

N, D, BOX = 32, 4, 50000.0
NU_K = np.array([0.0, 1e-5, 1e-4, 5e-4, 1e-3, 4e-3], np.float32)
NU_F = np.array([1.02, 0.99, 0.98, 0.97, 0.985, 0.995], np.float32)


def _field():
    return np.random.RandomState(0).normal(size=(N, N, N)).astype(np.float32)


def _particles():
    rng = np.random.RandomState(2)
    pos = np.concatenate([rng.uniform(0, BOX, (1024, 3)),
                          (rng.normal(BOX / 4, BOX / 30, (512, 3))) % BOX])
    mass = rng.uniform(1.0, 3.0, len(pos)).astype(np.float32)
    return pos, mass


def _cfg():
    from shenqi_tpu_torch.gravity.pm import PMConfig
    return PMConfig(nmesh=N, boxsize=BOX, G=43007.1, asmth=1.5)


def _pfft_body(rank, dev, out):
    from shenqi_tpu_torch.core.particles import float_to_ipos
    from shenqi_tpu_torch.parallel import pfft
    from shenqi_tpu_torch.parallel.domain import distribute_slabs
    from test_torch_slab_domain import _cuts
    nloc = N // D
    slab = torch.from_numpy(_field()[rank * nloc:(rank + 1) * nloc].copy())
    pencil = pfft.pfft_r2c(slab)
    back = pfft.pfft_c2r(pencil, N)
    pos, mass = _particles()
    ipos = float_to_ipos(pos, BOX, device="cpu").numpy()
    host = {"ipos": ipos, "mass": mass,
            "pid": np.arange(len(pos), dtype=np.int64)}
    res = {"pencil": torch.view_as_real(pencil).numpy(),
           "back": back.numpy()}
    cfg = _cfg()
    for tag, cuts in (("uni", None), ("bal", _cuts(ipos.view(np.uint32), D))):
        loc = distribute_slabs(host, D, rank, cuts)
        ip = torch.from_numpy(loc["ipos"].view(np.int32))
        m = torch.from_numpy(loc["mass"])
        acc, ps = pfft.pm_forces_slab(ip, m, cfg, D, want_power=True,
                                      cuts_in=cuts)
        res.update({f"{tag}_pid": loc["pid"], f"{tag}_acc": acc.numpy()})
        if cuts is None:
            res.update(power=ps.power.numpy(), nmodes=ps.nmodes.numpy(),
                       k=ps.k.numpy(), norm=ps.norm.numpy(),
                       cdm_power=pfft.measure_cdm_power_slab(
                           ip, m, cfg, D).power.numpy())
            rho_k, _, ctx = pfft.pm_depose_slab(ip, m, cfg, D)
            acc_nu, _ = pfft.pm_forces_from_rhok(
                rho_k, ctx, cfg, D, torch.from_numpy(NU_K),
                torch.from_numpy(NU_F))
            res["nu_acc"] = acc_nu.numpy()
    rows = np.arange(rank, len(pos), D)
    res["pen_pid"] = rows
    res["pen_acc"] = pfft.pm_forces_pencil(
        torch.from_numpy(ipos[rows]), torch.from_numpy(mass[rows]),
        cfg).numpy()
    np.savez(f"{out}/rank{rank}.npz", **res)


def test_pfft_and_slab_pm_match_jax(tmp_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    from shenqi_tpu.core.particles import float_to_ipos
    from shenqi_tpu.gravity.pm import PMConfig, pm_forces
    from shenqi_tpu.parallel.pfft import pfft_r2c
    from shenqi_tpu.parallel.sharded import make_mesh

    ranks = spawn_ranks(_pfft_body, D, tmp_path)
    x = _field()
    mesh = make_mesh(D)
    jpen = np.asarray(jax.jit(lambda s: shard_map(
        pfft_r2c, mesh=mesh, in_specs=(P("dp"),),
        out_specs=P(None, "dp", None), check_vma=False)(s))(
        jax.device_put(x, NamedSharding(mesh, P("dp")))))
    got = np.concatenate([r["pencil"][..., 0] + 1j * r["pencil"][..., 1]
                          for r in ranks], axis=1)
    scale = np.abs(jpen).max()
    assert np.abs(got - jpen).max() < 1e-5 * scale
    assert np.abs(got - np.fft.rfftn(x.astype(np.float64))).max() \
        < 1e-5 * scale
    back = np.concatenate([r["back"] for r in ranks])
    assert np.abs(back - x).max() < 1e-4

    pos, mass = _particles()
    ipos = jnp.asarray(float_to_ipos(pos, BOX))
    cfg = PMConfig(nmesh=N, boxsize=BOX, G=43007.1, asmth=1.5)
    ref, _, ps = pm_forces(ipos, jnp.asarray(mass), cfg,
                           want_potential=False)
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    for tag in ("uni", "bal", "pen"):
        pid = np.concatenate([r[f"{tag}_pid"] for r in ranks])
        acc = np.concatenate([r[f"{tag}_acc"] for r in ranks])
        assert sorted(pid) == list(range(len(pos)))
        assert np.abs(acc - ref[pid]).max() < 1e-4 * scale, tag
    for r in ranks:
        np.testing.assert_array_equal(r["nmodes"], np.asarray(ps.nmodes))
        for key in ("power", "cdm_power"):
            np.testing.assert_allclose(r[key], np.asarray(ps.power),
                                       rtol=1e-4)
        np.testing.assert_allclose(r["k"], np.asarray(ps.k), rtol=1e-5)
        np.testing.assert_allclose(r["norm"], np.asarray(ps.norm),
                                   rtol=1e-6)
    # the neutrino response: the JAX factor mesh from the same knots
    k1 = np.fft.fftfreq(N, 1.0 / N)
    kz = np.arange(N // 2 + 1)
    kmag = np.sqrt(k1[:, None, None] ** 2 + k1[None, :, None] ** 2
                   + kz[None, None, :] ** 2) * np.float32(2 * np.pi / BOX)
    fac = np.interp(kmag, NU_K, NU_F).astype(np.float32)
    ref_nu = np.asarray(pm_forces(ipos, jnp.asarray(mass), cfg,
                                  want_potential=False,
                                  nu_factor=jnp.asarray(fac))[0])
    pid = np.concatenate([r["uni_pid"] for r in ranks])
    acc = np.concatenate([r["nu_acc"] for r in ranks])
    assert np.abs(acc - ref_nu[pid]).max() < 1e-4 * scale
    assert np.abs(ref_nu - ref).max() > 1e-3 * scale     # it acted
