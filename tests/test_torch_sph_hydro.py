"""The port's SPH hydro force (shenqi_tpu_torch/sph/hydro.py,
stencil_hydro.py) against the JAX package's on the CPU, from the seeded
sets of tests/test_stencil_hydro.py and tests/test_visc_limiter.py.

Limits, from the JAX package's own tests: accel, dt_entropy and
max_signal_vel within 5e-5 of their max (test_stencil_hydro.py:66-75);
cover flags identical; the limiter's effect as test_visc_limiter.py
bounds it.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from shenqi_tpu.sph import kernels as jk
from shenqi_tpu.sph.hydro import hydro_walk_dense as j_hydro_dense
from shenqi_tpu.sph.stencil_hydro import stencil_hydro_walk as j_shw

from shenqi_tpu_torch.sph import kernels as tk
from shenqi_tpu_torch.sph.hydro import HydroParams, hydro_walk_dense
from shenqi_tpu_torch.sph.stencil_hydro import stencil_hydro_walk
from tests.test_hydro import _prepare, BOX
from tests.test_stencil_hydro import _gas_setup, _src_fields
from tests.test_torch_sph import _t, _rel
from tests.test_visc_limiter import _fast_pair_setup

torch.set_num_threads(2)


def _par(p):
    """The port's HydroParams from the JAX package's."""
    return HydroParams(boxsize=p.boxsize, atime=p.atime, hubble=p.hubble,
                       art_bulk_visc_const=p.art_bulk_visc_const,
                       density_contrast_limit=p.density_contrast_limit,
                       density_independent_sph=p.density_independent_sph)


def _hydro_pair(n, seed, clustered, long_ids=(), k=None, egy=True,
                long_h=0.30):
    tree, payload, targets, par, _ = _gas_setup(n, seed,
                                                clustered=clustered)
    par = par._replace(density_independent_sph=egy)
    ipos_src, fields = _src_fields(payload, tree)
    fields = np.array(fields)
    fields[list(long_ids), 1] = long_h * BOX
    rj, cj, nj = j_shw(ipos_src, jnp.asarray(fields), targets, par,
                       spec=jk.CUBIC, k=k)
    tt = {key: _t(v) for key, v in targets.items()}
    rt, ct, nt, nlong = stencil_hydro_walk(_t(ipos_src), _t(fields), tt,
                                           _par(par), spec=tk.CUBIC, k=k)
    return (rj, np.asarray(cj), nj), (rt, ct.numpy(), nt), nlong


@pytest.mark.parametrize("case", ["clustered", "density_entropy",
                                  "long_reach"])
def test_stencil_hydro_walk_parity(case):
    """The symmetric hydro stencil, with pressure-entropy and
    density-entropy equations of motion, and with sources whose hsml
    exceeds the 2-cell cut (the dense long-reach pass,
    test_stencil_hydro.py:82; k = 3 puts the cut at 0.25 box, below the
    inflated 0.3 box)."""
    if case != "long_reach":
        (rj, cj, nj), (rt, ct, nt), nlong = _hydro_pair(
            800, 51, True, egy=case == "clustered")
    else:
        (rj, cj, nj), (rt, ct, nt), nlong = _hydro_pair(
            700, 53, False, long_ids=(3, 100, 450), k=3)
        assert nlong >= 3
    assert nj == nt and np.array_equal(cj, ct)
    ok = ~ct
    assert ok.sum() > 0.9 * len(ct)
    for name, a, b in zip(rj._fields, rj, rt):
        assert _rel(np.asarray(a)[ok], b.numpy()[ok]) < 5e-5, name


@pytest.mark.parametrize("dloga", [0.0, 0.2])
def test_viscosity_limiter_parity(dloga):
    """The fast cold pair of tests/test_visc_limiter.py through the dense
    hydro pass, with the limiter off (dloga 0) and armed (a long step):
    the port matches the JAX package, and the armed limiter cuts the hot
    pair's dissipation while leaving the subsonic rest alone."""
    pos, mass, vel, entropy, hsml0 = _fast_pair_setup()
    tree, payload, targets, par, _ = _prepare(pos, mass, vel, entropy,
                                              hsml0)
    n = len(pos)
    dl = jnp.full(n, dloga, jnp.float32)
    payload = dict(payload, dloga=dl[tree.order])
    targets = dict(targets, dloga=dl)
    rj = j_hydro_dense(payload, targets, par)
    pt = {k: _t(v) for k, v in payload.items()}
    tt = {k: _t(v) for k, v in targets.items()}
    rt = hydro_walk_dense(pt, tt, _par(par))
    for name, a, b in zip(rj._fields, rj, rt):
        assert _rel(a, b) < 5e-5, name
    if dloga:
        pt0 = dict(pt, dloga=torch.zeros(n))
        r0 = hydro_walk_dense(pt0, dict(tt, dloga=torch.zeros(n)),
                              _par(par))
        d0, d1 = r0.dt_entropy.numpy(), rt.dt_entropy.numpy()
        hot = np.argsort(d0)[-2:]
        assert (d1[hot] < 0.9 * d0[hot]).all()
        rest = np.setdiff1d(np.arange(n), hot)
        np.testing.assert_allclose(d1[rest], d0[rest], rtol=1e-3, atol=1e-9)




@pytest.mark.parametrize("k,branch", [(6, "stencil"), (3, "dense")])
def test_hydro_cover_patch_parity(k, branch, monkeypatch):
    """The hydro cover patch (stencil_hydro.hydro_cover_patch) against
    the JAX package's dense patch of the same targets, within 5e-5 of
    each output's max (test_stencil_hydro_walk_parity's limit), on the
    targets the walk flags cover: at grid level 6, the 40 of smallest
    hsml, whose reach outgrows the W = 7 window and which the patch
    redoes on one-target stencils; at level 3, every 20th target with
    its hsml tripled, whose window would hold an eighth of the grid, so
    the patch takes every source.  Which branch ran is asserted."""
    from shenqi_tpu_torch.sph import stencil_hydro as tsh
    tree, payload, targets, par, _ = _gas_setup(800, 51, clustered=True)
    ipos_src, fields = _src_fields(payload, tree)
    hs = np.asarray(targets["hsml"])
    sel = np.argsort(hs)[:40] if branch == "stencil" else np.arange(0, 800,
                                                                     20)
    tj = {key: np.asarray(v)[sel].copy() for key, v in targets.items()}
    if branch == "dense":
        tj["hsml"] = tj["hsml"] * 3
    tt = {key: _t(v) for key, v in tj.items()}
    _, cover, _, _ = stencil_hydro_walk(_t(ipos_src), _t(fields), tt,
                                        _par(par), spec=tk.CUBIC, k=k)
    cov = cover.numpy()
    assert cov.sum() >= 10
    tj = {key: v[cov] for key, v in tj.items()}
    tt = {key: _t(v) for key, v in tj.items()}
    rj = j_hydro_dense(payload, {key: jnp.asarray(v) for key, v in
                                 tj.items()}, par)
    ran = []
    real_dense, real_walk = tsh.hydro_walk_dense, tsh.stencil_hydro_walk
    monkeypatch.setattr(tsh, "hydro_walk_dense", lambda *a, **kw: (
        ran.append("dense"), real_dense(*a, **kw))[1])
    monkeypatch.setattr(tsh, "stencil_hydro_walk", lambda *a, **kw: (
        ran.append("stencil"), real_walk(*a, **kw))[1])
    pt = {key: _t(v) for key, v in payload.items()}
    rt = tsh.hydro_cover_patch(_t(ipos_src), _t(fields), tt, _par(par), pt,
                               spec=tk.CUBIC, k=k)
    assert set(ran) == {branch}
    for name, a, b in zip(rj._fields, rj, rt):
        assert _rel(np.asarray(a), b.numpy()) < 5e-5, name


def test_long_reach_pass_culls_exactly():
    """The long-reach pass (stencil_hydro._hydro_long_eval) keeps only the
    Morton block pairs within reach: every smoothing length of 3000
    uniform rows shrunk to a fifth (~0.025 box, under the 2-cell cut of
    level 5) and 40 sources inflated to 0.08 box, each reaching a part
    of the targets; against every target with
    every long source (the same accumulator, unculled): accel,
    dt_entropy and max_signal_vel within 5e-5 of their max, and some
    block pairs culled."""
    from shenqi_tpu_torch.sph import stencil_hydro as tsh
    tree, payload, targets, par, _ = _gas_setup(3000, 55, clustered=False)
    ipos_src, fields = _src_fields(payload, tree)
    fields = np.array(fields)
    fields[:, 1] *= 0.2
    fields[np.arange(0, 3000, 75), 1] = 0.08 * BOX
    tt = {key: _t(v) for key, v in targets.items()}
    tt["hsml"] = tt["hsml"] * 0.2
    tpar = _par(par)
    _, _, _, long_rows, nlong = tsh.build_grid_hydro(
        _t(ipos_src), _t(fields), 5, 2.0 * BOX / 32)
    assert nlong == 40
    accum = tsh._hydro_accum(tk.CUBIC, tpar)
    extra = tsh._hydro_extra(tt, tpar, None)
    tvalid = tt["hsml"] > 0
    got = tsh._hydro_long_eval(long_rows, extra, tt["ipos"], tvalid,
                               float(BOX), accum)
    src = tsh._unpack_src(long_rows[None])
    dist, r2 = tsh.pair_dist(tt["ipos"][:, None, :], src["ipos"], BOX)
    want = accum(tsh._zero_carry((3000,), "cpu"), extra, src, dist, r2,
                 tvalid[:, None].expand(r2.shape))
    touched = (torch.linalg.norm(want[0], dim=-1) > 0).sum()
    assert 0 < touched < 3000
    for a, b in zip(want, got):
        a, b = a.numpy(), b.numpy()
        assert np.abs(a - b).max() <= 5e-5 * np.abs(a).max()
