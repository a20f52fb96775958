"""Grid-stencil short-range gravity of the port against the JAX package
(engine="pallas" in interpret mode and the default xla engine), against
the f64 direct oracle, and on the active-subset and dead-row paths.
Inputs are the clustered sets of tests/test_stencil_gravity.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from shenqi_tpu.gravity import stencil as js
from shenqi_tpu.gravity.window import window_polynomials as j_window

from shenqi_tpu_torch.convert import window_from_numpy
from shenqi_tpu_torch.gravity import stencil as ts
from shenqi_tpu_torch.gravity.shortrange import ShortRangeParams
from tests.test_stencil_gravity import _ipos_mass
from tests.test_tree import _direct_short_range, BOX

# one intra-op thread: the suite runs several pytest workers at once,
# and torch's default of one thread per core oversubscribes the host
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def windows():
    jw = j_window(1.5)
    return jw, window_from_numpy(np.asarray(jw.cf), np.asarray(jw.cp),
                                 float(jw.xmax), device="cpu")


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _tparams(params):
    return ShortRangeParams(*params)


def _rel_err(acc, ref):
    fmag = np.linalg.norm(ref, axis=1)
    scale = np.median(fmag[fmag > 0])
    return np.linalg.norm(acc - ref, axis=1) / scale


@pytest.fixture(scope="module")
def case700():
    return _ipos_mass(700, 21)


@pytest.mark.parametrize("k", [2, 3])
def test_build_grid_bit_exact(case700, k):
    ipos, mass, _, _ = case700
    mass_np = np.asarray(mass).copy()
    mass_np[::11] = 0.0                      # dead rows sort last
    jr = js.build_grid(ipos, jnp.asarray(mass_np), k)
    tr = ts.build_grid(_t(ipos), _t(mass_np), k)
    for name, j, t in zip(("order", "ipos_s", "mass_s", "qtab", "qmeta",
                           "n_alive"), jr, tr):
        np.testing.assert_array_equal(
            t.numpy(), np.asarray(j).view(np.int32)
            if np.asarray(j).dtype == np.uint32 else np.asarray(j),
            err_msg=name)


@pytest.fixture(scope="module")
def jax_pallas700(windows, case700):
    """JAX engine="pallas" (interpret mode) forces and potential."""
    ipos, mass, params, _ = case700
    acc, pot, _ = js.stencilgrav(ipos, mass, params, windows[0],
                                 want_pot=True, engine="pallas")
    return np.asarray(acc), np.asarray(pot)


def test_stencil_matches_jax_pallas_engine(windows, case700, jax_pallas700):
    """Both evaluate the exact spline + window for every pair: the port
    agrees to f32 rounding (99th percentile < 1e-4 of median |a|)."""
    _, tw = windows
    ipos, mass, params, _ = case700
    got, _, _ = ts.stencilgrav(_t(ipos), _t(mass), _tparams(params), tw)
    ref = jax_pallas700[0]
    err = np.linalg.norm(got.numpy() - ref, axis=1) / np.median(
        np.linalg.norm(ref, axis=1))
    assert np.percentile(err, 99) < 1e-4, np.percentile(err, 99)
    assert np.isfinite(got.numpy()).all()


def test_stencil_matches_jax_xla_engine(windows):
    """The JAX default engine (capped Newton + near-cell correction) is
    the same force law evaluated in another order."""
    jw, tw = windows
    ipos, mass, params, _ = _ipos_mass(900, 22)
    ref, _, _ = js.stencilgrav(ipos, mass, params, jw, engine="xla")
    got, _, _ = ts.stencilgrav(_t(ipos), _t(mass), _tparams(params), tw)
    ref = np.asarray(ref)
    err = np.linalg.norm(got.numpy() - ref, axis=1) / np.median(
        np.linalg.norm(ref, axis=1))
    assert np.percentile(err, 99) < 1e-4, np.percentile(err, 99)


def test_stencil_matches_direct_oracle(windows, case700):
    _, tw = windows
    ipos, mass, params, expected = case700
    acc, pot, _ = ts.stencilgrav(_t(ipos), _t(mass), _tparams(params), tw,
                                 want_pot=True)
    err = _rel_err(acc.numpy(), expected)
    assert np.percentile(err, 90) < 0.005, np.percentile(err, 90)
    assert np.isfinite(pot.numpy()).all()


def test_stencil_potential_matches_jax(windows, case700, jax_pallas700):
    _, tw = windows
    ipos, mass, params, _ = case700
    _, tpot, _ = ts.stencilgrav(_t(ipos), _t(mass), _tparams(params), tw,
                                want_pot=True)
    jpot = jax_pallas700[1]
    err = np.abs(tpot.numpy() - jpot) / np.median(np.abs(jpot))
    assert np.percentile(err, 99) < 1e-4


def test_stencil_sparse_active(windows):
    """Sparse actives: compacted targets."""
    jw, tw = windows
    ipos, mass, params, expected = _ipos_mass(800, 23)
    n = expected.shape[0]
    active = np.random.RandomState(5).rand(n) < 0.1
    nact = int(active.sum())
    ref, _, _ = js.stencilgrav(ipos, mass, params, jw, engine="pallas",
                               active=jnp.asarray(active), n_targets=nact)
    got, _, _ = ts.stencilgrav(_t(ipos), _t(mass), _tparams(params), tw,
                               active=_t(active), n_targets=nact)
    got = got.numpy()
    assert np.all(got[~active] == 0.0)
    # (no erfc-oracle bar here: on this subset the calibrated window
    # itself sits ~2e-2 from the erfc oracle in the JAX package too)
    ref = np.asarray(ref)[active]
    d = np.linalg.norm(got[active] - ref, axis=1) / np.median(
        np.linalg.norm(ref, axis=1))
    assert np.percentile(d, 99) < 1e-4


def test_stencil_cover_fallback(windows):
    """A W=5 window is too narrow for many sub-block bboxes: those
    targets go through the per-target (blk = 1) fallback, and the
    fused path reports ok False for them."""
    jw, tw = windows
    ipos, mass, params, _ = _ipos_mass(800, 26)
    ref, _, _ = js.stencilgrav(ipos, mass, params, jw, engine="pallas", W=5)
    cache = {}
    got, _, _ = ts.stencilgrav(_t(ipos), _t(mass), _tparams(params), tw,
                               W=5, tier_cache=cache)
    assert any(k[-1] == "pp" for k in cache if isinstance(k, tuple))
    got = got.numpy()
    ref = np.asarray(ref)
    d = np.linalg.norm(got - ref, axis=1) / np.median(
        np.linalg.norm(ref, axis=1))
    assert np.percentile(d, 99) < 1e-4, np.percentile(d, 99)
    _, _, ok = ts.stencilgrav_fused(_t(ipos), _t(mass), _tparams(params),
                                    tw, W=5, tier_cache=cache)
    assert not bool(ok)


def test_stencil_active_subset(windows):
    """Active subset with masked sources equals the full call's rows."""
    _, tw = windows
    ipos, mass, params, _ = _ipos_mass(900, 23)
    n = mass.shape[0]
    sel = np.random.RandomState(5).rand(n) < 0.4
    mass_sel = np.where(sel, np.asarray(mass), 0.0).astype(np.float32)
    tp = _tparams(params)
    acc_a, _, _ = ts.stencilgrav(_t(ipos), _t(mass_sel), tp, tw,
                                 n_targets=int(sel.sum()), active=_t(sel))
    acc_f, _, _ = ts.stencilgrav(_t(ipos), _t(mass_sel), tp, tw)
    aa, af = acc_a.numpy(), acc_f.numpy()
    assert np.allclose(aa[sel], af[sel], rtol=1e-5, atol=1e-7)
    assert np.all(aa[~sel] == 0.0)


def test_stencil_odd_n_and_dead_rows(windows):
    _, tw = windows
    ipos, mass, params, expected = _ipos_mass(653, 24)
    n = expected.shape[0]
    mass_np = np.asarray(mass).copy()
    dead = np.zeros(n, bool)
    dead[::13] = True
    mass_np[dead] = 0.0
    acc, _, _ = ts.stencilgrav(_t(ipos), _t(mass_np), _tparams(params), tw)
    acc = acc.numpy()
    assert np.all(acc[dead] == 0.0)
    assert np.isfinite(acc).all()
    pos = np.asarray(ipos).astype(np.float64) * (BOX / 2 ** 32)
    exp_alive, _ = _direct_short_range(
        pos[~dead], mass_np[~dead].astype(np.float64), params)
    err = _rel_err(acc[~dead], exp_alive)
    assert np.percentile(err, 90) < 0.005


def test_fused_path_ok_flag_and_cache(windows, case700):
    """Cold cache: the fused call falls back to the slow path and
    returns ok; warm: same forces with ok True; caps cut below the
    counts: ok False."""
    _, tw = windows
    ipos, mass, params, _ = case700
    tp = _tparams(params)
    cache = {}
    a0, _, ok0 = ts.stencilgrav_fused(_t(ipos), _t(mass), tp, tw,
                                      tier_cache=cache)
    a1, _, ok1 = ts.stencilgrav_fused(_t(ipos), _t(mass), tp, tw,
                                      tier_cache=cache)
    assert bool(ok0) and bool(ok1)
    np.testing.assert_array_equal(a1.numpy(), a0.numpy())
    key = next(k for k in cache if k[0] == "stencil")
    cache[key] = (32, 32, 32, 32)
    _, _, ok2 = ts.stencilgrav_fused(_t(ipos), _t(mass), tp, tw,
                                     tier_cache=cache)
    assert not bool(ok2)


@pytest.mark.parametrize("active", [False, True])
def test_stencil_erfc_window_matches_jax(case700, active):
    """ShortRangeForceWindowType erfc: the port's stencil with the erfc
    window (the kernel's erfc instantiation; its plain version here)
    against the JAX stencil with no window tables (its XLA pair pass), on
    positions of which about half lie at or above 2^31, for all targets
    and for an active subset: 2e-4 of max |acc| and |pot|
    (tests/test_pallas_p2p.py's limit)."""
    from shenqi_tpu_torch.gravity.shortrange import ErfcWindow
    ipos, mass, params, _ = case700
    assert (np.asarray(ipos) >= 2 ** 31).any(0).all()
    kw_j, kw_t = dict(want_pot=True), dict(want_pot=True)
    if active:
        sel = np.random.RandomState(8).rand(mass.shape[0]) < 0.3
        nact = int(sel.sum())
        kw_j.update(active=jnp.asarray(sel), n_targets=nact)
        kw_t.update(active=_t(sel), n_targets=nact)
    jacc, jpot, _ = js.stencilgrav(ipos, mass, params, None, **kw_j)
    tacc, tpot, _ = ts.stencilgrav(_t(ipos), _t(mass), _tparams(params),
                                   ErfcWindow(params.asmth), **kw_t)
    jacc, jpot = np.asarray(jacc), np.asarray(jpot)
    assert np.abs(tacc.numpy() - jacc).max() < 2e-4 * np.abs(jacc).max()
    assert np.abs(tpot.numpy() - jpot).max() < 2e-4 * np.abs(jpot).max()
    if active:
        assert not tacc.numpy()[~sel].any()
