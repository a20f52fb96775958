"""PM gravity of the port against the JAX package: CIC deposit and
readout, the full PM force solve, the binned power spectrum and the
PM-calibrated short-range window."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from shenqi_tpu.core.particles import float_to_ipos
from shenqi_tpu.ops import cic as jcic
from shenqi_tpu.gravity import pm as jpm
from shenqi_tpu.gravity.window import window_polynomials as j_window
from shenqi_tpu.gravity.shortrange import short_range_window as j_srw

from shenqi_tpu_torch.ops import cic as tcic
from shenqi_tpu_torch.gravity import pm as tpm
from shenqi_tpu_torch.gravity.window import window_polynomials as t_window
from shenqi_tpu_torch.gravity.shortrange import short_range_window as t_srw

# one intra-op thread: the suite runs several pytest workers at once,
# and torch's default of one thread per core oversubscribes the host
torch.set_num_threads(1)

BOX = 50000.0


def _particles(n, seed, clustered=True):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, BOX, (n, 3))
    if clustered:
        c = rng.uniform(0, BOX, (6, 3))
        pos[: n // 2] = (c[rng.randint(0, 6, n // 2)]
                         + rng.normal(0, BOX / 40, (n // 2, 3))) % BOX
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    mask = rng.rand(n) > 0.05
    ipos = float_to_ipos(pos, BOX)
    return ipos, mass, mask


def _t(a):
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


@pytest.mark.parametrize("nmesh", [16, 32])
def test_cic_deposit_and_readout(nmesh):
    ipos, mass, mask = _particles(3000, nmesh)
    ref = np.asarray(jcic.cic_deposit(jnp.asarray(ipos), jnp.asarray(mass),
                                      nmesh, mask=jnp.asarray(mask)))
    got = tcic.cic_deposit(_t(ipos), _t(mass), nmesh,
                           mask=_t(mask)).numpy()
    # scatter-add order differs: compare to f32 rounding of the total
    assert np.abs(got - ref).max() < 1e-5 * ref.sum()
    assert got.sum() == pytest.approx(mass[mask].sum(), rel=1e-5)

    field = np.random.RandomState(1).normal(
        size=(nmesh,) * 3).astype(np.float32)
    ref_r = np.asarray(jcic.cic_readout(jnp.asarray(field),
                                        jnp.asarray(ipos),
                                        mask=jnp.asarray(mask)))
    got_r = tcic.cic_readout(torch.from_numpy(field), _t(ipos),
                             mask=_t(mask)).numpy()
    assert np.abs(got_r - ref_r).max() < 1e-5 * np.abs(field).max()


@pytest.fixture(scope="module")
def pm_pair():
    ipos, mass, mask = _particles(4000, 7)
    jcfg = jpm.PMConfig(nmesh=32, boxsize=BOX, G=43007.1, asmth=1.5)
    tcfg = tpm.PMConfig(nmesh=32, boxsize=BOX, G=43007.1, asmth=1.5)
    jr = jpm.pm_forces(jnp.asarray(ipos), jnp.asarray(mass), jcfg,
                       mask=jnp.asarray(mask))
    tr = tpm.pm_forces(_t(ipos), _t(mass), tcfg, mask=_t(mask))
    return mask, jr, tr, jcfg, tcfg


def test_pm_forces_match(pm_pair):
    mask, (ja, jpot, _), (ta, tpot, _), _, _ = pm_pair
    ja = np.asarray(ja)[mask]
    ta = ta.numpy()[mask]
    scale = np.median(np.linalg.norm(ja, axis=1))
    err = np.linalg.norm(ta - ja, axis=1) / scale
    assert np.percentile(err, 99) < 1e-4, np.percentile(err, 99)
    jpot = np.asarray(jpot)[mask]
    perr = np.abs(tpot.numpy()[mask] - jpot) / np.median(np.abs(jpot))
    assert np.percentile(perr, 99) < 1e-4


def test_finalize_power_match(pm_pair):
    _, (_, _, jps), (_, _, tps), jcfg, tcfg = pm_pair
    jk, jp_, jn = jpm.finalize_power(jps, jcfg, 50.0)
    tk, tp_, tn = tpm.finalize_power(tps, tcfg, 50.0)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_allclose(tk, jk, rtol=1e-4)
    np.testing.assert_allclose(tp_, jp_, rtol=1e-4)


@pytest.fixture(scope="module")
def windows():
    return j_window(1.5), t_window(1.5, device="cpu")


def test_window_coefficients_match(windows):
    """The port calibrates against its own PM: same degree, and the
    Chebyshev coefficients agree within 1e-5 absolute (the window is
    O(1); the calibration's own noise is ~1e-4)."""
    jw, tw = windows
    assert tw.cf.shape == jw.cf.shape and tw.cp.shape == jw.cp.shape
    assert tw.xmax == float(jw.xmax)
    np.testing.assert_allclose(tw.cf.numpy(), np.asarray(jw.cf), atol=1e-5)
    np.testing.assert_allclose(tw.cp.numpy(), np.asarray(jw.cp), atol=1e-5)


def test_window_values_match(windows):
    jw, tw = windows
    cell = BOX / 32
    r = np.linspace(0, 16 * cell, 1000).astype(np.float32)
    jf, jp_ = j_srw(jnp.asarray(r), cell, 1.5, jw)
    tf, tp_ = t_srw(torch.from_numpy(r), cell, 1.5, tw)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5)
    np.testing.assert_allclose(tp_.numpy(), np.asarray(jp_), atol=1e-5)
