"""The pair kernel's plain version against the JAX Pallas kernel (run in
interpret mode on the CPU, as tests/test_pallas_p2p.py runs it) and
against the f64 numpy oracle of tests/test_pallas_p2p.py; with the erfc
window (which the JAX package evaluates in its XLA pair pass, not the
Pallas kernel) against that pass, at tests/test_pallas_p2p.py's 2e-4."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from shenqi_tpu.gravity.window import window_polynomials as j_window
from shenqi_tpu.ops.pallas_p2p import p2p_blocked as j_p2p

from shenqi_tpu_torch.convert import window_from_numpy
from shenqi_tpu_torch.gravity.shortrange import ErfcWindow
from shenqi_tpu_torch.ops.p2p import (p2p_blocked, p2p_blocked_reference,
                                      p2p_erfc_flops_per_pair,
                                      p2p_flops_outside_window,
                                      p2p_flops_per_pair)
from tests.test_pallas_p2p import _reference

# one intra-op thread: the suite runs several pytest workers at once,
# and torch's default of one thread per core oversubscribes the host
torch.set_num_threads(1)

BOX = 50000.0
SOFT, CELL, G = 120.0, BOX / 64, 43007.1


def _inputs(nb, blk, S, seed):
    """Random targets and sources over the whole uint32 range, every
    7th lane padding (zero mass), and the first block's first sources
    within a few cells of its targets so the softening branches and the
    window run."""
    rng = np.random.RandomState(seed)
    tgt = rng.randint(0, 2 ** 32, (nb, blk, 3), dtype=np.uint64
                      ).astype(np.uint32)
    src = rng.randint(0, 2 ** 32, (nb, S, 3), dtype=np.uint64
                      ).astype(np.uint32)
    sm = rng.uniform(0.5, 2.0, (nb, S)).astype(np.float32)
    sm[:, ::7] = 0.0
    for b in range(nb):
        near = np.resize(tgt[b], (min(S, 4 * blk), 3))
        src[b, :len(near)] = (near.astype(np.int64) + rng.randint(
            -2 ** 22, 2 ** 22, near.shape)).astype(np.uint32)
    return tgt, src, sm


def _t(a):
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


@pytest.fixture(scope="module")
def windows():
    jw = j_window(1.5)
    return jw, window_from_numpy(np.asarray(jw.cf), np.asarray(jw.cp),
                                 float(jw.xmax), device="cpu")


def _padding(sm, case):
    """The padding layouts the CUDA kernel's chunk skip meets: a block
    of all-padding lanes, and live lanes only as a prefix of each block
    (as the stencil packs them) with whole padding chunks after it."""
    sm = sm.copy()
    if case == "all_padding":
        sm[1] = 0.0
    elif case == "prefix":
        for b, live in enumerate((40, 300, 1)):
            sm[b, live:] = 0.0
    return sm


# (case, blk, S, window degree; None: the default fit's 12)
CASES = [("random", 32, 1024, None), ("random", 128, 1024, None),
         ("all_padding", 32, 1024, None), ("prefix", 32, 1024, None),
         ("random", 1, 2048, None), ("random", 32, 1024, 16)]


@pytest.mark.parametrize("case,blk,S,degree", CASES)
@pytest.mark.parametrize("want_pot", [True, False])
def test_reference_matches_pallas_kernel(windows, case, blk, S, degree,
                                         want_pot):
    jw, tw = windows
    if degree is not None:
        jw = j_window(1.5, degree=degree)
        tw = window_from_numpy(np.asarray(jw.cf), np.asarray(jw.cp),
                               float(jw.xmax), device="cpu")
        assert tw.cf.shape[0] == degree + 1
    nb = 3
    tgt, src, sm = _inputs(nb, blk, S, blk + want_pot)
    sm = _padding(sm, case)
    jacc, jpot = j_p2p(jnp.asarray(tgt), jnp.asarray(src), jnp.asarray(sm),
                       BOX, SOFT, CELL, jw, G, interpret=True,
                       want_pot=want_pot, sch=512, blk=blk)
    tacc, tpot = p2p_blocked_reference(_t(tgt), _t(src), _t(sm), BOX, SOFT,
                                       CELL, tw, G, want_pot=want_pot,
                                       sch=512, blk=blk)
    jacc = np.asarray(jacc)
    scale = np.abs(jacc).max()
    assert np.abs(tacc.numpy() - jacc).max() < 2e-4 * scale
    if case == "all_padding":
        assert not tacc[1].any() and not np.any(jacc[1])
    if want_pot:
        jpot = np.asarray(jpot)
        assert np.abs(tpot.numpy() - jpot).max() < \
            2e-4 * np.abs(jpot).max()
    else:
        assert jpot is None and tpot is None


@pytest.mark.parametrize("blk", [1, 32, 128])
def test_reference_matches_f64_oracle(windows, blk, monkeypatch):
    """Against tests/test_pallas_p2p.py's f64 numpy oracle (written for
    its module's BLK, which is patched to this block size)."""
    import tests.test_pallas_p2p as oracle
    monkeypatch.setattr(oracle, "BLK", blk)
    jw, tw = windows
    tgt, src, sm = _inputs(4, blk, 512, 10 + blk)
    ref_acc, ref_pot = _reference(tgt, src, sm, SOFT, CELL, jw, G)
    acc, pot = p2p_blocked(_t(tgt), _t(src), _t(sm), BOX, SOFT, CELL, tw,
                           G, want_pot=True, blk=blk)
    assert np.abs(acc.numpy() - ref_acc).max() < 2e-4 * np.abs(ref_acc).max()
    assert np.abs(pot.numpy() - ref_pot).max() < \
        2e-4 * (np.abs(ref_pot).max() + 1e-30)


def test_padding_lanes_contribute_nothing(windows):
    """Zero-mass lanes are padding: appending them changes nothing."""
    _, tw = windows
    tgt, src, sm = _inputs(2, 32, 512, 3)
    acc, pot = p2p_blocked(_t(tgt), _t(src), _t(sm), BOX, SOFT, CELL, tw, G,
                           blk=32)
    src2 = np.concatenate([src, src[:, ::-1]], axis=1)
    sm2 = np.concatenate([sm, np.zeros_like(sm)], axis=1)
    acc2, pot2 = p2p_blocked(_t(tgt), _t(src2), _t(sm2), BOX, SOFT, CELL,
                             tw, G, blk=32)
    # only the summation order changes (f32 rounding)
    np.testing.assert_allclose(acc2.numpy(), acc.numpy(),
                               atol=1e-6 * np.abs(acc.numpy()).max())
    np.testing.assert_allclose(pot2.numpy(), pot.numpy(),
                               atol=1e-6 * np.abs(pot.numpy()).max())


def test_cpu_wrapper_takes_plain_version_without_launching(windows):
    _, tw = windows
    tgt, src, sm = _inputs(1, 32, 512, 4)
    before = p2p_blocked.launches
    p2p_blocked(_t(tgt), _t(src), _t(sm), BOX, SOFT, CELL, tw, G, blk=32)
    assert p2p_blocked.launches == before
    assert (p2p_flops_outside_window() < p2p_flops_per_pair(12)
            < p2p_flops_per_pair(12, 12, True))
    assert (p2p_flops_outside_window() < p2p_erfc_flops_per_pair()
            < p2p_erfc_flops_per_pair(True))


@pytest.mark.parametrize("poly", [True, False, "erfc"])
@pytest.mark.parametrize("want_pot", [True, False])
def test_pair_factors_match(windows, poly, want_pot):
    """shortrange_refined._pair_fac_any (Chebyshev window: the one-rsqrt
    form; erfc, as no tables or as the ErfcWindow the port's stencil
    carries: spline_force + short_range_window) against the JAX
    package's, on separations from inside the softening to past the
    window range.  f32 rounding: 1e-5 of the largest factor."""
    from shenqi_tpu.gravity.shortrange_refined import _pair_fac_any as jf
    from shenqi_tpu.gravity.shortrange import ShortRangeParams as JP
    from shenqi_tpu_torch.gravity.shortrange_refined import \
        _pair_fac_any as tf
    from shenqi_tpu_torch.gravity.shortrange import ShortRangeParams as TP
    jw, tw = windows
    kw = dict(boxsize=BOX, cellsize=CELL, rcut=6 * CELL, asmth=1.5,
              softening=SOFT, G=G)
    rng = np.random.RandomState(6)
    r = np.concatenate([rng.uniform(0, 2 * SOFT, 500),
                        rng.uniform(0, 16 * CELL, 1500)]).astype(np.float32)
    r2 = (r * r).astype(np.float32)
    m = rng.uniform(0.5, 2.0, r.shape).astype(np.float32)
    jff, jfp = jf(jnp.asarray(r2), jnp.asarray(m), JP(**kw),
                  jw if poly is True else None, want_pot)
    tff, tfp = tf(torch.from_numpy(r2), torch.from_numpy(m), TP(**kw),
                  ErfcWindow(1.5) if poly == "erfc" else
                  tw if poly else None, want_pot)
    jff = np.asarray(jff)
    fin = np.isfinite(jff)
    scale = np.abs(jff[fin]).max()
    assert np.array_equal(np.isfinite(tff.numpy()), fin)
    assert np.abs(tff.numpy()[fin] - jff[fin]).max() < 1e-5 * scale
    if want_pot:
        jfp = np.asarray(jfp)
        assert np.abs(tfp.numpy() - jfp).max() < 1e-5 * np.abs(jfp).max()
    else:
        assert tfp is None and jfp is None


def _jax_erfc_pass(tgt, src, sm, want_pot):
    """The JAX package's erfc pair pass, as its stencil's `pair_accum`
    runs it with no window tables (shenqi_tpu/gravity/stencil.py:
    296-310): the uint32 separations, `_pair_fac_any` and the sums,
    times G."""
    from shenqi_tpu.gravity.shortrange import ShortRangeParams as JP
    from shenqi_tpu.gravity.shortrange_refined import _pair_fac_any
    params = JP(boxsize=BOX, cellsize=CELL, rcut=6 * CELL, asmth=1.5,
                softening=SOFT, G=G)
    d = jnp.asarray(src)[:, None, :, :] - jnp.asarray(tgt)[:, :, None, :]
    dx = jax.lax.bitcast_convert_type(d, jnp.int32).astype(
        jnp.float32) * jnp.float32(BOX / 2 ** 32)
    r2 = jnp.sum(dx * dx, axis=-1)
    ff, fp = _pair_fac_any(r2, jnp.asarray(sm)[:, None, :], params, None,
                           want_pot)
    acc = np.asarray(jnp.sum(dx * ff[..., None], axis=2) * G)
    return acc, (np.asarray(jnp.sum(fp, axis=2) * G) if want_pot else None)


@pytest.mark.parametrize("case,blk,S", [
    ("random", 32, 1024), ("prefix", 32, 1024), ("random", 1, 2048),
    ("random", 128, 512)])
@pytest.mark.parametrize("want_pot", [True, False])
def test_erfc_reference_matches_jax_pair_pass(case, blk, S, want_pot):
    """The erfc window's plain pair pass (what the CPU runs and the
    kernel's erfc instantiation is held to on the card) against the JAX
    package's erfc pair pass: 2e-4 of max |acc| and |pot|."""
    tgt, src, sm = _inputs(3, blk, S, 20 + blk + want_pot)
    sm = _padding(sm, case)
    # sources at 1-16 cells of the first targets, across the window's
    # 15-cell end
    rng = np.random.RandomState(blk)
    k = min(S, 64)
    off = rng.normal(size=(3, k, 3))
    off *= (rng.uniform(1.0, 16.0, (3, k, 1)) * CELL
            / np.linalg.norm(off, axis=2, keepdims=True))
    src[:, -k:] = (tgt[:, :1].astype(np.int64)
                   + np.round(off * 2 ** 32 / BOX).astype(np.int64)
                   ).astype(np.uint32)
    sm[:, -k:] = 1.0
    jacc, jpot = _jax_erfc_pass(tgt, src, sm, want_pot)
    tacc, tpot = p2p_blocked(_t(tgt), _t(src), _t(sm), BOX, SOFT, CELL,
                             ErfcWindow(1.5), G, want_pot=want_pot,
                             sch=512 if S % 512 == 0 else 8, blk=blk)
    assert np.abs(tacc.numpy() - jacc).max() < 2e-4 * np.abs(jacc).max()
    if want_pot:
        assert np.abs(tpot.numpy() - jpot).max() < 2e-4 * np.abs(jpot).max()
    else:
        assert tpot is None
