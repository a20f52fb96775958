"""Port foundation against the JAX package: fixed-point positions, Morton
keys, the timeline, cosmology factors, timebin assignment and the
state conversion.  Integer work is compared bit-exact."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from shenqi_tpu.core import particles as jp
from shenqi_tpu.core import integrate as jint
from shenqi_tpu.core.timeline import Timeline as JTimeline
from shenqi_tpu.cosmology.background import Cosmology as JCosmology
from shenqi_tpu.ops import morton as jm
from shenqi_tpu.utils.units import default_units as j_default_units

from shenqi_tpu_torch.core import particles as tp
from shenqi_tpu_torch.core import integrate as tint
from shenqi_tpu_torch.core.timeline import Timeline as TTimeline
from shenqi_tpu_torch.cosmology.background import Cosmology as TCosmology
from shenqi_tpu_torch.ops import morton as tm
from shenqi_tpu_torch.utils.units import default_units as t_default_units
from shenqi_tpu_torch import convert

# one intra-op thread: the suite runs several pytest workers at once,
# and torch's default of one thread per core oversubscribes the host
torch.set_num_threads(1)

BOX = 50000.0


def _positions(seed=0, n=4000):
    """Uniform positions over the whole box (half of them >= 2^31 in
    fixed point) plus the edges: 0, just below the box, the midpoint,
    negative and beyond-the-box values that wrap."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, BOX, (n, 3))
    edges = np.array([[0.0, BOX * (1 - 1e-12), BOX / 2],
                      [-1.0, BOX + 1.0, BOX / 2 - 1e-9],
                      [BOX * 0.999999, 1e-9, -BOX * 0.25]])
    return np.concatenate([pos, edges])


def _u32(t):
    return t.numpy().view(np.uint32)


def test_float_to_ipos_bit_exact():
    pos = _positions()
    ref = jp.float_to_ipos(pos, BOX)
    got = tp.float_to_ipos(pos, BOX, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got), ref)
    assert (ref >= 2 ** 31).mean() > 0.4     # the upper half is covered


def test_ipos_to_float_and_delta_bit_exact():
    pos = _positions(1)
    ja = jp.float_to_ipos(pos, BOX)
    jb = jp.float_to_ipos(np.roll(pos, 7, axis=0), BOX)
    ta = tp.float_to_ipos(pos, BOX, device="cpu")
    tb = tp.float_to_ipos(np.roll(pos, 7, axis=0), BOX, device="cpu")
    np.testing.assert_array_equal(
        tp.ipos_to_float(ta, BOX).numpy(),
        np.asarray(jp.ipos_to_float(jnp.asarray(ja), BOX)))
    ref = np.asarray(jp.ipos_delta(jnp.asarray(ja), jnp.asarray(jb), BOX))
    got = tp.ipos_delta(ta, tb, BOX).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.abs(ref).max() > BOX / 4      # wrapped separations occur


def test_wrap_helpers_match_uint32():
    rng = np.random.RandomState(2)
    a = rng.randint(0, 2 ** 32, 1000, dtype=np.uint64).astype(np.uint32)
    b = rng.randint(0, 2 ** 32, 1000, dtype=np.uint64).astype(np.uint32)
    ta = torch.from_numpy(a.view(np.int32).copy())
    tb = torch.from_numpy(b.view(np.int32).copy())
    np.testing.assert_array_equal(
        _u32(tp.wrap_i32(ta.long() - tb.long())), a - b)
    np.testing.assert_array_equal(
        _u32(tp.wrap_i32(ta.long() + tb.long())), a + b)
    for s in (1, 7, 22, 31):
        np.testing.assert_array_equal(tp.lshr(ta, s).numpy(),
                                      (a >> np.uint32(s)).astype(np.int64))


def test_morton_keys_bit_exact():
    ipos = jp.float_to_ipos(_positions(3), BOX)
    t = torch.from_numpy(ipos.view(np.int32).copy())
    jk = np.asarray(jm.morton_key(jnp.asarray(ipos)))
    np.testing.assert_array_equal(tm.morton_key(t).numpy(),
                                  jk.astype(np.int64))
    jhi, jlo = jm.morton_key_pair(jnp.asarray(ipos))
    thi, tlo = tm.morton_key_pair(t)
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    for level in (1, 4, 10, 13, 20):
        jc = np.asarray(jm.key_pair_to_cell(jhi, jlo, level))
        tc = tm.key_pair_to_cell(thi, tlo, level).numpy()
        np.testing.assert_array_equal(tc, jc)
        jph, jpl = jm.key_pair_prefix(jhi, jlo, level)
        tph, tpl = tm.key_pair_prefix(thi, tlo, level)
        np.testing.assert_array_equal(tph.numpy(), np.asarray(jph))
        np.testing.assert_array_equal(tpl.numpy(), np.asarray(jpl))


def _timelines():
    args = ([0.1, 0.2, 0.8], 0.05, 1.0)
    return JTimeline.setup(*args), TTimeline.setup(*args)


def test_timeline_equal():
    jt, tt = _timelines()
    assert [vars(s) for s in jt.syncpoints] == \
        [vars(s) for s in tt.syncpoints]
    for loga in np.log([0.05, 0.06, 0.1, 0.15, 0.5, 0.9, 1.0]):
        ti = jt.ti_from_loga(loga)
        assert tt.ti_from_loga(loga) == ti
        assert tt.loga_from_ti(ti) == jt.loga_from_ti(ti)
        for dloga in (1e-4, 3e-2):
            assert tt.dti_from_dloga(dloga, ti) == \
                jt.dti_from_dloga(dloga, ti)
        assert tt.find_next_ti_sync(ti) == jt.find_next_ti_sync(ti)


@pytest.mark.parametrize("a0,a1", [(0.1, 0.1001), (0.1, 0.2),
                                   (0.33, 0.5), (0.5, 1.0)])
def test_cosmology_factors_equal(a0, a1):
    jc = JCosmology(Omega0=0.288, OmegaLambda=0.712, OmegaBaryon=0.0472,
                    HubbleParam=0.7, RadiationOn=1)
    tc = TCosmology(Omega0=0.288, OmegaLambda=0.712, OmegaBaryon=0.0472,
                    HubbleParam=0.7, RadiationOn=1)
    jc.init(0.1, j_default_units())
    tc.init(0.1, t_default_units())
    for name in ("exact_drift_factor", "exact_gravkick_factor"):
        ref = getattr(jc, name)(a0, a1)
        got = getattr(tc, name)(a0, a1)
        assert got == pytest.approx(ref, rel=1e-12, abs=0)
    assert tc.hubble_function(a1) == pytest.approx(
        float(jc.hubble_function(a1)), rel=1e-12)


def test_assign_timebins_matches_reference_loop():
    """The vectorized bin assignment equals the JAX package's particle
    loop, on bins that must clamp to active ones and on NaN/inf."""
    jt, tt = _timelines()
    rng = np.random.RandomState(4)
    n = 3000
    for ti_mult in (0, 1, 12, 2 ** 20):
        ti = ti_mult * 2 ** 18
        times_j = jint.DriftKickTimes.init(ti)
        times_j.pm_length = 2 ** 30
        times_t = tint.DriftKickTimes.init(ti)
        times_t.pm_length = 2 ** 30
        dloga = 10 ** rng.uniform(-9, -1, n)
        dloga[:5] = [np.nan, np.inf, 0.0, 1e-30, 1.0]
        old = rng.randint(0, 32, n).astype(np.int8)
        active = rng.rand(n) < 0.8
        # the device criterion is f32 in both packages
        d32 = dloga.astype(np.float32)
        with np.errstate(invalid="ignore"):
            ref, bad_ref = jint.assign_timebins(d32, old, active, times_j,
                                                jt, 1e-8)
        got, bad = tint.assign_timebins(
            torch.from_numpy(d32), torch.from_numpy(old),
            torch.from_numpy(active), times_t, tt, 1e-8)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert bad == bad_ref


def test_convert_particles_exact():
    jpd = jp.ParticleData.zeros(256)
    rng = np.random.RandomState(5)
    ipos = rng.randint(0, 2 ** 32, (256, 3), dtype=np.uint64
                       ).astype(np.uint32)
    d = {f: np.asarray(getattr(jpd, f)) for f in
         jp.ParticleData.__dataclass_fields__}
    d["ipos"] = ipos
    d["vel"] = rng.normal(size=(256, 3)).astype(np.float32)
    d["id_lo"] = rng.randint(0, 2 ** 32, 256, dtype=np.uint64
                             ).astype(np.uint32)
    d["timebin"] = rng.randint(0, 40, 256).astype(np.int8)
    p = convert.particles_from_numpy(d, device="cpu")
    np.testing.assert_array_equal(p.ipos_u32(), ipos)
    np.testing.assert_array_equal(p.vel.numpy(), d["vel"])
    np.testing.assert_array_equal(p.timebin.numpy(), d["timebin"])
    np.testing.assert_array_equal(p.ids64() & 0xFFFFFFFF,
                                  d["id_lo"].astype(np.uint64))


def test_cuda_entry_points_refuse_without_card():
    """Asking for CUDA on a host without a card raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no card"):
        tp.float_to_ipos(_positions(), BOX)


def test_kick_and_predictor_tables_equal():
    """Per-bin half-kick and predictor factor tables: the same host
    float64 integrals, rounded to f32 in both packages."""
    jt, tt = _timelines()
    jc = JCosmology(Omega0=0.288, OmegaLambda=0.712, OmegaBaryon=0.0472,
                    HubbleParam=0.7, RadiationOn=1)
    tc = TCosmology(Omega0=0.288, OmegaLambda=0.712, OmegaBaryon=0.0472,
                    HubbleParam=0.7, RadiationOn=1)
    jc.init(0.05, j_default_units())
    tc.init(0.05, t_default_units())
    ti = 3 * 2 ** 40
    times = []
    for mod in (jint, tint):
        t = mod.DriftKickTimes.init(ti)
        t.ti_kick = [ti - (b % 5) * 2 ** 36 for b in range(len(t.ti_kick))]
        t.pm_kick = ti - 2 ** 39
        times.append(t)
    for jtab, ttab in zip(jint.gravkick_tables(jc, jt, times[0]),
                          tint.gravkick_tables(tc, tt, times[1],
                                               device="cpu")):
        np.testing.assert_array_equal(ttab.numpy(), np.asarray(jtab))
    jp_ = jint.predictor_tables(jc, jt, times[0])
    tp_ = tint.predictor_tables(tc, tt, times[1], device="cpu")
    for jtab, ttab in zip(jp_[:3], tp_[:3]):
        np.testing.assert_array_equal(ttab.numpy(), np.asarray(jtab))
    assert tp_[3] == jp_[3]
