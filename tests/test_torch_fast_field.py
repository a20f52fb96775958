"""genic's `scheme="fast"` Gaussian field in the port against the JAX
package's on the CPU (shenqi_tpu/genic/ic.py gaussian_field: the white
noise of jax.random.normal(PRNGKey(seed), (n, n, n), f32), then rfftn /
n^1.5).

Limits: the uniform that jax.random.normal draws on [nextafter(-1, 0), 1)
bit for bit; the normals within 4 ulp (threefry.erfinv_xla, XLA's f32
erf_inv, against XLA's: FMA contraction apart, the same polynomial); the
field within 1e-5 of max |g| at 32^3, which erfinv's and the FFT's
rounding set (ROADMAP A.12); `unitary` and `invert_phase` as the JAX
package applies them to the port's own field.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from shenqi_tpu.genic.ic import gaussian_field as j_field
from shenqi_tpu_torch.genic.ic import gaussian_field as t_field
from shenqi_tpu_torch.utils import threefry as tf


@pytest.mark.parametrize("seed", [0, 181170])
def test_normal_matches_jax(seed):
    shape = (48, 40, 33)
    jk, tk = jax.random.PRNGKey(seed), tf.PRNGKey(seed)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    ju = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, 1.0))
    tu = tf.uniform(tk, shape)
    tu = torch.clamp(tu * tf._NORMAL_SPAN + tf._NORMAL_LO,
                     min=tf._NORMAL_LO).numpy()
    np.testing.assert_array_equal(tu.view(np.uint32), ju.view(np.uint32))
    jn = np.asarray(jax.random.normal(jk, shape, jnp.float32))
    tn = tf.normal(tk, shape).numpy()
    ulp = np.abs(tn.view(np.int32).astype(np.int64)
                 - jn.view(np.int32).astype(np.int64))
    assert ulp.max() <= 4, ulp.max()
    # a block of rows drawn with the whole shape's counters
    half = tf.normal(tk, (24, 40, 33), start=24 * 40 * 33).numpy()
    np.testing.assert_array_equal(half, tn[24:])


def test_erfinv_xla_matches_lax():
    """XLA's f32 erf_inv over (-1, 1) and at its ends, where torch's
    erfinv lies up to ~80 ulp away in the tails."""
    x = np.concatenate([
        np.random.default_rng(3).uniform(-1, 1, 200000),
        np.linspace(-1.0, 1.0, 20001),
        [np.nextafter(np.float32(1.0), np.float32(0.0)), 0.0]]
    ).astype(np.float32)
    j = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    t = tf.erfinv_xla(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isinf(t), np.isinf(j))
    fin = np.isfinite(j)
    ulp = np.abs(t[fin].view(np.int32).astype(np.int64)
                 - j[fin].view(np.int32).astype(np.int64))
    assert ulp.max() <= 4, ulp.max()


@pytest.mark.parametrize("seed", [7, 2 ** 31 - 1])
def test_fast_field_matches_jax(seed):
    n = 32
    j = np.asarray(j_field(seed, n, scheme="fast"))
    t = t_field(seed, n, scheme="fast", device="cpu")
    assert t.dtype == np.complex64 and t.shape == (n, n, n // 2 + 1)
    assert np.abs(t - j).max() < 1e-5 * np.abs(j).max()
    # the unit modes and the paired field, from the port's own field
    u = t_field(seed, n, unitary=True, scheme="fast", device="cpu")
    amp = np.abs(t)
    np.testing.assert_allclose(u, t / np.where(amp > 0, amp, 1.0),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        t_field(seed, n, invert_phase=True, scheme="fast", device="cpu"),
        -t)
