"""The port's threefry2x32 stream (shenqi_tpu_torch/utils/threefry.py)
against jax.random (threefry, `jax_threefry_partitionable` on): the
split chain from PRNGKey(42) over 64 steps, split into three, the scalar
bits of a key, and `bits` and `uniform` of shape (300, 17), the latter
also drawn a block of rows at a time, and `randint` over 300 keys: all
bit-identical."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from shenqi_tpu_torch.utils import threefry as tf


def _key(k):
    return tuple(int(x) for x in np.asarray(k).tolist())


def test_partitionable_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 42, 181170, 2 ** 31 - 1])
def test_split_chain(seed):
    jk, tk = jax.random.PRNGKey(seed), tf.PRNGKey(seed)
    assert _key(jk) == tk
    for _ in range(64):
        jk, jsub = jax.random.split(jk)
        tk, tsub = tf.split(tk)
        assert (_key(jk), _key(jsub)) == (tk, tsub)
    assert [_key(k) for k in jax.random.split(jk, 3)] == tf.split(tk, 3)


def test_bits_and_uniform():
    jk, tk = jax.random.PRNGKey(42), tf.PRNGKey(42)
    for _ in range(5):
        jk, _ = jax.random.split(jk)
        tk, _ = tf.split(tk)
    assert int(jax.random.bits(jk, dtype=jnp.uint32)) == tf.bits(tk)
    jb = np.asarray(jax.random.bits(jk, (300, 17), "uint32"))
    np.testing.assert_array_equal(tf.bits(tk, (300, 17)).numpy(),
                                  jb.astype(np.int64))
    ju = np.asarray(jax.random.uniform(jk, (300, 17)))
    tu = tf.uniform(tk, (300, 17))
    assert tu.dtype == torch.float32
    np.testing.assert_array_equal(tu.numpy().view(np.int32),
                                  ju.view(np.int32))
    # block by block with the whole shape's counters
    blocks = [tf.uniform(tk, (min(64, 300 - r), 17), start=r * 17)
              for r in range(0, 300, 64)]
    np.testing.assert_array_equal(torch.cat(blocks).numpy().view(np.int32),
                                  ju.view(np.int32))


def test_mulmod32():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, 10000, dtype=np.uint64)
    b = rng.integers(0, 2 ** 32, 10000, dtype=np.uint64)
    want = (a * b) & np.uint64(0xFFFFFFFF)      # uint64 wraps mod 2^64
    got = tf.mulmod32(torch.from_numpy(a.astype(np.int64)),
                      torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def jax_randint(key, lo, hi):
    """jax.random.randint(key, (), lo, hi).  With x64 off JAX 0.9 refuses
    the Python int 2**31 as an int32 argument (OverflowError), so the
    JAX package's helium_step (simulation_gas.py:1100-1101) cannot run
    as written; a uint32 maxval runs `_randint` itself, which clips
    2**31 to the int32 maximum and widens the span by one."""
    if hi == 2 ** 31:
        hi = np.uint32(hi)
    return int(jax.random.randint(key, (), lo, hi))


def test_randint_python_2_31_overflows():
    with pytest.raises(OverflowError):
        jax.random.randint(jax.random.PRNGKey(0), (), 0, 2 ** 31)


@pytest.mark.parametrize("lo,hi", [(0, 2 ** 31), (0, 1000), (-7, 2 ** 31 - 1),
                                   (5, 5)])
def test_randint(lo, hi):
    """jax.random.randint(key, (), lo, hi) over 300 keys of the split
    chain from PRNGKey(42): bit-identical (helium's QSO bubble seed is
    randint(next_key(), (), 0, 2**31))."""
    jk, tk = jax.random.PRNGKey(42), tf.PRNGKey(42)
    for _ in range(300):
        jk, jsub = jax.random.split(jk)
        tk, tsub = tf.split(tk)
        assert jax_randint(jsub, lo, hi) == tf.randint(tsub, lo, hi)
