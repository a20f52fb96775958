"""Morton (Z-order) keys from fixed-point positions
(shenqi_tpu/ops/morton.py in torch).

Keys are 30 bits (10 per dimension).  Positions are int32 bit patterns
of uint32 (core/particles.py), so every shift here is taken in int64:
int32 `>>` is arithmetic and would smear the sign bit into the key.
Keys are returned as int64 tensors holding the uint32 key value.
"""

from __future__ import annotations

import torch

from ..core.particles import lshr, u32

MORTON_BITS = 10            # bits per dimension
MAX_DEPTH = MORTON_BITS


def _expand_bits10(v):
    """Spread the low 10 bits of v so there are 2 zeros between bits."""
    v = v.long() & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _compact_bits10(v):
    """Inverse of _expand_bits10."""
    v = v.long() & 0x09249249
    v = (v | (v >> 2)) & 0x030C30C3
    v = (v | (v >> 4)) & 0x0300F00F
    v = (v | (v >> 8)) & 0x030000FF
    v = (v | (v >> 16)) & 0x3FF
    return v


def morton_key(ipos) -> torch.Tensor:
    """30-bit Morton key from fixed-point positions [N,3].  Takes the
    top 10 bits of each coordinate; x is the most significant axis."""
    top = lshr(ipos, 32 - MORTON_BITS)
    kx = _expand_bits10(top[:, 0])
    ky = _expand_bits10(top[:, 1])
    kz = _expand_bits10(top[:, 2])
    return (kx << 2) | (ky << 1) | kz


def morton_key_pair(ipos):
    """60-bit Morton key as two 30-bit words (hi, lo) [N]: hi
    interleaves bits 31..22 of each coordinate, lo bits 21..12.  Bits
    above the 10 kept by _expand_bits10 drop out as in the JAX
    package."""
    hi = morton_key(ipos)
    mid = lshr(ipos, 32 - 2 * MORTON_BITS)
    kx = _expand_bits10(mid[:, 0])
    ky = _expand_bits10(mid[:, 1])
    kz = _expand_bits10(mid[:, 2])
    lo = (kx << 2) | (ky << 1) | kz
    return hi, lo


def key_pair_prefix(hi, lo, level: int):
    """(prefix_hi, prefix_lo) identifying the level-`level` cell."""
    if level <= MAX_DEPTH:
        return u32(hi) >> (3 * (MAX_DEPTH - level)), torch.zeros_like(lo)
    return hi, u32(lo) >> (3 * (2 * MAX_DEPTH - level))


def key_to_cell(key, level: int):
    """Decode a Morton key prefix at `level` into integer cell coords
    [N,3] int32 in [0, 2^level)."""
    pref = u32(key) >> (3 * (MAX_DEPTH - level))
    x = _compact_bits10(pref >> 2)
    y = _compact_bits10(pref >> 1)
    z = _compact_bits10(pref)
    return torch.stack([x, y, z], dim=-1).to(torch.int32)


def key_pair_to_cell(hi, lo, level: int):
    """Decode a (hi, lo) pair into integer cell coords at `level`."""
    if level <= MAX_DEPTH:
        return key_to_cell(hi, level)
    chi = key_to_cell(hi, MAX_DEPTH)
    clo = key_to_cell(lo, level - MAX_DEPTH)
    return (chi << (level - MAX_DEPTH)) + clo
