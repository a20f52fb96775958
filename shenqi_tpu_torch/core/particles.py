"""Structure-of-arrays particle state: the DM fields of
shenqi_tpu/core/particles.py as a dataclass of torch tensors.

Positions are uint32 fixed point (the box maps onto the full uint32
range, so periodic wrapping is integer overflow and the minimum-image
separation is the wrapped difference read as int32).  Torch has no
uint32 subtract, shift or compare, so the port stores the same 32 bits
as int32 BIT PATTERNS and does every operation that depends on the
unsigned value in int64:

  * `u32(x)`: the unsigned value, `x.long() & 0xFFFFFFFF`;
  * `wrap_i32(v)`: an int64 value brought back into int32 range
    modulo 2^32 (what a uint32 add or subtract does);
  * `lshr(x, s)`: the logical right shift (int32 `>>` is arithmetic).

IDs are two uint32 words (lo, hi), also stored as int32 bit patterns.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device

# particle types, matching the reference convention
GAS, DM, NU, UNUSED3, STAR, BH = 0, 1, 2, 3, 4, 5
NTYPES = 6

POS_SCALE = 2.0 ** 32  # integer units across one box length

_MASK32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """Unsigned value of int32 bit patterns, as int64."""
    return x.long() & _MASK32


def wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 bit pattern of v modulo 2^32."""
    v = v & _MASK32
    return (v - ((v >> 31) << 32)).to(torch.int32)


def lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns (int64 result)."""
    return u32(x) >> s


def u32_numpy_to_i32(a: np.ndarray) -> np.ndarray:
    """uint32 numpy array -> the same bits as int32 (no copy)."""
    return np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)


def float_to_ipos(pos, boxsize, device=None) -> torch.Tensor:
    """Map float positions [0, box) -> uint32 fixed point, returned as an
    int32 bit-pattern tensor on `device`.  The host arithmetic (float64)
    is the JAX package's, so the bits are identical."""
    frac = np.asarray(pos, dtype=np.float64) / boxsize
    frac = frac - np.floor(frac)
    bits = (frac * POS_SCALE).astype(np.int64).astype(np.uint32)
    return torch.from_numpy(u32_numpy_to_i32(bits).copy()).to(
        resolve_device(device))


def ipos_to_float(ipos: torch.Tensor, boxsize,
                  dtype=torch.float32) -> torch.Tensor:
    """uint32 fixed point -> float positions in [0, box).  int64 -> f32
    rounds to nearest like uint32 -> f32, so this is bit-exact."""
    return u32(ipos).to(dtype) * (boxsize / POS_SCALE)


def ipos_delta(ipos_a: torch.Tensor, ipos_b: torch.Tensor, boxsize,
               dtype=torch.float32) -> torch.Tensor:
    """Minimum-image separation a-b as float: exact via the wrapped
    int32 difference."""
    d = wrap_i32(ipos_a.long() - ipos_b.long())
    return d.to(dtype) * float(np.asarray(boxsize / POS_SCALE, np.float32))


@dataclass
class ParticleData:
    """Base per-particle fields of the DM slice (capacity-N tensors;
    aliveness via `mask`)."""

    ipos: torch.Tensor        # [N,3] int32 bits of uint32 fixed point
    vel: torch.Tensor         # [N,3] f32 velocity (internal units)
    mass: torch.Tensor        # [N]   f32
    ptype: torch.Tensor       # [N]   int8
    mask: torch.Tensor        # [N]   bool — slot alive?
    id_lo: torch.Tensor       # [N]   int32 bits of the uint32 low word
    id_hi: torch.Tensor       # [N]   int32 bits of the uint32 high word
    timebin: torch.Tensor     # [N]   int8 — current timestep bin
    hsml: torch.Tensor        # [N]   f32
    grav_pm: torch.Tensor     # [N,3] f32 long-range (PM) acceleration
    grav_accel: torch.Tensor  # [N,3] f32 short-range acceleration
    potential: torch.Tensor   # [N]   f32
    old_acc: torch.Tensor     # [N]   f32 |acc|/G of the previous step

    @property
    def n(self) -> int:
        return self.ipos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.ipos.device

    @classmethod
    def zeros(cls, n: int, device=None) -> "ParticleData":
        dev = resolve_device(device)

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return cls(
            ipos=z(n, 3, dtype=torch.int32), vel=z(n, 3), mass=z(n),
            ptype=z(n, dtype=torch.int8), mask=z(n, dtype=torch.bool),
            id_lo=z(n, dtype=torch.int32), id_hi=z(n, dtype=torch.int32),
            timebin=z(n, dtype=torch.int8), hsml=z(n), grav_pm=z(n, 3),
            grav_accel=z(n, 3), potential=z(n), old_acc=z(n))

    def replace(self, **kw) -> "ParticleData":
        return dataclasses.replace(self, **kw)

    def ids64(self) -> np.ndarray:
        """Recombine the id words on the host as uint64."""
        lo = self.id_lo.cpu().numpy().view(np.uint32).astype(np.uint64)
        hi = self.id_hi.cpu().numpy().view(np.uint32).astype(np.uint64)
        return (hi << np.uint64(32)) | lo

    def ipos_u32(self) -> np.ndarray:
        """Positions as a host uint32 array (the JAX package's layout)."""
        return self.ipos.cpu().numpy().view(np.uint32)
