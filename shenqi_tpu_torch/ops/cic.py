"""Cloud-in-cell mass assignment and readout on a periodic mesh
(shenqi_tpu/ops/cic.py:20-140 in torch).

Deposit is one accumulating `index_put_` over the 8 cell corners,
readout 8 gathers.  The accumulation order differs from XLA's (and is
not fixed under CUDA atomics), so the mesh agrees with the JAX one to
float32 rounding, not bitwise.
"""

from __future__ import annotations

import torch

from ..core.particles import POS_SCALE, u32


def _cell_coords(ipos: torch.Tensor, nmesh: int):
    """Fixed-point positions -> (base cell index [N,3] int64, fraction
    [N,3] f32).  The int32 bit patterns are read as unsigned (2^32 is
    added to negative values) before the f32 conversion."""
    x = u32(ipos).to(torch.float32) * (nmesh / POS_SCALE)
    i0 = torch.floor(x)
    frac = x - i0
    i0 = i0.long()
    # guard the pathological x == nmesh rounding case
    i0 = torch.where(i0 >= nmesh, nmesh - 1, i0)
    return i0, frac


def _corners(i0, f, nmesh: int):
    """Yield (flat mesh index [N], weight [N]) for the 8 CIC corners,
    in the JAX package's (dx, dy, dz) order."""
    for dx in (0, 1):
        wx = (1.0 - f[:, 0]) if dx == 0 else f[:, 0]
        ix = (i0[:, 0] + dx) % nmesh
        for dy in (0, 1):
            wy = (1.0 - f[:, 1]) if dy == 0 else f[:, 1]
            iy = (i0[:, 1] + dy) % nmesh
            for dz in (0, 1):
                wz = (1.0 - f[:, 2]) if dz == 0 else f[:, 2]
                iz = (i0[:, 2] + dz) % nmesh
                yield (ix * nmesh + iy) * nmesh + iz, wx, wy, wz


def cic_deposit(ipos, weights, nmesh: int, mask=None) -> torch.Tensor:
    """Deposit `weights` onto an [nmesh]^3 f32 mesh with CIC.
    Masked-out particles deposit nothing."""
    i0, f = _cell_coords(ipos, nmesh)
    w = weights.to(torch.float32)
    if mask is not None:
        w = torch.where(mask, w, 0.0)
    idx, val = [], []
    for flat, wx, wy, wz in _corners(i0, f, nmesh):
        idx.append(flat)
        val.append(w * wx * wy * wz)
    mesh = torch.zeros(nmesh ** 3, dtype=torch.float32, device=w.device)
    mesh.index_put_((torch.cat(idx),), torch.cat(val), accumulate=True)
    return mesh.view(nmesh, nmesh, nmesh)


def cic_readout(mesh, ipos, mask=None) -> torch.Tensor:
    """Interpolate mesh values back to particle positions with CIC."""
    nmesh = mesh.shape[0]
    i0, f = _cell_coords(ipos, nmesh)
    flat_mesh = mesh.reshape(-1)
    out = torch.zeros(ipos.shape[0], dtype=torch.float32,
                      device=mesh.device)
    for flat, wx, wy, wz in _corners(i0, f, nmesh):
        out = out + flat_mesh[flat] * (wx * wy * wz)
    if mask is not None:
        out = torch.where(mask, out, 0.0)
    return out


def _slab_corners(i0, f, nmesh: int, relx):
    """(dx, dy, dz) corners on an x-slab buffer: x plane relx + dx of the
    buffer, y and z periodic; flat index into [nbuf, N, N]."""
    for dx in (0, 1):
        wx = (1.0 - f[:, 0]) if dx == 0 else f[:, 0]
        ix = relx + dx
        for dy in (0, 1):
            wy = (1.0 - f[:, 1]) if dy == 0 else f[:, 1]
            iy = (i0[:, 1] + dy) % nmesh
            for dz in (0, 1):
                wz = (1.0 - f[:, 2]) if dz == 0 else f[:, 2]
                iz = (i0[:, 2] + dz) % nmesh
                yield (ix * nmesh + iy) * nmesh + iz, wx, wy, wz


def _slab_rel(i0, nmesh: int, nbuf: int, halo: int, x0: int):
    """Buffer plane of each base cell and whether both CIC planes lie in
    the buffer."""
    relx = torch.remainder(i0[:, 0] - (x0 - halo), nmesh)
    inbuf = relx < nbuf - 1
    return torch.where(inbuf, relx, 0), inbuf


def cic_deposit_slab(ipos, weights, nmesh: int, nloc: int, halo: int,
                     x0: int, mask=None) -> torch.Tensor:
    """CIC deposit into an x-slab buffer [nloc + 2 halo, N, N] covering
    the global planes [x0 - halo, x0 + nloc + halo) mod N
    (shenqi_tpu/ops/cic.py:56-89): the per-rank region deposit of
    petapm.cpp:79-87, whose boundary planes the caller then ships to
    their owners.  Rows whose planes fall outside deposit nothing."""
    i0, f = _cell_coords(ipos, nmesh)
    w = weights.to(torch.float32)
    if mask is not None:
        w = torch.where(mask, w, 0.0)
    nbuf = nloc + 2 * halo
    relx, inbuf = _slab_rel(i0, nmesh, nbuf, halo, x0)
    w = torch.where(inbuf, w, 0.0)
    idx, val = [], []
    for flat, wx, wy, wz in _slab_corners(i0, f, nmesh, relx):
        idx.append(flat)
        val.append(w * wx * wy * wz)
    buf = torch.zeros(nbuf * nmesh * nmesh, dtype=torch.float32,
                      device=w.device)
    buf.index_put_((torch.cat(idx),), torch.cat(val), accumulate=True)
    return buf.view(nbuf, nmesh, nmesh)


def cic_readout_slab(buf, ipos, nmesh: int, halo: int, x0: int,
                     mask=None) -> torch.Tensor:
    """Interpolate from an extended x-slab buffer laid out as
    cic_deposit_slab's (shenqi_tpu/ops/cic.py:92-117)."""
    nbuf = buf.shape[0]
    i0, f = _cell_coords(ipos, nmesh)
    relx, inbuf = _slab_rel(i0, nmesh, nbuf, halo, x0)
    flat_buf = buf.reshape(-1)
    out = torch.zeros(ipos.shape[0], dtype=torch.float32, device=buf.device)
    for flat, wx, wy, wz in _slab_corners(i0, f, nmesh, relx):
        out = out + flat_buf[flat] * (wx * wy * wz)
    out = torch.where(inbuf, out, 0.0)
    if mask is not None:
        out = torch.where(mask, out, 0.0)
    return out
