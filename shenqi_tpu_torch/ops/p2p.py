"""The short-range pair kernel: `p2p_blocked` (CUDA, csrc/p2p.cu) and its
plain PyTorch version `p2p_blocked_reference`.

Both compute the function of the TPU kernel shenqi_tpu/ops/pallas_p2p.py
(`p2p_blocked`, body `_make_kernel`): for each of nb target blocks,
`blk` targets against that block's S packed source lanes (zero mass
marks padding), the minimum-image separation from the wrapped uint32
difference, the cubic-spline softened force factor with one rsqrt, the
Chebyshev short-range window by Clenshaw, and optionally the potential.

`p2p_blocked` launches the kernel for CUDA tensors and takes the plain
version only for tensors that lie on the CPU.  `p2p_blocked.launches`
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..core.particles import POS_SCALE, wrap_i32
from ..gravity.shortrange import PolyWindow, clenshaw, host_coeffs

BLK = 128            # default targets per block
SCH = 512            # source-lane granularity S must be a multiple of
MAX_BLK = 256        # the kernel's largest target block
MAX_COEF = 64        # the kernel's Chebyshev coefficient limit


def _scalars(boxsize, softening, cellsize, window: PolyWindow, G):
    """The kernel's f32 scalars, rounded as the JAX package rounds them:
    inv_cellxmax = 1 / (f32(cellsize) * f32(xmax)) in f32."""
    to_f = np.float32(boxsize / POS_SCALE)
    soft = np.float32(softening)
    inv_cellxmax = np.float32(1.0) / (np.float32(cellsize)
                                      * np.float32(window.xmax))
    return to_f, soft, np.float32(inv_cellxmax), np.float32(G)


def p2p_flops_per_pair(ncf: int, ncp: int = 0, want_pot: bool = False):
    """f32 operations of one non-padding, non-softened pair inside the
    window range, as csrc/p2p.cu evaluates it (an FMA counts 2, a
    compare, select, convert or rsqrt 1): padding test 1, separation
    9 (3 integer subtracts, 3 converts, 3 multiplies), r^2 5, rsqrt
    with its test and select 3, r and rinv^3 3, u 1, softening test 1,
    Newtonian factor 1, x and its test 2, t with clamp 4, Clenshaw
    1 + 3 per term beyond the first + 3, window clamp 2, force factor
    1, accumulation 6.  The potential adds its Clenshaw, clamp,
    factor 2 and accumulation 2."""
    def cl(n):
        return 1 + 3 * (n - 1) + 3

    n = 1 + 9 + 5 + 3 + 3 + 1 + 1 + 1 + 2 + 4 + cl(ncf) + 2 + 1 + 6
    if want_pot:
        n += cl(ncp) + 2 + 2 + 2
    return n


def p2p_flops_outside_window() -> int:
    """f32 operations of one non-padding pair past the window range
    (x >= 1), where the window is 0 and the pair adds nothing, with or
    without the potential: padding test 1, separation 9, r^2 5, rsqrt
    with its test and select 3, r 1, x and its test 2."""
    return 1 + 9 + 5 + 3 + 1 + 2


def p2p_blocked_reference(tgt_ipos, src_ipos, src_mass, boxsize,
                          softening, cellsize, window: PolyWindow, G,
                          want_pot: bool = True, sch: int = SCH,
                          blk: int = BLK):
    """Plain PyTorch version of the kernel, on any device.

    tgt_ipos [nb, blk, 3] int32 bits; src_ipos [nb, S, 3] int32 bits
    with S % sch == 0; src_mass [nb, S] f32 (zero for padding lanes).
    Returns (acc [nb, blk, 3], pot [nb, blk] or None), G-multiplied.
    Blocks are taken in chunks of about 2^22 pairs to bound memory; like
    the kernel, it skips what only padding lanes would add (blocks with
    no source mass, and lanes past a chunk's last massive one).
    """
    nb, S = src_mass.shape
    assert S % sch == 0, (S, sch)
    to_f, soft, inv_cellxmax, g = (float(v) for v in _scalars(
        boxsize, softening, cellsize, window, G))
    cf = host_coeffs(window.cf)
    cp = host_coeffs(window.cp) if want_pot else None
    dev = src_mass.device
    acc = torch.zeros((nb, blk, 3), dtype=torch.float32, device=dev)
    pot = torch.zeros((nb, blk), dtype=torch.float32, device=dev)
    hinv = float(np.float32(1.0) / np.float32(soft))
    h3i = float(np.float32(hinv) * np.float32(hinv) * np.float32(hinv))
    soft2 = float(np.float32(soft) * np.float32(soft))
    step = max(1, (1 << 22) // max(blk * S, 1))
    for lo in range(0, nb, step):
        m = src_mass[lo:lo + step]
        rows = torch.nonzero((m != 0).any(1)).flatten()
        if rows.numel() == 0:
            continue
        cols = torch.nonzero((m[rows] != 0).any(0)).flatten()
        s_eff = int(cols[-1]) + 1
        rows = rows + lo
        t = tgt_ipos[rows].long()[:, :, None, :]           # [c,blk,1,3]
        s = src_ipos[rows, :s_eff].long()[:, None, :, :]   # [c,1,S',3]
        m = src_mass[rows, :s_eff][:, None, :]             # [c,1,S']
        d = wrap_i32(s - t).to(torch.float32) * to_f       # [c,blk,S,3]
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        r2 = dx * dx + dy * dy + dz * dz
        rinv = torch.where(r2 > 0, torch.rsqrt(r2), 0.0)
        r = r2 * rinv
        rinv3 = rinv * rinv * rinv
        u = r * hinv
        insoft = r2 < soft2
        fin = m * h3i * (10.666666666667 + u * u * (32.0 * u - 38.4))
        fout = (m * h3i * (21.333333333333 - 48.0 * u + 38.4 * u * u
                           - 10.666666666667 * u * u * u)
                - 0.066666666667 * m * rinv3)
        fac = torch.where(insoft, torch.where(u < 0.5, fin, fout),
                          m * rinv3)
        x = r * inv_cellxmax
        tt = torch.clamp(2.0 * x - 1.0, -1.0, 1.0)
        inrange = x < 1.0
        fw = torch.where(inrange, torch.clamp(clenshaw(tt, cf), 0.0, 1.0),
                         0.0)
        fall = fac * fw
        acc[rows] = torch.stack([(dx * fall).sum(-1), (dy * fall).sum(-1),
                                 (dz * fall).sum(-1)], dim=-1) * g
        if want_pot:
            wpi = -2.8 + u * u * (5.333333333333 + u * u * (6.4 * u - 9.6))
            wpo = (-3.2 + u * u * (10.666666666667
                                   + u * (-16.0 + u * (9.6
                                          - 2.133333333333 * u))))
            fpot = torch.where(
                insoft,
                m * hinv * torch.where(u < 0.5, wpi, wpo)
                + torch.where(u < 0.5, 0.0, 0.066666666667 * m * rinv),
                -m * rinv)
            pw = torch.where(inrange,
                             torch.clamp(clenshaw(tt, cp), 0.0, 1.0), 0.0)
            pot[rows] = (fpot * pw).sum(-1) * g
    return acc, (pot if want_pot else None)


@lru_cache(maxsize=None)
def _lib():
    """csrc/p2p.cu, built on first use, with its C signatures set."""
    from .._build import load_library
    lib = load_library("p2p")
    f = lib.shenqi_p2p_blocked
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    f.argtypes = [P, P, P, P, I, P, I, P, P, I, I, I, F, F, F, F, I, I, P]
    f.restype = I
    lib.shenqi_p2p_instantiation.argtypes = [I, I, I]
    lib.shenqi_p2p_instantiation.restype = I
    lib.shenqi_cuda_error_string.argtypes = [I]
    lib.shenqi_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_instantiation(window: PolyWindow, want_pot: bool) -> str:
    """Which instantiation of csrc/p2p.cu serves this window: the one
    with the degree compiled in (coefficients in registers), or the
    run-time-degree one.  Builds the library; needs the CUDA toolkit."""
    nc = _lib().shenqi_p2p_instantiation(window.cf.shape[0],
                                         window.cp.shape[0], int(want_pot))
    return f"degree {nc - 1} compiled in" if nc else "run-time degree"


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"p2p_blocked: {name} on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"p2p_blocked: {name} is {t.dtype}, "
                        f"expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"p2p_blocked: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"p2p_blocked: {name} is not contiguous")


def p2p_blocked(tgt_ipos, src_ipos, src_mass, boxsize, softening,
                cellsize, window: PolyWindow, G, want_pot: bool = True,
                sch: int = SCH, blk: int = BLK):
    """Fused pair interaction over pre-packed per-block source tables
    (the signature of the JAX package's p2p_blocked, without
    `interpret`).

    tgt_ipos [nb, blk, 3] int32 bits; src_ipos [nb, S, 3] int32 bits
    with S % sch == 0; src_mass [nb, S] f32 (zero for padding lanes).
    Returns (acc [nb, blk, 3], pot [nb, blk] or None), G-multiplied.
    CUDA tensors launch csrc/p2p.cu; CPU tensors take the plain version.
    """
    if tgt_ipos.device.type == "cpu":
        return p2p_blocked_reference(tgt_ipos, src_ipos, src_mass,
                                     boxsize, softening, cellsize, window,
                                     G, want_pot=want_pot, sch=sch,
                                     blk=blk)
    dev = tgt_ipos.device
    if dev.type != "cuda":
        raise ValueError(f"p2p_blocked: unsupported device {dev}")
    nb, S = src_mass.shape
    if S % sch:
        raise ValueError(f"p2p_blocked: S={S} is not a multiple of {sch}")
    if not 1 <= blk <= MAX_BLK:
        raise ValueError(f"p2p_blocked: blk={blk} outside 1..{MAX_BLK}")
    _check("tgt_ipos", tgt_ipos, torch.int32, (nb, blk, 3), dev)
    _check("src_ipos", src_ipos, torch.int32, (nb, S, 3), dev)
    _check("src_mass", src_mass, torch.float32, (nb, S), dev)
    cf, cp = window.cf, window.cp
    _check("window.cf", cf, torch.float32, (cf.shape[0],), dev)
    _check("window.cp", cp, torch.float32, (cp.shape[0],), dev)
    if not (1 <= cf.shape[0] <= MAX_COEF and 1 <= cp.shape[0] <= MAX_COEF):
        raise ValueError("p2p_blocked: window degree above the kernel's "
                         f"{MAX_COEF} coefficients")
    acc = torch.empty((nb, blk, 3), dtype=torch.float32, device=dev)
    pot = torch.empty((nb, blk), dtype=torch.float32, device=dev) \
        if want_pot else None
    if nb == 0:
        return acc, pot
    to_f, soft, inv_cellxmax, g = _scalars(boxsize, softening, cellsize,
                                           window, G)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.shenqi_p2p_blocked(
        tgt_ipos.data_ptr(), src_ipos.data_ptr(), src_mass.data_ptr(),
        cf.data_ptr(), cf.shape[0], cp.data_ptr(), cp.shape[0],
        acc.data_ptr(), pot.data_ptr() if want_pot else None,
        nb, blk, S, float(to_f), float(soft), float(inv_cellxmax),
        float(g), int(want_pot), dev.index if dev.index is not None
        else torch.cuda.current_device(), stream)
    if rc != 0:
        msg = lib.shenqi_cuda_error_string(rc).decode()
        raise RuntimeError(f"p2p_blocked: kernel launch failed: "
                           f"CUDA error {rc} ({msg})")
    p2p_blocked.launches += 1
    return acc, pot


p2p_blocked.launches = 0
