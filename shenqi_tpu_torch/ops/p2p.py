"""The short-range pair kernel: `p2p_blocked` (CUDA, csrc/p2p.cu) and its
plain PyTorch version `p2p_blocked_reference`.

Both compute the function of the TPU kernel shenqi_tpu/ops/pallas_p2p.py
(`p2p_blocked`, body `_make_kernel`): for each of nb target blocks,
`blk` targets against that block's S packed source lanes (zero mass
marks padding), the minimum-image separation from the wrapped uint32
difference, the cubic-spline softened force factor with one rsqrt, the
short-range window, and optionally the potential.  The window is the
Chebyshev fit of the calibrated window by Clenshaw (`PolyWindow`, the
TPU kernel's) or the analytic erfc form (`ErfcWindow`,
ShortRangeForceWindowType erfc, which the JAX package evaluates in its
XLA pair pass instead: shenqi_tpu/gravity/stencil.py `pair_accum` with
`_pair_fac_any`).

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
from ..gravity.shortrange import (ErfcWindow, PolyWindow, erfc_window,
                                  host_coeffs, poly_window)

BLK = 128            # default targets per block
SCH = 512            # source-lane granularity S must be a multiple of
MAX_BLK = 256        # the kernel's largest target block
MAX_COEF = 64        # the kernel's Chebyshev coefficient limit

# The erfc window's instructions per pair beyond the separation, the
# spline and the sums, opcode by opcode, in the SASS of nvcc 12.9 for
# sm_90a (tools/torch_erfc_sass.py: a probe kernel per window output,
# less an identity kernel; chip_smoke.py's build phase counts them again
# and fails if they differ): u = x ku, erfcf(u), the Gaussian term and
# its sum for the force.  The potential window is erfcf(u) again, which
# the compiler shares, so it adds none.
ERFC_FORCE_SASS = {
    "FADD": 7, "FFMA": 23, "FFMA.RM": 1, "FFMA.SAT": 1, "FMUL": 11,
    "FRND.TRUNC": 1, "FSEL": 1, "FSETP.GEU.AND": 1, "FSETP.GT.AND": 2,
    "HFMA2.MMA": 2, "LOP3.LUT": 2, "MOV": 2, "MUFU.EX2": 2, "MUFU.RCP": 2,
    "NOP": 3, "SHF.L.U32": 2, "ULDC": 1}
ERFC_POT_SASS = {}
# no operation: padding, register moves and constant loads (HFMA2.MMA
# writes a constant into a register)
SASS_MOVES = ("NOP", "MOV", "IMAD.MOV", "HFMA2.MMA", "ULDC", "LDC")


def sass_work(opcodes):
    """The opcodes of a SASS count that do work: all but SASS_MOVES."""
    return {op: n for op, n in opcodes.items()
            if not any(op == m or op.startswith(m + ".")
                       for m in SASS_MOVES)}


def sass_tally(opcodes):
    """(operations with an FFMA counted 2, FFMAs, MUFU instructions) of
    a SASS count.  Every instruction of sass_work counts: for the erfc
    force window 25 FFMA (2 each), 4 MUFU (EX2 2, RCP 2), 23 other f32
    instructions (FADD 7, FMUL 11, FSETP 3, FSEL 1, FRND 1) and 4
    integer ones (LOP3 2, SHF 2: expf's exponent scaling), priced as f32
    operations too: 81 operations."""
    ops = sass_work(opcodes)
    ffma = sum(n for op, n in ops.items() if op.split(".")[0] == "FFMA")
    mufu = sum(n for op, n in ops.items() if op.split(".")[0] == "MUFU")
    return sum(ops.values()) + ffma, ffma, mufu


# (operations, FFMAs, MUFU) of the force window and of what the
# potential window adds: (81, 25, 4) and (0, 0, 0)
ERFC_FORCE = sass_tally(ERFC_FORCE_SASS)
ERFC_POT = sass_tally(ERFC_POT_SASS)


def _scalars(boxsize, softening, cellsize, window, G):
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


def _erfc_ku(window: ErfcWindow):
    """u = x * ku for x = r / (cell xmax): ku = xmax * 0.5 / asmth, f32."""
    return np.float32(window.xmax * 0.5 / window.asmth)


def p2p_erfc_flops_per_pair(want_pot: bool = False):
    """f32 operations of one non-padding, non-softened pair inside the
    window range with the erfc window, as csrc/p2p.cu evaluates it: the
    Chebyshev tally's pair without its window (padding test 1,
    separation 9, r^2 5, rsqrt 3, r and rinv^3 3, u 1, softening test 1,
    Newtonian factor 1, x and its test 2, force factor 1, accumulation
    6) and the erfc force window of ERFC_FORCE (SASS-counted, an FMA
    counts 2); the potential adds ERFC_POT's window, factor 2 and
    accumulation 2."""
    n = 1 + 9 + 5 + 3 + 3 + 1 + 1 + 1 + 2 + 1 + 6 + ERFC_FORCE[0]
    if want_pot:
        n += ERFC_POT[0] + 2 + 2
    return n


def pair_counts(window, want_pot: bool):
    """(f32 operations, FMAs among them, MUFU and convert instructions
    among them) of one live pair inside the window range, for the
    window's instantiation: the issue floor's tally (chip_smoke.py).
    FMAs of the common part: r^2 2, accumulation 3 (the potential's 1);
    of the Chebyshev window: t 1 and one per Clenshaw term.  The 3
    converts and the rsqrt go to the MUFU pipe."""
    if isinstance(window, ErfcWindow):
        ops = p2p_erfc_flops_per_pair(want_pot)
        fmas = 5 + ERFC_FORCE[1] + ((ERFC_POT[1] + 1) if want_pot else 0)
        xu = 4 + ERFC_FORCE[2] + (ERFC_POT[2] if want_pot else 0)
        return ops, fmas, xu
    ncf, ncp = window.cf.shape[0], window.cp.shape[0]
    ops = p2p_flops_per_pair(ncf, ncp, want_pot)
    return ops, 6 + ncf + (ncp + 1 if want_pot else 0), 4


def p2p_flops_outside_window() -> int:
    """f32 operations of one non-padding pair past the window range
    (x >= 1), where the window is 0 and the pair adds nothing, with or
    without the potential: padding test 1, separation 9, r^2 5, rsqrt
    with its test and select 3, r 1, x and its test 2."""
    return 1 + 9 + 5 + 3 + 1 + 2


def _window_fn(window, want_pot: bool):
    """The window at x = r / (cell xmax), its argument formed as the
    kernel forms it (u = x ku for erfc, t = 2x - 1 for the Chebyshev
    fits), by gravity/shortrange's erfc_window or poly_window: x ->
    (force window, potential window or None), zero for x >= 1."""
    if isinstance(window, ErfcWindow):
        ku = float(_erfc_ku(window))

        def win(x):
            return erfc_window(x * ku, want_pot)
    elif isinstance(window, PolyWindow):
        cf = host_coeffs(window.cf)
        cp = host_coeffs(window.cp) if want_pot else None

        def win(x):
            return poly_window(2.0 * x - 1.0, cf, cp)
    else:
        raise TypeError(f"p2p_blocked: no pair kernel for the window "
                        f"{type(window).__name__}")

    def in_range(x):
        inrange = x < 1.0
        fw, pw = win(x)
        return (torch.where(inrange, fw, 0.0),
                torch.where(inrange, pw, 0.0) if want_pot else None)
    return in_range


def p2p_blocked_reference(tgt_ipos, src_ipos, src_mass, boxsize,
                          softening, cellsize, window, G,
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
    win = _window_fn(window, want_pot)
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
        fw, pw = win(r * inv_cellxmax)
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
            pot[rows] = (fpot * pw).sum(-1) * g
    return acc, (pot if want_pot else None)


@lru_cache(maxsize=None)
def _lib():
    """csrc/p2p.cu, built on first use, with its C signatures set."""
    from .._build import load_library
    lib = load_library("p2p")
    f = lib.shenqi_p2p_blocked
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    f.argtypes = [P, P, P, I, P, I, P, I, F, P, P, I, I, I, F, F, F, F, I,
                  I, P]
    f.restype = I
    lib.shenqi_p2p_instantiation.argtypes = [I, I, I, I]
    lib.shenqi_p2p_instantiation.restype = I
    lib.shenqi_cuda_error_string.argtypes = [I]
    lib.shenqi_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _kind(window) -> int:
    """The C interface's window kind: 0 Chebyshev, 1 erfc."""
    if isinstance(window, ErfcWindow):
        return 1
    if isinstance(window, PolyWindow):
        return 0
    raise TypeError(f"p2p_blocked: no pair kernel for the window "
                    f"{type(window).__name__}")


def kernel_instantiation(window, want_pot: bool) -> str:
    """Which instantiation of csrc/p2p.cu serves this window: the erfc
    one, the one with the Chebyshev degree compiled in (coefficients in
    registers), or the run-time-degree one.  Builds the library; needs
    the CUDA toolkit."""
    kind = _kind(window)
    nc = _lib().shenqi_p2p_instantiation(
        kind, 0 if kind else window.cf.shape[0],
        0 if kind else window.cp.shape[0], int(want_pot))
    if nc < 0:
        return "erfc window"
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
                cellsize, window, G, want_pot: bool = True,
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
    kind = _kind(window)
    if kind == 0:
        cf, cp = window.cf, window.cp
        _check("window.cf", cf, torch.float32, (cf.shape[0],), dev)
        _check("window.cp", cp, torch.float32, (cp.shape[0],), dev)
        if not (1 <= cf.shape[0] <= MAX_COEF
                and 1 <= cp.shape[0] <= MAX_COEF):
            raise ValueError("p2p_blocked: window degree above the "
                             f"kernel's {MAX_COEF} coefficients")
        coef = (cf.data_ptr(), cf.shape[0], cp.data_ptr(), cp.shape[0], 0.0)
    else:
        coef = (None, 0, None, 0, float(_erfc_ku(window)))
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
        kind, *coef, acc.data_ptr(), pot.data_ptr() if want_pot else None,
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
