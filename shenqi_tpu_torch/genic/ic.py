"""Initial conditions: Gaussian field + Zel'dovich displacement
(shenqi_tpu/genic/ic.py in torch).

The MP-GenIC analog (libgenic/zeldovich.cpp, main.cpp): the reference's
Gaussian field (genic/gadget_field.py, host numpy, the same phases for
the same seed), the displacement transfer as dense per-mode tables, and
the displacements back through an inverse FFT (torch.fft; cuFFT on the
card) and the CIC readout (ops/cic.py).

Math (identical to the reference displacement transfer,
libgenic/zeldovich.cpp:293-315):
  disp_j(k) = i * (kint_j / kint^2) / (2 pi) / sqrt(L) * Delta(k) * g(k)
with Delta = sqrt(P(k)) in internal units, g a unit complex Gaussian, and
an unnormalized inverse FFT.  Velocity = a H(a) f(a) * disp (peculiar).

`scheme="fast"` (no CLI selects it, in the JAX package either) is
jax.random.normal white noise through an rfftn: utils/threefry.py draws
jax's uniform to the bit and its normals within a few ulp, so the
realization is the JAX package's to f32 rounding.  Species lattices take
a fractional shift, species displacements a transfer type, and with a
CLASS transfer table loaded the velocities come from the scale-dependent
growth (dlog_growth).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..core.particles import float_to_ipos
from ..cosmology.background import Cosmology
from ..cosmology.power import InputPower, DELTA_TOT
from ..ops.cic import cic_readout


def setup_grid(ngrid: int, boxsize: float, id_offset: int = 1,
               shift_frac: float = 0.0):
    """Particles on a regular lattice with deterministic IDs.

    Matches the reference grid pre-IC (libgenic/zeldovich.cpp IDGenerator):
    index (i,j,k) -> id = offset + i*ng^2 + j*ng + k, position at the cell
    corner plus an optional fractional shift (the species lattices of a
    neutrino or gas run sit apart).
    """
    ng = ngrid
    idx = np.arange(ng)
    X, Y, Z = np.meshgrid(idx, idx, idx, indexing="ij")
    pos = np.stack([X, Y, Z], axis=-1).reshape(-1, 3).astype(np.float64)
    pos = ((pos + shift_frac) * (boxsize / ng)) % boxsize
    ids = (id_offset + X.ravel() * ng * ng + Y.ravel() * ng
           + Z.ravel()).astype(np.uint64)
    return pos, ids


def gaussian_field(seed: int, nmesh: int, unitary: bool = False,
                   invert_phase: bool = False, scheme: str = "gadget",
                   device=None) -> np.ndarray:
    """Unit-variance hermitian complex Gaussian modes g_k [n,n,n//2+1]
    (host complex64).  scheme='gadget': the reference's
    pmic_fill_gaussian_gadget phases, so the same seed gives the same
    realization as MP-GenIC and the JAX package, bit for bit.
    scheme='fast': rfftn(white noise) / n^1.5 of jax.random.normal's
    draw from PRNGKey(seed) (utils/threefry.normal), on `device` (CUDA
    unless the caller asks for the CPU): exactly hermitian, each mode
    <|g|^2> = 1, the JAX package's realization to f32 rounding.

    `unitary` fixes |g|=1 keeping the phase (variance suppression);
    `invert_phase` flips the sign (paired simulations).
    """
    if scheme == "fast":
        from ..utils import threefry
        white = threefry.normal(threefry.PRNGKey(seed),
                                (nmesh, nmesh, nmesh),
                                device=resolve_device(device))
        g = torch.fft.rfftn(white) / nmesh ** 1.5
        if unitary:
            amp = g.abs()
            g = g / torch.where(amp > 0, amp, 1.0)
        if invert_phase:
            g = -g
        return g.cpu().numpy().astype(np.complex64)
    if scheme != "gadget":
        raise ValueError(f"gaussian_field: unknown scheme {scheme!r}")
    from .gadget_field import gadget_gaussian_field
    return gadget_gaussian_field(seed, nmesh, unitary=unitary,
                                 invert_phase=invert_phase
                                 ).astype(np.complex64)


def _mesh_to_k(nmesh: int):
    """Integer wavenumbers with the reference's MESH2K convention
    (petapm.cpp:159-162): i <= N/2 -> i, else i - N.  The Nyquist index
    N/2 maps to +N/2, not numpy fftfreq's -N/2."""
    i = np.arange(nmesh)
    return np.where(i <= nmesh // 2, i, i - nmesh).astype(np.float64)


def _mode_tables(nmesh: int):
    k1 = _mesh_to_k(nmesh)
    kx = k1[:, None, None]
    ky = k1[None, :, None]
    kz = np.arange(nmesh // 2 + 1, dtype=np.float64)[None, None, :]
    k2 = kx ** 2 + ky ** 2 + kz ** 2
    return (kx, ky, kz), k2


@dataclass
class ZeldovichResult:
    pos: np.ndarray        # [N,3] displaced positions (internal units)
    vel: np.ndarray        # [N,3] velocities (convention per use_peculiar)


def displacement_fields(g_k, power: InputPower, CP: Cosmology,
                        pos_lattice: np.ndarray, boxsize: float,
                        time_ic: float, ttype: int = DELTA_TOT,
                        use_peculiar: bool = True,
                        device=None) -> ZeldovichResult:
    """Zel'dovich displacements and velocities at the lattice points, for
    the species whose transfer type is `ttype`.

    The per-mode tables are host f64 cast to f32 as in the JAX package;
    the complex field, the inverse FFTs and the CIC readouts run on
    `device` (CUDA unless the caller asks for the CPU).  With
    scale-dependent velocities (a transfer table loaded) the velocities
    take three more inverse FFTs of the growth table."""
    dev = resolve_device(device)
    nmesh = g_k.shape[0]
    (kx, ky, kz), k2 = _mode_tables(nmesh)

    kmag_internal = np.sqrt(k2) * (2 * np.pi / boxsize)
    delta = power.delta_spec(kmag_internal, ttype)
    growth = (power.dlog_growth(kmag_internal, ttype)
              if power.scale_dep_velocity else None)

    k2_safe = np.where(k2 > 0, k2, 1.0)
    base = 1.0 / (2 * np.pi) / np.sqrt(boxsize) / k2_safe
    base = np.where(k2 > 0, base, 0.0)

    ipos = float_to_ipos(pos_lattice, boxsize, device=dev)
    g = torch.from_numpy(np.ascontiguousarray(g_k, np.complex64)).to(dev)

    def solve_axis(kaxis_int, amp_table):
        fac = torch.from_numpy(np.ascontiguousarray(
            base * kaxis_int * amp_table, np.float32)).to(dev)
        field_k = (1j * fac) * g
        # unnormalized inverse FFT (reference/FFTW convention)
        mesh = torch.fft.irfftn(field_k, s=(nmesh, nmesh, nmesh)) \
            * nmesh ** 3
        return cic_readout(mesh.to(torch.float32), ipos)

    disp = torch.stack([solve_axis(kj, delta) for kj in (kx, ky, kz)],
                       dim=-1).cpu().numpy()
    if growth is not None:
        vel = torch.stack([solve_axis(kj, growth) for kj in (kx, ky, kz)],
                          dim=-1).cpu().numpy()
    else:
        vel = disp.copy()

    hubble_a = CP.hubble_function(time_ic)
    vel_prefac = time_ic * hubble_a
    if not use_peculiar:
        vel_prefac /= np.sqrt(time_ic)
    if growth is None:
        vel_prefac *= CP.F_Omega(time_ic)
    vel = vel * vel_prefac

    pos = (pos_lattice + disp) % boxsize
    return ZeldovichResult(pos=pos, vel=vel)


def generate_dm_ics(ngrid: int, boxsize: float, seed: int,
                    power: InputPower, CP: Cosmology, time_ic: float,
                    unitary: bool = False, invert_phase: bool = False,
                    nmesh: Optional[int] = None,
                    use_peculiar: bool = True, device=None):
    """One-species (DM) IC: returns (pos, vel, ids, mass_per_particle)
    as host arrays.

    mass = Omega0 * rhocrit * box^3 / ngrid^3 (total matter in DM).
    """
    nmesh = nmesh or ngrid
    pos_lattice, ids = setup_grid(ngrid, boxsize)
    g_k = gaussian_field(seed, nmesh, unitary, invert_phase)
    res = displacement_fields(g_k, power, CP, pos_lattice, boxsize,
                              time_ic, use_peculiar=use_peculiar,
                              device=device)
    mass = (CP.Omega0 * CP.RhoCrit * boxsize ** 3) / ngrid ** 3
    return res.pos, res.vel, ids, mass
