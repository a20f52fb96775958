"""Lensing potential planes (plane.cpp / lenstools.cpp analog;
shenqi_tpu/physics/plane.py: the deposit in torch on the device, the
rest copied, host float64).

For each cut point and normal direction, particles inside a slab of
given thickness are NGP-binned onto a 2-D grid, normalized to the
density fluctuation, and the 2-D Poisson equation is solved in Fourier
space with Gaussian smoothing (the lenstools cutPlaneGaussianGrid
pipeline, lenstools.cpp:120-318).  Output is a real FITS image with
the same header keys the reference writes (lenstools.cpp:321-394) via
a self-contained minimal FITS writer (no cfitsio on this image).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from ..utils.constants import CM_PER_KPC, CM_PER_MPC, LIGHTCGS


@dataclass
class PlaneParams:
    Resolution: int = 256
    Thickness: float = 0.0          # internal units; <=0 -> boxsize
    CutPoints: List[float] = field(default_factory=list)
    Normals: List[int] = field(default_factory=lambda: [0, 1, 2])
    DoubleOut: bool = False


def omega_source(CP, atime: float) -> float:
    """Matter density carried by particles (lenstools.cpp:28-37):
    with linear-response neutrinos, the particle mass excludes nu."""
    om = CP.Omega0
    if CP.MassiveNuLinRespOn:
        om -= atime ** 3 * CP.ONu.get_omega_nu(atime)
    return om


def cut_plane_gaussian_grid(pos, active, num_particles_tot,
                            comoving_distance, boxsize, CP, atime,
                            normal: int, center: float,
                            thickness: float, resolution: int,
                            smooth: float = 1.0):
    """One potential plane (lenstools cutPlaneGaussianGrid).

    pos: [N,3] positions in internal units; active: [N] bool.
    Returns (potential [R,R] float64-ish, n_particles_on_plane).
    """
    # Output-time host computation in float64 (matches the
    # reference's FFTW double path; not a hot loop)
    pos = np.asarray(pos, np.float64)
    d0, d1 = (normal + 1) % 3, (normal + 2) % 3
    # slab membership along the normal (periodic)
    rel = np.mod(pos[:, normal] - (center - thickness / 2), boxsize)
    in_slab = (rel < thickness) & np.asarray(active)

    # NGP binning on the plane
    cell = boxsize / resolution
    i0 = np.clip((pos[:, d0] % boxsize) / cell, 0,
                 resolution - 1e-6).astype(np.int64)
    i1 = np.clip((pos[:, d1] % boxsize) / cell, 0,
                 resolution - 1e-6).astype(np.int64)
    density = np.zeros((resolution, resolution))
    np.add.at(density, (i0[in_slab], i1[in_slab]), 1.0)
    n_plane = int(in_slab.sum())

    # normalize counts to density fluctuation (lenstools.cpp:291-299)
    bin_norm = thickness
    dnf = (1.0 / num_particles_tot
           * boxsize ** 3 / (cell * cell * bin_norm))
    density = density * dnf

    # 2-D Poisson solve with the lenstools multipole convention
    # (l in cycles per box: lx = i/R)
    rho_k = np.fft.rfft2(density)
    i = np.arange(resolution)
    lx = np.where(i < resolution // 2, i, i - resolution) \
        / resolution
    ly = np.arange(resolution // 2 + 1) / resolution
    l2 = lx[:, None] ** 2 + ly[None, :] ** 2
    l2[0, 0] = 1.0
    rho_k[0, 0] = 0.0                   # drop the uniform mode
    factor = (-2.0 * (cell * cell / comoving_distance ** 2)
              / (l2 * 4 * np.pi ** 2))
    factor = factor * np.exp(-0.5 * (2 * np.pi * smooth) ** 2 * l2)
    pot = np.fft.irfft2(rho_k * factor, s=(resolution, resolution))

    # physical normalizations (lenstools.cpp:246-253, 302-310)
    h0_cgs = 100 * CP.HubbleParam * 3.2407793e-20
    cosmo_norm = (1.5 * h0_cgs ** 2 * omega_source(CP, atime)
                  / LIGHTCGS ** 2)
    dens_norm = (bin_norm * comoving_distance
                 * (CM_PER_KPC / CP.HubbleParam) ** 2 / atime)
    return pot * (cosmo_norm * dens_norm), n_plane


def plane_counts_ipos(ipos, alive, boxsize, normal: int,
                      center: float, thickness: float,
                      resolution: int):
    """NGP plane deposit straight from the fixed-point positions (int32
    bit patterns of uint32), on the device they lie on.

    Slab membership and the bins are exact integer work in int64 (the
    unsigned values, ROADMAP C.1): the periodic slab test is the
    difference modulo 2^32, and a bin is floor(u * R / 2^32) =
    (u * R) >> 32, which int64 holds for R < 2^31.  The counts come from
    an integer scatter-add, so they are bit-identical on any device
    (the JAX package computes the same integers with 16-bit limbs in
    uint32).

    Returns (counts [R,R] int32, n_plane int32 scalar), device tensors.
    """
    d0, d1 = (normal + 1) % 3, (normal + 2) % 3
    ip = ipos.long() & 0xFFFFFFFF
    # periodic slab membership along the normal, exact modulo 2^32
    off = int(round(((center - thickness / 2) % boxsize)
                    / boxsize * 2 ** 32)) & 0xFFFFFFFF
    tfrac = thickness / boxsize
    if tfrac >= 1.0:
        in_slab = alive
    else:
        thick_u = int(round(tfrac * 2 ** 32))
        rel = (ip[:, normal] - off) & 0xFFFFFFFF
        in_slab = alive & (rel < thick_u)
    i0 = (ip[:, d0] * resolution) >> 32
    i1 = (ip[:, d1] * resolution) >> 32
    oob = resolution * resolution
    tgt = torch.where(in_slab, i0 * resolution + i1, oob)
    counts = torch.zeros(oob + 1, dtype=torch.int32, device=ipos.device)
    counts.index_add_(0, tgt, torch.ones_like(tgt, dtype=torch.int32))
    return (counts[:oob].reshape(resolution, resolution),
            in_slab.sum().to(torch.int32))


def cut_plane_from_counts(counts, num_particles_tot,
                          comoving_distance, boxsize, CP, atime,
                          thickness: float, resolution: int,
                          smooth: float = 1.0):
    """FFT + normalization half of cut_plane_gaussian_grid, fed by a
    precomputed NGP count grid (host f64; output cadence only)."""
    cell = boxsize / resolution
    density = np.asarray(counts, np.float64)
    bin_norm = thickness
    dnf = (1.0 / num_particles_tot
           * boxsize ** 3 / (cell * cell * bin_norm))
    density = density * dnf

    rho_k = np.fft.rfft2(density)
    i = np.arange(resolution)
    lx = np.where(i < resolution // 2, i, i - resolution) \
        / resolution
    ly = np.arange(resolution // 2 + 1) / resolution
    l2 = lx[:, None] ** 2 + ly[None, :] ** 2
    l2[0, 0] = 1.0
    rho_k[0, 0] = 0.0                   # drop the uniform mode
    factor = (-2.0 * (cell * cell / comoving_distance ** 2)
              / (l2 * 4 * np.pi ** 2))
    factor = factor * np.exp(-0.5 * (2 * np.pi * smooth) ** 2 * l2)
    pot = np.fft.irfft2(rho_k * factor, s=(resolution, resolution))

    h0_cgs = 100 * CP.HubbleParam * 3.2407793e-20
    cosmo_norm = (1.5 * h0_cgs ** 2 * omega_source(CP, atime)
                  / LIGHTCGS ** 2)
    dens_norm = (bin_norm * comoving_distance
                 * (CM_PER_KPC / CP.HubbleParam) ** 2 / atime)
    return pot * (cosmo_norm * dens_norm)


def write_planes_deposit(snapnum: int, atime: float, CP, deposit,
                         ntot: int, boxsize: float, outdir: str,
                         unit_velocity: float,
                         unit_length_in_cm: float, par: PlaneParams):
    """write_planes with a caller-supplied deposit:
    `deposit(normal, center, thickness) -> (counts, n_plane)` —
    the single-device loop passes plane_counts_ipos on the run's
    device."""
    import os
    thickness = par.Thickness if par.Thickness > 0 else boxsize
    cuts = list(par.CutPoints)
    if not cuts:
        cuts = [(0.5 + i) * thickness
                for i in range(int(boxsize / thickness))]
    redshift = 1.0 / atime - 1.0
    chi = CP.comoving_distance(atime, 1.0, unit_velocity)
    written = []
    for ci, cut in enumerate(cuts):
        for normal in par.Normals:
            counts, n_plane = deposit(normal, cut, thickness)
            pot = cut_plane_from_counts(
                counts, ntot, max(chi, 1e-10), boxsize, CP, atime,
                thickness, par.Resolution)
            fn = os.path.join(
                outdir, f"snap{snapnum}_potentialPlane{ci}_"
                        f"normal{normal}.fits")
            write_fits_plane(fn, np.asarray(pot), CP, redshift, chi,
                             boxsize, int(n_plane),
                             unit_length_in_cm, par.DoubleOut)
            written.append(fn)
    return written


# ---------------- minimal FITS image writer ----------------

def _fits_card(key: str, value, comment: str = "") -> bytes:
    if isinstance(value, bool):
        v = "T" if value else "F"
        body = f"{key:<8}= {v:>20}"
    elif isinstance(value, int):
        body = f"{key:<8}= {value:>20}"
    elif isinstance(value, float):
        body = f"{key:<8}= {value:>20.12G}"
    else:
        body = f"{key:<8}= '{value:<8}'"
    if comment:
        body += f" / {comment}"
    return body[:80].ljust(80).encode("ascii")


def write_fits_plane(path: str, data: np.ndarray, CP, redshift: float,
                     comoving_distance: float, boxsize: float,
                     n_particles: int, unit_length_in_cm: float,
                     double_out: bool = False):
    """Single-HDU FITS image with the reference header keys
    (lenstools.cpp savePotentialPlane).  Big-endian data, 2880-byte
    record padding — readable by astropy/lenstools."""
    arr = np.asarray(data, np.float64 if double_out else np.float32)
    bitpix = -64 if double_out else -32
    lbox_mpc = boxsize * unit_length_in_cm / CM_PER_MPC
    chi_mpc = comoving_distance * unit_length_in_cm / CM_PER_MPC
    ode0 = CP.OmegaLambda if CP.OmegaLambda > 0 else CP.Omega_fld
    cards = [
        _fits_card("SIMPLE", True, "conforms to FITS standard"),
        _fits_card("BITPIX", bitpix),
        _fits_card("NAXIS", 2),
        _fits_card("NAXIS1", arr.shape[1]),
        _fits_card("NAXIS2", arr.shape[0]),
        _fits_card("H0", 100.0 * CP.HubbleParam,
                   "Hubble constant in km/s*Mpc"),
        _fits_card("h", CP.HubbleParam, "Dimensionless Hubble"),
        _fits_card("OMEGA_M", CP.Omega0, "Dark Matter density"),
        _fits_card("OMEGA_L", ode0, "Dark Energy density"),
        _fits_card("W0", CP.w0_fld, "DE equation of state"),
        _fits_card("WA", CP.wa_fld, "DE running eq. of state"),
        _fits_card("Z", redshift, "Redshift of the lens plane"),
        _fits_card("CHI", chi_mpc, "Comoving distance in Mpc/h"),
        _fits_card("SIDE", lbox_mpc, "Side length in Mpc/h"),
        _fits_card("NPART", int(n_particles),
                   "Number of particles on the plane"),
        _fits_card("UNIT", "rad2", "Pixel value unit"),
        "END".ljust(80).encode("ascii"),
    ]
    header = b"".join(cards)
    header += b" " * ((2880 - len(header) % 2880) % 2880)
    payload = arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    payload += b"\0" * ((2880 - len(payload) % 2880) % 2880)
    with open(path, "wb") as f:
        f.write(header + payload)
    return path


def read_fits_plane(path: str):
    """Read back a plane written by write_fits_plane (tests)."""
    with open(path, "rb") as f:
        raw = f.read()
    header = {}
    n_cards = 0
    for off in range(0, len(raw), 80):
        card = raw[off:off + 80].decode("ascii", "replace")
        n_cards += 1
        key = card[:8].strip()
        if key == "END":
            break
        if "=" in card:
            val = card[9:].split("/")[0].strip()
            header[key] = val.strip("' ")
    hdr_len = ((n_cards * 80 + 2879) // 2880) * 2880
    bitpix = int(header["BITPIX"])
    shape = (int(header["NAXIS2"]), int(header["NAXIS1"]))
    dt = np.dtype(">f8" if bitpix == -64 else ">f4")
    count = shape[0] * shape[1]
    data = np.frombuffer(raw[hdr_len:hdr_len + count * dt.itemsize],
                         dtype=dt).reshape(shape)
    return header, data


def write_planes(snapnum: int, atime: float, CP, pos, active,
                 boxsize: float, outdir: str, unit_velocity: float,
                 unit_length_in_cm: float, par: PlaneParams):
    """Driver: loop cut points x normals, write all planes
    (plane.cpp write_plane)."""
    import os
    thickness = par.Thickness if par.Thickness > 0 else boxsize
    cuts = list(par.CutPoints)
    if not cuts:
        cuts = [(0.5 + i) * thickness
                for i in range(int(boxsize / thickness))]
    redshift = 1.0 / atime - 1.0
    chi = CP.comoving_distance(atime, 1.0, unit_velocity)
    ntot = int(np.asarray(active).sum())
    written = []
    for ci, cut in enumerate(cuts):
        for normal in par.Normals:
            pot, n_plane = cut_plane_gaussian_grid(
                pos, active, ntot, max(chi, 1e-10), boxsize, CP,
                atime, normal, cut, thickness, par.Resolution)
            fn = os.path.join(
                outdir, f"snap{snapnum}_potentialPlane{ci}_"
                        f"normal{normal}.fits")
            write_fits_plane(fn, np.asarray(pot), CP, redshift, chi,
                             boxsize, int(n_plane),
                             unit_length_in_cm, par.DoubleOut)
            written.append(fn)
    return written
