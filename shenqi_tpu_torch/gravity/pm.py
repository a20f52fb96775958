"""Long-range particle-mesh gravity via FFT (shenqi_tpu/gravity/pm.py
in torch).

Pipeline (the reference long-range solver, libgadget/gravpm.cpp:379-487):
  1. CIC-deposit masses onto an Nmesh^3 grid
  2. r2c FFT (torch.fft.rfftn; cuFFT on the card)
  3. potential transfer: -G/(pi L) * exp(-k2 asmth2)/k2 * W_cic^-4
  4. total-matter P(k) binned in the same pass
  5. c2r per component with the 4-point difference kernel
     (8 sin w - sin 2w)/6
  6. CIC readout of the 3 force components (and the potential)

The JAX package left the FFT to XLA; here it is cuFFT through
torch.fft, not a kernel of this repository.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.cic import cic_deposit, cic_readout


class PMConfig(NamedTuple):
    nmesh: int
    boxsize: float      # internal length units
    G: float            # gravitational constant, internal units
    asmth: float = 1.5  # long/short-range split scale in mesh cells
    nbins_power: int = 0  # power spectrum bins (0 -> nmesh)


class PowerSpectrum(NamedTuple):
    """Binned P(k) measured from the density mesh (device tensors)."""
    k: torch.Tensor        # [nbins] mean |k| per bin (grid units)
    power: torch.Tensor    # [nbins] sum of w |delta_k|^2 / W^2
    nmodes: torch.Tensor   # [nbins]
    norm: torch.Tensor     # scalar: |mode 0|^2 = (sum of mass)^2


def _kpos_1d(n: int, device, half: bool = False):
    """Integer wavenumbers along one axis: [0..n/2, -(n/2-1)..-1]."""
    if half:
        return torch.arange(n // 2 + 1, dtype=torch.float32,
                            device=device)
    k = torch.arange(n, dtype=torch.float32, device=device)
    return torch.where(k <= n // 2, k, k - n)


def _kgrid(n: int, device):
    return (_kpos_1d(n, device)[:, None, None],
            _kpos_1d(n, device)[None, :, None],
            _kpos_1d(n, device, half=True)[None, None, :])


def _sinc_unnormed(x):
    """sin(x)/x, safe at 0."""
    small = torch.abs(x) < 1e-5
    return torch.where(small, 1.0,
                       torch.sin(x) / torch.where(small, 1.0, x))


def _cic_invwindow(cfg: PMConfig, device, kvec=None):
    """Per-mode 1/W_cic for the rfft layout (or the k-vectors `kvec` of
    another layout); W = prod sinc^2(pi k/N)."""
    n = cfg.nmesh
    f = 1.0
    for kj in (kvec or _kgrid(n, device)):
        s = _sinc_unnormed(kj * (np.pi / n))
        f = f / (s * s)
    return f  # broadcasting produces [n, n, n//2+1]


def power_sums(rho_k, cfg: PMConfig, invwindow, kvec):
    """The binned sums of measure_power on any k layout (the full rfftn
    half spectrum, or one rank's pencil): (power, nmodes, ksum, norm)
    with norm the summed |rho_k|^2 of the k = 0 mode, which a pencil
    holds on one rank only."""
    n = cfg.nmesh
    dev = rho_k.device
    nbins = cfg.nbins_power or n
    kx, ky, kz = kvec
    k2 = kx * kx + ky * ky + kz * kz
    m = rho_k.real ** 2 + rho_k.imag ** 2
    w = torch.where((kz == 0) | (kz == n // 2), 1.0, 2.0)
    w = torch.broadcast_to(w, m.shape)
    keff = torch.sqrt(k2)
    binsperunit = (nbins - 1) / np.log(np.sqrt(3.) * n / 2.)
    kint = torch.floor(binsperunit * 0.5 * torch.log(
        torch.where(k2 > 0, k2, 1.0))).to(torch.int64)
    kint = torch.where(k2 > 0, kint, nbins)  # k=0 -> overflow bin
    kint = torch.clamp(kint, 0, nbins)

    flat = torch.broadcast_to(kint, m.shape).reshape(-1)

    def segsum(v):
        out = torch.zeros(nbins + 1, dtype=torch.float32, device=dev)
        return out.index_add_(0, flat, v.reshape(-1))[:nbins]

    power = segsum(w * m * invwindow * invwindow)
    nmodes = segsum(w)
    ksum = segsum(w * keff)
    norm = torch.sum(torch.where(k2 == 0, m, 0.0))
    return power, nmodes, ksum, norm


def power_from_sums(power, nmodes, ksum, norm) -> PowerSpectrum:
    kmean = torch.where(nmodes > 0, ksum / torch.clamp(nmodes, min=1),
                        0.0)
    return PowerSpectrum(k=kmean, power=power, nmodes=nmodes, norm=norm)


def measure_power(rho_k, cfg: PMConfig, invwindow=None) -> PowerSpectrum:
    """Bin |rho_k|^2 into log-k2 bins (powerspectrum_add_mode math):
    kint = floor(binsperunit * log(k2)/2), binsperunit =
    (nbins-1)/log(sqrt(3) N/2); hermitian weight 2 except on the kz=0
    and kz=N/2 planes.  f32 sums, as in the JAX package."""
    dev = rho_k.device
    if invwindow is None:
        invwindow = _cic_invwindow(cfg, dev)
    return power_from_sums(*power_sums(rho_k, cfg, invwindow,
                                       _kgrid(cfg.nmesh, dev)))


def finalize_power(ps: PowerSpectrum, cfg: PMConfig, boxsize_mpc: float):
    """Host-side: convert to (k [h/Mpc], P [(Mpc/h)^3]) like the
    reference powerspectrum_sum (libgadget/powerspectrum.cpp:72-88)."""
    k = ps.k.double().cpu().numpy()
    power = ps.power.double().cpu().numpy()
    nmodes = ps.nmodes.double().cpu().numpy()
    norm = float(ps.norm)
    sel = nmodes > 0
    k = k[sel]
    power = power[sel] / nmodes[sel] / norm * boxsize_mpc ** 3
    kk = k * 2 * np.pi / boxsize_mpc
    return kk, power, nmodes[sel]


def potential_transfer(cfg: PMConfig, kvec, invwindow):
    """The potential's Green's function per mode: -G/(pi L) exp(-k2
    asmth2)/k2 W^-4, times N^3 for the normalized inverse FFT
    (irfftn divides by N^3, the reference's FFTW does not); 0 at k=0."""
    n = cfg.nmesh
    kx, ky, kz = kvec
    k2 = kx * kx + ky * ky + kz * kz
    asmth2 = (2 * np.pi * cfg.asmth / n) ** 2
    pot_factor = -cfg.G / (np.pi * cfg.boxsize)
    fac = (pot_factor * n ** 3) * torch.exp(-k2 * asmth2) \
        / torch.where(k2 > 0, k2, 1.0) * invwindow * invwindow
    return torch.where(k2 > 0, fac, 0.0)


def force_transfer(cfg: PMConfig, kj, pot_k):
    """One force component's modes: i (-(8 sin w - sin 2w)/6 N/L) pot_k,
    w = 2 pi kj/N (the 4-point difference kernel)."""
    n = cfg.nmesh
    w = kj * (2 * np.pi / n)
    ffac = -((8.0 * torch.sin(w) - torch.sin(2.0 * w)) / 6.0) \
        * (n / cfg.boxsize)
    return (1j * ffac) * pot_k


def measure_cdm_power(ipos, mass, cfg: PMConfig, mask=None) -> PowerSpectrum:
    """Deposit, one FFT and the binning only: the CDM (particle) power
    that sources the neutrino linear response (measure_power_spectrum,
    gravpm.cpp:360, taken before the nu factor multiplies the modes)."""
    mesh = cic_deposit(ipos, mass, cfg.nmesh, mask=mask)
    rho_k = torch.fft.rfftn(mesh)
    return measure_power(rho_k, cfg, _cic_invwindow(cfg, ipos.device))


def pm_forces(ipos, mass, cfg: PMConfig, mask=None,
              want_potential: bool = True, nu_factor=None):
    """Full PM force solve on the device the inputs lie on.

    Args:
      ipos: [N,3] int32 bit patterns of uint32 fixed-point positions
      mass: [N] f32
      cfg: PMConfig
      mask: [N] bool — dead particles neither deposit nor read out
      nu_factor: optional f32 [n, n, n//2+1] multiplier on the density
        modes (the massive-neutrino linear response, 1 + f_nu
        delta_nu/delta_cdm), applied before the power is measured

    Returns:
      (accel [N,3] f32, potential [N] f32 or None, PowerSpectrum)
    """
    n = cfg.nmesh
    dev = ipos.device
    mesh = cic_deposit(ipos, mass, n, mask=mask)
    rho_k = torch.fft.rfftn(mesh)

    invwindow = _cic_invwindow(cfg, dev)
    if nu_factor is not None:
        rho_k = rho_k * nu_factor
    ps = measure_power(rho_k, cfg, invwindow)

    pot_k = rho_k * potential_transfer(cfg, _kgrid(n, dev), invwindow)
    accel = torch.stack([cic_readout(torch.fft.irfftn(
        force_transfer(cfg, kj, pot_k), s=(n, n, n)), ipos, mask=mask)
        for kj in _kgrid(n, dev)], dim=-1)

    potential = None
    if want_potential:
        pmesh = torch.fft.irfftn(pot_k, s=(n, n, n))
        potential = cic_readout(pmesh, ipos, mask=mask)
    return accel, potential, ps
