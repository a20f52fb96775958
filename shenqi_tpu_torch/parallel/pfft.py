"""The distributed pencil FFT and the slab PM solve
(shenqi_tpu/parallel/pfft.py in torch.distributed).

The reference distributes its PM FFT with heFFTe over MPI
(libgadget/petapm.cpp).  Here, as in the JAX package, one transform is
local FFTs around a single all_to_all:

  forward (pfft_r2c), x-slab [N/D, N, N] real per rank:
    1. local rfft2 over (y, z)                  -> [N/D, N, K]
    2. x <-> y transpose (all_to_all_equal)     -> [N, N/D, K]
    3. fft along the now complete x axis        -> the k pencil
  inverse (pfft_c2r) reverses the three steps.

The pencil is [kx (all N), ky (this rank's N/D), kz (K = N/2+1)];
`pencil_kvec` gives each rank its ky range, so transfer functions and
P(k) binning are local (one all_reduce of the bin sums).

The slab PM (pm_forces_slab): CIC deposit into the rank's x-slab plus
`halo` boundary planes, which a ring shift adds into the neighbours'
slabs (the petapm.cpp:79-87 region exchange reduced to a ring because
the domains are mesh slabs); the readout borrows `halo` planes back.
On cost-balanced slabs the deposit rows are first routed to their
uniform FFT slab and the forces routed back (domain.route_rows).
torch.fft is cuFFT on the card; no kernel of this repository.
"""

from __future__ import annotations

import numpy as np
import torch

from ..gravity.pm import (PowerSpectrum, _cic_invwindow, _kpos_1d,
                          force_transfer, potential_transfer,
                          power_from_sums, power_sums)
from ..ops.cic import cic_deposit, cic_deposit_slab, cic_readout, \
    cic_readout_slab
from . import collectives as cc
from .domain import route_back, route_rows, slab_index


def pfft_r2c(x_slab: torch.Tensor) -> torch.Tensor:
    """Forward distributed real FFT (pfft.py:35-56): this rank's x-slab
    [N/D, N, N] -> its k pencil [N, N/D, K] complex."""
    D = cc.world_size()
    nloc, n, _ = x_slab.shape
    yk = torch.fft.rfft2(x_slab)                          # [N/D, N, K]
    k = yk.shape[-1]
    # block d (the y chunk of rank d) goes to rank d; block s of the
    # result holds x chunk s of my y chunk
    blocks = yk.reshape(nloc, D, n // D, k).permute(1, 0, 2, 3)
    xk = cc.all_to_all_equal(blocks.contiguous()).reshape(n, n // D, k)
    return torch.fft.fft(xk, dim=0)


def pfft_c2r(pencil: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of pfft_r2c (pfft.py:59-69): pencil [N, N/D, K] -> x-slab
    [N/D, N, N] real."""
    D = cc.world_size()
    k = pencil.shape[-1]
    xk = torch.fft.ifft(pencil, dim=0).reshape(D, n // D, n // D, k)
    yk = cc.all_to_all_equal(xk.contiguous())        # [D(y), N/D, N/D, K]
    yk = yk.permute(1, 0, 2, 3).reshape(n // D, n, k)
    return torch.fft.irfft2(yk, s=(n, n))


def pencil_kvec(n: int, device):
    """Integer wavenumbers of this rank's pencil (pfft.py:72-85):
    (kx [N,1,1], ky [1,N/D,1], kz [1,1,K])."""
    D, me = cc.world_size(), cc.rank()
    nloc = n // D
    kx = _kpos_1d(n, device)[:, None, None]
    ky = me * nloc + torch.arange(nloc, dtype=torch.float32, device=device)
    ky = torch.where(ky <= n // 2, ky, ky - n)[None, :, None]
    kz = _kpos_1d(n, device, half=True)[None, None, :]
    return kx, ky, kz


def measure_power_pencil(rho_k, cfg) -> PowerSpectrum:
    """P(k) of the pencil layout (pfft.py:117-171; powerspectrum_add_mode,
    gravpm.cpp:326): each rank bins its ky chunk, one all_reduce sums the
    bins, so every rank holds the global spectrum."""
    kvec = pencil_kvec(cfg.nmesh, rho_k.device)
    sums = power_sums(rho_k, cfg, _cic_invwindow(cfg, rho_k.device, kvec),
                      kvec)
    flat = cc.all_sum(torch.cat([s.reshape(-1) for s in sums]))
    nb = sums[0].numel()
    return power_from_sums(flat[:nb], flat[nb:2 * nb], flat[2 * nb:3 * nb],
                           flat[3 * nb])


def _interp(x, xp, fp):
    """np.interp (clamped at both ends) of x on the knots (xp, fp)."""
    i = torch.searchsorted(xp, x.reshape(-1).contiguous(), right=True)
    i = torch.clamp(i, 1, xp.numel() - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    t = torch.clamp((x.reshape(-1) - x0) / (x1 - x0), 0.0, 1.0)
    return (f0 + t * (f1 - f0)).reshape(x.shape)


def _depose(ipos, mass, cfg, ndev: int, halo: int, mask, cuts_in):
    """Deposit onto the uniform FFT slab (with the halo planes summed
    into their owners) and the forward FFT: the shared first half of
    pfft.py:174-224.  Returns (rho_k pencil, readout context)."""
    n = cfg.nmesh
    if n % ndev:
        raise ValueError(f"nmesh {n} not divisible by ndev {ndev}")
    nloc = n // ndev
    if halo > nloc:
        raise ValueError(f"halo {halo} > slab {nloc}")
    me = cc.rank()
    C = ipos.shape[0]
    ipos_dep, mass_dep, dep_mask = ipos, mass, mask
    stay = state = None
    if cuts_in is not None and ndev > 1:
        alive = mask if mask is not None else mass > 0
        udest = slab_index(ipos[:, 0], ndev)
        stay = alive & (udest == me)
        recv, state = route_rows({"ipos": ipos, "mass": mass}, udest,
                                 alive, ndev)
        ipos_dep = torch.cat([ipos, recv["ipos"]])
        mass_dep = torch.cat([mass, recv["mass"]])
        dep_mask = torch.cat([stay, torch.ones(recv["mass"].shape[0],
                                               dtype=torch.bool,
                                               device=ipos.device)])
    buf = cic_deposit_slab(ipos_dep, mass_dep, n, nloc, halo, me * nloc,
                           mask=dep_mask)
    slab = buf[halo:halo + nloc].clone()
    if ndev > 1:
        # my planes below x0 belong to the left neighbour's interior
        from_right = cc.ring_shift(buf[:halo], -1, same_shape=True,
                                   tag="pm_halo")
        from_left = cc.ring_shift(buf[nloc + halo:], 1, same_shape=True,
                                  tag="pm_halo")
    else:
        from_left, from_right = buf[nloc + halo:], buf[:halo]
    slab[:halo] += from_left
    slab[nloc - halo:] += from_right
    return pfft_r2c(slab), (ipos_dep, dep_mask, stay, state, C, halo)


def pm_depose_slab(ipos, mass, cfg, ndev: int, halo: int = 2, mask=None,
                   cuts_in=None):
    """The deposit half of the PM solve (pfft.py:244-283): the routed
    deposit, one r2c and the CDM P(k) before any neutrino factor
    (measure_power_spectrum, gravpm.cpp:360).  Returns (rho_k, ps, ctx)
    for pm_forces_from_rhok, so a neutrino run deposits once per PM
    step."""
    rho_k, ctx = _depose(ipos, mass, cfg, ndev, halo, mask, cuts_in)
    return rho_k, measure_power_pencil(rho_k, cfg), ctx


def measure_cdm_power_slab(ipos, mass, cfg, ndev: int, halo: int = 2,
                           mask=None, cuts_in=None) -> PowerSpectrum:
    """Deposit, one FFT and the binning only (pfft.py:227-241): the CDM
    power sourcing the neutrino linear response."""
    return pm_depose_slab(ipos, mass, cfg, ndev, halo, mask, cuts_in)[1]


def pm_forces_from_rhok(rho_k, ctx, cfg, ndev: int, nu_k=None,
                        nu_fac=None, want_power: bool = False):
    """The force half of the PM solve (pfft.py:286-337): the optional
    neutrino factor interp(|k|, nu_k, nu_fac), the P(k) after it, the
    Green's function and gradient, three c2r, the readout at the
    deposited rows with `halo` planes borrowed from the neighbours, and
    the route back to the senders' rows.  Returns (accel [C,3], ps)."""
    ipos_dep, dep_mask, stay, state, C, halo = ctx
    n = cfg.nmesh
    nloc = n // ndev
    x0 = cc.rank() * nloc
    dev = rho_k.device
    kvec = pencil_kvec(n, dev)
    if nu_fac is not None:
        kx, ky, kz = kvec
        kmag = torch.sqrt(kx * kx + ky * ky + kz * kz) \
            * float(np.float32(2 * np.pi / cfg.boxsize))
        rho_k = rho_k * _interp(kmag, nu_k, nu_fac)
    ps = measure_power_pencil(rho_k, cfg) if want_power else None
    pot_k = rho_k * potential_transfer(
        cfg, kvec, _cic_invwindow(cfg, dev, kvec))
    accel = []
    for kj in kvec:
        fslab = pfft_c2r(force_transfer(cfg, kj, pot_k), n)
        if ndev > 1:
            lo_ext = cc.ring_shift(fslab[nloc - halo:], 1, same_shape=True,
                                   tag="pm_halo")
            hi_ext = cc.ring_shift(fslab[:halo], -1, same_shape=True,
                                   tag="pm_halo")
        else:
            lo_ext, hi_ext = fslab[nloc - halo:], fslab[:halo]
        ext = torch.cat([lo_ext, fslab, hi_ext])
        accel.append(cic_readout_slab(ext, ipos_dep, n, halo, x0,
                                      mask=dep_mask))
    accel = torch.stack(accel, dim=-1)
    if state is not None:
        back = route_back(accel[C:].contiguous(), state)
        accel = torch.where(stay[:, None], accel[:C], back)
    return accel, ps


def pm_forces_slab(ipos, mass, cfg, ndev: int, halo: int = 2, mask=None,
                   want_power: bool = False, cuts_in=None, nu_k=None,
                   nu_fac=None):
    """The distributed PM forces, per-rank memory O(N^3/D)
    (pfft.py:340-423): this rank's rows must lie in its slab (uniform
    slabs) or its cost-balanced interval (cuts_in), as the exchange
    leaves them.  Returns (accel [C,3], ps or None)."""
    rho_k, ctx = _depose(ipos, mass, cfg, ndev, halo, mask, cuts_in)
    return pm_forces_from_rhok(rho_k, ctx, cfg, ndev, nu_k, nu_fac,
                               want_power)


def pm_forces_pencil(ipos, mass, cfg):
    """The round-1 multi-device PM (pfft.py:426-468): a full-mesh deposit
    summed over ranks, the pencil FFT of each rank's slab, and the force
    slabs gathered back to full meshes for a readout at any position."""
    n = cfg.nmesh
    D, me = cc.world_size(), cc.rank()
    nloc = n // D
    dev = ipos.device
    mesh = cc.all_sum(cic_deposit(ipos, mass, n))
    rho_k = pfft_r2c(mesh[me * nloc:(me + 1) * nloc].contiguous())
    kvec = pencil_kvec(n, dev)
    pot_k = rho_k * potential_transfer(
        cfg, kvec, _cic_invwindow(cfg, dev, kvec))
    accel = []
    for kj in kvec:
        fslab = pfft_c2r(force_transfer(cfg, kj, pot_k), n)
        fmesh, _ = cc.all_gather_rows(fslab.contiguous())
        accel.append(cic_readout(fmesh, ipos))
    return torch.stack(accel, dim=-1)
