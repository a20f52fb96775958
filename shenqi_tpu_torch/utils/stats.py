"""Run statistics: energy.txt (shenqi_tpu/utils/stats.py:33-88, the
stats.cpp analog) on the port's ParticleData, sfr.txt (stats.py:89
`sfr_statistics`), and blackholes.txt with the BlackholeDetails.bin
records (stats.py:136-232).  The energy line has no internal energy
term.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.particles import BH, ipos_to_float
from .constants import (GRAVITY, LIGHTCGS, PROTONMASS, THOMPSON, SOLAR_MASS,
                        SEC_PER_YEAR)

# BlackholeDetails.bin's fixed record (bhinfo.cpp collect_BH_info analog)
BH_DETAIL_DTYPE = np.dtype([
    ("ID", "<u8"), ("Time", "<f8"), ("Mass", "<f4"), ("Mdot", "<f4"),
    ("Density", "<f4"), ("Pos", "<f4", 3), ("Vel", "<f4", 3)])


def _energy_reduce(particles, atime):
    """Device-side energy sums in f32, as the JAX package reduces them
    (one host pull of the sums)."""
    p = particles
    m = torch.where(p.mask, p.mass, 0.0)
    ekin = 0.5 * torch.sum(m * torch.sum(p.vel ** 2, dim=1)) / atime ** 2
    epot = 0.5 * torch.sum(m * p.potential)
    return torch.stack([epot, ekin]).tolist()


def energy_statistics_fast(fd, atime, particles):
    """energy.txt line from one device reduction: time, total internal
    energy, potential energy, kinetic energy."""
    epot, ekin = _energy_reduce(particles, atime)
    fd.write(f"{atime:g} {0.0:g} {epot:g} {ekin:g}\n")
    fd.flush()


def energy_statistics(fd, atime, particles):
    """Append one line to energy.txt with host sums (stats.cpp
    energy_statistics layout)."""
    mask = particles.mask.cpu().numpy()
    mass = particles.mass.cpu().numpy()[mask]
    vel = particles.vel.cpu().numpy()[mask]
    pot = particles.potential.cpu().numpy()[mask]
    ekin = 0.5 * float((mass * (vel ** 2).sum(axis=1)).sum()) / atime ** 2
    epot = 0.5 * float((mass * pot).sum())
    fd.write(f"{atime:g} {0.0:g} {epot:g} {ekin:g}\n")
    fd.flush()


def sfr_statistics(fd, atime, total_sm, totsfrrate, rate_in_msunperyear,
                   total_sum_mass_stars, avg_dtime, total_sum_part,
                   tot_newstars):
    """Append one line to sfr.txt in the reference's 8-column layout
    (sfr_eff.cpp write_sfr_txt; shenqi_tpu/utils/stats.py:89): scale
    factor, expected stellar mass formed (internal units), instantaneous
    SFR of active particles [Msun/yr], expected SFR from total_sm
    [Msun/yr], actual spawned stellar mass this step (internal units),
    mean active-particle timestep, number of star-forming particles,
    number of new stars this step."""
    fd.write(f"{atime:g} {total_sm:g} {totsfrrate:g} "
             f"{rate_in_msunperyear:g} {total_sum_mass_stars:g} "
             f"{avg_dtime:g} {int(total_sum_part)} "
             f"{int(tot_newstars)}\n")
    fd.flush()


def _bh_txt_line(fd, atime, nbh, m, md, units):
    """One blackholes.txt line: time, N_bh, total subgrid mass, total
    Mdot (internal), Mdot in Msun/yr, summed Eddington ratio
    (bhinfo.cpp write_blackhole_txt layout); the sums over the f32
    arrays in numpy, as the JAX package's."""
    mtot = float(m.sum())
    mdot = float(md.sum())
    medd = float((md / np.maximum(m, 1e-35)).sum())
    mdot_msun_yr = mdot * (units.UnitMass_in_g / SOLAR_MASS) \
        / (units.UnitTime_in_s / SEC_PER_YEAR)
    medd /= ((4 * np.pi * GRAVITY * LIGHTCGS * PROTONMASS
              / (0.1 * LIGHTCGS ** 2 * THOMPSON)) * units.UnitTime_in_s)
    fd.write(f"{atime:g} {nbh} {mtot:g} {mdot:g} {mdot_msun_yr:g} "
             f"{medd:g}\n")
    fd.flush()


def _bh_records(atime, ids, m, md, dens, pos, vel):
    rec = np.zeros(len(ids), dtype=BH_DETAIL_DTYPE)
    rec["ID"] = ids
    rec["Time"] = atime
    rec["Mass"] = m
    rec["Mdot"] = md
    rec["Density"] = dens
    rec["Pos"] = pos
    rec["Vel"] = vel
    return rec


def bh_statistics_fast(fd_bh, fd_bhdet, atime, particles, gas, boxsize,
                       units):
    """blackholes.txt + BlackholeDetails records of the alive BH rows
    (ptype BH with a subgrid mass), from one gather of those rows on the
    device (stats.py:136-183 of the JAX package).  Nothing is written
    before the first BH exists (blackhole.cpp:221-223).  Returns the BH
    count."""
    p = particles
    n = p.n
    alive = p.mask & (p.ptype == BH) & (gas.bh_mass > 0)
    nbh = int(alive.sum())
    if nbh == 0:
        return 0
    idx = torch.nonzero(alive).squeeze(1)
    dens = torch.zeros(n, dtype=gas.density.dtype, device=p.device)
    dens[:gas.density.shape[0]] = gas.density
    f = torch.cat([gas.bh_mass[idx, None], gas.bh_mdot[idx, None],
                   dens[idx, None], ipos_to_float(p.ipos[idx], boxsize),
                   p.vel[idx]], 1).cpu().numpy()
    lo, hi = (w[idx].cpu().numpy().view(np.uint32).astype(np.uint64)
              for w in (p.id_lo, p.id_hi))
    m, md = np.ascontiguousarray(f[:, 0]), np.ascontiguousarray(f[:, 1])
    if fd_bh is not None:
        _bh_txt_line(fd_bh, atime, nbh, m, md, units)
    if fd_bhdet is not None:
        _bh_records(atime, (hi << np.uint64(32)) | lo, m, md, f[:, 2],
                    f[:, 3:6], f[:, 6:9]).tofile(fd_bhdet)
        fd_bhdet.flush()
    return nbh


def blackhole_statistics(fd, atime, bh_mass, bh_mdot, alive, units):
    """Append one line to blackholes.txt from host arrays (stats.py:186
    of the JAX package): the rows `alive` with a subgrid mass."""
    m = np.asarray(bh_mass)
    md = np.asarray(bh_mdot)
    sel = np.asarray(alive) & (m > 0)
    _bh_txt_line(fd, atime, int(sel.sum()), m[sel], md[sel], units)


def bh_details(fd, atime, ids, bh_mass, bh_mdot, density, pos, vel,
               alive):
    """Append the BlackholeDetails.bin records of the rows `alive` with a
    subgrid mass, from host arrays (stats.py:208 of the JAX package):
    [u8 id, f8 time, f4 mass, f4 mdot, f4 density, 3f4 pos, 3f4 vel]."""
    sel = np.asarray(alive) & (np.asarray(bh_mass) > 0)
    idx = np.nonzero(sel)[0]
    if idx.size == 0:
        return 0
    _bh_records(atime, np.asarray(ids)[idx], np.asarray(bh_mass)[idx],
                np.asarray(bh_mdot)[idx], np.asarray(density)[idx],
                np.asarray(pos)[idx], np.asarray(vel)[idx]).tofile(fd)
    fd.flush()
    return idx.size
