"""Run statistics: energy.txt (shenqi_tpu/utils/stats.py:33-88, the
stats.cpp analog) on the port's ParticleData, and sfr.txt (stats.py:89
`sfr_statistics`).  The energy line has no internal energy term; the
black-hole writers come with ROADMAP A.8's black holes.
"""

from __future__ import annotations

import torch


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
