"""Run statistics: energy.txt (shenqi_tpu/utils/stats.py:33-88, the
stats.cpp analog) on the port's ParticleData.

The DM slice writes the energy line only, with no internal energy; the
gas term, the sfr.txt and the black-hole writers come with the gas slice
(ROADMAP A.7, A.8).
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
