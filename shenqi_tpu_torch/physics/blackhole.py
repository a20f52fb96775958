"""The kernel-weighted gas environment of a set of points
(blackhole.cpp's accretion-walk gather; shenqi_tpu/physics/blackhole.py
:83-143 in torch), which the metal return uses for its stars' weight
sums.  Black holes themselves (seeding, accretion, feedback, swallowing,
mergers, dynamical friction, drag) are ROADMAP A.8's next item.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..sph.kernels import KernelSpec, CUBIC, wk as kern_wk

# pairs of one block of the dense [points x gas] pass
_PAIR_BLOCK = 1 << 24


class BHEnv(NamedTuple):
    """Kernel-weighted gas environment at each point."""
    density: torch.Tensor          # [Nb]
    entropy: torch.Tensor          # [Nb] smoothed entropy / density
    gas_vel: torch.Tensor          # [Nb,3] smoothed velocity / density
    feedback_weight: torch.Tensor  # [Nb] sum m_j wk


def bh_gas_environment(bh_ipos, bh_hsml, gas_ipos, gas_mass,
                       gas_entropy, gas_vel, gas_alive, boxsize,
                       spec: KernelSpec = CUBIC) -> BHEnv:
    """Dense [Nb x Ngas] kernel sums, a block of gas rows at a time (the
    JAX package scans chunks of 8192)."""
    from ..ops.treewalk import pair_dist
    nb = bh_ipos.shape[0]
    ng = gas_ipos.shape[0]
    dev = bh_ipos.device
    dens = torch.zeros(nb, dtype=torch.float32, device=dev)
    sent = torch.zeros_like(dens)
    svel = torch.zeros((nb, 3), dtype=torch.float32, device=dev)
    H = bh_hsml[:, None]
    Hs = torch.clamp(H, min=1e-35)
    cols = max(1, _PAIR_BLOCK // max(nb, 1))
    for g0 in range(0, ng, cols):
        g = slice(g0, min(g0 + cols, ng))
        gm = gas_mass[g]
        _, r2 = pair_dist(bh_ipos[:, None, :], gas_ipos[g][None, :, :],
                          boxsize)
        inside = (r2 < H * H) & gas_alive[g][None, :] & (gm[None, :] > 0)
        u = torch.clamp(torch.sqrt(r2) / Hs, max=1.0)
        w = torch.where(inside, kern_wk(spec, u, Hs), 0.0)
        mw = gm[None, :] * w
        dens += torch.sum(mw, 1)
        sent += torch.sum(mw * gas_entropy[g][None, :], 1)
        svel += mw @ gas_vel[g]
    dsafe = torch.clamp(dens, min=1e-35)
    # the JAX package sums the feedback weight apart from the density,
    # the same sum
    return BHEnv(density=dens, entropy=sent / dsafe,
                 gas_vel=svel / dsafe[:, None], feedback_weight=dens.clone())
