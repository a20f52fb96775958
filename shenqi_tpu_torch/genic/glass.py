"""Glass pre-IC generation (libgenic/glass.cpp analog;
shenqi_tpu/genic/glass.py in torch).

Evolves random particles under REVERSED PM gravity with damped steps:
mutual repulsion relaxes them into a glass-like configuration with
sub-Poisson noise.  Same scheme as the reference glass_evolve: PM-only
force, velocity = -force * damping, fixed step count.  The positions are
int32 bit patterns of the uint32 fixed point; a step adds its int32
displacement modulo 2^32 (ROADMAP C.1).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..core.particles import float_to_ipos, u32, wrap_i32, POS_SCALE
from ..gravity.pm import PMConfig, pm_forces


def make_glass(ngrid: int, boxsize: float, seed: int = 1,
               nsteps: int = 30, nmesh: int = None, device=None):
    """Return glass particle positions [ngrid^3, 3] (internal units, host
    float64); the steps run on `device` (CUDA unless the caller asks for
    the CPU)."""
    dev = resolve_device(device)
    nmesh = nmesh or ngrid
    n = ngrid ** 3
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, boxsize, (n, 3))
    cfg = PMConfig(nmesh=nmesh, boxsize=boxsize, G=1.0, asmth=0.0)
    mass = torch.ones(n, dtype=torch.float32, device=dev)

    ipos = float_to_ipos(pos, boxsize, device=dev)
    # damping scaled so typical first-step moves are ~ mean separation
    sep = boxsize / ngrid
    scale = float(np.float32(POS_SCALE / boxsize))
    for i in range(nsteps):
        accel, _, _ = pm_forces(ipos, mass, cfg, want_potential=False)
        amax = float(torch.max(torch.linalg.norm(accel, dim=-1)))
        if amax <= 0:
            break
        damping = float(np.float32(0.3 * sep / amax))
        dx_fp = (-accel * damping) * scale
        ipos = wrap_i32(ipos.long() + dx_fp.to(torch.int32).long())
    return u32(ipos).to(torch.float64).cpu().numpy() * (boxsize / POS_SCALE)
