"""Short-range gravity on a slab domain (shenqi_tpu/parallel/sharded.py
in torch.distributed).

`stencil_forces_slab` is sharded.py:291-339: the ghost rows within rcut
and one stencil cell (halo_width_fp) arrive through the halo exchange,
then the grid-stencil engine (gravity/stencil.py, whose pair sums are
the hand-written kernel ops/p2p.py) runs on this rank's rows plus the
ghosts, with this rank's alive rows as the only targets: each rank
computes the forces of its own rows from the sources the single-device
engine would sum, so the result equals its result up to f32 summation
order.

The JAX layer needed static shapes inside shard_map: a fixed ghost
capacity and stencil caps resolved on the host (stencil_static_config,
sharded.py:278), regrown from a pmax'd diagnostic.  The port's stencil
sizes its caps from the counts at run time, with grow-only caches per
rank, so neither exists here.  `make_mesh` (sharded.py:47) is the
process-group setup of parallel/collectives.py; the round-1 library
steps make_sharded_step / make_slab_step, which no CLI reaches, are
not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..gravity.stencil import stencilgrav, stencilgrav_fused
from .domain import halo_exchange


def halo_width_fp(rcut: float, boxsize: float) -> int:
    """The ghost strip of the short range in fixed point: rcut plus one
    cell of the stencil's grid, with the JAX package's 2^16 slack.  The
    engine sums every source of the cells within rcut of a target
    sub-block, the window's tail included, so a source up to rcut plus
    one cell from the slab can enter a local target's sum; shipping all
    of them gives the single-device sums.  (sharded.py:312 ships rcut
    only, which leaves part of that tail out near the slab faces.)"""
    k = min(int(np.ceil(np.log2(boxsize / rcut))), 10)
    return int(np.ceil((rcut + boxsize / 2 ** k) / boxsize * 2 ** 32)) \
        + (1 << 16)


def stencil_forces_slab(fields: dict, sp, window_tables, ndev: int,
                        cuts_in=None, sub: int = 32, tier_cache=None,
                        caps_cache=None, _plain: bool = False):
    """Short-range forces of this rank's alive rows (mass > 0) from the
    alive rows of every rank within the ghost strip.  fields: {'ipos', 'mass'} of
    this rank's rows.  Returns (acc [C,3], info) with info['ghosts'] the
    ghost rows received."""
    ipos_l, mass_l = fields["ipos"], fields["mass"]
    C = ipos_l.shape[0]
    ghosts = halo_exchange({"ipos": ipos_l, "mass": mass_l},
                           halo_width_fp(sp.rcut, sp.boxsize), ndev,
                           cuts_in)
    ipos = torch.cat([ipos_l, ghosts["ipos"]])
    mass = torch.cat([mass_l, ghosts["mass"]])
    active = torch.zeros(ipos.shape[0], dtype=torch.bool,
                         device=ipos.device)
    active[:C] = mass_l > 0
    n_act = int(active.sum())
    info = {"ghosts": int(ghosts["mass"].shape[0]), "targets": n_act}
    if n_act == 0:
        return torch.zeros((C, 3), dtype=torch.float32,
                           device=ipos.device), info
    kw = dict(sub=sub, n_targets=n_act, active=active,
              tier_cache=tier_cache, caps_cache=caps_cache,
              want_pot=False, _plain=_plain)
    acc, _, ok = stencilgrav_fused(ipos, mass, sp, window_tables, **kw)
    if not bool(ok):
        acc, _, _ = stencilgrav(ipos, mass, sp, window_tables, **kw)
    return acc[:C], info
