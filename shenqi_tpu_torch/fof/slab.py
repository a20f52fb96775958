"""Friends-of-friends over the slab domain (shenqi_tpu/fof/slab.py in
torch.distributed): fof.cpp's cross-rank linking (fof_reduce_links,
fof.cpp:368-482) and catalogue reduction (fof_reduce_groups,
fof.cpp:903).

Labels (fof_label_slab, fof/slab.py:77-176):
  1. the rows within one linking length of the slab arrive as ghosts
     (domain.halo_exchange);
  2. the port's blocked FOF (fof/fof.py fof_label) labels this rank's
     rows plus the ghosts: local components;
  3. every row's GLOBAL label is the minimum particle id of its
     component: each round re-exchanges the boundary rows' labels and
     takes the minimum over each local component, until an all-reduced
     count of changed labels is zero (at most one round per slab a
     group spans; ndev + 2 rounds at most, as in the JAX package).
  Labels are ids, so they do not depend on the rank count.

Catalogue (compile_groups_slab_distributed, fof/slab.py:278-538): each
rank sums its rows into one partial record per label
(_segment_reduce_local), routes the partials to the label's owner rank
(label % D) for the combine (reduce_groups_slab), and the centre of
mass is unwrapped per row against the group's GLOBAL reference (the
position of its minimum-id row) sent back along the same lanes, as
fof_finish_group_properties does.  Only the G-sized group table is
gathered; the particle state stays on its ranks.  Sums are float64.

The JAX builders make_fof_slab and make_group_reduce_slab, which
compile shard_map programs, have no counterpart: the calls are plain.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.particles import POS_SCALE, u32
from ..parallel import collectives as cc
from ..parallel.domain import halo_exchange, route_back, route_rows
from .fof import FOFGroups, compile_groups, fof_label

NOLABEL = (1 << 63) - 1


def _seg_min(comp, g, n):
    m = torch.full((n,), NOLABEL, dtype=torch.int64, device=g.device)
    m.scatter_reduce_(0, comp, g, "amin", include_self=True)
    return m[comp]


def fof_label_slab(fields: dict, b: float, boxsize: float, ndev: int,
                   nlevels: int = 8, cuts_in=None):
    """Global FOF labels of this rank's rows.  fields: 'ipos' (int32
    bits), 'mass' (0 = not linked), 'pid' (int64 ids).  Returns
    (glabel [C] int64: the minimum pid of the row's group, NOLABEL for
    rows of no mass; info with the ghosts and the rounds)."""
    ipos_l, mass_l, pid_l = fields["ipos"], fields["mass"], fields["pid"]
    C = ipos_l.shape[0]
    width_fp = int(np.ceil(b / boxsize * 2 ** 32)) + (1 << 12)
    ghosts = halo_exchange({"ipos": ipos_l, "mass": mass_l, "pid": pid_l},
                           width_fp, ndev, cuts_in)
    ipos = torch.cat([ipos_l, ghosts["ipos"]])
    alive = torch.cat([mass_l, ghosts["mass"]]) > 0
    n = ipos.shape[0]
    comp = (fof_label(ipos, alive, b, boxsize, nlevels=nlevels) if n
            else torch.zeros(0, dtype=torch.int64, device=ipos.device))
    pid = torch.cat([pid_l, ghosts["pid"]])
    g_local = _seg_min(comp, torch.where(alive, pid, NOLABEL), n)[:C]
    rounds = 0
    while ndev > 1 and rounds < ndev + 2:
        gg = halo_exchange({"ipos": ipos_l, "mass": mass_l,
                            "glabel": g_local}, width_fp, ndev,
                           cuts_in)["glabel"]
        g_comb = torch.where(alive, torch.cat([g_local, gg]), NOLABEL)
        g_new = _seg_min(comp, g_comb, n)[:C]
        changed = cc.sum_int(int((g_new != g_local).sum()), ipos.device)
        g_local = g_new
        rounds += 1
        if changed == 0:
            break
    return g_local, {"ghosts": int(ghosts["mass"].shape[0]),
                     "rounds": rounds}


def compile_groups_from_slab(glabel, fields: dict, boxsize: float,
                             min_length: int = 32):
    """The catalogue from every rank's rows gathered on every rank and
    fof.compile_groups (fof/slab.py:232-275): the simple host version
    of compile_groups_slab_distributed, for small runs and tests.  The
    min-pid labels become min-ROW labels so compile_groups' unwrap
    reference applies.  Returns (FOFGroups over the gathered rows in
    rank order, their pids)."""
    alive = fields["mass"] > 0
    g = {k: cc.all_gather_rows(v[alive])[0].cpu().numpy() for k, v in
         dict(lab=glabel, ipos=fields["ipos"], vel=fields["vel"],
              mass=fields["mass"], pid=fields["pid"]).items()}
    pid = g["pid"]
    order = np.argsort(pid, kind="stable")
    rows = order[np.minimum(np.searchsorted(pid[order], g["lab"]),
                            len(pid) - 1)]
    groups = compile_groups(rows, g["ipos"].view(np.uint32), g["vel"],
                            g["mass"], np.full(len(pid), 1, np.int8),
                            np.ones(len(pid), bool), boxsize,
                            min_length=min_length)
    return groups, pid


def _segments(lab):
    """Segment ids of a sorted label column, and the first row flags."""
    newseg = torch.ones_like(lab, dtype=torch.bool)
    newseg[1:] = lab[1:] != lab[:-1]
    return torch.cumsum(newseg.long(), 0) - 1, newseg


def _segsum(seg, v, nseg):
    out = torch.zeros((nseg,) + tuple(v.shape[1:]), dtype=v.dtype,
                      device=v.device)
    return out.index_add_(0, seg, v)


def _segment_reduce_local(lab, pid, posf, vel, mass, ptyp):
    """One partial record per distinct label of this rank's rows
    (fof/slab.py:290-344): lab, ref (the position of the segment's
    minimum-pid row), isref (that row is the group's minimum-id row),
    msum, mvsum, cnt and the per-type mass and count.  Returns (partials,
    rowctx) with rowctx the sorted rows' segment, position and mass for
    the unwrap against the global reference."""
    order = torch.argsort(pid, stable=True)
    order = order[torch.argsort(lab[order], stable=True)]
    labs, pids = lab[order], pid[order]
    poss, vels, ms = posf[order], vel[order].double(), mass[order].double()
    seg, newseg = _segments(labs)
    nseg = int(newseg.sum())
    first = torch.nonzero(newseg).squeeze(1)
    onehot = (ptyp[order].long()[:, None]
              == torch.arange(6, device=lab.device)[None, :])
    part = {"lab": labs[first], "ref": poss[first],
            "isref": (pids[first] == labs[first]).to(torch.int32),
            "msum": _segsum(seg, ms, nseg),
            "mvsum": _segsum(seg, ms[:, None] * vels, nseg),
            "cnt": _segsum(seg, torch.ones_like(seg), nseg),
            "mbt": _segsum(seg, torch.where(onehot, ms[:, None], 0.0), nseg),
            "cbt": _segsum(seg, onehot.long(), nseg)}
    return part, (seg, poss, ms)


def reduce_groups_slab(glabel, fields: dict, boxsize: float, ndev: int):
    """The per-group sums of the labelled rows, each group on its owner
    rank label % D (fof/slab.py:347-450).  Returns a dict of per-group
    tensors (lab, len, mass, cm, vcm, mbt, cbt, first_pos) of the
    groups this rank owns."""
    alive = (fields["mass"] > 0) & (glabel != NOLABEL)
    ipos = fields["ipos"][alive]
    posf = u32(ipos).double() * (boxsize / POS_SCALE)
    part, (segl, poss, ms) = _segment_reduce_local(
        glabel[alive], fields["pid"][alive], posf, fields["vel"][alive],
        fields["mass"][alive], fields["ptyp"][alive])
    me = cc.rank()
    dest = part["lab"] % ndev
    valid = torch.ones_like(dest, dtype=torch.bool)
    recv, state = route_rows(part, dest, valid, ndev)
    stay = dest == me
    comb = {k: torch.cat([part[k][stay], recv[k]]) for k in part}
    order = torch.argsort(comb["lab"], stable=True)
    seg, newseg = _segments(comb["lab"][order])
    nseg = int(newseg.sum())

    def sc(name, w=None):
        v = comb[name][order]
        if w is not None:
            v = torch.where(w[order].reshape((-1,) + (1,) * (v.dim() - 1))
                            > 0, v, torch.zeros_like(v))
        return _segsum(seg, v, nseg)

    REF = sc("ref", comb["isref"])
    M, MV, CNT, MBT, CBT = (sc(k) for k in ("msum", "mvsum", "cnt", "mbt",
                                            "cbt"))
    # the global reference back to every partial's rank, along the lanes
    # the partials came (route_back), so each row unwraps against it
    ref_rows = torch.empty_like(comb["ref"])
    ref_rows[order] = REF[seg]
    n_stay = int(stay.sum())
    ref_part = torch.zeros_like(part["ref"])
    ref_part[stay] = ref_rows[:n_stay]
    ref_part = torch.where(stay[:, None], ref_part,
                           route_back(ref_rows[n_stay:].contiguous(), state))
    d = poss - ref_part[segl]
    d -= boxsize * torch.round(d / boxsize)
    md = _segsum(segl, ms[:, None] * d, part["lab"].shape[0])
    recv2, _ = route_rows({"md": md}, dest, valid, ndev)
    md_comb = torch.cat([md[stay], recv2["md"]])
    MD = _segsum(seg, md_comb[order], nseg)
    first = torch.nonzero(newseg).squeeze(1)
    Mc = torch.clamp(M, min=1e-300)[:, None]
    return {"lab": comb["lab"][order][first], "len": CNT, "mass": M,
            "cm": torch.remainder(REF + MD / Mc, boxsize), "vcm": MV / Mc,
            "mbt": MBT, "cbt": CBT, "first_pos": REF}


def compile_groups_slab_distributed(glabel, fields: dict, boxsize: float,
                                    ndev: int, min_length: int = 32):
    """The catalogue with the per-group reduction on the owner ranks
    (fof/slab.py:453-538): every rank gets the G-sized table, numbered
    1..G by descending length, ties by label (fof_assign_grnr), and the
    group number of each of ITS alive rows.  fields: ipos, vel, mass,
    ptyp, pid of this rank's rows.  Returns (FOFGroups, alive-row
    pids)."""
    tab = reduce_groups_slab(glabel, fields, boxsize, ndev)
    keep = tab["len"] >= min_length
    mine = {k: v[keep].cpu().numpy() for k, v in tab.items()}
    parts = cc.all_gather_object(mine)
    allt = {k: np.concatenate([p[k] for p in parts]) for k in mine}
    order = np.lexsort((allt["lab"], -allt["len"]))
    t = {k: v[order] for k, v in allt.items()}
    G = len(order)
    alive = (fields["mass"] > 0).cpu().numpy()
    lab_rows = glabel.cpu().numpy()[alive]
    s = np.argsort(t["lab"])
    at = np.clip(np.searchsorted(t["lab"][s], lab_rows), 0, max(G - 1, 0))
    group_id = np.zeros(len(lab_rows), np.int64)
    if G:
        hit = t["lab"][s][at] == lab_rows
        group_id[hit] = s[at[hit]] + 1
    groups = FOFGroups(
        ngroups=G, lengths=t["len"].astype(np.int64), masses=t["mass"],
        cm=t["cm"], vel=t["vcm"], mass_by_type=t["mbt"],
        length_by_type=t["cbt"].astype(np.int64), group_id=group_id,
        first_pos=t["first_pos"], sfr=None)
    return groups, fields["pid"].cpu().numpy()[alive]
