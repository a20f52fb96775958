"""The port's sharded snapshots (shenqi_tpu_torch/io/sharded_io.py) on 4
gloo ranks with two writer groups (NUM_WRITERS 2):

  * save_snapshot_sharded's PART file is byte for byte the one the
    single-process writer (io/snapshot.write_snapshot) makes of the same
    rows in rank order, block headers and checksums included, and
    read_snapshot gives every row back bit-exact after sorting by ID
    (the ID words, the exact f8 positions of the uint32 bits, v / a);
  * load_snapshot_sharded hands each rank exactly the rows of its slab,
    positions and masses bit-exact, velocities to rtol 1e-6 (v / a
    written in f4, times a read back), IDs as written;
  * save_snapshot_sharded_multi's PART file of three types, the gas with
    its five SPH blocks, is byte for byte write_snapshot's of the same
    rows (each type's in rank order).
"""

import dataclasses
import os

import numpy as np
import torch

from test_torch_slab_domain import spawn_ranks

D, N, BOX, A = 4, 5000, 64000.0, 0.25


def _state():
    rng = np.random.RandomState(3)
    ipos = rng.randint(0, 2 ** 32, (N, 3), dtype=np.uint64).astype(np.uint32)
    ipos[:100, 0] = 2 ** 32 - 1 - rng.randint(0, 2 ** 20, 100)
    vel = rng.normal(0, 50, (N, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, N).astype(np.float32)
    ids = (rng.permutation(N).astype(np.uint64) + 1) | (np.uint64(3) << 32)
    return ipos, vel, mass, ids


def _header():
    from shenqi_tpu_torch.io.snapshot import SnapshotHeader
    return SnapshotHeader(TotNumPart=np.zeros(6, np.uint64),
                          MassTable=np.zeros(6), Time=A, BoxSize=BOX,
                          Omega0=0.3, OmegaLambda=0.7, TimeIC=0.1)


def _io_body(rank, dev, out):
    from shenqi_tpu_torch.io import sharded_io
    from shenqi_tpu_torch.io.sharded_io import (load_snapshot_sharded,
                                                save_snapshot_sharded)
    from shenqi_tpu_torch.parallel.domain import distribute_slabs
    ipos, vel, mass, ids = _state()
    loc = distribute_slabs({"ipos": ipos, "vel": vel, "mass": mass,
                            "lo": (ids & np.uint64(0xFFFFFFFF)).astype(
                                np.uint32).view(np.int32),
                            "hi": (ids >> np.uint64(32)).astype(
                                np.uint32).view(np.int32)}, D, rank)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in loc.items()}
    sharded_io.NUM_WRITERS = 2         # two writer groups of two ranks
    save_snapshot_sharded(f"{out}/PART_000", _header(),
                          {"ipos": t["ipos"].view(torch.int32),
                           "vel": t["vel"], "mass": t["mass"],
                           "pid": t["lo"], "pid_hi": t["hi"]},
                          BOX, A)
    sharded_io.CHUNK = 1024            # stream the file in five pieces
    back = load_snapshot_sharded(f"{out}/PART_000", BOX, device="cpu")
    np.savez(f"{out}/rank{rank}.npz", **{k: v.numpy() for k, v in
                                          back.items()},
             sent=loc["ipos"])


def test_sharded_snapshot_round_trip(tmp_path):
    from shenqi_tpu_torch.io.snapshot import read_snapshot, write_snapshot
    ranks = spawn_ranks(_io_body, D, tmp_path)
    ipos, vel, mass, ids = _state()
    x = ipos[:, 0].astype(np.int64) >> 30          # the owner slab
    h, b = read_snapshot(str(tmp_path / "PART_000"))
    assert int(h.TotNumPart[1]) == N and h.Time == A
    got_pos = b[1]["Position"]
    pos64 = ipos.astype(np.float64) * (BOX / 2 ** 32)
    o = np.argsort(b[1]["ID"])
    oi = np.argsort(ids)
    np.testing.assert_array_equal(b[1]["ID"][o], ids[oi])
    np.testing.assert_array_equal(got_pos[o], pos64[oi])
    np.testing.assert_array_equal(b[1]["Velocity"][o], (vel / A)[oi])
    np.testing.assert_array_equal(b[1]["Mass"][o], mass[oi])
    # the file's rows are rank 0's, then rank 1's, ...
    sent = np.concatenate([r["sent"] for r in ranks]).view(np.uint32)
    np.testing.assert_array_equal(got_pos, sent.astype(np.float64)
                                  * (BOX / 2 ** 32))
    # byte-identical to write_snapshot of the same rows
    perm = oi[np.argsort(o)]           # file row -> state row
    want_dir = tmp_path / "single"
    write_snapshot(str(want_dir), dataclasses.replace(
        _header(), TotNumPart=h.TotNumPart),
        {1: {"Position": pos64[perm], "Velocity": (vel / A)[perm],
             "Mass": mass[perm], "ID": ids[perm]}})
    for root, _, files in os.walk(want_dir):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), want_dir)
            with open(os.path.join(root, f), "rb") as fa, \
                    open(tmp_path / "PART_000" / rel, "rb") as fb:
                assert fa.read() == fb.read(), rel
    # the loader: each rank its slab's rows
    for r, res in enumerate(ranks):
        mine = np.nonzero(x == r)[0]
        got = np.sort(res["pid"])
        np.testing.assert_array_equal(got, np.sort(ids[mine]).astype(
            np.int64))
        k = np.argsort(res["pid"])
        m = mine[np.argsort(ids[mine])]
        np.testing.assert_array_equal(res["ipos"].view(np.uint32)[k],
                                      ipos[m])
        np.testing.assert_array_equal(res["mass"][k], mass[m])
        np.testing.assert_allclose(res["vel"][k], vel[m], rtol=1e-6)


def _gas_cols():
    rng = np.random.RandomState(5)
    ptype = rng.choice(np.array([0, 1, 4], np.int8), N, p=[0.45, 0.5, 0.05])
    cols = {k: rng.uniform(lo, hi, N).astype(np.float32) for k, lo, hi in (
        ("hsml", 10.0, 900.0), ("density", 1e-9, 1e-6),
        ("egywt", 1e-9, 1e-6), ("entropy", 1e3, 1e6))}
    return ptype, cols


def _io_multi_body(rank, dev, out):
    from shenqi_tpu_torch.io import sharded_io
    from shenqi_tpu_torch.io.sharded_io import save_snapshot_sharded_multi
    from shenqi_tpu_torch.parallel.domain import distribute_slabs
    ipos, vel, mass, ids = _state()
    ptype, cols = _gas_cols()
    loc = distribute_slabs({"ipos": ipos, "vel": vel, "mass": mass,
                            "lo": (ids & np.uint64(0xFFFFFFFF)).astype(
                                np.uint32).view(np.int32),
                            "hi": (ids >> np.uint64(32)).astype(
                                np.uint32).view(np.int32),
                            "ptype": ptype, "row": np.arange(N), **cols},
                           D, rank)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in loc.items()}
    sharded_io.NUM_WRITERS = 2         # two writer groups of two ranks
    save_snapshot_sharded_multi(
        f"{out}/PART_000", _header(),
        {"ipos": t["ipos"].view(torch.int32), "vel": t["vel"],
         "mass": t["mass"], "pid": t["lo"], "pid_hi": t["hi"],
         "ptype": t["ptype"]}, BOX, A, gas={k: t[k] for k in cols})
    np.savez(f"{out}/rank{rank}.npz", row=loc["row"])


def test_sharded_multi_species_equals_single_writer(tmp_path):
    """save_snapshot_sharded_multi's file (three types, the gas with its
    five SPH blocks) is byte for byte write_snapshot's of the same rows:
    each type's rows in rank order, InternalEnergy as the single-device
    CLI writes it."""
    from shenqi_tpu_torch.io.sharded_io import gas_internal_energy
    from shenqi_tpu_torch.io.snapshot import read_snapshot, write_snapshot
    ranks = spawn_ranks(_io_multi_body, D, tmp_path)
    ipos, vel, mass, ids = _state()
    ptype, cols = _gas_cols()
    rows = np.concatenate([r["row"] for r in ranks])     # file row order
    pos64 = ipos.astype(np.float64) * (BOX / 2 ** 32)
    blocks = {}
    for t in (0, 1, 4):
        r = rows[ptype[rows] == t]
        blocks[t] = {"Position": pos64[r], "Velocity": (vel / A)[r],
                     "Mass": mass[r], "ID": ids[r]}
        if t == 0:
            blocks[t].update(
                SmoothingLength=cols["hsml"][r], Density=cols["density"][r],
                EgyWtDensity=cols["egywt"][r], Entropy=cols["entropy"][r],
                InternalEnergy=gas_internal_energy(
                    cols["entropy"][r], cols["density"][r], A))
    h, b = read_snapshot(str(tmp_path / "PART_000"))
    counts = np.bincount(ptype, minlength=6)
    np.testing.assert_array_equal(h.TotNumPart, counts)
    assert sorted(b) == [0, 1, 4] and sorted(b[0]) == sorted(blocks[0])
    want_dir = tmp_path / "single"
    write_snapshot(str(want_dir), dataclasses.replace(
        _header(), TotNumPart=h.TotNumPart), blocks)
    dirs = set()
    for root, _, files in os.walk(want_dir):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), want_dir)
            with open(os.path.join(root, f), "rb") as fa, \
                    open(tmp_path / "PART_000" / rel, "rb") as fb:
                assert fa.read() == fb.read(), rel
            dirs.add(os.path.dirname(rel))
    assert len(dirs - {"Header", ""}) == 3 * 4 + 5     # every block
