"""`gadget_main --mesh N` with gas on N cards against the single-device
run on one card: chip_smoke's travis-hydro paramfiles (validation/
travis.py:38-98, every subgrid switch off) at Ngrid 64 (2 x 64^3 in
128 Mpc/h), z = 99 to a = 0.012 with outputs at 0.01 and 0.012, and
Nmesh 2.5 Ngrid in both runs (160; travis' default, 2 (2 Ngrid^3)^(1/3)
= 162, splits into slabs for no rank count above 2).

Prints each run's seconds, each rank's gas rows, ghosts, exchanged rows
and hsml-loop iterations per step, and the --mesh run's PART_001 by ID
against the single-device one at tests/test_slab_gas.py's limits (the
median entropy within rtol 5e-3; at least 95% of the gas rows within
rtol 2e-2 in Density, 4e-2 in SmoothingLength and 1e-2 in entropy; the
95th percentile of |dv| under 2e-2 of the largest |v|).  Exits 1 when a
limit is missed.

With --subgrid, the subgrid sources instead, on a star-forming clump:
NG^3 gas + NG^3 DM at a = 0.1 in star-small's 5 Mpc/h box (the gas
lattice jittered, CLUMP gas rows in a sphere of radius 0.25% of the box,
four old stars, two of them in the clump: tests/test_torch_gas_cli.py's
star IC at this size, its clump half as wide so that it stays above
star-small's density threshold at 64^3), star-small's paramfile (chip_smoke._GADGET_STARS:
CoolingOn, StarformationOn, ofjt10 winds, MetalReturnOn) with
BlackHoleOn, a UVFluctuationFile, MESH_SUB_SF and SUBGRID_SEEDING (the
clump's group seeds at the first PM step's FOF), to a = 0.1002 (outputs
0.1001, 0.1002), Nmesh 2.5 NG; --mesh N against --mesh 1 on one card
(the same slab loop, its draws keyed by ID).  Prints each rank's source
stages (gathered packs, collectives, seconds) and PART_001 by ID: the
star and BH IDs of the two runs (at most 1% of either set differing: a
draw within f32 rounding of its threshold may flip when a sum's order
changes), the rows in both within 2e-5 of the box for 99% of them, the
95th percentile of |dv| under 2e-2 of the largest |v|, the total mass
within 1e-6 of the --mesh 1 run's at its first output.

    python3 tools/torch_mesh_cards.py OUTDIR [N]     # N: the cards used
    python3 tools/torch_mesh_cards.py OUTDIR N --cpu NG   # gloo, Ngrid NG
    python3 tools/torch_mesh_cards.py OUTDIR N --subgrid [--cpu NG]
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (_GADGET_GAS, _GADGET_STARS, _GENIC_GAS,  # noqa
                        MESH_SUB_SF, _class_tk_table, _dm_small_cosmology,
                        _eh_table, _zreion_table)


def _rank_hook(event, sim, outdir):
    """Each rank's per-step records, saved at the end of its run."""
    if event != "end":
        return
    from shenqi_tpu_torch.parallel import collectives as cc
    torch.save({"sph_log": sim.sph_log, "exchange_log": sim.exchange_log,
                "force_log": sim.force_log, "counts": dict(cc.COUNTS),
                "source_log": sim.source_log, "seed_log": sim.seed_log,
                "star_count": sim.star_count},
               os.path.join(outdir, f"rank{cc.rank()}.pt"))


def _by_id(b):
    o = np.argsort(b["ID"])
    return {k: v[o] for k, v in b.items()}


# the clump's gas rows and the seeding thresholds it passes (its group:
# CLUMP gas rows of star-small's gas mass, 0.08 at 64^3, and two old
# stars of half that)
CLUMP = 128
SUBGRID_SEEDING = "MinFoFMassForNewSeed = 0.05\nMinMStarForNewSeed = 1e-4\n"


def _clump_ic(path, ng):
    """tests/test_torch_gas_cli.py's star IC (_star_ic) at ng^3: the gas
    lattice jittered by 5% of a cell, CLUMP rows in a sphere of radius
    0.25% of the box around (0.3, 0.4, 0.5) (0.5% there), four old stars
    at half the gas mass, the first two in the clump."""
    from shenqi_tpu_torch.cosmology.background import Cosmology
    from shenqi_tpu_torch.io.snapshot import SnapshotHeader, write_snapshot
    from shenqi_tpu_torch.utils.units import default_units
    box, a = 5000.0, 0.1
    cp = Cosmology(Omega0=0.288, OmegaLambda=0.712, OmegaBaryon=0.0472,
                   HubbleParam=0.7, RadiationOn=1)
    cp.init(a, default_units())
    rng = np.random.default_rng(7)
    n = ng ** 3
    g = (np.arange(ng) + 0.5) * box / ng
    lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    gpos = lat + rng.normal(0, 0.05 * box / ng, lat.shape)
    r = 0.0025 * box * rng.uniform(0, 1, CLUMP) ** (1 / 3)
    d = rng.normal(size=(CLUMP, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    gpos[:CLUMP] = np.array([0.3, 0.4, 0.5]) * box + r[:, None] * d
    mg = cp.OmegaBaryon * cp.RhoCrit * box ** 3 / n
    md = (cp.Omega0 - cp.OmegaBaryon) * cp.RhoCrit * box ** 3 / n
    spos = lat[rng.choice(n, 4, replace=False)] + 0.3
    spos[:2] = np.array([0.3, 0.4, 0.5]) * box + 2.0 * np.arange(2)[:, None]

    def vel(m):
        return rng.normal(0, 5, (m, 3)).astype(np.float32)

    blocks = {
        0: {"Position": gpos % box, "Velocity": vel(n),
            "Mass": np.full(n, mg, np.float32),
            "ID": np.arange(1, n + 1, dtype=np.uint64)},
        1: {"Position": (lat + 0.5 * box / ng) % box, "Velocity": vel(n),
            "Mass": np.full(n, md, np.float32),
            "ID": np.arange(n + 1, 2 * n + 1, dtype=np.uint64)},
        4: {"Position": spos, "Velocity": vel(4),
            "Mass": np.full(4, mg / 2, np.float32),
            "ID": np.arange(2 * n + 1, 2 * n + 5, dtype=np.uint64)}}
    write_snapshot(path, SnapshotHeader(
        TotNumPart=np.array([n, n, 0, 0, 4, 0], np.uint64),
        MassTable=np.zeros(6), Time=a, BoxSize=box, Omega0=0.288,
        OmegaLambda=0.712, OmegaBaryon=0.0472, HubbleParam=0.7,
        UsePeculiarVelocity=1, TimeIC=a), blocks)
    return path


def subgrid(out, ndev, ng=64, device=None):
    """--mesh ndev against --mesh 1 with the subgrid sources."""
    from shenqi_tpu_torch.cli.gadget_main import run_gadget
    from shenqi_tpu_torch.io.snapshot import read_snapshot
    if device is None:
        print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                       "--format=csv,noheader").read().strip(), flush=True)
    os.makedirs(out, exist_ok=True)
    ic = _clump_ic(os.path.join(out, "IC"), ng)
    uvf = _zreion_table(os.path.join(out, "UVF"), 5.0)
    runs = {}
    for mesh in (1, ndev):
        od = os.path.join(out, f"mesh{mesh}")
        pf = os.path.join(out, f"mesh{mesh}.gadget")
        with open(pf, "w") as f:
            f.write(_GADGET_STARS.format(ic=ic, out=od,
                                         outputs="0.1001,0.1002", a=0.1002)
                    .replace("BlackHoleOn = 0", "BlackHoleOn = 1")
                    + SUBGRID_SEEDING + MESH_SUB_SF
                    + f"UVFluctuationFile = {uvf}\nNmesh = {5 * ng // 2}\n")
        t = time.perf_counter()
        run_gadget(pf, 2, mesh_devices=mesh, rank_hook=_rank_hook,
                   mesh_timeout=300.0, device=device)
        runs[mesh] = od
        print(f"--mesh {mesh}: {time.perf_counter() - t:.2f} s", flush=True)
        for r in range(mesh):
            rec = torch.load(os.path.join(od, f"rank{r}.pt"),
                             weights_only=False)
            for e in rec["source_log"]:
                print(f"  rank {r} step {e['step']} {e['stage']}: pack "
                      f"{e['pack']}, {e['collectives']} collectives, "
                      f"{e['s']:.3f} s" + "".join(
                          f", {k} {v}" for k, v in e.items() if k not in (
                              "step", "stage", "pack", "collectives", "s")))
            print(f"  rank {r}: stars formed {rec['star_count']}, seeds "
                  f"{rec['seed_log']}, collectives {rec['counts']}")
    _, b0 = read_snapshot(os.path.join(runs[1], "PART_000"))
    _, b1 = read_snapshot(os.path.join(runs[1], "PART_001"))
    h2, b2 = read_snapshot(os.path.join(runs[ndev], "PART_001"))
    m0 = sum(float(b["Mass"].sum(dtype=np.float64)) for b in b0.values())
    m2 = sum(float(b["Mass"].sum(dtype=np.float64)) for b in b2.values())
    ok = abs(m2 / m0 - 1) < 1e-6
    line = [f"total mass {abs(m2 / m0 - 1):.3e} off --mesh 1's at its first "
            f"output (limit 1e-6)"]
    for t_ in (4, 5):
        i1 = set(b1[t_]["ID"].tolist()) if t_ in b1 else set()
        i2 = set(b2[t_]["ID"].tolist()) if t_ in b2 else set()
        diff = len(i1 ^ i2)
        line.append(f"type {t_}: {len(i2)} rows against {len(i1)}, "
                    f"{diff} IDs in one run only")
        ok &= (bool(i1) or t_ == 5) and diff <= 0.01 * max(len(i1), len(i2))
    box = h2.BoxSize
    for t_ in sorted(set(b1) & set(b2)):
        x1, x2 = _by_id(b1[t_]), _by_id(b2[t_])
        both = np.intersect1d(x1["ID"], x2["ID"])
        s1 = np.searchsorted(x1["ID"], both)
        s2 = np.searchsorted(x2["ID"], both)
        d = np.abs(x1["Position"][s1] - x2["Position"][s2])
        d = np.minimum(d, box - d).max(axis=1) / box
        dv = np.linalg.norm(x1["Velocity"][s1] - x2["Velocity"][s2], axis=1)
        vmax = np.linalg.norm(x1["Velocity"], axis=1).max()
        frac, p95 = float((d < 2e-5).mean()), float(np.percentile(dv, 95)
                                                    / vmax)
        line.append(f"type {t_}: {len(both)} rows in both, {frac:.4f} within"
                    f" 2e-5 of the box, |dv| p95 {p95:.3e} of the largest")
        ok &= frac >= 0.99 and p95 < 2e-2
    print(f"--mesh {ndev} against --mesh 1 at a={h2.Time:.5f}: "
          + "; ".join(line), flush=True)
    return 0 if ok else 1


def _entropy(g, a):
    from shenqi_tpu_torch.utils.constants import GAMMA_MINUS1
    return (GAMMA_MINUS1 * g["InternalEnergy"].astype(np.float64)
            / (g["Density"].astype(np.float64) / a ** 3) ** GAMMA_MINUS1)


def main(out, ndev, ng=64, device=None):
    from shenqi_tpu_torch.cli.gadget_main import run_gadget
    from shenqi_tpu_torch.cli.genic_main import run_genic
    from shenqi_tpu_torch.io.snapshot import read_snapshot
    if device is None:
        print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                       "--format=csv,noheader").read().strip(), flush=True)
    os.makedirs(out, exist_ok=True)
    pk, tk = os.path.join(out, "pk.txt"), os.path.join(out, "tk.txt")
    _eh_table(pk)
    _class_tk_table(tk, _dm_small_cosmology(), 0.01)
    gp = os.path.join(out, "p.genic")
    with open(gp, "w") as f:
        f.write(_GENIC_GAS.format(out=os.path.join(out, "ics"), ng=ng,
                                  pk=pk, tk=tk, dtf=1))
    ic = run_genic(gp, device=device)
    runs = {}
    for name, mesh in (("single", 0), (f"mesh{ndev}", ndev)):
        od = os.path.join(out, name)
        pf = os.path.join(out, f"{name}.gadget")
        with open(pf, "w") as f:
            f.write(_GADGET_GAS.format(ic=ic, out=od, outputs="0.01,0.012",
                                       a=0.012) + f"Nmesh = {5 * ng // 2}\n")
        t = time.perf_counter()
        if mesh:
            run_gadget(pf, 2, mesh_devices=mesh, rank_hook=_rank_hook,
                       mesh_timeout=300.0, device=device)
        else:
            run_gadget(pf, 2, device=device)
            if device is None:
                torch.cuda.synchronize()
        runs[name] = od
        print(f"{name}: {time.perf_counter() - t:.2f} s", flush=True)
    od = runs[f"mesh{ndev}"]
    for r in range(ndev):
        rec = torch.load(os.path.join(od, f"rank{r}.pt"), weights_only=False)
        sent = {s_: n for s_, n, _ in rec["exchange_log"]}
        for x in rec["sph_log"]:
            print(f"rank {r} step {x['step']}: {x['gas']} gas rows, ghosts "
                  f"{x['dens_ghosts']} density / {x['hydro_ghosts']} hydro, "
                  f"exchange sent {sent.get(x['step'], 0)} rows, hsml loop "
                  f"{x['niter']} iterations, {x['strips']} strips, SPH "
                  f"{x['density_s'] + x['fp_s'] + x['hydro_s']:.3f} s")
        print(f"rank {r} collectives: {rec['counts']}")
    h1, b1 = read_snapshot(os.path.join(runs["single"], "PART_001"))
    h2, b2 = read_snapshot(os.path.join(od, "PART_001"))
    a = h1.Time
    for t_ in b1:
        o1, o2 = np.argsort(b1[t_]["ID"]), np.argsort(b2[t_]["ID"])
        assert np.array_equal(b1[t_]["ID"][o1], b2[t_]["ID"][o2])
        b1[t_] = {k: v[o1] for k, v in b1[t_].items()}
        b2[t_] = {k: v[o2] for k, v in b2[t_].items()}
    g1, g2 = b1[0], b2[0]
    e1, e2 = _entropy(g1, a), _entropy(g2, a)
    med = abs(float(np.median(e2) / np.median(e1) - 1))
    share = {n: float(np.isclose(x, y, rtol=rt).mean()) for n, x, y, rt in (
        ("Density", g2["Density"], g1["Density"], 2e-2),
        ("SmoothingLength", g2["SmoothingLength"], g1["SmoothingLength"],
         4e-2), ("entropy", e2, e1, 1e-2))}
    v1 = np.concatenate([b1[t_]["Velocity"] for t_ in sorted(b1)])
    v2 = np.concatenate([b2[t_]["Velocity"] for t_ in sorted(b2)])
    dv = float(np.percentile(np.linalg.norm(v2 - v1, axis=1), 95)
               / np.abs(v1).max())
    print(f"--mesh {ndev} against one card at a={a:.5f}: median entropy "
          f"within {med:.3e} (limit 5e-3), rows within the limits "
          f"{share} (at least 0.95), 95th percentile |dv| {dv:.3e} of the "
          f"largest |v| (limit 2e-2)", flush=True)
    ok = med < 5e-3 and min(share.values()) > 0.95 and dv < 2e-2
    return 0 if ok else 1


if __name__ == "__main__":
    argv = sys.argv[1:]
    cpu = None
    if "--cpu" in argv:
        i = argv.index("--cpu")
        cpu = int(argv[i + 1])
        del argv[i:i + 2]
    run = main
    if "--subgrid" in argv:
        argv.remove("--subgrid")
        run = subgrid
    n = int(argv[1]) if len(argv) > 1 else torch.cuda.device_count()
    sys.exit(run(argv[0], n, ng=cpu or 64, device="cpu" if cpu else None))
