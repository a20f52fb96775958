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

    python3 tools/torch_mesh_cards.py OUTDIR [N]     # N: the cards used
    python3 tools/torch_mesh_cards.py OUTDIR N --cpu NG   # gloo, Ngrid NG
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (_GADGET_GAS, _GENIC_GAS, _class_tk_table,  # noqa
                        _dm_small_cosmology, _eh_table)


def _rank_hook(event, sim, outdir):
    """Each rank's per-step records, saved at the end of its run."""
    if event != "end":
        return
    from shenqi_tpu_torch.parallel import collectives as cc
    torch.save({"sph_log": sim.sph_log, "exchange_log": sim.exchange_log,
                "force_log": sim.force_log, "counts": dict(cc.COUNTS)},
               os.path.join(outdir, f"rank{cc.rank()}.pt"))


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
    n = int(argv[1]) if len(argv) > 1 else torch.cuda.device_count()
    sys.exit(main(argv[0], n, ng=cpu or 64,
                  device="cpu" if cpu else None))
