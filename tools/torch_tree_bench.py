#!/usr/bin/env python3
"""Time the port's octree build (shenqi_tpu_torch/ops/tree.build_octree)
on one NVIDIA card at the shapes FOF and the velocity dispersion give it:
uniform positions with a quarter of the rows in small clumps, 8 levels
(FOF) and 10 levels (veldisp's first try), with the card's name and
power limit.  Prints one JSON object: the median ms of each shape.

    python3 tools/torch_tree_bench.py [--repo DIR] [n ...]

--repo imports the package from another checkout (for example a
parent commit unpacked beside this one), so that two versions can be
timed in one call.
"""

import argparse
import json
import subprocess
import sys

import numpy as np
import torch


def _positions(n, seed=7):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1, (n, 3))
    nc = n // 4
    centres = rng.uniform(0, 1, (max(nc // 64, 1), 3))
    pos[:nc] = (centres[rng.integers(0, len(centres), nc)]
                + rng.normal(0, 1e-3, (nc, 3))) % 1.0
    return ((pos * 2.0 ** 32).astype(np.uint64) & 0xFFFFFFFF) \
        .astype(np.uint32).view(np.int32)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=__file__.rsplit("/tools/", 1)[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("n", type=int, nargs="*", default=[262144, 2097152])
    a = ap.parse_args(argv)
    sys.path.insert(0, a.repo)
    from shenqi_tpu_torch.ops.tree import build_octree
    dev = torch.device("cuda")
    out = {"repo": a.repo, "device": torch.cuda.get_device_name(0),
           "power_limit": subprocess.run(
               ["nvidia-smi", "--query-gpu=power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip(), "ms": {}}
    for n in a.n:
        ipos = torch.from_numpy(_positions(n)).to(dev)
        mass = torch.ones(n, device=dev)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        alive[::97] = False
        for nlevels in (8, 10):
            def build():
                return build_octree(ipos, mass, alive, 1.0, nlevels=nlevels,
                                    ncrit=32)
            build()
            ts = []
            for _ in range(a.reps):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                build()
                e1.record()
                e1.synchronize()
                ts.append(e0.elapsed_time(e1))
            out["ms"][f"n{n}_l{nlevels}"] = float(np.median(ts))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
