#!/usr/bin/env python3
"""Hold the port's FOF labels (shenqi_tpu_torch/fof/fof.fof_label) on
trees of several depths against a brute-force friends-of-friends: every
pair closer than b found by scipy's periodic cKDTree, and the connected
components of that graph.  The state is chip_smoke.py's clustered
snapshot with compact halos (`_clustered` + `_with_halos`, box 50000
kpc/h scaled to n_side / 128), b = 0.2 mean separations.

FOF takes at most ncrit sources from a leaf (ROADMAP C.4), so where the
halos fill leaves at the deepest level a shallow tree misses links.
Prints, for each depth, the groups of 32 or more, the components and
whether the partition is the brute-force one.  Runs on the CPU:

    python3 tools/torch_fof_depth_check.py [--n-side 128] [--levels 8 10]
"""

import argparse
import os
import sys
import time

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from shenqi_tpu_torch.core.particles import float_to_ipos  # noqa: E402
from shenqi_tpu_torch.fof.fof import fof_label  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-side", type=int, default=128)
    ap.add_argument("--levels", type=int, nargs="+", default=[8, 10])
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    box = 50000.0 * args.n_side / 128
    pos = chip_smoke._with_halos(chip_smoke._clustered(args.n_side, box),
                                 box)
    n = len(pos)
    ipos = float_to_ipos(pos, box, device="cpu")
    b = 0.2 * (box / np.cbrt(n))
    x = np.mod(ipos.numpy().view(np.uint32).astype(np.float64)
               * (box / 2 ** 32), box)
    pairs = cKDTree(x, boxsize=box).query_pairs(b, output_type="ndarray")
    ncomp, brute = connected_components(coo_matrix(
        (np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])), shape=(n, n)),
        directed=False)
    big = int((np.bincount(brute) >= 32).sum())
    print(f"{n} particles, box {box:.0f}, b {b:.4f}: brute force "
          f"{len(pairs)} pairs, {ncomp} components, {big} of 32 or more")
    for nl in args.levels:
        t = time.perf_counter()
        lab = fof_label(ipos, torch.ones(n, dtype=torch.bool), b, box,
                        nlevels=nl).numpy()
        sec = time.perf_counter() - t
        _, comp = np.unique(lab, return_inverse=True)
        cnt = np.bincount(comp)
        same = len(np.unique(np.stack([brute, comp], 1), axis=0)) == \
            ncomp == len(cnt)
        print(f"{nl} levels: {len(cnt)} components, "
              f"{int((cnt >= 32).sum())} of 32 or more, partition the "
              f"brute-force one: {same} ({sec:.1f} s)")


if __name__ == "__main__":
    main()
