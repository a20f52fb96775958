#!/usr/bin/env python3
"""Time the port's implicit cooling solve (shenqi_tpu_torch/physics/
cooling_rates.do_cooling) on one NVIDIA card: op by op (each rate
evaluation's torch ops dispatched from the host) against the rate
evaluations replayed from their captured CUDA graphs, at a few row
counts, with the card's name and power limit.

    python3 tools/torch_cooling_bench.py [rows ...]
"""

import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, __file__.rsplit("/tools/", 1)[0])
from shenqi_tpu_torch.physics import cooling_rates as tc  # noqa: E402


def _inputs(n, dev):
    rng = np.random.default_rng(1)
    nh = 10 ** rng.uniform(-5, 0, n)

    def f(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    return (f(10 ** rng.uniform(10, 14, n)), f(nh / 0.76 * 1.6726e-24),
            f(10 ** rng.uniform(13, 15, n)), f(np.full(n, 1.1)))


def _solve(u, rho, dt, ne):
    return tc.do_cooling(u, rho, dt, 0.24, 9.0, tc.UVBG(),
                         tc.CoolingParams(MinGasTemp=5.0),
                         min_egyspec_cgs=1e9, ne_init=ne)


def _timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t, out


def main(argv):
    if not torch.cuda.is_available():
        print("torch_cooling_bench: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{card}; torch {torch.__version__}", flush=True)
    for n in [int(a) for a in argv] or [64, 4096, 262144]:
        args = _inputs(n, dev)
        real = tc.heatingcooling_rate
        # op by op: the rate evaluation without its graph
        # (the redshift as the graphs take it: a device f32 scalar)
        tc.heatingcooling_rate = (
            lambda rho, u, he, z, uv, par, ne_init, extra_heat=0.0:
            tc.get_heatingcooling_rate(
                rho, u, he, torch.tensor(float(z), device=dev), uv, par,
                ne_init=ne_init, extra_heat=extra_heat))
        try:
            t_eager, a = _timed(lambda: _solve(*args))
        finally:
            tc.heatingcooling_rate = real
        t_first, _ = _timed(lambda: _solve(*args))   # captures the graph
        t_graph, b = _timed(lambda: _solve(*args))
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        print(f"do_cooling rows {n}: op by op {t_eager:.3f} s; graphs "
              f"{t_graph:.3f} s ({t_first:.3f} s with the capture); "
              f"results bitwise equal {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
