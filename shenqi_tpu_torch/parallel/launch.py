"""Spawning the ranks of a slab run (the JAX package's make_mesh,
shenqi_tpu/parallel/sharded.py:47, as processes).

`run_ranks(body, ndev, args, device_type, ...)` starts `ndev` processes
with torch.multiprocessing in spawn mode.  Rank r sets its device
(cuda:r, or the CPU, with one thread when there are several ranks),
joins the process group through a FileStore (collectives.init: NCCL on
cards, gloo on the CPU; no TCP port, so parallel runs cannot collide),
calls body(rank, device, *args) and leaves the group.  `timeout_s`
bounds each collective, so a rank that never joins one makes the others
raise instead of hang; `join_timeout` bounds the whole run.  A rank that
raises ends the others, and its traceback is raised here.  `body` must
be picklable (a module-level function); rank 0's return value, which
must be small, comes back.
"""

from __future__ import annotations

import multiprocessing
import os
import time

import torch

from . import collectives as cc


def _rank_main(rank, body, ndev, args, device_type, store, timeout_s, q):
    dev = (torch.device("cuda", rank) if device_type == "cuda"
           else torch.device("cpu"))
    if dev.type == "cpu" and ndev > 1:
        # ranks share the host's cores; one rank keeps torch's threads
        torch.set_num_threads(1)
    cc.init(store, rank, ndev, dev, timeout_s)
    try:
        out = body(rank, dev, *args)
        if rank == 0:
            q.put(out)
    finally:
        cc.finalize()


def run_ranks(body, ndev: int, args: tuple, device_type: str, store: str,
              timeout_s: float = 300.0, join_timeout: float = None):
    """Run body on `ndev` spawned ranks meeting at the FileStore path
    `store` (removed before and after).  On the card `ndev` may not
    exceed the cards present: nothing falls back to gloo, the CPU or
    fewer ranks."""
    import torch.multiprocessing as tmp
    from .domain import _log2
    _log2(ndev)
    if device_type == "cuda" and ndev > torch.cuda.device_count():
        raise RuntimeError(
            f"--mesh {ndev} needs {ndev} cards, one per rank; "
            f"{torch.cuda.device_count()} present")
    if os.path.exists(store):
        os.remove(store)
    q = multiprocessing.get_context("spawn").SimpleQueue()
    pc = tmp.start_processes(
        _rank_main, nprocs=ndev, join=False, start_method="spawn",
        args=(body, ndev, args, device_type, store, timeout_s, q))
    deadline = None if join_timeout is None else \
        time.monotonic() + join_timeout
    try:
        while not pc.join(timeout=1):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{ndev} ranks did not end within "
                                   f"{join_timeout} s")
    finally:
        for pr in pc.processes:
            if pr.is_alive():
                pr.terminate()
            pr.join()
        if os.path.exists(store):
            os.remove(store)
    return None if q.empty() else q.get()
