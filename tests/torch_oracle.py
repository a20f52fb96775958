"""Module-fixture results computed once per test session and shared by
the pytest-xdist workers.

`shared(tmp_path_factory, name, body, *args)` runs body(out_dir,
*args) once per session, in a spawned process, and every worker that
asks loads its pickled result.  body is a module-level function (it is
pickled to the process by name); out_dir is a directory of the session
that every worker can read, for the files the body writes.  A lock
file per result makes one worker compute it while the others wait, so a
fixture whose tests land on several workers under `--dist load` runs
once, not once per worker.  `shared_all(tmp_path_factory, jobs)` does
the same for several independent jobs (the two packages' runs of one
oracle; `both_sides` names those two): a worker starts every job no
other worker has taken, each in its own process, all at once, and
waits for the rest.  A job that failed fails in every worker that asks
for it: no other worker runs it again.

A job of the JAX package may ask to run again, up to `retries` more
times, when its process dies of a signal: the JAX package's XLA
compiler has aborted a worker in a veldisp compile (`Fatal Python
error: Aborted` in backend_compile_and_load), which ends every test of
that worker.  Every retry is reported as a warning with the job's name
and the signal.  The port's jobs keep the default `retries=0`: a port
run that dies of a signal fails its tests at once.  A body that raises
is never retried: its traceback is raised here.

The result is pickled whole (Simulation objects of either package
included), but for callables that cannot be pickled, such as the local
lambdas a JAX run caches: each becomes a `Dropped` that raises if
called.
"""

import multiprocessing
import os
import pickle
import shutil
import signal
import traceback
import warnings
from pathlib import Path

from filelock import FileLock, Timeout


def session_dir(tmp_path_factory) -> Path:
    """The session's base temporary directory, shared by its workers."""
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


class Dropped:
    """Stands for a callable of an oracle's result that did not pickle."""

    def __init__(self, what):
        self.what = what

    def __call__(self, *a, **kw):
        raise RuntimeError(f"{self.what} did not survive the shared "
                           f"oracle's pickling")


class _Pickler(pickle.Pickler):
    def reducer_override(self, obj):
        if callable(obj) and not isinstance(obj, type):
            try:
                pickle.dumps(obj)
            except Exception:
                return Dropped, (repr(obj)[:200],)
        return NotImplemented


def _child(body, out, args, result):
    try:
        value = body(out, *args)
        tmp = result.with_name(result.name + ".tmp")
        with open(tmp, "wb") as f:
            _Pickler(f).dump(value)
        os.replace(tmp, result)
    except BaseException:
        (out / "error.txt").write_text(traceback.format_exc())
        raise SystemExit(1)


# retries of a JAX package job whose process dies of a signal
JAX_RETRIES = 2


def _signal_name(exitcode):
    try:
        return signal.Signals(-exitcode).name
    except ValueError:
        return f"signal {-exitcode}"


def _fail(out, msg):
    """Raise msg, and leave it for the workers that wait on this job:
    they raise it too, and do not run the job again."""
    (out / "failed.txt").write_text(msg)
    raise RuntimeError(msg)


def _raise_if_failed(out):
    failed = out / "failed.txt"
    if failed.exists():
        raise RuntimeError(failed.read_text())


def _compute(jobs):
    """Run each (out, body, args, retries) job in its own spawned
    process, all at once; a job whose process dies of a signal runs
    again while it has retries left."""
    ctx = multiprocessing.get_context("spawn")
    while jobs:
        procs = []
        for out, body, args, retries in jobs:
            # a run that died may have left part of its files
            shutil.rmtree(out, ignore_errors=True)
            out.mkdir(parents=True)
            p = ctx.Process(target=_child,
                            args=(body, out, args, out / "result.pkl"))
            p.start()
            procs.append((out, body, args, retries, p))
        again = []
        for out, body, args, retries, p in procs:
            p.join()
            if (out / "result.pkl").exists():
                continue
            if p.exitcode is None or p.exitcode >= 0:
                err = out / "error.txt"
                _fail(out, f"shared oracle {out.name} failed (exit code "
                           f"{p.exitcode}):\n"
                      + (err.read_text() if err.exists() else ""))
            sig = _signal_name(p.exitcode)
            if retries <= 0:
                _fail(out, f"shared oracle {out.name} died of {sig}")
            warnings.warn(f"shared oracle {out.name} died of {sig}; "
                          f"running it again ({retries - 1} retries "
                          f"left after this one)")
            again.append((out, body, args, retries - 1))
        jobs = again


def shared_all(tmp_path_factory, jobs):
    """[(name, body, args, retries), ...] -> their results, each
    computed once per session."""
    base = session_dir(tmp_path_factory)
    todo = {name: (base / f"oracle_{name}", body, tuple(args), retries)
            for name, body, args, retries in jobs}

    def done(name):
        return (todo[name][0] / "result.pkl").exists()

    while True:
        pending = [n for n in todo if not done(n)]
        if not pending:
            break
        for n in pending:
            _raise_if_failed(todo[n][0])
        locks = {}
        for n in pending:
            lock = FileLock(str(todo[n][0]) + ".lock")
            try:
                lock.acquire(timeout=0)
            except Timeout:
                continue
            locks[n] = lock
        if not locks:
            # every job left is another worker's: wait for one of them
            lock = FileLock(str(todo[pending[0]][0]) + ".lock")
            lock.acquire()
            locks[pending[0]] = lock
        try:
            for n in locks:
                _raise_if_failed(todo[n][0])
            _compute([todo[n] for n in locks if not done(n)])
        finally:
            for lock in locks.values():
                lock.release()
    out = []
    for name, *_ in jobs:
        with open(todo[name][0] / "result.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def shared(tmp_path_factory, name, body, *args, retries=0):
    return shared_all(tmp_path_factory, [(name, body, args, retries)])[0]


def both_sides(tmp_path_factory, prefix, body, *args):
    """shared_all of body(out, side, *args) for side "jax" and "torch",
    named f"{prefix}_{side}"; only the JAX side is retried."""
    return shared_all(tmp_path_factory, [
        (f"{prefix}_{side}", body, (side,) + args,
         JAX_RETRIES if side == "jax" else 0)
        for side in ("jax", "torch")])
