"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<stem>.cu` becomes `_build/lib<stem>_<hash>.so`, a shared
library with a plain C interface (no PyTorch headers), compiled for
Hopper (`sm_90a`).  The hash covers the source and the flags, so a
changed source rebuilds and an unchanged one loads what is there.
nvcc writes to a temporary name that is renamed into place only after a
successful build, so a build that was cut off leaves nothing a later
run trusts.  Sources build in parallel, one nvcc each.  nvcc's
`-Xptxas -v` report (registers, shared memory, spills) is kept beside
each library as `<name>.log`.

The host C++ of the repository's `native/` (the bigfile writer,
native/bigfile_io.cpp) builds the same way with the C++ compiler and
native/Makefile's CXXFLAGS into `_build/` (`load_host_library`); the
library that `make -C native` may have left in `native/` is never
loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NATIVE_DIR = PKG_DIR.parent / "native"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
NVCC_TIMEOUT_S = 120


@dataclass
class Built:
    stem: str
    path: Path
    log: str          # nvcc's output, the ptxas report included
    seconds: float    # 0.0 when an existing library was reused


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, the default toolkit prefix, or $PATH."""
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
             "/usr/local/cuda"]
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                           "toolkit's bin directory on PATH")
    return found


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _target(src: Path) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for dep in [src, *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Build every stale source (in parallel) and return {stem: Built}.
    A failed or timed-out build raises with nvcc's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, []
    nvcc = None
    for src in sources():
        dst = _target(src)
        log = dst.with_suffix(".log")
        if dst.is_file():
            text = log.read_text() if log.is_file() else ""
            out[src.stem] = Built(src.stem, dst, text, 0.0)
            continue
        nvcc = nvcc or find_nvcc()
        tmp = dst.with_name(f".tmp{os.getpid()}_{dst.name}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((src, dst, tmp, proc, time.perf_counter()))
    failures = []
    for src, dst, tmp, proc, t0 in running:
        left = max(1.0, NVCC_TIMEOUT_S - (time.perf_counter() - t0))
        try:
            text, _ = proc.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            text = f"nvcc timed out after {NVCC_TIMEOUT_S} s\n{text}"
        seconds = time.perf_counter() - t0
        if proc.returncode != 0 or not tmp.is_file():
            tmp.unlink(missing_ok=True)
            failures.append(f"--- {src.name} (rc={proc.returncode})\n{text}")
            continue
        dst.with_suffix(".log").write_text(text)
        os.replace(tmp, dst)
        out[src.stem] = Built(src.stem, dst, text, seconds)
    if failures:
        raise RuntimeError("nvcc build failed:\n" + "\n".join(failures))
    return out


@lru_cache(maxsize=None)
def load_library(stem: str) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<stem>.cu`, built on first use."""
    built = build_all()
    if stem not in built:
        raise RuntimeError(f"no CUDA source csrc/{stem}.cu")
    return ctypes.CDLL(str(built[stem].path))


def host_flags() -> tuple:
    """The compiler and flags of native/Makefile (`CXX ?=`, `CXXFLAGS
    ?=`; $CXX overrides the compiler, as for make), with -shared."""
    text = (NATIVE_DIR / "Makefile").read_text()
    cxx = re.search(r"^CXX\s*\?=\s*(.+)$", text, re.M)
    flags = re.search(r"^CXXFLAGS\s*\?=\s*(.+)$", text, re.M)
    if cxx is None or flags is None:
        raise RuntimeError("native/Makefile names no CXX or CXXFLAGS")
    return (os.environ.get("CXX") or cxx.group(1).strip(),
            *flags.group(1).split(), "-shared")


def build_host(stem: str) -> Built:
    """Build native/<stem>.cpp into _build/lib<stem>_<hash>.so unless it
    is there; a failed or timed-out build raises with the compiler's
    output."""
    src = NATIVE_DIR / f"{stem}.cpp"
    if not src.is_file():
        raise RuntimeError(f"no host source native/{stem}.cpp")
    cmd = host_flags()
    h = hashlib.sha256(" ".join(cmd).encode())
    h.update(src.read_bytes())
    dst = BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"
    if dst.is_file():
        return Built(stem, dst, "", 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = dst.with_name(f".tmp{os.getpid()}_{dst.name}")
    t0 = time.perf_counter()
    try:
        out = subprocess.run([*cmd, "-o", str(tmp), str(src)],
                             capture_output=True, text=True,
                             timeout=NVCC_TIMEOUT_S)
        text, rc = out.stdout + out.stderr, out.returncode
    except (OSError, subprocess.TimeoutExpired) as e:
        text, rc = f"{cmd[0]}: {e}", -1
    if rc != 0 or not tmp.is_file():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host build of native/{stem}.cpp failed "
                           f"(rc={rc}):\n{text}")
    os.replace(tmp, dst)
    return Built(stem, dst, text, time.perf_counter() - t0)


@lru_cache(maxsize=None)
def load_host_library(stem: str) -> ctypes.CDLL:
    """The ctypes handle of native/<stem>.cpp, built on first use."""
    return ctypes.CDLL(str(build_host(stem).path))
