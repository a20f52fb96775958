"""The threaded C++ bigfile block writer (native/bigfile_io.cpp), the
port of shenqi_tpu/io/native.py.

The library is built from the repository's source at first use, with
native/Makefile's flags, into shenqi_tpu_torch/_build/
(`_build.load_host_library`).  A failed build raises with the
compiler's output: nothing falls back to the numpy writer.  Its files
are the numpy writer's (io/bigfile.py), byte for byte, but for one
case: a data file that gets no rows (a block of fewer rows than files)
is written empty, where the numpy writer leaves it out.  Only the
writer is bound: the JAX package reads through numpy too.
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .._build import load_host_library
    lib = load_host_library("bigfile_io")
    lib.bf_write_block.restype = ctypes.c_int
    lib.bf_write_block.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    return lib


def write_block(path: str, dtype: str, data: np.ndarray, nfile: int = 1):
    """Write the whole block `path` (its data files, header and an empty
    attrs-v2), the rows split over `nfile` files as the numpy writer
    splits them.  Raises OSError if the library reports a failure (its
    code: -errno of a failed system call, or -1 for bad arguments)."""
    data = np.ascontiguousarray(np.asarray(data))
    if data.ndim == 1:
        data = data.reshape(-1, 1)
    data = np.ascontiguousarray(data.astype(dtype, copy=False))
    # the library makes the block's directory, not its parents
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    rc = _lib().bf_write_block(path.encode(), dtype.encode(),
                               data.shape[1], len(data), nfile,
                               data.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise OSError(f"bf_write_block failed on {path} (rc={rc})")
