"""bigfile format reader/writer (numpy, single-process).

Disk-format compatible with the bigfile library vendored by the reference
(depends/bigfile/src/bigfile.c): a BigFile is a directory tree; each block
is a directory holding
  * ``header``  — text: DTYPE/NMEMB/NFILE plus one line per data file with
    its row count, raw sysv byte-sum checksum, and folded checksum;
  * ``attrs-v2`` — text: one line per attribute,
    ``NAME DTYPE NMEMB <hex bytes> #HUMANE [ textual ]``;
  * ``000000``, ``000001``, … — raw little-endian binary, row-major,
    ``nmemb`` columns per row.

Snapshots written here are readable by the reference's tools and by the
PyPI ``bigfile`` package, and vice versa.  A C++ parallel writer can
replace the data path later without changing the format.

A copy of shenqi_tpu/io/bigfile.py (no JAX in it) so that the PyTorch port
imports nothing of the JAX package; tests/test_torch_genic_io.py pins it.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional, Union

import numpy as np


def _sysv_checksum(data: bytes) -> int:
    """Byte-sum checksum (SysV 'sum'), truncated to uint32."""
    return int(np.frombuffer(data, dtype=np.uint8).sum(dtype=np.uint64)
               & 0xFFFFFFFF)


def _fold_checksum(s: int) -> int:
    r = (s & 0xFFFF) + ((s & 0xFFFFFFFF) >> 16)
    return (r & 0xFFFF) + (r >> 16)


def _normalize_dtype(dtype) -> str:
    """Canonical bigfile dtype string, e.g. '<f8', '<u4'."""
    dt = np.dtype(dtype)
    s = dt.str
    if s[0] == "|":   # endian-agnostic (i1, u1, S...)
        return s
    if s[0] == "=":
        s = "<" + s[1:]
    return s


class BigAttrs:
    """Attribute set of a block (attrs-v2 text file)."""

    def __init__(self):
        self._data: Dict[str, np.ndarray] = {}

    def __getitem__(self, name):
        v = self._data[name]
        if v.dtype.kind == "S" and v.size >= 1:
            # string attribute: join bytes
            return v.tobytes().split(b"\0")[0].decode()
        return v

    def __setitem__(self, name, value):
        if isinstance(value, str):
            arr = np.frombuffer(value.encode(), dtype="S1").copy()
        elif isinstance(value, bytes):
            arr = np.frombuffer(value, dtype="S1").copy()
        else:
            arr = np.atleast_1d(np.asarray(value))
        self._data[name] = arr

    def __contains__(self, name):
        return name in self._data

    def keys(self):
        return self._data.keys()

    def raw(self, name) -> np.ndarray:
        return self._data[name]

    # ---- serialization ----
    @staticmethod
    def _textual(arr: np.ndarray) -> str:
        raw = arr.tobytes()
        if len(raw) > 128:
            return "... (Too Long) "
        if arr.dtype.kind == "S":
            out = ""
            for b in raw:
                if b == 0:
                    break
                if b == 0x0A:
                    out += "..."
                    break
                out += chr(b)
            return out
        return " ".join(repr(x) if arr.dtype.kind == "f" else str(x)
                        for x in arr.tolist())

    def write(self, path: str):
        lines = []
        for name, arr in self._data.items():
            dtype = _normalize_dtype(arr.dtype)
            nmemb = arr.size
            hexdata = arr.tobytes().hex().upper()
            lines.append(f"{name} {dtype} {nmemb} {hexdata} "
                         f"#HUMANE [ {self._textual(arr)} ]\n")
        with open(os.path.join(path, "attrs-v2"), "w") as f:
            f.writelines(lines)

    @classmethod
    def read(cls, path: str) -> "BigAttrs":
        attrs = cls()
        fn = os.path.join(path, "attrs-v2")
        if not os.path.exists(fn):
            return attrs
        with open(fn) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split(" ", 3)
                if len(parts) < 4:
                    continue
                name, dtype, nmemb, rest = parts
                hexdata = rest.split(" ", 1)[0]
                raw = bytes.fromhex(hexdata)
                arr = np.frombuffer(raw, dtype=dtype, count=int(nmemb)).copy()
                attrs._data[name] = arr
        return attrs


class BigBlock:
    """One column: a 2-D table of (size rows, nmemb cols) of one dtype."""

    def __init__(self, path: str):
        self.path = path
        self.dtype: Optional[str] = None
        self.nmemb = 1
        self.nfile = 0
        self.fsize: List[int] = []
        self.attrs = BigAttrs()

    @property
    def size(self) -> int:
        return sum(self.fsize)

    # ---- open existing ----
    @classmethod
    def open(cls, path: str) -> "BigBlock":
        bb = cls(path)
        header = os.path.join(path, "header")
        if os.path.exists(header):
            with open(header) as f:
                for line in f:
                    key, _, val = line.partition(":")
                    key = key.strip()
                    if key == "DTYPE":
                        bb.dtype = val.strip()
                    elif key == "NMEMB":
                        bb.nmemb = int(val)
                    elif key == "NFILE":
                        bb.nfile = int(val)
                        bb.fsize = [0] * bb.nfile
                    else:
                        # data file line: "000000: size : cksum : folded"
                        # (file ids are %06X hex, cf. bigfile.c EXT_DATA)
                        try:
                            fid = int(key, 16)
                        except ValueError:
                            continue
                        bb.fsize[fid] = int(val.split(":")[0])
        bb.attrs = BigAttrs.read(path)
        return bb

    # ---- create ----
    @classmethod
    def create(cls, path: str, dtype, size: int, nmemb: int = 1,
               nfile: int = 1) -> "BigBlock":
        os.makedirs(path, exist_ok=True)
        bb = cls(path)
        bb.dtype = _normalize_dtype(dtype)
        bb.nmemb = nmemb
        bb.nfile = nfile
        # rows per file: balanced split like the C library
        bb.fsize = [(size * (i + 1)) // nfile - (size * i) // nfile
                    for i in range(nfile)]
        return bb

    def _foffset(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.fsize)]).astype(np.int64)

    def _fname(self, fid: int) -> str:
        return os.path.join(self.path, f"{fid:06X}")

    # ---- I/O ----
    def write(self, start: int, data: np.ndarray):
        """Write rows [start, start+len(data)).  Rows must already exist
        in the block layout (size fixed at creation)."""
        data = np.ascontiguousarray(data)
        if data.ndim == 1:
            data = data.reshape(-1, 1)
        assert data.shape[1] == self.nmemb, \
            f"nmemb mismatch {data.shape} vs {self.nmemb}"
        data = data.astype(self.dtype, copy=False)
        offsets = self._foffset()
        n = len(data)
        written = 0
        itemsize = np.dtype(self.dtype).itemsize * self.nmemb
        for fid in range(self.nfile):
            lo, hi = offsets[fid], offsets[fid + 1]
            s = max(start, lo)
            e = min(start + n, hi)
            if s >= e:
                continue
            fn = self._fname(fid)
            mode = "r+b" if os.path.exists(fn) else "wb"
            with open(fn, mode) as f:
                f.seek(int(s - lo) * itemsize)
                f.write(data[s - start:e - start].tobytes())
            written += e - s
        assert written == n, f"write out of bounds: {start}+{n} > {self.size}"

    def read(self, start: int = 0, count: Optional[int] = None) -> np.ndarray:
        if count is None:
            count = self.size - start
        out = np.empty((count, self.nmemb), dtype=self.dtype)
        offsets = self._foffset()
        itemsize = np.dtype(self.dtype).itemsize * self.nmemb
        got = 0
        for fid in range(self.nfile):
            lo, hi = offsets[fid], offsets[fid + 1]
            s = max(start, lo)
            e = min(start + count, hi)
            if s >= e:
                continue
            with open(self._fname(fid), "rb") as f:
                f.seek(int(s - lo) * itemsize)
                raw = f.read(int(e - s) * itemsize)
            out[s - start:e - start] = np.frombuffer(
                raw, dtype=self.dtype).reshape(-1, self.nmemb)
            got += e - s
        assert got == count, f"read out of bounds: {start}+{count}"
        if self.nmemb == 1:
            return out[:, 0]
        return out

    def flush(self):
        """Write header (recomputing checksums from the data files)."""
        lines = [f"DTYPE: {self.dtype}\n",
                 f"NMEMB: {self.nmemb}\n",
                 f"NFILE: {self.nfile}\n"]
        itemsize = np.dtype(self.dtype).itemsize * self.nmemb
        for fid in range(self.nfile):
            fn = self._fname(fid)
            if os.path.exists(fn):
                with open(fn, "rb") as f:
                    cksum = _sysv_checksum(f.read())
            else:
                cksum = 0
                if self.fsize[fid] > 0:
                    # create the (empty) file so readers see a complete block
                    with open(fn, "wb") as f:
                        f.write(b"\0" * self.fsize[fid] * itemsize)
            lines.append(f"{fid:06X}: {self.fsize[fid]} : {cksum} : "
                         f"{_fold_checksum(cksum)}\n")
        with open(os.path.join(self.path, "header"), "w") as f:
            f.writelines(lines)
        self.attrs.write(self.path)


class BigFile:
    """A bigfile directory: named blocks addressed by path-like keys."""

    def __init__(self, root: str, create: bool = False):
        self.root = root
        if create:
            os.makedirs(root, exist_ok=True)
        elif not os.path.isdir(root):
            raise FileNotFoundError(root)
        self._open_blocks: Dict[str, BigBlock] = {}

    def __contains__(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.root, name, "header")) or \
            os.path.exists(os.path.join(self.root, name, "attrs-v2"))

    def __getitem__(self, name: str) -> BigBlock:
        if name not in self._open_blocks:
            path = os.path.join(self.root, name)
            if not os.path.isdir(path):
                raise KeyError(f"no block {name} in {self.root}")
            self._open_blocks[name] = BigBlock.open(path)
        return self._open_blocks[name]

    def create_block(self, name: str, dtype, size: int, nmemb: int = 1,
                     nfile: int = 1) -> BigBlock:
        bb = BigBlock.create(os.path.join(self.root, name), dtype, size,
                             nmemb, nfile)
        self._open_blocks[name] = bb
        return bb

    def blocks(self) -> List[str]:
        found = []
        for dirpath, dirnames, filenames in os.walk(self.root):
            if "header" in filenames or "attrs-v2" in filenames:
                rel = os.path.relpath(dirpath, self.root)
                found.append("" if rel == "." else rel)
                dirnames.clear()
        return sorted(found)

    def remove(self):
        shutil.rmtree(self.root)
