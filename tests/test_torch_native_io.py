"""The port's snapshot writer through the C++ block writer
(shenqi_tpu_torch/io/native.py, native/bigfile_io.cpp built into
shenqi_tpu_torch/_build/) against the port's numpy writer and the JAX
package's write_snapshot, on the CPU: a snapshot of gas, DM, star and
BH rows with every on-disk dtype of the registry (f8 x 3, f4 x 3, f4 x 9,
u8, u1, i4, u4) written with nfile 1, 2 and 3.  Every file of the three
directories (the data files, each block's header with its checksums,
attrs-v2, the Header block) is byte-identical.  A build that fails
raises with the compiler's output."""

import os

import numpy as np
import pytest

from shenqi_tpu.io.snapshot import (SnapshotHeader as JHeader,
                                    write_snapshot as j_write)
from shenqi_tpu_torch import _build
from shenqi_tpu_torch.io import native
from shenqi_tpu_torch.io.snapshot import (SnapshotHeader, read_snapshot,
                                          write_snapshot)


def _blocks():
    rng = np.random.default_rng(11)
    n = {0: 301, 1: 512, 4: 7, 5: 3}
    b = {t: {"Position": rng.uniform(0, 5000.0, (m, 3)),
             "Velocity": rng.normal(0, 50, (m, 3)).astype(np.float32),
             "Mass": rng.uniform(1, 2, m).astype(np.float32),
             "ID": rng.integers(1, 2 ** 63, m, dtype=np.uint64)}
         for t, m in n.items()}
    b[0].update(Metals=rng.uniform(0, 1, (n[0], 9)).astype(np.float32),
                Generation=rng.integers(0, 4, n[0]).astype(np.uint8),
                InternalEnergy=rng.uniform(1, 100, n[0]).astype(np.float32),
                TimeBinHydro=rng.integers(0, 20, n[0]).astype(np.uint32))
    b[4]["StellarFormationTime"] = rng.uniform(0, 0.1, n[4]).astype(
        np.float32)
    b[5].update(BlackholeSwallowed=np.array([0, 1, 0], np.int32),
                BlackholeSwallowID=np.array([0, 5, 2 ** 40], np.uint64))
    return n, b


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for f in names:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("nfile", [1, 2, 3])
def test_native_writer_bytes(tmp_path, nfile):
    n, blocks = _blocks()
    tot = np.array([n.get(t, 0) for t in range(6)], np.uint64)
    kw = dict(TotNumPart=tot, MassTable=np.zeros(6), Time=0.1,
              BoxSize=5000.0, Omega0=0.288, OmegaLambda=0.712,
              OmegaBaryon=0.0472, HubbleParam=0.7, TimeIC=0.01)
    write_snapshot(str(tmp_path / "native"), SnapshotHeader(**kw), blocks,
                   nfile=nfile)
    write_snapshot(str(tmp_path / "numpy"), SnapshotHeader(**kw), blocks,
                   nfile=nfile, _numpy=True)
    j_write(str(tmp_path / "jax"), JHeader(**kw), blocks, nfile=nfile)
    got = _files(tmp_path / "native")
    # every block's data files, header and attrs-v2, and the Header
    # block's header and attrs-v2
    assert len(got) == 2 + sum(
        (nfile + 2) for b in blocks.values() for _ in b)
    for other in ("numpy", "jax"):
        ref = _files(tmp_path / other)
        assert sorted(got) == sorted(ref), other
        for name, data in ref.items():
            assert got[name] == data, (other, name)
    _, back = read_snapshot(str(tmp_path / "native"))
    for t, props in blocks.items():
        for k, v in props.items():
            np.testing.assert_array_equal(back[t][k], v)


def test_native_writer_empty_file_slots(tmp_path):
    """A block of fewer rows than files (1 BH row, nfile 3): the C++
    writer writes an empty data file for each slot that gets no rows,
    where the numpy writer writes none.  Every other file is the numpy
    writer's byte for byte, as the JAX package's are (whose writer
    writes such empty files too where its own native library is built),
    and the snapshot reads back."""
    rng = np.random.default_rng(3)
    blocks = {1: {"Position": rng.uniform(0, 10.0, (5, 3)),
                  "Mass": np.ones(5, np.float32)},
              5: {"Position": rng.uniform(0, 10.0, (1, 3)),
                  "BlackholeSwallowID": np.array([7], np.uint64)}}
    kw = dict(TotNumPart=np.array([0, 5, 0, 0, 0, 1], np.uint64),
              MassTable=np.zeros(6), Time=0.1, BoxSize=10.0, Omega0=0.3,
              OmegaLambda=0.7)
    write_snapshot(str(tmp_path / "native"), SnapshotHeader(**kw), blocks,
                   nfile=3)
    write_snapshot(str(tmp_path / "numpy"), SnapshotHeader(**kw), blocks,
                   nfile=3, _numpy=True)
    j_write(str(tmp_path / "jax"), JHeader(**kw), blocks, nfile=3)
    got, ref, jax_ = (_files(tmp_path / d) for d in ("native", "numpy",
                                                      "jax"))
    empty = {f"5/{k}/{i:06d}" for k in blocks[5] for i in (0, 1)}
    assert set(got) == set(ref) | empty and not set(ref) & empty
    assert all(got[name] == b"" for name in empty)
    for name, data in ref.items():
        assert got[name] == data, name
        assert jax_[name] == data, name
    assert all(jax_[name] == b"" for name in set(jax_) - set(ref))
    _, back = read_snapshot(str(tmp_path / "native"))
    for t, props in blocks.items():
        for k, v in props.items():
            np.testing.assert_array_equal(back[t][k], v)


def test_native_library_built_into_build_dir():
    lib = native._lib()
    assert os.path.dirname(lib._name) == str(_build.BUILD_DIR)
    assert os.path.basename(lib._name).startswith("libbigfile_io_")
    cxx, *flags = _build.host_flags()
    assert flags[:-1] == ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread"]
    assert flags[-1] == "-shared"


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output;
    nothing falls back to the numpy writer."""
    (tmp_path / "Makefile").write_text(
        (_build.NATIVE_DIR / "Makefile").read_text())
    (tmp_path / "bigfile_io.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(_build, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    _build.load_host_library.cache_clear()
    native._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=r"(?s)host build of "
                           r"native/bigfile_io\.cpp failed.*error"):
            write_snapshot(str(tmp_path / "snap"), SnapshotHeader(
                TotNumPart=np.array([0, 4, 0, 0, 0, 0], np.uint64),
                MassTable=np.zeros(6), Time=0.1, BoxSize=1.0, Omega0=0.3,
                OmegaLambda=0.7), {1: {"Mass": np.ones(4, np.float32)}})
    finally:
        _build.load_host_library.cache_clear()
        native._lib.cache_clear()
