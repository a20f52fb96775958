"""The port's ICs, parameters and bigfile I/O against the JAX package on
the CPU, from the same seeded inputs.

Limits, with what these cases measured beside each (CPU, torch
2.13.0+cpu): the copied host modules are the same code (source and
declarations equal); the reference field bit-identical; delta_spec to
rtol 1e-12 (identical); ICs: IDs exact, positions within 1e-6 of the box
(f32 FFTs in both; measured 3.8e-9 at Ngrid 8 and 16), velocities within
1e-5 of their rms (measured under 1e-6); bigfiles byte-identical.
"""

import filecmp
import inspect
import os

import numpy as np
import pytest
import torch

import shenqi_tpu.cli.params as j_params
import shenqi_tpu.cosmology.power as j_power
import shenqi_tpu.genic.gadget_field as j_field
import shenqi_tpu.genic.ic as j_ic
import shenqi_tpu.genic.thermal as j_thermal
import shenqi_tpu.io.bigfile as j_bigfile
import shenqi_tpu.io.snapshot as j_snap
import shenqi_tpu.physics.neutrinos_lra as j_lra
import shenqi_tpu.utils.config as j_config
import shenqi_tpu.utils.hci as j_hci
import shenqi_tpu.utils.walltime as j_walltime
from shenqi_tpu.cosmology.background import Cosmology as JCosmology
from shenqi_tpu.utils.units import default_units as j_units

import shenqi_tpu_torch.cli.params as t_params
import shenqi_tpu_torch.cosmology.power as t_power
import shenqi_tpu_torch.genic.gadget_field as t_field
import shenqi_tpu_torch.genic.ic as t_ic
import shenqi_tpu_torch.genic.thermal as t_thermal
import shenqi_tpu_torch.io.bigfile as t_bigfile
import shenqi_tpu_torch.io.snapshot as t_snap
import shenqi_tpu_torch.physics.neutrinos_lra as t_lra
import shenqi_tpu_torch.utils.config as t_config
import shenqi_tpu_torch.utils.hci as t_hci
import shenqi_tpu_torch.utils.walltime as t_walltime
from shenqi_tpu_torch.cosmology.background import Cosmology as TCosmology
from shenqi_tpu_torch.core.particles import ParticleData, u32_numpy_to_i32
from shenqi_tpu_torch.utils.units import default_units as t_units

COSMO = dict(Omega0=0.288, OmegaLambda=0.712, OmegaBaryon=0.0472,
             HubbleParam=0.7, RadiationOn=1)
BOX = 64000.0


def _code(mod, comments=True):
    """A module's source without its docstring (the port's copies add a
    line there naming their origin), and without its comment lines when
    `comments` is False (a copy that cites a reference behaviour it keeps
    in a comment, ROADMAP C.4)."""
    src = inspect.getsource(mod)
    src = src[src.index('"""', 3) + 3:]
    if not comments:
        src = "\n".join(ln for ln in src.splitlines()
                        if not ln.lstrip().startswith("#"))
    return src


@pytest.mark.parametrize("pair", [
    (j_config, t_config), (j_params, t_params), (j_walltime, t_walltime),
    (j_hci, t_hci), (j_bigfile, t_bigfile), (j_field, t_field),
    (j_thermal, t_thermal), (j_lra, t_lra)],
    ids=["config", "params", "walltime", "hci", "bigfile", "gadget_field",
         "thermal", "neutrinos_lra"])
def test_copied_module_is_the_original(pair):
    j, t = pair
    assert _code(t) == _code(j)


def test_copied_power_is_the_original_but_for_comments():
    """cosmology/power.py is copied whole; its one addition is the comment
    that cites _tophat_sigma's k-grid slip."""
    assert _code(t_power, comments=False) == _code(j_power, comments=False)
    assert _code(t_power) != _code(j_power)


@pytest.mark.parametrize("which", ["gadget_params", "genic_params"])
def test_param_declarations_equal(which):
    dj = getattr(j_params, which)().decls
    dt = getattr(t_params, which)().decls
    assert list(dt) == list(dj)
    for name in dj:
        a, b = dj[name], dt[name]
        assert (b.ptype, b.required, b.default, b.enum_table) == \
            (a.ptype, a.required, a.default, a.enum_table), name
    if which == "gadget_params":
        assert dt["SplitGravityTimestepsOn"].default == 1
        assert dt["RandomParticleOffset"].default == 8


def test_build_output_list():
    s = '0.5, "0.125",0.2,,0.3'
    assert t_config.build_output_list(s) == j_config.build_output_list(s)
    with pytest.raises(t_config.ParamError):
        t_config.build_output_list("0.1,-0.2")


@pytest.mark.parametrize("nmesh", [8, 16])
def test_gadget_field_bit_identical(nmesh):
    for seed in (1, 181170, 2 ** 31 - 5):
        for unitary, invert in ((False, False), (True, True)):
            a = j_field.gadget_gaussian_field(seed, nmesh, unitary=unitary,
                                              invert_phase=invert)
            b = t_field.gadget_gaussian_field(seed, nmesh, unitary=unitary,
                                              invert_phase=invert)
            assert a.dtype == b.dtype and np.array_equal(a, b)


def _powers(table=None):
    jcp = JCosmology(**COSMO)
    jcp.init(0.1, j_units())
    tcp = TCosmology(**COSMO)
    tcp.init(0.1, t_units())
    if table is None:
        return (j_power.InputPower.analytic_eh(
            jcp, j_units().UnitLength_in_cm, primordial_index=0.96),
            t_power.InputPower.analytic_eh(
                tcp, t_units().UnitLength_in_cm, primordial_index=0.96))
    return (j_power.InputPower.from_file(table, jcp,
                                         j_units().UnitLength_in_cm),
            t_power.InputPower.from_file(table, tcp,
                                         t_units().UnitLength_in_cm))


def test_input_power_matches(tmp_path):
    """analytic_eh, from_file and both normalizations, the Sigma8 one
    through the copied _tophat_sigma with its k-grid slip."""
    k = np.logspace(-7, 1, 300)
    pj, pt = _powers()
    np.testing.assert_allclose(pt.delta_spec(k), pj.delta_spec(k),
                               rtol=1e-12, atol=0)
    pj.normalize(sigma8=0.8, time_ic=0.1)
    pt.normalize(sigma8=0.8, time_ic=0.1)
    assert pt.norm == pytest.approx(pj.norm, rel=1e-12)
    kt = np.logspace(-4, 2, 200)
    np.savetxt(tmp_path / "pk.txt", np.c_[kt, kt / (1 + (kt / 0.02) ** 3)])
    pj, pt = _powers(str(tmp_path / "pk.txt"))
    pj.normalize(input_power_redshift=0.0, time_ic=0.1)
    pt.normalize(input_power_redshift=0.0, time_ic=0.1)
    assert pt.norm == pytest.approx(pj.norm, rel=1e-12)
    np.testing.assert_allclose(pt.delta_spec(k), pj.delta_spec(k),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("ngrid", [8, 16])
def test_generate_dm_ics_matches(ngrid):
    pj, pt = _powers()
    pj.norm = pt.norm = 3e3
    jcp, tcp = pj.CP, pt.CP
    kw = dict(seed=181170, time_ic=0.1, unitary=True, nmesh=2 * ngrid)
    a = j_ic.generate_dm_ics(ngrid, BOX, power=pj, CP=jcp, **kw)
    b = t_ic.generate_dm_ics(ngrid, BOX, power=pt, CP=tcp, device="cpu",
                             **kw)
    np.testing.assert_array_equal(b[2], a[2])
    assert b[3] == a[3]
    d = np.abs(b[0] - a[0])
    assert np.minimum(d, BOX - d).max() < 1e-6 * BOX
    rms = np.sqrt(np.mean(np.asarray(a[1], np.float64) ** 2))
    assert rms > 0 and np.abs(b[1] - a[1]).max() < 1e-5 * rms
    # scheme="fast", refused until ROADMAP A.12, gives the JAX field
    # (tests/test_torch_fast_field.py holds it at 32^3)
    jg = np.asarray(j_ic.gaussian_field(1, 8, scheme="fast"))
    tg = t_ic.gaussian_field(1, 8, scheme="fast", device="cpu")
    assert np.abs(tg - jg).max() < 1e-5 * np.abs(jg).max()


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_bigfile_bytes_identical_and_read_across(tmp_path):
    rng = np.random.RandomState(5)
    n = 300
    hdr_kw = dict(TotNumPart=np.array([0, n, 0, 0, 0, 0], np.uint64),
                  MassTable=np.array([0, 0.5, 0, 0, 0, 0]), Time=0.25,
                  BoxSize=BOX, Omega0=0.288, OmegaLambda=0.712,
                  OmegaBaryon=0.0472, HubbleParam=0.7, UsePeculiarVelocity=1,
                  TimeIC=0.1)
    blocks = {1: {"Position": rng.uniform(0, BOX, (n, 3)),
                  "Velocity": rng.normal(size=(n, 3)).astype(np.float32),
                  "Mass": np.full(n, 0.5, np.float32),
                  "ID": np.arange(1, n + 1, dtype=np.uint64),
                  "GroupID": rng.randint(0, 9, n).astype(np.uint32)}}
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    hj = j_snap.SnapshotHeader(**hdr_kw)
    hj.extra["Seed"] = np.array([181170], dtype="<i8")
    ht = t_snap.SnapshotHeader(**hdr_kw)
    ht.extra["Seed"] = np.array([181170], dtype="<i8")
    j_snap.write_snapshot(pj, hj, blocks)
    t_snap.write_snapshot(pt, ht, blocks)
    assert _files(pj) == _files(pt) and len(_files(pt)) >= 12
    for f in _files(pj):
        assert filecmp.cmp(os.path.join(pj, f), os.path.join(pt, f),
                           shallow=False), f
    # read across both ways
    for reader, path in ((t_snap.read_snapshot, pj),
                         (j_snap.read_snapshot, pt)):
        h, b = reader(path)
        assert h.Time == 0.25 and int(h.extra["Seed"][0]) == 181170
        for name, arr in blocks[1].items():
            np.testing.assert_array_equal(b[1][name], arr)


class _State:
    def __init__(self, particles):
        self.particles = particles


def test_positions_above_2_31_round_trip(tmp_path):
    """state_to_blocks and the snapshot writer keep positions at and
    above 2^31 of the uint32 range exactly (ROADMAP C.1)."""
    ipos = np.array([[0, 2 ** 31, 2 ** 32 - 1], [2 ** 31 - 1, 2 ** 31 + 1,
                     12345], [4000000000, 3, 2 ** 31]], np.uint32)
    n = len(ipos)
    p = ParticleData.zeros(n, device="cpu").replace(
        ipos=torch.from_numpy(u32_numpy_to_i32(ipos).copy()),
        mask=torch.ones(n, dtype=torch.bool),
        ptype=torch.ones(n, dtype=torch.int8),
        mass=torch.full((n,), 0.5),
        id_lo=torch.arange(1, n + 1, dtype=torch.int32))
    b = t_snap.state_to_blocks(_State(p), BOX, atime=0.5)
    expect = ipos.astype(np.float64) * (BOX / 2 ** 32)
    np.testing.assert_array_equal(b[1]["Position"], expect)
    t_snap.write_snapshot(str(tmp_path / "s"), t_snap.SnapshotHeader(
        TotNumPart=np.array([0, n, 0, 0, 0, 0], np.uint64),
        MassTable=np.zeros(6), Time=0.5, BoxSize=BOX, Omega0=0.3,
        OmegaLambda=0.7), b)
    _, back = j_snap.read_snapshot(str(tmp_path / "s"))
    from shenqi_tpu_torch.core.particles import float_to_ipos
    again = float_to_ipos(back[1]["Position"], BOX, device="cpu")
    assert (again.numpy().view(np.uint32) == ipos).all()
    np.testing.assert_array_equal(back[1]["ID"], [1, 2, 3])
