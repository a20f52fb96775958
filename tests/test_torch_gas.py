"""Adiabatic gas in the port's Simulation against the JAX package's on the
CPU: the configuration of tests/test_simulation_gas.py (gas + DM on
lattices half a cell apart, box 64000 kpc/h, z = 9) at 8^3 + 8^3 with
InputPower.analytic_eh at sigma8 0.8 in place of its CLASS table,
hierarchical gravity, the quintic kernel and pressure-entropy SPH; and the
pressure-entropy IC fixed point (tests/test_init_entropy.py's case
without its reference file).

Both packages start from one state: the port's particles are the JAX
package's (convert.particles_from_numpy) and the window is carried across.

Limits: positions within 2e-5 of the box, velocity outliers (relative
difference over 1e-3) under 5e-3 of the rows, timebins equal but for
those outliers (__graft_entry__.py:194-206); entropy, density and hsml
within 1e-3 relative for >= 99% of the gas rows; the fixed point's
entropy within 2e-3 (test_init_entropy.py:68) of the JAX one and of its
defining relation.
"""

import numpy as np
import pytest
import torch

from shenqi_tpu.cosmology.background import Cosmology as JCosmology
from shenqi_tpu.cosmology.power import InputPower as JPower
from shenqi_tpu.core.timeline import Timeline as JTimeline
from shenqi_tpu.genic.ic import (setup_grid, gaussian_field,
                                 displacement_fields)
from shenqi_tpu.gravity.treepm import get_window_tables
from shenqi_tpu.simulation import Simulation as JSimulation
from shenqi_tpu.simulation_gas import GasPhysics as JGasPhysics
from shenqi_tpu.sph.kernels import QUINTIC as JQUINTIC
from shenqi_tpu.utils.units import default_units as j_units

from shenqi_tpu_torch.convert import particles_from_numpy, window_from_numpy
from shenqi_tpu_torch.core.timeline import Timeline as TTimeline
from shenqi_tpu_torch.cosmology.background import Cosmology as TCosmology
from shenqi_tpu_torch.simulation import Simulation as TSimulation
from shenqi_tpu_torch import simulation_gas as tsg
from shenqi_tpu_torch.simulation_gas import GasPhysics as TGasPhysics
from shenqi_tpu_torch.sph import stencil_density as tsd
from shenqi_tpu_torch.sph.kernels import QUINTIC
from shenqi_tpu_torch.utils.constants import GAMMA_MINUS1
from shenqi_tpu_torch.utils.units import default_units as t_units

torch.set_num_threads(2)

BOX = 64000.0
NG = 8
A_IC, A_END = 0.1, 0.125
COSMO = dict(Omega0=0.288, OmegaLambda=0.712, OmegaBaryon=0.0472,
             HubbleParam=0.7, RadiationOn=1)
U0 = 100.0


def _species(gas_only=False):
    cp = JCosmology(**COSMO)
    cp.init(A_IC, j_units())
    power = JPower.analytic_eh(cp, j_units().UnitLength_in_cm)
    power.normalize(sigma8=0.8, input_power_redshift=0, time_ic=A_IC)
    g_k = gaussian_field(181170, NG, unitary=True)
    lat_gas, ids_gas = setup_grid(NG, BOX, id_offset=NG ** 3 + 1,
                                  shift_frac=0.0)
    rg = displacement_fields(g_k, power, cp, lat_gas, BOX, A_IC)
    m_gas = cp.OmegaBaryon * cp.RhoCrit * BOX ** 3 / NG ** 3
    sp = [(0, rg.pos, rg.vel * A_IC, m_gas, ids_gas)]
    if not gas_only:
        lat_dm, ids_dm = setup_grid(NG, BOX, id_offset=1, shift_frac=0.5)
        rd = displacement_fields(g_k, power, cp, lat_dm, BOX, A_IC)
        m_dm = ((cp.Omega0 - cp.OmegaBaryon) * cp.RhoCrit * BOX ** 3
                / NG ** 3)
        sp.append((1, rd.pos, rd.vel * A_IC, m_dm, ids_dm))
    return sp


def _pair(sp):
    """Both packages' simulations from one state."""
    jcp = JCosmology(**COSMO)
    jcp.init(A_IC, j_units())
    tcp = TCosmology(**COSMO)
    tcp.init(A_IC, t_units())
    js = JSimulation.from_species(
        sp, jcp, BOX, 2 * NG, JTimeline.setup([A_END], A_IC, A_END), A_IC,
        gas_u0=U0, gas_physics=JGasPhysics(kernel=JQUINTIC))
    ts = TSimulation.from_species(
        sp, tcp, BOX, 2 * NG, TTimeline.setup([A_END], A_IC, A_END), A_IC,
        gas_u0=U0, gas_physics=TGasPhysics(kernel=QUINTIC), device="cpu")
    jp = js.particles
    ts.particles = particles_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in
         type(jp).__dataclass_fields__}, device="cpu")
    jw = get_window_tables(js.gravity)
    js.window_tables = jw
    ts.window_tables = window_from_numpy(np.asarray(jw.cf),
                                         np.asarray(jw.cp), float(jw.xmax),
                                         device="cpu")
    return js, ts


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(a), 1e-30)


@pytest.fixture(scope="module")
def gas_steps():
    """Three steps of both packages; for each of the port's steps, its SPH
    passes as {targets, niter, walks}: the hsml loop's targets and
    iterations (sph.density) and the targets of each of its stencil walks
    (the cover patch's one-target walks, sub=1, left out)."""
    js, ts = _pair(_species())
    js.hierarchical = ts.hierarchical = True
    passes = []
    dens, walk = tsg.sph_density, tsd.stencil_density_walk

    def rec_density(*a, **kw):
        passes.append({"targets": a[1].shape[0], "walks": []})
        out = dens(*a, **kw)
        passes[-1]["niter"] = out.niter
        return out

    def rec_walk(*a, **kw):
        if kw.get("sub", 32) != 1:
            passes[-1]["walks"].append(a[1].shape[0])
        return walk(*a, **kw)

    rec = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsg, "sph_density", rec_density)
        mp.setattr(tsd, "stencil_density_walk", rec_walk)
        for _ in range(3):
            js.run(max_steps=1)
            n0 = len(passes)
            ts.run(max_steps=1)
            rec.append((js.atime(), ts.atime(),
                        np.asarray(js.particles.timebin).copy(),
                        ts.particles.timebin.numpy().copy(),
                        passes[n0:]))
    return js, ts, rec


def test_gas_run_parity(gas_steps):
    js, ts, rec = gas_steps
    assert ts.gas.ngas == NG ** 3 and ts.hierarchical
    for aj, at, bj, bt, _ in rec:
        assert aj == at
    jp, tp = js.particles, ts.particles
    d = (np.asarray(jp.ipos).astype(np.int64)
         - tp.ipos.numpy().view(np.uint32).astype(np.int64))
    d = (d + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert np.abs(d).max() < 2e-5 * 2 ** 32
    vj, vt = np.asarray(jp.vel), tp.vel.numpy()
    vrel = (np.linalg.norm(vj - vt, axis=1)
            / np.maximum(np.linalg.norm(vj, axis=1), 1e-30))
    out = vrel > 1e-3
    assert out.mean() < 5e-3
    for aj, at, bj, bt, _ in rec:
        assert np.array_equal(bj[~out], bt[~out])
    ng = ts.gas.ngas
    for a, b in ((js.gas.entropy, ts.gas.entropy),
                 (js.gas.density, ts.gas.density),
                 (np.asarray(jp.hsml)[:ng], tp.hsml[:ng])):
        assert (_rel(a, b) < 1e-3).mean() >= 0.99
    assert np.isfinite(ts.gas.entropy.numpy()).all()
    assert (ts.gas.density > 0).all()


def test_gas_steps_walk_the_active_subset(gas_steps):
    """The first pass walks every gas row; a later step's density and
    hydro take only the active gas, and the hsml loop redoes only the
    targets whose hsml changed."""
    _, ts, rec = gas_steps
    first = rec[0][4][0]
    assert first["targets"] == NG ** 3
    assert first["walks"][0] == NG ** 3
    assert any(p["targets"] < NG ** 3 for r in rec[1:] for p in r[4])
    for p in (p for r in rec for p in r[4]):
        w = p["walks"]
        assert len(w) == p["niter"] and all(b <= w[0] for b in w[1:])


def test_entropy_fixed_point_parity():
    """The first density pass and the pressure-entropy fixed point of a
    gas-only 8^3 box at a = 0.1, both packages from one state."""
    js, ts = _pair(_species(gas_only=True))
    js.gas = js.gas_physics.density_hydro(js, js.gas)
    ts.gas = ts.gas_physics.density_hydro(ts, ts.gas)
    js.init_gas_entropy()
    ts.init_gas_entropy()
    assert not ts._gas_entropy_is_u
    fp = ts.gas_physics.last_fixed_point
    assert fp["converged"] and fp["iterations"] <= 100
    assert fp["maxdiff"][-1] < 1e-3
    ent, egywt = ts.gas.entropy.numpy(), ts.gas.egy_wt_density.numpy()
    np.testing.assert_allclose(ent, np.asarray(js.gas.entropy), rtol=2e-3)
    np.testing.assert_allclose(egywt, np.asarray(js.gas.egy_wt_density),
                               rtol=2e-3)
    a3 = ts.atime() ** 3
    np.testing.assert_allclose(
        ent, GAMMA_MINUS1 * U0 / np.maximum(egywt / a3, 1e-35)
        ** GAMMA_MINUS1, rtol=2e-3)
