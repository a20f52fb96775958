"""The CUDA pair kernel against its plain version, on the card.

Marked `cuda`: it skips on a host without a card.  Whether a card is
present is decided inside the test, never at import (pytest-xdist
workers must all collect the same tests).  On the card:
    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

from functools import lru_cache

import numpy as np
import pytest
import torch


def _inputs(nb, blk, S, seed):
    rng = np.random.RandomState(seed)
    tgt = rng.randint(0, 2 ** 32, (nb, blk, 3), dtype=np.uint64
                      ).astype(np.uint32)
    src = rng.randint(0, 2 ** 32, (nb, S, 3), dtype=np.uint64
                      ).astype(np.uint32)
    near = min(S, 2 * blk)
    src[:, :near] = (np.resize(tgt, (nb, near, 3)).astype(np.int64)
                     + rng.randint(-2 ** 22, 2 ** 22, (nb, near, 3))
                     ).astype(np.uint32)
    sm = rng.uniform(0.5, 2.0, (nb, S)).astype(np.float32)
    sm[:, ::7] = 0.0
    return tgt, src, sm


def _t(a, device):
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@lru_cache(maxsize=None)
def _window(dev, degree=None):
    from shenqi_tpu_torch.gravity.window import window_polynomials
    return window_polynomials(1.5, degree=degree, device=dev)


def _check(tgt, src, sm, blk, want_pot, dev, w=None, sch=None):
    """Kernel against the plain version at 2e-4 of max |acc| and |pot|
    (tests/test_pallas_p2p.py's limit), each launch counted, and a
    second launch of the same inputs giving the same bits."""
    from shenqi_tpu_torch.ops.p2p import p2p_blocked, p2p_blocked_reference
    w = _window(dev) if w is None else w
    args = (_t(tgt, dev), _t(src, dev), _t(sm, dev), 50000.0, 120.0,
            50000.0 / 64, w, 43007.1)
    kw = dict(want_pot=want_pot, blk=blk)
    if sch is not None:
        kw["sch"] = sch
    before = p2p_blocked.launches
    acc, pot = p2p_blocked(*args, **kw)
    acc2, pot2 = p2p_blocked(*args, **kw)
    torch.cuda.synchronize()
    assert p2p_blocked.launches == before + 2
    assert torch.equal(acc, acc2)
    ref_acc, ref_pot = p2p_blocked_reference(*args, **kw)
    scale = ref_acc.abs().max()
    assert (acc - ref_acc).abs().max() < 2e-4 * scale
    if want_pot:
        assert torch.equal(pot, pot2)
        assert (pot - ref_pot).abs().max() < 2e-4 * ref_pot.abs().max()
    return acc, pot


@pytest.mark.cuda
@pytest.mark.parametrize("blk", [1, 32, 128, 256])
@pytest.mark.parametrize("want_pot", [False, True])
def test_p2p_kernel_matches_plain_version(blk, want_pot):
    dev = _card()
    _check(*_inputs(64, blk, 1024, blk), blk, want_pot, dev)


# (nb, blk, S, sch): S of one 32-lane chunk; S not a multiple of the
# chunk (nor of the 8 warps' split); S = 4096 (the main-path tier); nb
# below the card's 132 SMs; blk that are not powers of two
SHAPES = [(64, 32, 32, 32), (64, 32, 1000, 8), (64, 1, 36, 4),
          (16, 32, 4096, 512), (5, 32, 512, 512), (40, 7, 520, 8),
          (24, 100, 264, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("nb,blk,S,sch", SHAPES)
@pytest.mark.parametrize("want_pot", [False, True])
def test_p2p_kernel_shapes(nb, blk, S, sch, want_pot):
    dev = _card()
    _check(*_inputs(nb, blk, S, nb + S), blk, want_pot, dev, sch=sch)


@pytest.mark.cuda
@pytest.mark.parametrize("blk", [1, 32])
def test_p2p_kernel_padding(blk):
    """A block of all-padding lanes gives exactly 0; a chunk whose only
    mass sits in its last lane, behind whole padding chunks, counts."""
    dev = _card()
    tgt, src, sm = _inputs(4, blk, 512, 7)
    sm[0] = 0.0
    sm[1] = 0.0
    sm[1, 95] = 1.5               # last lane of the third 32-lane chunk
    src[1, 95] = (tgt[1, 0].astype(np.int64) + 2 ** 20).astype(np.uint32)
    acc, pot = _check(tgt, src, sm, blk, True, dev)
    assert torch.count_nonzero(acc[0]) == 0
    assert torch.count_nonzero(pot[0]) == 0
    assert torch.count_nonzero(acc[1]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("degree,compiled", [(12, True), (16, False)])
def test_p2p_kernel_window_degree(degree, compiled):
    """Degree 12 (the default smoothing's fit) runs the instantiation
    with the degree compiled in; another degree the run-time one."""
    from shenqi_tpu_torch.ops.p2p import kernel_instantiation
    dev = _card()
    w = _window(dev, degree)
    for want_pot in (False, True):
        inst = kernel_instantiation(w, want_pot)
        assert (inst == "degree 12 compiled in") == compiled, inst
        _check(*_inputs(32, 32, 1024, degree), 32, want_pot, dev, w=w)


@pytest.mark.cuda
@pytest.mark.parametrize("blk", [1, 32, 128])
@pytest.mark.parametrize("want_pot", [False, True])
def test_p2p_kernel_erfc_window(blk, want_pot):
    """The erfc window's instantiation (ShortRangeForceWindowType erfc)
    against its plain version at 2e-4, the same bits twice, on sources
    from inside the softening to past the window's 15 cells."""
    from shenqi_tpu_torch.gravity.shortrange import ErfcWindow
    from shenqi_tpu_torch.ops.p2p import kernel_instantiation
    dev = _card()
    w = ErfcWindow(1.5)
    assert kernel_instantiation(w, want_pot) == "erfc window"
    _check(*_inputs(64, blk, 1024, 3 + blk), blk, want_pot, dev, w=w)


@pytest.mark.cuda
def test_fof_labels_on_card_equal_cpu():
    """FOF of a clustered 16^3 state with gas secondaries: the labels and
    the catalogue on the card are those of the port's CPU path, bit for
    bit (integer work: no tolerance)."""
    from shenqi_tpu_torch.core.particles import float_to_ipos
    from shenqi_tpu_torch.fof.fof import fof, fof_label
    dev = _card()
    box = 60000.0
    rng = np.random.RandomState(11)
    n = 16 ** 3
    pos = rng.uniform(0, box, (n, 3))
    clump = rng.choice(n, n // 3, replace=False)
    centers = rng.uniform(0, box, (6, 3))
    pos[clump] = centers[np.arange(len(clump)) % 6] \
        + rng.normal(0, 300.0, (len(clump), 3))
    pos %= box
    ptype = np.ones(n, np.int8)
    ptype[::4] = 0
    vel = rng.normal(0, 50, (n, 3)).astype(np.float32)
    mass = np.ones(n, np.float32)
    b = 0.2 * box / 16
    out = {}
    for d in ("cpu", dev):
        ipos = float_to_ipos(pos, box, device=d)
        prim = torch.from_numpy(ptype == 1).to(d)
        out[str(d)] = (fof_label(ipos, prim, b, box).cpu(),
                       fof(ipos, vel, mass, ptype, np.ones(n, bool), box,
                           box / 16))
    (lc, gc), (lg, gg) = out["cpu"], out[str(dev)]
    assert torch.equal(lc, lg)
    assert gg.ngroups == gc.ngroups > 0
    assert np.array_equal(gg.group_id, gc.group_id)


@pytest.mark.cuda
def test_fof_repass_on_card_equal_links():
    """FOF labels on the card with the pairs within b kept and with the
    pass run again in every iteration (the form past fof._MAX_LINKS):
    identical integers."""
    from shenqi_tpu_torch.core.particles import float_to_ipos
    from shenqi_tpu_torch.fof import fof as fofm
    dev = _card()
    box = 60000.0
    rng = np.random.RandomState(12)
    pos = np.vstack([rng.uniform(0, box, (2000, 3)),
                     rng.uniform(0, box, (3, 3)).repeat(300, 0)
                     + rng.normal(0, 60.0, (900, 3))]) % box
    ipos = float_to_ipos(pos, box, device=dev)
    alive = torch.ones(len(pos), dtype=torch.bool, device=dev)
    b = 0.2 * box / 12
    kept = fofm.fof_label(ipos, alive, b, box)
    saved = fofm._MAX_LINKS
    fofm._MAX_LINKS = 0
    try:
        again = fofm.fof_label(ipos, alive, b, box)
    finally:
        fofm._MAX_LINKS = saved
    assert torch.equal(kept, again)
    assert int(torch.bincount(kept).max()) >= 250


@pytest.mark.cuda
def test_hierarchical_run_kernel_equals_plain():
    """A hierarchical 32^3 run (half the particles in three tight clumps,
    so several levels are occupied), 4 steps, through the kernel and
    through the plain version: the trajectory limits of
    __graft_entry__.py:194-206 and equal timebins but for the velocity
    outliers."""
    from shenqi_tpu_torch.core.timeline import Timeline
    from shenqi_tpu_torch.cosmology.background import Cosmology
    from shenqi_tpu_torch.simulation import Simulation
    from shenqi_tpu_torch.utils.units import default_units
    dev = _card()
    box, n_side = 64000.0, 32
    rng = np.random.RandomState(1)
    n = n_side ** 3
    pos = rng.uniform(0, box, (n, 3))
    k = n // 6
    for c in range(3):
        pos[c * k:(c + 1) * k] = (rng.uniform(0, box, 3)
                                  + rng.normal(0, box / 200, (k, 3))) % box
    vel = rng.normal(0, 5.0, (n, 3)).astype(np.float32)
    cp = Cosmology(Omega0=0.3, OmegaLambda=0.7, OmegaBaryon=0.05,
                   HubbleParam=0.7, CMBTemperature=2.7255, RadiationOn=1)
    cp.init(0.1, default_units())
    mass = np.full(n, cp.Omega0 * cp.RhoCrit * box ** 3 / n, np.float32)
    runs = []
    for plain in (False, True):
        sim = Simulation.from_arrays(
            pos, vel, mass, np.arange(1, n + 1, dtype=np.uint64), cp, box,
            64, Timeline.setup([0.5], 0.1, 0.5), 0.1, device=dev)
        sim.hierarchical = True
        sim._plain_p2p = plain
        levels = []
        for _ in range(4):
            sim.run(max_steps=1)
            levels.append(len(torch.unique(sim.particles.timebin)))
        runs.append((sim, levels))
    (sk, lk), (sp, lp) = runs
    assert max(lk) >= 2 and lk == lp
    alive = sk.particles.mask.cpu().numpy()
    d = np.abs(sk.particles.ipos_u32()[alive].astype(np.int64)
               - sp.particles.ipos_u32()[alive].astype(np.int64))
    assert np.minimum(d, 2 ** 32 - d).max() < 2e-5 * 2 ** 32
    v1 = sp.particles.vel.cpu().numpy()[alive]
    v2 = sk.particles.vel.cpu().numpy()[alive]
    vs = float(np.median(np.abs(v1))) + 1e-6
    outlier = np.max(np.abs(v1 - v2), axis=1) > 2e-3 * vs + 1e-4
    assert np.mean(outlier) < 5e-3
    tb1 = sk.particles.timebin.cpu().numpy()[alive]
    tb2 = sp.particles.timebin.cpu().numpy()[alive]
    assert np.all((tb1 == tb2) | outlier)


@pytest.mark.cuda
def test_gas_run_on_card_equals_cpu():
    """A 16^3 gas + 16^3 DM run (the configuration of
    tests/test_torch_gas.py, quintic kernel, pressure-entropy SPH,
    hierarchical), 4 steps on the card through the pair kernel and on the
    CPU through its plain version: positions within 2e-5 of the box,
    velocity outliers under 5e-3, timebins equal but for them, entropy,
    density and hsml within 1e-3 relative for >= 99% of the gas rows."""
    from shenqi_tpu_torch.core.timeline import Timeline
    from shenqi_tpu_torch.cosmology.background import Cosmology
    from shenqi_tpu_torch.cosmology.power import InputPower
    from shenqi_tpu_torch.genic.ic import (setup_grid, gaussian_field,
                                           displacement_fields)
    from shenqi_tpu_torch.simulation import Simulation
    from shenqi_tpu_torch.simulation_gas import GasPhysics
    from shenqi_tpu_torch.sph.kernels import QUINTIC
    from shenqi_tpu_torch.utils.units import default_units
    dev = _card()
    box, ng, a_ic = 64000.0, 16, 0.1
    cp = Cosmology(Omega0=0.288, OmegaLambda=0.712, OmegaBaryon=0.0472,
                   HubbleParam=0.7, RadiationOn=1)
    cp.init(a_ic, default_units())
    power = InputPower.analytic_eh(cp, default_units().UnitLength_in_cm)
    power.normalize(sigma8=0.8, input_power_redshift=0, time_ic=a_ic)
    g_k = gaussian_field(181170, ng, unitary=True)
    lat_dm, ids_dm = setup_grid(ng, box, id_offset=1, shift_frac=0.5)
    lat_gas, ids_gas = setup_grid(ng, box, id_offset=ng ** 3 + 1)
    rd = displacement_fields(g_k, power, cp, lat_dm, box, a_ic, device="cpu")
    rg = displacement_fields(g_k, power, cp, lat_gas, box, a_ic,
                             device="cpu")
    m_gas = cp.OmegaBaryon * cp.RhoCrit * box ** 3 / ng ** 3
    m_dm = (cp.Omega0 - cp.OmegaBaryon) * cp.RhoCrit * box ** 3 / ng ** 3
    species = [(0, rg.pos, rg.vel * a_ic, m_gas, ids_gas),
               (1, rd.pos, rd.vel * a_ic, m_dm, ids_dm)]
    runs = []
    for d in (dev, torch.device("cpu")):
        sim = Simulation.from_species(
            species, cp, box, 2 * ng, Timeline.setup([0.125], a_ic, 0.125),
            a_ic, gas_u0=100.0, gas_physics=GasPhysics(kernel=QUINTIC),
            device=d)
        sim.hierarchical = True
        sim.run(max_steps=4)
        runs.append(sim)
    sk, sc = runs
    assert sk.atime() == sc.atime()
    d = np.abs(sk.particles.ipos_u32().astype(np.int64)
               - sc.particles.ipos_u32().astype(np.int64))
    assert np.minimum(d, 2 ** 32 - d).max() < 2e-5 * 2 ** 32
    v1 = sc.particles.vel.numpy()
    v2 = sk.particles.vel.cpu().numpy()
    outlier = (np.linalg.norm(v1 - v2, axis=1)
               > 1e-3 * np.maximum(np.linalg.norm(v1, axis=1), 1e-30))
    assert outlier.mean() < 5e-3
    assert np.all((sk.particles.timebin.cpu().numpy()
                   == sc.particles.timebin.numpy()) | outlier)
    n = sc.gas.ngas
    for a, b in ((sc.gas.entropy, sk.gas.entropy),
                 (sc.gas.density, sk.gas.density),
                 (sc.particles.hsml[:n], sk.particles.hsml[:n])):
        a, b = a.numpy(), b.cpu().numpy()
        assert (np.abs(a - b) / np.abs(a) < 1e-3).mean() >= 0.99


@pytest.mark.cuda
def test_subgrid_run_on_card_equals_cpu():
    """The subgrid steps of tests/test_torch_subgrid.py (8^3 gas + 8^3 DM,
    a clump above the SF threshold, four old stars, cooling, SH03 star
    formation, ofjt10 winds at 10 km/s a, metal return), 5 steps on the
    card and on the CPU: star rows, IDs, types and masks identical;
    positions within 2e-5 of the box, velocity outliers under 5e-3;
    entropy and density within 1e-3 relative for >= 99% of the gas rows;
    metallicity within 1e-4 of its max; total mass to 1e-9."""
    from shenqi_tpu_torch.core.timeline import Timeline
    from shenqi_tpu_torch.cosmology.background import Cosmology
    from shenqi_tpu_torch.cosmology.power import InputPower
    from shenqi_tpu_torch.genic.ic import (setup_grid, gaussian_field,
                                           displacement_fields)
    from shenqi_tpu_torch.physics import (cooling_rates as cr, sfr as sf,
                                          winds as wi)
    from shenqi_tpu_torch.physics.metal_return import MetalReturn
    from shenqi_tpu_torch.simulation import Simulation
    from shenqi_tpu_torch.simulation_gas import GasPhysics
    from shenqi_tpu_torch.sph.kernels import QUINTIC
    from shenqi_tpu_torch.utils.units import default_units
    import os
    dev = _card()
    box, ng, a_ic = 64000.0, 8, 0.1
    units = default_units()
    cp = Cosmology(Omega0=0.288, OmegaLambda=0.712, OmegaBaryon=0.0472,
                   HubbleParam=0.7, RadiationOn=1)
    cp.init(a_ic, units)
    power = InputPower.analytic_eh(cp, units.UnitLength_in_cm)
    power.normalize(sigma8=0.8, input_power_redshift=0, time_ic=a_ic)
    g_k = gaussian_field(181170, ng, unitary=True)
    lat_gas, ids_gas = setup_grid(ng, box, id_offset=ng ** 3 + 1,
                                  shift_frac=0.0)
    lat_dm, ids_dm = setup_grid(ng, box, id_offset=1, shift_frac=0.5)
    rg = displacement_fields(g_k, power, cp, lat_gas, box, a_ic,
                             device="cpu")
    rd = displacement_fields(g_k, power, cp, lat_dm, box, a_ic, device="cpu")
    rng = np.random.default_rng(5)
    pos = rg.pos.copy()
    r = 0.008 * box * rng.uniform(0, 1, 128) ** (1 / 3)
    u = rng.normal(size=(128, 3))
    u /= np.linalg.norm(u, axis=1)[:, None]
    pos[:128] = np.array([0.3, 0.4, 0.5]) * box + r[:, None] * u
    m_gas = cp.OmegaBaryon * cp.RhoCrit * box ** 3 / ng ** 3
    m_dm = (cp.Omega0 - cp.OmegaBaryon) * cp.RhoCrit * box ** 3 / ng ** 3
    species = [(0, pos, rg.vel * a_ic, m_gas, ids_gas),
               (1, rd.pos, rd.vel * a_ic, m_dm, ids_dm)]
    yields = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data_yields")
    old = np.arange(300, 304)
    runs = []
    for d in (dev, torch.device("cpu")):
        coolpar = cr.CoolingParams(fBar=cp.OmegaBaryon / cp.OmegaCDM)
        crit = (5e-5 * units.UnitMass_in_g / units.UnitLength_in_cm ** 3
                * 0.76 / 1.6726e-24)
        sfp = sf.SFRParams(MaxSfrTimescale=0.01, CritPhysDensity=crit).init(
            cp, units, m_gas, cr.UVBG(), coolpar)
        wp = wi.WindParams(WindModel=wi.WIND_MODEL_OFJT10).init(
            sfp.FactorSN, sfp.EgySpecSN, sfp.PhysDensThresh,
            units.UnitTime_in_s)
        gp = GasPhysics(kernel=QUINTIC, cooling_on=True, sfr_on=True,
                        winds_on=True, metal_return_on=True, coolpar=coolpar,
                        sfrpar=sfp, windpar=wp,
                        coolunits=sf.CoolingUnits.create(units,
                                                         cp.HubbleParam),
                        metals=MetalReturn.load(yields))
        sim = Simulation.from_species(
            species, cp, box, 2 * ng, Timeline.setup([0.125], a_ic, 0.125),
            a_ic, gas_u0=100.0, gas_physics=gp, star_headroom=256, device=d)
        p, g = sim.particles, sim.gas
        pt = p.ptype.clone()
        pt[old] = 4
        sim.particles = p.replace(ptype=pt)
        g.birth_a[old] = 0.05
        g.star_metallicity[old] = 0.01
        g.mass0[old] = p.mass[old]
        g.vdisp.fill_(10.0 * a_ic)
        sim.hierarchical = True
        sim.run(max_steps=5)
        runs.append(sim)
    sk, sc = runs
    assert sk.atime() == sc.atime()
    for f in ("mask", "ptype", "id_lo", "id_hi"):
        assert torch.equal(getattr(sk.particles, f).cpu(),
                           getattr(sc.particles, f)), f
    stars = (sc.particles.ptype == 4) & sc.particles.mask
    assert int(stars.sum()) >= 12
    alive = sc.particles.mask.numpy()
    d = np.abs(sk.particles.ipos_u32().astype(np.int64)
               - sc.particles.ipos_u32().astype(np.int64))[alive]
    assert np.minimum(d, 2 ** 32 - d).max() < 2e-5 * 2 ** 32
    v1 = sc.particles.vel.numpy()[alive]
    v2 = sk.particles.vel.cpu().numpy()[alive]
    outlier = (np.linalg.norm(v1 - v2, axis=1)
               > 1e-3 * np.maximum(np.linalg.norm(v1, axis=1), 1e-30))
    assert outlier.mean() < 5e-3
    n = sc.gas.ngas
    gas = ((sc.particles.ptype[:n] == 0) & sc.particles.mask[:n]).numpy()
    for a, b in ((sc.gas.entropy, sk.gas.entropy),
                 (sc.gas.density, sk.gas.density)):
        a, b = a.numpy()[gas], b.cpu().numpy()[gas]
        assert (np.abs(a - b) / np.abs(a) < 1e-3).mean() >= 0.99
    zc, zk = sc.gas.metallicity.numpy(), sk.gas.metallicity.cpu().numpy()
    assert zc.max() > 0 and np.abs(zc - zk).max() <= 1e-4 * zc.max()
    assert float(sc.particles.mass.double().sum()) == pytest.approx(
        float(sk.particles.mass.double().sum()), rel=1e-9)


@pytest.mark.cuda
def test_cooling_graph_equals_eager():
    """The rate evaluation replayed from its CUDA graph equals the same
    torch ops run one by one on the card, bit for bit, at row counts in
    three buckets and at two redshifts; the implicit solver on the card
    agrees with the CPU's within 1e-4 relative (tests/test_torch_cooling.py's
    limit)."""
    from shenqi_tpu_torch.physics import cooling_rates as tc
    dev = _card()
    p = tc.CoolingParams(MinGasTemp=5.0)
    rng = np.random.default_rng(1)
    for n in (100, 3000, 70000):
        nh = 10 ** rng.uniform(-5, 0, n)
        u = torch.tensor(10 ** rng.uniform(10, 14, n), dtype=torch.float32)
        rho = torch.tensor(nh / 0.76 * 1.6726e-24, dtype=torch.float32)
        ne = torch.tensor(rng.uniform(0, 1.2, n), dtype=torch.float32)
        for z in (9.0, 8.5):
            a = tc.heatingcooling_rate(rho.to(dev), u.to(dev), 0.24, z,
                                       tc.UVBG(), p, ne.to(dev))
            b = tc.get_heatingcooling_rate(rho.to(dev), u.to(dev), 0.24,
                                           torch.tensor(z, device=dev),
                                           tc.UVBG(), p, ne_init=ne.to(dev))
            for x, y in zip(a, b):
                assert torch.equal(x, y)
    dt = torch.tensor(10 ** rng.uniform(12, 15, n), dtype=torch.float32)
    uc, nc = tc.do_cooling(u, rho, dt, 0.24, 9.0, tc.UVBG(), p,
                           min_egyspec_cgs=1e9, ne_init=ne)
    uk, nk = tc.do_cooling(u.to(dev), rho.to(dev), dt.to(dev), 0.24, 9.0,
                           tc.UVBG(), p, min_egyspec_cgs=1e9,
                           ne_init=ne.to(dev))
    uc = uc.double().numpy()
    assert (np.abs(uk.cpu().numpy() - uc) <= 1e-4 * uc).all()
    nc = nc.double().numpy()
    assert (np.abs(nk.cpu().numpy() - nc)
            <= np.maximum(1e-4 * nc, 2.4e-7)).all()


def _bh_sim(device):
    """tests/test_torch_blackhole_sim.py's swallow-and-merger state (6^3
    gas + 6^3 DM at a = 0.5, three BHs seeded on neighbouring rows, their
    subgrid masses seven gas masses) on `device`, from one seed."""
    from shenqi_tpu_torch.core.timeline import Timeline
    from shenqi_tpu_torch.cosmology.background import Cosmology
    from shenqi_tpu_torch.physics.blackhole import BHParams
    from shenqi_tpu_torch.simulation import Simulation
    from shenqi_tpu_torch.simulation_gas import GasPhysics
    from shenqi_tpu_torch.utils.units import default_units
    box, n, a = 10000.0, 6, 0.5
    cp = Cosmology(Omega0=0.3, OmegaLambda=0.7, OmegaBaryon=0.05,
                   HubbleParam=0.7, RadiationOn=0, CMBTemperature=0.0)
    cp.init(a, default_units())
    rng = np.random.RandomState(2)
    ng = n ** 3
    grid = (np.arange(n) + 0.5) * (box / n)
    gpos = np.stack(np.meshgrid(grid, grid, grid, indexing="ij"),
                    -1).reshape(-1, 3)
    gpos = gpos + rng.uniform(-0.02, 0.02, gpos.shape) * (box / n)
    m_gas = cp.OmegaBaryon * cp.RhoCrit * box ** 3 / ng
    vel = rng.normal(0, 20, (ng, 3)).astype(np.float32)
    vel[[0, 1, 6]] = 0.0
    sp = [(0, gpos % box, vel, m_gas, np.arange(1, ng + 1)),
          (1, (gpos + 0.5 * box / n) % box,
           rng.normal(0, 20, (ng, 3)).astype(np.float32),
           (cp.Omega0 - cp.OmegaBaryon) * cp.RhoCrit * box ** 3 / ng,
           np.arange(ng + 1, 2 * ng + 1))]
    gp = GasPhysics(bh_on=True, bh_dynfric_on=True,
                    bhpar=BHParams(SeedBlackHoleMass=7.0 * m_gas,
                                   HubbleParam=0.7))
    sim = Simulation.from_species(
        sp, cp, box, 2 * n, Timeline.setup([0.6], a, 0.6), a, gas_u0=10.0,
        gas_physics=gp, device=device)
    mean_rho = m_gas * ng / box ** 3
    sim.gas = sim.gas.replace(
        density=torch.tensor(rng.uniform(0.5, 2, ng) * mean_rho,
                             dtype=torch.float32, device=device),
        entropy=torch.tensor(rng.uniform(30, 70, ng), dtype=torch.float32,
                             device=device))
    hs = sim.particles.hsml.clone()
    hs[:ng] = 1.5 * box / n
    sim.particles = sim.particles.replace(hsml=hs)
    sim.gas = gp.seed_bh(sim, sim.gas, [0, 1, 6])
    return sim


@pytest.mark.cuda
def test_blackhole_step_on_card_equals_cpu():
    """blackhole_step (environment, accretion, feedback, the swallow draw,
    mergers, drag, dynamical friction) on the card and on the CPU from one
    state: ptype, mask, the swallowed rows and the merger survivors
    identical, bh_mass, bh_mdot, entropy, mass and velocity within 1e-5 of
    each field's largest value, the key chains at the same state."""
    dev = _card()
    sims = [_bh_sim(d) for d in (dev, torch.device("cpu"))]
    for s in sims:
        s.gas = s.gas_physics.blackhole_step(s, s.gas, 0.002)
    sk, sc = sims
    assert sk.gas_physics.last_bh_stats == sc.gas_physics.last_bh_stats
    assert sc.gas_physics.last_bh_stats["mergers"] == 2
    assert sc.gas_physics.last_bh_stats["swallowed"] >= 1
    assert sk.gas_physics.rng_key == sc.gas_physics.rng_key
    for f in ("mask", "ptype"):
        assert torch.equal(getattr(sk.particles, f).cpu(),
                           getattr(sc.particles, f)), f
    for a, b in ((sc.gas.bh_mass, sk.gas.bh_mass),
                 (sc.gas.bh_mdot, sk.gas.bh_mdot),
                 (sc.gas.entropy, sk.gas.entropy),
                 (sc.particles.mass, sk.particles.mass),
                 (sc.particles.vel, sk.particles.vel)):
        a, b = a.double().numpy(), b.cpu().double().numpy()
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()


@pytest.mark.cuda
def test_cooling_graph_metal_rows_equals_eager():
    """The rate evaluation with a metal cooling table and a per-row UVBG
    (the fluctuating UVB gating half the rows), replayed from its CUDA
    graph, equals the same evaluation op by op on the card bit for bit, at
    two row buckets and two redshifts; the implicit solver with both on the
    card agrees with the CPU's within 1e-4 relative."""
    from shenqi_tpu_torch.physics import cooling_rates as tc
    from shenqi_tpu_torch.physics.uv_fluctuations import (MetalCoolingTable,
                                                          local_uvbg)
    dev = _card()
    p = tc.CoolingParams(MinGasTemp=5.0)
    zb = np.array([0.0, 2.0, 5.0, 9.0, 12.0])
    nb = np.arange(-8.0, 4.0)
    tb = np.array([1.0, 3.0, 4.0, 5.0, 6.0, 8.0, 9.5])
    Z, N, T = np.meshgrid(zb, nb, tb, indexing="ij")
    mc = MetalCoolingTable(zb, nb, tb, 3e2 * 10 ** (0.5 * N)
                           * (1 + 0.05 * Z) * 10 ** (-0.3 * np.abs(T - 5.2)))
    g = tc.UVBG(gJH0=1e-13, gJHe0=8e-14, gJHep=5e-16, epsH0=6e-25,
                epsHe0=7e-25, epsHep=1e-26, self_shield_dens=3e-3)
    rng = np.random.default_rng(3)
    for n in (100, 3000):
        nh = 10 ** rng.uniform(-5, 0, n)
        u = torch.tensor(10 ** rng.uniform(10, 14, n), dtype=torch.float32)
        rho = torch.tensor(nh / 0.76 * 1.6726e-24, dtype=torch.float32)
        ne = torch.tensor(rng.uniform(0, 1.2, n), dtype=torch.float32)
        met = torch.tensor(rng.uniform(0, 0.04, n), dtype=torch.float32)
        zre = torch.tensor(rng.choice([6.0, 10.0], n), dtype=torch.float32)
        for z in (7.0, 6.5):
            uv = local_uvbg(g, zre.to(dev), z)
            a = tc.heatingcooling_rate(rho.to(dev), u.to(dev), 0.24, z, uv,
                                       p, ne.to(dev),
                                       metallicity=met.to(dev),
                                       metal_cool=mc)
            b = tc.get_heatingcooling_rate(
                rho.to(dev), u.to(dev), 0.24, torch.tensor(z, device=dev),
                uv, p, ne_init=ne.to(dev), metallicity=met.to(dev),
                metal_cool=mc)
            for x, y in zip(a, b):
                assert torch.equal(x, y)
    dt = torch.tensor(10 ** rng.uniform(12, 15, n), dtype=torch.float32)
    out = []
    for d in (torch.device("cpu"), dev):
        uv = local_uvbg(g, zre.to(d), 7.0)
        out.append(tc.do_cooling(u.to(d), rho.to(d), dt.to(d), 0.24, 7.0,
                                 uv, p, min_egyspec_cgs=1e9,
                                 ne_init=ne.to(d), metallicity=met.to(d),
                                 metal_cool=mc))
    (uc, nc), (uk, nk) = out
    uc = uc.double().numpy()
    assert (np.abs(uk.cpu().numpy() - uc) <= 1e-4 * uc).all()
    nc = nc.double().numpy()
    assert (np.abs(nk.cpu().numpy() - nc)
            <= np.maximum(1e-4 * nc, 2.4e-7)).all()


@pytest.mark.cuda
def test_plane_counts_on_card_equals_cpu():
    """plane_counts_ipos on the card: the integer counts and n_plane
    bit-identical to the CPU's, for a thin slab, one that wraps the box
    edge and the whole box (positions of 2^31 and above included)."""
    dev = _card()
    from shenqi_tpu_torch.physics.plane import plane_counts_ipos
    rng = np.random.RandomState(7)
    ipos = rng.randint(0, 2 ** 32, (400000, 3), dtype=np.uint64).astype(
        np.uint32)
    alive = rng.rand(len(ipos)) < 0.9
    for normal, center, thick in ((0, 60.0, 50.0), (1, 5.0, 30.0),
                                  (2, 125.0, 250.0)):
        c0, n0 = plane_counts_ipos(_t(ipos, "cpu"), torch.from_numpy(alive),
                                   250.0, normal, center, thick, 256)
        c1, n1 = plane_counts_ipos(_t(ipos, dev),
                                   torch.from_numpy(alive).to(dev), 250.0,
                                   normal, center, thick, 256)
        assert torch.equal(c1.cpu(), c0) and int(n1) == int(n0) > 0


@pytest.mark.cuda
def test_excursion_pass_on_card_equals_cpu():
    """calculate_uvbg at UVBGdim 64 on the card (cuFFT) against the CPU:
    the ionized cells the same in 99.9% of the cells, J21 within 1e-4 of
    its max where both ionize alike, the global xHI within 1e-3, the gas
    rows' J21 within 1e-4 of its max on 95% of them
    (tests/test_torch_excursion.py's limits)."""
    dev = _card()
    from shenqi_tpu_torch.cosmology.background import Cosmology
    from shenqi_tpu_torch.physics.excursion import (ExcursionSetParams,
                                                    calculate_uvbg)
    from shenqi_tpu_torch.utils.units import default_units
    cp = Cosmology(Omega0=0.3, OmegaLambda=0.7, OmegaBaryon=0.05,
                   HubbleParam=0.7, RadiationOn=0, CMBTemperature=0.0)
    cp.init(0.1, default_units())
    rng = np.random.RandomState(0)
    box, n_dm, n_star, n_gas = 20000.0, 200000, 20000, 20000
    pos = np.vstack([rng.uniform(0.1 * box, 0.3 * box, (n_gas, 3)),
                     rng.uniform(0, box, (n_dm, 3)),
                     rng.uniform(0.1 * box, 0.3 * box, (n_star, 3))])
    m_dm = cp.Omega0 * cp.RhoCrit * box ** 3 / n_dm
    mass = np.concatenate([np.full(n_gas, 0.05 * m_dm), np.full(n_dm, m_dm),
                           np.full(n_star, 0.05 * m_dm)]).astype(np.float32)
    ptype = np.concatenate([np.zeros(n_gas, np.int8), np.ones(n_dm, np.int8),
                            np.full(n_star, 4, np.int8)])
    fesc = np.where(ptype == 4, 1.0, 0.0).astype(np.float32)
    ip = (pos / box * 2 ** 32).astype(np.uint64).astype(np.uint32)
    par = ExcursionSetParams(UVBGdim=64, ReionRBubbleMax=4000.0,
                             ReionRBubbleMin=400.0)
    res = [calculate_uvbg(_t(ip, d), torch.from_numpy(mass).to(d),
                          torch.from_numpy(ptype).to(d),
                          torch.zeros(len(ip), device=d),
                          torch.from_numpy(fesc).to(d), 0.125, cp,
                          default_units(), box, par)
           for d in ("cpu", dev)]
    x0, x1 = res[0].xhi_grid.numpy(), res[1].xhi_grid.cpu().numpy()
    j0, j1 = res[0].j21_grid.numpy(), res[1].j21_grid.cpu().numpy()
    assert (x0 == 0).any() and ((x0 == 0) == (x1 == 0)).mean() >= 0.999
    both = (x0 == 0) & (x1 == 0)
    assert (np.abs(j0 - j1)[both] <= 1e-4 * j0.max()).mean() >= 0.999
    assert abs(float(res[0].vol_weighted_xhi)
               - float(res[1].vol_weighted_xhi)) <= 1e-3
    p0 = res[0].j21_particles.numpy()[:n_gas]
    p1 = res[1].j21_particles.cpu().numpy()[:n_gas]
    assert (np.abs(p0 - p1) <= 1e-4 * p0.max()).mean() >= 0.95


def _nccl_stencil_body(rank, dev):
    """One NCCL rank: the slab short range of a clustered state through
    the kernel and through its plain version (module level: spawned)."""
    from shenqi_tpu_torch.core.particles import float_to_ipos
    from shenqi_tpu_torch.gravity.shortrange import ShortRangeParams
    from shenqi_tpu_torch.parallel import collectives as cc
    from shenqi_tpu_torch.parallel.sharded import stencil_forces_slab
    rng = np.random.RandomState(4)
    box, n = 50000.0, 32768
    pos = rng.uniform(0, box, (n, 3))
    pos[: n // 4] = (box / 3 + rng.normal(0, box / 200, (n // 4, 3))) % box
    sp = ShortRangeParams(boxsize=box, rcut=4.5 * box / 64,
                          softening=box / 64 / 30, asmth=1.5,
                          G=43007.1, cellsize=box / 64)
    f = {"ipos": float_to_ipos(pos, box, device=dev),
         "mass": torch.full((n,), 1e-3, device=dev)}
    acc, info = stencil_forces_slab(f, sp, _window(dev), 1)
    plain, _ = stencil_forces_slab(f, sp, _window(dev), 1, _plain=True)
    one = cc.all_sum(torch.ones(1, device=dev))      # through NCCL
    err = float((acc - plain).abs().max() / plain.abs().max())
    return {"backend": cc.backend(), "err": err, "sum": float(one),
            "targets": info["targets"]}


@pytest.mark.cuda
def test_slab_stencil_nccl_rank_equals_plain(tmp_path):
    """A single-rank NCCL process group runs stencil_forces_slab with the
    kernel within 2e-4 of its plain version."""
    _card()
    from shenqi_tpu_torch.parallel.launch import run_ranks
    out = run_ranks(_nccl_stencil_body, 1, (), "cuda",
                    str(tmp_path / "store"), 120.0, 600.0)
    assert out["backend"] == "nccl" and out["sum"] == 1.0
    assert out["targets"] == 32768
    assert out["err"] < 2e-4, out


@pytest.mark.cuda
def test_mesh2_refused_on_one_card(tmp_path):
    """--mesh 2 on a host with one card raises, naming the count; it never
    falls back to gloo, the CPU or fewer ranks."""
    _card()
    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has two cards")
    from shenqi_tpu_torch.parallel.launch import run_ranks
    with pytest.raises(RuntimeError, match="needs 2 cards.*1 present"):
        run_ranks(_nccl_stencil_body, 2, (), "cuda",
                  str(tmp_path / "store"))


def _nccl_sph_body(rank, dev):
    """One NCCL rank: slab density and hydro of a clustered gas state
    against the single-device stencil SPH on the same card (module level:
    spawned)."""
    from shenqi_tpu_torch.core.particles import float_to_ipos
    from shenqi_tpu_torch.parallel import collectives as cc
    from shenqi_tpu_torch.parallel.sph_slab import density_slab, hydro_slab
    from shenqi_tpu_torch.sph.density import density
    from shenqi_tpu_torch.sph.hydro import (HydroParams, balsara_f1,
                                            hydro_time_factors,
                                            pressure_predict)
    from shenqi_tpu_torch.sph.stencil_hydro import stencil_hydro_walk
    rng = np.random.RandomState(6)
    box, n = 50000.0, 32768
    pos = rng.uniform(0, box, (n, 3))
    pos[: n // 4] = (box / 3 + rng.normal(0, box / 100, (n // 4, 3))) % box
    f = {"ipos": float_to_ipos(pos, box, device=dev),
         "mass": torch.ones(n, device=dev),
         "vel": torch.from_numpy(rng.normal(0, 30, (n, 3)).astype(
             np.float32)).to(dev),
         "entvar": torch.ones(n, device=dev)}
    h0 = torch.full((n,), 2.0 * box / n ** (1 / 3), device=dev)
    d1, info = density_slab(f, h0, box, 1)
    d0 = density(f, f["ipos"], f["vel"], f["entvar"], h0, box)
    tf = hydro_time_factors(0.5, 0.15)
    press = pressure_predict(torch.clamp(d0.egy_wt_density, min=1e-35),
                             f["entvar"])
    f1 = balsara_f1(d0.div_vel, d0.curl_vel, torch.sqrt(
        5 / 3 * press / torch.clamp(d0.egy_wt_density, min=1e-35)),
        d0.hsml, tf["fac_mu"])
    z = torch.zeros(n, device=dev)
    src = {**f, "hsml": d0.hsml, "density": d0.density,
           "eomdensity": d0.egy_wt_density, "pressure": press,
           "divvel": d0.div_vel, "curlvel": d0.curl_vel,
           "dhsml_egy": d0.dhsml_egy_density_factor, "dloga": z,
           "decoupled": torch.zeros(n, dtype=torch.bool, device=dev)}
    tg = {"ipos": f["ipos"], "vel": f["vel"], "hsml": d0.hsml,
          "mass": f["mass"], "density": d0.density,
          "egyrho": d0.egy_wt_density, "entvar": f["entvar"],
          "pressure": press, "f1": f1, "dhsml": d0.dhsml_egy_density_factor,
          "dloga": z}
    par = HydroParams(boxsize=box)
    h1, _ = hydro_slab(src, tg, par, tf, box, 1)
    table = torch.stack([f["mass"], d0.hsml, *f["vel"].T, d0.density,
                         d0.egy_wt_density, f["entvar"], press, d0.div_vel,
                         d0.curl_vel, d0.dhsml_egy_density_factor, z], 1)
    h0_, _, nc, _ = stencil_hydro_walk(f["ipos"], table, tg, par, tf=tf)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())
    return {"backend": cc.backend(), "niter": (info["niter"], d0.niter),
            "hsml": float(((d1.hsml - d0.hsml).abs() / d0.hsml).max()),
            "rho": float(((d1.density - d0.density).abs()
                          / d0.density).max()),
            "acc": rel(h1.accel, h0_.accel), "cover": nc}


@pytest.mark.cuda
def test_slab_sph_nccl_rank_equals_single_device(tmp_path):
    """A single-rank NCCL process group runs the slab density loop and
    hydro on a clustered state, equal to the single-device stencil SPH on
    the card (hsml and density within rtol 3e-5, the iterations equal,
    accelerations within 1e-4 of the largest)."""
    _card()
    from shenqi_tpu_torch.parallel.launch import run_ranks
    out = run_ranks(_nccl_sph_body, 1, (), "cuda", str(tmp_path / "store"),
                    120.0, 600.0)
    assert out["backend"] == "nccl"
    assert out["niter"][0] == out["niter"][1], out
    assert out["hsml"] < 3e-5 and out["rho"] < 3e-5, out
    assert out["acc"] < 1e-4, out


def _slab_sources(dev):
    """The slab source stage of tests/test_torch_slab_subgrid.py's sf
    state with ofjt10 winds, black holes and old stars as well, on `dev`
    (the state forced by id in the port itself, as that file forces the
    JAX one):
    one _gas_source_terms, one _slab_blackhole_step and one
    _slab_metal_return.  Returns the alive rows on the host, by id."""
    import os
    import test_torch_slab_subgrid as SS
    from shenqi_tpu_torch.core.integrate import TimestepParams
    from shenqi_tpu_torch.core.timeline import Timeline
    from shenqi_tpu_torch.parallel.slab_sim import SlabSimulation
    from shenqi_tpu_torch.physics.blackhole import BHParams
    from shenqi_tpu_torch.physics.metal_return import MetalReturn
    from shenqi_tpu_torch.physics.winds import WIND_MODEL_OFJT10, WindParams
    from shenqi_tpu_torch.simulation_gas import GasPhysics
    from shenqi_tpu_torch.utils import threefry
    from shenqi_tpu_torch.utils.constants import GAMMA_MINUS1
    a0 = SS.SETUP["sf"][0]
    a3inv = 1.0 / a0 ** 3
    ph = SS._physics("sf", SS._torch_mods())
    sp = ph["sp"]
    wp = WindParams(WindModel=WIND_MODEL_OFJT10, WindFreeTravelLength=20.0)
    wp.init(sp.FactorSN, sp.EgySpecSN, sp.PhysDensThresh,
            ph["units"].UnitTime_in_s)
    ydir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data_yields")
    gp = GasPhysics(cooling_on=True, sfr_on=True, winds_on=True,
                    coolpar=ph["coolpar"], coolunits=ph["cu"], sfrpar=sp,
                    windpar=wp, metal_return_on=True,
                    metals=MetalReturn.load(ydir), bh_on=True,
                    bhpar=BHParams(**SS.BH), bh_dynfric_on=True,
                    rng_key=threefry.PRNGKey(7))
    sim = SlabSimulation.from_species(
        SS._species("sf"), ph["cp"], SS.BOX, SS.NMESH,
        Timeline.setup([a0 + 0.01], a0, a0 + 0.01), a0, gas_u0=100.0,
        tsp=TimestepParams(), gas_physics=gp, device=dev)
    r = dict(sim._rows())
    gas = r["ptype"] == 0
    idl = r["id_lo"].long()
    dens = torch.where(idl % 2 == 0, 20.0, 0.01) * sp.PhysDensThresh / a3inv
    dens = torch.where(gas, dens, 0.0).to(torch.float32)
    u0 = sp.temp_to_u * 1e4
    ent = u0 * GAMMA_MINUS1 / torch.clamp(dens * a3inv,
                                          min=1e-35) ** GAMMA_MINUS1
    star = gas & (idl % 16 == 3)
    r.update(density=dens, egy_wt_density=dens,
             entropy=torch.where(gas, ent, r["entropy"]),
             hsml=torch.where(gas, 180.0, r["hsml"]),
             vdisp=torch.where(gas, 120.0, 0.0),
             ptype=torch.where(star, 4, r["ptype"]).to(torch.int8),
             birth_a=torch.where(star, 0.1, r["birth_a"]),
             mass0=torch.where(star, r["mass"], r["mass0"]),
             star_metallicity=torch.where(star, 0.01, 0.0))
    sim._set_rows(r)
    sim._seed_bh_rows(torch.nonzero((sim.particles.ptype == 0)
                                    & (sim.particles.id_lo % 64 == 0))
                      .squeeze(1).cpu().numpy())
    sim._gas_source_terms(1e-2)
    sim._slab_blackhole_step(5.0)
    sim._slab_metal_return()
    out = {k: v[sim._rows()["mask"]].cpu().numpy()
           for k, v in sim._rows().items()}
    ids = ((out["id_hi"].view(np.uint32).astype(np.uint64) << np.uint64(32))
           | out["id_lo"].view(np.uint32).astype(np.uint64))
    o = np.argsort(ids)
    res = {k: v[o] for k, v in out.items()}
    res["id"] = ids[o]
    res["stars"] = sim.star_count
    res["pack"] = np.array([(e["stage"], e["pack"]) for e in sim.source_log])
    return res


def _nccl_sources_body(rank, dev, out):
    """One NCCL rank's slab source stage (module level: spawned); its rows
    go back through an .npz (run_ranks returns small values only)."""
    from shenqi_tpu_torch.parallel import collectives as cc
    np.savez(out, **_slab_sources(dev))
    return {"backend": cc.backend()}


@pytest.mark.cuda
def test_slab_sources_nccl_rank_equals_cpu(tmp_path):
    """One NCCL rank's slab source stage (star formation with splits,
    ofjt10 winds over the gathered stars, a BH step with swallows and
    dynamical friction, the metal return) on the card against the same
    stage in one CPU process: ids, types, the stars formed and the packs
    identical; mass, velocity, entropy, metallicity and the BH masses
    within 1e-4 of each column's largest value (the cooling and kernel
    sums in f32 on two devices)."""
    _card()
    from shenqi_tpu_torch.parallel.launch import run_ranks
    out = str(tmp_path / "card.npz")
    ret = run_ranks(_nccl_sources_body, 1, (out,), "cuda",
                    str(tmp_path / "store"), 120.0, 600.0)
    card = dict(np.load(out))
    cpu = _slab_sources("cpu")
    assert ret["backend"] == "nccl"
    assert cpu["stars"] > 0 and card["stars"] == cpu["stars"]
    np.testing.assert_array_equal(card["pack"], cpu["pack"])
    np.testing.assert_array_equal(card["id"], cpu["id"])
    np.testing.assert_array_equal(card["ptype"], cpu["ptype"])
    assert (cpu["ptype"] == 5).any() and (cpu["delay_time"] > 0).any()
    for k in ("mass", "vel", "entropy", "metallicity", "bh_mass", "bh_mdot"):
        a, b = card[k].astype(np.float64), cpu[k].astype(np.float64)
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1e-30), k
