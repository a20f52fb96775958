"""MP-Gadget equivalent CLI (gadget/main.cpp analog), the single-device
path of shenqi_tpu/cli/gadget_main.py for the port.

Usage:
  python -m shenqi_tpu_torch.cli.gadget_main paramfile [RestartFlag] [SnapNum] [--mesh N] [--device cpu]

RestartFlag semantics match the reference (gadget/main.cpp:51-119):
  (none)/2 : start from the IC file (or snapshot SnapNum if given)
  1        : restart from the last stored snapshot
  3        : run FOF on snapshot SnapNum and write a halo catalog
  4        : compute and write the power spectrum of snapshot SnapNum

The run is on the card unless `--device cpu` is given.  It runs
hierarchical gravity (SplitGravityTimestepsOn, on by default) or the
plain individual timesteps, the massive-neutrino linear response
(MassiveNuLinRespOn) and gas (gas particles with HydroOn:
pressure-entropy or density-entropy SPH; CoolingOn, StarformationOn,
WindOn and MetalReturnOn with an optional TreeCoolFile, MetalCoolFile
with MetalCoolingOn and UVFluctuationFile; BlackHoleOn with its
seeding FOF on PM steps, blackholes.txt and BlackholeDetails.bin;
QSOLightupOn/HeliumReionizationOn with a ReionHistFile (a FOF on every
PM step of the helium era); ExcursionSetReionOn with a J21CoeffFile;
snapshots with the gas, star and BH blocks, sfr.txt, resumes that
restore the gas, star and BH state), LightconeOn (the LIGHTCONE
bigfile), WritePlaneOn (FITS potential planes at each snapshot FOF) and
either short-range window (ShortRangeForceWindowType exact or erfc, the
latter on this path and on --mesh).
`--mesh N` runs the slab loop on N spawned ranks (NCCL on cuda:0..N-1,
gloo with --device cpu; _spawn_slab, _run_slab): dark matter and, with
HydroOn, SPH with the gas blocks in its snapshots, and CoolingOn,
StarformationOn, WindOn, MetalReturnOn, BlackHoleOn (the seeding FOF on
PM steps, over the ranks), MetalCoolFile and UVFluctuationFile; like the
JAX --mesh run it writes no star or BH blocks, sfr.txt or
blackholes.txt, and a resume reads no gas, star or BH block: its gas
starts from InitGasTemp and the IC fixed point, its stars with birth_a 0
and its BHs with bh_mass 0 (ROADMAP C.4).  What the port does not have
yet is refused with the ROADMAP item that brings it: on --mesh
reionization, lightcones and planes (A.9.4) and `--mesh AxB` (A.9.5);
RestartFlag 99 (A.10).
"""

from __future__ import annotations

import os
import re
import sys
import time

import numpy as np
import torch

from .._device import resolve_device
from .genic_main import _pop_device
from .params import gadget_params
from ..utils.units import get_unitsystem
from ..utils.config import build_output_list
from ..utils.constants import (CM_PER_MPC, BOLTZMANN, PROTONMASS,
                               GAMMA_MINUS1, HYDROGEN_MASSFRAC)
from ..utils.hci import HCI
from ..utils.walltime import Walltime
from ..utils.stats import (energy_statistics_fast, sfr_statistics,
                           bh_statistics_fast)
from ..cosmology.background import Cosmology
from ..core.timeline import Timeline
from ..core.integrate import TimestepParams
from ..core.particles import (ParticleData, float_to_ipos, u32,
                              u32_numpy_to_i32)
from ..io.snapshot import SnapshotHeader, read_snapshot, write_snapshot
from ..io.fofio import save_fof, save_fof_particles
from ..io.sharded_io import gas_internal_energy
from ..simulation import Simulation
from ..simulation_gas import GasPhysics
from ..sph.kernels import KERNELS
from ..physics.blackhole import BHParams, seed_black_holes
from ..physics.cooling_rates import CoolingParams, TreeCool, UVBG
from ..physics.metal_return import MetalReturn
from ..physics.sfr import SFRParams, CoolingUnits
from ..physics.uv_fluctuations import (ZreionTable, MetalCoolingTable,
                                       J21Coeffs)
from ..physics.excursion import ExcursionSetParams
from ..physics.helium_reion import HeliumReion, QSOLightupParams
from ..physics.lightcone import Lightcone
from ..physics.plane import (PlaneParams, plane_counts_ipos,
                             write_planes_deposit)
from ..physics.winds import WindParams
from ..physics.neutrinos_lra import DeltaTotTable
from ..fof.fof import fof


def load_cosmology(ps, hdr: SnapshotHeader, time_begin, units):
    def pick(par, hval):
        v = ps.get_double(par)
        return hval if v < 0 else v
    cp = Cosmology(
        Omega0=ps.get_double("Omega0"),
        OmegaLambda=pick("OmegaLambda", hdr.OmegaLambda),
        OmegaBaryon=pick("OmegaBaryon", hdr.OmegaBaryon),
        HubbleParam=pick("HubbleParam", hdr.HubbleParam),
        CMBTemperature=ps.get_double("CMBTemperature"),
        RadiationOn=ps.get_int("RadiationOn"),
        Omega_fld=ps.get_double("Omega_fld"),
        w0_fld=ps.get_double("w0_fld"),
        wa_fld=ps.get_double("wa_fld"),
        Omega_ur=ps.get_double("Omega_ur"),
        MNu=(ps.get_double("MNue"), ps.get_double("MNum"),
             ps.get_double("MNut")),
        MassiveNuLinRespOn=ps.get_int("MassiveNuLinRespOn"))
    cp.init(time_begin, units)
    return cp


# the data_yields/ beside the package: the metal return's default tables
_YIELDS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data_yields")


def _read_particles(snap_path):
    """(header, (pos, vel, ids, mass, ptype), the snapshot's blocks)."""
    hdr, blocks = read_snapshot(snap_path)
    pos_l, vel_l, ids_l, mass_l, type_l = [], [], [], [], []
    for t, props in sorted(blocks.items()):
        pos = props["Position"]
        n = len(pos)
        pos_l.append(pos)
        vel = props["Velocity"].astype(np.float64)
        if hdr.UsePeculiarVelocity:
            vel = vel * hdr.Time   # internal v = a * v_pec
        vel_l.append(vel)
        ids_l.append(props.get("ID", np.arange(n, dtype=np.uint64)))
        if "Mass" in props:
            mass_l.append(props["Mass"].astype(np.float64))
        else:
            mass_l.append(np.full(n, hdr.MassTable[t]))
        type_l.append(np.full(n, t, dtype=np.int8))
    return hdr, (np.concatenate(pos_l), np.concatenate(vel_l),
                 np.concatenate(ids_l), np.concatenate(mass_l),
                 np.concatenate(type_l)), blocks


def _init_checks(pos, ids, mass, cp, boxsize):
    """IC validation (init.cpp:88-115 analogs): unique IDs, positions
    inside the box, total matter mass consistent with Omega0."""
    if len(np.unique(ids)) != len(ids):
        raise ValueError("duplicate particle IDs in the ICs "
                         "(domain_test_id_uniqueness)")
    if np.any(pos < 0) or np.any(pos > boxsize):
        raise ValueError("particle positions outside the box "
                         "(check_positions)")
    masstot = float(np.sum(mass))
    omega = masstot / boxsize ** 3 / cp.RhoCrit
    omega_exp = cp.Omega0
    if cp.MassiveNuLinRespOn:
        omega_exp -= cp.ONu.get_omega_nu(1.0)
    if abs(omega - omega_exp) > 5e-2 * omega_exp:
        # the reference endruns here; tolerate synthetic test
        # snapshots but make the inconsistency loud
        print(f"WARNING: IC mass inconsistent with Omega0: particles "
              f"give Omega={omega:.4g}, expected {omega_exp:.4g} "
              f"(check_omega)")


def _resume_snap_counter(outdir):
    """Fallback snapshot counter: one past the last snapshot on
    record, so unplanned (HCI/off-OutputList) dumps never overwrite
    an existing PART_* after a RestartFlag-1 resume."""
    try:
        with open(os.path.join(outdir, "LastSnapNum.txt")) as f:
            return int(f.read().strip()) + 1
    except (OSError, ValueError):
        return 0


def _snap_index(ps, a, fallback):
    """Snapshot number = position of `a` in the FULL OutputList, so a run
    resumed from PART_k keeps writing PART_{k+1}... (timebinmgr.cpp
    setup_sync_points + checkpoint.cpp find_last_snapnum).  Falls back
    to the sequential counter when `a` is not an OutputList entry."""
    try:
        times = sorted(set(build_output_list(
            ps.get_string("OutputList"))))
    except Exception:
        return fallback
    if not times:
        return fallback
    ls = np.log(times)
    i = int(np.argmin(np.abs(ls - np.log(a))))
    if abs(ls[i] - np.log(a)) < 1e-6:
        return i
    return fallback


def _write_power(fn, kk, pk, nm, d1):
    """powerspectrum-%.4f.txt (gravpm.cpp:110-118 convention)."""
    with open(fn, "w") as f:
        f.write("# in Mpc/h Units \n")
        f.write(f"# D1 = {d1:g} \n")
        f.write("# k P N P(z=0)\n")
        for j in range(len(kk)):
            if nm[j] > 0:
                f.write(f"{kk[j]:g} {pk[j]:g} {int(nm[j])} "
                        f"{pk[j] / d1 ** 2:g}\n")


def _refuse_unported(ps, restart_flag, mesh_devices):
    """What the run path needs that the port has not ported (FOF and
    P(k) of a snapshot, RestartFlag 3 and 4, need none of it).  `--mesh
    N` runs the slab loop with dark matter, gas and the subgrid sources
    (ROADMAP A.9.1-A.9.3); what it does not have yet is refused with its
    item."""
    reion = [k for k in ("HeliumReionizationOn", "QSOLightupOn",
                         "ExcursionSetReionOn", "LightconeOn",
                         "WritePlaneOn") if ps.get_int(k)]
    mesh = bool(mesh_devices) and restart_flag not in (3, 4)
    refuse = [
        (restart_flag == 99, "RestartFlag 99 (the force tests)", "A.10"),
        (mesh and "x" in str(mesh_devices),
         f"--mesh {mesh_devices} (the 2-D PM processor grid)", "A.9.5"),
        (mesh and bool(reion), f"--mesh with {', '.join(reion)}",
         "A.9.4")]
    for cond, what, item in refuse:
        if cond:
            raise NotImplementedError(
                f"gadget_main: {what} is not ported yet (ROADMAP {item})")


def _restore_gas_state(sim, blocks, ptype, atime, cp, min_egyspec=0.0):
    """Restore the gas (and star/BH) state from snapshot blocks on a
    resume (gadget_main.py:136-234 of the JAX package).

    The reference's petaio read-side converters (petaio.cpp:858-865:
    Entropy = (g-1) u / (Density a^-3)^(g-1), with the density read
    first) and check_density_entropy's fixups and MinEgySpec floor
    (init.cpp:363-389), in host float64 as the JAX package does them;
    the floor is the star-formation model's (0 without it).  Rows in
    `sim` are ordered by sorted ptype with the order within a type kept,
    matching `blocks`."""
    dev = sim.device

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    g = blocks[0]
    ngas = int(sim.gas.ngas)
    a3inv = 1.0 / atime ** 3
    meanbar = cp.OmegaBaryon * cp.RhoCrit
    dens = np.asarray(g["Density"], np.float64).copy()
    bad = (dens <= 0) | ~np.isfinite(dens)
    dens[bad] = meanbar
    if bad.any():
        print(f"Detected bad densities in {bad.sum()} particles on disc")
    egyw = np.asarray(g.get("EgyWtDensity", dens), np.float64).copy()
    badw = (egyw <= 0) | ~np.isfinite(egyw)
    egyw[badw] = dens[badw]
    u = np.asarray(g["InternalEnergy"], np.float64)
    with np.errstate(invalid="ignore"):
        ent = GAMMA_MINUS1 * u / (dens * a3inv) ** GAMMA_MINUS1
    minent = GAMMA_MINUS1 * min_egyspec / (dens * a3inv) ** GAMMA_MINUS1
    ent = np.where(~np.isfinite(ent) | (ent < minent), minent, ent)
    gas = sim.gas
    rep = dict(entropy=t(ent), density=t(dens), egy_wt_density=t(egyw))
    for name, attr in (("ElectronAbundance", "ne"),
                       ("StarFormationRate", "sfr"),
                       ("Metallicity", "metallicity"),
                       ("DelayTime", "delay_time")):
        if name in g:
            rep[attr] = t(g[name])
    if "Generation" in g:
        rep["generation"] = t(g["Generation"], np.int32)
    if "SmoothingLength" in g:
        hs = sim.particles.hsml.clone()
        hs[:ngas] = t(g["SmoothingLength"])
        sim.particles = sim.particles.replace(hsml=hs)
    # star rows: formation time, birth metallicity, return budget; BH
    # rows: mass and accretion rate
    offs = {}
    o = 0
    for ty in sorted(set(ptype.tolist())):
        n_t = int((ptype == ty).sum())
        offs[ty] = (o, o + n_t)
        o += n_t

    def put(attr, lo, hi, vals):
        a = rep.get(attr, getattr(gas, attr)).clone()
        a[lo:hi] = t(vals)
        rep[attr] = a

    if 4 in blocks and 4 in offs:
        s0, s1 = offs[4]
        st = blocks[4]
        for name, attr in (("StellarFormationTime", "birth_a"),
                           ("Metallicity", "star_metallicity"),
                           ("LastEnrichmentMyr", "last_enrich_myr"),
                           ("TotalMassReturned", "total_returned")):
            if name in st:
                put(attr, s0, s1, st[name])
        if "TotalMassReturned" in st:
            # mass0 back-solved from the returned fraction
            mnow = sim.particles.mass[s0:s1].cpu().numpy()
            put("mass0", s0, s1, mnow / np.maximum(
                1.0 - np.asarray(st["TotalMassReturned"], np.float32), 0.1))
    if 5 in blocks and 5 in offs:
        b0, b1 = offs[5]
        for name, attr in (("BlackholeMass", "bh_mass"),
                           ("BlackholeAccretionRate", "bh_mdot")):
            if name in blocks[5]:
                put(attr, b0, b1, blocks[5][name])
    sim.gas = gas.replace(**rep)
    sim._gas_entropy_is_u = False


def _gas_physics(ps, cp, units, atime, gas_mass, boxsize):
    """(GasPhysics, u0): the SPH and subgrid configuration of the
    paramfile (gadget_main.py:909-1080 of the JAX package) and the initial
    specific internal energy from InitGasTemp (CMB-derived when negative,
    as the reference's init.cpp).  gas_mass: the gas particles' masses,
    whose median is the star formation's average baryon mass."""
    kern = {0: "cubic", 1: "quintic", 2: "quartic"}[
        ps.get_enum("DensityKernelType")]
    cooling_on = bool(ps.get_int("CoolingOn"))
    sfr_on = bool(ps.get_int("StarformationOn"))
    winds_on = bool(ps.get_int("WindOn"))
    coolpar = CoolingParams(
        CMBTemperature=ps.get_double("CMBTemperature"),
        MinGasTemp=ps.get_double("MinGasTemp"),
        PhotoIonizeFactor=ps.get_double("PhotoIonizeFactor"),
        SelfShieldingOn=bool(ps.get_int("SelfShieldingOn")),
        PhotoIonizationOn=bool(ps.get_int("PhotoIonizationOn")),
        UVRedshiftThreshold=ps.get_double("UVRedshiftThreshold"),
        fBar=cp.OmegaBaryon / max(cp.OmegaCDM, 1e-10))
    tcf = ps.get_string("TreeCoolFile")
    treecool = (TreeCool(tcf, coolpar.PhotoIonizeFactor)
                if cooling_on and tcf else None)
    sfrpar = windpar = None
    if sfr_on:
        sfrpar = SFRParams(
            CritOverDensity=ps.get_double("CritOverDensity"),
            CritPhysDensity=ps.get_double("CritPhysDensity"),
            FactorSN=ps.get_double("FactorSN"),
            FactorEVP=ps.get_double("FactorEVP"),
            TempSupernova=ps.get_double("TempSupernova"),
            TempClouds=ps.get_double("TempClouds"),
            MaxSfrTimescale=ps.get_double("MaxSfrTimescale"),
            Generations=int(ps.get_double("Generations")),
            MinGasTemp=ps.get_double("MinGasTemp"),
            Criterion=ps.get_enum("StarformationCriterion"),
            BHFeedbackUseTcool=ps.get_int("BHFeedbackUseTcool"))
        sfrpar.init(cp, units, float(np.median(gas_mass)), UVBG(), coolpar)
        if winds_on:
            windpar = WindParams(
                WindModel=ps.get_enum("WindModel"),
                WindEfficiency=ps.get_double("WindEfficiency"),
                WindEnergyFraction=ps.get_double("WindEnergyFraction"),
                WindSigma0=ps.get_double("WindSigma0"),
                WindSpeedFactor=ps.get_double("WindSpeedFactor"),
                WindFreeTravelLength=ps.get_double("WindFreeTravelLength"),
                WindFreeTravelDensFac=ps.get_double(
                    "WindFreeTravelDensFac"),
                MinWindVelocity=ps.get_double("MinWindVelocity"),
                WindThermalFactor=ps.get_double("WindThermalFactor"))
            windpar.init(sfrpar.FactorSN, sfrpar.EgySpecSN,
                         sfrpar.PhysDensThresh, units.UnitTime_in_s)
    metals = None
    if ps.get_int("MetalReturnOn"):
        metals = MetalReturn.load(ps.get_string("MetalYieldDir") or _YIELDS,
                                  sn1a_n0=ps.get_double("MetalsSn1aN0"))
    # the fluctuating UVB and metal-line cooling tables
    # (cooling_uvfluc.cpp; gadget_main.py:980-991)
    uvf = ps.get_string("UVFluctuationFile")
    zreion_table = (ZreionTable.load(uvf, boxsize, units.UnitLength_in_cm)
                    if uvf else None)
    mcf = ps.get_string("MetalCoolFile")
    metal_cool = (MetalCoolingTable.load(mcf)
                  if mcf and ps.get_int("MetalCoolingOn") else None)
    # black holes (blackhole.cpp; gadget_main.py:1036-1060)
    bh_on = bool(ps.get_int("BlackHoleOn"))
    bhpar = None
    if bh_on:
        bhpar = BHParams(
            BlackHoleAccretionFactor=ps.get_double(
                "BlackHoleAccretionFactor"),
            BlackHoleEddingtonFactor=ps.get_double(
                "BlackHoleEddingtonFactor"),
            BlackHoleFeedbackFactor=ps.get_double("BlackHoleFeedbackFactor"),
            SeedBlackHoleMass=ps.get_double("SeedBlackHoleMass"),
            SeedBHDynMass=ps.get_double("SeedBHDynMass"),
            MinFoFMassForNewSeed=ps.get_double("MinFoFMassForNewSeed"),
            MinMStarForNewSeed=ps.get_double("MinMStarForNewSeed"),
            BlackHoleNgbFactor=ps.get_double("BlackHoleNgbFactor"),
            BlackHoleMaxAccretionRadius=ps.get_double(
                "BlackHoleMaxAccretionRadius"),
            UnitTime_in_s=units.UnitTime_in_s,
            UnitVelocity_in_cm_per_s=units.UnitVelocity_in_cm_per_s,
            HubbleParam=cp.HubbleParam, BH_DRAG=ps.get_int("BH_DRAG"))
    # QSO helium reionization (cooling_qso_lightup.cpp; gadget_main.py:
    # 993-1008): only with a history table
    helium = None
    rhf = ps.get_string("ReionHistFile")
    if (ps.get_int("QSOLightupOn") or ps.get_int("HeliumReionizationOn")) \
            and rhf:
        helium = HeliumReion.load(rhf, QSOLightupParams(
            qso_candidate_min_mass=ps.get_double("QSOMinMass"),
            qso_candidate_max_mass=ps.get_double("QSOMaxMass"),
            mean_bubble=ps.get_double("QSOMeanBubble"),
            var_bubble=max(ps.get_double("QSOVarBubble"), 1e-10),
            heIIIreion_finish_frac=ps.get_double(
                "QSOHeIIIReionFinishFrac")))
    # excursion-set reionization (uvbg.cpp; gadget_main.py:1010-1034)
    excursion = j21c = None
    if ps.get_int("ExcursionSetReionOn"):
        excursion = ExcursionSetParams(
            UVBGdim=ps.get_int("UVBGdim"),
            ReionRBubbleMax=ps.get_double("ReionRBubbleMax"),
            ReionRBubbleMin=ps.get_double("ReionRBubbleMin"),
            ReionDeltaRFactor=ps.get_double("ReionDeltaRFactor"),
            ReionFilterType=ps.get_int("ReionFilterType"),
            RtoMFilterType=ps.get_int("RtoMFilterType"),
            ReionNionPhotPerBary=ps.get_double("ReionNionPhotPerBary"),
            AlphaUV=ps.get_double("AlphaUV"),
            EscapeFractionNorm=ps.get_double("EscapeFractionNorm"),
            EscapeFractionScaling=ps.get_double("EscapeFractionScaling"),
            ReionUseParticleSFR=ps.get_int("ReionUseParticleSFR"),
            ReionGammaHaloBias=ps.get_double("ReionGammaHaloBias"),
            ReionSFRTimescale=ps.get_double("ReionSFRTimescale"))
        jcf = ps.get_string("J21CoeffFile")
        if jcf:
            j21c = J21Coeffs.load(jcf)
    gp = GasPhysics(
        density_independent_sph=bool(ps.get_int("DensityIndependentSphOn")),
        eta=ps.get_double("DensityResolutionEta"),
        ngb_deviation=ps.get_double("MaxNumNgbDeviation"),
        art_bulk_visc=ps.get_double("ArtBulkViscConst"),
        density_contrast_limit=ps.get_double("DensityContrastLimit"),
        kernel=KERNELS[kern], cooling_on=cooling_on, sfr_on=sfr_on,
        winds_on=winds_on, metal_return_on=metals is not None,
        coolpar=coolpar, treecool=treecool, sfrpar=sfrpar,
        windpar=windpar,
        coolunits=CoolingUnits.create(units, cp.HubbleParam),
        metals=metals, bh_on=bh_on, bhpar=bhpar,
        bh_dynfric_on=bh_on and ps.get_int("BH_DynFrictionMethod") > 0,
        zreion_table=zreion_table, metal_cool=metal_cool, helium=helium,
        excursion=excursion, j21_coeffs=j21c,
        excursion_zstop=ps.get_double("ExcursionSetZStop"), units=units)
    init_temp = ps.get_double("InitGasTemp")
    if init_temp < 0:
        init_temp = cp.CMBTemperature / atime
    mw = 4.0 / (1 + 3 * HYDROGEN_MASSFRAC)
    u0 = (BOLTZMANN * init_temp / mw / PROTONMASS / GAMMA_MINUS1
          / units.UnitInternalEnergy_in_cgs)
    return gp, u0


def _build_nu_table(ps, cp, units, boxsize, nmesh, atime, restart_flag,
                    snapnum, icfile):
    """Massive-neutrino linear-response state (neutrinos_lra.cpp;
    gadget_main.py:237-270 of the JAX package): the delta_tot table, its
    IC ratio from the CLASS transfer table, and on a resume the history
    saved with the snapshot.  None when MassiveNuLinRespOn = 0."""
    if not cp.MassiveNuLinRespOn:
        return None
    wavenum = (2 * np.pi / boxsize) * np.arange(1, nmesh // 2 + 1)
    nt = DeltaTotTable.create(
        cp, wavenum, time_transfer=atime,
        unit_time_in_s=units.UnitTime_in_s,
        unit_velocity=units.UnitVelocity_in_cm_per_s)
    tfile = ps.get_string("FileWithTransferFunction")
    if tfile and os.path.exists(tfile):
        # IC ratio delta_nu/delta_cdm from the CLASS transfer table
        tr = np.loadtxt(tfile)
        ktr = tr[:, 0] * cp.HubbleParam / (units.UnitLength_in_cm
                                           / 3.085678e24)  # h/Mpc -> internal
        dnu = np.abs(tr[:, 5]) if tr.shape[1] > 5 else np.abs(tr[:, 3])
        dcdm = np.abs(tr[:, 3])
        nt.init_ratio = np.interp(wavenum, ktr,
                                  dnu / np.maximum(dcdm, 1e-30))
    # resuming: restore the delta_tot history saved with the snapshot
    if restart_flag in (1, 2) and snapnum >= 0:
        if nt.load(icfile):
            print(f"Restored neutrino delta_tot history from {icfile}")
    return nt


def _gas_blocks(s, t, sel, a):
    """The SPH blocks of type t's rows `sel` (host mask over all rows) at
    scale factor a (gadget_main.py:1180-1218 of the JAX package): for gas
    the smoothing length, densities, InternalEnergy from the entropy and
    Density a^-3, and the subgrid fields; for stars and black holes their
    bookkeeping.  Host numpy arithmetic, as the JAX package's."""
    g = s.gas
    d = {}
    if t == 0:
        ng = g.ngas
        gsel = sel[:ng]

        def host(x):
            return x.cpu().numpy()[:ng][gsel]

        dens = host(g.density)
        entr = host(g.entropy)
        d["SmoothingLength"] = host(s.particles.hsml)
        d["Density"] = dens
        d["EgyWtDensity"] = host(g.egy_wt_density)
        d["InternalEnergy"] = gas_internal_energy(entr, dens, a)
        d["ElectronAbundance"] = host(g.ne)
        d["StarFormationRate"] = host(g.sfr)
        d["Metallicity"] = host(g.metallicity)
        d["DelayTime"] = host(g.delay_time)
        d["Generation"] = host(g.generation).astype(np.uint8)
    elif t == 4:
        for name, attr in (("StellarFormationTime", "birth_a"),
                           ("Metallicity", "star_metallicity"),
                           ("TotalMassReturned", "total_returned"),
                           ("LastEnrichmentMyr", "last_enrich_myr")):
            d[name] = getattr(g, attr).cpu().numpy()[sel].astype(np.float32)
    elif t == 5:
        d["BlackholeMass"] = g.bh_mass.cpu().numpy()[sel].astype(np.float32)
        d["BlackholeAccretionRate"] = \
            g.bh_mdot.cpu().numpy()[sel].astype(np.float32)
    return d


class _DeviceWalltime(Walltime):
    """The reference's stage timers with a device synchronize before
    each reading, so a stage is charged its own device work."""

    def __init__(self, device):
        super().__init__()
        self._device = device

    def measure(self, name: str) -> float:
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        return super().measure(name)


def _particles_from_arrays(pos, vel, mass, ids, ptype, boxsize, dev):
    """A ParticleData (all rows alive) from snapshot arrays."""
    n = len(pos)
    ids = ids.astype(np.uint64)
    lo = (ids & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (ids >> np.uint64(32)).astype(np.uint32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return ParticleData.zeros(n, device=dev).replace(
        ipos=float_to_ipos(pos, boxsize, device=dev),
        vel=t(vel.astype(np.float32)), mass=t(mass.astype(np.float32)),
        ptype=t(ptype), mask=torch.ones(n, dtype=torch.bool, device=dev),
        id_lo=t(u32_numpy_to_i32(lo)), id_hi=t(u32_numpy_to_i32(hi)))


def _run_fof_snapshot(ps, hdr, outdir, snapnum, pos, vel, mass, ids,
                      ptype, boxsize, atime, dev):
    """RestartFlag 3: FOF of a snapshot and its PIG catalogue."""
    npart_tot = int(sum(hdr.TotNumPart))
    mean_sep = boxsize / np.cbrt(
        hdr.TotNumPart[1] if hdr.TotNumPart[1] > 0 else npart_tot)
    groups = fof(float_to_ipos(pos, boxsize, device=dev),
                 vel.astype(np.float32), mass.astype(np.float32), ptype,
                 np.ones(len(pos), bool), boxsize, mean_sep,
                 linking_length=ps.get_double("FOFHaloLinkingLength"),
                 min_length=ps.get_int("FOFHaloMinLength"))
    path = os.path.join(outdir, f"{ps.get_string('FOFFileBase')}"
                        f"_{max(snapnum, 0):03d}")
    save_fof(path, groups, hdr, atime)
    if ps.get_int("FOFSaveParticles"):
        pd = _particles_from_arrays(pos, vel, mass, ids, ptype, boxsize,
                                    dev)
        save_fof_particles(path, groups, pd, boxsize=boxsize, atime=atime)
    print(f"FOF: {groups.ngroups} groups -> {path}")
    return groups


def _run_power_snapshot(ps, hdr, cp, units, outdir, pos, mass, boxsize,
                        atime, dev):
    """RestartFlag 4: the power spectrum of a snapshot (runpower,
    gadget/main.cpp:106-119)."""
    from ..gravity.pm import PMConfig, pm_forces, finalize_power
    nmesh = ps.get_int("Nmesh")
    if nmesh <= 0:
        nmesh = 2 * int(round(np.cbrt(sum(hdr.TotNumPart))))
    cfg = PMConfig(nmesh=nmesh, boxsize=boxsize, G=cp.GravInternal,
                   asmth=ps.get_double("Asmth"))
    ipos = float_to_ipos(pos, boxsize, device=dev)
    _, _, psacc = pm_forces(ipos, torch.from_numpy(
        mass.astype(np.float32)).to(dev), cfg, want_potential=False)
    mpc = CM_PER_MPC / units.UnitLength_in_cm
    kk, pk, nm = finalize_power(psacc, cfg, boxsize / mpc)
    d1 = 1.0 / cp.growth_factor(1.0, atime)
    fn = os.path.join(outdir, f"powerspectrum-{atime:.4f}.txt")
    _write_power(fn, kk, pk, nm, d1)
    print(f"runpower: wrote {fn}")
    return fn


def _open_run(paramfile, restart_flag, snapnum, strict):
    """(params, OutputDir, the file to start from, its snapshot number):
    the IC file, or with RestartFlag 1 the last snapshot on record, or
    snapshot SnapNum when given."""
    ps = gadget_params()
    ps.parse_file(paramfile, strict=strict)
    outdir = ps.get_string("OutputDir")
    os.makedirs(outdir, exist_ok=True)
    icfile = ps.get_string("InitCondFile")
    if restart_flag == 1:
        with open(os.path.join(outdir, "LastSnapNum.txt")) as f:
            snapnum = int(f.read().strip())
    if restart_flag == 1 or snapnum >= 0:
        icfile = os.path.join(outdir, f"{ps.get_string('SnapshotFileBase')}"
                              f"_{snapnum:03d}")
    return ps, outdir, icfile, snapnum


def _run_config(ps, hdr, atime, npart):
    """(timeline, nmesh, timestep parameters, gravity keywords) of a run
    from the paramfile and the starting snapshot's header."""
    outputs = build_output_list(ps.get_string("OutputList"))
    timeline = Timeline.setup(outputs, atime, ps.get_double("TimeMax"),
                              ps.get_double("NoSnapshotUntilTime"),
                              bool(ps.get_int("SnapshotWithFOF")))
    nmesh = ps.get_int("Nmesh")
    if nmesh <= 0:
        nmesh = 2 * int(round(np.cbrt(sum(hdr.TotNumPart))))
    tsp = TimestepParams(
        ErrTolIntAccuracy=ps.get_double("ErrTolIntAccuracy"),
        CourantFac=ps.get_double("CourantFac"),
        MaxRMSDisplacementFac=ps.get_double("MaxRMSDisplacementFac"),
        MaxSizeTimestep=ps.get_double("MaxSizeTimestep"),
        MinSizeTimestep=ps.get_double("MinSizeTimestep"),
        MaxGasVel=ps.get_double("MaxGasVel"),
        ForceEqualTimesteps=bool(ps.get_int("ForceEqualTimesteps")),
        FastParticleType=ps.get_int("FastParticleType"))
    gravity_kw = dict(
        asmth=ps.get_double("Asmth"),
        rcut_cells=ps.get_double("TreeRcut"),
        err_tol_force_acc=ps.get_double("ErrTolForceAcc"),
        bh_opening_angle=ps.get_double("BHOpeningAngle"),
        use_bh=1 if ps.get_int("TreeUseBH") == 1 else 0,
        window_type=("exact" if ps.get_enum(
            "ShortRangeForceWindowType") == 0 else "erfc"))
    # softening: an explicitly set fraction (GravitySoftening,
    # params.cpp:161, in mean DM separations; spline h = 2.8x that);
    # otherwise the simulation derives the same 1/30 default itself
    if ps.is_set("GravitySoftening") or \
            ps.is_set("FractionalGravitySoftening"):
        frac = ps.get_double(
            "GravitySoftening" if ps.is_set("GravitySoftening")
            else "FractionalGravitySoftening")
        gravity_kw["softening"] = (
            2.8 * frac * hdr.BoxSize / np.cbrt(max(npart, 1)))
    return timeline, nmesh, tsp, gravity_kw


def run_gadget(paramfile: str, restart_flag: int = 2,
               snapnum: int = -1, max_steps: int = 10 ** 9,
               strict: bool = False, mesh_devices=0, device=None,
               rank_hook=None, mesh_timeout: float = 300.0,
               join_timeout: float = None):
    """Run the paramfile's simulation (or its RestartFlag 3/4 analysis)
    on `device`: CUDA unless the caller asks for the CPU.  Returns the
    Simulation, the FOFGroups (3) or the power-spectrum path (4).

    mesh_devices N > 0 runs the slab simulation on N ranks spawned here
    (`--mesh N`; _spawn_slab): NCCL with rank r on cuda:r, or gloo with
    device='cpu'.  mesh_timeout bounds each collective, join_timeout the
    whole run; rank_hook(event, sim, outdir), a picklable callable,
    sees each rank at 'start' and 'end'.  Returns rank 0's summary."""
    dev = resolve_device(device)
    ps, outdir, icfile, snapnum = _open_run(paramfile, restart_flag,
                                            snapnum, strict)
    hdr, (pos, vel, ids, mass, ptype), snap_blocks = _read_particles(icfile)
    has_gas = bool((ptype == 0).any()) and bool(ps.get_int("HydroOn"))
    _refuse_unported(ps, restart_flag, mesh_devices)
    if mesh_devices and restart_flag not in (3, 4):
        del pos, vel, ids, mass, ptype, snap_blocks
        return _spawn_slab(paramfile, restart_flag, snapnum, max_steps,
                           strict, int(mesh_devices), dev, outdir,
                           rank_hook, mesh_timeout, join_timeout)
    units = get_unitsystem(hdr.UnitLength_in_cm, hdr.UnitMass_in_g,
                           hdr.UnitVelocity_in_cm_per_s)
    atime = hdr.Time
    cp = load_cosmology(ps, hdr, atime, units)
    boxsize = hdr.BoxSize
    _init_checks(pos, ids, mass, cp, boxsize)

    if restart_flag == 3:
        return _run_fof_snapshot(ps, hdr, outdir, snapnum, pos, vel, mass,
                                 ids, ptype, boxsize, atime, dev)
    if restart_flag == 4:
        return _run_power_snapshot(ps, hdr, cp, units, outdir, pos, mass,
                                   boxsize, atime, dev)

    timeline, nmesh, tsp, gravity_kw = _run_config(ps, hdr, atime, len(pos))

    if has_gas:
        # the types stay apart, gas rows first (Simulation.from_species),
        # with spare rows for split-spawned stars (the PartAllocFactor
        # analog of gadget_main.py:1099-1101; grown on demand)
        gp, u0 = _gas_physics(ps, cp, units, atime, mass[ptype == 0],
                              boxsize)
        species = [(int(ty), pos[ptype == ty], vel[ptype == ty],
                    mass[ptype == ty], ids[ptype == ty])
                   for ty in sorted(set(ptype.tolist()))]
        shr = (max(int((ptype == 0).sum()) // 4, 1024) if gp.sfr_on
               else 0)
        sim = Simulation.from_species(
            species, cp, boxsize, nmesh, timeline, atime, tsp=tsp,
            gravity_kw=gravity_kw, gas_u0=u0, gas_physics=gp,
            star_headroom=shr, device=dev)
        if 0 in snap_blocks and "InternalEnergy" in snap_blocks[0]:
            # resuming from one of our snapshots (or a reference one):
            # the gas state instead of the InitGasTemp cold start
            _restore_gas_state(sim, snap_blocks, ptype, atime, cp,
                               gp.sfrpar.min_egyspec() if gp.sfrpar
                               else 0.0)
            print("Restored gas/star/BH state from snapshot")
    else:
        # every row runs as ptype DM, neutrino particles (type 2)
        # included: they drift, are written and enter FOF as type 1, as
        # in the JAX package's single-device run without gas
        # (gadget_main.py:1117-1120, Simulation.from_arrays; ROADMAP C.4)
        sim = Simulation.from_arrays(pos, vel, mass, ids, cp, boxsize,
                                     nmesh, timeline, atime, tsp=tsp,
                                     gravity_kw=gravity_kw, device=dev)
    del snap_blocks
    sim.resumed = (restart_flag == 1)
    sim.hierarchical = bool(ps.get_int("SplitGravityTimestepsOn")
                            or ps.get_int("HierarchicalGravity"))
    # anti-correlation box shift, a fraction of a PM cell
    # (gadget/params.cpp:85, default 8 cells worth over Nmesh)
    sim.random_offset_frac = (ps.get_double("RandomParticleOffset")
                              / max(nmesh, 1))
    sim.nu_table = _build_nu_table(ps, cp, units, boxsize, nmesh, atime,
                                   restart_flag, snapnum, icfile)

    # lightcone crossings collected after each drift (lightcone.cpp;
    # gadget_main.py:1136-1150 of the JAX package), on the host
    lightcone = None
    if ps.get_int("LightconeOn"):
        lightcone = Lightcone(CP=cp, boxsize=boxsize,
                              unit_velocity=units.UnitVelocity_in_cm_per_s)

        def on_drift(s, a0, a1):
            t0 = time.perf_counter()
            p = s.particles
            n = lightcone.compute(a0, a1, s.output_ipos().cpu().numpy(),
                                  p.vel.cpu().numpy(), p.ids64(),
                                  p.mask.cpu().numpy())
            # (a0, a1, crossings, host seconds) of each drift
            s.lightcone_log.append((a0, a1, n, time.perf_counter() - t0))
        sim.on_drift = on_drift
        sim.lightcone_log = []

    snap_counter = [_resume_snap_counter(outdir)]
    base = ps.get_string("SnapshotFileBase")

    def on_snapshot(s, a):
        # max() keeps numbering monotone when an unplanned (HCI)
        # dump has consumed an index below this OutputList position
        snap_counter[0] = max(_snap_index(ps, a, snap_counter[0]),
                              snap_counter[0])
        path = os.path.join(outdir, f"{base}_{snap_counter[0]:03d}")
        p = s.particles
        maskv = p.mask.cpu().numpy()
        tys = p.ptype.cpu().numpy()
        posn = (u32(s.output_ipos()).to(torch.float64)
                * (boxsize / 2 ** 32)).cpu().numpy()
        veln = p.vel.cpu().numpy() / a        # peculiar
        massn = p.mass.cpu().numpy()
        idsn = p.ids64()
        blocks = {}
        totnum = np.zeros(6, dtype=np.uint64)
        for t in range(6):
            sel = maskv & (tys == t)
            if not sel.any():
                continue
            totnum[t] = sel.sum()
            blocks[t] = {"Position": posn[sel], "Velocity": veln[sel],
                         "Mass": massn[sel], "ID": idsn[sel]}
            if s.gas is not None:
                blocks[t].update(_gas_blocks(s, t, sel, a))
        shdr = SnapshotHeader(
            TotNumPart=totnum,
            MassTable=np.zeros(6), Time=a, BoxSize=boxsize,
            Omega0=cp.Omega0, OmegaLambda=cp.OmegaLambda,
            OmegaBaryon=cp.OmegaBaryon, HubbleParam=cp.HubbleParam,
            UnitLength_in_cm=units.UnitLength_in_cm,
            UnitMass_in_g=units.UnitMass_in_g,
            UnitVelocity_in_cm_per_s=units.UnitVelocity_in_cm_per_s,
            UsePeculiarVelocity=1, TimeIC=hdr.TimeIC)
        write_snapshot(path, shdr, blocks)
        if s.nu_table is not None:
            s.nu_table.save(path)   # the delta_nu history rides along
        with open(os.path.join(outdir, "LastSnapNum.txt"), "w") as f:
            f.write(str(snap_counter[0]))
        if s.power_history:
            a_p, kk, pk, nm = s.power_history[-1]
            _write_power(os.path.join(outdir, f"powerspectrum-{a:.4f}.txt"),
                         kk, pk, nm, 1.0 / cp.growth_factor(1.0, a))
        snap_counter[0] += 1

    snapshot_with_fof = bool(ps.get_int("SnapshotWithFOF"))

    def run_fof(s):
        """The FOF catalogue of the current state (gadget_main.py:1253-1268
        of the JAX package)."""
        p = s.particles
        mask = p.mask.cpu().numpy()
        npart_tot = int(mask.sum())
        ndm = int((p.ptype.cpu().numpy()[mask] == 1).sum())
        mean_sep = boxsize / np.cbrt(max(ndm, npart_tot, 1))
        sfr = None
        if s.gas is not None:
            # the gas rows' star formation rates give the groups'
            sfr = torch.nn.functional.pad(s.gas.sfr, (0, p.n - s.gas.ngas))
        return fof(s.output_ipos(), p.vel, p.mass, p.ptype, p.mask,
                   boxsize, mean_sep,
                   linking_length=ps.get_double("FOFHaloLinkingLength"),
                   min_length=ps.get_int("FOFHaloMinLength"), sfr=sfr)

    def fof_physics(s, groups):
        """FOF-cadence physics (gadget_main.py:1320-1354 of the JAX
        package): every row's halo mass; the BH seeds: in each group
        above the seeding thresholds without a BH, the densest alive gas
        row (the first of equals, numpy's argmax) becomes a BH; then the
        HeIII bubbles."""
        gpx = s.gas_physics
        if s.gas is None or gpx is None:
            return
        p = s.particles
        gid = groups.group_id
        halo_mass = np.zeros(p.n, np.float32)
        ing = gid > 0
        if groups.ngroups:
            halo_mass[ing] = groups.masses[gid[ing] - 1]
        s.halo_mass = torch.from_numpy(halo_mass).to(dev)
        if gpx.bh_on and gpx.bhpar is not None and groups.ngroups:
            to_seed = seed_black_holes(groups, groups.mass_by_type[:, 4],
                                       groups.length_by_type[:, 5],
                                       gpx.bhpar)
            ngc = s.gas.ngas
            dens = s.gas.density.cpu().numpy()
            is_gas = (p.ptype[:ngc] == 0).cpu().numpy() \
                & p.mask[:ngc].cpu().numpy()
            rows = []
            for gi in to_seed:
                cand = np.nonzero((gid[:ngc] == gi + 1) & is_gas)[0]
                if cand.size:
                    rows.append(int(cand[np.argmax(dens[cand])]))
            if rows:
                s.gas = gpx.seed_bh(s, s.gas, rows)
                print(f"Seeded {len(rows)} black holes")
        if gpx.helium is not None and groups.ngroups:
            s.gas = gpx.helium_step(s, s.gas, groups.masses, groups.cm)

    write_planes_on = bool(ps.get_int("WritePlaneOn"))

    def write_planes(s, a):
        """Lensing potential planes at a snapshot FOF (plane.cpp;
        gadget_main.py:1286-1318 of the JAX package): the NGP deposit on
        the device, the FFT and the FITS files on the host."""
        cuts = [float(x) for x in ps.get_string("PlaneCutPoints").split(",")
                if x.strip()]
        normals = [int(x) for x in ps.get_string("PlaneNormals").split(",")
                   if x.strip()]
        par = PlaneParams(Resolution=ps.get_int("PlaneResolution"),
                          Thickness=ps.get_double("PlaneThickness"),
                          CutPoints=cuts, Normals=normals or [0, 1, 2])
        p = s.particles
        ipos = s.output_ipos()

        def deposit(normal, center, thickness):
            counts, n_plane = plane_counts_ipos(
                ipos, p.mask, boxsize, normal, center, thickness,
                par.Resolution)
            return counts.cpu().numpy(), int(n_plane)

        ntot = int(p.mask.sum())
        return write_planes_deposit(snap_counter[0] - 1, a, cp, deposit,
                                    ntot, boxsize, outdir,
                                    units.UnitVelocity_in_cm_per_s,
                                    units.UnitLength_in_cm, par)

    def on_snapshot_with_fof(s, a):
        on_snapshot(s, a)
        if not snapshot_with_fof:
            return
        wt.measure("Snapshot")
        p = s.particles
        groups = run_fof(s)
        pig = os.path.join(outdir, f"{ps.get_string('FOFFileBase')}"
                           f"_{snap_counter[0] - 1:03d}")
        save_fof(pig, groups, hdr, a)
        if ps.get_int("FOFSaveParticles"):
            # the member positions keep the internal random offset, as
            # the JAX package writes them (gadget_main.py:1306-1307
            # passes the particles, not output_ipos)
            save_fof_particles(pig, groups, p, boxsize=boxsize, atime=a)
        print(f"FOF at a={a:g}: {groups.ngroups} groups -> {pig}")
        fof_physics(s, groups)
        if write_planes_on:
            write_planes(s, a)
        wt.measure("FOF")

    sim.on_snapshot = on_snapshot_with_fof

    # seeding-cadence FOF searches on PM steps (run.cpp:364,637-660;
    # gadget_main.py:1356-1379): at a >= next_seed_check, which then moves
    # to a * TimeBetweenSeedingSearch
    bh_enabled = has_gas and sim.gas_physics is not None \
        and sim.gas_physics.bh_on
    # and on every PM step of the helium era (gadget_main.py:1359-1380)
    helium_obj = sim.gas_physics.helium if sim.gas_physics else None
    next_seed_check = [atime]
    seed_factor = ps.get_double("TimeBetweenSeedingSearch")

    def on_pm_step(s):
        a = s.atime()
        seed_due = bh_enabled and a >= next_seed_check[0]
        he_due = helium_obj is not None and helium_obj.during(1.0 / a - 1.0)
        if not (seed_due or he_due):
            return
        groups = run_fof(s)
        if seed_due:
            next_seed_check[0] = a * seed_factor
        fof_physics(s, groups)
        wt.measure("FOF")

    sim.on_pm_step = on_pm_step

    def on_bad_timestep(s):
        """Emergency TIMESTEP-DUMP snapshot (run.cpp:794-797)."""
        try:
            snap_counter_save = snap_counter[0]
            snap_counter[0] = 999
            on_snapshot(s, s.atime())
            src = os.path.join(outdir, f"{base}_999")
            dst = os.path.join(outdir, "TIMESTEP-DUMP")
            if os.path.isdir(src):
                os.rename(src, dst)
            snap_counter[0] = snap_counter_save
            # on_snapshot recorded 999 in LastSnapNum.txt, but PART_999
            # was just renamed away: point it back at the last real one
            lsn = os.path.join(outdir, "LastSnapNum.txt")
            prev = None
            if snap_counter_save > 0:
                prev = snap_counter_save - 1
            else:
                nums = [int(m.group(1)) for f in os.listdir(outdir)
                        if (m := re.fullmatch(f"{base}_(\\d{{3}})", f))]
                if nums:
                    prev = max(nums)
            if prev is not None:
                with open(lsn, "w") as fh:
                    fh.write(str(prev))
            elif os.path.exists(lsn):
                os.remove(lsn)
            print(f"Bad timestep: emergency dump -> {dst}")
        except Exception as e:       # the dump must never mask the
            print(f"TIMESTEP-DUMP failed: {e}")   # original error
    sim.on_bad_timestep = on_bad_timestep

    # human control interface: stop/checkpoint/terminate files and the
    # wall-clock timeout prediction, polled on PM steps (hci.cpp:76-185,
    # run.cpp:408); checkpoints reuse the snapshot writer (with FOF when
    # SnapshotWithFOF) at the next free index, so RestartFlag 1 resumes
    # from them
    sim.hci = HCI(outdir, time_limit_cpu=ps.get_double("TimeLimitCPU"),
                  auto_checkpoint_time=ps.get_double("AutoSnapshotTime"))
    sim.on_checkpoint = on_snapshot_with_fof

    # per-step statistics: energy.txt, sfr.txt, cpu.txt
    wt = _DeviceWalltime(dev)
    sim.walltime = wt
    fd_energy = open(os.path.join(outdir, ps.get_string("EnergyFile")), "a")
    fd_cpu = open(os.path.join(outdir, ps.get_string("CpuFile")), "a")
    fd_sfr = (open(os.path.join(outdir, "sfr.txt"), "a")
              if has_gas and ps.get_int("StarformationOn") else None)
    # blackholes.txt and, with WriteBlackHoleDetails, BlackholeDetails.bin
    # (gadget_main.py:1451-1456)
    fd_bh = (open(os.path.join(outdir, "blackholes.txt"), "a")
             if bh_enabled else None)
    fd_bhdet = (open(os.path.join(outdir, "BlackholeDetails.bin"), "ab")
                if bh_enabled and ps.get_int("WriteBlackHoleDetails")
                else None)
    if fd_sfr is not None and fd_sfr.tell() == 0:
        fd_sfr.write(
            "# SFR.txt columns are:\n"
            "# 0. Time  1. total_sm  2. totsfrrate [Msun/yr]\n"
            "# 3. rate_in_msunperyear  4. total_sum_mass_stars\n"
            "# 5. avg dt  6. n star-forming  7. new stars\n")
    pk_written = [0]

    def dump_power(s):
        """powerspectrum-%.4f.txt for every PM step (gravpm.cpp writes
        at each long-range force)."""
        while pk_written[0] < len(s.power_history):
            a_p, kk, pk, nm = s.power_history[pk_written[0]]
            pk_written[0] += 1
            _write_power(os.path.join(outdir,
                                      f"powerspectrum-{a_p:.4f}.txt"),
                         kk, pk, nm, 1.0 / cp.growth_factor(1.0, a_p))

    def on_step(s):
        a = s.atime()
        wt.measure("Misc")
        dump_power(s)
        energy_statistics_fast(fd_energy, a, s.particles)
        st = s.gas_physics.last_sfr_stats if s.gas_physics else None
        if fd_sfr is not None and st is not None:
            # a line only when stars could form (sfr_eff.cpp:390
            # `if(FdSfr && total_sm > 0)`)
            if st["total_sm"] > 0:
                sfr_statistics(fd_sfr, a, **st)
            s.gas_physics.last_sfr_stats = None
        if fd_bh is not None:
            # nothing before the first BH exists (blackhole.cpp:221-223)
            bh_statistics_fast(fd_bh, fd_bhdet, a, s.particles, s.gas,
                               boxsize, units)
        wt.write_cpu_log(fd_cpu, a)
        wt.reset_step()

    sim.on_step = on_step
    try:
        sim.run(max_steps=max_steps)
        if lightcone is not None:
            lc_path = lightcone.save(os.path.join(outdir, "LIGHTCONE"))
            print(f"Lightcone -> {lc_path}")
    finally:
        for fd in (fd_energy, fd_cpu, fd_sfr, fd_bh, fd_bhdet):
            if fd is not None:
                fd.close()
    return sim


# ------------------------------------------------ the slab run (--mesh N)

def _spawn_slab(paramfile, restart_flag, snapnum, max_steps, strict, ndev,
                dev, outdir, rank_hook, mesh_timeout, join_timeout):
    """`--mesh N` (gadget_main.py:876-907 of the JAX package): N ranks
    (parallel/launch.py) meeting through a FileStore in OutputDir, NCCL
    on cuda:0..N-1 or gloo with the CPU; each runs _slab_rank.  Returns
    rank 0's summary of the run."""
    from ..parallel.launch import run_ranks
    return run_ranks(_slab_rank, ndev,
                     (paramfile, restart_flag, snapnum, max_steps, strict,
                      rank_hook),
                     dev.type, os.path.join(outdir, ".mesh_store"),
                     mesh_timeout, join_timeout)


def _slab_rank(rank, dev, paramfile, restart_flag, snapnum, max_steps,
               strict, rank_hook):
    """One rank of a slab run: it reads the paramfile and the starting
    snapshot itself and runs _run_slab."""
    from ..parallel import collectives as cc
    ps, outdir, icfile, snapnum = _open_run(paramfile, restart_flag,
                                            snapnum, strict)
    hdr, (pos, vel, ids, mass, ptype), _ = _read_particles(icfile)
    units = get_unitsystem(hdr.UnitLength_in_cm, hdr.UnitMass_in_g,
                           hdr.UnitVelocity_in_cm_per_s)
    atime = hdr.Time
    cp = load_cosmology(ps, hdr, atime, units)
    _init_checks(pos, ids, mass, cp, hdr.BoxSize)
    timeline, nmesh, tsp, gravity_kw = _run_config(ps, hdr, atime, len(pos))
    nu_table = _build_nu_table(ps, cp, units, hdr.BoxSize, nmesh, atime,
                               restart_flag, snapnum, icfile)
    gas = None
    if (ptype == 0).any() and ps.get_int("HydroOn"):
        # the SPH and subgrid configuration and u0 from InitGasTemp at
        # the start's a, also on a resume: the JAX --mesh run starts its
        # gas from u0 and the fixed point whatever the snapshot holds, and
        # reads no star or BH block (gadget_main.py:876-907; ROADMAP C.4)
        gas = _gas_physics(ps, cp, units, atime, mass[ptype == 0],
                           hdr.BoxSize)
    if rank_hook is not None:
        rank_hook("start", None, outdir)
    sim = _run_slab(ps, hdr, cp, units, timeline, tsp, gravity_kw,
                    (pos, vel, mass, ids, ptype), nmesh, outdir, max_steps,
                    nu_table, restart_flag == 1, dev, gas)
    if rank_hook is not None:
        rank_hook("end", sim, outdir)
    return {"backend": cc.backend(), "world": cc.world_size(),
            "step_count": sim.step_count, "atime": sim.atime(),
            "ti_current": sim.times.ti_current,
            "hierarchical": sim.hierarchical,
            "offset_u32": sim._offset_u32,
            "snapshots": list(sim.snapshots), "hci_exit": sim.hci_exit}


def _run_slab(ps, hdr, cp, units, timeline, tsp, gravity_kw, arrays,
              nmesh, outdir, max_steps, nu_table, resumed, dev, gas=None):
    """The slab loop of one rank with its outputs (gadget_main.py:272-724
    of the JAX package): dark matter, and with gas = (GasPhysics, u0) SPH
    and the subgrid sources the GasPhysics switches on (the types apart,
    SlabSimulation.from_species); PART snapshots written by every rank
    (io/sharded_io, with the gas blocks), P(k) at each PM step and
    snapshot, the slab FOF of every type with its distributed catalogue
    and the PIG at snapshots (SnapshotWithFOF; the PIG holds the group
    table, as the JAX --mesh run writes it, without member particles),
    with BlackHoleOn the seeding FOF on PM steps (_seed_on_pm_step),
    cpu.txt, HCI and the neutrino response.  Rank 0 writes the files no
    other rank shares."""
    from ..fof.slab import compile_groups_slab_distributed, fof_label_slab
    from ..io.sharded_io import save_snapshot_sharded_multi
    from ..parallel import collectives as cc
    from ..parallel.slab_sim import SharedHCI, SlabSimulation
    pos, vel, mass, ids, ptype = arrays
    boxsize = hdr.BoxSize
    atime = hdr.Time
    me, ndev = cc.rank(), cc.world_size()
    if gas is None:
        sim = SlabSimulation.from_arrays(pos, vel, mass, ids, cp, boxsize,
                                         nmesh, timeline, atime, tsp=tsp,
                                         gravity_kw=gravity_kw, device=dev)
    else:
        gp, u0 = gas
        species = [(int(ty), pos[ptype == ty], vel[ptype == ty],
                    mass[ptype == ty], ids[ptype == ty])
                   for ty in sorted(set(ptype.tolist()))]
        sim = SlabSimulation.from_species(
            species, cp, boxsize, nmesh, timeline, atime, tsp=tsp,
            gravity_kw=gravity_kw, gas_u0=u0, gas_physics=gp, device=dev)
    sim.nu_table = nu_table
    sim.resumed = resumed
    sim.hierarchical = bool(ps.get_int("SplitGravityTimestepsOn")
                            or ps.get_int("HierarchicalGravity"))
    sim.random_offset_frac = (ps.get_double("RandomParticleOffset")
                              / max(nmesh, 1))
    base = ps.get_string("SnapshotFileBase")
    snap_counter = [_resume_snap_counter(outdir)]
    mean_sep = boxsize / np.cbrt(max(len(pos), 1))
    b_link = ps.get_double("FOFHaloLinkingLength") * mean_sep
    snapshot_with_fof = bool(ps.get_int("SnapshotWithFOF"))
    del pos, vel, mass, ids, ptype, arrays

    def ids64(p):
        return (u32(p.id_hi) << 32) | u32(p.id_lo)

    def on_snapshot(s, a):
        snap_counter[0] = max(_snap_index(ps, a, snap_counter[0]),
                              snap_counter[0])
        path = os.path.join(outdir, f"{base}_{snap_counter[0]:03d}")
        shdr = SnapshotHeader(
            TotNumPart=np.zeros(6, np.uint64), MassTable=np.zeros(6),
            Time=a, BoxSize=boxsize, Omega0=cp.Omega0,
            OmegaLambda=cp.OmegaLambda, OmegaBaryon=cp.OmegaBaryon,
            HubbleParam=cp.HubbleParam,
            UnitLength_in_cm=units.UnitLength_in_cm,
            UnitMass_in_g=units.UnitMass_in_g,
            UnitVelocity_in_cm_per_s=units.UnitVelocity_in_cm_per_s,
            UsePeculiarVelocity=1, TimeIC=hdr.TimeIC)
        p = s.particles
        mass_out = torch.where(p.mask, p.mass, 0.0)
        g = s.gas
        gcols = None
        if g is not None:
            pad = p.n - g.ngas
            gcols = {"hsml": p.hsml, **{
                k: torch.nn.functional.pad(v, (0, pad)) for k, v in (
                    ("density", g.density), ("egywt", g.egy_wt_density),
                    ("entropy", g.entropy))}}
        save_snapshot_sharded_multi(path, shdr, {
            "ipos": s.output_ipos(), "vel": p.vel, "mass": mass_out,
            "pid": p.id_lo, "pid_hi": p.id_hi, "ptype": p.ptype}, boxsize,
            a, gas=gcols)
        if me == 0:
            if s.nu_table is not None:
                s.nu_table.save(path)
            with open(os.path.join(outdir, "LastSnapNum.txt"), "w") as f:
                f.write(str(snap_counter[0]))
            if s.power_history:
                a_p, kk, pk, nm = s.power_history[-1]
                _write_power(os.path.join(outdir,
                                          f"powerspectrum-{a:.4f}.txt"),
                             kk, pk, nm, 1.0 / cp.growth_factor(1.0, a))
        if snapshot_with_fof:
            wt.measure("Snapshot")
            glabel, _ = fof_label_slab(
                {"ipos": p.ipos, "mass": mass_out, "pid": ids64(p)}, b_link,
                boxsize, ndev, nlevels=s.gravity.tree_nlevels,
                cuts_in=s.cuts_fp)
            groups, _ = compile_groups_slab_distributed(
                glabel, {"ipos": s.output_ipos(), "vel": p.vel,
                         "mass": mass_out, "ptyp": p.ptype,
                         "pid": ids64(p)},
                boxsize, ndev, min_length=ps.get_int("FOFHaloMinLength"))
            pig = os.path.join(outdir, f"{ps.get_string('FOFFileBase')}"
                               f"_{snap_counter[0]:03d}")
            if me == 0:
                save_fof(pig, groups, hdr, a)
                print(f"FOF at a={a:g}: {groups.ngroups} groups -> {pig}")
            cc.barrier()
            wt.measure("FOF")
        snap_counter[0] += 1

    sim.on_snapshot = on_snapshot
    sim.hci = SharedHCI(HCI(outdir,
                            time_limit_cpu=ps.get_double("TimeLimitCPU"),
                            auto_checkpoint_time=ps.get_double(
                                "AutoSnapshotTime")), dev)
    sim.on_checkpoint = on_snapshot
    wt = _DeviceWalltime(dev)
    sim.walltime = wt
    fd_cpu = (open(os.path.join(outdir, ps.get_string("CpuFile")), "a")
              if me == 0 else None)
    pk_written = [0]

    def on_step(s):
        wt.measure("Misc")
        if fd_cpu is not None:
            while pk_written[0] < len(s.power_history):
                a_p, kk, pk, nm = s.power_history[pk_written[0]]
                pk_written[0] += 1
                _write_power(os.path.join(outdir,
                                          f"powerspectrum-{a_p:.4f}.txt"),
                             kk, pk, nm, 1.0 / cp.growth_factor(1.0, a_p))
            wt.write_cpu_log(fd_cpu, s.atime())
        wt.reset_step()

    sim.on_step = on_step
    gp = sim.gas_physics
    if gp is not None and gp.bh_on and gp.bhpar is not None:
        sim.on_pm_step = _seed_on_pm_step(
            ps, atime, b_link, boxsize, ndev, ids64, wt)
    try:
        sim.run(max_steps=max_steps)
    finally:
        if fd_cpu is not None:
            fd_cpu.close()
    return sim


def _seed_on_pm_step(ps, atime, b_link, boxsize, ndev, ids64, wt):
    """The seeding FOF of a slab run on PM steps (gadget_main.py:625-716
    of the JAX package, its BH half): at a >= the next check, which then
    moves to a * TimeBetweenSeedingSearch, the slab FOF and its
    distributed catalogue; in each group seed_black_holes picks, the
    densest alive gas row becomes a BH, found over the ranks from
    all-reduced values (the largest density, then the smallest ID among
    the rows at it), so every rank agrees on every seed."""
    from ..fof.slab import compile_groups_slab_distributed, fof_label_slab
    from ..parallel import collectives as cc
    next_check = [atime]
    seed_factor = ps.get_double("TimeBetweenSeedingSearch")
    min_len = ps.get_int("FOFHaloMinLength")

    def on_pm_step(s):
        a = s.atime()
        if a < next_check[0]:
            return
        next_check[0] = a * seed_factor
        p, g, gp = s.particles, s.gas, s.gas_physics
        mass_out = torch.where(p.mask, p.mass, 0.0)
        glabel, _ = fof_label_slab(
            {"ipos": p.ipos, "mass": mass_out, "pid": ids64(p)}, b_link,
            boxsize, ndev, nlevels=s.gravity.tree_nlevels, cuts_in=s.cuts_fp)
        groups, _ = compile_groups_slab_distributed(
            glabel, {"ipos": s.output_ipos(), "vel": p.vel, "mass": mass_out,
                     "ptyp": p.ptype, "pid": ids64(p)},
            boxsize, ndev, min_length=min_len)
        wt.measure("FOF")
        if not groups.ngroups:
            return
        to_seed = np.asarray(seed_black_holes(
            groups, groups.mass_by_type[:, 4], groups.length_by_type[:, 5],
            gp.bhpar), np.int64)
        if not to_seed.size:
            return
        # the alive rows in the catalogue's order; the gas rows are the
        # prefix, their density the gas state's
        alive = torch.nonzero(mass_out > 0).squeeze(1).cpu().numpy()
        gid = groups.group_id
        ng = g.ngas
        dens = np.full(len(alive), -np.inf)
        isg = (alive < ng) & (p.ptype.cpu().numpy()[alive] == 0)
        dens[isg] = g.density.cpu().numpy()[alive[isg]]
        pid = ids64(p).cpu().numpy()[alive]
        best_d = np.full(len(to_seed), -np.inf)
        for j, gi in enumerate(to_seed):
            c = (gid == gi + 1) & isg
            if c.any():
                best_d[j] = dens[c].max()
        dev = s.device
        dmax = cc.all_max(torch.from_numpy(best_d).to(dev)).cpu().numpy()
        big = np.iinfo(np.int64).max
        best_id = np.full(len(to_seed), big, np.int64)
        for j, gi in enumerate(to_seed):
            c = (gid == gi + 1) & isg & (dens == dmax[j])
            if c.any():
                best_id[j] = pid[c].min()
        win = cc.all_min(torch.from_numpy(best_id).to(dev)).cpu().numpy()
        win = win[win != big]
        rows = alive[isg & np.isin(pid, win)]
        s._seed_bh_rows(rows)
        if cc.rank() == 0 and len(win):
            print(f"Seeded {len(win)} black holes")

    return on_pm_step


def main(argv=None):
    argv = list(argv) if argv is not None else sys.argv[1:]
    device = _pop_device(argv)
    mesh_devices = 0
    if "--mesh" in argv:
        i = argv.index("--mesh")
        spec = argv[i + 1]
        mesh_devices = spec if "x" in spec else int(spec)
        del argv[i: i + 2]
    if len(argv) < 1:
        print("usage: python -m shenqi_tpu_torch.cli.gadget_main paramfile "
              "[RestartFlag] [SnapNum] [--mesh N] [--device cpu]",
              file=sys.stderr)
        return 1
    restart = int(argv[1]) if len(argv) > 1 else 2
    snapnum = int(argv[2]) if len(argv) > 2 else -1
    run_gadget(argv[0], restart, snapnum, mesh_devices=mesh_devices,
               device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
