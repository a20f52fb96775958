"""MP-GenIC equivalent CLI: paramfile -> bigfile IC snapshot
(shenqi_tpu/cli/genic_main.py for the port).

Usage: python -m shenqi_tpu_torch.cli.genic_main paramfile.genic [--device cpu]

Reads the same parameter files as the reference genic (genic/params.cpp)
and writes an IC bigfile readable by both packages and the reference.
The field is the reference's (host numpy); the FFTs and the CIC readout
run on the card unless `--device cpu` is given.  The DM species, gas
(ProduceGas: the two lattices split half a cell about their centre of
mass), neutrino particles (NgridNu, thermal Fermi-Dirac speeds) and
per-species transfer functions (DifferentTransferFunctions with
FileWithTransferFunction) are ported.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .._device import resolve_device
from .params import genic_params
from ..utils.units import get_unitsystem
from ..cosmology.background import Cosmology
from ..cosmology.power import (InputPower, DELTA_NU, DELTA_CB, DELTA_BAR,
                               DELTA_CDM)
from ..genic.ic import setup_grid, gaussian_field, displacement_fields
from ..genic.thermal import NU_V0, FermiDiracSampler, add_thermal_speeds
from ..io.bigfile import BigFile
from ..io.snapshot import SnapshotHeader


def run_genic(paramfile: str, strict: bool = False, device=None) -> str:
    """Write the IC snapshot the paramfile describes; returns its path."""
    dev = resolve_device(device)
    ps = genic_params()
    ps.parse_file(paramfile, strict=strict)

    units = get_unitsystem(ps.get_double("UnitLength_in_cm"),
                           ps.get_double("UnitMass_in_g"),
                           ps.get_double("UnitVelocity_in_cm_per_s"))
    redshift = ps.get_double("Redshift")
    time_ic = 1.0 / (1 + redshift)
    cp = Cosmology(
        Omega0=ps.get_double("Omega0"),
        OmegaLambda=ps.get_double("OmegaLambda"),
        OmegaBaryon=ps.get_double("OmegaBaryon"),
        HubbleParam=ps.get_double("HubbleParam"),
        CMBTemperature=ps.get_double("CMBTemperature"),
        RadiationOn=ps.get_int("RadiationOn"),
        MNu=(ps.get_double("MNue"), ps.get_double("MNum"),
             ps.get_double("MNut")))
    cp.init(time_ic, units)

    boxsize = ps.get_double("BoxSize")
    ngrid = ps.get_int("Ngrid")
    nmesh = ps.get_int("Nmesh")
    if nmesh <= 0:
        # genic/params.cpp:194: the default displacement mesh is 2*Ngrid,
        # and the reference's field is sized by Nmesh, so phase parity
        # with MP-GenIC needs the same default
        nmesh = 2 * ngrid
    seed = ps.get_int("Seed")
    use_peculiar = ps.get_int("UsePeculiarVelocity")

    if ps.get_int("WhichSpectrum") == 2:
        power = InputPower.from_file(ps.get_string("FileWithInputSpectrum"),
                                     cp, units.UnitLength_in_cm)
    else:
        power = InputPower.analytic_eh(
            cp, units.UnitLength_in_cm,
            primordial_index=ps.get_double("PrimordialIndex"))
    power.normalize(sigma8=ps.get_double("Sigma8"),
                    input_power_redshift=ps.get_double(
                        "InputPowerRedshift"),
                    time_ic=time_ic)

    # per-species transfer functions (libgenic/power.c
    # DifferentTransferFunctions): species transfer ratios and
    # scale-dependent velocities
    difftrans = ps.get_int("DifferentTransferFunctions")
    if difftrans:
        tf = ps.get_string("FileWithTransferFunction")
        if tf:
            power.load_transfer(tf, time_ic)
            sdv = ps.get_int("ScaleDepVelocity")
            power.scale_dep_velocity = bool(
                sdv if sdv >= 0 else difftrans)

    g_k = gaussian_field(seed, nmesh,
                         unitary=bool(ps.get_int("UnitaryAmplitude")),
                         invert_phase=bool(ps.get_int("InvertPhase")))
    species = []   # (ptype, pos, vel, ids, mass)

    ngrid_nu = ps.get_int("NgridNu")
    mnu_sum = sum(cp.MNu)
    omega_nu = cp.ONu.get_omega_nu(1.0) if mnu_sum > 0 else 0.0
    with_nu = ngrid_nu > 0 and mnu_sum > 0
    nufrac = 0.0

    # compute_mass (libgenic/save.cpp:90): CDM excludes baryons when
    # gas particles exist and neutrinos whenever MNu > 0 (their mass
    # lives in particles * nufrac and/or the linear response)
    produce_gas = ps.get_int("ProduceGas")
    omega_cdm_mass = cp.Omega0 - omega_nu \
        - (cp.OmegaBaryon if produce_gas else 0.0)
    mass_dm = omega_cdm_mass * cp.RhoCrit * boxsize ** 3 / ngrid ** 3
    if produce_gas:
        # centre-of-mass-preserving half-cell split (genic/main.cpp:63-64):
        # shift_dm = +0.5 (Ob/O0) cells, shift_gas = -0.5 ((O0-Ob)/O0)
        mass_gas = cp.OmegaBaryon * cp.RhoCrit * boxsize ** 3 / ngrid ** 3
        fb = cp.OmegaBaryon / cp.Omega0
        lattice_dm, ids_dm = setup_grid(ngrid, boxsize, id_offset=1,
                                        shift_frac=0.5 * fb)
        lattice_gas, ids_gas = setup_grid(ngrid, boxsize,
                                          id_offset=ngrid ** 3 + 1,
                                          shift_frac=-0.5 * (1 - fb))
        # genic/main.cpp:106-110: with DifferentTransferFunctions the DM
        # takes the pure CDM transfer and the gas the baryons'; without,
        # both the cb-weighted one
        species_tf = difftrans and power.transfer_ratio
        res_dm = displacement_fields(
            g_k, power, cp, lattice_dm, boxsize, time_ic,
            ttype=DELTA_CDM if species_tf else DELTA_CB,
            use_peculiar=use_peculiar, device=dev)
        res_gas = displacement_fields(
            g_k, power, cp, lattice_gas, boxsize, time_ic,
            ttype=DELTA_BAR if species_tf else DELTA_CB,
            use_peculiar=use_peculiar, device=dev)
        species.append((1, res_dm.pos, res_dm.vel, ids_dm, mass_dm))
        species.append((0, res_gas.pos, res_gas.vel, ids_gas, mass_gas))
    else:
        # neutrino-particle runs shift the DM and nu lattices apart
        # (genic/main.cpp:67-72)
        shift_dm = 0.5 * omega_nu / cp.Omega0 if with_nu else 0.0
        lattice, ids = setup_grid(ngrid, boxsize, shift_frac=shift_dm)
        res = displacement_fields(g_k, power, cp, lattice, boxsize, time_ic,
                                  use_peculiar=use_peculiar, device=dev)
        species.append((1, res.pos, res.vel, ids, mass_dm))

    # neutrino particle species (genic/main.cpp:87-98,200-231): thermal
    # Fermi-Dirac velocities and DELTA_NU transfer displacements
    if with_nu:
        v_th = NU_V0(redshift, mnu_sum / 3.0,
                     units.UnitVelocity_in_cm_per_s)
        if not use_peculiar:
            v_th /= np.sqrt(time_ic)
        # genic/params.cpp:162: the z = 0 cap is blown up by (1+z)
        max_v = (ps.get_double("Max_nuvel") * (1 + redshift)
                 * (units.UnitVelocity_in_cm_per_s / 1e5))
        nu_sampler = FermiDiracSampler(v_th, max_v)
        nufrac = nu_sampler.nufrac()
        print(f"F-D velocity scale {v_th:g}; particle mass fraction "
              f"{nufrac:g}")
        lattice_nu, ids_nu = setup_grid(
            ngrid_nu, boxsize,
            id_offset=1 + sum(len(s_[1]) for s_ in species),
            shift_frac=(0.0 if produce_gas else
                        -0.5 * (cp.Omega0 - omega_nu) / cp.Omega0))
        if power.transfer_ratio:
            res_nu = displacement_fields(
                g_k, power, cp, lattice_nu, boxsize, time_ic,
                ttype=DELTA_NU, use_peculiar=use_peculiar, device=dev)
            pos_nu, vel_nu = res_nu.pos, res_nu.vel
        else:
            # no transfer table: thermal-only neutrinos on the lattice
            pos_nu = lattice_nu
            vel_nu = np.zeros_like(lattice_nu, dtype=np.float32)
        vel_nu = add_thermal_speeds(
            np.asarray(vel_nu, np.float64), np.random.RandomState(seed + 2),
            nu_sampler.v_amp, nu_sampler.max_v)
        mass_nu = (nufrac * omega_nu * cp.RhoCrit * boxsize ** 3
                   / ngrid_nu ** 3)
        species.append((2, pos_nu, vel_nu.astype(np.float32), ids_nu,
                        mass_nu))

    # write the IC snapshot
    outdir = ps.get_string("OutputDir")
    base = ps.get_string("FileBase")
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, base)
    bf = BigFile(path, create=True)
    totnumpart = np.zeros(6, dtype=np.uint64)
    masstable = np.zeros(6)
    for t, pos, vel, ids_t, mass in species:
        totnumpart[t] = len(pos)
        masstable[t] = mass
    hdr = SnapshotHeader(
        TotNumPart=totnumpart, MassTable=masstable, Time=time_ic,
        BoxSize=boxsize, Omega0=cp.Omega0, OmegaLambda=cp.OmegaLambda,
        OmegaBaryon=cp.OmegaBaryon, HubbleParam=cp.HubbleParam,
        UnitLength_in_cm=units.UnitLength_in_cm,
        UnitMass_in_g=units.UnitMass_in_g,
        UnitVelocity_in_cm_per_s=units.UnitVelocity_in_cm_per_s,
        UsePeculiarVelocity=use_peculiar, TimeIC=time_ic)
    hdr.extra["Seed"] = np.array([seed], dtype="<i8")
    hdr.extra["UnitaryAmplitude"] = np.array(
        [ps.get_int("UnitaryAmplitude")], dtype="<i4")
    hdr.extra["InvertPhase"] = np.array([ps.get_int("InvertPhase")],
                                        dtype="<i4")
    hdr.extra["FractionNuInParticles"] = np.array([nufrac])
    hdr.write(bf)
    for t, pos, vel, ids_t, mass in species:
        for name, data, dtype, nmemb in (("Position", pos, "<f8", 3),
                                         ("Velocity", vel, "<f4", 3),
                                         ("ID", ids_t, "<u8", 1)):
            blk = bf.create_block(f"{t}/{name}", dtype, len(pos),
                                  nmemb=nmemb)
            blk.write(0, data.astype(dtype))
            blk.flush()
    print(f"Wrote ICs to {path}: "
          + ", ".join(f"type{t}={len(p)}" for t, p, *_ in species))
    return path


def _pop_device(argv):
    """Remove `--device D` from argv; returns D (None: CUDA)."""
    if "--device" not in argv:
        return None
    i = argv.index("--device")
    dev = argv[i + 1]
    del argv[i: i + 2]
    return dev


def main(argv=None):
    argv = list(argv) if argv is not None else sys.argv[1:]
    device = _pop_device(argv)
    if len(argv) < 1:
        print("usage: python -m shenqi_tpu_torch.cli.genic_main paramfile "
              "[--device cpu]", file=sys.stderr)
        return 1
    run_genic(argv[0], device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
