"""MP-GenIC equivalent CLI: paramfile -> bigfile IC snapshot
(shenqi_tpu/cli/genic_main.py for the port).

Usage: python -m shenqi_tpu_torch.cli.genic_main paramfile.genic [--device cpu]

Reads the same parameter files as the reference genic (genic/params.cpp)
and writes an IC bigfile readable by both packages and the reference.
The field is the reference's (host numpy); the FFTs and the CIC readout
run on the card unless `--device cpu` is given.  This slice ports the DM
branch: gas (ProduceGas), neutrino particles (NgridNu) and per-species
transfer functions (DifferentTransferFunctions) are refused.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .._device import resolve_device
from .params import genic_params
from ..utils.units import get_unitsystem
from ..cosmology.background import Cosmology
from ..cosmology.power import InputPower
from ..genic.ic import setup_grid, gaussian_field, displacement_fields
from ..io.bigfile import BigFile
from ..io.snapshot import SnapshotHeader


def _refuse_unported(ps):
    """The branches of the JAX genic that this slice does not port, each
    refused where it would take effect."""
    mnu = sum(ps.get_double(k) for k in ("MNue", "MNum", "MNut"))
    for cond, what, item in (
            (ps.get_int("ProduceGas"), "ProduceGas: gas particles", "A.7"),
            (ps.get_int("NgridNu") > 0 and mnu > 0,
             "NgridNu: neutrino particles", "A.6"),
            (ps.get_int("DifferentTransferFunctions")
             and ps.get_string("FileWithTransferFunction"),
             "DifferentTransferFunctions with FileWithTransferFunction: "
             "per-species transfer functions", "A.12")):
        if cond:
            raise NotImplementedError(
                f"genic {what} are not ported yet (ROADMAP {item})")


def run_genic(paramfile: str, strict: bool = False, device=None) -> str:
    """Write the IC snapshot the paramfile describes; returns its path."""
    dev = resolve_device(device)
    ps = genic_params()
    ps.parse_file(paramfile, strict=strict)
    _refuse_unported(ps)

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

    g_k = gaussian_field(seed, nmesh,
                         unitary=bool(ps.get_int("UnitaryAmplitude")),
                         invert_phase=bool(ps.get_int("InvertPhase")))

    # compute_mass (libgenic/save.cpp:90): CDM excludes neutrinos
    # whenever MNu > 0 (their mass lives in the linear response)
    omega_nu = cp.ONu.get_omega_nu(1.0) if sum(cp.MNu) > 0 else 0.0
    mass_dm = (cp.Omega0 - omega_nu) * cp.RhoCrit * boxsize ** 3 \
        / ngrid ** 3
    lattice, ids = setup_grid(ngrid, boxsize)
    res = displacement_fields(g_k, power, cp, lattice, boxsize, time_ic,
                              use_peculiar=use_peculiar, device=dev)

    # write the IC snapshot
    outdir = ps.get_string("OutputDir")
    base = ps.get_string("FileBase")
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, base)
    bf = BigFile(path, create=True)
    totnumpart = np.zeros(6, dtype=np.uint64)
    masstable = np.zeros(6)
    totnumpart[1] = len(ids)
    masstable[1] = mass_dm
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
    hdr.extra["FractionNuInParticles"] = np.array([0.0])
    hdr.write(bf)
    for name, data, dtype, nmemb in (("Position", res.pos, "<f8", 3),
                                     ("Velocity", res.vel, "<f4", 3),
                                     ("ID", ids, "<u8", 1)):
        blk = bf.create_block(f"1/{name}", dtype, len(ids), nmemb=nmemb)
        blk.write(0, data.astype(dtype))
        blk.flush()
    print(f"Wrote ICs to {path}: type1={len(ids)}")
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
