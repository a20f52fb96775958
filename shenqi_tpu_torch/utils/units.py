"""Internal unit system (Gadget convention, factors of h left in).

Mirrors the semantics of the reference unit system
(libgadget/utils/unitsystem.h:7-20): three base units (length, mass,
velocity) define time, density and energy units.

A copy of shenqi_tpu/utils/units.py (no JAX in it) so that the PyTorch port
imports nothing of the JAX package.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class UnitSystem:
    UnitMass_in_g: float            # internal mass unit -> grams/h
    UnitVelocity_in_cm_per_s: float # internal velocity unit -> cm/s
    UnitLength_in_cm: float         # internal length unit -> cm/h
    UnitTime_in_s: float            # internal time unit -> s/h
    UnitDensity_in_cgs: float
    UnitEnergy_in_cgs: float
    UnitInternalEnergy_in_cgs: float


def get_unitsystem(UnitLength_in_cm: float, UnitMass_in_g: float,
                   UnitVelocity_in_cm_per_s: float) -> UnitSystem:
    t = UnitLength_in_cm / UnitVelocity_in_cm_per_s
    dens = UnitMass_in_g / UnitLength_in_cm ** 3
    energy = UnitMass_in_g * UnitLength_in_cm ** 2 / t ** 2
    return UnitSystem(
        UnitMass_in_g=UnitMass_in_g,
        UnitVelocity_in_cm_per_s=UnitVelocity_in_cm_per_s,
        UnitLength_in_cm=UnitLength_in_cm,
        UnitTime_in_s=t,
        UnitDensity_in_cgs=dens,
        UnitEnergy_in_cgs=energy,
        UnitInternalEnergy_in_cgs=energy / UnitMass_in_g,
    )


# Default Gadget units: kpc/h, 1e10 Msun/h, km/s.
def default_units() -> UnitSystem:
    return get_unitsystem(3.085678e21, 1.989e43, 1e5)
