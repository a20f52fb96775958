"""Physical constants in cgs units.

Values match the reference's constant table (libgadget/physconst.h) so that
internal-unit conversions agree to the last digit — required for snapshot
compatibility and for matching the reference's P(k) to <0.1%.

A copy of shenqi_tpu/utils/constants.py (no JAX in it) so that the PyTorch port
imports nothing of the JAX package.
"""

GRAVITY = 6.672e-8          # cm^3 g^-1 s^-2
SOLAR_MASS = 1.989e33       # g
SOLAR_LUM = 3.826e33        # erg/s
RAD_CONST = 7.565e-15       # erg cm^-3 K^-4 (4 sigma_SB / c)
STEFAN_BOLTZMANN = 5.670373e-5  # erg cm^-2 s^-1 K^-4
AVOGADRO = 6.0222e23
BOLTZMANN = 1.38066e-16     # erg/K
BOLEVK = 8.61734e-5         # Boltzmann constant in eV/K
EV_IN_ERGS = 1.60218e-12
GAS_CONST = 8.31425e7
LIGHTCGS = 2.99792458e10    # cm/s
PLANCK = 6.6262e-27
CM_PER_MPC = 3.085678e24
CM_PER_KPC = 3.085678e21
PROTONMASS = 1.6726e-24     # g
ELECTRONMASS = 9.10953e-28  # g
THOMPSON = 6.65245e-25      # cm^2
ELECTRONCHARGE = 4.8032e-10
HUBBLE = 3.2407789e-18      # 100 km/s/Mpc in h/sec
SEC_PER_MEGAYEAR = 3.155e13
SEC_PER_YEAR = 3.155e7

GAMMA = 5.0 / 3.0           # adiabatic index of simulated gas
GAMMA_MINUS1 = GAMMA - 1.0

HYDROGEN_MASSFRAC = 0.76    # primordial hydrogen mass fraction

# Ratio of neutrino to CMB temperature, including the non-instantaneous
# decoupling correction (Mangano et al 2005); CLASS default so that
# omega_nu = m_nu / 93.14 h^2.  (cf. reference omega_nu_single.hpp TNUCMB)
TNUCMB = (4.0 / 11.0) ** (1.0 / 3.0) * 1.00328
# Number of massive neutrino species
NUSPECIES = 3
