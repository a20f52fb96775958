"""Metal return from stellar populations (metal_return.cpp analog).

Physics:
  * Chabrier 2003 IMF (same normalization constants as the reference,
    metal_return.cpp:159-167)
  * stellar lifetimes from the Raiteri, Villata & Navarro 1996 fit
    (log t = a0(Z) + a1(Z) log m + a2(Z) log^2 m) — an independent
    published fit standing in for the reference's tabulated lifetimes
  * AGB yields parsed at runtime from the Karakas 2010 (0912.2142) and
    Doherty 2014 VW93 published tables; SNII yields from the Kobayashi
    2006 machine-readable table (the same data files the reference's
    tools/extract_yields.py consumes)
  * Sn1a: Maoz 2012 (1305.2913 eq 10) power-law DTD, index 1.12,
    normalized to Sn1aN0 SN/Msun; Iwamoto 1999 W7 yields

Per star particle and timestep: find the dying-mass window
[masslow, masshigh] from the lifetime inverse, IMF-integrate the mass
and metal return, add Sn1a, then scatter to gas neighbors
kernel-weighted (dense chunked star x gas blocks, like BH feedback).

A copy of the JAX package's host code (the IMF, the lifetime fit, the
yield parsers, `sn1a_number`, `MetalReturn`; numpy and scipy) so that
the port imports nothing of the JAX package; tests/test_torch_metal_
return.py pins it equal.  `metal_return_step` is torch ops on the
caller's device.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
from scipy.integrate import quad
from scipy.interpolate import RegularGridInterpolator
from scipy.optimize import brentq

from ..utils.constants import HUBBLE, SEC_PER_MEGAYEAR

# species order matches the reference (metal_tables.h NSPECIES):
SPECIES = ("H", "He", "C", "N", "O", "Ne", "Mg", "Si", "Fe")
NSPECIES = len(SPECIES)

MINMASS = 0.1     # IMF lower bound (Msun)
MAXMASS = 40.0    # highest mass returning metals
SNAGBSWITCH = 8.0  # AGB/SNII boundary
SNII_MIN = 8.0

# Iwamoto et al 1999 W7 SnIa yields per event (Msun), published values
SN1A_YIELDS = np.array([0, 0, 4.83e-2, 1.16e-6, 1.43e-1, 4.51e-3,
                        8.57e-3, 1.53e-1, 7.43e-1])
SN1A_TOTAL_METALS = float(SN1A_YIELDS[2:].sum())
SN1A_EJECTA = 1.3743416565891  # total W7 ejecta mass


def chabrier_imf(mass):
    """Chabrier 2003 IMF (number per unit mass), reference constants."""
    mass = np.asarray(mass, dtype=np.float64)
    low = 0.852464 / mass * np.exp(
        -(np.log10(mass / 0.079) / 0.69) ** 2 / 2)
    high = 0.237912 * mass ** (-2.3)
    return np.where(mass <= 1, low, high)


def imf_mass_integral(lo=MINMASS, hi=MAXMASS):
    """Total mass in the IMF over [lo, hi] (normalization)."""
    val1 = 0.0
    if lo < 1.0:
        val1, _ = quad(lambda m: m * chabrier_imf(m), lo, min(1.0, hi))
    val2 = 0.0
    if hi > 1.0:
        val2, _ = quad(lambda m: m * chabrier_imf(m), max(lo, 1.0), hi)
    return val1 + val2


def lifetime_myr(mass, metallicity):
    """Raiteri et al 1996 stellar lifetime fit (Myr).

    Valid for 0.6 < M < 120 Msun and 7e-5 < Z < 0.03 (clamped)."""
    z = np.clip(metallicity, 7e-5, 0.03)
    m = np.clip(mass, 0.6, 120.0)
    lz = np.log10(z)
    a0 = 10.13 + 0.07547 * lz - 0.008084 * lz * lz
    a1 = -4.424 - 0.7939 * lz - 0.1187 * lz * lz
    a2 = 1.262 + 0.3385 * lz + 0.05417 * lz * lz
    lm = np.log10(m)
    logt_yr = a0 + a1 * lm + a2 * lm * lm
    return 10.0 ** logt_yr / 1e6


def mass_dying_at(t_myr, metallicity):
    """Inverse lifetime: mass whose lifetime equals t_myr."""
    if t_myr <= lifetime_myr(120.0, metallicity):
        return 120.0
    if t_myr >= lifetime_myr(0.6, metallicity):
        return 0.6
    return brentq(lambda m: lifetime_myr(m, metallicity) - t_myr,
                  0.6, 120.0, xtol=1e-8)


def find_mass_bin_limits(dt_start_myr, dt_end_myr, metallicity):
    """Mass window [masslow, masshigh] of stars dying in the age
    interval (find_mass_bin_limits semantics)."""
    masshigh = mass_dying_at(max(dt_start_myr, 1e-10), metallicity)
    masslow = mass_dying_at(max(dt_end_myr, 1e-10), metallicity)
    return min(masslow, masshigh), max(masslow, masshigh)


# ---------------- yield table loading ----------------

@dataclass
class YieldTable:
    """2D (metallicity, mass) tables of per-species yields + ejecta."""

    masses: np.ndarray
    metallicities: np.ndarray
    yields: Dict[str, np.ndarray]      # species -> [nmet, nmass]
    total_metal: np.ndarray            # [nmet, nmass]
    ejected: np.ndarray                # [nmet, nmass]

    def interp(self, name: str):
        tab = (self.total_metal if name == "Z"
               else self.ejected if name == "ej"
               else self.yields[name])
        return RegularGridInterpolator(
            (self.metallicities, self.masses), tab, bounds_error=False,
            fill_value=None)


_SPECIES_PATTERNS = {
    "H": ("p", "d", "h1", "h2"), "He": ("he3", "he4"),
    "C": ("c12", "c13"), "N": ("n14", "n15"),
    "O": ("o16", "o17", "o18"), "Ne": ("ne20", "ne21", "ne22"),
    "Mg": ("mg24", "mg25", "mg26"), "Si": ("si28", "si29", "si30"),
    "Fe": ("fe54", "fe56", "fe57", "fe58", "fe60"),
}


def _species_of(token: str) -> Optional[str]:
    token = token.lower()
    for sp, pats in _SPECIES_PATTERNS.items():
        if token in pats:
            return sp
    return None


def load_agb_yields(yield_dir: str) -> YieldTable:
    """Parse the Karakas 2010 (tables a2-a5) + Doherty/VW93 AGB yield
    files (same published data the reference's extract_yields.py reads;
    this parser is independent)."""
    bins: Dict[Tuple[float, float], Dict[str, float]] = {}

    def finish(head, acc):
        if head is not None and acc:
            bins[head] = acc

    # Karakas format: "# Minitial = M msun, Z = Z, Mfinal = ..."
    kar_head = re.compile(
        r"# Minitial =\s*([\d.]+) msun, Z = ([\d.]+)")
    kar_line = re.compile(
        r"\s*([a-z0-9]+)\s+\d+\s+([-\d.E+]+)\s+([-\d.E+]+)")
    # VW93/Doherty format: "  6.5M Z=0.001 VW93"
    vw_head = re.compile(r"\s*([\d.]+)M Z=([\d.]+) VW93")
    vw_line = re.compile(r"\s*([a-z0-9]+)\s+([-\d.E+]+)\s+([-\d.E+]+)")

    def parse(fname, head_re, line_re):
        head, acc = None, {}
        with open(fname) as f:
            for line in f:
                m = head_re.match(line)
                if m:
                    finish(head, acc)
                    head = (float(m.group(1)), float(m.group(2)))
                    acc = {sp: 0.0 for sp in SPECIES}
                    acc["Z"] = 0.0
                    acc["ej"] = 0.0
                    continue
                m = line_re.match(line)
                if m and head is not None:
                    token = m.group(1)
                    try:
                        lost = float(m.group(3))
                    except ValueError:
                        continue
                    sp = _species_of(token)
                    if sp is not None:
                        acc[sp] += lost
                    if sp not in ("H", "He"):
                        acc["Z"] += lost
                    acc["ej"] += lost
        finish(head, acc)

    agb = os.path.join(yield_dir, "agb")
    for fn in ("table_a2.txt", "table_a3.txt", "table_a4.txt",
               "table_a5.txt"):
        p = os.path.join(agb, fn)
        if os.path.exists(p):
            parse(p, kar_head, kar_line)
    for fn in ("TABLE1-VW93ML.txt", "P3Doh14b-table1.txt"):
        p = os.path.join(agb, fn)
        if os.path.exists(p):
            parse(p, vw_head, vw_line)
    if not bins:
        raise FileNotFoundError(f"no AGB yield files under {agb}")

    # fix the Karakas M=2.1 quirk
    bins = {(2.0 if abs(m - 2.1) < 1e-9 else m, z): v
            for (m, z), v in bins.items()}
    masses = np.array(sorted({m for m, z in bins}))
    mets = np.array(sorted({z for m, z in bins}))

    def grid(key):
        out = np.zeros((len(mets), len(masses)))
        for (m, z), v in bins.items():
            out[np.searchsorted(mets, z),
                np.searchsorted(masses, m)] = v[key]
        # fill holes along mass by nearest available in the met row
        for i in range(len(mets)):
            row = out[i]
            nz = np.nonzero(row)[0]
            if len(nz) and len(nz) < len(row):
                out[i] = np.interp(np.arange(len(row)), nz, row[nz])
        return out

    yields = {sp: grid(sp) for sp in SPECIES}
    return YieldTable(masses=masses, metallicities=mets, yields=yields,
                      total_metal=grid("Z"), ejected=grid("ej"))


def load_snii_yields(yield_dir: str) -> YieldTable:
    """Parse the Kobayashi 2006 SNII machine-readable table.

    Layout: rows of `Z  species  P13 P15 P18 P20 P25 P30 P40` — the
    yield (Msun) of each isotope for 7 progenitor masses at 4
    metallicities.  Isotopes like `^12^C` are folded into elements."""
    path = os.path.join(yield_dir, "snii_kabayashi_2006.txt")
    masses = np.array([13., 15., 18., 20., 25., 30., 40.])
    bins: Dict[float, Dict[str, np.ndarray]] = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) != 2 + len(masses):
                continue
            try:
                z = float(parts[0])
                vals = np.array([float(x) for x in parts[2:]])
            except ValueError:
                continue
            token = parts[1]
            if token in ("M_final_", "M_cut_"):
                d = bins.setdefault(z, {})
                d[token] = vals
                continue
            # normalize isotope markup: ^12^C -> c12, p -> p
            m = re.match(r"\^(\d+)\^([A-Za-z]+)", token)
            if m:
                token = (m.group(2) + m.group(1)).lower()
            else:
                token = token.lower()
            sp = _species_of(token)
            d = bins.setdefault(z, {})
            if sp is not None:
                d[sp] = d.get(sp, np.zeros(len(masses))) + vals
            if sp not in ("H", "He"):
                d["Z"] = d.get("Z", np.zeros(len(masses))) + vals
            d["ej"] = d.get("ej", np.zeros(len(masses))) + vals
    if not bins:
        raise ValueError(f"could not parse SNII yields from {path}")
    mets = np.array(sorted(bins))
    yields = {}
    for sp in SPECIES:
        yields[sp] = np.stack([bins[z].get(sp, np.zeros(len(masses)))
                               for z in mets])
    total = np.stack([bins[z]["Z"] for z in mets])
    ej = np.stack([bins[z]["ej"] for z in mets])
    return YieldTable(masses=masses, metallicities=mets, yields=yields,
                      total_metal=total, ejected=ej)


# ---------------- per-star return computation ----------------

def sn1a_number(dt_myr_start, dt_myr_end, hubble_h, sn1a_n0=1.3e-3):
    """Number of Sn1a per Msun of stars in the age window
    (metal_return.cpp:297-313, Maoz 2012 DTD)."""
    index = 1.12
    tau = 40.0
    if dt_myr_end < tau:
        return 0.0
    dt_myr_start = max(dt_myr_start, tau)
    t_hub = 1 / (hubble_h * HUBBLE * SEC_PER_MEGAYEAR)
    total = 1 - (t_hub / tau) ** (1 - index)
    return (sn1a_n0 / total
            * ((dt_myr_start / tau) ** (1 - index)
               - (dt_myr_end / tau) ** (1 - index)))


@dataclass
class MetalReturn:
    """Precomputed interpolators + the per-star return evaluation."""

    agb: YieldTable
    snii: YieldTable
    sn1a_n0: float = 1.3e-3
    imf_norm: float = field(default=0.0)

    @classmethod
    def load(cls, yield_dir: str, sn1a_n0=1.3e-3) -> "MetalReturn":
        mr = cls(agb=load_agb_yields(yield_dir),
                 snii=load_snii_yields(yield_dir), sn1a_n0=sn1a_n0)
        mr.imf_norm = imf_mass_integral()
        mr._agb_z = mr.agb.interp("Z")
        mr._agb_ej = mr.agb.interp("ej")
        mr._snii_z = mr.snii.interp("Z")
        mr._snii_ej = mr.snii.interp("ej")
        return mr

    def _imf_weighted(self, interp, metallicity, lo, hi):
        """integral of imf(m) * yield(met, m) dm over [lo, hi]."""
        if lo >= hi:
            return 0.0
        val, _ = quad(lambda m: chabrier_imf(m)
                      * float(interp((metallicity, m))), lo, hi,
                      limit=100)
        return val

    def star_return(self, metallicity, age_start_myr, age_end_myr,
                    hubble_h):
        """(mass_return_fraction, metal_return_fraction) per unit
        initial stellar mass for the age window."""
        masslow, masshigh = find_mass_bin_limits(
            age_start_myr, age_end_myr, metallicity)
        mass_ret = 0.0
        metal_ret = 0.0
        # AGB part
        lo = max(masslow, float(self.agb.masses[0]))
        hi = min(masshigh, SNAGBSWITCH)
        z = np.clip(metallicity, self.agb.metallicities[0],
                    self.agb.metallicities[-1])
        mass_ret += self._imf_weighted(self._agb_ej, z, lo, hi)
        metal_ret += self._imf_weighted(self._agb_z, z, lo, hi)
        # SNII part
        lo = max(masslow, SNII_MIN, float(self.snii.masses[0]))
        hi = min(masshigh, float(self.snii.masses[-1]))
        z2 = np.clip(metallicity, self.snii.metallicities[0],
                     self.snii.metallicities[-1])
        mass_ret += self._imf_weighted(self._snii_ej, z2, lo, hi)
        metal_ret += self._imf_weighted(self._snii_z, z2, lo, hi)
        # normalize by total IMF mass
        mass_ret /= self.imf_norm
        metal_ret /= self.imf_norm
        # Sn1a
        nsn = sn1a_number(age_start_myr, age_end_myr, hubble_h,
                          self.sn1a_n0)
        mass_ret += nsn * SN1A_EJECTA
        metal_ret += nsn * SN1A_TOTAL_METALS
        return mass_ret, metal_ret, nsn


# ---------------- scatter to gas (dense, in blocks) ----

# star lanes of one block (the JAX package's scan chunk)
_STAR_CHUNK = 256
# pairs of one block
_PAIR_BLOCK = 1 << 24


def metal_return_step(star_ipos, star_hsml, star_mass_return,
                      star_metal_return, star_fw, gas_ipos, gas_mass,
                      gas_alive, boxsize, spec=None):
    """Distribute returned mass and metals to gas kernel-weighted.

    star_fw: per-star kernel weight sums (from
    blackhole.bh_gas_environment with star positions — the
    stellar_density2.cpp volume pass analog).  The stars are taken 256
    at a time as the JAX package's scan takes them, the gas rows in
    blocks of at most 2^24 pairs.
    Returns (dmass [Ng], dmetalmass [Ng]) increments.
    """
    import torch
    from ..ops.treewalk import pair_dist
    from ..sph.kernels import CUBIC, wk as kern_wk
    if spec is None:
        spec = CUBIC
    ns = star_ipos.shape[0]
    ng = gas_ipos.shape[0]
    dm = torch.zeros(ng, dtype=torch.float32, device=gas_ipos.device)
    dz = torch.zeros_like(dm)
    for s0 in range(0, ns, _STAR_CHUNK):
        sl = slice(s0, min(s0 + _STAR_CHUNK, ns))
        H = star_hsml[sl][None, :]
        Hs = torch.clamp(H, min=1e-35)
        smr = star_mass_return[sl][None, :]
        szr = star_metal_return[sl][None, :]
        sfw = torch.clamp(star_fw[sl][None, :], min=1e-35)
        rows = max(1, _PAIR_BLOCK // H.shape[1])
        for g0 in range(0, ng, rows):
            g = slice(g0, min(g0 + rows, ng))
            _, r2 = pair_dist(gas_ipos[g][:, None, :],
                              star_ipos[sl][None, :, :], boxsize)
            inside = (r2 < H * H) & gas_alive[g][:, None] & (smr > 0)
            u = torch.clamp(torch.sqrt(r2) / Hs, max=1.0)
            w = torch.where(inside, kern_wk(spec, u, Hs), 0.0)
            share = w * gas_mass[g][:, None] / sfw
            dm[g] += torch.sum(share * smr, 1)
            dz[g] += torch.sum(share * szr, 1)
    return dm, dz
