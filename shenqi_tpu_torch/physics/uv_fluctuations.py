"""Fluctuating UV background + metal cooling tables (cooling_uvfluc.cpp
analog; shenqi_tpu/physics/uv_fluctuations.py:27-204 in torch).

Two independent optional tables:

  * Zreion_Table (Battaglia & Trac 2010 model, bigfile): the
    reionization redshift on a uniform spatial grid.  Particles whose
    z_reion is below the current redshift have not been reionized yet
    and see NO ionizing background (cooling_uvfluc.cpp:143-166).
    Periodic trilinear interpolation.

  * MetalCool file (bigfile, cloudy + UVB - H - He net rate at solar
    metallicity): NetCoolingRate on a (redshift, log10 nH, log10 T)
    grid, scaled linearly by the particle metallicity
    (cooling_uvfluc.cpp:271-335).  Clamped trilinear interpolation.

  * J21CoeffFile: photo rates per unit J21 by UV spectral slope, which
    turn the excursion set's per-particle J21 into per-row rates
    (cooling_uvfluc.cpp get_local_UVBG_from_J21).

The loaders are the JAX package's host code; the lookups are f32 torch
ops on the caller's device (the tables are moved there once).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..io.bigfile import BigFile
from ..utils.constants import CM_PER_MPC


class _OnDevice:
    """A host table's f32 copies, one per device."""

    def __init__(self, **arrays):
        self._host = arrays
        self._dev = {}

    def get(self, device):
        d = self._dev.get(device)
        if d is None:
            d = self._dev[device] = {
                k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                for k, v in self._host.items()}
        return d


class ZreionTable:
    """Spatial reionization-redshift grid with periodic trilinear
    lookup."""

    def __init__(self, table, nside: int, boxsize: float,
                 median_redshift: float):
        self.table = np.asarray(table, np.float32).reshape(nside, nside,
                                                           nside)
        self.nside = nside
        self.boxsize = boxsize           # internal units
        self.median_redshift = median_redshift
        self._t = _OnDevice(table=self.table.reshape(-1))

    @classmethod
    def load(cls, path: str, boxsize: float,
             unit_length_in_cm: float) -> "ZreionTable":
        """Read the UV fluctuation bigfile (Zreion_Table block with
        Nmesh/BoxSize/Redshift attrs; BoxSize is in Mpc/h)."""
        bf = BigFile(path)
        blk = bf["Zreion_Table"]
        nside = int(blk.attrs.raw("Nmesh")[0])
        table_box_mpc = float(blk.attrs.raw("BoxSize")[0])
        zreion = float(blk.attrs.raw("Redshift")[0])
        box_mpc = boxsize * unit_length_in_cm / CM_PER_MPC
        if abs(table_box_mpc - box_mpc) > 1e-5 * box_mpc:
            raise ValueError(
                f"UV fluctuation table box {table_box_mpc} Mpc/h does "
                f"not match simulation box {box_mpc} Mpc/h")
        data = blk.read().reshape(nside, nside, nside)
        return cls(data, nside, boxsize, zreion)

    def zreion(self, pos):
        """Periodic trilinear interpolation at positions [N, 3] (internal
        length units, an f32 tensor)."""
        ns = self.nside
        tab = self._t.get(pos.device)["table"]
        x = pos / self.boxsize * ns
        i0 = torch.floor(x).long()
        f = x - i0
        out = 0.0
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    flat = (((i0[:, 0] + dx) % ns) * ns
                            + (i0[:, 1] + dy) % ns) * ns \
                        + (i0[:, 2] + dz) % ns
                    w = ((f[:, 0] if dx else 1 - f[:, 0])
                         * (f[:, 1] if dy else 1 - f[:, 1])
                         * (f[:, 2] if dz else 1 - f[:, 2]))
                    out = out + w * tab[flat]
        return out


def local_uvbg(global_uvbg, zreion, redshift):
    """Per-particle UVBG: particles not yet reionized (z_reion below the
    current redshift) see zero photoionization/heating but keep the
    self-shielding density (cooling_uvfluc.cpp:143-166).

    zreion: [N] from ZreionTable.zreion.  Returns a UVBG whose fields are
    [N] tensors."""
    on = (zreion >= redshift).to(torch.float32)
    return type(global_uvbg)(
        gJH0=global_uvbg.gJH0 * on, gJHe0=global_uvbg.gJHe0 * on,
        gJHep=global_uvbg.gJHep * on, epsH0=global_uvbg.epsH0 * on,
        epsHe0=global_uvbg.epsHe0 * on, epsHep=global_uvbg.epsHep * on,
        self_shield_dens=global_uvbg.self_shield_dens
        * torch.ones_like(on),
        zreion=zreion)


@dataclass(frozen=True)
class J21Coeffs:
    """Photo rates per unit J21 as a function of the UV spectral
    slope alpha (the J21CoeffFile table, same column layout as
    TREECOOL but keyed by alpha; cooling_rates.cpp:274-286)."""

    alpha: np.ndarray
    rates: np.ndarray      # [Na, 6] log10 of Gamma_HI..Eps_HeII

    @classmethod
    def load(cls, path: str) -> "J21Coeffs":
        data = np.loadtxt(path)
        return cls(alpha=data[:, 0],
                   rates=np.log10(np.maximum(data[:, 1:7], 1e-300)))

    def at(self, alpha_uv: float):
        return [10.0 ** np.interp(alpha_uv, self.alpha,
                                  self.rates[:, i]) for i in range(6)]


def uvbg_from_j21(global_uvbg, j21, zreion, redshift, alpha_uv,
                  coeffs: J21Coeffs, fbar=0.17):
    """Per-particle UVBG from the excursion-set J21
    (cooling_uvfluc.cpp get_local_UVBG_from_J21): rates scale
    linearly with J21; HeII rates are zero (HeIII handled by the QSO
    lightup model); self-shielding density follows Rahmati 2012 with
    the local gJH0.  j21, zreion: [N] f32 tensors."""
    gH0, gHe0, _gHep, eH0, eHe0, _eHep = (float(v)
                                          for v in coeffs.at(alpha_uv))
    ev = 1.60218e-12
    j = j21.to(torch.float32)
    gJH0 = gH0 * j
    # Rahmati 2012 eq. 13 with the local photoionization rate; the JAX
    # package's floor jnp.maximum(gJH0, 1e-300) is 0 in f32
    g12 = torch.clamp(gJH0, min=0.0) / 1e-12
    greyopac = float(np.interp(np.clip(redshift, 0, 5),
                               [0., 1, 2, 3, 4, 5],
                               [2.59e-18, 2.37e-18, 2.27e-18,
                                2.15e-18, 2.02e-18, 1.94e-18]))
    ssdens = (6.73e-3 * (greyopac / 2.49e-18) ** (-2. / 3)
              * g12 ** (2. / 3) * (fbar / 0.17) ** (-1. / 3))
    ssdens = torch.where(gJH0 > 0, ssdens, 1e10)
    return type(global_uvbg)(
        gJH0=gJH0, gJHe0=gHe0 * j, gJHep=torch.zeros_like(j),
        epsH0=eH0 * j * ev, epsHe0=eHe0 * j * ev,
        epsHep=torch.zeros_like(j),
        self_shield_dens=ssdens, zreion=zreion)


class MetalCoolingTable:
    """Cloudy net metal cooling at solar Z on a (z, log nH, log T) grid;
    scaled by the metallicity at evaluation."""

    def __init__(self, redshift_bins, lognh_bins, logt_bins, rate):
        self.redshift_bins = np.asarray(redshift_bins, np.float64)
        self.lognh_bins = np.asarray(lognh_bins, np.float64)
        self.logt_bins = np.asarray(logt_bins, np.float64)
        self.rate = np.asarray(rate, np.float32).reshape(
            len(self.redshift_bins), len(self.lognh_bins),
            len(self.logt_bins))
        self._t = _OnDevice(z=self.redshift_bins, nh=self.lognh_bins,
                            t=self.logt_bins, rate=self.rate.reshape(-1))

    @classmethod
    def load(cls, path: str) -> "MetalCoolingTable":
        bf = BigFile(path)
        tab = bf["MetallicityInSolar_bins"].read()
        if tab.size != 1 or tab[0] != 0.0:
            raise ValueError("MetalCool file is wrongly tabulated")
        zb = np.asarray(bf["Redshift_bins"].read(), np.float64)
        nb = np.asarray(bf["HydrogenNumberDensity_bins"].read(), np.float64)
        tb = np.asarray(bf["Temperature_bins"].read(), np.float64)
        rate = np.asarray(bf["NetCoolingRate"].read(), np.float64)
        return cls(zb, nb, tb, rate.reshape(len(zb), len(nb), len(tb)))

    @staticmethod
    def _axis_index(b, x):
        """Fractional index on a (possibly non-uniform) axis, clamped to
        the table range (the reference's InterpNLinear clamps)."""
        i = torch.searchsorted(b, x, right=True) - 1
        i = torch.clamp(i, 0, b.shape[0] - 2)
        f = (x - b[i]) / torch.clamp(b[i + 1] - b[i], min=1e-35)
        return i, torch.clamp(f, 0.0, 1.0)

    def eval(self, redshift, temp, nh_cgs):
        """Net cooling at solar metallicity, erg/s/g per unit Z (multiply
        by the particle metallicity like cooling_rates.cpp:1154).
        redshift: a float or a 0-d tensor."""
        temp = torch.as_tensor(temp, dtype=torch.float32)
        nh_cgs = torch.as_tensor(nh_cgs, dtype=torch.float32,
                                 device=temp.device)
        d = self._t.get(temp.device)
        z = torch.as_tensor(redshift, dtype=torch.float32,
                            device=temp.device) * torch.ones_like(temp)
        iz, fz = self._axis_index(d["z"], z)
        inh, fnh = self._axis_index(
            d["nh"], torch.log10(torch.clamp(nh_cgs, min=1e-35)))
        it, ft = self._axis_index(d["t"],
                                  torch.log10(torch.clamp(temp, min=1.0)))
        nn, nt = self.rate.shape[1], self.rate.shape[2]
        out = 0.0
        for dz_ in (0, 1):
            for dn in (0, 1):
                for dt in (0, 1):
                    w = ((fz if dz_ else 1 - fz)
                         * (fnh if dn else 1 - fnh)
                         * (ft if dt else 1 - ft))
                    flat = ((iz + dz_) * nn + inh + dn) * nt + it + dt
                    out = out + w * d["rate"][flat]
        return out
