"""SPH hydro accelerations (shenqi_tpu/sph/hydro.py in torch, the
hydra2.cpp / hydratree2.hpp analog).

Physics identical to the reference hydro walk
(libgadget/hydratree2.hpp:230-380):
  * symmetric kernel: pairs interact if r < max(H_i, H_j)
  * pressure-entropy or density-entropy EOM with grad-h correction terms
  * Monaghan artificial viscosity with Balsara switch (Gadget-2 eq 13-14)
    and the viscosity limiter against the particle timestep
  * signal velocity tracking (for the Courant condition)
  * DtEntropy from the viscous dissipation, converted to entropy rate
    with GAMMA_MINUS1 / (hubble a^2 rho^{gamma-1})

The time-dependent comoving factors (fac_mu, fac_vsic_fix, hubble_a2,
the reference HydroPriv fields) come from `hydro_time_factors` as f32
values.  The tree walks (`hydro_walk`, `hydro_walk_blocked`) stay with
ROADMAP A.10; the production path is sph/stencil_hydro.py, with
`hydro_walk_dense` for the targets it flags.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.treewalk import run_walk_dense
from ..utils.constants import GAMMA, GAMMA_MINUS1
from .kernels import KernelSpec, CUBIC, dwk as kern_dwk


class HydroParams(NamedTuple):
    """Static hydro configuration.  The time factors are not here: they
    change every step and come in through `tf` (hydro_time_factors);
    atime and hubble are the defaults the JAX package keeps."""
    boxsize: float
    atime: float = 1.0
    hubble: float = 0.1

    art_bulk_visc_const: float = 0.75
    density_contrast_limit: float = 2.0
    density_independent_sph: bool = True

    @property
    def fac_mu(self):
        return self.atime ** (3 * (GAMMA - 1) / 2) / self.atime

    @property
    def fac_vsic_fix(self):
        return self.hubble * self.atime ** (3 * GAMMA_MINUS1)

    @property
    def hubble_a2(self):
        return self.hubble * self.atime ** 2

    def static_key(self):
        """The subset the JAX package compiles against."""
        return self._replace(atime=1.0, hubble=0.1)


def hydro_time_factors(atime, hubble):
    """The comoving factors of this time, computed in f32 as the JAX
    package computes them, as Python floats holding those f32 values."""
    a = np.float32(atime)
    h = np.float32(hubble)
    return {
        "fac_mu": float(a ** np.float32(3 * (GAMMA - 1) / 2) / a),
        "fac_vsic_fix": float(h * a ** np.float32(3 * GAMMA_MINUS1)),
        "hubble_a2": float(h * a ** 2),
    }


class HydroResult(NamedTuple):
    accel: torch.Tensor           # [T,3] comoving hydro acceleration
    dt_entropy: torch.Tensor      # [T] entropy change rate
    max_signal_vel: torch.Tensor  # [T]


def pressure_predict(eomdensity, entvar):
    p = entvar * eomdensity
    return torch.where(p > 0, torch.exp(GAMMA * torch.log(
        torch.clamp(p, min=1e-35))), 0.0)


def _hydro_accum(spec: KernelSpec, par: HydroParams):
    """The hydro accumulator over a tensor of pairs (ops/treewalk.py
    protocol): targets [...], sources [..., S]; carry = (acc [..., 3],
    dts [...], maxvsig [...])."""
    def accumulate(carry, extra, src, dist, r2, live):
        acc, dts, maxvsig = carry

        def e(name):
            v = extra[name]
            return v[..., None] if torch.is_tensor(v) else v

        H_i = e("hsml")
        H_j = src["hsml"]
        inside = live & (r2 > 0) & ((r2 < H_i * H_i) | (r2 < H_j * H_j)) \
            & (src["mass"] > 0)
        # sanitize padded/masked lanes BEFORE any division: a NaN times
        # zero weight is still NaN
        H_j = torch.where(inside, H_j, 1.0)

        # j-side predicted state
        density_j = src["density"]
        eomdensity_j = src["eomdensity"]
        entvar_j = src["entvar"]
        press_j = src["pressure"]
        eom_j = torch.clamp(eomdensity_j, min=1e-35)
        p_over_rho2_j = press_j / (eom_j * eom_j)
        cs_j = torch.sqrt(GAMMA * press_j / eom_j)
        cs_i = e("soundspeed")
        p_over_rho2_i = e("p_over_rho2")

        vsig_pair = cs_i + cs_j
        maxvsig = torch.maximum(maxvsig, torch.amax(
            torch.where(inside, vsig_pair, 0.0), -1))

        dv = extra["vel"][..., None, :] - src["vel"]
        vdotr = torch.sum(dist * dv, -1)
        del dv
        vdotr2 = vdotr + e("hubble_a2") * r2
        r = torch.sqrt(torch.clamp(r2, min=1e-35))

        dwk_i = kern_dwk(spec, torch.clamp(r / H_i, max=1.0), H_i)
        dwk_j = kern_dwk(spec, torch.clamp(r / H_j, max=1.0), H_j)
        dwk_ij = dwk_i + dwk_j

        # artificial viscosity (Gadget-2 eq 13-14) where approaching
        approach = vdotr2 < 0
        fac_mu = e("fac_mu")
        mu_ij = fac_mu * vdotr2 / r
        rho_ij = 0.5 * (e("density") + density_j)
        vsig_visc = cs_i + cs_j - 3 * mu_ij
        maxvsig = torch.maximum(maxvsig, torch.amax(
            torch.where(inside & approach, vsig_visc, 0.0), -1))
        adiv = torch.abs(src["divvel"])
        f2 = adiv / (adiv + src["curlvel"]
                     + 0.0001 * cs_j / fac_mu / torch.clamp(H_j, min=1e-35))
        visc = (0.25 * par.art_bulk_visc_const * vsig_visc * (-mu_ij)
                / torch.clamp(rho_ij, min=1e-35) * (e("f1") + f2))
        del f2, adiv, rho_ij, vsig_visc, mu_ij
        # viscosity limiter against the timestep (hydratree2.hpp:334-343)
        dloga = 2 * torch.maximum(e("dloga"), src["dloga"])
        msum = e("mass") + src["mass"]
        denom = 0.5 * msum * dwk_ij * r * dloga
        visc_lim = 0.5 * e("fac_vsic_fix") * vdotr2 / torch.where(
            torch.abs(denom) > 0, denom, 1.0)
        apply_lim = (dloga > 0) & (dwk_ij < 0) & (msum > 0)
        visc = torch.where(apply_lim, torch.minimum(visc, visc_lim), visc)
        visc = torch.where(approach, visc, 0.0)
        del denom, visc_lim, apply_lim, dloga, msum

        m_j = src["mass"]
        hfc_visc = 0.5 * m_j * visc * dwk_ij / r
        hfc = hfc_visc
        if par.density_independent_sph:
            entvar_i = e("entvar")
            hfc = hfc + m_j * (
                dwk_i * p_over_rho2_i * entvar_j
                / torch.clamp(entvar_i, min=1e-35)
                + dwk_j * p_over_rho2_j * entvar_i
                / torch.clamp(entvar_j, min=1e-35)) / r
            if par.density_contrast_limit >= 0:
                rr1 = e("egyrho") / torch.clamp(e("density"), min=1e-35)
                rr2 = eomdensity_j / torch.clamp(density_j, min=1e-35)
                if par.density_contrast_limit > 0:
                    rr1 = torch.clamp(rr1, max=par.density_contrast_limit)
                    rr2 = torch.clamp(rr2, max=par.density_contrast_limit)
            else:
                rr1 = rr2 = 0.0
        else:
            rr1 = rr2 = 1.0
        hfc = hfc + m_j * (p_over_rho2_i * e("dhsml") * dwk_i * rr1
                           + p_over_rho2_j * src["dhsml_egy"] * dwk_j
                           * rr2) / r

        hfc = torch.where(inside, hfc, 0.0)
        hfc_visc = torch.where(inside, hfc_visc, 0.0)
        acc = acc - torch.sum(hfc[..., None] * dist, -2)
        dts = dts + torch.sum(0.5 * hfc_visc * vdotr2, -1)
        return acc, dts, maxvsig

    return accumulate


def _hydro_extra(targets, par, tf=None):
    """Targets + derived columns + the time factors (Python floats: the
    same for every target)."""
    press = targets["pressure"]
    egyrho = torch.clamp(targets["egyrho"], min=1e-35)
    extra = dict(targets)
    extra["soundspeed"] = torch.sqrt(GAMMA * press / egyrho)
    extra["p_over_rho2"] = press / (egyrho * egyrho)
    if tf is None:
        tf = {"fac_mu": float(np.float32(par.fac_mu)),
              "fac_vsic_fix": float(np.float32(par.fac_vsic_fix)),
              "hubble_a2": float(np.float32(par.hubble_a2))}
    extra.update(tf)
    return extra


def entropy_rate(dts, density, par, tf=None):
    """Viscous dissipation -> entropy rate (hydratree2.hpp:140)."""
    hub_a2 = (tf or {}).get("hubble_a2", par.hubble_a2)
    return dts * GAMMA_MINUS1 / (hub_a2 * torch.pow(
        torch.clamp(density, min=1e-35), GAMMA_MINUS1))


def hydro_walk_dense(payload, targets, par: HydroParams,
                     spec: KernelSpec = CUBIC, tf=None) -> HydroResult:
    """The hydro force against EVERY source (the run_walk_dense oracle):
    the accumulator applies the symmetric max(H_i, H_j) cut itself.
    Used for the cover targets the stencil engine flags.

    payload: source ipos, mass (0 for dead or decoupled rows), hsml,
    vel, density, eomdensity, entvar, pressure, divvel, curlvel,
    dhsml_egy, dloga.  targets: ipos, vel, hsml, mass, density, egyrho,
    entvar, pressure, f1 (Balsara), dhsml, dloga."""
    t = targets["ipos"].shape[0]
    dev = targets["ipos"].device
    carry0 = (torch.zeros((t, 3), dtype=torch.float32, device=dev),
              torch.zeros(t, dtype=torch.float32, device=dev),
              torch.zeros(t, dtype=torch.float32, device=dev))
    src = {k: v for k, v in payload.items() if k != "decoupled"}
    if "decoupled" in payload:
        src["mass"] = torch.where(payload["decoupled"], 0.0,
                                  payload["mass"])
    acc, dts, maxvsig = run_walk_dense(
        src, targets["ipos"], _hydro_extra(targets, par, tf), carry0,
        _hydro_accum(spec, par), par.boxsize)
    return HydroResult(accel=acc,
                       dt_entropy=entropy_rate(dts, targets["density"],
                                               par, tf),
                       max_signal_vel=maxvsig)


def balsara_f1(divvel, curlvel, soundspeed, hsml, fac_mu):
    """Balsara viscosity switch for the target side."""
    return torch.abs(divvel) / (torch.abs(divvel) + curlvel
                                + 0.0001 * soundspeed / fac_mu
                                / torch.clamp(hsml, min=1e-35))
