"""State carried across from the JAX package, exactly.

`particles_from_numpy` takes the fields of shenqi_tpu's ParticleData
(core/particles.py:64-90) as numpy arrays and builds the port's
ParticleData: uint32 fields (`ipos`, `id_lo`, `id_hi`) become int32 bit
patterns, the rest keep their dtype.  `window_from_numpy` turns a JAX
PolyWindow's arrays into the port's PolyWindow.  `nu_table_from_numpy`
turns a JAX DeltaTotTable's host state into the port's, on the port's
Cosmology.  `gas_state_from_numpy` turns a JAX GasState's arrays into
the port's GasState (the star, wind and black-hole fields too: BH rows
are ptype 5 in the particles and carry `bh_mass`, `bh_mdot`), and
`bh_params_from` a JAX BHParams into the port's.  `key_from_numpy`
turns a JAX GasPhysics.rng_key into the port's threefry key, so that
both packages go on drawing one stream.  `slab_rows_from_numpy` turns a
JAX SlabSimulation's `fields` (its row state under the JAX slab names)
into the port's slab row columns of one rank (SlabSimulation._rows,
which SlabSimulation._set_rows takes).  All seven are exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._device import resolve_device
from .core.particles import ParticleData, u32_numpy_to_i32
from .gravity.shortrange import PolyWindow
from .physics.blackhole import BHParams
from .physics.neutrinos_lra import DeltaTotTable
from .simulation_gas import GasState

_U32_FIELDS = ("ipos", "id_lo", "id_hi")
_DTYPES = {"vel": np.float32, "mass": np.float32, "ptype": np.int8,
           "mask": np.bool_, "timebin": np.int8, "hsml": np.float32,
           "grav_pm": np.float32, "grav_accel": np.float32,
           "potential": np.float32, "old_acc": np.float32}


def particles_from_numpy(d: dict, device=None) -> ParticleData:
    """The port's ParticleData from a dict of the JAX fields as numpy."""
    dev = resolve_device(device)
    kw = {}
    for f in ParticleData.__dataclass_fields__:
        a = np.asarray(d[f])
        if f in _U32_FIELDS:
            if a.dtype != np.uint32:
                raise TypeError(f"{f} must be uint32, got {a.dtype}")
            a = u32_numpy_to_i32(a)
        else:
            a = np.ascontiguousarray(a, dtype=_DTYPES[f])
        kw[f] = torch.from_numpy(a.copy()).to(dev)
    return ParticleData(**kw)


def window_from_numpy(cf, cp, xmax, device=None) -> PolyWindow:
    """The port's PolyWindow from a JAX PolyWindow's (cf, cp, xmax)."""
    dev = resolve_device(device)
    return PolyWindow(
        xmax=float(np.float32(xmax)),
        cf=torch.from_numpy(np.asarray(cf, np.float32).copy()).to(dev),
        cp=torch.from_numpy(np.asarray(cp, np.float32).copy()).to(dev))


def nu_table_from_numpy(d: dict, CP) -> DeltaTotTable:
    """The port's DeltaTotTable from a JAX DeltaTotTable's fields but CP
    (numpy arrays, lists and floats, copied), on the port's Cosmology
    `CP`: both packages then continue one neutrino history."""
    kw = {}
    for f in dataclasses.fields(DeltaTotTable):
        if f.name == "CP":
            continue
        v = d[f.name]
        if isinstance(v, np.ndarray):
            v = v.copy()
        elif isinstance(v, list):
            v = list(v)
        kw[f.name] = v
    return DeltaTotTable(CP=CP, **kw)


def gas_state_from_numpy(d: dict, device=None) -> GasState:
    """The port's GasState from a dict of the JAX GasState's fields as
    numpy (`ngas` an int); None fields of the JAX state take the port's
    initial values."""
    dev = resolve_device(device)
    ngas = int(d["ngas"])
    ntot = len(np.asarray(d["birth_a"]))
    init = GasState.create(ngas, np.zeros(ngas, np.float32), ntot=ntot,
                           device=dev)
    kw = {"ngas": ngas}
    for f in dataclasses.fields(GasState):
        if f.name == "ngas":
            continue
        v = d.get(f.name)
        if v is None:
            kw[f.name] = getattr(init, f.name)
            continue
        dtype = {torch.int32: np.int32, torch.bool: np.bool_}.get(
            getattr(init, f.name).dtype, np.float32)
        kw[f.name] = torch.from_numpy(
            np.array(v, dtype=dtype, copy=True)).to(dev)
    return GasState(**kw)


def bh_params_from(par) -> BHParams:
    """The port's BHParams from a JAX BHParams (or any object with its
    fields)."""
    return BHParams(**{f.name: getattr(par, f.name)
                       for f in dataclasses.fields(BHParams)})


def key_from_numpy(key) -> tuple:
    """The port's threefry key (utils/threefry.py) from a jax.random key
    array of two uint32 words (GasPhysics.rng_key)."""
    k = np.asarray(key, dtype=np.uint32).reshape(2)
    return (int(k[0]), int(k[1]))


# the JAX slab loop's row names (parallel/slab_sim.py:212-357 of the JAX
# package) -> the port's ParticleData and GasState names
_SLAB_NAMES = {
    "ipos": "ipos", "vel": "vel", "mass": "mass", "id_lo": "id_lo",
    "id_hi": "id_hi", "ptyp": "ptype", "tbin": "timebin", "hsml": "hsml",
    "gacc": "grav_accel", "gpm": "grav_pm", "oldacc": "old_acc",
    "entropy": "entropy", "density": "density", "egywt": "egy_wt_density",
    "dhsml_egy": "dhsml_egy", "divv": "div_vel", "curlv": "curl_vel",
    "hacc": "hydro_accel", "dts": "dt_entropy", "mvsig": "max_signal_vel",
    "dth": "dt_hsml", "grho": "gradrho_mag", "ne": "ne",
    "met": "metallicity", "sfr": "sfr", "delay": "delay_time",
    "gen": "generation", "vdsp": "vdisp", "heiii": "heiii",
    "j21": "local_j21", "zrei": "zreion_p", "birtha": "birth_a",
    "enr": "last_enrich_myr", "m0": "mass0", "tret": "total_returned",
    "bhm": "bh_mass", "bhmd": "bh_mdot", "smet": "star_metallicity"}


def slab_rows_from_numpy(fields: dict, rank: int, ndev: int, cuts_in=None,
                         device=None) -> dict:
    """The port's slab row columns of rank `rank` of `ndev` from a JAX
    slab `fields` dict as numpy: the alive rows (mass > 0) whose x lies in
    the rank's slab (uniform slabs, or the cuts `cuts_in`), every JAX
    column under the port's name (_SLAB_NAMES), uint32 words as int32
    bits; `mask` true and `potential` zero.  The JAX package's ptype,
    time bin and generation are int32, the port's int8, int8, int32."""
    from .parallel.domain import slab_index
    dev = resolve_device(device)
    mass = np.asarray(fields["mass"], np.float32)
    ipos = np.asarray(fields["ipos"]).view(np.uint32)
    x = torch.from_numpy(u32_numpy_to_i32(ipos[:, 0].copy()))
    mine = (mass > 0) & (slab_index(x, ndev, cuts_in).numpy() == rank)
    rows = {}
    for jax_name, name in _SLAB_NAMES.items():
        if jax_name not in fields:
            continue
        a = np.asarray(fields[jax_name])[mine]
        if jax_name in ("ipos", "id_lo", "id_hi"):
            a = u32_numpy_to_i32(a.astype(np.uint32))
        elif name in ("ptype", "timebin"):
            a = a.astype(np.int8)
        elif name == "generation":
            a = a.astype(np.int32)
        elif name == "heiii":
            a = a.astype(np.bool_)
        else:
            a = a.astype(np.float32)
        rows[name] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    n = int(mine.sum())
    rows["mask"] = torch.ones(n, dtype=torch.bool, device=dev)
    rows["potential"] = torch.zeros(n, dtype=torch.float32, device=dev)
    return rows
