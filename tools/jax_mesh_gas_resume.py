"""Where does the JAX package's `gadget_main --mesh N` start its gas on a
resume?  Runs the JAX package (not the port) on the CPU: genic of the
travis-hydro miniature (chip_smoke's _GENIC_GAS at Ngrid 8), the JAX
single-device gadget_main to a = 0.011 with a snapshot there, then the
JAX gadget_main --mesh 2 with RestartFlag 1 from that snapshot for one
step, and prints the median specific energy of its gas after the step
(u = A (EgyWtDensity a^-3)^(gamma-1) / (gamma-1)) against u0(a) from
InitGasTemp (the CMB temperature at a) and against the snapshot's
InternalEnergy.  The port's --mesh run matches the answer
(tests/test_torch_mesh_gas_cli.py; ROADMAP C.4).

    XLA_FLAGS=--xla_force_host_platform_device_count=2 JAX_PLATFORMS=cpu \\
        python tools/jax_mesh_gas_resume.py OUTDIR

The --mesh step compiles multi-device programs: minutes on a CPU host.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (_GADGET_GAS, _GENIC_GAS, _class_tk_table,  # noqa
                        _dm_small_cosmology, _eh_table)


def main(out):
    import jax
    jax.config.update("jax_platforms", "cpu")
    from shenqi_tpu.cli.gadget_main import run_gadget
    from shenqi_tpu.cli.genic_main import run_genic
    from shenqi_tpu.io.snapshot import read_snapshot
    from shenqi_tpu.utils import constants as C
    os.makedirs(out, exist_ok=True)
    pk, tk = os.path.join(out, "pk.txt"), os.path.join(out, "tk.txt")
    _eh_table(pk)
    _class_tk_table(tk, _dm_small_cosmology(), 0.01)
    gp = os.path.join(out, "p.genic")
    with open(gp, "w") as f:
        f.write(_GENIC_GAS.format(out=os.path.join(out, "ics"), ng=8, pk=pk,
                                  tk=tk, dtf=1))
    ic = run_genic(gp)
    run = os.path.join(out, "run")
    pf = os.path.join(out, "p.gadget")
    with open(pf, "w") as f:
        f.write(_GADGET_GAS.format(ic=ic, out=run, outputs="0.01,0.011",
                                   a=0.011))
    run_gadget(pf)
    with open(pf, "w") as f:
        f.write(_GADGET_GAS.format(ic=ic, out=run, outputs="0.01,0.011,0.012",
                                   a=0.012))
    sim = run_gadget(pf, 1, max_steps=1, mesh_devices=2)
    a = sim.atime()
    f = sim.fields
    gas = (np.asarray(f["ptyp"]) == 0) & (np.asarray(f["mass"]) > 0)
    ent = np.asarray(f["entropy"], np.float64)[gas]
    egy = np.asarray(f["egywt"], np.float64)[gas]
    u = ent * (egy / a ** 3) ** C.GAMMA_MINUS1 / C.GAMMA_MINUS1
    u0 = (C.BOLTZMANN * 2.7255 / a / (4.0 / (1 + 3 * C.HYDROGEN_MASSFRAC))
          / C.PROTONMASS / C.GAMMA_MINUS1 / 1e10)
    _, b = read_snapshot(os.path.join(run, "PART_001"))
    u_snap = float(np.median(b[0]["InternalEnergy"]))
    print(f"JAX --mesh 2 resume from a = 0.011, one step to a = {a:.6f}: "
          f"median gas u / u0(a) = {np.median(u) / u0:.6f}, the snapshot's "
          f"u / u0(a) = {u_snap / u0:.6f}")


if __name__ == "__main__":
    main(sys.argv[1])
