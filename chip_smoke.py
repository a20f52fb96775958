#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (shenqi_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                  # on a machine with a card
    python3 chip_smoke.py --cpu-rehearsal  # tiny sizes, plain versions, CPU
    python3 chip_smoke.py --steps-log steps.jsonl  # also keep dm-small's steps

Phases, one line each (with seconds since start), in a hard budget of
BUDGET_S for the whole run, the kernel build included:

  env     card name and power limit (nvidia-smi), torch, CUDA, nvcc,
          whether triton imports
  build   nvcc of csrc/*.cu into C-ABI libraries; ptxas registers,
          shared memory and spills per kernel instantiation
  kernel  every launch shape (nb, blk, S) of one stencil pass at 128^3,
          the per-target fallback's shape (blk 1) and blk 128, with and
          without the potential: p2p_blocked against
          p2p_blocked_reference, two launches of the same inputs
          compared bit for bit, and the kernel timed against its bound
          (counted from the live pairs inside and past the window) and
          the issue floor; the pass's sums; the window degree, the
          kernel instantiation, and the compiled-in degree timed
          against the run-time-degree kernel
  parity  the slice at 32^3, mesh 64, 2 steps, once through the kernel
          and once through the plain version; trajectory limits of
          tests/test_torch_simulation.py; FOF labels of a 32^3 clustered
          state with halos on the card (with the pairs within b kept,
          and with the pass run again each iteration) and through the
          CPU path, equal
  slice   the main path: 128^3 clustered particles, box 50000, mesh 256,
          stencil engine, Simulation.from_arrays(device="cuda").run(3);
          kernel launches counted per step, stage times per step
  cli     the two CLIs as a user runs them, at 128^3 (box 128000 kpc/h,
          dm-small's cosmology, an analytic Eisenstein-Hu table):
          genic_main, gadget_main RestartFlag 4 (P(k) of the ICs), 2 (a
          run to a = 0.11 at the CLI defaults: hierarchical gravity, the
          random offset, HCI, snapshot and FOF) and 3 (FOF of PART_000,
          and of a clustered snapshot with halos); per step the occupied
          bins, each force call (full pass or active-source level) with
          its targets, launches and seconds, and the stages; FOF and I/O
          rates, FOF's peak device memory, and the checks of each
          output; every launch shape the run gave the pair kernel
          against the plain version, a second launch's bits and its
          bound, as in `kernel`
  mesh    (run after `bh`, whose directory holds the `stars` output; the
          `cli` and `gas` outputs stay until the end) gadget_main --mesh
          1 on cli's ICs and paramfile:
          the slab run (exchange, pencil-FFT PM, slab stencil, slab FOF,
          sharded snapshot) on one spawned rank through NCCL (gloo in the
          rehearsal); the backend, per step the exchange's rows, each
          force call's targets, ghosts and seconds, the stages, the
          collectives, seconds per step beside cli's; checks against
          cli's output: the step count, positions by ID within 2e-5 of
          the box, every P(k) file to rtol 1e-4; then, in the same rank,
          gadget_main --mesh 1 RestartFlag 2 from cli's clustered
          snapshot with halos, whose first force pass and snapshot write
          the slab FOF's PIG through the run's own on_snapshot, against
          the single-device FOF of that snapshot on a tree of the run's
          depth (group count, masses to rtol 5e-3, under 10% of lengths
          differing), cli's RestartFlag 3 PIG of it printed beside
          (ROADMAP C.6); then the `gas` phase's travis-hydro ICs and
          paramfile under --mesh 1 to its first output, 0.01
          (MESH_GAS_RUN; the slab SPH: density loop, IC fixed point,
          hydro, the gas blocks), its gas rows and ghosts, hsml-loop
          iterations, fixed-point iterations and SPH seconds, its PART
          by ID against `gas`'s at tests/test_slab_gas.py's limits, P(k)
          and PIGs beside `gas`'s; then the `stars` output at
          0.1178 resumed under --mesh 1 with `bh`'s paramfile
          (BlackHoleOn, the UVFluctuationFile, ofjt10 winds,
          MetalReturnOn) and MESH_SUB_SF to the outputs 0.1179 and
          0.1181 (MESH_SUB_RUN: the PM step that ends at 0.1179 runs
          the seeding FOF and gives the winds their speed; every slab
          source stage): stars formed (split and whole printed), wind kicks, the
          velocity dispersion on a PM step, a BH seeded at the seed mass
          and accreting, no entropy lowered by the feedback, the total
          mass within 1e-6, every field finite, every star and BH in the
          PIG; per step its SPH passes, eEOS rows, the Cooling, BH and
          MetalReturn seconds beside `bh`'s at the same a, each source
          stage's gathered pack and collectives; every launch shape the
          four runs gave the pair kernel against the plain version, as
          in `cli`; and --mesh 2 refused on a one-card host
  dmsmall dm-small as its paramfile stands but for its end: 64^3, box
          64000 kpc/h, mesh 128, z = 9 to a = 0.15 (0.25 in dm-small)
          with FOF at 0.15 (the EH table for its CLASS one); the bins
          and level calls over the
          run, the cost of a level call by its targets, host syncs per
          step (torch's sync debug mode), each FOF's groups, stages and
          peak memory, the momentum change, and every launch shape
          against the plain version
  nu      the neutrino configuration of tests/test_genic_nu.py at 128^3
          CDM + 64^3 neutrino particles, mesh 256, on a written CLASS-
          layout transfer table: genic_main (mass split, thermal speeds),
          RestartFlag 4 (P(k) of the ICs against the mass-weighted
          input), a MassiveNuLinRespOn run to the first output and a
          RestartFlag 1 resume from it for one step (one delta_tot column
          per PM step, the history restored and carried on), the host
          cost of the response per PM step, and every launch shape
          against the plain version
  gas     travis-hydro (validation/travis.py:38-98 with the subgrid
          switches off): 64^3 gas + 64^3 DM, box 128 Mpc/h, z = 99 to
          a = 0.015 with outputs and FOF at 0.01, 0.012, 0.015, on the EH
          table and a CLASS-layout transfer table (DifferentTransfer-
          Functions 1): genic_main with ProduceGas, RestartFlag 4, the run
          (hierarchical gravity, pressure-entropy SPH, quintic kernel) and
          a RestartFlag 1 resume to 0.017 with CoolingOn, MetalCoolingOn
          and a MetalCoolFile (GAS_RESUME_COOLING: the pure-cooling
          branch, the only one that reads the table), its metal lookup
          checked to run; each species' P(k) at each
          output against its linear spectrum (CDM 4%, baryons 12%), the
          gas fields finite and positive, adiabatic cooling of the median
          InternalEnergy (5%), the IC entropy fixed point's convergence,
          the momentum; per step the stages, per SPH pass its density
          walks, cover patches, long-reach sources and hydro seconds, host
          syncs and peak memory; every launch shape against the plain
          version
  gas128  the same at 2 x 128^3 particles: genic_main, the IC entropy
          fixed point and the first loop pass, the same records
  stars   star-small (validation/star_small.py:36-77): 64^3 gas + 64^3
          DM, box 5 Mpc/h, z = 9, CoolingOn, StarformationOn, WindOn
          (ofjt10), MetalReturnOn, pressure-entropy SPH, FOF at each
          output, no TREECOOL; cuts: BlackHoleOn 0 (on in `bh`), the EH
          table for class_pk_9.dat, the run ends at STARS_RUNS' TimeMax.
          genic_main and the run; checks: stars formed (the first one's a
          printed against star-small's 0.115, STARS_FIRST_BY), sfr.txt's
          8 columns, wind kicks, metal returned, gas metallicity, total
          mass within 1e-6, every gas and star field finite (entropy,
          density positive), every star in a PIG group, every launch
          shape against the plain version; per step the stages, stars
          formed (split, whole), wind kicks, metal-return stars, host
          syncs; peak memory
  bh      star-small with BlackHoleOn 1 (every BH parameter at its
          default) and a UVFluctuationFile (_zreion_table: z_reion 6 in
          one octant, 10 elsewhere) resumed with RestartFlag 1 from the
          `stars` run's last output (a = 0.1178) to BH_RUNS' output with
          FOF, past the first PM step's seeding FOF.  The one cut: MinFoFMassForNewSeed and
          MinMStarForNewSeed lowered below the groups that hold the stars
          at 0.118 (BH_SEEDING; star-small seeds at a = 0.14-0.15).
          Checks: the star rows restored exactly at the start; BHs seeded
          at the seed mass; blackholes.txt from the seeding step with its
          count and mass; accretion (mdot > 0, mass above the seed); the
          feedback never lowering an entropy and raising some;
          BlackholeDetails.bin in the JAX record layout with the seeded
          IDs; the per-row UVB rates read at every source step, with gas
          rows on both sides of z_reion; total mass within 1e-6; every
          field finite; every BH in a PIG group and the PIG's BH count
          the run's; every launch shape against the plain version.  Printed: star-small's first
          blackholes.txt line (0.14-0.15) and PIG BH counts; per step the
          BH stage, seeds, swallowed rows, mergers, the other stages and
          host syncs; each FOF's seconds; peak memory.  The CPU rehearsal runs it at
          2 x 16^3 from the rehearsal's `stars` output (0.104) to 0.108
          with STARS_REHEARSAL's SF thresholds and BH_REHEARSAL_SEEDING
          (16^3 forms no FOF group of 8 or more: groups of 4, seeds in any
          group holding a star)
  reion   star-small with every subgrid switch: BlackHoleOn (BH_SEEDING),
          HeliumReionizationOn with a ReionHistFile, ExcursionSetReionOn
          with a J21CoeffFile (both tables written by tools/ while the
          earlier phases run) and WritePlaneOn, resumed with RestartFlag 1
          from the `bh` output (0.119) to the output 0.1193 (0.1196 too
          until the `mesh` phase's subgrid run needed the budget), the end
          of a PM step whose FOF
          runs the QSO bubbles and the excursion pass.  Cuts (REION_SWITCHES): the HeII history
          from z = 9 (the reference's starts at z 4-6), QSOMinMass 0.15
          (below the one star-holding group at 0.118), QSOMeanBubble 1
          Mpc/h (below the 5 Mpc/h box), ReionNionPhotPerBary 40000
          (4000: no cell crossed the barrier).  Checks: the star and BH
          rows restored exactly; HeIII rows at the helium FOF, no entropy
          of an ionized row lowered and no other row touched; local_j21
          never falling, gas rows with J21 > 0 after the last pass, and
          zreion_p set only where J21 > 0; both xHI in [0, 1]; three FITS
          planes at each output with NPART the
          live count; total mass within 1e-6; every field finite; every
          launch shape against the plain version.  Printed: bubbles and
          new HeIII rows per FOF, xHI and the seconds of each excursion
          pass, per step the stages and host syncs, peak memory.  The
          rehearsal resumes from its `bh` output (0.108) to 0.109 with
          QSOMinMass 0
  lc      a lensing run's last stretch on the DM path: dm-small's
          cosmology on the EH table, 64^3 in a 256 Mpc/h box (larger than
          the lightcone radius, so at most 3^3 box replicas), genic_main
          at z = 0.05, gadget_main to a = 0.96 with FOF at 0.955 and 0.96,
          LightconeOn and WritePlaneOn with two 20 Mpc/h slabs, one
          wrapping the box's edge (LC_PLANES).  Checks: every Aemit within
          its drift's (a0, a1], every crossing's distance within [R(a1),
          R(a0)], the LIGHTCONE blocks in the JAX layout; at each of the
          twelve deposits the counts summing to n_plane, which lies
          between 0 and the live count and equals a float64 host count
          of the slab, and the FITS NPART those counts; every launch
          shape against the plain version.  Printed: the lightcone's host
          seconds per drift
  erfc    ShortRangeForceWindowType erfc (ROADMAP A.12) on `lc`'s 64^3
          ICs to LC_RUNS' outputs without LightconeOn and WritePlaneOn:
          the pair kernel's erfc instantiation on every force call;
          checks: the run's window, every launch shape against the plain
          version with and without the potential (2e-4, the same bits
          twice), the final positions beside `lc`'s (the calibrated
          window) within ERFC_VS_EXACT of the box, finite P(k).  Printed:
          each shape's ms, f32 bound and issue floor
  writer  `lc`'s last snapshot written again through the C++ block
          writer (native/bigfile_io.cpp, built into _build/) and the
          numpy writer, every file byte-identical to each other and to
          the run's own snapshot; seconds and MB/s of each writer (page
          cache, no fsync)
  field   genic's scheme="fast" Gaussian field at 128^3 on the card
          against the same call on the CPU within 1e-5 of max |g|, with
          the seconds of each
  profile where the time goes in one full force pass at that size
          (host-clock stages); outside the counted main path

It ends with a `kernels:` line (each main path's launches, `cli`,
`mesh`, `slice`, `dmsmall`, `nu`, `gas`, `gas128`, `stars`, `bh`, `reion`,
`lc` and `erfc`, with the row of its largest launch shape),
the JSON kernel table (the `cli` run's launches and largest shape, and
the erfc instantiation's from the `erfc` run), the
card's name and power limit, and the run's result as one JSON object.
`--steps-log PATH` appends dm-small's per-step record (bins, force
calls, stages) to PATH as JSON lines.  It imports
neither JAX nor the JAX package, and exits non-zero if any phase fails,
if the budget runs out, if no card is present (without the rehearsal
flag), or if the port is not beside it.
"""

from __future__ import annotations

import faulthandler
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

BUDGET_S = 560.0
# the CPU rehearsal runs the plain versions on a shared host: it checks
# the script's flow, not its time, so it has a budget of its own
REHEARSAL_BUDGET_S = 1500.0
# travis-hydro (validation/travis.py:38-98): z = 99 to TimeMax 0.015 with
# its three outputs, then a resume from the last one with a later output;
# at 128^3 the IC fixed point and the first loop pass (3 until the
# `stars` phase needed the budget)
GAS_A_IC = 0.01
GAS_RUNS = (("0.01,0.012,0.015", 0.015),
            ("0.01,0.012,0.015,0.016,0.017", 0.017))
# the resume cools with metal lines (_metal_cool_table): its first step
# after the restart takes no source step, so it runs to 0.017 (one step
# to 0.016 until the review repair)
GAS_RESUME_COOLING = "MetalCoolingOn = 1\nMetalCoolFile = {metal}\n"
# the `mesh` phase's travis-hydro run under --mesh 1, its outputs a
# prefix of the `gas` run's: to the first output, the ICs' force pass
# with the IC fixed point, since the phase took its subgrid run (to the
# second output, 0.012, the script took 453.1 s on an H100; with the
# subgrid run it reached 476.2 s at the end of `mesh`, ~503 s in all; to
# 0.015, as `gas`, 542.4 s; PERF.md sections 5-6); the CPU rehearsal's
# stops there too (its 2 x 32^3 SPH takes minutes a step on the CPU)
MESH_GAS_RUN = ("0.01", 0.01)
MESH_GAS_REHEARSAL_RUN = ("0.01", 0.01)
GAS128_STEPS = 1
# dm-small runs to a = 0.25 (validation/dm_small.py:44-59), here to its
# first output, 0.15, to leave the budget to `stars` and `bh` (0.25 until
# the first, 0.2 until the second); the neutrino
# run to its first output, then resumes from it for one step (a
# paramfile with a later second output, as a user extends a run): the
# outputs 0.0101 and 0.0102 since `reion` and `lc` came (0.0102 and
# 0.0104 before: the host response update grows with the history, B.5)
DMSMALL_TIMEMAX = 0.15
NU_RUNS = (("0.0101", 0.0101), ("0.0101,0.0102", 0.0102))
# star-small (validation/star_small.py:36-77) from z = 9 to the first
# output after stars have formed and metal return has acted, then a resume
# from it with a later output.  With the EH table the first star formed at
# a = 0.11669 on the card, the first metal returned at 0.11724 (its first
# runs: the star-forming gas appears at a = 0.110, where the JAX package's
# run on the reference's CLASS table had it at 0.1025,
# validation/NOTES_star_small_r2.md), so the run ends at an output past
# both, 0.1178 (0.118 until the `reion` and `lc` phases needed the budget;
# on the card the first star formed at 0.11692-0.11705 and the first
# metal returned at 0.11762); star-small's own criterion, a star
# before 0.115 (check_results.py), is printed against the run's first star
STARS_RUNS = (("0.105,0.11,0.115,0.1178", 0.1178),)
STARS_FIRST_BY = 0.115
# the CPU rehearsal's 16^3 resolves no gas dense enough for the SF
# threshold, nor halos for FOF: it lowers the thresholds, and takes the
# cubic kernel (the metal return's weight sums are cubic, ROADMAP C.4, so
# the mass balance is not blurred by the rehearsal's far more numerous
# stars), to check the flow to a = 0.104; the card runs star-small as its
# paramfile stands
STARS_REHEARSAL = ("CritPhysDensity = 1e-5\nCritOverDensity = 1.0\n"
                   "DensityKernelType = cubic\n")
STARS_REHEARSAL_RUNS = (("0.102,0.104", 0.104),)
# the `bh` phase: star-small with BlackHoleOn 1 resumed from the `stars`
# run's last output (0.1178) to the output 0.119 (0.1195 until `reion`
# took its place as the resume after it).  A PM step ends at each output
# (its length is clamped to the next sync point), so the output 0.1185
# brings the first PM step's seeding FOF.  The one cut: the seeding
# thresholds, lowered below the one FOF group that holds the run's stars
# at 0.118 (mass 0.2135, stars 2.978e-4, in 1e10 Msun/h, on the card;
# star-small's are 2 and 5e-4, and it seeds its first BHs at
# a = 0.14-0.15, past this budget; PERF.md section 4)
BH_RUNS = (("0.105,0.11,0.115,0.1178,0.1185,0.119", 0.119),)
BH_SEEDING = "MinFoFMassForNewSeed = 0.15\nMinMStarForNewSeed = 2e-4\n"
# the `mesh` phase's fourth run: `bh`'s paramfile under --mesh 1, resumed
# from the `stars` output at 0.1178 to the outputs 0.1179 and 0.1181.  A
# PM step ends at each output: the one at 0.1179, the first after the
# start, runs the seeding FOF (there rather than at `bh`'s 0.1185: the
# run to 0.1185 took 16 steps and 70.03 s on the card, the script 526 s
# in all) and the first velocity dispersion, which the wind speed needs
# (0 until then on --mesh, ROADMAP C.4), so the winds kick from 0.1179
# on (with 0.1185 the one output after the start, no star formed after
# its PM step).  Two cuts (MESH_SUB_SF), since at star-small's rate two
# stars formed from 0.1169 to 0.1178: MaxSfrTimescale 1.5 -> 0.015 with
# CritPhysDensity pinned at the 0.223 H/cm^3 that star-small derives at
# 1.5 (the derived threshold scales with 1/MaxSfrTimescale: at 0.015 no
# row reached it), 8 stars by 0.1181 on the card, and Generations 4 ->
# 2, so that a row that split once converts whole at its next (PERF.md
# section 6).  The rehearsal runs from its `stars` output (0.104) to
# 0.108, past a second PM step
MESH_SUB_RUN = ("0.105,0.11,0.115,0.1178,0.1179,0.1181", 0.1181)
MESH_SUB_REHEARSAL_RUN = ("0.102,0.104,0.106,0.108", 0.108)
MESH_SUB_SF = ("MaxSfrTimescale = 0.015\nCritPhysDensity = 0.223\n"
               "Generations = 2\n")
# the rehearsal's 16^3: the slab FOF links every type within 0.2 mean
# separations (the single-device FOF attaches gas to the nearest DM or
# star farther out), which there holds no star; at 0.5 a few groups do,
# so the seeding runs (most stars stay outside groups: that check is the
# card's)
MESH_SUB_REHEARSAL_FOF = "FOFHaloLinkingLength = 0.5\n"
# the rehearsal's 16^3 forms no FOF group of 8 members or more: its `bh`
# phase links groups of 4 and seeds in any group with a star
BH_REHEARSAL_RUNS = (("0.102,0.104,0.106,0.108", 0.108),)
BH_REHEARSAL_SEEDING = ("FOFHaloMinLength = 4\nMinFoFMassForNewSeed = 0.1\n"
                        "MinMStarForNewSeed = 1e-5\n")
# the `reion` phase: star-small with every subgrid switch (BlackHoleOn with
# BH_SEEDING, HeliumReionizationOn with a ReionHistFile, ExcursionSetReionOn
# with a J21CoeffFile, WritePlaneOn) resumed from the `bh` run's output
# 0.119 to the output 0.1193 (0.1196 too until the `mesh` phase's
# subgrid run needed the budget): it ends a PM step, whose FOF
# runs the QSO bubbles and after which the excursion pass runs.  Cuts
# (PERF.md section 4): the HeII history linear from z = HEII_Z[0] = 9
# (above the run's z = 7.3; the reference's starts at z 4-6) to 6;
# QSOMinMass 0.15 (default 100, in 1e10 Msun/h), below the one group that
# holds stars at 0.118 (0.2135); QSOMeanBubble 1000 kpc/h, below the
# 5 Mpc/h box (default 20 Mpc/h); ReionNionPhotPerBary 4000 -> 40000, so
# that the cells around the box's few star-holding groups cross the
# excursion barrier fcoll > 1/ReionEfficiency by a = 0.1193 (at 4000 none
# did: xHI 0.998 by volume, PR 11 call 1; star-small's 5 Mpc/h holds 5-7
# stars then).  UVFluctuationFile is the `bh` phase's, since the J21
# rates take precedence over it here, and MetalCoolFile the `gas`
# resume's, since a run with star formation never reads it (in both
# packages).  The rehearsal's 16^3 groups are far lighter: QSOMinMass 0
# there
REION_RUNS = ((BH_RUNS[0][0] + ",0.1193", 0.1193),)
REION_REHEARSAL_RUNS = ((BH_REHEARSAL_RUNS[0][0] + ",0.1085,0.109", 0.109),)
REION_SWITCHES = """HeliumReionizationOn = 1
ReionHistFile = {heii}
QSOMinMass = {qmin}
QSOMeanBubble = 1000.0
ExcursionSetReionOn = 1
J21CoeffFile = {j21}
ReionNionPhotPerBary = 40000.0
WritePlaneOn = 1
"""
# the `lc` phase: a lensing run's last stretch on the DM path, dm-small's
# cosmology on the EH table at 64^3 in a 256 Mpc/h box (larger than the
# lightcone radius R(a) at a = 0.952, ~156 Mpc/h, so the replica loop
# spans at most (2 x 1 + 1)^3 boxes), genic_main at z = 0.05, gadget_main
# to a = 0.96 with FOF, the lightcone and the planes at 0.955 and 0.96:
# two slabs 20 Mpc/h thick, one about the box's middle and one about
# 250 Mpc/h, which wraps the box's edge
LC_BOX = 256000.0
LC_Z_IC = 0.05
LC_RUNS = ("0.955,0.96", 0.96)
LC_PLANES = "PlaneThickness = 20000.0\nPlaneCutPoints = 128000,250000\n"
# the erfc run's final positions beside the lc run's (the calibrated
# window): the two windows differ by a few 1e-3 of the short-range force
# near rcut (gravity/window.py), which moves no particle by 1e-4 of the
# box between a = 0.95 and 0.96
ERFC_VS_EXACT = 1e-4
FIELD_SEED, FIELD_N = 181170, 128
# star-small's own criteria this depth cannot reach (check_results.py):
# the first blackholes.txt line, and the PIG BH counts at 0.125/0.15/0.2
BH_FIRST_LINE = (0.14, 0.15)
BH_PIG_COUNTS = ((0.125, 0), (0.15, 3), (0.2, 4))
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores (SXM data sheet)
H100_BYTES_S = 3.35e12       # HBM3
# the clock of that f32 rate: 132 SMs x 128 FMA lanes x 2 flops
H100_CLOCK = H100_F32_FLOPS / (132 * 128 * 2)
H100_ISSUE_S = 132 * 128 * H100_CLOCK   # thread-instructions/s, 4 x 32 per SM
H100_XU_S = 132 * 16 * H100_CLOCK       # converts and rsqrt, 16 per SM
T0 = time.perf_counter()


class SmokeFailure(RuntimeError):
    pass


def elapsed() -> float:
    return time.perf_counter() - T0


def say(phase: str, msg: str):
    print(f"[{phase} {elapsed():7.2f}s] {msg}", flush=True)


def check_budget(where: str, budget: float = BUDGET_S):
    if elapsed() > budget:
        raise SmokeFailure(f"time budget of {budget:.0f} s spent at {where}")


def _clustered(npart_side, box, seed=181170):
    """Clustered particle set of bench.py:45-83: Zel'dovich displacements
    from a CDM-like spectrum boosted to rms ~1.5 cells (first shell
    crossings), deterministic from the seed."""
    n = npart_side
    rng = np.random.RandomState(seed)
    white = rng.normal(size=(n, n, n)).astype(np.float32)
    gk = np.fft.rfftn(white) / n ** 1.5
    kx = np.fft.fftfreq(n, 1.0 / n)[:, None, None]
    ky = np.fft.fftfreq(n, 1.0 / n)[None, :, None]
    kz = np.arange(n // 2 + 1)[None, None, :]
    k2 = kx ** 2 + ky ** 2 + kz ** 2
    k2[0, 0, 0] = 1.0
    kmag = np.sqrt(k2) * (2 * np.pi / box)
    keq = 8 * 2 * np.pi / box
    pk = kmag / (1.0 + (kmag / keq) ** 3.4)
    amp = np.sqrt(pk)
    amp[0, 0, 0] = 0.0
    cell = box / n
    kf = 2 * np.pi / box
    disp = []
    for kj in (kx, ky, kz):
        dk = gk * amp * (1j * kj * kf) / (k2 * kf * kf)
        disp.append(np.fft.irfftn(dk, s=(n, n, n), axes=(0, 1, 2)).real
                    * n ** 3)
    disp = np.stack([d.ravel() for d in disp], -1)
    rms = np.sqrt(np.mean(disp ** 2))
    disp *= 1.5 * cell / max(rms, 1e-30)
    grid = (np.arange(n) + 0.5) * cell
    X, Y, Z = np.meshgrid(grid, grid, grid, indexing="ij")
    pos = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1) + disp
    return pos % box


def _with_halos(pos, box, seed=181170, frac=0.25):
    """`_clustered` positions with compact halos added: at b = 0.2 mean
    separations the Zel'dovich state alone links almost nothing (1.05
    links per particle and no 32-member group at 32^3 and 64^3), so a
    quarter of the particles, chosen from the seed, are moved into
    Gaussian clumps of 32-1024 members (radius 0.15 mean separations)
    for FOF to find."""
    rng = np.random.RandomState(seed + 1)
    n = len(pos)
    sep = box / np.cbrt(n)
    pos = pos.copy()
    idx = rng.permutation(n)[:int(frac * n)]
    sizes = np.minimum((32 * rng.pareto(1.0, len(idx) // 32 + 1) + 32)
                       .astype(np.int64), 1024)
    ends = np.cumsum(sizes)
    sizes = sizes[:np.searchsorted(ends, len(idx))]
    cen = rng.uniform(0, box, (len(sizes), 3))
    k = min(int(sizes.sum()), len(idx))
    which = np.repeat(np.arange(len(sizes)), sizes)[:k]
    pos[idx[:k]] = cen[which] + rng.normal(0, 0.15 * sep, (k, 3))
    return pos % box


# dm-small's cosmology (validation/dm_small.py:24-42) with an analytic
# Eisenstein-Hu table in place of its CLASS one (WhichSpectrum 2, Sigma8
# -1, InputPowerRedshift 0: the table's z = 0 amplitude is grown back to
# the ICs, ROADMAP A.4); tests/test_torch_cli.py and
# tests/test_torch_imports.py write their paramfiles from these too
_GENIC = """
OutputDir = {out}/IC
FileBase = IC
Ngrid = {ng}
BoxSize = {box}
Omega0 = 0.288
OmegaLambda = 0.712
OmegaBaryon = 0.0472
HubbleParam = 0.7
ProduceGas = 0
Redshift = 9
WhichSpectrum = 2
FileWithInputSpectrum = {pk}
Sigma8 = -1
InputPowerRedshift = 0
DifferentTransferFunctions = 0
UsePeculiarVelocity = 1
Seed = 181170
UnitaryAmplitude = 1
"""

# everything else at its default: hierarchical gravity
# (SplitGravityTimestepsOn 1), the random offset (8 cells) and HCI are on
_GADGET = """
InitCondFile = {ic}
OutputDir = {out}
OutputList = {a}
TimeMax = {a}
Omega0 = 0.288
MassiveNuLinRespOn = 0
HydroOn = 0
CoolingOn = 0
StarformationOn = 0
BlackHoleOn = 0
MetalReturnOn = 0
WindOn = 0
SnapshotWithFOF = {fof}
Nmesh = {nmesh}
"""


# the neutrino configuration of tests/test_genic_nu.py (three 0.1333 eV
# species, z = 99, box 300000 kpc/h) with the EH table and a written
# CLASS-layout transfer table (_class_tk_table) in place of the
# reference's CLASS files; tests/test_torch_genic_nu.py writes its
# paramfile from it too
_GENIC_NU = """
OutputDir = {out}/IC
FileBase = IC
Ngrid = {ng}
NgridNu = {ngnu}
BoxSize = 300000
Omega0 = 0.288
OmegaLambda = 0.712
OmegaBaryon = 0.0472
ProduceGas = 0
HubbleParam = 0.7
Redshift = 99
MNue = 0.133333333333
MNum = 0.133333333333
MNut = 0.133333333333
WhichSpectrum = 2
FileWithInputSpectrum = {pk}
Sigma8 = -1
InputPowerRedshift = 0
FileWithTransferFunction = {tk}
DifferentTransferFunctions = 1
UsePeculiarVelocity = 1
Seed = 181170
UnitaryAmplitude = 1
"""

# the lines a gadget_main paramfile adds to _GADGET for that
# configuration's run with the neutrino linear response
_GADGET_NU = """MNue = 0.133333333333
MNum = 0.133333333333
MNut = 0.133333333333
FileWithTransferFunction = {tk}
"""


# star-small (validation/star_small.py:36-77) as the port runs it: the EH
# table for class_pk_9.dat (normalized as dm-small's), BlackHoleOn 0
# (ROADMAP A.8), no TreeCoolFile as in the example; the shortened
# OutputList and TimeMax are STARS_RUNS'
_GENIC_STARS = """
OutputDir = {out}/IC
FileBase = IC
Ngrid = {ng}
BoxSize = 5000
Omega0 = 0.288
OmegaLambda = 0.712
OmegaBaryon = 0.0472
ProduceGas = 1
HubbleParam = 0.7
Redshift = 9
WhichSpectrum = 2
FileWithInputSpectrum = {pk}
Sigma8 = -1
InputPowerRedshift = 0
DifferentTransferFunctions = 0
UsePeculiarVelocity = 1
Seed = 181170
UnitaryAmplitude = 1
"""

_GADGET_STARS = """
InitCondFile = {ic}
OutputDir = {out}
OutputList = {outputs}
TimeLimitCPU = 43000
TimeMax = {a}
Omega0 = 0.288
MassiveNuLinRespOn = 0
HydroOn = 1
CoolingOn = 1
StarformationOn = 1
DensityIndependentSphOn = 1
SnapshotWithFOF = 1
PartAllocFactor = 2.0
BlackHoleOn = 0
MetalReturnOn = 1
WindOn = 1
"""

# the reference's travis CI example (validation/travis.py:38-98) as the
# port runs it: adiabatic gas (the subgrid switches off, their files
# dropped), the EH table for class_pk_99.dat and _class_tk_table at z = 99
# for class_tk_99.dat, normalized as the `nu` phase's;
# tests/test_torch_gas.py writes its paramfiles from these too
_GENIC_GAS = """
OutputDir = {out}/IC
FileBase = IC
Ngrid = {ng}
BoxSize = 128.0
Omega0 = 0.288
OmegaLambda = 0.712
OmegaBaryon = 0.0472
ProduceGas = 1
HubbleParam = 0.7
Redshift = 99
WhichSpectrum = 2
FileWithInputSpectrum = {pk}
Sigma8 = -1
InputPowerRedshift = 0
FileWithTransferFunction = {tk}
DifferentTransferFunctions = {dtf}
UsePeculiarVelocity = 1
Seed = 181170
UnitaryAmplitude = 1
UnitLength_in_cm = 3.085678e24
UnitMass_in_g = 1.989e43
UnitVelocity_in_cm_per_s = 1e5
"""

_GADGET_GAS = """
InitCondFile = {ic}
OutputDir = {out}
OutputList = {outputs}
SplitGravityTimestepsOn = 1
TimeLimitCPU = 43000
TimeMax = {a}
Omega0 = 0.288
OmegaLambda = 0.712
OmegaBaryon = 0.0472
HubbleParam = 0.7
HydroOn = 1
CoolingOn = 0
StarformationOn = 0
RadiationOn = 1
DensityIndependentSphOn = 1
MetalReturnOn = 0
MassiveNuLinRespOn = 0
SnapshotWithFOF = 1
FOFHaloLinkingLength = 0.2
FOFHaloMinLength = 32
PartAllocFactor = 2.0
BlackHoleOn = 0
WindOn = 0
"""


def _nu_cosmology():
    from shenqi_tpu_torch.cosmology.background import Cosmology
    from shenqi_tpu_torch.utils.units import default_units
    cp = Cosmology(Omega0=0.288, OmegaLambda=0.712, OmegaBaryon=0.0472,
                   HubbleParam=0.7, RadiationOn=1, MNu=(0.133333333333,) * 3)
    cp.init(0.01, default_units())
    return cp


def _dm_small_cosmology():
    from shenqi_tpu_torch.cosmology.background import Cosmology
    from shenqi_tpu_torch.utils.units import default_units
    cp = Cosmology(Omega0=0.288, OmegaLambda=0.712, OmegaBaryon=0.0472,
                   HubbleParam=0.7, RadiationOn=1)
    cp.init(0.1, default_units())
    return cp


def _sigma8(power):
    """Top-hat sigma(8 Mpc/h) of an InputPower (either package's) at its
    current norm, integrated from k = 1e-5 h/Mpc: InputPower.normalize's
    own integral (_tophat_sigma) keeps the reference's k-grid slip
    (ROADMAP C.4), so the tables here are normalized by this one."""
    R = 8.0 * power.mpc_scale
    k = np.logspace(np.log10(1e-5 / power.mpc_scale), np.log10(500.0 / R),
                    8192)
    kr = R * k
    w = 3 * (np.sin(kr) / kr ** 3 - np.cos(kr) / kr ** 2)
    return np.sqrt(np.trapezoid(4 * np.pi / (2 * np.pi) ** 3 * k * k
                                * (w * power.delta_spec(k)) ** 2, k))


def _eh_table(path):
    """Write k [h/Mpc], P [(Mpc/h)^3] of the analytic EH spectrum at
    z = 0 in dm-small's cosmology, normalized to sigma8 = 0.8; returns
    it."""
    from shenqi_tpu_torch.cosmology.power import InputPower
    from shenqi_tpu_torch.utils.units import default_units
    power = InputPower.analytic_eh(_dm_small_cosmology(),
                                   default_units().UnitLength_in_cm)
    power.norm = 0.8 / _sigma8(power)
    kt = np.logspace(-4, 2, 600)
    table = np.c_[kt, (power.delta_spec(kt / power.mpc_scale)
                       / power.mpc_scale ** 1.5) ** 2]
    np.savetxt(path, table)
    return table


def _class_tk_table(path, cp, time_ic):
    """Write a transfer table in the layout of CLASS's `format = class`
    output with the extra metric columns (22 columns; what
    InputPower.load_transfer and gadget_main._build_nu_table read),
    synthetic but consistent: at the ICs baryons lag the CDM below 0.05
    h/Mpc, the three neutrino species free-stream below k_fs = 0.05
    h/Mpc (delta_nu = delta_cdm / (1 + (k/k_fs)^2)), and the velocity
    columns give each species f(a) times its own delta, so that
    dlog_growth / delta_spec = f.  `cp` is the port's Cosmology at
    `time_ic`.  Returns the table."""
    from shenqi_tpu_torch.utils.constants import LIGHTCGS
    k = np.logspace(-4, 2, 400)
    d_cdm = 1.0 / (1.0 + (k / 0.2) ** 2) ** 0.8
    d_b = d_cdm * (1.0 - 0.3 * k ** 2 / (k ** 2 + 0.05 ** 2))
    d_nu = d_cdm / (1.0 + (k / 0.05) ** 2)
    fac = (time_ic * cp.hubble_function(time_ic) / cp.Hubble
           * 100 * cp.HubbleParam / (LIGHTCGS / 1e5))
    f = cp.F_Omega(time_ic)
    t = np.zeros((len(k), 21))
    t[:, 0] = -d_cdm                 # photons: unread
    t[:, 1], t[:, 2], t[:, 3] = -d_b, -d_cdm, -d_nu
    t[:, 4:7] = -d_nu[:, None]       # the three massive species
    t[:, 8] = -d_cdm                 # total: unread
    t[:, 11] = 2 * fac * f * d_cdm   # h': v_cdm = h'/2 / fac
    t[:, 15] = fac * f * (d_b - d_cdm)               # t_b: v_b - v_cdm
    t[:, 16:19] = (fac * f * (d_nu - d_cdm))[:, None]  # t_ncdm
    table = np.c_[k, t]
    np.savetxt(path, table)
    return table


def _zreion_table(path, box_mpc, nside=8):
    """A UV fluctuation bigfile (the Zreion_Table block and its
    Nmesh/BoxSize/Redshift attributes, tests/test_uvfluc_helium.py:18-31):
    z_reion = 6 in one octant of the box, 10 elsewhere."""
    from shenqi_tpu_torch.io.bigfile import BigFile
    tab = np.full((nside, nside, nside), 10.0)
    tab[: nside // 2, : nside // 2, : nside // 2] = 6.0
    bf = BigFile(str(path), create=True)
    blk = bf.create_block("Zreion_Table", "<f8", nside ** 3, nmemb=1)
    blk.write(0, tab.ravel())
    blk.attrs["Nmesh"] = np.array([nside], dtype="u8")
    blk.attrs["BoxSize"] = np.array([box_mpc], dtype="f8")
    blk.attrs["Redshift"] = np.array([7.5], dtype="f8")
    blk.flush()
    return str(path)


def _metal_cool_table(path):
    """A MetalCool bigfile (tests/test_uvfluc_helium.py:61-78's blocks):
    a made-up smooth NetCoolingRate (erg/s/g at solar Z) on an uneven
    (z, log nH, log T) grid, changing at most half a dex per unit of
    log nH or log T."""
    from shenqi_tpu_torch.io.bigfile import BigFile
    zb = np.array([0.0, 1.0, 2.5, 4.0, 6.0, 9.0, 12.0])
    nb = np.array([-8.0, -7.0, -6.2, -5.0, -4.0, -3.0, -2.1, -1.0, 0.0, 1.0,
                   2.0, 3.0])
    tb = np.array([1.0, 2.5, 3.5, 4.0, 4.5, 5.0, 5.5, 6.5, 8.0, 9.5])
    Z, N, T = np.meshgrid(zb, nb, tb, indexing="ij")
    rate = (3e2 * 10 ** (0.5 * N) * (1 + 0.05 * Z)
            * 10 ** (-0.3 * np.abs(T - 5.2)) * (1 + 0.2 * np.sin(T)))
    bf = BigFile(str(path), create=True)
    for name, data in [("MetallicityInSolar_bins", np.array([0.0])),
                       ("Redshift_bins", zb),
                       ("HydrogenNumberDensity_bins", nb),
                       ("Temperature_bins", tb),
                       ("NetCoolingRate", rate.ravel())]:
        blk = bf.create_block(name, "<f8", len(data), nmemb=1)
        blk.write(0, data)
        blk.flush()
    return str(path)


# the repo's own table generators (tools/): a HeII reionization history
# (linear in z from HEII_Z[0] to HEII_Z[1], HEII_NUMZ rows) and a J21
# coefficient table, written in process instead of the reference's
# examples/HeIIReionizationTable and J21_to_rates files
_TOOLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
HEII_Z = (9.0, 6.0)
HEII_NUMZ = 4


def _start_tables(heii_path, j21_path, z=HEII_Z, numz=HEII_NUMZ):
    """Start the generators of the tables whose path is given (the HeII
    history integrates its heating rate with scipy's dblquad, ~4 s a row
    on one core); returns their processes."""
    cmds = []
    if heii_path is not None:
        cmds.append([sys.executable,
                     os.path.join(_TOOLS, "HeII_input_file_maker.py"),
                     "--alphaq", "1.7", "--hist", "linear", "--z_i",
                     str(z[0]), "--z_f", str(z[1]), "--numz", str(numz),
                     "--outfile", str(heii_path)])
    if j21_path is not None:
        cmds.append([sys.executable,
                     os.path.join(_TOOLS, "make_j21coefftable.py"), "-o",
                     str(j21_path)])
    return [subprocess.Popen(c, stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE, text=True)
            for c in cmds]


def _wait_tables(procs, timeout=300):
    for pr in procs:
        try:
            _, err = pr.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            pr.kill()
            pr.communicate()
            raise SmokeFailure(f"{pr.args[1]} did not finish in {timeout} s")
        if pr.returncode:
            raise SmokeFailure(f"{pr.args[1]} failed: {err.strip()[-300:]}")


def _reion_tables(heii_path, j21_path, **kw):
    """Write the tables whose path is given; returns both paths."""
    _wait_tables(_start_tables(heii_path, j21_path, **kw))
    return (None if heii_path is None else str(heii_path),
            None if j21_path is None else str(j21_path))


def _bin_span(bins):
    """'35-38 (4)' for the occupied timebins of a step."""
    if not bins:
        return "-"
    return f"{min(bins)}-{max(bins)} ({len(bins)})"


def _histogram(seq):
    """'{1: 90, 2: 50}': how often each value occurs."""
    vals, counts = np.unique(np.asarray(seq), return_counts=True)
    return "{" + ", ".join(f"{v}: {c}" for v, c in zip(vals, counts)) + "}"


def _calls_line(calls):
    """One step's force calls: kind, targets, launches, seconds."""
    return " | ".join(f"{kind} {n} ({l} launches, {sec:.3f} s)"
                      for kind, n, l, sec in calls) or "none"


def _cpu_steps(path):
    """[(a, {stage: seconds})] per step from a cpu.txt."""
    steps = []
    with open(path) as f:
        for line in f:
            m = re.match(r"Step \d+, Time: (\S+),", line)
            if m:
                steps.append((float(m.group(1)), {}))
            elif steps and line.startswith("    "):
                name, sec = line.split()[:2]
                steps[-1][1][name] = float(sec)
    return steps


def _fof_line(fs):
    """One FOF call's stages and counts (fof.FOFStats)."""
    it = max(fs.iterations, 1)
    kept = ("more than fof._MAX_LINKS links: the pass ran again in each "
            "iteration" if fs.repass else f"{fs.links} links kept")
    return (f"FOF tree {fs.tree_s:.3f} s, traversal {fs.traverse_s:.3f} s "
            f"({fs.blocks} blocks, {fs.leaves} leaves), pair pass "
            f"{fs.pairs_s:.3f} s ({fs.pair_lanes} pair lanes, {kept}), "
            f"{fs.iterations} iterations {fs.iterate_s:.3f} s "
            f"({1e3 * fs.iterate_s / it:.2f} ms each), {fs.syncs} host "
            f"syncs, secondary attach {fs.attach_s:.3f} s, compile_groups "
            f"{fs.compile_s:.3f} s")


def _cooling_counts():
    """(solves, rate evaluations) of cooling_rates.do_cooling so far."""
    from shenqi_tpu_torch.physics.cooling_rates import do_cooling
    return do_cooling.calls, do_cooling.evaluations


def _cooling_line(c0):
    """The cooling solves since the counts c0 and their rate evaluations
    (96 a solve at the JAX package's fixed loop counts)."""
    calls, evals = (b - a for a, b in zip(c0, _cooling_counts()))
    return (f"cooling solves {calls}, rate evaluations {evals} "
            f"({evals / max(calls, 1):.1f} a solve; 96 at the fixed loop "
            f"counts)")


def _erfc_sass():
    """(the erfc window's SASS count, how it differs from the table that
    ops/p2p.py prices the erfc bound with): tools/torch_erfc_sass.py."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_erfc_sass", os.path.join(_TOOLS, "torch_erfc_sass.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.count()
    res.pop("sass")
    return res, mod.check(res)


def _run(cmd):
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({type(e).__name__})"
    return (out.stdout or out.stderr).strip()


class Smoke:
    def __init__(self, rehearsal: bool):
        import torch
        self.torch = torch
        self.rehearsal = rehearsal
        self.dev = torch.device("cpu" if rehearsal else "cuda")
        self.card = ""
        self.kernel_row = {}
        # sizes: the card runs the real ones; the rehearsal tiny ones
        self.n_kernel, self.n_slice, self.mesh_slice = (
            (32, 32, 64) if rehearsal else (128, 128, 256))
        self.n_parity, self.mesh_parity = (8, 16) if rehearsal else (32, 64)
        self.n_cli = 16 if rehearsal else 128
        self.n_dmsmall = 16 if rehearsal else 64
        self.n_nu = 16 if rehearsal else 128
        self.n_gas, self.n_gas128 = (32, 16) if rehearsal else (64, 128)
        self.cli_launches = self.dmsmall_launches = self.nu_launches = 0
        self.gas_launches = self.gas128_launches = 0
        self.n_stars = 16 if rehearsal else 64
        self.budget = REHEARSAL_BUDGET_S if rehearsal else BUDGET_S
        self.stars_launches, self.stars_row = 0, {}
        self.bh_launches, self.bh_row = 0, {}
        self.reion_launches, self.reion_row = 0, {}
        self.n_lc = 16 if rehearsal else 64
        self.lc_launches, self.lc_row = 0, {}
        self.erfc_launches, self.erfc_row = 0, {}
        self.lc_dir = None
        self.stars_dir = self.bh_dir = self.cli_dir = self.gas_dir = None
        # the cli and gas runs' paramfiles, outputs, steps and seconds,
        # for `mesh`
        self.cli_run = self.gas_run = None
        self.mesh_gas_run = MESH_GAS_REHEARSAL_RUN if rehearsal \
            else MESH_GAS_RUN
        self.mesh_sub_run = MESH_SUB_REHEARSAL_RUN if rehearsal \
            else MESH_SUB_RUN
        self.mesh_sub_start = None
        self.mesh_launches, self.mesh_row = 0, {}
        # the reionization tables, written by tools/ from the start on
        self.table_dir, self.table_procs = None, []
        self.heii = self.j21 = None
        self.cli_row, self.dmsmall_row, self.nu_row = {}, {}, {}
        self.gas_row, self.gas128_row = {}, {}
        self.steps_log = None

    # ---------------------------------------------------------------- env
    def env(self):
        torch = self.torch
        self.card = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"])
        print(self.card, flush=True)
        nvcc = "not found"
        if shutil.which("nvcc") or not self.rehearsal:
            try:
                from shenqi_tpu_torch._build import find_nvcc
                nvcc = _run([find_nvcc(), "--version"]).splitlines()[-1]
            except RuntimeError as e:
                nvcc = str(e)
        try:
            import triton  # noqa: F401
            tri = f"imports ({triton.__version__})"
        except ImportError:
            tri = "does not import"
        say("env", f"card={self.card!r} torch={torch.__version__} "
            f"cuda={torch.version.cuda} nvcc={nvcc!r} triton {tri} "
            f"device={self.dev}"
            + (f" name={torch.cuda.get_device_name(0)}"
               if not self.rehearsal else ""))

    def start_tables(self):
        """Start tools/' generators of the HeII history and the J21 table
        the `reion` phase reads; they run on the host beside the earlier
        phases."""
        import tempfile
        self.table_dir = tempfile.mkdtemp(prefix="shenqi_tables_")
        self.heii = os.path.join(self.table_dir, "HeIIReionizationTable")
        self.j21 = os.path.join(self.table_dir, "J21_to_rates.txt")
        self.table_procs = _start_tables(self.heii, self.j21)

    def close(self):
        """Stop the generators if they still run, and remove every
        directory the phases left."""
        for pr in self.table_procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
        for d in (self.table_dir, self.stars_dir, self.bh_dir, self.lc_dir,
                  self.cli_dir, self.gas_dir):
            if d:
                shutil.rmtree(d, ignore_errors=True)

    # -------------------------------------------------------------- build
    def build(self):
        if self.rehearsal:
            say("build", "skipped in the CPU rehearsal (no nvcc here)")
            return
        from concurrent.futures import ThreadPoolExecutor
        from shenqi_tpu_torch import _build
        t = time.perf_counter()
        with ThreadPoolExecutor(1) as pool:
            sass = pool.submit(_erfc_sass)
            built = _build.build_all()
            sass = sass.result()
        say("build", f"{len(built)} librar{'y' if len(built) == 1 else 'ies'}"
            f" in {time.perf_counter() - t:.2f} s "
            f"(nvcc {', '.join(f'{b.stem}: {b.seconds:.2f} s' for b in built.values())})")
        for b in built.values():
            for fn, info in _ptxas_report(b.log):
                say("build", f"{b.stem} {fn}: {info}")
        res, bad = sass
        say("build", f"erfc window SASS ({res['nvcc']}): force "
            f"{res['force_opcodes']} -> (operations, FFMA, MUFU) "
            f"{res['ERFC_FORCE']}; the potential adds "
            f"{res['pot_opcodes']} -> {res['ERFC_POT']}")
        if bad:
            raise RuntimeError("; ".join(bad))
        host = _build.build_host("bigfile_io")
        say("build", f"native/bigfile_io.cpp ({' '.join(_build.host_flags())})"
            f" in {host.seconds:.2f} s: {host.path.name}")

    # ------------------------------------------------------------- kernel
    def _make_sim(self, n_side, nmesh, box=50000.0):
        from shenqi_tpu_torch.cosmology.background import Cosmology
        from shenqi_tpu_torch.core.timeline import Timeline
        from shenqi_tpu_torch.simulation import Simulation
        from shenqi_tpu_torch.utils.units import default_units
        cp = Cosmology(Omega0=0.3, OmegaLambda=0.7, OmegaBaryon=0.05,
                       HubbleParam=0.7, CMBTemperature=2.7255, RadiationOn=1)
        cp.init(0.25, default_units())
        pos = _clustered(n_side, box)
        n = len(pos)
        mass = cp.Omega0 * cp.RhoCrit * box ** 3 / n
        vel = np.zeros((n, 3), np.float32)
        ids = np.arange(1, n + 1, dtype=np.uint64)
        return Simulation.from_arrays(
            pos, vel, np.full(n, mass, np.float32), ids, cp, box, nmesh,
            Timeline.setup([0.5], 0.25, 0.5), 0.25, device=self.dev)

    def kernel(self):
        torch = self.torch
        from shenqi_tpu_torch.gravity import stencil as st
        from shenqi_tpu_torch.gravity.treepm import get_window_tables
        from shenqi_tpu_torch.ops.p2p import (kernel_instantiation,
                                              p2p_blocked,
                                              p2p_blocked_reference)
        t = time.perf_counter()
        sim = self._make_sim(self.n_kernel, self.mesh_slice)
        sim.window_tables = w = get_window_tables(sim.gravity,
                                                  device=self.dev)
        self.sim = sim
        ncf, ncp = w.cf.shape[0], w.cp.shape[0]
        inst = ("plain version (CPU)" if self.rehearsal else
                f"{kernel_instantiation(w, False)}; with the potential "
                f"{kernel_instantiation(w, True)}")
        say("kernel", f"{sim.particles.n} clustered particles set up in "
            f"{time.perf_counter() - t:.2f} s (window degree {ncf - 1}, "
            f"potential {ncp - 1}; kernel instantiation: {inst})")
        # record the pair-kernel inputs of one stencil pass over this
        # state, one example per distinct launch shape (nb, blk, S)
        shapes = {}
        real = st.p2p_blocked

        def record(*a, **kw):
            key = (a[2].shape[0], kw["blk"], a[2].shape[1])
            shapes.setdefault(key, [0, a, dict(kw)])[0] += 1
            return real(*a, **kw)

        st.p2p_blocked = record
        try:
            p = sim.particles
            st.stencilgrav(p.ipos, torch.where(p.mask, p.mass, 0.0),
                           sim.gravity.short(), w, tier_cache={})
        finally:
            st.p2p_blocked = real
        # every launch shape of the pass, the per-target fallback's
        # shape (blk = 1, each target of the main-path tier with its
        # block's source table) and blk = 128 (the JAX blocked engine's
        # block: four sub-blocks' targets against the first one's
        # sources), each against its bound and its plain version
        main = max(shapes, key=lambda k: k[0] * k[1] * k[2])
        _, args, kw = shapes[main]
        rest = args[3:]
        tgt, src, sm = args[:3]
        nb = sm.shape[0]
        blk = kw["blk"]
        nb1 = min(nb, 32)
        one = (tgt[:nb1].reshape(nb1 * blk, 1, 3).contiguous(),
               src[:nb1].repeat_interleave(blk, 0).contiguous(),
               sm[:nb1].repeat_interleave(blk, 0).contiguous())
        nb4 = nb * blk // 128
        four = (tgt[:nb4 * 128 // blk].reshape(nb4, 128, 3).contiguous(),
                src[::128 // blk][:nb4].contiguous(),
                sm[::128 // blk][:nb4].contiguous())
        keys = sorted(shapes)
        cases = [(shapes[k][0], shapes[k][1][:3], shapes[k][2])
                 for k in keys]
        cases += [(0, one, dict(kw, blk=1)), (0, four, dict(kw, blk=128))]
        n_all = sum(v[0] for v in shapes.values())
        tot = {False: [0.0] * 3, True: [0.0] * 3}
        rows = []
        for n, ins, kwc in cases:
            inwin = self._in_window(ins, rest)
            for want_pot in (False, True):
                r = self._compare(p2p_blocked, p2p_blocked_reference, ins,
                                  rest, dict(kwc, want_pot=want_pot), inwin)
                for i, k in enumerate(("ms", "bound_ms", "floor_ms")):
                    tot[want_pot][i] += n * r[k]
                say("kernel", f"x{n} per pass: p2p_blocked " + " ".join(
                    f"{k}={v}" for k, v in r.items())
                    + f"; {100 * r['bound_ms'] / r['ms']:.1f}% of bound, "
                    f"{100 * r['floor_ms'] / r['ms']:.1f}% of issue floor")
                if not r["rel_err"] < 2e-4:
                    raise SmokeFailure(f"p2p_blocked disagrees with its "
                                       f"plain version: {r}")
                if not r["repeatable"]:
                    raise SmokeFailure(f"p2p_blocked gave other bits on a "
                                       f"second launch of the same inputs: "
                                       f"{r}")
                rows.append(r)
        for want_pot, (ms, bound, floor) in tot.items():
            say("kernel", f"one full pass, {n_all} launches, potential "
                f"{want_pot}: kernel {ms:.3f} ms against {bound:.3f} ms of "
                f"bounds ({100 * bound / ms:.1f}%) and {floor:.3f} ms of "
                f"issue floors ({100 * floor / ms:.1f}%)")
        # the degree compiled in against the run-time-degree kernel at
        # the main-path tier: the same window with one zero coefficient
        # more (one more Clenshaw step per window) takes the latter
        pad = w._replace(cf=torch.cat([w.cf, w.cf.new_zeros(1)]),
                         cp=torch.cat([w.cp, w.cp.new_zeros(1)]))
        for want_pot in (False, True):
            kwp = dict(kw, want_pot=want_pot)
            ms_c, ms_r = self._time(
                lambda: p2p_blocked(*args, **kwp),
                lambda: p2p_blocked(*args[:6], pad, *args[7:], **kwp))
            say("kernel", f"main-path tier, potential {want_pot}: degree "
                f"{ncf - 1} compiled in {ms_c:.4f} ms, run-time degree "
                f"{ncf} (zero top coefficient) {ms_r:.4f} ms")
        # the erfc window's instantiation at the same tier (ROADMAP A.12),
        # beside the degree compiled in, each against its own bound
        from shenqi_tpu_torch.gravity.shortrange import ErfcWindow
        ew = ErfcWindow(sim.gravity.asmth)
        erest = (*rest[:3], ew, rest[4])
        ins = args[:3]
        inwin = {id(w): self._in_window(ins, rest),
                 id(ew): self._in_window(ins, erest)}
        for want_pot in (False, True):
            kwp = dict(kw, want_pot=want_pot)
            ms_c, ms_e = self._time(
                lambda: p2p_blocked(*args, **kwp),
                lambda: p2p_blocked(*ins, *erest, **kwp))
            txt = []
            for name, win, ms in ((f"degree {ncf - 1}", w, ms_c),
                                  ("erfc", ew, ms_e)):
                bound, by, pairs = self._bound(ins, kw["blk"], want_pot, win,
                                               inwin[id(win)])
                floor = _issue_floor_ms(pairs, inwin[id(win)], win, want_pot)
                txt.append(f"{name} {ms:.4f} ms (f32 bound {bound:.4f} ms, "
                           f"{100 * bound / ms:.1f}%; issue floor "
                           f"{floor:.4f} ms, {100 * floor / ms:.1f}%)")
            say("kernel", f"main-path tier {list(ins[2].shape)} blk "
                f"{kw['blk']}, potential {want_pot}: " + "; ".join(txt))
        self.kernel_row = rows[2 * keys.index(main)]
        del shapes, args, tgt, src, sm, one, four, cases

    def _in_window(self, ins, rest):
        """Live pair-lanes inside the window range (x = r / (cell xmax)
        < 1), with x computed as the plain version computes it."""
        torch = self.torch
        from shenqi_tpu_torch.core.particles import wrap_i32
        from shenqi_tpu_torch.ops.p2p import _scalars
        tgt, src, sm = ins
        to_f, _, icx, _ = (float(v) for v in _scalars(*rest[:5]))
        step = max(1, (1 << 22) // (tgt.shape[1] * sm.shape[1]))
        n = 0
        for lo in range(0, sm.shape[0], step):
            d = wrap_i32(src[lo:lo + step].long()[:, None]
                         - tgt[lo:lo + step].long()[:, :, None])
            r2 = (d.float() * to_f).square().sum(-1)
            rinv = torch.where(r2 > 0, torch.rsqrt(r2), 0.0)
            x = r2 * rinv * icx
            n += int(((x < 1.0) & (sm[lo:lo + step] != 0)[:, None]).sum())
        return n

    def _bound(self, ins, blk, want_pot, window, inwin):
        """(least time in ms, what sets it, live pair-lanes): the f32
        operations of the live pairs at the peak f32 rate (a pair inside
        the window at its full count for the window's instantiation, one
        past it at the separation, r and x), or each input read once and
        each output written once at the memory rate, whichever is
        longer."""
        from shenqi_tpu_torch.ops.p2p import (p2p_flops_outside_window,
                                              pair_counts)
        tgt, src, sm = ins
        nb = sm.shape[0]
        pairs = int((sm != 0).sum()) * blk
        flops = (inwin * pair_counts(window, want_pot)[0]
                 + (pairs - inwin) * p2p_flops_outside_window())
        nbytes = (tgt.numel() + src.numel() + sm.numel() + nb * blk * 3
                  + (nb * blk if want_pot else 0)) * 4
        t_ops = flops / H100_F32_FLOPS * 1e3
        t_bytes = nbytes / H100_BYTES_S * 1e3
        return (max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes", pairs)

    def _compare(self, kern, plain, ins, rest, kw, inwin):
        torch = self.torch
        a_k, p_k = kern(*ins, *rest, **kw)
        a_2, p_2 = kern(*ins, *rest, **kw)
        repeatable = bool(torch.equal(a_k, a_2) and (
            not kw["want_pot"] or torch.equal(p_k, p_2)))
        a_p, p_p = plain(*ins, *rest, **kw)
        err = float((a_k - a_p).abs().max())
        rel = err / max(float(a_p.abs().max()), 1e-30)
        if kw["want_pot"]:
            rel = max(rel, float((p_k - p_p).abs().max())
                      / max(float(p_p.abs().max()), 1e-30))
        nb, S = ins[2].shape
        bound, by, pairs = self._bound(ins, kw["blk"], kw["want_pot"],
                                       rest[3], inwin)
        floor = _issue_floor_ms(pairs, inwin, rest[3], kw["want_pot"])
        ms_k, ms_p = self._time(lambda: kern(*ins, *rest, **kw),
                                lambda: plain(*ins, *rest, **kw))
        return dict(blk=kw["blk"], want_pot=kw["want_pot"], nb=nb, S=S,
                    pair_lanes=pairs, in_window=inwin, max_abs_err=err,
                    rel_err=rel, repeatable=repeatable, ms=ms_k,
                    plain_ms=ms_p, bound_ms=bound, bound_by=by,
                    floor_ms=floor)

    def _time(self, *fns):
        """Each function timed in turns (f1, f2, ..., f1, f2, ...) with
        CUDA events, best of 2 turns, each turn of enough calls to last
        about 5 ms, so that a short kernel is not timed while the card's
        clocks ramp up (a plain version of 20-80 ms takes one call a turn:
        five a turn added a third of a minute to the script);
        the rehearsal times one call of each with the host clock (its
        numbers time nothing of the card)."""
        torch = self.torch
        if self.rehearsal:
            out = []
            for f in fns:
                t = time.perf_counter()
                f()
                out.append((time.perf_counter() - t) * 1e3)
            return out
        reps = []
        for f in fns:                  # the warm-up call sizes the turns
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            f()
            e1.record()
            torch.cuda.synchronize()
            reps.append(min(1000, max(1, int(5.0 / max(
                e0.elapsed_time(e1), 1e-3)))))
        best = [float("inf")] * len(fns)
        for _ in range(2):
            for i, f in enumerate(fns):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(reps[i]):
                    f()
                e1.record()
                torch.cuda.synchronize()
                best[i] = min(best[i], e0.elapsed_time(e1) / reps[i])
        return best

    # ------------------------------------------------------------- parity
    def parity(self):
        torch = self.torch
        runs = []
        for plain in (False, True):
            sim = self._make_sim(self.n_parity, self.mesh_parity)
            rng = np.random.RandomState(3)
            v = rng.normal(0, 20.0, (sim.n_real, 3)).astype(np.float32)
            vel = sim.particles.vel.clone()
            vel[:sim.n_real] = torch.from_numpy(v).to(self.dev)
            sim.particles = sim.particles.replace(vel=vel)
            sim._plain_p2p = plain
            t = time.perf_counter()
            sim.run(max_steps=2)
            if not self.rehearsal:
                torch.cuda.synchronize()
            runs.append((sim, time.perf_counter() - t))
        (sk, tk), (sp, tp) = runs
        alive = sk.particles.mask.cpu().numpy()
        ip1 = sk.particles.ipos_u32()[alive].astype(np.int64)
        ip2 = sp.particles.ipos_u32()[alive].astype(np.int64)
        d = np.abs(ip1 - ip2)
        dpos = float(np.minimum(d, 2 ** 32 - d).max()) / 2 ** 32
        v1 = sp.particles.vel.cpu().numpy()[alive]
        v2 = sk.particles.vel.cpu().numpy()[alive]
        vs = float(np.median(np.abs(v1))) + 1e-6
        outlier = np.max(np.abs(v1 - v2), axis=1) > 2e-3 * vs + 1e-4
        tb_ok = np.all((sk.particles.timebin.cpu().numpy()[alive]
                        == sp.particles.timebin.cpu().numpy()[alive])
                       | outlier)
        say("parity", f"{int(alive.sum())} particles mesh "
            f"{self.mesh_parity} 2 steps: kernel {tk:.2f} s, plain "
            f"{tp:.2f} s; max |dpos| {dpos:.3e} box (limit 2e-5), "
            f"velocity outliers {outlier.mean():.2e} (limit 5e-3), "
            f"timebins equal but outliers: {bool(tb_ok)}")
        if not (dpos < 2e-5 and outlier.mean() < 5e-3 and tb_ok
                and sk.times.ti_current == sp.times.ti_current):
            raise SmokeFailure("kernel path and plain path disagree")
        # FOF labels of one clustered state with halos, on this run's
        # device (with the pairs within b kept, and with the pass run
        # again each iteration, as past fof._MAX_LINKS) and through the
        # port's CPU path: integers, so equal
        from shenqi_tpu_torch.core.particles import float_to_ipos
        from shenqi_tpu_torch.fof import fof as fofm
        n1, box = self.n_parity, 50000.0 * self.n_parity / 128
        pos = _with_halos(_clustered(n1, box), box)
        b = 0.2 * box / n1
        labels, secs, keep = [], [], fofm._MAX_LINKS
        for dev, max_links in ((self.dev, keep), (self.dev, 0),
                               (torch.device("cpu"), keep)):
            t = time.perf_counter()
            alive = torch.ones(len(pos), dtype=torch.bool, device=dev)
            fofm._MAX_LINKS = max_links
            try:
                labels.append(fofm.fof_label(
                    float_to_ipos(pos, box, device=dev), alive, b,
                    box).cpu())
            finally:
                fofm._MAX_LINKS = keep
            secs.append(time.perf_counter() - t)
        ngrp = int((torch.bincount(labels[0]) >= 32).sum())
        same = all(torch.equal(labels[0], x) for x in labels[1:])
        say("parity", f"FOF labels of {len(pos)} clustered particles with "
            f"halos ({ngrp} groups of 32 or more): {self.dev} {secs[0]:.2f}"
            f" s, {self.dev} with the pass each iteration {secs[1]:.2f} s, "
            f"CPU {secs[2]:.2f} s, identical {same}")
        if not (same and ngrp > 0):
            raise SmokeFailure("FOF labels differ between the card, the "
                               "card's repeated pass and the CPU path")

    # -------------------------------------------------------------- slice
    def _sync(self):
        if not self.rehearsal:
            self.torch.cuda.synchronize()

    def slice(self):
        torch = self.torch
        from shenqi_tpu_torch.gravity import stencil as st
        from shenqi_tpu_torch.ops.p2p import p2p_blocked
        sim = self.sim
        if sim.particles.n != self.n_slice ** 3:
            sim = self._make_sim(self.n_slice, self.mesh_slice)
        n = sim.n_real
        steps = []
        clock = _StageClock(self._sync)
        # the pair kernel's device time per step: CUDA events around each
        # call from the stencil, read after the step's synchronize
        events = []
        real = st.p2p_blocked

        def timed(*a, **kw):
            if self.rehearsal:
                return real(*a, **kw)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = real(*a, **kw)
            e1.record()
            events.append((e0, e1))
            return out

        def on_step(s):
            self._sync()
            clock.measure("kicks")
            kms = sum(e0.elapsed_time(e1) for e0, e1 in events)
            events.clear()
            steps.append((time.perf_counter(), p2p_blocked.launches,
                          clock.take(), s.last_n_targets or n, kms))
            check_budget(f"slice step {s.step_count}")

        sim.on_step = on_step
        m = sim.particles.mass.double()[:, None]
        p0 = (m * sim.particles.vel.double()).sum(0)
        self._sync()
        if not self.rehearsal:
            torch.cuda.reset_peak_memory_stats()
        # the main path: counts set to 0 just before, read just after
        st.p2p_blocked = timed
        p2p_blocked.launches = 0
        t0 = time.perf_counter()
        clock.start()
        sim.walltime = clock
        try:
            sim.run(max_steps=3)
        finally:
            st.p2p_blocked = real
        launches = p2p_blocked.launches
        sim.walltime = None
        prev_t, prev_l = t0, 0
        per_step = []
        for i, (t, l, stages, ntgt, kms) in enumerate(steps):
            per_step.append((t - prev_t, l - prev_l))
            say("slice", f"step {i}: {t - prev_t:.3f} s, {ntgt} short-range"
                f" targets, p2p_blocked launches {l - prev_l} taking "
                f"{kms:.3f} ms of device time; stages " + ", ".join(
                    f"{k} {v:.3f} s" for k, v in stages.items()))
            prev_t, prev_l = t, l
        p = sim.particles
        rate = (n * (len(per_step) - 1) / sum(s for s, _ in per_step[1:])
                if len(per_step) > 1 else float("nan"))
        acc_ok = bool(torch.isfinite(p.grav_accel).all()
                      and torch.isfinite(p.grav_pm).all())
        from shenqi_tpu_torch.core.particles import ipos_to_float
        pos = ipos_to_float(p.ipos, sim.boxsize)
        pos_ok = bool(torch.isfinite(pos).all()
                      and torch.isfinite(p.vel).all())
        mv = m * p.vel.double()
        dp = float(torch.linalg.norm(mv.sum(0) - p0))
        smv = float(torch.linalg.norm(mv, dim=1).sum())
        mem = (torch.cuda.max_memory_allocated() / 2 ** 30
               if not self.rehearsal else float("nan"))
        say("slice", f"{n} particles, mesh {sim.gravity.nmesh}, "
            f"{len(per_step)} steps to a={sim.atime():.5f}: {rate:.1f} "
            f"particle-steps/s after the first step (all particles per "
            f"step, as bench.py counts; individual timesteps update only "
            f"the active targets); |dP| / sum m|v| = "
            f"{dp / max(smv, 1e-300):.3e} (limit 1e-3); accelerations "
            f"finite {acc_ok}, positions finite {pos_ok}; peak device "
            f"memory {mem:.2f} GiB; p2p_blocked launches {launches}")
        self.launches = launches
        if len(per_step) != 3:
            raise SmokeFailure(f"slice ran {len(per_step)} steps, not 3")
        if not self.rehearsal and any(l <= 0 for _, l in per_step):
            raise SmokeFailure("a step ran without the pair kernel")
        if not (acc_ok and pos_ok and dp < 1e-3 * smv):
            raise SmokeFailure("slice results are not sane")
        self.sim = sim

    def cli(self):
        """The main path as its users run it: genic_main, then gadget_main
        RestartFlag 4, 2 and 3, on paramfiles written into a temporary
        directory that the `mesh` phase reuses and close() removes."""
        import tempfile
        self.cli_dir = tempfile.mkdtemp(prefix="shenqi_cli_")
        self._cli(self.cli_dir)

    def _cli(self, tmp):
        import os
        torch = self.torch
        from shenqi_tpu_torch.cli import gadget_main, genic_main
        from shenqi_tpu_torch.io.snapshot import (SnapshotHeader,
                                                  read_snapshot,
                                                  write_snapshot)
        from shenqi_tpu_torch.ops.p2p import p2p_blocked
        ng, nmesh, box = self.n_cli, 2 * self.n_cli, 1000.0 * self.n_cli
        pk = os.path.join(tmp, "pk_eh.txt")
        table = _eh_table(pk)
        out = os.path.join(tmp, "output")
        gp, pp = os.path.join(tmp, "p.genic"), os.path.join(tmp, "p.gadget")
        with open(gp, "w") as f:
            f.write(_GENIC.format(out=tmp, ng=ng, box=box, pk=pk))
        with open(pp, "w") as f:
            f.write(_GADGET.format(ic=os.path.join(tmp, "IC", "IC"),
                                   out=out, a=0.11, fof=1, nmesh=nmesh))
        dev = "cpu" if self.rehearsal else None      # None: the card

        # genic_main, its stages timed by wrapping what it calls (the
        # displacement fields end with a copy to the host: synchronous)
        t = time.perf_counter()
        with _Wrap(genic_main, "gaussian_field") as field, \
                _Wrap(genic_main, "displacement_fields") as disp:
            ic = genic_main.run_genic(gp, device=dev)
        t_all = time.perf_counter() - t
        write_s = time.perf_counter() - disp.t_end
        say("cli", f"genic_main Ngrid {ng} ({ng ** 3} particles), box "
            f"{box:.0f} kpc/h, mesh {2 * ng}: {t_all:.2f} s = field "
            f"{field.seconds:.2f} s + displacement fields (host tables, "
            f"FFTs and readout on the card) {disp.seconds:.3f} s + bigfile"
            f" write {write_s:.2f} s + set-up")
        hdr, blocks = read_snapshot(ic)
        ids = np.sort(blocks[1]["ID"])
        icpos = blocks[1]["Position"]
        if not (len(ids) == ng ** 3 and np.array_equal(
                ids, np.arange(1, ng ** 3 + 1, dtype=np.uint64))):
            raise SmokeFailure("IC IDs are not a permutation of 1..N")
        if not (np.isfinite(icpos).all() and (icpos >= 0).all()
                and (icpos < box).all()):
            raise SmokeFailure("IC positions outside [0, box)")
        # internal velocities a * v_pec, as gadget_main reads them
        p0 = (blocks[1]["Velocity"].astype(np.float64) * hdr.Time
              * hdr.MassTable[1]).sum(0)
        del blocks, icpos, ids

        # RestartFlag 4: P(k) of the ICs against the table at a = 0.1
        t = time.perf_counter()
        fn = gadget_main.run_gadget(pp, 4, device=dev)
        t4 = time.perf_counter() - t
        d = np.loadtxt(fn)
        knyq = np.pi * ng / (box / 1000.0)
        low = d[:, 0] < knyq / 4
        want = np.interp(np.log(d[low, 0]), np.log(table[:, 0]), table[:, 1])
        ratio = float((d[low, 2] * d[low, 3]).sum()
                      / (d[low, 2] * want).sum())
        say("cli", f"gadget_main RestartFlag 4 (P(k) of the ICs, mesh "
            f"{nmesh}): {t4:.2f} s; P(z=0) over the {int(low.sum())} bins "
            f"below a quarter of the particle Nyquist k ({knyq / 4:.3f} "
            f"h/Mpc), mode-weighted, / the table = {ratio:.4f} (limit "
            f"|1 - ratio| < 0.08, validation/dm_small.py's at a = 0.1)")
        if not abs(1 - ratio) < 0.08:
            raise SmokeFailure(f"IC P(k) off the table by {ratio - 1:+.3f}")

        # RestartFlag 2: the run at the CLI defaults (hierarchical), with
        # each force call, the bins of each step and one example of each
        # pair-kernel launch shape recorded, for the comparison with the
        # plain version after it
        if not self.rehearsal:
            torch.cuda.reset_peak_memory_stats()
        # the main path: counts set to 0 just before, read just after
        p2p_blocked.launches = 0
        t = time.perf_counter()
        with _Wrap(gadget_main, "write_snapshot", keep=True) as snap, \
                _Wrap(gadget_main, "fof", keep=True) as fofw, \
                _RunRecorder(self._sync) as rec:
            sim = gadget_main.run_gadget(pp, 2, device=dev)
        t2 = time.perf_counter() - t
        self.cli_launches = p2p_blocked.launches
        mem = (torch.cuda.max_memory_allocated() / 2 ** 30
               if not self.rehearsal else float("nan"))
        steps = self._run_steps(out, sim)
        calls = rec.per_step()
        bins = dict(rec.bins)
        for i, (a, stages) in enumerate(steps):
            say("cli", f"  {'step ' + str(i) if i < len(steps) - 1 else 'end'}"
                f" at a={a:.5f}: bins {_bin_span(bins.get(i))}; force calls "
                + _calls_line(calls.get(i, [])) + "; stages " + ", ".join(
                    f"{k} {v:.3f} s" for k, v in sorted(stages.items())))
        tot = dict(sorted(sim.walltime.total_acc.items()))
        (_, (spath, shdr, sblocks)), = snap.calls
        nbytes = sum(v.nbytes for b_ in sblocks.values() for v in b_.values())
        fs = fofw.calls[0][0].stats
        say("cli", f"gadget_main RestartFlag 2 to a={sim.atime():.5f}: "
            f"{t2:.2f} s, {len(steps) - 1} steps, {len(rec.calls)} force "
            f"calls ({sum(c[1] == 'level' for c in rec.calls)} of them "
            f"active-source levels), at most "
            f"{max(len(b) for _, b in rec.bins)} occupied bins; stage totals "
            + ", ".join(f"{k} {v:.3f} s" for k, v in tot.items())
            + f" (Misc holds the kicks); p2p_blocked launches "
            f"{self.cli_launches}; peak device memory {mem:.2f} GiB; "
            f"snapshot write {nbytes / 1e6:.1f} MB in {snap.seconds:.3f} s "
            f"= {nbytes / 1e6 / snap.seconds:.1f} MB/s; " + _fof_line(fs))
        del sblocks, snap
        for f_ in ("PART_000", "PIG_000", "energy.txt", "cpu.txt",
                   "powerspectrum-0.1100.txt"):
            if not os.path.exists(os.path.join(out, f_)):
                raise SmokeFailure(f"gadget_main wrote no {f_}")
        if abs(sim.atime() - 0.11) > 1e-6:
            raise SmokeFailure(f"the run ended at a={sim.atime()}")
        if not sim.hierarchical:
            raise SmokeFailure("the CLI default did not run hierarchically")
        self._check_calls("cli", rec)
        self._check_momentum("cli", sim, p0)
        self.cli_run = {"pp": pp, "out": out, "steps": sim.step_count,
                        "seconds": t2, "ic": os.path.join(tmp, "IC", "IC")}
        del sim
        self.cli_row = self._check_shapes(rec.shapes, "cli")
        del rec

        # RestartFlag 3 on PART_000, then on a clustered state with halos
        for snap_, label in ((0, "PART_000"), (7, "clustered with halos")):
            if snap_ == 7:
                n1 = self.n_slice
                cbox = 50000.0 * n1 / 128
                cpos = _with_halos(_clustered(n1, cbox), cbox)
                cp = _dm_small_cosmology()
                m = cp.Omega0 * cp.RhoCrit * cbox ** 3 / len(cpos)
                write_snapshot(os.path.join(out, "PART_007"), SnapshotHeader(
                    TotNumPart=np.array([0, len(cpos), 0, 0, 0, 0],
                                        np.uint64),
                    MassTable=np.zeros(6), Time=0.11, BoxSize=cbox,
                    Omega0=0.288, OmegaLambda=0.712, OmegaBaryon=0.0472,
                    HubbleParam=0.7, TimeIC=0.1),
                    {1: {"Position": cpos,
                         "Velocity": np.zeros((len(cpos), 3), np.float32),
                         "Mass": np.full(len(cpos), m, np.float32),
                         "ID": np.arange(1, len(cpos) + 1,
                                         dtype=np.uint64)}})
                del cpos
            t = time.perf_counter()
            with _Wrap(gadget_main, "fof", peak=not self.rehearsal) as fofw:
                g = gadget_main.run_gadget(pp, 3, snap_, device=dev)
            t3 = time.perf_counter() - t
            say("cli", f"gadget_main RestartFlag 3 on {label}: {t3:.2f} s, "
                f"{g.ngroups} groups, largest {int(g.lengths[:1].sum())}; "
                f"FOF's peak device memory above what it was given "
                + (f"{fofw.peak / 2 ** 20:.1f} MiB; " if not self.rehearsal
                   else "not measured on the CPU; ") + _fof_line(g.stats))
            if not os.path.isdir(os.path.join(out, f"PIG_{snap_:03d}")):
                raise SmokeFailure(f"RestartFlag 3 wrote no PIG_{snap_:03d}")
            if int(g.lengths.sum()) != int((g.group_id > 0).sum()):
                raise SmokeFailure("group lengths do not sum to the grouped "
                                   "particles")
        if g.ngroups < 1:
            raise SmokeFailure("FOF found no group in the clustered state")

    def _check_shapes(self, shapes, phase, both_pots=False):
        """Every launch shape (nb, blk, S, want_pot) a run gave the pair
        kernel, on the inputs of one of its launches (with `both_pots`
        with and without the potential): against the plain version, a
        second launch's bits, and its bound.  Returns the row of the
        shape with the most pair lanes, at the run's own want_pot."""
        from shenqi_tpu_torch.ops.p2p import (p2p_blocked,
                                              p2p_blocked_reference)
        rows = []
        for key in sorted(shapes):
            n, args, kw = shapes[key]
            ins, rest = args[:3], args[3:]
            inwin = self._in_window(ins, rest)
            for want_pot in ((False, True) if both_pots
                             else (kw["want_pot"],)):
                r = self._compare(p2p_blocked, p2p_blocked_reference, ins,
                                  rest, dict(kw, want_pot=want_pot), inwin)
                say(phase, f"x{n} in the run: p2p_blocked " + " ".join(
                    f"{k}={v}" for k, v in r.items())
                    + f"; {100 * r['bound_ms'] / r['ms']:.1f}% of bound, "
                    f"{100 * r['floor_ms'] / r['ms']:.1f}% of issue floor")
                if not r["rel_err"] < 2e-4:
                    raise SmokeFailure(f"p2p_blocked disagrees with its "
                                       f"plain version at a shape of the "
                                       f"{phase} run: {r}")
                if not r["repeatable"]:
                    raise SmokeFailure(f"p2p_blocked gave other bits on a "
                                       f"second launch at a shape of the "
                                       f"{phase} run: {r}")
                if want_pot == kw["want_pot"]:
                    rows.append((key[0] * key[1] * key[2], r))
        if not rows:
            raise SmokeFailure(f"the {phase} run launched no pair kernel")
        return max(rows, key=lambda x: x[0])[1]

    def _run_steps(self, out, sim):
        """[(a, {stage: seconds})] per step of a gadget_main run: cpu.txt
        holds each finished step; the last loop pass (the final forces,
        the snapshot and FOF) ends without a step record, so its stages
        come from the run's timer."""
        import os
        steps = _cpu_steps(os.path.join(out, "cpu.txt"))
        steps.append((sim.atime(), dict(sim.walltime.step_acc)))
        return steps

    def _check_calls(self, phase, rec):
        """Every force call of the run launched the pair kernel (on the
        card), and every step but the last assigned timebins."""
        if not rec.calls:
            raise SmokeFailure(f"the {phase} run made no force call")
        if not self.rehearsal and min(c[3] for c in rec.calls) <= 0:
            raise SmokeFailure(f"a force call of the {phase} run launched "
                               f"no pair kernel")

    def _check_momentum(self, phase, sim, p0):
        """Total momentum change under 1e-3 of sum m|v|."""
        torch = self.torch
        p = sim.particles
        mv = p.mass.double()[:, None] * p.vel.double()
        dp = float(torch.linalg.norm(mv.sum(0).cpu()
                                     - torch.from_numpy(p0)))
        smv = float(torch.linalg.norm(mv, dim=1).sum())
        say(phase, f"|dP| / sum m|v| = {dp / smv:.3e} (limit 1e-3)")
        if not dp < 1e-3 * smv:
            raise SmokeFailure(f"momentum not conserved in the {phase} run")

    # --------------------------------------------------------------- mesh
    def mesh(self):
        """gadget_main --mesh 1 on cli's ICs and paramfile: the slab loop
        on one spawned rank through NCCL (gloo in the rehearsal), held to
        cli's single-device output; then, in the same rank, the --mesh
        run from cli's clustered snapshot for the catalogue
        (_mesh_fof_clustered), the --mesh run of the `gas` phase's
        travis-hydro ICs and paramfile (_mesh_gas) and the --mesh resume
        of the `stars` output with `bh`'s paramfile (_mesh_sub); then
        --mesh 2 on this one-card host must raise.  It runs after `bh`,
        whose directory holds the `stars` output."""
        import functools
        import os
        torch = self.torch
        from shenqi_tpu_torch.cli import gadget_main
        from shenqi_tpu_torch.io.snapshot import read_snapshot
        run = self.cli_run
        out = os.path.join(self.cli_dir, "mesh_output")
        pp = os.path.join(self.cli_dir, "p_mesh.gadget")
        with open(run["pp"]) as f:
            text = f.read()
        with open(pp, "w") as f:
            f.write(text.replace(run["out"], out))
        # the clustered run's output directory holds a link to cli's
        # PART_007, its start (RestartFlag 2, SnapNum 7)
        out_fof = os.path.join(self.cli_dir, "mesh_fof_output")
        pp_fof = os.path.join(self.cli_dir, "p_mesh_fof.gadget")
        os.makedirs(out_fof)
        os.symlink(os.path.join(run["out"], "PART_007"),
                   os.path.join(out_fof, "PART_007"))
        with open(pp_fof, "w") as f:
            f.write(text.replace(run["out"], out_fof))
        # the gas run: the `gas` phase's ICs and paramfile
        out_gas = os.path.join(self.gas_dir, "mesh_output")
        pp_gas = os.path.join(self.gas_dir, "p_mesh.gadget")
        with open(pp_gas, "w") as f:
            f.write(_GADGET_GAS.format(
                ic=self.gas_run["ic"], out=out_gas,
                outputs=self.mesh_gas_run[0], a=self.mesh_gas_run[1]))
        pp_sub, out_sub = self._mesh_sub_setup()
        dev = "cpu" if self.rehearsal else None      # None: the card
        t = time.perf_counter()
        summ = gadget_main.run_gadget(
            pp, 2, mesh_devices=1, device=dev,
            rank_hook=functools.partial(
                _mesh_rank_hook, then=((pp_fof, 2, 7), (pp_gas, 2, -1),
                                       (pp_sub, 1, -1))),
            mesh_timeout=300.0,
            join_timeout=max(self.budget - elapsed(), 60.0))
        t_mesh = time.perf_counter() - t
        rec = torch.load(os.path.join(out, "mesh_rank0.pt"),
                         map_location=self.dev, weights_only=False)
        self.mesh_launches = rec["launches"]
        nsteps = summ["step_count"]
        say("mesh", f"gadget_main --mesh 1: backend {summ['backend']}, "
            f"world size {summ['world']}; {t_mesh:.2f} s in all (spawn, "
            f"process group, the rank's set-up and run {rec['run_s']:.2f} s,"
            f" then the clustered run in the same rank), {nsteps} steps; p2p_blocked launches {self.mesh_launches}; "
            f"collectives " + ", ".join(f"{k} {v:.6g}" for k, v in
                                        sorted(rec["counts"].items())))
        steps = _cpu_steps(os.path.join(out, "cpu.txt"))
        steps.append((summ["atime"], rec["last_stages"]))
        xch = {st_: (rows, sec) for st_, rows, sec in rec["exchange_log"]}
        for i, (a, stages) in enumerate(steps):
            calls = [c for c in rec["force_log"] if c[0] == i]
            rows, sec = xch.get(i, (0, 0.0))
            say("mesh", f"  {'step ' + str(i) if i < len(steps) - 1 else 'end'}"
                f" at a={a:.5f}: exchange sent {rows} rows in {sec:.4f} s; "
                f"force calls " + (", ".join(
                    f"{k} {n} targets + {g} ghosts {s_:.3f} s"
                    for _, k, n, g, s_ in calls) or "none") + "; stages "
                + ", ".join(f"{k} {v:.3f} s"
                            for k, v in sorted(stages.items())))
        per = rec["run_s"] / max(nsteps, 1)
        say("mesh", f"seconds per step: --mesh 1 {per:.3f} (set-up "
            f"included) against cli's {run['seconds'] / max(run['steps'], 1):.3f}"
            f" (the whole gadget_main call over its steps)")
        if nsteps != run["steps"]:
            raise SmokeFailure(f"--mesh 1 took {nsteps} steps, cli "
                               f"{run['steps']}")
        if not summ["hierarchical"]:
            raise SmokeFailure("--mesh 1 did not run hierarchically")
        if not self.rehearsal and self.mesh_launches <= 0:
            raise SmokeFailure("the --mesh 1 run launched no pair kernel")
        # the outputs against cli's: positions by ID (test_slab_sim.py's
        # 2e-5 of the box), P(k) to rtol 1e-4
        h1, b1 = read_snapshot(os.path.join(run["out"], "PART_000"))
        h2, b2 = read_snapshot(os.path.join(out, "PART_000"))
        o1, o2 = np.argsort(b1[1]["ID"]), np.argsort(b2[1]["ID"])
        if not np.array_equal(b1[1]["ID"][o1], b2[1]["ID"][o2]):
            raise SmokeFailure("--mesh 1 wrote other IDs than cli")
        box = h1.BoxSize
        d = np.abs(b1[1]["Position"][o1] - b2[1]["Position"][o2])
        dpos = float(np.minimum(d, box - d).max() / box)
        pks = sorted(f_ for f_ in os.listdir(run["out"])
                     if f_.startswith("powerspectrum-"))
        prel = 0.0
        for f_ in pks:
            p1 = np.loadtxt(os.path.join(run["out"], f_))
            p2 = np.loadtxt(os.path.join(out, f_))
            if p1.shape != p2.shape or not np.array_equal(p1[:, 2], p2[:, 2]):
                raise SmokeFailure(f"--mesh 1's {f_} has other bins")
            prel = max(prel, float(np.max(np.abs(p2[:, [0, 1]] / p1[:, [0, 1]]
                                                 - 1))))
        say("mesh", f"against cli: positions within {dpos:.3e} of the box "
            f"(limit 2e-5), {len(pks)} P(k) files within rtol {prel:.3e} "
            f"(limit 1e-4)")
        if not dpos < 2e-5:
            raise SmokeFailure(f"--mesh 1 positions off by {dpos:.3e}")
        if not (len(pks) and prel < 1e-4):
            raise SmokeFailure(f"--mesh 1 P(k) off by {prel:.3e}")
        shapes = rec["shapes"]
        del rec
        # the run forms no FOF group by a = 0.11: the --mesh catalogue is
        # checked on the run from cli's clustered PART_007 in the same rank
        for more in (self._mesh_fof_clustered(out_fof),
                     self._mesh_gas(out_gas), self._mesh_sub(out_sub)):
            for key, (n, a_, kw) in more.items():
                shapes.setdefault(key, [0, a_, kw])[0] += n
        self.mesh_row = self._check_shapes(shapes, "mesh")
        del shapes
        if not self.rehearsal:
            try:
                gadget_main.run_gadget(pp, 2, mesh_devices=2)
            except RuntimeError as e:
                if "needs 2 cards" not in str(e):
                    raise
                say("mesh", f"--mesh 2 refused: {e}")
            else:
                raise SmokeFailure("--mesh 2 ran on a one-card host")

    def _mesh_fof_clustered(self, out):
        """The --mesh run from cli's clustered PART_007 (RestartFlag 2,
        SnapNum 7; a = 0.11 is the paramfile's one output and TimeMax),
        run by gadget_main's rank body in the first run's rank after it
        (_mesh_rank_hook's `then`): one full force pass, then its
        snapshot with the slab FOF and the PIG that its on_snapshot
        writes, before any drift.  That PIG against the single-device FOF
        of the same snapshot (fof_label and compile_groups here) on a
        tree of the run's depth, at test_cli_mesh_fof.py's limits; cli's
        RestartFlag 3 PIG_007, whose tree has 8 levels, is printed beside
        it: FOF takes at most ncrit sources from a leaf (ROADMAP C.4), so
        where compact halos fill leaves at the deepest level the
        catalogue depends on the depth (C.6).  Returns the run's
        pair-kernel launch shapes."""
        import os
        torch = self.torch
        from shenqi_tpu_torch.core.particles import float_to_ipos
        from shenqi_tpu_torch.fof.fof import compile_groups, fof_label
        from shenqi_tpu_torch.io.fofio import load_fof
        from shenqi_tpu_torch.io.snapshot import read_snapshot
        run = self.cli_run
        rec = torch.load(os.path.join(out, "mesh_rank0.pt"),
                         map_location=self.dev, weights_only=False)
        self.mesh_launches += rec["launches"]
        if not (len(rec["snapshots"]) == 1
                and abs(rec["snapshots"][0] - 0.11) < 1e-9):
            raise SmokeFailure(f"the --mesh 1 run from PART_007 wrote "
                               f"snapshots at {rec['snapshots']}")
        # the single-device catalogue of the same rows, the linking
        # length formed as gadget_main forms it (FOFHaloLinkingLength 0.2
        # times the mean separation; FOFHaloMinLength 32)
        h, b = read_snapshot(os.path.join(run["out"], "PART_007"))
        box, n = h.BoxSize, len(b[1]["ID"])
        ipos = float_to_ipos(b[1]["Position"], box, device=self.dev)
        self._sync()
        t = time.perf_counter()
        lab = fof_label(ipos, torch.ones(n, dtype=torch.bool,
                                         device=self.dev),
                        0.2 * (box / np.cbrt(n)), box,
                        nlevels=rec["tree_nlevels"]).cpu().numpy()
        ref = compile_groups(lab, ipos.cpu().numpy().view(np.uint32),
                             np.zeros((n, 3), np.float32),
                             b[1]["Mass"].astype(np.float32),
                             np.ones(n, np.int8), np.ones(n, bool), box,
                             min_length=32)
        sec_ref = time.perf_counter() - t
        got = load_fof(os.path.join(out, "PIG_000"))
        cli8 = load_fof(os.path.join(run["out"], "PIG_007"))

        def compare(c1, c2):
            m1, m2 = np.sort(c1["Mass"]), np.sort(c2["Mass"])
            l1 = np.sort(np.asarray(c1["LengthByType"]).sum(axis=1))
            l2 = np.sort(np.asarray(c2["LengthByType"]).sum(axis=1))
            if len(m1) != len(m2) or not len(m1):
                return False, f"{len(m2)} groups against {len(m1)}"
            dm = float(np.max(np.abs(m2 / m1 - 1)))
            dl = float(np.mean(l1 != l2))
            return (dm < 5e-3 and dl < 0.1), (
                f"{len(m2)} groups against {len(m1)}, masses within rtol "
                f"{dm:.3e} (limit 5e-3), {dl:.3f} of the lengths "
                f"differing (limit 0.1)")
        same, line = compare({"Mass": ref.masses,
                              "LengthByType": ref.lengths[:, None]}, got)
        _, line8 = compare(cli8, got)
        say("mesh", f"the --mesh 1 run from the clustered PART_007 ({n} "
            f"particles, RestartFlag 2, in the same rank): its set-up and "
            f"run {rec['run_s']:.2f} s, snapshots at a = "
            f"{rec['snapshots']}; p2p_blocked launches {rec['launches']}; "
            f"its PIG_000 against the single-device FOF of PART_007 on a "
            f"tree of the run's {rec['tree_nlevels']} levels ({sec_ref:.2f}"
            f" s): {line}; against cli's RestartFlag 3 PIG_007 (a tree of "
            f"8 levels; ROADMAP C.6): {line8}")
        if not same:
            raise SmokeFailure("the --mesh 1 run's PIG of the clustered "
                               "snapshot differs from the single-device "
                               "FOF of it")
        return rec["shapes"]

    def _mesh_gas(self, out):
        """The --mesh run of travis-hydro (the `gas` phase's ICs and
        paramfile, RestartFlag 2, z = 99 to MESH_GAS_RUN's TimeMax, in the
        rehearsal MESH_GAS_REHEARSAL_RUN's), run by the rank after the
        clustered one: per step its gas rows and ghosts
        (none at one rank), the hsml loop's iterations and strips, the IC
        fixed point's iterations, density, fixed-point and hydro seconds
        beside the step's stages; its snapshot at TimeMax by ID against
        the `gas` run's, at tests/test_slab_gas.py's limits (IDs and types
        equal, the entropy finite and positive, its median within rtol
        5e-3, at least 95% of the gas rows within rtol 2e-2 in Density,
        4e-2 in SmoothingLength and 1e-2 in entropy, the 95th percentile
        of |dv| under 2e-2 of the largest |v|); its step count, P(k) files
        and PIG group counts printed beside the `gas` run's.  Returns the
        run's pair-kernel launch shapes."""
        import os
        torch = self.torch
        from shenqi_tpu_torch.io.fofio import load_fof
        from shenqi_tpu_torch.io.snapshot import read_snapshot
        from shenqi_tpu_torch.utils.constants import GAMMA_MINUS1
        grun = self.gas_run
        rec = torch.load(os.path.join(out, "mesh_rank0.pt"),
                         map_location=self.dev, weights_only=False)
        self.mesh_launches += rec["launches"]
        steps = _cpu_steps(os.path.join(out, "cpu.txt"))
        steps.append((None, rec["last_stages"]))
        fp = rec["fixed_point"]
        amax = self.mesh_gas_run[1]
        g_steps = sum(a_ < amax - 1e-9 for a_, _ in _cpu_steps(
            os.path.join(grun["out"], "cpu.txt")))
        say("mesh", f"the --mesh 1 run of travis-hydro ({self.n_gas}^3 gas "
            f"+ DM, RestartFlag 2, in the same rank): its set-up and run "
            f"{rec['run_s']:.2f} s, {rec['step_count']} steps to a={amax} "
            f"(gas {g_steps}; gas to {GAS_RUNS[0][1]} {grun['steps']} in "
            f"{grun['seconds']:.2f} s, SPH {grun['sph_s']:.2f} s), "
            f"snapshots at a = {rec['snapshots']}; "
            f"p2p_blocked launches {rec['launches']}; IC fixed point "
            f"{fp.get('iterations')} iterations, converged "
            f"{fp.get('converged')}, max relative change per iteration "
            + ", ".join(f"{d:.2e}" for d in fp.get("maxdiff", [])))
        for r in rec["sph_log"]:
            st = steps[r["step"]][1] if r["step"] < len(steps) else {}
            say("mesh", f"  step {r['step']}: {r['gas']} gas rows, ghosts "
                f"{r['dens_ghosts']} density / {r['hydro_ghosts']} hydro; "
                f"hsml loop {r['niter']} iterations, {r['strips']} strips, "
                f"{r['dens_cover']} cover targets; fixed point "
                f"{r['fp_iter']} iterations {r['fp_s']:.3f} s; density "
                f"{r['density_s']:.3f} s, hydro {r['hydro_s']:.3f} s "
                f"({r['hydro_cover']} cover, {r['long_reach']} long-reach); "
                f"stages " + ", ".join(f"{k} {v:.3f} s"
                                       for k, v in sorted(st.items())))
        snap = f"PART_{self.mesh_gas_run[0].count(','):03d}"
        h1, b1 = read_snapshot(os.path.join(grun["out"], snap))
        h2, b2 = read_snapshot(os.path.join(out, snap))
        a = h1.Time
        if abs(h2.Time - a) > 1e-9 or sorted(b1) != sorted(b2):
            raise SmokeFailure(f"the --mesh 1 gas run's {snap} is at "
                               f"a={h2.Time} with types {sorted(b2)}")
        for t_ in b1:
            o1, o2 = np.argsort(b1[t_]["ID"]), np.argsort(b2[t_]["ID"])
            if not np.array_equal(b1[t_]["ID"][o1], b2[t_]["ID"][o2]):
                raise SmokeFailure(f"the --mesh 1 gas run wrote other type "
                                   f"{t_} IDs than gas")
            b1[t_] = {k: v[o1] for k, v in b1[t_].items()}
            b2[t_] = {k: v[o2] for k, v in b2[t_].items()}
        g1, g2 = b1[0], b2[0]

        def entropy(g):
            return (GAMMA_MINUS1 * g["InternalEnergy"].astype(np.float64)
                    / (g["Density"].astype(np.float64) / a ** 3)
                    ** GAMMA_MINUS1)
        e1, e2 = entropy(g1), entropy(g2)
        med = float(np.median(e2) / np.median(e1) - 1)
        share = {name: float(np.isclose(x, y, rtol=rt).mean())
                 for name, x, y, rt in (
                     ("Density", g2["Density"], g1["Density"], 2e-2),
                     ("SmoothingLength", g2["SmoothingLength"],
                      g1["SmoothingLength"], 4e-2),
                     ("entropy", e2, e1, 1e-2))}
        v1 = np.concatenate([b1[t_]["Velocity"] for t_ in sorted(b1)])
        v2 = np.concatenate([b2[t_]["Velocity"] for t_ in sorted(b2)])
        dv = float(np.percentile(np.linalg.norm(v2 - v1, axis=1), 95)
                   / np.abs(v1).max())
        pks = sorted(f_ for f_ in os.listdir(out)
                     if f_.startswith("powerspectrum-"))
        prel = max((float(np.max(np.abs(
            np.loadtxt(os.path.join(out, f_))[:, 1]
            / np.loadtxt(os.path.join(grun["out"], f_))[:, 1] - 1)))
            for f_ in pks if f_ in grun["pks"]), default=float("nan"))
        groups = [len(load_fof(os.path.join(out, f"PIG_{i:03d}"))["Mass"])
                  for i in range(self.mesh_gas_run[0].count(",") + 1)]
        say("mesh", f"  against gas at a={a:.5f}: median entropy within "
            f"rtol {med:+.3e} (limit 5e-3); rows within the limits: "
            + ", ".join(f"{k} {v:.4f}" for k, v in share.items())
            + f" (at least 0.95); 95th percentile |dv| {dv:.3e} of the "
            f"largest |v| (limit 2e-2); {len(pks)} P(k) files (gas "
            f"{len(grun['pks'])}), P within rtol {prel:.3e} of gas's; PIG "
            f"groups {groups} (gas {grun['groups'][:len(groups)]})")
        if not (np.isfinite(e2).all() and (e2 > 0).all()):
            raise SmokeFailure("the --mesh 1 gas run's entropy is not finite "
                               "and positive")
        if not (abs(med) < 5e-3 and min(share.values()) > 0.95
                and dv < 2e-2):
            raise SmokeFailure("the --mesh 1 gas run is off the gas run")
        if not fp.get("converged") or not rec["sph_log"]:
            raise SmokeFailure("the --mesh 1 gas run ran no SPH or no IC "
                               "fixed point")
        return rec["shapes"]

    def _mesh_sub_setup(self):
        """The fourth --mesh run's paramfile and output directory: `bh`'s
        paramfile (BlackHoleOn with its seeding thresholds, the
        UVFluctuationFile, ofjt10 winds, MetalReturnOn) to MESH_SUB_RUN's
        end, with MESH_SUB_SF, resuming (RestartFlag 1) from a link to
        the `stars` output that `bh` resumed from."""
        import os
        if self.bh_dir is None:
            raise SmokeFailure("mesh needs the bh phase's directory")
        runs = STARS_REHEARSAL_RUNS if self.rehearsal else STARS_RUNS
        start = runs[0][0].count(",")
        src = os.path.join(self.bh_dir, "output")
        out = os.path.join(self.bh_dir, "mesh_output")
        os.makedirs(out)
        os.symlink(os.path.join(src, f"PART_{start:03d}"),
                   os.path.join(out, f"PART_{start:03d}"))
        with open(os.path.join(out, "LastSnapNum.txt"), "w") as f:
            f.write(str(start))
        # (the rehearsal's own thresholds after MESH_SUB_SF: the last
        # value of a parameter holds)
        extra = MESH_SUB_SF + (STARS_REHEARSAL + BH_REHEARSAL_SEEDING
                               + MESH_SUB_REHEARSAL_FOF if self.rehearsal
                               else BH_SEEDING)
        pp = os.path.join(self.bh_dir, "p_mesh_sub.gadget")
        with open(pp, "w") as f:
            f.write(_GADGET_STARS.format(
                ic=os.path.join(self.bh_dir, "IC", "IC"), out=out,
                outputs=self.mesh_sub_run[0], a=self.mesh_sub_run[1])
                .replace("BlackHoleOn = 0", "BlackHoleOn = 1") + extra
                + f"UVFluctuationFile = {os.path.join(self.bh_dir, 'UVF')}\n")
        self.mesh_sub_start = (src, start)
        return pp, out

    def _mesh_sub(self, out):
        """The --mesh resume of star-small with every source but
        reionization, run by the rank after the gas run, and the checks
        of `stars` and `bh` that a --mesh run can show (it reads no gas,
        star or BH block, ROADMAP C.4): stars formed by splits and whole
        conversions (printed: at star-small's rates a row rarely forms
        twice in the run, so whole conversions are the CPU tests'), wind
        kicks (gas rows in the wind phase), the velocity
        dispersion refreshed on a PM step, a BH seeded at the seed mass
        and accreting, the feedback never lowering an entropy, the total
        mass from the start's PART to the end's within 1e-6 (swallowed
        gas lands on its BH), every field finite, every star and BH in a
        PIG group.  Printed per step beside `bh`'s at the same a: the
        Cooling, BH and MetalReturn seconds, each source stage's gathered
        pack and collectives.  Returns the run's pair-kernel launch
        shapes."""
        import os
        torch = self.torch
        from shenqi_tpu_torch.io.fofio import load_fof
        from shenqi_tpu_torch.io.snapshot import read_snapshot
        from shenqi_tpu_torch.physics.blackhole import BHParams
        rec = torch.load(os.path.join(out, "mesh_rank0.pt"),
                         map_location=self.dev, weights_only=False)
        self.mesh_launches += rec["launches"]
        src, start = self.mesh_sub_start
        amax = self.mesh_sub_run[1]
        logs = rec["source_log"]
        sf = [e for e in logs if e["stage"] == "sf"]
        split = sum(e["split"] for e in sf)
        whole = sum(e["whole"] for e in sf)
        kicks = sum(e["kicks"] for e in sf)
        vd = [e for e in logs if e["stage"] == "veldisp"]
        bhs = [e for e in logs if e["stage"] == "bh"]
        seeds = sum(n for _, _, n in rec["seed_log"])
        say("mesh", f"the --mesh 1 resume of the stars output with bh's "
            f"paramfile (RestartFlag 1, in the same rank): its set-up and run "
            f"{rec['run_s']:.2f} s, {rec['step_count']} steps to a={amax}, "
            f"snapshots at a = {rec['snapshots']}; p2p_blocked launches "
            f"{rec['launches']}; stars formed {rec['star_count']} ({split} "
            f"split, {whole} whole); wind kicks {kicks}, {rec['delayed']} gas"
            f" rows in the wind phase at the end; veldisp passes {len(vd)} "
            f"(iterations {[e['iterations'] for e in vd]}, ghosts "
            f"{[e['pack'] for e in vd]}), gas sigma {rec['vdisp'][0]:.4g}-"
            f"{rec['vdisp'][1]:.4g}; BHs seeded {seeds} at a = "
            f"{[round(a_, 5) for _, a_, _ in rec['seed_log']]}, BH masses "
            f"{rec['bh_mass'].tolist()}, mdot {rec['bh_mdot'].tolist()}; "
            f"collectives " + ", ".join(
                f"{k} {v}" for k, v in sorted(rec["counts"].items())))
        say("mesh", "  its SPH passes: " + "; ".join(
            f"step {r['step']}: {r['niter']} hsml iterations, density "
            f"{r['density_s']:.3f} s, hydro {r['hydro_s']:.3f} s, "
            f"{r.get('decoupled', 0)} decoupled" for r in rec["sph_log"]))
        say("mesh", "  its star formation: " + "; ".join(
            f"step {e['step']}: {e['active']} active gas rows, {e['on_eeos']}"
            f" on the eEOS, densest {e['rho_max']:.3g} x the threshold, "
            f"{e['split']} split + {e['whole']} whole, {e['kicks']} kicks"
            for e in sf))
        # per step beside bh's run at the same a
        mine = _cpu_steps(os.path.join(out, "cpu.txt"))
        mine.append((amax, rec["last_stages"]))
        theirs = {round(a_, 5): st_ for a_, st_ in _cpu_steps(
            os.path.join(src, "cpu.txt"))}
        for i, (a_, st_) in enumerate(mine):
            pk = ", ".join(f"{e['stage']} {e['pack']} rows {e['collectives']}"
                           f" coll. {e['s']:.3f} s"
                           for e in logs if e["step"] == i) or "none"
            ref = theirs.get(round(a_, 5))
            say("mesh", f"  step {i} at a={a_:.5f}: Cooling/BH/MetalReturn "
                + "/".join(f"{st_.get(k, 0.0):.3f}" for k in (
                    "Cooling", "BH", "MetalReturn"))
                + " s (bh " + ("/".join(f"{ref.get(k, 0.0):.3f}" for k in (
                    "Cooling", "BH", "MetalReturn")) + " s" if ref is not None
                    else "no step at this a") + f"); source stages {pk}")
        _, b0 = read_snapshot(os.path.join(src, f"PART_{start:03d}"))
        snap = f"PART_{self.mesh_sub_run[0].count(','):03d}"
        h1, b1 = read_snapshot(os.path.join(out, snap))
        m0 = sum(float(np.sum(b["Mass"], dtype=np.float64))
                 for b in b0.values())
        m1 = sum(float(np.sum(b["Mass"], dtype=np.float64))
                 for b in b1.values())
        dm = abs(m1 / m0 - 1)
        finite = rec["finite"] and all(
            np.isfinite(v).all() for b in b1.values() for v in b.values()
            if np.issubdtype(np.asarray(v).dtype, np.floating))
        n_star = len(b1[4]["ID"]) if 4 in b1 else 0
        n_bh = len(b1[5]["ID"]) if 5 in b1 else 0
        pig = load_fof(os.path.join(out, snap.replace("PART", "PIG")))
        lbt = (np.asarray(pig["LengthByType"]).sum(axis=0)
               if len(pig["Mass"]) else np.zeros(6))
        seed_m = np.float32(BHParams().SeedBlackHoleMass)
        say("mesh", f"  at a={h1.Time:.5f}: total mass {m1:.9g} against "
            f"{m0:.9g} at the start ({dm:.3e}, limit 1e-6); every field "
            f"finite {finite}; {n_star} stars and {n_bh} BHs, the PIG's "
            f"{int(lbt[4])} and {int(lbt[5])} in {len(pig['Mass'])} groups; "
            f"BH feedback: smallest entropy change "
            f"{min((e['dent_min'] for e in bhs), default=0.0):.4g}, rows "
            f"heated {[e['heated'] for e in bhs]}, swallowed "
            f"{[e['swallowed'] for e in bhs]}, mergers "
            f"{[e['mergers'] for e in bhs]}")
        fails = []
        if not (rec["star_count"] and split + whole):
            fails.append(f"stars formed {rec['star_count']} ({split} split, "
                         f"{whole} whole)")
        if not (kicks and rec["delayed"]):
            fails.append(f"wind kicks {kicks}, delayed rows {rec['delayed']}")
        if not (vd and rec["vdisp"][1] > 0):
            fails.append("no velocity dispersion on a PM step")
        if not (seeds and len(rec["bh_mass"])
                and (rec["bh_mass"] >= seed_m).all()
                and (rec["bh_mdot"] > 0).any()):
            fails.append("no BH seeded at the seed mass and accreting")
        if any(e["dent_min"] < 0 for e in bhs):
            fails.append("the BH feedback lowered an entropy")
        if not dm < 1e-6:
            fails.append(f"total mass off by {dm:.3e}")
        if not finite:
            fails.append("a field is not finite")
        if not (int(lbt[4]) == n_star and int(lbt[5]) == n_bh
                or self.rehearsal):
            fails.append("a star or BH lies outside the PIG's groups")
        if fails:
            raise SmokeFailure("the --mesh 1 subgrid run: " + "; ".join(fails))
        return rec["shapes"]

    # ------------------------------------------------------------ dmsmall
    def dmsmall(self):
        """dm-small as its paramfile stands (validation/dm_small.py:24-59):
        genic_main, then gadget_main RestartFlag 2 from z = 9 to
        DMSMALL_TIMEMAX with dm-small's OutputList 0.15,0.2,0.25 and FOF
        at each output it reaches, at the CLI defaults (hierarchical
        gravity); the EH table in place of class_pk_9.dat."""
        import tempfile
        tmp = tempfile.mkdtemp(prefix="shenqi_dmsmall_")
        try:
            self._dmsmall(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def _dmsmall(self, tmp):
        import os
        torch = self.torch
        from shenqi_tpu_torch.cli import gadget_main, genic_main
        from shenqi_tpu_torch.io.snapshot import read_snapshot
        from shenqi_tpu_torch.ops.p2p import p2p_blocked
        ng = self.n_dmsmall
        nmesh, box = 2 * ng, 1000.0 * ng
        pk = os.path.join(tmp, "pk_eh.txt")
        _eh_table(pk)
        out = os.path.join(tmp, "output")
        gp, pp = os.path.join(tmp, "p.genic"), os.path.join(tmp, "p.gadget")
        with open(gp, "w") as f:
            f.write(_GENIC.format(out=tmp, ng=ng, box=box, pk=pk))
        with open(pp, "w") as f:
            f.write(_GADGET.replace("OutputList = {a}",
                                    "OutputList = 0.15,0.2,0.25").format(
                ic=os.path.join(tmp, "IC", "IC"), out=out,
                a=DMSMALL_TIMEMAX, fof=1, nmesh=nmesh)
                + "PartAllocFactor = 2.0\nDensityIndependentSphOn = 0\n")
        dev = "cpu" if self.rehearsal else None
        t = time.perf_counter()
        ic = genic_main.run_genic(gp, device=dev)
        say("dmsmall", f"genic_main Ngrid {ng}, box {box:.0f} kpc/h: "
            f"{time.perf_counter() - t:.2f} s")
        hdr, blocks = read_snapshot(ic)
        p0 = (blocks[1]["Velocity"].astype(np.float64) * hdr.Time
              * hdr.MassTable[1]).sum(0)
        del blocks

        # the main path: counts set to 0 just before, read just after
        p2p_blocked.launches = 0
        t = time.perf_counter()
        with _Wrap(gadget_main, "fof", keep=True,
                   peak=not self.rehearsal) as fofw, \
                _RunRecorder(self._sync, syncs=not self.rehearsal) as rec:
            sim = gadget_main.run_gadget(pp, 2, device=dev)
        t2 = time.perf_counter() - t
        self.dmsmall_launches = p2p_blocked.launches
        steps = self._run_steps(out, sim)
        tot = dict(sorted(sim.walltime.total_acc.items()))
        nstep = len(steps) - 1
        per = rec.per_step()
        levels = [sum(c[0] == "level" for c in per.get(i, []))
                  for i in range(nstep + 1)]
        nbins = [len(b) for _, b in rec.bins]
        say("dmsmall", f"gadget_main RestartFlag 2, {ng ** 3} particles, "
            f"mesh {nmesh}, to a={sim.atime():.5f}: {t2:.2f} s, {nstep} "
            f"steps, {sum(c[1] == 'full' for c in rec.calls)} full passes "
            f"and {sum(levels)} active-source level calls, "
            f"{len(sim.power_history)} PM steps; stage totals "
            + ", ".join(f"{k} {v:.3f} s" for k, v in tot.items())
            + f"; p2p_blocked launches {self.dmsmall_launches} in "
            f"{len(rec.shapes)} shapes")
        allb = sorted({b for _, bb in rec.bins for b in bb})
        say("dmsmall", f"bins {allb[0]}-{allb[-1]} occupied over the run; "
            f"steps by their count of occupied bins "
            f"{_histogram(nbins)}, by their count of level calls "
            f"{_histogram(levels)}; first and last ten steps' bins: "
            + ", ".join(_bin_span(b) for _, b in rec.bins[:10]) + " ... "
            + ", ".join(_bin_span(b) for _, b in rec.bins[-10:]))
        # the cost of an active-source call by its target count, and of
        # a step's Tree stage (B.3)
        for lo, hi in ((0, 1e3), (1e3, 1e4), (1e4, 1e5), (1e5, 1e12)):
            sel = [c for c in rec.calls
                   if c[1] == "level" and lo <= c[2] < hi]
            if sel:
                say("dmsmall", f"level calls with {lo:.0e}-{hi:.0e} targets:"
                    f" {len(sel)}, {np.mean([c[4] for c in sel]):.4f} s "
                    f"each ({np.mean([c[3] for c in sel]):.1f} launches)")
        full = [c for c in rec.calls if c[1] == "full"]
        tree = [st_.get("Tree", 0.0) for _, st_ in steps]
        say("dmsmall", f"full passes {len(full)}, "
            f"{np.mean([c[4] for c in full]):.4f} s each; Tree per step "
            f"mean {np.mean(tree):.4f} s, max {np.max(tree):.4f} s; "
            f"step wall mean {t2 / max(nstep, 1):.4f} s")
        if rec.syncs:
            ds = np.diff([0] + rec.syncs)
            say("dmsmall", f"host syncs flagged by torch's sync debug mode"
                f" per step: mean {ds.mean():.1f}, max {ds.max()}, "
                f"total {int(ds.sum())}")
        for (g, args), sec, pk_ in zip(fofw.calls, fofw.each,
                                      fofw.peaks or [None] * len(fofw.calls)):
            fs = g.stats
            say("dmsmall", f"FOF at an output: {sec:.2f} s, {g.ngroups} "
                f"groups, largest {int(g.lengths[:1].sum())}, pair pass "
                f"{fs.pairs_s:.3f} s ({fs.pair_lanes} lanes, "
                f"{fs.links} links kept, repass {fs.repass}), "
                f"{fs.iterations} iterations, compile_groups "
                f"{fs.compile_s:.3f} s, peak device memory above its "
                "inputs " + (f"{pk_ / 2 ** 20:.1f} MiB" if pk_ is not None
                             else "not measured on the CPU"))
        if self.steps_log:
            with open(self.steps_log, "a") as f:
                for i, (a, stages) in enumerate(steps):
                    f.write(json.dumps({
                        "phase": "dmsmall", "step": i, "a": a,
                        "bins": dict(rec.bins).get(i),
                        "calls": per.get(i, []), "stages": stages}) + "\n")
        if abs(sim.atime() - DMSMALL_TIMEMAX) > 1e-6:
            raise SmokeFailure(f"dm-small ended at a={sim.atime()}")
        if len(fofw.calls) != len([a for a in (0.15, 0.2, 0.25)
                                   if a <= DMSMALL_TIMEMAX + 1e-9]):
            raise SmokeFailure("dm-small ran FOF at other than its outputs")
        if max(levels) < 2 or max(nbins) < 2:
            raise SmokeFailure("no step of dm-small used two or more levels")
        self._check_calls("dmsmall", rec)
        self._check_momentum("dmsmall", sim, p0)
        del sim
        self.dmsmall_row = self._check_shapes(rec.shapes, "dmsmall")
        del rec

    # ----------------------------------------------------------------- nu
    def nu(self):
        """The neutrino configuration: genic_main with NgridNu and
        DifferentTransferFunctions 1 on a written CLASS-layout transfer
        table, RestartFlag 4 (P(k) of the ICs), a short gadget_main run
        with MassiveNuLinRespOn 1 and one snapshot, then a RestartFlag 1
        resume from it for one step."""
        import tempfile
        tmp = tempfile.mkdtemp(prefix="shenqi_nu_")
        try:
            self._nu(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def _nu(self, tmp):
        import os
        torch = self.torch
        from shenqi_tpu_torch import simulation
        from shenqi_tpu_torch.cli import gadget_main, genic_main
        from shenqi_tpu_torch.cosmology.power import InputPower, DELTA_NU
        from shenqi_tpu_torch.io.bigfile import BigFile
        from shenqi_tpu_torch.io.snapshot import read_snapshot
        from shenqi_tpu_torch.ops.p2p import p2p_blocked
        from shenqi_tpu_torch.physics.neutrinos_lra import DeltaTotTable
        from shenqi_tpu_torch.utils.units import default_units
        ng, ngnu = self.n_nu, self.n_nu // 2
        nmesh, box, a_ic = 2 * ng, 300000.0, 0.01
        cp = _nu_cosmology()
        pk, tk = os.path.join(tmp, "pk_eh.txt"), os.path.join(tmp, "tk.txt")
        table = _eh_table(pk)
        _class_tk_table(tk, cp, a_ic)
        out = os.path.join(tmp, "output")
        gp = os.path.join(tmp, "p.genic")
        with open(gp, "w") as f:
            f.write(_GENIC_NU.format(out=tmp, ng=ng, ngnu=ngnu, pk=pk, tk=tk))
        pps = []
        for i, (outputs, amax) in enumerate(NU_RUNS):
            pps.append(os.path.join(tmp, f"p{i}.gadget"))
            with open(pps[-1], "w") as f:
                f.write(_GADGET.replace("OutputList = {a}",
                                        f"OutputList = {outputs}").replace(
                    "MassiveNuLinRespOn = 0", "MassiveNuLinRespOn = 1").format(
                    ic=os.path.join(tmp, "IC", "IC"), out=out, a=amax, fof=0,
                    nmesh=nmesh) + _GADGET_NU.format(tk=tk))
        dev = "cpu" if self.rehearsal else None
        t = time.perf_counter()
        with _Wrap(genic_main, "displacement_fields") as disp:
            ic = genic_main.run_genic(gp, device=dev)
        say("nu", f"genic_main Ngrid {ng} + NgridNu {ngnu}, box {box:.0f} "
            f"kpc/h, mesh {nmesh}: {time.perf_counter() - t:.2f} s "
            f"(displacement fields {disp.seconds:.2f} s in "
            f"{len(disp.each)} calls)")
        hdr, blocks = read_snapshot(ic)
        onu = cp.ONu.get_omega_nu(1.0)
        nufrac = float(np.asarray(hdr.extra["FractionNuInParticles"])[0])
        split = (hdr.MassTable[2] * ngnu ** 3) / (hdr.MassTable[1] * ng ** 3)
        want = nufrac * onu / (0.288 - onu)
        vnu = np.linalg.norm(blocks[2]["Velocity"], axis=1)
        vdm = np.linalg.norm(blocks[1]["Velocity"], axis=1)
        say("nu", f"mass split {split:.6g} (want {want:.6g}, limit 1e-3 "
            f"relative), FractionNuInParticles {nufrac:.6f}, neutrino "
            f"speeds median {np.median(vnu):.4g} km/s (limit > 3e4), max "
            f"{vnu.max():.6g} (cap {5000 * 100:.0f}), DM median "
            f"{np.median(vdm):.4g} km/s (limit < 300)")
        if not (abs(split / want - 1) < 1e-3 and 0.99 < nufrac <= 1.0
                and np.median(vnu) > 3e4 and vnu.max() <= 5000 * 100 * 1.001
                and np.median(vdm) < 300):
            raise SmokeFailure("the neutrino ICs fail tests/test_genic_nu.py"
                               "'s checks")
        m_cdm = hdr.MassTable[1] * ng ** 3
        m_nu = hdr.MassTable[2] * ngnu ** 3
        del blocks

        # RestartFlag 4: P(k) of all the particles against the input.
        # The CDM follows the table (DELTA_TOT), the neutrino particles
        # its DELTA_NU ratio as load_transfer reads it (three times each
        # column's, ROADMAP C.4), each weighted by its mass
        fn = gadget_main.run_gadget(pps[0], 4, device=dev)
        d = np.loadtxt(fn)
        knyq = np.pi * ng / (box / 1000.0)
        low = d[:, 0] < knyq / 4
        ip = InputPower.from_file(pk, cp, default_units().UnitLength_in_cm)
        ip.load_transfer(tk, a_ic)
        k_int = d[low, 0] / ip.mpc_scale
        r_nu = ip.delta_spec(k_int, DELTA_NU) / ip.delta_spec(k_int)
        f_nu = m_nu / (m_cdm + m_nu)
        want_pk = (np.interp(np.log(d[low, 0]), np.log(table[:, 0]),
                             table[:, 1]) * ((1 - f_nu) + f_nu * r_nu) ** 2)
        ratio = float((d[low, 2] * d[low, 3]).sum()
                      / (d[low, 2] * want_pk).sum())
        say("nu", f"RestartFlag 4: P(z=0) over the {int(low.sum())} bins "
            f"below a quarter of the particle Nyquist k, mode-weighted, / "
            f"the mass-weighted input = {ratio:.4f} (limit |1 - ratio| < "
            f"0.08); the neutrino ratio there {r_nu.min():.3g}-"
            f"{r_nu.max():.3g}, f_nu {f_nu:.4f}")
        if not abs(1 - ratio) < 0.08:
            raise SmokeFailure(f"nu IC P(k) off by {ratio - 1:+.3f}")

        # RestartFlag 2 with the linear response to the first output,
        # then RestartFlag 1 from it for one step (the resumed sync point's
        # pass and one more); the counts set to 0 just before the first
        # run, read after the second
        sync = self._sync
        p2p_blocked.launches = 0
        runs = []
        for pp_, flag, steps_ in ((pps[0], 2, 10 ** 9), (pps[1], 1, 2)):
            t = time.perf_counter()
            with _Wrap(simulation, "measure_cdm_power", sync=sync) as cdm, \
                    _Wrap(DeltaTotTable, "update") as upd, \
                    _Wrap(simulation.Simulation, "_nu_factor",
                          sync=sync) as nuf, \
                    _RunRecorder(sync) as rec:
                sim = gadget_main.run_gadget(pp_, flag, max_steps=steps_,
                                             device=dev)
            runs.append((sim, rec, time.perf_counter() - t, cdm, upd, nuf))
        self.nu_launches = p2p_blocked.launches
        (s1, r1, t1, cdm, upd, nuf), (s2, r2, t2, *_) = runs
        nt1, nt2 = s1.nu_table, s2.nu_table
        for j, (c_, u_, n_) in enumerate(zip(cdm.each, upd.each, nuf.each)):
            say("nu", f"PM step {j}: measure_cdm_power {c_:.4f} s, "
                f"DeltaTotTable.update {u_:.4f} s, the rest of the factor "
                f"(potential_factor, the nu3d mesh on the host, its copy) "
                f"{n_ - c_ - u_:.4f} s")
        say("nu", f"RestartFlag 2 with MassiveNuLinRespOn 1 to "
            f"a={s1.atime():.6f}: {t1:.2f} s, {s1.step_count} steps, "
            f"{len(s1.power_history)} PM steps, delta_tot "
            f"{nt1.delta_tot.shape}, {len(r1.calls)} force calls, at most "
            f"{max(len(b) for _, b in r1.bins)} occupied bins; RestartFlag 1 "
            f"for one step to a={s2.atime():.6f}: {t2:.2f} s, "
            f"{len(s2.power_history)} PM solves, delta_tot "
            f"{nt2.delta_tot.shape}; p2p_blocked launches "
            f"{self.nu_launches}")
        if nt1.delta_tot.shape[1] != len(s1.power_history):
            raise SmokeFailure("delta_tot did not gain one column per PM "
                               "step")
        saved = BigFile(os.path.join(out, "PART_000"))
        deltas = saved["Neutrino/Deltas"].read()
        scale = saved["Neutrino/Scalefact"].read()
        na = len(scale)
        # the resumed sync point's PM solve adds no column (its a is the
        # last one's); every later PM solve adds one
        if not (np.array_equal(deltas, nt1.delta_tot.ravel())
                and np.array_equal(nt2.scalefact[:na], scale)
                and np.array_equal(nt2.delta_tot[:, :na],
                                   deltas.reshape(-1, na))
                and nt2.delta_tot.shape[1]
                == na + len(s2.power_history) - 1):
            raise SmokeFailure("the resume did not restore and carry on the "
                               "saved neutrino history")
        for r in (r1, r2):
            self._check_calls("nu", r)
        shapes = dict(r1.shapes)
        for k, v in r2.shapes.items():
            shapes.setdefault(k, [0] + v[1:])[0] += v[0]
        del s1, s2, runs
        self.nu_row = self._check_shapes(shapes, "nu")
        del shapes, r1, r2

    # ---------------------------------------------------------------- gas
    def gas(self):
        """travis-hydro (validation/travis.py:38-98, adiabatic): genic_main
        with ProduceGas and DifferentTransferFunctions, RestartFlag 4, the
        run from z = 99 to a = 0.015 with outputs and FOF at 0.01, 0.012
        and 0.015, then a RestartFlag 1 resume from the last output for
        0.017 with CoolingOn, MetalCoolingOn and a MetalCoolFile.  Its
        directory stays for `mesh`; close() removes it."""
        import tempfile
        self.gas_dir = tempfile.mkdtemp(prefix="shenqi_gas_")
        self._gas(self.gas_dir)

    def _gas_files(self, tmp, ng):
        """The tables and the genic paramfile of travis-hydro at Ngrid ng;
        returns (genic paramfile, IC path, EH table path, tk path)."""
        import os
        pk, tk = os.path.join(tmp, "pk_eh.txt"), os.path.join(tmp, "tk.txt")
        _eh_table(pk)
        _class_tk_table(tk, _dm_small_cosmology(), GAS_A_IC)
        gp = os.path.join(tmp, "p.genic")
        with open(gp, "w") as f:
            f.write(_GENIC_GAS.format(out=tmp, ng=ng, pk=pk, tk=tk, dtf=1))
        return gp, os.path.join(tmp, "IC", "IC"), pk, tk

    def _gas_run(self, phase, pp, flag, max_steps=10 ** 9, syncs=False):
        """A gadget_main run of a gas paramfile with its force calls,
        kernel shapes, SPH passes and FOF recorded; returns (sim, seconds,
        run recorder, SPH recorder, FOF wrapper, peak device GiB)."""
        from shenqi_tpu_torch.cli import gadget_main
        torch = self.torch
        if not self.rehearsal:
            torch.cuda.reset_peak_memory_stats()
        dev = "cpu" if self.rehearsal else None
        t = time.perf_counter()
        with _Wrap(gadget_main, "fof", keep=True) as fofw, \
                _SphRecorder(self._sync) as sph, \
                _RunRecorder(self._sync, syncs=syncs) as rec:
            sim = gadget_main.run_gadget(pp, flag, max_steps=max_steps,
                                         device=dev)
        sec = time.perf_counter() - t
        mem = (torch.cuda.max_memory_allocated() / 2 ** 30
               if not self.rehearsal else float("nan"))
        self._check_calls(phase, rec)
        return sim, sec, rec, sph, fofw, mem

    def _sph_report(self, phase, sph, steps):
        """Per step the stages; per SPH pass its density walks (targets,
        seconds), cover-patched targets, long-reach sources and hydro
        seconds; the IC fixed point's iterations."""
        for i, (a, stages) in enumerate(steps):
            say(phase, f"  {'step ' + str(i) if i < len(steps) - 1 else 'end'}"
                f" at a={a:.5f}: stages " + ", ".join(
                    f"{k} {v:.3f} s" for k, v in sorted(stages.items())))
        for ps_ in sph.passes:
            say(phase, f"  SPH pass (step {ps_['step']}): {ps_['targets']} "
                f"targets, {ps_['seconds']:.3f} s; density {ps_['niter']} "
                f"iterations: " + ", ".join(f"{n} in {t_:.3f} s"
                                            for n, t_ in ps_["walks"])
                + f"; cover patches {ps_['density_cover']} density "
                f"sub-blocks, {ps_['cover_s']:.3f} s; "
                f"{ps_['hydro_cover']} hydro cover sub-blocks; "
                f"{ps_['long_reach']} long-reach sources; hydro "
                f"{ps_['hydro_s']:.3f} s")
        for fp in sph.fixed_points:
            say(phase, f"  IC entropy fixed point: {fp['iterations']} "
                f"iterations in {fp['seconds']:.3f} s "
                f"({fp['seconds'] / max(fp['iterations'] + 1, 1):.3f} s per"
                f" walk), converged {fp['converged']}, max relative change "
                f"per iteration " + ", ".join(f"{d:.2e}"
                                              for d in fp["maxdiff"]))

    def _gas(self, tmp):
        import os
        from shenqi_tpu_torch.cli import gadget_main, genic_main
        from shenqi_tpu_torch.io.bigfile import BigFile
        from shenqi_tpu_torch.io.snapshot import read_snapshot
        from shenqi_tpu_torch.ops.p2p import p2p_blocked
        from shenqi_tpu_torch.physics.uv_fluctuations import MetalCoolingTable
        from shenqi_tpu_torch.utils import constants as C
        torch = self.torch
        ng = self.n_gas
        gp, ic, pk, tk = self._gas_files(tmp, ng)
        out = os.path.join(tmp, "output")
        pps = []
        for i, (outputs, amax) in enumerate(GAS_RUNS):
            pps.append(os.path.join(tmp, f"p{i}.gadget"))
            pf = _GADGET_GAS.format(ic=ic, out=out, outputs=outputs, a=amax)
            if i:
                # the resume cools: the pure-cooling branch, the one that
                # reads a MetalCoolFile (a run with star formation never
                # does, in both packages)
                pf = pf.replace("CoolingOn = 0", "CoolingOn = 1") \
                    + GAS_RESUME_COOLING.format(metal=_metal_cool_table(
                        os.path.join(tmp, "MCool")))
            with open(pps[-1], "w") as f:
                f.write(pf)
        dev = "cpu" if self.rehearsal else None
        t = time.perf_counter()
        with _Wrap(genic_main, "displacement_fields") as disp:
            genic_main.run_genic(gp, device=dev)
        say("gas", f"genic_main Ngrid {ng} gas + DM ({2 * ng ** 3} "
            f"particles), box 128 Mpc/h, z = 99: "
            f"{time.perf_counter() - t:.2f} s (displacement fields "
            f"{disp.seconds:.2f} s in {len(disp.each)} calls)")
        hdr, blocks = read_snapshot(ic)
        if sorted(blocks) != [0, 1] or len(blocks[0]["ID"]) != ng ** 3:
            raise SmokeFailure("genic wrote no gas species")
        p0 = sum((blocks[t_]["Velocity"].astype(np.float64) * hdr.Time
                  * hdr.MassTable[t_]).sum(0) for t_ in (0, 1))
        del blocks
        # RestartFlag 4 and the per-species P(k) of the ICs
        t = time.perf_counter()
        fn = gadget_main.run_gadget(pps[0], 4, device=dev)
        say("gas", f"RestartFlag 4: {time.perf_counter() - t:.2f} s -> "
            f"{os.path.basename(fn)}")
        theory = _GasTheory(pk, tk)
        self._species_pk_check("gas", ic, GAS_A_IC, theory)

        # the main path: counts set to 0 just before, read just after
        p2p_blocked.launches = 0
        sim, t2, rec, sph, fofw, mem = self._gas_run(
            "gas", pps[0], 2, syncs=not self.rehearsal)
        self.gas_launches = p2p_blocked.launches
        steps = self._run_steps(out, sim)
        tot = dict(sorted(sim.walltime.total_acc.items()))
        say("gas", f"gadget_main RestartFlag 2, {2 * ng ** 3} particles, to "
            f"a={sim.atime():.5f}: {t2:.2f} s, {len(steps) - 1} steps, "
            f"{len(rec.calls)} force calls, {len(sph.passes)} SPH passes, "
            f"{len(sim.power_history)} PM steps, at most "
            f"{max(len(b) for _, b in rec.bins)} occupied bins; stage "
            f"totals " + ", ".join(f"{k} {v:.3f} s" for k, v in tot.items())
            + f"; p2p_blocked launches {self.gas_launches} in "
            f"{len(rec.shapes)} shapes; peak device memory {mem:.2f} GiB")
        self._sph_report("gas", sph, steps)
        if rec.syncs:
            ds = np.diff([0] + rec.syncs)
            say("gas", f"host syncs flagged by torch's sync debug mode per "
                f"step: mean {ds.mean():.1f}, max {ds.max()}, total "
                f"{int(ds.sum())}")
        for g_, _ in fofw.calls:
            say("gas", f"FOF at an output: {g_.ngroups} groups, "
                f"{int(g_.length_by_type[:, 0].sum()) if g_.ngroups else 0} "
                f"gas rows attached; " + _fof_line(g_.stats))
        self.gas_run = {"ic": ic, "out": out, "steps": len(steps) - 1,
                        "seconds": t2, "sph_s": tot.get("SPH", 0.0),
                        "groups": [g_.ngroups for g_, _ in fofw.calls],
                        "pks": sorted(f_ for f_ in os.listdir(out)
                                      if f_.startswith("powerspectrum-"))}
        if abs(sim.atime() - GAS_RUNS[0][1]) > 1e-6:
            raise SmokeFailure(f"travis-hydro ended at a={sim.atime()}")
        if len(fofw.calls) != 3 or not sph.fixed_points:
            raise SmokeFailure("travis-hydro ran FOF at other than its three "
                               "outputs, or no IC entropy fixed point")
        fp = sph.fixed_points[0]
        if not (fp["converged"] and fp["iterations"] <= 100):
            raise SmokeFailure(f"the IC entropy fixed point did not meet its "
                               f"1e-3 stop: {fp}")
        self._check_momentum("gas", sim, p0)
        # u0 from InitGasTemp = -1: the CMB temperature at the ICs
        u0 = (C.BOLTZMANN * 2.7255 / GAS_A_IC
              / (4.0 / (1 + 3 * C.HYDROGEN_MASSFRAC)) / C.PROTONMASS
              / C.GAMMA_MINUS1 / 1e10)
        for i, a in enumerate((0.01, 0.012, 0.015)):
            snap = os.path.join(out, f"PART_{i:03d}")
            self._gas_fields_check(snap, os.path.join(out, f"PIG_{i:03d}"),
                                   a, u0)
            self._species_pk_check("gas", snap, a, theory)
        del sim

        # RestartFlag 1 from the last output to 0.017: the restored
        # state is the saved one (no cold start, no fixed point)
        saved = BigFile(os.path.join(out, "PART_002"))
        u_saved = saved["0/InternalEnergy"].read()
        c0 = _cooling_counts()
        with _Wrap(MetalCoolingTable, "eval") as mcw:
            sim, t1, rec2, sph, _, _ = self._gas_run("gas", pps[1], 1)
        say("gas", _cooling_line(c0))
        ent = sim.gas.entropy
        say("gas", f"RestartFlag 1 from PART_002 to a={sim.atime():.6f} "
            f"with CoolingOn, MetalCoolingOn and a MetalCoolFile: {t1:.2f} "
            f"s, {len(sph.passes)} SPH passes, IC fixed points "
            f"{len(sph.fixed_points)}, Cooling "
            f"{sim.walltime.total_acc.get('Cooling', 0.0):.3f} s; the metal "
            f"table's lookup ran {len(mcw.each)} times (eager calls and "
            f"CUDA graph captures; travis's gas has no metals, so the lines "
            f"add 0 here)")
        if sph.fixed_points or not sim.atime() > GAS_RUNS[0][1] \
                or not np.isfinite(u_saved).all():
            raise SmokeFailure("the resume did not restore the gas state "
                               "and step on")
        if not mcw.each or not bool(torch.isfinite(ent).all()):
            raise SmokeFailure("the resume's cooling did not read the metal "
                               "table, or gave a non-finite entropy")
        del sim
        shapes = dict(rec.shapes)
        for k_, v in rec2.shapes.items():
            shapes.setdefault(k_, [0] + v[1:])[0] += v[0]
        del rec, rec2
        self.gas_row = self._check_shapes(shapes, "gas")

    def _gas_fields_check(self, snap, pig, a, u0):
        """The gas blocks of a PART finite and positive, the PIG's gas
        rows finite, and the median InternalEnergy within 5% of the
        adiabatic u0 (a_ic/a)^2 of gamma = 5/3 gas in linear flow."""
        from shenqi_tpu_torch.io.bigfile import BigFile
        bf = BigFile(snap)
        for name in ("SmoothingLength", "Density", "EgyWtDensity",
                     "InternalEnergy"):
            v = bf[f"0/{name}"].read()
            if not (np.isfinite(v).all() and (v > 0).all()):
                raise SmokeFailure(f"{snap}: gas {name} not finite and "
                                   f"positive")
        u = bf["0/InternalEnergy"].read()
        want = u0 * (GAS_A_IC / a) ** 2
        med = float(np.median(u))
        pg = BigFile(pig)
        gas_pig = [pg[f"0/{b}"].read() for b in ("Position", "Mass")
                   if f"0/{b}" in pg]
        say("gas", f"  a={a}: gas fields finite and positive; median "
            f"InternalEnergy {med:.6g} / adiabatic u0 (a_ic/a)^2 "
            f"{want:.6g} = {med / want:.4f} (limit 5%); PIG gas rows "
            f"{len(gas_pig[1]) if len(gas_pig) > 1 else 0}")
        if not all(np.isfinite(x).all() for x in gas_pig):
            raise SmokeFailure(f"{pig}: gas rows not finite")
        if not abs(med / want - 1) < 0.05:
            raise SmokeFailure(f"{snap}: the gas did not cool adiabatically")

    def _species_pk_check(self, phase, snap, a, theory):
        """P(k) of each species as travis.py species_power measures it
        (compensated CIC, mesh 128, bins of 2 pi / L) on the port's CIC,
        on bins 2:5, against the species' linear spectrum: CDM within 4%,
        baryons within 12% (validation/travis.py:266-276)."""
        from shenqi_tpu_torch.io.bigfile import BigFile
        bf = BigFile(snap)
        res = []
        for label, t_, rtol in (("cdm", 1, 0.04), ("bar", 0, 0.12)):
            kk, pk = _species_power(bf[f"{t_}/Position"].read(), 128.0,
                                    self.dev)
            want = theory.pk(label, kk[2:5], a)
            ratio = pk[2:5] / want
            res.append(f"{label} {np.round(ratio, 4).tolist()} "
                       f"(limit {rtol:.0%})")
            if not np.all(np.abs(ratio - 1) < rtol):
                raise SmokeFailure(f"{snap}: {label} P(k) off its linear "
                                   f"spectrum: {ratio}")
        say(phase, f"  P(k) at a={a} on bins 2:5 / linear theory: "
            + "; ".join(res))

    def gas128(self):
        """travis-hydro at Ngrid 128 (2 x 128^3 particles): genic_main, the
        IC entropy fixed point and the first loop pass.  (Its all-active
        SPH pass timed by piece, and before that under torch.profiler,
        went for the budget; PERF.md keeps their
        numbers.)"""
        import tempfile
        tmp = tempfile.mkdtemp(prefix="shenqi_gas128_")
        try:
            self._gas128(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def _gas128(self, tmp):
        import os
        from shenqi_tpu_torch.cli import genic_main
        from shenqi_tpu_torch.ops.p2p import p2p_blocked
        ng = self.n_gas128
        gp, ic, pk, tk = self._gas_files(tmp, ng)
        out = os.path.join(tmp, "output")
        pp = os.path.join(tmp, "p.gadget")
        with open(pp, "w") as f:
            # the first output at the end, so the passes taken write none
            f.write(_GADGET_GAS.format(ic=ic, out=out, outputs="0.015",
                                       a=0.015))
        dev = "cpu" if self.rehearsal else None
        t = time.perf_counter()
        genic_main.run_genic(gp, device=dev)
        say("gas128", f"genic_main Ngrid {ng} gas + DM ({2 * ng ** 3} "
            f"particles): {time.perf_counter() - t:.2f} s")
        p2p_blocked.launches = 0
        sim, t2, rec, sph, _, mem = self._gas_run(
            "gas128", pp, 2, max_steps=GAS128_STEPS,
            syncs=not self.rehearsal)
        self.gas128_launches = p2p_blocked.launches
        steps = self._run_steps(out, sim)
        tot = dict(sorted(sim.walltime.total_acc.items()))
        say("gas128", f"gadget_main RestartFlag 2 for {GAS128_STEPS} loop "
            f"passes, to a={sim.atime():.6f}: {t2:.2f} s, "
            f"{len(rec.calls)} force calls, {len(sph.passes)} SPH passes; "
            f"stage totals " + ", ".join(f"{k} {v:.3f} s"
                                        for k, v in tot.items())
            + f"; p2p_blocked launches {self.gas128_launches}; peak device "
            f"memory {mem:.2f} GiB")
        self._sph_report("gas128", sph, steps)
        if rec.syncs:
            ds = np.diff([0] + rec.syncs)
            say("gas128", f"host syncs per step: {ds.tolist()}")
        fp = sph.fixed_points[0] if sph.fixed_points else {}
        if not (fp.get("converged") and fp["iterations"] <= 100):
            raise SmokeFailure(f"the 128^3 IC entropy fixed point did not "
                               f"converge: {fp}")
        self.gas128_row = self._check_shapes(rec.shapes, "gas128")

    # -------------------------------------------------------------- stars
    def stars(self):
        """star-small (validation/star_small.py:36-77): genic_main with
        ProduceGas, then gadget_main RestartFlag 2 from z = 9 with
        CoolingOn, StarformationOn, WindOn (ofjt10), MetalReturnOn,
        pressure-entropy SPH and FOF at each output, to STARS_RUNS[0].
        Cuts: BlackHoleOn 0 here (the `bh`
        phase resumes from this run's last output with it on); the EH
        table, normalized as `dmsmall`'s, for class_pk_9.dat; the run ends
        at STARS_RUNS[0][1] instead of 0.2 (OutputList cut to match); no
        TreeCoolFile, as in the example.  The output directory stays for
        `bh`, whose resume checks the star rows restored exactly."""
        import tempfile
        tmp = tempfile.mkdtemp(prefix="shenqi_stars_")
        try:
            self._stars(tmp)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self.stars_dir = tmp

    def _stars(self, tmp):
        import os
        torch = self.torch
        from shenqi_tpu_torch.cli import gadget_main, genic_main
        from shenqi_tpu_torch.io.snapshot import read_snapshot
        from shenqi_tpu_torch.ops.p2p import p2p_blocked
        ng = self.n_stars
        pk = os.path.join(tmp, "pk_eh.txt")
        _eh_table(pk)
        gp = os.path.join(tmp, "p.genic")
        with open(gp, "w") as f:
            f.write(_GENIC_STARS.format(out=tmp, ng=ng, pk=pk))
        ic = os.path.join(tmp, "IC", "IC")
        out = os.path.join(tmp, "output")
        pps = []
        runs = STARS_REHEARSAL_RUNS if self.rehearsal else STARS_RUNS
        for i, (outputs, amax) in enumerate(runs):
            pps.append(os.path.join(tmp, f"p{i}.gadget"))
            with open(pps[-1], "w") as f:
                f.write(_GADGET_STARS.format(ic=ic, out=out,
                                             outputs=outputs, a=amax)
                        + (STARS_REHEARSAL if self.rehearsal else ""))
        dev = "cpu" if self.rehearsal else None
        t = time.perf_counter()
        genic_main.run_genic(gp, device=dev)
        say("stars", f"genic_main Ngrid {ng} gas + DM ({2 * ng ** 3} "
            f"particles), box 5000 kpc/h, z = 9: "
            f"{time.perf_counter() - t:.2f} s")
        hdr, blocks = read_snapshot(ic)
        m_ic = sum(float(np.sum(blocks[t_]["Mass"], dtype=np.float64))
                   if "Mass" in blocks[t_] else
                   hdr.MassTable[t_] * len(blocks[t_]["ID"])
                   for t_ in blocks)
        del blocks

        # the main path: counts set to 0 just before, read just after
        if not self.rehearsal:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        live = {"t": t, "sim": None}

        def step_line(fn, wt, fd, a):
            # one line as each step ends (host values only: no sync), and
            # the budget
            sim_ = live["sim"]
            now = time.perf_counter()
            say("stars", f"  live: step {sim_.step_count if sim_ else '-'} "
                f"to a={a:.5f} in {now - live['t']:.2f} s, "
                f"{len(getattr(sim_, 'star_formation_times', []))} stars so"
                f" far; " + ", ".join(f"{k} {v:.2f}" for k, v in
                                      sorted(wt.step_acc.items())))
            live["t"] = now
            check_budget("stars run", self.budget)
            return fn(wt, fd, a)

        def catch(fn, sim_, *a, **kw):
            live["sim"] = sim_
            return fn(sim_, *a, **kw)

        # the main path: counts set to 0 just before, read just after
        p2p_blocked.launches = 0
        with _Wrap(gadget_main, "fof", keep=True) as fofw, \
                _Wrap(gadget_main._DeviceWalltime, "write_cpu_log",
                      through=step_line), \
                _Wrap(gadget_main.Simulation, "run", through=catch), \
                _StarRecorder() as srec, _SphRecorder(self._sync) as sph, \
                _RunRecorder(self._sync, syncs=not self.rehearsal) as rec:
            c0 = _cooling_counts()
            sim = gadget_main.run_gadget(pps[0], 2, device=dev)
        t2 = time.perf_counter() - t
        say("stars", _cooling_line(c0))
        self.stars_launches = p2p_blocked.launches
        mem = (torch.cuda.max_memory_allocated() / 2 ** 30
               if not self.rehearsal else float("nan"))
        steps = self._run_steps(out, sim)
        tot = dict(sorted(sim.walltime.total_acc.items()))
        per = srec.per_step()
        say("stars", f"gadget_main RestartFlag 2, {2 * ng ** 3} particles, "
            f"to a={sim.atime():.5f}: {t2:.2f} s, {len(steps) - 1} steps, "
            f"{len(rec.calls)} force calls, {len(sim.power_history)} PM "
            f"steps; stage totals " + ", ".join(
                f"{k} {v:.3f} s" for k, v in tot.items())
            + f"; p2p_blocked launches {self.stars_launches} in "
            f"{len(rec.shapes)} shapes; peak device memory {mem:.2f} GiB")
        syncs = np.diff([0] + rec.syncs) if rec.syncs else []
        for i, (a, stages) in enumerate(steps):
            st_ = per.get(i, {})
            say("stars", f"  {'step ' + str(i) if i < len(steps) - 1 else 'end'}"
                f" at a={a:.5f}: stars formed {st_.get('split', 0)} split + "
                f"{st_.get('whole', 0)} whole, {st_.get('sf_rows', 0)} "
                f"star-forming rows, wind kicks {st_.get('kicks', 0)}, "
                f"metal return {st_.get('mr_stars', 0)} active stars "
                f"returning {st_.get('returned', 0.0):.4g}; host syncs "
                + (f"{syncs[i]}" if i < len(syncs) else "-")
                + "; stages " + ", ".join(f"{k} {v:.3f} s"
                                          for k, v in sorted(stages.items())))
        if len(syncs):
            say("stars", f"host syncs per step (torch's sync debug mode): "
                f"mean {np.mean(syncs):.1f}, max {np.max(syncs)}")
        walks = [w for ps_ in sph.passes for w in ps_["walks"]]
        full = [sec for n, sec in walks if n > ng ** 3 // 2]
        say("stars", f"SPH: {len(sph.passes)} passes, {len(walks)} density "
            f"walks ({len(full)} of over half the gas, "
            f"{np.sum(full) if full else 0:.2f} s; the rest "
            f"{sum(sec for _, sec in walks) - np.sum(full):.2f} s), "
            f"density iterations per pass "
            f"{_histogram([ps_['niter'] for ps_ in sph.passes])}, cover "
            f"patches {sum(p_['cover_s'] for p_ in sph.passes):.2f} s, "
            f"hydro {sum(p_['hydro_s'] for p_ in sph.passes):.2f} s, "
            f"{sum(p_['hydro_cover'] for p_ in sph.passes)} hydro cover "
            f"sub-blocks, {sum(p_['long_reach'] for p_ in sph.passes)} "
            f"long-reach sources")
        born = list(getattr(sim, "star_formation_times", []))
        tot_s = srec.totals()
        say("stars", f"stars formed {len(born)} ({tot_s['split']} split, "
            f"{tot_s['whole']} whole), the first at a="
            + (f"{min(born):.5f}" if born else "-")
            + f"; wind kicks {tot_s['kicks']}; metal-return calls "
            f"{tot_s['mr_calls']} with {tot_s['mr_star_lanes']} active-star "
            f"lanes, returned {tot_s['returned']:.6g}, gas received "
            f"{tot_s['received']:.6g} (the weights' cubic sums against the "
            f"run's kernel, ROADMAP C.4)")
        for g_, _ in fofw.calls:
            say("stars", f"FOF at an output: {g_.ngroups} groups, "
                f"{int(g_.length_by_type[:, 4].sum()) if g_.ngroups else 0}"
                f" star rows in groups; " + _fof_line(g_.stats))
        p = sim.particles
        m_end = float(p.mass.double()[p.mask].sum())
        dm_rel = abs(m_end - m_ic) / m_ic
        say("stars", f"total mass {m_end:.9g} against the ICs' {m_ic:.9g}: "
            f"relative change {dm_rel:.3e} (limit 1e-6)")
        # the checks of the run (validation/star_small.py's criteria that
        # a run to this a can meet)
        if born:
            say("stars", f"the first star at a={min(born):.5f}: star-small's"
                f" criterion, before a = {STARS_FIRST_BY} "
                f"(check_results.py, met on the reference's CLASS table), "
                + ("met" if min(born) < STARS_FIRST_BY else
                   "not met with the EH table"))
        if not born:
            raise SmokeFailure("no star formed in the star-small run")
        if tot_s["kicks"] < 1:
            raise SmokeFailure("no wind kick in the star-small run")
        if not tot_s["returned"] > 0:
            raise SmokeFailure("no metal-return call returned mass")
        if not dm_rel < 1e-6:
            raise SmokeFailure(f"total mass changed by {dm_rel:.3e}")
        if abs(sim.atime() - runs[0][1]) > 1e-6:
            raise SmokeFailure(f"star-small ended at a={sim.atime()}")
        lines = [ln.split() for ln in open(os.path.join(out, "sfr.txt"))
                 if not ln.startswith("#")]
        say("stars", f"sfr.txt: {len(lines)} lines, the last "
            + (" ".join(lines[-1]) if lines else "-"))
        if not lines or any(len(ln) != 8 for ln in lines):
            raise SmokeFailure("sfr.txt has no line in the 8-column format")
        n_out = len(runs[0][0].split(","))
        if len(fofw.calls) != n_out:
            raise SmokeFailure("star-small ran FOF at other than its outputs")
        for i in range(n_out):
            self._star_fields_check(os.path.join(out, f"PART_{i:03d}"),
                                    os.path.join(out, f"PIG_{i:03d}"))
        self._check_calls("stars", rec)
        del sim
        shapes = dict(rec.shapes)
        del rec
        self.stars_row = self._check_shapes(shapes, "stars")

    # ----------------------------------------------------------------- bh
    def bh(self):
        """star-small with BlackHoleOn 1 (every BH parameter at its
        default: BH_DynFrictionMethod 1, BH_DRAG 1, WriteBlackHoleDetails
        1) and a UVFluctuationFile resumed with RestartFlag 1 from the
        `stars` run's last output (a = 0.1178, which holds stars) to
        BH_RUNS[0]'s output with FOF.  The one cut: the seeding thresholds (BH_SEEDING).  The resume does the
        `stars` resume's checks (the star rows restored exactly); the
        `reion` phase resumes from its output and checks the BH rows."""
        if self.stars_dir is None:
            raise SmokeFailure("bh needs the stars phase's output")
        tmp, self.stars_dir = self.stars_dir, None
        try:
            self._bh(tmp)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        # the reion phase resumes from the bh run's output
        self.bh_dir = tmp

    def _bh_groups(self, pig):
        """The FOF groups of a PIG that hold stars: (mass, stellar mass)
        each, largest first."""
        from shenqi_tpu_torch.io.bigfile import BigFile
        pg = BigFile(pig)
        if "FOFGroups/Mass" not in pg:
            return []
        m = pg["FOFGroups/Mass"].read()
        mbt = pg["FOFGroups/MassByType"].read()
        return sorted(((float(a), float(b)) for a, b in zip(m, mbt[:, 4])
                       if b > 0), reverse=True)

    def _bh(self, tmp):
        import os
        torch = self.torch
        from shenqi_tpu_torch.cli import gadget_main
        from shenqi_tpu_torch import simulation_gas as sg
        from shenqi_tpu_torch.io.bigfile import BigFile
        from shenqi_tpu_torch.io.snapshot import read_snapshot
        from shenqi_tpu_torch.ops.p2p import p2p_blocked
        from shenqi_tpu_torch.utils.stats import BH_DETAIL_DTYPE
        GP = sg.GasPhysics
        out = os.path.join(tmp, "output")
        ic = os.path.join(tmp, "IC", "IC")
        runs = BH_REHEARSAL_RUNS if self.rehearsal else BH_RUNS
        seeding = (STARS_REHEARSAL + BH_REHEARSAL_SEEDING if self.rehearsal
                   else BH_SEEDING)
        with open(os.path.join(out, "LastSnapNum.txt")) as f:
            start = int(f.read().strip())
        groups0 = self._bh_groups(os.path.join(out, f"PIG_{start:03d}"))
        say("bh", f"PIG_{start:03d}: {len(groups0)} groups hold stars, "
            f"(mass, stellar mass) in 1e10 Msun/h: " + ", ".join(
                f"({a:.4g}, {b:.4g})" for a, b in groups0[:12])
            + f"; the seeding thresholds {seeding.strip()!r} "
            f"(star-small's: 2 and 5e-4)")
        # the fluctuating UVB: per-row rates gated on a z_reion table
        uvf = _zreion_table(os.path.join(tmp, "UVF"), 5.0)
        pps = []
        for i, (outputs, amax) in enumerate(runs):
            pps.append(os.path.join(tmp, f"bh{i}.gadget"))
            with open(pps[-1], "w") as f:
                f.write(_GADGET_STARS.format(ic=ic, out=out, outputs=outputs,
                                             a=amax)
                        .replace("BlackHoleOn = 0", "BlackHoleOn = 1")
                        + seeding + f"UVFluctuationFile = {uvf}\n")
        _, saved0 = read_snapshot(os.path.join(out, f"PART_{start:03d}"))
        m_start = sum(float(np.sum(b["Mass"], dtype=np.float64))
                      for b in saved0.values())
        n_cpu0 = len(_cpu_steps(os.path.join(out, "cpu.txt")))
        dev = "cpu" if self.rehearsal else None
        seeds, bhsteps, feedback, fofs, got0 = [], [], [], [], {}
        uvrows = []
        live = {"t": time.perf_counter(), "sim": None}

        def on_local_uvbg(fn, uv, zreion, redshift):
            # rows the table reionized by now, of all (no host sync here)
            uvrows.append(torch.stack([(zreion >= redshift).sum(),
                                       torch.tensor(zreion.numel(),
                                                    device=zreion.device)]))
            return fn(uv, zreion, redshift)

        def on_seed(fn, gp, sim_, gas, rows):
            out_ = fn(gp, sim_, gas, rows)
            r = torch.as_tensor(np.asarray(rows, np.int64), device=sim_.device)
            seeds.append((sim_.step_count, sim_.atime(),
                          np.asarray(rows, np.int64),
                          sim_.particles.ids64()[np.asarray(rows)],
                          out_.bh_mass[r].cpu().numpy(),
                          sim_.particles.ptype[r].cpu().numpy()))
            return out_

        def on_bh_step(fn, gp, sim_, *a, **kw):
            t = time.perf_counter()
            out_ = fn(gp, sim_, *a, **kw)
            bhsteps.append((sim_.step_count, dict(gp.last_bh_stats),
                            time.perf_counter() - t))
            return out_

        def on_feedback(fn, *a, **kw):
            dent = fn(*a, **kw)
            feedback.append(torch.stack([dent.min(), (dent > 0).sum().to(
                dent.dtype), torch.isfinite(dent).all().to(dent.dtype)]))
            return dent

        def on_fof(fn, *a, **kw):
            # a seeding search runs from the PM-step hook, the others at
            # an output
            f, kind = sys._getframe(1), "at an output"
            while f is not None:
                if f.f_code.co_name == "on_pm_step":
                    kind = "the seeding search of a PM step"
                    break
                f = f.f_back
            t = time.perf_counter()
            g_ = fn(*a, **kw)
            sim_ = live["sim"]
            fofs.append((sim_.step_count, sim_.atime(), g_.ngroups,
                         time.perf_counter() - t, kind))
            return g_

        def on_restore(fn, sim_, *a, **kw):
            fn(sim_, *a, **kw)
            g = sim_.gas
            rows = torch.nonzero(sim_.particles.ptype == 4).squeeze(1)
            got0.update({k: getattr(g, k)[rows].cpu().numpy() for k in (
                "birth_a", "star_metallicity", "total_returned",
                "last_enrich_myr")})

        def catch(fn, sim_, *a, **kw):
            live["sim"] = sim_
            return fn(sim_, *a, **kw)

        def step_line(fn, wt, fd, a):
            sim_ = live["sim"]
            now = time.perf_counter()
            st_ = bhsteps[-1][1] if bhsteps else {}
            say("bh", f"  live: step {sim_.step_count if sim_ else '-'} to "
                f"a={a:.5f} in {now - live['t']:.2f} s, {st_.get('nbh', 0)} "
                f"BHs; " + ", ".join(f"{k} {v:.2f}" for k, v in
                                     sorted(wt.step_acc.items())))
            live["t"] = now
            check_budget("bh run", self.budget)
            return fn(wt, fd, a)

        if not self.rehearsal:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        # the main path: counts set to 0 just before, read just after
        p2p_blocked.launches = 0
        with _Wrap(GP, "seed_bh", through=on_seed), \
                _Wrap(GP, "blackhole_step", through=on_bh_step), \
                _Wrap(sg, "bh_thermal_feedback", through=on_feedback), \
                _Wrap(sg, "local_uvbg", through=on_local_uvbg), \
                _Wrap(gadget_main, "fof", through=on_fof), \
                _Wrap(gadget_main, "_restore_gas_state", through=on_restore), \
                _Wrap(gadget_main._DeviceWalltime, "write_cpu_log",
                      through=step_line), \
                _Wrap(gadget_main.Simulation, "run", through=catch), \
                _RunRecorder(self._sync, syncs=not self.rehearsal) as rec:
            c0 = _cooling_counts()
            sim = gadget_main.run_gadget(pps[0], 1, device=dev)
        t_run = time.perf_counter() - t
        say("bh", _cooling_line(c0))
        self.bh_launches = p2p_blocked.launches
        mem = (torch.cuda.max_memory_allocated() / 2 ** 30
               if not self.rehearsal else float("nan"))
        # the start restored the star rows exactly (the stars phase's own
        # resume check)
        for name, key in (("StellarFormationTime", "birth_a"),
                          ("Metallicity", "star_metallicity"),
                          ("TotalMassReturned", "total_returned"),
                          ("LastEnrichmentMyr", "last_enrich_myr")):
            if not np.array_equal(got0.get(key), saved0[4][name]):
                raise SmokeFailure(f"the resume did not restore the stars' "
                                   f"{name}")
        say("bh", f"RestartFlag 1 from PART_{start:03d} (a = "
            f"{STARS_RUNS[0][1] if not self.rehearsal else 'rehearsal'}): "
            f"the {len(saved0[4]['ID'])} star rows' StellarFormationTime, "
            f"Metallicity, TotalMassReturned and LastEnrichmentMyr restored "
            f"exactly")
        steps = self._run_steps(out, sim)[n_cpu0:]
        tot = dict(sorted(sim.walltime.total_acc.items()))
        say("bh", f"gadget_main RestartFlag 1 with BlackHoleOn to a="
            f"{sim.atime():.5f}: {t_run:.2f} s, {len(steps) - 1} steps, "
            f"{len(rec.calls)} force calls; stage totals " + ", ".join(
                f"{k} {v:.3f} s" for k, v in tot.items())
            + f"; p2p_blocked launches {self.bh_launches} in "
            f"{len(rec.shapes)} shapes; peak device memory {mem:.2f} GiB")
        syncs = np.diff([0] + rec.syncs) if rec.syncs else []
        per = {}
        for step, st_, sec in bhsteps:
            per.setdefault(step, []).append((st_, sec))
        seeded_at = {s_[0]: len(s_[2]) for s_ in seeds}
        fb = [v.tolist() for v in feedback]
        for i, (a, stages) in enumerate(steps):
            k = i + sim.step_count - (len(steps) - 1)
            b = per.get(k, [])
            say("bh", f"  {'step ' + str(k) if i < len(steps) - 1 else 'end'}"
                f" at a={a:.5f}: BH stage {stages.get('BH', 0.0):.3f} s, "
                f"BHs {b[-1][0]['nbh'] if b else 0}, seeded "
                f"{seeded_at.get(k, 0)}, swallowed "
                f"{sum(x[0]['swallowed'] for x in b)}, mergers "
                f"{sum(x[0]['mergers'] for x in b)}; host syncs "
                + (f"{syncs[i]}" if i < len(syncs) else "-")
                + "; stages " + ", ".join(
                    f"{n} {v:.3f} s" for n, v in sorted(stages.items())
                    if n != "BH"))
        bh_s = [x[2] for x in bhsteps]
        say("bh", f"BH stage: {len(bhsteps)} calls, "
            f"{sum(1 for x in bhsteps if x[1]['nbh'])} with BHs, "
            f"{np.sum(bh_s):.3f} s in all (max "
            f"{np.max(bh_s) if bh_s else 0:.3f} s); swallowed rows "
            f"{sum(x[1]['swallowed'] for x in bhsteps)}, mergers "
            f"{sum(x[1]['mergers'] for x in bhsteps)}")
        for step, a, ng_, sec, kind in fofs:
            say("bh", f"  FOF at step {step}, a={a:.5f} ({kind}): {ng_} "
                f"groups in {sec:.3f} s")
        if len(syncs):
            say("bh", f"host syncs per step (torch's sync debug mode): "
                f"mean {np.mean(syncs):.1f}, max {np.max(syncs)}")

        # the checks
        uvr = [x.tolist() for x in uvrows]
        say("bh", f"UVFluctuationFile (z_reion 6 in one octant, 10 "
            f"elsewhere): {len(uvr)} source steps read per-row rates, gas "
            f"rows reionized of all " + ", ".join(
                f"{a}/{b}" for a, b in uvr[:3]) + (" ..." if len(uvr) > 3
                                                   else ""))
        if not uvr or not all(0 < a < b for a, b in uvr):
            raise SmokeFailure("the fluctuating UVB's per-row rates did not "
                               "run, or did not split the gas by z_reion")
        if not seeds:
            raise SmokeFailure("no BH was seeded in the bh run")
        seed_mass = np.float32(2e-5)
        for step, a, rows, ids, bhm, pt in seeds:
            say("bh", f"seeded {len(rows)} BHs at step {step}, a={a:.5f}: "
                f"rows {rows.tolist()}, IDs {ids.tolist()}, subgrid masses "
                f"{bhm.tolist()}")
            if not ((bhm == seed_mass).all() and (pt == 5).all()):
                raise SmokeFailure("a seeded row is not a BH at the seed "
                                   "mass")
        seed_a = seeds[0][1]
        # a BH seeded at the run's last step has no record: the loop ends
        # before that step's statistics
        seed_ids = np.concatenate([s_[3] for s_ in seeds
                                   if s_[1] < runs[0][1] - 1e-9])
        lines = [ln.split() for ln in open(os.path.join(out,
                                                        "blackholes.txt"))]
        say("bh", f"blackholes.txt: {len(lines)} lines, the first "
            + " ".join(lines[0] if lines else ["-"]) + ", the last "
            + " ".join(lines[-1] if lines else ["-"]))
        if not lines or any(len(ln) != 6 for ln in lines):
            raise SmokeFailure("blackholes.txt has no line in the 6-column "
                               "format")
        if abs(float(lines[0][0]) - seed_a) > 1e-5 * seed_a \
                or int(lines[0][1]) != len(seeds[0][2]) \
                or not float(lines[0][2]) >= len(seeds[0][2]) * seed_mass:
            raise SmokeFailure("blackholes.txt does not begin at the "
                               "seeding step with its BHs and mass")
        det = np.fromfile(os.path.join(out, "BlackholeDetails.bin"),
                          dtype=BH_DETAIL_DTYPE)
        say("bh", f"BlackholeDetails.bin: {len(det)} records of "
            f"{BH_DETAIL_DTYPE.itemsize} bytes, IDs "
            f"{sorted(set(det['ID'].tolist()))}, masses "
            f"{det['Mass'].min():.6g}-{det['Mass'].max():.6g}, mdot "
            f"{det['Mdot'].min():.4g}-{det['Mdot'].max():.4g}")
        if os.path.getsize(os.path.join(out, "BlackholeDetails.bin")) \
                != len(det) * 52 or set(det["ID"].tolist()) \
                != set(seed_ids.tolist()):
            raise SmokeFailure("BlackholeDetails.bin's records are not the "
                               "seeded BHs' in the JAX layout")
        if not (np.isfinite(det["Mdot"]).all() and (det["Mdot"] > 0).all()
                and det["Mass"].max() > seed_mass):
            raise SmokeFailure("the BHs did not accrete (mdot > 0, mass "
                               "above the seed)")
        fmin = min((x[0] for x in fb), default=0.0)
        nheat = sum(int(x[1]) for x in fb)
        say("bh", f"feedback: {len(fb)} passes, {nheat} gas rows heated in "
            f"all, the smallest entropy change {fmin:.4g}")
        if not (fb and nheat > 0 and fmin >= 0 and all(x[2] for x in fb)):
            raise SmokeFailure("the BH feedback did not raise the gas "
                               "entropy, or lowered it")
        p = sim.particles
        m_end = float(p.mass.double()[p.mask].sum())
        dm_rel = abs(m_end - m_start) / m_start
        say("bh", f"total mass {m_end:.9g} against PART_{start:03d}'s "
            f"{m_start:.9g}: relative change {dm_rel:.3e} (limit 1e-6)")
        if not dm_rel < 1e-6:
            raise SmokeFailure(f"total mass changed by {dm_rel:.3e}")
        if abs(sim.atime() - runs[0][1]) > 1e-6:
            raise SmokeFailure(f"the bh run ended at a={sim.atime()}")
        n_out = len(runs[0][0].split(","))
        snap = os.path.join(out, f"PART_{n_out - 1:03d}")
        pig = os.path.join(out, f"PIG_{n_out - 1:03d}")
        self._star_fields_check(snap, pig, "bh")
        bf, pg = BigFile(snap), BigFile(pig)
        bh_ids = bf["5/ID"].read() if "5/ID" in bf else np.zeros(0)
        for name in ("Position", "Velocity", "Mass", "BlackholeMass",
                     "BlackholeAccretionRate"):
            if bh_ids.size and not np.isfinite(bf[f"5/{name}"].read()).all():
                raise SmokeFailure(f"{snap}: BH {name} not finite")
        in_pig = pg["5/ID"].read() if "5/ID" in pg else np.zeros(0)
        lbt = (pg["FOFGroups/LengthByType"].read()
               if "FOFGroups/LengthByType" in pg else np.zeros((0, 6)))
        n_bh = int((p.mask & (p.ptype == 5)).sum())
        # the snapshot holds the run's BHs at the output; the FOF after it
        # may seed more (fof_physics), which the run then holds
        say("bh", f"{snap.rsplit('/', 1)[-1]}: {bh_ids.size} BHs, "
            f"{in_pig.size} in PIG groups, LengthByType[:, 5] sums to "
            f"{int(lbt[:, 5].sum()) if len(lbt) else 0}; {n_bh} BH rows "
            f"in the run after the output's FOF")
        if not (bh_ids.size and np.isin(bh_ids, in_pig).all()
                and int(lbt[:, 5].sum()) == bh_ids.size
                and n_bh >= bh_ids.size):
            raise SmokeFailure(f"{pig}: a BH outside every FOF group, or the "
                               f"PIG's BH count is not the run's")
        first_a = float(lines[0][0])
        say("bh", f"star-small's criteria this depth cannot reach "
            f"(printed): the first blackholes.txt line at a={first_a:.5f} "
            f"(check_results wants {BH_FIRST_LINE[0]} < a < "
            f"{BH_FIRST_LINE[1]}: "
            + ("met" if BH_FIRST_LINE[0] < first_a < BH_FIRST_LINE[1]
               else "not met, the seeding thresholds cut") + "); "
            + ", ".join(f"{n} BHs wanted at a = {a}" for a, n in
                        BH_PIG_COUNTS)
            + f", {bh_ids.size} in this run's PIG at a = {runs[0][1]}")
        self._check_calls("bh", rec)
        del sim, saved0
        shapes = dict(rec.shapes)
        del rec
        self.bh_row = self._check_shapes(shapes, "bh")

    # -------------------------------------------------------------- reion
    def reion(self):
        """star-small with every subgrid switch, resumed with RestartFlag 1
        from the `bh` run's output (a = 0.119) to REION_RUNS' output
        0.1193 with FOF: BlackHoleOn with BH_SEEDING,
        HeliumReionizationOn with a ReionHistFile and ExcursionSetReionOn
        with a J21CoeffFile (both written by tools/ at the start of the
        script) and WritePlaneOn.
        The output ends a PM step, whose FOF runs the QSO bubbles; the
        excursion pass follows in that step.  The cuts are
        REION_SWITCHES'."""
        if self.bh_dir is None:
            raise SmokeFailure("reion needs the bh phase's output")
        tmp, self.bh_dir = self.bh_dir, None
        try:
            self._reion(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def _reion(self, tmp):
        torch = self.torch
        from shenqi_tpu_torch.cli import gadget_main
        from shenqi_tpu_torch import simulation_gas as sg
        from shenqi_tpu_torch.io.snapshot import read_snapshot
        from shenqi_tpu_torch.ops.p2p import p2p_blocked
        from shenqi_tpu_torch.physics.plane import read_fits_plane
        GP = sg.GasPhysics
        out = os.path.join(tmp, "output")
        ic = os.path.join(tmp, "IC", "IC")
        runs = REION_REHEARSAL_RUNS if self.rehearsal else REION_RUNS
        seeding = (STARS_REHEARSAL + BH_REHEARSAL_SEEDING if self.rehearsal
                   else BH_SEEDING)
        t = time.perf_counter()
        _wait_tables(self.table_procs)
        say("reion", f"the tables from tools/ ({self.heii}: linear HeIII "
            f"history z = {HEII_Z[0]} to {HEII_Z[1]}, {HEII_NUMZ} rows; "
            f"{self.j21}) ready, waited {time.perf_counter() - t:.2f} s")
        pp = os.path.join(tmp, "reion.gadget")
        with open(pp, "w") as f:
            f.write(_GADGET_STARS.format(ic=ic, out=out, outputs=runs[0][0],
                                         a=runs[0][1])
                    .replace("BlackHoleOn = 0", "BlackHoleOn = 1")
                    + seeding + REION_SWITCHES.format(
                        heii=self.heii, j21=self.j21,
                        qmin=0.0 if self.rehearsal else 0.15))
        with open(os.path.join(out, "LastSnapNum.txt")) as f:
            start = int(f.read().strip())
        _, saved0 = read_snapshot(os.path.join(out, f"PART_{start:03d}"))
        m_start = sum(float(np.sum(b["Mass"], dtype=np.float64))
                      for b in saved0.values())
        n_cpu0 = len(_cpu_steps(os.path.join(out, "cpu.txt")))
        dev = "cpu" if self.rehearsal else None
        got0, helium, exc, planes = {}, [], [], []
        live = {"t": time.perf_counter(), "sim": None}

        def on_restore(fn, sim_, *a, **kw):
            fn(sim_, *a, **kw)
            g, p = sim_.gas, sim_.particles
            for ty, keys in ((4, ("birth_a", "star_metallicity",
                                  "total_returned", "last_enrich_myr")),
                             (5, ("bh_mass", "bh_mdot"))):
                rows = torch.nonzero(p.ptype == ty).squeeze(1)
                got0[ty] = {k: getattr(g, k)[rows].cpu().numpy()
                            for k in keys}
                got0[ty]["ID"] = p.ids64()[rows.cpu().numpy()]

        def on_helium(fn, gp, sim_, gas, *a, **kw):
            h0, e0 = gas.heiii.clone(), gas.entropy.clone()
            g2 = fn(gp, sim_, gas, *a, **kw)
            new = g2.heiii & ~h0
            helium.append((sim_.step_count, sim_.atime(),
                           dict(gp.last_helium or {}),
                           int(new.sum()), int(g2.heiii.sum()),
                           bool((g2.entropy[new] >= e0[new]).all()),
                           bool((g2.entropy[~new] == e0[~new]).all()),
                           bool((g2.heiii | ~h0).all())))
            return g2

        def on_excursion(fn, gp, sim_, gas, hm):
            j0 = gas.local_j21.clone()
            g2 = fn(gp, sim_, gas, hm)
            z = g2.zreion_p
            exc.append((sim_.step_count, sim_.atime(), gp.last_excursion_s,
                        sim_.excursion_xhi, int((g2.local_j21 > 0).sum()),
                        bool((g2.local_j21 >= j0).all()),
                        bool(((z < 0) | (g2.local_j21 > 0)).all()),
                        int((z >= 0).sum())))
            return g2

        def on_planes(fn, snapnum, a, cp, deposit, ntot, *rest):
            files = fn(snapnum, a, cp, deposit, ntot, *rest)
            planes.append((snapnum, a, ntot, files))
            return files

        def catch(fn, sim_, *a, **kw):
            live["sim"] = sim_
            return fn(sim_, *a, **kw)

        def step_line(fn, wt, fd, a):
            sim_ = live["sim"]
            now = time.perf_counter()
            say("reion", f"  live: step {sim_.step_count if sim_ else '-'} "
                f"to a={a:.5f} in {now - live['t']:.2f} s; " + ", ".join(
                    f"{k} {v:.2f}" for k, v in sorted(wt.step_acc.items())))
            live["t"] = now
            check_budget("reion run", self.budget)
            return fn(wt, fd, a)

        if not self.rehearsal:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        # the main path: counts set to 0 just before, read just after
        p2p_blocked.launches = 0
        with _Wrap(GP, "helium_step", through=on_helium), \
                _Wrap(GP, "excursion_step", through=on_excursion), \
                _Wrap(gadget_main, "write_planes_deposit",
                      through=on_planes), \
                _Wrap(gadget_main, "fof", keep=True) as fofw, \
                _Wrap(gadget_main, "_restore_gas_state", through=on_restore), \
                _Wrap(gadget_main._DeviceWalltime, "write_cpu_log",
                      through=step_line), \
                _Wrap(gadget_main.Simulation, "run", through=catch), \
                _RunRecorder(self._sync, syncs=not self.rehearsal) as rec:
            c0 = _cooling_counts()
            sim = gadget_main.run_gadget(pp, 1, device=dev)
        t_run = time.perf_counter() - t
        say("reion", _cooling_line(c0))
        self.reion_launches = p2p_blocked.launches
        mem = (torch.cuda.max_memory_allocated() / 2 ** 30
               if not self.rehearsal else float("nan"))
        # the start restored the star and BH rows exactly (the checks of
        # the bh phase's former one-step resume)
        for ty, names in ((4, (("StellarFormationTime", "birth_a"),
                               ("Metallicity", "star_metallicity"),
                               ("TotalMassReturned", "total_returned"),
                               ("LastEnrichmentMyr", "last_enrich_myr"))),
                          (5, (("BlackholeMass", "bh_mass"),
                               ("BlackholeAccretionRate", "bh_mdot")))):
            if ty not in saved0:
                raise SmokeFailure(f"PART_{start:03d} has no type {ty} rows")
            ok = np.array_equal(got0.get(ty, {}).get("ID"), saved0[ty]["ID"])
            for name, key in names:
                ok &= np.array_equal(got0[ty].get(key), saved0[ty][name])
            if not ok:
                raise SmokeFailure(f"the resume did not restore the type "
                                   f"{ty} rows exactly")
        say("reion", f"RestartFlag 1 from PART_{start:03d}: the "
            f"{len(saved0[4]['ID'])} star rows and {len(saved0[5]['ID'])} "
            f"BH rows restored exactly (IDs, StellarFormationTime, "
            f"Metallicity, TotalMassReturned, LastEnrichmentMyr, "
            f"BlackholeMass, BlackholeAccretionRate)")
        steps = self._run_steps(out, sim)[n_cpu0:]
        tot = dict(sorted(sim.walltime.total_acc.items()))
        say("reion", f"gadget_main RestartFlag 1 with every subgrid switch "
            f"to a={sim.atime():.5f}: {t_run:.2f} s, {len(steps) - 1} "
            f"steps, {len(rec.calls)} force calls, "
            f"{len(sim.power_history)} PM steps; stage totals " + ", ".join(
                f"{k} {v:.3f} s" for k, v in tot.items())
            + f"; p2p_blocked launches {self.reion_launches} in "
            f"{len(rec.shapes)} shapes; peak device memory {mem:.2f} GiB")
        syncs = np.diff([0] + rec.syncs) if rec.syncs else []
        for i, (a, stages) in enumerate(steps):
            say("reion", f"  {'step ' + str(i) if i < len(steps) - 1 else 'end'}"
                f" at a={a:.5f}: host syncs "
                + (f"{syncs[i]}" if i < len(syncs) else "-")
                + "; stages " + ", ".join(f"{k} {v:.3f} s"
                                          for k, v in sorted(stages.items())))
        for step, a, last, nnew, nall, up, same, kept in helium:
            say("reion", f"helium FOF at step {step}, a={a:.5f}: "
                f"{last.get('bubbles', 0)} bubbles, {nnew} rows newly "
                f"HeIII, {nall} in all; entropy raised or kept on them "
                f"{up}, unchanged elsewhere {same}")
            if not (up and same and kept):
                raise SmokeFailure("a helium FOF lowered an ionized row's "
                                   "entropy, touched another row, or "
                                   "un-ionized one")
        for step, a, sec, xhi, nj, mono, zset, nz in exc:
            say("reion", f"excursion pass at step {step}, a={a:.5f}: "
                f"{sec:.4f} s, xHI volume {xhi[0]:.6f} mass {xhi[1]:.6f}, "
                f"{nj} gas rows with J21 > 0, {nz} with zreion set; J21 "
                f"never fell {mono}, zreion only where J21 > 0 {zset}")
            if not (mono and zset and 0 <= xhi[0] <= 1 and 0 <= xhi[1] <= 1):
                raise SmokeFailure("an excursion pass lowered a J21, set a "
                                   "zreion without J21, or gave xHI outside "
                                   "[0, 1]")
        if not helium or not any(h[4] for h in helium):
            raise SmokeFailure("no HeIII row appeared at the helium FOFs")
        if not exc:
            raise SmokeFailure("no excursion pass ran")
        if not exc[-1][4]:
            raise SmokeFailure("no gas row read J21 > 0: the per-row J21 "
                               "rates did not run")
        # the planes of the outputs past the `bh` run's
        n_bh = len((BH_REHEARSAL_RUNS if self.rehearsal
                    else BH_RUNS)[0][0].split(","))
        want = set(range(n_bh, len(runs[0][0].split(","))))
        for snapnum, a, ntot, files in planes:
            hdrs = [read_fits_plane(f_)[0] for f_ in files]
            npart = [int(h["NPART"]) for h in hdrs]
            say("reion", f"planes at a={a:.5f}: {len(files)} FITS files "
                f"(normals " + ", ".join(f_.rsplit("normal", 1)[1][0]
                                         for f_ in files)
                + f"), NPART {npart} against {ntot} live rows")
            if len(files) != 3 or any(n_ != ntot for n_ in npart):
                raise SmokeFailure("the planes are not three normals with "
                                   "NPART equal to the live count")
        if {pl[0] for pl in planes} != want:
            raise SmokeFailure("the planes were not written at the run's "
                               "outputs")
        for g_, _ in fofw.calls:
            say("reion", f"FOF: {g_.ngroups} groups; " + _fof_line(g_.stats))
        p = sim.particles
        m_end = float(p.mass.double()[p.mask].sum())
        dm_rel = abs(m_end - m_start) / m_start
        say("reion", f"total mass {m_end:.9g} against PART_{start:03d}'s "
            f"{m_start:.9g}: relative change {dm_rel:.3e} (limit 1e-6); "
            f"{int(sim.gas.heiii.sum())} HeIII rows at the end")
        if not dm_rel < 1e-6:
            raise SmokeFailure(f"total mass changed by {dm_rel:.3e}")
        if abs(sim.atime() - runs[0][1]) > 1e-6:
            raise SmokeFailure(f"the reion run ended at a={sim.atime()}")
        for i in sorted(want):
            self._star_fields_check(os.path.join(out, f"PART_{i:03d}"),
                                    os.path.join(out, f"PIG_{i:03d}"),
                                    "reion")
        for name in ("local_j21", "zreion_p", "entropy"):
            if not bool(torch.isfinite(getattr(sim.gas, name)).all()):
                raise SmokeFailure(f"the gas {name} is not finite")
        self._check_calls("reion", rec)
        del sim, saved0
        shapes = dict(rec.shapes)
        del rec
        self.reion_row = self._check_shapes(shapes, "reion")

    # ----------------------------------------------------------------- lc
    def lc(self):
        """A lensing run's last stretch on the DM path: dm-small's
        cosmology on the EH table, 64^3 in a 256 Mpc/h box, genic_main at
        z = 0.05, then gadget_main to a = 0.96 with FOF, LightconeOn and
        WritePlaneOn (LC_PLANES' slabs), outputs at 0.955 and 0.96."""
        import tempfile
        # kept until close(): `erfc` and `writer` start from its files
        self.lc_dir = tempfile.mkdtemp(prefix="shenqi_lc_")
        self._lc(self.lc_dir)

    def _lc(self, tmp):
        torch = self.torch
        from shenqi_tpu_torch.cli import gadget_main, genic_main
        from shenqi_tpu_torch.io.bigfile import BigFile
        from shenqi_tpu_torch.ops.p2p import p2p_blocked
        from shenqi_tpu_torch.physics import plane as pl
        from shenqi_tpu_torch.physics.lightcone import Lightcone
        from shenqi_tpu_torch.physics.plane import read_fits_plane
        ng = self.n_lc
        nmesh = 2 * ng
        pk = os.path.join(tmp, "pk_eh.txt")
        _eh_table(pk)
        out = os.path.join(tmp, "output")
        gp, pp = os.path.join(tmp, "p.genic"), os.path.join(tmp, "p.gadget")
        with open(gp, "w") as f:
            f.write(_GENIC.format(out=tmp, ng=ng, box=LC_BOX, pk=pk)
                    .replace("Redshift = 9", f"Redshift = {LC_Z_IC}"))
        with open(pp, "w") as f:
            f.write(_GADGET.replace("OutputList = {a}",
                                    f"OutputList = {LC_RUNS[0]}").format(
                ic=os.path.join(tmp, "IC", "IC"), out=out, a=LC_RUNS[1],
                fof=1, nmesh=nmesh) + "LightconeOn = 1\nWritePlaneOn = 1\n"
                + LC_PLANES)
        dev = "cpu" if self.rehearsal else None
        t = time.perf_counter()
        genic_main.run_genic(gp, device=dev)
        say("lc", f"genic_main Ngrid {ng}, box {LC_BOX:.0f} kpc/h, z = "
            f"{LC_Z_IC}: {time.perf_counter() - t:.2f} s")
        deposits = []

        def on_deposit(fn, ipos, alive, boxsize, normal, center, thickness,
                       *a):
            counts, n_plane = fn(ipos, alive, boxsize, normal, center,
                                 thickness, *a)
            # the slab's particles counted on the host in float64, apart
            # from the port's integer slab test
            x = ((ipos[:, normal].cpu().numpy().view(np.uint32)
                  .astype(np.float64) / 2.0 ** 32 * boxsize)
                 - (center - thickness / 2)) % boxsize
            live = alive.cpu().numpy()
            deposits.append((normal, center, int(counts.sum()),
                             int(n_plane), int((live & (x < thickness))
                                               .sum()), int(live.sum())))
            return counts, n_plane

        if not self.rehearsal:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        # the main path: counts set to 0 just before, read just after
        p2p_blocked.launches = 0
        with _Wrap(gadget_main, "plane_counts_ipos", through=on_deposit), \
                _Wrap(gadget_main, "fof", keep=True) as fofw, \
                _RunRecorder(self._sync) as rec:
            sim = gadget_main.run_gadget(pp, 2, device=dev)
        t_run = time.perf_counter() - t
        self.lc_launches = p2p_blocked.launches
        mem = (torch.cuda.max_memory_allocated() / 2 ** 30
               if not self.rehearsal else float("nan"))
        log = sim.lightcone_log
        tot = dict(sorted(sim.walltime.total_acc.items()))
        lc_s = [x[3] for x in log]
        say("lc", f"gadget_main RestartFlag 2, {ng ** 3} particles, mesh "
            f"{nmesh}, to a={sim.atime():.5f}: {t_run:.2f} s, "
            f"{sim.step_count} steps, {len(log)} drifts, "
            f"{len(sim.power_history)} PM steps; stage totals " + ", ".join(
                f"{k} {v:.3f} s" for k, v in tot.items())
            + f"; p2p_blocked launches {self.lc_launches} in "
            f"{len(rec.shapes)} shapes; peak device memory {mem:.2f} GiB")
        say("lc", f"lightcone host seconds per drift: mean "
            f"{np.mean(lc_s):.4f}, max {np.max(lc_s):.4f}, total "
            f"{np.sum(lc_s):.3f}; crossings per drift " + ", ".join(
                str(x[2]) for x in log))
        bf = BigFile(os.path.join(out, "LIGHTCONE"))
        layout = {"1/Position": ("<f8", 3), "1/Velocity": ("<f4", 3),
                  "1/ID": ("<u8", 1), "1/Aemit": ("<f4", 1)}
        for name, (dt, nm) in layout.items():
            blk = bf[name]
            if np.dtype(blk.dtype) != np.dtype(dt) or blk.nmemb != nm:
                raise SmokeFailure(f"LIGHTCONE {name} is {blk.dtype} x "
                                   f"{blk.nmemb}, not the JAX layout's")
        aem = bf["1/Aemit"].read()
        pos = bf["1/Position"].read()
        ncross = sum(x[2] for x in log)
        if len(aem) != ncross or ncross == 0:
            raise SmokeFailure(f"LIGHTCONE holds {len(aem)} rows against "
                               f"{ncross} crossings")
        # genic's default unit system: velocities in km/s
        lcone = Lightcone(CP=sim.CP, boxsize=LC_BOX, unit_velocity=1e5)
        d = np.linalg.norm(pos, axis=1)
        o, bad_a, bad_d = 0, 0, 0
        for a0, a1, n, _ in log:
            seg = slice(o, o + n)
            o += n
            tol = 1e-6 * a1
            bad_a += int(((aem[seg] < a0 - tol) | (aem[seg] > a1 + tol))
                         .sum())
            r_hi, r_lo = lcone.radius(a0), lcone.radius(a1)
            tol_d = 1e-9 * LC_BOX
            bad_d += int(((d[seg] > r_hi + tol_d) | (d[seg] <= r_lo - tol_d))
                         .sum())
        say("lc", f"LIGHTCONE: {len(aem)} rows in the JAX layout "
            f"(Position <f8 x 3, Velocity <f4 x 3, ID <u8, Aemit <f4); "
            f"Aemit outside its drift's (a0, a1]: {bad_a}; distance outside "
            f"[R(a1), R(a0)]: {bad_d}")
        if bad_a or bad_d:
            raise SmokeFailure("a lightcone crossing lies outside its "
                               "drift's interval or shell")
        for nrm, cen, c, n, host, al in deposits:
            say("lc", f"plane deposit, normal {nrm}, slab about {cen:.0f} "
                f"kpc/h: counts sum {c}, n_plane {n}, the host's float64 "
                f"count {host}, of {al} live rows")
        if len(deposits) != 12 or not all(c == n == host and 0 < n < al
                                          for _, _, c, n, host, al
                                          in deposits):
            raise SmokeFailure("the plane counts do not sum to the slab's "
                               "particles")
        fits = sorted(f_ for f_ in os.listdir(out) if f_.endswith(".fits"))
        nparts = []
        for f_ in fits:
            h, data = read_fits_plane(os.path.join(out, f_))
            nparts.append(int(h["NPART"]))
            if not np.isfinite(data).all():
                raise SmokeFailure(f"{f_} is not finite")
        say("lc", f"{len(fits)} FITS planes: " + ", ".join(fits)
            + f"; NPART {nparts}")
        if sorted(nparts) != sorted(d[3] for d in deposits):
            raise SmokeFailure("the planes' NPART are not their slabs' "
                               "counts")
        if len(fits) != 12 or len(fofw.calls) != 2:
            raise SmokeFailure("the lc run did not write its planes and "
                               "FOF at both outputs")
        self._check_calls("lc", rec)
        del sim
        shapes = dict(rec.shapes)
        del rec
        self.lc_row = self._check_shapes(shapes, "lc")

    # --------------------------------------------------------------- erfc
    def erfc(self):
        """ShortRangeForceWindowType erfc (ROADMAP A.12): `lc`'s ICs and
        outputs without LightconeOn and WritePlaneOn, every force call
        through the pair kernel's erfc instantiation."""
        torch = self.torch
        from shenqi_tpu_torch.cli import gadget_main
        from shenqi_tpu_torch.gravity.shortrange import ErfcWindow
        from shenqi_tpu_torch.io.snapshot import read_snapshot
        from shenqi_tpu_torch.ops.p2p import (kernel_instantiation,
                                              p2p_blocked)
        tmp = self.lc_dir
        out = os.path.join(tmp, "erfc")
        pp = os.path.join(tmp, "erfc.gadget")
        with open(pp, "w") as f:
            f.write(_GADGET.replace("OutputList = {a}",
                                    f"OutputList = {LC_RUNS[0]}").format(
                ic=os.path.join(tmp, "IC", "IC"), out=out, a=LC_RUNS[1],
                fof=0, nmesh=2 * self.n_lc)
                + "ShortRangeForceWindowType = erfc\n")
        dev = "cpu" if self.rehearsal else None
        t = time.perf_counter()
        # the main path: counts set to 0 just before, read just after
        p2p_blocked.launches = 0
        with _RunRecorder(self._sync) as rec:
            sim = gadget_main.run_gadget(pp, 2, device=dev)
        t_run = time.perf_counter() - t
        self.erfc_launches = p2p_blocked.launches
        w = sim.window_tables
        inst = "plain version (CPU)" if self.rehearsal else \
            kernel_instantiation(w, False)
        tot = dict(sorted(sim.walltime.total_acc.items()))
        say("erfc", f"gadget_main RestartFlag 2 with the erfc window "
            f"({w}; kernel instantiation: {inst}), {self.n_lc ** 3} "
            f"particles to a={sim.atime():.5f}: {t_run:.2f} s, "
            f"{sim.step_count} steps, {len(sim.power_history)} PM steps; "
            f"stage totals " + ", ".join(f"{k} {v:.3f} s"
                                         for k, v in tot.items())
            + f"; p2p_blocked launches {self.erfc_launches} in "
            f"{len(rec.shapes)} shapes")
        if w != ErfcWindow(sim.gravity.asmth) or not (
                self.rehearsal or inst == "erfc window"):
            raise SmokeFailure(f"the erfc run's window is {w} ({inst})")
        if not all(np.isfinite(np.asarray(h[2])).all()
                   for h in sim.power_history):
            raise SmokeFailure("the erfc run's P(k) is not finite")
        # the final positions beside the lc run's (the calibrated window)
        last = f"PART_{len(LC_RUNS[0].split(',')) - 1:03d}"
        _, be = read_snapshot(os.path.join(out, last))
        _, bx = read_snapshot(os.path.join(tmp, "output", last))
        oe, ox = np.argsort(be[1]["ID"]), np.argsort(bx[1]["ID"])
        if not np.array_equal(be[1]["ID"][oe], bx[1]["ID"][ox]):
            raise SmokeFailure("the erfc and lc snapshots hold other IDs")
        d = np.abs(be[1]["Position"][oe] - bx[1]["Position"][ox])
        d = np.minimum(d, LC_BOX - d).max() / LC_BOX
        say("erfc", f"{last}: positions beside lc's (calibrated window) "
            f"within {d:.3e} of the box (limit {ERFC_VS_EXACT:g}); finite: "
            f"{bool(np.isfinite(be[1]['Position']).all())}")
        if not (d < ERFC_VS_EXACT and np.isfinite(be[1]["Position"]).all()):
            raise SmokeFailure("the erfc run's positions left the lc run's")
        self._check_calls("erfc", rec)
        del sim
        shapes = dict(rec.shapes)
        del rec
        self.erfc_row = self._check_shapes(shapes, "erfc", both_pots=True)

    # ------------------------------------------------------------- writer
    def writer(self):
        """`lc`'s last snapshot written again by the C++ block writer and
        by the numpy writer, in turns (numpy, native, native, numpy),
        every file byte-identical to each other and to the run's own."""
        from shenqi_tpu_torch.io.snapshot import read_snapshot, write_snapshot
        last = f"PART_{len(LC_RUNS[0].split(',')) - 1:03d}"
        src = os.path.join(self.lc_dir, "output", last)
        hdr, blocks = read_snapshot(src)
        mb = sum(v.nbytes for b in blocks.values() for v in b.values()) / 1e6
        best = {}
        for name in ("numpy", "native", "native", "numpy"):
            d = os.path.join(self.lc_dir, f"write_{name}")
            shutil.rmtree(d, ignore_errors=True)
            t = time.perf_counter()
            write_snapshot(d, hdr, blocks, _numpy=name == "numpy")
            best[name] = min(best.get(name, 1e30), time.perf_counter() - t)
        ref = _tree_bytes(os.path.join(self.lc_dir, "write_numpy"))
        for other in ("write_native", os.path.join("output", last)):
            got = _tree_bytes(os.path.join(self.lc_dir, other))
            bad = sorted(k for k in set(ref) | set(got)
                         if ref.get(k) != got.get(k))
            if bad:
                raise SmokeFailure(f"{other} differs from the numpy writer's "
                                   f"files: {bad[:5]}")
        say("writer", f"{last} of lc ({mb:.1f} MB of blocks, {len(ref)} "
            f"files, byte-identical from both writers and the run): numpy "
            f"{best['numpy']:.4f} s ({mb / best['numpy']:.1f} MB/s), native "
            f"{best['native']:.4f} s ({mb / best['native']:.1f} MB/s), best "
            f"of 2 each, to the page cache (no fsync)")

    # -------------------------------------------------------------- field
    def field(self):
        """genic's scheme="fast" field on the device against the CPU."""
        from shenqi_tpu_torch.genic.ic import gaussian_field
        n = 32 if self.rehearsal else FIELD_N
        secs = []
        for dev in (self.dev, self.dev, "cpu"):
            t = time.perf_counter()
            g = gaussian_field(FIELD_SEED, n, scheme="fast", device=dev)
            self._sync()
            secs.append(time.perf_counter() - t)
            got, ref = (got, g) if dev == "cpu" else (g, None)
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        say("field", f"gaussian_field(scheme='fast') {n}^3 on {self.dev}: "
            f"{secs[0]:.3f} s, {secs[1]:.3f} s (first, second call), on "
            f"the CPU {secs[2]:.3f} s; max |g_dev - g_cpu| / max |g| = "
            f"{err:.3e} (limit 1e-5)")
        if not err < 1e-5 or got.shape != (n, n, n // 2 + 1):
            raise SmokeFailure("the fast field on the device left the CPU's")

    def _star_fields_check(self, snap, pig, phase="stars"):
        """The gas and star blocks of a PART finite, the gas density,
        weighted density, smoothing length and internal energy (so the
        entropy) positive, the gas metallicity positive somewhere, and
        every star of the PART a member of a PIG group."""
        from shenqi_tpu_torch.io.bigfile import BigFile
        bf = BigFile(snap)
        for name in ("SmoothingLength", "Density", "EgyWtDensity",
                     "InternalEnergy"):
            v = bf[f"0/{name}"].read()
            if not (np.isfinite(v).all() and (v > 0).all()):
                raise SmokeFailure(f"{snap}: gas {name} not finite and "
                                   f"positive")
        for name in ("Metallicity", "StarFormationRate", "DelayTime",
                     "ElectronAbundance", "Velocity"):
            if not np.isfinite(bf[f"0/{name}"].read()).all():
                raise SmokeFailure(f"{snap}: gas {name} not finite")
        zmax = float(bf["0/Metallicity"].read().max())
        ids = (bf["4/ID"].read() if "4/ID" in bf
               else np.zeros(0, np.uint64))
        for name in ("Position", "Velocity", "Mass", "StellarFormationTime",
                     "Metallicity", "TotalMassReturned",
                     "LastEnrichmentMyr"):
            if ids.size and not np.isfinite(bf[f"4/{name}"].read()).all():
                raise SmokeFailure(f"{snap}: star {name} not finite")
        pg = BigFile(pig)
        in_groups = (pg["4/ID"].read() if "4/ID" in pg
                     else np.zeros(0, np.uint64))
        lbt = pg["FOFGroups/LengthByType"].read() \
            if "FOFGroups/LengthByType" in pg else np.zeros((0, 6))
        say(phase, f"  {snap.rsplit('/', 1)[-1]}: gas fields finite, "
            f"positive; max gas metallicity {zmax:.4g}; {ids.size} stars, "
            f"{in_groups.size} of them in PIG groups (LengthByType "
            f"{int(lbt[:, 4].sum()) if len(lbt) else 0})")
        if not self.rehearsal and not np.isin(ids, in_groups).all():
            raise SmokeFailure(f"{pig}: a star outside every FOF group")
        if ids.size and not zmax > 0:
            raise SmokeFailure(f"{snap}: no gas metallicity after the "
                               f"stars formed")

    def profile(self):
        """Where the time goes in one full force pass at the slice's size
        (PM + short range for every particle, the work of a step in
        which all particles are active): host-clock stage times with a
        synchronize after each.  Not part of the counted main path.  (Its
        torch.profiler pass, device time by kernel and the busy share,
        went for the `mesh` phase's clustered run; PERF.md keeps its
        earlier numbers.)"""
        if self.rehearsal:
            say("profile", "skipped in the CPU rehearsal")
            return
        sim = self.sim

        def full_pass():
            t = [time.perf_counter()]
            sim._compute_pm(record_power=False)
            self._sync()
            t.append(time.perf_counter())
            sim._compute_tree(first_step=True)
            self._sync()
            t.append(time.perf_counter())
            sim._find_timesteps(first_step=False)
            self._sync()
            t.append(time.perf_counter())
            return [(b - a) * 1e3 for a, b in zip(t, t[1:])]

        times = self.sim.times
        saved = (times.pm_length, times.pm_start, times.mintimebin,
                 times.maxtimebin, sim.particles)
        full_pass()
        ms = full_pass()
        (times.pm_length, times.pm_start, times.mintimebin,
         times.maxtimebin, sim.particles) = saved
        say("profile", f"full force pass ({sim.n_real} targets): PM "
            f"{ms[0]:.2f} ms, short range {ms[1]:.2f} ms, timesteps "
            f"{ms[2]:.2f} ms, total {sum(ms):.2f} ms")

    # ------------------------------------------------------------- report
    def report(self):
        """The JSON kernel row from the CLI run (its launches, and the
        numbers of its largest launch shape), and on the `kernels:` line
        each main path's launches with the row of its largest shape."""
        def entry(r, launches):
            return {"name": "p2p_blocked", "route": "cuda",
                    "source": "shenqi_tpu_torch/csrc/p2p.cu",
                    "replaces": "shenqi_tpu/ops/pallas_p2p.py:153",
                    "launches": launches, "max_abs_err": r["max_abs_err"],
                    "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": None}
        print("kernels: " + json.dumps([
            dict(entry(r, n), path=path, rel_err=r["rel_err"],
                 shape=[r["nb"], r["blk"], r["S"], r["want_pot"]])
            for path, r, n in (
                ("cli", self.cli_row, self.cli_launches),
                ("mesh", self.mesh_row, self.mesh_launches),
                ("slice", self.kernel_row, self.launches),
                ("dmsmall", self.dmsmall_row, self.dmsmall_launches),
                ("nu", self.nu_row, self.nu_launches),
                ("gas", self.gas_row, self.gas_launches),
                ("gas128", self.gas128_row, self.gas128_launches),
                ("stars", self.stars_row, self.stars_launches),
                ("bh", self.bh_row, self.bh_launches),
                ("reion", self.reion_row, self.reion_launches),
                ("lc", self.lc_row, self.lc_launches),
                ("erfc", self.erfc_row, self.erfc_launches))]),
              flush=True)
        erfc = dict(entry(self.erfc_row, self.erfc_launches),
                    name="p2p_blocked_erfc",
                    replaces="shenqi_tpu/gravity/stencil.py:296")
        print(json.dumps({"kernels": [entry(self.cli_row,
                                            self.cli_launches), erfc]}),
              flush=True)
        print(self.card, flush=True)


class _GasTheory:
    """The linear spectrum of each species of travis-hydro: the EH table
    and the CLASS-layout transfer table as genic reads them (normalized to
    the ICs from InputPowerRedshift 0), the species' transfer type
    squared (DELTA_CDM for the DM, DELTA_BAR for the gas: what genic
    drew), times the squared growth ratio D(a)/D(a_ic)."""

    def __init__(self, pk, tk):
        from shenqi_tpu_torch.cosmology.background import Cosmology
        from shenqi_tpu_torch.cosmology.power import InputPower
        from shenqi_tpu_torch.utils.units import get_unitsystem
        units = get_unitsystem(3.085678e24, 1.989e43, 1e5)
        self.cp = Cosmology(Omega0=0.288, OmegaLambda=0.712,
                            OmegaBaryon=0.0472, HubbleParam=0.7,
                            CMBTemperature=2.7255, RadiationOn=1)
        self.cp.init(GAS_A_IC, units)
        self.power = InputPower.from_file(pk, self.cp,
                                          units.UnitLength_in_cm)
        self.power.normalize(sigma8=-1, input_power_redshift=0,
                             time_ic=GAS_A_IC)
        self.power.load_transfer(tk, GAS_A_IC)

    def pk(self, label, k, a):
        from shenqi_tpu_torch.cosmology.power import DELTA_BAR, DELTA_CDM
        t = DELTA_CDM if label == "cdm" else DELTA_BAR
        d = self.cp.growth_factor(a, GAS_A_IC)
        return self.power.delta_spec(k, t) ** 2 * d ** 2


def _species_power(pos, boxsize, device, nmesh=128):
    """Compensated-CIC P(k) of one species' positions on bins of width
    2 pi / box (validation/travis.py:103-164 species_power, on the port's
    CIC).  Returns (k, P) in the snapshot's units."""
    import torch
    from shenqi_tpu_torch.core.particles import float_to_ipos
    from shenqi_tpu_torch.ops.cic import cic_deposit
    n = len(pos)
    ipos = float_to_ipos(pos % boxsize, boxsize, device=device)
    mesh = cic_deposit(ipos, torch.full((n,), 1.0 / n, device=device), nmesh)
    rho_k = torch.fft.rfftn(mesh.double() * nmesh ** 3)
    pk3d = (rho_k.real ** 2 + rho_k.imag ** 2).cpu().numpy() / nmesh ** 6
    kx = np.fft.fftfreq(nmesh, 1.0 / nmesh)[:, None, None]
    ky = np.fft.fftfreq(nmesh, 1.0 / nmesh)[None, :, None]
    kz = np.arange(nmesh // 2 + 1)[None, None, :]
    kmag = np.sqrt(kx ** 2 + ky ** 2 + kz ** 2)
    w = np.pi / nmesh
    wcic = (np.sinc(kx * w / np.pi) * np.sinc(ky * w / np.pi)
            * np.sinc(kz * w / np.pi)) ** 2
    pk3d = pk3d / wcic ** 2
    # the kz = 0 and kz = n/2 planes count once, the others twice
    wgt = np.full(pk3d.shape, 2.0)
    wgt[:, :, 0] = 1.0
    wgt[:, :, -1] = 1.0
    bins = np.rint(kmag).astype(int).ravel()
    keep = bins > 0
    b = bins[keep]
    nb = nmesh // 2 + 1
    psum = np.bincount(b, (pk3d * wgt).ravel()[keep], minlength=nb)
    ksum = np.bincount(b, np.broadcast_to(kmag * wgt, pk3d.shape
                                          ).ravel()[keep], minlength=nb)
    cnt = np.bincount(b, wgt.ravel()[keep], minlength=nb)
    good = cnt > 0
    return (ksum[good] / cnt[good] * (2 * np.pi / boxsize),
            psum[good] / cnt[good] * boxsize ** 3)


class _SphRecorder:
    """Within a `with` block, records each SPH pass of a run
    (GasPhysics.density_hydro): its step and seconds; its targets and
    hsml-loop iterations (sph.density); each density walk's targets and
    seconds and the sub-blocks it flagged for the cover patch, whose
    one-target walks (sub=1) are timed apart (stencil_density_walk); the
    hydro walk's cover sub-blocks, long-reach sources and seconds
    (stencil_hydro_walk); and each IC entropy fixed point's iterations
    and seconds.  Every timed call sits between two synchronizes."""

    def __init__(self, sync):
        self.sync = sync
        self.passes, self.fixed_points = [], []
        self._reset()

    def _reset(self):
        self._cur = dict(targets=0, niter=0, walks=[], cover_s=0.0,
                         density_cover=0, hydro_cover=0, long_reach=0,
                         hydro_s=0.0)

    def _timed(self, fn, sink):
        rec = self

        def wrapper(*a, **kw):
            rec.sync()
            t = time.perf_counter()
            out = fn(*a, **kw)
            rec.sync()
            sink(a, kw, out, time.perf_counter() - t)
            return out
        return wrapper

    def __enter__(self):
        from shenqi_tpu_torch import simulation_gas as sg
        from shenqi_tpu_torch.sph import stencil_density as sd
        GP = sg.GasPhysics
        self._saved = (GP.density_hydro, GP.setup_density_indep_entropy,
                       sg.sph_density, sd.stencil_density_walk,
                       sg.stencil_hydro_walk)
        dh, fp, dens, sdw, shw = self._saved
        rec = self

        def on_pass(a, kw, out, sec):
            rec.passes.append(dict(rec._cur, step=a[1].step_count,
                                   seconds=sec))
            rec._reset()

        def on_fixed_point(a, kw, out, sec):
            rec.fixed_points.append(dict(a[0].last_fixed_point,
                                         seconds=sec))

        def on_density(a, kw, out, sec):
            rec._cur.update(targets=a[1].shape[0], niter=out.niter)

        def on_walk(a, kw, out, sec):
            # the cover patch walks one target per sub-block (sub=1)
            if kw.get("sub", 32) == 1:
                rec._cur["cover_s"] += sec
            else:
                rec._cur["walks"].append((a[1].shape[0], sec))
                rec._cur["density_cover"] += out[2]

        def on_hydro(a, kw, out, sec):
            rec._cur["hydro_s"] += sec
            rec._cur["hydro_cover"] += out[2]
            rec._cur["long_reach"] += out[3]

        GP.density_hydro = self._timed(dh, on_pass)
        GP.setup_density_indep_entropy = self._timed(fp, on_fixed_point)
        sg.sph_density = self._timed(dens, on_density)
        sd.stencil_density_walk = self._timed(sdw, on_walk)
        sg.stencil_hydro_walk = self._timed(shw, on_hydro)
        return self

    def __exit__(self, *exc):
        from shenqi_tpu_torch import simulation_gas as sg
        from shenqi_tpu_torch.sph import stencil_density as sd
        GP = sg.GasPhysics
        (GP.density_hydro, GP.setup_density_indep_entropy, sg.sph_density,
         sd.stencil_density_walk, sg.stencil_hydro_walk) = self._saved
        return False


class _StarRecorder:
    """Within a `with` block, records each source step of a run
    (GasPhysics.source_terms) by its step: the star-formation sums it
    reduces (_sf_stats_reduce: star-forming rows, split and whole
    conversions), the wind kicks of winds_star_feedback (rows whose
    velocity it changed), and each metal-return scatter's active-star
    lanes (bh_gas_environment), the mass its stars return and the mass
    the gas receives (metal_return_step).  The values stay on the device
    until `per_step`, so the run's host syncs are its own."""

    def __init__(self):
        self.step = -1
        self.rows = []          # (step, kind, device tensor)

    def __enter__(self):
        from shenqi_tpu_torch import simulation_gas as sg
        GP = sg.GasPhysics
        self._saved = (GP.source_terms, sg._sf_stats_reduce,
                       sg.winds_star_feedback, sg.bh_gas_environment,
                       sg.metal_return_step)
        src, stats, winds, env, mrs = self._saved
        rec = self

        def source_terms(gp, sim_, *a, **kw):
            rec.step = sim_.step_count
            return src(gp, sim_, *a, **kw)

        def sf_stats(*a, **kw):
            out = stats(*a, **kw)
            rec.rows.append((rec.step, "sf", out.clone()))
            return out

        def wind(*a, **kw):
            out = winds(*a, **kw)
            # the rows whose velocity the kicks changed
            rec.rows.append((rec.step, "kicks",
                             (out[0] != a[7]).any(1).sum()))
            return out

        def environment(*a, **kw):
            rec.rows.append((rec.step, "mr_stars", (a[1] > 0).sum()))
            return env(*a, **kw)

        def scatter(*a, **kw):
            dm, dz = mrs(*a, **kw)
            alive = a[7]
            rec.rows.append((rec.step, "returned", a[2].sum()))
            rec.rows.append((rec.step, "received",
                             dm.double()[alive].sum()))
            return dm, dz

        GP.source_terms = source_terms
        sg._sf_stats_reduce = sf_stats
        sg.winds_star_feedback = wind
        sg.bh_gas_environment = environment
        sg.metal_return_step = scatter
        return self

    def __exit__(self, *exc):
        from shenqi_tpu_torch import simulation_gas as sg
        (sg.GasPhysics.source_terms, sg._sf_stats_reduce,
         sg.winds_star_feedback, sg.bh_gas_environment,
         sg.metal_return_step) = self._saved
        return False

    def per_step(self):
        """{step: {split, whole, sf_rows, kicks, mr_stars, returned,
        received}}"""
        out = {}
        for step, kind, v in self.rows:
            d = out.setdefault(step, {})
            if kind == "sf":
                v = v.tolist()
                d["sf_rows"] = d.get("sf_rows", 0) + int(v[3])
                d["split"] = d.get("split", 0) + int(v[6])
                d["whole"] = d.get("whole", 0) + int(v[7])
            elif kind in ("returned", "received"):
                d[kind] = d.get(kind, 0.0) + float(v)
            else:
                d[kind] = d.get(kind, 0) + int(v)
                if kind == "mr_stars":
                    d["mr_calls"] = d.get("mr_calls", 0) + 1
        return out

    def totals(self):
        t = {"split": 0, "whole": 0, "kicks": 0, "mr_calls": 0,
             "mr_star_lanes": 0, "returned": 0.0, "received": 0.0}
        for d in self.per_step().values():
            for k in ("split", "whole", "kicks", "mr_calls", "returned",
                      "received"):
                t[k] += d.get(k, 0)
            t["mr_star_lanes"] += d.get("mr_stars", 0)
        return t


class _Wrap:
    """Within a `with` block, `obj.name` (a module's function or a class's
    method) is replaced by a wrapper that sums the seconds of its calls
    (`seconds`, each call's in `each`) and notes when the last one
    returned (`t_end`); with `sync`, it calls sync() before and after
    each call; with `keep`, it keeps each call's (result, args) in
    `calls`; with `peak`, the most device memory a call allocated above
    what was allocated when it began (`peak`, bytes; each call's in
    `peaks`); with `through`, it calls through(fn, *args, **kw) in place
    of fn(*args, **kw)."""

    def __init__(self, mod, name, through=None, keep=False, peak=False,
                 sync=None):
        self.mod, self.name, self.fn = mod, name, getattr(mod, name)
        self.through, self.keep, self.track = through, keep, peak
        self.sync = sync
        self.seconds, self.t_end, self.calls, self.peak = 0.0, 0.0, [], 0
        self.each, self.peaks = [], []

    def __call__(self, *args, **kw):
        import torch
        if self.track:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        if self.sync:
            self.sync()
        t = time.perf_counter()
        out = (self.through(self.fn, *args, **kw) if self.through
               else self.fn(*args, **kw))
        if self.sync:
            self.sync()
        self.t_end = time.perf_counter()
        self.seconds += self.t_end - t
        self.each.append(self.t_end - t)
        if self.track:
            self.peaks.append(torch.cuda.max_memory_allocated() - base)
            self.peak = max(self.peak, self.peaks[-1])
        if self.keep:
            self.calls.append((out, args))
        return out

    def __enter__(self):
        def wrapper(*args, **kw):     # a function, so a method binds
            return self(*args, **kw)
        setattr(self.mod, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.fn)
        return False


_MESH_HOOK = {}


def _mesh_rank_hook(event, sim, outdir, then=()):
    """The `mesh` phase inside each rank of a --mesh run: at 'start' the
    pair kernel's count set to 0 and a recorder of its launch shapes; at
    'end' the count, one example input of each shape, the rank's force
    calls, exchanges, SPH passes and IC fixed point, collective tallies,
    tree depth, snapshots and last stages, saved to mesh_rank<r>.pt in
    the run's output directory for the phase.  `then`, a list of
    (paramfile, RestartFlag, SnapNum): after that, the rank runs
    gadget_main's rank body on the first in the same process group (one
    spawn and NCCL start for every run), this hook recording it in its
    own output directory and going on with the rest.  A run with gas
    also saves its source stages (SlabSimulation.source_log, seed_log),
    the stars it formed and its end state: the gas rows in the wind
    phase, the gas's velocity dispersion, the BH rows' masses and rates,
    and whether every row's field is finite."""
    import torch
    from shenqi_tpu_torch.gravity import stencil as st
    from shenqi_tpu_torch.ops.p2p import p2p_blocked
    from shenqi_tpu_torch.parallel import collectives as cc
    if event == "start":
        p2p_blocked.launches = 0
        cc.COUNTS.clear()
        shapes = _MESH_HOOK["shapes"] = {}
        kern = _MESH_HOOK["kern"] = st.p2p_blocked

        def record(*a, **kw):
            key = (a[2].shape[0], kw["blk"], a[2].shape[1], kw["want_pot"])
            shapes.setdefault(key, [0, a, dict(kw)])[0] += 1
            return kern(*a, **kw)
        st.p2p_blocked = record
        _MESH_HOOK["t0"] = time.perf_counter()
        return
    st.p2p_blocked = _MESH_HOOK["kern"]
    sub = {}
    g, p = sim.gas, sim.particles
    if g is not None:
        bh = (p.mask & (p.ptype == 5)).cpu()
        ng = g.ngas
        sub = {"source_log": sim.source_log, "seed_log": sim.seed_log,
               "star_count": sim.star_count,
               "delayed": int((g.delay_time > 0).sum()),
               "vdisp": ((float(g.vdisp.min()), float(g.vdisp.max()))
                         if ng else (0.0, 0.0)),
               "bh_mass": g.bh_mass.cpu()[bh].numpy(),
               "bh_mdot": g.bh_mdot.cpu()[bh].numpy(),
               "finite": all(bool(torch.isfinite(v).all())
                             for v in sim._rows().values()
                             if v.is_floating_point())}
    torch.save({"launches": p2p_blocked.launches, **sub,
                "shapes": _MESH_HOOK["shapes"],
                "run_s": time.perf_counter() - _MESH_HOOK["t0"],
                "force_log": sim.force_log,
                "exchange_log": sim.exchange_log,
                "sph_log": sim.sph_log,
                "fixed_point": sim.last_fixed_point,
                "step_count": sim.step_count,
                "counts": dict(cc.COUNTS),
                "tree_nlevels": sim.gravity.tree_nlevels,
                "snapshots": list(sim.snapshots),
                "last_stages": dict(sim.walltime.step_acc)},
               os.path.join(outdir, f"mesh_rank{cc.rank()}.pt"))
    if then:
        import functools
        from shenqi_tpu_torch.cli import gadget_main
        (pp, flag, snapnum), rest = then[0], tuple(then[1:])
        gadget_main._slab_rank(cc.rank(), sim.device, pp, flag, snapnum,
                               10 ** 9, False,
                               functools.partial(_mesh_rank_hook, then=rest))


class _RunRecorder:
    """Within a `with` block, records what a gadget_main run does with
    the short-range force: each full pass (`_compute_tree`) and each
    level's active-source call (`_active_source_accel`) as (step, kind,
    targets, pair-kernel launches, seconds between synchronizes), the
    occupied timebins after each step's timestep assignment, and one
    example of each pair-kernel launch shape (nb, blk, S, want_pot) with
    its count.  With `syncs`, it also counts the host syncs that
    torch.cuda.set_sync_debug_mode flags, per step."""

    def __init__(self, sync, syncs=False):
        self.sync, self.count_syncs = sync, syncs
        self.calls, self.bins, self.shapes, self.syncs = [], [], {}, []
        self._caught = None

    def __enter__(self):
        import warnings
        import torch
        from shenqi_tpu_torch import simulation
        from shenqi_tpu_torch.gravity import stencil as st
        from shenqi_tpu_torch.ops.p2p import p2p_blocked
        S = simulation.Simulation
        self._saved = (S._compute_tree, S._active_source_accel,
                       S._hier_first_half, st.p2p_blocked)
        tree, level, first, kern = self._saved
        rec = self

        def timed(kind, fn, targets):
            def wrapper(sim_, *a, **kw):
                rec.sync()
                b, t = p2p_blocked.launches, time.perf_counter()
                out = fn(sim_, *a, **kw)
                rec.sync()
                rec.calls.append((sim_.step_count, kind,
                                  targets(sim_, *a, **kw),
                                  p2p_blocked.launches - b,
                                  time.perf_counter() - t))
                return out
            return wrapper

        def first_half(sim_, first_step):
            bad = first(sim_, first_step)
            p = sim_.particles
            rec.bins.append((sim_.step_count, torch.unique(
                p.timebin[p.mask]).tolist()))
            if rec._caught is not None:
                rec.syncs.append(len(rec._caught))
            return bad

        def record(*a, **kw):
            key = (a[2].shape[0], kw["blk"], a[2].shape[1], kw["want_pot"])
            rec.shapes.setdefault(key, [0, a, dict(kw)])[0] += 1
            return kern(*a, **kw)

        S._compute_tree = timed(
            "full", tree,
            lambda s_, first_step: s_.last_n_targets or s_.n_real)
        S._active_source_accel = timed("level", level,
                                       lambda s_, sel, n_act: n_act)
        S._hier_first_half = first_half
        st.p2p_blocked = record
        if self.count_syncs:
            self._warn = warnings.catch_warnings(record=True)
            self._caught = self._warn.__enter__()
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        from shenqi_tpu_torch import simulation
        from shenqi_tpu_torch.gravity import stencil as st
        S = simulation.Simulation
        (S._compute_tree, S._active_source_accel, S._hier_first_half,
         st.p2p_blocked) = self._saved
        if self.count_syncs:
            import torch
            torch.cuda.set_sync_debug_mode(0)
            self._warn.__exit__(*exc)
        return False

    def per_step(self):
        """{step: [(kind, targets, launches, seconds), ...]}"""
        out = {}
        for step, *rest in self.calls:
            out.setdefault(step, []).append(tuple(rest))
        return out


class _StageClock:
    """The Simulation's walltime hook: `measure(name)` charges the time
    since the previous call to `name`, after a device synchronize."""

    def __init__(self, sync):
        self.sync = sync
        self.t = time.perf_counter()
        self.acc = {}

    def start(self):
        self.sync()
        self.t = time.perf_counter()
        self.acc = {}

    def measure(self, name):
        self.sync()
        now = time.perf_counter()
        self.acc[name] = self.acc.get(name, 0.0) + now - self.t
        self.t = now

    def take(self):
        out, self.acc = self.acc, {}
        return out


def _tree_bytes(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, names in os.walk(root):
        for f in names:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def _issue_floor_ms(pairs, inwin, window, want_pot):
    """The pipe-limited floor beside the f32 bound: the operations of
    ops/p2p.py's tally (a pair inside the window at its full count for
    the window's instantiation, one past it at the separation, r and x)
    as issued instructions (an FMA, which the tally counts twice, issues
    once) at 128 per clock per SM, or each live pair's 3 int->float
    converts and rsqrt (and inside the erfc window its erfcf's and
    expf's MUFU instructions) at the 16 per clock per SM of their pipe,
    whichever takes longer."""
    from shenqi_tpu_torch.ops.p2p import (p2p_flops_outside_window,
                                          pair_counts)
    # FMAs in the tally (pair_counts): r^2 2, accumulation 3, the
    # window's; past the window, r^2's 2
    ops, fmas, xu = pair_counts(window, want_pot)
    instr = (inwin * (ops - fmas)
             + (pairs - inwin) * (p2p_flops_outside_window() - 2))
    return max(instr / H100_ISSUE_S,
               (inwin * xu + (pairs - inwin) * 4) / H100_XU_S) * 1e3


def _ptxas_report(log: str):
    """(kernel, 'N registers, S bytes smem, spills ...') per entry."""
    out, fn, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and fn:
            t = re.search(r"p2p_kernelILb([01])ELi(n?\d+)E", fn)
            if t:
                pot = "want_pot" if t.group(1) == "1" else "no pot"
                nc = int(t.group(2).replace("n", "-"))
                fn = (f"p2p_kernel<{pot}, "
                      + ("erfc window" if nc < 0 else f"degree {nc - 1}"
                         if nc else "run-time degree") + ">")
            out.append((fn, f"{m.group(1)} registers, {m.group(2)} B smem, "
                        f"{spill}"))
            fn = None
    return out


def main(argv) -> int:
    rehearsal = "--cpu-rehearsal" in argv
    steps_log = None
    if "--steps-log" in argv:
        steps_log = argv[argv.index("--steps-log") + 1]
    budget = REHEARSAL_BUDGET_S if rehearsal else BUDGET_S
    faulthandler.dump_traceback_later(budget + 30, exit=True)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available (torch.cuda.is_available()"
              " is False)", file=sys.stderr)
        return 1
    try:
        import shenqi_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: the shenqi_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 1
    smoke = Smoke(rehearsal)
    smoke.steps_log = steps_log
    smoke.budget = budget
    try:
        smoke.start_tables()
        for phase in ("env", "build", "kernel", "parity", "slice", "cli",
                      "dmsmall", "nu", "gas", "gas128", "stars", "bh", "mesh",
                      "reion", "lc", "erfc", "writer", "field", "profile"):
            getattr(smoke, phase)()
            if not rehearsal:
                torch.cuda.synchronize()
            check_budget(phase, budget)
        smoke.report()
    except Exception as e:  # every failure ends the run non-zero
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED after {elapsed():.1f} s: {e}",
              file=sys.stderr, flush=True)
        return 1
    finally:
        smoke.close()
        faulthandler.cancel_dump_traceback_later()
    say("done", f"all phases passed in {elapsed():.1f} s "
        f"(budget {budget:.0f} s)")
    if rehearsal:
        print(json.dumps({"ok": True, "rehearsal": "cpu"}), flush=True)
    else:
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
