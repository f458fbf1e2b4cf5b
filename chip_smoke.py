"""Smoke run of the PyTorch port (firefoam_torch) on one CUDA GPU.

    python chip_smoke.py

Phases (each prints one line; any failure raises and the exit code is not 0):
  1. the card: torch's device name and nvidia-smi's name and power limit;
  2. build the CUDA kernels from firefoam_torch/csrc/ (nvcc, sm_90a);
  3. the time of one grid barrier (grid.sync() over every co-resident
     block), then each kernel (K1 bicgstab, K2 pcg, K3 smooth) against its
     plain PyTorch version on the card, on random DIA systems with the
     box-fire offsets at 100k cells, float32 and float64, shared and
     per-row matrices (B in {1, 3, 4, 16} for K1/K2 and {1, 4} for K3: the
     grid-wide kernels), on the 9k-cell lattice, on a batch whose rows stop
     at different iterations, and on more rows than the card has blocks
     (the one-block-per-row kernels); K3's main-path solve is also timed
     through its one-block-per-row kernel, whose x must be bit-equal; K1 at
     the banded fvDOM's shapes, 128 and 160 rows of 100k cells with a
     matrix each (grid-wide with one block a row, and one block per row);
  4. the main path at 100k cells in float32: write_box_fire_case(50,40,50)
     → FireFoamSolver(device="cuda") → initial_state() → one warm-up step →
     make_chunk(20), with the kernels' launch counters checked, every logged
     number and the ray intensities finite, and the fire heating the gas;
  5. the 9k-cell case, 10 steps in float32 and in float64 on the card and in
     float64 on the CPU (the plain PyTorch solvers): the float32 T may drift
     from float64 by at most 0.05 relative, and the card's float64 T and U
     must match the CPU's within 1e-6 relative;
  6. the run CLI at 100k cells in float32 on the smoothSolver fire case with
     every run feature (write_smooth_fire_case: function objects, fvOptions,
     RTI probes and links), in-process through
     firefoam_torch.models.run.main: 30 steps in chunks of 10; the same 20
     steps writing once (time directory + checkpoint); 10 steps resumed
     from that checkpoint. Each run's launch counts (per step K3 3, K1 1
     plus the fvDOM steps, K2 2, plus 3 K2 of the hydrostatic init), the
     function-object and rtis rows, the written T and U against the
     checkpoint, and the repeated and resumed rows against the
     uninterrupted run (equal: the step is bit-reproducible on the card);
  7. the p_rgh solver family in float32: the lattice multigrid on the main
     path at 100k cells (FireFoamSolver(device="cuda", gmg=True)) from the
     developed state of phase 4 beside the K2 run of the same steps: every
     logged number finite, the gas heating, K2 launched by the hydrostatic
     init only and K1 as in phase 4, two multigrid runs bitwise equal, U of
     the two runs within 0.5 m/s and T within 0.05 relative (a K2 run with
     p_rgh in float64 beside it as the yardstick); the same pair from t = 0
     at 100k and at 500k cells (100, 50, 100), T and U within 0.5 K and 0.5
     m/s; then, at 9k, 100k and
     500k cells, one p_rgh system captured from a step and solved by K2 and
     gmg_pcg (at 9k also amg_pcg): ms, iterations, kernel launches and host
     reads per solve (torch.profiler), each x's normalised residual within
     the solve's tolerance;
  8. the exact solvers on the card, 9k cells in float64 with
     exact_solvers=True: the box fire (DIC-PCG on p_rgh) and the smoothSolver
     case (symGaussSeidel on Yi, h, k) over 10 steps against the CPU's
     float64 run of the same configuration (T and U within 1e-6 relative for
     the box fire and 1e-3 for the smoothSolver case, whose start-up
     amplifies last-bit differences), the last of these steps from the CPU's
     state within 1e-9 with equal iteration counts, iteration counts
     printed, ms per dic_pcg and per sgs_solve, two runs on the card bitwise
     equal;
  9. the gas-phase variants on the wall-fire case (write_wall_fire_case: a
     sheared lattice with the limited non-orthogonal correction,
     filteredLinear2V, WALE, eddyDissipationBertExtModel with an Fstar
     specie, the fire wall functions): at 100k cells in float32,
     make_chunk(20) from t = 0 with the launch counters checked (K1 and K2 as
     in phase 4, the species batch a K1 launch of 5 rows each step), fields
     and logs finite and the gas heating; the same 20 steps again, bitwise
     equal; launches and device-busy ms per step beside phase 4's box fire
     (torch.profiler); then the 9k-cell case with the ceiling baffle
     (thermalBaffle1D) over 10 steps, float64 on the card against float64
     on the CPU within CPU_TOL and float32 against float64 within the T
     drift band;
 10. the radiation family (write_radiation_fire_case): at 100k cells in
     float32, make_chunk(20) from t = 0 of grey-mean fvDOM (16 rays,
     greyMeanAbsorptionEmission with the ft table, constantScatter,
     maxIter 3, an absorptivityMode lookup wall, mixtureFractionSoot), of
     banded fvDOM (32 rays x Smith's 4 wsggmAbsorptionEmissionSmithBand
     bands: K1 gets 128 rows with a matrix each) and of P1 (one K1 row a
     radiation step), each with its launch counts checked against the
     solves (ray sweeps included), fields and logs finite, the gas heating
     below T_FLAME_MAX, and a second run bitwise equal; the radiation
     step's launches and device-busy ms beside a step without radiation
     (torch.profiler); its K1 launch captured and run again alone beside the
     plain version on the same operands, x within RAD_X_TOL and each row's
     true residual within RAD_RES_FACTOR of the plain version's; then at 9k
     cells 10 steps of each of the three, float64 on the card against
     float64 on the CPU (T and U within CPU_TOL, G within G_TOL) and float32
     against float64 within the T drift band, and one radiation solve from
     the CPU's float64 state at a tight tolerance on both sides, G within
     CPU_TOL; and viewFactor and opaqueSolid at 9k cells: an isothermal
     enclosure gives qr of about 0, and walls from 300 K to 1200 K give the
     card's float64 qr within CPU_TOL of the CPU's largest |qr|;
 11. unstructured meshes on the SEG layout (no kernel serves them; the
     solves run the plain twins and AMG): the castellated fire of the JAX
     package's unstructured scale row (write_castellated_fire_case
     (54,40,54), 2.0 x 1.5 x 2.0 m, mdot 0.01: about 117k cells) in
     float32, make_chunk(20) from t = 0 with no K1-K3 launch, fields and
     logs finite, the gas heating, a second run bitwise equal (the SEG sums
     are order-fixed); its ms/step, launches, host reads and device-busy ms
     per step, the host's seconds for the castellation, the geometry tables
     and the AMG build, ms and iterations per amg_pcg (and per Jacobi-CG twin
     on the same p_rgh system) and per twin BiCGStab solve, and the SEG
     sum's padded table beside a dense-plus-tail split and index_add_; then
     the 100k box fire with layout="seg" (the twins) beside phase 4's DIA
     run: T and U within GMG_TOL after GMG_STEPS steps from t = 0, T within
     GMG_T_DRIFT relative and U within GMG_TOL after phase 4's 1 + 20 steps
     (a flame: float32 round-off grows there, phase 7), and 1 + 10 steps
     in float64, SEG against DIA within CPU_TOL;
     then the castellated fire at 10k cells, 10 steps, float64 on the card
     against float64 on the CPU within CPU_TOL and float32 against float64
     within the T drift band;
 12. the Lagrangian sprinkler spray (write_spray_fire_case: the box fire with
     a detailed-sprinkler head spraying from t = 0, cloud radiation in
     fvDOM, a collector; the JAX package's capacity, 262,144 parcel slots;
     the cloud is plain PyTorch ops, no kernel of its own): at 100k cells
     in float32, make_chunk(20) after one warm-up step with the K1/K2 launch
     counts checked against the solves (fvDOM's sweeps with the spray's
     terms included, no K3), every field, parcel field and log finite,
     parcels alive, the mass bookkeeping (injected + the mass a parcel gains
     or loses as its density follows its temperature at a fixed diameter =
     in the system + evaporated + escaped + collected + dropped at
     minParticleMass, within SPRAY_MASS_TOL), a second run bitwise equal
     (cloud and random key
     included); ms/step, launches, host reads and device-busy ms per step
     beside phase 4's box fire, and the cloud's share of them; the run
     CLI's engine (run_case) writing a time directory and a checkpoint (the
     cloud's SoA, lists and key) and resuming bitwise equal to the
     uninterrupted run; then at 9k cells 10 steps in lockstep: float64 on
     the card against float64 on the CPU step by step (parcels and
     iteration counts equal; T and U within SPRAY_CHAIN_TOL, ROADMAP R10),
     the last step from the CPU's state within STEP_TOL with equal counts,
     float32 within the T drift band;
 13. the region fires (pyrolysis zones, the wall film and their coupling to
     the gas and the spray; plain PyTorch ops, no kernel of their own): the
     wetted panel fire (write_wetted_panel_fire_case: phase 12's sprinkler
     fire in a 1 x 0.5 x 1 m box with no collector, so that the drops reach
     the floor film, with a reactingOneDim21 panel of 1,900 columns x 20
     layers on the x = 0 wall, a thermoSingleLayer film over the floor and
     the panel fed along its top rim, the cloud's splashBai handoff and the
     film's drip injection) at 100k cells in float32: make_chunk(20) after
     one warm-up step with the K1/K2 launch counts checked against the
     solves, every field, parcel, film and solid leaf and log finite, the
     panel's surface heating, pyrolysate flowing into the gas, film mass
     above 0, the spray striking the film, the solid's mass ledger (the
     pyrolysate it sent against its own tally, within SOLID_TALLY_TOL, and
     against the mass lost from its density field, within SOLID_MASS_TOL)
     and the film's (inlet + impinged = film + evaporated + dripped +
     removed, within FILM_MASS_TOL), a second run bitwise equal (film,
     solid, cloud and key included); ms/step, launches, host reads and
     device-busy ms per step beside phase 4's box fire, and the regions'
     share (torch.profiler on _evolve_film and _evolve_pyrolysis alone);
     run_case writing and checkpointing (the solid's list and the film)
     and resuming bitwise equal; at 9k cells the panel fire and the wetted
     panel fire, 10 steps from t = 0 in lockstep (card float64 against the
     CPU's, within CPU_TOL for the panel fire, REGION_CHAIN_TOL for the
     wetted one; float32 within the T drift band); the panel fire's last
     step from the CPU's state within STEP_TOL with equal counts; the
     wetted fire's card run from the CPU's state at step 10 across the
     spray's strike on the film (T and U within STRIKE_CHAIN_TOL; impinged
     mass each step, film and solid within HANDOFF_TOL; parcels alive
     equal; impinged above 0),
     step 30 from the CPU's state, where the film drips, within STEP_TOL
     (film, cloud, impinged and dripped mass, counts equal), and
     FilmDripInjection against the CPU's on a set drip flux (DRIP_TOL); the
     solid-only case (write_pyrolysis_1d_case, solvePrimaryRegion false)
     through the run CLI, the card's float32 solid against the CPU's
     float64 within SOLID_F32_TOL;
 14. the spray's stock submodels (plain PyTorch ops, no kernel of their
     own): the multiphase spray fire (write_multiphase_spray_fire_case:
     phase 12's box with a coneNozzle of C3H8/H2O/ash parcels at 20,000
     parcels/s, singleKineticRate devolatilisation into C3H8 and the MPPIC
     packing, damping and isotropy models; 262,144 slots) at 100k cells in
     float32, make_chunk(20) after one warm-up step with the K1/K2 launch
     counts checked, every field, parcel lane and log finite, devolatilised
     mass above 0 and the C3H8 equation's source equal to it, the liquid's
     ledger (phase 12's, SPRAY_MASS_TOL) and the volatiles' (injected = held
     + devolatilised + carried out, VOLATILE_MASS_TOL), a second run bitwise
     equal (mv, MPPIC's draws and the key included), ms/step, launches,
     host reads and device-busy ms beside phase 4's box fire and the shares
     of MPPIC.apply and of the devolatilisation (torch.profiler), run_case
     writing, checkpointing (mv, mv0, ms) and resuming bitwise; the DEM
     spray (write_dem_spray_fire_case: two drops thrown at each other,
     pairCollision with 20 sub-cycles, 4,096 slots) at 100k cells, DEM_STEPS
     steps after the burst: finite, the drops meeting (partner records held
     over the sub-cycles, x velocities turned round), launch counts, a
     second run bitwise equal;
     PairCollision.collide alone on 16,384 parcels of a jittered packed
     lattice: ms a sub-cycle, peak memory and its row-block size, bitwise
     equal in blocks of LATTICE_BLOCK rows; at 9k cells both fires in
     phase 12's lockstep against the CPU (the DEM spray cut to
     DEM_SMALL_CAPACITY slots; the multiphase fire's parcels carry fuel, so
     float32's own draws (R11) move where it burns: the band holds a float32
     run with float64's draws rounded, and the drift as drawn is printed),
     and every stock injector card against CPU;
 15. multiple partitions (firefoam_torch/parallel/): the ranks are
     processes on cuda:0 over gloo (NCCL takes one rank per card), their
     CUDA payloads staged through host buffers (counted and printed). The
     100k box fire in 4 RCB parts: one float64 step from the single card's
     SEG flat state after 10 steps within 1e-10 with equal iteration
     counts, the same step again bitwise equal; 10 float32 steps timed
     (ms/step, device-busy ms, collectives and bytes a step by kind, bytes
     staged) beside phase 4's box fire; the 100k box fire in 2 z-slabs,
     p_rgh by the sharded lattice multigrid, 3 float64 steps from t = 0
     against the single card's DIA multigrid: at the case's tolerances the
     p_rgh iterations (tests/test_spmd_gmg.py's bounds), and with every
     solve taken to 1e-10 the fields (that test's bounds on T, p_rgh and
     U); the 100k sprinkler fire in 4
     RCB parts, 5 float64 steps: parcels equal and spray mass within 1e-8
     each step against the single card's SEG flat run, parcels migrating
     (seeded across the parts if none cross by themselves), none
     overflowing, alive on more than one rank; each sub-run's seconds;
 16. the kernels' JSON line (with launches_multiphase_path,
     launches_dem_path and launches_sharded_path), the DEM lattice's line,
     the partitions' line, the card line, and the final JSON line.

Imports nothing of JAX. Needs a CUDA card, nvcc and the repository checkout.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from firefoam_torch.io import read_field_file  # noqa: E402
from firefoam_torch.lagrangian import prng  # noqa: E402
from firefoam_torch.models import run as run_cli  # noqa: E402
from firefoam_torch.models import firefoam as firefoam_mod  # noqa: E402
from firefoam_torch.models.firefoam import FireFoamSolver  # noqa: E402
from firefoam_torch.solvers import dia_krylov, dic, linear  # noqa: E402
from firefoam_torch.profile_step import _busy_us  # noqa: E402
from firefoam_torch.radiation import fvdom as fvdom_mod  # noqa: E402
from firefoam_torch.spray_sensitivity import float64_draws  # noqa: E402
from firefoam_torch.utils.synthcase import (  # noqa: E402
    write_box_fire_case, write_castellated_fire_case, write_dem_spray_fire_case,
    write_multiphase_spray_fire_case, write_panel_fire_case, write_pyrolysis_1d_case,
    write_radiation_fire_case, write_smooth_fire_case, write_spray_fire_case,
    write_wall_fire_case, write_wetted_panel_fire_case)

N_MAIN = (50, 40, 50)  # 100,000 cells
N_SMALL = (30, 15, 20)  # 9,000 cells
N_LARGE = (100, 50, 100)  # 500,000 cells
# the castellated fire of the JAX package's unstructured scale row
# (bench.py:189-193): about 117k cells, 343k internal faces
N_CASTEL = (54, 40, 54)
CASTEL_KW = dict(size=(2.0, 1.5, 2.0), mdot=0.01)
N_CASTEL_SMALL = (24, 16, 24)  # 10,064 cells
GMG_STEPS = 5  # steps of each run of a K2/multigrid pair
# T [K] and U [m/s] of a multigrid run against the K2 run of the same steps
# from t = 0 (the comparison and the bound of the JAX package's multigrid
# test): both solves stop at the same dictionary tolerance
GMG_TOL = 0.5
# from a burning state T is held to the float32 drift band instead (phase
# 5's 0.05 relative): the two solvers leave different error modes at the
# same stated tolerance, and a flame front of 1000 K a cell turns a shift of
# a thousandth of a cell into kelvins. A K2 run with its p_rgh solve in
# float64 is printed beside it as the yardstick of that sensitivity
GMG_T_DRIFT = 0.05
# phase 9: float32 T against float64 (phase 5's band), and the steps whose
# launches and device time the profiler reads
T_DRIFT = 0.05
PROFILE_STEPS = 3
# phase 11: the profiler's steps on the 100k box fire on SEG and on DIA
# (the step after 1 + 20, which solves no rays, as the two after it) and
# the float64 SEG-against-DIA box fire's depth (1 + these steps, with the
# radiation solves of steps 1 and 11 of 1 + 20)
SEG_PROFILE_STEPS = 1
SEG_F64_STEPS = 10
# above propane's adiabatic flame temperature in air (about 2,270 K) and
# below the thermo's upper clip: a diverged run sits at the clip
T_FLAME_MAX = 3000.0
CHUNK = 20
DRIFT_STEPS = 10
# K1 rows of the banded fvDOM: 32 rays x 4 bands (grid-wide, one block a
# row on a 132-SM card) and x 5 bands (more rows than blocks)
BANDED_ROWS = (128, 160)
# isothermal enclosure: |qr| against σT⁴ of the walls (the view factors'
# closure comes from 50 scaling passes, not an exact normalisation)
QR_ISO_TOL = 1e-3
# the grey-mean absorption in float32 against float64 from the same state:
# its T-polynomials in 1/T cancel about twentyfold
FT_TABLE_TOL = 1e-4
# phase 12: the sprinkler head's parcels a second at 100k cells, enough for
# the JAX package's largest capacity (ceil(pps·maxDeltaT) + 1 parcels a step
# × 2048 steps, capped at 262,144); at 9k cells fewer (43,008 slots), as
# the CPU runs the same steps
SPRAY_PPS = 20000.0
SPRAY_CAPACITY = 262144
SPRAY_PPS_SMALL = 2000.0
SPRAY_PROFILE_STEPS = 2  # the profiler's steps (it costs about 6 s a 100k step)
# the 9k sprinkler fire's float64 card-vs-CPU chain after DRIFT_STEPS steps:
# the species' shared convection weight takes the minimum of every species'
# limiter, and those of species at 1e-70 flip with the last bit, so the
# chain departs at step 5 (ROADMAP R10; firefoam_torch/spray_sensitivity.py).
# Measured after 10 steps: card vs CPU T 1.472e-06, U 2.162e-06; a 1e-14 m/s
# nudge of U on the CPU alone T 3.002e-06, U 3.655e-06. One step from the
# CPU's state is held to STEP_TOL with equal iteration counts
SPRAY_CHAIN_TOL = 1e-5
# injected + expansion = in the system + evaporated + escaped + collected +
# dropped at minParticleMass, relative to injected; each term summed in
# float32 over the 262,144 slots (set from the readings: see PERF.md)
SPRAY_MASS_TOL = 1e-5
# phase 13. The region fires' boxes: 1 x 0.5 x 1 m and no collector, so that
# the sprinkler's drops (head 0.1 m below the top) reach the floor film
# within the runs' steps (at 9k cells from step 11 on, on the CPU)
WET_MAIN_KW = dict(pps=SPRAY_PPS, size=(1.0, 0.5, 1.0), collector=False, end_time=100.0)
WET_SMALL_KW = dict(pps=SPRAY_PPS_SMALL, size=(1.0, 0.5, 1.0), collector=False)
WET_CHAIN = 5  # 9k: the card's steps across the strike, from the CPU's state
WET_DRIP_STEP = 30  # 9k: a step at which the film drips (from step 28 on, CPU)
# The solid's mass ledger over the 100k chunk, relative to the pyrolysate
# it sent (Σ flux·dt, in float64): its own float32 tally of the mass it
# lost within SOLID_TALLY_TOL, and the mass lost from its float32 density
# field (summed in float64; the field's rounding) within SOLID_MASS_TOL.
# The film's ledger relative to the water taken in (a substep adds water at
# the film's density at the gas pressure and its old T, the mass is weighed
# at 1 atm and its new T: 8e-4 on the CPU in float64 over 40 steps of the
# 9k-class test case). The 9k wetted fire card vs CPU in float64 over the
# 10 steps from t = 0 (R10's limiter flips ride on the spray's vapour; the
# panel fire, without a spray, is held to CPU_TOL). Across the strike, from
# the CPU's state: T and U (a flip at the first step after the strike)
# within STRIKE_CHAIN_TOL, the handoff (impinged mass a step, every film
# leaf, the solid's T) within HANDOFF_TOL. FilmDripInjection card vs CPU
# within DRIP_TOL (the CPU test's bound). The solid-only case's float32
# card run against the CPU's float64 (T of the solid). Readings on an
# NVIDIA H100 80GB HBM3 at 700 W: tally 4.3e-08, lost 7.3e-04, film
# 1.8e-04, chain 3.0e-06, strike T/U 1.3e-05, handoff 6.4e-09, drip
# 2.2e-14, solid-only 5.9e-08 (PERF.md, the region models' findings)
SOLID_TALLY_TOL = 5e-7
SOLID_MASS_TOL = 2e-3
FILM_MASS_TOL = 1e-3
REGION_CHAIN_TOL = 1e-5
STRIKE_CHAIN_TOL = 5e-5
HANDOFF_TOL = 1e-7
DRIP_TOL = 1e-12
SOLID_F32_TOL = 1e-6
# phase 14. The DEM spray: the JAX package's capacity for its 2 parcels a
# step (4,096 slots), DEM_STEPS steps (at 100k cells its drops meet in the
# second), cut to DEM_SMALL_CAPACITY slots at 9k cells, where the CPU's dense
# pair matrix of 4,096 slots would take minutes a step; PairCollision.collide
# alone on a LATTICE of 16,384 parcels, and again in blocks of LATTICE_BLOCK
# rows (16 blocks and a short one). The multiphase spray's volatile ledger
# (injected = held + devolatilised + carried out, relative to injected; each
# term a float32 sum) within VOLATILE_MASS_TOL, and the devolatilised mass
# against the C3H8 equation's source within SOURCE_TOL. Readings on an NVIDIA
# H100 80GB HBM3 at 700 W: ledger 7.989e-08, source 1.055e-07 (PERF.md, the
# stock submodels' findings)
DEM_CAPACITY = 4096
DEM_STEPS = 6
DEM_SMALL_CAPACITY = 512
LATTICE = (32, 32, 16)
LATTICE_BLOCK = 1000
VOLATILE_MASS_TOL = 1e-6
SOURCE_TOL = 1e-6
# phase 15. The partitions: ranks on cuda:0 over gloo (NCCL takes one rank
# per card). The box fire in SHARD_P RCB parts: one float64 step from the
# single card's state after SHARD_WARM steps within SHARD_TOL with equal
# iteration counts; SHARD_F32_STEPS float32 steps timed. The box fire in two
# z-slabs (the sharded lattice multigrid) over SHARD_GMG_STEPS steps from
# t = 0 against the single card's DIA multigrid, twice: at the case's
# tolerances the p_rgh iterations within tests/test_spmd_gmg.py's bounds
# (at most 25, at most the single card's + 15); and with every linear solve
# taken to SHARD_TIGHT_TOL (relTol 0) on both sides, so that the two
# multigrids' different stopping points leave the comparison, each field
# within that test's bound (SHARD_GMG_TOL, set there at 3,840 cells). At
# 100k cells the two runs part by U 2.0e-05 at the case's tolerances and by
# U 4.6e-12 with every solve at 1e-12 (PERF.md, the partitions). The
# sprinkler fire in SHARD_P parts over SHARD_SPRAY_STEPS steps: parcels equal
# and spray mass each step within SHARD_MASS_TOL relative, the bound of
# tests/test_spmd_cloud.py (the card's float64 gas fields part at 1e-14 and
# the evaporated mass follows: 1.6e-11 after 5 steps, PERF.md, the partitions)
SHARD_P = 4
SHARD_BACKEND = "gloo"
SHARD_WARM = 10
SHARD_F32_STEPS = 10
SHARD_GMG_STEPS = 3
SHARD_SPRAY_STEPS = 5
SHARD_TOL = 1e-10
SHARD_GMG_TOL = {"T": 1e-6, "p_rgh": 1e-4, "U": 1e-5}
SHARD_MASS_TOL = 1e-8
SHARD_GMG = None  # the partitioned solver's rule: the sharded multigrid from 50k cells
SHARD_TIGHT_TOL = 1e-10
SHARD_DEADLINE = 900.0
SHARD_FIELDS = ("T", "U", "p_rgh", "rho", "k", "Y", "hs")
SHARD_ITERS = ("p_rgh_iters_0", "p_rgh_iters_1", "Ux_iters", "Uy_iters", "Uz_iters",
               "O2_iters", "C3H8_iters", "H2O_iters", "CO2_iters", "h_iters", "k_iters")
SOURCE = "firefoam_torch/csrc/dia_krylov.cu"
REPLACES = {
    "bicgstab": "firefoam_tpu/solvers/pallas_cg.py:281",
    "pcg": "firefoam_tpu/solvers/pallas_cg.py:201",
    "smooth": "firefoam_tpu/solvers/pallas_cg.py:377",
}
# (x rel, iteration slack); K3's f32 slack is one round of 4 sweeps: its
# float32 stagnation exit can fire a round apart from the plain version's
TOL = {torch.float64: (1e-9, 0), torch.float32: (1e-4, 2)}
SMOOTH_F32_SLACK = 4
SMOOTH_SWEEPS = 800  # the fire step's budget: max(maxIter, 200)·4
SMOOTH_EXTRA = (0.8, 4)  # dia_smooth's defaults: damping, sweeps per residual check
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
# bytes/s and non-tensor-core FLOP/s per type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# floating-point operations per cell, counted from csrc/dia_krylov.cu: one
# DIA row (K = 3 offsets) is 14; the prologue (2 rows + norm sums) 40;
# a CG iteration 29; a BiCGStab iteration 58; a Jacobi sweep 18 and its
# residual check (once per 4 sweeps) 17
FLOPS_PROLOGUE = 40
FLOPS_ITER = {"pcg": 29, "bicgstab": 58, "smooth": 18 + 17 / 4}
# vectors of nC values each iteration (sweep) of a row streams, counted from
# the kernels' passes: CG 20, BiCGStab 39, a Jacobi sweep 10 plus its
# residual check (9, once per 4 sweeps)
VECTORS_ITER = {"pcg": 20, "bicgstab": 39, "smooth": 10 + 9 / 4}
# barriers over all of a row's blocks per iteration (sweep), each with a
# dependent pass behind it: what an iteration costs when its bytes are on
# the SMs. K3: one per sweep and one per residual check (every 4 sweeps); the
# rows' "still iterating" flags ride on the round's first sweep barrier. Each
# kernel passes one more barrier than counted here, the one at which it
# learns that no row iterates any more
BARRIERS_ITER = {"pcg": 3, "bicgstab": 5, "smooth": 1 + 1 / SMOOTH_EXTRA[1]}
BARRIERS_PROLOGUE = 2
CHUNK_CLI = 10
# repeated and resumed vs uninterrupted CLI runs, per column of the printed
# (8-digit) rows relative to the column's largest value: 0, the card's step
# is bit-reproducible (every reduction has a fixed order; the boundary sums'
# index_add_ groups never collide, so its atomics add in a fixed order)
RESUME_TOL = 0.0
# card f64 vs CPU f64 after DRIFT_STEPS steps: the fvDOM ray solves stop at
# a residual of 1e-4, and where they stop depends on summation order
CPU_TOL = 1e-6
# the radiation field itself (G) after DRIFT_STEPS steps, card f64 vs CPU
# f64: BiCGStab carries a 1e-16 relative perturbation of a ray batch's
# right-hand side into G at 4e-6..6e-6 (9k-cell grey-mean batch on the CPU),
# and P1's G solve into 45..53 iterations and 1.3e-7; G is held to the ray
# solve's tolerance. What this run's G owes to its solves' stopping points
# alone is held to CPU_TOL by one solve at RAD_TIGHT_TOL from one state
G_TOL = 1e-4
RAD_TIGHT_TOL = 1e-12
# the radiation's K1 launch captured in the step and run again alone: x of
# the kernel against the plain version's (measured 4.9e-05..2.2e-04 in
# float32, where the two stop some iterations apart), and each row's true
# normalised residual against max(the plain version's, the tolerance). Both
# residuals are recomputed in float64 with float64's normFactor: where a
# row's intensity is nearly uniform that normFactor is small and float32's
# own is rounding noise, so a float32 solve that stopped at 1e-4 by its own
# measure can read far above 1e-4 here (Smith's transparent band at (8,6,7)
# on the CPU reads 0.86 for both versions alike)
RAD_X_TOL = 1e-2
RAD_RES_FACTOR = 10.0
# one step on the card from the CPU's float64 state, against the CPU's step
STEP_TOL = 1e-9
# the smoothSolver case over DRIFT_STEPS steps from t = 0, card f64 vs CPU
# f64: its start-up amplifies last-bit differences tenfold a step from step 5
# on whatever solves Yi, h and k (with K3 and its twin U reads 6.1e-05 after
# 10 steps, with symGaussSeidel 7.9e-05, iteration counts equal throughout)
SMOOTH_CHAIN_TOL = 1e-3


_T0 = time.perf_counter()


def say(phase, msg):
    """One line of phase `phase`, with the seconds since the script started
    (the run has a time limit: the next slice reads where it went)."""
    print(f"[{phase}] {msg} (+{time.perf_counter() - _T0:.0f} s)", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 3
def dia_system(rng, nxyz, B, per_row, sym, dtype, dev):
    """Random diagonally dominant DIA system(s) on the lattice stencil:
    (diag, upper, lower, b, x0) with [B, ...] rows, off-diagonals shared
    when not per_row."""
    nx, ny, nz = nxyz
    n = nx * ny * nz
    offs = (1, nx, nx * ny)
    c = np.arange(n)
    i, j, k = c % nx, (c // nx) % ny, c // (nx * ny)
    exists = [i + 1 < nx, j + 1 < ny, k + 1 < nz]
    rows = B if per_row else 1
    up = np.zeros((rows, 3, n))
    lo = np.zeros((rows, 3, n))
    for kk in range(3):
        v = -(0.5 + rng.rand(rows, n)) * exists[kk]
        up[:, kk] = v
        lo[:, kk] = v if sym else v * (1.0 + 0.3 * rng.rand(rows, n))
    diag = 1.0 + 0.1 * rng.rand(B, n)
    for kk, o in enumerate(offs):
        u = up[:, kk] if per_row else np.broadcast_to(up[:, kk], (B, n))
        l_ = lo[:, kk] if per_row else np.broadcast_to(lo[:, kk], (B, n))
        diag[:, : n - o] -= u[:, : n - o]
        diag[:, o:] -= l_[:, : n - o]
    b = rng.randn(B, n)
    x0 = 0.1 * rng.randn(B, n)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
    up = up.reshape(rows, 3 * n)
    lo = lo.reshape(rows, 3 * n)
    if not per_row:
        up, lo = up[0], lo[0]
    return offs, t(diag), t(up), t(lo), t(b), t(x0)


def time_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(name, dtype, ops, iters):
    """(bound_ms, bound_by): the least time the card could take for one
    solve of these operands — the larger of the bytes the function must
    move (each operand read once, x written once) over HBM's rate and the
    operations this run's iteration counts needed over the peak rate."""
    nbytes = sum(t.numel() for t in ops) * ops[0].element_size()
    nbytes += ops[-1].numel() * ops[-1].element_size()  # x, the shape of x0
    nC = ops[-1].shape[-1]
    B = ops[-1].shape[0] if ops[-1].ndim == 2 else 1
    flops = nC * (B * FLOPS_PROLOGUE + FLOPS_ITER[name] * float(np.sum(iters)))
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def streamed_ms(name, dtype, nC, iters):
    """The time HBM takes to stream every iteration's vectors once (no
    reuse from cache between passes): a looser bound than `bound`."""
    nbytes = VECTORS_ITER[name] * nC * torch.finfo(dtype).bits // 8 * float(np.sum(iters))
    return 1e3 * nbytes / HBM_BYTES_S


def latency_ms(name, iters, sync_s):
    """iterations × grid barriers per iteration × the measured time of one
    grid barrier (plus the prologue's): the least a solve that synchronises
    that often can take on this card."""
    return 1e3 * sync_s * (BARRIERS_PROLOGUE + BARRIERS_ITER[name] * float(np.max(iters)))


def phase_sync():
    """The time of one grid.sync() over every co-resident block of K2."""
    G, _ = dia_krylov._coop_blocks("pcg", torch.float32, 0)
    sync_s = dia_krylov.grid_sync_seconds(G)
    say(3, f"one grid barrier over {G} blocks of 1024 threads: {1e6 * sync_s:.3f} us "
           f"(over 9 blocks {1e6 * dia_krylov.grid_sync_seconds(9):.3f} us)")
    if not 0.0 < sync_s < 1e-3:
        raise SystemExit("phase 3: implausible grid barrier time")
    return G, sync_s


def phase_kernels(dev, G, sync_s):
    rng = np.random.RandomState(0)
    stats = {}
    smooth_kw = dict(max_iter=SMOOTH_SWEEPS)
    # (lattice, B, per-row matrices, rows stop apart)
    main = tuple((N_MAIN, B, pr, False)
                 for B, pr in ((1, False), (3, False), (4, True), (16, True)))
    # the wall fire's species batch (Fstar makes it 5 rows) and the banded
    # fvDOM's (ray x band) batches, 32 x 4 and 32 x 5 rows: K1 only
    wall = ((N_MAIN, 5, True, False),) + tuple((N_MAIN, B, True, False) for B in BANDED_ROWS)
    extra = ((N_SMALL, 1, False, False), (N_SMALL, 4, True, False), (N_SMALL, 4, True, True),
             (N_SMALL, G + 68, False, False))  # more rows than blocks: 200 on an H100
    for name, plain, kern, sym, shapes in (
        ("pcg", lambda *a, **k: dia_krylov.plain(linear.pcg, *a, **k), dia_krylov.dia_pcg, True,
         main + extra),
        ("bicgstab", lambda *a, **k: dia_krylov.plain(linear.bicgstab, *a, **k),
         dia_krylov.dia_bicgstab, False, main + wall + extra),
        ("smooth", dia_krylov.plain_smooth, dia_krylov.dia_smooth, False,
         ((N_MAIN, 1, False, False), (N_MAIN, 4, True, False)) + extra),
    ):
        st = stats.setdefault(name, {"max_abs_err": 0.0})
        for dtype in (torch.float64, torch.float32):
            xtol, slack = TOL[dtype]
            if name == "smooth" and dtype == torch.float32:
                slack = SMOOTH_F32_SLACK
            for nxyz, B, per_row, apart in shapes:
                offs, d, up, lo, b, x0 = dia_system(rng, nxyz, B, per_row, sym, dtype, dev)
                nC = x0.shape[-1]
                args = dict(tol=1e-8, rel_tol=0.0, max_iter=1000)
                if name == "smooth":
                    args.update(smooth_kw)
                if apart:  # right-hand sides of very different size and a relTol
                    scale = torch.tensor([1.0, 1e3, 1e-3, 30.0], dtype=dtype, device=dev)
                    b = (b * scale[:, None]).contiguous()
                    args.update(tol=1e-6, rel_tol=0.05)
                if apart and name == "smooth":
                    # Jacobi's rate follows the diagonal's dominance: heavier
                    # diagonals reach one absolute tolerance rounds sooner
                    heavier = torch.tensor([0.0, 0.5, 2.0, 8.0], dtype=dtype, device=dev)
                    d = d + heavier[:, None]
                    args.update(tol=1e-4, rel_tol=0.0)

                def run_k():
                    return kern(d, up, lo, b, x0, offs, **args)

                def laid_out(**kw):
                    """The same launch with another layout or kernel."""
                    return dia_krylov._launch(
                        name, d, up, lo, b, x0, offs, args["tol"], args["rel_tol"],
                        args["max_iter"], extra=SMOOTH_EXTRA if name == "smooth" else (), **kw)

                def ms_laid_out(**kw):
                    return time_ms(lambda: laid_out(**kw), reps=20)

                def run_p():
                    return plain(d, up, lo, b, x0, offs, **args)

                rk, rp = run_k(), run_p()
                torch.cuda.synchronize()
                it_k = rk.n_iterations.cpu().numpy()
                it_p = rp.n_iterations.cpu().numpy()
                err = float((rk.x - rp.x).abs().max())
                rel = float(((rk.x - rp.x).abs().amax(-1) / rp.x.abs().amax(-1)).max())
                ok = rel <= xtol and np.all(np.abs(it_k - it_p) <= slack) and bool(
                    torch.isfinite(rk.x).all()
                )
                if apart and len(set(it_p.tolist())) < 2:
                    raise SystemExit("phase 3: the rows meant to stop apart stopped together")
                ms_k, ms_p = time_ms(run_k, reps=20), time_ms(run_p, reps=2)
                plan, smem = dia_krylov._grid_launch_plan(name, dtype, B, nC, len(offs),
                                                          x0.element_size())
                blocks = (f" grid-wide {B}x{plan.blocks_per_row} blocks of "
                          f"{plan.cells_per_block} cells, {smem} B shared"
                          if plan.grid_wide else " one block per row")
                show = (lambda a: a.tolist()) if B <= 16 else (
                    lambda a: f"{int(a.min())}..{int(a.max())}")
                say(3, f"{name} {str(dtype)[6:]} {nC} cells B={B} "
                       f"{'per-row' if per_row else 'shared'}{' rows apart' if apart else ''}"
                       f"{blocks}: iters kernel {show(it_k)} plain {show(it_p)} "
                       f"max rel err {rel:.3e} kernel {ms_k:.3f} ms plain {ms_p:.3f} ms")
                if not ok:
                    raise SystemExit(f"phase 3: {name} disagrees with its plain version")
                st["max_abs_err"] = max(st["max_abs_err"], err)
                # the main path's shapes in float32: U-like shared rows for
                # K1, one p_rgh row for K2, one h or k row for K3 (whose
                # iterations are sweeps)
                if nxyz == N_MAIN and dtype == torch.float32 and (
                        (name in ("pcg", "smooth") and B == 1) or (name == "bicgstab" and B == 3)):
                    st["ms"], st["plain_ms"] = ms_k, ms_p
                    st["bound_ms"], st["bound_by"] = bound(name, dtype, (d, up, lo, b, x0), it_k)
                    st["latency_ms"] = latency_ms(name, it_k, sync_s)
                    st["us_per_iteration"] = 1e3 * ms_k / float(np.max(it_k))
                    say(3, f"{name} bound {st['bound_ms']:.4f} ms ({st['bound_by']}); "
                           f"every iteration's vectors streamed from HBM "
                           f"{streamed_ms(name, dtype, nC, it_k):.4f} ms; its grid barriers alone "
                           f"{st['latency_ms']:.4f} ms; {it_k.tolist()} iterations, "
                           f"{st['us_per_iteration']:.3f} us each")
                    st["blocks"] = B * plan.blocks_per_row
                    say(3, f"{name} the same solve with its slices streamed from L2 "
                           f"(nothing kept in shared memory) "
                           f"{ms_laid_out(resident=False):.3f} ms; with at least 256 cells "
                           f"a block {ms_laid_out(min_cells=256):.3f} ms, 1024 cells "
                           f"{ms_laid_out(min_cells=1024):.3f} ms")
                if (name == "bicgstab" and nxyz == N_MAIN and dtype == torch.float32
                        and B in (5,) + BANDED_ROWS):
                    row = {"ms": ms_k, "plain_ms": ms_p, "iterations": int(np.max(it_k)),
                           "us_per_iteration": 1e3 * ms_k / float(np.max(it_k)),
                           "bound_ms": bound(name, dtype, (d, up, lo, b, x0), it_k)[0],
                           "streamed_ms": streamed_ms(name, dtype, nC, it_k),
                           # one block per row: block barriers, no grid barrier
                           "latency_ms": latency_ms(name, it_k, sync_s) if plan.grid_wide else None,
                           "blocks": B * plan.blocks_per_row if plan.grid_wide else B}
                    st[f"B{B}"] = row
                    batch = "the wall fire's species" if B == 5 else "the banded fvDOM's"
                    say(3, f"bicgstab B={B} per-row ({batch} batch): "
                           f"{row['iterations']} iterations, {row['us_per_iteration']:.3f} us each, "
                           f"{row['blocks']} blocks; bound {row['bound_ms']:.4f} ms; streamed "
                           f"{row['streamed_ms']:.4f} ms; grid barriers alone "
                           f"{'n/a' if row['latency_ms'] is None else format(row['latency_ms'], '.4f')} ms")
                if name == "smooth" and nxyz == N_MAIN and B in (1, 4):
                    # the main path's h/k and Yi shapes through the kernel that
                    # takes B > G: a sweep is the same expression in both
                    one = laid_out(grid_wide=False)
                    same_sweeps = torch.equal(one.n_iterations, rk.n_iterations)
                    say(3, f"smooth {str(dtype)[6:]} B={B} one block per row: "
                           f"{ms_laid_out(grid_wide=False):.3f} ms, sweeps "
                           f"{one.n_iterations.tolist()}, x bit-equal to the grid-wide "
                           f"kernel's: {torch.equal(one.x, rk.x)}")
                    if same_sweeps and not torch.equal(one.x, rk.x):
                        raise SystemExit("phase 3: K3's two kernels differ after equal sweeps")
                if nxyz == N_SMALL and dtype == torch.float32 and B == 1:
                    say(3, f"{name} {nC} cells: {1e3 * ms_k / float(np.max(it_k)):.3f} us per "
                           f"iteration; with at least 128 cells a block "
                           f"{ms_laid_out(min_cells=128):.3f} ms, 256 "
                           f"{ms_laid_out(min_cells=256):.3f} ms, 1024 "
                           f"{ms_laid_out(min_cells=1024):.3f} ms")
    return stats


# ---------------------------------------------------------------- phase 4
def expected_launches(rad, count0, n_steps):
    """K1/K2 launches n_steps steps make: per step U, Yi, h, k (K1) and two
    p_rgh correctors (K2); fvDOM adds one K1 launch on its solve steps."""
    n_rad = 0
    if rad is not None:
        for c in range(count0, count0 + n_steps):
            if c == 0 or (rad.solver_freq > 0 and c % rad.solver_freq == 0):
                n_rad += 1
    return 4 * n_steps + n_rad, 2 * n_steps


def phase_main(dev, case):
    t0 = time.perf_counter()
    solver = FireFoamSolver(case, device=dev)
    state = solver.initial_state()
    T0_max = float(state["T"].i.max())
    step = solver.make_step()
    state, _ = step(state)  # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    count0 = int(state["rad"]["count"]) if "rad" in state else 0
    chunk = solver.make_chunk(CHUNK)
    dia_krylov.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, logs = chunk(state)
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t0
    launches = dict(dia_krylov.LAUNCHES)
    exp_k1, exp_k2 = expected_launches(solver.radiation, count0, CHUNK)
    n = solver.geom.n_cells
    ms = 1e3 * dt_s / CHUNK
    finite = bool(torch.isfinite(state["T"].i).all() and torch.isfinite(state["U"].i).all())
    bad_logs = [k for k, v in logs.items() if not bool(torch.isfinite(torch.as_tensor(v)).all())]
    rays_finite = bool(torch.isfinite(state["rad"]["I"]).all()) if "rad" in state else True
    T_max = float(state["T"].i.max())
    qdot = float(logs["Qdot_total"][-1])
    p_its = [[int(a), int(b)] for a, b in zip(logs["p_rgh_iters_0"], logs["p_rgh_iters_1"])]
    u_its = [[int(a), int(b), int(c)] for a, b, c in
             zip(logs["Ux_iters"], logs["Uy_iters"], logs["Uz_iters"])]
    say(4, f"{n} cells float32: {ms:.3f} ms/step, {n / (ms * 1e-3):.6e} cell-updates/s "
           f"(setup + warm-up {setup_s:.1f} s); T finite {finite}, Qdot_total {qdot:.6e} W, "
           f"T max {T_max:.3f} K (initially {T0_max:.3f} K); non-finite log entries "
           f"{bad_logs}; ray intensities finite {rays_finite}")
    say(4, f"launches K1 {launches['bicgstab']} (expected {exp_k1}), "
           f"K2 {launches['pcg']} (expected {exp_k2})")
    say(4, f"p_rgh iterations per step {p_its}")
    say(4, f"U iterations per step {u_its}")
    if not finite or not qdot > 0.0 or bad_logs or not rays_finite:
        raise SystemExit("phase 4: fields not finite or no heat release")
    if not T_max > T0_max + 1.0:
        raise SystemExit("phase 4: the fire released heat but the gas did not heat up")
    if launches["bicgstab"] != exp_k1 or launches["pcg"] != exp_k2:
        raise SystemExit("phase 4: kernel launch counts do not match the solves")
    return solver, state, ms


# ---------------------------------------------------------------- phase 7
def norm_residual(m, x, x0):
    """OpenFOAM's normalised residual Σ|b − A·x| / normFactor(x0) of a p_rgh
    system, as every solver of the family computes it."""
    diag, b = m.totals()
    mv = linear.ldu_matvec(m.geom, diag, m.upper, m.lower)
    _, norm = linear._norm_factor(mv, x0, b)
    return float(torch.sum(torch.abs(b - mv(x))) / norm)


def capture(obj, attr, call):
    """The argument tuples `obj.attr` receives while `call()` runs."""
    got, orig = [], getattr(obj, attr)

    def shim(*a, **k):
        got.append(a)
        return orig(*a, **k)

    setattr(obj, attr, shim)
    try:
        call()
    finally:
        setattr(obj, attr, orig)
    return got


def launches_and_reads(fn):
    """(CUDA kernels launched, host reads of a device scalar) of one call,
    from torch.profiler; None for the kernels if it saw no device event."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    kernels = sum(e.count for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.lower().startswith("memcpy") and not e.key.lower().startswith("memset"))
    reads = sum(e.count for e in avgs if e.key == "aten::_local_scalar_dense")
    return (kernels or None), reads


def p_rgh_solver_times(phase, solvers, state, what):
    """One p_rgh system (the last corrector of a step of the first solver
    from `state`) through each solver's own p_rgh solve: ms, iterations,
    kernel launches and host reads per solve, and x's distance from the
    converged solution (CG in float64 to 1e-12: K2 on DIA, the twin on
    SEG); every x's normalised
    residual must be within the tolerance the solve stopped at. Returns
    {name: (ms, iterations)}."""
    first = next(iter(solvers.values()))
    m, x0, final = capture(first, "_solve_p_rgh", lambda: first.step(state))[-1]
    c = firefoam_mod._solver_controls(first.fv_solution, "p_rghFinal", "p_rgh")
    f8 = torch.float64
    diag, b = m.totals()
    exact = linear.solve_ldu(m.geom, "PCG", diag.to(f8), m.upper.to(f8), m.lower.to(f8),
                             b.to(f8), x0.to(f8), tol=1e-12, max_iter=20000).x
    moved = float((exact - x0.to(f8)).abs().max())  # how far the solve has to move x0
    out = {}
    for name, solver in solvers.items():
        solve = lambda: solver._solve_p_rgh(m, x0, final)
        res = solve()
        torch.cuda.synchronize()
        it, res0 = int(res.n_iterations), float(res.initial_residual)
        true_res = norm_residual(m, res.x, x0)
        err = float((res.x.to(f8) - exact).abs().max()) / moved
        limit = max(linear.tol_floor(c["tolerance"], x0.dtype), c["relTol"] * res0)
        ms = time_ms(solve, reps=5)
        kernels, reads = launches_and_reads(solve)
        out[name] = (ms, it)
        say(phase, f"{what} p_rgh system, {name}: {ms:.3f} ms per solve, {it} iterations, "
                   f"{kernels if kernels is not None else 'not measured'} kernel launches and "
                   f"{reads} host reads per solve; residual {res0:.3e} -> {true_res:.3e} "
                   f"(stops at {limit:.3e}); max |x - converged x| {err:.3e} of max "
                   f"|converged x - x0|")
        # recomputed from x in this dtype: twice the stopping value at most
        if not (np.isfinite(true_res) and true_res <= 2.0 * limit and it > 0):
            raise SystemExit(f"phase {phase}: {name} left a residual beyond its tolerance")
    return out


def gmg_pair(dev, case, k2, state, what, burning=False):
    """GMG_STEPS steps from `state` with K2 on p_rgh (solver `k2`) and with
    the lattice multigrid (a new solver, built and initialised inside the
    launch count); returns the multigrid solver and the pair's numbers.
    `burning`: the state holds a flame (T to GMG_T_DRIFT relative, and the
    float64-p_rgh yardstick run)."""
    n = k2.geom.n_cells
    count0 = int(state["rad"]["count"]) if "rad" in state else 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_k2, logs_k2 = k2.make_chunk(GMG_STEPS)(state)
    torch.cuda.synchronize()
    ms_k2 = 1e3 * (time.perf_counter() - t0) / GMG_STEPS

    dia_krylov.reset_counts()
    mg = FireFoamSolver(case, device=dev, gmg=True)
    if mg.gmg is None or mg._ldu is not None or mg.amg is not None:
        raise SystemExit("phase 7: gmg=True did not put the lattice multigrid on p_rgh")
    mg.initial_state()  # the hydrostatic init's solves are K2's
    init_k2 = dia_krylov.LAUNCHES["pcg"]
    chunk = mg.make_chunk(GMG_STEPS)
    st_mg, logs_mg = chunk(state)
    torch.cuda.synchronize()
    launches = dict(dia_krylov.LAUNCHES)
    # the same steps again: timed (the first run's solves allocate), and
    # held against the first run bit for bit
    t0 = time.perf_counter()
    repeat = chunk(state)[0]
    torch.cuda.synchronize()
    ms_mg = 1e3 * (time.perf_counter() - t0) / GMG_STEPS
    exp_k1, _ = expected_launches(mg.radiation, count0, GMG_STEPS)

    its = lambda logs: [[int(a), int(b)] for a, b in
                        zip(logs["p_rgh_iters_0"], logs["p_rgh_iters_1"])]
    bad = [k for k, v in logs_mg.items() if not bool(torch.isfinite(torch.as_tensor(v)).all())]
    dT = float((st_mg["T"].i - st_k2["T"].i).abs().max())
    dT_rel = float(((st_mg["T"].i - st_k2["T"].i).abs() / st_k2["T"].i).max())
    dU = float((st_mg["U"].i - st_k2["U"].i).abs().max())
    T_max = float(st_mg["T"].i.max())
    same = all(torch.equal(repeat[f].i, st_mg[f].i) for f in ("T", "U", "p_rgh", "Y", "k"))
    say(7, f"{what} ({n} cells float32), {GMG_STEPS} steps from the same state: K2 "
           f"{ms_k2:.3f} ms/step, multigrid {ms_mg:.3f} ms/step; multigrid vs K2 max |dT| "
           f"{dT:.3e} K ({dT_rel:.3e} relative), max |dU| {dU:.3e} m/s; T max {T_max:.3f} K; "
           f"non-finite log entries {bad}; two multigrid runs bitwise equal: {same}")
    if burning:
        p64 = FireFoamSolver(case, device=dev, gmg=False, p_rgh_f64=True)
        st_64, _ = p64.make_chunk(GMG_STEPS)(state)
        say(7, f"{what} yardstick, K2 with p_rgh solved in float64 vs K2: max |dT| "
               f"{float((st_64['T'].i - st_k2['T'].i).abs().max()):.3e} K, max |dU| "
               f"{float((st_64['U'].i - st_k2['U'].i).abs().max()):.3e} m/s")
    say(7, f"{what} p_rgh iterations per corrector: K2 {its(logs_k2)}, multigrid {its(logs_mg)}")
    say(7, f"{what} launches with the multigrid on p_rgh: K2 {launches['pcg']} (the hydrostatic "
           f"init's {init_k2}), K1 {launches['bicgstab']} (expected {exp_k1}), K3 "
           f"{launches['smooth']}")
    if bad or not bool(torch.isfinite(st_mg["T"].i).all() and torch.isfinite(st_mg["U"].i).all()):
        raise SystemExit("phase 7: the multigrid run is not finite")
    if not (dU <= GMG_TOL and (dT_rel <= GMG_T_DRIFT if burning else dT <= GMG_TOL)):
        raise SystemExit("phase 7: the multigrid run leaves the K2 run beyond the bound")
    if not same:
        raise SystemExit("phase 7: two multigrid runs differ")
    if launches["pcg"] != init_k2 or init_k2 < 1 or launches["bicgstab"] != exp_k1:
        raise SystemExit("phase 7: kernel launch counts do not match the solves")
    return mg, st_k2, T_max, launches


def phase_gmg(dev, tmp, main_case, main_solver, main_state, small_case):
    """The lattice multigrid beside K2 (see the module docstring); returns the
    main path's launch counts with the multigrid on and the solve times
    {cells: {solver: (ms, iterations)}}."""
    times = {}
    T0_max = float(main_state["T"].i.max())
    gmg_pair(dev, main_case, main_solver, main_solver.initial_state(), "box fire from t = 0")
    mg, _, T_max, launches = gmg_pair(dev, main_case, main_solver, main_state,
                                      "box fire, burning", burning=True)
    if not T_max > T0_max:
        raise SystemExit("phase 7: the gas stopped heating with the multigrid on")
    times[main_solver.geom.n_cells] = p_rgh_solver_times(
        7, {"K2": main_solver, "gmg_pcg": mg}, main_state, "100k-cell")
    del mg

    t0 = time.perf_counter()
    large_case = write_box_fire_case(os.path.join(tmp, "large"), n=N_LARGE)
    k2 = FireFoamSolver(large_case, device=dev, gmg=False)
    state = k2.initial_state()
    state, _ = k2.step(state)
    torch.cuda.synchronize()
    say(7, f"500k cells: case, mesh, solver, initial state and one step in "
           f"{time.perf_counter() - t0:.1f} s")
    mg, state, _, _ = gmg_pair(dev, large_case, k2, state, "500k box fire")
    times[k2.geom.n_cells] = p_rgh_solver_times(7, {"K2": k2, "gmg_pcg": mg}, state, "500k-cell")
    del mg, k2, state

    k2 = FireFoamSolver(small_case, device=dev, gmg=False)
    state, _ = k2.make_chunk(DRIFT_STEPS)(k2.initial_state())
    solvers = {"K2": k2, "gmg_pcg": FireFoamSolver(small_case, device=dev, gmg=True),
               "amg_pcg": FireFoamSolver(small_case, device=dev, amg=True)}
    if solvers["amg_pcg"].amg is None or solvers["amg_pcg"].gmg is not None:
        raise SystemExit("phase 7: amg=True did not put AMG on p_rgh")
    times[k2.geom.n_cells] = p_rgh_solver_times(7, solvers, state, "9k-cell")
    faster = sorted(n for n, t in times.items() if t["gmg_pcg"][0] < t["K2"][0])
    say(7, "ms per p_rgh solve, K2 / gmg_pcg: " + "; ".join(
        f"{n} cells {t['K2'][0]:.3f} / {t['gmg_pcg'][0]:.3f}" for n, t in sorted(times.items()))
        + f"; the multigrid is faster at {faster if faster else 'no measured size'} "
          f"(the card's automatic threshold: {firefoam_mod.GMG_MIN_CELLS['cuda']})")
    return launches, times


# ---------------------------------------------------------------- phase 9
def step_profile(step, state, n_steps):
    """(state, kernel launches, host reads of a device scalar, device-busy
    ms) per step over n_steps steps, from torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n_steps):
            state, _ = step(state)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    kernels = sum(e.count for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.lower().startswith(("memcpy", "memset")))
    reads = sum(e.count for e in avgs if e.key == "aten::_local_scalar_dense")
    return state, kernels / n_steps, reads / n_steps, _busy_us(prof) / 1e3 / n_steps


_BOX_PROFILE = []


def box_profile(box_solver, box_state):
    """(kernel launches, host reads, device-busy ms) per step of phase 4's
    box fire over PROFILE_STEPS steps from its state (steps 22-24: no ray
    solve), profiled once and printed beside each later phase's fire."""
    if not _BOX_PROFILE:
        _BOX_PROFILE.extend(step_profile(box_solver.make_step(), box_state, PROFILE_STEPS)[1:])
    return tuple(_BOX_PROFILE)


def phase_wall(dev, tmp, box_solver, box_state, box_ms):
    """The gas-phase variants on the 100k-cell wall-fire case (see the
    module docstring); returns its launch counts."""
    case = write_wall_fire_case(os.path.join(tmp, "wall"), n=N_MAIN)
    t0 = time.perf_counter()
    solver = FireFoamSolver(case, device=dev)
    if not (solver.lap_limiter == 0.5 and solver.u_div_scheme[0] == "filteredLinear2"
            and solver.turb.model == "WALE"
            and solver.combustion.variant == "eddyDissipationBertExtModel"):
        raise SystemExit("phase 9: the wall-fire case did not select its variants")
    state0 = solver.initial_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    T0_max = float(state0["T"].i.max())
    rows, launch = [], dia_krylov._launch

    def recording(name, diag, upper, lower, b, x0, *a, **k):
        rows.append((name, x0.shape[0] if x0.ndim == 2 else 1))
        return launch(name, diag, upper, lower, b, x0, *a, **k)

    chunk = solver.make_chunk(CHUNK)
    dia_krylov._launch = recording
    try:
        dia_krylov.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, logs = chunk(state0)
        torch.cuda.synchronize()
        dt_s = time.perf_counter() - t0
        launches = dict(dia_krylov.LAUNCHES)
    finally:
        dia_krylov._launch = launch
    exp_k1, exp_k2 = expected_launches(solver.radiation, 0, CHUNK)
    b5 = sum(1 for name, B in rows if name == "bicgstab" and B == 5)
    ms = 1e3 * dt_s / CHUNK
    n = solver.geom.n_cells
    fields = ("T", "U", "p_rgh", "Y", "k", "nut", "alphat")
    finite = all(bool(torch.isfinite(state[f].i).all() and torch.isfinite(state[f].b).all())
                 for f in fields)
    bad_logs = [k for k, v in logs.items() if not bool(torch.isfinite(torch.as_tensor(v)).all())]
    rays_finite = bool(torch.isfinite(state["rad"]["I"]).all()) if "rad" in state else True
    T_max = float(state["T"].i.max())
    wall = solver.geom.patch("wall").slice
    fstar = float(state["Y"].i[:, solver.combustion.fstar_index].max())
    say(9, f"wall fire {n} cells float32: {ms:.3f} ms/step (setup {setup_s:.1f} s), T max "
           f"{T_max:.3f} K (initially {T0_max:.3f} K) at t = {float(state['t']):.4f} s, "
           f"Qdot_total {float(logs['Qdot_total'][-1]):.6e} W, Fstar max {fstar:.3e}, wall "
           f"alphat max {float(state['alphat'].b[wall].max()):.3e}; fields finite {finite}, "
           f"non-finite log entries {bad_logs}, ray intensities finite {rays_finite}")
    say(9, f"launches K1 {launches['bicgstab']} (expected {exp_k1}, {b5} of them on the 5 "
           f"species rows), K2 {launches['pcg']} (expected {exp_k2}), K3 {launches['smooth']}")
    if not finite or bad_logs or not rays_finite:
        raise SystemExit("phase 9: the wall fire is not finite")
    if not T0_max + 1.0 < T_max < T_FLAME_MAX:
        raise SystemExit("phase 9: the wall fire did not heat the gas, or ran away")
    if (launches["bicgstab"], launches["pcg"], launches["smooth"], b5) != (exp_k1, exp_k2, 0, CHUNK):
        raise SystemExit("phase 9: kernel launch counts do not match the solves")
    again, logs2 = chunk(state0)
    torch.cuda.synchronize()
    same = all(torch.equal(again[f].i, state[f].i) and torch.equal(again[f].b, state[f].b)
               for f in fields) and all(torch.equal(logs2[k], logs[k]) for k in logs)
    say(9, f"the same {CHUNK} steps again: states and logs bitwise equal: {same}")
    if not same:
        raise SystemExit("phase 9: two runs of the wall fire differ")
    _, k_wall, _, busy_wall = step_profile(solver.make_step(), state, PROFILE_STEPS)
    k_box, _, busy_box = box_profile(box_solver, box_state)
    say(9, f"per step at {n} cells float32: box fire {box_ms:.3f} ms (phase 4), "
           f"{k_box:.0f} kernel launches, device busy {busy_box:.3f} ms; wall fire {ms:.3f} ms, "
           f"{k_wall:.0f} kernel launches, device busy {busy_wall:.3f} ms (torch.profiler over "
           f"{PROFILE_STEPS} steps)")
    return launches


def phase_wall_baffle(dev, tmp):
    """The 9k-cell wall fire with the ceiling baffle: float64 on the card
    against the CPU's, float32 against float64."""
    small = write_wall_fire_case(os.path.join(tmp, "wall_baffle"), n=N_SMALL, baffle=True)
    out, ms_run = {}, {}
    for run, d, dtype in (("f32", dev, torch.float32), ("f64", dev, torch.float64),
                          ("cpu", torch.device("cpu"), torch.float64)):
        # the kernels' float64 instantiations against their twins (phase 5)
        s = FireFoamSolver(small, device=d, dtype=dtype, exact_solvers=False, gmg=False,
                           amg=False)
        if "baffle_master" not in [p.name for p in s.geom.patches]:
            raise SystemExit("phase 9: the baffle was not made")
        st = s.initial_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _ = s.make_chunk(DRIFT_STEPS)(st)
        torch.cuda.synchronize()
        ms_run[run] = 1e3 * (time.perf_counter() - t0) / DRIFT_STEPS
        out[run] = {f: torch.cat([st[f].i.reshape(-1), st[f].b.reshape(-1)]).double().cpu().numpy()
                    for f in ("T", "U")}
    T32, T64 = out["f32"]["T"], out["f64"]["T"]
    drift = float(np.max(np.abs(T32 - T64) / np.maximum(T64, 1.0)))
    vs_cpu = {f: float(np.max(np.abs(out["f64"][f] - out["cpu"][f])) /
                       np.max(np.abs(out["cpu"][f]))) for f in ("T", "U")}
    say(9, f"baffled wall fire {int(np.prod(N_SMALL))} cells, {DRIFT_STEPS} steps (cells and "
           f"faces): float32 {ms_run['f32']:.3f} ms/step, float64 {ms_run['f64']:.3f} ms/step, "
           f"CPU float64 {ms_run['cpu']:.1f} ms/step; max relative T drift float32 vs float64 "
           f"{drift:.6e}; float64 card vs CPU: T {vs_cpu['T']:.3e}, U {vs_cpu['U']:.3e}")
    if not np.all(np.isfinite(T32)) or not drift <= T_DRIFT:
        raise SystemExit("phase 9: float32 drifts from float64 beyond the band")
    if not max(vs_cpu.values()) <= CPU_TOL:
        raise SystemExit(f"phase 9: the card's float64 run differs from the CPU's beyond {CPU_TOL}")


# ---------------------------------------------------------------- phase 10
def rad_launches(rad) -> int:
    """K1 launches the radiation model made since it was built: fvDOM's ray
    sweeps, P1's G solves."""
    return getattr(rad, "sweeps", getattr(rad, "solves", 0))


def radiation_leaves(state):
    return [v for v in state["rad"].values() if torch.is_tensor(v)]


def radiation_run(dev, case, what):
    """make_chunk(CHUNK) from t = 0 at 100k cells in float32 with the
    launch counters and the K1 row counts recorded; the same steps again,
    bitwise equal. Returns (solver, state, launches, ms/step)."""
    t0 = time.perf_counter()
    solver = FireFoamSolver(case, device=dev)
    rad = solver.radiation
    state0 = solver.initial_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    T0_max = float(state0["T"].i.max())
    rows, launch = [], dia_krylov._launch

    def recording(name, diag, upper, lower, b, x0, *a, **k):
        rows.append((name, x0.shape[0] if x0.ndim == 2 else 1))
        return launch(name, diag, upper, lower, b, x0, *a, **k)

    chunk = solver.make_chunk(CHUNK)
    before = rad_launches(rad)
    dia_krylov._launch = recording
    try:
        dia_krylov.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, logs = chunk(state0)
        torch.cuda.synchronize()
        dt_s = time.perf_counter() - t0
        launches = dict(dia_krylov.LAUNCHES)
    finally:
        dia_krylov._launch = launch
    n_rad = rad_launches(rad) - before
    opportunities = expected_launches(rad, 0, CHUNK)[0] - 4 * CHUNK
    batch = rad.n_rays * rad.n_lambda if hasattr(rad, "n_lambda") else 1
    on_batch = sum(1 for name, B in rows if name == "bicgstab" and B == batch)
    ms = 1e3 * dt_s / CHUNK
    fields = ("T", "U", "p_rgh", "Y", "k")
    finite = all(bool(torch.isfinite(state[f].i).all() and torch.isfinite(state[f].b).all())
                 for f in fields) and all(bool(torch.isfinite(v).all())
                                          for v in radiation_leaves(state))
    bad_logs = [k for k, v in logs.items() if not bool(torch.isfinite(torch.as_tensor(v)).all())]
    T_max = float(state["T"].i.max())
    soot = float(solver.soot.soot(state["Y"].i).max()) if solver.soot is not None else None
    say(10, f"{what}, {solver.geom.n_cells} cells float32: {ms:.3f} ms/step (setup "
            f"{setup_s:.1f} s), T max {T_max:.3f} K (initially {T0_max:.3f} K) at t = "
            f"{float(state['t']):.4f} s, Qdot_total {float(logs['Qdot_total'][-1]):.6e} W, "
            f"G max {float(state['rad']['G'].max()):.6e} W/m2, soot max {soot:.3e}; fields "
            f"finite {finite}, non-finite log entries {bad_logs}")
    if rad.last_iters is not None:
        its = rad.last_iters.cpu()
        say(10, f"{what}: {n_rad} radiation launches; the last one's rows took "
                f"{int(its.min())}..{int(its.max())} iterations (mean {float(its.float().mean()):.1f})")
    say(10, f"{what}: launches K1 {launches['bicgstab']} (expected {4 * CHUNK} + {n_rad} "
            f"radiation launches in {opportunities} radiation steps, {on_batch} of them with "
            f"{batch} rows), K2 {launches['pcg']} (expected {2 * CHUNK}), K3 "
            f"{launches['smooth']}")
    if not finite or bad_logs:
        raise SystemExit(f"phase 10: the {what} run is not finite")
    if not T0_max + 1.0 < T_max < T_FLAME_MAX:
        raise SystemExit(f"phase 10: the {what} run did not heat the gas, or ran away")
    max_sweeps = getattr(rad, "max_iter", 1)
    # fvDOM's ray batches are the only K1 launches of nR·nL > 4 rows; P1's
    # G solve has one row, as h and k do
    counts = (launches["bicgstab"], launches["pcg"], launches["smooth"])
    if not (opportunities <= n_rad <= max_sweeps * opportunities
            and (batch == 1 or on_batch == n_rad) and counts == (4 * CHUNK + n_rad, 2 * CHUNK, 0)):
        raise SystemExit(f"phase 10: the {what} run's kernel launch counts do not match its solves")
    again, logs2 = chunk(state0)
    torch.cuda.synchronize()
    same = (all(torch.equal(again[f].i, state[f].i) and torch.equal(again[f].b, state[f].b)
                for f in fields)
            and all(torch.equal(a, b) for a, b in zip(radiation_leaves(again),
                                                      radiation_leaves(state)))
            and all(torch.equal(logs2[k], logs[k]) for k in logs))
    say(10, f"{what}: the same {CHUNK} steps again, states and logs bitwise equal: {same}")
    if not same:
        raise SystemExit(f"phase 10: two runs of the {what} case differ")
    return solver, state, launches, ms


def profiled(step, state, n_steps):
    """(state, kernel launches, device-busy ms, K1 device ms, K1 launches),
    each per step, over n_steps steps (torch.profiler)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n_steps):
            state, _ = step(state)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.lower().startswith(("memcpy", "memset")))
    k1 = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and "bicgstab" in e.name]
    k1_us = sum(e.time_range.end - e.time_range.start for e in k1)
    return (state, kernels / n_steps, _busy_us(prof) / 1e3 / n_steps,
            k1_us / 1e3 / n_steps, len(k1) / n_steps)


def small_radiation_runs(dev, tmp, models):
    """10 steps of each model at 9k cells: float64 on the card against the
    CPU's float64, float32 against float64."""
    for model, kw in models:
        # a solve on steps 1 and 6: the second one sees the burning gas, and
        # its absorption feeds back into the steps after it
        case = write_radiation_fire_case(os.path.join(tmp, f"rad9k_{model}"), n=N_SMALL,
                                         model=model, solver_freq=5, **kw)
        out, ms_run, sweeps, its = {}, {}, {}, {}
        for run, d, dtype in (("f32", dev, torch.float32), ("f64", dev, torch.float64),
                              ("cpu", torch.device("cpu"), torch.float64)):
            s = FireFoamSolver(case, device=d, dtype=dtype, exact_solvers=False, gmg=False,
                               amg=False)
            st = s.initial_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _ = s.make_chunk(DRIFT_STEPS)(st)
            torch.cuda.synchronize()
            ms_run[run] = 1e3 * (time.perf_counter() - t0) / DRIFT_STEPS
            sweeps[run] = rad_launches(s.radiation)
            its[run] = s.radiation.last_iters.cpu()
            out[run] = {f: torch.cat([st[f].i.reshape(-1), st[f].b.reshape(-1)]).double().cpu().numpy()
                        for f in ("T", "U")}
            out[run]["G"] = st["rad"]["G"].double().cpu().numpy()
            if run == "cpu" and model == "greyMean":
                ft_table_on_card(dev, case, st)
        T32, T64 = out["f32"]["T"], out["f64"]["T"]
        drift = float(np.max(np.abs(T32 - T64) / np.maximum(T64, 1.0)))
        vs_cpu = {f: float(np.max(np.abs(out["f64"][f] - out["cpu"][f])) /
                           np.max(np.abs(out["cpu"][f]))) for f in ("T", "U", "G")}
        g32 = float(np.max(np.abs(out["f32"]["G"] - out["f64"]["G"])) / np.max(np.abs(out["f64"]["G"])))
        other = int((its["f64"] != its["cpu"]).sum())
        say(10, f"{model} {int(np.prod(N_SMALL))} cells, {DRIFT_STEPS} steps: float32 "
                f"{ms_run['f32']:.3f} ms/step, float64 {ms_run['f64']:.3f} ms/step, CPU float64 "
                f"{ms_run['cpu']:.1f} ms/step; radiation launches {sweeps}; max relative T drift "
                f"float32 vs float64 {drift:.6e}; float64 card vs CPU: T {vs_cpu['T']:.3e}, "
                f"U {vs_cpu['U']:.3e}, G {vs_cpu['G']:.3e}; the last radiation launch's rows "
                f"with other iteration counts on the card: {other} of {its['cpu'].numel()}; "
                f"G float32 vs float64 {g32:.3e}")
        tight = radiation_solve_vs_cpu(dev, case, model)
        if not np.all(np.isfinite(T32)) or not drift <= T_DRIFT:
            raise SystemExit(f"phase 10: {model} float32 drifts from float64 beyond the band")
        if not (max(vs_cpu["T"], vs_cpu["U"]) <= CPU_TOL and vs_cpu["G"] <= G_TOL
                and sweeps["f64"] == sweeps["cpu"] and tight <= CPU_TOL):
            raise SystemExit(f"phase 10: {model} on the card in float64 differs from the CPU's")


def radiation_solve_vs_cpu(dev, case, model):
    """One radiation solve from the CPU's float64 state after 5 steps (the
    solve that first sees the flame), on the card and on the CPU in float64
    with the solve's tolerance at RAD_TIGHT_TOL: max |ΔG| / max |G|."""
    G, its, host = {}, {}, None
    for run, d in (("cpu", torch.device("cpu")), ("f64", dev)):
        s = FireFoamSolver(case, device=d, dtype=torch.float64, exact_solvers=False, gmg=False,
                           amg=False)
        if host is None:
            st, _ = s.make_chunk(5)(s.initial_state())
            host = firefoam_mod.state_to_numpy(st)
        st = firefoam_mod.state_from_numpy(host, device=d, dtype=torch.float64)
        s.radiation.tol = RAD_TIGHT_TOL
        before = rad_launches(s.radiation)
        G[run] = s.radiation.maybe_correct(st, s.gas)["G"].cpu().numpy()
        if rad_launches(s.radiation) == before:
            raise SystemExit(f"phase 10: {model}'s radiation did not solve after 5 steps")
        its[run] = int(s.radiation.last_iters.max())
    rel = float(np.max(np.abs(G["f64"] - G["cpu"])) / np.max(np.abs(G["cpu"])))
    say(10, f"{model}: one radiation solve from the CPU's float64 state after 5 steps at "
            f"tolerance {RAD_TIGHT_TOL:.0e} (up to {its['f64']} iterations on the card, "
            f"{its['cpu']} on the CPU): G card vs CPU {rel:.3e}")
    return rel


def ft_table_on_card(dev, case, state):
    """The grey-mean absorption (its ft-table interpolation included) on the
    card in float32 and float64 from the same state, against float64."""
    a = {}
    for dtype in (torch.float32, torch.float64):
        s = FireFoamSolver(case, device=dev, dtype=dtype, exact_solvers=False, gmg=False,
                           amg=False)
        st = firefoam_mod.state_from_numpy(firefoam_mod.state_to_numpy(state), device=dev,
                                           dtype=dtype)
        a[dtype] = torch.cat(s.radiation.absorption(st, s.gas)).double().cpu().numpy()
    if not np.max(a[torch.float64]) > 0.0:
        raise SystemExit("phase 10: the grey-mean state holds no absorbing gas")
    rel = float(np.max(np.abs(a[torch.float32] - a[torch.float64])) /
                np.max(np.abs(a[torch.float64])))
    say(10, f"grey-mean absorption with the ft table on the card, float32 vs float64 from the "
            f"same state: max {rel:.3e} of max a {np.max(a[torch.float64]):.4e} 1/m")
    if not rel <= FT_TABLE_TOL:
        raise SystemExit("phase 10: the ft-table absorption in float32 leaves float64's")


def view_factor_runs(dev, tmp):
    """viewFactor and opaqueSolid at 9k cells (see the module docstring)."""
    case = write_radiation_fire_case(os.path.join(tmp, "rad9k_vf"), n=N_SMALL,
                                     model="viewFactor", solver_freq=1)
    qr = {}
    for run, d, dtype in (("f32", dev, torch.float32), ("f64", dev, torch.float64),
                          ("cpu", torch.device("cpu"), torch.float64)):
        t0 = time.perf_counter()
        s = FireFoamSolver(case, device=d, dtype=dtype, exact_solvers=False, gmg=False, amg=False)
        build_s = time.perf_counter() - t0
        vf = s.radiation
        st = s.initial_state()
        # the isothermal enclosure: every wall at 600 K
        q_iso, _ = vf._solve(torch.full_like(st["T"].b, 600.0))
        iso_rel = float(q_iso.abs().max()) / (5.670367e-8 * 600.0**4)
        # walls from 300 K at the base to 1200 K at the top: qr of the
        # order of sigma T^4
        z = vf.geom.b_Cf[:, 2]
        T_wall = 300.0 + 900.0 * (z - z.min()) / (z.max() - z.min())
        qr[run] = vf._solve(T_wall)[0].double().cpu().numpy()
        st, _ = s.make_chunk(DRIFT_STEPS)(st)
        torch.cuda.synchronize()
        q10 = vf.qr_boundary(st["rad"])
        say(10, f"viewFactor {run}: {len(vf.sel)} wall faces, F built in {build_s:.1f} s (with "
                f"the solver); isothermal enclosure max |qr| / sigma T^4 {iso_rel:.3e}; walls "
                f"300-1200 K qr in [{qr[run].min():.4e}, {qr[run].max():.4e}] W/m2; after "
                f"{DRIFT_STEPS} steps of the fire qr in [{float(q10.min()):.4e}, "
                f"{float(q10.max()):.4e}] W/m2")
        if not iso_rel <= QR_ISO_TOL:
            raise SystemExit("phase 10: the isothermal enclosure exchanges net radiation")
        if not bool(torch.isfinite(q10).all() and torch.isfinite(st["T"].i).all()):
            raise SystemExit("phase 10: the viewFactor fire is not finite")
    scale = float(np.max(np.abs(qr["cpu"])))
    vs_cpu = {run: float(np.max(np.abs(qr[run] - qr["cpu"]))) / scale for run in ("f64", "f32")}
    say(10, f"viewFactor qr, walls 300-1200 K, card vs CPU float64: float64 {vs_cpu['f64']:.3e}, "
            f"float32 {vs_cpu['f32']:.3e} of the CPU's largest |qr| ({scale:.4e} W/m2)")
    if not vs_cpu["f64"] <= CPU_TOL:
        raise SystemExit("phase 10: the viewFactor qr on the card differs from the CPU's")
    rp = os.path.join(case, "constant", "radiationProperties")
    with open(rp) as f:
        txt = f.read()
    with open(rp, "w") as f:
        f.write(txt.replace("radiationModel viewFactor;", "radiationModel opaqueSolid;"))
    s = FireFoamSolver(case, device=dev)
    st, logs = s.make_chunk(3)(s.initial_state())
    zero = float(s.radiation.qr_boundary(st["rad"]).abs().max())
    say(10, f"opaqueSolid ({type(s.radiation).__name__}) 3 steps: T max "
            f"{float(st['T'].i.max()):.3f} K, max |qr| {zero:.1e}")
    if type(s.radiation).__name__ != "OpaqueSolid" or zero != 0.0 or not bool(
            torch.isfinite(st["T"].i).all()):
        raise SystemExit("phase 10: opaqueSolid did not run as a transparent, inert model")


def radiation_solve(solver, step, state, sync_s, what):
    """The K1 launch of the radiation step from `state` (fvDOM's last ray
    sweep; P1's G solve) captured and run again alone: kernel and plain
    version on the same operands (ms, iterations, max relative difference
    of x), and its bounds from this run's operands and iteration counts."""
    got, orig = [], dia_krylov.dia_bicgstab

    def shim(*a, **k):
        got.append((a, k))
        return orig(*a, **k)

    dia_krylov.dia_bicgstab = shim
    try:
        step(state)
    finally:
        dia_krylov.dia_bicgstab = orig
    rad = solver.radiation
    rows = rad.n_rays * rad.n_lambda if hasattr(rad, "n_lambda") else 1
    a, k = [(a, k) for a, k in got if k.get("max_iter") in (500, 1000)
            and (a[4].shape[0] if a[4].ndim == 2 else 1) == rows][-1]
    ops, x0 = a[:5], a[4]
    run_k = lambda: orig(*a, **k)
    run_p = lambda: dia_krylov.plain(linear.bicgstab, *a, **k)
    rk, rp = run_k(), run_p()
    torch.cuda.synchronize()
    its = rk.n_iterations.reshape(-1).cpu().numpy()
    its_p = rp.n_iterations.reshape(-1).cpu().numpy()
    rel = float(((rk.x - rp.x).abs().max() / rp.x.abs().max()))
    res_k, res_p = (true_residual(*ops, a[5], x) for x in (rk.x, rp.x))
    worst = float(torch.max(res_k / torch.clamp(res_p, min=k["tol"])))
    plan, _ = dia_krylov._grid_launch_plan("bicgstab", x0.dtype, rows, x0.shape[-1],
                                           len(a[5]), x0.element_size())
    out = {"ms": time_ms(run_k, reps=3), "plain_ms": time_ms(run_p, reps=1),
           "iterations": int(its.max()), "rows": rows,
           "bound_ms": bound("bicgstab", x0.dtype, ops, its)[0],
           "streamed_ms": streamed_ms("bicgstab", x0.dtype, x0.shape[-1], its),
           "latency_ms": latency_ms("bicgstab", its, sync_s) if plan.grid_wide else None,
           "blocks": rows * plan.blocks_per_row if plan.grid_wide else rows}
    say(10, f"{what}: its radiation solve ({rows} rows, captured in the step) alone: kernel "
            f"{out['ms']:.3f} ms, {int(its.min())}..{int(its.max())} iterations; plain "
            f"{out['plain_ms']:.3f} ms, {int(its_p.min())}..{int(its_p.max())} iterations; max rel "
            f"difference of x {rel:.3e}; {out['blocks']} blocks; bound {out['bound_ms']:.4f} ms, "
            f"streamed {out['streamed_ms']:.4f} ms, grid barriers alone "
            f"{'n/a' if out['latency_ms'] is None else format(out['latency_ms'], '.4f')} ms")
    say(10, f"{what}: true normalised residuals (float64) kernel {float(res_k.max()):.3e}, "
            f"plain {float(res_p.max()):.3e} at tolerance {k['tol']:.0e}; the kernel's "
            f"largest row against max(plain, tolerance): {worst:.3f}")
    if not bool(torch.isfinite(rk.x).all()):
        raise SystemExit(f"phase 10: the {what} radiation solve is not finite alone")
    if not (rel <= RAD_X_TOL and worst <= RAD_RES_FACTOR):
        raise SystemExit(f"phase 10: K1 disagrees with its plain version on the {what} "
                         "radiation solve")
    return out


def true_residual(diag, upper, lower, b, x0, offsets, x):
    """Σ|b − A·x| / normFactor(x0) of each row, in float64: OpenFOAM's
    normalised residual, recomputed from the operands."""
    d, u, lo, bb, xx0, xx = (v.double() for v in (diag, upper, lower, b, x0, x))
    mv = lambda v: dia_krylov.dia_matvec(d, u, lo, offsets, v)
    _, norm = linear._norm_factor(mv, xx0, bb)
    return torch.sum(torch.abs(bb - mv(xx)), dim=-1) / norm


def phase_radiation(dev, tmp, box_solver, box_state, box_ms, sync_s):
    """The radiation family (see the module docstring); returns, per model,
    the 100k run's launch counts, the in-step K1 ms per radiation launch and
    the captured radiation solve's numbers."""
    runs = {}
    for what, model, kw in (("grey-mean fvDOM", "greyMean", {}),
                            ("banded fvDOM", "wsggBand", dict(n_theta=4, n_phi=2)),
                            ("P1", "P1", {})):
        case = write_radiation_fire_case(os.path.join(tmp, f"rad_{model}"), n=N_MAIN,
                                         model=model, **kw)
        solver, state, launches, ms = radiation_run(dev, case, what)
        step = solver.make_step()
        # the chunk ended at a radiation opportunity: the next step solves
        # the radiation, the two after it do not
        before = rad_launches(solver.radiation)
        st, k_rad, busy_rad, k1_ms, k1_n = profiled(step, state, 1)
        n_rad = rad_launches(solver.radiation) - before
        _, k_no, busy_no, k1_ms_no, k1_n_no = profiled(step, st, 2)
        runs[model] = {"launches": launches, "k1_step_ms": (k1_ms - k1_ms_no) / n_rad,
                       "solve": radiation_solve(solver, step, state, sync_s, what)}
        say(10, f"{what} per step at {solver.geom.n_cells} cells float32: the radiation step "
                f"{k_rad:.0f} kernel launches, device busy {busy_rad:.3f} ms (K1 {k1_ms:.3f} ms "
                f"over {k1_n:.0f} launches, {n_rad} of them the radiation's: "
                f"{runs[model]['k1_step_ms']:.3f} ms each); a step without radiation "
                f"{k_no:.0f} launches, {busy_no:.3f} ms (K1 {k1_ms_no:.3f} ms over "
                f"{k1_n_no:.0f}); the radiation adds {k_rad - k_no:.0f} launches and "
                f"{busy_rad - busy_no:.3f} ms of device work")
        del solver, state, st
    k_box, _, busy_box = box_profile(box_solver, box_state)
    say(10, f"box fire (phase 4) {box_ms:.3f} ms/step, {k_box:.0f} kernel launches and "
            f"{busy_box:.3f} ms device busy a step")
    small_radiation_runs(dev, tmp, (("greyMean", {}), ("wsggBand", dict(n_theta=4, n_phi=2)),
                                    ("P1", {})))
    view_factor_runs(dev, tmp)
    return runs



# ---------------------------------------------------------------- phase 8
def timed(obj, attr, totals):
    """Replace obj.attr by a version that adds (1 call, its seconds between
    two device synchronisations) to `totals` and leaves its last call there
    as a function to call again; returns the undo."""
    orig = getattr(obj, attr)

    def shim(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **k)
        torch.cuda.synchronize()
        totals[0] += 1
        totals[1] += time.perf_counter() - t0
        totals[2] = lambda: orig(*a, **k)
        return out

    setattr(obj, attr, shim)
    return lambda: setattr(obj, attr, orig)


def phase_exact(dev, tmp, box_case):
    """The OpenFOAM-exact solvers on the card against the CPU, float64."""
    smooth_case = write_smooth_fire_case(os.path.join(tmp, "small_smooth"), n=N_SMALL)
    fields = ("T", "U", "p_rgh")
    rel = lambda a, b: {f: float((a[f].i.cpu() - b[f].i.cpu()).abs().max() /
                                 b[f].i.abs().max()) for f in ("T", "U")}
    for what, case, keys, chain_tol in (
        ("box fire (DIC-PCG on p_rgh)", box_case, ("p_rgh_iters_0", "p_rgh_iters_1"), CPU_TOL),
        ("smoothSolver case (symGaussSeidel on Yi, h, k)", smooth_case,
         ("p_rgh_iters_1", "h_iters", "k_iters", "O2_iters"), SMOOTH_CHAIN_TOL),
    ):
        end, its, ms, solvers = {}, {}, {}, {}
        for run, d in (("cpu", torch.device("cpu")), ("card", dev), ("card again", dev)):
            dia_krylov.reset_counts()
            solver = FireFoamSolver(case, device=d, dtype=torch.float64, exact_solvers=True)
            if solver._ldu is None or solver.gmg is not None or solver.amg is not None:
                raise SystemExit("phase 8: exact_solvers=True did not build the schedule alone")
            state = solver.initial_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if run == "cpu":  # the last step apart: the card repeats it from the same state
                before, _ = solver.make_chunk(DRIFT_STEPS - 1)(state)
                state, last = solver.step(before)
                logs = None
            else:
                state, logs = solver.make_chunk(DRIFT_STEPS)(state)
            torch.cuda.synchronize()
            ms[run] = 1e3 * (time.perf_counter() - t0) / DRIFT_STEPS
            end[run], solvers[run] = state, solver
            if logs is not None:
                its[run] = {k: [int(v) for v in logs[k]] for k in keys}
            if run == "card":
                launches = dict(dia_krylov.LAUNCHES)
        # one step on the card from the CPU's state, every exact solve of it
        # timed between two device synchronisations
        t_dic, t_sgs = [0, 0.0, None], [0, 0.0, None]
        undo = [timed(firefoam_mod, "dic_pcg", t_dic), timed(dic, "dic_pcg", t_dic),
                timed(firefoam_mod, "sgs_solve", t_sgs), timed(dic, "sgs_solve", t_sgs)]
        try:
            stepped, log = solvers["card"].step(firefoam_mod.state_from_numpy(
                firefoam_mod.state_to_numpy(before), device=dev, dtype=torch.float64))
        finally:
            for u in undo:
                u()
        one, chain = rel(stepped, end["cpu"]), rel(end["card"], end["cpu"])
        same_its = all(int(log[k]) == int(last[k]) for k in log
                       if k.endswith("_iters") or "iters_" in k)
        same = all(torch.equal(end["card"][f].i, end["card again"][f].i) for f in fields)
        say(8, f"{what}, {end['cpu']['T'].i.numel()} cells float64, {DRIFT_STEPS} steps: card "
               f"{ms['card']:.1f} ms/step, CPU {ms['cpu']:.1f} ms/step; card vs CPU after the "
               f"chain: T {chain['T']:.3e}, U {chain['U']:.3e} relative; the last step from the "
               f"CPU's state: T {one['T']:.3e}, U {one['U']:.3e}, iteration counts equal "
               f"{same_its}; two card runs bitwise equal: {same}; other launches K1 "
               f"{launches['bicgstab']}, K2 {launches['pcg']}, K3 {launches['smooth']}")
        say(8, f"iterations per step on the card {its['card']}")
        def per(t):
            if not t[0]:
                return "none"
            kernels, reads = launches_and_reads(t[2])
            return (f"{1e3 * t[1] / t[0]:.3f} ms each over {t[0]}; the last of them "
                    f"{kernels if kernels is not None else 'not measured'} kernel launches and "
                    f"{reads} host reads")

        say(8, f"one step on the card: dic_pcg {per(t_dic)}; sgs_solve {per(t_sgs)}")
        if not bool(torch.isfinite(end["card"]["T"].i).all()):
            raise SystemExit("phase 8: the card's run is not finite")
        if not (max(one.values()) <= STEP_TOL and same_its and max(chain.values()) <= chain_tol):
            raise SystemExit("phase 8: the card's run differs from the CPU's beyond the bounds")
        if not same or its["card"] != its["card again"]:
            raise SystemExit("phase 8: two runs on the card differ")
        if t_dic[0] < 2 or launches["pcg"] != 0:
            raise SystemExit("phase 8: p_rgh did not go through dic_pcg")
        if case is smooth_case and (t_sgs[0] != 3 or launches["smooth"] != 0):
            raise SystemExit("phase 8: Yi, h and k did not go through sgs_solve")


# ---------------------------------------------------------------- phase 6
def cli(args):
    """run.main(args) in this process; returns its printed output (echoing
    the last line). A failure inside raises."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_cli.main(args)
    out = buf.getvalue()
    if rc != 0:
        raise SystemExit(f"phase 6: run {' '.join(args)} exited {rc}")
    say(6, out.strip().splitlines()[-1])
    return out


def dat(root, sub):
    """The rows of a postProcessing .dat file."""
    return np.loadtxt(os.path.join(root, "postProcessing", sub), ndmin=2)


def rows_diff(a, b):
    """The largest difference between two runs' rows of the .dat files,
    per column relative to that column's largest value in `b`."""
    return max(float(np.max(np.abs(a[s] - b[s]) /
                            np.maximum(np.max(np.abs(b[s]), axis=0), 1e-30))) for s in b)


def slice_launches(n_steps, count0, solver_freq):
    """K1/K2/K3 launches of one CLI run: per step U (K1), Yi, h and k (K3)
    and two p_rgh correctors (K2); fvDOM adds one K1 launch on its solve
    steps; the hydrostatic init of initial_state adds 3 K2 launches."""
    n_rad = sum(1 for c in range(count0, count0 + n_steps)
                if c == 0 or (solver_freq > 0 and c % solver_freq == 0))
    return {"bicgstab": n_steps + n_rad, "pcg": 3 + 2 * n_steps, "smooth": 3 * n_steps}


DATS = ("HRR/0/volFieldValue.dat", "minMaxTU/0/fieldMinMax.dat", "plume/0/probes.dat",
        "rtis/0/rtis.dat")


def phase_cli(tmp):
    """The slice through the run CLI (see the module docstring); returns the
    launch counts of its 20-step writing run."""
    case = write_smooth_fire_case(os.path.join(tmp, "slice"), n=N_MAIN, end_time=100.0,
                                  write_control="runTime", write_interval=1e3)
    base = ["--case", case, "--chunk", str(CHUNK_CLI), "--quiet"]
    freq = 10  # the case's fvDOM solverFreq

    def run(args, n_steps, count0):
        dia_krylov.reset_counts()
        out = cli(base + args)
        got = dict(dia_krylov.LAUNCHES)
        exp = slice_launches(n_steps, count0, freq)
        say(6, f"launches {got} (expected {exp})")
        if got != exp:
            raise SystemExit("phase 6: kernel launch counts do not match the solves")
        rows = {sub: dat(case, sub) for sub in DATS}
        for sub, r in rows.items():
            if r.shape[0] != n_steps or not np.all(np.isfinite(r)):
                raise SystemExit(f"phase 6: {sub} has {r.shape[0]} rows for {n_steps} steps "
                                 f"or non-finite values")
        return out, got, rows

    # 1. 30 uninterrupted steps
    _, _, full = run(["--max-steps", "30"], 30, 0)
    t = full[DATS[0]][:, 0]
    T_max = full[DATS[1]][:, 1]  # columns: t, T_max, T_min, U_max, U_min (sorted keys)
    say(6, f"30 steps: t {t[0]:.6g} … {t[-1]:.6g} s, T max {T_max[0]:.3f} → {T_max[-1]:.3f} K")
    if not T_max[-1] > 298.15 + 1.0:
        raise SystemExit("phase 6: the gas did not heat")
    # 2. the same 20 steps, writing once at step 20 (runTime writes do not
    # change the steps): a write interval between t(10) and t(20)
    w = float(0.5 * (t[9] + t[19]))
    with open(os.path.join(case, "system", "controlDict")) as f:
        txt = f.read()
    with open(os.path.join(case, "system", "controlDict"), "w") as f:
        f.write(txt.replace("writeInterval 1000.0;", f"writeInterval {w!r};"))
    out_dir = os.path.join(tmp, "slice_out")
    out, launches, first = run(["--max-steps", "20", "--output", out_dir], 20, 0)
    m = re.search(r"([0-9.]+) ms/step, writing ([0-9.]+) s", out)
    ms, write_s = float(m.group(1)), float(m.group(2))
    times = sorted(d for d in os.listdir(out_dir) if d[0].isdigit())
    ckpt = run_cli.latest_checkpoint(out_dir)
    if len(times) != 1 or ckpt is None:
        raise SystemExit(f"phase 6: expected one write, found {times}")
    with np.load(ckpt) as z:
        state = {k: z[k] for k in z.files}
    for f in ("T", "U"):
        got = read_field_file(os.path.join(out_dir, times[0], f)).internal_array(
            int(np.prod(N_MAIN)))
        ref = state[f"['{f}'].i"].astype(np.float64)
        err = float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)))
        say(6, f"written {f} at t = {times[0]} vs the checkpoint: max rel {err:.3e}")
        if not err <= 1e-7:  # 8 significant digits
            raise SystemExit(f"phase 6: written {f} differs from the state")
    # two runs of the same 20 steps
    rep20 = rows_diff(first, {s: full[s][:20] for s in DATS})
    # 3. 10 steps resumed from the checkpoint at step 20
    count0 = int(state["['rad']['count']"])
    _, _, resumed = run(["--max-steps", "10", "--resume", ckpt], 10, count0)
    res10 = rows_diff(resumed, {s: full[s][20:] for s in DATS})
    say(6, f"{int(np.prod(N_MAIN))} cells float32 CLI: {ms:.3f} ms/step over chunks of "
           f"{CHUNK_CLI}, writing {write_s:.3f} s (one time directory + checkpoint); "
           f"function-object/rtis rows, max rel difference: repeated 20 steps {rep20:.3e}, "
           f"resumed steps 21-30 vs uninterrupted {res10:.3e}")
    if not max(rep20, res10) <= RESUME_TOL:
        raise SystemExit(f"phase 6: a repeated or resumed run differs from the uninterrupted "
                         f"one beyond {RESUME_TOL}")
    return launches


# ---------------------------------------------------------------- phase 5
def phase_drift(dev, case):
    out = {}
    ms = {}
    for run, d, dtype in (("f32", dev, torch.float32), ("f64", dev, torch.float64),
                          ("cpu", torch.device("cpu"), torch.float64)):
        # the kernels' float64 instantiations and their twins: not the exact
        # solvers float64 picks by itself (phase 8), nor the CPU's AMG
        solver = FireFoamSolver(case, device=d, dtype=dtype, exact_solvers=False, gmg=False,
                                amg=False)
        state = solver.initial_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = solver.make_chunk(DRIFT_STEPS)(state)
        torch.cuda.synchronize()
        ms[run] = 1e3 * (time.perf_counter() - t0) / DRIFT_STEPS
        out[run] = {f: state[f].i.double().cpu().numpy() for f in ("T", "U")}
    T32, T64 = out["f32"]["T"], out["f64"]["T"]
    drift = float(np.max(np.abs(T32 - T64) / np.maximum(T64, 1.0)))
    vs_cpu = {f: float(np.max(np.abs(out["f64"][f] - out["cpu"][f])) /
                       np.max(np.abs(out["cpu"][f]))) for f in ("T", "U")}
    n = T64.size
    say(5, f"{n} cells, {DRIFT_STEPS} steps: float32 {ms['f32']:.3f} ms/step "
           f"({n / (ms['f32'] * 1e-3):.6e} cell-updates/s), float64 "
           f"{ms['f64']:.3f} ms/step; max relative T drift {drift:.6e}; float64 card vs "
           f"CPU: T {vs_cpu['T']:.3e}, U {vs_cpu['U']:.3e} relative "
           f"(CPU {ms['cpu']:.1f} ms/step)")
    if not np.all(np.isfinite(T32)) or not drift <= 0.05:
        raise SystemExit("phase 5: float32 drifts from float64 beyond 0.05")
    if not max(vs_cpu.values()) <= CPU_TOL:
        raise SystemExit(f"phase 5: the card's float64 run differs from the CPU's beyond {CPU_TOL}")


# ---------------------------------------------------------------- phase 11
def seg_sum_layouts(g):
    """The SEG face→cell sum (face_to_both_sum, the matvec's and the
    divergence's) on the 117k mesh three ways, float32, [nI] and [nI, 3]:
    the port's padded table; the same table split into its first `dense`
    columns and a tail of the longer rows; and index_add_ (atomics: not
    order-fixed, timed as the library's call only). Returns the numbers."""
    nI, nC = g.n_internal, g.n_cells
    tab = g.seg_both.table
    deg = (tab != 2 * nI).sum(dim=1)
    dense = int(torch.quantile(deg.double(), 0.9))
    rows = torch.nonzero(deg > dense).squeeze(1)
    head, tail = tab[:, :dense].contiguous(), tab[rows, dense:].contiguous()

    def split(a, b):
        ext = torch.cat([a, b, a.new_zeros((1,) + tuple(a.shape[1:]))])
        out = ext[head].sum(dim=1)
        return out.index_add_(0, rows, ext[tail].sum(dim=1))  # rows distinct: no collision

    def library(a, b):
        out = a.new_zeros((nC,) + tuple(a.shape[1:]))
        return out.index_add_(0, g.own, a).index_add_(0, g.nei, b)

    out = {"max_faces": int(deg.max()), "mean_faces": float(deg.double().mean()),
           "table_slots_per_face": tab.numel() / (2.0 * nI), "dense_columns": dense,
           "tail_rows": int(rows.numel())}
    gen = torch.Generator(device=g.device).manual_seed(0)
    for width in (1, 3):
        shape = (nI,) if width == 1 else (nI, 3)
        a = torch.randn(shape, generator=gen, device=g.device, dtype=torch.float32)
        b = torch.randn(shape, generator=gen, device=g.device, dtype=torch.float32)
        ref = g.face_to_both_sum(a, b)
        if not (torch.allclose(split(a, b), ref, rtol=1e-5, atol=1e-5)
                and torch.allclose(library(a, b), ref, rtol=1e-5, atol=1e-5)):
            raise SystemExit("phase 11: the three SEG sums disagree")
        same = all(torch.equal(g.face_to_both_sum(a, b), ref) for _ in range(3))
        out[f"w{width}"] = {"padded_ms": time_ms(lambda: g.face_to_both_sum(a, b), reps=20),
                            "split_ms": time_ms(lambda: split(a, b), reps=20),
                            "index_add_ms": time_ms(lambda: library(a, b), reps=20),
                            "repeat_equal": same}
        if not same:
            raise SystemExit("phase 11: the SEG sum is not bitwise repeatable")
    return out


def twin_solves(solver, state):
    """The BiCGStab solves of one step (U, Yi, h, k and, on a radiation
    step, the fvDOM rays: solve_ldu's twins on SEG), captured and run again
    alone: ms, iterations (the largest row's), kernel launches and host
    reads per solve."""
    calls, orig = [], linear.solve_ldu
    mods = (firefoam_mod, linear, fvdom_mod)

    def shim(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    for mod in mods:
        mod.solve_ldu = shim
    try:
        solver.step(state)
    finally:
        for mod in mods:
            mod.solve_ldu = orig
    out = []
    for a, k in calls:
        if a[1] != "PBiCGStab":
            continue
        run = lambda: orig(*a, **k)
        res = run()
        ms = time_ms(run, reps=3)
        kernels, reads = launches_and_reads(run)
        rows = a[6].shape[0] if a[6].ndim == 2 else 1
        out.append({"rows": rows, "ms": ms, "iterations": int(res.n_iterations.max()),
                    "launches": kernels, "host_reads": reads})
    return out


def phase_castellated(dev, tmp, box_case, box_solver, box_state, box_ms):
    """Unstructured meshes on the SEG layout (see the module docstring);
    returns the castellated path's launch counts and its numbers."""
    # ---- the 117k-cell castellated fire, float32
    t0 = time.perf_counter()
    case = write_castellated_fire_case(os.path.join(tmp, "castel"), n=N_CASTEL, **CASTEL_KW)
    solver = FireFoamSolver(case, device=dev)
    build_s = time.perf_counter() - t0
    g = solver.geom
    if g.layout != "seg" or solver.amg is None or solver._ldu is not None:
        raise SystemExit("phase 11: the castellated fire did not take SEG with AMG on p_rgh")
    n, host = g.n_cells, solver.setup_seconds
    dia_krylov.reset_counts()
    state0 = solver.initial_state()
    init = sum(dia_krylov.LAUNCHES.values())
    T0_max = float(state0["T"].i.max())
    say(11, f"castellated fire {n} cells, {g.n_internal} internal faces, {g.n_boundary} "
            f"boundary faces, layout {g.layout}, {len(solver.amg.levels)} AMG levels; host "
            f"seconds: mesh (blockMesh, castellation, topoSet, createPatch) "
            f"{host['mesh']:.2f}, geometry and SEG tables {host['geometry']:.2f}, AMG "
            f"hierarchy {host['solvers']:.2f}; case and solver {build_s:.1f} s")
    chunk = solver.make_chunk(CHUNK)
    dia_krylov.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, logs = chunk(state0)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / CHUNK
    launches = dict(dia_krylov.LAUNCHES)
    fields = ("T", "U", "p_rgh", "Y", "k", "phi")
    finite = all(bool(torch.isfinite(state[f].i).all() and torch.isfinite(state[f].b).all())
                 for f in fields)
    bad_logs = [k for k, v in logs.items() if not bool(torch.isfinite(torch.as_tensor(v)).all())]
    rays_finite = bool(torch.isfinite(state["rad"]["I"]).all())
    T_max = float(state["T"].i.max())
    p_its = [[int(a), int(b)] for a, b in zip(logs["p_rgh_iters_0"], logs["p_rgh_iters_1"])]
    say(11, f"castellated fire float32, make_chunk({CHUNK}) from t = 0: {ms:.3f} ms/step, "
            f"{n / (ms * 1e-3):.6e} cell-updates/s; T max {T_max:.3f} K (initially "
            f"{T0_max:.3f} K), Qdot_total {float(logs['Qdot_total'][-1]):.6e} W; fields finite "
            f"{finite}, non-finite log entries {bad_logs}, ray intensities finite {rays_finite}")
    say(11, f"castellated fire launches K1 {launches['bicgstab']}, K2 {launches['pcg']}, K3 "
            f"{launches['smooth']} (the hydrostatic init {init}; expected 0: no kernel serves "
            f"SEG); amg_pcg iterations per corrector {p_its}")
    if not finite or bad_logs or not rays_finite:
        raise SystemExit("phase 11: the castellated fire is not finite")
    if not T0_max + 1.0 < T_max < T_FLAME_MAX:
        raise SystemExit("phase 11: the castellated fire did not heat the gas, or ran away")
    if sum(launches.values()) or init:
        raise SystemExit("phase 11: a DIA kernel was launched on a SEG mesh")
    again, logs2 = chunk(state0)
    torch.cuda.synchronize()
    same = all(torch.equal(again[f].i, state[f].i) and torch.equal(again[f].b, state[f].b)
               for f in fields) and all(torch.equal(logs2[k], logs[k]) for k in logs)
    say(11, f"the same {CHUNK} castellated steps again: states and logs bitwise equal: {same}")
    if not same:
        raise SystemExit("phase 11: two runs of the castellated fire differ")
    _, k_step, r_step, busy = step_profile(solver.make_step(), state, PROFILE_STEPS)
    say(11, f"castellated fire per step (torch.profiler, {PROFILE_STEPS} steps after the "
            f"chunk): {k_step:.0f} kernel launches, {r_step:.0f} host reads, device busy "
            f"{busy:.3f} ms of {ms:.3f} ms ({100.0 * (1.0 - busy / ms):.1f} % idle)")
    flat = copy.copy(solver)
    flat.amg = None  # the same solver with the Jacobi-CG twin on p_rgh
    p_rgh = p_rgh_solver_times(11, {"amg_pcg": solver, "CG twin": flat}, state,
                               "117k castellated")
    twins = twin_solves(solver, state)
    for t in twins:
        say(11, f"castellated twin BiCGStab solve of {t['rows']} row(s): {t['ms']:.3f} ms, "
                f"{t['iterations']} iterations, {t['launches']} kernel launches and "
                f"{t['host_reads']} host reads per solve")
    sums = seg_sum_layouts(g)
    say(11, f"SEG face-to-cell sum at {n} cells ({sums['mean_faces']:.2f} faces a cell, up to "
            f"{sums['max_faces']}; {sums['table_slots_per_face']:.2f} table slots a face): "
            + "; ".join(f"{'[nI]' if w == 'w1' else '[nI, 3]'} padded table "
                        f"{sums[w]['padded_ms']:.4f} ms, split ({sums['dense_columns']} dense "
                        f"columns + {sums['tail_rows']} tail rows) {sums[w]['split_ms']:.4f} "
                        f"ms, index_add_ {sums[w]['index_add_ms']:.4f} ms"
                        for w in ("w1", "w3")))
    castel = {"cells": n, "ms_per_step": ms, "launches_per_step": k_step,
              "host_reads_per_step": r_step, "device_busy_ms": busy, "host_seconds": host,
              "p_rgh": {k: {"ms": v[0], "iterations": v[1]} for k, v in p_rgh.items()},
              "twin_bicgstab": twins,
              "seg_sum": sums}
    del solver, flat, state, again, state0

    # ---- the 100k box fire on SEG beside phase 4's DIA run of the same steps
    seg = FireFoamSolver(box_case, device=dev, layout="seg", amg=False)
    if seg.geom.layout != "seg" or seg.amg is not None:
        raise SystemExit("phase 11: layout='seg' did not give the flat twins on SEG")
    dia_krylov.reset_counts()
    st5, _ = seg.make_chunk(GMG_STEPS)(seg.initial_state())
    seg_launches = sum(dia_krylov.LAUNCHES.values())
    ref5, _ = box_solver.make_chunk(GMG_STEPS)(box_solver.initial_state())
    dT5 = float((st5["T"].i - ref5["T"].i).abs().max())
    dU5 = float((st5["U"].i - ref5["U"].i).abs().max())
    dia_krylov.reset_counts()
    st = seg.initial_state()
    st, _ = seg.step(st)  # phase 4's warm-up step
    chunk = seg.make_chunk(CHUNK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, logs = chunk(st)
    torch.cuda.synchronize()
    ms_seg = 1e3 * (time.perf_counter() - t0) / CHUNK
    seg_launches += sum(dia_krylov.LAUNCHES.values())
    dT = float(((st["T"].i - box_state["T"].i).abs() / box_state["T"].i).max())
    dU = float((st["U"].i - box_state["U"].i).abs().max())
    _, k_seg, r_seg, busy_seg = step_profile(seg.make_step(), st, SEG_PROFILE_STEPS)
    k_dia, r_dia, busy_dia = box_profile(box_solver, box_state)
    del seg, st, st5, ref5
    # 1 + SEG_F64_STEPS steps in float64, both layouts on the same solvers
    out64 = {}
    for layout in ("dia", "seg"):
        s64 = FireFoamSolver(box_case, device=dev, dtype=torch.float64, layout=layout,
                             exact_solvers=False, gmg=False, amg=False)
        st64, _ = s64.make_chunk(1 + SEG_F64_STEPS)(s64.initial_state())
        out64[layout] = {f: st64[f].i for f in ("T", "U")}
        del s64, st64
    vs64 = {f: float((out64["seg"][f] - out64["dia"][f]).abs().max()
                     / out64["dia"][f].abs().max()) for f in ("T", "U")}
    say(11, f"box fire {box_state['T'].i.numel()} cells float32, 1 + {CHUNK} steps from t = 0: "
            f"DIA (phase 4, K1/K2) {box_ms:.3f} ms/step, {k_dia:.0f} launches, {r_dia:.0f} host "
            f"reads, device busy {busy_dia:.3f} ms a step; SEG (the twins) {ms_seg:.3f} "
            f"ms/step, {k_seg:.0f} launches, {r_seg:.0f} host reads, device busy "
            f"{busy_seg:.3f} ms a step; kernel launches on SEG {seg_launches}")
    say(11, f"box fire SEG vs DIA: after {GMG_STEPS} steps from t = 0 max |dT| {dT5:.3e} K, "
            f"max |dU| {dU5:.3e} m/s; after 1 + {CHUNK} steps (burning) max relative dT "
            f"{dT:.3e}, max |dU| {dU:.3e} m/s; 1 + {SEG_F64_STEPS} steps in float64: T "
            f"{vs64['T']:.3e}, U {vs64['U']:.3e} relative")
    if seg_launches:
        raise SystemExit("phase 11: the box fire on SEG launched a kernel")
    if not (dT5 <= GMG_TOL and dU5 <= GMG_TOL and dT <= GMG_T_DRIFT and dU <= GMG_TOL):
        raise SystemExit("phase 11: the box fire on SEG leaves the DIA run beyond the bound")
    if not max(vs64.values()) <= CPU_TOL:
        raise SystemExit(f"phase 11: in float64 SEG leaves DIA beyond {CPU_TOL}")
    castel["box_fire_seg"] = {"ms_per_step": ms_seg, "launches_per_step": k_seg,
                              "host_reads_per_step": r_seg, "device_busy_ms": busy_seg,
                              "dia_ms_per_step": box_ms, "dia_launches_per_step": k_dia,
                              "dia_device_busy_ms": busy_dia, "dT_5": dT5, "dU_5": dU5,
                              "dT_rel": dT, "dU": dU, "f64_vs_dia": vs64}

    # ---- the castellated fire at about 10k cells: card against CPU
    small = write_castellated_fire_case(os.path.join(tmp, "castel_small"), n=N_CASTEL_SMALL)
    out, ms_run = {}, {}
    for run, d, dtype in (("f32", dev, torch.float32), ("f64", dev, torch.float64),
                          ("cpu", torch.device("cpu"), torch.float64)):
        s = FireFoamSolver(small, device=d, dtype=dtype)  # the automatic rule
        st = s.initial_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _ = s.make_chunk(DRIFT_STEPS)(st)
        torch.cuda.synchronize()
        ms_run[run] = 1e3 * (time.perf_counter() - t0) / DRIFT_STEPS
        out[run] = {f: st[f].i.double().cpu().numpy() for f in ("T", "U")}
        picks = "AMG" if s.amg is not None else "DIC-PCG" if s._ldu is not None else "CG"
        out[run]["picks"] = picks
    T32, T64 = out["f32"]["T"], out["f64"]["T"]
    drift = float(np.max(np.abs(T32 - T64) / np.maximum(T64, 1.0)))
    vs_cpu = {f: float(np.max(np.abs(out["f64"][f] - out["cpu"][f])) /
                       np.max(np.abs(out["cpu"][f]))) for f in ("T", "U")}
    say(11, f"castellated fire {T64.size} cells, {DRIFT_STEPS} steps: float32 ({out['f32']['picks']} "
            f"on p_rgh) {ms_run['f32']:.3f} ms/step, float64 ({out['f64']['picks']}) "
            f"{ms_run['f64']:.3f} ms/step, CPU float64 ({out['cpu']['picks']}) "
            f"{ms_run['cpu']:.1f} ms/step; max relative T drift float32 vs float64 "
            f"{drift:.6e}; float64 card vs CPU: T {vs_cpu['T']:.3e}, U {vs_cpu['U']:.3e}")
    if not np.all(np.isfinite(T32)) or not drift <= T_DRIFT:
        raise SystemExit("phase 11: float32 drifts from float64 beyond the band")
    if not max(vs_cpu.values()) <= CPU_TOL:
        raise SystemExit(f"phase 11: the card's float64 run differs from the CPU's beyond "
                         f"{CPU_TOL}")
    castel["small"] = {"cells": int(T64.size), "drift": drift, "vs_cpu": vs_cpu, "ms": ms_run}
    return launches, castel



# ---------------------------------------------------------------- phase 12
def spray_leaves(state):
    """Every tensor of a state (fields, radiation, the cloud's SoA, its
    injector/collector lists and its random key), by key path."""
    out = {}

    def walk(x, key):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{key}/{k}")
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(v, f"{key}[{i}]")
        elif isinstance(x, tuple):
            walk(x.i, key + ".i")
            walk(x.b, key + ".b")
        elif torch.is_tensor(x):
            out[key] = x

    walk(state, "")
    return out


def states_equal(a, b):
    la, lb = spray_leaves(a), spray_leaves(b)
    return la.keys() == lb.keys() and all(torch.equal(la[k], lb[k]) for k in la)


def injected_mass(solver, state, elapsed):
    """The mass the sprinkler heads released by `state`: the K-factor flow
    of every head over `elapsed`, the sum of the steps' dt as each step
    accrued it (the float32 t carries its own rounding), less what each
    head still owes."""
    m = 0.0
    for inj, ist in zip(solver.cloud.injectors, state["cloud"]["inj"]):
        m += inj.n_spr * inj.Q * 1000.0 * elapsed - float(ist["m_owed"].sum())
    return m


def profiled_call(fn):
    """(kernel launches, host reads, device-busy ms) of one call."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    kernels = sum(e.count for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.lower().startswith(("memcpy", "memset")))
    reads = sum(e.count for e in avgs if e.key == "aten::_local_scalar_dense")
    return kernels, reads, _busy_us(prof) / 1e3


def phase_spray(dev, tmp, box_solver, box_state, box_ms):
    """The sprinkler fire (see the module docstring); returns the launch
    counts of its 100k-cell run."""
    case = write_spray_fire_case(os.path.join(tmp, "spray"), n=N_MAIN, pps=SPRAY_PPS,
                                 end_time=100.0)
    t0 = time.perf_counter()
    solver = FireFoamSolver(case, device=dev)
    cloud = solver.cloud
    state0 = solver.initial_state()
    step = solver.make_step()
    state1, log1 = step(state0)  # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n = solver.geom.n_cells
    if cloud is None or cloud.cfg.capacity != SPRAY_CAPACITY or "cloud_rad" not in state1:
        raise SystemExit("phase 12: the sprinkler case did not build its cloud at the JAX "
                         "package's capacity with cloud radiation")
    count0 = int(state1["rad"]["count"])
    chunk = solver.make_chunk(CHUNK)
    sweeps0 = solver.radiation.sweeps
    dia_krylov.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, logs = chunk(state1)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / CHUNK
    launches = dict(dia_krylov.LAUNCHES)
    exp_k1, exp_k2 = expected_launches(solver.radiation, count0, CHUNK)
    sweeps = solver.radiation.sweeps - sweeps0
    fields = ("T", "U", "p_rgh", "Y", "k")
    finite = all(bool(torch.isfinite(state[f].i).all()) for f in fields) and all(
        bool(torch.isfinite(v).all()) for v in spray_leaves(state["cloud"]).values()
        if v.is_floating_point())
    bad_logs = [k for k, v in logs.items() if not bool(torch.isfinite(torch.as_tensor(v)).all())]
    alive = int(logs["cloud_nParcels"][-1])
    T_max = float(state["T"].i.max())
    # mass bookkeeping from t = 0: injected + expansion = in the system +
    # evaporated + escaped + collected (the collector removes what it
    # catches) + dropped at minParticleMass
    evap, esc, drop, expa = (float(log1[k]) + float(logs[k].sum()) for k in (
        "cloud_massEvaporated", "cloud_massEscaped", "cloud_massDropped", "cloud_massExpansion"))
    coll = sum(float(c["mass"].sum()) for c in state["cloud"]["coll"])
    inside = float(logs["cloud_mass"][-1])
    inj = injected_mass(solver, state, float(log1["dt"]) + float(logs["dt"].double().sum()))
    book = abs(inj + expa - (inside + evap + esc + coll + drop)) / inj
    say(12, f"sprinkler fire {n} cells float32 (capacity {cloud.cfg.capacity} parcels, "
            f"{cloud.cfg.n_sub} substeps of a {cloud.cfg.walk_steps}-hop walk; setup + warm-up "
            f"{setup_s:.1f} s): {ms:.3f} ms/step over make_chunk({CHUNK}), t = "
            f"{float(state['t']):.4f} s, T max {T_max:.3f} K, parcels alive {alive}; fields, "
            f"cloud and logs finite {finite and not bad_logs} {bad_logs}")
    say(12, f"mass since t = 0 [kg]: injected {inj:.6e} + expansion {expa:.6e} = in system "
            f"{inside:.6e} + evaporated {evap:.6e} + escaped {esc:.6e} + collected {coll:.6e} "
            f"+ dropped {drop:.6e}; relative gap {book:.3e} (bound {SPRAY_MASS_TOL:g})")
    say(12, f"launches K1 {launches['bicgstab']} (expected {exp_k1}; fvDOM ray sweeps with the "
            f"spray's terms {sweeps}), K2 {launches['pcg']} (expected {exp_k2}), K3 "
            f"{launches['smooth']}")
    if not finite or bad_logs:
        raise SystemExit("phase 12: the sprinkler fire is not finite")
    if not alive > 0:
        raise SystemExit("phase 12: no parcel alive")
    if not book <= SPRAY_MASS_TOL:
        raise SystemExit("phase 12: the spray's mass bookkeeping does not close")
    if (launches["bicgstab"], launches["pcg"], launches["smooth"]) != (exp_k1, exp_k2, 0) or \
            sweeps != exp_k1 - 4 * CHUNK:
        raise SystemExit("phase 12: kernel launch counts do not match the solves")
    again, logs2 = chunk(state1)
    torch.cuda.synchronize()
    same = states_equal(again, state) and all(torch.equal(logs2[k], logs[k]) for k in logs)
    say(12, f"the same {CHUNK} steps again: states (cloud and key included) and logs bitwise "
            f"equal: {same}")
    if not same:
        raise SystemExit("phase 12: two runs of the sprinkler fire differ")
    _, k_spray, r_spray, busy_spray = step_profile(step, state, SPRAY_PROFILE_STEPS)
    k_box, r_box, busy_box = box_profile(box_solver, box_state)
    k_cloud, r_cloud, busy_cloud = profiled_call(lambda: solver._evolve_cloud(state, {}))
    k_spray = max(k_spray, 1)  # the profiler may see no device event (then 0)
    busy_spray = max(busy_spray, 1e-9)
    say(12, f"per step at {n} cells float32 (torch.profiler over {SPRAY_PROFILE_STEPS} steps, "
            f"the box fire's over {PROFILE_STEPS}): box fire {box_ms:.3f} ms (phase 4), {k_box:.0f} launches, {r_box:.1f} host reads, device "
            f"busy {busy_box:.3f} ms; sprinkler fire {ms:.3f} ms, {k_spray:.0f} launches, "
            f"{r_spray:.1f} host reads, device busy {busy_spray:.3f} ms "
            f"({100.0 * (1.0 - busy_spray / ms):.1f} % idle); the cloud's evolve alone "
            f"{k_cloud} launches ({100.0 * k_cloud / k_spray:.1f} %), {r_cloud} host reads, "
            f"{busy_cloud:.3f} ms device busy ({100.0 * busy_cloud / busy_spray:.1f} %)")
    del again, state0
    phase_spray_cli(write_spray_fire_case(os.path.join(tmp, "spray_cli"), n=N_MAIN,
                                          pps=SPRAY_PPS, end_time=100.0),
                    tmp, 12, "sprinkler")
    phase_spray_small(dev, write_spray_fire_case(os.path.join(tmp, "spray_small"), n=N_SMALL,
                                                 pps=SPRAY_PPS_SMALL),
                      12, "sprinkler fire")
    return launches


def phase_spray_cli(case, tmp, phase, what, keys=()):
    """A spray fire through the run CLI's engine (run_case): 15
    uninterrupted steps; the same 10 steps writing once (time directory +
    checkpoint with the cloud, its key and the cloud leaves `keys`); 5 steps
    resumed from that checkpoint, bitwise equal to the uninterrupted run's."""
    kw = dict(verbose=False, chunk=5, device="cuda")
    path = os.path.join(case, "system", "controlDict")

    def control(old, new):
        with open(path) as f:
            txt = f.read()
        with open(path, "w") as f:
            f.write(txt.replace(old, new))

    # runTime writes do not change the steps (adjustableRunTime ones shorten
    # them to land on the write time)
    control("writeControl adjustableRunTime; writeInterval 1;",
            "writeControl runTime; writeInterval 1000.0;")
    _, full, logs = run_cli.run_case(case, max_steps=15, **kw)
    t = [float(lg["t"]) for lg in logs]
    control("writeInterval 1000.0;", f"writeInterval {0.5 * (t[8] + t[9])!r};")  # at step 10
    out_dir = os.path.join(tmp, f"{what}_out")
    stats = {}
    _, ten, _ = run_cli.run_case(case, max_steps=10, output_dir=out_dir, write_fields=True,
                                 stats=stats, **kw)
    times = sorted(d for d in os.listdir(out_dir) if d[0].isdigit())
    ckpt = run_cli.latest_checkpoint(out_dir)
    if len(times) != 1 or ckpt is None:
        raise SystemExit(f"phase {phase}: expected one write, found {times}")
    with np.load(ckpt) as z:
        have = set(z.files)
        rng = z["['cloud']['rng']"]
    n_cloud = sum(1 for k in have if k.startswith("['cloud']"))
    need = {"['cloud']['alive']", "['cloud']['inj'][0]['m_owed']"} | {
        f"['cloud']{k}" for k in keys}
    if rng.dtype != np.uint32 or not need <= have:
        raise SystemExit(f"phase {phase}: the checkpoint lacks the cloud, its key or "
                         f"{sorted(need - have)}")
    _, resumed, _ = run_cli.run_case(case, max_steps=5, resume=ckpt, **kw)
    same = states_equal(resumed, full)
    say(phase, f"{what}: run_case: 15 steps; 10 steps writing once "
               f"({stats['write_seconds']:.3f} s: time directory {times[0]} + checkpoint with "
               f"{n_cloud} cloud leaves, key {rng.tolist()}); 5 steps resumed: state bitwise "
               f"equal to the uninterrupted run's {same} "
               f"(parcels {int(full['cloud']['alive'].sum())})")
    if not same:
        raise SystemExit(f"phase {phase}: the resumed {what} run differs from the uninterrupted "
                         "one")


def phase_spray_small(dev, case, phase, what, capacity=None, aligned_draws=False):
    """A 9k-cell spray fire: DRIFT_STEPS steps in float32 and float64 on the
    card and in float64 on the CPU, in lockstep: each step the card's
    float64 fields and parcels against the CPU's (the first step whose
    parcels part, and whose iteration counts part, is printed); then the
    last step again on the card from the CPU's state. `capacity` cuts the
    clouds' slots (all runs alike). `aligned_draws`: one more float32 run
    whose random draws are float64's rounded (R11: float32 and float64 draw
    from other bits), which the T drift band then holds; the drift as drawn
    is printed. Returns the runs' solvers."""
    t_start = time.perf_counter()
    cpu = torch.device("cpu")
    runs = (("f32", dev, torch.float32), ("f64", dev, torch.float64),
            ("cpu", cpu, torch.float64)) + ((("f32x", dev, torch.float32),) if aligned_draws
                                            else ())
    solvers, states, secs = {}, {}, {}
    for run, d, dtype in runs:
        solvers[run] = FireFoamSolver(case, device=d, dtype=dtype, exact_solvers=False,
                                      gmg=False, amg=False)
        if capacity is not None:
            solvers[run].cloud.cfg.capacity = capacity
        states[run] = solvers[run].initial_state()
        secs[run] = 0.0
    rows, parted, iters_apart, before, last = [], None, None, None, None
    for i in range(DRIFT_STEPS):
        logs = {}
        if i == DRIFT_STEPS - 1:
            before = firefoam_mod.state_to_numpy(states["cpu"])
        for run, _, _ in runs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with float64_draws() if run == "f32x" else contextlib.nullcontext():
                states[run], logs[run] = solvers[run].step(states[run])
            torch.cuda.synchronize()
            secs[run] += time.perf_counter() - t0
        last = logs["cpu"]
        apart = [f"{k} {int(logs['f64'][k])}/{int(logs['cpu'][k])}" for k in logs["cpu"]
                 if "iters" in k and int(logs["f64"][k]) != int(logs["cpu"][k])]
        if apart and iters_apart is None:
            iters_apart = f"step {i + 1}: " + ", ".join(apart)
        a, b = states["f64"], states["cpu"]
        ca, cb = a["cloud"], b["cloud"]
        both = (ca["alive"].cpu() & cb["alive"]).numpy()
        alive_diff = int((ca["alive"].cpu() != cb["alive"]).sum())
        cell_diff = int((ca["cell"].cpu() != cb["cell"]).numpy()[both].sum())
        x_diff = float((ca["x"].cpu() - cb["x"]).abs().numpy()[both].max()) if both.any() else 0.0
        rel = {f: float((a[f].i.cpu() - b[f].i).abs().max() / b[f].i.abs().max())
               for f in ("T", "U")}
        rows.append(f"{i + 1}: T {rel['T']:.2e} U {rel['U']:.2e} x {x_diff:.1e} "
                    f"cells {cell_diff} alive {alive_diff}")
        if parted is None and (alive_diff or cell_diff):
            parted = i + 1
    out = {run: {f: states[run][f].i.double().cpu().numpy() for f in ("T", "U")}
           for run, _, _ in runs}
    alive = {run: int(states[run]["cloud"]["alive"].sum()) for run, _, _ in runs}
    ms = {run: 1e3 * secs[run] / DRIFT_STEPS for run in secs}
    T64 = out["f64"]["T"]
    drifts = {run: float(np.max(np.abs(out[run]["T"] - T64) / np.maximum(T64, 1.0)))
              for run in ("f32", "f32x") if run in out}
    T32 = out["f32x" if aligned_draws else "f32"]["T"]
    drift = drifts["f32x" if aligned_draws else "f32"]
    aligned = (f" (as drawn {drifts['f32']:.6e}; with float64's draws rounded, which the band "
               f"holds: {drift:.6e})" if aligned_draws else "")

    vs_cpu = {f: float(np.max(np.abs(out["f64"][f] - out["cpu"][f])) /
                       np.max(np.abs(out["cpu"][f]))) for f in ("T", "U")}
    # the last step on the card from the CPU's state
    stepped, log = solvers["f64"].step(firefoam_mod.state_from_numpy(before, device=dev,
                                                                     dtype=torch.float64))
    one = {f: float((stepped[f].i.cpu() - states["cpu"][f].i).abs().max() /
                    states["cpu"][f].i.abs().max()) for f in ("T", "U")}
    same_its = all(int(log[k]) == int(last[k]) for k in last if "iters" in k)
    say(phase, f"{what} {T64.size} cells, float64 card vs CPU step by step (relative T, U; "
               f"largest parcel position gap [m]; parcels in other cells; alive flags apart): "
               f"{'; '.join(rows)}; "
               f"first step whose parcels part: {parted}; first solves whose iteration counts "
               f"part (card/CPU): {iters_apart}")
    say(phase, f"{what} {T64.size} cells, {DRIFT_STEPS} steps: float32 {ms['f32']:.3f}, "
               f"float64 {ms['f64']:.3f}, CPU float64 {ms['cpu']:.1f} ms/step; float64 card vs "
               f"CPU: T {vs_cpu['T']:.3e}, U {vs_cpu['U']:.3e} relative (bound "
               f"{SPRAY_CHAIN_TOL:g}); "
               f"the last step from the CPU's state: T {one['T']:.3e}, U "
               f"{one['U']:.3e}, iteration counts equal {same_its}; parcels alive {alive['f64']} "
               f"vs {alive['cpu']} (float32 {alive['f32']}); float32 T drift {drift:.6e}"
               f"{aligned} ({time.perf_counter() - t_start:.1f} s)")
    if alive["f64"] != alive["cpu"] or parted is not None:
        raise SystemExit(f"phase {phase}: the card's float64 parcels part from the CPU's")
    if not (max(one.values()) <= STEP_TOL and same_its):
        raise SystemExit(f"phase {phase}: the card's float64 step differs from the CPU's")
    if not max(vs_cpu.values()) <= SPRAY_CHAIN_TOL:
        raise SystemExit(f"phase {phase}: the card's float64 run differs from the CPU's beyond "
                         "the bound")
    if not np.all(np.isfinite(T32)) or not drift <= T_DRIFT:
        raise SystemExit(f"phase {phase}: float32 drifts from float64 beyond the band")
    return solvers


# ---------------------------------------------------------------- phase 13
def solid_mass(solver, state) -> float:
    """The solids' mass [kg]: Σ ρ·dx·area over every zone's layers, summed
    in float64."""
    m = 0.0
    for z, zst in zip(solver.pyrolysis.zones, state["pyro"]):
        dx = torch.as_tensor(z.region.dx, dtype=torch.float64, device=zst["rho"].device)
        area = torch.as_tensor(z.region.area, dtype=torch.float64, device=zst["rho"].device)
        m += float((zst["rho"].double() * dx[None, :] * area[:, None]).sum())
    return m


def surface_T_max(state) -> float:
    return max(float(zst["T"][:, 0].max()) for zst in state["pyro"])


def phase_regions(dev, tmp, box_solver, box_state, box_ms):
    """The region fires (see the module docstring); returns the launch
    counts of the 100k-cell wetted panel fire."""
    case = write_wetted_panel_fire_case(os.path.join(tmp, "wet"), n=N_MAIN, **WET_MAIN_KW)
    t0 = time.perf_counter()
    solver = FireFoamSolver(case, device=dev)
    zone = solver.pyrolysis.zones[0] if solver.pyrolysis is not None else None
    film = solver.film
    state0 = solver.initial_state()
    step = solver.make_step()
    state1, log1 = step(state0)  # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n = solver.geom.n_cells
    if zone is None or film is None or solver.cloud is None or \
            solver.cloud.cfg.capacity != SPRAY_CAPACITY or len(solver.cloud.injectors) != 2:
        raise SystemExit("phase 13: the wetted panel fire did not build its regions, its cloud "
                         "at the JAX package's capacity and the drip injector")
    count0 = int(state1["rad"]["count"])
    chunk = solver.make_chunk(CHUNK)
    sweeps0 = solver.radiation.sweeps
    Ts1, m1 = surface_T_max(state1), solid_mass(solver, state1)
    dia_krylov.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, logs = chunk(state1)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / CHUNK
    launches = dict(dia_krylov.LAUNCHES)
    exp_k1, exp_k2 = expected_launches(solver.radiation, count0, CHUNK)
    sweeps = solver.radiation.sweeps - sweeps0
    leaves = spray_leaves({k: state[k] for k in ("T", "U", "p_rgh", "Y", "k", "cloud", "film",
                                                 "pyro", "rad")})
    finite = all(bool(torch.isfinite(v).all()) for v in leaves.values() if v.is_floating_point())
    bad_logs = [k for k, v in logs.items() if not bool(torch.isfinite(torch.as_tensor(v)).all())]
    T_s = surface_T_max(state)
    mlr = logs[f"pyro_{zone.region_name}_mlr"].double()
    p_in = solver.geom.patch(f"region0_to_{zone.region_name}_panelHigh")
    inflow = float(-state["phi"].b[p_in.slice].double().sum())
    film_mass = float(logs["film_mass"][-1])
    # the solid's ledger over the chunk: its mass lost against the pyrolysate
    # it sent (Σ flux·dt), and its own tally
    sent = float((mlr * logs["dt"].double()).sum())
    lost = m1 - solid_mass(solver, state)
    tally = float(state["pyro"][0]["lostSolidMass"].double() - state1["pyro"][0]["lostSolidMass"]
                  .double())
    solid_gap = abs(lost - sent) / max(sent, 1e-300)
    tally_gap = abs(tally - sent) / max(sent, 1e-300)
    impinged = float(logs["film_massImpinged"].double().sum())
    # the film's ledger from t = 0
    fst = state["film"]
    taken = float(log1["film_massInlet"]) + float(log1["film_massImpinged"]) + float(
        (logs["film_massInlet"].double() + logs["film_massImpinged"].double()).sum())
    kept = film_mass + float(fst["evaporatedMass"]) + float(fst["drippedMass"]) + float(
        fst["removedMass"])
    film_gap = abs(taken - kept) / max(taken, 1e-300)
    say(13, f"wetted panel fire {n} cells float32 ({zone.region.n_faces} solid columns x "
            f"{zone.region.n_layers} layers, film on {film.fm.n_faces} faces, capacity "
            f"{solver.cloud.cfg.capacity} parcels; setup + warm-up {setup_s:.1f} s): {ms:.3f} "
            f"ms/step over make_chunk({CHUNK}), t = {float(state['t']):.4f} s, T max "
            f"{float(state['T'].i.max()):.3f} K; the panel's surface T max {Ts1:.3f} -> "
            f"{T_s:.3f} K; pyrolysate {float(mlr[0]):.6e} -> {float(mlr[-1]):.6e} kg/s, into "
            f"the gas through panelHigh {inflow:.6e} kg/s; film mass {film_mass:.6e} kg; "
            f"parcels alive {int(logs['cloud_nParcels'][-1])}; fields, parcels, film, solid "
            f"and logs finite {finite and not bad_logs} {bad_logs}")
    say(13, f"solid mass ledger over the chunk [kg]: lost {lost:.6e}, pyrolysate sent "
            f"{sent:.9e}, the solid's tally {tally:.9e}; relative gaps: lost {solid_gap:.3e} "
            f"(bound {SOLID_MASS_TOL:g}), tally {tally_gap:.3e} (bound {SOLID_TALLY_TOL:g}). "
            f"Film since t = 0: inlet + impinged {taken:.6e} (impinged over the chunk "
            f"{impinged:.6e}) = film "
            f"{film_mass:.6e} + evaporated {float(fst['evaporatedMass']):.6e} + dripped "
            f"{float(fst['drippedMass']):.6e} + removed {float(fst['removedMass']):.6e}; "
            f"relative gap {film_gap:.3e} (bound {FILM_MASS_TOL:g})")
    say(13, f"launches K1 {launches['bicgstab']} (expected {exp_k1}; fvDOM ray sweeps {sweeps}), "
            f"K2 {launches['pcg']} (expected {exp_k2}), K3 {launches['smooth']}")
    if not finite or bad_logs:
        raise SystemExit("phase 13: the wetted panel fire is not finite")
    if not (T_s > Ts1 and float(mlr.min()) > 0.0 and inflow > 0.0 and film_mass > 0.0):
        raise SystemExit("phase 13: the panel did not heat, no pyrolysate flowed or the film is "
                         "dry")
    if not (solid_gap <= SOLID_MASS_TOL and tally_gap <= SOLID_TALLY_TOL):
        raise SystemExit("phase 13: the solid's mass ledger does not close")
    if not impinged > 0.0:
        raise SystemExit("phase 13: the spray never struck the film")
    if not film_gap <= FILM_MASS_TOL:
        raise SystemExit("phase 13: the film's mass ledger does not close")
    if (launches["bicgstab"], launches["pcg"], launches["smooth"]) != (exp_k1, exp_k2, 0) or \
            sweeps != exp_k1 - 4 * CHUNK:
        raise SystemExit("phase 13: kernel launch counts do not match the solves")
    again, logs2 = chunk(state1)
    torch.cuda.synchronize()
    same = states_equal(again, state) and all(torch.equal(logs2[k], logs[k]) for k in logs)
    say(13, f"the same {CHUNK} steps again: states (film, solid, cloud and key included) and "
            f"logs bitwise equal: {same}")
    if not same:
        raise SystemExit("phase 13: two runs of the wetted panel fire differ")
    del again, state0
    _, k_all, r_all, busy_all = step_profile(step, state, SPRAY_PROFILE_STEPS)
    srcs = solver._evolve_cloud(dict(state), {})[1]
    k_film, r_film, busy_film = profiled_call(lambda: solver._evolve_film(state, srcs, {}))
    k_pyro, r_pyro, busy_pyro = profiled_call(lambda: solver._evolve_pyrolysis(state, {}, srcs))
    k_all = max(k_all, 1)
    busy_all = max(busy_all, 1e-9)
    say(13, f"per step at {n} cells float32 (torch.profiler over {SPRAY_PROFILE_STEPS} steps): box "
            f"fire {box_ms:.3f} ms (phase 4); wetted panel fire {ms:.3f} ms, {k_all:.0f} "
            f"launches, {r_all:.1f} host reads, device busy {busy_all:.3f} ms "
            f"({100.0 * (1.0 - busy_all / ms):.1f} % idle); the film's evolve alone {k_film} "
            f"launches ({100.0 * k_film / k_all:.1f} %), {r_film} host reads, {busy_film:.3f} "
            f"ms device busy ({100.0 * busy_film / busy_all:.1f} %); the pyrolysis' alone "
            f"{k_pyro} launches ({100.0 * k_pyro / k_all:.1f} %), {r_pyro} host reads, "
            f"{busy_pyro:.3f} ms ({100.0 * busy_pyro / busy_all:.1f} %)")
    if r_film or r_pyro:
        raise SystemExit("phase 13: the regions read the card on the host")
    del state, solver
    phase_regions_cli(tmp, case)
    for which in ("panel", "wetted"):
        phase_regions_small(dev, tmp, which)
    phase_solid_only(tmp)
    return launches


def phase_regions_cli(tmp, case):
    """The wetted panel fire through run_case: 10 uninterrupted steps; the
    same 5 steps writing once (a time directory and a checkpoint with the
    solid's list and the film); 5 steps resumed from it, bitwise equal."""
    path = os.path.join(case, "system", "controlDict")
    kw = dict(verbose=False, chunk=5, device="cuda")

    def control(old, new):
        with open(path) as f:
            txt = f.read()
        with open(path, "w") as f:
            f.write(txt.replace(old, new))

    control("writeControl adjustableRunTime; writeInterval 1;",
            "writeControl runTime; writeInterval 1000.0;")
    _, full, logs = run_cli.run_case(case, max_steps=10, **kw)
    t = [float(lg["t"]) for lg in logs]
    control("writeInterval 1000.0;", f"writeInterval {0.5 * (t[3] + t[4])!r};")  # at step 5
    out_dir = os.path.join(tmp, "wet_out")
    stats = {}
    run_cli.run_case(case, max_steps=5, output_dir=out_dir, write_fields=True, stats=stats, **kw)
    times = sorted(d for d in os.listdir(out_dir) if d[0].isdigit())
    ckpt = run_cli.latest_checkpoint(out_dir)
    if len(times) != 1 or ckpt is None:
        raise SystemExit(f"phase 13: expected one write, found {times}")
    with np.load(ckpt) as z:
        keys = set(z.files)
    need = ("['pyro'][0]['T']", "['pyro'][0]['Ys0']", "['film']['delta']",
            "['film_drip_b']", "['cloud']['inj'][1]['m_owed']")
    if not all(k in keys for k in need):
        raise SystemExit("phase 13: the checkpoint lacks the solid, the film or the drip injector")
    _, resumed, _ = run_cli.run_case(case, max_steps=5, resume=ckpt, **kw)
    same = states_equal(resumed, full)
    say(13, f"run_case: 10 steps; 5 steps writing once ({stats['write_seconds']:.3f} s: time "
            f"directory {times[0]} + checkpoint with {sum(1 for k in keys if 'pyro' in k)} solid "
            f"and {sum(1 for k in keys if 'film' in k)} film leaves); 5 steps resumed: state "
            f"bitwise equal to the uninterrupted run's {same}")
    if not same:
        raise SystemExit("phase 13: the resumed wetted panel fire differs from the uninterrupted one")


def rel_max(a, b, floor=1e-300) -> float:
    """max |a − b| / max |b| (b on the CPU, a anywhere)."""
    a, b = torch.as_tensor(a).cpu().double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / max(float(b.abs().max()), floor))


def region_rel(a, b) -> dict:
    """The card's state against the CPU's: T and U of the gas, the solid's
    T, and (with a film) every film leaf, relative to its largest value."""
    rel = {f: rel_max(a[f].i, b[f].i) for f in ("T", "U")}
    rel["solid"] = rel_max(a["pyro"][0]["T"], b["pyro"][0]["T"])
    if "film" in b:
        fa, fb = spray_leaves(a["film"]), spray_leaves(b["film"])
        rel["film"] = max(rel_max(fa[k], fb[k]) for k in fb if fb[k].is_floating_point())
    return rel


def phase_regions_small(dev, tmp, which):
    """A 9k-cell region fire, DRIFT_STEPS steps from t = 0 in lockstep in
    float32 and float64 on the card and float64 on the CPU. The panel fire:
    then the last step on the card from the CPU's state. The wetted panel
    fire (in a 1 × 0.5 × 1 m box with no collector, so that the spray
    strikes the floor film from step WET_STRIKE on): the card's float64
    run restarts from the CPU's state at step DRIFT_STEPS and runs
    WET_CHAIN steps across the strike beside the CPU's (impinged mass per
    step, film, solid, parcels alive); the CPU runs on alone to step
    WET_DRIP_STEP, where the film drips over the panel's lower rim, and the
    card takes that step from the CPU's state; FilmDripInjection on the
    card against the CPU's on a set drip flux (the run's drip stays below
    a parcel's mass)."""
    if which == "panel":
        case = write_panel_fire_case(os.path.join(tmp, "panel_small"), n=N_SMALL)
        chain_tol = CPU_TOL
    else:
        case = write_wetted_panel_fire_case(os.path.join(tmp, "wet_small"), n=N_SMALL,
                                            **WET_SMALL_KW)
        chain_tol = REGION_CHAIN_TOL
    cpu = torch.device("cpu")
    runs = (("f32", dev, torch.float32), ("f64", dev, torch.float64), ("cpu", cpu, torch.float64))
    solvers, states, secs = {}, {}, {}
    for run, d, dtype in runs:
        solvers[run] = FireFoamSolver(case, device=d, dtype=dtype, exact_solvers=False,
                                      gmg=False, amg=False)
        states[run] = solvers[run].initial_state()
        secs[run] = 0.0

    def card_step(run, st):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solvers[run].step(st)
        torch.cuda.synchronize()
        secs[run] += time.perf_counter() - t0
        return out

    rows, before, last = [], None, None
    for i in range(DRIFT_STEPS):
        logs = {}
        if i == DRIFT_STEPS - 1:
            before = firefoam_mod.state_to_numpy(states["cpu"])
        for run, _, _ in runs:
            states[run], logs[run] = card_step(run, states[run])
        last = logs["cpu"]
        rel = region_rel(states["f64"], states["cpu"])
        row = f"{i + 1}: " + " ".join(f"{k} {v:.2e}" for k, v in rel.items())
        if "cloud" in states["cpu"]:
            row += (f" alive "
                    f"{int((states['f64']['cloud']['alive'].cpu() != states['cpu']['cloud']['alive']).sum())}")
        rows.append(row)
    vs_cpu = rel
    T32 = states["f32"]["T"].i.double().cpu().numpy()
    T64 = states["f64"]["T"].i.double().cpu().numpy()
    drift = float(np.max(np.abs(T32 - T64) / np.maximum(T64, 1.0)))
    ms = {run: 1e3 * secs[run] / DRIFT_STEPS for run in secs}
    label = "panel fire" if which == "panel" else "wetted panel fire"
    say(13, f"{label} {T64.size} cells, float64 card vs CPU step by step (relative): "
            f"{'; '.join(rows)} (bound {chain_tol:g}); {DRIFT_STEPS} steps: float32 "
            f"{ms['f32']:.3f}, float64 {ms['f64']:.3f}, CPU float64 {ms['cpu']:.1f} ms/step; "
            f"float32 T drift {drift:.6e}")
    if not max(vs_cpu.values()) <= chain_tol:
        raise SystemExit(f"phase 13: the card's float64 {which} fire differs from the CPU's "
                         "beyond the bound")
    if "cloud" in states["cpu"] and not torch.equal(states["f64"]["cloud"]["alive"].cpu(),
                                                    states["cpu"]["cloud"]["alive"]):
        raise SystemExit("phase 13: the card's float64 parcels part from the CPU's")
    if not np.all(np.isfinite(T32)) or not drift <= T_DRIFT:
        raise SystemExit(f"phase 13: the {which} fire's float32 drifts from float64 beyond the band")
    del states["f32"], solvers["f32"]
    if which == "wetted":
        # the strike: the card restarts from the CPU's state and runs beside it
        states["f64"] = firefoam_mod.state_from_numpy(firefoam_mod.state_to_numpy(states["cpu"]),
                                                      device=dev, dtype=torch.float64)
        rows, imp = [], {"f64": 0.0, "cpu": 0.0}
        for i in range(DRIFT_STEPS, DRIFT_STEPS + WET_CHAIN):
            logs = {}
            for run in ("f64", "cpu"):
                states[run], logs[run] = card_step(run, states[run])
                imp[run] += float(logs[run]["film_massImpinged"])
            rel = region_rel(states["f64"], states["cpu"])
            rel["imp"] = rel_max(logs["f64"]["film_massImpinged"],
                                      logs["cpu"]["film_massImpinged"])
            alive = [int(states[run]["cloud"]["alive"].sum()) for run in ("f64", "cpu")]
            rows.append(f"{i + 1}: " + " ".join(f"{k} {v:.2e}" for k, v in rel.items())
                        + f" impinged {float(logs['cpu']['film_massImpinged']):.6e} kg, alive "
                        f"{alive[0]}/{alive[1]}")
            handoff = max(v for k, v in rel.items() if k not in ("T", "U"))
            if not (max(rel["T"], rel["U"]) <= STRIKE_CHAIN_TOL and handoff <= HANDOFF_TOL
                    and alive[0] == alive[1]):
                raise SystemExit(f"phase 13: the card's spray-to-film handoff parts from the "
                                 f"CPU's at step {i + 1}: {rows[-1]}")
        say(13, f"wetted panel fire: the card from the CPU's state at step {DRIFT_STEPS}, "
                f"{WET_CHAIN} steps across the strike beside the CPU (relative; bounds: T and U "
                f"{STRIKE_CHAIN_TOL:g}, the rest {HANDOFF_TOL:g}): {'; '.join(rows)}; impinged in all {imp['f64']:.9e} kg "
                f"(card), {imp['cpu']:.9e} kg (CPU)")
        if not (imp["f64"] > 0.0 and imp["cpu"] > 0.0):
            raise SystemExit("phase 13: the spray never struck the film")
        del states["f64"]
        for _ in range(DRIFT_STEPS + WET_CHAIN, WET_DRIP_STEP - 1):
            states["cpu"], _ = solvers["cpu"].step(states["cpu"])
        before = firefoam_mod.state_to_numpy(states["cpu"])
        states["cpu"], last = solvers["cpu"].step(states["cpu"])
    stepped, log = solvers["f64"].step(firefoam_mod.state_from_numpy(before, device=dev,
                                                                     dtype=torch.float64))
    one = region_rel(stepped, states["cpu"])
    same_its = all(int(log[k]) == int(last[k]) for k in last if "iters" in k)
    extra = ""
    if which == "wetted":
        ca, cb = spray_leaves(stepped["cloud"]), spray_leaves(states["cpu"]["cloud"])
        one["cloud"] = max(rel_max(ca[k], cb[k]) for k in cb if cb[k].is_floating_point())
        ints_equal = all(torch.equal(ca[k].cpu(), cb[k]) for k in cb if not cb[k].is_floating_point())
        for k in ("film_massImpinged", "film_mass"):
            one[k] = rel_max(log[k], last[k])
        drip = [float(st["film"]["drippedMass"]) for st in (stepped, states["cpu"])]
        same_its = same_its and ints_equal
        extra = (f"; cloud {one['cloud']:.3e} (integer leaves equal {ints_equal}), impinged "
                 f"{one['film_massImpinged']:.3e}, film mass {one['film_mass']:.3e}; dripped "
                 f"since t = 0 {drip[0]:.9e} kg (card), {drip[1]:.9e} kg (CPU)")
    step_at = DRIFT_STEPS if which == "panel" else WET_DRIP_STEP
    say(13, f"{label}: step {step_at} on the card from the CPU's state (relative, bound "
            f"{STEP_TOL:g}): " + ", ".join(f"{k} {v:.3e}" for k, v in one.items()
                                            if k in ("T", "U", "solid", "film"))
            + f", iteration counts equal {same_its}{extra}")
    if not (max(one.values()) <= STEP_TOL and same_its):
        raise SystemExit(f"phase 13: the card's float64 step of the {which} fire differs from "
                         "the CPU's")
    if which == "wetted":
        if not min(drip) > 0.0:
            raise SystemExit("phase 13: the wetted panel fire's film never dripped")
        drip_injection_vs_cpu(dev, solvers["f64"].cloud.injectors[1],
                              solvers["cpu"].cloud.injectors[1])


def drip_injection_vs_cpu(dev, card_inj, cpu_inj):
    """FilmDripInjection (float64) on the card against the CPU's: the same
    drip flux on the film's gas-side faces (none, then some, then more),
    the same keys; release positions, velocities, sizes, cells, masses,
    the parcel count and the owed mass within DRIP_TOL."""
    rng = np.random.default_rng(4)
    nB = cpu_inj.geom.n_boundary
    sts = {"card": card_inj.init_state(), "cpu": cpu_inj.init_state()}
    worst, n_inj = 0.0, {}
    for k, scale in enumerate((0.0, 0.5, 2.0)):
        drip = np.zeros(nB)
        drip[cpu_inj.bidx] = scale * rng.uniform(0.0, 1.0, cpu_inj.bidx.size)
        fu = rng.normal(size=(nB, 3))
        out = {}
        for run, inj, d in (("card", card_inj, dev), ("cpu", cpu_inj, torch.device("cpu"))):
            f64 = dict(dtype=torch.float64, device=d)
            gas = {"film_drip_b": torch.as_tensor(drip, **f64),
                   "film_U_b": torch.as_tensor(fu, **f64)}
            sts[run], out[run] = inj.inject(sts[run], prng.PRNGKey(k),
                                            torch.tensor(0.0, **f64), torch.tensor(0.01, **f64),
                                            gas)
        for name in ("x", "U", "d", "mass"):
            worst = max(worst, rel_max(out["card"][name], out["cpu"][name]))
        for name in ("cell", "valid"):
            if not torch.equal(out["card"][name].cpu(), out["cpu"][name]):
                worst = float("inf")
        worst = max(worst, rel_max(sts["card"]["m_owed"], sts["cpu"]["m_owed"]))
        n_inj = {run: int(sts[run]["n_inj"]) for run in sts}
    say(13, f"FilmDripInjection float64 on {cpu_inj.bidx.size} film faces, card vs CPU over 3 "
            f"drip fluxes: parcels released {n_inj['card']}/{n_inj['cpu']}, largest relative "
            f"difference {worst:.3e} (bound {DRIP_TOL:g})")
    if not (n_inj["card"] == n_inj["cpu"] > 0 and worst <= DRIP_TOL):
        raise SystemExit("phase 13: the card's drip injection differs from the CPU's")


def phase_solid_only(tmp):
    """The solid-only case (solvePrimaryRegion false) through the run CLI on
    the card, then its engine on the card (float32) and on the CPU
    (float64): the solid's T within SOLID_F32_TOL."""
    case = write_pyrolysis_1d_case(os.path.join(tmp, "p1d"), n=N_SMALL)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_cli.main(["--case", case, "--max-steps", "20", "--chunk", "10", "--output",
                           os.path.join(tmp, "p1d_out")])
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("pyro_")]
    out = {}
    for run, d in (("card", "cuda"), ("cpu", "cpu")):
        s, st, _ = run_cli.run_case(case, max_steps=20, verbose=False, device=d)
        out[run] = (st["pyro"][0]["T"].double().cpu(), float(st["t"]))
    rel = float((out["card"][0] - out["cpu"][0]).abs().max() / out["cpu"][0].abs().max())
    say(13, f"solid-only case through the run CLI: exit {rc}, {len(lines)} region log lines, "
            f"last '{lines[-1] if lines else ''}'; 20 steps (t = {out['card'][1]:.6g} s card, "
            f"{out['cpu'][1]:.6g} s CPU): the solid's T max {float(out['card'][0].max()):.3f} K, "
            f"card float32 vs CPU float64 {rel:.3e} relative (bound {SOLID_F32_TOL:g})")
    if rc != 0 or not lines or not rel <= SOLID_F32_TOL:
        raise SystemExit("phase 13: the solid-only case failed or parts from the CPU's")


# ---------------------------------------------------------------- phase 14
def sum_log(log1, logs, key) -> float:
    """A step-log entry summed in float64 over the warm-up step and a chunk."""
    return float(log1[key]) + float(logs[key].double().sum())


def cone_injected(solver, state, elapsed):
    """The mass the cone injectors released by `state`: their mass rate over
    `elapsed` less what each still owes."""
    return sum(inj.mass_rate * elapsed - float(ist["m_owed"])
               for inj, ist in zip(solver.cloud.injectors, state["cloud"]["inj"]))


def phase_multiphase(dev, tmp, box_solver, box_state, box_ms):
    """The multiphase spray fire at 100k cells (see the module docstring);
    returns the launch counts of its run."""
    t_start = time.perf_counter()
    case = write_multiphase_spray_fire_case(os.path.join(tmp, "multi"), n=N_MAIN,
                                            pps=SPRAY_PPS, end_time=100.0)
    solver = FireFoamSolver(case, device=dev)
    cloud = solver.cloud
    state0 = solver.initial_state()
    step = solver.make_step()
    state1, log1 = step(state0)  # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    n = solver.geom.n_cells
    if cloud is None or cloud.cfg.capacity != SPRAY_CAPACITY or cloud.devol is None or \
            cloud.mppic is None or cloud.ledger is None:
        raise SystemExit("phase 14: the multiphase case did not build its cloud at the JAX "
                         "package's capacity with devolatilisation, MPPIC and the ledger")
    count0 = int(state1["rad"]["count"])
    chunk = solver.make_chunk(CHUNK)
    sweeps0 = solver.radiation.sweeps
    dia_krylov.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, logs = chunk(state1)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / CHUNK
    launches = dict(dia_krylov.LAUNCHES)
    exp_k1, exp_k2 = expected_launches(solver.radiation, count0, CHUNK)
    sweeps = solver.radiation.sweeps - sweeps0
    finite = all(bool(torch.isfinite(state[f].i).all()) for f in ("T", "U", "p_rgh", "Y", "k")) \
        and all(bool(torch.isfinite(v).all()) for v in spray_leaves(state["cloud"]).values()
                if v.is_floating_point())
    bad_logs = [k for k, v in logs.items() if not bool(torch.isfinite(torch.as_tensor(v)).all())]
    alive = int(logs["cloud_nParcels"][-1])
    # the liquid's ledger (phase 12's): injected + expansion = in the system
    # + evaporated + escaped + collected + dropped
    elapsed = float(log1["dt"]) + float(logs["dt"].double().sum())
    evap, esc, drop, expa = (sum_log(log1, logs, k) for k in (
        "cloud_massEvaporated", "cloud_massEscaped", "cloud_massDropped", "cloud_massExpansion"))
    coll = sum(float(c["mass"].sum()) for c in state["cloud"]["coll"])
    inside = float(logs["cloud_mass"][-1])
    inj = cone_injected(solver, state, elapsed)
    book = abs(inj + expa - (inside + evap + esc + coll + drop)) / inj
    # the volatiles' ledger: injected = held + devolatilised + carried out
    v_inj, v_dev, v_lost = (sum_log(log1, logs, k) for k in (
        "cloud_volatileInjected", "cloud_massDevolatilised", "cloud_volatileLost"))
    v_held = float(logs["cloud_volatileMass"][-1])
    vbook = abs(v_inj - (v_held + v_dev + v_lost)) / v_inj
    # the next step's devolatilised mass as the C3H8 equation receives it
    lg = {}
    _, out = solver._evolve_cloud(state, lg)
    gained = float((out["SY"][solver.gas.index("C3H8")].double() * solver.geom.V.double()).sum()
                   * float(state["dt"]))
    to_c3h8 = abs(gained - float(lg["cloud_massDevolatilised"])) / max(gained, 1e-300)
    live = state["cloud"]["alive"]
    v_held_frac = float(state["cloud"]["mv"][live].double().sum()
                        / state["cloud"]["mv0"][live].double().sum().clamp(min=1e-300))
    say(14, f"multiphase spray fire {n} cells float32 (capacity {cloud.cfg.capacity}, "
            f"{cloud.cfg.n_sub} substeps of a {cloud.cfg.walk_steps}-hop walk; setup + warm-up "
            f"{setup_s:.1f} s): {ms:.3f} ms/step over make_chunk({CHUNK}), t = "
            f"{float(state['t']):.4f} s, T max {float(state['T'].i.max()):.3f} K, parcels alive "
            f"{alive} (their volatiles {v_held_frac:.4f} of what they were injected with); "
            f"fields, cloud and logs finite {finite and not bad_logs} {bad_logs}")
    say(14, f"liquid since t = 0 [kg]: injected {inj:.6e} + expansion {expa:.6e} = in system "
            f"{inside:.6e} + evaporated {evap:.6e} + escaped {esc:.6e} + collected {coll:.6e} "
            f"+ dropped {drop:.6e}; relative gap {book:.3e} (bound {SPRAY_MASS_TOL:g})")
    say(14, f"volatiles since t = 0 [kg]: injected {v_inj:.6e} = held {v_held:.6e} + "
            f"devolatilised {v_dev:.6e} + carried out {v_lost:.6e}; relative gap {vbook:.3e} "
            f"(bound {VOLATILE_MASS_TOL:g}); the next step's devolatilised "
            f"{float(lg['cloud_massDevolatilised']):.6e} kg, the C3H8 equation's source "
            f"{gained:.6e} kg ({to_c3h8:.3e} apart, bound {SOURCE_TOL:g})")
    say(14, f"launches K1 {launches['bicgstab']} (expected {exp_k1}; fvDOM ray sweeps "
            f"{sweeps}), K2 {launches['pcg']} (expected {exp_k2}), K3 {launches['smooth']}")
    if not finite or bad_logs:
        raise SystemExit("phase 14: the multiphase spray fire is not finite")
    if not (alive > 0 and v_dev > 0.0 and gained > 0.0):
        raise SystemExit("phase 14: no parcel alive, or nothing devolatilised into the gas")
    if not (book <= SPRAY_MASS_TOL and vbook <= VOLATILE_MASS_TOL and to_c3h8 <= SOURCE_TOL):
        raise SystemExit("phase 14: a mass ledger of the multiphase spray does not close")
    if (launches["bicgstab"], launches["pcg"], launches["smooth"]) != (exp_k1, exp_k2, 0) or \
            sweeps != exp_k1 - 4 * CHUNK:
        raise SystemExit("phase 14: kernel launch counts do not match the solves")
    again, logs2 = chunk(state1)
    torch.cuda.synchronize()
    same = states_equal(again, state) and all(torch.equal(logs2[k], logs[k]) for k in logs)
    say(14, f"the same {CHUNK} steps again: states (mv, mv0, ms, key, MPPIC's draws included) "
            f"and logs bitwise equal: {same}")
    if not same:
        raise SystemExit("phase 14: two runs of the multiphase spray fire differ")
    del again
    _, k_multi, r_multi, busy_multi = step_profile(step, state, SPRAY_PROFILE_STEPS)
    k_box, r_box, busy_box = box_profile(box_solver, box_state)
    cst = state["cloud"]
    k_mppic, r_mppic, busy_mppic = profiled_call(
        lambda: cloud.mppic.apply(cst, solver.geom, state["dt"], prng.PRNGKey(0)))
    T_p = torch.clamp(cst["T"], min=cloud.cfg.T_min)
    gate = cst["alive"] & (cst["mv0"].sum(1) > 0)
    dt_sub = state["dt"] / cloud.cfg.n_sub
    k_dev, r_dev, busy_dev = profiled_call(lambda: [cloud.devol.calculate(
        dt_sub, T_p, cst["mv"], cst["mv0"], cst["canCombust"], gate)
        for _ in range(cloud.cfg.n_sub)])
    k_multi, busy_multi = max(k_multi, 1), max(busy_multi, 1e-9)
    say(14, f"per step at {n} cells float32 (torch.profiler over {SPRAY_PROFILE_STEPS} steps, "
            f"the box fire's over {PROFILE_STEPS}): box fire {box_ms:.3f} ms (phase 4), {k_box:.0f} launches, {r_box:.1f} host reads, "
            f"device busy {busy_box:.3f} ms; multiphase spray fire {ms:.3f} ms, {k_multi:.0f} "
            f"launches, {r_multi:.1f} host reads, device busy {busy_multi:.3f} ms "
            f"({100.0 * (1.0 - busy_multi / ms):.1f} % idle); MPPIC.apply {k_mppic} launches "
            f"({100.0 * k_mppic / k_multi:.1f} %), {r_mppic} host reads, {busy_mppic:.3f} ms "
            f"({100.0 * busy_mppic / busy_multi:.1f} %); Devolatilisation.calculate x "
            f"{cloud.cfg.n_sub} substeps {k_dev} launches ({100.0 * k_dev / k_multi:.1f} %), "
            f"{r_dev} host reads, {busy_dev:.3f} ms ({100.0 * busy_dev / busy_multi:.1f} %)")
    phase_spray_cli(case, tmp, 14, "multiphase", keys=("['mv']", "['mv0']", "['ms']"))
    say(14, f"multiphase spray fire at {n} cells: {time.perf_counter() - t_start:.1f} s")
    return launches


class _NoWalls:
    patches = []


def dem_lattice(dev):
    """PairCollision.collide alone on a jittered packed lattice of
    LATTICE parcels (every neighbour pair overlapping): ms per sub-cycle,
    the peak memory and the row-block size it chose, and the same call with
    LATTICE_BLOCK rows a block, bitwise equal."""
    from firefoam_torch.io import parse_string
    from firefoam_torch.lagrangian.paircollision import PairCollision

    pc = PairCollision.from_dict(parse_string(
        "collisionModel pairCollision; pairCollisionCoeffs { nSubCycles 2; pairModelCoeffs "
        "{ alpha 0.12; b 1.5; mu 0.52; cohesionEnergyDensity 0; } }"),
        parse_string("youngsModulus 1e5; poissonsRatio 0.35;"), _NoWalls())
    rng = np.random.default_rng(14)
    d = 2e-3
    idx = np.stack(np.meshgrid(*(np.arange(k) for k in LATTICE), indexing="ij"), -1)
    idx = idx.reshape(-1, 3)
    n = idx.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    st = {"x": torch.as_tensor(idx * 0.98 * d + rng.uniform(-0.01, 0.01, (n, 3)) * d, **f32),
          "U": torch.as_tensor(rng.normal(0.0, 0.05, (n, 3)), **f32),
          "d": torch.full((n,), d, **f32), "nP": torch.ones(n, **f32),
          "alive": torch.ones(n, dtype=torch.bool, device=dev)}
    cst = pc.init_state(n, torch.float32, dev)
    pc.collide(st, cst, 1000.0, 1e-5)  # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    a = pc.collide(st, cst, 1000.0, 1e-5)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / pc.sub_cycles
    peak = torch.cuda.max_memory_allocated(dev) - base
    rows = pc.last_block_rows
    pc.block_rows = LATTICE_BLOCK
    t0 = time.perf_counter()
    b = pc.collide(st, cst, 1000.0, 1e-5)
    torch.cuda.synchronize()
    ms_b = 1e3 * (time.perf_counter() - t0) / pc.sub_cycles
    same = all(torch.equal(a[0][k], b[0][k]) for k in ("x", "U")) and all(
        torch.equal(a[1][k], b[1][k]) for k in a[1])
    held = int((a[1]["rec_id"] >= 0).sum())
    say(14, f"PairCollision.collide alone, {n} parcels float32 in a jittered packed lattice "
            f"(partner records held {held}): {ms:.3f} ms a sub-cycle in blocks of {rows} rows, "
            f"peak memory {peak / 2 ** 30:.3f} GiB above the inputs; {ms_b:.3f} ms a sub-cycle "
            f"in blocks of {LATTICE_BLOCK} rows: bitwise equal {same}")
    if not (same and held > 0):
        raise SystemExit("phase 14: collide depends on its row-block size, or found no contact")
    return {"ms_per_subcycle": ms, "peak_bytes": peak, "block_rows": rows,
            "ms_per_subcycle_other_block": ms_b}


def phase_dem(dev, tmp):
    """The DEM spray at 100k cells and collide alone at 16,384 parcels;
    returns (the launch counts of the spray's run, the lattice's readings)."""
    t_start = time.perf_counter()
    case = write_dem_spray_fire_case(os.path.join(tmp, "dem"), n=N_MAIN, end_time=100.0)
    solver = FireFoamSolver(case, device=dev)
    cloud = solver.cloud
    if cloud is None or cloud.pair_collision is None or cloud.cfg.capacity != DEM_CAPACITY:
        raise SystemExit("phase 14: the DEM case did not build its pair collision at the JAX "
                         "package's capacity")
    state0 = solver.initial_state()
    step = solver.make_step()
    state1, log1 = step(state0)  # warm-up: the burst
    count0 = int(state1["rad"]["count"])
    chunk = solver.make_chunk(DEM_STEPS)
    dia_krylov.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, logs = chunk(state1)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / DEM_STEPS
    launches = dict(dia_krylov.LAUNCHES)
    exp_k1, exp_k2 = expected_launches(solver.radiation, count0, DEM_STEPS)
    finite = all(bool(torch.isfinite(state[f].i).all()) for f in ("T", "U", "p_rgh", "Y", "k")) \
        and all(bool(torch.isfinite(v).all()) for v in spray_leaves(state["cloud"]).values()
                if v.is_floating_point())
    bad_logs = [k for k, v in logs.items() if not bool(torch.isfinite(torch.as_tensor(v)).all())]
    # the same steps again, counting the partner records held after each
    # sub-cycle (a contact lasts about ten)
    pcm = cloud.pair_collision
    pcm.contacts = torch.zeros((), dtype=torch.int64, device=dev)
    again, logs2 = chunk(state1)
    held, pcm.contacts = int(pcm.contacts), None
    torch.cuda.synchronize()
    same = states_equal(again, state) and all(torch.equal(logs2[k], logs[k]) for k in logs)
    c1, c2 = state1["cloud"], state["cloud"]
    ux0 = c1["U"][c1["alive"], 0].cpu()
    ux1 = c2["U"][c2["alive"], 0].cpu()
    turned = ux0.numel() == 2 and ux1.numel() == 2 and bool(
        torch.all(torch.sign(ux1) == -torch.sign(ux0)))
    say(14, f"DEM spray {solver.geom.n_cells} cells float32 (capacity {cloud.cfg.capacity}, "
            f"{cloud.cfg.n_sub} substeps x {pcm.sub_cycles} sub-cycles of the dense pair "
            f"matrix in blocks of {pcm.last_block_rows} rows): {ms:.3f} ms/step over "
            f"make_chunk({DEM_STEPS}), t = {float(state['t']):.4f} s; partner records held "
            f"over the sub-cycles {held}; the drops' x velocities "
            f"{[round(v, 4) for v in ux0.tolist()]} -> {[round(v, 4) for v in ux1.tolist()]} "
            f"m/s, turned round {turned}; finite {finite and not bad_logs} {bad_logs}; "
            f"launches K1 {launches['bicgstab']} (expected {exp_k1}), K2 {launches['pcg']} "
            f"(expected {exp_k2}), K3 {launches['smooth']}; the same steps again bitwise "
            f"equal {same}")
    if not finite or bad_logs:
        raise SystemExit("phase 14: the DEM spray is not finite")
    if not (held > 0 and turned):
        raise SystemExit("phase 14: the DEM drops never met")
    if (launches["bicgstab"], launches["pcg"], launches["smooth"]) != (exp_k1, exp_k2, 0):
        raise SystemExit("phase 14: kernel launch counts do not match the solves")
    if not same:
        raise SystemExit("phase 14: two runs of the DEM spray differ")
    del again, solver, state, state0, state1
    say(14, f"DEM spray at 100k cells: {time.perf_counter() - t_start:.1f} s")
    return launches, dem_lattice(dev)


# the stock injectors' dictionaries and the files they read, for the card
# against the CPU on one mesh (the kinds of injection_stock.STOCK_KINDS)
_STOCK_FILES = {
    "positions": "3\n(\n(0.1 0.1 0.1)\n(0.5 0.5 0.5)\n(0.9 0.85 0.9)\n)\n",
    "parcelData": "(\n((0.2 0.2 0.2) (0 -1 0) 1e-3 1000 0.02)\n"
                  "((0.6 0.6 0.6) (0 -2 0) 2e-3 1000 0.04)\n)\n",
    "thermoTab": "2\n(\n((0.5 0.9 0.5) (0 -1 0) 0.0010 1000 0.05 342.0 4100.0)\n"
                 "((0.4 0.8 0.4) (0 -1 0) 0.0008 1000 0.03 361.0 4200.0)\n)\n",
    "reactTab": "1\n(\n((0.5 0.9 0.5) (0 -1 0) 0.0010 1000 0.05 350.0 4100.0 (1.0))\n)\n",
    "multiTab": "1\n(\n((0.5 0.9 0.5) (0 -1 0) 0.0010 1000 0.05 335.0 4100.0 "
                "(0.25 0.55 0.20) (1.0) (1.0) (1.0))\n)\n",
}
_RR = ("sizeDistribution { type RosinRammler; RosinRammlerDistribution { minValue 1e-4; "
       "maxValue 1e-3; d 4e-4; n 3; } }")
_STOCK_KINDS = {
    "manualInjection": "SOI 0.05; massTotal 0.3; positionsFile \"positions\"; U0 (0 -1 0); " + _RR,
    "cellZoneInjection": "SOI 0; cellZone z1; numberDensity 1500; massTotal 0.05; "
                         "U0 (0 0.5 0); " + _RR,
    "fieldActivatedInjection": "SOI 0; massTotal 0.06; factor 1.0; referenceField p; "
                               "thresholdField pMin; nParcelsPerInjector 2; positionsFile "
                               "\"positions\"; U0 (0 0 0); " + _RR,
    "kinematicLookupTableInjection": "SOI 0; duration 1; parcelsPerSecond 20; "
                                     "inputFile \"parcelData\";",
    "thermoLookupTableInjection": "SOI 0; duration 5; parcelsPerSecond 70; "
                                  "inputFile \"thermoTab\";",
    "reactingLookupTableInjection": "SOI 0; duration 5; parcelsPerSecond 70; "
                                    "inputFile \"reactTab\";",
    "reactingMultiphaseLookupTableInjection": "SOI 0; duration 5; parcelsPerSecond 70; "
                                              "inputFile \"multiTab\";",
    "coneNozzleInjection": "SOI 0; duration 1; massTotal 0.1; parcelsPerSecond 100; "
                           "position (0.5 0.9 0.5); direction (0.1 -1 0); outerDiameter 0.2; "
                           "innerDiameter 0.05; Cd constant 0.9; thetaInner constant 0; "
                           "thetaOuter constant 30; flowRateProfile constant 1; " + _RR,
    "none": "",
    "noInjection": "",
    "inflationInjection": "SOI 0; duration 1; cellZone z1; flowRate constant 1e-5; "
                          "growthRate constant 5e-3; dSeed 1e-4; parcelsPerSecond 50; "
                          "rhoInjection 1000; " + _RR,
}


def stock_injectors_vs_cpu(dev, case, solvers):
    """Every stock injector in float64 on the card against the CPU's, on the
    9k mesh: 6 steps of inject from the same key chain (the fieldActivated
    gate closed, then open in half the cells): candidates and injector
    states within STEP_TOL, cells and masks equal."""
    from firefoam_torch.io import Case, parse_string
    from firefoam_torch.lagrangian.injection import make_injector

    for name, txt in _STOCK_FILES.items():
        with open(os.path.join(case, "constant", name), "w") as f:
            f.write(txt)
    nC = solvers["cpu"].geom.n_cells
    zones = {"z1": np.arange(0, nC, 7)}
    rng = np.random.default_rng(3)
    worst, fired = 0.0, {}
    for kind, body in _STOCK_KINDS.items():
        spec = parse_string(f"type {kind}; {body}")
        injs = {run: make_injector("inj", spec, solvers[run].cloud.walk, Case(case),
                                   torch.float64, geom=solvers[run].geom, cell_zones=zones)
                for run in ("f64", "cpu")}
        for inj in injs.values():
            inj.max_per_step = inj.capacity_for_dt(0.1)
        sts = {run: inj.init_state() for run, inj in injs.items()}
        key, n_valid = prng.PRNGKey(11), 0
        for i in range(6):
            key, k = prng.split(key)
            p = np.full(nC, 1e5) + (2e5 * (rng.uniform(size=nC) < 0.5) if i >= 2 else 0.0)
            out = {}
            for run, d in (("f64", dev), ("cpu", torch.device("cpu"))):
                f64 = dict(dtype=torch.float64, device=d)
                gas = {"p": torch.as_tensor(p, **f64), "pMin": torch.full((nC,), 2e5, **f64)}
                sts[run], out[run] = injs[run].inject(sts[run], k, torch.tensor(i * 0.05, **f64),
                                                      torch.tensor(0.05, **f64), gas)
            for kk, v in list(out["cpu"].items()) + [(f"state/{a}", b) for a, b in
                                                     sts["cpu"].items()]:
                mine = out["f64"][kk] if not kk.startswith("state/") else sts["f64"][kk[6:]]
                if v.is_floating_point():
                    worst = max(worst, rel_max(mine, v))
                elif not torch.equal(mine.cpu(), v):
                    worst = float("inf")
            n_valid += int(out["cpu"]["valid"].sum())
        fired[kind] = n_valid
    say(14, f"the {len(_STOCK_KINDS)} stock injectors float64, card vs CPU over 6 steps: "
            f"parcels {fired}; largest relative difference {worst:.3e} (bound {STEP_TOL:g})")
    if not worst <= STEP_TOL or any(v == 0 for k, v in fired.items()
                                    if k not in ("none", "noInjection")):
        raise SystemExit("phase 14: a stock injector on the card differs from the CPU's")


def phase_stock_small(dev, tmp):
    """Both fires at 9k cells against the CPU (phase 12's lockstep), the DEM
    spray cut to DEM_SMALL_CAPACITY slots; then every stock injector."""
    multi = write_multiphase_spray_fire_case(os.path.join(tmp, "multi_small"), n=N_SMALL,
                                             pps=SPRAY_PPS_SMALL)
    # its parcels carry fuel: where float32's own draws put them (R11) the
    # devolatilised propane burns elsewhere, so the band holds the float32
    # run with float64's draws rounded
    solvers = phase_spray_small(dev, multi, 14, "multiphase spray fire", aligned_draws=True)
    dem = write_dem_spray_fire_case(os.path.join(tmp, "dem_small"), n=N_SMALL)
    phase_spray_small(dev, dem, 14, f"DEM spray ({DEM_SMALL_CAPACITY} slots)",
                      capacity=DEM_SMALL_CAPACITY)
    stock_injectors_vs_cpu(dev, multi, solvers)


# ---------------------------------------------------------------- phase 15
def comm_per_step(out) -> dict:
    """Rank 0's collectives a step (mean over the run's steps): calls and
    bytes sent per kind, and the bytes staged through the host."""
    reps = out["comm"][0]
    n = len(reps)
    kinds = reps[0]["counts"]
    per = {k: {"calls": sum(r["counts"][k]["calls"] for r in reps) / n,
               "bytes": sum(r["counts"][k]["bytes"] for r in reps) / n} for k in kinds}
    staged = sum(r["staged"]["bytes"] for r in reps) / n
    return {"collectives": per, "staged_bytes": staged}


def comm_text(c) -> str:
    parts = [f"{k} {v['calls']:.0f} ({v['bytes'] / 1e6:.3f} MB)"
             for k, v in c["collectives"].items() if v["calls"]]
    return ", ".join(parts) + f"; staged through the host {c['staged_bytes'] / 1e6:.3f} MB"


def shard_rel(got, ref) -> dict:
    """Per field, max |a − b| / max |b| of the gathered state against the
    single card's."""
    out = {}
    for f in SHARD_FIELDS:
        a = np.asarray(got[f].i, np.float64)
        b = ref[f].i.detach().cpu().double().numpy()
        out[f] = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
    return out


def seed_crossing_parcels(sp, state, n=120):
    """tests/test_spmd_cloud.py's seeding: n parcels across the domain with
    velocities that cross partition boundaries."""
    cst = dict(state["cloud"])
    rng = np.random.RandomState(3)
    C = sp.gg.C.numpy()
    cells = rng.choice(len(C), n, replace=False)
    U = np.zeros((n, 3))
    U[:, 0] = 1.5 * np.sign(rng.randn(n))
    U[:, 2] = 1.0 * np.sign(rng.randn(n))

    def setcap(a, v):
        a = a.clone()
        a[:n] = torch.as_tensor(np.asarray(v), dtype=a.dtype, device=a.device)
        return a

    cst.update(x=setcap(cst["x"], C[cells]), U=setcap(cst["U"], U), d=setcap(cst["d"], 5e-4),
               nP=setcap(cst["nP"], 10.0), T=setcap(cst["T"], 310.0),
               cell=setcap(cst["cell"], cells), alive=setcap(cst["alive"], True))
    state = dict(state)
    state["cloud"] = cst
    return state


def shard_box_f64(dev, main_case):
    """The box fire in SHARD_P RCB parts, float64: one step from the single
    card's SEG flat state after SHARD_WARM steps, and the same step again;
    returns (the run, the readings, the initial state, the state stepped
    from)."""
    from firefoam_torch.parallel.spmd_step import SpmdFireFoam

    t0 = time.perf_counter()
    sp = SpmdFireFoam(main_case, SHARD_P, dtype=torch.float64, device=dev,
                      backend=SHARD_BACKEND, partition="auto")
    ref = sp.ref
    state0 = ref.initial_state()
    state = state0
    for _ in range(SHARD_WARM):
        state, _ = ref.step(state)
    state1, log1 = ref.step(state)
    out = sp.run(state, 1, deadline_s=SHARD_DEADLINE, repeat=True)
    rel = shard_rel(out["state"], state1)
    its = {k: (int(out["logs"][0][k]), int(log1[k])) for k in SHARD_ITERS}
    c = comm_per_step(out)
    say(15, f"box fire {ref.geom.n_cells} cells in {SHARD_P} {sp.partition.upper()} parts "
            f"({SHARD_BACKEND}, ranks on {dev}, CUDA payloads staged through host buffers), "
            f"float64, one step from the single card's SEG flat state after {SHARD_WARM} "
            f"steps: relative differences {rel} (bound {SHARD_TOL:g}); iterations "
            f"(partitioned, single) {its}; collectives a step {comm_text(c)}; the same step "
            f"again bitwise equal {out['repeat_equal']}; K1-K3 launches {out['kernel_launches']}")
    if sp.partition != "rcb" or out["p_solver"] != "flat":
        raise SystemExit("phase 15: the 100k box in 4 parts did not take RCB and the flat CG")
    if max(rel.values()) > SHARD_TOL or any(a != b for a, b in its.values()):
        raise SystemExit("phase 15: the partitioned step departs from the single card's")
    if not out["repeat_equal"]:
        raise SystemExit("phase 15: two runs of the partitioned step differ")
    say(15, f"box fire float64 in {SHARD_P} parts: {time.perf_counter() - t0:.1f} s")
    readings = {"rel": rel, "iterations": its, **c, "repeat_equal": out["repeat_equal"]}
    return out, readings, state0, state


def shard_box_f32(dev, main_case, state, main_ms):
    """The box fire in SHARD_P RCB parts, float32, SHARD_F32_STEPS steps
    timed (the last one profiled) from `state`."""
    from firefoam_torch.parallel.spmd_step import SpmdFireFoam

    t0 = time.perf_counter()
    sp = SpmdFireFoam(main_case, SHARD_P, dtype=torch.float32, device=dev,
                      backend=SHARD_BACKEND, partition="auto", build_ref=False)
    out = sp.run(state, SHARD_F32_STEPS, deadline_s=SHARD_DEADLINE, profile=True)
    secs = out["seconds"]
    ms = 1e3 * float(np.mean(secs[1:-1]))
    busy = out["busy_ms"][-1] if out["busy_ms"] else float("nan")
    c = comm_per_step(out)
    g = out["state"]
    finite = all(np.isfinite(np.asarray(g[f].i)).all() for f in ("T", "U", "p_rgh"))
    its = [[int(lg["p_rgh_iters_0"]), int(lg["p_rgh_iters_1"])] for lg in out["logs"]]
    say(15, f"box fire float32 in {SHARD_P} parts, {SHARD_F32_STEPS} steps: "
            f"{ms:.3f} ms/step over steps 2-{SHARD_F32_STEPS - 1} (rank 0; steps "
            f"{[round(1e3 * x, 1) for x in secs]} ms, the first warms up, the last is "
            f"profiled), device busy {busy:.3f} ms on rank 0 in the profiled step; phase 4's "
            f"single-card DIA box fire {main_ms:.3f} ms/step; collectives a step "
            f"{comm_text(c)}; p_rgh iterations {its}; finite {finite}; rank setup "
            f"{out['setup_seconds']:.1f} s")
    if not finite:
        raise SystemExit("phase 15: the float32 partitioned run is not finite")
    say(15, f"box fire float32 in {SHARD_P} parts: {time.perf_counter() - t0:.1f} s")
    return out, {"ms_per_step": ms, "step_ms": [1e3 * x for x in secs], "device_busy_ms": busy,
                 "single_card_dia_ms": main_ms, **c}


def tight_case(root: str) -> str:
    """The 100k box fire with every linear solve taken to SHARD_TIGHT_TOL
    (relTol 0, maxIter 1000)."""
    case = write_box_fire_case(root, n=N_MAIN)
    path = os.path.join(case, "system", "fvSolution")
    with open(path) as f:
        text = f.read()
    text = re.sub(r"tolerance [0-9.eE+-]+", f"tolerance {SHARD_TIGHT_TOL:g}", text)
    text = re.sub(r"relTol [0-9.eE+-]+", "relTol 0", text)
    text = re.sub(r"maxIter [0-9]+", "maxIter 1000", text)
    with open(path, "w") as f:
        f.write(text)
    return case


def slab_vs_single(dev, case, start):
    """The box fire `case` in two z-slabs (the sharded lattice multigrid on
    p_rgh), SHARD_GMG_STEPS float64 steps from `start` (a SEG state of the
    case at t = 0), against the single card's DIA lattice multigrid from its
    own initial state: (the partitioned run, its partition, the largest
    differences per step, the p_rgh iterations per step, the single run's
    field scales)."""
    from firefoam_torch.parallel.spmd_step import SpmdFireFoam

    f64 = torch.float64
    sp = SpmdFireFoam(case, 2, dtype=f64, device=dev, backend=SHARD_BACKEND,
                      partition="auto", gmg=SHARD_GMG, build_ref=False)
    out = sp.run(start, SHARD_GMG_STEPS, deadline_s=SHARD_DEADLINE, every_step=True)
    s1 = FireFoamSolver(case, device=dev, dtype=f64, layout="dia", gmg=True)
    if sp.partition != "slab" or out["p_solver"] != "sharded_gmg" or s1.gmg is None:
        raise SystemExit("phase 15: the two z-slabs did not run the sharded multigrid")
    st1 = s1.initial_state()
    pairs, steps = [], []
    for k in range(SHARD_GMG_STEPS):
        st1, lg = s1.step(st1)
        pairs.append([(int(out["logs"][k][key]), int(lg[key]))
                      for key in ("p_rgh_iters_0", "p_rgh_iters_1")])
        steps.append({f: float(np.abs(np.asarray(out["states"][k][f].i)
                                      - st1[f].i.cpu().numpy()).max()) for f in SHARD_GMG_TOL})
    scale = {f: float(st1[f].i.abs().max()) for f in SHARD_GMG_TOL}
    return out, sp, steps, pairs, scale


def shard_slab(dev, tmp, main_case, start):
    """The box fire in two z-slabs against the single card's DIA lattice
    multigrid (slab_vs_single): at the case's tolerances from `start` (the
    SEG flat solver's initial state), the p_rgh iterations within
    test_spmd_gmg.py's bounds; with every solve at SHARD_TIGHT_TOL, the
    fields within that test's bounds."""
    t0 = time.perf_counter()
    out, sp, steps, pairs, scale = slab_vs_single(dev, main_case, start)
    c = comm_per_step(out)
    say(15, f"box fire in 2 {sp.partition} parts, p_rgh by the {out['p_solver']} "
            f"(slab dims {sp.lz.slab_dims}), float64, {SHARD_GMG_STEPS} steps from t = 0 "
            f"against the single card's DIA lattice multigrid at the case's tolerances: p_rgh "
            f"iterations (partitioned, single) {pairs} (bounds: at most 25, at most the single "
            f"run's + 15); max differences per step {steps} (the fields' largest values "
            f"{scale}); collectives a step {comm_text(c)}")
    if any(a > 25 or a > b + 15 for step in pairs for a, b in step):
        raise SystemExit("phase 15: the sharded multigrid's p_rgh iterations are out of bounds")
    tight = tight_case(os.path.join(tmp, "box_tight"))
    # the partitioned run starts from the SEG flat solver's state, as above
    start_t = FireFoamSolver(tight, device=dev, dtype=torch.float64, layout="seg",
                             exact_solvers=False, gmg=False, amg=False).initial_state()
    out_t, _, steps_t, pairs_t, _ = slab_vs_single(dev, tight, start_t)
    dif = steps_t[-1]
    say(15, f"the same with every linear solve at tolerance {SHARD_TIGHT_TOL:g} (relTol 0) on "
            f"both sides: max differences per step {steps_t} (bounds {SHARD_GMG_TOL}, test_spmd_"
            f"gmg.py's); p_rgh iterations (partitioned, single) {pairs_t}")
    if any(d[f] >= SHARD_GMG_TOL[f] for d in steps_t for f in d):
        raise SystemExit("phase 15: the sharded multigrid run is out of its bounds")
    say(15, f"box fire in two z-slabs: {time.perf_counter() - t0:.1f} s")
    return [out, out_t], {
        "case_tolerance": {"max_diff_per_step": steps, "p_rgh_iterations": pairs, **c},
        "tight": {"tolerance": SHARD_TIGHT_TOL, "max_diff": dif, "max_diff_per_step": steps_t,
                  "bounds": SHARD_GMG_TOL, "p_rgh_iterations": pairs_t}}


def shard_spray(dev, tmp):
    """The sprinkler fire in SHARD_P parts, SHARD_SPRAY_STEPS float64 steps
    against the single card's SEG flat run."""
    from firefoam_torch.parallel.spmd_step import SpmdFireFoam

    t0 = time.perf_counter()
    case = write_spray_fire_case(os.path.join(tmp, "spray15"), n=N_MAIN, pps=SPRAY_PPS,
                                 end_time=100.0)
    sp = SpmdFireFoam(case, SHARD_P, dtype=torch.float64, device=dev, backend=SHARD_BACKEND,
                      partition="auto")
    seeded = False
    start = sp.ref.initial_state()
    while True:
        out = sp.run(start, SHARD_SPRAY_STEPS, deadline_s=SHARD_DEADLINE)
        if sum(int(lg["cloud_migrated"]) for lg in out["logs"]) > 0 or seeded:
            break
        seeded = True
        start = seed_crossing_parcels(sp, start)
    st = start
    rows = []
    for k in range(SHARD_SPRAY_STEPS):
        st, lg = sp.ref.step(st)
        got = out["logs"][k]
        rows.append((int(got["cloud_nParcels"]), int(lg["cloud_nParcels"]),
                     abs(got["cloud_mass"] - float(lg["cloud_mass"]))
                     / max(abs(float(lg["cloud_mass"])), 1e-300),
                     int(got["cloud_migrated"]), int(got["cloud_migrOverflow"])))
    alive = out["alive_per_rank"]
    c = comm_per_step(out)
    say(15, f"sprinkler fire {sp.ref.geom.n_cells} cells in {SHARD_P} {sp.partition.upper()} "
            f"parts, float64, {SHARD_SPRAY_STEPS} steps{' (parcels seeded across the parts: '
            'none crossed unseeded)' if seeded else ''}: per step (parcels partitioned, single, "
            f"spray mass relative difference, migrated, overflow) {rows} (mass bound "
            f"{SHARD_MASS_TOL:g}); parcels alive per rank {alive}; collectives a step "
            f"{comm_text(c)}")
    if any(a != b or m > SHARD_MASS_TOL or o != 0 for a, b, m, _, o in rows):
        raise SystemExit("phase 15: the partitioned spray departs from the single card's")
    if not (sum(r[3] for r in rows) > 0 and sum(a > 0 for a in alive) > 1):
        raise SystemExit("phase 15: no parcel migrated, or the parcels sit on one rank")
    say(15, f"sprinkler fire in {SHARD_P} parts: {time.perf_counter() - t0:.1f} s")
    return out, {"steps": rows, "alive_per_rank": alive, "seeded": seeded, **c}


def phase_partitions(dev, tmp, main_case, main_ms):
    """Phase 15 (see the module docstring); returns (the kernels' launches
    summed over the partitioned runs, the readings for the JSON line)."""
    readings = {"backend": SHARD_BACKEND, "ranks_on": str(dev)}
    out, readings["box_f64"], state0, state = shard_box_f64(dev, main_case)
    runs = [out]
    out, readings["box_f32"] = shard_box_f32(dev, main_case, state, main_ms)
    runs.append(out)
    outs, readings["slab_gmg"] = shard_slab(dev, tmp, main_case, state0)
    runs.extend(outs)
    out, readings["spray"] = shard_spray(dev, tmp)
    runs.append(out)
    launches = {k: sum(r["kernel_launches"][k] for r in runs) for k in ("bicgstab", "pcg", "smooth")}
    return launches, readings


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = card_line()
    say(1, f"device {name}; nvidia-smi: {card}")

    say(2, f"kernels built and loaded in {dia_krylov.build_seconds():.2f} s "
           f"from {SOURCE}")

    G, sync_s = phase_sync()
    stats = phase_kernels(dev, G, sync_s)

    with tempfile.TemporaryDirectory(prefix="firefoam_smoke_") as tmp:
        main_case = write_box_fire_case(os.path.join(tmp, "main"), n=N_MAIN)
        main_solver, main_state, main_ms = phase_main(dev, main_case)
        small_case = write_box_fire_case(os.path.join(tmp, "small"), n=N_SMALL)
        phase_drift(dev, small_case)
        launches = phase_cli(tmp)
        gmg_launches, solve_ms = phase_gmg(dev, tmp, main_case, main_solver, main_state,
                                           small_case)
        phase_exact(dev, tmp, small_case)
        wall_launches = phase_wall(dev, tmp, main_solver, main_state, main_ms)
        phase_wall_baffle(dev, tmp)
        rad_runs = phase_radiation(dev, tmp, main_solver, main_state, main_ms, sync_s)
        banded = rad_runs["wsggBand"]
        castel_launches, castel = phase_castellated(dev, tmp, main_case, main_solver,
                                                    main_state, main_ms)
        spray_launches = phase_spray(dev, tmp, main_solver, main_state, main_ms)
        region_launches = phase_regions(dev, tmp, main_solver, main_state, main_ms)
        multi_launches = phase_multiphase(dev, tmp, main_solver, main_state, main_ms)
        del main_solver, main_state
        dem_launches, lattice = phase_dem(dev, tmp)
        phase_stock_small(dev, tmp)
        shard_launches, shards = phase_partitions(dev, tmp, main_case, main_ms)

    kernels = [
        {
            "name": name_k,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name_k],
            "launches": launches[name_k],  # the slice through the run CLI (phase 6)
            "launches_multigrid_path": gmg_launches[name_k],  # phase 7's 100k-cell run
            "launches_wall_fire_path": wall_launches[name_k],  # phase 9's 100k-cell run
            # phase 10's 100k-cell banded fvDOM run
            "launches_radiation_path": banded["launches"][name_k],
            # phase 11's 117k-cell castellated run: no kernel serves SEG
            "launches_castellated_path": castel_launches[name_k],
            # phase 12's 100k-cell sprinkler fire: the spray runs no kernel of
            # its own; K1 and K2 serve its gas step and its fvDOM rays
            "launches_spray_path": spray_launches[name_k],
            # phase 13's 100k-cell wetted panel fire: the regions run no
            # kernel of their own; K1 and K2 serve its gas step and its rays
            "launches_region_path": region_launches[name_k],
            # phase 14's 100k-cell multiphase spray fire and DEM spray: the
            # stock submodels run no kernel of their own; K1 and K2 serve
            # their gas steps and rays
            "launches_multiphase_path": multi_launches[name_k],
            "launches_dem_path": dem_launches[name_k],
            # phase 15's partitioned runs, summed over the ranks: the
            # partitions are SEG, where no kernel serves
            "launches_sharded_path": shard_launches[name_k],
            "max_abs_err": stats[name_k]["max_abs_err"],
            "ms": stats[name_k]["ms"],
            "plain_ms": stats[name_k]["plain_ms"],
            "bound_ms": stats[name_k]["bound_ms"],
            "bound_by": stats[name_k]["bound_by"],
            "library_ms": None,  # no single PyTorch call solves these systems
            "latency_ms": stats[name_k]["latency_ms"],
            "us_per_iteration": stats[name_k]["us_per_iteration"],
            "blocks": stats[name_k]["blocks"],
            "grid_sync_us": 1e6 * sync_s,
        }
        for name_k in ("bicgstab", "pcg", "smooth")
    ]
    # K1 on the wall fire's 5-row species batch and the banded fvDOM's 128
    # and 160 rows (phase 3), and in the banded radiation step (phase 10)
    for B in (5,) + BANDED_ROWS:
        kernels[0].update({f"{k}_B{B}": v for k, v in stats["bicgstab"][f"B{B}"].items()})
    kernels[0].update(radiation_solves={
        m: dict(r["solve"], in_step_ms=r["k1_step_ms"]) for m, r in rad_runs.items()})
    if not all(k["launches"] > 0 for k in kernels):
        raise SystemExit("a kernel of the slice was never launched")
    p_rgh = {str(n): {k: {"ms": v[0], "iterations": v[1]} for k, v in t.items()}
             for n, t in sorted(solve_ms.items())}
    print(json.dumps({"p_rgh_solve": p_rgh}))
    print(json.dumps({"castellated": castel}))
    print(json.dumps({"dem_collide": lattice}))
    print(json.dumps({"partitions": shards}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
