#!/usr/bin/env python3
"""Smoke run of castro_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase: the whole run
    python3 chip_smoke.py K          # the build, then the phases named (kernels,
                                     # A-N, probes, timing); no kernel table

From the root of a checkout, on a machine with one card and the CUDA
toolkit. Each phase is one function of main() over its shared state. In
order:
  1. print the card (nvidia-smi name and power limit, torch's name, count);
  2. build the twelve CUDA kernels (the nine of the step and the three
     profiling probes) from castro_tpu_torch/csrc and print each compiled
     kernel's registers, stack, shared memory and spills (ptxas -v), every
     direction and variant of trace_ppm and ctu_face among them, and
     fail unless prim_aux, flatten, clean_fill, consup (its march and rows
     kernels) and every probe_vpu body have no stack and no spills;
  3. hold each kernel against its plain PyTorch version on the card, at the
     main paths' shapes (3D Sedov 128^3 interior, 136^3 grown; 2D Sedov
     4096^2, 4104^2 grown; 1D Sod 4096; float32), and on the branches the
     main paths do not take (at 136^3 too for the face kernels' srcQ, the
     trace without the solve, ctu_face's terms=[], one corner along either
     axis and final without consup), at 32^3 and 64^2 (HLLC, wall masks,
     symmetry/periodic/no-slip fills, prim_aux without div u, both reset
     flags of trans_apply), at a grid of prime extents that cuts the face
     kernels' tiles raggedly (RAGGED, with wall faces), and cmpflx and
     trans_cmpflx with coord 1 and 2 at the RZ and spherical paths' shapes;
     and every step kernel, on the prime grid in float32 and float64, at the
     reacting layouts (LAYOUTS: 7, 13 and 19 species, the shock flag, hybrid
     momenta, an aux component);
  4. drive the main paths through Simulation(...).run() on the card, each
     with every launch count zeroed just before and read just after and
     checked against the step's structure, with mass conservation and a
     small run on the card held against the same run on the CPU:
       A  3D Sedov 128^3, the fused kernel structure;
       B  3D Sedov 128^3 with riemann_solver=1 and 64^3 with
          hybrid_riemann=1 (some zones must be flagged as shocks): the
          unfused structure (trace, trans_apply x18, consup x3);
       C  2D Sedov 4096^2 (cmpflx x2, trans_cmpflx x2) and 1D Sod n=1024
          to t=0.2 (cmpflx), held against the exact Riemann solution;
       D  3D Sedov 128^3 with PLM (ctu_face x9: three 1D solves, three
          corner pairs, three finals with consup) and with the positivity
          flux limiter (the finals without consup, the update in torch
          ops); speed_limit and transverse_use_eos at 32^3, card vs CPU;
       E  2D RZ Sedov 2048 x 4096 (cmpflx x4 with coord=1, all else torch
          ops), and RZ 512 x 1024 and 1D spherical n=512 to t=0.01 (cmpflx
          x1 with coord=2), the RZ midplane held against the spherical run;
       F  2D double Mach reflection (inflow with its fill hook, HLLC, cfl
          0.9): 128 x 32 to t=0.05 with the checks of
          tests/test_double_mach.py, 2048 x 512 timed; the 2D acoustic pulse
          card vs CPU;
       G  two-level AMR (AmrSimulation.run: windows, subcycling, refluxing,
          avgDown, regrids every 2 steps): 3D Sedov 128^3 + 1 level for 10
          coarse steps, 2D Sedov 1024^2 + 1 level for 5, 1D Sod n=256 + 1
          level to t=0.2 against the exact solution; launch counts against
          the hierarchy's structure (tried level steps, avgDowns, windows
          made), the kernels held on the level-1 window's state, and a
          32^3 / 64^2 / 256 run on the card against the CPU with equal
          windows and masks;
       H  Strang-split reactions (a half-dt burn and clean + fill before
          the hydro step and after it), the kernels first held on the
          blob's state: the 3D burning blob (iso7, 64^3)
          with the gamma law in float32 (path A's kernels at NPASS = 7,
          clean_fill after each burn) and with Helmholtz in float64 (the
          face kernels; prim_aux and clean_fill are torch ops, as in JAX),
          each with its time a step (the mean of the steps after init), burn
          time, iterations, energy released, mass balanced against the
          boundary outflow and a device-only profile, and an 8^3 copy on the
          card against the CPU (float32 against float64 within 1e-4, float64
          at 1e-8); the 1D detonation (powerlaw, n=512, cmpflx at NPASS = 3)
          with tests/test_problems.py's checks, the fuel it burnt held against
          the same steps on the CPU, cmpflx held on its final state, and n=64
          card vs CPU; aprox19 with Helmholtz, one react() on 32^3 at T =
          3e9, card vs CPU;
       I  self-gravity (the multigrid in torch ops, the gravity source and
          its corrector, the sponge; a step runs prim_aux twice, once
          without div u, the source-traced trace_ppm and clean_fill twice),
          the kernels first held on the state after a DustCollapse step: I3,
          the 3D DustCollapse (PoissonGrav, float32, fixed dt) at 128^3 with
          launch counts, two Poisson solves a step (V-cycles and residuals
          printed), mass against the boundary outflow and the centre's
          density rising, 32^3 card vs CPU (float64; float32 against
          float64), the uniform sphere against its analytic field, and 256^3
          timed with its gravity share and a device-only profile; I1, the 1D
          spherical DustCollapse (MonopoleGrav, float64) to 0.6 t_ff with
          tests/test_convergence.py's checks; IF, the full-physics blob
          (burning_blob physics="full": + Poisson gravity and the sponge) at
          64^3, one step with its burn and gravity shares, 8^3 card vs
          CPU; IG, composite gravity on two levels (a 3D blob 64^3 + one
          level timed, phi_sync_resid; 2D 32^2 card vs CPU);
       J  flame_wave and the surface-burning setups (thermal diffusion,
          rotation, the HSE fill hook, the initial models, aprox13, rprox,
          nova and powerlaw with Helmholtz or the gamma law), float64:
          cmpflx and trans_cmpflx first held bit for bit on the initial
          states of flame_wave (NPASS = 13), xrb_mixed (10) and nova (14);
          J-fw, flame_wave at N_FW (256 x 128) for STEPS_FW steps after
          init_data with its init time, ms a step, zones/s, the burn's and
          the conduction's shares, the HSE fill's time a step, peak
          memory and a device-only profile, and 32 x 16 card vs CPU after
          one step; J-hse, hse_convergence at n = 64 and 128 to t = 1, the
          residual velocity falling with resolution; J-sci, toy_flame,
          convective_flame, reacting_bubble, xrb_mixed and nova at the
          JAX package's default sizes for STEPS_SCI steps, convective_flame
          (128 x 96) and xrb_mixed (N_XRB_CPU, 32 x 96) card vs CPU after
          one step;
       K  the spherical and convecting science setups (subch, aprox21, the
          NSE bypass, multigamma, MonopoleGrav and PoissonGrav in RZ),
          float64: cmpflx and trans_cmpflx first held bit for bit on seeded
          faces at NPASS 3, 17, 19 and 21 (Cartesian and curvilinear) and on
          the states of subchandra (17) and massive_star (19); K-sub,
          subchandra in 2D RZ at 128 x 256, its 1024-shell model built on
          the card (the batched bisection walk, one CUDA graph a march;
          limit 60 s), 2 steps timed with the burn's and gravity's shares
          and a device-only profile, the model on the card against the CPU's
          and 1D n=128 card vs CPU; K-ms, massive_star 1D n=256 with NSE, the
          NSE bisection's graph against the eager loop bit for bit, one step
          timed with the NSE bypass's share, the iron core checked, 8 zones
          over 2e8 cm card vs CPU; K-burn, aprox21 + Helmholtz react() on 16^3 with and without
          NSE, card vs CPU on 2^3; K-sci, wdmerger (both problems), the
          reacting and convection tests, the bubbles, celldet, planet,
          StarGrav, hydrostatic_adjust, hse_convergence_general and the
          general acoustic pulse one step each, double_bubble, celldet,
          wdmerger problem 0 and nse_test's initial state card vs CPU;
       L  SDC and MOL (a MOL evaluation's Riemann solves are cmpflx
          launches, the rest torch ops; clean_fill after each node update
          in 3D) and the hydro test setups, float64: L4, true SDC-4 on
          Lobatto nodes on the 3D acoustic pulse at 128^3, 2 steps timed
          after a warm one (78 cmpflx launches a step), cmpflx bit for bit
          on the step's MOL-4 faces in float64 and float32; L-rad (Radau,
          102) and L2 (SDC-2, 9) at 64^3; the three at 16^3 card vs CPU;
          L-det, the 1D detonation (n=512) in simplified SDC, SDC-2 and
          SDC-4 for 20 steps each, the fuel burnt, n=64 card vs CPU; L-blob,
          H3's blob with simplified SDC at 64^3 (the CTU step's five 3D
          kernels, two evaluations a step, and the forced burner), one step
          at 1/8 of the CFL dt after the burner's capture with its burn
          share, 8^3 card vs CPU; L-amr, the 2D pulse 512^2 + 1 level with
          SDC-4, 2 coarse steps, mass to 1e-12, 64^2 card vs CPU; L-set,
          every hydro test setup (KH, RT, Noh, gresho, oddeven, the torus,
          lw_acoustics, the riemann_2d configurations, the Helmholtz shock
          tubes) at its default size, init + 2 steps, riemann_2d config 3
          and sod_stellar test 1 card vs CPU; the CPU references in a
          worker process beside the card;
       M  radiation, float64 unless named (radiation/, ops/rad_hydro.py:
          the characteristic rad-CTU step and the implicit FLD update are
          torch ops, as the JAX package leaves them to XLA; the
          operator-split step's solves are cmpflx and trans_cmpflx on the
          radiation layout): M3, the 3D gray rad-CTU pulse at 128^3, 2
          steps timed after a warm one, the implicit update's and the
          CTU-rad chain's shares, V-cycles a solve and each solve's
          residual against its tolerance, a profile, and 16^3 card vs CPU; M-split, rad_blast (1D spherical, n=128),
          rad_breakout (n=1024), bwp-rad (2D RZ 64 x 128) and a 2D
          Cartesian box (256^2) through the operator-split step, launches a
          step checked, cmpflx / trans_cmpflx / trans_apply bit for bit on
          each run's state and on the box at ngroups 1 and 4 in float32 and
          float64, card vs CPU; M-mg, rad_sphere (n=256, 60 groups) against
          its analytic spectrum, su_olson multigroup (n=512) and
          rad_shestakov (64 groups) against the JAX tests' checks, a
          float32 multigroup rad-CTU step at 64^3 (f-space advection,
          Compton) finite; M-amr, the JAX AMR radiation setup at 256^2 + 1
          level, 2 coarse steps, total energy, and multigroup + Compton at
          32^2; M-set, rad_shock (Mach 2), rad_tests' thermal wave and
          radiation source, init + 2 steps and card vs CPU; the CPU
          references in a worker process;
       N  ideal MHD (mhd/, the MHD branches of driver/sim.py and
          driver/amr.py), float64 unless named, torch ops throughout as
          the JAX package leaves MHD to XLA (every kernel's launches on the
          path must read 0): N3, the 3D CTU-CT step on the periodic Alfven
          wave at 128^3 through Simulation.run, 2 steps timed after a warm
          one, a profiled step, div B, 16^3 card vs CPU over 3 steps;
          N-rk2, castro.mhd_ctu=0 at 64^3, div B, 16^3 card vs CPU;
          N2, Orszag-Tang at 1024^2, 3 steps timed after a warm one and
          profiled, 64^2 card vs CPU, one float32 step at 256^2 against
          the CPU's; N1, Brio-Wu (n=200 to t=0.1), Dai-Woodward and the
          fast rarefaction (n=128, 20 steps) through MhdSimulation with the
          JAX tests' checks; N-set, loop advection (div B, the loop's
          drift), the species contact, RT with constant gravity through
          Simulation and its card vs CPU; N-amr, two-level Orszag-Tang
          256^2 + 1 level, 3 coarse steps timed and one profiled, div B on
          both levels, the covered coarse faces against the fine faces'
          restriction, 32^2 + 1 level card vs CPU with equal windows and
          masks;
     then the probe entry points (castro_tpu_torch/scripts/prof_cmpflx.py
     at 128^3 and prof_vpu.py), each probe first held against its plain
     version (probe_cmpflx at every tiling and probe_copy bit for bit,
     the vpu bodies as stated at VPU_CHECK_ITERS);
  5. time the main paths (zones/s, ms/step, peak memory, device time by
     kernel under torch.profiler; G3D's window and refined fraction) and each kernel (its device time under
     torch.profiler) beside its bound and its plain version's time (CUDA
     events); trace_ppm and ctu_face variant by variant
     (castro_tpu_torch/scripts/prof_faces.py); consup direction by
     direction at NPASS = 1 and 19, float32 and float64 (the float64 inputs
     the float32 ones cast, each first held against its plain version), each
     beside its bound; probe_vpu's fma beside its FLOP bound and its ceiling
     of two FP32 instructions a step, and fma_rn (one FFMA) beside the FLOP
     bound; the nine step kernels again at NPASS = 7 and 19; cmpflx and trans_cmpflx in float64 at NPASS = 13
     on flame_wave's state (J-fw's grid), the bound's operations over the
     float64 peak; cmpflx, trans_cmpflx and trans_apply on the radiation
     layout (the 2D box at 2048^2, ngroups 1 and 4, float32 and float64).
Any failure exits non-zero. The last two lines are the kernels' JSON and
the {"ok": true, ...} line. Without a card, or without the package beside
this file, it exits 2 and prints no result.
"""

import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import time
import types
from concurrent.futures import ProcessPoolExecutor

# Kernel vs plain version, on the same inputs on the card. flatten,
# trace_ppm and ctu_face are built with --fmad=false and do their plain
# versions' operations in the same order: they must agree bit for bit. So
# must cmpflx, trans_apply, trans_cmpflx and consup, whose bodies are the
# device functions of ctu_face.
# prim_aux and clean_fill divide k_B/m_u by mu (gamma-1) for the EOS's cv,
# where torch computes a scalar over a tensor as a reciprocal times the
# scalar, one rounding more; they are held pointwise to RTOL |plain| with no
# absolute term, except div u, a sum of differences, whose floor is RTOL
# times its largest magnitude. Card vs CPU after three steps: RTOL |cpu|
# plus RTOL times each component's largest magnitude, as the float64 tests
# against JAX scale their floor (tests/test_torch_sedov.py). RTOL is the
# fused-vs-XLA float32 budget of the JAX package (tests/test_pallas.py:41).
EXACT = ("flatten", "trace_ppm", "ctu_face", "cmpflx", "trans_apply", "trans_cmpflx",
         "consup", "probe_cmpflx", "probe_copy")
RTOL = 2e-5
# kernels whose ptxas rows must show no stack and no spills, in float32 and
# float64 (probe_vpu, float32 alone, is held to the same apart)
NO_STACK = ("prim_aux_kernel", "flatten_kernel", "clean_fill_kernel", "consup_march_kernel",
            "consup_rows_kernel")
MASS_RTOL = 1e-6
# H100 SXM, published peaks (NVIDIA's data sheet): HBM bytes/s and float32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
N_MAIN, STEPS_MAIN = 128, 10
N_BIG, STEPS_BIG = 256, 4       # path A at a grid that fills the card, timed
N_IF = 64                         # path I: the full-physics blob (cut from 128^3)
N_SMALL = 32
RAGGED = (29, 21, 37)             # interior cells; 37 x 29 x 45 grown, all prime
N_HYBRID, STEPS_HYBRID = 64, 20   # path B with hybrid_riemann
N_2D, STEPS_2D = 4096, 10         # path C
N_2D_SMALL = 64
N_1D = 1024                       # path C: 1D Sod (cut from 4096, then 2048)
SOD_L1_BOUND = 0.015              # mean |rho - exact| / mean exact (tests/test_sod.py)
N_RZ, STEPS_RZ = 2048, 10         # path E: RZ N x 2N, timed
N_SPH = 512                       # path E: RZ N x 2N and 1D spherical N to t=0.01 (cut
                                  # from 1024)
RZ_L1_BOUND, RZ_PEAK_CELLS = 0.05, 2   # tests/test_sedov_analytic.py
DMR_CHECK, DMR_BIG, STEPS_DMR = (128, 32), (2048, 512), 10   # path F
N_AMR, STEPS_AMR = 128, 10        # path G: 3D Sedov with one refined level (256^3 effective)
N_AMR_2D, STEPS_AMR_2D = 1024, 5  # path G: 2D Sedov
N_AMR_1D = 256                    # path G: 1D Sod to t=0.2 (cut from 1024, then 512)
N_H3, STEPS_H3 = 64, 1            # path H: the burning blob, steps of each EOS (cut from
                                  # 128^3 to keep the whole smoke within 1000 s)
N_BLOB_CPU = 8                    # paths H, I: the blob's card-vs-CPU copy (the CPU burns
                                  # slowly; cut from 16)
N_DET, STEPS_DET = 512, 100       # path H1: the 1D detonation, n and at most these steps
                                  # (cut from 200)
STEPS_I3 = 3                      # path I: 3D DustCollapse at N_MAIN^3, checked (cut from
                                  # 5)
STEPS_I3_BIG = 2                  # path I: 3D DustCollapse at N_MAIN^3, timed after init
                                  # (cut from 5 steps at 256^3)
GRAV_DT = 2e-5                    # path I: DustCollapse's fixed dt (s; t_ff = 0.066 s; float32
                                  # overflows in the Riemann solve past t ~ 2e-4 at 16^3-64^3)
N_GRAV_CPU = 32                   # path I: DustCollapse's card-vs-CPU copy
N_SPHERE = 128                    # path I: the uniform sphere against its analytic field
N_I1 = 128                        # path I: 1D spherical DustCollapse to 0.6 t_ff
N_IG, STEPS_IG = 64, 1            # path I: composite gravity, 3D blob + one level, timed
                                  # (cut from 2 coarse steps)
N_IG_CPU = 32                     # path I: composite gravity's 2D card-vs-CPU copy
N_FW, STEPS_FW = (256, 128), 1   # path J: flame_wave, timed after init_data (cut from 512
                                  # x 256 and 3 steps; at 1024 x 512
                                  # the smoke would not end within its time limit)
N_FW_CPU = (32, 16)               # path J: flame_wave's card-vs-CPU copy, one step (cut
                                  # from 64 x 32)
N_HSE = (64, 128)                 # path J: hse_convergence to t = 1
N_XRB_CPU = (32, 96)              # path J: xrb_mixed's card-vs-CPU copy, one step
STEPS_SCI = 1                     # path J: the five surface-burning setups, steps of each
                                  # (cut from 2)
N_KSUB, STEPS_KSUB = (128, 256), 2  # path K: subchandra in 2D RZ, timed after init_data (the
                                    # JAX default; 256 x 512 asked, over the time budget)
N_KSUB_CPU = 128                  # path K: subchandra 1D card vs CPU (the JAX test's size)
N_KMS, STEPS_KMS = 256, 1         # path K: massive_star 1D with NSE, timed after init_data
                                  # (3 steps asked; ~30 s a step: the burner's ~100
                                  # iterations a half burn in the NSE zones)
N_KMS_CPU = 8                     # path K: massive_star 1D card vs CPU over 2e8 cm
N_KWDM = (32, 64)                 # path K: wdmerger, both problems (0.5 + 0.5 Msun)
N_KCD_CPU = (64, 16)              # path K: celldet's card-vs-CPU copy
STEPS_KSCI = 1                    # path K: the science setups, steps of each
FP64_OPS_PER_S = 34e12            # H100 SXM float64 outside the tensor cores (NVIDIA's data sheet)
DET_BURNT_RTOL = 1e-4             # H1: fuel burnt on the card against the same steps on the CPU
F32_VS_F64 = 1e-4                 # card float32 against CPU float64 (tests/test_f32_physics.py)
CPU_JOB_THREADS = 3               # path K: torch threads of the worker process that runs
                                  # the CPU references beside the card's process
F64_RTOL = 1e-8                   # card float64 against CPU float64, coupled burns
# path L: SDC and MOL. name -> (sdc_order, sdc_quadrature); the cmpflx launches
# of a step a dimension: MOL evaluations (3, 13 on Lobatto nodes, 17 on Radau
# nodes) x Riemann solves a direction (1 at order 2, 2 at order 4)
L_SDC = {"L4": (4, 0), "L-rad": (4, 1), "L2": (2, 0)}
L_SOLVES = {(4, 0): 26, (4, 1): 34, (2, 0): 3}
N_L4, STEPS_L4 = 128, 2           # L4: the 3D acoustic pulse, float64, timed after 1 warm step
N_LSMALL = 64                     # L-rad, L2: one step each
N_LCMP, L_DT_CMP = 16, 2e-3       # L-cmp: L4, L-rad, L2 card vs CPU, one step at this dt
N_LDET, STEPS_LDET = 512, 20      # L-det: the 1D detonation in the three SDC modes
N_LDET_CPU, STEPS_LDET_CPU = 64, 10  # L-det card vs CPU, at the CFL dt of the initial state
# L-det's modes: name -> (time_integration_method, sdc_order); cmpflx launches a step
L_DET = {"simplified": (3, 2, 2), "sdc2": (2, 2, 3), "sdc4": (2, 4, 26)}
N_LBLOB = 64                      # L-blob: H3's blob with time_integration_method=3, float64
                                  # (in float32 the forced burn fails in the hot zones, in
                                  # the JAX package too: PERF.md, path L)
L_BLOB_DT_FRAC = 1 / 8            # L-blob: its timed step at this fraction of the CFL dt
                                  # (cut from 1: the full step's two forced burns take
                                  # ~400 iterations each, 77 s at 64^3: PERF.md, path L)
N_LAMR, STEPS_LAMR = 512, 2       # L-amr: 2D acoustic pulse + 1 level, SDC-4, float64
N_LAMR_CPU = 64
N_LSET_CPU = {"riemann_2d": 64, "sod_stellar": 128}  # L-set card vs CPU, 2 steps
# path M: radiation. M3 the 3D gray rad-CTU pulse (tests/test_rad_hydro_coupling.py:
# 182-200), float64, timed after 1 warm step; its card-vs-CPU copy
N_M3, STEPS_M3, N_M3_CPU = 128, 2, 16
M_DT = 2e-3                       # the pulse's and the boxes' fixed dt
N_MBOX, N_MBOX_KERN = 128, 64     # M-split: the 2D Cartesian operator-split box; its kernel
                                  # checks (ngroups 1 and 4, float32 and float64)
STEPS_MSPLIT = 2                  # M-split: steps of each run, card and CPU
N_MSPH, M_SPH_T, M_SPH_DT = 256, 1.0e-13, 1.0e-15  # M-mg: rad_sphere's run, the JAX test's
                                  # dt, 100 steps (cut from its 1000 to 1e-12 for time; the
                                  # whole run: python -m castro_tpu_torch.problems.rad_sphere)
N_MSO, N_MSB = 512, 256           # M-mg: su_olson multigroup, rad_shestakov (64 groups)
STEPS_MSO, STEPS_MSB = 10, 20     # M-mg: their steps, every check after them (the JAX tests:
                                  # su_olson 20 and 60 steps, rad_shestakov 40; cut for time,
                                  # 1.1 and 0.77 s a step on the card, PERF.md section 4)
N_MMG = 64                        # M-mg: the float32 multigroup rad-CTU step (4 groups,
                                  # f-space advection and Compton)
N_MAMR, STEPS_MAMR = 256, 2       # M-amr: tests/test_amr_radiation.py's setup + 1 level
N_MAMR_MG = 32                    # M-amr: its multigroup + Compton composition
N_2D_RAD = 2048                   # the timing phase: the kernels on the radiation layout
# path N: ideal MHD, float64 unless named. N3 the 3D CTU-CT step on the periodic
# Alfven wave, timed after 1 warm step; its card-vs-CPU copy and steps
N_N3, STEPS_N3, N_N3_CPU, STEPS_N_CPU = 128, 2, 16, 3
N_NRK2 = 64                       # N-rk2: castro.mhd_ctu=0, the RK2 flux-CT step (CPU copy 16^3)
N_N2, STEPS_N2, N_N2_CPU, N_N2_F32 = 1024, 3, 64, 256   # N2: Orszag-Tang; its CPU copy;
                                  # one float32 step against the CPU's
N_NAMR, STEPS_NAMR, N_NAMR_CPU = 256, 3, 32   # N-amr: Orszag-Tang + 1 level (a static box)
N_NBW = 200                       # N1: Brio-Wu to t = 0.1 (cut from 512, then from 400,
                                  # tests/test_mhd.py's size: 90-104 ms a step on the card,
                                  # host-bound, 39.6 s at 400; its checks hold from 128 up)
DIVB_MAX = 1e-10                  # |div B| over the interior (masked cells on a window)
COVERED_FACES_MAX = 5e-3          # covered coarse faces against the fine faces' restriction
                                  # (tests/test_mhd_amr.py: the initial data differ at O(dx^2))
# the reacting layouts held kernel vs plain: (nspec, naux, shock flag,
# hybrid momenta)
LAYOUTS = [(7, 0, False, False), (13, 0, False, False), (19, 0, False, False),
           (7, 0, True, False), (3, 0, False, True), (7, 1, False, False),
           (19, 1, True, True)]
# the vpu bodies held to their plain versions: fma and div bit for bit;
# fma_rn (one rounding an iteration against two) to iterations x 2^-23;
# recip_approx (rcp.approx, at most one ulp from 1/x; the body's map has
# slope of magnitude one, so errors add) to 2 x iterations x 2^-23; rsqrt
# and exp (rsqrtf, expf: 2 ulp each; both maps contract to a fixed point,
# so errors do not grow) to 8 x 2^-23
VPU_CHECK_ITERS = 300
VPU_TIME_ITERS = 10000            # the fma body's launch timed for the kernels line
VPU_RTOL = {"fma": 0.0, "div": 0.0, "fma_rn": VPU_CHECK_ITERS * 2.0 ** -23,
            "recip_approx": 2 * VPU_CHECK_ITERS * 2.0 ** -23, "rsqrt": 8 * 2.0 ** -23,
            "exp": 8 * 2.0 ** -23}

REPLACES = {
    "prim_aux": "castro_tpu/ops/pallas_kernels.py:770",
    "flatten": "castro_tpu/ops/pallas_kernels.py:953",
    "trace_ppm": "castro_tpu/ops/pallas_kernels.py:1415",
    "ctu_face": "castro_tpu/ops/pallas_kernels.py:395",
    "clean_fill": "castro_tpu/ops/pallas_kernels.py:1019",
    "cmpflx": "castro_tpu/ops/pallas_kernels.py:210",
    "trans_apply": "castro_tpu/ops/pallas_kernels.py:255",
    "trans_cmpflx": "castro_tpu/ops/pallas_kernels.py:145",
    "consup": "castro_tpu/ops/pallas_kernels.py:1243",
    "probe_cmpflx": "scripts/prof_cmpflx.py:47",
    "probe_copy": "scripts/prof_cmpflx.py:70",
    "probe_vpu": "scripts/prof_vpu.py:12",
}
SOURCE = {"probe_cmpflx": "prof_cmpflx.cu", "probe_copy": "prof_cmpflx.cu",
          "probe_vpu": "prof_vpu.cu"}
# aten operations counted as arithmetic when the plain version's operations
# are counted (count_ops); data movement (copies, cat, stack, views, fills)
# is not counted
ARITH_OPS = {
    "abs", "add", "addcdiv", "addcmul", "amax", "amin", "bitwise_and", "bitwise_not",
    "bitwise_or", "clamp", "clamp_max", "clamp_min", "div", "eq", "exp", "floor", "fmax",
    "fmin", "ge", "gt", "isfinite", "isinf", "isnan", "le", "log", "logical_and",
    "logical_not", "logical_or", "lt", "max", "maximum", "min", "minimum", "mul", "ne",
    "neg", "pow", "reciprocal", "rsqrt", "rsub", "sign", "sgn", "sqrt", "sub", "sum",
    "where"}


# the profiler's own bookkeeping, reported among the device events
PROFILER_OVERHEAD = ("Command Buffer Full", "Buffer Flush", "Activity Buffer Request")


T_START = time.perf_counter()


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def elapsed():
    """Seconds since the script started, for the section headers."""
    return f"[+{time.perf_counter() - T_START:.0f} s]"


def smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def ptxas_table(log, lib=None):
    """[{kernel, registers, stack, spill_stores, spill_loads, smem, sass}] of
    every compiled kernel in an `nvcc -Xptxas -v` log, names demangled
    (cu++filt) and cut to the kernel and its template arguments; `sass` is
    the kernel's count of SASS instructions in the library `lib`
    (cuobjdump), the instructions one thread issues at most where the code
    has no loops."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            rows.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            cur.update(registers=int(m.group(1)), smem=int(smem.group(1)) if smem else 0)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if lib is not None and os.path.exists(tool):
        sass, fn = {}, None
        dump = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                              timeout=300).stdout
        for line in dump.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
            elif fn and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
                sass[fn] = sass.get(fn, 0) + 1
        for r in rows:
            r["sass"] = sass.get(r["kernel"], -1)
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if rows and os.path.exists(filt):
        out = subprocess.run([filt], input="\n".join(r["kernel"] for r in rows),
                             capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(out) == len(rows):
            for r, name in zip(rows, out):
                name = re.sub(r"^void ctt::", "", name).split(">(")[0] + ">"
                r["kernel"] = re.sub(r"\((int|bool)\)", "", name)
    return rows


def compare(got, ref, rtol, floor=(), report=False):
    """(max |got - ref|, max |got - ref| / |ref|, whether every element lies
    within rtol |ref|); the outputs whose indices are in `floor` (all of them
    for floor=True) also get rtol times each component's largest |ref| (the
    leading axis of an output with components). rtol = 0 asks for equality. With `report`,
    print the worst violation of each output."""
    import torch

    got = [got] if isinstance(got, torch.Tensor) else got
    ref = [ref] if isinstance(ref, torch.Tensor) else ref
    worst, worst_rel, ok = 0.0, 0.0, True
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = g.double(), r.double()
        # NaN in both at the same place (the ghost margin is garbage by
        # construction), and the same infinity in both (a float32 overflow
        # both versions reach), count as agreement
        both_nan = (torch.isnan(g) & torch.isnan(r)) | (torch.isinf(r) & (g == r))
        d = torch.where(both_nan, 0.0, torch.nan_to_num((g - r).abs(), nan=float("inf")))
        worst = max(worst, float(d.max()))
        rel = torch.where(d == 0, 0.0, torch.nan_to_num(d / r.abs(), nan=float("inf")))
        worst_rel = max(worst_rel, float(rel.max()))
        tol = rtol * r.abs()
        if floor is True or i in floor:
            mag = torch.nan_to_num(r.abs(), nan=0.0)
            if r.dim() >= 2:
                tol = tol + rtol * mag.flatten(1).amax(1).reshape((-1,) + (1,) * (r.dim() - 1))
            else:
                tol = tol + rtol * mag.max()
        excess = torch.where(both_nan, -1.0, torch.nan_to_num(d - tol, nan=1.0))
        good = bool((excess <= 0).all())
        ok = ok and good
        if report and not good:
            idx = tuple(int(v) for v in torch.unravel_index(excess.argmax(), excess.shape))
            print(f"    output {i} {tuple(g.shape)}: worst at {idx}: kernel {float(g[idx])!r} "
                  f"plain {float(r[idx])!r}; {int((excess > 0).sum())} elements outside",
                  file=sys.stderr)
    return worst, worst_rel, ok


def flat(o):
    """The tensors in a nest of tuples, lists and dicts, in order."""
    import torch

    if isinstance(o, torch.Tensor):
        return [o]
    if isinstance(o, dict):
        o = list(o.values())
    if isinstance(o, (list, tuple)):
        return [x for i in o for x in flat(i)]
    return []


def time_ms(fn, reps, warm=2):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, reps, name=None):
    """Device time of one launch of the kernel that `fn` launches, from
    torch.profiler: the median of the kernel's own records (ctt::, or
    ctt::<name>... given `name`; without the wrapper's allocations and
    fills) over the calls traced. The profiler can drop records of a trace
    (at NPASS 7 and 19 it returned none for some directions of trace_ppm
    and ctu_face), and once handed probe_vpu's trace the records of the
    kernel timed before it (probe_copy's): traces are taken until `reps`
    records are in hand, at most four; with none, the device records it
    did see are printed and None is returned."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    times_us, seen = [], set()
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        got = []
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            seen.add(e.name[:60])
            if f"ctt::{name or ''}" in e.name:
                dev_us = getattr(e, "self_device_time_total", None)
                got.append(dev_us if dev_us is not None
                           else getattr(e, "self_cuda_time_total", 0.0))
        got = [t for t in got if t > 0]
        if len(got) > reps:
            fail(f"the profiler counted {len(got)} kernel launches in {reps} calls")
        times_us += got
        if len(times_us) >= reps:
            break
    if not times_us:
        print(f"  the profiler recorded no ctt:: kernel in 4 traces; device records seen: "
              f"{sorted(seen)[:6]}")
        return None
    return statistics.median(times_us) / 1e3


def kernel_event_ms(fn, reps):
    """Device time of one launch of the kernel that `fn` launches, from
    CUDA events recorded on the launch's stream just before and just after
    the launch itself (castro_tpu_torch.ops.kernels._call wrapped), the
    median over `reps` calls after one warm-up: the kernel alone, without
    the wrapper's allocations and fills, where the profiler returns no
    record."""
    import statistics

    import torch
    from castro_tpu_torch.ops import kernels as K_

    inner, pairs = K_._call, []

    def bracketed(name, like, *args):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        inner(name, like, *args)
        ev[1].record()
        pairs.append(ev)

    K_._call = bracketed
    try:
        fn()
        torch.cuda.synchronize()
        pairs.clear()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    finally:
        K_._call = inner
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def count_ops(fn):
    """The arithmetic operations of one call of a plain version: each aten
    operation of ARITH_OPS counts one operation per element of its largest
    tensor operand or result (the input of a reduction, the broadcast
    output of an elementwise operation)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__.rstrip("_") in ARITH_OPS:
                sizes = [t.numel() for t in flat([args, kwargs or {}, out])]
                Count.ops += max(sizes, default=0)
            return out

    with Count():
        fn()
    return Count.ops


def time_kernel(name, variants, S, itemsize, ops_per_s, reps, plain_reps):
    """Per-launch times of kernel `name` over its variants, each (kernel
    call, plain call, components moved[, elements[, variant label]]): the
    kernel's device time (torch.profiler; CUDA events around the launch,
    with a notice, where the profiler returns no record), the wrapper's and
    the plain version's
    (CUDA events), and the bound max(components x elements x itemsize /
    HBM_BYTES_PER_S, operations of the plain version / ops_per_s). Returns
    the mean over the variants and the row of each."""
    rows = []
    for kern, plain, comps, *more in variants:
        S_ = more[0] if more else S
        w_ms = time_ms(kern, reps=reps)
        k_ms = kernel_device_ms(kern, reps=reps, name=name)
        ms_from = "profiler"
        if k_ms is None:
            k_ms, ms_from = kernel_event_ms(kern, reps=reps), "events"
            print(f"  {name}: the profiler saw no device time; ms from CUDA events around the "
                  f"launch: {k_ms:.4f} ms")
        p_ms = time_ms(plain, reps=plain_reps, warm=1)
        ops = count_ops(plain)
        b_bytes = comps * S_ * itemsize / HBM_BYTES_PER_S * 1e3
        b_ops = ops / ops_per_s * 1e3
        rows.append(dict(ms=k_ms, wrapper_ms=w_ms, plain_ms=p_ms, bound_ms=max(b_bytes, b_ops),
                         bytes_ms=b_bytes, ops_ms=b_ops, comps=comps, ops_per_cell=ops / S_,
                         ms_from=ms_from,
                         variant=more[1] if len(more) > 1 else None))
    mean = {k: sum(r[k] for r in rows) / len(rows)
            for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms")}
    mean["bound_by"] = "bytes" if mean["bytes_ms"] >= mean["ops_ms"] else "operations"
    return mean, rows


def annotation(e):
    """Whether a profiler record is a range annotation, not device work
    (the record's methods differ between torch versions)."""
    kind = getattr(e, "activity_type", None)
    flag = getattr(e, "is_user_annotation", None)
    return (kind is not None and "annotation" in kind()) or (flag is not None and bool(flag()))


def profile_steps(sim, steps, card, host=True):
    """Device busy time by kernel over a few steps of `sim.run`, under
    torch.profiler; the idle share is 1 - busy / wall (the profiler's own
    host overhead included). Also the share of the busy time spent in this
    repo's kernels (ctt::) against torch's own. host=False traces the
    device alone (a burn's 10^6 launches a step are too many host events).
    Returns dict(idle, busy_us, wall_us) a step, or None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sim.run(max_step=sim.step_count + steps, verbose=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    if host:
        averages = prof.key_averages()
        host_names = {e.key for e in averages
                      if e.device_type != torch.autograd.DeviceType.CUDA}
        for e in averages:
            # kernels, copies and fills only: a host-side aten:: row, and the
            # device-side annotation of the same name, repeat the time of the
            # kernels the operation launched
            if e.device_type != torch.autograd.DeviceType.CUDA or e.key in host_names \
                    or e.key in PROFILER_OVERHEAD:
                continue
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0.0)
            if dev_us > 0:
                rows.append((dev_us, e.count, e.key))
    else:
        # the device's records read as they are: key_averages() builds an
        # object a record, minutes for a burn's 10^6 launches
        by_name = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA or annotation(e) \
                    or e.name() in PROFILER_OVERHEAD:
                continue
            r = by_name.setdefault(e.name(), [0.0, 0])
            r[0] += e.duration_ns() / 1e3 if hasattr(e, "duration_ns") else e.duration_us()
            r[1] += 1
        rows = [(us, count, name) for name, (us, count) in by_name.items() if us > 0]
    if not rows:
        print(f"profile [{card}]: device time not measured (the profiler saw no device time)")
        return None
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    ours = sum(r[0] for r in rows if "ctt::" in r[2])
    print(f"profile [{card}]: {steps} steps under torch.profiler, wall {wall_us / steps:.1f} "
          f"us/step, device busy {busy / steps:.1f} us/step, idle share "
          f"{1.0 - busy / wall_us:.4f}; hand-written kernels {ours / steps:.1f} us/step "
          f"({ours / busy:.4f} of busy), torch ops {(busy - ours) / steps:.1f} us/step; "
          f"device time by name (us/step, launches/step):")
    for dev_us, count, key in rows[:14]:
        print(f"  {dev_us / steps:10.1f}  {count / steps:5.1f}  {key[:90]}")
    return dict(idle=1.0 - busy / wall_us, busy_us=busy / steps, wall_us=wall_us / steps,
                launches=sum(r[1] for r in rows) / steps)


def k_burn_react(nse_on, n_b, where):
    """Path K-burn: aprox21 + Helmholtz, StrangReactor.react(dt=1e-8) on the
    n_b^3 corner of a seeded 16^3 box at rho 1e9 and T 4e9 +- 10% (T_nse
    4e9: half the zones in NSE with nse_on). Returns (react's outputs,
    seconds, the burner's iterations, the layout)."""
    import dataclasses as dc

    import torch

    from castro_tpu_torch.config import Params
    from castro_tpu_torch.eos import make_eos
    from castro_tpu_torch.network import make_network
    from castro_tpu_torch.reactions.strang import StrangReactor
    from castro_tpu_torch.state import layout_from_params

    p = Params().with_ns("network", network_name="aprox21", nse=nse_on, T_nse=4.0e9)
    p = p.with_ns("eos", eos_name="helmholtz").with_ns("tpu", dtype="float64")
    net = make_network(p)
    pp = dc.replace(p, network=dc.replace(p.network, nspec=net.nspec, spec_names=net.spec_names))
    Lb = layout_from_params(pp)
    eos = make_eos(pp, net)
    reactor = StrangReactor(pp, net, eos, Lb)
    g_ = torch.Generator("cpu").manual_seed(11)
    T = 4e9 * (1.0 + 0.1 * (2 * torch.rand((16,) * 3, generator=g_, dtype=torch.float64) - 1))
    T = T[:n_b, :n_b, :n_b].to(where)
    rho = torch.full_like(T, 1e9)
    xn = torch.zeros((net.nspec,) + T.shape, dtype=T.dtype, device=where)
    for name, xv in (("Si28", 0.6), ("O16", 0.3), ("Fe54", 0.1)):
        xn[net.spec_names.index(name)] = xv
    es = eos.rt(rho=rho, T=T, xn=xn)
    u = torch.zeros((Lb.NVAR,) + T.shape, dtype=T.dtype, device=where)
    u[Lb.URHO], u[Lb.UTEMP], u[Lb.UEINT], u[Lb.UEDEN] = rho, T, rho * es.e, rho * es.e
    u[Lb.UFS:Lb.UFS + Lb.nspec] = rho[None] * xn
    if where != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = reactor.react(u, 1e-8)
    if where != "cpu":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, reactor.burner.stats.iterations, Lb


def l_box_tag(sim, u_int, level):
    """Path L's AMR tags: the cells within 0.3 < x, y < 0.7."""
    m = None
    for d in range(sim.geom.dim):
        x = sim.geom.cell_centers(d, 0)
        t = (x > 0.3) & (x < 0.7)
        m = t if m is None else m & t
    return m.expand(tuple(u_int.shape[1:]))


def l_sim(kind, device, n, order=4, quad=0, tim=2, dtype="float64", dim=3, fixed_dt=-1.0):
    """Path L's runs, built alike on the card and in the worker process:
    "pulse" the acoustic pulse with true SDC, "det" the 1D detonation with
    time_integration_method `tim`, "blob" path H3's blob (iso7, the gamma
    law) in float64 with simplified SDC (at `fixed_dt` where positive),
    "amr" the 2D pulse + one level with SDC-4, "riemann_2d" configuration
    3, "sod_stellar" test 1."""
    from castro_tpu_torch.driver.sim import Simulation
    from castro_tpu_torch.problems import (acoustic_pulse, burning_blob, detonation,
                                           riemann_2d, sod_stellar)

    sdc = dict(time_integration_method=tim, sdc_order=order, sdc_quadrature=quad)
    if kind == "pulse":
        p = acoustic_pulse.make_params(n=n, dim=dim, dtype=dtype).with_ns("castro", **sdc)
        return Simulation(p, problem_init=acoustic_pulse.problem_init, device=device)
    if kind == "det":
        p = detonation.make_params(n=n, tim=tim).with_ns("castro", sdc_order=order)
        return Simulation(p, problem_init=detonation.problem_init, device=device)
    if kind == "blob":
        p = burning_blob.make_params(n=n, dtype="float64", eos="gamma_law").with_ns(
            "castro", time_integration_method=3, fixed_dt=fixed_dt)
        return Simulation(p, problem_init=burning_blob.problem_init, device=device)
    if kind == "amr":
        from castro_tpu_torch.driver.amr import AmrSimulation

        p = acoustic_pulse.make_params(n=n, dim=2).with_ns("castro", use_retry=0, **sdc)
        p = p.with_ns("amr", max_level=1, regrid_int=0)
        return AmrSimulation(p, problem_init=acoustic_pulse.problem_init,
                             problem_tagging=l_box_tag, device=device)
    if kind == "riemann_2d":
        return Simulation(riemann_2d.make_params(n=n, config=3),
                          problem_init=riemann_2d.problem_init, device=device)
    if kind == "sod_stellar":
        return Simulation(sod_stellar.make_params(test=1, n=n),
                          problem_init=sod_stellar.problem_init, device=device)
    raise ValueError(kind)


def l_steps(kind, device, n, dts, **kw):
    """One of path L's runs stepped by advance at the dts given (an AMR
    hierarchy's covered cells first averaged down from the fine level).
    Returns (the interior, or each level's interior, as float64 CPU
    tensors; the seconds of the steps; the burner's iterations or None)."""
    import torch

    s_ = l_sim(kind, device, n, **kw)
    s_.init_data()
    if kind == "amr":
        s_._avg_down(0)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for d_ in dts:
        s_.advance(d_)
    if device != "cpu":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if kind == "amr":
        return [s_.interior(l_).double().cpu() for l_ in range(2)], secs, None
    burner = getattr(s_.sdc or s_.sdc_simplified, "burner", None)
    return s_.interior().double().cpu(), secs, None if burner is None else \
        burner.stats.iterations


def cpu_job(kind, *args):
    """The CPU references of paths K, L and M, run in a worker process while
    the card's process goes on: ("ms", params, model, dt) one massive_star
    step, ("burn", nse_on) K-burn's 2^3 corner, ("l", l_steps' arguments)
    one of path L's runs, ("m", kind, dts, m_sim's keywords) one of path
    M's. Returns numpy arrays, the burner's iterations (L, K) or Er (M)
    and the seconds."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    torch.set_num_threads(CPU_JOB_THREADS)
    if kind == "m":
        mkind, dts, kw = args
        u_, er_, secs = m_steps(mkind, "cpu", dts, **kw)
        return u_.numpy(), er_.numpy(), secs
    if kind == "l":
        lkind, n, dts, kw = args
        out, secs, iters = l_steps(lkind, "cpu", n, dts, **kw)
        out = [o.numpy() for o in out] if isinstance(out, list) else out.numpy()
        return out, iters, secs
    if kind == "burn":
        out, secs, iters, _ = k_burn_react(args[0], 2, "cpu")
        return ([o.numpy() for o in out[:3]] + [bool(out[3])], iters, secs)
    from castro_tpu_torch.driver.sim import Simulation
    from castro_tpu_torch.problems import massive_star

    msp, model, dt = args
    s_ = Simulation(msp, device="cpu",
                    problem_init=lambda a_, b_: massive_star.problem_init(a_, b_, model))
    s_.init_data()
    t0 = time.perf_counter()
    s_.advance(dt)
    return s_.interior().double().numpy(), s_.reactor.burner.stats.iterations, \
        time.perf_counter() - t0


def m_sim(kind, device, n=None, dtype="float64", ngroups=1):
    """Path M's runs, built alike on the card and in the worker process:
    "pulse" the 3D rad-CTU pulse (tests/test_rad_hydro_coupling.py:109-200),
    "mg3d" tests/test_f32_physics.py's multigroup step in 3D (4 groups,
    f-space advection, Compton),
    "box" the 2D Cartesian operator-split box (a Sod-like tube with an Er
    pulse), the setups "rad_blast", "rad_breakout", "bwp_rad", "rad_shock",
    "thermal_wave", "rad_source", "su_olson_mg", "shestakov", and "amr" /
    "amr_mg" tests/test_amr_radiation.py's hierarchy. Returns the
    simulation, initialized, its radiation set as its setup sets it."""
    import torch
    from castro_tpu_torch.config import Params
    from castro_tpu_torch.driver.sim import Simulation
    from castro_tpu_torch.problems import (rad_blast, rad_breakout, rad_shestakov, rad_shock,
                                           rad_tests, science_extra, su_olson)
    from castro_tpu_torch.problems.util import fill_from_prim

    def rad_box(dim, kappa_r, kappa_p, split):
        p = Params().with_ns("amr", n_cell=(n,) * dim)
        p = p.with_ns("geometry", prob_lo=(0.0,) * 3, prob_hi=(1.0,) * 3)
        p = p.with_ns("castro", lo_bc=(0,) * dim, hi_bc=(0,) * dim, do_radiation=1,
                      small_dens=1e-12, small_temp=1e-12, small_pres=1e-15,
                      check_cfl_violation=0, fixed_dt=M_DT)
        mg = dict(lowest_group_hz=1e13, highest_group_hz=1e17,
                  do_inelastic_scattering=1) if ngroups > 1 else {}
        p = p.with_ns("radiation", const_kappa_p=kappa_p, const_kappa_r=kappa_r, limiter=2,
                      ngroups=ngroups, hydro_coupling=0 if split else 1, **mg)
        return p.with_ns("eos", eos_gamma=5.0 / 3.0).with_ns("tpu", dtype=dtype)

    def pulse_er(s_):
        r2 = sum((s_.geom.cell_centers(d, 0) - 0.5) ** 2 for d in range(s_.layout.dim))
        s_.u_rad = s_.u_rad * 0.0 + 1e-6 + 5.0 * torch.exp(-r2 / 0.02)

    post = None
    if kind == "mg3d":
        # tests/test_f32_physics.py:319-355's multigroup configuration in 3D
        p = Params().with_ns("amr", n_cell=(n,) * 3)
        p = p.with_ns("geometry", prob_lo=(0.0,) * 3, prob_hi=(1.0,) * 3)
        p = p.with_ns("castro", do_radiation=1, do_hydro=1, lo_bc=(0,) * 3, hi_bc=(0,) * 3,
                      fixed_dt=2e-7)
        p = p.with_ns("radiation", ngroups=4, const_kappa_p=1e-6, const_kappa_r=50.0,
                      limiter=0, lowest_group_hz=1e14, highest_group_hz=1e18,
                      do_inelastic_scattering=1)
        p = p.with_ns("tpu", dtype=dtype)

        def init(s_, u):
            r = s_.geom.radius(s_.ng, center=(0.5, 0.5, 0.5))
            return fill_from_prim(s_, u, 1.0, (0.0, 0.0, 0.0), T=0.1 + torch.exp(-(r / 0.12) ** 2))

        sim = Simulation(p, problem_init=init, device=device)
    elif kind == "pulse":
        def init(s_, u):
            return fill_from_prim(s_, u, 1.0, (0.0, 0.0, 0.0), p=1.0)

        sim = Simulation(rad_box(3, 1e4, 0.0, False), problem_init=init, device=device)
        post = pulse_er
    elif kind == "box":
        def init(s_, u):
            x = s_.geom.cell_centers(0, s_.ng).expand(s_.grown_shape())
            one = torch.ones_like(x)
            rho = torch.where(x < 0.5, one, 0.25 * one)
            pres = torch.where(x < 0.5, one, 0.3 * one)
            return fill_from_prim(s_, u, rho, (0.1, 0.0, 0.0), p=pres)

        sim = Simulation(rad_box(2, 1e4, 1e-3, True), problem_init=init, device=device)
        post = pulse_er
    elif kind in ("rad_blast", "rad_breakout"):
        mod = rad_blast if kind == "rad_blast" else rad_breakout
        sim = Simulation(mod.make_params(n=n), problem_init=mod.problem_init, device=device)
    elif kind == "bwp_rad":
        sim = Simulation(science_extra.bwp_rad_params(n=n), problem_init=science_extra.bwp_rad_init,
                         device=device)
    elif kind == "rad_shock":
        sim = Simulation(rad_shock.make_params(mach=2, n=n), problem_init=rad_shock.problem_init,
                         device=device)

        def post(s_):
            s_.u_rad = rad_shock.rad_init(s_)
    elif kind == "thermal_wave":
        sim = Simulation(rad_tests.thermal_wave_params(n=n), problem_init=rad_tests.thermal_wave_init,
                         device=device)
    elif kind == "rad_source":
        sim = Simulation(rad_tests.rad_source_params(n=n), problem_init=rad_tests.rad_source_init,
                         device=device)

        def post(s_):
            s_.u_rad = rad_tests.rad_source_Er0(s_)
    elif kind == "su_olson_mg":
        sim = Simulation(su_olson.mg_params(n=n), problem_init=su_olson.mg_init, device=device)
        post = su_olson.mg_setup_radiation
    elif kind == "shestakov":
        sim = Simulation(rad_shestakov.make_params(n=n), problem_init=rad_shestakov.problem_init,
                         device=device)
        post = rad_shestakov.setup_radiation
    elif kind in ("amr", "amr_mg"):
        from castro_tpu_torch.driver.amr import AmrSimulation

        p = Params().with_ns("amr", n_cell=(n, n), max_level=1, regrid_int=0,
                             refinement_indicators=("terr",))
        p = p.with_ns("geometry", prob_lo=(0.0,) * 3, prob_hi=(1.0,) * 3)
        p = p.with_ns("castro", do_radiation=1, do_hydro=0, lo_bc=(2, 2), hi_bc=(2, 2),
                      fixed_dt=2e-7)
        p = p.with_ns("radiation", const_kappa_p=1e-6, const_kappa_r=50.0, limiter=0, ngroups=1)
        if kind == "amr_mg":
            p = p.with_ns("radiation", ngroups=4, lowest_group_hz=1.0e13,
                          highest_group_hz=1.0e17, do_inelastic_scattering=1,
                          const_kappa_r=5.0)
        p = p.replace(extra={"amr.terr.field": "Temp", "amr.terr.value_greater": 0.5})

        def init(s_, u):
            r = s_.geom.radius(s_.ng, center=(0.5, 0.5))
            return fill_from_prim(s_, u, 1.0, (0.0, 0.0, 0.0), T=0.1 + torch.exp(-(r / 0.12) ** 2))

        amr = AmrSimulation(p, problem_init=init, device=device)
        amr.init_data()
        return amr
    else:
        raise ValueError(kind)
    sim.init_data()
    if post is not None:
        post(sim)
    return sim


def m_steps(kind, device, dts, **kw):
    """One of path M's runs, stepped by advance at the dts given. Returns
    (the interior, float64 on the CPU; Er likewise; the seconds)."""
    import torch

    s_ = m_sim(kind, device, **kw)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for d_ in dts:
        s_.advance(d_)
        s_.step_count += 1
    if device != "cpu":
        torch.cuda.synchronize()
    return s_.interior().double().cpu(), s_.u_rad.double().cpu(), time.perf_counter() - t0


def m_first_dt(kind, **kw):
    """A run's first dt, from its initial state on the CPU."""
    return m_sim(kind, "cpu", **kw).estimate_dt()


def n_sim(kind, device, n, dtype="float64"):
    """Path N's runs, built alike on the card and on the CPU, through the
    Simulation (castro.do_mhd=1): "alfven" the 3D periodic Alfven wave (CTU-CT),
    "alfven_rk2" the same with castro.mhd_ctu=0, "ot" Orszag-Tang, "rt" the
    magnetized Rayleigh-Taylor setup with constant gravity (n x 2n), "amr"
    Orszag-Tang + one level over N-amr's static box. Returns the simulation,
    not initialized."""
    from castro_tpu_torch.driver.sim import Simulation
    from castro_tpu_torch.problems import mhd_tests, orszag_tang

    if kind in ("alfven", "alfven_rk2"):
        p = mhd_tests.alfven_params(n=n, dim=3).with_ns(
            "castro", mhd_ctu=int(kind == "alfven")).with_ns("tpu", dtype=dtype)
        return Simulation(p, problem_init=mhd_tests.alfven_init, device=device)
    if kind == "ot":
        return Simulation(orszag_tang.make_params(n=n, dtype=dtype),
                          problem_init=orszag_tang.problem_init, device=device)
    if kind == "rt":
        return Simulation(mhd_tests.rt_params(n=(n, 2 * n)).with_ns("tpu", dtype=dtype),
                          problem_init=mhd_tests.rt_init, device=device)
    if kind == "amr":
        from castro_tpu_torch.driver.amr import AmrSimulation

        p = orszag_tang.make_params(n=n, dtype=dtype).with_ns("amr", max_level=1, regrid_int=0,
                                                              n_error_buf=2)
        # path L's box, tests/test_mhd_amr.py's static tags
        return AmrSimulation(p, problem_init=orszag_tang.problem_init, problem_tagging=l_box_tag,
                             device=device)
    raise ValueError(kind)


def n_div_b(sim, l=None):
    """max |div B| over a single-level run's interior, or over level l's
    valid region of a hierarchy (its masked cells above level 0)."""
    import torch

    from castro_tpu_torch.ops.stencil import interior_slice

    if l is None:
        div = sim.mhd.div_b(sim.u_b)[interior_slice(sim.ng, sim.layout.dim, 0)]
        return float(div.abs().max())
    s_ = sim._sims_at(l)
    div = s_.mhd.div_b(sim.u_b[l])[interior_slice(sim.ng, sim.dim, 0)]
    if l > 0:
        div = torch.where(sim.masks[l], div, 0.0)
    return float(div.abs().max())


def n_compare(got, ref, rtol, report=False):
    """Card against CPU for n_steps' outputs, pairs of (state [NVAR, ...],
    face fields [3, ...]) a level: rtol |cpu| + rtol times a scale, each
    state component's largest |cpu| but the momenta's, which share their
    vector's, and for the face fields max(|B|, sqrt(2 max |rho E|)), the
    field whose pressure is the largest energy density (a field that is 0
    but for round-off, as B with B_0 = 0, has no scale of its own).
    Returns (max abs err, max rel err where cpu != 0, all within)."""
    import torch

    from castro_tpu_torch.state import StateLayout

    L = StateLayout(dim=got[0].dim() - 1, mhd=True)
    worst, worst_rel, ok = 0.0, 0.0, True
    for i in range(0, len(got), 2):
        u_r = ref[i]
        mag = u_r.abs().flatten(1).amax(1)
        mom = [L.UMX, L.UMY, L.UMZ]
        mag[mom] = mag[mom].max()
        bscale = max(float(ref[i + 1].abs().max()), float(torch.sqrt(2 * u_r[L.UEDEN].abs().max())))
        for g, r, scale in ((got[i], u_r, mag.reshape((-1,) + (1,) * (u_r.dim() - 1))),
                            (got[i + 1], ref[i + 1], bscale)):
            d = (g - r).abs()
            worst = max(worst, float(d.max()))
            nz = r != 0
            if bool(nz.any()):
                worst_rel = max(worst_rel, float((d[nz] / r[nz].abs()).max()))
            excess = d - (rtol * r.abs() + rtol * scale)
            good = bool((excess <= 0).all()) and bool(torch.isfinite(g).all())
            ok = ok and good
            if report and not good:
                idx = tuple(int(v) for v in torch.unravel_index(excess.argmax(), excess.shape))
                print(f"    level {i // 2} {'state' if g is got[i] else 'faces'} "
                      f"{tuple(g.shape)}: worst at {idx}: card {float(g[idx])!r} cpu "
                      f"{float(r[idx])!r}; {int((excess > 0).sum())} elements outside",
                      file=sys.stderr)
    return worst, worst_rel, ok


def n_steps(kind, device, n, steps, dtype="float64"):
    """One of path N's runs, `steps` steps by advance at the CFL dt of its
    initial state (the CPU's, so that both devices take the same dt).
    Returns ([the interior and the interior faces of every level, float64
    on the CPU], the masks and windows of a hierarchy, the seconds)."""
    import torch

    from castro_tpu_torch.ops.stencil import interior_slice

    s_ = n_sim(kind, device, n, dtype)
    s_.init_data()
    ref = n_sim(kind, "cpu", n, dtype)
    ref.init_data()
    dt = ref.estimate_dt()
    del ref
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        s_.advance(dt)
    if device != "cpu":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    amr = hasattr(s_, "masks")
    levels = range(s_.max_level + 1) if amr else [None]
    out, meta = [], []
    for l in levels:
        u_ = s_.u[l] if amr else s_.u
        b_ = s_.u_b[l] if amr else s_.u_b
        ng, dim = s_.ng, (s_.dim if amr else s_.layout.dim)
        out.append(u_[interior_slice(ng, dim)].double().cpu())
        isl = interior_slice(ng, dim, 0)
        out.append(torch.stack([bb[isl] for bb in b_]).double().cpu())
        if amr:
            meta.append((s_.masks[l].cpu(), tuple(int(v) for v in s_.window[l][0]),
                         tuple(s_.window[l][1])))
    return out, meta, secs


def main(argv=()):
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on a machine with an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from castro_tpu_torch.driver.amr import AmrSimulation
        from castro_tpu_torch.driver.sim import Simulation
        from castro_tpu_torch.eos.gamma_law import GammaLawEos
        from castro_tpu_torch.network import GeneralNullNetwork
        from castro_tpu_torch.ops import kernels as K
        from castro_tpu_torch.ops import advection_util as au
        from castro_tpu_torch.ops import probes as P
        from castro_tpu_torch.ops.ctu import _bnd_masks
        from castro_tpu_torch.ops.stencil import interior_slice, shifted
        from castro_tpu_torch.ops.trace_ppm import trace_ppm as trace_ppm_ops
        from castro_tpu_torch.ops.trans import term_bundle
        from castro_tpu_torch.problems import (acoustic_pulse, burning_blob, detonation,
                                               double_mach, sedov, sod)
        from castro_tpu_torch.state import StateLayout
        from castro_tpu_torch.scripts import prof_cmpflx, prof_faces, prof_vpu
        from castro_tpu_torch.utils.exact_riemann import solution as exact_solution
        from castro_tpu_torch.config import Params
        from castro_tpu_torch.problems import dust_collapse, flame_wave
        from castro_tpu_torch.problems.util import fill_from_prim
        from castro_tpu_torch.state import layout_from_params
    except ImportError as e:
        print(f"castro_tpu_torch not found beside chip_smoke.py: {e}", file=sys.stderr)
        return 2

    import numpy as np

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch: {kind}, count {torch.cuda.device_count()} | "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    K.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, one process per source)")
    ptxas = ptxas_table(K.build_log(), K._LIB.path)
    print(f"ptxas -v, {len(ptxas)} kernels (registers, stack bytes, spill stores / loads "
          f"bytes, static shared memory bytes, SASS instructions; trace_ppm_kernel<T, D, SRC, "
          f"FUSE, HYDRO>, ctu_face_kernel<T, D, NT1, NT2, CONSUP, TA, HYDRO>; HYDRO true: the "
          f"pure-hydro layout's build, its passive loops unrolled; false: any layout, the "
          f"passives looped at run time):")
    for r in ptxas:
        print(f"  {r['kernel']:50s} {r.get('registers', -1):4d} regs  stack {r.get('stack', -1):4d}"
              f"  spills {r.get('spill_stores', -1)} / {r.get('spill_loads', -1)}"
              f"  smem {r.get('smem', -1):6d}  sass {r.get('sass', -1)}")
    # the cell kernels keep everything in registers and shared memory: no
    # local-memory stack (EosGL indexed at run time put 88 B there) and no
    # spills, in float32 and float64
    cells = [r for r in ptxas if r["kernel"].startswith(NO_STACK)]
    built = {(name, t) for r in cells for name in NO_STACK for t in ("float", "double")
             if r["kernel"].startswith(f"{name}<{t}")}
    if len(built) != 2 * len(NO_STACK) or any(
            r.get("stack", -1) != 0 or r.get("spill_stores", -1) != 0 for r in cells):
        fail(f"ptxas: {NO_STACK} must build for float32 and float64 with no stack and no "
             f"spills: {cells}")
    vpu_rows = [r for r in ptxas if r["kernel"].startswith("probe_vpu_kernel")]
    if len(vpu_rows) != len(P.VPU_OPS) or any(
            r.get("stack", -1) != 0 or r.get("spill_stores", -1) != 0 for r in vpu_rows):
        fail(f"ptxas: probe_vpu_kernel must build for each body with no stack and no spills: "
             f"{vpu_rows}")

    def sedov_sim(n, dtype="float32", bc=2, device="cuda", dim=3, n_cell=None, **castro):
        p = sedov.make_params(n=n, dim=dim, stop_time=1.0, r_init=0.1, exp_energy=0.5,
                              dtype=dtype)
        p = p.with_ns("castro", lo_bc=(bc,) * 3, hi_bc=(bc,) * 3, **castro)
        if n_cell is not None:
            p = p.with_ns("amr", n_cell=n_cell)
        return Simulation(p, problem_init=sedov.problem_init, device=device)

    def sod_sim(n, device="cuda"):
        return Simulation(sod.make_params(n=n, dim=1, dtype="float32"),
                          problem_init=sod.problem_init, device=device)

    def curvilinear_sim(geometry, n, device="cuda"):
        """Sedov on the axis (tests/test_sedov_analytic.py): 2D RZ, r in
        [0, 1] and z in [-1, 1] on n x 2n cells, or 1D spherical on n."""
        kw = dict(stop_time=0.01, r_init=0.1, p_ambient=1e-5, exp_energy=1.0, dtype="float32")
        if geometry == "rz":
            p = sedov.make_params(n=n, dim=2, coord=1, **kw)
            p = p.with_ns("geometry", coord_sys=1, prob_lo=(0.0, -1.0, 0.0),
                          prob_hi=(1.0, 1.0, 0.0)).with_ns("amr", n_cell=(n, 2 * n))
            p = p.with_ns("castro", lo_bc=(3, 2), hi_bc=(2, 2), cfl=0.4)
            center = (0.0, 0.0)
        else:
            p = sedov.make_params(n=n, dim=1, coord=2, **kw)
            p = p.with_ns("castro", lo_bc=(3,), hi_bc=(2,), cfl=0.4)
            center = (0.0,)
        return Simulation(p, problem_init=lambda s_, u_: sedov.problem_init(s_, u_, center),
                          device=device)

    def dmr_sim(n, device="cuda"):
        return double_mach.build(n=n, dtype="float32", device=device)

    def pulse_sim(n, device="cuda"):
        return Simulation(acoustic_pulse.make_params(n=n, dtype="float32"),
                          problem_init=acoustic_pulse.problem_init, device=device)

    # what a phase hands on: its figures for the summary (each phase binds
    # its own names; those it hands on it also binds here) and the probes'
    # inputs, which the timing phase reads
    ctx = types.SimpleNamespace()

    # -- 3. kernel vs plain --------------------------------------------------------
    errs = {name: [0.0, 0.0] for name in REPLACES}

    def check(name, got, ref, what, floor=()):
        rtol = 0.0 if name in EXACT else RTOL
        tol = "0 (bit for bit)" if name in EXACT else f"{RTOL:g}|plain|" + (
            f", div u + {RTOL:g} max|div u|" if floor else "")
        err, rel, ok = compare(flat(got), flat(ref), rtol, floor)
        errs[name] = [max(errs[name][0], err), max(errs[name][1], rel)]
        print(f"  {name:10s} {what:42s} max abs err {err:.3e} rel {rel:.3e} "
              f"(tol {tol}) {'ok' if ok else 'DISAGREES'}", flush=True)
        if not ok:
            compare(flat(got), flat(ref), rtol, floor, report=True)
            fail(f"{name} disagrees with its plain version on {what}")

    def inputs(sim, u, dt):
        """Every kernel input of one step, made by the plain versions."""
        c, L, cfg = sim.params.castro, sim.layout, sim.cfg
        q, qaux, div = K.prim_aux_plain(u, L, sim.eos, cfg.small_dens, sim.small_temp,
                                        sim.geom.dx)
        flatn = K.flatten_plain(q, L)
        masks = _bnd_masks(u.shape[1:], 3, sim.ng, cfg.lo_bc, cfg.hi_bc)
        return dict(q=q, qaux=qaux, div=div, flatn=flatn, masks=masks, dt=dt,
                    dx=sim.geom.dx, L=L, cfg=cfg, eos=sim.eos, sim=sim, u=u,
                    eta2=c.dual_energy_eta2)

    def compare_step(x, label, solver=0, src=None, off_path=False, cells=True):
        """The kernels of a fused step on its inputs `x`; without `cells`
        (an EOS the kernels do not evaluate) not prim_aux and clean_fill."""
        L, cfg, dt, dx = x["L"], x["cfg"], x["dt"], x["dx"]
        sim, u = x["sim"], x["u"]
        args = (u, L, x["eos"], cfg.small_dens, sim.small_temp, dx)
        if cells:
            check("prim_aux", K.prim_aux(*args, courant_dt=dt),
                  K.prim_aux_plain(*args, courant_dt=dt), f"{label}, divu+courant",
                  floor=(2,))
        check("flatten", K.flatten(x["q"], L), K.flatten_plain(x["q"], L), label)
        tr = []
        for d in range(3):
            fr = dict(coord=0, riemann_solver=solver, bnd_mask=x["masks"][d])
            a = (x["q"], x["qaux"], src, x["flatn"], d, dt, dx[d], L, cfg.small_dens,
                 cfg.small_pres, cfg.small_ener)
            got = K.trace_ppm(*a, fuse_riemann=fr)
            ref = K.trace_ppm_plain(*a, fuse_riemann=fr)
            check("trace_ppm", got, ref, f"{label}, d={d}")
            tr.append(ref)
            if off_path:  # with srcQ, with and without the solve
                g = torch.Generator(dev).manual_seed(d)
                s_ = src if src is not None else \
                    1e-3 * x["q"].abs() * torch.randn(x["q"].shape, device=dev, generator=g)
                a = (x["q"], x["qaux"], s_, *a[3:])
                check("trace_ppm", K.trace_ppm(*a, fuse_riemann=fr),
                      K.trace_ppm_plain(*a, fuse_riemann=fr), f"{label}, srcQ d={d}")
                check("trace_ppm", K.trace_ppm(*a), K.trace_ppm_plain(*a),
                      f"{label}, srcQ, no solve d={d}")
        hsrc = torch.zeros_like(u)
        for d in range(3):
            t1, t2 = [t for t in range(3) if t != d]

            def term(t, f):
                return {"flux": tr[t][2], "qe": tr[t][3], "t_dir": t, "cdtdx": f * dt / dx[t]}

            fa = (tr[d][0], tr[d][1], x["qaux"], d)
            fb = (L, 0, solver, cfg.small_dens, cfg.small_pres, True, False)
            kw = dict(bnd_mask=x["masks"][d])
            check("ctu_face", K.ctu_face(*fa, [term(t1, 1 / 3)], *fb, terms2=[term(t2, 1 / 3)], **kw),
                  K.ctu_face_plain(*fa, [term(t1, 1 / 3)], *fb, terms2=[term(t2, 1 / 3)], **kw),
                  f"{label}, corner pair d={d}")
            cs = dict(hsrc=hsrc, div_node=x["div"], u=u, difmag=cfg.difmag, dx=dx,
                      finalize_dt=dt if d == 2 else None)
            fin = [term(t1, 0.5), term(t2, 0.5)]
            got = K.ctu_face(*fa, fin, *fb, consup=cs, **kw)
            ref = K.ctu_face_plain(*fa, fin, *fb, consup=cs, **kw)
            check("ctu_face", got, ref, f"{label}, final+consup d={d}")
            hsrc = ref[1]
            if off_path:  # the variants the main path does not launch
                for terms, kind in (([], "terms=[]"), ([term(t1, 1 / 3)], "one corner t1"),
                                    ([term(t2, 1 / 3)], "one corner t2"),
                                    (fin, "final, no consup")):
                    check("ctu_face", K.ctu_face(*fa, terms, *fb, **kw),
                          K.ctu_face_plain(*fa, terms, *fb, **kw), f"{label}, {kind} d={d}")
        if not cells:
            return
        ca = (hsrc, L, x["eos"], cfg.lo_bc, cfg.hi_bc, sim.ng, cfg.small_dens,
              sim.small_temp, x["eta2"], True)
        check("clean_fill", K.clean_fill(*ca, with_status=True),
              K.clean_fill_plain(*ca, with_status=True), f"{label}, with status")
        check("clean_fill", K.clean_fill(*ca), K.clean_fill_plain(*ca), f"{label}, no status")

    def compare_unfused_3d(x, label):
        """The kernels of the unfused 3D structure at the shapes path B gives
        them: the trace without the solve, trans_apply on corner and final
        bundles, consup per direction; and cmpflx on a 3D grid."""
        L, cfg, dt, dx, u, qaux = x["L"], x["cfg"], x["dt"], x["dx"], x["u"], x["qaux"]
        sd, sp = cfg.small_dens, cfg.small_pres
        g, c = qaux[L.QGAMC], qaux[L.QC]
        tr, f1d = [], []
        for d in range(3):
            a = (x["q"], qaux, None, x["flatn"], d, dt, dx[d], L, sd, sp, cfg.small_ener)
            ref = K.trace_ppm_plain(*a)
            check("trace_ppm", K.trace_ppm(*a), ref, f"{label}, no solve d={d}")
            tr.append(ref)
            a = (ref[0], ref[1], shifted(g, -1, d), g, shifted(c, -1, d), c, d, L, 0, 0, sd, sp)
            f1d.append(K.cmpflx_plain(*a, bnd_mask=x["masks"][d]))
            check("cmpflx", K.cmpflx(*a, bnd_mask=x["masks"][d]), f1d[-1], f"{label}, 3D d={d}")
        dtw = K.wt(dt, u.dtype)

        def term(t, f):
            return {"flux": f1d[t][0], "qe": f1d[t][1], "t_dir": t, "cdtdx": f * dtw / dx[t]}

        for n, terms, kind in ((0, [term(1, 1 / 3)], "corner"), (1, [term(2, 1 / 3)], "corner"),
                               (2, [term(0, 0.5), term(1, 0.5)], "final")):
            for q_face, shift, side in ((tr[n][1], 0, "p"), (tr[n][0], -1, "m")):
                a = (q_face, *term_bundle(terms, qaux, n, shift, L), L, sp, True, False)
                check("trans_apply", K.trans_apply(*a), K.trans_apply_plain(*a),
                      f"{label}, {kind} n={n} {side} state")
        hsrc = torch.zeros_like(u)
        for d in range(3):
            a = (hsrc, f1d[d][0], f1d[d][1][L.GDPRES], f1d[d][1][L.GDU + d], x["div"], u, d, L,
                 cfg.difmag, dx)
            fin = dt if d == 2 else None
            ref = K.consup_plain(*a, finalize_dt=fin)
            check("consup", K.consup(*a, finalize_dt=fin), ref,
                  f"{label}, d={d}" + (", finalize" if d == 2 else ""))
            hsrc = ref[0]

    def inputs_low_dim(sim, u, dt, solver=0):
        """The face states, 1D fluxes and bundles of a 1D or 2D step, made by
        torch ops and the plain versions."""
        L, cfg, dx, dim = sim.layout, sim.cfg, sim.geom.dx, sim.layout.dim
        sd, sp = cfg.small_dens, cfg.small_pres
        coord = int(sim.geom.coord)
        q, qaux = au.ctoprim(u, L, sim.eos, sd, sim.small_temp)
        flatn = K.flatten_plain(q, L)
        masks = _bnd_masks(u.shape[1:], dim, sim.ng, cfg.lo_bc, cfg.hi_bc)
        dtw = K.wt(dt, u.dtype)
        g, c = qaux[L.QGAMC], qaux[L.QC]
        solves = []
        for d in range(dim):
            qm, qp = trace_ppm_ops(q, qaux, None, flatn, d, dtw, dx[d], L, sd, sp,
                                   cfg.small_ener)
            solves.append((qm, qp, shifted(g, -1, d), g, shifted(c, -1, d), c, d, L, coord,
                           solver, sd, sp))
        del q, flatn
        f1d = [K.cmpflx_plain(*a, bnd_mask=masks[a[6]]) for a in solves]
        finals = []
        if dim == 2:
            for n, t in ((0, 1), (1, 0)):
                term = [{"flux": f1d[t][0], "qe": f1d[t][1], "t_dir": t,
                         "cdtdx": 0.5 * dtw / dx[t]}]
                bp = term_bundle(term, qaux, n, 0, L)
                bm = term_bundle(term, qaux, n, -1, L)
                finals.append((solves[n][0], solves[n][1], bm[0], bp[0], bm[1], bp[1], bm[2],
                               bp[2], *solves[n][2:6], n, L, coord, solver, sd, sp))
        return dict(solves=solves, f1d=f1d, finals=finals, masks=masks, L=L, sp=sp)

    def compare_low_dim(y, label, resets=((True, False),)):
        """cmpflx, trans_cmpflx and trans_apply at a 1D or 2D step's shapes."""
        for a, ref in zip(y["solves"], y["f1d"]):
            check("cmpflx", K.cmpflx(*a, bnd_mask=y["masks"][a[6]]), ref, f"{label}, d={a[6]}")
        for a in y["finals"]:
            n = a[12]
            for rd, rr in resets:
                what = f"{label}, final n={n}" + ("" if (rd, rr) == (True, False) else
                                                 f", resets {rd}/{rr}")
                check("trans_cmpflx", K.trans_cmpflx(*a, rd, rr, bnd_mask=y["masks"][n]),
                      K.trans_cmpflx_plain(*a, rd, rr, bnd_mask=y["masks"][n]), what)
                for q_face, df, dre, dp, side in ((a[1], a[3], a[5], a[7], "p"),
                                                  (a[0], a[2], a[4], a[6], "m")):
                    b = (q_face, df, dre, dp, y["L"], y["sp"], rd, rr)
                    check("trans_apply", K.trans_apply(*b), K.trans_apply_plain(*b),
                          f"{what} {side} state")

    def layout_state(L, dtype, shape, seed):
        """A random state of layout L on a grid: species mass fractions that
        sum to one (one species at exactly zero), aux, the shock flag, hybrid
        momenta, a cell below small_dens and two with negative energies."""
        rng = np.random.default_rng(seed)
        rho = rng.uniform(0.5, 1.5, shape)
        vel = rng.uniform(-0.4, 0.4, (3,) + shape)
        rhoe = rng.uniform(0.3, 2.0, shape) / 0.4
        u = np.zeros((L.NVAR,) + shape)
        u[L.URHO] = rho
        u[L.UMX:L.UMZ + 1] = rho * vel
        u[L.UEINT] = rhoe
        u[L.UEDEN] = rhoe + 0.5 * rho * (vel ** 2).sum(0)
        u[L.UTEMP] = 1.0
        xs = rng.uniform(0.0, 1.0, (L.nspec,) + shape)
        xs[min(1, L.nspec - 1)] = 0.0 if L.nspec > 1 else xs[0]
        u[L.UFS:L.UFS + L.nspec] = rho * xs / xs.sum(0)
        if L.naux:
            u[L.UFX:L.UFX + L.naux] = rho * rng.uniform(0.4, 0.6, (L.naux,) + shape)
        if L.shock_var:
            u[L.USHK] = rng.integers(0, 2, shape)
        if L.hybrid_momentum:
            u[L.UMR:L.UMP + 1] = rho * rng.uniform(-0.4, 0.4, (3,) + shape)
        u[L.URHO, 5, 6, 7] = 1e-14
        u[L.UEINT, 9, 9, 9] = -1.0
        u[L.UEDEN, 10, 11, 12] = -3.0
        return torch.as_tensor(u, dtype=dtype, device=dev)

    def layout_eos(L):
        names = ("He4", "C12", "O16", "Ne20", "Mg24", "Si28", "Fe56")
        net = GeneralNullNetwork(spec_names=[names[i % len(names)] for i in range(L.nspec)])
        return GammaLawEos(1.4, network=net, assume_neutral=False)

    def compare_layout(L, dtype, shape):
        """Every step kernel against its plain version at layout L: prim_aux
        (four variants), flatten, trace_ppm (alone and with CGF / HLLC +
        srcQ + walls), ctu_face (every variant, walls), clean_fill (two BC
        sets), consup (each direction, accumulating and finalizing), and
        cmpflx, trans_apply, trans_cmpflx on the 3D grid."""
        eos = layout_eos(L)
        tag = (f"nspec {L.nspec}" + (f" + {L.naux} aux" if L.naux else "")
               + (", shock flag" if L.shock_var else "") + (", hybrid" if L.hybrid_momentum
                                                            else "")
               + (", f64" if dtype == torch.float64 else ", f32"))
        sd, st, sp, se = 1e-12, 1e-12, 1e-20, 1e-200
        dxs, dtl = (1.0 / 12, 1.0 / 16, 1.0 / 20), 2e-3
        raw = layout_state(L, dtype, shape, 3)
        u = K.clean_fill_plain(raw, L, eos, (2,) * 3, (2,) * 3, 4, sd, st, 1e-4, True)
        a = (u, L, eos, sd, st, dxs)
        for wd, cd in ((True, dtl), (False, dtl), (True, None), (False, None)):
            check("prim_aux", K.prim_aux(*a, with_divu=wd, courant_dt=cd),
                  K.prim_aux_plain(*a, with_divu=wd, courant_dt=cd),
                  f"{tag}, divu {wd} courant {cd is not None}", floor=(2,) if wd else ())
        q, qaux, div = K.prim_aux_plain(*a)
        check("flatten", K.flatten(q, L), K.flatten_plain(q, L), tag)
        flatn = K.flatten_plain(q, L)
        for lo, hi in (((2, 2, 2), (2, 2, 2)), ((5, 4, 0), (2, 3, 0))):
            ca = (raw, L, eos, lo, hi, 4, sd, st, 1e-4, True)
            check("clean_fill", K.clean_fill(*ca, with_status=True),
                  K.clean_fill_plain(*ca, with_status=True), f"{tag}, bc {lo} {hi}")
        g = torch.Generator(dev).manual_seed(1)
        src = 0.05 * torch.randn(q.shape, dtype=dtype, device=dev, generator=g)
        walls = _bnd_masks(shape, 3, 4, (3,) * 3, (3,) * 3)
        tr = []
        for d in range(3):
            ta = (q, qaux, None, flatn, d, dtl, dxs[d], L, sd, sp, se)
            check("trace_ppm", K.trace_ppm(*ta), K.trace_ppm_plain(*ta), f"{tag}, d={d}")
            fr = dict(coord=0, riemann_solver=0, bnd_mask=None)
            ref = K.trace_ppm_plain(*ta, fuse_riemann=fr)
            check("trace_ppm", K.trace_ppm(*ta, fuse_riemann=fr), ref, f"{tag}, CGF d={d}")
            tr.append(ref)
            tb = (q, qaux, src, *ta[3:])
            fr = dict(coord=0, riemann_solver=2, bnd_mask=walls[d])
            check("trace_ppm", K.trace_ppm(*tb, fuse_riemann=fr),
                  K.trace_ppm_plain(*tb, fuse_riemann=fr), f"{tag}, HLLC srcQ walls d={d}")
        hs = 0.1 * u
        for d in range(3):
            t1, t2 = [t for t in range(3) if t != d]

            def term(t, f):
                return {"flux": tr[t][2], "qe": tr[t][3], "t_dir": t, "cdtdx": f * dtl / dxs[t]}

            fa = (tr[d][0], tr[d][1], qaux, d)
            fb = (L, 0, 0, sd, sp, True, False)
            fin = [term(t1, 0.5), term(t2, 0.5)]
            cs = dict(hsrc=hs, div_node=50.0 * div, u=u, difmag=0.1, dx=dxs,
                      finalize_dt=dtl if d == 2 else None)
            for terms, kw, kind in (([], {}, "terms=[]"), ([term(t2, 1 / 3)], {}, "corner t2"),
                                    ([term(t1, 1 / 3)], dict(terms2=[term(t2, 1 / 3)]), "pair"),
                                    (fin, {}, "final"), (fin, dict(consup=cs), "final+consup")):
                kw = dict(kw, bnd_mask=walls[d])
                check("ctu_face", K.ctu_face(*fa, terms, *fb, **kw),
                      K.ctu_face_plain(*fa, terms, *fb, **kw), f"{tag}, {kind} d={d}")
            gc, cc = qaux[L.QGAMC], qaux[L.QC]
            ca = (tr[d][0], tr[d][1], shifted(gc, -1, d), gc, shifted(cc, -1, d), cc, d, L, 0)
            for solver, m in ((0, None), (2, walls[d])):
                check("cmpflx", K.cmpflx(*ca, solver, sd, sp, bnd_mask=m),
                      K.cmpflx_plain(*ca, solver, sd, sp, bnd_mask=m),
                      f"{tag}, solver {solver} d={d}")
            f1, q1 = tr[t1][2], tr[t1][3]
            bp = term_bundle([term(t1, 0.5)], qaux, d, 0, L)
            bm = term_bundle([term(t1, 0.5)], qaux, d, -1, L)
            for qf, b_, side in ((tr[d][1], bp, "p"), (tr[d][0], bm, "m")):
                ta_ = (qf, *b_, L, sp, True, d == 1)
                check("trans_apply", K.trans_apply(*ta_), K.trans_apply_plain(*ta_),
                      f"{tag}, {side} state d={d}")
            tc = (tr[d][0], tr[d][1], bm[0], bp[0], bm[1], bp[1], bm[2], bp[2], *ca[2:6], d, L,
                  0, 2, sd, sp, True, False)
            check("trans_cmpflx", K.trans_cmpflx(*tc, bnd_mask=walls[d]),
                  K.trans_cmpflx_plain(*tc, bnd_mask=walls[d]), f"{tag}, HLLC walls d={d}")
            for fin_dt in (None, dtl):
                co = (hs, tr[d][2], tr[d][3][L.GDPRES], tr[d][3][L.GDU + d], 50.0 * div, u, d,
                      L, 0.1, dxs)
                check("consup", K.consup(*co, finalize_dt=fin_dt),
                      K.consup_plain(*co, finalize_dt=fin_dt),
                      f"{tag}, d={d}" + (", finalize" if fin_dt else ""))
        del raw, u, q, qaux, div, flatn, tr, hs, src

    def count_shocks(s_):
        q_, _ = au.ctoprim(s_.u, s_.layout, s_.eos, s_.cfg.small_dens, s_.small_temp)
        shk_ = au.shock(q_, s_.geom.dx, s_.layout, s_.cfg.shock_threshold)
        ctx.flagged.append(int(s_.interior(shk_[None]).sum()))

    # path G: two-level AMR (driver/amr.py) in 3D, 2D and 1D
    def amr_sim(dim, n, device="cuda", tagging=None, regrid_int=2, problem="sedov"):
        """Sedov (r_init 0.1, exp_energy 0.5, outflow) or Sod with one
        refined level, float32; tags from the pressure's relative gradient
        above 0.1 (Sod: the density's above 0.05), or from `tagging`."""
        if problem == "sod":
            p = sod.make_params(n=n, dim=1, dtype="float32")
            ind = {"amr.tag.field": "density", "amr.tag.relative_gradient": 0.05}
            init = sod.problem_init
        else:
            p = sedov.make_params(n=n, dim=dim, stop_time=1.0, r_init=0.1, exp_energy=0.5,
                                  dtype="float32")
            ind = {"amr.tag.field": "pressure", "amr.tag.relative_gradient": 0.1}
            init = sedov.problem_init
        p = p.with_ns("amr", max_level=1, regrid_int=regrid_int, n_error_buf=2,
                      refinement_indicators=() if tagging else ("tag",)).replace(extra=ind)
        return AmrSimulation(p, problem_init=init, problem_tagging=tagging, device=device)

    def amr_mass(amr):
        """Level 0's mass: covered cells hold their children's average."""
        vol = amr.sim0.geom.volume(0).double()
        return float((amr.interior(0)[amr.sim0.layout.URHO].double() * vol).sum())

    def drive_amr(label, amr, level_step, window_step, max_step=None, stop_time=None):
        """AmrSimulation.run on the card with the launch counts zeroed just
        before and read just after, checked against the hierarchy's
        structure: `level_step` launches a level-0 step tried,
        `window_step` a level-1 window's step tried (two a coarse step for
        each window, more where a retry subcycles), and in 3D one clean_fill
        of level 0 for each avgDown, of level 0 and each window at init,
        and of each new window at a regrid. Checks finite levels and level
        0's mass. Returns the coarse steps taken."""
        print(f"main path {label}, AmrSimulation.run on the card", flush=True)
        cf3 = 1 if amr.dim == 3 else 0
        rec = {"level0": 0, "window": 0, "avg_down": 0, "new_windows": 0, "windows": []}
        hooks = ("advance", "_advance_level", "_advance_extra", "_avg_down", "regrid")
        saved = {h: getattr(amr, h) for h in hooks}

        def advance(dt):
            rec["windows"].append(1 + len(amr.extra[1]))
            return saved["advance"](dt)

        def advance_level(l, dt, t):
            rec["level0" if l == 0 else "window"] += 1
            return saved["_advance_level"](l, dt, t)

        def advance_extra(*a):
            rec["window"] += 1
            return saved["_advance_extra"](*a)

        def avg_down(*a, **kw):
            rec["avg_down"] += 1
            return saved["_avg_down"](*a, **kw)

        def regrid(*a, **kw):
            out = saved["regrid"](*a, **kw)
            rec["new_windows"] += 1 + len(amr.extra[1])
            return out

        amr.advance, amr._advance_level, amr._advance_extra, amr._avg_down, amr.regrid = \
            advance, advance_level, advance_extra, avg_down, regrid
        K.reset_launch_counts()
        amr.init_data()
        rec["new_windows"] += 1 + len(amr.extra[1])
        mass0 = amr_mass(amr)
        amr.run(max_step=max_step, stop_time=stop_time, verbose=False)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        for h in hooks:
            delattr(amr, h)
        # a coarse step without a retry: one level-0 step, two steps of each
        # window, one avgDown of each window
        steps, windows = len(rec["windows"]), sum(rec["windows"])
        if rec["level0"] == steps and (rec["window"], rec["avg_down"]) != (2 * windows, windows):
            fail(f"path {label}: {rec['window']} window steps and {rec['avg_down']} avgDowns "
                 f"for {steps} coarse steps over {windows} windows, without a retry")
        expected = {name: 0 for name in launches}
        for name, v in level_step.items():
            expected[name] += v * rec["level0"]
        for name, v in window_step.items():
            expected[name] += v * rec["window"]
        expected["clean_fill"] += cf3 * (1 + rec["avg_down"] + rec["new_windows"])
        win = amr.window[1]
        frac = float(amr.masks[1].sum()) / float(np.prod(amr.geom_full[1].n_cell))
        print(f"  {amr.step_count} coarse steps, t = {amr.t:.6e}; tried {rec['level0']} level-0 "
              f"steps ({rec['level0'] - steps} in retries) and {rec['window']} window steps, "
              f"{rec['avg_down']} avgDowns, "
              f"{rec['new_windows']} windows made; level-1 window {tuple(win[1])} at "
              f"{tuple(int(v) for v in win[0])}, {len(amr.extra[1])} extra windows, refined "
              f"fraction {frac:.4f} of the fine level; launches {launches}; expected {expected}")
        if launches != expected or any(launches[k] == 0 for k, v in window_step.items() if v):
            fail(f"path {label}: the launch counts do not match the hierarchy's structure")
        if not all(bool(torch.isfinite(u).all()) for u in amr.u):
            fail(f"path {label}: non-finite state")
        mass1 = amr_mass(amr)
        dm = abs(mass1 - mass0) / mass0
        print(f"  level-0 mass: {mass0:.9e} -> {mass1:.9e}, relative change {dm:.3e} "
              f"(limit {MASS_RTOL:g})")
        if dm > MASS_RTOL:
            fail(f"path {label}: mass is not conserved")
        path_launches[label] = launches
        return amr.step_count

    def window_sim(amr):
        return amr._get_level(1, amr.window[1][1]).sim

    def amr_card_vs_cpu(label, make, steps=2):
        """`steps` coarse steps on the CPU, then the same dt sequence on the
        card, from a geometric tagging (no threshold a rounding can cross)
        and no regrid after init: the windows and masks must be equal, then
        each level is held as card_vs_cpu holds a state."""
        print(f"card vs CPU, {label} float32, {steps} coarse steps:", flush=True)
        runs, dts = {}, []
        for where in ("cpu", "cuda"):
            a = make(where)
            a.init_data()
            for k in range(steps):
                if where == "cpu":
                    dts.append(a.estimate_dt())
                a.advance(dts[k])
                a.step_count += 1
                a.dt = dts[k]
            runs[where] = a
        c, g = runs["cpu"], runs["cuda"]
        for l in range(2):
            same_win = (np.array_equal(c.window[l][0], g.window[l][0])
                        and tuple(c.window[l][1]) == tuple(g.window[l][1]))
            if not same_win or not torch.equal(c.masks[l], g.masks[l].cpu()):
                fail(f"{label}: the card's level-{l} window or mask differs from the CPU's")
            err, rel, ok = compare(g.interior(l).cpu(), c.interior(l), RTOL, floor=True)
            print(f"  level {l} (window {tuple(g.window[l][1])}): max abs err {err:.3e} rel "
                  f"{rel:.3e} (tol {RTOL:g}|cpu| + {RTOL:g} max|cpu| per component) "
                  f"{'ok' if ok else 'DISAGREES'}")
            if not ok:
                compare(g.interior(l).cpu(), c.interior(l), RTOL, floor=True, report=True)
                fail(f"the card and the CPU disagree on {label}, level {l}")

    def ball(radius):
        """Tags the cells within `radius` of the domain's centre."""
        def tag(s_, u_int, level):
            return s_.geom.radius(0) < radius
        return tag

    # path H: Strang-split reactions (reactions/strang.py: a half-dt burn and
    # clean + fill before the hydro step and after it)
    def blob_sim(n, dtype="float32", eos="gamma_law", device="cuda", physics="burn"):
        return Simulation(burning_blob.make_params(n=n, dtype=dtype, eos=eos, physics=physics),
                          problem_init=burning_blob.problem_init, device=device)

    def burn_stats(sim):
        """Wrap sim's reactor: each half burn is timed (synchronized), its
        iterations and the energy it released (sum of rho de over the
        interior's cells, erg/cm^3 x cm^3) recorded."""
        st = dict(calls=0, s=0.0, iters=[], released=0.0)
        react = sim.reactor.react
        L, ng = sim.layout, sim.ng
        vol = float(np.prod(sim.geom.dx))

        def timed(u, dt, shk=None):
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            out = react(u, dt, shk)
            torch.cuda.synchronize()
            st["s"] += time.perf_counter() - t0_
            st["calls"] += 1
            st["iters"].append(sim.reactor.burner.stats.iterations)
            inner = (slice(ng, -ng),) * L.dim
            de = (out[0][L.UEINT] - u[L.UEINT])[inner]
            st["released"] += float(de.double().sum()) * vol
            return out

        sim.reactor.react = timed
        return st

    def reacting_card_vs_cpu(label, make, rtol, steps=2, shared_momentum=False):
        """`steps` steps of make("cpu"), then the same dt sequence on
        make("cuda"), within rtol |cpu| + rtol max|cpu| per component; the
        species as mass fractions, within rtol of a zone's total of one (the
        burn's trace products are 1e-25 of the mass, where float32 and
        float64 rates differ by a percent). With `shared_momentum` the three
        momenta share the largest momentum magnitude as their floor (a
        momentum that the geometry cancels is rounding of the others)."""
        print(f"card vs CPU, {label}, {steps} step(s) {elapsed()}:", flush=True)
        runs, dts, iters = {}, [], {}
        for where in ("cpu", "cuda"):
            s_ = make(where)
            s_.init_data()
            if where == "cpu":
                s_.run(max_step=steps, verbose=False, callbacks=[lambda q_: dts.append(q_.dt)])
            else:
                for d_ in dts:
                    s_.advance(d_)
            runs[where] = s_.interior().double().cpu()
            iters[where] = None if s_.reactor is None else s_.reactor.burner.stats.iterations
        Ls = s_.layout
        spec = slice(Ls.UFS, Ls.UFS + Ls.nspec)
        rest = [c_ for c_ in range(Ls.NVAR) if not Ls.UFS <= c_ < Ls.UFS + Ls.nspec]
        gu_, ru_ = runs["cuda"], runs["cpu"]
        mag = ru_[rest].abs().flatten(1).amax(1)
        if shared_momentum:
            mom = [rest.index(c_) for c_ in (Ls.UMX, Ls.UMY, Ls.UMZ)]
            mag[mom] = mag[mom].max()
        err = (gu_[rest] - ru_[rest]).abs()
        tol = rtol * (ru_[rest].abs() + mag.reshape((-1,) + (1,) * Ls.dim))
        worst = float(torch.where(err == 0, 0.0, err / tol).max())
        x_err = float((gu_[spec] / gu_[Ls.URHO] - ru_[spec] / ru_[Ls.URHO]).abs().max())
        ok = worst <= 1.0 and x_err <= rtol
        print(f"  dt {dts}; max abs err {float(err.max()):.3e}, {worst:.3e} of the tolerance "
              f"({rtol:g} |cpu| + {rtol:g} max|cpu| per component"
              f"{', the momenta sharing theirs' if shared_momentum else ''}); mass fractions max "
              f"abs err {x_err:.3e} (tol {rtol:g}); last half burn's iterations card "
              f"{iters['cuda']}, CPU {iters['cpu']} {'ok' if ok else 'DISAGREES'}", flush=True)
        if not ok:
            compare(gu_[rest], ru_[rest], rtol, floor=True, report=True)
            fail(f"the card and the CPU disagree on {label}")
        return worst, x_err

    def blob_make(dtype_card, dtype_cpu, eos, physics="burn"):
        return lambda where: blob_sim(N_BLOB_CPU, dtype_card if where == "cuda" else dtype_cpu,
                                      eos, where, physics)

    def grav_of(s_):
        return next(fn.gravity for fn in s_.source_fns if fn.name == "grav")

    def dust_sim(n, dtype="float32", device="cuda"):
        """The 3D DustCollapse (PoissonGrav, multipole BCs, outflow) at a
        fixed dt: the CFL estimate knows no gravity (the JAX CLI's default
        run fails at t = 0, ROADMAP.md)."""
        p = dust_collapse.make_params(n=n, dim=3, dtype=dtype).with_ns("castro",
                                                                      fixed_dt=GRAV_DT)
        return Simulation(p, problem_init=dust_collapse.problem_init, device=device)

    def timed_gravity(s_):
        """Wrap the Gravity's grav_vector: the synchronized host time of each
        field (the solver reads its residual on the host every V-cycle)."""
        grav = grav_of(s_)
        st = dict(s=0.0, calls=0)
        inner = grav.grav_vector

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            out = inner(*a, **kw)
            torch.cuda.synchronize()
            st["s"] += time.perf_counter() - t0_
            st["calls"] += 1
            return out

        grav.grav_vector = timed
        return st

    def centre_rho(s_):
        """The mean density of the 2^3 cells about the centre."""
        n_ = s_.geom.n_cell[0] // 2
        ui = s_.interior()[s_.layout.URHO]
        return float(ui[n_ - 1:n_ + 1, n_ - 1:n_ + 1, n_ - 1:n_ + 1].double().mean())

    def grav_card_vs_cpu(label, make, dtype_card, dtype_cpu, rtol, steps):
        """`steps` steps on the CPU in dtype_cpu, then the same dt sequence on
        the card in dtype_card, within rtol |cpu| + rtol max|cpu| per
        component; rho e and rho T (UEINT, and UTEMP times the density: T
        is e / c_v) with their floor scaled by max|rho E| / max|rho e|: in
        the cold collapse e is E - KE, a difference the precision resolves
        only to rtol of E's scale (T alone, e over the cell's density, is
        then unbounded where the density is low)."""
        print(f"card vs CPU, {label}: {steps} steps, card {dtype_card}, CPU {dtype_cpu} "
              f"{elapsed()}:", flush=True)
        runs, dts = {}, []
        for where, dt_ in (("cpu", dtype_cpu), ("cuda", dtype_card)):
            s2 = make(where, dt_)
            s2.init_data()
            if where == "cpu":
                s2.run(max_step=steps, verbose=False, callbacks=[lambda q_: dts.append(q_.dt)])
            else:
                for d_ in dts:
                    s2.advance(d_)
            runs[where] = s2.interior().double().cpu()
            runs[where + "_solves"] = [v for v, _ in grav_of(s2).solve_stats]
        Lg = s2.layout
        rest = [c for c in range(Lg.NVAR) if c not in (Lg.UEINT, Lg.UTEMP)]
        err, rel, ok = compare(runs["cuda"][rest], runs["cpu"][rest], rtol, floor=True)

        def derived(u_):
            return torch.stack([u_[Lg.UEINT], u_[Lg.URHO] * u_[Lg.UTEMP]])

        ref_d = derived(runs["cpu"])
        ratio = float(runs["cpu"][Lg.UEDEN].abs().max() / runs["cpu"][Lg.UEINT].abs().max())
        mag = ref_d.abs().flatten(1).amax(1).reshape(-1, 1, 1, 1)
        d_err = (derived(runs["cuda"]) - ref_d).abs()
        ok_d = bool((d_err <= rtol * ref_d.abs() + rtol * max(ratio, 1.0) * mag).all())
        print(f"  max abs err {err:.3e} rel {rel:.3e} (tol {rtol:g}|cpu| + {rtol:g} max|cpu| "
              f"per component); rho e and rho T max err {float((d_err / mag).max()):.3e} of their "
              f"largest magnitude (tol {rtol:g} x max|rho E| / max|rho e| = {rtol * ratio:.3e}); "
              f"V-cycles card {runs['cuda_solves']}, CPU {runs['cpu_solves']} "
              f"{'ok' if ok and ok_d else 'DISAGREES'}")
        if not (ok and ok_d):
            compare(runs["cuda"][rest], runs["cpu"][rest], rtol, floor=True, report=True)
            fail(f"the card and the CPU disagree on {label}")

    # IG: composite gravity on two levels (tests/test_composite_gravity.py's
    # blob: 0.01 + 2 exp(-(r/0.25)^2), p = 1, order-4 multipole BCs, tags
    # where rho > 0.5), float32
    def grav_amr(dim, n, device="cuda", dtype="float32"):
        p = Params().with_ns("amr", n_cell=(n,) * dim, max_level=1, regrid_int=2,
                             refinement_indicators=("dens",))
        p = p.with_ns("geometry", prob_lo=(-1.0,) * 3, prob_hi=(1.0,) * 3)
        p = p.with_ns("castro", lo_bc=(2,) * dim, hi_bc=(2,) * dim, do_grav=1,
                      small_dens=1e-8)
        p = p.with_ns("gravity", gravity_type="PoissonGrav", max_multipole_order=4)
        p = p.replace(extra={"amr.dens.field": "density", "amr.dens.value_greater": 0.5})
        p = p.with_ns("tpu", dtype=dtype)

        def init_(s_, u_):
            r_ = s_.geom.radius(s_.ng, center=(0.0,) * s_.geom.dim)
            return fill_from_prim(s_, u_, 0.01 + 2.0 * torch.exp(-(r_ / 0.25) ** 2),
                                  (0.0, 0.0, 0.0), p=1.0)

        return AmrSimulation(p, problem_init=init_, device=device)

    def sci_sim(mod, n=None, device="cuda"):
        p = mod.make_params() if n is None else mod.make_params(n=n)
        return Simulation(p, problem_init=mod.problem_init, device=device)

    def sync_timed(fn, st):
        """fn with the synchronized host time of each call added to st."""

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            st["s"] += time.perf_counter() - t0_
            st["calls"] += 1
            return out

        return timed

    def timed_run(sim):
        """The burn and, where the setup has them, the conduction source and
        the fill hook, each timed (synchronized host clock); the counters
        restart at the end of init_data, whose own time is kept."""
        st = dict(burn=burn_stats(sim), diff=dict(s=0.0, calls=0),
                  fill=dict(s=0.0, calls=0), init=dict(s=0.0, end=None))
        for i, src in enumerate(sim.source_fns):
            if src.name == "diff":
                timed_diff = sync_timed(src, st["diff"])
                timed_diff.name, timed_diff.conductivity = src.name, src.conductivity
                sim.source_fns[i] = timed_diff
        if sim.problem_fill is not None:
            fill = sim.problem_fill
            sim.problem_fill = sync_timed(lambda u, t=0.0: fill(u, t), st["fill"])
        init = sim.init_data

        def stamped_init(*a, **kw):
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            out = init(*a, **kw)
            torch.cuda.synchronize()
            st["init"].update(s=time.perf_counter() - t0_, end=time.perf_counter())
            st["burn"].update(s=0.0, calls=0, iters=[], released=0.0)
            st["diff"].update(s=0.0, calls=0)
            st["fill"].update(s=0.0, calls=0)
            return out

        sim.init_data = stamped_init
        return st

    def time_path(key, label, make, steps, profile=0):
        """zones/s, ms/step and peak memory of `steps` steps after 2 warm-up
        steps; with `profile`, that many further steps under torch.profiler."""
        s = make()
        s.init_data()
        s.run(max_step=2, verbose=False)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zones0 = s.num_zones_advanced
        t0 = time.perf_counter()
        s.run(max_step=2 + steps, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        zps = (s.num_zones_advanced - zones0) / wall
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ctx.results[key] = dict(zones_per_s=zps, step_ms=1e3 * wall / steps, peak_gib=peak)
        amr_note = ""
        if hasattr(s, "window"):  # an AmrSimulation: zones as _count_zones counts them
            frac = float(s.masks[1].sum()) / float(np.prod(s.geom_full[1].n_cell))
            ctx.results[key].update(window=list(s.window[1][1]), refined_fraction=frac,
                                extra_windows=len(s.extra[1]))
            amr_note = (f", level-1 window {tuple(s.window[1][1])} (+{len(s.extra[1])} extra), "
                        f"refined fraction {frac:.4f}, zones a coarse step {s._count_zones(0)}")
        dname = str(getattr(s, "sim0", s).dtype).replace("torch.", "")
        print(f"main path timing [{card}]: {label} {dname}, {steps} steps "
              f"(estimate_dt + advance): {1e3 * wall / steps:.3f} ms/step, {zps:.6e} zones/s, "
              f"peak memory {peak:.3f} GiB{amr_note}", flush=True)
        if profile:
            profile_steps(s, profile, card)
        del s
        torch.cuda.empty_cache()

    # the nine step kernels at the reacting layouts: NPASS = 7 (iso7, path
    # H3's) and 19 (aprox19), the same 136^3 Sedov state with that many
    # species; cmpflx and trans_cmpflx on the 3D grid's faces
    def layout_calls(nspec):
        fxl = prof_faces.setup(N_MAIN, nspec=nspec)
        Ll, ul, dxl, dtl, cfl = fxl["layout"], fxl["u"], fxl["dx"], fxl["dt"], fxl["cfg"]
        trl, ql, qxl, dvl = fxl["tr"], fxl["q"], fxl["qaux"], fxl["div"]
        al = (ul, Ll, fxl["eos"], cfl.small_dens, fxl["small_temp"], dxl)
        cl = {"prim_aux": [(lambda: K.prim_aux(*al, courant_dt=dtl),
                            lambda: K.prim_aux_plain(*al, courant_dt=dtl),
                            Ll.NVAR - 2 + Ll.NQ + Ll.NQAUX + 1)],
              "flatten": [(lambda: K.flatten(ql, Ll), lambda: K.flatten_plain(ql, Ll), 5)]}
        for name, variant, d, kern, plain, comps in prof_faces.variants(fxl):
            if variant in ("with the solve", "corner pair", "final + consup"):
                cl.setdefault(name, []).append((kern, plain, comps))
        cfa = (ul, Ll, fxl["eos"], cfl.lo_bc, cfl.hi_bc, fxl["ng"], cfl.small_dens,
               fxl["small_temp"], 1e-4, True)
        cl["clean_fill"] = [(lambda: K.clean_fill(*cfa, with_status=True),
                             lambda: K.clean_fill_plain(*cfa, with_status=True), 2 * Ll.NVAR)]
        g_, c_ = qxl[Ll.QGAMC], qxl[Ll.QC]

        def term_l(t, f):
            return {"flux": trl[t][2], "qe": trl[t][3], "t_dir": t, "cdtdx": f * dtl / dxl[t]}

        for key in ("consup", "cmpflx", "trans_apply", "trans_cmpflx"):
            cl[key] = []
        for d in range(3):
            t1 = [t for t in range(3) if t != d][0]
            co = (torch.zeros_like(ul), trl[d][2], trl[d][3][Ll.GDPRES], trl[d][3][Ll.GDU + d],
                  dvl, ul, d, Ll, cfl.difmag, dxl)
            fin = dtl if d == 2 else None
            cl["consup"].append((lambda co=co, fin=fin: K.consup(*co, finalize_dt=fin),
                                 lambda co=co, fin=fin: K.consup_plain(*co, finalize_dt=fin),
                                 5 * Ll.NVAR + 3))
            ca = (trl[d][0], trl[d][1], shifted(g_, -1, d), g_, shifted(c_, -1, d), c_, d, Ll,
                  0, 0, cfl.small_dens, cfl.small_pres)
            cl["cmpflx"].append((lambda ca=ca: K.cmpflx(*ca), lambda ca=ca: K.cmpflx_plain(*ca),
                                 2 * Ll.NQ + 4 + Ll.NVAR + Ll.NGDNV))
            bp = term_bundle([term_l(t1, 0.5)], qxl, d, 0, Ll)
            bm = term_bundle([term_l(t1, 0.5)], qxl, d, -1, Ll)
            ta = (trl[d][1], *bp, Ll, cfl.small_pres, True, False)
            cl["trans_apply"].append((lambda ta=ta: K.trans_apply(*ta),
                                      lambda ta=ta: K.trans_apply_plain(*ta),
                                      2 * Ll.NQ + Ll.NVAR + 2))
            tc = (trl[d][0], trl[d][1], bm[0], bp[0], bm[1], bp[1], bm[2], bp[2], *ca[2:6], d,
                  Ll, 0, 0, cfl.small_dens, cfl.small_pres, True, False)
            cl["trans_cmpflx"].append((lambda tc=tc: K.trans_cmpflx(*tc),
                                       lambda tc=tc: K.trans_cmpflx_plain(*tc),
                                       2 * Ll.NQ + 2 * Ll.NVAR + 8 + Ll.NVAR + Ll.NGDNV))
        if nspec == 19:
            cl["consup, float64"] = consup_f64_calls(fxl)
        return cl, ul

    def consup_f64_calls(fx_):
        """consup alone in each direction on prof_faces.setup's inputs cast
        to float64 (the kernel's float64 build at the same state)."""
        x64 = prof_faces.cast(fx_, torch.float64)
        return [(kern, plain, comps) for _, kern, plain, comps in prof_faces.consup_variants(x64)]

    def phase_kernels():




        print(f"kernel vs plain, {N_MAIN}^3 Sedov float32 (main-path shapes):", flush=True)
        sim = sedov_sim(N_MAIN)
        sim.init_data()
        dt = sim.estimate_dt()
        compare_step(inputs(sim, sim.u, dt), "Sedov init")
        sim.advance(dt)
        compare_step(inputs(sim, sim.u, dt), "after 1 step", off_path=True)
        del sim
        print(f"kernel vs plain, {N_SMALL}^3, branches off the main path:", flush=True)
        for bc, solver, label in ((3, 2, "symmetry walls, HLLC"), (0, 0, "periodic"),
                                  (5, 0, "no-slip walls")):
            s = sedov_sim(N_SMALL, bc=bc)
            s.init_data()
            dts = s.estimate_dt()
            s.advance(dts)
            x = inputs(s, s.u, dts)
            g = torch.Generator(dev).manual_seed(0)
            src = 1e-3 * x["q"].abs() * torch.randn(x["q"].shape, device=dev, generator=g)
            compare_step(x, f"{label}, srcQ", solver=solver, src=src, off_path=True)
            args = (s.u, s.layout, s.eos, s.cfg.small_dens, s.small_temp, s.geom.dx)
            check("prim_aux", K.prim_aux(*args, with_divu=False),
                  K.prim_aux_plain(*args, with_divu=False), f"{label}, no divu")







        print(f"kernel vs plain, {N_MAIN}^3 Sedov float32, the unfused structure's shapes:",
              flush=True)
        sim = sedov_sim(N_MAIN)
        sim.init_data()
        dt = sim.estimate_dt()
        sim.advance(dt)
        compare_unfused_3d(inputs(sim, sim.u, dt), "after 1 step")
        del sim
        s = sedov_sim(N_SMALL, bc=3)
        s.init_data()
        dts = s.estimate_dt()
        s.advance(dts)
        compare_unfused_3d(inputs(s, s.u, dts), f"{N_SMALL}^3 symmetry walls")
        grown = " x ".join(str(n + 8) for n in RAGGED)
        print(f"kernel vs plain, Sedov {grown} grown (prime extents), symmetry walls:", flush=True)
        s = sedov_sim(N_SMALL, bc=3, n_cell=RAGGED)
        s.init_data()
        dts = s.estimate_dt()
        s.advance(dts)
        x = inputs(s, s.u, dts)
        compare_step(x, "ragged", off_path=True)
        compare_step(x, "ragged, HLLC", solver=2)
        compare_unfused_3d(x, "ragged")
        del s, x
        torch.cuda.empty_cache()
        print(f"kernel vs plain, 2D Sedov {N_2D}^2 and 1D Sod {N_1D} float32 (path C's shapes):",
              flush=True)
        sim = sedov_sim(N_2D, dim=2)
        sim.init_data()
        dt = sim.estimate_dt()
        sim.advance(dt)
        y = inputs_low_dim(sim, sim.u, dt)
        compare_low_dim(y, f"2D {N_2D}^2 after 1 step")
        del sim, y
        torch.cuda.empty_cache()
        sim = sod_sim(N_1D)
        sim.run(max_step=20, verbose=False)
        compare_low_dim(inputs_low_dim(sim, sim.u, sim.dt), f"1D Sod {N_1D} after 20 steps")
        del sim
        print(f"kernel vs plain, 2D {N_2D_SMALL}^2, branches off the main paths:", flush=True)
        s = sedov_sim(N_2D_SMALL, dim=2, bc=3)
        s.init_data()
        for _ in range(3):
            s.advance(s.estimate_dt())
        compare_low_dim(inputs_low_dim(s, s.u, s.estimate_dt(), solver=2),
                        "symmetry walls, HLLC", resets=((True, False), (True, True), (False, False)))
        del s
        torch.cuda.empty_cache()
        print(f"kernel vs plain, RZ {N_RZ} x {2 * N_RZ} (coord 1) and 1D spherical {N_SPH} "
              f"(coord 2), float32 (path E's shapes):", flush=True)
        for geometry, n in (("rz", N_RZ), ("sph", N_SPH)):
            s = curvilinear_sim(geometry, n)
            s.init_data()
            dts = s.estimate_dt()
            s.advance(dts)
            compare_low_dim(inputs_low_dim(s, s.u, dts), f"{geometry} after 1 step")
            del s
            torch.cuda.empty_cache()

        # the reacting layouts: 7, 13 and 19 species (iso7, aprox13, aprox19),
        # the shock flag, hybrid momenta and an aux component, on the ragged grid
        # in float32 and float64 (tests/test_torch_cuda_layouts.py's cases)
        grown_r = tuple(n + 8 for n in RAGGED)
        print(f"kernel vs plain at the reacting layouts, {' x '.join(map(str, grown_r))} grown "
              f"(prime extents), float32 and float64 {elapsed()}:", flush=True)
        for dtype in (torch.float32, torch.float64):
            for lay in LAYOUTS:
                compare_layout(StateLayout(dim=3, nspec=lay[0], naux=lay[1], shock_var=lay[2],
                                           hybrid_momentum=lay[3]), dtype, grown_r)

    # -- 4. the main path -------------------------------------------------------------
    path_launches = {}

    def mass(sim):
        """The interior's mass, sum of rho times the cell volume."""
        vol = sim.geom.volume(0).double()
        return float((sim.interior()[sim.layout.URHO].double() * vol).sum())

    def drive(label, sim, per_try, max_step=None, stop_time=None, callbacks=None,
              conserves_mass=True, outflow=False):
        """Run `sim` through Simulation.run with the launch counts zeroed just
        before and read just after; check them against `per_try` (launches a
        tried step; clean_fill once more at init where the kernel cleans),
        finite values and, unless an inflow feeds the grid, mass
        conservation; with `outflow`, the mass change must equal the mass the
        steps' boundary fluxes carried out (no step may be retried). Returns
        the number of steps tried."""
        print(f"main path {label}, Simulation.run on the card {elapsed()}", flush=True)
        tries = {"n": 0, "out": 0.0}
        step_impl = sim._step_impl
        if outflow:
            sim.keep_fluxes = True

        def counted(*a, **kw):
            tries["n"] += 1
            out = step_impl(*a, **kw)
            if outflow:  # interior face fluxes: the first and last face along d
                dxs = sim.geom.dx
                for d_, f_ in enumerate(out[3]):
                    rho_f = f_[sim.layout.URHO].double()
                    area = float(np.prod([dxs[k] for k in range(len(dxs)) if k != d_]))
                    net = (rho_f.narrow(d_, rho_f.shape[d_] - 1, 1).sum()
                           - rho_f.narrow(d_, 0, 1).sum())
                    tries["out"] += float(a[1]) * area * float(net)
                out = out[:3] + out[4:]
            return out

        sim._step_impl = counted
        K.reset_launch_counts()
        sim.init_data()
        mass0 = mass(sim)
        sim.run(max_step=max_step, stop_time=stop_time, verbose=False, callbacks=callbacks)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        n = tries["n"]
        expected = {name: per_try.get(name, 0) * n for name in launches}
        if sim._kernel_clean_fill:
            expected["clean_fill"] += 1
        print(f"  {sim.step_count} steps ({n} tried), t = {sim.t:.6e}; launches {launches}; "
              f"expected {expected}")
        if launches != expected or any(launches[k] == 0 for k, v in per_try.items() if v):
            fail(f"path {label}: the launch counts do not match the step's structure")
        u_end = sim.interior()
        if not bool(torch.isfinite(u_end).all()):
            fail(f"path {label}: non-finite state")
        mass1 = mass(sim)
        dm = abs(mass1 - mass0 + tries["out"]) / mass0
        print(f"  mass: {mass0:.9e} -> {mass1:.9e}"
              + (f", out through the boundaries {tries['out']:.9e}" if outflow else "")
              + f", relative change {dm:.3e} "
              + (f"(limit {MASS_RTOL:g})" if conserves_mass else "(inflow: not checked)"))
        if conserves_mass and dm > MASS_RTOL:
            fail(f"path {label}: mass is not conserved")
        if outflow and n != sim.step_count:
            fail(f"path {label}: a step was retried, its boundary fluxes counted twice")
        path_launches[label] = launches
        sim._step_impl = step_impl
        sim.keep_fluxes = False
        return n

    def card_vs_cpu(label, make, steps=3, per_try=None):
        """`steps` steps on the CPU (the plain versions), then the same dt
        sequence on the card; optionally the card run's launch counts."""
        print(f"card vs CPU, {label} float32, {steps} steps (CPU through the plain versions):",
              flush=True)
        runs, dts = {}, []
        for where in ("cpu", "cuda"):
            s = make(where)
            s.init_data()
            if where == "cpu":
                s.run(max_step=steps, verbose=False, callbacks=[lambda s_: dts.append(s_.dt)])
            else:  # the same dt sequence on the card
                K.reset_launch_counts()
                for d_ in dts:
                    s.advance(d_)
                if per_try is not None:
                    got = {k: v for k, v in K.launch_counts().items() if k in per_try}
                    want = {k: v * len(dts) for k, v in per_try.items()}
                    print(f"  launches {got}; expected {want}")
                    if got != want:
                        fail(f"{label}: the launch counts do not match the step's structure")
            runs[where] = s.interior().cpu()
        err, rel, ok = compare(runs["cuda"], runs["cpu"], RTOL, floor=True)
        print(f"  max abs err {err:.3e} rel {rel:.3e} (tol {RTOL:g}|cpu| + {RTOL:g} max|cpu| "
              f"per component) {'ok' if ok else 'DISAGREES'}")
        if not ok:
            compare(runs["cuda"], runs["cpu"], RTOL, floor=True, report=True)
            fail(f"the card and the CPU disagree on {label}")

    FUSED = {"prim_aux": 1, "flatten": 1, "trace_ppm": 3, "ctu_face": 6, "clean_fill": 1}
    UNFUSED = {"prim_aux": 1, "flatten": 1, "trace_ppm": 3, "trans_apply": 18, "consup": 3,
               "clean_fill": 1}
    TWO_D = {"cmpflx": 2, "trans_cmpflx": 2}
    TWO_D_UNFUSED = {"trans_apply": 4, "cmpflx": 0, "trans_cmpflx": 0}
    ONE_D = {"cmpflx": 1}

    def path_a():
        # path A: the fused 3D structure
        drive(f"A: Sedov {N_MAIN}^3 float32, {STEPS_MAIN} steps", sedov_sim(N_MAIN), FUSED,
              max_step=STEPS_MAIN)
        card_vs_cpu(f"Sedov {N_SMALL}^3", lambda where: sedov_sim(N_SMALL, device=where))

    def path_b():
        # path B: the unfused 3D structure
        drive(f"B: Sedov {N_MAIN}^3 float32 riemann_solver=1, {STEPS_MAIN} steps",
              sedov_sim(N_MAIN, riemann_solver=1), UNFUSED, max_step=STEPS_MAIN)
        torch.cuda.empty_cache()
        flagged = ctx.flagged = []


        drive(f"B: Sedov {N_HYBRID}^3 float32 hybrid_riemann=1, {STEPS_HYBRID} steps",
              sedov_sim(N_HYBRID, hybrid_riemann=1), UNFUSED, max_step=STEPS_HYBRID,
              callbacks=[count_shocks])
        print(f"  zones the shock detector flags after each step (the next step's faces beside "
              f"them take the HLL flux): {flagged}")
        if max(flagged[:-1]) == 0:
            fail("path B with hybrid_riemann: no zone was flagged, no face took the HLL flux")
        card_vs_cpu(f"Sedov {N_SMALL}^3 riemann_solver=1",
                    lambda where: sedov_sim(N_SMALL, device=where, riemann_solver=1),
                    per_try=UNFUSED)
        card_vs_cpu(f"Sedov {N_SMALL}^3 hybrid_riemann=1",
                    lambda where: sedov_sim(N_SMALL, device=where, hybrid_riemann=1), steps=8)

    def path_c():
        # path C: 2D and 1D
        drive(f"C: 2D Sedov {N_2D}^2 float32, {STEPS_2D} steps", sedov_sim(N_2D, dim=2), TWO_D,
              max_step=STEPS_2D)
        torch.cuda.empty_cache()
        sim = sod_sim(N_1D)
        t0 = time.perf_counter()
        n_sod = drive(f"C: 1D Sod n={N_1D} float32 to t=0.2", sim, ONE_D, stop_time=0.2)
        sod_ms = ctx.sod_ms = 1e3 * (time.perf_counter() - t0) / n_sod
        rho = sim.interior()[sim.layout.URHO].double().cpu().numpy()
        xc = sim.geom.cell_centers_1d(0, 0).double().cpu().numpy()
        rho_ex, _, _ = exact_solution(xc, sim.t, 0.5, 1.0, 0.0, 1.0, 0.125, 0.0, 0.1, 1.4)
        l1 = ctx.l1 = float(abs(rho - rho_ex).mean() / rho_ex.mean())
        print(f"  1D Sod at t = {sim.t:.6f}: mean |rho - exact| / mean exact = {l1:.6e} "
              f"(bound {SOD_L1_BOUND}); {sod_ms:.3f} ms/step over {n_sod} steps, init included "
              f"[{card}]")
        if not l1 < SOD_L1_BOUND:
            fail("1D Sod disagrees with the exact Riemann solution")
        del sim
        card_vs_cpu(f"2D Sedov {N_2D_SMALL}^2",
                    lambda where: sedov_sim(N_2D_SMALL, dim=2, device=where), per_try=TWO_D)
        card_vs_cpu(f"2D Sedov {N_2D_SMALL}^2 riemann_solver=1",
                    lambda where: sedov_sim(N_2D_SMALL, dim=2, device=where, riemann_solver=1),
                    per_try=TWO_D_UNFUSED)
        card_vs_cpu("1D Sod n=256", lambda where: sod_sim(256, device=where), steps=10,
                    per_try=ONE_D)

    def path_d():
        # path D: PLM, the flux limiters, speed_limit, transverse_use_eos in 3D
        PLM_3D = {"prim_aux": 1, "flatten": 1, "ctu_face": 9, "clean_fill": 1, "trace_ppm": 0}
        LIMITED_3D = {"prim_aux": 1, "flatten": 1, "trace_ppm": 3, "ctu_face": 6, "consup": 0,
                      "clean_fill": 1}
        SPEED_LIMITED_3D = dict(LIMITED_3D, clean_fill=0)
        NO_KERNELS = {name: 0 for name in K.launch_counts()}
        drive(f"D: Sedov {N_MAIN}^3 float32 ppm_type=0, {STEPS_MAIN} steps",
              sedov_sim(N_MAIN, ppm_type=0), PLM_3D, max_step=STEPS_MAIN)
        drive(f"D: Sedov {N_MAIN}^3 float32 limit_fluxes_on_small_dens=1, 5 steps",
              sedov_sim(N_MAIN, limit_fluxes_on_small_dens=1), LIMITED_3D, max_step=5)
        torch.cuda.empty_cache()
        card_vs_cpu(f"Sedov {N_SMALL}^3 ppm_type=0",
                    lambda where: sedov_sim(N_SMALL, device=where, ppm_type=0), per_try=PLM_3D)
        card_vs_cpu(f"Sedov {N_SMALL}^3 speed_limit=1",
                    lambda where: sedov_sim(N_SMALL, device=where, speed_limit=1.0),
                    per_try=SPEED_LIMITED_3D)
        card_vs_cpu(f"Sedov {N_SMALL}^3 transverse_use_eos=1",
                    lambda where: sedov_sim(N_SMALL, device=where, transverse_use_eos=1),
                    per_try=NO_KERNELS)

    def path_e():
        # path E: RZ and spherical
        RZ = {"cmpflx": 4}
        drive(f"E: 2D RZ Sedov {N_RZ} x {2 * N_RZ} float32, {STEPS_RZ} steps",
              curvilinear_sim("rz", N_RZ), RZ, max_step=STEPS_RZ)
        torch.cuda.empty_cache()
        cuts = {}
        for geometry, per_try in (("sph", ONE_D), ("rz", RZ)):
            sim = curvilinear_sim(geometry, N_SPH)
            t0 = time.perf_counter()
            n_tried = drive(f"E: {'1D spherical' if geometry == 'sph' else '2D RZ'} Sedov "
                            f"n={N_SPH} float32 to t=0.01", sim, per_try, stop_time=0.01)
            ms = 1e3 * (time.perf_counter() - t0) / n_tried
            rho = sim.interior()[sim.layout.URHO].double().cpu().numpy()
            cuts[geometry] = rho if geometry == "sph" else 0.5 * (rho[:, N_SPH - 1] + rho[:, N_SPH])
            print(f"  {ms:.3f} ms/step over {n_tried} steps, init included [{card}]")
            del sim
            torch.cuda.empty_cache()
        rz_l1 = ctx.rz_l1 = float(abs(cuts["rz"] - cuts["sph"]).mean() / cuts["sph"].mean())
        peak_shift = ctx.peak_shift = abs(int(cuts["rz"].argmax()) - int(cuts["sph"].argmax()))
        print(f"  RZ midplane vs 1D spherical at t = 0.01: relative L1 {rz_l1:.6e} (bound "
              f"{RZ_L1_BOUND}), peaks {peak_shift} cells apart (bound {RZ_PEAK_CELLS})")
        if not (rz_l1 < RZ_L1_BOUND and peak_shift <= RZ_PEAK_CELLS):
            fail("the RZ midplane disagrees with the 1D spherical run")
        card_vs_cpu("2D RZ Sedov 32 x 64", lambda where: curvilinear_sim("rz", 32, device=where),
                    per_try=RZ)
        card_vs_cpu("1D spherical Sedov n=128",
                    lambda where: curvilinear_sim("sph", 128, device=where), steps=10,
                    per_try=ONE_D)

    def path_f():
        # path F: double Mach reflection and the acoustic pulse
        sim = dmr_sim(DMR_CHECK)
        drive(f"F: 2D double Mach reflection {DMR_CHECK[0]} x {DMR_CHECK[1]} float32 to t=0.05",
              sim, TWO_D, stop_time=0.05, conserves_mass=False)
        L = sim.layout
        rho = sim.interior()[L.URHO].double().cpu().numpy()
        xc = sim.geom.cell_centers_1d(0, 0).double().cpu().numpy()
        xs_num = float(xc[abs(np.diff(rho[:, -1])).argmax()])
        xs_ana = 1 / 6 + 1.0 / np.tan(np.pi / 3) + (10 / np.sin(np.pi / 3)) * sim.t
        dmr_checks = ctx.dmr_checks = dict(rho_max=float(rho.max()), shock_x=xs_num, shock_x_exact=xs_ana,
                          pre_shock_rho=float(rho[-1, 0]))
        print(f"  DMR at t = {sim.t:.6f}: {dmr_checks} (tests/test_double_mach.py: rho max > 12, "
              f"|shock x - exact| < {4 * 4.0 / DMR_CHECK[0]}, pre-shock rho 1.4 to 1e-6)")
        if not (np.isfinite(rho).all() and rho.max() > 12.0
                and abs(xs_num - xs_ana) < 4 * 4.0 / DMR_CHECK[0]
                and abs(rho[-1, 0] - 1.4) <= 1e-6 * 1.4):
            fail("double Mach reflection fails the checks of tests/test_double_mach.py")
        del sim
        drive(f"F: 2D double Mach reflection {DMR_BIG[0]} x {DMR_BIG[1]} float32, {STEPS_DMR} "
              f"steps", dmr_sim(DMR_BIG), TWO_D, max_step=STEPS_DMR, conserves_mass=False)
        torch.cuda.empty_cache()
        card_vs_cpu("2D double Mach reflection 64 x 16", lambda where: dmr_sim((64, 16), where),
                    per_try=TWO_D)
        card_vs_cpu("2D acoustic pulse 64^2", lambda where: pulse_sim(64, where), per_try=TWO_D)

    def path_g():






        G_FUSED_WINDOW = {k: v for k, v in FUSED.items() if k != "clean_fill"}
        amr = amr_sim(3, N_AMR)
        drive_amr(f"G: 3D Sedov AMR {N_AMR}^3 + 1 level float32, {STEPS_AMR} coarse steps", amr,
                  FUSED, G_FUSED_WINDOW, max_step=STEPS_AMR)
        print(f"kernel vs plain, the level-1 window of path G3D "
              f"({' x '.join(str(n) for n in amr.u[1].shape[1:])} grown):", flush=True)
        ws = window_sim(amr)
        dtw = amr.estimate_dt() / 2
        compare_step(inputs(ws, amr.u[1], dtw), "G3D window")
        g3d_window = ctx.g3d_window = tuple(amr.window[1][1])
        del amr, ws
        torch.cuda.empty_cache()
        amr_card_vs_cpu(f"3D Sedov AMR {N_SMALL}^3 + 1 level",
                        lambda where: amr_sim(3, N_SMALL, where, tagging=ball(0.15), regrid_int=0))

        amr = amr_sim(2, N_AMR_2D)
        drive_amr(f"G: 2D Sedov AMR {N_AMR_2D}^2 + 1 level float32, {STEPS_AMR_2D} coarse steps",
                  amr, TWO_D, TWO_D, max_step=STEPS_AMR_2D)
        ws = window_sim(amr)
        compare_low_dim(inputs_low_dim(ws, amr.u[1], amr.estimate_dt() / 2),
                        f"G2D window {tuple(amr.u[1].shape[1:])} grown")
        del amr, ws
        torch.cuda.empty_cache()
        amr_card_vs_cpu(f"2D Sedov AMR {N_2D_SMALL}^2 + 1 level",
                        lambda where: amr_sim(2, N_2D_SMALL, where, tagging=ball(0.15),
                                              regrid_int=0))

        amr = amr_sim(1, N_AMR_1D, problem="sod")
        t0 = time.perf_counter()
        n_g1 = drive_amr(f"G: 1D Sod AMR n={N_AMR_1D} + 1 level float32 to t=0.2", amr, ONE_D, ONE_D,
                         stop_time=0.2)
        g1_ms = ctx.g1_ms = 1e3 * (time.perf_counter() - t0) / n_g1
        comp = amr.composite_interior()[amr.sim0.layout.URHO].double().cpu().numpy()
        xc = amr.geom_full[1].cell_centers_1d(0, 0).double().cpu().numpy()
        rho_ex, _, _ = exact_solution(xc, amr.t, 0.5, 1.0, 0.0, 1.0, 0.125, 0.0, 0.1, 1.4)
        g1_l1 = ctx.g1_l1 = float(abs(comp - rho_ex).mean() / rho_ex.mean())
        print(f"  1D Sod AMR at t = {amr.t:.6f}: composite mean |rho - exact| / mean exact = "
              f"{g1_l1:.6e} (bound {SOD_L1_BOUND}); {g1_ms:.3f} ms a coarse step over {n_g1}, "
              f"init and regrids included [{card}]")
        if not g1_l1 < SOD_L1_BOUND:
            fail("1D Sod AMR disagrees with the exact Riemann solution")
        ws = window_sim(amr)
        compare_low_dim(inputs_low_dim(ws, amr.u[1], amr.dt / 2),
                        f"G1D window {tuple(amr.u[1].shape[1:])} grown")
        del amr, ws
        amr_card_vs_cpu("1D Sod AMR n=256 + 1 level",
                        lambda where: amr_sim(1, 256, where, problem="sod", regrid_int=0,
                                              tagging=lambda s_, u_, l_: (
                                                  s_.geom.cell_centers_1d(0, 0) - 0.5).abs() < 0.1),
                        steps=4)

    def path_h():


        # the kernels at path H's shapes: the blob's initial state, NPASS = 7,
        # float32 with the gamma law, float64 with Helmholtz (face kernels)
        print(f"kernel vs plain, the burning blob {N_H3}^3 iso7 (NPASS = 7) {elapsed()}:",
              flush=True)
        for dtype, eos in (("float32", "gamma_law"), ("float64", "helmholtz")):
            s_ = blob_sim(N_H3, dtype, eos)
            s_.init_data()
            compare_step(inputs(s_, s_.u, s_.estimate_dt()), f"blob {eos} {dtype}",
                         cells=eos == "gamma_law")
            del s_
            torch.cuda.empty_cache()

        FUSED_STRANG = dict(FUSED, clean_fill=3)  # clean + fill after each half burn
        FACES = {"flatten": 1, "trace_ppm": 3, "ctu_face": 6}  # Helmholtz: no prim_aux/clean_fill
        h_results = ctx.h_results = {}
        for key, dtype, eos, per_try in (("H3-gl", "float32", "gamma_law", FUSED_STRANG),
                                         ("H3-helm", "float64", "helmholtz", FACES)):
            sim = blob_sim(N_H3, dtype, eos)
            st = burn_stats(sim)
            # the steps are timed from the end of init_data (synchronized)
            stamps = []
            init = sim.init_data

            def stamped_init(*a, **kw):
                out = init(*a, **kw)
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                return out

            sim.init_data = stamped_init
            n_h = drive(f"{key}: burning blob {N_H3}^3 iso7 {eos} {dtype}, {STEPS_H3} steps", sim,
                        per_try, max_step=STEPS_H3, outflow=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - stamps[0]
            sim.init_data = init
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            h_results[key] = dict(step_ms=1e3 * wall / n_h, burn_share=st["s"] / wall,
                                  iters=st["iters"], released_erg=st["released"], peak_gib=peak,
                                  zones_per_s=sim.num_zones_advanced / wall)
            print(f"  [{card}] {1e3 * wall / n_h:.1f} ms a step, the mean of {n_h} steps after "
                  f"init; burns {st['s']:.2f} s of {wall:.2f} s ({st['s'] / wall:.4f}), "
                  f"{st['calls']} half burns, iterations each {st['iters']}; energy released "
                  f"{st['released']:.6e} erg; peak memory {peak:.3f} GiB", flush=True)
            if not st["released"] > 0.0:
                fail(f"path {key}: the hot zone released no energy")
            del sim
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()



        # float32 on the card against float64 on the CPU: the f32-vs-f64 budget of
        # tests/test_f32_physics.py:53-75 (1e-4)
        reacting_card_vs_cpu(f"H3-gl: {N_BLOB_CPU}^3 blob, card float32, CPU float64",
                             blob_make("float32", "float64", "gamma_law"), F32_VS_F64)
        reacting_card_vs_cpu(f"H3-helm: {N_BLOB_CPU}^3 blob, float64",
                             blob_make("float64", "float64", "helmholtz"), F64_RTOL, steps=1)

        # H1: the 1D detonation (powerlaw, gamma law 1.4, float64; cmpflx with
        # NPASS = 3), tests/test_problems.py:64-79's checks; the same steps on
        # the CPU hold the fuel burnt, and cmpflx is held on the final state
        sim = Simulation(detonation.make_params(n=N_DET), problem_init=detonation.problem_init)
        L = sim.layout
        det_dts = []
        t0 = time.perf_counter()
        n_det = drive(f"H1: detonation n={N_DET} float64 to t=0.4 (at most {STEPS_DET} steps)", sim,
                      ONE_D, stop_time=0.4, max_step=STEPS_DET, outflow=True,
                      callbacks=[lambda q_: det_dts.append(q_.dt)])
        det_ms = ctx.det_ms = 1e3 * (time.perf_counter() - t0) / n_det
        compare_low_dim(inputs_low_dim(sim, sim.u, sim.dt), f"H1 detonation n={N_DET} float64")
        ui = sim.interior().double()
        sims = {}
        for where in ("cpu", "cuda"):
            sims[where] = Simulation(detonation.make_params(n=N_DET),
                                     problem_init=detonation.problem_init, device=where)
            sims[where].init_data()
        fuel0 = float(sims["cuda"].interior()[L.UFS].double().sum())
        fuel_ratio = ctx.fuel_ratio = float(ui[L.UFS].sum()) / fuel0
        mom_max = ctx.mom_max = float(ui[L.UMX].abs().max())
        t_cpu = time.perf_counter()
        for d_ in det_dts:
            sims["cpu"].advance(d_)
        t_cpu = time.perf_counter() - t_cpu
        u_cpu = sims["cpu"].interior()
        burnt, burnt_cpu = 1.0 - fuel_ratio, 1.0 - float(u_cpu[L.UFS].sum()) / fuel0
        burnt_err = abs(burnt - burnt_cpu) / burnt_cpu
        err, rel, _ = compare(ui.cpu(), u_cpu, F64_RTOL, floor=True)
        print(f"  [{card}] {det_ms:.3f} ms a step; t = {sim.t:.6e} after {sim.step_count} steps; "
              f"fuel / initial fuel {fuel_ratio:.9f} (tests/test_problems.py asks < 0.9 at n=128 "
              f"after 2000 steps, t ~ 1.5e-3); max |rho u| {mom_max:.6e} (> 1e-3); the same "
              f"steps on the CPU ({t_cpu:.1f} s): fuel burnt {burnt:.9e} card, {burnt_cpu:.9e} CPU,"
              f" {burnt_err:.3e} apart (tol {DET_BURNT_RTOL:g}); state max abs err {err:.3e} rel "
              f"{rel:.3e}", flush=True)
        if not (mom_max > 1e-3 and fuel_ratio < 1.0):
            fail("H1: the detonation did not burn or did not move")
        if not burnt_err <= DET_BURNT_RTOL:
            fail("H1: the card and the CPU burnt different amounts of fuel")
        h_results["H1"] = dict(step_ms=det_ms, fuel_ratio=fuel_ratio, burnt_rel_err=burnt_err)
        del sim, sims, u_cpu
        print("card vs CPU, H1: detonation n=64, 10 steps, float64:", flush=True)
        runs, dts = {}, []
        for where in ("cpu", "cuda"):
            s_ = Simulation(detonation.make_params(n=64), problem_init=detonation.problem_init,
                            device=where)
            s_.init_data()
            if where == "cpu":
                s_.run(max_step=10, verbose=False, callbacks=[lambda q_: dts.append(q_.dt)])
            else:
                for d_ in dts:
                    s_.advance(d_)
            runs[where] = s_.interior().cpu()
        err, rel, ok = compare(runs["cuda"], runs["cpu"], F64_RTOL, floor=True)
        print(f"  max abs err {err:.3e} rel {rel:.3e} (tol {F64_RTOL:g}|cpu| + {F64_RTOL:g} "
              f"max|cpu| per component) {'ok' if ok else 'DISAGREES'}")
        if not ok:
            compare(runs["cuda"], runs["cpu"], F64_RTOL, floor=True, report=True)
            fail("the card and the CPU disagree on the detonation")

        # H-burn: aprox19 with Helmholtz, float64, StrangReactor.react on a 32^3
        # box at rho 1e6 and T 3e9 +- 10% (tests/test_f32_physics.py:78-116's
        # setup), the card against the CPU on an 8^3 corner of the same zones
        from castro_tpu_torch.config import Params
        from castro_tpu_torch.eos import make_eos
        from castro_tpu_torch.network import make_network
        from castro_tpu_torch.reactions.strang import StrangReactor
        from castro_tpu_torch.state import layout_from_params
        import dataclasses as dc

        p = Params().with_ns("network", network_name="aprox19").with_ns("eos", eos_name="helmholtz")
        p = p.with_ns("tpu", dtype="float64")
        hb = {}
        for where, n_b in (("cuda", N_SMALL), ("cpu", 8)):
            net = make_network(p)
            pp = dc.replace(p, network=dc.replace(p.network, nspec=net.nspec,
                                                  spec_names=net.spec_names))
            L = layout_from_params(pp)
            eos = make_eos(pp, net)
            reactor = StrangReactor(pp, net, eos, L)
            g = torch.Generator("cpu").manual_seed(7)
            T = 3e9 * (1.0 + 0.1 * (2 * torch.rand((N_SMALL,) * 3, generator=g,
                                                    dtype=torch.float64) - 1))
            T = T[:n_b, :n_b, :n_b].to(where)
            rho = torch.full_like(T, 1e6)
            xn = torch.zeros((net.nspec,) + T.shape, dtype=T.dtype, device=where)
            xn[net.spec_names.index("He4")] = 1.0
            es = eos.rt(rho=rho, T=T, xn=xn)
            u = torch.zeros((L.NVAR,) + T.shape, dtype=T.dtype, device=where)
            u[L.URHO], u[L.UTEMP], u[L.UEINT], u[L.UEDEN] = rho, T, rho * es.e, rho * es.e
            u[L.UFS:L.UFS + L.nspec] = rho[None] * xn
            if where == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = reactor.react(u, 1e-8)
            if where == "cuda":
                torch.cuda.synchronize()
            hb[where] = (out, time.perf_counter() - t0, reactor.burner.stats.iterations)
        # the state but its species, and enuc: F64_RTOL |cpu| + F64_RTOL max|cpu|;
        # the mass fractions within F64_RTOL (a zone's total is one) and
        # omega_dot within F64_RTOL of its zone's largest rate (species the burn
        # leaves at zero come out at zero on one device and at 1e-12 on the
        # other, from the LU solves' rounding)
        Lb = L
        gu, ru = hb["cuda"][0][0][:, :8, :8, :8].cpu(), hb["cpu"][0][0]
        spec = slice(Lb.UFS, Lb.UFS + Lb.nspec)
        rest = [c for c in range(Lb.NVAR) if not Lb.UFS <= c < Lb.UFS + Lb.nspec]
        err, rel, ok = compare([gu[rest], hb["cuda"][0][2][:8, :8, :8].cpu()],
                               [ru[rest], hb["cpu"][0][2]], F64_RTOL, floor=True)
        x_err = float((gu[spec] / gu[Lb.URHO] - ru[spec] / ru[Lb.URHO]).abs().max())
        god, rod = hb["cuda"][0][1][:, :8, :8, :8].cpu(), hb["cpu"][0][1]
        w_err = float(((god - rod).abs() / rod.abs().amax(0, keepdim=True).clamp(min=1e-300)).max())
        ok = ok and x_err <= F64_RTOL and w_err <= F64_RTOL
        rel = max(rel, x_err, w_err)
        print(f"H-burn [{card}]: aprox19 + Helmholtz float64, react(dt=1e-8) on {N_SMALL}^3: "
              f"{hb['cuda'][1]:.3f} s, {hb['cuda'][2]} iterations; CPU on 8^3: {hb['cpu'][1]:.3f} s,"
              f" {hb['cpu'][2]} iterations; card vs CPU on the 8^3 corner: state and enuc max abs "
              f"err {err:.3e} (tol {F64_RTOL:g}|cpu| + {F64_RTOL:g} max|cpu| per component), mass "
              f"fractions {x_err:.3e} (tol {F64_RTOL:g}), omega_dot {w_err:.3e} of the zone's "
              f"largest rate (tol {F64_RTOL:g}) {'ok' if ok else 'DISAGREES'}; failed zones card "
              f"{bool(hb['cuda'][0][3])}, CPU {bool(hb['cpu'][0][3])}", flush=True)
        if not ok or bool(hb["cuda"][0][3]) != bool(hb["cpu"][0][3]):
            compare([gu[rest]], [ru[rest]], F64_RTOL, floor=True, report=True)
            fail("H-burn: the card and the CPU disagree")
        h_results["H-burn"] = dict(card_s=hb["cuda"][1], iterations=hb["cuda"][2],
                                   cpu_iterations=hb["cpu"][2], max_rel_err=rel)
        del hb, gu, ru, god, rod
        torch.cuda.empty_cache()

    def path_i():
        # path I: self-gravity (gravity/, the multigrid of solvers/multigrid.py,
        # the gravity source and its corrector, the sponge): a step with sources
        # runs prim_aux twice (the second without div u, for the corrector's
        # primitives), traces the old-time source into the three trace_ppm and
        # ends in clean_fill twice; two Poisson solves a step
        from castro_tpu_torch.geometry import geometry_from_params
        from castro_tpu_torch.gravity import Gravity
        from castro_tpu_torch.problems import dust_collapse
        from castro_tpu_torch.problems.util import fill_from_prim
        from castro_tpu_torch.utils import constants as UC

        i_results = ctx.i_results = {}
        FUSED_SRC = dict(FUSED, prim_aux=2, clean_fill=2)





        print(f"kernel vs plain, 3D DustCollapse {N_MAIN}^3 float32 after a step (PoissonGrav; "
              f"the old-time source traced into trace_ppm, prim_aux without div u) {elapsed()}:",
              flush=True)
        s_ = dust_sim(N_MAIN)
        s_.init_data()
        s_.advance(GRAV_DT)
        x = inputs(s_, s_.u, GRAV_DT)
        dtw = K.wt(GRAV_DT, s_.dtype)
        src_old = sum(fn(s_, s_.u, x["q"], x["qaux"], s_.t, dtw) for fn in s_.source_fns)
        s_._reset_sources()
        srcQ = au.src_to_prim(x["q"], x["qaux"], src_old, s_.layout)
        compare_step(x, "DustCollapse, srcQ", src=srcQ)
        args = (s_.u, s_.layout, s_.eos, s_.cfg.small_dens, s_.small_temp, s_.geom.dx)
        check("prim_aux", K.prim_aux(*args, with_divu=False),
              K.prim_aux_plain(*args, with_divu=False), "DustCollapse, no divu")
        del s_, x, src_old, srcQ
        torch.cuda.empty_cache()

        # I3: the 3D DustCollapse at 128^3 through Simulation.run
        sim = dust_sim(N_MAIN)
        grav = grav_of(sim)
        gst = timed_gravity(sim)
        rec = {}
        init = sim.init_data

        def init_rec(*a, **kw):
            out = init(*a, **kw)
            rec["rho_c0"] = centre_rho(sim)
            torch.cuda.synchronize()
            gst.update(s=0.0, calls=0)
            rec["t0"] = time.perf_counter()
            return out

        sim.init_data = init_rec
        n_i = drive(f"I3: DustCollapse {N_MAIN}^3 float32 PoissonGrav, {STEPS_I3} steps", sim,
                    FUSED_SRC, max_step=STEPS_I3, outflow=True)
        wall = time.perf_counter() - rec["t0"]
        sim.init_data = init
        rho_c1 = centre_rho(sim)
        solves = grav.solve_stats
        print(f"  [{card}] {1e3 * wall / n_i:.1f} ms a step after init (the launch-count and "
              f"outflow bookkeeping included), gravity {gst['s']:.3f} s ({gst['s'] / wall:.4f}); "
              f"Poisson solves: {len(solves)} for {n_i} steps tried (V-cycles, final max "
              f"residual): {solves}; centre density {rec['rho_c0']:.9e} -> {rho_c1:.9e}")
        if len(solves) != 2 * n_i:
            fail("path I3: not two Poisson solves a step")
        if any(v >= grav.n_vcycles for v, _ in solves):
            print(f"  note: a solve ran to the {grav.n_vcycles}-cycle cap (float32 stalled above "
                  f"rtol {grav.rtol:g})")
        if not rho_c1 > rec["rho_c0"]:
            fail("path I3: the centre's density did not rise")
        i_results["I3_128"] = dict(step_ms=1e3 * wall / n_i, gravity_share=gst["s"] / wall,
                                   solves=solves, rho_centre=[rec["rho_c0"], rho_c1])
        del sim, grav
        torch.cuda.empty_cache()


        # float64 over one step: from the second step on, a perturbation of one
        # ulp of the state moves it by far more than 1e-8 (a switch of the scheme
        # flips in some cells of the cold collapse), on one device as on two
        grav_card_vs_cpu(f"I3 DustCollapse {N_GRAV_CPU}^3", lambda w, d: dust_sim(N_GRAV_CPU, d, w),
                         "float64", "float64", F64_RTOL, 1)
        grav_card_vs_cpu(f"I3 DustCollapse {N_GRAV_CPU}^3", lambda w, d: dust_sim(N_GRAV_CPU, d, w),
                         "float32", "float64", F32_VS_F64, 3)

        # the uniform sphere (tests/test_gravity.py:30-57) at N_SPHERE^3 on the card
        for gtype in ("PoissonGrav", "MonopoleGrav"):
            p = Params().with_ns("amr", n_cell=(N_SPHERE,) * 3).with_ns(
                "geometry", prob_lo=(-1.0,) * 3, prob_hi=(1.0,) * 3).with_ns(
                "castro", lo_bc=(2, 2, 2), hi_bc=(2, 2, 2), do_grav=1).with_ns(
                "gravity", gravity_type=gtype).with_ns("tpu", dtype="float32")
            geom = geometry_from_params(p, device="cuda")
            gr = Gravity(p, geom, layout_from_params(p), 4)
            xs = geom.cell_centers_1d(0, 0).double()
            X, Y, Z = torch.meshgrid(xs, xs, xs, indexing="ij")
            r = torch.sqrt(X ** 2 + Y ** 2 + Z ** 2)
            R = 0.5
            rho = torch.where(r < R, 1.0, 0.0).float()
            M = 4.0 / 3.0 * np.pi * R ** 3
            g3 = gr.grav_vector(rho)[0].double()
            gmag = torch.sqrt((g3 ** 2).sum(0))
            g_exact = torch.where(r < R, UC.Gconst * M * r / R ** 3, UC.Gconst * M / r ** 2)
            mask = (r > 0.25) & ((r < 0.4) | (r > 0.65)) & (r < 0.95)
            rel = ((gmag - g_exact).abs()[mask] / g_exact[mask])
            inward = bool(((g3[0] * X + g3[1] * Y + g3[2] * Z)[mask] < 0).all())
            print(f"I3 uniform sphere {N_SPHERE}^3 {gtype} float32 [{card}]: |g| against the "
                  f"analytic field, mean rel err {float(rel.mean()):.4e} (limit 0.05), max "
                  f"{float(rel.max()):.4e} (limit 0.25), inward {inward}; solves "
                  f"{gr.solve_stats}", flush=True)
            if not (float(rel.mean()) < 0.05 and float(rel.max()) < 0.25 and inward):
                fail(f"path I3: the uniform sphere's field ({gtype}) misses the analytic one")
            i_results[f"sphere_{gtype}"] = dict(mean_rel=float(rel.mean()),
                                                max_rel=float(rel.max()))
            del gr, g3, X, Y, Z, r, rho, gmag, g_exact
        torch.cuda.empty_cache()

        # I3 timed at 128^3: STEPS_I3_BIG steps after init, then 1 step under
        # the profiler, the device traced alone (~2 x 10^5 launches a step)
        sim = dust_sim(N_MAIN)
        gst = timed_gravity(sim)
        sim.init_data()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gst.update(s=0.0, calls=0)
        nsolve0 = len(grav_of(sim).solve_stats)
        t0 = time.perf_counter()
        sim.run(max_step=STEPS_I3_BIG, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        solves = grav_of(sim).solve_stats[nsolve0:]
        i_results["I3_128"] = dict(step_ms=1e3 * wall / STEPS_I3_BIG, gravity_share=gst["s"] / wall,
                                   zones_per_s=sim.num_zones_advanced / wall, peak_gib=peak,
                                   solves=solves)
        print(f"main path timing [{card}]: I3: DustCollapse {N_MAIN}^3 float32, {STEPS_I3_BIG} "
              f"steps after init: {1e3 * wall / STEPS_I3_BIG:.3f} ms/step, "
              f"{sim.num_zones_advanced / wall:.6e} zones/s, gravity {gst['s']:.3f} s of "
              f"{wall:.3f} s ({gst['s'] / wall:.4f}, {gst['calls']} fields), peak memory "
              f"{peak:.3f} GiB; solves (V-cycles, final max residual): {solves}", flush=True)
        if len(solves) != 2 * STEPS_I3_BIG:
            fail("path I3: not two Poisson solves a step at 128^3")
        del sim
        torch.cuda.empty_cache()

        # I1: 1D spherical DustCollapse (MonopoleGrav, float64) to 0.6 t_ff with
        # tests/test_convergence.py:36-55's checks
        s1 = Simulation(dust_collapse.make_params(n=N_I1, dim=1),
                        problem_init=dust_collapse.problem_init, device="cuda")
        s1.init_data()
        L1 = s1.layout
        rho0_max = float(s1.interior()[L1.URHO].max())
        t_ff = dust_collapse.free_fall_time(1.0e9)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        s1.run(stop_time=0.6 * t_ff, max_step=4000, verbose=False)
        torch.cuda.synchronize()
        i1_s = time.perf_counter() - t0
        rho = s1.interior()[L1.URHO].double().cpu().numpy()
        inner = rho[:20]
        flat_ = float(inner.std() / inner.mean())
        launches1 = K.launch_counts()
        path_launches[f"I1: DustCollapse 1D n={N_I1}"] = launches1
        print(f"I1 [{card}]: 1D spherical DustCollapse n={N_I1} float64 to 0.6 t_ff: "
              f"{s1.step_count} steps, {i1_s:.3f} s; max rho {rho.max() / rho0_max:.6f} x the "
              f"initial (limit > 1.5), inner std/mean {flat_:.4e} (limit 0.2), finite and positive "
              f"{bool(np.isfinite(rho).all() and rho.min() > 0)}; launches {launches1}", flush=True)
        if not (np.isfinite(rho).all() and rho.min() > 0 and rho.max() > 1.5 * rho0_max
                and flat_ < 0.2 and launches1["cmpflx"] >= s1.step_count > 0):
            fail("path I1: the 1D DustCollapse misses test_convergence.py's checks")
        i_results["I1"] = dict(steps=s1.step_count, s=i1_s, compression=float(rho.max() / rho0_max),
                               inner_std_over_mean=flat_)
        del s1

        # IF: the full-physics blob (burning_blob physics="full": Poisson gravity
        # with order-2 multipole BCs, iso7 Strang, the sponge), gamma law, float32
        sim = blob_sim(N_IF, physics="full")
        st = burn_stats(sim)
        gst = timed_gravity(sim)
        stamps = []
        init = sim.init_data

        def stamped_init(*a, **kw):
            out = init(*a, **kw)
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            gst.update(s=0.0, calls=0)
            return out

        sim.init_data = stamped_init
        n_f = drive(f"IF: full-physics blob {N_IF}^3 float32, 1 step", sim,
                    dict(FUSED, prim_aux=2, clean_fill=4), max_step=1, outflow=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - stamps[0]
        sim.init_data = init
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        i_results["IF"] = dict(step_ms=1e3 * wall / n_f, burn_share=st["s"] / wall,
                               gravity_share=gst["s"] / wall, iters=st["iters"],
                               released_erg=st["released"], peak_gib=peak,
                               solves=grav_of(sim).solve_stats)
        print(f"  [{card}] {1e3 * wall / n_f:.1f} ms a step after init; burns {st['s']:.3f} s "
              f"({st['s'] / wall:.4f}), gravity {gst['s']:.3f} s ({gst['s'] / wall:.4f}), "
              f"iterations {st['iters']}, energy released {st['released']:.6e} erg, peak memory "
              f"{peak:.3f} GiB; solves {grav_of(sim).solve_stats}", flush=True)
        if not st["released"] > 0.0:
            fail("path IF: the hot zone released no energy")
        del sim
        torch.cuda.empty_cache()
        reacting_card_vs_cpu(f"IF: {N_BLOB_CPU}^3 blob, card float32, CPU float64",
                             blob_make("float32", "float64", "gamma_law", "full"), F32_VS_F64,
                             steps=1)


        amr = grav_amr(3, N_IG)
        amr.init_data()
        amr.run(max_step=1, verbose=False)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zones0 = amr.num_zones_advanced
        t0 = time.perf_counter()
        amr.run(max_step=1 + STEPS_IG, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        u_ok = all(bool(torch.isfinite(u_).all()) for u_ in amr.u)
        i_results["IG"] = dict(ms_per_coarse_step=1e3 * wall / STEPS_IG,
                               zones_per_s=(amr.num_zones_advanced - zones0) / wall,
                               window=list(amr.window[1][1]), phi_sync_resid=amr.phi_sync_resid,
                               peak_gib=peak)
        print(f"main path timing [{card}]: IG: 3D blob {N_IG}^3 + 1 level float32, {STEPS_IG} "
              f"coarse steps: {1e3 * wall / STEPS_IG:.3f} ms a coarse step, "
              f"{(amr.num_zones_advanced - zones0) / wall:.6e} zones/s, window "
              f"{tuple(amr.window[1][1])} (+{len(amr.extra[1])} extra), refined cells "
              f"{int(amr.masks[1].sum())}, phi_sync_resid {amr.phi_sync_resid:.6e}, peak memory "
              f"{peak:.3f} GiB; finite {u_ok}", flush=True)
        if not u_ok or not amr.phi_sync_resid > 0.0:
            fail("path IG: the composite-gravity run failed")
        del amr
        torch.cuda.empty_cache()

        # float64: the blob is at rest in pressure balance, its momenta (gravity
        # with G in cgs on a unit blob: ~1e-10) are float32's round-off
        print(f"card vs CPU, IG 2D blob {N_IG_CPU}^2 + 1 level float64, 2 coarse steps {elapsed()}:",
              flush=True)
        runs = {}
        for where in ("cpu", "cuda"):
            a_ = grav_amr(2, N_IG_CPU, where, "float64")
            a_.init_data()
            for _ in range(2):
                a_.advance(1e-3)
            runs[where] = ([u_[interior_slice(a_.ng, 2)].cpu() for u_ in a_.u],
                           [a_.window[1][0].tolist(), a_.window[1][1]], a_.phi_sync_resid)
        # the tolerance of tests/test_torch_amr.py: F64_RTOL (|cpu| + each
        # component's largest magnitude), a momentum's magnitude at least
        # sqrt(max rho x max rho E), the state's momentum scale: the blob is at
        # rest, its momenta the round-off of the pressure balance
        ok = runs["cuda"][1] == runs["cpu"][1]
        Lg, worst = a_.sim0.layout, 0.0
        for gu_, ru_ in zip(runs["cuda"][0], runs["cpu"][0]):
            mag = ru_.abs().flatten(1).amax(1)
            mom = float(torch.sqrt(mag[Lg.URHO] * mag[Lg.UEDEN]))
            for c in (Lg.UMX, Lg.UMY, Lg.UMZ):
                mag[c] = max(float(mag[c]), mom)
            tol = F64_RTOL * (ru_.abs() + mag.reshape(-1, 1, 1))
            worst = max(worst, float(((gu_ - ru_).abs() / tol).max()))
        ok = ok and worst <= 1.0
        print(f"  windows card {runs['cuda'][1]}, CPU {runs['cpu'][1]}; max error {worst:.3e} of "
              f"the tolerance ({F64_RTOL:g} (|cpu| + max|cpu|) per component, the momenta's "
              f"magnitude at least sqrt(max rho max rho E)); phi_sync_resid card "
              f"{runs['cuda'][2]:.6e}, CPU {runs['cpu'][2]:.6e} {'ok' if ok else 'DISAGREES'}")
        if not ok:
            fail("the card and the CPU disagree on IG")
        del runs

    def path_j():
        # path J: flame_wave and the surface-burning setups (problems/*.py:
        # thermal diffusion, rotation, the HSE fill hook, the initial models of
        # utils/initial_models.py, the triple-alpha, rprox and nova networks),
        # float64. A 2D step launches cmpflx and trans_cmpflx twice each, a 1D
        # step cmpflx once; everything else is torch ops (Helmholtz's prim_aux
        # and clean_fill, as the JAX package leaves them to XLA, and a fill hook
        # turns the kernel clean_fill off), so the launch counts are TWO_D and
        # ONE_D a tried step. The kernels are first held on the states of the
        # path at NPASS = 13 (flame_wave, aprox13), 10 (xrb_mixed, rprox) and 14
        # (nova)
        from castro_tpu_torch.problems import (convective_flame, flame_wave, hse_convergence,
                                               nova, reacting_bubble, toy_flame, xrb_mixed)

        j_results = ctx.j_results = {}


        print(f"kernel vs plain, path J's states, float64 {elapsed()}:", flush=True)
        for label, make in ((f"flame_wave {N_FW[0]} x {N_FW[1]} (NPASS 13)",
                             lambda: flame_wave.build(n=N_FW)),
                            ("xrb_mixed 64 x 192 (NPASS 10)", lambda: sci_sim(xrb_mixed)),
                            ("nova 64 x 128 (NPASS 14)", lambda: sci_sim(nova))):
            s_ = make()
            s_.init_data()
            compare_low_dim(inputs_low_dim(s_, s_.u, s_.estimate_dt()), label)
            del s_
            torch.cuda.empty_cache()



        # J-fw: flame_wave as the JAX package configures it, timed
        sim = flame_wave.build(n=N_FW)
        assert [s_.name for s_ in sim.source_fns] == ["diff", "grav"]
        st = timed_run(sim)
        torch.cuda.reset_peak_memory_stats()
        n_fw = drive(f"J-fw: flame_wave {N_FW[0]} x {N_FW[1]} float64, {STEPS_FW} steps", sim,
                     TWO_D, max_step=STEPS_FW, conserves_mass=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - st["init"]["end"]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        zones = int(np.prod(N_FW))
        T_max = float(sim.interior()[sim.layout.UTEMP].max())
        j_results["J-fw"] = dict(
            n_cell=list(N_FW), init_s=st["init"]["s"], step_ms=1e3 * wall / n_fw,
            zones_per_s=zones * sim.step_count / wall, burn_share=st["burn"]["s"] / wall,
            diffusion_share=st["diff"]["s"] / wall, hse_fill_ms_per_step=1e3 * st["fill"]["s"] / n_fw,
            hse_fills_per_step=st["fill"]["calls"] / n_fw, iters=st["burn"]["iters"],
            released_erg=st["burn"]["released"], peak_gib=peak, T_max=T_max)
        print(f"  [{card}] init_data {st['init']['s']:.3f} s; {1e3 * wall / n_fw:.1f} ms a step, the "
              f"mean of {n_fw} steps after init, {zones * sim.step_count / wall:.6e} zones/s; burns "
              f"{st['burn']['s']:.3f} s ({st['burn']['s'] / wall:.4f}), {st['burn']['calls']} half "
              f"burns, iterations {st['burn']['iters']}; conduction {st['diff']['s']:.4f} s "
              f"({st['diff']['s'] / wall:.4f}); HSE fill {1e3 * st['fill']['s'] / n_fw:.2f} ms a "
              f"step ({st['fill']['calls'] / n_fw:.1f} fills a step); energy released "
              f"{st['burn']['released']:.6e} erg; peak memory {peak:.3f} GiB; max T {T_max:.6e} K",
              flush=True)
        if not (st["burn"]["released"] > 0.0 and T_max > 3.5e8):
            fail("path J-fw: the ignition patch did not burn")
        del sim
        torch.cuda.empty_cache()

        j_results["J-fw_vs_cpu"] = reacting_card_vs_cpu(
            f"J-fw: flame_wave {N_FW_CPU[0]} x {N_FW_CPU[1]}, float64",
            lambda where: flame_wave.build(n=N_FW_CPU, device=where), F64_RTOL, steps=1,
            shared_momentum=True)

        # J-hse: hse_convergence to t = 1, HSE fills on both faces; the residual
        # velocity falls with resolution (tests/test_hse_convergence.py's bounds)
        v_hse = {}
        for n_h in N_HSE:
            sim = hse_convergence.build(n=n_h)
            drive(f"J-hse: hse_convergence n={n_h} float64 to t=1.0", sim, ONE_D, stop_time=1.0,
                  conserves_mass=False)
            ui = sim.interior().double()
            v_hse[n_h] = float((ui[sim.layout.UMX] / ui[sim.layout.URHO]).abs().max())
            del sim
        j_results["J-hse"] = dict(max_velocity=v_hse)
        print(f"  max |u| at t = 1: {v_hse} (bounds: < 5e-4 at n = {N_HSE[0]}, falling at least 3x "
              f"to n = {N_HSE[1]})", flush=True)
        if not (v_hse[N_HSE[0]] < 5e-4 and v_hse[N_HSE[1]] < v_hse[N_HSE[0]] / 3.0):
            fail("path J-hse: the hydrostatic atmosphere does not converge")

        # J-sci: the five setups at the JAX package's default sizes, a few steps
        for key, mod, per_try in (("toy_flame", toy_flame, ONE_D),
                                  ("convective_flame", convective_flame, TWO_D),
                                  ("reacting_bubble", reacting_bubble, TWO_D),
                                  ("xrb_mixed", xrb_mixed, TWO_D), ("nova", nova, TWO_D)):
            sim = sci_sim(mod)
            st = timed_run(sim)
            n_s = drive(f"J-sci: {key} {' x '.join(map(str, sim.geom.n_cell))} float64, "
                        f"{STEPS_SCI} steps", sim, per_try, max_step=STEPS_SCI, conserves_mass=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - st["init"]["end"]
            b = st["burn"]
            j_results[f"J-sci {key}"] = dict(
                init_s=st["init"]["s"], step_ms=1e3 * wall / n_s, burn_share=b["s"] / wall,
                diffusion_share=st["diff"]["s"] / wall, iters=b["iters"], released_erg=b["released"],
                dt=sim.dt, sources=[s_.name for s_ in sim.source_fns])
            print(f"  [{card}] init_data {st['init']['s']:.3f} s; {1e3 * wall / n_s:.1f} ms a step "
                  f"after init; burns {b['s']:.3f} s ({b['s'] / wall:.4f}), iterations {b['iters']}; "
                  f"conduction {st['diff']['s'] / wall:.4f} of the wall; energy released "
                  f"{b['released']:.6e} erg; last dt {sim.dt:.6e}; sources "
                  f"{[s_.name for s_ in sim.source_fns]}", flush=True)
            del sim
            torch.cuda.empty_cache()
        j_results["J-sci convective_flame_vs_cpu"] = reacting_card_vs_cpu(
            "J-sci: convective_flame 128 x 96, float64",
            lambda where: sci_sim(convective_flame, device=where), F64_RTOL, steps=1,
            shared_momentum=True)
        j_results["J-sci xrb_mixed_vs_cpu"] = reacting_card_vs_cpu(
            f"J-sci: xrb_mixed {N_XRB_CPU[0]} x {N_XRB_CPU[1]}, float64",
            lambda where: sci_sim(xrb_mixed, N_XRB_CPU, device=where), F64_RTOL, steps=1,
            shared_momentum=True)

    def path_k_body(pool):
        # path K: the spherical and convecting science setups (problems/
        # subchandra.py, massive_star.py, wdmerger.py, reacting_tests.py,
        # convect.py, bubbles.py, science_extra.py, gravity_tests.py,
        # acoustic_pulse.py): subch, aprox21, the NSE bypass, the multigamma
        # EOS, MonopoleGrav and PoissonGrav in RZ, float64. A 2D Cartesian
        # step launches cmpflx and trans_cmpflx twice each, a 2D RZ step
        # cmpflx four times, a 1D step cmpflx once; the rest is torch ops.
        # The kernels are first held bit for bit at NPASS 3, 17, 19 and 21 on
        # seeded faces and on the states of subchandra and massive_star
        from castro_tpu_torch.problems import (bubbles, convect, massive_star, reacting_tests,
                                               science_extra, subchandra, wdmerger)
        from castro_tpu_torch.problems import acoustic_pulse as ap_mod
        from castro_tpu_torch.problems import gravity_tests as gt_mod
        from castro_tpu_torch.utils import constants as C_

        k_results = ctx.k_results = {}
        RZ_K = {"cmpflx": 4}

        def face_inputs(L, shape, seed):
            """Seeded float64 face states, Riemann aux and transverse
            bundles (tests/test_torch_cuda_layouts.py:_face_inputs)."""
            rng = np.random.default_rng(seed)

            def state():
                q = np.zeros((L.NQ,) + shape)
                q[L.QRHO] = rng.uniform(0.5, 1.5, shape)
                q[L.QU:L.QW + 1] = rng.uniform(-0.6, 0.6, (3,) + shape)
                q[L.QPRES] = rng.uniform(0.3, 2.0, shape)
                q[L.QREINT] = q[L.QPRES] / 0.4
                q[L.QGAME], q[L.QTEMP] = 1.4, 1.0
                q[L.QFS:] = rng.uniform(0.0, 1.0, (L.nspec + L.naux,) + shape)
                return torch.as_tensor(q, dtype=torch.float64, device=dev)

            def bundle():
                df = 0.2 * rng.standard_normal((L.NVAR,) + shape)
                df[L.URHO] = rng.uniform(-0.5, 1.2, shape)
                df[L.UEDEN] = rng.uniform(-1.0, 4.0, shape)
                return tuple(torch.as_tensor(a, dtype=torch.float64, device=dev) for a in
                             (df, 0.1 * rng.standard_normal(shape),
                              0.3 * rng.standard_normal(shape)))

            aux = [torch.as_tensor(rng.uniform(lo, hi, shape), dtype=torch.float64, device=dev)
                   for lo, hi in ((1.3, 1.7), (1.3, 1.7), (0.5, 1.5), (0.5, 1.5))]
            return state(), state(), aux, bundle(), bundle()

        print(f"kernel vs plain, path K, seeded float64 faces at NPASS 3, 17, 19, 21 "
              f"{elapsed()}:", flush=True)
        for nspec in (3, 17, 19, 21):
            for dim, shape in ((1, (181,)), (2, (37, 29))):
                Lk = StateLayout(dim=dim, nspec=nspec)
                qm, qp, aux, bm, bp = face_inputs(Lk, shape, nspec)
                for solver, bc, coord in ((0, 2, 0), (2, 3, 0), (0, 2, dim)):
                    for d in range(dim):
                        mask = _bnd_masks(shape, dim, 4, (bc,) * dim, (bc,) * dim)[d]
                        a = (qm, qp, *aux, d, Lk, coord, solver, 1e-12, 1e-20)
                        what = f"NPASS {nspec} {dim}D d={d} solver {solver} coord {coord}"
                        check("cmpflx", K.cmpflx(*a, bnd_mask=mask),
                              K.cmpflx_plain(*a, bnd_mask=mask), what)
                        if dim == 2 and coord == 0:
                            a = (qm, qp, bm[0], bp[0], bm[1], bp[1], bm[2], bp[2], *aux, d, Lk,
                                 0, solver, 1e-12, 1e-20, True, False)
                            check("trans_cmpflx", K.trans_cmpflx(*a, bnd_mask=mask),
                                  K.trans_cmpflx_plain(*a, bnd_mask=mask), what)
                del qm, qp, aux, bm, bp

        def sync_s():
            torch.cuda.synchronize()
            return time.perf_counter()

        def instrument(sim):
            """The burn, the NSE bypass and the gravity field of each call
            timed on the synchronized host clock; the burner's iterations a
            half burn and the zones in NSE recorded."""
            st = {k_: dict(s=0.0, calls=0) for k_ in ("burn", "nse", "grav")}
            st["burn"]["iters"], st["nse"]["zones"] = [], []
            r_ = sim.reactor
            if r_ is not None:
                react = r_.react

                def timed_react(u_, dt_, shk=None):
                    t0_ = sync_s()
                    out = react(u_, dt_, shk)
                    st["burn"]["s"] += sync_s() - t0_
                    st["burn"]["calls"] += 1
                    st["burn"]["iters"].append(r_.burner.stats.iterations)
                    return out

                r_.react = timed_react
                if r_.nse is not None:
                    apply_nse = r_._apply_nse

                    def timed_nse(*a_):
                        t0_ = sync_s()
                        out = apply_nse(*a_)
                        st["nse"]["s"] += sync_s() - t0_
                        st["nse"]["calls"] += 1
                        st["nse"]["zones"].append(int(out[2].sum()))
                        return out

                    r_._apply_nse = timed_nse
            for fn in sim.source_fns:
                if fn.name == "grav" and hasattr(fn.gravity, "grav_vector"):
                    gv = fn.gravity.grav_vector

                    def timed_grav(*a_, gv=gv, **kw_):
                        t0_ = sync_s()
                        out = gv(*a_, **kw_)
                        st["grav"]["s"] += sync_s() - t0_
                        st["grav"]["calls"] += 1
                        return out

                    fn.gravity.grav_vector = timed_grav
            return st

        def timed_steps(key, label, sim, per_try, steps, model_s, extra=None, profile=False):
            """init_data, then `steps` steps through drive (launch counts
            against per_try), timed from the end of the set-up: ms a step,
            zones/s, the burn's, the NSE bypass's and gravity's shares, the
            burner's iterations a half burn, the zones in NSE, peak memory;
            then one step under the profiler (the device alone). The set-up
            is init_data and the capture of the burner's and the NSE
            bisection's CUDA graphs: one half burn of the initial state, its
            result discarded, so that the timed steps replay them."""
            react = None if sim.reactor is None else sim.reactor.react
            st = instrument(sim)
            init = sim.init_data
            stamps = {}

            def stamped_init(*a_, **kw_):
                t0_ = sync_s()
                out = init(*a_, **kw_)
                stamps["init_s"] = sync_s() - t0_
                t0_ = sync_s()
                if react is not None:
                    react(sim.u, 0.5 * sim.estimate_dt())
                stamps["capture_s"] = sync_s() - t0_
                stamps["end"] = time.perf_counter()
                for v_ in st.values():
                    v_.update(s=0.0, calls=0)
                st["burn"]["iters"].clear()
                st["nse"]["zones"].clear()
                torch.cuda.reset_peak_memory_stats()
                return out

            sim.init_data = stamped_init
            n_k = drive(label, sim, per_try, max_step=steps, conserves_mass=False)
            wall = sync_s() - stamps["end"]
            sim.init_data = init
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            zones = int(np.prod(sim.geom.n_cell))
            res = dict(n_cell=list(sim.geom.n_cell), model_s=model_s, init_s=stamps["init_s"],
                       capture_s=stamps["capture_s"],
                       step_ms=1e3 * wall / n_k, zones_per_s=zones * sim.step_count / wall,
                       burn_share=st["burn"]["s"] / wall, nse_share=st["nse"]["s"] / wall,
                       grav_share=st["grav"]["s"] / wall, iters=st["burn"]["iters"],
                       nse_zones=st["nse"]["zones"], peak_gib=peak, dt=sim.dt)
            res.update(extra or {})
            print(f"  [{card}] {key}: model {model_s:.3f} s + init_data {stamps['init_s']:.3f} "
                  f"s + the graphs' capture {stamps['capture_s']:.3f} s; {1e3 * wall / n_k:.1f} "
                  f"ms a step (the mean of {n_k} after the set-up), "
                  f"{res['zones_per_s']:.6e} zones/s; burn {res['burn_share']:.4f}, NSE bypass "
                  f"{res['nse_share']:.4f}, gravity {res['grav_share']:.4f} of the wall; burner "
                  f"iterations a half burn {res['iters']}; zones in NSE {res['nse_zones']}; "
                  f"peak memory {peak:.3f} GiB; last dt {sim.dt:.6e}", flush=True)
            prof = profile_steps(sim, 1, card, host=False) if profile else None
            res["idle_share"] = None if prof is None else prof["idle"]
            k_results[key] = res
            return sim

        # K-ms's run and its comparison's model on the card first: the worker
        # process then steps the comparison on the CPU (8 zones over 2e8 cm,
        # the innermost zones in the iron core, in NSE, about the zone size
        # of the timed run) at the first dt of the timed run, some 100 burner
        # iterations in the NSE zones (this grid's own CFL step, ten times
        # longer, takes 448, minutes on the CPU), and K-burn's 2^3 corners
        ms_holder = {}
        ms_sim = Simulation(massive_star.make_params(n=N_KMS), device="cuda",
                            problem_init=lambda s_, u_: massive_star.problem_init(
                                s_, u_, ms_holder["m"]))
        t0_ = sync_s()
        ms_holder["m"] = massive_star.build_model(ms_sim)
        ms_model_s = sync_s() - t0_
        ms_sim.init_data()
        dt_ms = ms_sim.estimate_dt()
        msp = massive_star.make_params(n=N_KMS_CPU).with_ns("geometry",
                                                          prob_hi=(2.0e8, 1.0, 1.0))
        ms8 = {}
        s_ = Simulation(msp, device="cuda", problem_init=lambda a_, b_: massive_star.
                        problem_init(a_, b_, ms8["m"]))
        ms8["m"] = massive_star.build_model(s_, nshell=96)
        jobs = {"ms": pool.submit(cpu_job, "ms", msp, ms8["m"], dt_ms),
                "burn0": pool.submit(cpu_job, "burn", 0),
                "burn1": pool.submit(cpu_job, "burn", 1)}

        # K-sub: subchandra in 2D RZ at the JAX geometry, the model built on
        # the card (the batched bisection walk, captured shells); its kernels
        # held on the initial state first
        holder = {}
        sim = Simulation(subchandra.make_params(n=N_KSUB), device="cuda",
                         problem_init=lambda s_, u_: subchandra.problem_init(s_, u_, holder["m"]))
        t0_ = sync_s()
        holder["m"] = subchandra.build_model(sim)
        model_s = sync_s() - t0_
        print(f"K-sub [{card}]: subchandra's model, {len(holder['m']['r'])} shells, "
              f"{holder['m']['marches']} batched marches for 30 bisection steps: {model_s:.3f} s "
              f"(limit 60 s) {elapsed()}", flush=True)
        if model_s > 60.0:
            fail("path K-sub: the white dwarf's model took more than 60 s")
        sim.init_data()
        compare_low_dim(inputs_low_dim(sim, sim.u, sim.estimate_dt()),
                        f"subchandra RZ {N_KSUB[0]} x {N_KSUB[1]} (NPASS 17)")
        timed_steps("K-sub", f"K-sub: subchandra RZ {N_KSUB[0]} x {N_KSUB[1]} float64, "
                    f"{STEPS_KSUB} steps", sim, RZ_K, STEPS_KSUB, model_s,
                    dict(marches=holder["m"]["marches"]))
        del sim, holder
        torch.cuda.empty_cache()

        # the model on the card against the model on the CPU (the JAX test's
        # star at 24 shells), then subchandra 1D card vs CPU from one model
        kw_sub = dict(M_WD=0.9 * C_.M_solar, M_He=0.05 * C_.M_solar, pert_temp_factor=25.0)
        mods = {}
        for where in ("cuda", "cpu"):
            s_ = Simulation(subchandra.make_params(dim=1, n=N_KSUB_CPU, **kw_sub), device=where)
            mods[where] = subchandra.build_model(s_, nshell=24)
        worst = max(float(np.max(np.abs(mods["cuda"][k_] - mods["cpu"][k_])
                              / np.maximum(np.abs(mods["cpu"][k_]), 1e-300)))
                    for k_ in ("density", "temperature", "pressure", "mass"))
        print(f"K-sub: the 24-shell model on the card against the CPU's, largest relative "
              f"difference {worst:.3e} (tol {F64_RTOL:g}); marches card "
              f"{mods['cuda']['marches']}, CPU {mods['cpu']['marches']}", flush=True)
        if not worst <= F64_RTOL:
            fail("path K-sub: the card's model disagrees with the CPU's")
        model1 = mods["cuda"]
        k_results["K-sub_model_vs_cpu"] = worst
        k_results["K-sub_vs_cpu"] = reacting_card_vs_cpu(
            f"K-sub: subchandra 1D n={N_KSUB_CPU}, float64", lambda where: Simulation(
                subchandra.make_params(dim=1, n=N_KSUB_CPU, **kw_sub), device=where,
                problem_init=lambda s_, u_: subchandra.problem_init(s_, u_, model1)),
            F64_RTOL, steps=1)

        # K-ms: massive_star with NSE, 1D spherical (one 768-shell march, built
        # above) timed; the core stays iron-group dominated (2D RZ is not run:
        # a step there costs a minute, the burner's ~170 iterations in the NSE
        # zones)
        key, sim = "K-ms", ms_sim
        compare_low_dim(inputs_low_dim(sim, sim.u, dt_ms),
                        f"massive_star {'x'.join(map(str, sim.geom.n_cell))} (NPASS 19)")
        # the NSE temperature's bisection: its CUDA graph against the eager
        # loop on the same zones, bit for bit
        r_, L_, u_ = sim.reactor, sim.layout, sim.u
        rho_ = u_[L_.URHO]
        xn_ = u_[L_.UFS:L_.UFS + L_.nspec] / rho_[None]
        col = sim.network.column(sim.network.zion / sim.network.aion, xn_, 1)
        ye_ = torch.clamp(torch.sum(col * xn_, dim=0), 1e-3, 1.0)
        args_ = (rho_, ye_, xn_, u_[L_.UEINT] / rho_)
        t0_ = sync_s()
        eager = r_._bisect(*args_, n=4, graph=False)
        t_eager = sync_s() - t0_
        graph_ = r_._bisect(*args_, n=4)  # the capture
        t0_ = sync_s()
        graph_ = r_._bisect(*args_, n=4)
        t_graph = sync_s() - t0_
        same = all(torch.equal(a_, b_) for a_, b_ in zip(eager, graph_))
        print(f"K-ms [{card}]: 4 bisections of the NSE temperature on {rho_.numel()} "
              f"zones, eager {t_eager:.3f} s, CUDA graph {t_graph:.3f} s; bit for bit "
              f"{'ok' if same else 'DISAGREES'}", flush=True)
        if not same:
            fail("path K-ms: the NSE bisection's graph disagrees with the eager loop")
        label = f"{key}: massive_star {'x'.join(map(str, sim.geom.n_cell))} float64, NSE"
        # no profiled step: a step is ~2.5e7 device records (the burner's
        # ~100 iterations a half burn in the NSE zones), minutes to read
        timed_steps(key, f"{label}, {STEPS_KMS} step(s)", sim, ONE_D, STEPS_KMS, ms_model_s,
                    dict(nse_bisect_4_eager_s=t_eager, nse_bisect_4_graph_s=t_graph),
                    profile=False)
        ui = sim.interior().double()
        x0 = float(((ui[sim.layout.UFS + 15] + ui[sim.layout.UFS + 16])
                    / ui[sim.layout.URHO])[0])
        k_results[key]["xfe_zone0"] = x0
        print(f"  X(Fe54 + Ni56) at the centre zone {x0:.6f} (limit > 0.5); the first step's "
              f"dt {dt_ms:.6e} s", flush=True)
        if not x0 > 0.5:
            fail(f"path {key}: the core is not iron-group dominated")
        del sim, ms_sim, ms_holder
        torch.cuda.empty_cache()

        # K-ms card vs CPU: the card's step of the comparison beside the
        # worker's CPU step
        s_ = Simulation(msp, device="cuda", problem_init=lambda a_, b_: massive_star.
                        problem_init(a_, b_, ms8["m"]))
        s_.init_data()
        t0_ = sync_s()
        s_.advance(dt_ms)
        card_ms = s_.interior().double().cpu()
        ms_iters = {"cuda": (s_.reactor.burner.stats.iterations, sync_s() - t0_)}
        cpu_ms, it_cpu, s_cpu = jobs["ms"].result()
        ms_iters["cpu"] = (it_cpu, s_cpu)
        runs = {"cuda": card_ms, "cpu": torch.as_tensor(cpu_ms)}
        Lm = s_.layout
        spec = slice(Lm.UFS, Lm.UFS + Lm.nspec)
        rest = [c_ for c_ in range(Lm.NVAR) if not Lm.UFS <= c_ < Lm.UFS + Lm.nspec]
        err, rel, ok = compare(runs["cuda"][rest], runs["cpu"][rest], F64_RTOL, floor=True)
        x_err = float((runs["cuda"][spec] / runs["cuda"][Lm.URHO]
                       - runs["cpu"][spec] / runs["cpu"][Lm.URHO]).abs().max())
        print(f"card vs CPU, K-ms: massive_star 1D n={N_KMS_CPU} over 2e8 cm, one step of "
              f"{dt_ms:.6e} s (the second half burn's iterations, and the step's seconds: card "
              f"{ms_iters['cuda']}, CPU {ms_iters['cpu']}): "
              f"max abs err {err:.3e} rel {rel:.3e} (tol {F64_RTOL:g}|cpu| + "
              f"{F64_RTOL:g} max|cpu|), mass fractions {x_err:.3e} (tol {F64_RTOL:g}) "
              f"{'ok' if ok and x_err <= F64_RTOL else 'DISAGREES'}", flush=True)
        if not (ok and x_err <= F64_RTOL):
            fail("path K-ms: the card and the CPU disagree")
        k_results["K-ms_vs_cpu"] = dict(max_abs_err=err, max_rel_err=rel, x_err=x_err, dt=dt_ms,
                                        iterations_and_s=ms_iters)

        # K-burn: aprox21 + Helmholtz, StrangReactor.react on a 16^3 box at
        # rho 1e9 and T 4e9 +- 10%, without and with network.nse=1 (T_nse 4e9:
        # half the zones in NSE); the card against the worker's CPU on a 2^3
        # corner
        for nse_on in (0, 1):
            out, secs, iters, Lb = k_burn_react(nse_on, 16, "cuda")
            cpu_out, it_cpu, s_cpu = jobs[f"burn{nse_on}"].result()
            kb = {"cuda": (out, secs, iters), "cpu": (cpu_out, s_cpu, it_cpu)}
            gu, ru = out[0][:, :2, :2, :2].cpu(), torch.as_tensor(cpu_out[0])
            sp_ = slice(Lb.UFS, Lb.UFS + Lb.nspec)
            rest = [c_ for c_ in range(Lb.NVAR) if not Lb.UFS <= c_ < Lb.UFS + Lb.nspec]
            err, rel, ok = compare(gu[rest], ru[rest], F64_RTOL, floor=True)
            x_err = float((gu[sp_] / gu[Lb.URHO] - ru[sp_] / ru[Lb.URHO]).abs().max())
            ok = ok and x_err <= F64_RTOL and bool(out[3]) == cpu_out[3]
            print(f"K-burn [{card}]: aprox21 + Helmholtz, network.nse={nse_on}, react(dt=1e-8) "
                  f"on 16^3: {kb['cuda'][1]:.3f} s, {kb['cuda'][2]} iterations; card vs CPU on "
                  f"2^3 (the worker's CPU: {it_cpu} iterations, {s_cpu:.3f} s): max abs err "
                  f"{err:.3e} rel {rel:.3e}, mass fractions {x_err:.3e} (tol "
                  f"{F64_RTOL:g}) {'ok' if ok else 'DISAGREES'}", flush=True)
            if not ok:
                fail(f"K-burn: the card and the CPU disagree (nse={nse_on})")
            k_results[f"K-burn nse={nse_on}"] = dict(card_s=kb["cuda"][1], cpu_s=s_cpu,
                                                     iterations=kb["cuda"][2],
                                                     cpu_iterations=it_cpu, x_err=x_err)
        del kb
        torch.cuda.empty_cache()

        # K-sci: the other setups at the JAX package's default or test sizes,
        # one step each; card vs CPU on double_bubble, celldet and wdmerger
        # problem 0
        def wdm(problem, where="cuda", models=None, n=N_KWDM):
            p_ = wdmerger.make_params(n=n, mass_P=0.5, mass_S=0.5, problem=problem)
            return Simulation(p_, device=where, problem_init=lambda s_, u_: wdmerger.problem_init(
                s_, u_, models=models))

        def plain(params, init, where="cuda", ext=None):
            return Simulation(params, problem_init=init, device=where,
                              **({"ext_src": ext(params)} if ext else {}))

        # the 0.5 Msun star, built once on the card for both stars of both
        # problems and their card-vs-CPU copy (the two stars are equal)
        t0_ = sync_s()
        wm_models = wdmerger._wd(wdm(0), 0.5, wdmerger.DEFAULTS["stellar_temp"]) * 2
        k_results["K-sci wdmerger_models_s"] = sync_s() - t0_
        print(f"K-sci [{card}]: wdmerger's 0.5 Msun star (512 shells, 30 bisection steps): "
              f"{k_results['K-sci wdmerger_models_s']:.3f} s", flush=True)
        rt_, cv_, bb_, se_, gt_ = reacting_tests, convect, bubbles, science_extra, gt_mod
        sci = [
            ("wdmerger-0", lambda: wdm(0, models=wm_models), RZ_K),
            ("wdmerger-1", lambda: wdm(1, models=wm_models), RZ_K),
            ("reacting_convergence", lambda: plain(rt_.reacting_convergence_params(n=64),
                                                   rt_.reacting_convergence_init), TWO_D),
            ("bubble_convergence", lambda: plain(rt_.bubble_convergence_params(n=64),
                                                 rt_.bubble_convergence_init), TWO_D),
            ("toy_convect", lambda: plain(cv_.toy_convect_params(), cv_.toy_convect_init), TWO_D),
            ("test_convect", lambda: plain(cv_.test_convect_params(), cv_.test_convect_init,
                                           ext=cv_.make_test_convect_source), TWO_D),
            ("gamma_law_bubble", lambda: plain(bb_.gamma_law_params(), bb_.gamma_law_init),
             TWO_D),
            ("double_bubble", lambda: plain(bb_.double_bubble_params(), bb_.double_bubble_init),
             TWO_D),
            ("celldet", lambda: plain(se_.celldet_params(), se_.celldet_init), TWO_D),
            ("planet", lambda: plain(se_.planet_params(), se_.planet_init), TWO_D),
            ("star_grav", lambda: plain(gt_.star_grav_params(), gt_.star_grav_init), ONE_D),
            ("hse_adjust", lambda: plain(gt_.hse_adjust_params(), gt_.hse_adjust_init,
                                         ext=gt_.make_hse_adjust_source), ONE_D),
            ("hse_general", lambda: plain(gt_.hse_general_params(), gt_.hse_general_init),
             ONE_D),
            ("acoustic_pulse_general", lambda: plain(ap_mod.general_params(),
                                                     ap_mod.general_init), TWO_D),
        ]
        for key, make, per_try in sci:
            sim = make()
            t0_ = sync_s()
            n_s = drive(f"K-sci: {key} {' x '.join(map(str, sim.geom.n_cell))} float64, "
                        f"{STEPS_KSCI} step(s)", sim, per_try, max_step=STEPS_KSCI,
                        conserves_mass=False)
            wall = sync_s() - t0_
            ui = sim.interior()
            k_results[f"K-sci {key}"] = dict(s_with_init=wall, steps=n_s, dt=sim.dt,
                                              sources=[s_.name for s_ in sim.source_fns])
            print(f"  [{card}] {wall:.3f} s with init_data; last dt {sim.dt:.6e}; sources "
                  f"{[s_.name for s_ in sim.source_fns]}; rho in [{float(ui[0].min()):.4e}, "
                  f"{float(ui[0].max()):.4e}] {elapsed()}", flush=True)
            del sim, ui
            torch.cuda.empty_cache()
        k_results["K-sci double_bubble_vs_cpu"] = reacting_card_vs_cpu(
            "K-sci: double_bubble 128 x 128 (multigamma), float64",
            lambda where: plain(bubbles.double_bubble_params(), bubbles.double_bubble_init,
                                where), F64_RTOL, steps=1, shared_momentum=True)
        k_results["K-sci celldet_vs_cpu"] = reacting_card_vs_cpu(
            f"K-sci: celldet {N_KCD_CPU[0]} x {N_KCD_CPU[1]}, float64",
            lambda where: plain(science_extra.celldet_params(n=N_KCD_CPU),
                                science_extra.celldet_init, where), F64_RTOL, steps=1,
            shared_momentum=True)
        k_results["K-sci wdmerger-0_vs_cpu"] = reacting_card_vs_cpu(
            f"K-sci: wdmerger problem 0 {N_KWDM[0]} x {N_KWDM[1]} (RZ PoissonGrav), float64",
            lambda where: wdm(0, where, wm_models), F64_RTOL, steps=1, shared_momentum=True)
        # nse_test: its initial state, the NSE distribution on every zone
        # (aprox19, 6e9 K), card against CPU; no step on the card (its burn
        # at 6e9 K outside the bypass takes the burner's 1024 iterations)
        st_ = {}
        for where in ("cuda", "cpu"):
            s_ = plain(reacting_tests.nse_test_params(n=64), reacting_tests.nse_test_init, where)
            t0_ = sync_s()
            s_.init_data()
            st_[where] = (s_.interior().double().cpu(), sync_s() - t0_)
        err, rel, ok = compare(st_["cuda"][0], st_["cpu"][0], F64_RTOL, floor=True)
        print(f"card vs CPU, K-sci: nse_test n=64 initial state (NSE at 1e9 g/cc, 6e9 K): "
              f"card {st_['cuda'][1]:.3f} s, CPU {st_['cpu'][1]:.3f} s; max abs err {err:.3e} rel "
              f"{rel:.3e} (tol {F64_RTOL:g}|cpu| + {F64_RTOL:g} max|cpu|) "
              f"{'ok' if ok else 'DISAGREES'}", flush=True)
        if not ok:
            fail("K-sci: nse_test's initial state differs between the card and the CPU")
        k_results["K-sci nse_test_init_vs_cpu"] = dict(max_abs_err=err, max_rel_err=rel,
                                                       card_s=st_["cuda"][1])

    def path_k():
        # the CPU references of K-ms and K-burn (minutes of eager torch ops on
        # the host) run in one worker process beside the card's work
        pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
        try:
            path_k_body(pool)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    def path_l_body(pool):
        # path L: SDC and MOL (sdc/__init__.py, ops/mol.py, ops/fourth_order.py)
        # and the hydro test setups (problems/hydro_tests.py, riemann_2d.py,
        # sod_stellar.py). True SDC's MOL evaluations solve their Riemann
        # problems through cmpflx (1 a direction at order 2, 2 at order 4),
        # everything else in them is torch ops but clean_fill (3D, after each
        # node update); simplified SDC's advective term is the CTU step's
        # kernels. The CPU references run in the worker process beside the
        # card's work, submitted first.
        from castro_tpu_torch.ops import fourth_order as t4
        from castro_tpu_torch.problems import hydro_tests, riemann_2d, sod_stellar

        l_results = ctx.l_results = {}

        def sync_s():
            torch.cuda.synchronize()
            return time.perf_counter()

        # the dts of the comparisons, from the CPU's initial states (cheap)
        def first_dt(kind, n, **kw):
            s_ = l_sim(kind, "cpu", n, **kw)
            s_.init_data()
            return s_.estimate_dt()

        cmp_runs = {}
        for key, (order, quad) in L_SDC.items():
            cmp_runs[f"{key}-cmp"] = ("pulse", N_LCMP, [L_DT_CMP], dict(order=order, quad=quad))
        for mode, (tim, order, _) in L_DET.items():
            dt_ = first_dt("det", N_LDET_CPU, tim=tim, order=order)
            cmp_runs[f"L-det-{mode}-cmp"] = ("det", N_LDET_CPU, [dt_] * STEPS_LDET_CPU,
                                             dict(tim=tim, order=order))
        cmp_runs["L-blob-cmp"] = ("blob", N_BLOB_CPU, [first_dt("blob", N_BLOB_CPU)], {})
        cmp_runs["L-amr-cmp"] = ("amr", N_LAMR_CPU, [first_dt("pulse", N_LAMR_CPU, dim=2)] * 2,
                                 {})
        for kind, n_ in N_LSET_CPU.items():
            cmp_runs[f"L-set-{kind}-cmp"] = (kind, n_, [first_dt(kind, n_)] * 2, {})
        jobs = {key: pool.submit(cpu_job, "l", *run) for key, run in cmp_runs.items()}

        def card_vs_cpu_l(key, rtol, species=False):
            """The same run on the card, against the worker's: rtol |cpu| +
            rtol max|cpu| per component; with `species` the mass fractions
            within rtol (a zone's total is one)."""
            kind, n_, dts, kw = cmp_runs[key]
            got, secs, iters = l_steps(kind, "cuda", n_, dts, **kw)
            ref, iters_cpu, secs_cpu = jobs[key].result()
            got = got if isinstance(got, list) else [got]
            ref = [torch.as_tensor(r_) for r_ in (ref if isinstance(ref, list) else [ref])]
            s_ = l_sim(kind, "cpu", n_, **kw)
            Ls = s_.sim0.layout if hasattr(s_, "sim0") else s_.layout
            x_err = 0.0
            if species:
                spec = slice(Ls.UFS, Ls.UFS + Ls.nspec)
                x_err = max(float((g_[spec] / g_[Ls.URHO] - r_[spec] / r_[Ls.URHO]).abs().max())
                            for g_, r_ in zip(got, ref))
                rest = [c_ for c_ in range(Ls.NVAR) if not Ls.UFS <= c_ < Ls.UFS + Ls.nspec]
                got, ref = [g_[rest] for g_ in got], [r_[rest] for r_ in ref]
            err, rel, ok = compare(got, ref, rtol, floor=True)
            ok = ok and x_err <= rtol
            print(f"card vs CPU, {key}: {kind} n={n_}, {len(dts)} step(s) at dt {dts[0]:.6e}: card "
                  f"{secs:.3f} s, CPU {secs_cpu:.3f} s (worker process); burner iterations card "
                  f"{iters}, CPU {iters_cpu}; max abs err {err:.3e} rel {rel:.3e} (tol {rtol:g}|cpu| "
                  f"+ {rtol:g} max|cpu| per component{', mass fractions ' + f'{x_err:.3e}' if species else ''}) "
                  f"{'ok' if ok else 'DISAGREES'}", flush=True)
            if not ok:
                compare(got, ref, rtol, floor=True, report=True)
                fail(f"path {key}: the card and the CPU disagree")
            l_results[key] = dict(max_abs_err=err, max_rel_err=rel, x_err=x_err, card_s=secs,
                                  cpu_s=secs_cpu)

        def drive_l(label, sim, per_step, steps, warm=0, conserves_mass=True, burner=None):
            """`warm` steps, then `steps` steps through Simulation.run with the
            launch counts zeroed just before and read just after, held against
            per_step x the steps tried (clean_fill once more at init where the
            kernel cleans); finite values, mass conservation (periodic or
            closed boxes) where asked. Returns (ms a step, peak GiB, the
            burner's seconds and iterations a call over the timed steps)."""
            print(f"main path {label}, Simulation.run on the card {elapsed()}", flush=True)
            tries = {"n": 0}
            try_step = sim.try_step

            def counted(*a_, **kw_):
                tries["n"] += 1
                return try_step(*a_, **kw_)

            sim.try_step = counted
            bst = dict(s=0.0, calls=0, iters=[])
            if burner is not None:
                holder, attr = burner
                burn = getattr(holder, attr)

                def timed_burn(*a_, **kw_):
                    t0_ = sync_s()
                    out = burn(*a_, **kw_)
                    bst["s"] += sync_s() - t0_
                    bst["calls"] += 1
                    bst["iters"].append(burn.stats.iterations)
                    return out

                setattr(holder, attr, timed_burn)
            K.reset_launch_counts()
            sim.init_data()
            clean0 = K.launch_counts()["clean_fill"]
            if warm:
                sim.run(max_step=warm, verbose=False)
                torch.cuda.synchronize()
                K.reset_launch_counts()
                tries["n"] = 0
                clean0 = 0
                bst.update(s=0.0, calls=0, iters=[])
            mass0 = mass(sim)
            torch.cuda.reset_peak_memory_stats()
            t0_ = sync_s()
            sim.run(max_step=warm + steps, verbose=False)
            wall = sync_s() - t0_
            launches = K.launch_counts()
            n = tries["n"]
            expected = {name: per_step.get(name, 0) * n for name in launches}
            expected["clean_fill"] += clean0
            print(f"  {steps} steps ({n} tried) after {warm} warm, t = {sim.t:.6e}; launches "
                  f"{launches}; expected {expected}")
            if launches != expected or any(launches[k_] == 0 for k_, v in per_step.items() if v):
                fail(f"path {label}: the launch counts do not match the step's structure")
            if not bool(torch.isfinite(sim.interior()).all()):
                fail(f"path {label}: non-finite state")
            mass1 = mass(sim)
            dm = abs(mass1 - mass0) / mass0
            print(f"  mass: {mass0:.12e} -> {mass1:.12e}, relative change {dm:.3e} "
                  + (f"(limit 1e-12)" if conserves_mass else "(open boundaries: not checked)"))
            if conserves_mass and dm > 1e-12:
                fail(f"path {label}: mass is not conserved")
            path_launches[label] = launches
            sim.try_step = try_step
            if burner is not None:
                setattr(burner[0], burner[1], burn)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            return 1e3 * wall / steps, peak, bst

        def mol4_solves(sim, u, dtype):
            """Every cmpflx argument tuple of one MOL-4 evaluation of u (in
            `dtype`): per direction the face-centre states, then the
            face-average states (ops/fourth_order.py:mol4_face_states)."""
            L, cfg = sim.layout, sim.cfg
            q_cc, q_avg, qaux, flatn = t4.mol4_prims(sim._fill(u).to(dtype), L, cfg, sim.eos,
                                                     sim.small_temp)
            c_, g_ = qaux[L.QC], qaux[L.QGAMC]
            out = []
            for d in range(L.dim):
                qm, qp = t4.mol4_face_states(q_cc, q_avg, flatn, d, L)
                aux = (shifted(g_, -1, d), g_, shifted(c_, -1, d), c_)
                for a_, b_ in ((t4.face_avg_to_center(qm, d, L.dim),
                                t4.face_avg_to_center(qp, d, L.dim)), (qm, qp)):
                    out.append((a_.contiguous(), b_.contiguous(), *aux, d, L, sim.geom.coord,
                                cfg.riemann_solver, cfg.small_dens, cfg.small_pres))
            return out

        # L4: true SDC-4 on Lobatto nodes, the 3D acoustic pulse at 128^3 in
        # float64; then cmpflx bit for bit on the MOL-4 faces of its state
        SDC3 = {key: {"cmpflx": 3 * L_SOLVES[oq], "clean_fill": {(4, 0): 8, (4, 1): 12,
                                                                  (2, 0): 3}[oq]}
                for key, oq in L_SDC.items()}
        sim = l_sim("pulse", "cuda", N_L4, order=4, quad=0)
        ms, peak, _ = drive_l(f"L4: SDC-4 Lobatto, 3D acoustic pulse {N_L4}^3 float64, "
                              f"{STEPS_L4} steps", sim, SDC3["L4"], STEPS_L4, warm=1)
        zones = N_L4 ** 3
        print(f"  [{card}] L4: {ms:.1f} ms a step, {zones / (ms / 1e3):.6e} zones/s, peak memory "
              f"{peak:.3f} GiB; cmpflx {3 * L_SOLVES[(4, 0)]} launches a step (13 MOL-4 "
              f"evaluations x 2 solves x 3 directions)", flush=True)
        prof = profile_steps(sim, 1, card)  # the device's time by kernel, one more step
        l_results["L4"] = dict(step_ms=ms, zones_per_s=zones / (ms / 1e3), peak_gib=peak,
                               cmpflx_per_step=3 * L_SOLVES[(4, 0)], mol_evaluations=13,
                               profile=prof)
        for dtype in (torch.float64, torch.float32):
            for k_, args in enumerate(mol4_solves(sim, sim.u, dtype)):
                what = (f"L4 MOL-4 {'face-centre' if k_ % 2 == 0 else 'face-average'} "
                        f"d={k_ // 2} {str(dtype)[6:]}")
                check("cmpflx", K.cmpflx(*args), K.cmpflx_plain(*args), what)
        del sim
        torch.cuda.empty_cache()

        # L-rad, L2: SDC-4 on Radau nodes and SDC-2 at 64^3, one step each
        for key in ("L-rad", "L2"):
            order, quad = L_SDC[key]
            sim = l_sim("pulse", "cuda", N_LSMALL, order=order, quad=quad)
            ms, peak, _ = drive_l(f"{key}: SDC-{order} {'Radau' if quad else 'Lobatto'}, 3D "
                                  f"acoustic pulse {N_LSMALL}^3 float64, 1 step", sim, SDC3[key], 1)
            l_results[key] = dict(step_ms=ms, zones_per_s=N_LSMALL ** 3 / (ms / 1e3),
                                  peak_gib=peak, cmpflx_per_step=SDC3[key]["cmpflx"])
            print(f"  [{card}] {key}: {ms:.1f} ms a step (with the first step's set-up), "
                  f"cmpflx {SDC3[key]['cmpflx']} launches a step", flush=True)
            del sim
        torch.cuda.empty_cache()

        # L-cmp: the three integrators, 16^3 card vs CPU, float64
        for key in L_SDC:
            card_vs_cpu_l(f"{key}-cmp", F64_RTOL)

        # L-det: the 1D detonation in the three SDC modes, 20 steps each
        for mode, (tim, order, solves) in L_DET.items():
            sim = l_sim("det", "cuda", N_LDET, tim=tim, order=order)
            Ld = sim.layout
            holder = (sim.sdc or sim.sdc_simplified, "burner")
            sim.init_data()
            fuel0 = float(sim.interior()[Ld.UFS].double().sum())
            ms, _, bst = drive_l(f"L-det {mode}: detonation n={N_LDET} float64, {STEPS_LDET} "
                                 f"steps", sim, {"cmpflx": solves}, STEPS_LDET,
                                 conserves_mass=False, burner=holder)
            ratio = float(sim.interior()[Ld.UFS].double().sum()) / fuel0
            print(f"  [{card}] L-det {mode}: {ms:.2f} ms a step; fuel / initial fuel {ratio:.9f}; "
                  f"burns {bst['s']:.3f} s, {bst['calls']} burns, iterations "
                  f"{bst['iters'][:8]}...", flush=True)
            if not ratio < 1.0:
                fail(f"L-det {mode}: no fuel burned")
            l_results[f"L-det-{mode}"] = dict(step_ms=ms, fuel_ratio=ratio,
                                              burn_s=bst["s"], burns=bst["calls"])
            card_vs_cpu_l(f"L-det-{mode}-cmp", F64_RTOL, species=True)
            del sim

        # L-blob: H3's blob (iso7, gamma law) with simplified SDC, float64 (in
        # float32 the full-dt burn with the advective forcing fails in the hot
        # zones, the JAX package's too): the forced burner's graph captured by
        # one burn of the initial state without forcing, then one step at
        # L_BLOB_DT_FRAC of the initial state's CFL dt
        sim = l_sim("blob", "cuda", N_LBLOB)
        sim.init_data()
        dt_blob = L_BLOB_DT_FRAC * sim.estimate_dt()
        sim = l_sim("blob", "cuda", N_LBLOB, fixed_dt=dt_blob)
        sim.init_data()
        Lb, ub = sim.layout, sim.u
        zero = torch.zeros_like(ub[Lb.UFS:Lb.UFS + Lb.nspec])
        t0_ = sync_s()
        sim.sdc_simplified.burner(ub[Lb.URHO], ub[Lb.UTEMP], ub[Lb.UFS:Lb.UFS + Lb.nspec] /
                                  ub[Lb.URHO], ub[Lb.UEINT] / ub[Lb.URHO], dt_blob,
                                  xdot_force=zero, edot_force=zero[0])
        capture_s = sync_s() - t0_
        ms, peak, bst = drive_l(f"L-blob: burning blob {N_LBLOB}^3 iso7 gamma law float64, "
                                f"time_integration_method=3, 1 step at dt {dt_blob:.6e}", sim,
                                {k_: 2 * v for k_, v in FUSED.items() if k_ != "clean_fill"}
                                | {"clean_fill": 1}, 1, conserves_mass=False,
                                burner=(sim.sdc_simplified, "burner"))
        l_results["L-blob"] = dict(step_ms=ms, zones_per_s=N_LBLOB ** 3 / (ms / 1e3),
                                   burn_share=bst["s"] / (ms / 1e3), iters=bst["iters"],
                                   peak_gib=peak, dt=dt_blob, capture_s=capture_s)
        print(f"  [{card}] L-blob: the graph's capture (a burn without forcing) {capture_s:.3f} "
              f"s; {ms:.1f} ms a step, burns {bst['s']:.3f} s "
              f"({bst['s'] / (ms / 1e3):.4f} of the step), {bst['calls']} full-dt burns, "
              f"iterations {bst['iters']}; peak memory {peak:.3f} GiB", flush=True)
        del sim
        torch.cuda.empty_cache()
        card_vs_cpu_l("L-blob-cmp", F64_RTOL, species=True)

        # L-amr: the 2D pulse 512^2 + one level, SDC-4: a level's step is
        # 13 MOL-4 evaluations x 2 solves x 2 directions of cmpflx
        amr = l_sim("amr", "cuda", N_LAMR, dim=2)
        steps_ = {"n": 0}
        sdc_step = Simulation._sdc_step

        def counted_sdc(self_, *a_, **kw_):
            steps_["n"] += 1
            return sdc_step(self_, *a_, **kw_)

        print(f"main path L-amr: 2D acoustic pulse {N_LAMR}^2 + 1 level, SDC-4 float64, "
              f"{STEPS_LAMR} coarse steps {elapsed()}", flush=True)
        amr.init_data()
        amr._avg_down(0)  # the covered cells from the fine data, so mass is conserved
        m0 = float(amr.interior(0)[0].double().sum()) / N_LAMR ** 2
        Simulation._sdc_step = counted_sdc
        try:
            K.reset_launch_counts()
            t0_ = sync_s()
            amr.run(max_step=STEPS_LAMR, verbose=False)
            wall = sync_s() - t0_
            launches = K.launch_counts()
        finally:
            Simulation._sdc_step = sdc_step
        m1 = float(amr.interior(0)[0].double().sum()) / N_LAMR ** 2
        expected = {k_: (2 * L_SOLVES[(4, 0)] * steps_["n"] if k_ == "cmpflx" else 0)
                    for k_ in launches}
        dm = abs(m1 - m0) / m0
        print(f"  [{card}] {1e3 * wall / STEPS_LAMR:.1f} ms a coarse step; level steps "
              f"{steps_['n']}, window {tuple(amr.window[1][1])} (+{len(amr.extra[1])} extra); "
              f"launches {launches}; expected {expected}; mass {m0:.15e} -> {m1:.15e}, "
              f"relative change {dm:.3e} (limit 1e-12)", flush=True)
        if launches != expected or dm > 1e-12 or not all(bool(torch.isfinite(u_).all())
                                                         for u_ in amr.u):
            fail("path L-amr: launch counts, mass or finiteness")
        path_launches[f"L-amr: 2D pulse {N_LAMR}^2 + 1 level SDC-4"] = launches
        l_results["L-amr"] = dict(coarse_step_ms=1e3 * wall / STEPS_LAMR, mass_rel=dm,
                                  level_steps=steps_["n"], window=list(amr.window[1][1]))
        del amr
        torch.cuda.empty_cache()
        card_vs_cpu_l("L-amr-cmp", F64_RTOL)

        # L-set: every hydro test setup at its JAX default size, init + 2 steps
        setups = {"kh": (hydro_tests.kh_params(), hydro_tests.kh_init),
                  "rt": (hydro_tests.rt_params(), hydro_tests.rt_init),
                  "noh": (hydro_tests.noh_params(), hydro_tests.noh_init),
                  "gresho": (hydro_tests.gresho_params(), hydro_tests.gresho_init),
                  "oddeven": (hydro_tests.oddeven_params(), hydro_tests.oddeven_init),
                  "rotating_torus": (hydro_tests.rotating_torus_params(),
                                     hydro_tests.rotating_torus_init),
                  "lw_acoustics": (hydro_tests.lw_acoustics_params(),
                                   hydro_tests.lw_acoustics_init)}
        setups.update({f"riemann_2d-c{c_}": (riemann_2d.make_params(config=c_),
                                             riemann_2d.problem_init)
                       for c_ in sorted(riemann_2d.CONFIGS)})
        setups.update({f"sod_stellar-{k_}": (sod_stellar.make_params(test=k_),
                                             sod_stellar.problem_init)
                       for k_ in sorted(sod_stellar.TESTS)})
        set_res = {}
        for key, (p_, init_) in setups.items():
            s_ = Simulation(p_, problem_init=init_, device="cuda")
            K.reset_launch_counts()
            t0_ = sync_s()
            s_.init_data()
            s_.run(max_step=2, verbose=False)
            wall = sync_s() - t0_
            launches = {k_: v for k_, v in K.launch_counts().items() if v}
            # a 1D step with riemanncg (the stellar shock tubes) is torch ops
            kernels_run = s_.layout.dim == 1 and s_.cfg.riemann_solver == 1 or \
                sum(launches.values()) > 0
            ok = bool(torch.isfinite(s_.u).all()) and kernels_run
            set_res[key] = dict(s=wall, n_cell=list(s_.geom.n_cell), t=s_.t, launches=launches)
            print(f"  [{card}] L-set {key}: {tuple(s_.geom.n_cell)}, init + 2 steps {wall:.3f} s, "
                  f"t = {s_.t:.6e}, launches {launches} {'ok' if ok else 'FAILED'}", flush=True)
            if not ok:
                fail(f"L-set {key}: non-finite state or no kernel launched")
            del s_
        l_results["L-set"] = set_res
        torch.cuda.empty_cache()
        for kind in N_LSET_CPU:
            card_vs_cpu_l(f"L-set-{kind}-cmp", F64_RTOL)

    def path_l():
        pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
        try:
            path_l_body(pool)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    def path_m_body(pool):
        # path M: radiation (radiation/, ops/rad_hydro.py, the radiation
        # branches of driver/sim.py and driver/amr.py). The characteristic
        # rad-CTU step and the implicit FLD update are torch ops, as the JAX
        # package leaves them to XLA (M3, M-mg's multigroup step, M-amr, and
        # every do_hydro=0 setup launch no kernel); the operator-split step
        # (radiation.hydro_coupling=0) is the hydro step on the radiation
        # layout, whose Riemann solves are cmpflx (and trans_cmpflx in 2D
        # Cartesian), held bit for bit on that layout. The CPU references run
        # in the worker process beside the card's work, submitted first.
        from castro_tpu_torch.ops import rad_hydro
        from castro_tpu_torch.problems import rad_sphere, rad_shestakov, su_olson
        from castro_tpu_torch.utils import constants as C

        m_results = ctx.m_results = {}

        def sync_s():
            torch.cuda.synchronize()
            return time.perf_counter()

        split_runs = {"rad_blast": (dict(n=128), {"cmpflx": 1}, "1D spherical n=128"),
                      "rad_breakout": (dict(n=1024), {"cmpflx": 1}, "1D spherical n=1024"),
                      "bwp_rad": (dict(n=(64, 128)), {"cmpflx": 4}, "2D RZ 64 x 128"),
                      "box": (dict(n=N_MBOX), {"cmpflx": 2, "trans_cmpflx": 2},
                              f"2D Cartesian {N_MBOX}^2")}
        set_runs = {"rad_shock": dict(n=128), "thermal_wave": dict(n=64),
                    "rad_source": dict(n=16)}
        cmp_runs = {"M3-cmp": ("pulse", [M_DT] * 2, dict(n=N_M3_CPU))}
        for key, (kw, _, _) in split_runs.items():
            dt_ = M_DT if key == "box" else m_first_dt(key, **kw)
            cmp_runs[f"M-split-{key}-cmp"] = (key, [dt_] * STEPS_MSPLIT, kw)
        for key, kw in set_runs.items():
            cmp_runs[f"M-set-{key}-cmp"] = (key, [m_first_dt(key, **kw)] * 2, kw)
        jobs = {key: pool.submit(cpu_job, "m", *run) for key, run in cmp_runs.items()}

        def card_vs_cpu_m(key, rtol=F64_RTOL):
            """The same run on the card against the worker's: rtol |cpu| +
            rtol max|cpu| per component of the state and of Er."""
            kind_, dts, kw = cmp_runs[key]
            got_u, got_er, secs = m_steps(kind_, "cuda", dts, **kw)
            ref_u, ref_er, secs_cpu = jobs[key].result()
            ref_u, ref_er = torch.as_tensor(ref_u), torch.as_tensor(ref_er)
            if got_er.dim() == ref_u.dim() - 1:  # gray: a leading axis of one
                got_er, ref_er = got_er[None], ref_er[None]
            err, rel, ok = compare([got_u, got_er], [ref_u, ref_er], rtol, floor=True)
            print(f"card vs CPU, {key}: {kind_} {kw}, {len(dts)} step(s) at dt {dts[0]:.6e}: card "
                  f"{secs:.3f} s, CPU {secs_cpu:.3f} s (worker process); max abs err {err:.3e} "
                  f"rel {rel:.3e} (tol {rtol:g}|cpu| + {rtol:g} max|cpu| per component, state "
                  f"and Er) {'ok' if ok else 'DISAGREES'}", flush=True)
            if not ok:
                compare([got_u, got_er], [ref_u, ref_er], rtol, floor=True, report=True)
                fail(f"path {key}: the card and the CPU disagree")
            m_results[key] = dict(max_abs_err=err, max_rel_err=rel, card_s=secs,
                                  cpu_s=secs_cpu)

        def drive_m(label, sim, per_step, steps, warm=0):
            """`warm` steps, then `steps` steps through Simulation.run with the
            launch counts zeroed just before and read just after, held against
            per_step x the radiation steps tried; finite state and Er.
            Returns (ms a step, peak GiB, the solves' stats of the timed
            steps)."""
            print(f"main path {label}, Simulation.run on the card {elapsed()}", flush=True)
            tries = {"n": 0}
            rad_step = sim._rad_step_impl

            def counted(*a_, **kw_):
                tries["n"] += 1
                return rad_step(*a_, **kw_)

            sim._rad_step_impl = counted
            if warm:
                sim.run(max_step=sim.step_count + warm, verbose=False)
            tries["n"] = 0
            n_stats = len(sim.rad.solve_stats)
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            t0_ = sync_s()
            sim.run(max_step=sim.step_count + steps, verbose=False)
            wall = sync_s() - t0_
            launches = K.launch_counts()
            sim._rad_step_impl = rad_step
            n = tries["n"]
            expected = {name: per_step.get(name, 0) * n for name in launches}
            print(f"  {steps} steps ({n} tried) after {warm} warm, t = {sim.t:.6e}; launches "
                  f"{launches}; expected {expected}")
            if launches != expected or any(launches[k_] == 0 for k_, v in per_step.items() if v):
                fail(f"path {label}: the launch counts do not match the step's structure")
            if not (bool(torch.isfinite(sim.interior()).all())
                    and bool(torch.isfinite(sim.u_rad).all()) and float(sim.u_rad.min()) >= 0.0):
                fail(f"path {label}: non-finite state or negative Er")
            path_launches[label] = launches
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            return 1e3 * wall / steps, peak, sim.rad.solve_stats[n_stats:]

        # M3: the 3D gray rad-CTU pulse at N_M3^3, float64, a warm step, then
        # STEPS_M3 timed with the implicit update's and the CTU-rad chain's
        # shares (each call synchronized)
        sim = m_sim("pulse", "cuda", n=N_M3)
        sim.run(max_step=1, verbose=False)
        shares = {"ctu_rad": 0.0, "implicit": 0.0}
        chain, implicit = rad_hydro.ctu_rad_hydro, sim._implicit_rad

        def timed(key, fn):
            def run_(*a_, **kw_):
                t0_ = sync_s()
                out = fn(*a_, **kw_)
                shares[key] += sync_s() - t0_
                return out
            return run_

        rad_hydro.ctu_rad_hydro = timed("ctu_rad", chain)
        sim._implicit_rad = timed("implicit", implicit)
        sim.rad.solve_history = []  # each solve's tolerance and residual a V-cycle
        try:
            ms, peak, stats = drive_m(f"M3: 3D gray rad-CTU pulse {N_M3}^3 float64, {STEPS_M3} "
                                      f"steps after 1 warm", sim, {}, STEPS_M3)
        finally:
            rad_hydro.ctu_rad_hydro = chain
            del sim._implicit_rad
        cycles = [c_ for c_, _ in stats]
        zones = N_M3 ** 3
        wall_s = ms * STEPS_M3 / 1e3
        m_results["M3"] = dict(step_ms=ms, zones_per_s=zones / (ms / 1e3), peak_gib=peak,
                               outer_iters=sim.rad.outer_iters, solves=len(stats),
                               vcycles_per_solve=sum(cycles) / max(len(cycles), 1),
                               vcycles_max=max(cycles, default=0),
                               implicit_share=shares["implicit"] / wall_s,
                               ctu_rad_share=shares["ctu_rad"] / wall_s)
        print(f"  [{card}] M3: {ms:.1f} ms a step, {zones / (ms / 1e3):.6e} zones/s, peak memory "
              f"{peak:.3f} GiB; outer iterations {sim.rad.outer_iters} a step, {len(stats)} solves "
              f"in {STEPS_M3} steps, V-cycles a solve {m_results['M3']['vcycles_per_solve']:.2f} "
              f"(max {m_results['M3']['vcycles_max']}); the implicit update "
              f"{m_results['M3']['implicit_share']:.4f} of the steps, the CTU-rad chain "
              f"{m_results['M3']['ctu_rad_share']:.4f}", flush=True)
        # each solve's residual against its tolerance (rtol max|rhs|): where
        # the solves run their cap, the residual falls and then stays flat
        # above the tolerance (tests/test_torch_rad_vcycle_cap.py holds the
        # same plateau against the JAX package on the CPU)
        plateaus = []
        for k_, ((tol,), hist) in enumerate(sim.rad.solve_history):
            res = [h[0] for h in hist]
            late = res[len(res) // 2:]
            flat = max(late) / min(late)
            plateaus.append(dict(vcycles=len(res) - 1, tol=tol, first=res[0], final=res[-1],
                                 late_max_over_min=flat))
            print(f"  M3 solve {k_}: {len(res) - 1} V-cycles, residual {res[0]:.3e} -> "
                  f"{res[-1]:.3e} against the tolerance {tol:.3e} (final / tol "
                  f"{res[-1] / tol:.3f}); after V-cycles 1, 2, 4, 8, 16: "
                  f"{', '.join(f'{res[i_]:.2e}' for i_ in (1, 2, 4, 8, 16) if i_ < len(res))}; "
                  f"max / min over the last half {flat:.3f}")
            if res[-1] > tol and not (res[-1] < 1e-6 * res[0] and flat < 3.0):
                fail(f"path M3: solve {k_} stopped at its cap without a round-off plateau")
        m_results["M3"]["solves_residuals"] = plateaus
        sim.rad.solve_history = None
        # one more step under the profiler, the device's kernels only
        profile_steps(sim, 1, card, host=False)
        del sim
        torch.cuda.empty_cache()
        card_vs_cpu_m("M3-cmp")

        # M-split: the operator-split step through cmpflx / trans_cmpflx on
        # the radiation layout; each kernel then held bit for bit on the
        # run's final state
        for key, (kw, per_step, what) in split_runs.items():
            sim = m_sim(key, "cuda", **kw)
            dt_ = cmp_runs[f"M-split-{key}-cmp"][1][0]
            ms, peak, stats = drive_m(f"M-split {key}: {what}, float64, {STEPS_MSPLIT} steps",
                                      sim, per_step, STEPS_MSPLIT)
            print(f"  [{card}] M-split {key}: {ms:.1f} ms a step (the first's set-up in it), "
                  f"launches a step {per_step}, V-cycles a solve "
                  f"{sum(c_ for c_, _ in stats) / max(len(stats), 1):.2f}", flush=True)
            m_results[f"M-split-{key}"] = dict(step_ms=ms, peak_gib=peak, per_step=per_step)
            compare_low_dim(inputs_low_dim(sim, sim.u, dt_), f"M-split {key} ngroups 1 f64",
                            resets=((True, False), (False, True)))
            del sim
            card_vs_cpu_m(f"M-split-{key}-cmp")
        for ng_ in (1, 4):
            for dt_name in ("float32", "float64"):
                sim = m_sim("box", "cuda", n=N_MBOX_KERN, dtype=dt_name, ngroups=ng_)
                compare_low_dim(inputs_low_dim(sim, sim.u, M_DT),
                                f"M-split box {N_MBOX_KERN}^2 ngroups {ng_} {dt_name[5:]}",
                                resets=((True, False), (False, True)))
                del sim
        torch.cuda.empty_cache()

        # M-mg: rad_sphere against its analytic spectrum (the JAX test's
        # checks), su_olson multigroup and rad_shestakov against theirs, and
        # a float32 multigroup rad-CTU step with f-space advection and Compton
        t0_ = sync_s()
        r_, Er_, fld_ = rad_sphere.run(n=N_MSPH, t_end=M_SPH_T, dt=M_SPH_DT, device="cuda")
        sph_s = sync_s() - t0_
        sph = dict(s=sph_s, steps=int(round(M_SPH_T / M_SPH_DT)),
                   **rad_sphere.score(r_, Er_, M_SPH_T),
                   vcycles_per_solve=float(np.mean([c_ for c_, _ in fld_.solve_stats])))
        m_results["M-mg-rad_sphere"] = sph
        ok = sph["ok"]
        print(f"  [{card}] M-mg rad_sphere n={N_MSPH}, 60 groups, {sph['steps']} steps of "
              f"{M_SPH_DT:g} s to {M_SPH_T:g} s: {sph_s:.2f} s; at r = {sph['r_obs']:.4f} against "
              f"the analytic spectrum: median rel {sph['median_rel']:.4f} (limit 0.10), max rel "
              f"{sph['max_rel']:.4f} (0.6), energy {sph['energy_rel']:.4f} (0.15), peak shift "
              f"{sph['peak_shift']} (1); V-cycles a group solve {sph['vcycles_per_solve']:.2f} "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            fail("M-mg rad_sphere: the spectrum misses the analytic one")

        sim = m_sim("su_olson_mg", "cuda", n=N_MSO)
        L_ = sim.layout
        dx_ = float(sim.geom.dx[0])
        e_mat0 = float(sim.interior()[L_.UEINT].double().sum()) * dx_
        ms, peak, _ = drive_m(f"M-mg su_olson multigroup n={N_MSO}, {STEPS_MSO} steps", sim, {},
                              STEPS_MSO)
        e_rad = float(sim.u_rad.double().sum()) * dx_
        e_mat = float(sim.interior()[L_.UEINT].double().sum()) * dx_
        x_ = sim.geom.cell_centers_1d(0).cpu().numpy()
        injected = 2.0 * su_olson.MG_QN * (int(np.sum(np.abs(x_) <= su_olson.MG_X0)) * dx_) * sim.t
        bal = abs(e_rad + e_mat - e_mat0 - injected) / injected
        Er_n = sim.u_rad.cpu().numpy()
        far = x_ > 3.0
        asym = Er_n[0][far].max() / max(Er_n[1][far].max(), 1e-300)
        m_results["M-mg-su_olson"] = dict(step_ms=ms, balance_rel=bal, thin_over_thick_far=asym)
        print(f"  [{card}] M-mg su_olson MG: {ms:.1f} ms a step; after {STEPS_MSO} steps the "
              f"energy balance {bal:.3e} (limit 0.02), the thin group's far field / the thick "
              f"group's {asym:.3e} (limit > 10)", flush=True)
        if not (bal < 0.02 and asym > 10.0):
            fail("M-mg su_olson: the energy balance or the picket-fence asymmetry")
        del sim

        sim = m_sim("shestakov", "cuda", n=N_MSB)
        L_ = sim.layout
        sc = rad_shestakov.scales(sim.params)
        rhoe0 = float(sim.interior()[L_.UEINT].double().sum())
        sim.params = sim.params.with_ns("castro", fixed_dt=4.5339149910673475e-08)
        ms, peak, _ = drive_m(f"M-mg rad_shestakov n={N_MSB}, 64 groups, {STEPS_MSB} steps", sim,
                              {}, STEPS_MSB)
        Er_n = sim.u_rad.double().cpu().numpy()
        x_ = sim.geom.cell_centers_1d(0, 0).cpu().numpy()
        beyond = x_ > 1.5 * sc["x0"] * 0.5
        prof_ = Er_n.sum(axis=0)
        spec = Er_n[:, 2]
        carriers = int((spec > 0.01 * spec.max()).sum())
        budget = abs((rhoe0 - float(sim.interior()[L_.UEINT].double().sum())) - Er_n.sum()) / \
            Er_n.sum()
        m_results["M-mg-shestakov"] = dict(step_ms=ms, peak_gib=peak, carriers=carriers,
                                           budget_rel=budget)
        ok = prof_[beyond].max() > 1e-6 * prof_.max() and carriers >= 3 and budget < 0.05
        print(f"  [{card}] M-mg rad_shestakov: {ms:.1f} ms a step; Er beyond the jump "
              f"{prof_[beyond].max() / prof_.max():.3e} of the peak (> 1e-6), carrier groups "
              f"{carriers} (>= 3), energy budget {budget:.3e} (0.05) {'ok' if ok else 'FAILED'}",
              flush=True)
        if not ok:
            fail("M-mg rad_shestakov: the JAX test's checks")
        del sim

        sim = m_sim("mg3d", "cuda", n=N_MMG, dtype="float32")
        ms, peak, stats = drive_m(f"M-mg: float32 multigroup rad-CTU {N_MMG}^3 (hot spot), 4 "
                                  f"groups, f-space advection and Compton, 2 steps", sim, {}, 2)
        m_results["M-mg-f32"] = dict(step_ms=ms, peak_gib=peak,
                                     vcycles=[c_ for c_, _ in stats][:8],
                                     Er_min=float(sim.u_rad.min()), Er_max=float(sim.u_rad.max()))
        print(f"  [{card}] M-mg f32: {ms:.1f} ms a step (the first's set-up in it), finite, Er in "
              f"[{m_results['M-mg-f32']['Er_min']:.3e}, {m_results['M-mg-f32']['Er_max']:.3e}]; "
              f"V-cycles of the first solves {m_results['M-mg-f32']['vcycles']} (float32 "
              f"solves stall above rtol 1e-6 and run the cap of 15)", flush=True)
        del sim
        torch.cuda.empty_cache()

        # M-amr: tests/test_amr_radiation.py's hierarchy at N_MAMR^2 + 1
        # level (gray, do_hydro=0, float32 as that test), 2 coarse steps,
        # total energy (composite: uncovered coarse + masked fine) as that
        # test checks it; the multigroup + Compton composition small
        from castro_tpu_torch.ops.interlevel import restrict_mask

        def amr_energy(amr):
            L_ = amr.sim0.layout
            cov = torch.zeros_like(amr.masks[0])
            cov[amr._parent_rel_slice(1)] = restrict_mask(amr.masks[1], 2)
            cmask = amr.masks[0] & ~cov
            dxc = float(np.prod(amr.sim0.geom.dx))
            dxf = float(np.prod(amr._sims_at(1).geom.dx))
            m1 = amr.masks[1]
            e_ = (amr.interior(0)[L_.UEDEN][cmask].double().sum()
                  + amr.u_rad[0][cmask].double().sum()) * dxc
            e_ = e_ + (amr.interior(1)[L_.UEDEN][m1].double().sum()
                       + amr.u_rad[1][m1].double().sum()) * dxf
            return float(e_)

        print(f"main path M-amr: radiation hierarchy {N_MAMR}^2 + 1 level, {STEPS_MAMR} coarse "
              f"steps {elapsed()}", flush=True)
        amr = m_sim("amr", "cuda", n=N_MAMR)
        e0 = amr_energy(amr)
        K.reset_launch_counts()
        t0_ = sync_s()
        for _ in range(STEPS_MAMR):
            amr.advance(2e-7)
        wall = sync_s() - t0_
        e1 = amr_energy(amr)
        launches = {k_: v for k_, v in K.launch_counts().items() if v}
        ok = abs(e1 - e0) / abs(e0) < 5e-3 and all(
            bool(torch.isfinite(a_).all()) and float(a_.min()) >= 0.0 for a_ in amr.u_rad) and \
            not launches and 0 in amr._rad_sync_rhs
        m_results["M-amr"] = dict(coarse_step_ms=1e3 * wall / STEPS_MAMR,
                                  energy_rel=abs(e1 - e0) / abs(e0), window=list(amr.window[1][1]))
        print(f"  [{card}] M-amr: {1e3 * wall / STEPS_MAMR:.1f} ms a coarse step, window "
              f"{tuple(amr.window[1][1])}, refined cells {int(amr.masks[1].sum())}; total energy "
              f"{e0:.9e} -> {e1:.9e}, relative {abs(e1 - e0) / abs(e0):.3e} (limit 5e-3, the "
              f"deferred sync pending); launches {launches} (none: torch ops) "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            fail("path M-amr: energy, finiteness or the deferred sync")
        del amr
        amr = m_sim("amr_mg", "cuda", n=N_MAMR_MG)
        frac0 = [er.double().sum(dim=tuple(range(1, er.dim()))) / er.double().sum()
                 for er in amr.u_rad]
        for _ in range(2):
            amr.advance(2e-7)
        moved = []
        for l_, er in enumerate(amr.u_rad):
            if not (bool(torch.isfinite(er).all()) and float(er.min()) >= 0.0):
                fail("path M-amr multigroup: non-finite or negative Er")
            frac1 = er.double().sum(dim=tuple(range(1, er.dim()))) / er.double().sum()
            moved.append(float((frac1 - frac0[l_]).abs().max()))
        m_results["M-amr-mg"] = dict(group_fraction_moved=moved)
        print(f"  [{card}] M-amr multigroup + Compton {N_MAMR_MG}^2 + 1 level, 2 coarse steps: "
              f"finite, Er >= 0; the group fractions moved by {moved} on levels 0, 1", flush=True)
        if not all(m_ > 1e-8 for m_ in moved):
            fail("path M-amr multigroup: Compton did not redistribute the spectrum")
        del amr
        torch.cuda.empty_cache()

        # M-set: rad_shock (Mach 2) and rad_tests at their JAX sizes, init +
        # 2 steps each on the card, then card vs CPU
        for key, kw in set_runs.items():
            dts = cmp_runs[f"M-set-{key}-cmp"][1]
            sim = m_sim(key, "cuda", **kw)
            sim.params = sim.params.with_ns("castro", fixed_dt=dts[0])
            ms, peak, _ = drive_m(f"M-set {key}: {kw}, 2 steps", sim, {}, 2)
            m_results[f"M-set-{key}"] = dict(step_ms=ms)
            print(f"  [{card}] M-set {key}: {ms:.1f} ms a step, t = {sim.t:.6e}", flush=True)
            del sim
            card_vs_cpu_m(f"M-set-{key}-cmp")

    def path_m():
        pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
        try:
            path_m_body(pool)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    def path_n():
        # path N: ideal MHD (mhd/, the MHD branches of driver/sim.py and
        # driver/amr.py, ops/fill.py:fill_face, the face operators of
        # ops/interlevel.py). The JAX package runs MHD in XLA, no Pallas
        # kernel: every step here is torch ops and launches none of the
        # twelve kernels (launches_path_N).
        from castro_tpu_torch.mhd import MhdSimulation
        from castro_tpu_torch.ops.interlevel import restrict_face, restrict_mask
        from castro_tpu_torch.problems import mhd_tests as mt

        n_results = ctx.n_results = {}

        def sync_s():
            torch.cuda.synchronize()
            return time.perf_counter()

        def no_kernels(label):
            launches = K.launch_counts()
            path_launches[label] = launches
            if any(launches.values()):
                fail(f"path {label}: the MHD path launched a kernel: {launches}")

        def card_vs_cpu_n(label, kind, n, steps=STEPS_N_CPU, dtype="float64", rtol=F64_RTOL):
            """The same steps on the card and on the CPU: rtol |cpu| + rtol
            max|cpu| per component of the state and of each face field (and
            the same windows and masks on a hierarchy)."""
            K.reset_launch_counts()
            got, meta_g, secs = n_steps(kind, "cuda", n, steps, dtype)
            no_kernels(f"{label} (card)")
            ref, meta_r, secs_cpu = n_steps(kind, "cpu", n, steps, dtype)
            same = all(bool(torch.equal(a[0], b[0])) and a[1:] == b[1:]
                       for a, b in zip(meta_g, meta_r))
            err, rel, ok = n_compare(got, ref, rtol)
            print(f"card vs CPU, {label}: {kind} n={n} {dtype}, {steps} step(s): card {secs:.3f} s, "
                  f"CPU {secs_cpu:.3f} s; max abs err {err:.3e} rel {rel:.3e} (tol {rtol:g}|cpu| "
                  f"+ {rtol:g} max|cpu| per component, the momenta their vector's, the face fields "
                  f"max(|B|, sqrt(2 max rho E)))"
                  + (f"; windows and masks {'equal' if same else 'DIFFER'}" if meta_g else "")
                  + f" {'ok' if ok else 'DISAGREES'}", flush=True)
            if not ok:
                n_compare(got, ref, rtol, report=True)
                fail(f"path {label}: the card and the CPU disagree")
            if not same:
                fail(f"path {label}: the card's and the CPU's windows or masks differ")
            n_results[label] = dict(max_abs_err=err, max_rel_err=rel, card_s=secs, cpu_s=secs_cpu)

        def drive_n(label, sim, steps, warm=0, profile=False):
            """`warm` steps, then `steps` through Simulation.run with the
            launch counts zeroed just before and read just after (all must
            stay 0); finite state, div B. Returns (ms a step, peak GiB)."""
            print(f"main path {label}, Simulation.run on the card {elapsed()}", flush=True)
            sim.init_data()
            if warm:
                sim.run(max_step=sim.step_count + warm, verbose=False)
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            t0_ = sync_s()
            sim.run(max_step=sim.step_count + steps, verbose=False)
            wall = sync_s() - t0_
            no_kernels(label)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            divb = n_div_b(sim)
            finite = bool(torch.isfinite(sim.interior()).all()) and all(
                bool(torch.isfinite(bb).all()) for bb in sim.u_b)
            print(f"  {steps} steps after {warm} warm, t = {sim.t:.6e}: {1e3 * wall / steps:.1f} "
                  f"ms a step, peak {peak:.3f} GiB, max |div B| {divb:.3e} (limit {DIVB_MAX:g}), "
                  f"launches of the twelve kernels 0", flush=True)
            if not finite:
                fail(f"path {label}: non-finite state or face field")
            if divb > DIVB_MAX:
                fail(f"path {label}: div B {divb:.3e} above {DIVB_MAX:g}")
            res = dict(step_ms=1e3 * wall / steps, peak_gib=peak, div_b=divb, t=sim.t,
                       zones_per_s=float(np.prod(sim.geom.n_cell)) / (wall / steps))
            if profile:
                prof = profile_steps(sim, 1, card, host=False)
                if prof is not None:
                    res.update(profile_busy_ms=prof["busy_us"] / 1e3,
                               profile_wall_ms=prof["wall_us"] / 1e3, idle=prof["idle"],
                               device_launches=prof["launches"])
                if n_div_b(sim) > DIVB_MAX:
                    fail(f"path {label}: div B above {DIVB_MAX:g} after the profiled step")
            return res

        # N3: the 3D CTU-CT step at N_N3^3, full width, then card vs CPU
        sim = n_sim("alfven", "cuda", N_N3)
        res = drive_n(f"N3: 3D CTU-CT Alfven wave {N_N3}^3 float64, {STEPS_N3} steps after 1 "
                      f"warm", sim, STEPS_N3, warm=1, profile=True)
        n_results["N3"] = res
        print(f"  [{card}] N3: {res['step_ms']:.1f} ms a step, {res['zones_per_s']:.6e} zones/s, "
              f"peak {res['peak_gib']:.3f} GiB, idle {res.get('idle', float('nan')):.4f}, "
              f"device launches a step {res.get('device_launches', float('nan')):.0f}", flush=True)
        del sim
        torch.cuda.empty_cache()
        card_vs_cpu_n("N3-cmp", "alfven", N_N3_CPU)

        # N-rk2: the RK2 flux-CT step (castro.mhd_ctu=0)
        sim = n_sim("alfven_rk2", "cuda", N_NRK2)
        n_results["N-rk2"] = drive_n(f"N-rk2: 3D RK2 flux-CT Alfven wave {N_NRK2}^3 float64",
                                     sim, 2)
        del sim
        card_vs_cpu_n("N-rk2-cmp", "alfven_rk2", N_N3_CPU)

        # N2: Orszag-Tang, timed; card vs CPU; one float32 step
        sim = n_sim("ot", "cuda", N_N2)
        n_results["N2"] = drive_n(f"N2: Orszag-Tang {N_N2}^2 float64, {STEPS_N2} steps after 1 "
                                  f"warm", sim, STEPS_N2, warm=1, profile=True)
        del sim
        torch.cuda.empty_cache()
        card_vs_cpu_n("N2-cmp", "ot", N_N2_CPU)
        card_vs_cpu_n("N2-f32", "ot", N_N2_F32, steps=1, dtype="float32", rtol=RTOL)

        # N1: the Riemann tubes, MhdSimulation at the JAX tests' sizes
        # (tests/test_mhd.py, tests/test_mhd_problems.py) with their checks
        K.reset_launch_counts()
        bw = MhdSimulation(mt.brio_wu_params(n=N_NBW), problem_init=mt.tube_init())
        t0_ = sync_s()
        bw.run(stop_time=0.1)
        bw_s = sync_s() - t0_
        rho = bw.interior()[bw.base.layout.URHO].double().cpu().numpy()
        x = bw.base.geom.cell_centers_1d(0, 0).double().cpu().numpy()
        plateau = float(rho[(x > 0.44) & (x < 0.47)].mean())
        contact = float(rho[(x > 0.62) & (x < 0.65)].mean())
        bw_ok = (np.isfinite(rho).all() and rho.min() > 0
                 and np.allclose(rho[x < 0.05], 1.0, rtol=1e-6)
                 and np.allclose(rho[x > 0.95], 0.125, rtol=1e-6)
                 and 0.6 < plateau < 0.85 and 0.2 < contact < 0.4
                 and np.isclose(rho.mean(), (1.0 + 0.125) / 2, rtol=1e-10))
        print(f"  [{card}] N1 Brio-Wu n={N_NBW} to t=0.1: {bw.step_count} steps, {bw_s:.2f} s; plateau "
              f"{plateau:.4f} (0.6-0.85), post-contact {contact:.4f} (0.2-0.4), mean rho "
              f"{rho.mean():.12f} (0.5625) {'ok' if bw_ok else 'FAILS'}", flush=True)
        if not bw_ok:
            fail("path N1: Brio-Wu misses tests/test_mhd.py's checks")
        n_results["N1-brio_wu"] = dict(steps=bw.step_count, s=bw_s, plateau=plateau,
                                       contact=contact)
        del bw

        def tube(params, init, nsteps=20):
            m_ = MhdSimulation(params, problem_init=init)
            m_.init_data()
            dt_ = 0.5 * m_.estdt()
            for _ in range(nsteps):
                m_.state = m_.step(m_.state, dt_)
                m_.t += dt_
            return m_, m_.interior().double().cpu().numpy()

        dw, ui = tube(mt.dai_woodward_params(n=128), mt.tube_init(mt.DAI_WOODWARD))
        L = dw.base.layout
        dw_ok = np.isfinite(ui).all() and ui[L.URHO].max() > 1.081 and ui[L.URHO].min() > 0.1
        fr, ui2 = tube(mt.fast_rarefaction_params(n=128), mt.tube_init(mt.FAST_RAREFACTION))
        fr_ok = np.isfinite(ui2).all() and ui2[L.URHO][ui2.shape[1] // 2] < 0.99
        print(f"  N1 Dai-Woodward n=128, 20 steps: rho {ui[L.URHO].min():.4f} .. "
              f"{ui[L.URHO].max():.4f} (max > 1.081, min > 0.1) {'ok' if dw_ok else 'FAILS'}; "
              f"fast rarefaction n=128, 20 steps: centre rho {ui2[L.URHO][ui2.shape[1] // 2]:.4f} "
              f"(< 0.99) {'ok' if fr_ok else 'FAILS'}", flush=True)
        if not (dw_ok and fr_ok):
            fail("path N1: a tube misses tests/test_mhd_problems.py's checks")
        del dw, fr

        # N-set: loop advection, the species contact (MhdSimulation, the
        # JAX tests' sizes and checks), the RT setup through Simulation
        # with constant gravity (the old source traced and the corrector)
        n_ = 32
        lp = MhdSimulation(mt.loop_advection_params(n=n_), problem_init=mt.loop_advection_init)
        lp.init_data()
        div0 = lp.div_b_max()
        dt_ = 0.4 * lp.estdt()

        def loop_centre(m_):
            b2 = sum(bb[interior_slice(m_.base.ng, 2, 0)].double() ** 2 for bb in m_.state.b[:2])
            g_ = m_.base.geom
            return [float((b2 * g_.cell_centers(d, 0).double()).sum() / b2.sum()) for d in (0, 1)]

        c0 = loop_centre(lp)
        for _ in range(10):
            lp.state = lp.step(lp.state, dt_)
            lp.t += dt_
        c1 = loop_centre(lp)
        pp_ = mt.LOOP_DEFAULTS
        shift = [c1[0] - c0[0], c1[1] - c0[1]]
        want = [pp_["u_x"] * lp.t, pp_["u_y"] * lp.t]
        off = max(abs(a - b) for a, b in zip(shift, want)) * n_
        lp_ok = (div0 < 1e-12 and lp.div_b_max() < 1e-11 and bool(torch.isfinite(
            lp.interior()).all()) and off < 0.5)
        print(f"  N-set loop advection n={n_}, 10 steps: div B {div0:.3e} -> {lp.div_b_max():.3e} "
              f"(1e-12, 1e-11); the loop's |B|^2 centroid moved ({shift[0]:.5f}, {shift[1]:.5f}) "
              f"against u t = ({want[0]:.5f}, {want[1]:.5f}), {off:.3f} cells off (< 0.5) "
              f"{'ok' if lp_ok else 'FAILS'}", flush=True)
        if not lp_ok:
            fail("path N-set: loop advection")
        del lp
        sp_ = MhdSimulation(mt.species_params(n=64), problem_init=mt.species_init)
        sp_.init_data()
        Ls = sp_.base.layout
        X0 = sp_.interior()[Ls.UFS: Ls.UFS + 2].double().cpu().numpy()
        dt_ = 0.4 * sp_.estdt()
        for _ in range(12):
            sp_.state = sp_.step(sp_.state, dt_)
        ui = sp_.interior().double().cpu().numpy()
        X1 = ui[Ls.UFS: Ls.UFS + 2]
        frac0, frac1 = X0[0] / X0.sum(0), X1[0] / X1.sum(0)
        nx = X0.shape[1]
        best = int(np.argmin([np.abs(np.roll(frac0, k_) - frac1).mean() for k_ in range(nx)]))
        expect = 1.0 * dt_ * 12 * nx
        sp_ok = (np.allclose(X1.sum(0), ui[Ls.URHO], rtol=1e-10)
                 and min(abs(best - expect), nx - abs(best - expect)) < 2.0)
        print(f"  N-set species contact n=64, 12 steps: shifted {best} cells (expected "
              f"{expect:.2f}), species sum to rho {'ok' if sp_ok else 'FAILS'}", flush=True)
        if not sp_ok:
            fail("path N-set: the species contact")
        del sp_
        no_kernels("N1 and N-set (MhdSimulation)")
        rt = n_sim("rt", "cuda", 16)
        n_results["N-set-rt"] = drive_n("N-set RT 16 x 32, constant gravity", rt, 3)
        del rt
        card_vs_cpu_n("N-set-rt-cmp", "rt", 16)

        # N-amr: two-level Orszag-Tang, the CT register; card vs CPU
        print(f"main path N-amr: Orszag-Tang {N_NAMR}^2 + 1 level float64, {STEPS_NAMR} coarse "
              f"steps {elapsed()}", flush=True)
        amr = n_sim("amr", "cuda", N_NAMR)
        amr.init_data()
        div_init = [n_div_b(amr, l_) for l_ in range(2)]
        K.reset_launch_counts()
        t0_ = sync_s()
        amr.run(max_step=STEPS_NAMR, verbose=False)
        wall = sync_s() - t0_
        no_kernels("N-amr")
        prof = profile_steps(amr, 1, card, host=False)  # one more coarse step, profiled
        divs = [n_div_b(amr, l_) for l_ in range(2)]
        ng_, dim_ = amr.ng, amr.dim
        csl = amr._parent_rel_slice(1)
        cmask = restrict_mask(amr.masks[1], dim_)
        worst = 0.0
        for d in range(dim_):
            fine = amr.u_b[1][d][tuple(slice(ng_, ng_ + s_ + (1 if a == d else 0))
                                       for a, s_ in enumerate(amr.window[1][1]))]
            rf = restrict_face(fine, d, dim_)
            coarse = amr.u_b[0][d][tuple(slice(s_.start + ng_, s_.stop + ng_ + (1 if a == d else 0))
                                         for a, s_ in enumerate(csl))]
            n_d = cmask.shape[d]
            inner = cmask.narrow(d, 0, n_d - 1) & cmask.narrow(d, 1, n_d - 1)
            diff = (rf.narrow(d, 1, n_d - 1) - coarse.narrow(d, 1, n_d - 1)).abs()[inner]
            worst = max(worst, float(diff.max()))
        amr_ok = max(divs) < DIVB_MAX and worst < COVERED_FACES_MAX and bool(
            torch.isfinite(amr.interior(0)).all())
        n_results["N-amr"] = dict(coarse_step_ms=1e3 * wall / STEPS_NAMR, div_b=divs,
                                  div_b_init=div_init, covered_faces_max=worst,
                                  window=list(amr.window[1][1]),
                                  refined_cells=int(amr.masks[1].sum()))
        if prof is not None:
            n_results["N-amr"].update(profile_busy_ms=prof["busy_us"] / 1e3,
                                      profile_wall_ms=prof["wall_us"] / 1e3, idle=prof["idle"],
                                      device_launches=prof["launches"])
        print(f"  [{card}] N-amr: {1e3 * wall / STEPS_NAMR:.1f} ms a coarse step, window "
              f"{tuple(amr.window[1][1])}, {int(amr.masks[1].sum())} refined cells; max |div B| "
              f"{divs[0]:.3e} / {divs[1]:.3e} (limit {DIVB_MAX:g}); covered coarse faces against "
              f"the fine faces' restriction {worst:.3e} (< {COVERED_FACES_MAX:g}) "
              f"{'ok' if amr_ok else 'FAILS'}", flush=True)
        if not amr_ok:
            fail("path N-amr: div B, the covered faces or a non-finite state")
        del amr
        torch.cuda.empty_cache()
        card_vs_cpu_n("N-amr-cmp", "amr", N_NAMR_CPU, steps=2)

    def phase_probes():
        # the probes: each against its plain version, then the entry points
        print(f"probes vs plain (scripts/prof_cmpflx.py setup at 128^3, float32) {elapsed()}:",
              flush=True)
        px = ctx.px = prof_cmpflx.setup(n=120)
        pargs = ctx.pargs = prof_cmpflx.cmpflx_args(px)
        pref = P.probe_cmpflx_plain(*pargs)
        for label, (tile, threads) in prof_cmpflx.tilings(px["qm"].shape[1:]).items():
            check("probe_cmpflx", P.probe_cmpflx(*pargs, tile=tile, threads=threads), pref, label)
        cref = P.probe_copy_plain(px["qm"], px["qp"], px["layout"])
        for tile in ((8, None), P.BEST_TILE):
            check("probe_copy", P.probe_copy(px["qm"], px["qp"], px["layout"], tile=tile), cref,
                  f"tile {tile}")
        vx = ctx.vx = torch.full((512, 512), 1.1, dtype=torch.float32, device=dev)
        vx[0] = torch.linspace(0.3, 3.0, 512, device=dev)
        for op in P.VPU_OPS:
            got = P.probe_vpu(vx, op, VPU_CHECK_ITERS)
            ref = P.probe_vpu_plain(vx, op, VPU_CHECK_ITERS)
            err, rel, ok = compare(got, ref, VPU_RTOL[op])
            errs["probe_vpu"] = [max(errs["probe_vpu"][0], err), max(errs["probe_vpu"][1], rel)]
            print(f"  probe_vpu  {op}, {VPU_CHECK_ITERS} iterations{'':17s} max abs err {err:.3e} "
                  f"rel {rel:.3e} (tol {VPU_RTOL[op]:.3g}|plain|) {'ok' if ok else 'DISAGREES'}")
            if not ok:
                compare(got, ref, VPU_RTOL[op], report=True)
                fail(f"probe_vpu {op} disagrees with its plain version")
        print("probe entry points (python -m castro_tpu_torch.scripts.prof_cmpflx / prof_vpu):",
              flush=True)
        K.reset_launch_counts()
        probe_ms = ctx.probe_ms = prof_cmpflx.run(px, out=lambda line: print("  " + line))
        vpu_ps, vpu_bound_ps = prof_vpu.run(vx, out=lambda line: print("  " + line))
        ctx.vpu_ps, ctx.vpu_bound_ps = vpu_ps, vpu_bound_ps
        torch.cuda.synchronize()
        path_launches["probe: the entry points"] = K.launch_counts()
        print(f"  launches {path_launches['probe: the entry points']}", flush=True)
        if any(path_launches["probe: the entry points"][k] == 0
               for k in ("probe_cmpflx", "probe_copy", "probe_vpu")):
            fail("a probe entry point launched no probe kernel")

    def phase_timing():
        # -- 5. timing ---------------------------------------------------------------------
        print(f"timing {elapsed()}", flush=True)
        ctx.results = {}
        px, pargs, vx, probe_ms = ctx.px, ctx.pargs, ctx.vx, ctx.probe_ms
        vpu_ps, vpu_bound_ps = ctx.vpu_ps, ctx.vpu_bound_ps

        time_path(str(N_MAIN), f"A: Sedov {N_MAIN}^3", lambda: sedov_sim(N_MAIN), STEPS_MAIN,
                  profile=1)
        time_path(str(N_BIG), f"A: Sedov {N_BIG}^3", lambda: sedov_sim(N_BIG), STEPS_BIG)
        time_path(f"amr-{N_AMR}", f"G: 3D Sedov AMR {N_AMR}^3 + 1 level",
                  lambda: amr_sim(3, N_AMR), STEPS_AMR, profile=1)
        time_path(f"{N_MAIN}-cg", f"B: Sedov {N_MAIN}^3 riemann_solver=1",
                  lambda: sedov_sim(N_MAIN, riemann_solver=1), 5, profile=1)
        try:  # reported, not required: the unfused structure's live set at 264^3
            time_path(f"{N_BIG}-cg", f"B: Sedov {N_BIG}^3 riemann_solver=1",
                      lambda: sedov_sim(N_BIG, riemann_solver=1), 2)
        except torch.cuda.OutOfMemoryError as e:
            print(f"main path timing [{card}]: B: Sedov {N_BIG}^3 riemann_solver=1 not measured, "
                  f"out of device memory: {str(e).splitlines()[0]}")
            torch.cuda.empty_cache()
        time_path(f"{N_HYBRID}-hybrid", f"B: Sedov {N_HYBRID}^3 hybrid_riemann=1",
                  lambda: sedov_sim(N_HYBRID, hybrid_riemann=1), 10)
        time_path(f"{N_2D}^2", f"C: 2D Sedov {N_2D}^2", lambda: sedov_sim(N_2D, dim=2), 5,
                  profile=1)
        time_path(f"{N_2D}^2-cg", f"C: 2D Sedov {N_2D}^2 riemann_solver=1",
                  lambda: sedov_sim(N_2D, dim=2, riemann_solver=1), 3)
        time_path(f"{N_MAIN}-plm", f"D: Sedov {N_MAIN}^3 ppm_type=0",
                  lambda: sedov_sim(N_MAIN, ppm_type=0), STEPS_MAIN, profile=1)
        time_path(f"{N_MAIN}-limiter", f"D: Sedov {N_MAIN}^3 limit_fluxes_on_small_dens=1",
                  lambda: sedov_sim(N_MAIN, limit_fluxes_on_small_dens=1), 5)
        time_path(f"rz-{N_RZ}", f"E: 2D RZ Sedov {N_RZ} x {2 * N_RZ}",
                  lambda: curvilinear_sim("rz", N_RZ), 5, profile=1)
        time_path(f"dmr-{DMR_BIG[0]}", f"F: 2D double Mach reflection {DMR_BIG[0]} x {DMR_BIG[1]}",
                  lambda: dmr_sim(DMR_BIG), STEPS_DMR, profile=1)

        time_path("H1", f"H1: detonation n={N_DET}",
                  lambda: Simulation(detonation.make_params(n=N_DET),
                                     problem_init=detonation.problem_init), 10, profile=1)

        sim = sedov_sim(N_MAIN)
        sim.init_data()
        dt = sim.estimate_dt()
        sim.advance(dt)
        x = inputs(sim, sim.u, dt)
        L, cfg, dx, u = x["L"], x["cfg"], x["dx"], sim.u

        def term(t, f):
            return {"flux": tr[t][2], "qe": tr[t][3], "t_dir": t, "cdtdx": f * dt / dx[t]}

        isz = u.element_size()
        tr = [K.trace_ppm_plain(x["q"], x["qaux"], None, x["flatn"], d, dt, dx[d], L,
                                cfg.small_dens, cfg.small_pres, cfg.small_ener,
                                fuse_riemann=dict(coord=0, riemann_solver=0, bnd_mask=None))
              for d in range(3)]


        hsrc = torch.zeros_like(u)
        # name -> list of (kernel call, plain call, components moved[, elements[, variant]])
        calls = {}
        a = (u, L, x["eos"], cfg.small_dens, sim.small_temp, dx)
        # prim_aux reads six of u's components: not the total energy or the
        # temperature
        calls["prim_aux"] = [(lambda: K.prim_aux(*a, courant_dt=dt),
                              lambda: K.prim_aux_plain(*a, courant_dt=dt),
                              L.NVAR - 2 + L.NQ + L.NQAUX + 1)]
        calls["flatten"] = [(lambda: K.flatten(x["q"], L), lambda: K.flatten_plain(x["q"], L), 5)]
        # the face kernels variant by variant (scripts/prof_faces.py): trace_ppm
        # with the solve (A) and without (B); ctu_face's pair and final + consup
        # (A), terms=[] (D, PLM) and the final alone (D, limited)
        fx = prof_faces.setup(N_MAIN)
        face_calls = {("trace_ppm", "with the solve"): "trace_ppm",
                      ("trace_ppm", "without the solve"): "trace_ppm, no solve",
                      ("ctu_face", "corner pair"): "ctu_face",
                      ("ctu_face", "final + consup"): "ctu_face",
                      ("ctu_face", "terms=[]"): "ctu_face, terms=[]",
                      ("ctu_face", "final alone"): "ctu_face, final alone"}
        for name, variant, d, kern, plain, comps in prof_faces.variants(fx):
            calls.setdefault(face_calls[(name, variant)], []).append(
                (kern, plain, comps, u[0].numel(), variant))
        ca = (u, L, x["eos"], cfg.lo_bc, cfg.hi_bc, sim.ng, cfg.small_dens, sim.small_temp,
              x["eta2"], True)
        calls["clean_fill"] = [(lambda: K.clean_fill(*ca, with_status=True),
                                lambda: K.clean_fill_plain(*ca, with_status=True), 2 * L.NVAR)]
        # the unfused structure's kernels at 136^3: trans_apply on a corner and
        # on a final bundle, consup per direction
        calls["trans_apply"] = []
        for n_, terms, q_face, shift in ((0, [term(1, 1 / 3)], tr[0][1], 0),
                                         (1, [term(2, 1 / 3)], tr[1][0], -1),
                                         (2, [term(0, 0.5), term(1, 0.5)], tr[2][1], 0)):
            b = (q_face, *term_bundle(terms, x["qaux"], n_, shift, L), L, cfg.small_pres, True,
                 False)
            calls["trans_apply"].append((lambda b=b: K.trans_apply(*b),
                                         lambda b=b: K.trans_apply_plain(*b),
                                         2 * L.NQ + L.NVAR + 2))
        calls["consup"] = []
        for d in range(3):
            cs = (hsrc, tr[d][2], tr[d][3][L.GDPRES], tr[d][3][L.GDU + d], x["div"], u, d, L,
                  cfg.difmag, dx)
            fin = dt if d == 2 else None
            calls["consup"].append((lambda cs=cs, fin=fin: K.consup(*cs, finalize_dt=fin),
                                    lambda cs=cs, fin=fin: K.consup_plain(*cs, finalize_dt=fin),
                                    4 * L.NVAR + 3 + L.NVAR))
        # path C's kernels at 4104^2
        sim2 = sedov_sim(N_2D, dim=2)
        sim2.init_data()
        dt2 = sim2.estimate_dt()
        sim2.advance(dt2)
        y = inputs_low_dim(sim2, sim2.u, dt2)
        S2 = sim2.u[0].numel()
        calls["cmpflx"] = [(lambda a=a: K.cmpflx(*a), lambda a=a: K.cmpflx_plain(*a),
                            2 * L.NQ + 4 + L.NVAR + L.NGDNV, S2) for a in y["solves"]]
        calls["trans_cmpflx"] = [
            (lambda a=a: K.trans_cmpflx(*a, True, False),
             lambda a=a: K.trans_cmpflx_plain(*a, True, False),
             2 * L.NQ + 2 * L.NVAR + 8 + L.NVAR + L.NGDNV, S2) for a in y["finals"]]
        del y
        # the probes at the entry points' shapes: probe_cmpflx at its best shape
        # (the other tilings are in the entry point's lines), probe_copy the 30
        # components it must move, probe_vpu the fma body over 512^2
        SP = px["qm"][0].numel()
        calls["probe_cmpflx"] = [(lambda: P.probe_cmpflx(*pargs),
                                  lambda: P.probe_cmpflx_plain(*pargs),
                                  2 * L.NQ + 4 + L.NVAR + L.NGDNV, SP)]
        calls["probe_copy"] = [(lambda: P.probe_copy(px["qm"], px["qp"], px["layout"]),
                                lambda: P.probe_copy_plain(px["qm"], px["qp"], px["layout"]),
                                3 * L.NVAR + L.NGDNV, SP)]
        calls["probe_vpu"] = [(lambda: P.probe_vpu(vx, "fma", VPU_TIME_ITERS),
                               lambda: P.probe_vpu_plain(vx, "fma", VPU_TIME_ITERS), 2, vx.numel())]

        entries, extra = [], {}
        ctx.entries = entries
        print(f"kernel timing {elapsed()} [{card}], float32, at Sedov {N_MAIN}^3 (grown {u.shape[1]}^3; "
              f"cmpflx and trans_cmpflx at 2D Sedov {N_2D}^2, grown {sim2.u.shape[1]}^2; the "
              f"probes at 128^3 and, probe_vpu, 512^2 x {VPU_TIME_ITERS} iterations), per "
              f"launch: the kernel's device time (torch.profiler), the wrapper's and the plain "
              f"version's time (CUDA events); bound = max(bytes / {HBM_BYTES_PER_S:g} B/s, "
              f"operations of the plain version / {FP32_OPS_PER_S:g} op/s):", flush=True)
        by_variant = {}  # ctu_face's variants: the mean over the three directions
        by_direction = {}  # consup's rows: {"npass1_float32": [{d, ms, bound_ms, share}], ...}

        def direction_rows(key, rows_):
            by_direction[key] = [dict(d=d_, ms=r_["ms"], bound_ms=r_["bound_ms"],
                                      share=r_["bound_ms"] / r_["ms"], ms_from=r_["ms_from"])
                                 for d_, r_ in enumerate(rows_)]
            print(f"  consup by direction, {key.replace('_', ', ')}: " + "; ".join(
                f"d={r_['d']} {r_['ms']:.4f} ms, {r_['share']:.3f} of {r_['bound_ms']:.4f}"
                for r_ in by_direction[key]), flush=True)

        for name, variants in calls.items():
            sums, rows = time_kernel(name, variants, u[0].numel(), isz, FP32_OPS_PER_S, reps=20,
                                     plain_reps=3)
            if name == "consup":
                direction_rows("npass1_float32", rows)
            for r in rows:
                print(f"  {name:10s} {r['ms']:9.4f} ms   wrapper {r['wrapper_ms']:9.4f} ms   plain "
                      f"{r['plain_ms']:9.4f} ms   bound {r['bound_ms']:.4f} ms ({r['comps']} "
                      f"components, {r['bytes_ms']:.4f} ms; {r['ops_per_cell']:.1f} operations a "
                      f"cell, {r['ops_ms']:.4f} ms)", flush=True)
                if name.startswith("ctu_face"):
                    for key in ("ms", "plain_ms", "bound_ms"):
                        by_variant.setdefault(r["variant"], {}).setdefault(key, 0.0)
                        by_variant[r["variant"]][key] += r[key] / 3
            if name not in REPLACES:  # a second variant of a kernel: printed, kept with its kernel
                extra[name] = sums
                continue
            by_path = {label.split(":")[0] + ":" + label.split(":")[1].split(",")[0]: c[name]
                       for label, c in path_launches.items() if c[name]}
            entries.append({
                "name": name, "route": "cuda",
                "source": f"castro_tpu_torch/csrc/{SOURCE.get(name, name + '.cu')}",
                "replaces": REPLACES[name], "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": errs[name][0], "max_rel_err": errs[name][1], "ms": sums["ms"],
                "wrapper_ms": sums["wrapper_ms"], "plain_ms": sums["plain_ms"],
                "bound_ms": sums["bound_ms"],
                "bound_by": sums["bound_by"],
                "library_ms": None})
        for e in entries:
            if e["name"] == "trace_ppm":  # the variant the unfused structure launches
                e.update({k + "_no_solve": extra["trace_ppm, no solve"][k]
                          for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms")})
            if e["name"] == "ctu_face":
                e["ms_by_variant"] = by_variant
            if e["name"] in ("trace_ppm", "ctu_face", "prim_aux", "flatten", "clean_fill"):
                # float32, every direction and variant
                e["ptxas"] = [r for r in ptxas if r["kernel"].startswith(e["name"] + "_kernel<float")]
            if e["name"] == "probe_cmpflx":
                e["entry_point_ms_by_tiling"] = {k: v for k, v in probe_ms.items() if "cmpflx" in k}
            if e["name"] == "probe_copy":
                nbytes = prof_cmpflx.copy_bytes(px)
                e["bytes_moved"] = nbytes
                e["achieved_GB_s"] = nbytes / e["ms"] / 1e6
            if e["name"] == "consup":
                e["ptxas"] = [r for r in ptxas if r["kernel"].startswith("consup_")]
                e["by_direction"] = by_direction
            if e["name"] == "probe_vpu":
                e["iterations"] = VPU_TIME_ITERS
                e["ps_per_element_op"] = vpu_ps
                e["bound_ps_per_element_op"] = vpu_bound_ps
                e["ptxas"] = [r for r in ptxas if r["kernel"].startswith("probe_vpu_kernel")]
                # fma is two dependent FP32 instructions (FMUL, FADD: the
                # library builds with --fmad=false), so at the published
                # 67 TFLOP/s, which counts an FFMA as two operations, it can
                # take no less than twice the FLOP bound; fma_rn is one FFMA
                e["ceiling_ms"] = 2 * e["bound_ms"]
                e["share_of_bound"] = e["bound_ms"] / e["ms"]
                e["share_of_ceiling"] = e["ceiling_ms"] / e["ms"]
                rn_ms = kernel_device_ms(lambda: P.probe_vpu(vx, "fma_rn", VPU_TIME_ITERS),
                                         reps=5, name="probe_vpu") or kernel_event_ms(
                    lambda: P.probe_vpu(vx, "fma_rn", VPU_TIME_ITERS), reps=5)
                e["fma_rn"] = dict(ms=rn_ms, bound_ms=e["bound_ms"],
                                   share_of_bound=e["bound_ms"] / rn_ms)
                print(f"  probe_vpu  fma {e['ms']:.4f} ms: {e['share_of_bound']:.3f} of the "
                      f"{e['bound_ms']:.4f} ms bound ({FP32_OPS_PER_S:g} op/s, 2 a step), "
                      f"{e['share_of_ceiling']:.3f} of the {e['ceiling_ms']:.4f} ms ceiling of two "
                      f"FP32 instructions a step; fma_rn (one FFMA) {rn_ms:.4f} ms: "
                      f"{e['bound_ms'] / rn_ms:.3f} of the {e['bound_ms']:.4f} ms bound [{card}]",
                      flush=True)

        f64_calls = consup_f64_calls(fx)
        for (kern, plain, _), d in zip(f64_calls, range(3)):
            check("consup", kern(), plain(), f"float64, NPASS = 1, d={d}")
        _, rows = time_kernel("consup", f64_calls, u[0].numel(), 8, FP64_OPS_PER_S, reps=10,
                              plain_reps=1)
        direction_rows("npass1_float64", rows)
        del f64_calls
        h_launches = {}
        for label, c in path_launches.items():
            if label.startswith("H"):
                for k_, v_ in c.items():
                    h_launches[k_] = h_launches.get(k_, 0) + v_
        for nspec in (7, 19):
            cl, ul = layout_calls(nspec)
            Sl, iszl = ul[0].numel(), ul.element_size()
            print(f"kernel timing [{card}], float32, Sedov {N_MAIN}^3 with NPASS = {nspec} "
                  f"(NVAR {ul.shape[0]}), per launch as above {elapsed()}:", flush=True)
            for e in entries:
                if e["name"] not in cl:
                    continue
                sums, rows_l = time_kernel(e["name"], cl[e["name"]], Sl, iszl, FP32_OPS_PER_S,
                                           reps=10, plain_reps=2)
                # every variant and direction's device time, and where it came from
                by_row = [round(r_["ms"], 4) for r_ in rows_l]
                from_profiler = sum(r_["ms_from"] == "profiler" for r_ in rows_l)
                e[f"npass{nspec}"] = dict(
                    ms=sums["ms"], plain_ms=sums["plain_ms"], bound_ms=sums["bound_ms"],
                    bound_by=sums["bound_by"], launches_path_H=h_launches.get(e["name"], 0),
                    ms_by_direction=by_row, rows_from_profiler=from_profiler)
                print(f"  {e['name']:12s} {sums['ms']:9.4f} ms   plain {sums['plain_ms']:9.4f} ms   "
                      f"bound {sums['bound_ms']:.4f} ms ({e[f'npass{nspec}']['bound_by']}); "
                      f"NPASS = 1: {e['ms']:.4f} ms, bound {e['bound_ms']:.4f} ms; by direction "
                      f"{by_row}, {from_profiler} of {len(rows_l)} from the profiler, the rest "
                      f"from CUDA events around the launch", flush=True)
                if e["name"] == "consup" and nspec == 19:
                    direction_rows("npass19_float32", rows_l)
            if "consup, float64" in cl:
                for (kern, plain, _), d in zip(cl["consup, float64"], range(3)):
                    check("consup", kern(), plain(), f"float64, NPASS = {nspec}, d={d}")
                _, rows_l = time_kernel("consup", cl["consup, float64"], Sl, 8, FP64_OPS_PER_S,
                                        reps=10, plain_reps=1)
                direction_rows(f"npass{nspec}_float64", rows_l)
            del cl, ul
            torch.cuda.empty_cache()
        # path J's kernels in float64 at NPASS = 13 on flame_wave's state
        # (J-fw's grid, its initial state): the bound's operations over the
        # float64 peak, its bytes at 8 a value
        j_launches, k_launches, l_launches = {}, {}, {}
        for label, c in path_launches.items():
            for prefix, acc in (("J", j_launches), ("K", k_launches), ("L", l_launches)):
                if label.startswith(prefix):
                    for k_, v_ in c.items():
                        acc[k_] = acc.get(k_, 0) + v_
        sfw = flame_wave.build(n=N_FW)
        sfw.init_data()
        yf = inputs_low_dim(sfw, sfw.u, sfw.estimate_dt())
        Lf, Sf, iszf = sfw.layout, sfw.u[0].numel(), sfw.u.element_size()
        fcalls = {"cmpflx": [(lambda a=a: K.cmpflx(*a), lambda a=a: K.cmpflx_plain(*a),
                              2 * Lf.NQ + 4 + Lf.NVAR + Lf.NGDNV) for a in yf["solves"]],
                  "trans_cmpflx": [(lambda a=a: K.trans_cmpflx(*a, True, False),
                                    lambda a=a: K.trans_cmpflx_plain(*a, True, False),
                                    2 * Lf.NQ + 2 * Lf.NVAR + 8 + Lf.NVAR + Lf.NGDNV)
                                   for a in yf["finals"]]}
        print(f"kernel timing [{card}], float64, flame_wave {N_FW[0]} x {N_FW[1]} (grown "
              f"{tuple(sfw.u.shape[1:])}, NPASS = {Lf.nspec}), per launch as above, the operations "
              f"over {FP64_OPS_PER_S:g} op/s {elapsed()}:", flush=True)
        for e in entries:
            if e["name"] not in fcalls:
                continue
            sums, _ = time_kernel(e["name"], fcalls[e["name"]], Sf, iszf, FP64_OPS_PER_S, reps=10,
                                  plain_reps=2)
            e["float64_npass13_flame_wave"] = dict(
                ms=sums["ms"], wrapper_ms=sums["wrapper_ms"], plain_ms=sums["plain_ms"],
                bound_ms=sums["bound_ms"], bound_by=sums["bound_by"],
                launches_path_J=j_launches.get(e["name"], 0))
            print(f"  {e['name']:12s} {sums['ms']:9.4f} ms   wrapper {sums['wrapper_ms']:9.4f} ms   "
                  f"plain {sums['plain_ms']:9.4f} ms   bound {sums['bound_ms']:.4f} ms "
                  f"({e['float64_npass13_flame_wave']['bound_by']}; bytes {sums['bytes_ms']:.4f} ms, "
                  f"operations {sums['ops_ms']:.4f} ms)", flush=True)
        del sfw, yf, fcalls
        torch.cuda.empty_cache()
        # path M's kernels on the radiation layout (the operator-split box of
        # M-split at N_2D_RAD^2, its initial state): cmpflx, trans_cmpflx and
        # trans_apply, ngroups 1 and 4, float32 and float64; the bytes those
        # the function must move (the hydro components and the passives of
        # each state read, not the radiation ones it copies past; every
        # output written, the Godunov state's radiation components too)
        m_launches = {}
        for label, c in path_launches.items():
            if label.startswith("M"):
                for k_, v_ in c.items():
                    m_launches[k_] = m_launches.get(k_, 0) + v_
        rad_rows = {}
        for ng_ in (1, 4):
            for dt_name, ops_ps in (("float32", FP32_OPS_PER_S), ("float64", FP64_OPS_PER_S)):
                sbox = m_sim("box", "cuda", n=N_2D_RAD, dtype=dt_name, ngroups=ng_)
                yb = inputs_low_dim(sbox, sbox.u, M_DT)
                Lb, Sb, iszb = sbox.layout, sbox.u[0].numel(), sbox.u.element_size()
                qread = 8 + Lb.nspec + Lb.naux
                bcalls = {
                    "cmpflx": [(lambda a=a: K.cmpflx(*a), lambda a=a: K.cmpflx_plain(*a),
                                2 * qread + 4 + Lb.NVAR + Lb.NGDNV) for a in yb["solves"]],
                    "trans_cmpflx": [(lambda a=a: K.trans_cmpflx(*a, True, False),
                                      lambda a=a: K.trans_cmpflx_plain(*a, True, False),
                                      2 * qread + 2 * Lb.NVAR + 8 + Lb.NVAR + Lb.NGDNV)
                                     for a in yb["finals"]],
                    "trans_apply": [(lambda a=a: K.trans_apply(a[1], a[3], a[5], a[7], Lb,
                                                               yb["sp"], True, False),
                                     lambda a=a: K.trans_apply_plain(a[1], a[3], a[5], a[7], Lb,
                                                                     yb["sp"], True, False),
                                     2 * Lb.NQ + Lb.NVAR + 2) for a in yb["finals"]]}
                print(f"kernel timing [{card}], {dt_name}, the radiation layout (ngroups {ng_}, "
                      f"NQ {Lb.NQ}, NGDNV {Lb.NGDNV}), box {N_2D_RAD}^2 (grown "
                      f"{tuple(sbox.u.shape[1:])}), per launch as above {elapsed()}:", flush=True)
                for name, calls_ in bcalls.items():
                    sums, _ = time_kernel(name, calls_, Sb, iszb, ops_ps, reps=10, plain_reps=2)
                    rad_rows.setdefault(name, {})[f"ngroups{ng_}_{dt_name}"] = dict(
                        ms=sums["ms"], wrapper_ms=sums["wrapper_ms"], plain_ms=sums["plain_ms"],
                        bound_ms=sums["bound_ms"], bound_by=sums["bound_by"])
                    print(f"  {name:12s} {sums['ms']:9.4f} ms   wrapper {sums['wrapper_ms']:9.4f} "
                          f"ms   plain {sums['plain_ms']:9.4f} ms   bound {sums['bound_ms']:.4f} ms "
                          f"({sums['bound_by']}; bytes {sums['bytes_ms']:.4f} ms, operations "
                          f"{sums['ops_ms']:.4f} ms)", flush=True)
                del sbox, yb, bcalls
                torch.cuda.empty_cache()
        for e in entries:
            if e["name"] in REPLACES and e["name"] not in ("probe_cmpflx", "probe_copy",
                                                             "probe_vpu"):
                e["launches_path_H"] = h_launches.get(e["name"], 0)
                e["launches_path_J"] = j_launches.get(e["name"], 0)
                e["launches_path_K"] = k_launches.get(e["name"], 0)
                e["launches_path_L"] = l_launches.get(e["name"], 0)
                e["launches_path_M"] = m_launches.get(e["name"], 0)
            # path N (MHD) is torch ops: 0 for every kernel, checked there
            e["launches_path_N"] = sum(c.get(e["name"], 0) for label, c in path_launches.items()
                                       if label.startswith("N"))
            if e["name"] in rad_rows:
                e[f"radiation_layout_{N_2D_RAD}"] = rad_rows[e["name"]]

    phases = [("kernels", phase_kernels), ("A", path_a), ("B", path_b), ("C", path_c),
              ("D", path_d), ("E", path_e), ("F", path_f), ("G", path_g), ("H", path_h),
              ("I", path_i), ("J", path_j), ("K", path_k), ("L", path_l), ("M", path_m),
              ("N", path_n), ("probes", phase_probes),
              ("timing", phase_timing)]
    names = [name for name, _ in phases]
    wanted = list(argv) or names
    unknown = [w for w in wanted if w not in names]
    if unknown:
        print(f"unknown phase(s) {unknown}; the phases are {names}", file=sys.stderr)
        return 2
    if "timing" in wanted and "probes" not in wanted:
        wanted.append("probes")  # the timing phase times the probes at their inputs
    phase_s = {}
    for phase_key, phase_fn in phases:
        if phase_key in wanted:
            phase_t0 = time.perf_counter()
            phase_fn()
            phase_s[phase_key] = time.perf_counter() - phase_t0
            print(f"phase {phase_key}: {phase_s[phase_key]:.1f} s {elapsed()}", flush=True)
    print("phase times (s): " + json.dumps(phase_s), flush=True)
    if len(phase_s) < len(phases):
        # a partial run: no summary, no kernel table (their launch counts and
        # errors come from every path) and not the whole run's last line
        print(smi_line())
        print(f"partial run of the phases {[k for k in names if k in phase_s]}: passed")
        return 0
    entries, results = ctx.entries, ctx.results
    step_bound = sum(e["bound_ms"] * FUSED.get(e["name"], 0) for e in entries)
    print(f"summary [{card}]: " + json.dumps({
        "zones_per_s": {k: v["zones_per_s"] for k, v in results.items()},
        "step_ms": {k: v["step_ms"] for k, v in results.items()},
        "peak_gib": {k: v["peak_gib"] for k, v in results.items()},
        "step_bound_ms_128": step_bound, "sod_1d_ms_per_step": ctx.sod_ms, "sod_1d_l1": ctx.l1,
        "shock_zones_flagged": ctx.flagged, "rz_vs_spherical_l1": ctx.rz_l1,
        "rz_vs_spherical_peak_cells": ctx.peak_shift, "dmr_checks": ctx.dmr_checks,
        "amr_3d": results.get(f"amr-{N_AMR}"), "amr_3d_window_after_run": list(ctx.g3d_window),
        "amr_sod_1d_l1": ctx.g1_l1, "amr_sod_1d_ms_per_coarse_step": ctx.g1_ms,
        "path_H": ctx.h_results, "path_I": ctx.i_results, "path_J": ctx.j_results,
        "path_K": ctx.k_results, "path_L": ctx.l_results, "path_M": ctx.m_results,
        "path_N": ctx.n_results,
        "phase_s": phase_s,
        "detonation": dict(ms_per_step=ctx.det_ms, fuel_ratio=ctx.fuel_ratio,
                           max_mom=ctx.mom_max)}))
    print(smi_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
