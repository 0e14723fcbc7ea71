#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for sm_90a).

    python3 chip_smoke.py

Drives `mpctsid_tpu_torch` end to end on the card and fails (non-zero exit,
no result line) if any phase fails.  It needs a CUDA device and the CUDA
toolkit (`nvcc`); there is no CPU fallback.  Phases:

  1. device   card name and power limit (nvidia-smi), torch/CUDA versions,
              the asserted full-f32 matmul settings
  2. build    builds the ten kernel libraries (thirteen kernels: kernel A
              is admm_fused.cu's second entry point, the planner's three
              kernels are planner.cu's) from mpctsid_tpu_torch/qp/csrc,
              dyn/csrc and plan/csrc, one nvcc each, all started together
  3. kernels  each kernel against its plain PyTorch version on the card, same
              inputs (numpy seed), then its time, the plain version's time
              and the card's bound at the main path's shape:
              3a the M2 iteration (a thread-block cluster per scenario):
                 MPC shape (B=64, n=192, m=320: clusters of 2, M2 in
                 registers, A in shared memory), the test shape (B=3, n=24,
                 m=40: one block), B=1, a WBC-sized odd shape, B=67 (one
                 cluster more than a wave), shapes that take clusters of 3
                 and 7 (rows not 16-byte aligned), M2 in shared memory, A
                 streamed, M2 and A streamed (unit-scaled, well-conditioned
                 QPs: m >= n), a skewed M2 (the kernel must
                 apply M2 transposed) on a cluster and on one block, and the
                 main path's shape (B=4096, 192, 320), 30 iterations; each
                 launch's layout is printed and checked, two launches must
                 agree bit for bit;
              3b the generic and the packed refined iteration, inputs WITH
                 equality rows and infinite bounds: WBC shape (B=64, n=30,
                 m=50), test shape, B=1, B=37, B=531 (a partial last block
                 of warps), n=32, n=33, n=31, n=40, n=32 with m=8, the MPC
                 shape (B=8, generic kernel only; the packed kernel must
                 refuse it) and the main path's shape (B=4096, 30, 50), 13
                 iterations; also against EACH OTHER; the path of each
                 launch checked (generic: a warp per scenario for n <= 32,
                 else a block; packed: registers for n <= 32, else shared
                 memory), two launches of each bit for bit, the packed
                 register path bit for bit the generic warp path (one loop),
                 and a skewed K (it must apply K transposed);
              3c the whole-solve kernel on the same QPs, 40 iterations in 3
                 rounds, warm-started: unscaled x, y and the scales.  Its
                 warp path (one warp per scenario, n <= 32) at B = 1, 37, 64
                 and 4096 (a partial last block) at the WBC and the test
                 shape and at n = 32, the edge; its block path at n = 33 and
                 at the MPC shape (global workspace); the path each launch
                 takes is checked, and two launches must agree bit for bit
              3d the tensor-core iteration (K as given) against its plain
                 version: its warp path at the same B's and shapes; its
                 cluster path (matrices resident across a thread-block
                 cluster) at the MPC shape (B = 1, 8, 4096: clusters of 3), at
                 shapes that take clusters of 1, 2 and 6, at one whose n and
                 m are no multiples of 16 per block and at two that even a
                 cluster of 8 holds only in part (one with rows that are not
                 16-byte aligned in device memory); against the generic kernel
                 on a symmetric K; on a visibly skewed K, where "as given"
                 and "transposed" part, on BOTH paths; two launches bit for
                 bit; timed at both main-path shapes
              3e the WBC-build and plant-step kernels (dyn/csrc/, a warp per
                 scenario over the rigid-body core rbd.h) against
                 build_wbc_qp_reference and plant_step_reference on the same
                 inputs at B = 1, 37, 4094 (its last block partly filled)
                 and 4096, float32 (1e-4 of each output's largest entry) and
                 float64 (1e-10), payload off and on, exact_pin off and on:
                 the four gaits' contact mixes; plant states sliding,
                 sticking, pulled off the ground and above it, drawn away
                 from the contact law's switching surfaces; the layout each
                 launch took (dyn/kernels.py::rbd_layout on the card's
                 limits); two launches bit for bit; times at B = 1 and 4096
                 (a one-launch CUDA graph's replay, and the eager wrapper)
                 beside the plain chains' and the bounds
              3f kernel A (admm_solve_plain_warp: the default WBC solve in
                 one launch) against qp/admm.py's plain chain on the card:
                 random QPs with equality rows at B = 1, 37, 64 and n = 32
                 (the warp path's edge; n = 33 refused), the cascade's own
                 WBC QPs (config4_cascade_4k, mid-gait trot, B = 1, 37,
                 4096; float32 does not reproduce itself there: held where
                 the plain version lies within the tolerances of float64,
                 and by the median distance to float64) and B = 4096
                 random: unscaled x, y within FUSED_X_TOL / FUSED_Y_TOL on
                 all but B/200 scenarios, D, E, c within FUSED_SCALE_RTOL,
                 as close to float64 as the plain float32 chain (factor 2),
                 two launches bit for bit; kernel B (chol_inverse) against
                 blockinv.spd_inverse_chol: n = 30 (warp path) and 192
                 (blocked block path) at B = 1, 37, 4096, n = 33 and 240
                 (the working matrix in device memory), the panel edges
                 n = 63, 65, 191, 193 at B = 1 and 37 (each launch's layout
                 checked), the K of the cascade's own WBC and MPC solves:
                 |I - K X| in float64 within twice the plain version's; a
                 NaN and an indefinite matrix take the plain version's
                 fallbacks and leave the rest of the batch bit for bit;
                 times at B = 1 and 4096 beside the plain chains,
                 torch.linalg.inv_ex (kernel B) and the bounds
              3g the planner's kernels (plan/csrc/planner.cu: the footstep
                 horizon, the reference rollout, the swing reference)
                 against their plain versions at B = 1, 37 and 4096, float32
                 (1e-5 of each output's largest entry) and float64 (1e-12),
                 every gait, any yaw, swing durations of 0; the Ruiz kernel
                 (qp/csrc/ruiz.cu) against admm.ruiz_equilibrate at the
                 MPC's shape (its stride-0 constraint matrix, QPs built from
                 planned states) and the WBC's (dense A from the build
                 kernel) at B = 1, 37 and 4096 (1e-5); the entries whose
                 bits part are counted; two launches bit for bit; each
                 launch's layout (path: a thread-block cluster or a warp per
                 scenario; cluster size, blocks a multiprocessor); times at
                 B = 1, 256 and 4096 (a one-launch graph's replay, the eager
                 wrapper) beside the plain chains and the bounds
  4. rollout  the main path at full size: cascade_rollout of the preset
              config4_cascade_4k (B=4096 trot, v = 0.3 m/s), per-scenario
              friction in [0.5, 0.9], default solver budgets, MPC backend =
              the M2 kernel with kernel B's K^-1; once with the default WBC
              (kernel A) and once with each other kernel WBC backend
              ("fused", "packed", "vpu"); checks
              finiteness, mpc_ok, wbc_ok_frac, base height, and the launch
              counts of every kernel (set to 0 before each rollout; the WBC
              build, the plant step and the swing reference once a tick,
              the footstep horizon, the reference rollout and Ruiz once a
              period on every path, Ruiz once a tick more on the WBC
              iteration backends); then
              the same preset on the ESTIMATED state (complementary filter in
              the loop, hint-free) with both QP stages on the tensor-core
              kernel
  5. backends kernel on the path against plain on the path, B=256: the MPC
              backends "m2" and "torch" over two periods; each WBC backend,
              the default's kernel route among them, against the plain WBC
              chain (asked for explicitly) on one mid-gait WBC tick and one
              period;
              the estimator loop on the tensor-core kernel against the
              estimator loop on the plain backends, one period
  6. single   B=1, one period per WBC backend (the single-robot shape)
  7. sweep    the Monte-Carlo entry point: run_sweep over 2048 scenarios
              (mixed gaits, commands, friction, payload) in chunks of 1024, 3
              periods, default backends, each chunk replaying one CUDA graph
              per period (captured once: the launch counters move by two
              periods, the warm-up and the capture); then the same sweep
              stopped after one chunk, saved, loaded and finished: the two
              metric tables must be equal bit for bit; the first chunk run
              eagerly (cascade_rollout) equals the sweep's bit for bit
  8. accuracy the paths that carry the contract's 1e-4: solve_mpc_batch at
     tiers    B = 1024 on the port's own mid-gait trot MPC problems; the
              polished MPC tier (100 iterations in 4 rounds, KKT polish) in
              float32, on the plain backend and on the M2 kernel, against
              the same solve in float64 on the card (within 1e-4 in x, the
              largest over the batch); the df32 residual against a float64
              mat-vec (at least 100x closer than a float32 one); the float64
              WBC parity tier (WBC_PARITY_SOLVER's budget, warm-started,
              polished) at B = 4096 on a mid-gait tick, against the same
              call on the CPU
  9. host     the single-robot deployment path (host.py, B = 1, full
              Solo-12): a HostController per (MPC, WBC) backend pair (kernel
              1 with each WBC backend, kernel 5 on both stages) captures its
              four CUDA graphs (boundary, MPC, swing reference, WBC); over
              two periods on the plant, every replay is held against the
              same function run eagerly on the card (outputs and the warm
              starts it writes); the profiler counts the port's kernels in
              one replay of each graph (kernels 1 and B twice per MPC
              replay with the footstep, rollout and Ruiz kernels once, the
              WBC backend's kernel once (A, 4) or three times with kernel B
              and Ruiz once, the build kernel once per WBC replay, the
              footstep kernel once per boundary replay, the swing kernel
              once per swing replay);
              replay times; the `fused` WBC replay holds at most 40
              kernels, the default's at most 45, every MPC replay at most
              2,600; the default WBC replay captured with the plain solve
              chain and the MPC replay with the plain K^-1, the `fused` one
              with the plain QP build, and the boundary, MPC and swing
              replays with the plain planner and Ruiz, each beside the
              call as it ships, nodes and replay ms in turns (the before
              and after);
              then 0.6 s of closed loop, sync on the default
              and the fused WBC (upright, forward progress, plans consumed,
              WBC ok >= 0.99, no kernel launched outside the graphs, the
              telemetry ring holding every tick's torques) and async
              (planner thread on its own stream), with compute()'s p50 and
              p99 against the 2 ms budget (printed, not a gate)
  10. shard   a one-rank NCCL group runs sharded_cascade_rollout (the
              graphed rollout) at B = 1024 for one period: its all-reduced
              summary against the same reductions of an unsharded eager
              cascade_rollout; entry()'s
              cascade period on the card; dryrun_multichip refuses more
              ranks than cards
  11. oracle  the contract against the float64 oracle (mpctsid_tpu_torch/
              oracle/, numpy), which runs in a `spawn` pool of min(16, CPU
              count) one-thread processes while the card works:
              11a 512 MPC problems (128 each of trot, walk, bound, pace)
                  planned by the oracle: the port's contract tier
                  (mpc/srb.py::solve_mpc_contract: float64 condensation,
                  polished float32 solve) on the plain backend and on
                  kernel 1, every problem within 1e-4 of the oracle's
                  solve_mpc; the float32 build_mpc_qp with the same solve
                  printed beside it (over 1e-4 on a few problems: a
                  standing shortfall), the in-loop budget on kernel 1
                  printed; both assemblies' QPs against the oracle's;
                  every kernel 1 launch held against its plain version
              11b the oracle cascade's first 40 ticks of each gait, the four
                  gaits as one batch, warm-started tick to tick: the port's
                  float64 wbc/tsid.py::solve_wbc_contract within 1e-4 Nm on
                  every tick (the plain chain: float64 and polished); the
                  in-loop float32 solve on the default backend (kernel A)
                  and kernels 2-5 against the oracle (1e-2 Nm gated on
                  trot; walk, bound and pace printed: the in-loop budget
                  does not reach it, in the JAX package either), and every
                  kernel launch of those solves held against its plain
                  version on the same inputs at the kernel's tolerance
              11c a captured HostController per gait (kernel 1, plain WBC)
                  and on trot with kernel 4, fed the oracle controller's
                  (q, v): torques tick by tick against the oracle (1e-2 Nm
                  gated on trot, printed on the others), and each
                  controller's consumed MPC plans against a controller on
                  the plain MPC backend fed the same sequence (1e-3 N)
              11d config4_cascade_4k at B = 4096 for 40 periods, rows 0-3
                  walk, bound, pace and trot at the JAX package's
                  closed-loop commands: the per-gait bounds of
                  tests/test_cascade_jax.py and x within 0.02 m of the
                  oracle's closed loop; every row upright, kernel 1 twice
                  a period
  12. graphs  the batched period as one CUDA graph
              (cascade/graphed.py, the counterpart of jax.jit over the
              cascade): for each of phase 4's five configurations at
              B = 4096, a runner captures cascade_period from the rollout's
              initial state (the launch counters move by two periods: the
              warm-up and the capture); 12a each of the 3 periods replayed
              from phase 4's eager state of the period before, every state
              field and metric against eager (GRAPH_TOL; bit for bit
              printed), and the 3-period chain through
              cascade_rollout_graphed; 12b the profiler counts the kernels
              inside one replay (kernels 1 and B twice, the WBC's kernel 20
              or 60 times with kernel B 60 more, kernel 5 62 times: an eager
              period's launches), the
              copies, the device-busy ms; 12c period wall ms eager (phase
              4's) and graphed, median of 3, each ended by a synchronize,
              the idle share of a graphed period, the capture seconds and
              the pool's bytes; 12d the default and the fused WBC at B = 1
              and B = 256: eager and graphed period times, the state after
              3 replayed periods against eager
  13. bench   the port's bench (mpctsid_tpu_torch/bench.py, every timed
              rollout on graphs) into a temporary --out: 13a the headline
              at B = 1024 (upright_frac 1.0, mpc_fail_frac 0.0, wbc_ok_frac
              >= 0.99, every value finite; kernel 1 twice in one replay of
              its graph); 13b measure_latency (every time finite and
              positive; kernels 1, 2 and 4 inside their MPC chains'
              replays); 13c measure_host_loop; 13d run_presets +
              write_results (no FAILED row, no host_loop_error, config4 as
              13a, config2-3 finite, config5 no failed MPC solve, kernel 5
              inside the pallas_vs_xla chain's replay); RESULTS.md,
              BENCH_DETAIL.json and MULTIHOST_32K.json byte-identical

The line before the last is one JSON object describing every kernel of the
path (`launches_per_captured_period`: the kernel's launches inside one
replay of phase 12's graph; `bench_launches`: {bench function: the
kernel's launches there}, the wrappers' counters, which move at each
graph's warm-up and capture); the last line is {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import json
import math
import multiprocessing
import os
import sys
import tempfile
import time

import numpy as np
import torch

from mpctsid_tpu_torch import bench
from mpctsid_tpu_torch.bench import nvidia_smi_line
from mpctsid_tpu_torch.cascade import (CascadeConfigured, cascade_rollout,
                                       cascade_rollout_graphed, clear_runners,
                                       engine, init_controller, period_runner)
from mpctsid_tpu_torch.cascade.graphed import cached_runners
from mpctsid_tpu_torch.config import PRESETS, WBC_PARITY_SOLVER, EngineConfig
from mpctsid_tpu_torch.dist import (init_scenario_group, scenario_summary,
                                    sharded_cascade_rollout)
from mpctsid_tpu_torch.dyn import foot_positions, point_mass_spatial
from mpctsid_tpu_torch.dyn import kernels as rbd_kernels
from mpctsid_tpu_torch.entry import dryrun_multichip, entry
from mpctsid_tpu_torch.env.plant import (ContactParams, PlantState,
                                         contact_margins, plant_step,
                                         plant_step_reference)
from mpctsid_tpu_torch.est.filter import EstimatorState, estimator_init
from mpctsid_tpu_torch.host import HostController
from mpctsid_tpu_torch.model.gaits import GAIT_IDS, GAITS
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.mpc.srb import (CONTRACT_BUDGET, build_mpc_qp,
                                       solve_mpc_batch, solve_mpc_contract)
import mpctsid_tpu_torch.mpc.srb as srb_mod
import mpctsid_tpu_torch.plan.footsteps as footsteps_mod
import mpctsid_tpu_torch.plan.swing as swing_mod
from mpctsid_tpu_torch.plan import kernels as plan_kernels
from mpctsid_tpu_torch.plan.gait import TABLES as GAIT_TABLES
from mpctsid_tpu_torch.plan.gait import contacts_horizon
from mpctsid_tpu_torch.oracle import cascade as ocascade
from mpctsid_tpu_torch.oracle import mpc as ompc
from mpctsid_tpu_torch.oracle import planner as oplanner
from mpctsid_tpu_torch.oracle import sim as osim
from mpctsid_tpu_torch.qp import _build, kernels
from mpctsid_tpu_torch.qp import admm as admm_mod
from mpctsid_tpu_torch.qp.admm import admm_solve
from mpctsid_tpu_torch.qp.blockinv import spd_inverse_chol
from mpctsid_tpu_torch.qp.precision import residual_matvec
from mpctsid_tpu_torch.sweep import (METRIC_KEYS, SweepState, chunk_inputs,
                                     chunk_metrics, run_sweep,
                                     scenario_params, summarize)
from mpctsid_tpu_torch.utils import enforce_f32_matmuls
from mpctsid_tpu_torch.utils.graphs import CapturedCall
from mpctsid_tpu_torch.wbc import tsid as tsid_mod
from mpctsid_tpu_torch.wbc.tsid import (CONTRACT_ITERS, WbcRefs, solve_wbc,
                                        solve_wbc_contract)

# Published peaks of one H100 SXM (NVIDIA data sheet): the yardstick of the
# bound, whatever the power limit of the card at hand (printed beside it).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# The tensor cores' dense TF32 rate.  A product that keeps f32 accuracy takes
# at least three TF32 products (hi hi, hi lo, lo hi), so the f32-equivalent
# peak of split-TF32 work is a third of it: the operations side of kernel 5.
TF32_FLOP_PER_S = 495e12
SPLIT_TF32_FLOP_PER_S = TF32_FLOP_PER_S / 3.0

KERNEL_TOL = 1e-4      # abs, x/z/y on unit-scaled inequality-only QPs: same
                       # arithmetic, other summation order
# The refined iteration on QPs WITH equality rows.  On such a row rho is
# ~200, so y += rho (z_r - z) turns one f32 rounding of z (|z| ~ 3: 2e-7)
# into 4e-5 of y per iteration, and A' (rho z - y) feeds it back into x: two
# summation orders of the same arithmetic sit up to 4e-4 apart after 13
# iterations (measured on the CPU between the plain version and the TPU
# kernel in interpret mode: x 1.4e-4, z 3.7e-4, y 1.6e-4).  Without equality
# rows the same kernels are held to KERNEL_TOL.
REFINED_EQ_TOL = 1e-3
# The whole solve (two or three factorizations of cond ~1e4 matrices, 39-60
# iterations): the JAX package's own budget between two of its backends, on
# the UNSCALED solution.
FUSED_X_TOL = 1e-3
FUSED_Y_TOL = 1e-2
FUSED_SCALE_RTOL = 1e-4    # D, E, c: products of eight rsqrt's
# Downstream of a whole WBC solve the f32 noise of the 40-iteration solver
# decides (tests/test_torch_wbc.py: the JAX package differs from itself by
# 5.9e-2 Nm between lowerings; two backends of one package by up to 1.2e-1).
WBC_TAU_TOL = 0.2          # Nm, max over scenarios, one tick
WBC_TAU_MEDIAN_TOL = 5e-2  # Nm, median over scenarios
WBC_PERIOD_Q_TOL = 2e-3    # plant q after one period (20 ticks)
ROLLOUT_PERIODS = 3        # 60 WBC ticks per scenario
# Hint-free leg odometry drifts in x-y.  The JAX package's own test allows
# 0.065 m over 600 ms of trot (tests/test_estimator.py); this rollout lasts
# 60 ms from standing and was measured at 6.5e-4 m (max of 4096 scenarios,
# H100), so it is held to eight times that.
EST_DRIFT_TOL = 5e-3
SWEEP_TOTAL, SWEEP_CHUNK, SWEEP_PERIODS = 2048, 1024, 3
# Phase 8.  The contract's bar: control error < 1e-4 against the float64
# reference (BASELINE.json:5), here the polished float32 MPC solution
# against the same polished solve in float64, largest over the batch.
CONTRACT_TOL = 1e-4
MPC_TIER = CONTRACT_BUDGET      # the polished MPC tier (mpc/srb.py)
TIER_B = 1024
# The df32 residual must be this many times closer to float64 than a plain
# float32 mat-vec.
DF32_GAIN = 100.0
# The float64 WBC tier on the card against the same call on the CPU.  Both
# run the same float64 arithmetic in other summation orders (cuBLAS against
# the CPU's BLAS); 150 ADMM iterations through a cond ~1e5 KKT and an LU
# polish amplify a float64 rounding (1e-16 relative) to ~1e-11 relative of
# torques of ~1-10 Nm.  1e-6 Nm is 1/270 of the tier's own budget
# (1e-4 tau_max = 2.7e-4 Nm): no difference that passes can move the tier.
WBC_TIER_CPU_TOL = 1e-6
REFINED_ITERS = 13         # the WBC's 40 iterations in 3 rounds
# Phase 9.  A graph replays the kernels and ops its eager run launched, on
# the same inputs: the same bits are expected; 1e-6 is the bar if a library
# picks another summation order under capture.
GRAPH_TOL = 1e-6
GRAPH_TIMED = 3            # phase 12: timed periods, eager and graphed
HOST_SECONDS = 0.6         # simulated time of each closed-loop host run
TICK_BUDGET_MS = 2.0       # p50 single-tick latency at B = 1 (BASELINE.json:2)
# kernels in one replay of the host path's `fused` WBC graph: kernel 4, the
# build kernel and the solve's unscaling, residuals and torques (854 with
# the plain QP build on an H100)
FUSED_WBC_NODES = 40
# the same for the default WBC (kernel A in kernel 4's place; 3,014-3,019
# with the plain solve chain on an H100), and the host path's MPC replay on
# kernel 1 with kernel B's two inverses (8,994-8,999 with the plain
# inverses)
DEFAULT_WBC_NODES = 45
MPC_NODES = 2600
# (MPC backend, WBC backend) of the captured host controllers: every WBC
# backend, the MPC on kernel 1 (the default) and on kernel 5
HOST_BACKENDS = (("auto_mpc", "xla"), ("auto_mpc", "vpu"),
                 ("auto_mpc", "packed"), ("auto_mpc", "fused"),
                 ("pallas", "pallas"))
# name prefix of each kernel's __global__ functions, for the profiler
# (kernel B's block path launches spd_inverse_block_kernel and its guard,
# spd_newton_select_kernel, once per call: the prefix counts calls)
KERNEL_PREFIX = {"admm_iterate_m2": "admm_m2_",
                 "admm_iterate_vpu": "admm_vpu_",
                 "admm_iterate_vpu_packed": "admm_packed_",
                 "admm_solve_fused": "admm_fused_",
                 "admm_iterate": "admm_mma_",
                 "wbc_build": "wbc_build_kernel",
                 "plant_step": "plant_step_kernel",
                 "admm_solve_plain_warp": "admm_plain_warp_kernel",
                 "chol_inverse": "spd_inverse_",
                 "plan_footsteps_horizon": "plan_footsteps_kernel",
                 "reference_rollout": "plan_rollout_kernel",
                 "swing_foot_ref": "plan_swing_kernel",
                 "ruiz_equilibrate": "ruiz_kernel"}
SHARD_B = 1024             # phase 10: scenarios of the one-rank NCCL rollout
# Phase 11, the contract against the float64 oracle (mpctsid_tpu_torch/
# oracle/).  Torques of the in-loop float32 WBC against the oracle, Nm
# (tests/test_torch_host.py): measured 2.1e-3 - 4.0e-3 on trot.  On walk,
# bound and pace the in-loop budget (40 iterations in 3 rounds) ends 0.1 -
# 1.1 Nm from the oracle's converged QP in the JAX package as in the port
# (tests/test_torch_oracle_parity.py, _oracle_host.py): printed there, a
# standing shortfall (ROADMAP queue 3), gated on trot.
TAU_TOL = 1e-2
# 11c: consumed MPC plans of a kernel 1 host controller against one on the
# plain MPC backend, same (q, v) sequence, N (the port's plans against the
# JAX package's: tests/test_torch_host.py, _oracle_host.py)
PLAN_TOL = 1e-3
ORACLE_WORKERS = min(16, os.cpu_count() or 1)
ORACLE_GAITS = ("trot", "walk", "bound", "pace")
# each gait at the command of the JAX package's closed-loop tests
# (tests/test_cascade_jax.py:50-72), friction 0.7 (the oracle's default)
ORACLE_CMD = {"walk": (0.2, 0.0, 0.0), "bound": (0.25, 0.0, 0.0),
              "pace": (0.3, 0.0, 0.0), "trot": (0.3, 0.0, 0.0)}
ORACLE_S = 512             # 11a: MPC problems, 128 per gait
ORACLE_QP_CHECKED = 32     # 11a: of them, QP matrices held to the oracle's
ORACLE_TICKS = 40          # 11b, 11c: two periods from standing
INLOOP_MPC = dict(iters=60, adapt_rounds=2, rho=0.1)   # the cascade's budget
WBC_INLOOP_BACKENDS = ("xla", "vpu", "packed", "fused", "pallas")
# 11c: (gait, MPC backend, WBC backend) of the captured host controllers
ORACLE_HOSTS = (("trot", "auto_mpc", "xla"), ("walk", "auto_mpc", "xla"),
                ("bound", "auto_mpc", "xla"), ("pace", "auto_mpc", "xla"),
                ("trot", "auto_mpc", "fused"))
LONG_PERIODS = 40          # 11d
# 11d, rows 0-3: the JAX package's per-gait bounds over 40 periods
# (tests/test_cascade_jax.py:50-60): (min height, max |roll|, |pitch|,
# min x at the end); trot: height > 0.15, roll/pitch < 0.15
GAIT_BOUNDS = {"walk": (0.20, 0.10, 0.05), "bound": (0.12, 0.25, 0.07),
               "pace": (0.20, 0.25, 0.05), "trot": (0.15, 0.15, None)}
# 11d: |x_port - x_oracle| at the end of 40 periods, m.  On the CPU the port
# parts from the oracle by 8.3e-4 m at most over 10 periods
# (tests/test_torch_oracle_loop.py, band 5e-3) and by 1.6e-3 / 1.7e-3 /
# 5.5e-3 / 1.7e-4 m (walk / bound / pace / trot) over 40; chaotic contact
# lets the parting grow with time (6.6x from 10 to 40 periods) and the
# card's float32 rounding starts it elsewhere, so 40 periods get 3.6x the
# largest CPU measurement.
LONG_X_BAND = 0.02
FAILURES: list[str] = []


def check(cond: bool, what: str) -> None:
    print(f"  [{'ok' if cond else 'FAIL'}] {what}", flush=True)
    if not cond:
        FAILURES.append(what)


# ------------------------------------------------------------ kernel inputs

def random_qps(seed: int, B: int, n: int, m: int, eq: bool):
    """Unit-scaled random QPs (numpy, seeded): P, q, A, l, u.  With `eq`,
    four equality rows and a few infinite bounds (+-1e20, the convention of
    the WBC's swing rows)."""
    r = np.random.default_rng(seed)
    Q = r.normal(size=(B, n, n))
    P = Q @ Q.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    q = r.normal(size=(B, n))
    A = r.normal(size=(B, m, n))
    x_feas = r.normal(size=(B, n)) * 0.1
    margin = np.abs(r.normal(size=(B, m))) + 0.1
    Ax = np.einsum("bmn,bn->bm", A, x_feas)
    l, u = Ax - margin, Ax + margin
    if eq:
        l[:, :4] = u[:, :4] = Ax[:, :4]
        l[:, 10:13] = -1e20
        u[:, 12:15] = 1e20
    return r, P, q, A, l, u


def _dev(device):
    return lambda a, dt=torch.float32: torch.as_tensor(a).to(  # noqa: E731
        device, dt).contiguous()


def iteration_inputs(seed: int, B: int, n: int, m: int, device, eq: bool):
    """What the solver hands an iteration kernel: K = P + sigma I + A' rho A
    and its inverse (float64 on the card, rounded to float32 and left as
    unsymmetric as rounding makes them), rho with the 1e3 boost on equality
    rows, warm iterates.  Returns (m2_args, refined_args)."""
    r, P, q, A, l, u = random_qps(seed, B, n, m, eq)
    rho = 0.1 * (1.0 + r.uniform(size=(B, m))) * np.where(
        (u - l) < 1e-9, 1e3, 1.0)
    x = r.normal(size=(B, n)) * 0.1
    y = r.normal(size=(B, m)) * 0.1
    z = np.clip(np.einsum("bmn,bn->bm", A, x), l, u)
    dev = _dev(device)
    A64, P64, rho64 = (dev(a, torch.float64) for a in (A, P, rho))
    K = P64 + 1e-6 * torch.eye(n, dtype=torch.float64, device=device) \
        + torch.bmm((A64 * rho64[:, :, None]).transpose(1, 2), A64)
    Ki = torch.linalg.inv(K)
    M2 = (2.0 * Ki - Ki @ K @ Ki).float().contiguous()
    vecs = [dev(a) for a in (A, q, l, u, rho, x, z, y)]
    return [M2] + vecs, [Ki.float().contiguous(), K.float().contiguous()] + vecs


def fused_inputs(seed: int, B: int, n: int, m: int, device):
    r, P, q, A, l, u = random_qps(seed, B, n, m, eq=True)
    eqf = ((u - l) < 1e-9).astype(np.float32)
    x0 = r.normal(size=(B, n)) * 0.1
    y0 = r.normal(size=(B, m)) * 0.1
    dev = _dev(device)
    return [dev(a) for a in (P, q, A, l, u, eqf, x0, y0)]


def shape_of(args, a_index: int):
    B, n = args[0].shape[:2]
    return B, n, args[a_index].shape[1]


def max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def all_finite(tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def check_repeatable(label: str, fn) -> None:
    """Two launches on the same inputs must agree bit for bit (no atomics,
    no order that changes from run to run)."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          f"{label}: two launches agree bit for bit")


def m2_residency(resident: int) -> str:
    m2 = ("in registers" if resident & kernels.RES_M2_REGS else
          "in shared memory" if resident & kernels.RES_M2 else "streamed")
    a = "in shared memory" if resident & kernels.RES_M2_A else "streamed"
    return f"M2 {m2}, A {a}"


def compare_m2(name: str, args, iters: int = 30, cluster: int = 1,
               resident: int = kernels.RES_M2_REGS | kernels.RES_M2_A,
               gate: str = "plain"):
    """Kernel 1 against its plain version and a float64 run of it; returns
    the max abs error against the plain version.  The launch must take
    clusters of `cluster` blocks with the slices where `resident` says, and
    two launches must agree bit for bit.

    Against the float64 run the kernel must be as accurate as the float32
    plain version is (within a factor 2 plus a tenth of the tolerance), as
    kernel 5 is.  With gate="float64" that is the only gate on the values:
    for a QP whose plain float32 version itself lies at KERNEL_TOL from the
    float64 run, two float32 summation orders lie that far apart too, and
    the distance to the plain version is printed, not held."""
    kw = dict(iters=iters, sigma=1e-6, alpha=1.6)
    B, n, m = shape_of(args, 1)
    lay = kernels.m2_layout(n, m,
                            kernels.device_limits(args[0].device)[0])
    print(f"  m2 {name}: clusters of {lay.cluster} blocks x {lay.threads} "
          f"threads, {m2_residency(lay.resident)}, {4 * lay.smem_floats} B "
          f"of shared memory per block, "
          f"{kernels.m2_active_clusters(lay)} clusters resident at once",
          flush=True)
    check((lay.cluster, lay.resident) == (cluster, resident),
          f"m2 kernel, {name}: clusters of {cluster}, "
          f"{m2_residency(resident)}")
    got = kernels.admm_iterate_m2(*args, **kw)
    torch.cuda.synchronize()
    want = kernels.admm_iterate_m2_reference(*args, **kw)
    err = max_err(got, want)
    check_repeatable(f"m2 kernel, {name}",
                     lambda: kernels.admm_iterate_m2(*args, **kw))
    want64 = [t.float() for t in kernels.admm_iterate_m2_reference(
        *[a.double() for a in args], **kw)]
    k64, p64 = max_err(got, want64), max_err(want, want64)
    print(f"  m2 {name}: B={B} n={n} m={m} iters={iters} "
          f"max|d(x,z,y)|={err:.3e}; distance to a float64 run: kernel "
          f"{k64:.3e}, plain {p64:.3e}", flush=True)
    check(all_finite(got) and k64 <= 2.0 * p64 + KERNEL_TOL / 10,
          f"m2 kernel, {name}: as close to the float64 run as the plain "
          "float32 version (factor 2, plus a tenth of the tolerance)")
    if gate == "plain":
        check(err < KERNEL_TOL,
              f"m2 kernel vs plain, {name}: max abs err {err:.3e} < "
              f"{KERNEL_TOL:g}")
    return err


def compare_m2_skewed(name: str, args, iters: int = 30) -> float:
    """M2 made visibly non-symmetric: kernel 1 must follow the plain version,
    which applies M2 TRANSPOSED, and lie far from the same loop with M2 as
    given (the side a split of M2 by rows or by columns gets wrong)."""
    kw = dict(iters=iters, sigma=1e-6, alpha=1.6)
    skewed = list(args)
    M2 = args[0]
    g = torch.Generator(device="cpu").manual_seed(0)
    noise = torch.randn(M2.shape, generator=g).to(M2.device)
    skewed[0] = (M2 + SKEW * M2.abs().max() * torch.triu(noise, 1)
                 ).contiguous()
    got = kernels.admm_iterate_m2(*skewed, **kw)
    torch.cuda.synchronize()
    transposed = kernels.admm_iterate_m2_reference(*skewed, **kw)
    as_given = kernels.admm_iterate_m2_reference(
        skewed[0].transpose(1, 2).contiguous(), *skewed[1:], **kw)
    err = max_err(got, transposed)
    apart = max_err(got, as_given)
    sides = max_err(transposed, as_given)
    print(f"  m2 {name}, skewed M2 ({SKEW:g} of max|M2| above the diagonal): "
          f"vs plain M2 transposed {err:.3e}; vs plain M2 as given "
          f"{apart:.3e} (the two plain versions {sides:.3e} apart)",
          flush=True)
    check(all_finite(got) and err < KERNEL_TOL,
          f"m2 kernel, {name}, applies M2 transposed: < {KERNEL_TOL:g} of "
          "that plain version")
    check(apart > 10 * KERNEL_TOL and apart > 10 * err,
          f"m2 kernel, {name}, on a skewed M2 is far (> 10 tolerances, > 10 "
          "x its error) from M2 applied as given")
    return err


def packed_layout_of(B: int, n: int, m: int, device):
    return kernels.packed_layout(n, m, B, *kernels.device_limits(device),
                                 kernels.packed_slot_floats)


def compare_refined(name: str, args, tol: float, packed: bool = True,
                    path: str = "warp", packed_path: str = "registers"):
    """Kernels 2 and 3 against the one plain version and against each other;
    returns (err of the generic kernel, err of the packed kernel).  Kernel 2
    must take `path` ("warp" or "block") and kernel 3 `packed_path`
    ("registers" or "shared"); two launches of each must agree bit for bit,
    and where kernel 2's warp path and kernel 3's register path run the one
    loop of warp_regs.cuh, kernel 3 must give kernel 2's bits."""
    kw = dict(iters=REFINED_ITERS, sigma=1e-6, alpha=1.6)
    B, n, m = shape_of(args, 2)
    lay = kernels.vpu_layout(n, m, B, *kernels.device_limits(args[0].device))
    print(f"  vpu {name}: {lay.path} path, "
          + (f"{lay.g} scenarios (warps) per block" if lay.path == "warp"
             else f"one block of {lay.threads} threads per scenario"),
          flush=True)
    check(lay.path == path, f"vpu kernel, {name}: takes the {path} path")
    want = kernels.admm_iterate_refined_reference(*args, **kw)
    got_v = kernels.admm_iterate_vpu(*args, **kw)
    torch.cuda.synchronize()
    err_v = max_err(got_v, want)
    check_repeatable(f"vpu kernel, {name}",
                     lambda: kernels.admm_iterate_vpu(*args, **kw))
    line = (f"  refined {name}: B={B} n={n} m={m} iters={REFINED_ITERS} "
            f"vpu vs plain {err_v:.3e}")
    ok = all_finite(got_v) and err_v < tol
    err_p = 0.0
    if packed:
        play = packed_layout_of(B, n, m, args[0].device)
        print(f"  packed {name}: {play.path} path, {play.g} scenarios "
              f"(warps) per block, {4 * play.slot_floats} B of shared memory "
              "per scenario", flush=True)
        check(play.path == packed_path,
              f"packed kernel, {name}: takes the {packed_path} path")
        got_p = kernels.admm_iterate_vpu_packed(*args, **kw)
        torch.cuda.synchronize()
        err_p = max_err(got_p, want)
        err_vp = max_err(got_p, got_v)
        check_repeatable(f"packed kernel, {name}",
                         lambda: kernels.admm_iterate_vpu_packed(*args, **kw))
        line += f", packed vs plain {err_p:.3e}, packed vs vpu {err_vp:.3e}"
        ok = ok and all_finite(got_p) and err_p < tol and err_vp < tol
        if play.path == "registers" and lay.path == "warp":
            check(all(torch.equal(a, b) for a, b in zip(got_p, got_v)),
                  f"packed kernel, {name}: kernel 2's bits (one loop, "
                  "warp_regs.cuh)")
    print(line, flush=True)
    check(ok, f"refined kernels vs plain and each other, {name}: < {tol:g}")
    return err_v, err_p


def compare_mma(name: str, args, tol: float, iters: int = REFINED_ITERS,
                f64: bool = True, path: str = "warp", cluster: int = 0):
    """Kernel 5 against its plain version (K as given), and against the
    generic kernel on the same inputs with K made exactly symmetric (there
    the two sides of K are one function); returns the error against plain.
    The launch must take `path` ("warp", or "cluster" with `cluster` blocks
    per scenario), and two launches must agree bit for bit.

    With `f64` also the precision contract of the split-TF32 products:
    against a float64 run of the plain version the kernel must be as accurate
    as the float32 plain version is (within a factor 2; both distances are
    maxima of chaotic rounding noise, hence the tenth of the tolerance)."""
    kw = dict(iters=iters, sigma=1e-6, alpha=1.6)
    B, n, m = shape_of(args, 2)
    lay = kernels.mma_layout(n, m, B,
                             *kernels.device_limits(args[0].device))
    check((lay.path, lay.cluster) == (path, cluster),
          f"mma kernel, {name}: takes the {path} path"
          + (f" with clusters of {cluster}" if cluster else "")
          + f" ({lay})")
    want = kernels.admm_iterate_reference(*args, **kw)
    got = kernels.admm_iterate(*args, **kw)
    torch.cuda.synchronize()
    err = max_err(got, want)
    check_repeatable(f"mma kernel, {name}",
                     lambda: kernels.admm_iterate(*args, **kw))
    if f64:
        want64 = [t.float() for t in kernels.admm_iterate_reference(
            *[a.double() for a in args], **kw)]
        k64, p64 = max_err(got, want64), max_err(want, want64)
        print(f"  mma {name}: distance to a float64 run: kernel {k64:.3e}, "
              f"plain {p64:.3e}", flush=True)
        check(k64 <= 2.0 * p64 + tol / 10,
              f"mma kernel, {name}: as close to the float64 run as the plain "
              "float32 version (factor 2, plus a tenth of the tolerance)")
    sym = list(args)
    sym[1] = (0.5 * (args[1] + args[1].transpose(1, 2))).contiguous()
    got_s = kernels.admm_iterate(*sym, **kw)
    got_v = kernels.admm_iterate_vpu(*sym, **kw)
    torch.cuda.synchronize()
    err_v = max_err(got_s, got_v)
    print(f"  mma {name}: B={B} n={n} m={m} iters={iters} vs plain "
          f"{err:.3e}; symmetric K, vs the generic kernel {err_v:.3e}",
          flush=True)
    check(all_finite(got) and all_finite(got_s) and err < tol
          and err_v < tol,
          f"mma kernel vs plain and (symmetric K) vs the generic kernel, "
          f"{name}: < {tol:g}")
    return err


def time_mma(args, iters: int, reps: int, smi: str) -> dict:
    """Kernel 5, its plain version and the bound at the shape of `args`; also
    the generic FMA kernel's time (kernel 2: the same work with K
    transposed) as the yardstick of the tensor-core mat-vec."""
    kw = dict(iters=iters, sigma=1e-6, alpha=1.6)
    B, n, m = shape_of(args, 2)
    ms = time_ms(lambda: kernels.admm_iterate(*args, **kw), 2, reps)
    plain_ms = time_ms(
        lambda: kernels.admm_iterate_reference(*args, **kw), 1, 3)
    bound = refined_bound_ms(B, n, m, iters, SPLIT_TF32_FLOP_PER_S)
    report_times("mma", f"B={B} n={n} m={m} iters={iters}", ms, plain_ms,
                 bound, smi)
    vpu_ms = time_ms(lambda: kernels.admm_iterate_vpu(*args, **kw), 2, reps)
    print(f"    the generic FMA kernel on the same inputs: {vpu_ms:.4f} ms",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1])


SKEW = 3e-5     # of max |K|, added above the diagonal only


def compare_skewed_k(name: str, args, label: str = "mma") -> float:
    """K made visibly non-symmetric: kernel 5 ("mma") must follow the plain
    version that applies K AS GIVEN and lie far from the one that applies K
    transposed; kernel 2 ("vpu") the other way round.  x and z are compared:
    on a skewed K the refinement no longer cancels, and y (rho ~200 on
    equality rows) amplifies the rounding of z beyond any fixed tolerance."""
    kw = dict(iters=REFINED_ITERS, sigma=1e-6, alpha=1.6)
    skewed = list(args)
    K = args[1]
    g = torch.Generator(device="cpu").manual_seed(0)
    noise = torch.randn(K.shape, generator=g).to(K.device)
    skewed[1] = (K + SKEW * K.abs().max() * torch.triu(noise, 1)).contiguous()
    given = label == "mma"
    kernel = kernels.admm_iterate if given else kernels.admm_iterate_vpu
    got = kernel(*skewed, **kw)
    torch.cuda.synchronize()
    as_given = kernels.admm_iterate_reference(*skewed, **kw)
    transposed = kernels.admm_iterate_refined_reference(*skewed, **kw)
    follows, other = ((as_given, transposed) if given
                      else (transposed, as_given))
    side, other_side = (("as given", "transposed") if given
                        else ("transposed", "as given"))
    err = max_err(got[:2], follows[:2])
    apart = max_err(got[:2], other[:2])
    sides = max_err(as_given[:2], transposed[:2])
    print(f"  {label} {name}, skewed K ({SKEW:g} of max|K| above the "
          f"diagonal): x, z vs plain K {side} {err:.3e}; vs plain K "
          f"{other_side} {apart:.3e} (the two plain versions {sides:.3e} "
          "apart)", flush=True)
    check(all_finite(got) and err < REFINED_EQ_TOL,
          f"{label} kernel, {name}, applies K {side}: < {REFINED_EQ_TOL:g} "
          "of that plain version")
    check(apart > 10 * REFINED_EQ_TOL and apart > 10 * err,
          f"{label} kernel, {name}, on a skewed K is far (> 10 tolerances, "
          f"> 10 x its error) from K applied {other_side}")
    return err


FUSED_KW = dict(iters=40, adapt_rounds=3, equilibrate_iters=8, rho0=0.1,
                sigma=1e-6, alpha=1.6, rho_eq_scale=1e3, inf=1e20)


def compare_fused(name: str, args, path: str = "warp") -> float:
    """Kernel 4 against its plain version: the unscaled solution and the
    scales; returns the max abs error of the unscaled x.  The launch must
    take `path` ("warp" or "block"), and two launches must agree bit for bit.

    Two float32 runs of this solver differ by chaotic rounding noise whose
    largest value grows with the number of QPs looked at (measured: max |dx|
    5e-4 over 64 random QPs, 1.5e-3 over 4096).  So the kernel is held to
    the tolerance on all but 1 in 200 scenarios (on every one when B < 200),
    and, against a float64 run of the plain version, to being as accurate
    as the float32 plain version is (within a factor 2)."""
    B, n, m = shape_of(args, 2)
    lay = kernels.fused_layout(n, m, B,
                               *kernels.device_limits(args[0].device))
    check(lay.path == path,
          f"fused kernel, {name}: takes the {path} path ({lay})")
    return compare_whole("fused", kernels.admm_solve_fused,
                         kernels.admm_solve_fused_reference, name, args)


def compare_whole(label: str, kernel, reference, name: str, args,
                  spread: bool = False, chaotic: bool = False) -> float:
    """A whole-solve kernel (kernel 4 or A) against its plain version, as
    `compare_fused` says; returns the max abs error of the unscaled x.

    spread: the float64 gate compares the kernel's and the plain version's
    distances to float64 with the B // 200 largest of each left out, as
    the tolerance gate leaves out B // 200 scenarios (kernel A: measured on
    an H100 over 4096 random QPs, the largest distance of the kernel 2.65e-3
    against the plain version's 8.7e-4, the next ones alike; on 37 and 64
    QPs the kernel lay nearer); else the largest of each.

    chaotic: QPs on which no two float32 runs of the solver agree within the
    tolerances: the cascade's WBC QPs (the 1e6 swing-force ridge, the 1e3
    equality boost).  Measured on a CPU over 128 of them (phase 3f's
    inputs at B = 128): the plain float32 chain against itself with P and A
    perturbed by one rounding lies a median 0.18 (x; scale 270) and 8.1 (y;
    scale 117) away, and as far from a float64 run.  There the tolerances
    hold on the scenarios where the plain float32 version lies within them
    of float64 (all but 1 in 200 of those), and the kernel's median distance
    to float64 is held within twice the plain version's (plus a tenth of the
    tolerance), as phase 11's `hold_launches` does."""
    B, n, m = shape_of(args, 2)
    xs, ys, D, E, c = kernel(*args, **FUSED_KW)
    torch.cuda.synchronize()
    check_repeatable(f"{label} kernel, {name}",
                     lambda: kernel(*args, **FUSED_KW))

    def unscaled(xs_, ys_, D_, E_, c_):
        return D_ * xs_, E_ * ys_ / c_[:, None]

    x_k, y_k = unscaled(xs, ys, D, E, c)
    ref = reference(*args, **FUSED_KW)
    x_p, y_p = unscaled(*ref)
    x_64, y_64 = (t.float() for t in unscaled(
        *reference(*[a.double() for a in args], **FUSED_KW)))
    ex = (x_k - x_p).abs().amax(dim=1)
    ey = (y_k - y_p).abs().amax(dim=1)
    err_x, err_y = float(ex.max()), float(ey.max())
    if chaotic:
        held = (((x_p - x_64).abs().amax(dim=1) < FUSED_X_TOL)
                & ((y_p - y_64).abs().amax(dim=1) < FUSED_Y_TOL))
    else:
        held = torch.ones_like(ex, dtype=torch.bool)
    over = int((held & ((ex >= FUSED_X_TOL) | (ey >= FUSED_Y_TOL))).sum())
    n_held = int(held.sum())
    drop = B // 200 if spread else 0

    def far(a, b):
        d = (a - b).abs().amax(dim=1)
        if chaotic:
            return float(d.median())
        return float(torch.sort(d).values[len(d) - 1 - drop])

    k64 = (far(x_k, x_64), far(y_k, y_64))
    p64 = (far(x_p, x_64), far(y_p, y_64))
    err_s = max(float(((a - b).abs() / b.abs()).max())
                for a, b in ((D, ref[2]), (E, ref[3]), (c, ref[4])))
    which = ("median" if chaotic else
             f"all but the {drop} farthest" if drop else "max")
    print(f"  {label} {name}: B={B} n={n} m={m} iters=40/3 unscaled "
          f"max|dx|={err_x:.3e} max|dy|={err_y:.3e} (median "
          f"{float(ex.median()):.3e}, {float(ey.median()):.3e}; {over} of "
          f"{n_held} held scenarios over tolerance), scales rel {err_s:.3e}; "
          f"distance to a float64 run (x, y; {which}): kernel {k64[0]:.3e}, "
          f"{k64[1]:.3e}; plain {p64[0]:.3e}, {p64[1]:.3e}", flush=True)
    held_where = (" where the plain version is within them of float64"
                  if chaotic else "")
    check(all_finite((xs, ys, D, E, c)) and over <= n_held // 200
          and err_s < FUSED_SCALE_RTOL,
          f"{label} kernel vs plain, {name}: x < {FUSED_X_TOL:g}, y < "
          f"{FUSED_Y_TOL:g}{held_where} on all but {n_held // 200} "
          f"scenarios, scales < {FUSED_SCALE_RTOL:g} rel")
    slack = ((FUSED_X_TOL / 10, FUSED_Y_TOL / 10) if chaotic
             else (1e-4, 1e-4))
    check(k64[0] <= 2.0 * p64[0] + slack[0]
          and k64[1] <= 2.0 * p64[1] + slack[1],
          f"{label} kernel, {name}: as close to the float64 run as the plain "
          f"float32 version (factor 2, {which})")
    return err_x


def time_ms(fn, warmup: int, reps: int) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(floats: float, flops: float,
             flop_per_s: float = F32_FLOP_PER_S):
    """Least time the card could take: the bytes moved (every input read
    once, every output written once, 4 B each) against the memory rate, the
    operations against the peak rate of the unit that does them (the f32 FMA
    peak unless given); the larger of the two.  Returns
    (bound_ms, "bytes" | "operations", bytes_ms, flops_ms, flop_per_s)."""
    bytes_ms = 4.0 * floats / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / flop_per_s * 1e3
    return (max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations",
            bytes_ms, flops_ms, flop_per_s)


def m2_bound_ms(B: int, n: int, m: int, iters: int):
    """M2, A, q, x, l, u, rho, z, y in, x, z, y out; iters * (4 m n + 2 n^2)
    flops per scenario."""
    floats = B * (n * n + m * n + 2 * n + 5 * m + n + 2 * m)
    return bound_ms(floats, B * iters * (4.0 * m * n + 2.0 * n * n))


def refined_bound_ms(B: int, n: int, m: int, iters: int,
                     flop_per_s: float = F32_FLOP_PER_S):
    """K^-1, K, A, q, x, l, u, rho, z, y in, x, z, y out; iters *
    (4 m n + 6 n^2) flops per scenario (two products with A, three n x n),
    against the f32 FMA peak for kernels 2 and 3 and against the split-TF32
    tensor-core peak for kernel 5."""
    floats = B * (2 * n * n + m * n + 2 * n + 5 * m + n + 2 * m)
    return bound_ms(floats, B * iters * (4.0 * m * n + 6.0 * n * n),
                    flop_per_s)


def fused_bound_ms(B: int, n: int, m: int, iters: int, adapt_rounds: int,
                   equilibrate_iters: int):
    """P, A, q, x0, l, u, eqf, y0 in, x, D, y, E, c out.  Operations per
    scenario: each Ruiz round two abs-max passes and one rescale of P and A
    and the cost scale (6 n^2 + 4 m n); each adapt round K (2 m n^2 + m n),
    the Cholesky and the triangular inverse (n^3 / 3 each), X0 (2 n^3 / 3),
    the Newton-Schulz step and its two residual products (3 x 2 n^3); the
    iterations ((4 m n + 6 n^2) each); between rounds the residual ratios
    (4 m n + 2 n^2)."""
    rounds = max(1, adapt_rounds)
    iters_per = max(1, iters // rounds)
    floats = B * (n * n + m * n + 2 * n + 4 * m + 2 * n + 2 * m + 1)
    n3 = float(n) ** 3
    flops = B * (
        equilibrate_iters * (6.0 * n * n + 4.0 * m * n)
        + rounds * (2.0 * m * n * n + m * n + 2.0 * n3 / 3.0
                    + 2.0 * n3 / 3.0 + 6.0 * n3)
        + rounds * iters_per * (4.0 * m * n + 6.0 * n * n)
        + (rounds - 1) * (4.0 * m * n + 2.0 * n * n))
    return bound_ms(floats, flops)


def report_times(label, shape, kernel_ms, plain_ms, bound, smi) -> None:
    b_ms, by, bytes_ms, flops_ms, flop_per_s = bound
    unit = ("f32" if flop_per_s == F32_FLOP_PER_S
            else "f32-equivalent in split TF32 on the tensor cores")
    print(f"  {label} {shape}: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms by {by} (bytes "
          f"{bytes_ms:.4f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s, flops "
          f"{flops_ms:.4f} ms at {flop_per_s / 1e12:.0f} TFLOP/s {unit})  "
          f"[{smi}]", flush=True)


# ------------------------------- 3f. the default WBC solve and K^-1 as kernels

def spd_bound_ms(B: int, n: int):
    """K in, K^-1 out; per matrix the Cholesky and the triangular inverse
    (n^3 / 3 flops each), X0 = L^-T L^-1 (2 n^3 / 3) and the three products
    of the Newton-Schulz step and its guard (2 n^3 each)."""
    n3 = float(n) ** 3
    return bound_ms(2.0 * B * n * n,
                    B * (n3 / 3.0 + n3 / 3.0 + 2.0 * n3 / 3.0 + 6.0 * n3))


def cascade_qps(device):
    """The QPs the stages build at full width: config4_cascade_4k (B =
    4096, commands varied per scenario), two periods from standing, then a
    mid-gait trot WBC tick (two feet in swing) with its warm start as
    kernel A's arguments, and the MPC QP of the period after it."""
    cfg = PRESETS["config4_cascade_4k"]
    cc, ctl, plant, gid, v, cp = make_scenarios(cfg, cfg.batch, seed=12,
                                                device=device)
    v = varied_commands(cfg.batch, seed=12)
    ctl, plant, _ = cascade_rollout(cc, ctl, plant, gid, v, cp, n_periods=2,
                                    device=device)
    (tree, wcfg, q_t, v_t, refs, wkw), ctl, plant = capture_wbc_tick(
        cc, ctl, plant, gid, v, cp, tick=10, device=device)
    H, g, A, l, u = tsid_mod.build_wbc_qp(
        tree, wcfg, q_t, v_t, refs,
        extra_base_inertia=wkw.get("extra_base_inertia"))[:5]
    wbc = [t.contiguous() for t in (H, g, A, l, u, ((u - l) < 1e-9).float(),
                                     wkw["warm_x"], wkw["warm_y"])]
    (x0, x_ref, feet, cont), _, _ = capture_mpc_inputs(cc, ctl, plant, gid,
                                                       v, cp, device)
    return wbc, build_mpc_qp(SOLO12, cfg.mpc, x0, x_ref, feet, cont)


def solve_kernels_phase(smi: str, device, reports: dict) -> None:
    """3f: kernel A (the plain backend's WBC solve in one launch) against
    the plain chain, kernel B (K^-1) against blockinv.spd_inverse_chol, both
    on the card; paths, bit for bit repeats, fallbacks, times."""
    # ---- kernel A
    errs = [compare_whole("plain-warp", kernels.admm_solve_plain_warp,
                          kernels.admm_solve_plain_reference, name,
                          fused_inputs(seed, B, n, 50, device), spread=True)
            for name, seed, B, n in (("single", 70, 1, 30),
                                     ("odd batch", 71, 37, 30),
                                     ("wbc shape", 72, 64, 30),
                                     ("n = 32, the warp path's edge", 73, 64,
                                      32))]
    refused = False
    try:
        kernels.admm_solve_plain_warp(*fused_inputs(74, 8, 33, 55, device),
                                      **FUSED_KW)
    except ValueError as e:
        refused = "warp path" in str(e)
    check(refused, "plain-warp kernel refuses n = 33 (it has no block path; "
                   "nothing falls back)")
    wbc, mpc_qp = cascade_qps(device)
    Bt = wbc[0].shape[0]
    # (their chaotic differences are reported apart from max_abs_err)
    cascade_err = max(compare_whole(
        "plain-warp", kernels.admm_solve_plain_warp,
        kernels.admm_solve_plain_reference,
        f"cascade WBC QPs, mid-gait trot, B={B}", [t[:B] for t in wbc],
        chaotic=True) for B in (1, 37, Bt))
    big = fused_inputs(75, Bt, 30, 50, device)
    errs.append(compare_whole("plain-warp", kernels.admm_solve_plain_warp,
                              kernels.admm_solve_plain_reference,
                              "main path shape", big, spread=True))
    times = {}
    for B in (1, Bt):
        args = [t[:B] for t in wbc]
        times[B] = (
            time_ms(lambda: kernels.admm_solve_plain_warp(*args, **FUSED_KW),
                    3, 20),
            time_ms(lambda: kernels.admm_solve_plain_reference(
                *args, **FUSED_KW), 1, 3),
            fused_bound_ms(B, 30, 50, FUSED_KW["iters"],
                           FUSED_KW["adapt_rounds"],
                           FUSED_KW["equilibrate_iters"]))
        report_times("plain-warp (kernel A)",
                     f"B={B} n=30 m=50 iters=40/3, cascade QPs", *times[B],
                     smi)
    del big
    reports["admm_solve_plain_warp"] = dict(
        source="mpctsid_tpu_torch/qp/csrc/admm_fused.cu",
        replaces="mpctsid_tpu/qp/admm.py:209", max_abs_err=max(errs),
        max_abs_err_cascade_qps=cascade_err,
        ms=times[Bt][0], plain_ms=times[Bt][1], bound_ms=times[Bt][2][0],
        bound_by=times[Bt][2][1], ms_b1=times[1][0], plain_ms_b1=times[1][1],
        bound_ms_b1=times[1][2][0], bound_by_b1=times[1][2][1],
        library_ms=None)

    # ---- kernel B
    smem, n_sm = kernels.device_limits(device)
    abs_err, rel_err = 0.0, 0.0
    for n, m, path, in_smem in ((30, 50, "warp", False),
                                (192, 320, "block", True)):
        for B in (1, 37, Bt):
            if n == 192 and B == Bt:
                # 64 matrices tiled to B = 4096 (each its own memory), as 3a
                K = iteration_inputs(80, 64, n, m, device, eq=True)[1][1]
                K = K.repeat(Bt // 64, 1, 1).contiguous()
            else:
                K = iteration_inputs(80 + B, B, n, m, device, eq=True)[1][1]
            lay = kernels.spd_inverse_layout(n, B, smem, n_sm)
            check(lay.path == path and lay.in_smem == in_smem,
                  f"chol_inverse B={B} n={n}: takes the {path} path ({lay})")
            X = kernels.chol_inverse(K)
            check_repeatable(f"chol_inverse B={B} n={n}",
                             lambda: [kernels.chol_inverse(K)])
            rel_err = max(rel_err, hold_inverses(
                [(K, X)], f"chol_inverse, random K, B={B} n={n}", smi))
            abs_err = max(abs_err, float(
                (X - spd_inverse_chol(K, ns_steps=1)).abs().max()))
    for n, m, in_smem in ((33, 55, True), (240, 400, False)):
        K = iteration_inputs(90 + n, 3, n, m, device, eq=True)[1][1]
        lay = kernels.spd_inverse_layout(n, 3, smem, n_sm)
        check(lay.path == "block" and lay.in_smem == in_smem,
              f"chol_inverse n={n}: block path, matrix in "
              f"{'shared' if in_smem else 'device'} memory ({lay})")
        rel_err = max(rel_err, hold_inverses(
            [(K, kernels.chol_inverse(K))],
            f"chol_inverse, random K, n={n}", smi))
    # the block path's panel edges: n one short of and one past a multiple
    # of 32 (the identity pad fills the last panel), each launch's layout as
    # spd_inverse_layout states it: panels of 32, 4 x 4 tiles, 64 threads a
    # tile (128 / 256 / 512 a block), the working matrix in shared memory up
    # to n = 192
    for n in (63, 65, 191, 193):
        np_ = -(-n // 32) * 32
        threads = 128 if np_ <= 64 else 256 if np_ <= 96 else 512
        for B in (1, 37):
            K = iteration_inputs(300 + n + B, B, n, n + 20, device,
                                 eq=True)[1][1]
            lay = kernels.spd_inverse_layout(n, B, smem, n_sm)
            check(lay == kernels.SpdLayout(
                "block", 0, threads, np_ <= 192,
                kernels.spd_block_floats(n, np_ <= 192), 32, 4, np_ + 4),
                  f"chol_inverse B={B} n={n}: panels of 32 over np = {np_}, "
                  f"4 x 4 tiles, {threads} threads, the working matrix in "
                  f"{'shared' if np_ <= 192 else 'device'} memory ({lay})")
            X = kernels.chol_inverse(K)
            check_repeatable(f"chol_inverse B={B} n={n}",
                             lambda: [kernels.chol_inverse(K)])
            rel_err = max(rel_err, hold_inverses(
                [(K, X)], f"chol_inverse, random K, panel edge B={B} n={n}",
                smi))
    # the K the stages build: every inverse of a vpu solve of the cascade
    # WBC QPs and of a kernel 1 solve of the cascade MPC QPs
    log: list = []
    with recorded_launches(log):
        admm_solve(*wbc[:5], x0=wbc[6], y0=wbc[7], iters=40, adapt_rounds=3,
                   rho=0.1, backend="vpu")
        admm_solve(*mpc_qp, backend="m2", **INLOOP_MPC)
    for n in (30, 192):
        pairs = [(a[0], g[0]) for name, a, _, g in log
                 if name == "chol_inverse" and a[0].shape[-1] == n]
        rel_err = max(rel_err, hold_inverses(
            pairs, f"chol_inverse, the K of the cascade's "
                   f"{'WBC' if n == 30 else 'MPC'} solves, n={n}", smi))
    del log
    # per-matrix fallbacks: a NaN pair (both triangles) takes the identity
    # (s I s), an indefinite 2 x 2 block the unpolished X0; the other
    # matrices of the batch as in a clean batch, bit for bit
    for n, m in ((30, 50), (192, 320)):
        K = iteration_inputs(95, 6, n, m, device, eq=True)[1][1]
        bad = K.clone()
        bad[1, 3, 5] = bad[1, 5, 3] = float("nan")
        bad[2, :2, :2] = torch.tensor([[1.0, 2.0], [2.0, 1.0]],
                                      device=device) * bad[2, 0, 0]
        got, clean = kernels.chol_inverse(bad), kernels.chol_inverse(K)
        want = spd_inverse_chol(bad, ns_steps=1)
        rest = [0, 3, 4, 5]
        diag_k, diag_p = got[1].diagonal(), want[1].diagonal()
        off = ~torch.eye(n, dtype=torch.bool, device=device)
        nan_ok = (bool((got[1][off] == 0).all() and (want[1][off] == 0).all())
                  and float(((diag_k - diag_p).abs() / diag_p).max()) < 1e-5)
        spd_rel = float((got[2] - want[2]).abs().max() / want[2].abs().max())
        print(f"  chol_inverse fallbacks n={n}: NaN matrix diagonal (s I s) "
              f"in both {nan_ok}; indefinite matrix max |X - X_plain| / max "
              f"|X_plain| {spd_rel:.3e}", flush=True)
        check(nan_ok and spd_rel < 1e-3 and all_finite((got[2], want[2]))
              and torch.equal(got[rest], clean[rest]),
              f"chol_inverse n={n}: the NaN and the indefinite matrix take "
              "the plain version's fallbacks (identity; unpolished X0), the "
              "rest of the batch bit for bit as without them")
    timed_out = {}
    for n, m in ((30, 50), (192, 320)):
        K64 = iteration_inputs(99, 64, n, m, device, eq=True)[1][1]
        for B in (1, Bt):
            K = K64[:1] if B == 1 else K64.repeat(Bt // 64, 1, 1).contiguous()
            timed_out[n, B] = (
                time_ms(lambda: kernels.chol_inverse(K), 3, 20),
                time_ms(lambda: spd_inverse_chol(K, ns_steps=1), 1, 3),
                spd_bound_ms(B, n),
                time_ms(lambda: torch.linalg.inv_ex(K), 3, 20))
            ms, plain, bound, lib = timed_out[n, B]
            report_times("chol_inverse (kernel B)", f"B={B} n={n}", ms,
                         plain, bound, smi)
            print(f"    torch.linalg.inv_ex on the same K: {lib:.4f} ms",
                  flush=True)
    (ms, plain, bound, lib), (ms1, plain1, bound1, lib1) = (
        timed_out[192, Bt], timed_out[192, 1])
    w, w1 = timed_out[30, Bt], timed_out[30, 1]
    # the default path runs it at the MPC shape (n = 192): the row's numbers;
    # the WBC shape's (backends vpu, packed, mma) under *_wbc_shape
    reports["chol_inverse"] = dict(
        source="mpctsid_tpu_torch/qp/csrc/spd_inverse.cu",
        replaces="mpctsid_tpu/qp/blockinv.py:203", max_abs_err=abs_err,
        max_rel_err=rel_err, ms=ms, plain_ms=plain, bound_ms=bound[0],
        bound_by=bound[1], library_ms=lib, ms_b1=ms1, plain_ms_b1=plain1,
        bound_ms_b1=bound1[0], bound_by_b1=bound1[1], library_ms_b1=lib1,
        ms_wbc_shape=w[0], plain_ms_wbc_shape=w[1],
        bound_ms_wbc_shape=w[2][0], library_ms_wbc_shape=w[3],
        ms_b1_wbc_shape=w1[0], library_ms_b1_wbc_shape=w1[3])


# ------------------------------------------ 3e. the rigid-body stage kernels

# The WBC build and the plant step against their plain versions
# (tests/test_torch_rbd_kernels.py holds the same arithmetic on the CPU):
# float32 within 1e-4 of the plain result relative to the largest entry of
# each output (of each diagonal block for H, whose 1e6 ridge would set the
# scale), float64 within 1e-10 (the warp-per-scenario kernels, measured on
# the CPU: 1.3e-7 / 1.2e-6 and 1.1e-16 / 1.6e-15; on an H100: 7.8e-7 /
# 2.6e-6 and 8.1e-16 / 4.6e-15).
# The infinite bounds (INF) where the plain version puts them.
RBD_REL = {torch.float32: 1e-4, torch.float64: 1e-10}
# the last two: a last block partly filled (rbd.h's MAX_WARPS = 8 warps a
# block) and the cascade's batch
RBD_B = (1, 37, 4094, 4096)
RBD_GAITS = ("trot", "walk", "bound", "pace")
# plant states are drawn at least this far (m, N) from a switching surface
# of the contact law at either substep, where one rounding flips a branch
RBD_MARGIN = 1e-5
# the plant's four kinds of scenario, in the order a batch interleaves them
PLANT_KINDS = ("sliding", "sticking", "pulled off", "above")
WBC_NAMES = ("H", "g", "A", "l", "u", "M", "h", "JcT")


def rbd_ops() -> tuple[int, int, int]:
    """Operations per scenario that each function NEEDS, for its bound:
    (WBC build, plant substep, the re-solve of a clamping substep).  Multiply
    and add are counted apart; a division, square root, sine or cosine as
    one.  Counted from the model's structure, not from rbd.h's loops, which
    do about 2.5x more (31 k a build, 30 k a substep): each joint turns
    about a coordinate axis (that rotation of a 3-vector is 6 operations, a
    dense one 15), a motion transform [[E, 0], [F, E]] has a zero block and
    its congruence is formed on one triangle, a foot's Jacobian row has 9
    non-zero columns (the base's 6, its own leg's 3), the legs' blocks of M
    are decoupled (its SPD solves factor the legs first: 873 operations
    where a dense 18 x 18 Cholesky takes 1,944), a row scale (contact
    damping, task weights) is applied once, and a symmetric product is
    formed on one triangle at 2 operations a term.  The 6 x 6 inertias are
    data and counted dense; the anchor drag of a sliding foot (6) is left
    out.  The payload addend (21 a crba, 36 a rnea) is not counted: the
    timed runs carry none."""
    rot, mv3, cross, mv6, sym6 = 6, 15, 9, 66, 21
    quat_to_rot = 35
    # leg kinematics: per level a sine and cosine, the placement rotated
    # and added, the world rotation times an axis rotation (two columns)
    kin = quat_to_rot + 4 * (3 * (2 + mv3 + 3 + 18) + mv3 + 3)
    wrench = 2 * mv6 + 3 * cross + 9
    # rnea at qdd = 0: forward (w, v, wdot, vdot) per level, backward (the
    # body's wrench, its child's, the force carried to the parent)
    fwd = (rot + 1) + (cross + 3 + rot) + (rot + 2 + 2) + (cross + 3 + rot
                                                          + 2 + 2)
    bwd = wrench + 2 * rot + cross + 3
    rnea = 3 + wrench + 6 + 4 * (3 * fwd + 3 * bwd + 2 * 6 + 6)
    # crba: per leg three congruences (F = E S' 27, X' I 180, the lower
    # triangle of (X' I) X 132, the parent's inertia added), the base's sum,
    # six joint forces carried to a parent (2 rotations, a cross, an add)
    congruence = 27 + 180 + 132
    crba = 4 * (3 * congruence + 2 * sym6 + sym6
                + 6 * (2 * rot + cross + 3)) + sym6
    jac = 4 * (3 + mv3 + 27 + 3 * (3 + cross))
    shared = kin + rnea + crba + jac
    jv = 12 * (9 + 8)                    # J v over the 9 non-zero columns
    jtf = 2 * 12 * 9                     # J' f
    jtdj = 12 + 12 * 9 + 2 * (12 * 21 + 4 * 3 * 18 + 4 * 3 * 6)
    # the WBC build: drifts (per level r, three crosses, the joint's
    # velocity and its cross, three updates; the foot), J v, rpy, the task
    # accelerations, H = J' W J, g = -J' W b, the diagonal tasks, the rows
    drifts = 3 * mv3 + cross + 4 * (3 * (3 + 3 * cross + 3 + cross + 12)
                                    + 3 + 3 * cross + 6)
    wbc = (shared + drifts + jv + 3 + (12 * 7 + 4 * 2) + jtdj
           + (12 + jtf) + (24 + 84 + 21 + 30 + 20) + (24 + 108 + 24))
    # the plant substep: elastic forces, M v over M's 216 non-zeros, J' D J,
    # M + h J' D J on M's 117 lower non-zeros, the right-hand side, the
    # factor and both triangular solves, the forces at v_imp and the cone,
    # the integration
    chol = 4 * (15 + 54 + 126) + 93
    solve = 2 * 216
    rhs = 18 + jtf + 3 * 18
    integrate = quat_to_rot + mv3 + 6 + 3 + 5 + 2 + 1 + 2 + 1 + 3 + 28 + 8 \
        + 4 + 24
    substep = (shared + 20 + (216 + 198) + jtdj + 2 * 117 + rhs + chol
               + solve + jv + 36 + 4 * 9 + integrate)
    resolve = (rhs - 18) + chol + solve
    return wbc, substep, resolve


WBC_OPS, PLANT_SUBSTEP_OPS, PLANT_RESOLVE_OPS = rbd_ops()
# floats per scenario: the build reads q, v and the eight references (104)
# and the payload (36), and writes H, g, A, l, u, M, h, J (3,088); the plant
# reads q, v, anchor, in_contact, tau, five contact parameters (66) and the
# payload, and writes q, v, anchor, in_contact, f (61)
WBC_IN, WBC_OUT, PLANT_IN, PLANT_OUT, PAYLOAD = 104, 3088, 66, 61, 36


def random_states(r, n: int, spread: float):
    """q (n, 19) near standing with unit quaternions, v (n, 18)."""
    q = np.zeros((n, 19))
    q[:, 0:2] = r.normal(size=(n, 2)) * 0.2
    q[:, 2] = SOLO12.h_ref + r.normal(size=n) * 0.01
    quat = np.concatenate([r.normal(size=(n, 3)) * 0.08, np.ones((n, 1))], 1)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] = SOLO12.q_stand + r.normal(size=(n, 12)) * spread * 0.5
    return q, r.normal(size=(n, 18)) * spread


def wbc_build_inputs(B: int, seed: int):
    """(q, v, refs, payload) as float32 numpy: the four gaits' contact mixes
    at random phases, states near standing, swing references near the feet,
    an MPC plan on the stance feet (the CPU test's draw)."""
    r = np.random.default_rng(seed)
    q, v = random_states(r, B, 0.3)
    contacts = np.stack([GAITS[RBD_GAITS[i % 4]].contacts_at(
        int(r.integers(0, 16))) for i in range(B)])
    tree = CascadeConfigured(SOLO12, EngineConfig()).tree
    feet = foot_positions(tree, torch.tensor(q, dtype=torch.float64)).numpy()
    refs = dict(
        contacts=contacts,
        f_mpc=np.concatenate([r.normal(size=(B, 4, 2)),
                              r.uniform(2.0, 12.0, size=(B, 4, 1))], -1)
        * contacts[..., None],
        foot_pos_ref=feet + r.normal(size=(B, 4, 3)) * 0.01,
        foot_vel_ref=r.normal(size=(B, 4, 3)) * 0.2,
        foot_acc_ref=r.normal(size=(B, 4, 3)) * 2.0,
        q_posture=np.tile(SOLO12.q_stand, (B, 1)),
        base_rpy_ref=r.normal(size=(B, 2)) * 0.02,
        h_ref=np.full(B, SOLO12.h_ref))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (f32(q), f32(v), {k: f32(a) for k, a in refs.items()},
            f32(r.uniform(0.0, 0.4, size=B)))


def plant_step_inputs(B: int, seed: int, device):
    """(state, params, tau, payload) as float32 numpy: the CPU test's four
    kinds of scenario interleaved (PLANT_KINDS), each drawn at least
    RBD_MARGIN from the contact law's switching surfaces at both substeps,
    with the payload and without (checked in float64 on the card); and the
    number of (scenario, substep) pairs that clamp a foot, per payload."""
    tree = CascadeConfigured(SOLO12, EngineConfig()).tree
    r = np.random.default_rng(seed)
    per_kind = -(-B // len(PLANT_KINDS))
    picked = []
    for kind in PLANT_KINDS:
        rows = []
        while len(rows) < per_kind:
            n = per_kind + 64
            q, v = random_states(r, n, 0.2)
            if kind == "above":
                q[:, 2] += 0.03
            else:
                q[:, 2] -= r.uniform(0.002, 0.005, size=n)
                v[:, 0:6] *= 0.1
            if kind == "sliding":
                v[:, 0:2] = r.normal(size=(n, 2)) * 1.5
            if kind == "pulled off":
                v[:, 2] = r.uniform(1.5, 2.5, size=n)
            feet = foot_positions(
                tree, torch.tensor(q, dtype=torch.float64)).numpy()
            cand = dict(
                q=q, v=v,
                anchor=feet[..., 0:2] + r.normal(size=(n, 4, 2)) * 0.002,
                in_contact=r.integers(0, 2, size=(n, 4)),
                kp_n=np.full(n, 8000.0), kd_n=np.full(n, 100.0),
                kp_t=np.full(n, 2000.0), kd_t=np.full(n, 30.0),
                mu=r.uniform(0.3, 1.0, size=n),
                tau=r.normal(size=(n, 12)) * 0.5,
                payload=r.uniform(0.0, 0.4, size=n))
            cand = {k: np.asarray(a, np.float32) for k, a in cand.items()}
            ok = np.ones(n, bool)
            for margin in plant_margins(tree, cand, device)[0]:
                ok &= margin > RBD_MARGIN
            rows += [{k: a[i] for k, a in cand.items()}
                     for i in np.flatnonzero(ok)]
        picked.append(rows[:per_kind])
    order = [picked[i % len(PLANT_KINDS)][i // len(PLANT_KINDS)]
             for i in range(B)]
    out = {k: np.stack([row[k] for row in order]) for k in order[0]}
    return out, [int(c) for c in plant_margins(tree, out, device)[1]]


def plant_margins(tree, d, device):
    """([least margin over both substeps, without and with the payload],
    [clamping (scenario, substep) pairs, without and with it]), float64 on
    the card."""
    t64 = lambda a: torch.tensor(a, dtype=torch.float64,  # noqa: E731
                                 device=device)
    margins, clamps = [], []
    for extra in (None, point_mass_spatial(t64(d["payload"]))):
        st = PlantState(q=t64(d["q"]), v=t64(d["v"]), anchor=t64(d["anchor"]),
                        in_contact=t64(d["in_contact"]))
        cp = ContactParams(**{k: t64(d[k]) for k in
                              ("kp_n", "kd_n", "kp_t", "kd_t", "mu")})
        least, n_cl = None, 0
        for _ in range(2):
            m, cl = contact_margins(tree, st, t64(d["tau"]), 5e-4, cp,
                                    extra)
            least = m if least is None else torch.minimum(least, m)
            n_cl += int(cl.sum())
            st, _ = plant_step_reference(tree, st, t64(d["tau"]), 5e-4, 1,
                                         cp, extra)
        margins.append(least.cpu().numpy())
        clamps.append(n_cl)
    return margins, clamps


def rbd_rel_err(got, want) -> tuple[float, float]:
    """(largest |got - want| relative to the largest |want|, largest
    |got - want|) over the finite entries; (inf, inf) unless the infinite
    bounds are where the plain version puts them."""
    inf_w = want.abs() >= 1e19
    if not (torch.equal(inf_w, got.abs() >= 1e19)
            and torch.equal(got[inf_w], want[inf_w])):
        return float("inf"), float("inf")
    d = (got - want)[~inf_w].abs().max()
    scale = want[~inf_w].abs().max().clamp_min(1e-30)
    return float(d / scale), float(d)


def rbd_layout_ok(name: str, B: int, dtype, device) -> bool:
    """The layout the last launch of kernel `name` took is
    dyn/kernels.py::rbd_layout's on the card's limits (and covers B)."""
    want = rbd_kernels.rbd_layout(name, B, dtype,
                                  *kernels.device_limits(device))
    got = rbd_kernels.last_layout(name)
    return got == want and got.warps * got.blocks >= B


def graph_ms(fn, reps: int = 50) -> float:
    """ms of one replay of a CUDA graph that holds fn()'s launches: their
    device time without the host's packing (the eager warm-up runs on a
    side stream first)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, 3, reps)


def compare_wbc_build(tree, cfg, inputs, dtype, device) -> tuple:
    """The build kernel against build_wbc_qp_reference on the card, payload
    off and on, exact_pin off and on; two launches bit for bit.  Returns
    the largest (relative, absolute) error."""
    q, v, refs, payload = inputs
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    q, v, payload = t(q), t(v), t(payload)
    refs = WbcRefs(**{k: t(a) for k, a in refs.items()})
    worst = (0.0, 0.0)
    for extra in (None, point_mass_spatial(payload)):
        for pin in (False, True):
            got = tsid_mod.wbc_build(tree, cfg, q, v, refs, extra, pin)
            laid = rbd_layout_ok("wbc_build", q.shape[0], dtype, device)
            again = tsid_mod.wbc_build(tree, cfg, q, v, refs, extra, pin)
            want = tsid_mod.build_wbc_qp_reference(tree, cfg, q, v, refs,
                                                   extra, pin)
            pairs = list(zip(got, want)) + [
                (got[0][:, :18, :18], want[0][:, :18, :18]),
                (got[0][:, 18:, 18:], want[0][:, 18:, 18:])]
            errs = [rbd_rel_err(g, w) for g, w in pairs]
            rel, ab = max(e[0] for e in errs), max(e[1] for e in errs)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            layout = all(g.shape == w.shape and g.stride() == w.stride()
                         for g, w in zip(got, want))
            check(rel <= RBD_REL[dtype] and same and layout and laid,
                  f"3e: wbc_build, B={q.shape[0]}, {str(dtype)[6:]}, payload "
                  f"{extra is not None}, exact_pin {pin}: within "
                  f"{RBD_REL[dtype]:g} of the plain version (relative), "
                  "shapes and strides its own, the launch laid out as "
                  f"rbd_layout says ({rbd_kernels.last_layout('wbc_build')}),"
                  " two launches bit for bit")
            worst = (max(worst[0], rel), max(worst[1], ab))
    return worst


def compare_plant_step(tree, inputs, dtype, device) -> tuple:
    """The plant kernel against plant_step_reference on the card, payload
    off and on; two launches bit for bit; returns the largest (relative,
    absolute) error."""
    d = inputs
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    st = PlantState(q=t(d["q"]), v=t(d["v"]), anchor=t(d["anchor"]),
                    in_contact=t(d["in_contact"]))
    cp = ContactParams(**{k: t(d[k]) for k in
                          ("kp_n", "kd_n", "kp_t", "kd_t", "mu")})
    worst = (0.0, 0.0)
    for extra in (None, point_mass_spatial(t(d["payload"]))):
        got = plant_step(tree, st, t(d["tau"]), params=cp,
                         extra_base_inertia=extra)
        laid = rbd_layout_ok("plant_step", st.q.shape[0], dtype, device)
        again = plant_step(tree, st, t(d["tau"]), params=cp,
                           extra_base_inertia=extra)
        want = plant_step_reference(tree, st, t(d["tau"]), 0.001, 2, cp,
                                    extra)
        fields = ("q", "v", "anchor", "in_contact")
        flat = lambda o: [getattr(o[0], k) for k in fields] + [o[1]]  # noqa
        errs = [rbd_rel_err(g, w) for g, w in zip(flat(got), flat(want))]
        rel, ab = max(e[0] for e in errs), max(e[1] for e in errs)
        same = all(torch.equal(a, b) for a, b in zip(flat(got), flat(again)))
        check(rel <= RBD_REL[dtype] and same and laid and torch.equal(
            got[0].in_contact, want[0].in_contact),
              f"3e: plant_step, B={st.q.shape[0]}, {str(dtype)[6:]}, "
              f"payload {extra is not None}: within {RBD_REL[dtype]:g} of "
              "the plain version (relative), contacts equal, the launch "
              "laid out as rbd_layout says "
              f"({rbd_kernels.last_layout('plant_step')}), two launches bit "
              "for bit")
        worst = (max(worst[0], rel), max(worst[1], ab))
    return worst


def rbd_kernels_phase(smi: str, device, reports: dict) -> None:
    """3e: the WBC-build and plant-step kernels against their plain
    versions at B = 1, 37, 4094 and 4096, float32 and float64, each
    launch's layout; their times at B = 1 and 4096 (float32, no payload:
    the main path's): a one-launch CUDA graph's replay (`ms`, the kernel's
    device time) and the eager wrapper (`ms_eager`, its packing on the host
    included), the plain chains' and the bounds."""
    cfg = EngineConfig()
    tree = CascadeConfigured(SOLO12, cfg).tree
    Bmax = max(RBD_B)
    wbc_in = wbc_build_inputs(Bmax, 60)
    plant_in, clamps = plant_step_inputs(Bmax, 61, device)
    print(f"  plant states: {PLANT_KINDS} interleaved, each at least "
          f"{RBD_MARGIN:g} from a switching surface; (scenario, substep) "
          f"pairs that clamp a foot at B={Bmax}: {clamps[0]} (payload "
          f"{clamps[1]})", flush=True)
    errs = {"wbc_build": {}, "plant_step": {}}
    for B in RBD_B:
        w_in = (wbc_in[0][:B], wbc_in[1][:B],
                {k: a[:B] for k, a in wbc_in[2].items()}, wbc_in[3][:B])
        p_in = {k: a[:B] for k, a in plant_in.items()}
        for dtype in (torch.float32, torch.float64):
            e_w = compare_wbc_build(tree, cfg.wbc, w_in, dtype, device)
            e_p = compare_plant_step(tree, p_in, dtype, device)
            errs["wbc_build"][(B, dtype)] = e_w
            errs["plant_step"][(B, dtype)] = e_p
            print(f"  B={B} {str(dtype)[6:]}: wbc_build max rel "
                  f"{e_w[0]:.3e} (abs {e_w[1]:.3e}), plant_step max rel "
                  f"{e_p[0]:.3e} (abs {e_p[1]:.3e})", flush=True)
    t = lambda a: torch.tensor(a, device=device)  # noqa: E731
    timed_out = {}
    for B in (1, Bmax):
        q, v = t(wbc_in[0][:B]), t(wbc_in[1][:B])
        refs = WbcRefs(**{k: t(a[:B]) for k, a in wbc_in[2].items()})
        st = PlantState(q=t(plant_in["q"][:B]), v=t(plant_in["v"][:B]),
                        anchor=t(plant_in["anchor"][:B]),
                        in_contact=t(plant_in["in_contact"][:B]))
        cp = ContactParams(**{k: t(plant_in[k][:B]) for k in
                              ("kp_n", "kd_n", "kp_t", "kd_t", "mu")})
        tau = t(plant_in["tau"][:B])
        w_call = lambda: tsid_mod.wbc_build(  # noqa: E731
            tree, cfg.wbc, q, v, refs)
        p_call = lambda: plant_step(tree, st, tau, params=cp)  # noqa: E731
        w_ms, w_eager = graph_ms(w_call), time_ms(w_call, 3, 50)
        p_ms, p_eager = graph_ms(p_call), time_ms(p_call, 3, 50)
        w_plain = time_ms(lambda: tsid_mod.build_wbc_qp_reference(
            tree, cfg.wbc, q, v, refs), 1, 3)
        p_plain = time_ms(lambda: plant_step_reference(
            tree, st, tau, 0.001, 2, cp), 1, 3)
        n_cl = clamps[0] if B == Bmax else plant_margins(
            tree, {k: a[:B] for k, a in plant_in.items()}, device)[1][0]
        w_bound = bound_ms(B * (WBC_IN + WBC_OUT), B * WBC_OPS)
        p_bound = bound_ms(
            B * (PLANT_IN + PLANT_OUT),
            2 * B * PLANT_SUBSTEP_OPS + n_cl * PLANT_RESOLVE_OPS)
        report_times("wbc_build", f"B={B} float32 (graph replay; eager "
                     f"wrapper {w_eager:.4f} ms)", w_ms, w_plain, w_bound,
                     smi)
        report_times("plant_step", f"B={B} float32, 2 substeps (graph "
                     f"replay; eager wrapper {p_eager:.4f} ms)", p_ms,
                     p_plain, p_bound, smi)
        timed_out[B] = ((w_ms, w_plain, w_bound, w_eager),
                        (p_ms, p_plain, p_bound, p_eager))
    for i, (name, src, replaces) in enumerate((
            ("wbc_build", "wbc_build.cu", "mpctsid_tpu/wbc/tsid.py:69"),
            ("plant_step", "plant_step.cu", "mpctsid_tpu/env/plant.py:131"))):
        (ms, plain, bound, eager), (ms1, plain1, bound1, eager1) = (
            timed_out[Bmax][i], timed_out[1][i])
        f32 = [e for (B, dt), e in errs[name].items() if dt == torch.float32]
        f64 = [e for (B, dt), e in errs[name].items() if dt == torch.float64]
        reports[name] = dict(
            source=f"mpctsid_tpu_torch/dyn/csrc/{src}", replaces=replaces,
            max_abs_err=max(e[1] for e in f32),
            max_rel_err=max(e[0] for e in f32),
            max_rel_err_f64=max(e[0] for e in f64),
            ms=ms, plain_ms=plain, bound_ms=bound[0], bound_by=bound[1],
            ms_eager=eager, ms_b1=ms1, plain_ms_b1=plain1,
            bound_ms_b1=bound1[0], bound_by_b1=bound1[1], ms_eager_b1=eager1)


# ------------------------------- 3g. the planner and Ruiz as kernels

# The planner kernels against their plain versions on the card: the same
# arithmetic op by op (planner.h), but the plain version's rotations go
# through cuBLAS (torch.bmm, einsum), whose products and sums the kernels
# write out: float32 within 1e-5 of each output's largest entry, float64
# within 1e-12 (measured on the CPU between the host build and the plain
# version: 1.2e-7 and 1.1e-16, tests/test_torch_plan_kernels.py); the bits
# that part are counted and printed.
PLAN_REL = {torch.float32: 1e-5, torch.float64: 1e-12}
PLAN_B = (1, 37, 4096)
# Ruiz against its plain version: max and products are the plain version's
# bit for bit; the mean's summation order and torch.rsqrt against rsqrtf may
# part by an ulp, and eight rounds of rsqrt carry it on; relative to each
# output's largest entry (the scales elementwise)
RUIZ_REL = 1e-5
# B's of the Ruiz comparisons, the MPC's QPs (stride-0 A) and the WBC's
# (dense A), and of its times
RUIZ_B = (1, 37, 4096)
RUIZ_TIMED_B = (1, 256, 4096)


def planner_inputs(B: int, seed: int) -> dict:
    """numpy float64 inputs of the three planner kernels: every gait id,
    phases over four periods, SRB states around the standing height with
    any yaw, commands, feet near the shoulders, swing phases in [0, 1] and
    durations (some 0: the clamp) and the apex height."""
    r = np.random.default_rng(seed)
    x = np.zeros((B, 12))
    x[:, 0:2] = r.normal(size=(B, 2)) * 0.5
    x[:, 2] = SOLO12.h_ref + r.normal(size=B) * 0.01
    x[:, 3:5] = r.normal(size=(B, 2)) * 0.05
    x[:, 5] = r.uniform(-np.pi, np.pi, B)
    x[:, 6:12] = r.normal(size=(B, 6)) * 0.3
    v_cmd = np.stack([r.uniform(-0.5, 0.5, B), r.uniform(-0.3, 0.3, B),
                      r.uniform(-1.0, 1.0, B)], axis=1)
    feet = (x[:, None, 0:3] + SOLO12.shoulder_offsets
            + r.normal(size=(B, 4, 3)) * 0.02)
    feet[:, :, 2] = r.normal(size=(B, 4)) * 0.01
    T = r.uniform(0.06, 0.3, (B, 4)) * (r.uniform(size=(B, 4)) > 0.1)
    return dict(gid=r.integers(0, len(GAIT_IDS), B).astype(np.int32),
                phase=r.integers(0, 4 * 16, B).astype(np.int32), x=x,
                v_cmd=v_cmd, feet=feet,
                lift=feet + r.normal(size=(B, 4, 3)) * 0.05,
                td=feet + r.normal(size=(B, 4, 3)) * 0.05,
                s=r.uniform(0.0, 1.0, (B, 4)), T=T)


def planner_calls(d: dict, dtype, device):
    """{kernel name: (wrapper call, plain call)} on the inputs `d`."""
    cfg = EngineConfig()
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    i = lambda a: torch.tensor(a, device=device)  # noqa: E731
    gid, ph, x, vc, feet = (i(d["gid"]), i(d["phase"]), t(d["x"]),
                            t(d["v_cmd"]), t(d["feet"]))
    sw = (t(d["lift"]), t(d["td"]), t(d["s"]), t(d["T"]),
          cfg.cascade.swing_height)
    fs_args = (SOLO12, cfg.mpc, cfg.cascade, gid, ph, x, vc, feet)
    return {"plan_footsteps_horizon": (
                lambda: footsteps_mod.plan_footsteps_horizon(*fs_args),
                lambda: footsteps_mod.plan_footsteps_horizon_reference(
                    *fs_args)),
            "reference_rollout": (
                lambda: srb_mod.reference_rollout(SOLO12, cfg.mpc, x, vc),
                lambda: srb_mod.reference_rollout_reference(SOLO12, cfg.mpc,
                                                            x, vc)),
            "swing_foot_ref": (lambda: swing_mod.swing_foot_ref(*sw),
                               lambda: swing_mod.swing_foot_ref_reference(
                                   *sw))}


def as_list(out):
    return [out] if isinstance(out, torch.Tensor) else list(out)


def kernel_vs_plain(name: str, call, plain, tol: float, tag: str) -> tuple:
    """One wrapper call against its plain version on the card: (largest
    |diff| relative to each output's largest entry, largest |diff|, entries
    whose bits part, entries); two launches bit for bit, shapes and dtypes
    the plain version's."""
    got, again, want = as_list(call()), as_list(call()), as_list(plain())
    errs = [rbd_rel_err(g, w) for g, w in zip(got, want)]
    rel, ab = max(e[0] for e in errs), max(e[1] for e in errs)
    parted = sum(int((g != w).sum()) for g, w in zip(got, want))
    total = sum(w.numel() for w in want)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    shapes = all(g.shape == w.shape and g.dtype == w.dtype
                 for g, w in zip(got, want))
    check(rel <= tol and same and shapes and all_finite(got),
          f"3g: {name}, {tag}: within {tol:g} of the plain version "
          "(relative), finite, shapes and dtypes its own, two launches bit "
          "for bit")
    return rel, ab, parted, total


def plan_bounds(B: int, d: dict, N: int) -> dict:
    """{kernel: bound}: the values each function must read and write (4
    bytes each: the ints of gait and phase, the float32 inputs it reads,
    its outputs) and its operations on this data: the footstep horizon a
    compare a step and foot and about 40 at each swing -> stance
    transition (the Raibert target with its sin, cos and sqrt), the rollout
    14 a step, the swing reference about 60 a foot."""
    g, ph = d["gid"][:B], d["phase"][:B]
    flags = GAIT_TABLES[g[:, None], (ph[:, None] + np.arange(N)) % 16]
    trans = int(((flags[:, 1:] > 0.5) & (flags[:, :-1] < 0.5)).sum())
    return {"plan_footsteps_horizon": bound_ms(
                B * (2 + 12 + 3 + 12 + N * 12 + 12), B * 4 * N + 40 * trans),
            "reference_rollout": bound_ms(B * (6 + N * 12), B * N * 14),
            "swing_foot_ref": bound_ms(B * 4 * (8 + 9), B * 4 * 60)}


def ruiz_bound_ms(B: int, n: int, m: int, iters: int, a_shared: bool):
    """P, q, l, u in, A once where it is shared (else per scenario); Pb, qb,
    Ab, lb, ub, D, E, c out.  Operations a scenario: each round two passes
    over P (a product and a max an entry), one over A (two products and two
    maxima an entry) and the scales; then the scaled P and A (two products
    an entry)."""
    floats = (B * (n * n + n + 2 * m) + (m * n if a_shared else B * m * n)
              + B * (n * n + n + m * n + 2 * m + n + m + 1))
    flops = B * (iters * (4.0 * n * n + 4.0 * m * n + 8.0 * (n + m))
                 + 2.0 * n * n + 2.0 * m * n)
    return bound_ms(floats, flops)


def ruiz_qps(device):
    """(MPC QPs, WBC QPs) at B = 4096 in float32 on the card: the MPC's
    from build_mpc_qp on planned states (its A the stride-0 constant), the
    WBC's from the build kernel on 3e's states (A dense)."""
    cfg = EngineConfig()
    Bt = max(RUIZ_B)
    d = planner_inputs(Bt, 80)
    t = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                               device=device)
    gid = torch.tensor(d["gid"] % 4, device=device)
    ph = torch.tensor(d["phase"], device=device)
    x, vc, feet = t(d["x"]), t(d["v_cmd"]), t(d["feet"])
    fsteps, _ = footsteps_mod.plan_footsteps_horizon(
        SOLO12, cfg.mpc, cfg.cascade, gid, ph, x, vc, feet)
    x_ref = srb_mod.reference_rollout(SOLO12, cfg.mpc, x, vc)
    cont = contacts_horizon(gid, ph, cfg.mpc.horizon, torch.float32)
    mpc = build_mpc_qp(SOLO12, cfg.mpc, x, x_ref, fsteps, cont)
    q, v, refs, _ = wbc_build_inputs(Bt, 81)
    tree = CascadeConfigured(SOLO12, cfg).tree
    wbc = tsid_mod.wbc_build(tree, cfg.wbc, t(q), t(v),
                             WbcRefs(**{k: t(a) for k, a in refs.items()}))
    return mpc, wbc[:5]


def ruiz_layout_line(args, device) -> str:
    """The layout a Ruiz launch on `args` takes: path, cluster size,
    scenarios a block, blocks a multiprocessor (the occupancy calculator's
    count for the launched kernel), where P lies, A's lists."""
    n, m, B = args[0].shape[-1], args[2].shape[1], args[0].shape[0]
    lay = kernels.ruiz_layout(n, m, B, *kernels.device_limits(device))
    path, size, p_in_smem, slots = lay.geometry
    per_sm = kernels._library("ruiz").ruiz_blocks_per_sm(path, n, m, size,
                                                         p_in_smem, slots)
    check(per_sm >= 1, f"3g: Ruiz's layout {lay} fits a multiprocessor")
    return (f"path {lay.path}, cluster {lay.cluster}, "
            f"{lay.warps or 1} scenario(s) a block, {lay.blocks} blocks of "
            f"{lay.threads} threads, {per_sm} blocks a multiprocessor, "
            f"{lay.width} columns a block, P in shared memory "
            f"{lay.p_in_smem}, slots {lay.slots}, {4 * lay.smem_floats} "
            "bytes of shared memory a block")


def planner_ruiz_phase(smi: str, device, reports: dict) -> None:
    """3g: the planner's three kernels and the Ruiz kernel against their
    plain versions on the card, bit for bit where they agree (counted);
    times at B = 1 and 4096 (Ruiz: 1, 256 and 4096; a one-launch CUDA
    graph's replay as `ms`, the eager wrapper beside it), the plain chains
    and the bounds."""
    N = EngineConfig().mpc.horizon
    errs = {k: [] for k in ("plan_footsteps_horizon", "reference_rollout",
                            "swing_foot_ref")}
    d = planner_inputs(max(PLAN_B), 70)
    for B in PLAN_B:
        dB = {k: a[:B] for k, a in d.items()}
        for dtype in (torch.float32, torch.float64):
            line = []
            for name, (call, plain) in planner_calls(dB, dtype,
                                                     device).items():
                e = kernel_vs_plain(name, call, plain, PLAN_REL[dtype],
                                    f"B={B} {str(dtype)[6:]}")
                errs[name].append((dtype, e))
                line.append(f"{name} rel {e[0]:.3e} abs {e[1]:.3e} "
                            f"({e[2]} of {e[3]} entries part)")
            print(f"  B={B} {str(dtype)[6:]}: " + "; ".join(line),
                  flush=True)
    timed = {}
    for B in (1, max(PLAN_B)):
        dB = {k: a[:B] for k, a in d.items()}
        bounds = plan_bounds(B, d, N)
        for name, (call, plain) in planner_calls(dB, torch.float32,
                                                 device).items():
            ms, eager = graph_ms(call), time_ms(call, 3, 50)
            plain_ms = time_ms(plain, 1, 3)
            timed[name, B] = (ms, eager, plain_ms, bounds[name])
            report_times(name, f"B={B} float32 (graph replay; eager wrapper "
                         f"{eager:.4f} ms)", ms, plain_ms, bounds[name], smi)
    for name, src, replaces in (
            ("plan_footsteps_horizon", "planner.cu",
             "mpctsid_tpu/plan/footsteps.py:37"),
            ("reference_rollout", "planner.cu", "mpctsid_tpu/mpc/srb.py:53"),
            ("swing_foot_ref", "planner.cu", "mpctsid_tpu/plan/swing.py:14")):
        f32 = [e for dt, e in errs[name] if dt == torch.float32]
        f64 = [e for dt, e in errs[name] if dt == torch.float64]
        (ms, eager, plain, bound), (ms1, eager1, plain1, bound1) = (
            timed[name, max(PLAN_B)], timed[name, 1])
        reports[name] = dict(
            source=f"mpctsid_tpu_torch/plan/csrc/{src}", replaces=replaces,
            max_abs_err=max(e[1] for e in f32),
            max_rel_err=max(e[0] for e in f32),
            max_rel_err_f64=max(e[0] for e in f64),
            entries_parted_f32=sum(e[2] for e in f32),
            entries_f32=sum(e[3] for e in f32),
            ms=ms, plain_ms=plain, bound_ms=bound[0], bound_by=bound[1],
            ms_eager=eager, ms_b1=ms1, plain_ms_b1=plain1,
            bound_ms_b1=bound1[0], bound_by_b1=bound1[1], ms_eager_b1=eager1)

    # ---- Ruiz
    iters = 8
    mpc, wbc = ruiz_qps(device)
    check(mpc[2].stride(0) == 0, "3g: the MPC's A reaches Ruiz as the "
                                 "stride-0 constant")
    rz = {}
    for shape, qp in (("mpc", mpc), ("wbc", wbc)):
        for B in RUIZ_B:
            args = [a[:B] for a in qp]
            e = kernel_vs_plain(
                "ruiz_equilibrate",
                lambda: kernels.ruiz_equilibrate(*args, iters),
                lambda: admm_mod.ruiz_equilibrate(*args, iters), RUIZ_REL,
                f"{shape} shape B={B}")
            rz.setdefault(shape, []).append(e)
            print(f"  ruiz_equilibrate {shape} shape B={B} "
                  f"(n={args[0].shape[-1]}, m={args[2].shape[1]}; "
                  f"{ruiz_layout_line(args, device)}): rel {e[0]:.3e} abs "
                  f"{e[1]:.3e} ({e[2]} of {e[3]} entries part)", flush=True)
        n, m = qp[0].shape[-1], qp[2].shape[1]
        for B in RUIZ_TIMED_B:
            args = [a[:B] for a in qp]
            call = lambda: kernels.ruiz_equilibrate(*args, iters)  # noqa
            ms, eager = graph_ms(call), time_ms(call, 2, 10)
            plain = time_ms(lambda: admm_mod.ruiz_equilibrate(*args, iters),
                            1, 2)
            bound = ruiz_bound_ms(B, n, m, iters, shape == "mpc")
            rz[shape, B] = (ms, eager, plain, bound)
            report_times("ruiz_equilibrate", f"{shape} shape B={B} n={n} "
                         f"m={m} (graph replay; eager wrapper {eager:.4f} "
                         "ms)", ms, plain, bound, smi)
    del mpc, wbc
    Bt = max(RUIZ_B)
    (ms, eager, plain, bound), (ms1, eager1, plain1, bound1) = (
        rz["mpc", Bt], rz["mpc", 1])
    w, w1 = rz["wbc", Bt], rz["wbc", 1]
    mid, wmid = rz["mpc", 256], rz["wbc", 256]
    # the default path runs it at the MPC shape (one launch a period): the
    # row's numbers; the WBC shape's (backends vpu, packed, mma) under
    # *_wbc_shape
    reports["ruiz_equilibrate"] = dict(
        source="mpctsid_tpu_torch/qp/csrc/ruiz.cu",
        replaces="mpctsid_tpu/qp/admm.py:80",
        max_abs_err=max(e[1] for e in rz["mpc"] + rz["wbc"]),
        max_rel_err=max(e[0] for e in rz["mpc"] + rz["wbc"]),
        entries_parted=sum(e[2] for e in rz["mpc"] + rz["wbc"]),
        entries=sum(e[3] for e in rz["mpc"] + rz["wbc"]),
        ms=ms, plain_ms=plain, bound_ms=bound[0], bound_by=bound[1],
        ms_eager=eager, ms_b1=ms1, plain_ms_b1=plain1, bound_ms_b1=bound1[0],
        bound_by_b1=bound1[1], ms_eager_b1=eager1, ms_wbc_shape=w[0],
        ms_eager_wbc_shape=w[1], plain_ms_wbc_shape=w[2],
        bound_ms_wbc_shape=w[3][0], ms_b1_wbc_shape=w1[0],
        plain_ms_b1_wbc_shape=w1[2], bound_ms_b1_wbc_shape=w1[3][0],
        ms_b256=mid[0], plain_ms_b256=mid[2], bound_ms_b256=mid[3][0],
        ms_b256_wbc_shape=wmid[0], plain_ms_b256_wbc_shape=wmid[2],
        bound_ms_b256_wbc_shape=wmid[3][0])
    for name in ("plan_footsteps_horizon", "reference_rollout",
                 "swing_foot_ref", "ruiz_equilibrate"):
        r = reports[name]
        print(f"  {name}: replaces {r['replaces']} (XLA's fusion; no TPU "
              f"kernel), source {r['source']}, library call none; B=4096 "
              f"{r['ms']:.4f} ms (graph replay) / {r['ms_eager']:.4f} ms "
              f"(eager), bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
              f"plain {r['plain_ms']:.3f} ms  [{smi}]", flush=True)


# ---------------------------------------------------------------- main path

COUNTED = {"admm_iterate_m2": kernels.admm_iterate_m2,
           "admm_iterate_vpu": kernels.admm_iterate_vpu,
           "admm_iterate_vpu_packed": kernels.admm_iterate_vpu_packed,
           "admm_solve_fused": kernels.admm_solve_fused,
           "admm_iterate": kernels.admm_iterate,
           "wbc_build": tsid_mod.wbc_build,
           "plant_step": plant_step,
           "admm_solve_plain_warp": kernels.admm_solve_plain_warp,
           "chol_inverse": kernels.chol_inverse,
           "plan_footsteps_horizon": footsteps_mod.plan_footsteps_horizon,
           "reference_rollout": srb_mod.reference_rollout,
           "swing_foot_ref": swing_mod.swing_foot_ref,
           "ruiz_equilibrate": kernels.ruiz_equilibrate}


def reset_launch_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


WBC_KERNEL_OF = {"xla": "admm_solve_plain_warp",
                 "torch": "admm_solve_plain_warp",
                 "fused": "admm_solve_fused",
                 "packed": "admm_iterate_vpu_packed",
                 "vpu": "admm_iterate_vpu",
                 "pallas": "admm_iterate"}
# WBC backends whose whole solve is one launch; the others launch their
# iteration kernel and kernel B once per adapt round
WHOLE_SOLVE = ("xla", "torch", "fused")
MPC_KERNEL_OF = {"auto_mpc": "admm_iterate_m2", "m2": "admm_iterate_m2",
                 "pallas": "admm_iterate"}


def expected_launches(cfg, periods: int, wbc_backend: str,
                      mpc_backend: str = None):
    """(the kernel this rollout is there to count, every kernel's expected
    launches): the MPC's iteration kernel and kernel B (its K^-1) once per
    MPC adapt round, the footstep horizon, the reference rollout and Ruiz
    once per period; a whole-solve kernel (kernel A on the default backend,
    kernel 4 on `fused`) once per WBC tick; a WBC iteration kernel and
    kernel B once per WBC adapt round and Ruiz once per tick; the WBC
    build, the plant step and the swing reference once per tick, whatever
    the backends."""
    expect = dict.fromkeys(COUNTED, 0)
    mpc_kernel = MPC_KERNEL_OF[mpc_backend or cfg.solver.mpc_backend]
    expect[mpc_kernel] = periods * cfg.solver.mpc_adapt_rounds
    expect["chol_inverse"] = periods * cfg.solver.mpc_adapt_rounds
    for name in ("plan_footsteps_horizon", "reference_rollout",
                 "ruiz_equilibrate"):
        expect[name] = periods
    ticks = periods * cfg.cascade.mpc_every
    expect["wbc_build"] = expect["plant_step"] = ticks
    expect["swing_foot_ref"] = ticks
    counted = WBC_KERNEL_OF[wbc_backend]
    if wbc_backend in WHOLE_SOLVE:
        expect[counted] += ticks
    else:
        expect[counted] += ticks * cfg.solver.wbc_adapt_rounds
        expect["chol_inverse"] += ticks * cfg.solver.wbc_adapt_rounds
        expect["ruiz_equilibrate"] += ticks
    return counted, expect


def standing(B: int):
    q0 = np.zeros((B, 19), np.float32)
    q0[:, 2] = SOLO12.h_ref
    q0[:, 6] = 1.0
    q0[:, 7:] = SOLO12.q_stand
    return q0


def make_scenarios(cfg, B: int, seed: int, device):
    cc = CascadeConfigured(SOLO12, cfg)
    q0 = standing(B)
    gid = np.full((B,), GAIT_IDS[cfg.gait], np.int32)
    ctl = init_controller(SOLO12, cfg, cc.tree, q0, gid, device=device)
    plant = PlantState.init(q0, device=device)
    cp = ContactParams.default(B, device=device)
    mu = np.random.default_rng(seed).uniform(0.5, 0.9, size=B)
    cp.mu = torch.as_tensor(mu, dtype=torch.float32).to(device)
    v = np.tile(np.asarray(cfg.v_ref, np.float32), (B, 1))
    return cc, ctl, plant, gid, v, cp


@dataclasses.dataclass
class EagerRecord:
    """What phase 4's eager rollout of one configuration leaves for phase
    12: the rollout's arguments, the state at every period boundary
    ((ctl, plant, est) before period 0, after period 0, ...), each period's
    metrics and wall seconds (each ended by a synchronize)."""

    tag: str
    cc: CascadeConfigured
    gid: torch.Tensor
    v: torch.Tensor
    cp: ContactParams
    use_estimator: bool
    solver_kw: dict
    states: list = dataclasses.field(default_factory=list)
    metrics: list = dataclasses.field(default_factory=list)
    walls: list = dataclasses.field(default_factory=list)


@contextlib.contextmanager
def recorded_periods(rec: EagerRecord):
    """cascade_rollout's periods recorded into `rec` (the hook wraps
    engine.cascade_period, which the rollout calls by name; the graphed
    runner holds its own reference and is never recorded)."""
    original = engine.cascade_period

    def hook(cc, ctl, plant, gait_id, v_cmd, contact_params, est=None,
             **kw):
        if not rec.states:
            rec.states.append((ctl, plant, est))
        torch.cuda.synchronize()
        t0 = time.time()
        out = original(cc, ctl, plant, gait_id, v_cmd, contact_params,
                       est=est, **kw)
        torch.cuda.synchronize()
        rec.walls.append(time.time() - t0)
        rec.states.append(out[:3])
        rec.metrics.append(out[3])
        return out

    engine.cascade_period = hook
    try:
        yield rec
    finally:
        engine.cascade_period = original


def full_width_rollout(cfg, wbc_backend: str, expect: dict, smi: str, device,
                       mpc_backend: str = None, use_estimator: bool = False):
    """The main path at full width with one WBC backend: ROLLOUT_PERIODS
    periods of the preset from standing, every launch count set to 0 just
    before and read just after.  With `use_estimator` the controller runs on
    the hint-free complementary filter's estimate.  Returns the counts and
    the rollout's `EagerRecord`."""
    B = cfg.batch
    cc, ctl, plant, gid, v, cp = make_scenarios(cfg, B, seed=0, device=device)
    est = estimator_init(standing(B), device=device) if use_estimator else None
    tag = f"wbc_backend={wbc_backend}"
    if mpc_backend is not None:
        tag = f"mpc_backend={mpc_backend} " + tag
    if use_estimator:
        tag = "estimator in the loop, " + tag
    rec = EagerRecord(tag, cc, torch.as_tensor(gid).to(device),
                      torch.as_tensor(v).to(device), cp, use_estimator,
                      dict(mpc_backend=mpc_backend, wbc_backend=wbc_backend))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.time()
    with recorded_periods(rec):
        ctl, plant, metrics = cascade_rollout(
            cc, ctl, plant, gid, v, cp, n_periods=ROLLOUT_PERIODS,
            device=device, est=est, use_estimator=use_estimator,
            mpc_backend=mpc_backend, wbc_backend=wbc_backend)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    ticks = B * ROLLOUT_PERIODS * cfg.cascade.mpc_every
    x = metrics["x_srb"]
    finite = all_finite((plant.q, plant.v, ctl.f_plan, x, metrics["tau_rms"]))
    dz = float((x[:, :, 2] - SOLO12.h_ref).abs().max())
    wbc_ok = float(metrics["wbc_ok_frac"].mean())
    print(f"  {tag}: {ticks / wall:.1f} ticks/s, "
          f"{wall / ROLLOUT_PERIODS:.3f} s per period, wall {wall:.2f} s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  "
          f"[{smi}]")
    print(f"    launches {counts}; max |z - h_ref| {dz:.4f} m; wbc_ok_frac "
          f"{wbc_ok:.4f}; mean mpc dual res "
          f"{float(metrics['mpc_dual_res'].mean()):.3e}; mean x after "
          f"{ROLLOUT_PERIODS} periods {float(plant.q[:, 0].mean()):+.4f} m",
          flush=True)
    check(tuple(x.shape) == (B, ROLLOUT_PERIODS, 12), f"{tag}: metrics shape")
    check(finite, f"{tag}: everything finite")
    check(bool(metrics["mpc_ok"].all()), f"{tag}: mpc_ok all true")
    check(wbc_ok >= 0.99, f"{tag}: wbc_ok_frac >= 0.99")
    check(dz < 0.03, f"{tag}: base height within 0.03 m of h_ref, every "
                     "scenario and period")
    check(counts == expect, f"{tag}: kernel launches are {expect}")
    if use_estimator:
        drift = metrics["est_xy_err"]
        print(f"    hint-free estimator drift |est xy - plant xy| after "
              f"{ROLLOUT_PERIODS} periods: mean "
              f"{float(drift[:, -1].mean()):.3e} m, max "
              f"{float(drift[:, -1].max()):.3e} m", flush=True)
        check(tuple(drift.shape) == (B, ROLLOUT_PERIODS)
              and bool(torch.isfinite(drift).all())
              and float(drift.max()) < EST_DRIFT_TOL,
              f"{tag}: est_xy_err finite and < {EST_DRIFT_TOL} m")
    return counts, rec


def capture_wbc_tick(cc, ctl, plant, gid, v, cp, tick: int, device):
    """Arguments of the `tick`-th solve_wbc call of one period (a real
    mid-gait WBC problem with its warm start), and the state after it."""
    captured = []
    original = engine.solve_wbc

    def hook(tree, cfg, q, v_, refs, **kw):
        captured.append((tree, cfg, q, v_, refs, kw))
        return original(tree, cfg, q, v_, refs, **kw)

    engine.solve_wbc = hook
    try:
        ctl, plant, _ = cascade_rollout(cc, ctl, plant, gid, v, cp,
                                        n_periods=1, device=device)
    finally:
        engine.solve_wbc = original
    return captured[tick], ctl, plant


def capture_mpc_inputs(cc, ctl, plant, gid, v, cp, device):
    """(x0, x_ref, feet, contacts) of the MPC solve of one period (the
    port's own planner: rollout, footsteps, gait table), and the state
    after it."""
    captured = []
    original = engine.build_mpc_qp

    def hook(model, cfg, x0, x_ref, feet, contacts, **kw):
        captured.append((x0, x_ref, feet, contacts))
        return original(model, cfg, x0, x_ref, feet, contacts, **kw)

    engine.build_mpc_qp = hook
    try:
        ctl, plant, _ = cascade_rollout(cc, ctl, plant, gid, v, cp,
                                        n_periods=1, device=device)
    finally:
        engine.build_mpc_qp = original
    return captured[0], ctl, plant


def varied_commands(B: int, seed: int):
    """(B, 3) commanded vx, vy, yaw rate, one per scenario (numpy, seeded),
    so that the trot scenarios of one batch pose different problems."""
    r = np.random.default_rng(seed)
    return np.stack([r.uniform(-0.4, 0.4, B), r.uniform(-0.2, 0.2, B),
                     r.uniform(-0.5, 0.5, B)], axis=1).astype(np.float32)


def timed(fn):
    """(fn's result, wall seconds up to a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def accuracy_tiers(smi: str, device) -> None:
    """Phase 8: the paths of qp/ and mpc/ that carry the contract's 1e-4."""
    cfg = PRESETS["config4_cascade_4k"]
    B = TIER_B
    cc, ctl, plant, gid, v, cp = make_scenarios(cfg, B, seed=8,
                                                device=device)
    v = varied_commands(B, seed=8)
    # two periods from standing reach mid-gait; the third's problems
    ctl, plant, _ = cascade_rollout(cc, ctl, plant, gid, v, cp, n_periods=2,
                                    device=device)
    (x0, x_ref, feet, cont), _, _ = capture_mpc_inputs(cc, ctl, plant, gid,
                                                       v, cp, device)

    (forces, sol), sec = timed(lambda: solve_mpc_batch(
        SOLO12, cfg.mpc, x0, x_ref, feet, cont))
    swing = cont < 0.5
    f_swing = float(forces[swing].abs().max()) if bool(swing.any()) else 0.0
    print(f"  solve_mpc_batch B={B} (200 iterations, plain backend): "
          f"{sec:.3f} s, ok {float(sol.ok.float().mean()):.4f}, max |f| on "
          f"swing feet {f_swing:.3e} N  [{smi}]", flush=True)
    check(tuple(forces.shape) == (B, cfg.mpc.horizon, 4, 3)
          and all_finite((forces, sol.x, sol.y)) and bool(sol.ok.all()),
          "solve_mpc_batch: (B, N, 4, 3) forces, finite, every solve ok")
    check(f_swing < 1e-3, "solve_mpc_batch: swing-foot forces pinned "
                          "(< 1e-3 N)")

    qp = build_mpc_qp(SOLO12, cfg.mpc, x0, x_ref, feet, cont)
    s64, sec64 = timed(lambda: admm_solve(
        *(t.double() for t in qp), backend="torch", **MPC_TIER))
    print(f"  polished MPC tier, float64 (plain backend): {sec64:.3f} s  "
          f"[{smi}]", flush=True)
    for backend in ("torch", cfg.solver.mpc_backend):
        s32, sec = timed(lambda: admm_solve(*qp, backend=backend,
                                            **MPC_TIER))
        d = (s32.x.double() - s64.x).abs().amax(dim=1)
        print(f"  polished MPC tier, float32, backend {backend}: {sec:.3f} "
              f"s; max |x32 - x64| over B={B}: {float(d.max()):.3e} (median "
              f"{float(d.median()):.3e})  [{smi}]", flush=True)
        check(s32.x.dtype == torch.float32 and bool(s32.ok.all())
              and float(d.max()) < CONTRACT_TOL,
              f"polished MPC tier ({backend}): float32 within "
              f"{CONTRACT_TOL:g} of the float64 solve, every scenario")
    del qp, s64

    # the df32 residual at the MPC KKT's size, cancelling (b = K x + 1e-6)
    g = torch.Generator(device="cpu").manual_seed(8)
    K64 = torch.randn((256, 512, 512), generator=g,
                      dtype=torch.float64).to(device)
    x64 = torch.randn((256, 512), generator=g, dtype=torch.float64).to(device)
    K32, x32 = K64.float(), x64.float()
    exact = torch.bmm(K32.double(), x32.double()[:, :, None])[:, :, 0]
    b32 = (exact + 1e-6 * torch.randn(exact.shape, generator=g,
                                      dtype=torch.float64).to(device)).float()
    ref = b32.double() - exact
    r_df, sec_df = timed(lambda: residual_matvec(b32, K32, x32))
    r_pl, sec_pl = timed(
        lambda: b32 - torch.bmm(K32, x32[:, :, None])[:, :, 0])
    e_df = float((r_df.double() - ref).abs().max())
    e_pl = float((r_pl.double() - ref).abs().max())
    print(f"  residual_matvec (256 x 512 x 512): df32 {sec_df * 1e3:.2f} ms, "
          f"max |r - r64| {e_df:.3e}; float32 bmm {sec_pl * 1e3:.2f} ms, "
          f"{e_pl:.3e}: {e_pl / max(e_df, 1e-300):.1f}x  [{smi}]", flush=True)
    check(r_df.dtype == torch.float32 and e_df * DF32_GAIN <= e_pl,
          f"residual_matvec: at least {DF32_GAIN:g}x closer to float64 than "
          "a float32 mat-vec")
    del K64, K32, exact

    # the float64 WBC tier at full width on a mid-gait tick, card vs CPU
    cfg4 = PRESETS["config4_cascade_4k"]
    cc, ctl, plant, gid, v, cp = make_scenarios(cfg4, cfg4.batch, seed=9,
                                                device=device)
    v = varied_commands(cfg4.batch, seed=9)
    ctl, plant, _ = cascade_rollout(cc, ctl, plant, gid, v, cp, n_periods=2,
                                    device=device)
    (tree, wcfg, q_t, v_t, refs, wkw), _, _ = capture_wbc_tick(
        cc, ctl, plant, gid, v, cp, tick=10, device=device)

    def tier(dev):
        d64 = lambda t: t.to(dev, torch.float64)  # noqa: E731
        refs64 = WbcRefs(**{k: d64(getattr(refs, k))
                            for k in refs.__dataclass_fields__})
        return solve_wbc(
            tree, wcfg, d64(q_t), d64(v_t), refs64,
            iters=WBC_PARITY_SOLVER.wbc_iters,
            adapt_rounds=WBC_PARITY_SOLVER.wbc_adapt_rounds,
            warm_x=d64(wkw["warm_x"]), warm_y=d64(wkw["warm_y"]),
            backend="torch", polish=True,
            extra_base_inertia=None if wkw.get("extra_base_inertia") is None
            else d64(wkw["extra_base_inertia"]))

    (tau_g, _, _, sol_g), sec_g = timed(lambda: tier(device))
    t0 = time.time()
    tau_c, _, _, sol_c = tier(torch.device("cpu"))
    sec_c = time.time() - t0
    d = (tau_g.cpu() - tau_c).abs().amax(dim=1)
    tau32 = solve_wbc(tree, wcfg, q_t, v_t, refs, **wkw)[0]
    d32 = (tau32.double() - tau_g).abs().amax(dim=1)
    print(f"  float64 WBC tier B={cfg4.batch} ({WBC_PARITY_SOLVER.wbc_iters} "
          f"iterations in {WBC_PARITY_SOLVER.wbc_adapt_rounds} rounds, "
          f"polished): card {sec_g:.3f} s, CPU {sec_c:.3f} s; max |tau card "
          f"- tau CPU| {float(d.max()):.3e} Nm (median "
          f"{float(d.median()):.3e}); the float32 in-loop solve lies "
          f"{float(d32.median()):.3e} Nm (median, max "
          f"{float(d32.max()):.3e}) from it  [{smi}]", flush=True)
    check(tau_g.dtype == torch.float64 and bool(sol_g.ok.all())
          and bool(sol_c.ok.all()) and all_finite((tau_g,)),
          "float64 WBC tier: float64, finite, every solve ok on both")
    check(float(d.max()) < WBC_TIER_CPU_TOL,
          f"float64 WBC tier: card within {WBC_TIER_CPU_TOL:g} Nm of the "
          "CPU, every scenario")


# ------------------------------------------------- the single-robot host path

def host_cfg(mpc_backend: str, wbc_backend: str) -> EngineConfig:
    cfg = EngineConfig(gait="trot", v_ref=(0.25, 0.0, 0.0))
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, mpc_backend=mpc_backend, wbc_backend=wbc_backend))


def backend_tag(mpc_backend: str, wbc_backend: str) -> str:
    return f"mpc {mpc_backend}, wbc {wbc_backend}"


class AgainstEager:
    """Stands in for one of HostController's captured calls: every call
    replays the graph, then runs the same function eagerly on the card from
    the same static inputs, and keeps the largest difference of the outputs
    and of the state the call writes in place (the warm starts)."""

    def __init__(self, call):
        self.call = call
        self.max_diff = 0.0
        self.calls = 0

    def __call__(self, **new_values):
        call = self.call
        for key, value in new_values.items():
            call.inputs[key].copy_(value)
        before = {k: t.clone() for k, t in call.inputs.items()}
        graph_out = call().clone()
        graph_after = {k: t.clone() for k, t in call.inputs.items()}
        for key, t in call.inputs.items():
            t.copy_(before[key])
        eager_out = call.fn(**call.inputs)
        diffs = [float((graph_out - eager_out).abs().max())] + [
            float((graph_after[k] - call.inputs[k]).abs().max())
            for k in call.inputs]
        # NaN compares False: count it as a failed comparison
        self.max_diff = max([self.max_diff] + [
            d if d == d else float("inf") for d in diffs])
        self.calls += 1
        return eager_out


def standing_q0():
    return standing(1)[0]


class GraphPlant:
    """The SimPlant of the host runs with its step captured as one CUDA
    graph (`CapturedCall`): the plant is the test bed, not the controller
    under test, and stepped eagerly it would take most of the phase's time
    (tens of ms a tick at B = 1).  read() -> (q, v) numpy; apply(tau)."""

    def __init__(self, tree, q0, device):
        from mpctsid_tpu_torch.env.interface import SimPlant

        sim = SimPlant(tree, q0, device=device)
        st = sim.state

        def step(q, v, anchor, in_contact, tau):
            new, _ = plant_step(tree, PlantState(q, v, anchor, in_contact),
                                tau, dt=sim.dt, params=sim.params)
            for old, t in zip((q, v, anchor, in_contact),
                              (new.q, new.v, new.anchor, new.in_contact)):
                old.copy_(t)
            return q

        self.q, self.v = st.q, st.v
        self._step = CapturedCall(
            step, dict(q=st.q, v=st.v, anchor=st.anchor,
                       in_contact=st.in_contact,
                       tau=torch.zeros((1, 12), device=device)),
            device, "plant step")

    def read(self):
        return self.q[0].cpu().numpy(), self.v[0].cpu().numpy()

    def apply(self, tau) -> None:
        self._step(tau=torch.as_tensor(tau).reshape(1, 12))


def drive_host(ctl, seconds: float, device, settle: float = 0.0,
               plant=None):
    """Closed loop of `ctl` on the plant on the card (a GraphPlant made here
    unless given): returns (min z, final x, compute() wall seconds per tick,
    which ticks were period boundaries, the returned torques)."""
    cfg = ctl.cfg
    if plant is None:
        plant = GraphPlant(ctl.tree, standing_q0(), device)
    n = int(round(seconds / cfg.cascade.wbc_dt))
    zs, xs, walls, taus = [], [], [], []
    try:
        for k in range(n):
            q, v = plant.read()
            t0 = time.perf_counter()
            tau = ctl.compute(q, v)
            walls.append(time.perf_counter() - t0)
            plant.apply(tau)
            if settle:
                time.sleep(settle)
            zs.append(float(q[2]))
            xs.append(float(q[0]))
            taus.append(tau)
    finally:
        ctl.close()
    boundary = np.arange(n) % cfg.cascade.mpc_every == 0
    return min(zs), xs[-1], np.asarray(walls), boundary, np.stack(taus)


def latency_line(walls, boundary) -> str:
    ms = walls * 1e3
    return (f"compute() p50 {np.percentile(ms, 50):.3f} ms, p99 "
            f"{np.percentile(ms, 99):.3f} ms over {ms.size} ticks; period "
            f"boundaries (MPC) p50 {np.percentile(ms[boundary], 50):.3f} ms, "
            f"p99 {np.percentile(ms[boundary], 99):.3f} ms; other ticks p50 "
            f"{np.percentile(ms[~boundary], 50):.3f} ms")


def flush_cupti() -> None:
    """Make CUPTI hand every activity record it holds to the profiler
    (CUPTI_ACTIVITY_FLAG_FLUSH_FORCED), inside a profiled window.  Without
    it, in a process that has run for a few minutes, the profiler misses the
    last device events of a graph replay, more the older the process (on
    an H100 the replay of a B = 1 `fused` MPC solve lost one of its 36
    kernels every 16 s of process age, kernel 4 among them from two minutes
    on; with the flush all 36 were seen from 2.4 minutes on:
    scripts/probe_profiler_loss.py, PERF.md)."""
    for name in ("libcupti.so.12", "libcupti.so"):
        try:
            lib = ctypes.CDLL(name, mode=os.RTLD_NOLOAD | os.RTLD_LAZY)
        except OSError:
            continue
        lib.cuptiActivityFlushAll.argtypes = [ctypes.c_uint32]
        lib.cuptiActivityFlushAll.restype = ctypes.c_int
        rc = lib.cuptiActivityFlushAll(1)
        if rc != 0:
            raise RuntimeError(f"cuptiActivityFlushAll failed with {rc}")
        return
    raise RuntimeError("the profiler has not loaded CUPTI (libcupti.so.12)")


def kernels_per_replay(call, replays: int = 1
                       ) -> tuple[dict, int, dict, float, int]:
    """Of ONE replay of a captured call, as the profiler sees it: ({kernel
    prefix: launches}, device kernels in all, {kernel prefix: device ms},
    device busy ms: the sum of every kernel's time, copies and memsets).
    One profiled window holds `replays` replays back to back; every count is
    the window's count over `replays`, rounded up, and times are averaged.
    A profiler drops records, it never adds them: a window that loses fewer
    than `replays` records of a kind still counts that kind right (in a
    process a few minutes old the profiler drops a window's first or last
    records, flush or not: on an H100 the build kernel of a profiled host
    WBC replay, kernel 4 of a B = 1 MPC chain)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    per = lambda n: -(-n // replays)  # noqa: E731
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(replays):
            call()
        torch.cuda.synchronize()
        flush_cupti()
    counts = dict.fromkeys(KERNEL_PREFIX.values(), 0)
    port_ms = dict.fromkeys(KERNEL_PREFIX.values(), 0.0)
    total, busy_ms, copies = 0, 0.0, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "memcpy" in e.name.lower() or "memset" in e.name.lower():
            copies += 1
            continue
        ms = e.time_range.elapsed_us() / 1e3
        total += 1
        busy_ms += ms
        for prefix in counts:
            # the profiler's names are demangled signatures ("void
            # name(...)")
            if prefix in e.name:
                counts[prefix] += 1
                port_ms[prefix] += ms
    return ({k: per(n) for k, n in counts.items()}, per(total),
            {k: t / replays for k, t in port_ms.items()}, busy_ms / replays,
            per(copies))


def host_graphs(smi: str, device) -> None:
    """9a: every captured call against its eager run; 9b: the kernels in
    each replay; the replay times."""
    for mpc_backend, wbc_backend in HOST_BACKENDS:
        tag = backend_tag(mpc_backend, wbc_backend)
        cfg = host_cfg(mpc_backend, wbc_backend)
        t0 = time.time()
        ctl = HostController(SOLO12, cfg, standing_q0(), device=device)
        capture_s = time.time() - t0
        attrs = {"boundary": "_boundary", "mpc": "_mpc",
                 "swing": "_swing_ref", "wbc": "_wbc"}
        calls = {name: getattr(ctl, a) for name, a in attrs.items()}
        compared = {name: AgainstEager(c) for name, c in calls.items()}
        for name, a in attrs.items():
            setattr(ctl, a, compared[name])
        periods = 2
        zmin, _, _, _, _ = drive_host(
            ctl, periods * cfg.cascade.mpc_every * cfg.cascade.wbc_dt, device)
        diffs = {k: c.max_diff for k, c in compared.items()}
        print(f"  {tag}: 4 graphs captured in {capture_s:.2f} s; "
              f"{periods} periods on the plant, each replay against the "
              f"eager run: max |diff| {diffs} (calls "
              f"{ {k: c.calls for k, c in compared.items()} })", flush=True)
        check(all(d <= GRAPH_TOL for d in diffs.values())
              and compared["mpc"].calls == periods
              and compared["wbc"].calls == periods * cfg.cascade.mpc_every
              and zmin > 0.15,
              f"{tag}: every graph replay within {GRAPH_TOL} of its eager "
              "run on the card")
        # 9b: the kernels inside one replay of each graph
        mpc_kernel = KERNEL_PREFIX[MPC_KERNEL_OF[mpc_backend]]
        wbc_name = WBC_KERNEL_OF[wbc_backend]
        per = {}
        for name, call in calls.items():
            # three replays a window, two windows: the profiler drops a
            # window's device records as the process ages (flush_cupti)
            per[name] = kernels_per_replay(call, replays=3)
        times = {name: time_ms(call, 3, 20) for name, call in calls.items()}
        launched = {k: ({p: c for p, c in v[0].items() if c}, v[1])
                    for k, v in per.items()}
        device_ms = {k: ({p: round(t, 4) for p, t in v[2].items() if t},
                         round(v[3], 4)) for k, v in per.items()}
        print(f"    kernels per replay (port's, all): {launched}", flush=True)
        print(f"    device ms per replay (port's kernels, busy in all): "
              f"{device_ms}", flush=True)
        print(f"    replay ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
              + f"  [{smi}]", flush=True)
        want_mpc = dict.fromkeys(KERNEL_PREFIX.values(), 0)
        want_mpc[mpc_kernel] = cfg.solver.mpc_adapt_rounds
        want_mpc[KERNEL_PREFIX["chol_inverse"]] = cfg.solver.mpc_adapt_rounds
        for name in ("plan_footsteps_horizon", "reference_rollout",
                     "ruiz_equilibrate"):
            want_mpc[KERNEL_PREFIX[name]] = 1
        want_wbc = dict.fromkeys(KERNEL_PREFIX.values(), 0)
        want_wbc[KERNEL_PREFIX["wbc_build"]] = 1
        if wbc_backend in WHOLE_SOLVE:
            want_wbc[KERNEL_PREFIX[wbc_name]] = 1
        else:
            want_wbc[KERNEL_PREFIX[wbc_name]] = cfg.solver.wbc_adapt_rounds
            want_wbc[KERNEL_PREFIX["chol_inverse"]] = (
                cfg.solver.wbc_adapt_rounds)
            want_wbc[KERNEL_PREFIX["ruiz_equilibrate"]] = 1
        check(per["mpc"][0] == want_mpc,
              f"{tag}: one MPC replay launches {want_mpc}")
        check(per["wbc"][0] == want_wbc,
              f"{tag}: one WBC replay launches {want_wbc}")
        want_bd = dict.fromkeys(KERNEL_PREFIX.values(), 0)
        want_bd[KERNEL_PREFIX["plan_footsteps_horizon"]] = 1
        want_sw = dict.fromkeys(KERNEL_PREFIX.values(), 0)
        want_sw[KERNEL_PREFIX["swing_foot_ref"]] = 1
        check(per["boundary"][0] == want_bd and per["swing"][0] == want_sw,
              f"{tag}: the boundary graph launches the footstep kernel once, "
              "the swing graph the swing kernel once, and no other port "
              "kernel")
        print(f"    WBC replay: {per['wbc'][1]} kernels + {per['wbc'][4]} "
              f"copies/memsets, {times['wbc']:.4f} ms; MPC replay: "
              f"{per['mpc'][1]} kernels + {per['mpc'][4]} copies/memsets, "
              f"{times['mpc']:.4f} ms  [{smi}]", flush=True)
        if wbc_backend == "fused":
            check(per["wbc"][1] <= FUSED_WBC_NODES,
                  f"{tag}: the WBC replay holds at most {FUSED_WBC_NODES} "
                  "kernels (854 with the plain QP build)")
            before_after(calls["wbc"], "WBC replay, plain QP build / build "
                         "kernel", plain_wbc_build(), smi, device)
        if wbc_backend == "xla":
            check(per["wbc"][1] <= DEFAULT_WBC_NODES,
                  f"{tag}: the WBC replay holds at most {DEFAULT_WBC_NODES} "
                  "kernels (3,014-3,019 with the plain solve chain)")
            before_after(calls["wbc"], "WBC replay, plain solve chain / "
                         "kernel A", plain_wbc_chain(), smi, device)
            before_after(calls["mpc"], "MPC replay, plain K^-1 / kernel B",
                         plain_inverses(), smi, device)
            for name, what in (("boundary", "boundary replay, plain "
                                "footsteps / planner kernel"),
                               ("mpc", "MPC replay, plain planner and Ruiz "
                                "/ their kernels"),
                               ("swing", "swing replay, plain swing "
                                "reference / its kernel")):
                before_after(calls[name], what, plain_planner(), smi, device)
        check(per["mpc"][1] <= MPC_NODES,
              f"{tag}: the MPC replay holds at most {MPC_NODES} kernels "
              "(8,994-8,999 with the plain K^-1)")
        del ctl, calls, compared
        torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_wbc_build():
    """The WBC QP built by its plain chain (build_wbc_qp_reference, the
    chain before the build kernel)."""
    def plain_build(tree, cfg, q, v, refs, extra_base_inertia=None,
                    exact_pin=False):
        return tsid_mod.build_wbc_qp_reference(tree, cfg, q, v, refs,
                                               extra_base_inertia, exact_pin)

    shipped = tsid_mod.wbc_build
    tsid_mod.wbc_build = plain_build
    try:
        yield
    finally:
        tsid_mod.wbc_build = shipped


@contextlib.contextmanager
def plain_wbc_chain():
    """The default WBC solve on its plain chain (qp/admm.py's admm_solve,
    kernel A's plain version) even for a float32, unpolished CUDA solve."""
    shipped = tsid_mod.takes_solve_kernel
    tsid_mod.takes_solve_kernel = lambda H, backend, polish: False
    try:
        yield
    finally:
        tsid_mod.takes_solve_kernel = shipped


@contextlib.contextmanager
def plain_planner():
    """The host path's planner and the kernel backends' Ruiz on their plain
    chains (the four kernels' plain versions)."""
    import mpctsid_tpu_torch.host as host_mod

    patched = ((host_mod, "plan_footsteps_horizon",
                footsteps_mod.plan_footsteps_horizon_reference),
               (host_mod, "reference_rollout",
                srb_mod.reference_rollout_reference),
               (host_mod, "swing_foot_ref",
                swing_mod.swing_foot_ref_reference),
               (admm_mod, "ruiz_equilibrate_kernel",
                admm_mod.ruiz_equilibrate))
    shipped = [getattr(mod, name) for mod, name, _ in patched]
    for mod, name, plain in patched:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(patched, shipped):
            setattr(mod, name, fn)


@contextlib.contextmanager
def plain_inverses():
    """The kernel backends' K^-1 by its plain chain
    (blockinv.spd_inverse_chol, kernel B's plain version)."""
    shipped = admm_mod.chol_inverse
    admm_mod.chol_inverse = lambda K: spd_inverse_chol(K, ns_steps=1)
    try:
        yield
    finally:
        admm_mod.chol_inverse = shipped


def before_after(call, what: str, before, smi: str, device) -> None:
    """9b: the host path's captured `call` captured twice more from copies
    of its inputs, once inside the context `before` (the plain chain a
    kernel replaced) and once as it ships; their kernels per replay and
    replay ms, timed in turns (before, after, after, before)."""

    def capture(name):
        inputs = {k: t.clone() for k, t in call.inputs.items()}
        return CapturedCall(call.fn, inputs, device, name)

    with before:
        b = capture(f"{what}: before")
    a = capture(f"{what}: after")
    nodes = {k: kernels_per_replay(c, replays=3)[1]
             for k, c in (("before", b), ("after", a))}
    ms = {"before": [], "after": []}
    for k in ("before", "after", "after", "before"):
        ms[k].append(time_ms(b if k == "before" else a, 3, 20))
    print(f"    {what}: {nodes['before']} / {nodes['after']} kernels, "
          f"{np.mean(ms['before']):.4f} / {np.mean(ms['after']):.4f} ms "
          f"(in turns: before {ms['before']}, after {ms['after']})  "
          f"[{smi}]", flush=True)
    b.close()
    a.close()


def host_closed_loop(smi: str, device) -> None:
    """9c-9e: the sync and async controllers in closed loop on the card."""
    seconds = HOST_SECONDS
    sync_lines = {}
    for mpc_backend, wbc_backend in (("auto_mpc", "xla"),
                                     ("auto_mpc", "fused")):
        tag = backend_tag(mpc_backend, wbc_backend)
        cfg = host_cfg(mpc_backend, wbc_backend)
        reset_launch_counts()
        ctl = HostController(SOLO12, cfg, standing_q0(), device=device,
                             telemetry=True)
        plant = GraphPlant(ctl.tree, standing_q0(), device)
        at_capture = launch_counts()
        zmin, x_end, walls, boundary, taus = drive_host(ctl, seconds, device,
                                                        plant=plant)
        counts = launch_counts()
        rec = ctl.drain_telemetry(8192)
        ok_frac = float(rec[:, 2].mean()) if len(rec) else 0.0
        line = latency_line(walls, boundary)
        sync_lines[tag] = line
        print(f"  sync, {tag}: {seconds} s simulated: min z {zmin:.4f} m, "
              f"x {x_end:+.4f} m, plan_period {ctl.plan_period}, wbc ok "
              f"{ok_frac:.4f}; {line} (budget {TICK_BUDGET_MS} ms p50, not a "
              f"gate)  [{smi}]", flush=True)
        print(f"    launch counts after capture {at_capture}, after the run "
              f"{counts}", flush=True)
        check(zmin > 0.15 and x_end > 0.05 and ctl.plan_period > 0
              and ok_frac >= 0.99,
              f"sync, {tag}: upright (min z > 0.15), forward progress, plans "
              "consumed, wbc ok fraction >= 0.99")
        check(counts == at_capture,
              f"sync, {tag}: no kernel launched outside the graphs while "
              "running (counts unchanged since capture)")
        # 9e: the telemetry ring
        check(rec.shape == (len(taus), HostController.TELEM_LEN)
              and np.array_equal(rec[:, 0], np.arange(len(taus),
                                                      dtype=np.float32))
              and np.array_equal(rec[:, 3:], taus)
              and ctl._telem.dropped == 0,
              f"sync, {tag}: telemetry holds one record per tick with the "
              "returned torques, none dropped")
        del ctl
        torch.cuda.empty_cache()

    for mpc_backend, wbc_backend in (("auto_mpc", "xla"),
                                     ("auto_mpc", "fused")):
        tag = backend_tag(mpc_backend, wbc_backend)
        ctl = HostController(SOLO12, host_cfg(mpc_backend, wbc_backend),
                             standing_q0(), device=device, async_mpc=True)
        zmin, x_end, walls, boundary, _ = drive_host(ctl, seconds, device,
                                                     settle=0.0005)
        print(f"  async, {tag}: min z {zmin:.4f} m, x {x_end:+.4f} m, "
              f"plan_period {ctl.plan_period}; "
              f"{latency_line(walls, boundary)}  [{smi}]", flush=True)
        print(f"    sync beside it: {sync_lines[tag]}", flush=True)
        check(zmin > 0.15 and ctl.plan_period > 0,
              f"async, {tag}: upright, plans published by the planner "
              "thread consumed")
        del ctl
        torch.cuda.empty_cache()


def sharded_path(smi: str, device) -> None:
    """10: a one-rank NCCL group runs the sharded rollout; its summary
    against the same reductions of an unsharded rollout; entry()."""
    import torch.distributed as dist

    cfg = PRESETS["config2_gait_sweep"]
    with tempfile.TemporaryDirectory() as tmp:
        group = init_scenario_group(device, f"file://{tmp}/store", 0, 1)
        try:
            cc, ctl, plant, gid, _, cp = make_scenarios(cfg, SHARD_B, seed=3,
                                                        device=device)
            v = varied_commands(SHARD_B, seed=3)
            run = sharded_cascade_rollout(cc, 1, group=group, device=device)
            (_, plant_s, met_s, summary), wall = timed(
                lambda: run(ctl, plant, gid, v, cp))
            _, plant_u, met_u = cascade_rollout(cc, ctl, plant, gid, v, cp,
                                                n_periods=1, device=device)
        finally:
            dist.destroy_process_group()
    want = scenario_summary(met_u, lambda t, op: t)
    diffs = {k: abs(float(summary[k]) - float(want[k])) for k in want}
    same_q = torch.equal(plant_s.q, plant_u.q)
    print(f"  NCCL, 1 rank, B={SHARD_B}, 1 period in {wall:.2f} s: summary "
          + ", ".join(f"{k} {float(t):.6g}" for k, t in summary.items())
          + f"; |sharded - unsharded| {diffs}; plant q bit for bit "
          f"{same_q}  [{smi}]", flush=True)
    check(set(summary) == set(want) and all(d == 0.0 for d in diffs.values())
          and int(summary["n_total"]) == SHARD_B,
          "sharded rollout: the all-reduced summary equals the reductions of "
          "the unsharded rollout")
    fn, args = entry(device=device)
    x = fn(*args)
    torch.cuda.synchronize()
    print(f"  entry(): x_srb {tuple(x.shape)}, finite "
          f"{bool(torch.isfinite(x).all())}", flush=True)
    check(tuple(x.shape) == (8, 12) and bool(torch.isfinite(x).all()),
          "entry(): one cascade period on the card, finite output")
    try:
        dryrun_multichip(torch.cuda.device_count() + 1, device=device)
        refused = False
    except RuntimeError as e:
        refused = "cards" in str(e)
    check(refused, "dryrun_multichip(n, 'cuda') with fewer than n cards "
                   "raises")


# ------------------------------------- 11. the contract against the oracle

WBC_FIELDS = ("contacts", "f_mpc", "foot_pos_ref", "foot_vel_ref",
              "foot_acc_ref", "q_posture", "base_rpy_ref", "h_ref")
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def _oracle_worker_init() -> None:
    # below the main process, which drives the card from one core
    os.nice(10)
    torch.set_num_threads(1)


def start_oracle_pool():
    """A `spawn` pool of ORACLE_WORKERS processes, each on one BLAS/OpenMP
    thread (the variables are set for the children only).  The oracle is
    numpy: the workers never touch the card."""
    saved = {k: os.environ.get(k) for k in THREAD_VARS}
    os.environ.update(dict.fromkeys(THREAD_VARS, "1"))
    try:
        return multiprocessing.get_context("spawn").Pool(
            ORACLE_WORKERS, initializer=_oracle_worker_init)
    finally:
        for k, val in saved.items():
            if val is None:
                os.environ.pop(k)
            else:
                os.environ[k] = val


def oracle_mpc_problems(S: int, seed: int):
    """S MPC problems, S / 4 of each gait, planned by the oracle as
    tests/test_torch_mpc.py plans them: a random gait phase, the state
    perturbed (h +-0.01 m, v +-0.2 m/s, roll and pitch +-0.05), a command
    vx +-0.5, vy +-0.2, yaw rate +-0.5.  [(gait, phase, (x0, x_ref, feet,
    contacts))], the inputs rounded to float32 (the card's) and handed to
    the oracle as such: identical inputs on both sides."""
    cfg = EngineConfig()
    out = []
    for i in range(S):
        gait = ORACLE_GAITS[i % len(ORACLE_GAITS)]
        r = np.random.default_rng([seed, i])
        x0 = np.zeros(12)
        x0[2] = SOLO12.h_ref + r.normal() * 0.01
        x0[6:8] = r.normal(size=2) * 0.2
        x0[3:5] = r.normal(size=2) * 0.05
        vc = np.array([r.uniform(-0.5, 0.5), r.uniform(-0.2, 0.2),
                       r.uniform(-0.5, 0.5)])
        phase = int(r.integers(0, 16))
        sched = oplanner.GaitScheduler(GAITS[gait], phase=phase)
        feet0 = SOLO12.shoulder_offsets.copy()
        feet0[:, 2] = 0.0
        fsteps, _ = oplanner.plan_footsteps_horizon(
            SOLO12, cfg.mpc, cfg.cascade, sched, x0, vc, feet0)
        problem = (x0, ompc.reference_rollout(SOLO12, cfg.mpc, x0, vc),
                   fsteps, sched.horizon(cfg.mpc.horizon))
        out.append((gait, phase, tuple(
            np.asarray(a, np.float32).astype(np.float64) for a in problem)))
    return out


def oracle_mpc_solve(problem):
    """Pool worker: the oracle's solve_mpc; (x, seconds)."""
    cfg = EngineConfig()
    t0 = time.perf_counter()
    _, res = ompc.solve_mpc(SOLO12, cfg.mpc, cfg.solver, *problem)
    return res.x, time.perf_counter() - t0


def oracle_closed_loop(gait: str, ticks: int, record: int) -> dict:
    """Pool worker: the oracle's controller (the reference's
    Controller.compute() loop) on the oracle's simulator from standing, at
    the gait's ORACLE_CMD, for `ticks` ticks.  Keeps the first `record`
    ticks' (q, v, WBC references, WBC torque, applied torque) and the SRB
    state at every period start."""
    cfg = EngineConfig(gait=gait, v_ref=ORACLE_CMD[gait])
    q0 = standing(1)[0].astype(np.float64)
    ctl = ocascade.OracleController(SOLO12, cfg, q0)
    sim = osim.SimState.init(q0)
    wbc = []
    original = ocascade.solve_wbc

    def hook(tree, wcfg, q, v, refs, **kw):
        out = original(tree, wcfg, q, v, refs, **kw)
        wbc.append((refs, out[0].copy()))
        return out

    ocascade.solve_wbc = hook
    recorded, starts = [], []
    t0 = time.perf_counter()
    try:
        for k in range(ticks):
            cmd, log = ctl.compute(sim.q, sim.v)
            tau = cmd.torque(sim.q[7:], sim.v[6:])
            if k % cfg.cascade.mpc_every == 0:
                starts.append(log.x_srb)
            if k < record:
                recorded.append(dict(q=sim.q.copy(), v=sim.v.copy(),
                                     refs=wbc[-1][0], wbc_tau=wbc[-1][1],
                                     tau=tau))
            wbc.clear()
            sim, _ = osim.step(ctl.tree, sim, tau)
    finally:
        ocascade.solve_wbc = original
    return dict(ticks=recorded, starts=np.stack(starts),
                seconds=time.perf_counter() - t0)


def by_gait(d, gaits, fmt=".3e") -> str:
    """'gait max m (median m)' for each gait of per-scenario errors d."""
    return "; ".join(
        f"{g} max {np.max(d[gaits == g]):{fmt}} (median "
        f"{np.median(d[gaits == g]):{fmt}})" for g in ORACLE_GAITS)


# the plain versions of the whole-solve kernels (scaled x, y and D, E, c)
WHOLE_REFERENCE = {"admm_solve_fused": kernels.admm_solve_fused_reference,
                   "admm_solve_plain_warp": kernels.admm_solve_plain_reference}
# plain version and tolerance of each kernel whose launches phase 11 records
# (refined iterations on the WBC QP, which has equality rows: REFINED_EQ_TOL)
PLAIN_OF = {"admm_iterate_m2": (kernels.admm_iterate_m2_reference,
                                KERNEL_TOL),
            "admm_iterate_vpu": (kernels.admm_iterate_refined_reference,
                                 REFINED_EQ_TOL),
            "admm_iterate_vpu_packed": (
                kernels.admm_iterate_refined_reference, REFINED_EQ_TOL),
            "admm_iterate": (kernels.admm_iterate_reference, REFINED_EQ_TOL)}


@contextlib.contextmanager
def recorded_launches(log: list):
    """Inside, every kernel wrapper that `admm_solve` calls appends (name,
    inputs, keyword arguments, outputs) to `log`; the wrappers themselves
    (and their launch counts) are unchanged."""
    names = ("admm_iterate_m2", "admm_solve_fused", "admm_solve_plain_warp",
             "chol_inverse")
    saved = {k: getattr(admm_mod, k) for k in names}
    saved_iter = dict(admm_mod._ITERATION_KERNELS)

    def recording(fn):
        def call(*args, **kw):
            inputs = [a.clone() for a in args]
            out = fn(*args, **kw)
            outs = [out] if isinstance(out, torch.Tensor) else out
            log.append((fn.__name__, inputs, kw, [o.clone() for o in outs]))
            return out
        return call

    for k, fn in saved.items():
        setattr(admm_mod, k, recording(fn))
    for k, fn in saved_iter.items():
        admm_mod._ITERATION_KERNELS[k] = recording(fn)
    try:
        yield log
    finally:
        for k, fn in saved.items():
            setattr(admm_mod, k, fn)
        admm_mod._ITERATION_KERNELS.update(saved_iter)


def per_scenario(got, want) -> torch.Tensor:
    """(B,) max abs difference of each scenario over a list of tensors."""
    return torch.stack([(g.float() - w.float()).abs().reshape(len(g), -1)
                        .amax(dim=1) for g, w in zip(got, want)]).amax(dim=0)


def hold_launches(log: list, label: str, smi: str) -> None:
    """Every recorded launch against its plain version on the same inputs.

    Where the plain float32 version reproduces a float64 run of itself
    (median distance over the scenarios under the kernel's tolerance), the
    gates of phases 2-6: each scenario within the tolerance of the plain
    version wherever that version lies within it of float64, and each launch
    as close to float64 as the plain float32 version (largest over its
    scenarios, factor 2, plus a tenth of the tolerance; compare_m2).

    Where it does not, no two float32 summation orders agree either, and
    the distance to the plain version is printed, not held: on the oracle's
    WBC ticks with swing feet the 13 iterations of a round end a median
    0.29 (first round) to 0.05 (third) from a float64 run of the same map
    (measured on a CPU), and kernel and plain version differ by up to 10.
    There the kernel's distances to float64 must be distributed as the plain
    version's: their median within a factor 2 (plus a tenth of the
    tolerance).  Kernels 4 and A on their unscaled (x, y) in units of the
    tolerances x 1e-3, y 1e-2, their scales to 1e-4 relative, always.
    Kernel B by |I - K X|_F (float64) per matrix: the kernel's largest and
    median within twice the plain version's (plus 1e-6)."""
    by: dict = {}
    inverses = []
    for name, args, kw, got in log:
        if name == "chol_inverse":
            inverses.append((args[0], got[0]))
            continue
        args64 = [a.double() for a in args]
        ok = all_finite(got)
        if name in WHOLE_REFERENCE:
            def unscaled(xs, ys, D, E, c):
                return D * xs, E * ys / c[:, None]
            reference = WHOLE_REFERENCE[name]
            want = reference(*args, **kw)
            k, p = unscaled(*got), unscaled(*want)
            w64 = [t.float() for t in unscaled(*reference(*args64, **kw))]
            tols = (FUSED_X_TOL, FUSED_Y_TOL)
            err, k64, p64 = (
                torch.maximum(*[per_scenario([a], [b]) / t
                                for a, b, t in zip(u, v, tols)])
                for u, v in ((k, p), (k, w64), (p, w64)))
            ok &= max(float(((a - b).abs() / b.abs()).max())
                      for a, b in zip(got[2:], want[2:])) < FUSED_SCALE_RTOL
            tol = 1.0
        else:
            plain, tol = PLAIN_OF[name]
            want = plain(*args, **kw)
            want64 = [t.float() for t in plain(*args64, **kw)]
            err = per_scenario(got, want)
            k64, p64 = per_scenario(got, want64), per_scenario(want, want64)
        r = by.setdefault(name, dict(err=[], k64=[], p64=[], ok=True,
                                     max_rule=True, tol=tol))
        r["ok"] &= ok
        r["max_rule"] &= (float(k64.max())
                          <= 2.0 * float(p64.max()) + tol / 10)
        for key, val in (("err", err), ("k64", k64), ("p64", p64)):
            r[key].append(val.cpu())
    for name, r in by.items():
        tol = r["tol"]
        err, k64, p64 = (torch.cat(r[key]) for key in ("err", "k64", "p64"))
        med = {key: float(t.median()) for key, t in
               (("err", err), ("k64", k64), ("p64", p64))}
        held = p64 < tol
        over = int((held & (err >= tol)).sum())
        reproducible = med["p64"] < tol
        unit = (" (in units of the tolerances x 1e-3, y 1e-2)"
                if name in WHOLE_REFERENCE else f" (tolerance {tol:g})")
        print(f"  {label}: {len(r['err'])} launches of {name}, {len(err)} "
              f"scenarios, against the plain version on the same inputs"
              f"{unit}: |d| max {float(err.max()):.3e}, median "
              f"{med['err']:.3e}; distance to a float64 run: kernel max "
              f"{float(k64.max()):.3e} median {med['k64']:.3e}, plain max "
              f"{float(p64.max()):.3e} median {med['p64']:.3e}; "
              f"{int(held.sum())} scenarios where the plain version lies "
              f"within the tolerance of float64, {over} of them over  "
              f"[{smi}]", flush=True)
        if reproducible:
            check(r["ok"] and r["max_rule"] and over == 0,
                  f"{label}: every launch of {name} within {tol:g} of its "
                  "plain version wherever that is within it of float64, and "
                  "as close to float64 as the plain float32 version")
        else:
            check(r["ok"] and med["k64"] <= 2.0 * med["p64"] + tol / 10,
                  f"{label}: {name}'s launches as close to float64 as its "
                  "plain float32 version's (medians; the plain version does "
                  "not reproduce float64 on these inputs)")
    if inverses:
        hold_inverses(inverses, f"{label}: {len(inverses)} launches of "
                                "chol_inverse", smi)


def inverse_residual(K, X) -> torch.Tensor:
    """(B,) |I - K X|_F in float64."""
    eye = torch.eye(K.shape[-1], dtype=torch.float64, device=K.device)
    return (eye - K.double() @ X.double()).flatten(1).norm(dim=1)


def hold_inverses(pairs, label: str, smi: str) -> float:
    """Kernel B's outputs X of (K, X) `pairs` against the plain version
    (blockinv.spd_inverse_chol) on the same K: |I - K X|_F in float64, the
    kernel's largest and median within twice the plain version's plus 1e-6;
    finite wherever the plain version is.  Returns the largest
    max|X - X_plain| / max|X_plain| over the matrices."""
    rk, rp, rel, ok = [], [], 0.0, True
    for K, X in pairs:
        want = spd_inverse_chol(K, ns_steps=1)
        rk.append(inverse_residual(K, X).cpu())
        rp.append(inverse_residual(K, want).cpu())
        fin = torch.isfinite(want).flatten(1).all(dim=1)
        ok &= bool(torch.isfinite(X).flatten(1).all(dim=1)[fin].all())
        scale = want.abs().flatten(1).amax(dim=1).clamp_min(1e-30)
        d = (X - want).abs().flatten(1).amax(dim=1) / scale
        rel = max(rel, float(d[fin].max()) if bool(fin.any()) else 0.0)
    rk, rp = torch.cat(rk), torch.cat(rp)
    print(f"  {label}, {len(rk)} matrices: |I - K X| (float64) kernel max "
          f"{float(rk.max()):.3e} median {float(rk.median()):.3e}; plain max "
          f"{float(rp.max()):.3e} median {float(rp.median()):.3e}; max "
          f"|X - X_plain| / max |X_plain| {rel:.3e}  [{smi}]", flush=True)
    check(ok and float(rk.max()) <= 2.0 * float(rp.max()) + 1e-6
          and float(rk.median()) <= 2.0 * float(rp.median()) + 1e-6,
          f"{label}: |I - K X| within twice the plain version's (largest "
          "and median), finite wherever it is finite")
    return rel


def over_lines(x, x_o, problems, over) -> None:
    for i in over[:5]:
        c = np.argsort(-np.abs(x[i] - x_o[i]))[:3]
        where = [(int(j // 12), int(j % 12 // 3), int(j % 3)) for j in c]
        print(f"    over: {problems[i][0]}, phase {problems[i][1]}, "
              f"coordinates (step, foot, axis) {where} off by "
              f"{np.round(x[i, c] - x_o[i, c], 7).tolist()}", flush=True)


def oracle_mpc_contract(problems, pending, smi: str, device) -> None:
    """11a: the port's MPC contract tier (mpc/srb.py::solve_mpc_contract)
    on the card against the oracle's solve_mpc on ORACLE_S problems of four
    gaits; the float32 build_mpc_qp with the same solve beside it."""
    cfg = EngineConfig()
    S = len(problems)
    gaits = np.array([p[0] for p in problems])
    inputs = [torch.tensor(np.stack([p[2][i] for p in problems]),
                           dtype=torch.float32).to(device) for i in range(4)]
    sols, secs, log = {}, {}, []
    with recorded_launches(log):
        for backend in ("torch", "m2"):
            (_, sol), sec = timed(lambda: solve_mpc_contract(
                SOLO12, cfg.mpc, *inputs, backend=backend))
            sols["contract", backend] = sol
            secs["contract", backend] = sec
        qp32, secs["float32"] = timed(
            lambda: build_mpc_qp(SOLO12, cfg.mpc, *inputs))
        for backend in ("torch", "m2"):
            sols["float32", backend], secs["float32", backend] = timed(
                lambda: admm_solve(*qp32, backend=backend, **CONTRACT_BUDGET))
        sol, secs["in-loop"] = timed(lambda: admm_solve(
            *qp32, backend="m2", **INLOOP_MPC))
    x_inloop = sol.x.double().cpu().numpy()
    hold_launches(log, "11a", smi)
    del log

    # the QP matrices of the first problems against the oracle's: the
    # float32 assembly and the contract tier's (float64, rounded once)
    k = ORACLE_QP_CHECKED
    qps = {"float32": [t[:k] for t in qp32],
           "contract": [t.float() for t in build_mpc_qp(
               SOLO12, cfg.mpc, *(t[:k].double() for t in inputs))]}
    worst = {a: [0.0] * 3 for a in qps}
    qp_ok = {a: True for a in qps}
    for i in range(k):
        Po, qo, Ao, lo, uo = ompc.build_mpc_qp(SOLO12, cfg.mpc,
                                               *problems[i][2])
        stance = np.repeat(problems[i][2][3].reshape(-1) > 0.5, 5)
        pinned = np.repeat(problems[i][2][3].reshape(-1) < 0.5, 3)
        off = ~np.eye(len(qo), dtype=bool)
        f32 = lambda a: a.astype(np.float32).astype(np.float64)  # noqa: E731
        for a, qp in qps.items():
            P, q, A, l, u = [t[i].double().cpu().numpy() for t in qp]
            dP = P - Po
            dq = float(np.abs(q - qo).max())
            dPo = float(np.abs(dP[off]).max())
            dPd = float(np.abs(np.diagonal(dP)[~pinned]).max())
            worst[a] = [max(w, d) for w, d in zip(worst[a], (dq, dPo, dPd))]
            qp_ok[a] &= bool(
                dq < 1e-5 and dPo < 1e-5 and dPd < 1e-5
                and (np.diagonal(dP)[pinned] > 1e5).all()
                and np.array_equal(A, f32(Ao))
                and np.array_equal(l[stance], f32(lo[stance]))
                and np.array_equal(u[stance], f32(uo[stance]))
                and (l[~stance] < -1e19).all() and (u[~stance] > 1e19).all())
    for a in qps:
        print(f"  QP of the first {k} problems, {a} assembly, against the "
              f"oracle's: max |dq| {worst[a][0]:.3e}, |dP| off the diagonal "
              f"{worst[a][1]:.3e}, on the unpinned diagonal "
              f"{worst[a][2]:.3e}  [{smi}]", flush=True)
        check(qp_ok[a], f"11a: {a}-assembled QP within the CPU test's "
                        "budgets of the oracle's (q, P 1e-5; A, stance "
                        "bounds exact; swing rows free, swing forces on the "
                        "ridge)")

    results = pending.get()           # a worker that raised raises here
    x_o = np.stack([r[0] for r in results])
    oracle_s = np.array([r[1] for r in results])
    for (tier, backend), sol in sols.items():
        x = sol.x.double().cpu().numpy()
        d = np.abs(x - x_o).max(axis=1)
        over = np.flatnonzero(d >= CONTRACT_TOL)
        extra = ("solve_mpc_contract" if tier == "contract" else
                 f"float32 build_mpc_qp + the same solve, + "
                 f"{secs['float32'] / S * 1e3:.4f} ms assembly")
        print(f"  {extra}, backend {backend}: max over S={S} "
              f"{d.max():.3e}, {len(over)} over {CONTRACT_TOL:g}; "
              f"{by_gait(d, gaits)}; {secs[tier, backend] / S * 1e3:.4f} ms "
              f"per problem  [{smi}]", flush=True)
        over_lines(x, x_o, problems, over)
        if tier == "contract":
            check(bool(sol.ok.all()) and sol.x.dtype == torch.float32
                  and float(d.max()) < CONTRACT_TOL,
                  f"11a: solve_mpc_contract, backend {backend}: every one "
                  f"of {S} problems within {CONTRACT_TOL:g} of the oracle's "
                  "solve_mpc")
        elif len(over):
            print(f"    the float32 assembly misses {CONTRACT_TOL:g} on "
                  f"{len(over)} of {S}: a standing shortfall (ROADMAP "
                  "queue 3), not a gate", flush=True)
    d = np.abs(x_inloop - x_o).max(axis=1)
    print(f"  in-loop budget (60 iterations in 2 rounds, kernel 1, float32 "
          f"assembly, no polish): {by_gait(d, gaits)}; "
          f"{secs['in-loop'] / S * 1e3:.4f} ms per solve (not a gate)",
          flush=True)
    print(f"  the oracle's solve_mpc: {oracle_s.mean() * 1e3:.2f} ms per "
          f"solve (median {np.median(oracle_s) * 1e3:.2f}) on one core of "
          f"this host, {ORACLE_WORKERS} workers", flush=True)


def _oracle_tick(runs, k: int, dtype, device):
    """Tick k of every gait's oracle run as one batch of four scenarios:
    (q, v, refs, the oracle's WBC torques)."""
    pick = [runs[g]["ticks"][k] for g in ORACLE_GAITS]

    def put(a):
        return torch.tensor(np.stack(a), dtype=dtype).to(device)

    refs = WbcRefs(**{f: put([np.asarray(getattr(p["refs"], f), np.float64)
                              for p in pick]) for f in WBC_FIELDS})
    return (put([p["q"] for p in pick]), put([p["v"] for p in pick]), refs,
            np.stack([p["wbc_tau"] for p in pick]))


def gait_line(errs) -> str:
    return ", ".join(f"{g} {e:.3e}" for g, e in zip(ORACLE_GAITS, errs))


def oracle_wbc_contract(runs, smi: str, device) -> None:
    """11b: the oracle cascade's first ORACLE_TICKS ticks of each gait, the
    four gaits as one batch on the card, warm-started tick to tick."""
    cfg = EngineConfig()
    tree = CascadeConfigured(SOLO12, cfg).tree
    wx = wy = None
    errs, ok = [], True
    torch.cuda.synchronize()
    t0 = time.time()
    for k in range(ORACLE_TICKS):
        q, v, refs, tau_o = _oracle_tick(runs, k, torch.float64, device)
        tau, _, _, sol = solve_wbc_contract(tree, cfg.wbc, q, v, refs,
                                            warm_x=wx, warm_y=wy)
        ok &= bool(sol.ok.all()) and tau.dtype == torch.float64
        wx, wy = sol.x, sol.y
        errs.append(np.abs(tau.cpu().numpy() - tau_o).max(axis=1))
    torch.cuda.synchronize()
    worst = np.max(errs, axis=0)
    print(f"  solve_wbc_contract (float64, {CONTRACT_ITERS} iterations, "
          f"polished): max |tau - tau_oracle| per gait {gait_line(worst)} "
          f"Nm over {ORACLE_TICKS} ticks; "
          f"{(time.time() - t0) / ORACLE_TICKS * 1e3:.1f} ms a tick at B = 4"
          f"  [{smi}]", flush=True)
    check(ok and float(worst.max()) < CONTRACT_TOL,
          f"11b: solve_wbc_contract within {CONTRACT_TOL:g} Nm of the oracle "
          "on every tick of every gait")
    reset_launch_counts()
    expect = dict.fromkeys(COUNTED, 0)
    log: list = []
    trot = ORACLE_GAITS.index("trot")
    for backend in WBC_INLOOP_BACKENDS:
        wx = torch.zeros((4, 30), device=device)
        wy = torch.zeros((4, 50), device=device)
        errs, ok = [], True
        with recorded_launches(log):
            for k in range(ORACLE_TICKS):
                q, v, refs, tau_o = _oracle_tick(runs, k, torch.float32,
                                                 device)
                tau, _, _, sol = solve_wbc(
                    tree, cfg.wbc, q, v, refs, iters=cfg.solver.wbc_iters,
                    adapt_rounds=cfg.solver.wbc_adapt_rounds, warm_x=wx,
                    warm_y=wy, backend=backend)
                ok &= bool(sol.ok.all()) and bool(torch.isfinite(tau).all())
                wx = torch.where(sol.ok[:, None], sol.x, wx)
                wy = torch.where(sol.ok[:, None], sol.y, wy)
                errs.append(np.abs(tau.double().cpu().numpy()
                                   - tau_o).max(1))
        worst = np.max(errs, axis=0)
        print(f"  in-loop float32 WBC ({cfg.solver.wbc_iters} iterations in "
              f"{cfg.solver.wbc_adapt_rounds} rounds), backend {backend}: "
              f"max |tau - tau_oracle| {gait_line(worst)} Nm; over "
              f"{TAU_TOL:g} on "
              f"{[g for g, w in zip(ORACLE_GAITS, worst) if w > TAU_TOL]} "
              f"(off trot: a standing shortfall, ROADMAP queue 3)  [{smi}]",
              flush=True)
        check(ok and worst[trot] < TAU_TOL,
              f"11b: in-loop WBC on {backend}: every solve ok, trot within "
              f"{TAU_TOL:g} Nm of the oracle on every tick")
        per_tick = (1 if backend in WHOLE_SOLVE
                    else cfg.solver.wbc_adapt_rounds)
        expect[WBC_KERNEL_OF[backend]] += ORACLE_TICKS * per_tick
        if backend not in WHOLE_SOLVE:
            expect["chol_inverse"] += ORACLE_TICKS * per_tick
            expect["ruiz_equilibrate"] += ORACLE_TICKS
        expect["wbc_build"] += ORACLE_TICKS
    counts = launch_counts()
    print(f"    launches {counts}", flush=True)
    check(counts == expect, f"11b: the WBC solve kernels (A, B, 2-5), Ruiz "
                            f"and the WBC build launched {expect}")
    hold_launches(log, "11b", smi)


def oracle_host_contract(runs, smi: str, device) -> None:
    """11c: the captured host controllers fed each gait's oracle (q, v)
    sequence: their torques against the oracle controller's, and their
    consumed MPC plans against a controller on the plain MPC backend."""
    plain_plans = {}
    for gait, mpc_backend, wbc_backend in (
            [(g, "torch", "xla") for g in ORACLE_GAITS] + list(ORACLE_HOSTS)):
        cfg = EngineConfig(gait=gait, v_ref=ORACLE_CMD[gait])
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, mpc_backend=mpc_backend, wbc_backend=wbc_backend))
        seq = runs[gait]["ticks"]
        ctl = HostController(SOLO12, cfg, seq[0]["q"], device=device)
        taus, plans = [], []
        try:
            for t in seq:
                taus.append(ctl.compute(t["q"], t["v"]))
                plans.append(ctl.f_plan.copy())
        finally:
            ctl.close()
        del ctl
        torch.cuda.empty_cache()
        taus, plans = np.stack(taus), np.stack(plans)
        if mpc_backend == "torch":
            plain_plans[gait] = plans
            continue
        d = np.abs(taus - np.stack([t["tau"] for t in seq])).max(axis=1)
        dp = float(np.abs(plans - plain_plans[gait]).max())
        print(f"  host path, {gait}, {backend_tag(mpc_backend, wbc_backend)}"
              f": max |tau - tau_oracle| {d.max():.3e} Nm (tick "
              f"{int(d.argmax())}, median {np.median(d):.3e}); consumed "
              f"plans against the plain MPC backend's {dp:.3e} N  [{smi}]",
              flush=True)
        check(bool(np.isfinite(taus).all()) and dp < PLAN_TOL,
              f"11c: host path ({gait}, {mpc_backend}/{wbc_backend}): "
              f"finite torques, plans within {PLAN_TOL:g} N of the plain "
              "MPC backend's on every tick")
        if gait == "trot":
            check(float(d.max()) < TAU_TOL,
                  f"11c: host path (trot, {wbc_backend}) within {TAU_TOL:g} "
                  "Nm of the oracle controller on every tick")
        elif d.max() >= TAU_TOL:
            print(f"    over {TAU_TOL:g} Nm: a standing shortfall of the "
                  "in-loop WBC budget (ROADMAP queue 3), not a gate",
                  flush=True)


def oracle_long_horizon(long_runs, smi: str, device) -> None:
    """11d: config4_cascade_4k at full width for LONG_PERIODS periods, rows
    0-3 one gait each at ORACLE_CMD and friction 0.7, the other rows mixed
    as the sweep draws them; rows 0-3 against the oracle's closed loop."""
    cfg = PRESETS["config4_cascade_4k"]
    B = cfg.batch
    cc = CascadeConfigured(SOLO12, cfg)
    gid, v, mu, _ = scenario_params(11, np.arange(B))
    for b, gait in enumerate(("walk", "bound", "pace", "trot")):
        gid[b], v[b], mu[b] = GAIT_IDS[gait], ORACLE_CMD[gait], 0.7
    q0 = standing(B)
    ctl = init_controller(SOLO12, cfg, cc.tree, q0, gid, device=device)
    plant = PlantState.init(q0, device=device)
    cp = ContactParams.default(B, device=device)
    cp.mu = torch.as_tensor(mu, dtype=torch.float32).to(device)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.time()
    ctl, plant, met = cascade_rollout(cc, ctl, plant, gid, v, cp,
                                      n_periods=LONG_PERIODS, device=device)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    expect = expected_launches(cfg, LONG_PERIODS, cfg.solver.wbc_backend)[1]
    x = met["x_srb"].double().cpu().numpy()
    upright = (x[:, :, 2] > 0.12).all(axis=1)
    print(f"  B={B}, {LONG_PERIODS} periods: {wall:.1f} s "
          f"({wall / LONG_PERIODS:.3f} s per period), launches {counts}; "
          f"upright {upright.mean():.4f}, mpc_ok "
          f"{float(met['mpc_ok'].float().mean()):.4f}  [{smi}]", flush=True)
    check(all_finite((plant.q, plant.v, met["x_srb"]))
          and bool(met["mpc_ok"].all()) and bool(upright.all()),
          f"11d: all {B} rows finite, every MPC solve ok, upright (height > "
          f"0.12 m at every period start) for {LONG_PERIODS} periods")
    check(counts == expect, f"11d: kernel launches are {expect}")
    for b, gait in enumerate(("walk", "bound", "pace", "trot")):
        xo = long_runs[gait].get()["starts"]
        xp = x[b]
        min_z, max_rp, min_x = GAIT_BOUNDS[gait]
        dx = abs(xp[-1, 0] - xo[-1, 0])
        print(f"  {gait} at {ORACLE_CMD[gait][0]} m/s: x {xp[-1, 0]:.4f} m "
              f"(oracle {xo[-1, 0]:.4f}, |dx| {dx:.2e}); min height "
              f"{xp[:, 2].min():.4f} m (oracle {xo[:, 2].min():.4f}); max "
              f"|roll|, |pitch| {np.abs(xp[:, 3:5]).max():.4f} (oracle "
              f"{np.abs(xo[:, 3:5]).max():.4f}); mean vx "
              f"{xp[:, 6].mean():.4f} m/s (oracle {xo[:, 6].mean():.4f})",
              flush=True)
        check(xp[:, 2].min() > min_z and np.abs(xp[:, 3:5]).max() < max_rp
              and (min_x is None or xp[-1, 0] > min_x),
              f"11d: {gait} row holds the JAX package's bounds (height > "
              f"{min_z}, roll/pitch < {max_rp}"
              + ("" if min_x is None else f", x > {min_x}") + ")")
        check(dx < LONG_X_BAND, f"11d: {gait} row's x within {LONG_X_BAND} "
                                f"m of the oracle's after {LONG_PERIODS} "
                                "periods")


def oracle_contract(smi: str, device) -> None:
    """Phase 11: the pool solves and rolls the oracle while the card
    works; whatever a worker raises is raised here."""
    problems = oracle_mpc_problems(ORACLE_S, seed=11)
    ticks = LONG_PERIODS * EngineConfig().cascade.mpc_every
    with start_oracle_pool() as pool:
        t_pool = time.time()
        long_runs = {g: pool.apply_async(oracle_closed_loop, (g, ticks, 0))
                     for g in ORACLE_GAITS}
        short_runs = {g: pool.apply_async(oracle_closed_loop,
                                          (g, ORACLE_TICKS, ORACLE_TICKS))
                      for g in ORACLE_GAITS}
        solves = pool.map_async(oracle_mpc_solve, [p[2] for p in problems],
                                chunksize=8)
        print(f"== 11a. polished MPC tier vs the oracle's solve_mpc, "
              f"S={ORACLE_S} (trot, walk, bound, pace)", flush=True)
        oracle_mpc_contract(problems, solves, smi, device)
        runs = {g: r.get() for g, r in short_runs.items()}
        print(f"== 11b. WBC tiers vs the oracle cascade, {ORACLE_TICKS} "
              "ticks per gait, B=4", flush=True)
        oracle_wbc_contract(runs, smi, device)
        print("== 11c. host path (captured graphs) vs the oracle controller",
              flush=True)
        oracle_host_contract(runs, smi, device)
        print(f"== 11d. {LONG_PERIODS} periods at full width vs the "
              "oracle's closed loop", flush=True)
        oracle_long_horizon(long_runs, smi, device)
        pool.close()
        pool.join()
        secs = {g: round(r.get()["seconds"], 2) for g, r in long_runs.items()}
        print(f"  the oracle's pool ({ORACLE_WORKERS} workers) done "
              f"{time.time() - t_pool:.1f} s after it started; the "
              f"{LONG_PERIODS}-period closed loops took {secs} s each",
              flush=True)


# ------------------------------- 12. the batched period as one CUDA graph

def flat_state(ctl, plant, est=None, metrics=None) -> dict:
    """{"ctl.phase": tensor, ..., "metric.x_srb": tensor, ...}."""
    out = {}
    for prefix, st in (("ctl", ctl), ("plant", plant), ("est", est)):
        if st is not None:
            out.update({f"{prefix}.{f.name}": getattr(st, f.name)
                        for f in dataclasses.fields(st)})
    out.update({f"metric.{k}": t for k, t in (metrics or {}).items()})
    return out


def bit_diff(got: dict, want: dict) -> tuple[float, bool]:
    """(the largest |got - want| over every tensor of `want`, NaN counted as
    inf; whether every tensor is equal bit for bit)."""
    worst, bitwise = 0.0, True
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            return float("inf"), False
        if g.dtype == torch.float32:
            bitwise &= bool(torch.equal(g.view(torch.int32),
                                        w.view(torch.int32)))
        else:
            bitwise &= bool(torch.equal(g, w))
        if g.numel():
            d = float((g.double() - w.double()).abs().max())
            worst = max(worst, d if d == d else float("inf"))
    return worst, bitwise


def timed_ms(fn, reps: int = GRAPH_TIMED) -> list:
    """Wall ms of `reps` calls of fn, each ended by a synchronize."""
    return [timed(fn)[1] * 1e3 for _ in range(reps)]


def expected_per_replay(cfg, wbc_backend, mpc_backend=None) -> dict:
    """{kernel prefix: launches} of one period of this configuration."""
    per = expected_launches(cfg, 1, wbc_backend, mpc_backend)[1]
    return {KERNEL_PREFIX[name]: n for name, n in per.items()}


def graphed_period(rec: EagerRecord, cfg, smi: str, device) -> dict:
    """12a-12c for one of phase 4's configurations at full width: capture
    from the rollout's initial state; replay every period from the eager
    state of the period before and hold state and metrics against eager;
    the 3-period chain through cascade_rollout_graphed; the kernels in one
    replay; times.  Returns {kernel prefix: launches in one replay}."""
    tag = rec.tag
    ctl0, plant0, est0 = rec.states[0]
    clear_runners()
    torch.cuda.empty_cache()
    reset_launch_counts()
    runner = period_runner(rec.cc, ctl0, plant0, rec.gid, rec.cp, est=est0,
                           use_estimator=rec.use_estimator, device=device,
                           **rec.solver_kw)
    at_capture = launch_counts()
    per_period = expected_launches(cfg, 1, rec.solver_kw["wbc_backend"],
                                   rec.solver_kw["mpc_backend"])[1]
    check(at_capture == {k: 2 * n for k, n in per_period.items()},
          f"12, {tag}: launch counters moved by two periods' launches (the "
          "warm-up and the capture)")
    # 12a: each period from the eager state of the period before
    worst, bitwise = 0.0, True
    for k in range(ROLLOUT_PERIODS):
        c, p, e = rec.states[k]
        runner.load(c, p, rec.gid, rec.cp, est=e)
        out = runner(rec.v)
        got = flat_state(*runner.state(), metrics=out)
        want = flat_state(*rec.states[k + 1], metrics=rec.metrics[k])
        d, b = bit_diff(got, want)
        worst, bitwise = max(worst, d), bitwise and b
    # the chain, through the entry point (the runner is cached)
    ctl_g, plant_g, met_g = cascade_rollout_graphed(
        rec.cc, ctl0, plant0, rec.gid, rec.v, rec.cp,
        n_periods=ROLLOUT_PERIODS, est=est0, use_estimator=rec.use_estimator,
        device=device, **rec.solver_kw)
    eager_met = {k: torch.stack([m[k] for m in rec.metrics], dim=1)
                 for k in rec.metrics[0]}
    ctl_e, plant_e, _ = rec.states[-1]
    chain, chain_bits = bit_diff(flat_state(ctl_g, plant_g, metrics=met_g),
                                 flat_state(ctl_e, plant_e,
                                            metrics=eager_met))
    print(f"  {tag}: captured in {runner.call.capture_seconds:.2f} s, "
          f"pool {runner.call.pool_bytes / 2**30:.3f} GiB; {ROLLOUT_PERIODS} "
          f"periods each from eager's state: max |graph - eager| {worst:.3e}, bit "
          f"for bit {bitwise}; the {ROLLOUT_PERIODS}-period chain "
          f"(cascade_rollout_graphed): {chain:.3e}, bit for bit "
          f"{chain_bits}", flush=True)
    check(worst <= GRAPH_TOL and chain <= GRAPH_TOL,
          f"12, {tag}: every replayed period and the chain within "
          f"{GRAPH_TOL} of eager (state and metrics)")
    check(launch_counts() == at_capture,
          f"12, {tag}: nothing launched outside the graph while replaying")
    # 12b: the kernels inside one replay
    counts, nodes, port_ms, busy_ms, copies = kernels_per_replay(
        lambda: runner(rec.v))
    want = expected_per_replay(cfg, rec.solver_kw["wbc_backend"],
                               rec.solver_kw["mpc_backend"])
    # 12c: times, each ended by a synchronize
    graph_ms = timed_ms(lambda: runner(rec.v))
    eager_ms = [w * 1e3 for w in rec.walls]
    g_med = float(np.median(graph_ms))
    print(f"    one replay: {nodes} kernels + {copies} copies/memsets, the "
          f"port's {({p: c for p, c in counts.items() if c})}, their device "
          f"ms {({p: round(t, 3) for p, t in port_ms.items() if t})}; "
          f"device busy {busy_ms:.3f} ms", flush=True)
    print(f"    Ruiz in the period: "
          f"{port_ms[KERNEL_PREFIX['ruiz_equilibrate']]:.3f} device ms "
          "(the first design, a block per scenario, at B = 4096: 3.151 on "
          "the default period, 7.44 on packed / vpu)", flush=True)
    print(f"    period wall ms, median of {len(graph_ms)}: eager "
          f"{float(np.median(eager_ms)):.3f} ({eager_ms}), graphed "
          f"{g_med:.3f} ({graph_ms}); device idle share of a graphed "
          f"period {1.0 - busy_ms / g_med:.4f}  [{smi}]", flush=True)
    check(counts == want, f"12, {tag}: one replay launches {want}, an "
                          "eager period's launches")
    runner = None
    clear_runners()
    torch.cuda.empty_cache()
    return counts


def graphed_times(cfg, B: int, wbc_backend: str, smi: str, device) -> None:
    """12d: eager and graphed period wall times at batch B (median of
    GRAPH_TIMED, each ended by a synchronize), and the chained final state
    held against eager."""
    cc, ctl, plant, gid, v, cp = make_scenarios(cfg, B, seed=4,
                                                device=device)
    gid_t = torch.as_tensor(gid).to(device)
    v_t = torch.as_tensor(v).to(device)
    eager_ms, c, p = [], ctl, plant
    for _ in range(GRAPH_TIMED):
        (c, p, _), wall = timed(lambda: cascade_rollout(
            cc, c, p, gid, v, cp, n_periods=1, device=device,
            wbc_backend=wbc_backend))
        eager_ms.append(wall * 1e3)
    clear_runners()
    torch.cuda.empty_cache()
    runner = period_runner(cc, ctl, plant, gid_t, cp, device=device,
                           wbc_backend=wbc_backend)
    runner.load(ctl, plant, gid_t, cp)
    graph_ms = timed_ms(lambda: runner(v_t))
    c_g, p_g, _ = runner.state()
    d, bits = bit_diff(flat_state(c_g, p_g), flat_state(c, p))
    print(f"  B={B}, wbc_backend={wbc_backend}: period wall ms, median of "
          f"{GRAPH_TIMED}: eager {float(np.median(eager_ms)):.3f} "
          f"({eager_ms}), graphed {float(np.median(graph_ms)):.3f} "
          f"({graph_ms}); capture {runner.call.capture_seconds:.2f} s, pool "
          f"{runner.call.pool_bytes / 2**30:.3f} GiB; after {GRAPH_TIMED} "
          f"periods max |graph - eager| {d:.3e}, bit for bit {bits}  "
          f"[{smi}]", flush=True)
    check(d <= GRAPH_TOL, f"12d, B={B}, {wbc_backend}: {GRAPH_TIMED} "
                          f"replayed periods within {GRAPH_TOL} of eager")
    runner = None
    clear_runners()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- 13. bench

# the JAX package's records, which the port's bench must leave as they are
BENCH_RECORDS = ("RESULTS.md", "BENCH_DETAIL.json", "MULTIHOST_32K.json")


def record_digests() -> dict:
    root = os.path.dirname(os.path.abspath(__file__))
    digests = {}
    for name in BENCH_RECORDS:
        with open(os.path.join(root, name), "rb") as f:
            digests[name] = hashlib.sha256(f.read()).hexdigest()
    return digests


def counted_call(fn, *args, **kw):
    """(fn's result, {kernel: launches} of the wrappers' counters over the
    call, set to 0 just before it)."""
    reset_launch_counts()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, launch_counts()


def numbers(d) -> list:
    """Every int or float value of a (nested) dict of a bench row."""
    out = []
    for v in d.values():
        if isinstance(v, dict):
            out += numbers(v)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out.append(float(v))
    return out


def guards_hold(row: dict, where: str) -> None:
    check(all(math.isfinite(v) for v in numbers(row))
          and row["upright_frac"] == 1.0 and row["mpc_fail_frac"] == 0.0
          and row["wbc_ok_frac"] >= 0.99,
          f"{where}: every value finite, upright_frac 1.0, mpc_fail_frac "
          "0.0, wbc_ok_frac >= 0.99")


def bench_phase(smi: str, device, reports: dict) -> None:
    """13a-13d; adds each kernel's `bench_launches` to `reports`."""
    by_function = {name: {} for name in COUNTED}

    def note(function: str, counts: dict) -> None:
        for name, n in counts.items():
            if n:
                by_function[name][function] = n

    chains = {}

    def inspect(name, call):
        chains[name] = kernels_per_replay(call, replays=3)[0]

    def nonzero(counts):
        return {k: n for k, n in counts.items() if n}

    m2, vpu, fused, mma = (KERNEL_PREFIX[k] for k in (
        "admm_iterate_m2", "admm_iterate_vpu", "admm_solve_fused",
        "admm_iterate"))
    before = record_digests()
    with tempfile.TemporaryDirectory() as out:
        clear_runners()
        torch.cuda.empty_cache()
        t0 = time.time()
        row, counts = counted_call(bench.headline, device=device)
        note("headline", counts)
        print(f"  13a headline ({time.time() - t0:.1f} s): {json.dumps(row)}"
              f"  [{smi}]", flush=True)
        guards_hold(row, "13a headline")
        (runner,) = cached_runners()
        per = kernels_per_replay(lambda: runner(runner.buffers["v_cmd"]))[0]
        print(f"    the port's kernels in one replay of the headline's graph: "
              f"{nonzero(per)}", flush=True)
        check(per[m2] == 2, "13a: kernel 1 twice in one replay of the "
                            "headline's graph")
        check(per[KERNEL_PREFIX["wbc_build"]] == 20
              and per[KERNEL_PREFIX["plant_step"]] == 20,
              "13a: the WBC build and the plant step once a tick in one "
              "replay of the headline's graph")
        runner = None
        clear_runners()
        torch.cuda.empty_cache()

        t0 = time.time()
        lat, counts = counted_call(bench.measure_latency, device,
                                   inspect=inspect)
        note("measure_latency", counts)
        print(f"  13b measure_latency ({time.time() - t0:.1f} s): "
              f"{json.dumps(lat)}  [{smi}]", flush=True)
        print(f"    the port's kernels in one replay of each MPC chain: "
              f"{ {k: nonzero(c) for k, c in chains.items()} }", flush=True)
        times = [lat["tick_ms_p50"], lat["mpc_solve_ms_p50"],
                 lat["e2e_dispatch_ms_p50"], *lat["mpc_ms_by_backend"].values()]
        check(set(lat["mpc_ms_by_backend"]) == set(bench.CARD_MPC_BACKENDS)
              and all(math.isfinite(t) and t > 0 for t in times),
              "13b: every time finite and positive, every backend timed")
        check(all(chains.get(f"measure_latency:{be}", {}).get(k, 0) > 0
                  for be, k in (("auto_mpc", m2), ("pallas_vpu", vpu),
                                ("fused", fused))),
              "13b: kernels 1, 2 and 4 each launched inside their chain's "
              "replay")
        clear_runners()
        torch.cuda.empty_cache()

        t0 = time.time()
        host, counts = counted_call(bench.measure_host_loop, device=device)
        note("measure_host_loop", counts)
        print(f"  13c measure_host_loop ({time.time() - t0:.1f} s): "
              f"{json.dumps(host)}  [{smi}]", flush=True)
        check(all(math.isfinite(v) for v in numbers(host))
              and host["host_loop_hz"] > 0, "13c: the host loop ran, every "
                                            "value finite")

        t0 = time.time()
        chains.clear()
        rows, counts = counted_call(bench.run_presets, device,
                                    inspect=inspect)
        note("run_presets", counts)
        bench.write_results({"config": "headline_B1024_trot", **row}, rows,
                            out, device)
        print(f"  13d run_presets + write_results ({time.time() - t0:.1f} s)"
              f"  [{smi}]", flush=True)
        for r in rows:
            print(f"    {json.dumps(r)}", flush=True)
        by_config = {r["config"]: r for r in rows}
        check(not any("FAILED" in r["metric"] for r in rows)
              and "host_loop_error" not in by_config["config1_trot_single"],
              "13d: no row FAILED, no host_loop_error")
        guards_hold(by_config["config4_cascade_4k"], "13d config4")
        for name in ("config2_gait_sweep", "config3_robustness"):
            print(f"    {name}: upright_frac "
                  f"{by_config[name]['upright_frac']} (printed, not gated)")
            check(all(math.isfinite(v) for v in numbers(by_config[name])),
                  f"13d {name}: every value finite")
        (sharded,) = [r for r in rows if r["config"].startswith(
            "config5_sharded")]
        check(sharded["n_mpc_fail"] == 0.0 and sharded["value"] > 0,
              f"13d {sharded['config']}: no failed MPC solve")
        print(f"    the port's kernels in one replay of each chain: "
              f"{ {k: nonzero(c) for k, c in chains.items()} }", flush=True)
        check(chains.get("pallas_vs_xla:pallas", {}).get(mma, 0) > 0,
              "13d: kernel 5 launched inside the pallas_vs_xla chain's "
              "replay")
        check(sorted(os.listdir(out)) == ["BENCH_DETAIL_TORCH.json",
                                          "RESULTS_TORCH.md"],
              "13d: write_results wrote its two files under --out")
    clear_runners()
    torch.cuda.empty_cache()
    check(record_digests() == before, "13: RESULTS.md, BENCH_DETAIL.json and "
                                      "MULTIHOST_32K.json byte-identical")
    for name in ("admm_iterate_m2", "admm_iterate_vpu", "admm_solve_fused",
                 "admm_iterate", "wbc_build", "plant_step",
                 "admm_solve_plain_warp", "chol_inverse"):
        check(sum(by_function[name].values()) > 0,
              f"13: {name} launched by the bench")
    for name, functions in by_function.items():
        reports[name]["bench_launches"] = functions


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU and has no CPU fallback", file=sys.stderr)
        return 2
    t_script = time.time()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    # ---- 1. device ------------------------------------------------------
    print("== 1. device", flush=True)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"  nvidia-smi name, power.limit: {smi}")
    print(f"  python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  "
          f"capability {torch.cuda.get_device_capability(0)}")
    enforce_f32_matmuls()
    print(f"  allow_tf32={torch.backends.cuda.matmul.allow_tf32}  "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    check(torch.backends.cuda.matmul.allow_tf32 is False
          and torch.get_float32_matmul_precision() == "highest",
          "matrix products pinned to full float32")

    # ---- 2. build -------------------------------------------------------
    print("== 2. build", flush=True)
    t0 = time.time()
    _build.build_libraries(kernels.build_specs() + rbd_kernels.build_specs()
                           + plan_kernels.build_specs())
    for name in kernels.LIBRARIES:
        kernels._library(name)
    for name in rbd_kernels.LIBRARIES:
        rbd_kernels._library(name)
    plan_kernels._library()
    n_libs = (len(kernels.LIBRARIES) + len(rbd_kernels.LIBRARIES)
              + len(plan_kernels.build_specs()))
    print(f"  nvcc {' '.join(_build.NVCC_FLAGS)}  ->  {_build.build_dir()}")
    print(f"  {n_libs} libraries built together and loaded in "
          f"{time.time() - t0:.2f} s; nvcc seconds each: "
          + ", ".join(f"{k} {v:.2f}" for k, v in _build.BUILD_SECONDS.items()),
          flush=True)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")

    reports = {}

    # ---- 3a. kernel 1 vs plain ------------------------------------------
    print("== 3a. M2 iteration kernel vs plain PyTorch version, on the card",
          flush=True)
    mpc_args, _ = iteration_inputs(0, 64, 192, 320, device, eq=False)
    test_args = iteration_inputs(1, 3, 24, 40, device, eq=False)[0]
    errs = [compare_m2("mpc shape", mpc_args, cluster=2),
            compare_m2("test shape", test_args),
            compare_m2("single",
                       iteration_inputs(2, 1, 192, 320, device, eq=False)[0],
                       cluster=2),
            compare_m2("wbc-sized, odd",
                       iteration_inputs(3, 5, 30, 50, device, eq=False)[0]),
            compare_m2("odd batch, one cluster more than a wave",
                       iteration_inputs(4, 67, 192, 320, device, eq=False)[0],
                       cluster=2),
            compare_m2("n=256 m=400 (clusters of 3)",
                       iteration_inputs(5, 4, 256, 400, device, eq=False)[0],
                       cluster=3),
            compare_m2("n=256 m=120 (clusters of 2, M2 in shared memory)",
                       iteration_inputs(6, 4, 256, 120, device, eq=False)[0],
                       cluster=2, resident=kernels.RES_M2 | kernels.RES_M2_A,
                       gate="float64"),
            compare_m2("n=256 m=256 (clusters of 3, M2 in shared memory)",
                       iteration_inputs(6, 4, 256, 256, device, eq=False)[0],
                       cluster=3,
                       resident=kernels.RES_M2 | kernels.RES_M2_A),
            compare_m2("n=401 m=701 (clusters of 7, rows not 16-byte "
                       "aligned)",
                       iteration_inputs(7, 2, 401, 701, device, eq=False)[0],
                       cluster=7),
            compare_m2("n=500 m=900 (A streamed)",
                       iteration_inputs(8, 2, 500, 900, device, eq=False)[0],
                       iters=10, cluster=8, resident=kernels.RES_M2),
            compare_m2("n=1000 m=2000 (M2 and A streamed)",
                       iteration_inputs(9, 1, 1000, 2000, device,
                                        eq=False)[0],
                       iters=5, cluster=8, resident=0),
            compare_m2_skewed("cluster of 2", mpc_args),
            compare_m2_skewed("one block", test_args)]
    del test_args
    # the main path's own shape: the 64 scenarios tiled to B = 4096 (every
    # scenario has its own memory; the kernel's time does not depend on the
    # values), compared once more and then timed
    Bt, n, m, iters = 4096, 192, 320, 30
    big = [a.repeat((Bt // a.shape[0],) + (1,) * (a.dim() - 1)).contiguous()
           for a in mpc_args]
    errs.append(compare_m2("main path shape", big, iters=iters, cluster=2))
    kw = dict(iters=iters, sigma=1e-6, alpha=1.6)
    kernel_ms = time_ms(lambda: kernels.admm_iterate_m2(*big, **kw), 1, 3)
    plain_ms = time_ms(
        lambda: kernels.admm_iterate_m2_reference(*big, **kw), 1, 2)
    bound = m2_bound_ms(Bt, n, m, iters)
    del big, mpc_args
    torch.cuda.empty_cache()
    report_times("m2", f"B={Bt} n={n} m={m} iters={iters}", kernel_ms,
                 plain_ms, bound, smi)
    reports["admm_iterate_m2"] = dict(
        source="mpctsid_tpu_torch/qp/csrc/admm_m2.cu",
        replaces="mpctsid_tpu/qp/pallas_kernels.py:440",
        max_abs_err=max(errs), ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=bound[0], bound_by=bound[1])

    # ---- 3b. kernels 2 and 3 vs plain and each other --------------------
    print("== 3b. generic and packed refined-iteration kernels vs their "
          "plain version and each other", flush=True)
    _, wbc_args = iteration_inputs(10, 64, 30, 50, device, eq=True)
    ev, ep = zip(
        compare_refined("wbc shape", wbc_args, REFINED_EQ_TOL),
        compare_refined("test shape", iteration_inputs(
            11, 3, 24, 40, device, eq=True)[1], REFINED_EQ_TOL),
        compare_refined("single", iteration_inputs(
            12, 1, 30, 50, device, eq=True)[1], REFINED_EQ_TOL),
        compare_refined("partial last block", iteration_inputs(
            13, 37, 30, 50, device, eq=True)[1], REFINED_EQ_TOL),
        compare_refined("wbc shape, no equality rows", iteration_inputs(
            14, 64, 30, 50, device, eq=False)[1], KERNEL_TOL),
        compare_refined("B=531, a partial last block of warps",
                        iteration_inputs(17, 531, 30, 50, device,
                                         eq=True)[1], REFINED_EQ_TOL),
        compare_refined("n = 32, the warp path's edge", iteration_inputs(
            18, 64, 32, 50, device, eq=True)[1], REFINED_EQ_TOL),
        compare_refined("n = 33 (block path, packed shared path)",
                        iteration_inputs(19, 8, 33, 55, device, eq=True)[1],
                        REFINED_EQ_TOL, path="block", packed_path="shared"),
        compare_refined("n = 31, odd (packed register path)",
                        iteration_inputs(29, 37, 31, 47, device, eq=True)[1],
                        REFINED_EQ_TOL),
        compare_refined("n = 40 (packed shared path, several per block)",
                        iteration_inputs(46, 300, 40, 60, device, eq=True)[1],
                        REFINED_EQ_TOL, path="block", packed_path="shared"),
        # the layout case, inequality-only: with four equality rows in
        # eight the float32 iteration is noisy at 1e-2 (the plain version
        # 6.1e-3 from float64 on the CPU; kernels 2 and 3, equal bit for
        # bit, 1.26e-2 from it on the card)
        compare_refined("n = 32, m = 8 (packed staging larger than A)",
                        iteration_inputs(47, 64, 32, 8, device, eq=False)[1],
                        KERNEL_TOL))
    ev, ep = list(ev), list(ep)
    ev.append(compare_skewed_k("warp path", wbc_args, label="vpu"))
    _, mpc_refined = iteration_inputs(15, 8, 192, 320, device, eq=True)
    ev.append(compare_refined("mpc shape (streamed matrices)", mpc_refined,
                              REFINED_EQ_TOL, packed=False, path="block")[0])
    refused = False
    try:
        kernels.admm_iterate_vpu_packed(*mpc_refined, iters=1)
    except ValueError as e:
        refused = "shared memory" in str(e)
    check(refused, "packed kernel refuses the MPC shape with the reason "
                   "(it never hands work to the generic kernel)")
    del mpc_refined
    Bt, n, m = 4096, 30, 50
    _, big = iteration_inputs(16, Bt, n, m, device, eq=True)
    e_v, e_p = compare_refined("main path shape", big, REFINED_EQ_TOL)
    ev.append(e_v)
    ep.append(e_p)
    kw = dict(iters=REFINED_ITERS, sigma=1e-6, alpha=1.6)
    vpu_ms = time_ms(lambda: kernels.admm_iterate_vpu(*big, **kw), 2, 10)
    packed_ms = time_ms(
        lambda: kernels.admm_iterate_vpu_packed(*big, **kw), 2, 10)
    plain_ms = time_ms(
        lambda: kernels.admm_iterate_refined_reference(*big, **kw), 1, 3)
    bound = refined_bound_ms(Bt, n, m, REFINED_ITERS)
    shape = f"B={Bt} n={n} m={m} iters={REFINED_ITERS}"
    report_times("vpu", shape, vpu_ms, plain_ms, bound, smi)
    report_times("packed", shape, packed_ms, plain_ms, bound, smi)
    del big
    reports["admm_iterate_vpu"] = dict(
        source="mpctsid_tpu_torch/qp/csrc/admm_vpu.cu",
        replaces="mpctsid_tpu/qp/pallas_kernels.py:155",
        max_abs_err=max(ev), ms=vpu_ms, plain_ms=plain_ms,
        bound_ms=bound[0], bound_by=bound[1])
    play = packed_layout_of(Bt, n, m, device)
    reports["admm_iterate_vpu_packed"] = dict(
        source="mpctsid_tpu_torch/qp/csrc/admm_packed.cu",
        replaces="mpctsid_tpu/qp/pallas_kernels.py:274",
        max_abs_err=max(ep), ms=packed_ms, plain_ms=plain_ms,
        bound_ms=bound[0], bound_by=bound[1],
        layout=dict(path=play.path, g=play.g, threads=play.threads,
                    ld=play.ld, slot_floats=play.slot_floats))

    # ---- 3c. kernel 4 vs plain ------------------------------------------
    print("== 3c. whole-solve kernel vs its plain version", flush=True)
    errs = [compare_fused("wbc shape", fused_inputs(20, 64, 30, 50, device)),
            compare_fused("test shape", fused_inputs(21, 3, 24, 40, device)),
            compare_fused("single", fused_inputs(22, 1, 30, 50, device)),
            compare_fused("odd batch", fused_inputs(23, 37, 30, 50, device)),
            compare_fused("n = 32, the warp path's edge",
                          fused_inputs(26, 64, 32, 50, device)),
            compare_fused("n = 33 (block path)",
                          fused_inputs(27, 8, 33, 55, device), path="block"),
            compare_fused("mpc shape (block path, global workspace)",
                          fused_inputs(24, 8, 192, 320, device),
                          path="block")]
    for seed, B_ in ((28, 1), (57, 37), (50, 64), (51, 4096)):
        errs.append(compare_fused(f"test shape, B={B_}",
                                  fused_inputs(seed, B_, 24, 40, device)))
    big = fused_inputs(25, Bt, n, m, device)
    errs.append(compare_fused("main path shape", big))
    fused_ms = time_ms(lambda: kernels.admm_solve_fused(*big, **FUSED_KW),
                       2, 10)
    plain_ms = time_ms(
        lambda: kernels.admm_solve_fused_reference(*big, **FUSED_KW), 1, 2)
    bound = fused_bound_ms(Bt, n, m, FUSED_KW["iters"],
                           FUSED_KW["adapt_rounds"],
                           FUSED_KW["equilibrate_iters"])
    report_times("fused", f"B={Bt} n={n} m={m} iters=40/3", fused_ms,
                 plain_ms, bound, smi)
    del big
    torch.cuda.empty_cache()
    reports["admm_solve_fused"] = dict(
        source="mpctsid_tpu_torch/qp/csrc/admm_fused.cu",
        replaces="mpctsid_tpu/qp/pallas_kernels.py:851",
        max_abs_err=max(errs), ms=fused_ms, plain_ms=plain_ms,
        bound_ms=bound[0], bound_by=bound[1])

    # ---- 3d. kernel 5 vs plain ------------------------------------------
    print("== 3d. tensor-core iteration kernel (K as given) vs its plain "
          "version", flush=True)
    _, wbc_args = iteration_inputs(30, 64, 30, 50, device, eq=True)
    _, mpc_args = iteration_inputs(35, 8, 192, 320, device, eq=True)
    errs = [compare_mma("wbc shape", wbc_args, REFINED_EQ_TOL),
            compare_mma("test shape", iteration_inputs(
                31, 3, 24, 40, device, eq=True)[1], REFINED_EQ_TOL),
            compare_mma("single", iteration_inputs(
                32, 1, 30, 50, device, eq=True)[1], REFINED_EQ_TOL),
            compare_mma("odd batch", iteration_inputs(
                33, 37, 30, 50, device, eq=True)[1], REFINED_EQ_TOL),
            compare_mma("wbc shape, no equality rows", iteration_inputs(
                34, 64, 30, 50, device, eq=False)[1], KERNEL_TOL),
            compare_mma("mpc shape, equality rows", mpc_args, REFINED_EQ_TOL,
                        path="cluster", cluster=3),
            compare_mma("mpc shape, single", iteration_inputs(
                38, 1, 192, 320, device, eq=True)[1], REFINED_EQ_TOL,
                        path="cluster", cluster=3),
            compare_mma("n=128 m=208 (clusters of 2)", iteration_inputs(
                39, 8, 128, 208, device, eq=True)[1], REFINED_EQ_TOL,
                        path="cluster", cluster=2),
            compare_mma("n=150 m=250 (ragged slices)", iteration_inputs(
                40, 8, 150, 250, device, eq=True)[1], REFINED_EQ_TOL,
                        path="cluster", cluster=2),
            compare_mma("n=100 m=170 (one block holds all)", iteration_inputs(
                41, 8, 100, 170, device, eq=True)[1], REFINED_EQ_TOL,
                        path="cluster", cluster=1),
            compare_mma("n=256 m=400 (clusters of 6)", iteration_inputs(
                42, 4, 256, 400, device, eq=True)[1], REFINED_EQ_TOL,
                        path="cluster", cluster=6),
            compare_mma("n=400 m=700 (K and A streamed)", iteration_inputs(
                43, 2, 400, 700, device, eq=True)[1], REFINED_EQ_TOL,
                        iters=5, f64=False, path="cluster", cluster=8),
            compare_mma("n=401 m=701 (streamed, rows not 16-byte aligned)",
                        iteration_inputs(44, 2, 401, 701, device, eq=True)[1],
                        REFINED_EQ_TOL, iters=5, f64=False, path="cluster",
                        cluster=8),
            compare_mma("n=37 m=61 (odd n on the warp path)",
                        iteration_inputs(45, 5, 37, 61, device, eq=True)[1],
                        REFINED_EQ_TOL),
            compare_skewed_k("warp path", wbc_args),
            compare_skewed_k("cluster path", mpc_args)]
    for seed, B_ in ((52, 1), (53, 37), (54, 64), (55, 4096)):
        errs.append(compare_mma(f"test shape, B={B_}", iteration_inputs(
            seed, B_, 24, 40, device, eq=True)[1], REFINED_EQ_TOL))
    del wbc_args, mpc_args
    mma_reports = {}
    # the main path's two shapes: the WBC stage's (13 iterations, equality
    # rows) and the MPC stage's (30 iterations, none; 64 scenarios tiled to
    # B = 4096 as in 3a)
    _, big = iteration_inputs(36, Bt, n, m, device, eq=True)
    _, mpc64 = iteration_inputs(37, 64, 192, 320, device, eq=False)
    mpc_big = [a.repeat((Bt // 64,) + (1,) * (a.dim() - 1)).contiguous()
               for a in mpc64]
    del mpc64
    # (the float64 run of 4096 MPC-sized scenarios is left out: the MPC
    # shape's precision is held at B=8 above)
    errs.append(compare_mma("main path shape, wbc stage", big, REFINED_EQ_TOL))
    mma_reports["wbc"] = time_mma(big, REFINED_ITERS, 10, smi)
    del big
    errs.append(compare_mma("main path shape, mpc stage", mpc_big, KERNEL_TOL,
                            iters=30, f64=False, path="cluster", cluster=3))
    mma_reports["mpc"] = time_mma(mpc_big, 30, 3, smi)
    del mpc_big
    torch.cuda.empty_cache()
    # 60 of the 62 launches per period are at the WBC shape: its numbers are
    # the entry's; the MPC shape's ride along under *_mpc_shape
    reports["admm_iterate"] = dict(
        source="mpctsid_tpu_torch/qp/csrc/admm_mma.cu",
        replaces="mpctsid_tpu/qp/pallas_kernels.py:929",
        max_abs_err=max(errs), **mma_reports["wbc"],
        **{k + "_mpc_shape": v for k, v in mma_reports["mpc"].items()})

    # ---- 3e. the rigid-body stage kernels vs plain ----------------------
    print("== 3e. WBC-build and plant-step kernels vs their plain versions",
          flush=True)
    rbd_kernels_phase(smi, device, reports)
    torch.cuda.empty_cache()

    # ---- 3f. kernels A and B vs plain -------------------------------------
    print("== 3f. the default WBC solve (kernel A) and K^-1 (kernel B) vs "
          "their plain versions", flush=True)
    solve_kernels_phase(smi, device, reports)
    torch.cuda.empty_cache()

    # ---- 3g. the planner and Ruiz vs plain ----------------------------------
    print("== 3g. the planner kernels (footsteps, reference rollout, swing "
          "reference) and Ruiz vs their plain versions", flush=True)
    planner_ruiz_phase(smi, device, reports)
    torch.cuda.empty_cache()

    # ---- 4. main path at full size, each WBC backend --------------------
    print("== 4. main path: cascade_rollout, preset config4_cascade_4k",
          flush=True)
    cfg = PRESETS["config4_cascade_4k"]
    print(f"  B={cfg.batch} gait={cfg.gait} v_ref={cfg.v_ref} periods="
          f"{ROLLOUT_PERIODS} mpc {cfg.solver.mpc_iters}/"
          f"{cfg.solver.mpc_adapt_rounds} wbc {cfg.solver.wbc_iters}/"
          f"{cfg.solver.wbc_adapt_rounds} mpc_backend="
          f"{cfg.solver.mpc_backend} (default wbc_backend="
          f"{cfg.solver.wbc_backend})")
    path_launches = {}
    records = []         # phase 12's references: (counted kernel, record)
    for wbc_backend in (cfg.solver.wbc_backend, "fused", "packed", "vpu"):
        counted, expect = expected_launches(cfg, ROLLOUT_PERIODS, wbc_backend)
        counts, rec = full_width_rollout(cfg, wbc_backend, expect, smi,
                                         device)
        path_launches[counted] = counts[counted]
        if wbc_backend == cfg.solver.wbc_backend:
            # every rollout launches them; the default one is the main path
            for name in ("wbc_build", "plant_step", "chol_inverse",
                         MPC_KERNEL_OF[cfg.solver.mpc_backend],
                         "plan_footsteps_horizon", "reference_rollout",
                         "swing_foot_ref", "ruiz_equilibrate"):
                path_launches[name] = counts[name]
        records.append((counted, rec))
        torch.cuda.empty_cache()
    # the estimator-in-the-loop path, both QP stages on kernel 5
    counted, expect = expected_launches(cfg, ROLLOUT_PERIODS, "pallas",
                                        mpc_backend="pallas")
    counts, rec = full_width_rollout(cfg, "pallas", expect, smi, device,
                                     mpc_backend="pallas", use_estimator=True)
    path_launches[counted] = counts[counted]
    records.append((counted, rec))
    del rec
    torch.cuda.empty_cache()
    for name, count in path_launches.items():
        check(count > 0, f"{name} was launched on the main path")
        reports[name]["launches"] = count

    # ---- 5. kernels on the path vs plain on the path --------------------
    print("== 5a. mpc_backend 'm2' (kernel) vs 'torch' (plain), B=256",
          flush=True)
    cfg256 = PRESETS["config2_gait_sweep"]
    outs = {}
    for backend in ("m2", "torch"):
        cc, ctl, plant, gid, v, cp = make_scenarios(cfg256, 256, seed=1,
                                                    device=device)
        ctl1, plant1, _ = cascade_rollout(cc, ctl, plant, gid, v, cp,
                                          n_periods=1, device=device,
                                          mpc_backend=backend)
        ctl2, plant2, _ = cascade_rollout(cc, ctl1, plant1, gid, v, cp,
                                          n_periods=1, device=device,
                                          mpc_backend=backend)
        outs[backend] = (ctl1.f_plan, plant2.q, ctl2.f_plan)
    d_plan = float((outs["m2"][0] - outs["torch"][0]).abs().max())
    d_q = float((outs["m2"][1] - outs["torch"][1]).abs().max())
    d_plan2 = float((outs["m2"][2] - outs["torch"][2]).abs().max())
    print(f"  plan solved from the same state: max |df_plan| {d_plan:.3e} N; "
          f"after the period that consumes it: max |dq| {d_q:.3e}, "
          f"max |df_plan| {d_plan2:.3e} N", flush=True)
    check(d_plan < 1e-3, "backends: f_plan within 1e-3 N")
    check(d_q < 1e-4, "backends: plant q within 1e-4 after the plan is "
                      "consumed")

    print("== 5b. WBC backends (the default's kernel route among them) vs "
          "the plain WBC chain, B=256, mid-gait", flush=True)
    # two periods from standing reach mid-gait; the third is the test bed,
    # on the plain chain of qp/admm.py (kernel A's plain version)
    with plain_wbc_chain():
        (tree, wcfg, q_t, v_t, refs, wkw), ctl3, plant3 = capture_wbc_tick(
            cc, ctl2, plant2, gid, v, cp, tick=10, device=device)
        wkw = {k: a for k, a in wkw.items() if k != "backend"}
        tau_plain = solve_wbc(tree, wcfg, q_t, v_t, refs, backend="torch",
                              **wkw)[0]
    for backend in ("xla", "fused", "packed", "vpu", "pallas"):
        tau, _, _, sol = solve_wbc(tree, wcfg, q_t, v_t, refs,
                                   backend=backend, **wkw)
        d_tau = (tau - tau_plain).abs().amax(dim=1)
        _, plant_k, met_k = cascade_rollout(cc, ctl2, plant2, gid, v, cp,
                                            n_periods=1, device=device,
                                            wbc_backend=backend)
        d_q = float((plant_k.q - plant3.q).abs().max())
        print(f"  {backend}: one tick max |dtau| {float(d_tau.max()):.3e} "
              f"Nm, median {float(d_tau.median()):.3e} Nm; one period max "
              f"|dq| {d_q:.3e}, wbc_ok_frac "
              f"{float(met_k['wbc_ok_frac'].mean()):.4f}", flush=True)
        check(bool(sol.ok.all()) and float(d_tau.max()) < WBC_TAU_TOL
              and float(d_tau.median()) < WBC_TAU_MEDIAN_TOL,
              f"{backend}: one WBC tick within {WBC_TAU_TOL} Nm (median "
              f"{WBC_TAU_MEDIAN_TOL}) of the plain WBC")
        check(d_q < WBC_PERIOD_Q_TOL and bool(
            (met_k["wbc_ok_frac"] == 1.0).all()),
              f"{backend}: one period within {WBC_PERIOD_Q_TOL} of the plain "
              "WBC's q, every tick ok")

    print("== 5c. estimator loop on the tensor-core kernel vs on the plain "
          "backends, B=256, one mid-gait period", flush=True)
    outs = {}
    for backend in ("pallas", "torch"):
        est = EstimatorState(q=plant2.q.clone(), v=plant2.v.clone())
        ctl_e, plant_e, met_e = cascade_rollout(
            cc, ctl2, plant2, gid, v, cp, n_periods=1, device=device, est=est,
            use_estimator=True, mpc_backend=backend, wbc_backend=backend)
        outs[backend] = (ctl_e.f_plan, plant_e.q, met_e)
    d_plan = float((outs["pallas"][0] - outs["torch"][0]).abs().max())
    d_q = float((outs["pallas"][1] - outs["torch"][1]).abs().max())
    d_est = float((outs["pallas"][2]["est_xy_err"]
                   - outs["torch"][2]["est_xy_err"]).abs().max())
    print(f"  max |df_plan| {d_plan:.3e} N, max |dq| {d_q:.3e}, max "
          f"|d est_xy_err| {d_est:.3e} m; wbc_ok_frac "
          f"{float(outs['pallas'][2]['wbc_ok_frac'].mean()):.4f}", flush=True)
    check(d_plan < 1e-3, "estimator loop: f_plan within 1e-3 N")
    check(d_q < WBC_PERIOD_Q_TOL and d_est < WBC_PERIOD_Q_TOL and bool(
        (outs["pallas"][2]["wbc_ok_frac"] == 1.0).all())
        and bool(outs["pallas"][2]["mpc_ok"].all()),
          f"estimator loop: plant q and est_xy_err within {WBC_PERIOD_Q_TOL} "
          "of the plain backends', every solve ok")

    # ---- 6. B = 1 --------------------------------------------------------
    print("== 6. single robot, B=1, one period per WBC backend", flush=True)
    cfg1 = PRESETS["config1_trot_single"]
    for wbc_backend in (cfg1.solver.wbc_backend, "fused", "packed", "vpu",
                        "pallas"):
        cc, ctl, plant, gid, v, cp = make_scenarios(cfg1, 1, seed=2,
                                                    device=device)
        reset_launch_counts()
        t0 = time.time()
        ctl, plant, metrics = cascade_rollout(
            cc, ctl, plant, gid, v, cp, n_periods=1, device=device,
            wbc_backend=wbc_backend)
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"  wbc_backend={wbc_backend}: one period "
              f"{time.time() - t0:.3f} s; launches {counts}", flush=True)
        check(all_finite((plant.q, plant.v, ctl.f_plan))
              and bool(metrics["mpc_ok"].all())
              and bool((metrics["wbc_ok_frac"] == 1.0).all()),
              f"B=1, {wbc_backend}: finite, mpc_ok, every WBC tick ok")
        expect = expected_launches(cfg1, 1, wbc_backend)[1]
        check(counts == expect, f"B=1, {wbc_backend}: launches are {expect}")

    # ---- 7. the Monte-Carlo sweep entry point ----------------------------
    print(f"== 7. run_sweep: {SWEEP_TOTAL} scenarios in chunks of "
          f"{SWEEP_CHUNK}, {SWEEP_PERIODS} periods; then interrupted, saved, "
          "loaded, finished", flush=True)
    clear_runners()
    reset_launch_counts()
    t0 = time.time()
    whole = run_sweep(SweepState.fresh(0, SWEEP_TOTAL, SWEEP_PERIODS),
                      SWEEP_CHUNK, verbose=False, device=device)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    (sweep_runner,) = cached_runners()
    capture_s = sweep_runner.call.capture_seconds
    del sweep_runner
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "sweep.npz")
        part = run_sweep(SweepState.fresh(0, SWEEP_TOTAL, SWEEP_PERIODS),
                         SWEEP_CHUNK, ckpt_path=ckpt, max_chunks=1,
                         verbose=False, device=device)
        stopped_at = part.cursor
        resumed = run_sweep(SweepState.load(ckpt), SWEEP_CHUNK,
                            ckpt_path=ckpt, verbose=False, device=device)
        reloaded = SweepState.load(ckpt)
    summary = summarize(whole)
    sweep_cfg = EngineConfig()     # run_sweep builds its own, the default
    ticks = SWEEP_TOTAL * SWEEP_PERIODS * sweep_cfg.cascade.mpc_every
    after = launch_counts()
    print(f"  {ticks / wall:.1f} "
          f"ticks/s, wall {wall:.2f} s ({capture_s:.2f} s of it the "
          f"capture); launches {counts}; {summary}  [{smi}]", flush=True)
    differing = [k for k in METRIC_KEYS if not np.array_equal(
        whole.metrics[k].view(np.uint32), resumed.metrics[k].view(np.uint32))]
    check(whole.cursor == SWEEP_TOTAL and stopped_at == SWEEP_CHUNK
          and resumed.cursor == SWEEP_TOTAL and reloaded.cursor == SWEEP_TOTAL,
          "sweep: cursors of the whole, the stopped and the resumed run")
    check(all(np.isfinite(whole.metrics[k]).all() for k in METRIC_KEYS),
          "sweep: every stored metric finite (no padding, no NaN left)")
    check(not differing, "sweep: interrupted and resumed run equals the "
          f"uninterrupted one bit for bit (differing metrics: {differing})")
    check(all(np.array_equal(reloaded.metrics[k].view(np.uint32),
                             resumed.metrics[k].view(np.uint32))
              for k in METRIC_KEYS),
          "sweep: the last checkpoint holds the finished table")
    # one runner serves every chunk: its warm-up and capture are the only
    # periods that move the counters
    expect = expected_launches(sweep_cfg, 2, sweep_cfg.solver.wbc_backend)[1]
    check(counts == expect, f"sweep: kernel launches are {expect} (one "
                            "capture for the whole sweep)")
    check(after == counts, "sweep: the stopped and the resumed run replayed "
                           "the cached graph (no launch outside it)")
    check(summary["upright_frac"] == 1.0,
          "sweep: every scenario upright after its 60 ms")
    # the first chunk, run eagerly, against the sweep's graphed first chunk
    chunk = scenario_params(0, np.arange(SWEEP_CHUNK))
    cc_e, ctl_e, plant_e, cp_e = chunk_inputs(*chunk, device)
    _, _, met_e = cascade_rollout(cc_e, ctl_e, plant_e, chunk[0], chunk[1],
                                  cp_e, n_periods=SWEEP_PERIODS,
                                  payload=chunk[3], device=device)
    eager_chunk = chunk_metrics(met_e, chunk[1], SWEEP_PERIODS)
    differing = [k for k in METRIC_KEYS if not np.array_equal(
        whole.metrics[k][:SWEEP_CHUNK].view(np.uint32),
        eager_chunk[k].view(np.uint32))]
    check(not differing, "sweep: the first chunk (graphed) equals the same "
          f"chunk run eagerly bit for bit (differing metrics: {differing})")
    del cc_e, ctl_e, plant_e, cp_e, met_e
    clear_runners()
    torch.cuda.empty_cache()

    # ---- 8. the accuracy tiers --------------------------------------------
    print("== 8. accuracy tiers: solve_mpc_batch, the polished MPC tier in "
          "float32 and float64, the df32 residual, the float64 WBC tier",
          flush=True)
    accuracy_tiers(smi, device)
    torch.cuda.empty_cache()

    # ---- 9. the single-robot deployment path -------------------------------
    t_host = time.time()
    print("== 9a/9b. host controller (B=1): each captured graph against its "
          "eager run, the kernels in each replay", flush=True)
    host_graphs(smi, device)
    print(f"== 9c-9e. host controller in closed loop on a SimPlant, "
          f"{HOST_SECONDS} s: sync, async, telemetry", flush=True)
    host_closed_loop(smi, device)

    # ---- 10. the sharded rollout and the entry twins -----------------------
    print("== 10. sharded rollout on a one-rank NCCL group; entry()",
          flush=True)
    sharded_path(smi, device)
    clear_runners()
    torch.cuda.empty_cache()
    print(f"  phases 9-10 took {time.time() - t_host:.1f} s", flush=True)

    # ---- 11. the contract against the float64 oracle ------------------------
    t_oracle = time.time()
    print(f"== 11. the contract against the float64 oracle "
          f"(mpctsid_tpu_torch/oracle/ in {ORACLE_WORKERS} processes)",
          flush=True)
    oracle_contract(smi, device)
    print(f"  phase 11 took {time.time() - t_oracle:.1f} s", flush=True)

    # ---- 12. the batched period as one CUDA graph ---------------------------
    t_graph = time.time()
    print(f"== 12a-12c. the batched period as one CUDA graph: preset "
          f"config4_cascade_4k (B={cfg.batch}), phase 4's five "
          "configurations, each replay against phase 4's eager periods",
          flush=True)
    graph_launches = {}
    for counted, rec in records:
        counts = graphed_period(rec, cfg, smi, device)
        graph_launches[counted] = counts[KERNEL_PREFIX[counted]]
        for name in ("wbc_build", "plant_step", "chol_inverse",
                     MPC_KERNEL_OF[cfg.solver.mpc_backend],
                     "plan_footsteps_horizon", "reference_rollout",
                     "swing_foot_ref", "ruiz_equilibrate"):
            graph_launches.setdefault(name, counts[KERNEL_PREFIX[name]])
    del records, rec
    torch.cuda.empty_cache()
    for name, count in graph_launches.items():
        reports[name]["launches_per_captured_period"] = count
    print("== 12d. eager and graphed period times at B = 1 and B = 256",
          flush=True)
    for B_, preset in ((1, "config1_trot_single"),
                       (256, "config2_gait_sweep")):
        pcfg = PRESETS[preset]
        for wbc_backend in (pcfg.solver.wbc_backend, "fused"):
            graphed_times(pcfg, B_, wbc_backend, smi, device)
    print(f"  phase 12 took {time.time() - t_graph:.1f} s", flush=True)

    # ---- 13. the port's bench ------------------------------------------------
    t_bench = time.time()
    print("== 13. the bench (mpctsid_tpu_torch/bench.py): headline, latency, "
          "host loop, presets", flush=True)
    bench_phase(smi, device, reports)
    print(f"  phase 13 took {time.time() - t_bench:.1f} s", flush=True)

    print(f"== total {time.time() - t_script:.1f} s", flush=True)
    if FAILURES:
        print("chip_smoke FAILED:", *FAILURES, sep="\n  ", file=sys.stderr)
        return 1

    # one PyTorch call computes kernel B's function (torch.linalg.inv_ex,
    # timed in 3f); none computes the others': library_ms null.  The WBC
    # build, the plant step and kernels A and B replace no TPU kernel: the
    # JAX package leaves those stages to XLA; `replaces` names its functions
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", **{"library_ms": None, **r})
        for name, r in reports.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
