"""Benchmark harness of the port: throughput, latency, scaling presets (the
counterpart of the repository's `bench.py`, same modes, protocol and keys).

Default mode prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "upright_frac": f, "mean_vx_err": e, "vx_track_frac": f,
   "mean_mpc_res": r, "mean_mpc_dual_res": r, "wbc_ok_frac": f,
   "mpc_fail_frac": f}
The correctness guards ride along in the same line, so a falling or
diverging batch never produces a clean headline number.

Modes:
  python -m mpctsid_tpu_torch.bench                headline throughput + guards
  python -m mpctsid_tpu_torch.bench --latency      B = 1 tick and MPC solve
                                                   times vs the 2 ms tick
  python -m mpctsid_tpu_torch.bench --full         every config preset +
                                                   latency + host loop +
                                                   kernel 5 vs the plain
                                                   backend -> RESULTS_TORCH.md,
                                                   BENCH_DETAIL_TORCH.json
  python -m mpctsid_tpu_torch.bench --batch-sweep  trot ticks/s at B = 256 to
                                                   8192 -> SCALING_TORCH.json
  python -m mpctsid_tpu_torch.bench --profile DIR  torch.profiler trace of the
                                                   headline run into DIR
Every mode runs on the card and raises without one; `--cpu` runs the same
code on the CPU at B = 16 (the kernels' plain versions).  Files are written
only under `--out` (default `build/bench_torch/` of the repository).

Measurement protocol: every time is DIFFERENTIAL, a long and a short run of
the same program, median over reps; the difference cancels what a call costs
besides its periods (loading the state into the runner's buffers, stacking
the metrics, the host read that ends the run).  Each timed rollout is
`cascade_rollout_graphed`, one CUDA graph replay per MPC period, the
counterpart of the JAX bench's `jax.jit(jax.vmap(cascade_rollout))`; its
capture happens in the first warm call and is printed apart on stderr.  One
"cascade solve" is one full control tick: a WBC (TSID) QP solve + plant
step plus its 1/20th share of the 50 Hz centroidal MPC solve (QP build +
footstep plan + adaptive-rho ADMM at the production budget, config.py
SolverConfig).

vs_baseline: the contract's target is >= 10,000 cascade solves/s for the
whole system (BASELINE.json:5); vs_baseline = value / 10,000.  The JAX
bench divides by 1,250 instead, the per-chip share of an eight-chip TPU
slice, which has no counterpart on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["build_batch", "diff_time", "cascade_guards", "measure_cascade",
           "measure_latency", "measure_host_loop", "measure_sharded",
           "run_presets",
           "write_results", "batch_sweep", "headline", "main"]

TARGET = 10000.0           # cascade solves/s, the whole system (BASELINE.json:5)
TICK_BUDGET_MS = 2.0       # p50 single-tick latency at B = 1 (BASELINE.json:2)
HEADLINE_B = 1024          # the headline batch on the card
CPU_B = 16                 # the headline and preset batch with --cpu
# Guard window, MPC periods: trot from standstill needs ~20 periods (0.4 s)
# to converge to its steady-state velocity, so a window as short as the
# timed rollout would report the transient and read as "the robot never
# moves".
GUARD_PERIODS = 31
SHARDED_B = 256            # config5 on the card: the JAX stand-in's batch
RANK_TIMEOUT_S = 900       # config5: time limit of each rank
DEFAULT_OUT = Path(__file__).resolve().parents[1] / "build" / "bench_torch"
# B = 1 MPC backends of the latency A/B on the card, under the JAX bench's
# names: kernel 1 (the MPC default), kernel 2, kernel 4, the plain version
CARD_MPC_BACKENDS = ("auto_mpc", "pallas_vpu", "fused", "xla")


def _release(device) -> None:
    """Close the cached period runners (their graphs' pools are gigabytes
    at large B) and hand the memory back."""
    from mpctsid_tpu_torch.cascade import clear_runners

    clear_runners()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def nvidia_smi_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# scenario-batch construction
# ---------------------------------------------------------------------------

def build_batch(cfg, B, gait_mix=None, mu_spread=False, payload_spread=False,
                seed=0, device="cuda"):
    """(cc, args) for a B-scenario batch on `device`; args is (ctl, plant,
    gid, v_cmd, contact_params) plus a per-scenario payload tensor when
    payload_spread.

    gait_mix: list of gait names cycled across the batch (per-scenario gait
    id is data, BASELINE.json:8); mu_spread: per-scenario friction in
    [0.4, 1.0]; payload_spread: per-scenario base point mass in [0, 0.5] kg,
    the "load" half of BASELINE.json:9's mu/load perturbation batches.  The
    numpy draws are the JAX bench's, in its order."""
    from mpctsid_tpu_torch.cascade import CascadeConfigured, init_controller
    from mpctsid_tpu_torch.env.plant import ContactParams, PlantState
    from mpctsid_tpu_torch.model.gaits import GAIT_IDS
    from mpctsid_tpu_torch.model.solo12 import SOLO12
    from mpctsid_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    model = SOLO12
    cc = CascadeConfigured(model, cfg)
    q0 = np.zeros((B, 19), np.float32)
    q0[:, 2] = model.h_ref
    q0[:, 6] = 1.0
    q0[:, 7:] = model.q_stand

    names = gait_mix or [cfg.gait]
    gids_np = np.array([GAIT_IDS[names[i % len(names)]] for i in range(B)],
                       np.int32)
    plant = PlantState.init(q0, device=dev)

    rng = np.random.default_rng(seed)
    vmax = np.where(gids_np == GAIT_IDS.get("static", -1), 0.0, 1.0)
    vc = torch.as_tensor(np.stack([
        rng.uniform(0.0, 0.35, B) * vmax,
        rng.uniform(-0.1, 0.1, B) * vmax,
        rng.uniform(-0.3, 0.3, B) * vmax], -1).astype(np.float32)).to(dev)
    cp = ContactParams.default(B, device=dev)
    if mu_spread:
        cp.mu = torch.as_tensor(rng.uniform(0.4, 1.0, B).astype(np.float32)
                                ).to(dev)
    gid = torch.as_tensor(gids_np).to(dev)
    # the controller's initial vertical-force warm start assumes each
    # scenario's mass, payload included (as sweep.py does)
    if payload_spread:
        payload = rng.uniform(0.0, 0.5, B).astype(np.float32)
        ctl = init_controller(model, cfg, cc.tree, q0, gids_np,
                              payload=payload, device=dev)
        return cc, (ctl, plant, gid, vc, cp,
                    torch.as_tensor(payload).to(dev))
    ctl = init_controller(model, cfg, cc.tree, q0, gids_np, device=dev)
    return cc, (ctl, plant, gid, vc, cp)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def diff_time(make_run, n_short, n_long, reps=3):
    """Median differential seconds per unit between n_short and n_long.
    make_run(n)() runs n units and returns a tensor, which is read on the
    host (the read waits for the device)."""
    run_s = make_run(n_short)
    run_l = make_run(n_long)
    run_s().item()   # capture + warm
    run_l().item()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run_s().item()
        t_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_l().item()
        t_l = time.perf_counter() - t0
        ts.append((t_l - t_s) / (n_long - n_short))
    return float(np.median(ts))


def cascade_guards(metrics: dict, v_cmd) -> dict:
    """The correctness guards of a rollout's metrics (numpy, (B, periods,
    ...)) under commands v_cmd (B, 3), the JAX bench's formulas and
    rounding."""
    x = np.asarray(metrics["x_srb"])
    # velocity tracking (upright_frac alone scores a standing robot 1.0):
    # body-frame forward velocity vs the commanded vx, averaged over the
    # second half of the rollout (the first periods are transient from
    # standstill)
    vc = np.asarray(v_cmd)
    h = x.shape[1] // 2
    yaw = x[:, h:, 5]
    vx_body = (np.cos(yaw) * x[:, h:, 6] + np.sin(yaw) * x[:, h:, 7])
    vx_err = np.abs(vx_body - vc[:, None, 0]).mean()
    # transient-insensitive companion: the fraction of the commanded forward
    # velocity reached in steady state (mean of the last 8 periods: a single
    # last state aliases the within-gait oscillation), over scenarios with a
    # meaningful command.  A standing batch scores ~0 here however long the
    # rollout.
    moving = np.abs(vc[:, 0]) > 0.05
    if moving.any():
        vx_ss = vx_body[moving, -8:].mean(axis=1)
        frac = np.clip(vx_ss / vc[moving, 0], 0.0, 1.5)
        vx_track = float(frac.mean())
    else:
        vx_track = 1.0
    return {
        "upright_frac": round(float((x[:, -1, 2] > 0.15).mean()), 4),
        "mean_vx_err": round(float(vx_err), 4),
        "vx_track_frac": round(vx_track, 3),
        "mean_mpc_res": float(np.asarray(metrics["mpc_prim_res"]).mean()),
        # the dual (stationarity) residual and the WBC success fraction: a
        # primal residual of 0.0 proves nothing for strictly interior
        # solutions
        "mean_mpc_dual_res": float(
            f"{np.asarray(metrics['mpc_dual_res']).mean():.3g}"),
        "wbc_ok_frac": round(
            float(np.asarray(metrics["wbc_ok_frac"]).mean()), 4),
        "mpc_fail_frac": round(
            float((~np.asarray(metrics["mpc_ok"])).mean()), 4),
    }


def measure_cascade(cc, args, periods=5, reps=3):
    """(ticks_per_s, guards) for a batched cascade rollout on the device the
    batch lies on.

    args: 5-tuple (ctl, plant, gid, v_cmd, cp) or 6-tuple with a trailing
    per-scenario payload (build_batch payload_spread=True)."""
    from mpctsid_tpu_torch.cascade import (cascade_rollout_graphed,
                                           period_runner)

    ctl, plant, gid, vc, cp = args[:5]
    payload = args[5] if len(args) == 6 else None
    dev = plant.q.device
    B = int(gid.shape[0])
    mpc_every = cc.cfg.cascade.mpc_every

    def rollout(n):
        return cascade_rollout_graphed(cc, ctl, plant, gid, vc, cp,
                                       n_periods=n, payload=payload,
                                       device=dev)[2]

    def make_run(n):
        return lambda: rollout(n)["x_srb"].sum()

    # the runner is cached by batch and configuration, not by n_periods:
    # the short, the long and the guard rollouts replay this one capture
    runner = period_runner(cc, ctl, plant, gid, cp, payload=payload,
                           device=dev)
    print(f"  B={B}: period captured in {runner.call.capture_seconds:.2f} s",
          file=sys.stderr, flush=True)
    per_period = max(diff_time(make_run, 1, periods + 1, reps), 1e-9)
    ticks_per_s = B * mpc_every / per_period

    # the guards: the same batch over a LONGER rollout than the timed one
    metrics = rollout(max(periods + 1, GUARD_PERIODS))
    metrics = {k: t.cpu().numpy() for k, t in metrics.items()}
    return ticks_per_s, cascade_guards(metrics, vc.cpu().numpy())


def _mpc_qp_batch(cc, args):
    """The batch's (B, ...) MPC QPs (P, q, A, l, u) from its initial states,
    at gait phase 0."""
    from mpctsid_tpu_torch import dyn
    from mpctsid_tpu_torch.cascade.engine import srb_state
    from mpctsid_tpu_torch.mpc.srb import build_mpc_qp, reference_rollout
    from mpctsid_tpu_torch.plan.footsteps import plan_footsteps_horizon
    from mpctsid_tpu_torch.plan.gait import contacts_horizon

    model, cfg = cc.model, cc.cfg
    _, plant, gid, vc = args[:4]
    x_srb = srb_state(plant.q, plant.v)
    feet = dyn.foot_positions(cc.tree, plant.q)
    phase = torch.zeros_like(gid, dtype=torch.int32)
    fsteps, _ = plan_footsteps_horizon(model, cfg.mpc, cfg.cascade, gid,
                                       phase, x_srb, vc, feet)
    x_ref = reference_rollout(model, cfg.mpc, x_srb, vc)
    cont = contacts_horizon(gid, phase, cfg.mpc.horizon, x_srb.dtype)
    return build_mpc_qp(model, cfg.mpc, x_srb, x_ref, fsteps, cont)


def _solve_chain(qp, backend, iters, adapt_rounds, name):
    """One warm-started step of a chain of MPC solves (their A declared
    block diagonal, `MPC_A_BLOCKS`), captured on the card
    (`CapturedCall`): the solution is written back into the static x and y
    that the next step starts from, and each step's cost moves by
    1e-7 * mean(x), a data dependency between the steps.  Returns (call,
    make_run); make_run(n)() starts the chain from zero, runs n steps and
    returns sum(x)."""
    from mpctsid_tpu_torch.mpc.srb import MPC_A_BLOCKS
    from mpctsid_tpu_torch.qp.admm import admm_solve
    from mpctsid_tpu_torch.utils.graphs import CapturedCall

    P, q, A, l, u = qp

    def step(x, y):
        sol = admm_solve(P, q + 1e-7 * x.mean(dim=-1, keepdim=True), A, l, u,
                         x0=x, y0=y, iters=iters, adapt_rounds=adapt_rounds,
                         rho=0.1, backend=backend, a_blocks=MPC_A_BLOCKS)
        x.copy_(sol.x)
        y.copy_(sol.y)
        return x

    call = CapturedCall(step, {"x": torch.zeros_like(q),
                               "y": torch.zeros_like(l)}, q.device, name)

    def make_run(n):
        def run():
            call.inputs["x"].zero_()
            call.inputs["y"].zero_()
            for _ in range(n):
                x = call()
            return x.sum()
        return run

    return call, make_run


def measure_latency(device="cuda", inspect=None):
    """B = 1 times against the 2 ms tick budget: ms per full cascade tick
    (WBC QP + plant + amortized MPC) and ms per standalone MPC QP solve per
    backend, both differential; and the p50 of one one-period call ended
    by a host read.

    The tick is the BATCHED path at B = 1 (a graphed period over 20); the
    deployment path's compute() is `measure_host_loop`'s.  inspect(name,
    replay), when given, is called with each MPC chain's one-step replay
    before the chain is closed."""
    from mpctsid_tpu_torch.cascade import cascade_rollout_graphed
    from mpctsid_tpu_torch.config import EngineConfig
    from mpctsid_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    cfg = EngineConfig(gait="trot", v_ref=(0.3, 0.0, 0.0))
    cc, (ctl, plant, gid, vc, cp) = build_batch(cfg, 1, device=dev)

    # --- full cascade tick (B = 1) -----------------------------------------
    def make_run_tick(n):
        return lambda: cascade_rollout_graphed(
            cc, ctl, plant, gid, vc, cp, n_periods=n,
            device=dev)[2]["x_srb"].sum()

    per_period = diff_time(make_run_tick, 2, 12, reps=5)
    tick_ms = per_period / cfg.cascade.mpc_every * 1e3

    # --- standalone MPC QP solve (B = 1), a warm-started chain -------------
    qp = _mpc_qp_batch(cc, (ctl, plant, gid, vc))
    # "auto_mpc" is the production resolution (kernel 1 on the card); the
    # winner is reported so that the config presets can cite it
    backends = CARD_MPC_BACKENDS if dev.type == "cuda" else ("xla",)
    mpc_by_backend = {}
    for be in backends:
        call, make_run = _solve_chain(qp, be, cfg.solver.mpc_iters,
                                      cfg.solver.mpc_adapt_rounds,
                                      f"MPC solve chain ({be}, B=1)")
        try:
            mpc_by_backend[be] = round(
                diff_time(make_run, 2, 22, reps=5) * 1e3, 4)
            if inspect is not None:
                inspect(f"measure_latency:{be}", call)
        finally:
            call.close()
    best_backend = min(mpc_by_backend, key=mpc_by_backend.get)
    mpc_ms = mpc_by_backend[next(iter(mpc_by_backend))]

    # p50 of a single one-period call, host read included (for context)
    def one():
        return cascade_rollout_graphed(cc, ctl, plant, gid, vc, cp,
                                       n_periods=1, device=dev)[2]

    one()["x_srb"].sum().item()
    e2e = []
    for _ in range(7):
        t0 = time.perf_counter()
        one()["x_srb"].sum().item()
        e2e.append(time.perf_counter() - t0)
    dispatch_ms = float(np.median(e2e)) * 1e3

    return {
        "tick_ms_p50": round(tick_ms, 4),
        "mpc_solve_ms_p50": round(mpc_ms, 4),
        "mpc_ms_by_backend": mpc_by_backend,
        "best_mpc_backend_B1": best_backend,
        "budget_ms": TICK_BUDGET_MS,
        "rt_headroom": round(TICK_BUDGET_MS / max(tick_ms, 1e-9), 1),
        "e2e_dispatch_ms_p50": round(dispatch_ms, 2),
    }


def measure_host_loop(n_ticks=300, device="cuda"):
    """Deployment-path loop rate: HostController.compute (its four captured
    graphs) with async MPC, driven by the native RtExecutor.

    Reports the free-running rate, and RtExecutor's jitter and overrun
    statistics at the 1 kHz contract period and at the achievable period
    (1.25x the free-running mean)."""
    from mpctsid_tpu_torch.config import EngineConfig
    from mpctsid_tpu_torch.host import HostController
    from mpctsid_tpu_torch.model.solo12 import SOLO12
    from mpctsid_tpu_torch.native import RtExecutor

    cfg = EngineConfig(gait="trot", v_ref=(0.2, 0.0, 0.0))
    q0 = np.zeros(19, np.float32)
    q0[2] = SOLO12.h_ref
    q0[6] = 1.0
    q0[7:] = SOLO12.q_stand
    hc = HostController(SOLO12, cfg, q0, async_mpc=True, device=device)
    q = np.asarray(q0)
    v = np.zeros(18, np.float32)
    try:
        for _ in range(30):                    # warm every graph
            hc.compute(q, v)
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            hc.compute(q, v)
        per = (time.perf_counter() - t0) / n_ticks
        hz = 1.0 / per

        ex1k = RtExecutor(0.001)
        ex1k.run(100, lambda k: hc.compute(q, v))
        s1k = ex1k.stats

        exa = RtExecutor(per * 1.25)
        exa.run(n_ticks, lambda k: hc.compute(q, v))
        sa = exa.stats
    finally:
        # the planner thread must be gone before anything captures again
        hc.close()
    return {
        "host_loop_hz": round(hz, 1),
        "budget_hz": 1000.0,
        "rt_1khz_overrun_frac": round(s1k["overruns"]
                                      / max(s1k["ticks"], 1), 3),
        "rt_sustainable_period_ms": round(per * 1.25 * 1e3, 2),
        "rt_sustainable_overrun_frac": round(sa["overruns"]
                                             / max(sa["ticks"], 1), 3),
        "rt_mean_jitter_us": round(sa["mean_jitter_us"], 1),
        "rt_max_jitter_us": round(sa["max_jitter_us"], 1),
    }


def _pallas_vs_xla(B=1024, iters=100, device="cuda", inspect=None):
    """Seconds per MPC ADMM solve of one B-scenario batch through the plain
    backend ("xla") and kernel 5 ("pallas"), each a captured chain of
    warm-started solves timed 1 against 4."""
    from mpctsid_tpu_torch.config import EngineConfig

    cfg = EngineConfig(gait="trot", v_ref=(0.3, 0.0, 0.0))
    cc, args = build_batch(cfg, B, device=device)
    qp = _mpc_qp_batch(cc, args)
    out = {}
    for backend in ("xla", "pallas"):
        call, make_run = _solve_chain(qp, backend, iters, 2,
                                      f"MPC solve chain ({backend}, B={B})")
        try:
            out[backend] = diff_time(make_run, 1, 4, reps=3) / B
            if inspect is not None:
                inspect(f"pallas_vs_xla:{backend}", call)
        finally:
            call.close()
    return out


# ---------------------------------------------------------------------------
# preset benchmarks (BASELINE.json:7-11; config presets in config.py PRESETS)
# ---------------------------------------------------------------------------

def _sharded_rank(rank: int, world: int, device_type: str, init_method: str,
                  B: int) -> None:
    """One rank of config5 (runs in its own interpreter): the B-scenario
    config5 batch split over the group, timed 3 periods against 1; rank 0
    prints the JSON line."""
    import dataclasses

    import torch.distributed as dist

    from mpctsid_tpu_torch.config import PRESETS
    from mpctsid_tpu_torch.dist import (init_scenario_group, shard_scenarios,
                                        sharded_cascade_rollout)

    dev = (torch.device("cuda", rank) if device_type == "cuda"
           else torch.device("cpu"))
    if device_type == "cpu":
        torch.set_num_threads(1)
    group = init_scenario_group(dev, init_method, rank, world)
    try:
        cfg = dataclasses.replace(PRESETS["config5_multihost_32k"], batch=B)
        cc, args = build_batch(cfg, B, device=dev)
        args = shard_scenarios(args, rank, world)

        def run(n):
            summary = sharded_cascade_rollout(cc, n_periods=n, group=group,
                                              device=dev)(*args)[3]
            return {k: t.item() for k, t in summary.items()}

        run(1)                                 # capture + warm
        t0 = time.perf_counter()
        run(1)
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        s_final = run(3)
        t3 = time.perf_counter() - t0
        per_period = max((t3 - t1) / 2, 1e-9)
        if rank == 0:
            print(json.dumps({
                "ticks_per_s": round(B * cfg.cascade.mpc_every / per_period,
                                     1),
                "batch": B,
                "n_devices": world,
                "protocol": "differential 3-vs-1 period",
                "upright_frac": round(s_final["n_upright"]
                                      / s_final["n_total"], 4),
                "max_mpc_prim_res": s_final["max_mpc_prim_res"],
                "n_mpc_fail": s_final["n_mpc_fail"],
            }), flush=True)
    finally:
        dist.destroy_process_group()


def measure_sharded(B: int, device="cuda") -> dict:
    """config5: `sharded_cascade_rollout` over one process per card (NCCL),
    or two gloo processes on the CPU; the JSON line of rank 0."""
    from mpctsid_tpu_torch.entry import _free_port, run_ranks
    from mpctsid_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    world = torch.cuda.device_count() if dev.type == "cuda" else 2
    init_method = f"tcp://localhost:{_free_port()}"
    out = run_ranks("from mpctsid_tpu_torch.bench import _sharded_rank; "
                    f"_sharded_rank({{rank}}, {world}, {dev.type!r}, "
                    f"{init_method!r}, {B})", world, RANK_TIMEOUT_S)
    return json.loads(out.strip().splitlines()[-1])


def run_presets(device="cuda", inspect=None):
    """The preset rows (the JAX bench's): config1 latency + host loop,
    config2 gait mix, config3 friction and payload spread, config4 B = 4096,
    config5 sharded, and on the card kernel 5 against the plain backend.
    inspect: passed to measure_latency and the kernel 5 comparison."""
    from mpctsid_tpu_torch.config import PRESETS
    from mpctsid_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    rows = []

    def add(name, metric, value, unit, extra=None):
        row = {"config": name, "metric": metric,
               "value": round(value, 2), "unit": unit}
        row.update(extra or {})
        rows.append(row)
        print(f"  {name}: {metric} = {row['value']} {unit} "
              f"{extra or ''}", file=sys.stderr, flush=True)

    # config1: single-rollout trot, latency vs the 2 ms tick, B = 1 backend
    # A/B, and the deployment host-loop rate under the native RtExecutor
    lat = measure_latency(dev, inspect)
    _release(dev)
    extra1 = {"budget_ms": lat["budget_ms"],
              "mpc_solve_ms_p50": lat["mpc_solve_ms_p50"],
              "mpc_ms_by_backend": lat["mpc_ms_by_backend"],
              "best_mpc_backend_B1": lat["best_mpc_backend_B1"],
              "e2e_dispatch_ms_p50": lat["e2e_dispatch_ms_p50"]}
    try:
        extra1.update(measure_host_loop(device=dev))
    except Exception as e:     # recorded in the row, as the JAX bench does
        extra1["host_loop_error"] = str(e)[:200]
    add("config1_trot_single", "p50 cascade tick latency", lat["tick_ms_p50"],
        "ms", extra1)

    # config2: 256-scenario gait sweep (trot/walk/bound/static as
    # per-scenario data)
    cfg = PRESETS["config2_gait_sweep"]
    cc, args = build_batch(cfg, cfg.batch if on_card else CPU_B,
                           gait_mix=["trot", "walk", "bound", "static"],
                           device=dev)
    tps, guards = measure_cascade(cc, args, periods=5)
    _release(dev)
    add("config2_gait_sweep", "cascade ticks/s (mixed gaits)", tps,
        "solves/s", guards)

    # config3: robustness, friction AND payload spread at once, warm-started
    # cascade (BASELINE.json:9 "mu/load perturbation batches")
    cfg = PRESETS["config3_robustness"]
    cc, args = build_batch(cfg, cfg.batch if on_card else CPU_B,
                           mu_spread=True, payload_spread=True, device=dev)
    tps, guards = measure_cascade(cc, args, periods=5)
    _release(dev)
    add("config3_robustness",
        "cascade ticks/s (mu in [0.4,1.0], payload in [0,0.5] kg)", tps,
        "solves/s", guards)

    # config4: 4k-scenario cascade on one card
    cfg = PRESETS["config4_cascade_4k"]
    cc, args = build_batch(cfg, cfg.batch if on_card else CPU_B, device=dev)
    tps, guards = measure_cascade(cc, args, periods=3)
    _release(dev)
    add("config4_cascade_4k", "cascade ticks/s (B=4096, 1 card)", tps,
        "solves/s", guards)

    # config5: the sharded path, one process per card
    B5 = SHARDED_B if on_card else CPU_B
    if on_card:
        n_cards = torch.cuda.device_count()
        where, name5 = (f"{n_cards} card(s), NCCL",
                        f"config5_sharded_B{B5}_{n_cards}card")
    else:
        where, name5 = "2 CPU processes, gloo", f"config5_sharded_B{B5}_2cpu"
    try:
        sub = measure_sharded(B5, dev)
        add(name5, f"sharded cascade ticks/s ({where})", sub["ticks_per_s"],
            "solves/s", {k: sub[k] for k in sub if k != "ticks_per_s"})
    except (RuntimeError, ValueError, IndexError) as e:
        add(name5, f"sharded cascade ({where}) FAILED", -1.0, "",
            {"stderr": str(e)[-400:]})

    # kernel 5 vs the plain backend on the MPC QP inner loop
    if on_card:
        pv = _pallas_vs_xla(B=1024, iters=100, device=dev, inspect=inspect)
        _release(dev)
        add("pallas_vs_xla", "MPC ADMM solve time, xla backend",
            pv["xla"] * 1e6, "us/solve")
        add("pallas_vs_xla", "MPC ADMM solve time, pallas backend",
            pv["pallas"] * 1e6, "us/solve",
            {"speedup_vs_xla": round(pv["xla"] / pv["pallas"], 2)})

    return rows


def _device_line(device) -> str:
    if torch.device(device).type == "cuda":
        return f"`{nvidia_smi_line()}` (nvidia-smi name, power.limit)"
    return "the CPU (`--cpu`: the kernels' plain versions, no device metric)"


def write_results(headline_row, rows, out_dir=DEFAULT_OUT, device="cuda"):
    """BENCH_DETAIL_TORCH.json and RESULTS_TORCH.md into out_dir."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    detail = {"headline": headline_row, "presets": rows}
    with open(out_dir / "BENCH_DETAIL_TORCH.json", "w") as f:
        json.dump(detail, f, indent=1)
    lines = [
        "# RESULTS_TORCH — measured benchmarks of mpctsid_tpu_torch",
        "",
        f"Device: {_device_line(device)}; measurement protocol as the JAX "
        "bench's (differential timing of graphed rollouts, median of reps; "
        "correctness guards computed on the timed batch).",
        "",
        "| Config | Metric | Value | Unit | Guards/notes |",
        "|---|---|---|---|---|",
    ]

    def fmt(row):
        extra = {k: v for k, v in row.items()
                 if k not in ("config", "metric", "value", "unit")}
        return (f"| {row['config']} | {row['metric']} | {row['value']:,} "
                f"| {row['unit']} | {extra} |")

    lines.append(fmt(headline_row))
    lines += [fmt(r) for r in rows]
    lines += [
        "",
        "Guard notes: `mean_mpc_res` (primal residual) is legitimately 0.0 "
        "when the trot MPC solution is strictly interior to the clipped "
        "friction/force bounds; `mean_mpc_dual_res` (the stationarity "
        "residual) is the guard that tracks solver accuracy, and "
        "`mean_vx_err` (body-frame forward-velocity tracking error vs the "
        "command, second half of the rollout) keeps a standing-still batch "
        "from scoring a clean headline.",
        "",
        "Scaling notes: the cascade is scenario-data-parallel; the only "
        "cross-card traffic is the all-reduced residual and metric summary "
        "(dist/mesh.py).  The config5 row ran one process per card of this "
        "machine; its name says how many.",
    ]
    with open(out_dir / "RESULTS_TORCH.md", "w") as f:
        f.write("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------

def batch_sweep(sizes=(256, 1024, 4096, 8192), device="cuda",
                out_dir=DEFAULT_OUT):
    """Trot-only single-card throughput at several batch sizes ->
    SCALING_TORCH.json in out_dir.  The same workload at every point; an
    error at the capacity edge is recorded for its size."""
    from mpctsid_tpu_torch.config import EngineConfig
    from mpctsid_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    cfg = EngineConfig(gait="trot", v_ref=(0.3, 0.0, 0.0))
    out = {}
    for B in sizes:
        try:
            cc, args = build_batch(cfg, B, device=dev)
            tps, guards = measure_cascade(
                cc, args, periods=5 if B <= 1024 else 3)
            out[str(B)] = {"ticks_per_s": round(tps, 1), **guards}
        except Exception as e:  # e.g. out of device memory at the edge
            out[str(B)] = {"error": str(e)[:300]}
        finally:
            _release(dev)
        print(f"  B={B}: {out[str(B)]}", file=sys.stderr, flush=True)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "SCALING_TORCH.json", "w") as f:
        json.dump(out, f, indent=1)
    return out


def _headline_batch(device) -> int:
    return HEADLINE_B if torch.device(device).type == "cuda" else CPU_B


def headline(profile_dir=None, device="cuda"):
    """The headline row: B = 1024 trot cascade ticks/s on the card (B = 16
    on the CPU) with its guards.  profile_dir: a torch.profiler trace
    (Chrome format, CPU and CUDA activities) of the whole measurement is
    written there, `headline_trace.json`.  It holds every kernel of every
    replayed period (about 136 thousand a period with the plain WBC), so
    at B = 1024 it runs to gigabytes, and the profiler slows the timed
    periods: the row's value is not the unprofiled headline."""
    from mpctsid_tpu_torch.config import EngineConfig
    from mpctsid_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    B = _headline_batch(dev)
    cfg = EngineConfig(gait="trot", v_ref=(0.3, 0.0, 0.0))
    cc, args = build_batch(cfg, B, device=dev)
    if profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            tps, guards = measure_cascade(cc, args, periods=5)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir,
                                              "headline_trace.json"))
    else:
        tps, guards = measure_cascade(cc, args, periods=5)
    row = {
        "metric": "cascade MPC+TSID control ticks/s per card "
                  f"(B={B}, trot, incl. MPC QP + WBC QP + plant)",
        "value": round(tps, 1),
        "unit": "solves/s",
        "vs_baseline": round(tps / TARGET, 2),
    }
    row.update(guards)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--latency", action="store_true")
    ap.add_argument("--batch-sweep", action="store_true")
    ap.add_argument("--profile", metavar="DIR", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--out", metavar="DIR", default=str(DEFAULT_OUT),
                    help="where the results files go")
    a = ap.parse_args(argv)

    from mpctsid_tpu_torch.utils import enforce_f32_matmuls, resolve_device

    enforce_f32_matmuls()
    device = resolve_device("cpu" if a.cpu else "cuda")
    if a.latency:
        print(json.dumps({"metric": "p50 single-solve latency",
                          **measure_latency(device)}))
        return 0
    if a.batch_sweep:
        print(json.dumps({"metric": "trot-only batch sweep",
                          **batch_sweep(device=device, out_dir=a.out)}))
        return 0

    row = headline(profile_dir=a.profile, device=device)
    _release(device)
    if a.full:
        print("presets:", file=sys.stderr)
        rows = run_presets(device)
        hrow = {"config": f"headline_B{_headline_batch(device)}_trot", **row}
        write_results(hrow, rows, a.out, device)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
