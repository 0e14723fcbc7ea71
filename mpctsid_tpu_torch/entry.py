"""Entry points of the port: the single-card forward step and the
sharded dry run (counterparts of the repository's `__graft_entry__.py`).

    from mpctsid_tpu_torch.entry import entry, dryrun_multichip
    fn, args = entry()             # one cascade period over 8 trot scenarios
    x_srb = fn(*args)
    dryrun_multichip(4)            # 5 sharded periods, 8 scenarios, 4 cards

`entry(device)` returns (fn, args): fn runs ONE full MPC + TSID cascade
period (plan -> centroidal MPC QP -> 20 WBC QPs + plant ticks) over a B = 8
trot batch on `device` and returns the periods' SRB states.

`dryrun_multichip(n, device)` runs one sharded 5-period cascade over 2n
scenarios with heterogeneous commands, one process per rank (NCCL, one card
each, on "cuda"; gloo on "cpu"), and asserts that every scenario stays
upright and every MPC solve succeeds.  On "cuda" it needs n cards and raises
with fewer: it does not move to the CPU.  Each rank is a fresh interpreter
with a time limit; a rank that would start ranks of its own refuses (depth
guard).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mpctsid_tpu_torch.utils import enforce_f32_matmuls, resolve_device

__all__ = ["entry", "dryrun_multichip", "run_ranks"]

_CHILD_ENV = "_MPCTSID_TORCH_DRYRUN_CHILD"
RANK_TIMEOUT_S = 600


def _example_batch(B: int, cfg, model, device, v_cmd=None):
    """(cc, (ctl, plant, gait_id, v_cmd, contact_params)): B copies of the
    standing robot on `device`, commands v_cmd (B, 3) or cfg.v_ref."""
    from mpctsid_tpu_torch.cascade import CascadeConfigured, init_controller
    from mpctsid_tpu_torch.env.plant import ContactParams, PlantState
    from mpctsid_tpu_torch.model.gaits import GAIT_IDS

    cc = CascadeConfigured(model, cfg)
    q0 = np.zeros((B, 19), np.float32)
    q0[:, 2] = model.h_ref
    q0[:, 6] = 1.0
    q0[:, 7:] = model.q_stand
    gid = np.full((B,), GAIT_IDS[cfg.gait], np.int32)
    ctl = init_controller(model, cfg, cc.tree, q0, gid, device=device)
    plant = PlantState.init(q0, device=device)
    if v_cmd is None:
        v_cmd = np.tile(np.asarray(cfg.v_ref, np.float32), (B, 1))
    vc = torch.as_tensor(v_cmd, dtype=torch.float32).to(device)
    cp = ContactParams.default(B, device=device)
    return cc, (ctl, plant, torch.as_tensor(gid).to(device), vc, cp)


def entry(device="cuda"):
    """(fn, example_args): one cascade period over a B = 8 trot batch."""
    from mpctsid_tpu_torch.cascade import cascade_period
    from mpctsid_tpu_torch.config import EngineConfig
    from mpctsid_tpu_torch.model.solo12 import SOLO12

    enforce_f32_matmuls()
    dev = resolve_device(device)
    cfg = EngineConfig(gait="trot", v_ref=(0.3, 0.0, 0.0))
    cc, args = _example_batch(8, cfg, SOLO12, dev)

    def fn(ctl, plant, gait_id, v_cmd, contact_params):
        _, _, _, metrics = cascade_period(cc, ctl, plant, gait_id, v_cmd,
                                          contact_params)
        return metrics["x_srb"]

    return fn, args


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(call: str, n_ranks: int,
              timeout_s: float = RANK_TIMEOUT_S) -> str:
    """Run the Python statement `call` (with `{rank}` in it) in `n_ranks`
    fresh interpreters at the repository root, all started together, each
    with the time limit `timeout_s`; returns rank 0's standard output and
    raises RuntimeError naming every rank that failed.  A rank that would
    start ranks of its own refuses (depth guard)."""
    if os.environ.get(_CHILD_ENV):
        raise RuntimeError("run_ranks was called inside one of its own "
                           "ranks; refusing to start ranks of ranks")
    env = dict(os.environ, **{_CHILD_ENV: "1"})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = []
    logs = []
    try:
        for rank in range(n_ranks):
            # files, not pipes: a rank blocked on a full pipe would stall
            # the collective the others wait in
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile(
                "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", call.format(rank=rank)], env=env,
                cwd=root, text=True, stdout=out, stderr=err))
        deadline = time.monotonic() + timeout_s
        failures = []
        for rank, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                failures.append(f"rank {rank} did not finish in "
                                f"{timeout_s} s")
                continue
            if p.returncode != 0:
                err = logs[rank][1]
                err.seek(0)
                failures.append(f"rank {rank} exited {p.returncode}: "
                                f"{err.read()[-2000:]}")
        if failures:
            raise RuntimeError("\n".join(failures))
        out = logs[0][0]
        out.seek(0)
        return out.read()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in logs:
            out.close()
            err.close()


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One sharded 5-period cascade over 2 * n_devices scenarios, one
    process per rank; prints the OK line, raises on any failure."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}, device='cuda') needs "
            f"{n_devices} cards, this machine has "
            f"{torch.cuda.device_count()}; pass device='cpu' for gloo "
            "processes on the CPU")
    init_method = f"tcp://localhost:{_free_port()}"
    try:
        out = run_ranks("from mpctsid_tpu_torch.entry import _dryrun_rank; "
                        f"_dryrun_rank({{rank}}, {n_devices}, {dev.type!r}, "
                        f"{init_method!r})", n_devices)
    except RuntimeError as e:
        raise RuntimeError(f"dryrun_multichip failed:\n{e}") from e
    sys.stdout.write(out)


def _dryrun_rank(rank: int, world: int, device_type: str,
                 init_method: str) -> None:
    """One rank of `dryrun_multichip` (runs in its own interpreter)."""
    import torch.distributed as dist

    from mpctsid_tpu_torch.config import EngineConfig
    from mpctsid_tpu_torch.dist import (init_scenario_group, shard_scenarios,
                                        sharded_cascade_rollout)
    from mpctsid_tpu_torch.model.solo12 import SOLO12

    torch.set_num_threads(1)
    enforce_f32_matmuls()
    dev = (torch.device("cuda", rank) if device_type == "cuda"
           else torch.device("cpu"))
    group = init_scenario_group(dev, init_method, rank, world)
    try:
        cfg = EngineConfig(gait="trot", v_ref=(0.3, 0.0, 0.0))
        B = 2 * world
        # heterogeneous commands, so that the dry run exercises real
        # per-scenario divergence, not B copies of one trajectory
        rng = np.random.default_rng(0)
        vc = np.stack([rng.uniform(0.1, 0.3, B), rng.uniform(-0.05, 0.05, B),
                       rng.uniform(-0.2, 0.2, B)], -1).astype(np.float32)
        cc, args = _example_batch(B, cfg, SOLO12, dev, v_cmd=vc)
        args = shard_scenarios(args, rank, world)
        # full production solver settings over 5 MPC periods (100 WBC ticks)
        run = sharded_cascade_rollout(cc, n_periods=5, group=group,
                                      device=dev)
        _, _, _, summary = run(*args)
        n_total = int(summary["n_total"])
        n_up = int(summary["n_upright"])
        if n_total != B:
            raise RuntimeError(f"n_total {n_total}, expected {B}")
        if n_up != B:
            raise RuntimeError(f"only {n_up}/{B} scenarios upright after 5 "
                               "periods")
        if float(summary["n_mpc_fail"]) != 0.0:
            raise RuntimeError(f"{float(summary['n_mpc_fail'])} scenarios "
                               "with a failed MPC solve")
        if rank == 0:
            print(f"dryrun_multichip({world}): OK — {B} scenarios, "
                  f"{n_up} upright, mean MPC residual "
                  f"{float(summary['mean_mpc_prim_res']):.2e}, max "
                  f"{float(summary['max_mpc_prim_res']):.2e}", flush=True)
    finally:
        dist.destroy_process_group()
