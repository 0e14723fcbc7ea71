"""Scenario sharding over processes with `torch.distributed` (counterpart of
the JAX package's dist/mesh.py, which shards over a device mesh).

The engine's parallel dimension is the SCENARIO batch: the cascade is
embarrassingly parallel across scenarios, so each process (one per card)
runs `cascade_rollout_graphed` on its slice of the batch (one CUDA graph
per period on its card, where the JAX module jits the sharded rollout), and
cross-process communication is used only for the global reductions the
contract names: batch-wide QP residual summaries and Monte-Carlo metric
aggregation.  Where
the JAX module writes `psum` / `pmax` / `pmin` over the mesh axis, this one
calls `all_reduce` with SUM / MAX / MIN over a process group: NCCL on CUDA,
gloo on the CPU.

Deliberate non-feature, as in the JAX module: NO collectives inside the QP
solves.  Scenarios are independent problems; a cross-process reduction
inside the ADMM loop would couple their convergence for no algorithmic
benefit and serialize every iteration on the slowest process.

The process group is the caller's to set up: nothing here discovers a
cluster.  `init_scenario_group` takes the address (`init_method`, e.g.
``tcp://localhost:<port>`` or ``file:///path``), the rank and the world size.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from mpctsid_tpu_torch.cascade.engine import CascadeConfigured
from mpctsid_tpu_torch.cascade.graphed import cascade_rollout_graphed
from mpctsid_tpu_torch.utils import resolve_device

__all__ = ["init_scenario_group", "shard_scenarios",
           "shard_scenarios_multihost", "sharded_cascade_rollout",
           "scenario_summary", "tree_map"]


def init_scenario_group(device, init_method: str, rank: int,
                        world_size: int):
    """Join the scenario process group: NCCL when `device` is CUDA (the
    process's card becomes the current device), gloo on the CPU.  Returns
    the default group."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is not None:
            torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return dist.group.WORLD


def tree_map(fn, tree):
    """Apply `fn` to every tensor / ndarray leaf of nested tuples, lists,
    dicts and dataclasses; other leaves are returned as they are."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, t) for k, t in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def _leading_sizes(tree) -> set:
    sizes = set()

    def note(x):
        sizes.add(x.shape[0])
        return x

    tree_map(note, tree)
    return sizes


def shard_scenarios(tree, rank: int, world: int):
    """This rank's slice of a global (B, ...) batch: scenarios
    [rank * B / world, (rank + 1) * B / world) of every leaf."""
    sizes = _leading_sizes(tree)
    if len(sizes) != 1:
        raise ValueError(f"leaves disagree on the batch size: {sorted(sizes)}")
    (B,) = sizes
    if B % world:
        raise ValueError(f"B = {B} scenarios do not split over {world} ranks")
    per = B // world
    return tree_map(lambda x: x[rank * per:(rank + 1) * per], tree)


def shard_scenarios_multihost(tree, group=None):
    """Multi-process form: each process passes ITS (B_local, ...) slice and
    gets it back as it is, after an `all_gather` has checked that every rank
    holds the same B_local (the summaries assume equal shards)."""
    sizes = _leading_sizes(tree)
    if len(sizes) != 1:
        raise ValueError(f"leaves disagree on the batch size: {sorted(sizes)}")
    (b_local,) = sizes
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    mine = torch.tensor([b_local], dtype=torch.int64, device=dev)
    every = [torch.zeros_like(mine)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(every, mine, group=group)
    got = [int(t) for t in every]
    if len(set(got)) != 1:
        raise ValueError(f"ranks hold different B_local: {got}")
    return tree


def scenario_summary(metrics: dict, reduce) -> dict:
    """The global summary of a rollout's (B_local, n_periods, ...) metrics,
    the JAX module's formulas; `reduce(tensor, op)` with op "sum", "max" or
    "min" reduces a 0-d tensor over all ranks (the identity for one
    process)."""
    prim = metrics["mpc_prim_res"]
    tau_rms = metrics["tau_rms"]
    n_local = torch.tensor(float(prim.shape[0]), dtype=prim.dtype,
                           device=prim.device)
    n_total = reduce(n_local, "sum")
    return {
        "mean_mpc_prim_res": reduce(prim.sum(), "sum") / (
            n_total * prim.shape[1]),
        # global convergence monitor: the worst primal residual of every
        # scenario on every rank
        "max_mpc_prim_res": reduce(prim.max(), "max"),
        "mean_tau_rms": reduce(tau_rms.sum(), "sum") / (
            n_total * tau_rms.shape[1]),
        "n_upright": reduce(
            (metrics["x_srb"][:, -1, 2] > 0.1).sum().to(prim.dtype), "sum"),
        # failure roll-up: scenarios with any failed MPC solve, and the worst
        # per-period WBC success fraction
        "n_mpc_fail": reduce(
            torch.any(~metrics["mpc_ok"], dim=1).sum().to(prim.dtype), "sum"),
        "min_wbc_ok_frac": reduce(metrics["wbc_ok_frac"].min(), "min"),
        "n_total": n_total,
    }


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def sharded_cascade_rollout(cc: CascadeConfigured, n_periods: int,
                            group=None, device="cuda", **solver_kw):
    """Returns fn(ctl, plant, gait_id, v_cmd, contact_params) ->
    (ctl, plant, metrics, summary): `cascade_rollout_graphed` of this
    process's scenarios on `device`, then the global summary
    (`scenario_summary`) all-reduced over `group` (default: the default
    group), outside any graph."""

    def reduce(t, op):
        t = t.reshape(1).clone()
        dist.all_reduce(t, op=_OPS[op], group=group)
        return t[0]

    def run(ctl, plant, gait_id, v_cmd, contact_params):
        ctl, plant, metrics = cascade_rollout_graphed(
            cc, ctl, plant, gait_id, v_cmd, contact_params,
            n_periods=n_periods, device=device, **solver_kw)
        return ctl, plant, metrics, scenario_summary(metrics, reduce)

    return run
