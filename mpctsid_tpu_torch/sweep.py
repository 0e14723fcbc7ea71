"""Monte-Carlo scenario sweeps with checkpoint/resume (counterpart of the
JAX package's sweep.py).

A sweep evaluates `total` scenarios, with per-scenario gait, velocity
command, ground friction and payload drawn deterministically from
(seed, scenario_index), in device-batch chunks.  After every chunk the sweep
state (scenario cursor + seed + accumulated per-scenario metrics) is
serialized, so a preempted sweep resumes from the cursor and produces
BITWISE the results of an uninterrupted run.

The checkpoint is a numpy `.npz` archive (`np.savez`).  The JAX package
writes flax msgpack: the two packages' checkpoint files are NOT
interchangeable, although they hold the same fields.

Each chunk is one `cascade_rollout_graphed`: on the card every chunk of the
sweep replays one CUDA graph per period, captured at the first chunk and
cached (the counterpart of the JAX sweep's `_chunk_runner`, one compiled
program per chunk shape); the padded tail chunk keeps the chunk's shape, so
one capture serves the whole sweep.

CLI (runs on the GPU unless --cpu is given, and fails if there is none):
    python -m mpctsid_tpu_torch.sweep --total 4096 --chunk 512 \\
        --ckpt sweep.npz --jsonl sweep_results.jsonl
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import sys
import tempfile

import numpy as np
import torch

from mpctsid_tpu_torch.cascade import (CascadeConfigured,
                                       cascade_rollout_graphed,
                                       init_controller)
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.env.plant import ContactParams, PlantState
from mpctsid_tpu_torch.model.gaits import GAIT_IDS
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.utils import resolve_device

METRIC_KEYS = ["final_z", "upright", "final_x", "vx_err",
               "max_mpc_res", "mpc_fail", "min_wbc_ok_frac"]

__all__ = ["METRIC_KEYS", "SweepState", "scenario_params", "chunk_inputs",
           "chunk_metrics", "run_sweep", "summarize", "main"]


@dataclasses.dataclass
class SweepState:
    """Checkpointable sweep progress."""

    seed: int
    total: int
    cursor: int                    # scenarios completed
    n_periods: int
    metrics: dict                  # key -> np.ndarray (total,)

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        np.savez(buf, seed=np.int64(self.seed), total=np.int64(self.total),
                 cursor=np.int64(self.cursor),
                 n_periods=np.int64(self.n_periods),
                 **{f"metric_{k}": np.asarray(v)
                    for k, v in self.metrics.items()})
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "SweepState":
        with np.load(io.BytesIO(data), allow_pickle=False) as d:
            return cls(seed=int(d["seed"]), total=int(d["total"]),
                       cursor=int(d["cursor"]), n_periods=int(d["n_periods"]),
                       metrics={k[len("metric_"):]: np.array(d[k])
                                for k in d.files if k.startswith("metric_")})

    @classmethod
    def fresh(cls, seed: int, total: int, n_periods: int) -> "SweepState":
        return cls(seed=seed, total=total, cursor=0, n_periods=n_periods,
                   metrics={k: np.full(total, np.nan, np.float32)
                            for k in METRIC_KEYS})

    def save(self, path: str):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(self.to_bytes())
        os.replace(tmp, path)      # atomic: a crash never corrupts the ckpt

    @classmethod
    def load(cls, path: str) -> "SweepState":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())


def scenario_params(seed: int, idx: np.ndarray):
    """Deterministic per-scenario draws, independent of chunking.

    Each scenario's RNG is seeded by (seed, index), so chunk boundaries and
    resume points cannot change any scenario's parameters.  Draws cover the
    perturbation axes: gait, velocity command, friction, and payload mass
    (0-0.4 kg point mass at the base).  Pure numpy, value by value the JAX
    package's draws."""
    gaits = ["trot", "walk", "bound"]
    gids = np.empty(len(idx), np.int32)
    vcs = np.empty((len(idx), 3), np.float32)
    mus = np.empty(len(idx), np.float32)
    payloads = np.empty(len(idx), np.float32)
    for j, i in enumerate(idx):
        r = np.random.default_rng([seed, int(i)])
        g = gaits[int(r.integers(0, len(gaits)))]
        gids[j] = GAIT_IDS[g]
        vmax = 0.3 if g != "walk" else 0.2
        vcs[j] = [r.uniform(0.05, vmax), r.uniform(-0.05, 0.05),
                  r.uniform(-0.2, 0.2)]
        mus[j] = r.uniform(0.45, 1.0)
        payloads[j] = r.uniform(0.0, 0.4)
    return gids, vcs, mus, payloads


def chunk_inputs(gids, vcs, mus, payloads, device):
    """The rollout's arguments for one chunk: (cc, ctl, plant, contact
    params), fresh from standing, the chunk's friction and payload."""
    model = SOLO12
    cfg = EngineConfig()
    cc = CascadeConfigured(model, cfg)
    B = len(gids)
    q0 = np.zeros((B, 19), np.float32)
    q0[:, 2] = model.h_ref
    q0[:, 6] = 1.0
    q0[:, 7:] = model.q_stand

    ctl = init_controller(model, cfg, cc.tree, q0, gids, payload=payloads,
                          device=device)
    plant = PlantState.init(q0, device=device)
    cp = ContactParams.default(B, device=device)
    cp = dataclasses.replace(
        cp, mu=torch.as_tensor(mus, dtype=torch.float32).to(device))
    return cc, ctl, plant, cp


def chunk_metrics(m: dict, vcs, n_periods: int) -> dict:
    """A chunk's rollout metrics -> per-scenario metric dict of numpy arrays
    (one device -> host transfer per metric)."""
    x = m["x_srb"]                                   # (B, n_periods, 12)
    vx_cmd = torch.as_tensor(vcs[:, 0], dtype=x.dtype).to(x.device)
    out = {
        "final_z": x[:, -1, 2],
        "upright": (x[:, :, 2] > 0.12).all(dim=1).to(torch.float32),
        "final_x": x[:, -1, 0],
        "vx_err": (x[:, n_periods // 2:, 6].mean(dim=1) - vx_cmd).abs(),
        "max_mpc_res": m["mpc_prim_res"].amax(dim=1),
        "mpc_fail": (~m["mpc_ok"]).sum(dim=1).to(torch.float32),
        "min_wbc_ok_frac": m["wbc_ok_frac"].amin(dim=1),
    }
    return {k: v.cpu().numpy() for k, v in out.items()}


def _run_chunk(gids, vcs, mus, payloads, n_periods: int, device) -> dict:
    """(gids, vcs, mus, payloads) of one chunk -> per-scenario metric dict
    of numpy arrays.  The chunk's fresh state and parameters are copied into
    the cached runner of the chunk's shape."""
    cc, ctl, plant, cp = chunk_inputs(gids, vcs, mus, payloads, device)
    _, _, m = cascade_rollout_graphed(cc, ctl, plant, gids, vcs, cp,
                                      n_periods=n_periods, payload=payloads,
                                      device=device)
    return chunk_metrics(m, vcs, n_periods)


def run_sweep(state: SweepState, chunk: int, ckpt_path: str | None = None,
              max_chunks: int | None = None, verbose: bool = True,
              device="cuda"):
    """Advance the sweep until done (or max_chunks), checkpointing per chunk.

    Runs on `device` (default the card; raises if CUDA is asked for and
    absent)."""
    dev = resolve_device(device)
    done_chunks = 0
    while state.cursor < state.total:
        if max_chunks is not None and done_chunks >= max_chunks:
            break
        lo = state.cursor
        hi = min(lo + chunk, state.total)
        idx = np.arange(lo, hi)
        gids, vcs, mus, payloads = scenario_params(state.seed, idx)
        # fixed-shape chunk: pad the tail by repeating the last scenario, so
        # every chunk runs the same batch shape (and the same kernels)
        pad = chunk - len(idx)
        if pad:
            gids = np.concatenate([gids, np.repeat(gids[-1:], pad)])
            vcs = np.concatenate([vcs, np.repeat(vcs[-1:], pad, 0)])
            mus = np.concatenate([mus, np.repeat(mus[-1:], pad)])
            payloads = np.concatenate(
                [payloads, np.repeat(payloads[-1:], pad)])
        out = _run_chunk(gids, vcs, mus, payloads, state.n_periods, dev)
        for k in METRIC_KEYS:
            state.metrics[k][lo:hi] = out[k][:len(idx)]
        state.cursor = hi
        done_chunks += 1
        if ckpt_path:
            state.save(ckpt_path)
        if verbose:
            up = np.nanmean(state.metrics["upright"][:state.cursor])
            print(f"  sweep {state.cursor}/{state.total} "
                  f"(upright so far {up:.3f})", file=sys.stderr)
    return state


def summarize(state: SweepState) -> dict:
    done = state.cursor
    m = {k: v[:done] for k, v in state.metrics.items()}
    return {
        "scenarios": int(done),
        "upright_frac": float(np.mean(m["upright"])) if done else 0.0,
        "mean_vx_err": float(np.mean(m["vx_err"])) if done else 0.0,
        "max_mpc_res": float(np.max(m["max_mpc_res"])) if done else 0.0,
        "mpc_fail_total": float(np.sum(m["mpc_fail"])) if done else 0.0,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--total", type=int, default=1024)
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--periods", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "mpctsid_torch_sweep.npz"))
    p.add_argument("--jsonl", default=None,
                   help="write per-scenario results at the end")
    p.add_argument("--resume", action="store_true",
                   help="continue from --ckpt if it exists")
    p.add_argument("--cpu", action="store_true", help="force CPU")
    a = p.parse_args(argv)

    if a.resume and os.path.exists(a.ckpt):
        state = SweepState.load(a.ckpt)
        print(f"resuming at {state.cursor}/{state.total}", file=sys.stderr)
    else:
        state = SweepState.fresh(a.seed, a.total, a.periods)
    state = run_sweep(state, a.chunk, ckpt_path=a.ckpt,
                      device="cpu" if a.cpu else "cuda")
    print(json.dumps(summarize(state)))

    if a.jsonl:
        with open(a.jsonl, "w") as f:
            for i in range(state.cursor):
                f.write(json.dumps(
                    {"scenario": i,
                     **{k: float(state.metrics[k][i])
                        for k in METRIC_KEYS}}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
