#!/usr/bin/env python3
"""The host path's tick latency of two checkouts on one card, in turns.

    python3 scripts/host_tick_ab.py --other build/parent [--rounds 2]
        [--seconds 2.0] [--out DIR]

Each turn is a fresh process that imports `chip_smoke.py` from one
checkout and runs its sync `HostController` on the default backends (the
M2 MPC, the default WBC) in closed loop on the card's captured plant
(`GraphPlant`) for --seconds of simulated time, as phase 9c does.  The
turns run --other, this checkout, this checkout, --other per round, so
that the two are compared on one card within one call.  --other is a copy
of another commit, e.g. its tree unpacked with `git archive` into a
git-ignored directory.  Prints one JSON line per turn (compute() p50 and
p99 over every tick, over the period-boundary ticks and over the others,
ms) and a summary line of the medians; --out also writes them to
DIR/host_tick_ab.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
import chip_smoke as cs
from mpctsid_tpu_torch.qp import _build
dev = torch.device("cuda")
cs.enforce_f32_matmuls()
# every library of the checkout, built together (cached for later turns)
_build.build_libraries(
    cs.kernels.build_specs() + cs.rbd_kernels.build_specs()
    + cs.plan_kernels.build_specs()
    + (cs.mpc_kernels.build_specs() if hasattr(cs, "mpc_kernels") else [])
    + (cs.kernels_tail.build_specs() if hasattr(cs, "kernels_tail") else []))
ctl = cs.HostController(cs.SOLO12, cs.host_cfg("auto_mpc", "xla"),
                        cs.standing_q0(), device=dev)
plant = cs.GraphPlant(ctl.tree, cs.standing_q0(), dev)
zmin, _, walls, boundary, _ = cs.drive_host(ctl, {seconds!r}, dev,
                                            plant=plant)
ms = walls * 1e3
pct = lambda a, p: float(np.percentile(a, p))
print(json.dumps(dict(
    root={root!r}, ticks=int(ms.size), min_z=zmin,
    p50=pct(ms, 50), p99=pct(ms, 99),
    boundary_p50=pct(ms[boundary], 50), boundary_p99=pct(ms[boundary], 99),
    other_p50=pct(ms[~boundary], 50), smi=cs.nvidia_smi_line())))
"""


def turn(root: Path, seconds: float) -> dict:
    r = subprocess.run([sys.executable, "-c",
                        CHILD.format(root=str(root), seconds=seconds)],
                       cwd=root, capture_output=True, text=True,
                       timeout=900, env=dict(os.environ))
    if r.returncode != 0:
        raise RuntimeError(f"turn in {root} failed:\n{r.stdout}\n{r.stderr}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="a checkout of the commit to compare with")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    other = Path(a.other).resolve()
    runs = {"other": [], "this": []}
    for _ in range(a.rounds):
        for name in ("other", "this", "this", "other"):
            r = turn(other if name == "other" else HERE, a.seconds)
            r["which"] = name
            runs[name].append(r)
            print(json.dumps(r), flush=True)
    summary = {name: {k: sorted(r[k] for r in rs)[len(rs) // 2]
                      for k in ("p50", "p99", "boundary_p50",
                                "boundary_p99", "other_p50")}
               for name, rs in runs.items()}
    print(json.dumps({"median_of_turns": summary}), flush=True)
    if a.out:
        Path(a.out).mkdir(parents=True, exist_ok=True)
        Path(a.out, "host_tick_ab.json").write_text(
            json.dumps({"runs": runs, "median_of_turns": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
