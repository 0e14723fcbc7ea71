#!/usr/bin/env python3
"""How phase 11a's kernel 1 gate answers one-ulp noise on kernel B's K^-1.

    python3 scripts/probe_11a_noise.py [--seeds 6] [--out DIR]

chip_smoke.py's phase 11a holds every launch of kernel 1
(`admm_iterate_m2`) within 1e-4 of its plain version on the same inputs,
wherever that plain version lies within 1e-4 of a float64 run
(`hold_launches`).  Those inputs include kernel B's K^-1.  This script runs
11a's MPC solves again (the same 512 oracle problems; no oracle pool, no
other phase) once with kernel B as it ships and once per seed with every
entry of each K^-1 of the MPC (n > 32) moved by one unit in the last place
at random (up, down or not at all), and prints each run's verdict, the
largest |kernel - plain| and the plain version's largest distance to
float64.  Needs an NVIDIA GPU (exits 2 without one); every line carries the
card's name and power limit.  With --out it writes probe_11a_noise.json
there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from mpctsid_tpu_torch.qp import admm as admm_mod  # noqa: E402


def run(inputs, cfg, inverse, smi):
    """11a's kernel launches with `inverse` as the kernel backends' K^-1;
    (gate held, max |kernel - plain|, max distance of the plain version to
    float64) over kernel 1's launches."""
    shipped = admm_mod.chol_inverse
    admm_mod.chol_inverse = inverse
    log: list = []
    try:
        with cs.recorded_launches(log):
            for backend in ("torch", "m2"):
                cs.solve_mpc_contract(cs.SOLO12, cfg.mpc, *inputs,
                                      backend=backend)
            qp32 = cs.build_mpc_qp(cs.SOLO12, cfg.mpc, *inputs)
            for backend in ("torch", "m2"):
                cs.admm_solve(*qp32, backend=backend, **cs.CONTRACT_BUDGET)
            cs.admm_solve(*qp32, backend="m2", **cs.INLOOP_MPC)
    finally:
        admm_mod.chol_inverse = shipped
    failures = len(cs.FAILURES)
    cs.hold_launches([e for e in log if e[0] == "admm_iterate_m2"],
                     "11a noise", smi)
    err, p64 = 0.0, 0.0
    for name, args, kw, got in log:
        if name != "admm_iterate_m2":
            continue
        plain, _tol = cs.PLAIN_OF["admm_iterate_m2"]
        want = plain(*args, **kw)
        want64 = [t.float() for t in plain(*[a.double() for a in args], **kw)]
        err = max(err, float(cs.per_scenario(got, want).max()))
        p64 = max(p64, float(cs.per_scenario(want, want64).max()))
    return len(cs.FAILURES) == failures, err, p64


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cs.enforce_f32_matmuls()
    smi = cs.nvidia_smi_line()
    cfg = cs.EngineConfig()
    problems = cs.oracle_mpc_problems(cs.ORACLE_S, seed=11)
    inputs = [torch.tensor(np.stack([p[2][i] for p in problems]),
                           dtype=torch.float32).to(device) for i in range(4)]
    shipped = admm_mod.chol_inverse

    def noisy(seed):
        g = torch.Generator(device=device)
        g.manual_seed(seed)

        def chol_inverse(K):
            X = shipped(K)
            if K.shape[-1] <= 32:
                return X
            step = torch.randint(-1, 2, X.shape, device=device,
                                 generator=g).float()
            return torch.nextafter(X, X + step * X.abs().clamp_min(1.0))
        return chol_inverse

    rows = []
    for name, inverse in [("as shipped", shipped)] + [
            (f"one-ulp noise, seed {s}", noisy(s)) for s in range(a.seeds)]:
        held, err, p64 = run(inputs, cfg, inverse, smi)
        row = dict(run=name, gate_held=held, max_kernel_minus_plain=err,
                   max_plain_to_float64=p64)
        rows.append(row)
        print(f"  {name}: gate held {held}, max |kernel - plain| {err:.4e}, "
              f"plain's max distance to float64 {p64:.4e}  [{smi}]",
              flush=True)
    report = {"card": smi, "tolerance": 1e-4, "runs": rows}
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        with open(os.path.join(a.out, "probe_11a_noise.json"), "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
