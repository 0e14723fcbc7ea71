#!/usr/bin/env python3
"""How the plain planner's rotations round on the card, against the forms
the planner kernels can take.

    python3 scripts/probe_rotation_forms.py [--batch 1 2 ... ] [--out DIR]

The plain versions of the footstep horizon and the reference rollout
(plan/footsteps.py, mpc/srb.py) rotate vectors by torch.bmm and
torch.einsum, which cuBLAS rounds either as a fused multiply-add chain or as
two products and a sum, by the call's dtype and batch.  The kernels take the
form that `plan/kernels.py::rotation_forms` names.  This script runs the
kernels with each of the four (bmm fused, einsum fused) forms forced at
every batch and dtype asked for, on chip_smoke.py's planner inputs, and
counts the entries that part from the plain version on the same card: the
form with none is cuBLAS's.  It prints which form that is beside what
`rotation_forms` says.  Needs an NVIDIA GPU (exits 2 without one); every
line carries the card's name and power limit.  With --out it writes
probe_rotation_forms.json there.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from mpctsid_tpu_torch.plan import kernels as plan_kernels  # noqa: E402

BATCHES = (1, 2, 3, 4, 5, 6, 7, 8, 16, 37, 64, 256, 1024, 4096, 8192,
           12288, 14000, 16384, 32768)


def parted(got, want) -> int:
    return sum(int((g != w).sum()) for g, w in zip(got, want))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=list(BATCHES))
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cs.enforce_f32_matmuls()
    smi = cs.nvidia_smi_line()
    shipped = plan_kernels.rotation_forms
    d = cs.planner_inputs(max(a.batch), 75)
    rows = []
    try:
        for dtype in (torch.float32, torch.float64):
            for B in a.batch:
                calls = cs.planner_calls({k: v[:B] for k, v in d.items()},
                                         dtype, device)
                counts = {}
                for forms in itertools.product((False, True), repeat=2):
                    plan_kernels.rotation_forms = \
                        lambda dt, b, forms=forms: forms
                    counts[forms] = {
                        name: parted(cs.as_list(call()), cs.as_list(plain()))
                        for name, (call, plain) in calls.items()
                        if name != "swing_foot_ref"}
                plan_kernels.rotation_forms = shipped
                clean = [f for f, c in counts.items()
                         if not any(c.values())]
                row = dict(dtype=str(dtype)[6:], B=B,
                           cublas_forms=[list(f) for f in clean],
                           rotation_forms=list(shipped(dtype, B)),
                           parted={f"bmm {f[0]}, einsum {f[1]}": c
                                   for f, c in counts.items()})
                rows.append(row)
                print(f"  {row['dtype']} B={B}: forms with no entry parted "
                      f"(bmm fused, einsum fused) {clean}; rotation_forms "
                      f"{row['rotation_forms']}  [{smi}]", flush=True)
    finally:
        plan_kernels.rotation_forms = shipped
    agree = all(r["rotation_forms"] in r["cublas_forms"] for r in rows)
    print(f"  rotation_forms names cuBLAS's form at every batch measured: "
          f"{agree}", flush=True)
    report = {"card": smi, "rows": rows, "agree": agree}
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        with open(os.path.join(a.out, "probe_rotation_forms.json"), "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
