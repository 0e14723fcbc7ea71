#!/usr/bin/env python3
"""The device events of one replay of a captured period, by name.

    python3 scripts/period_kernel_census.py [--batch 4096] [--wbc-backend xla]
        [--out FILE]

Captures `cascade_period` of the preset config4_cascade_4k (trot) at the
given batch with chip_smoke.py's runner (`period_runner`, as phase 12
does), replays it once to warm up, then profiles one replay in a fresh
process and prints every device event (kernels, copies, memsets) with its
count and the total.  Run it from two checkouts in one call on the same
card and diff the outputs to see what a change adds to or takes out of a
period (phase 12's count is taken late in a long process, where the
profiler's records vary by a few).  Needs an NVIDIA GPU (exits 2 without
one); the first line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--wbc-backend", default="xla")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cs.enforce_f32_matmuls()
    cfg = cs.PRESETS["config4_cascade_4k"]
    cc, ctl, plant, gid, v, cp = cs.make_scenarios(cfg, a.batch, seed=4,
                                                   device=device)
    gid_t = torch.as_tensor(gid).to(device)
    v_t = torch.as_tensor(v).to(device)
    runner = cs.period_runner(cc, ctl, plant, gid_t, cp, device=device,
                              wbc_backend=a.wbc_backend)
    runner.load(ctl, plant, gid_t, cp)
    runner(v_t)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        runner(v_t)
        torch.cuda.synchronize()
        cs.flush_cupti()
    names = collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)
    lines = [f"[{cs.nvidia_smi_line()}] B={a.batch} wbc_backend="
             f"{a.wbc_backend}: {sum(names.values())} device events in one "
             "replay"]
    lines += [f"{c:6d} {name}" for name, c in sorted(names.items())]
    text = "\n".join(lines) + "\n"
    print(text, end="")
    if a.out:
        with open(a.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
