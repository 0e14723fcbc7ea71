#!/usr/bin/env python3
"""Kernel 4 (`admm_solve_fused`) of this checkout against the same kernel
built from another checkout's sources, bit for bit, on the card.

    python3 scripts/compare_fused_bits.py --other DIR

DIR is another checkout's `mpctsid_tpu_torch/qp/csrc` (its `admm_fused.cu`
and the headers beside it).  Both libraries are built with the port's nvcc
flags and run on the same inputs (chip_smoke.py's `fused_inputs`: the WBC
shape at B = 37 and 4096, n = 32 and the test shape on the warp path, n = 33
and the MPC shape on the block path, 40 iterations in 3 rounds, warm
started).  Prints, per case, whether every output (x, y, D, E, c) agrees bit
for bit; exits 1 if one does not, 2 without a GPU.  A change that moves
device code shared with kernel 4 (admm_block.cuh, spd_inverse.cuh) is held
to this against its parent commit.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from mpctsid_tpu_torch.qp import _build, kernels  # noqa: E402

CASES = ((37, 30, 50, 1), (4096, 30, 50, 2), (64, 32, 50, 3),
         (64, 24, 40, 4), (8, 33, 55, 5), (8, 192, 320, 6))


def other_library(csrc: Path):
    """The other checkout's admm_fused.cu, built and loaded."""
    headers = tuple(sorted(p.name for p in csrc.iterdir()
                           if p.suffix in (".cuh", ".h")))
    spec = ("admm_fused_other", ("admm_fused.cu",), headers, str(csrc))
    _build.build_libraries([spec])
    lib = ctypes.CDLL(str(_build._target(*spec[:3], csrc)))
    lib.admm_fused_launch.argtypes = kernels._LAUNCH_ARGTYPES["admm_fused"]
    lib.admm_fused_launch.restype = ctypes.c_int
    lib.admm_fused_workspace_floats.argtypes = [ctypes.c_int] * 4
    lib.admm_fused_workspace_floats.restype = ctypes.c_longlong
    return lib


def run_other(lib, args, device):
    """One launch of the other build with the geometry of this checkout's
    fused_layout (the launcher's contract is unchanged)."""
    P, q, A, l, u, eqf, x0, y0 = args
    B, n = q.shape
    m = l.shape[1]
    kw = cs.FUSED_KW
    lay = kernels.fused_layout(n, m, B, *kernels.device_limits(device))
    outs = (torch.empty_like(q), torch.empty_like(l), torch.empty_like(q),
            torch.empty_like(l), q.new_empty((B,)))
    workspace = None
    if lay.path == "block":
        floats = lib.admm_fused_workspace_floats(B, n, m, lay.threads)
        workspace = q.new_empty((max(floats, 1),)) if floats else None
    rc = lib.admm_fused_launch(
        *(t.data_ptr() for t in (P, q, A, l, u, eqf, x0, y0, *outs)),
        workspace.data_ptr() if workspace is not None else None,
        B, n, m, kw["iters"], kw["adapt_rounds"], kw["equilibrate_iters"],
        kw["rho0"], kw["sigma"], kw["alpha"], kw["rho_eq_scale"], kw["inf"],
        lay.threads, lay.g, lay.ld, lay.slot_floats,
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the other build's launch failed: CUDA error {rc}")
    return outs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="another checkout's mpctsid_tpu_torch/qp/csrc")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_fused_bits: no GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    lib = other_library(opts.other.resolve())
    same_all = True
    for B, n, m, seed in CASES:
        args = cs.fused_inputs(seed, B, n, m, device)
        here = kernels.admm_solve_fused(*args, **cs.FUSED_KW)
        there = run_other(lib, args, device)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(here, there))
        same_all &= same
        path = kernels.fused_layout(n, m, B,
                                    *kernels.device_limits(device)).path
        print(f"kernel 4, B={B} n={n} m={m} ({path} path): x, y, D, E, c bit "
              f"for bit the other build's: {same}", flush=True)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
