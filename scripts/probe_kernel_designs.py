#!/usr/bin/env python3
"""Where the time of the redesigned kernels goes: the M2 iteration
(admm_m2.cu), the generic refined iteration (admm_vpu.cu), the tensor-core
iteration (admm_mma.cu), the whole solve (admm_fused.cu), kernels B
(spd_inverse.cu) and A (admm_fused.cu's plain-backend solve), the WBC build
and the plant step (dyn/csrc/), Ruiz (ruiz.cu), the MPC QP build
(mpc/csrc/mpc_build.cu) and the solve tail (solve_tail.cu).

    python3 scripts/probe_kernel_designs.py [--batch 4096] [--out DIR]
        [--kernels m2 vpu packed mma fused spd plainwarp build plant ruiz
                   mpcbuild tail]

Needs an NVIDIA GPU and nvcc.  All times are CUDA events at the main path's
shapes (WBC: n = 30, m = 50, 13 iterations, the whole solve 40 in 3 rounds;
MPC: n = 192, m = 320, 30 iterations), each with the card's name and power
limit.  `--kernels` picks the parts (default: all twelve):

  m2. (admm_m2.cu, MPC shape) the launcher called with other geometries
     than `kernels.m2_layout` chooses: clusters of 1, 2 and 4, M2 in
     registers or in shared memory, block sizes of 384 to 512 threads and
     clusters of 2, 3 and 4 (interleaved over several rounds), the earlier
     one-block layout (M2 in shared memory, A streamed), no iterations; and
     patched copies (times only): A's loads taken out of the one-block
     layout, the waits of the exchange removed, the three products skipped
     (those three give wrong results), and one block per scenario with M2
     and as many rows of A as fit beside it in shared memory, the other
     rows of A streamed (right results);
  vpu. (admm_vpu.cu, WBC shape) the warp path with 1 to 8 scenarios per
     block, a patched copy that also holds rows lane and lane + 32 of A in
     registers for A x_t (right results, m <= 64), no iterations, and the
     block path (the earlier design) at the same shape;

  mma 1. layouts (admm_mma.cu): the launcher is called with geometries other
     than the one `kernels.mma_layout` chooses (row stride and scenarios per
     block on the warp path; row stride, threads per block and cluster size
     on the cluster path), to show what the choice is worth, and with
     fewer scenarios (one wave of blocks, several);
  mma 2. variants (admm_mma.cu): copies of the source patched by text
     substitution and built beside the real library (the shipped source has
     no switch): the tile products skipped or stripped of one part at a
     time, the TF32 rounding done by the conversion instruction, a
     whole-cluster barrier added to every exchange, and a copy of the
     cluster path that reads the cycle counter after every product, block
     barrier and exchange of an iteration.  Their RESULTS ARE WRONG on purpose; only their times are
     read, to split the kernel's time into products, barriers, exchange
     and rounding;
  fused. (admm_fused.cu) the whole solve with fewer iterations, rounds
     and Ruiz passes (what each part costs), with other numbers of
     scenarios per block, and a patched copy that reads the cycle counter at
     every phase boundary of one warp (the share of each phase of a round);
  spd. (spd_inverse.cu, n = 192) kernel B's blocked block path against the
     scalar sweep it replaced and against the blocked factorization with X0 on
     torch.bmm (patched copies), whole chol_inverse and the factor launch
     alone, in interleaved rounds at B = 1 and --batch; 128-512 threads;
     torch.linalg.inv_ex; the share of each phase (cycle counter of thread
     0 after every barrier);
  plainwarp. (admm_fused.cu, WBC shape) kernel A against its design before
     (kernel 4's warp body with the norm-only Ruiz, a patched copy) in interleaved
     rounds at B = 1 and --batch, and the share of each of its phases;
  build, plant. (dyn/csrc/wbc_build.cu, plant_step.cu over rbd.h; float32,
     chip_smoke.py's inputs) the shipped warp-per-scenario kernels against
     PR 11's thread-per-scenario design (a patched copy of rbd.h with its
     serial body put back) in interleaved rounds at B = 1 and --batch,
     copies with 4 and 16 warps a block at --batch, each design's error
     against the plain version, and the cycles of each phase (a patched
     copy that reads the cycle counter at every phase boundary);
  ruiz. (qp/csrc/ruiz.cu over ruiz.h, the MPC shape n = 192, m = 320 with
     the stride-0 constraint matrix, and the WBC shape n = 30, m = 50 dense;
     8 rounds; B = 1, 256 and --batch) the shipped kernel against its
     first design (a block per scenario, P in shared memory: its ruiz.h and
     ruiz.cu kept here as a patched copy, FIRST_RUIZ_H / FIRST_RUIZ_CU), both
     held bit for bit against each other and the plain version on the same
     inputs, then timed in interleaved rounds beside the shipped kernel
     with 0 and 1 rounds, the layouts `ruiz_layout` does not choose
     (clusters of 1-8 blocks, P read from device memory, A read whole
     every round; warps a block, the cluster path at the WBC shape) and
     patched copies that undo one choice each (`RUIZ_SUBS`: Ab read from A,
     8 or 4 runs of rows over P, 8 rows of A loaded ahead, the warp path's
     row maxima by warp reductions), and the cycles of each stage of a
     round (a patched copy that reads the cycle counter at every block
     barrier and exchange wait, `RUIZ_CLOCK_SUBS`; plus load and stores).
     Times are one-launch CUDA graphs' replays.
  tail. (qp/csrc/solve_tail.cu over solve_tail.h, chip_smoke.py phase 3i's
     problems: the MPC shape with its stride-0 A and declared blocks, the
     WBC shape dense; B = 1, 256 and --batch) kkt_blocks and unscale
     against their first design (its solve_tail.h and .cu kept here,
     FIRST_TAIL_H / FIRST_TAIL_CU, built as a patched copy), adapt_rho
     (whose design stayed) against the same build: every output's bits
     against the first design's, then the times in interleaved rounds
     beside the layouts not chosen (kkt: a value a piece, 64-512 threads;
     unscale: warps a block, a scenario a warp, one slot staged by the
     lanes and the block path at the WBC shape, 256-1024 threads at the
     MPC shape), patched copies that undo or push one choice each
     (`TAIL_HEADER_VARIANTS`: 4 or 16 pieces a thread, 1 or 4 rows a
     group, the rows' loads by j; `TAIL_REGISTER_KKT_SUBS`: K's aligned
     tiles in registers; `tail_ring_subs`: at the MPC shape P's rows by
     bulk copy through rings of 3 x 32 and 4 x 16 rows), the library call
     for K
     (torch.baddbmm) and the plain chains, each with its share of the
     bound; the cycles of each phase (`TAIL_CLOCK_SUBS`); and ptxas'
     registers, shared memory and spills of every entry of every build.
     Times are one-launch CUDA graphs' replays.
  mpcbuild. (mpc/csrc/mpc_build.cu over mpc_build.h, N = 16, float32; B = 1
     and --batch) the shipped MPC QP build timed in interleaved rounds
     beside copies of its header with 192 and 768 threads a block (bit for
     bit the shipped kernel: the units do not depend on the threads), a
     copy that skips P's rows (wrong P; the time of the rest) and the
     float64 build; and the cycles of each phase (a patched copy that
     reads the cycle counter of thread 0 after every block barrier,
     `MPC_BUILD_CLOCK_SUBS`).  Times are one-launch CUDA graphs' replays.

Prints one JSON object at the end; with --out also writes it to
DIR/probe_kernel_designs.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mpctsid_tpu_torch.cascade import CascadeConfigured  # noqa: E402
from mpctsid_tpu_torch.config import EngineConfig  # noqa: E402
from mpctsid_tpu_torch.dyn import kernels as rbd_kernels  # noqa: E402
from mpctsid_tpu_torch.env import plant  # noqa: E402
from mpctsid_tpu_torch.env.plant import ContactParams, PlantState  # noqa: E402
from mpctsid_tpu_torch.model.solo12 import SOLO12  # noqa: E402
from mpctsid_tpu_torch.qp import _build, admm, kernels  # noqa: E402
from mpctsid_tpu_torch.wbc import tsid  # noqa: E402
from mpctsid_tpu_torch.wbc.tsid import WbcRefs  # noqa: E402

PARTS = ["m2", "vpu", "packed", "mma", "fused", "spd", "plainwarp", "build",
         "plant", "ruiz", "mpcbuild", "tail"]
WBC = (30, 50, 13)
MPC = (192, 320, 30)

# name -> list of (old, new) substitutions applied to admm_mma.cu
VARIANTS = {
    "no tile products": [
        ("    for (int unit = warp; unit < n_tiles * ksplit; "
         "unit += n_warps) {",
         "    for (int unit = warp; unit < n_tiles * ksplit && depth < 0; "
         "unit += n_warps) {")],
    "rounding by cvt.rna.tf32.f32": [
        ("    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
         "    uint32_t u;\n"
         "    asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(u) : \"f\"(x));\n"
         "    return u;")],
    # what each part of a tile product costs: taken out one at a time
    "one TF32 part per operand": [
        ("constexpr int PARTS = 2; ", "constexpr int PARTS = 1; "),
        ("constexpr int RESID_PARTS = 3;", "constexpr int RESID_PARTS = 1;")],
    "no matrix loads (the vector's elements instead)": [
        ("        const float4 r0 = *reinterpret_cast<const float4*>(m0 + kc);"
         "\n        const float4 r1 = *reinterpret_cast<const float4*>(m1 + "
         "kc);",
         "        const float4 r0 = v4, r1 = v4;\n        (void)kc;"),
        ("                const float2 pr =\n                    "
         "*reinterpret_cast<const float2*>(m0 + kc * ld);",
         "                const float2 pr = make_float2(vv[c], vv[c]);\n"
         "                (void)kc;")],
    "four multiplications for each mma": [
        ("    asm(\n        \"mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32."
         "f32 \"\n        \"{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, \"\n"
         "        \"{%10, %10, %10, %10};\\n\"\n"
         "        : \"=f\"(d[0]), \"=f\"(d[1]), \"=f\"(d[2]), \"=f\"(d[3])\n"
         "        : \"r\"(a0), \"r\"(a1), \"r\"(a2), \"r\"(a3), \"r\"(b0), "
         "\"r\"(b1), \"f\"(0.0f));",
         "    d[0] = __uint_as_float(a0) * __uint_as_float(b0);\n"
         "    d[1] = __uint_as_float(a2) * __uint_as_float(b1);\n"
         "    d[2] = __uint_as_float(a1) * __uint_as_float(b0);\n"
         "    d[3] = __uint_as_float(a3) * __uint_as_float(b1);")],
    "chunk loop unrolled by 2": [
        ("#pragma unroll 1\n        for (; ch < ch_full",
         "#pragma unroll 2\n        for (; ch < ch_full")],
    "chunk loop unrolled by 4": [
        ("#pragma unroll 1\n        for (; ch < ch_full",
         "#pragma unroll 4\n        for (; ch < ch_full")],
    # what the whole-cluster barrier costs that the exchange does without
    "a cluster barrier after every wait for an exchange": [
        (f"        barrier_wait(bars + {k}, phase);",
         f"        barrier_wait(bars + {k}, phase);\n        cluster.sync();")
        for k in range(4)],
}

# What runs between two marks of one iteration of the cluster path (a mark
# follows every product, every block barrier and every wait for an exchange)
CLUSTER_PHASES = [
    "product A' w", "block barrier", "A' w: sum, stores, wait for all blocks",
    "rhs and its parts, block barrier", "product K^-1 rhs", "block barrier",
    "x_a: sum, stores, wait", "product K x_a (three parts)", "block barrier",
    "r: sum, stores, wait", "product K^-1 r", "block barrier",
    "x_t: sum, stores, wait", "x update, product A x_t", "block barrier",
    "projection, block barrier"]


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def inputs(seed, B, n, m, device):
    """Well-conditioned random K^-1, K, A and iterates (values do not change
    the kernel's time)."""
    r = np.random.default_rng(seed)
    src = min(B, 64)

    def dev(a):
        t = torch.as_tensor(a, dtype=torch.float32)
        return t.repeat((B // src,) + (1,) * (t.dim() - 1)).to(
            device).contiguous()

    Q = r.normal(size=(src, n, n))
    K = Q @ Q.transpose(0, 2, 1) / n + np.eye(n)
    A = r.normal(size=(src, m, n))
    lo = -np.abs(r.normal(size=(src, m))) - 0.1
    return [dev(a) for a in (
        np.linalg.inv(K), K, A, r.normal(size=(src, n)), lo, -lo,
        0.1 * (1.0 + r.uniform(size=(src, m))),
        0.1 * r.normal(size=(src, n)), 0.1 * r.normal(size=(src, m)),
        0.1 * r.normal(size=(src, m)))]


def time_ms(fn, warmup, reps):
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


def launcher(lib):
    fn = lib.admm_mma_launch
    fn.argtypes = kernels._LAUNCH_ARGTYPES["admm_mma"]
    fn.restype = ctypes.c_int
    return fn


def launch(fn, args, iters, geometry):
    B, n = args[0].shape[:2]
    m = args[2].shape[1]
    outs = [torch.empty_like(t) for t in args[7:]]
    rc = fn(*(t.data_ptr() for t in (*args, *outs)), B, n, m, iters, 1e-6,
            1.6, *geometry, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}, {geometry}")
    return outs


def write_variant(name, subs, out_dir, source="admm_mma.cu",
                  header_subs=None, csrc=None, flags=()):
    """A copy of `source` (and of the headers named in `header_subs`, a dict
    header -> substitutions; a callable there maps the header's whole text)
    with the (old, new) text substitutions applied, in its own directory;
    returns the nvcc command that builds it beside the real library (the
    copy's directory first on the include path, so the patched headers win;
    `flags` after the common ones, as the library's own) and the library's
    path."""
    csrc = csrc or _build.CSRC
    tag = "".join(c if c.isalnum() else "_" for c in name)
    vdir = os.path.join(out_dir, f"{source[:-3]}_{tag}")
    os.makedirs(vdir, exist_ok=True)
    for fname, fsubs in [(source, subs), *(header_subs or {}).items()]:
        src = (csrc / fname).read_text()
        if callable(fsubs):
            src = fsubs(src)
        else:
            for old, new in fsubs:
                if old not in src:
                    raise RuntimeError(f"variant {name!r}: pattern not in "
                                       f"{fname}: {old!r}")
                src = src.replace(old, new)
        with open(os.path.join(vdir, fname), "w") as f:
            f.write(src)
    so = os.path.join(vdir, f"lib{source[:-3]}_{tag}.so")
    return [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-I", vdir,
            "-I", str(csrc), "-o", so, os.path.join(vdir, source)], so


# name -> the compiler's output of each patched copy built (ptxas -v)
VARIANT_LOGS: dict = {}


def build_variants(specs, out_dir):
    """{name: CDLL} of the patched copies `specs` (name -> keyword
    arguments of `write_variant`), their nvcc processes run together."""
    procs = {}
    for name, kw in specs.items():
        cmd, so = write_variant(name, out_dir=out_dir, **kw)
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} does not build:\n{out}")
        VARIANT_LOGS[name] = out
        libs[name] = ctypes.CDLL(so)
    return libs


def build_variant(name, subs, out_dir, source="admm_mma.cu",
                  header_subs=None):
    """One patched copy (`write_variant`), built; its CDLL."""
    return build_variants({name: dict(subs=subs, source=source,
                                      header_subs=header_subs)},
                          out_dir)[name]


def warp_geometry(n, m, ld, g):
    slot = (2 * n + m) * ld + 13 * kernels._pad16(n) + 9 * kernels._pad16(m)
    return (g, 0, 32 * g, ld, 0, g * slot)


def cluster_geometry(n, m, cluster, ld, threads, resident=7):
    np_, mp = kernels._pad16(n), kernels._pad16(m)
    rows_n = -(-(np_ // 16) // cluster) * 16
    rows_m = -(-(mp // 16) // cluster) * 16
    floats = (14 * np_ + 9 * rows_m + kernels.MMA_KSPLIT * max(np_, rows_m)
              + cluster * np_ + kernels.MMA_BARRIER_FLOATS)
    for bit, rows in ((kernels.RES_KINV, rows_n), (kernels.RES_A, rows_m),
                      (kernels.RES_K, rows_n)):
        if resident & bit:
            floats += rows * ld
    return (0, cluster, threads, ld, resident, floats)


FUSED_KW = dict(iters=40, adapt_rounds=3, equilibrate_iters=8, rho0=0.1,
                sigma=1e-6, alpha=1.6, rho_eq_scale=1e3, inf=1e20)

# phase boundaries of one adapt round of the warp path, by the source line
# that opens the phase; PHASES[k] names what runs from mark k to mark k + 1
# (file, anchor) of every phase boundary of a round of kernel 4's warp path;
# the factorization's phases lie in spd_inverse.cuh (warp_scaled_inverse),
# which the patched copy hands the counters to
MARKS = [
    ("admm_fused.cu",
     "        // row `lane` of K = P + sigma I + (A rho)' A, in registers\n"),
    ("admm_fused.cu", "        // K^-1 (spd_inverse.cuh): the Jacobi scale s,"),
    ("spd_inverse.cuh", "    // Cholesky, left-looking column sweep: lane i "
     "forms entry"),
    ("spd_inverse.cuh", "    // L^-1 by forward substitution, row-major into "
     "the lower"),
    ("spd_inverse.cuh", "    // row `lane` of X0 = L^-T L^-1, in registers, "
     "then TRANSPOSED"),
    ("spd_inverse.cuh", "    // one Newton-Schulz step.  M = 2I - Ks X0 "
     "column by column:"),
    ("spd_inverse.cuh", "    // X = X0 M, the same way over M\n"),
    ("spd_inverse.cuh", "    // r1 = |I - Ks X|_F^2\n"),
    ("spd_inverse.cuh", "    // divergence safeguard (a NaN compares false: "
     "back to X0), then the\n    // finite test of what is kept\n"),
    ("admm_fused.cu",
     "        warp_refined_iterations(sW, sK, sA, ld, n, m, fp.iters_per,"),
    ("admm_fused.cu",
     "        if (round + 1 < fp.n_rounds) {\n            // scaled residual "
     "ratios -> rho_s\n            float m_axz = 0.f, m_ax = 0.f, m_z = 0.f;"
     "\n            for (int i = lane; i < m; i += 32) {\n                "
     "const float ax = dot_strided("),
]
PHASES = ["K = P + sigma I + A' rho A", "Jacobi scaling", "Cholesky",
          "triangular inverse", "X0 = L^-T L^-1", "M = 2I - Ks X0",
          "X = X0 M", "|I - Ks X|^2", "safeguards, K^-1 = s X s",
          "the round's iterations", "residual ratios, rho, w (to the next K)"]


def fused_inputs(seed, B, n, m, device):
    r = np.random.default_rng(seed)
    Q = r.normal(size=(B, n, n))
    P = Q @ Q.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    A = r.normal(size=(B, m, n))
    x = r.normal(size=(B, n)) * 0.1
    Ax = np.einsum("bmn,bn->bm", A, x)
    margin = np.abs(r.normal(size=(B, m))) + 0.1
    lo, hi = Ax - margin, Ax + margin
    lo[:, :4] = hi[:, :4] = Ax[:, :4]
    lo[:, 10:13] = -1e20
    hi[:, 12:15] = 1e20
    eqf = ((hi - lo) < 1e-9).astype(np.float32)
    return [torch.as_tensor(a, dtype=torch.float32).to(device).contiguous()
            for a in (P, r.normal(size=(B, n)), A, lo, hi, eqf,
                      r.normal(size=(B, n)) * 0.1,
                      r.normal(size=(B, m)) * 0.1)]


def fused_launch(lib, args, kw, lay):
    B, n = args[1].shape
    m = args[3].shape[1]
    outs = [torch.empty_like(args[1]), torch.empty_like(args[3]),
            torch.empty_like(args[1]), torch.empty_like(args[3]),
            args[1].new_empty((B,))]
    fn = lib.admm_fused_launch
    fn.argtypes = kernels._LAUNCH_ARGTYPES["admm_fused"]
    fn.restype = ctypes.c_int
    rc = fn(*(t.data_ptr() for t in (*args, *outs)), None, B, n, m,
            kw["iters"], kw["adapt_rounds"], kw["equilibrate_iters"],
            kw["rho0"], kw["sigma"], kw["alpha"], kw["rho_eq_scale"],
            kw["inf"], lay.threads, lay.g, lay.ld, lay.slot_floats,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused launch failed: CUDA error {rc}, {lay}")
    return outs


def probe_cluster_phases(record, args, iters, lay, build):
    """Cycle counter of one thread (block 0 of each cluster) at every phase
    boundary of the cluster path's iteration; the cycles land in y_out."""
    src = (_build.CSRC / "admm_mma.cu").read_text()
    start = src.index("    for (int it = 0; it < a.iters; ++it) {\n"
                      "        const unsigned phase")
    stop = src.index("    if (rank == 0)\n        for (int j = t; j < n; "
                     "j += T) a.x_out")
    count = [0]

    def mark(match):
        count[0] += 1
        return f"{match.group(0)}\n        MARK({count[0] - 1})"

    body = re.sub(r"(        __syncthreads\(\);|        barrier_wait\(bars \+ "
                  r"\d, phase\);|n_warps,\n? *to_part\);)", mark,
                  src[start:stop])
    n_marks = len(CLUSTER_PHASES)
    if count[0] != n_marks:
        raise RuntimeError(f"cluster phases: {count[0]} marks placed, "
                           f"{n_marks} expected")
    last = ("    // no block leaves while a neighbour may still store into "
            "it\n    cluster.sync();\n")
    if last not in src[stop:]:
        raise RuntimeError("cluster phases: the final barrier moved")
    tail = src[stop:].replace(last, last + (
        "    if (rank == 0 && t == 0)\n"
        f"        for (int k_ = 0; k_ < {n_marks}; ++k_)\n"
        "            a.y_out[(size_t)b * m + k_] = (float)prof_[k_];\n"))
    head = (f"    long long prof_[{n_marks}] = {{}};\n"
            "    long long prev_ = clock64();\n"
            "#define MARK(k) { const long long now_ = clock64(); "
            "prof_[k] += now_ - prev_; prev_ = now_; }\n")
    cu = os.path.join(build, "admm_mma_phase_clocks.cu")
    so = os.path.join(build, "libadmm_mma_phase_clocks.so")
    with open(cu, "w") as f:
        f.write(src[:start] + head + body + tail)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", so, cu], check=True,
                   capture_output=True)
    fn = launcher(ctypes.CDLL(so))
    record("cluster_phases", what="the kernel with the clocks, ms",
           ms=time_ms(lambda: launch(fn, args, iters, lay.geometry), 1, 3))
    y = launch(fn, args, iters, lay.geometry)[2]
    torch.cuda.synchronize()
    cycles = y[:, :n_marks].double().mean(dim=0) / iters
    for k, name in enumerate(CLUSTER_PHASES):
        record("cluster_phases", phase=name,
               cycles_per_iteration=round(float(cycles[k]), 1),
               share=round(float(cycles[k] / cycles.sum()), 4))


def probe_fused(record, B, device, smem, n_sm, build):
    n, m = WBC[:2]
    args = fused_inputs(2, B, n, m, device)
    lay = kernels.fused_layout(n, m, B, smem, n_sm)
    lib = kernels._library("admm_fused")
    for what, kw in (("40 iterations in 3 rounds, 8 Ruiz passes", {}),
                     ("3 iterations in 3 rounds", dict(iters=3)),
                     ("3 iterations in 3 rounds, no Ruiz pass",
                      dict(iters=3, equilibrate_iters=0)),
                     ("13 iterations in 1 round", dict(iters=13,
                                                       adapt_rounds=1)),
                     ("1 iteration in 1 round, no Ruiz pass",
                      dict(iters=1, adapt_rounds=1, equilibrate_iters=0))):
        kw = dict(FUSED_KW, **kw)
        record("fused", what=what, layout=str(lay), ms=time_ms(
            lambda: fused_launch(lib, args, kw, lay), 2, 10))
    for g in (1, 2, 4, 6, 8, 11):
        lay_g = lay._replace(g=g)
        record("fused", what="scenarios per block", g=g, ms=time_ms(
            lambda: fused_launch(lib, args, FUSED_KW, lay_g), 2, 10))

    # cycle counter at every phase boundary, one warp in the middle of the
    # batch; the cycles of the last round land in its row of e_out
    mark = ("        {{ const long long now_ = clock64(); prof_[{k}] += "
            "now_ - prev_; prev_ = now_; }}\n")
    subs = [("    float rho_s = fp.rho0;\n    for (int round = 0; round < "
             "fp.n_rounds; ++round) {\n        for (int i = lane; i < m; "
             "i += 32) {\n            const float rh = srpat[i] * rho_s;",
             "    float rho_s = fp.rho0;\n    long long prof_[12] = {};\n"
             "    long long prev_ = clock64();\n    for (int round = 0; "
             "round < fp.n_rounds; ++round) {\n        for (int i = lane; "
             "i < m; i += 32) {\n            const float rh = srpat[i] * "
             "rho_s;")]
    # the factorization takes the counters as two more arguments
    header = [("                                                    "
               "float (&xr)[WN])\n{",
               "                                                    "
               "float (&xr)[WN], long long* prof_, long long& prev_)\n{")]
    subs.append(("        const bool bad = spd_warp::warp_scaled_inverse(kr, "
                 "si, n, sW, lane,\n                                         "
                 "              x0r);",
                 "        const bool bad = spd_warp::warp_scaled_inverse(kr, "
                 "si, n, sW, lane,\n                                         "
                 "              x0r, prof_, prev_);"))
    for k, (fname, anchor) in enumerate(MARKS):
        pair = (anchor, mark.format(k=(k - 1) % len(MARKS)) + anchor)
        (subs if fname == "admm_fused.cu" else header).append(pair)
    subs.append(("    if (lane == 0) io.c_out[b] = c;\n}\n\n// ---- kernel A",
                 "    if (lane == 0) io.c_out[b] = c;\n    if (lane == 0)\n"
                 "        for (int k_ = 0; k_ < 11; ++k_)\n            "
                 "io.e_out[(size_t)b * m + k_] = (float)prof_[k_];\n}\n\n"
                 "// ---- kernel A"))
    # the factorization's second half (X0, Newton-Schulz) takes them too;
    # kernel A calls it with counters it does not read
    header += [
        ("                                               float (&xr)[WN])\n{",
         "                                               float (&xr)[WN], "
         "long long* prof_, long long& prev_)\n{"),
        ("    return warp_x0_newton(ks, n, sW, lane, xr);",
         "    return warp_x0_newton(ks, n, sW, lane, xr, prof_, prev_);")]
    subs.append(("        const bool bad = spd_warp::warp_x0_newton(ks, n, sW, "
                 "lane, kinv);",
                 "        long long pa_[16] = {}, pb_ = 0;\n"
                 "        const bool bad = spd_warp::warp_x0_newton(ks, n, sW, "
                 "lane, kinv, pa_, pb_);"))
    plib = build_variant("phase clocks", subs, build, source="admm_fused.cu",
                         header_subs={"spd_inverse.cuh": header})
    outs = fused_launch(plib, args, FUSED_KW, lay)
    torch.cuda.synchronize()
    cycles = outs[3][:, :11].double()            # (B, 11) over 3 rounds
    total = cycles.sum(dim=1, keepdim=True)
    share = (cycles / total).mean(dim=0)
    for k, name in enumerate(PHASES):
        record("fused", what="share of the rounds' cycles", phase=name,
               share=round(float(share[k]), 4),
               mean_cycles_per_solve=float(cycles[:, k].mean()))


# name -> substitutions applied to admm_m2.cu (results wrong, times only)
M2_VARIANTS = {
    # on the one-block layout the products read A from device memory; here they
    # read an n-vector of shared memory instead (the same FMAs, no traffic)
    "no A loads (one-block layout)": [
        ("            matT_vec_chunks<true>(A_p, ld_a, mc, n, w, part, np, "
         "ch_a, L_a);",
         "            matT_vec_chunks<true>(x, 0, mc, n, w, part, np, ch_a, "
         "L_a);"),
        ("            mat_vec_streamed(A_p, ld_a, mc, n, xt, part);",
         "            mat_vec_streamed(x, 0, mc, n, xt, part);")],
    "no waits for the exchange": [
        (f"        barrier_wait(bars + {k}, phase);\n", "") for k in (0, 1)],
    "no products": [
        ("        if (wide_a)\n            matT_vec_chunks<true>(A_p",
         "        if (a.iters >= 0) {} else if (wide_a)\n"
         "            matT_vec_chunks<true>(A_p"),
        ("        if constexpr (REGS)\n            matT_vec_regs(",
         "        if (a.iters >= 0) {} else if constexpr (REGS)\n"
         "            matT_vec_regs("),
        ("        if (a_smem)\n            mat_vec_chunks(",
         "        if (a.iters >= 0) {} else if (a_smem)\n"
         "            mat_vec_chunks(")],
}


# One block per scenario with M2's rows and the first `rows` rows of A in
# shared memory, the other rows of A streamed from device memory every
# iteration (A' w by chunks of rows, each chunk from where its rows live;
# A x_t from shared memory for those rows, one warp per streamed row).  The
# kernel computes what the shipped one does; `rows` must be a multiple of the
# chunk of A' w.
def m2_partial_a_subs(rows):
    return [
        ("template <bool REGS>\n__global__",
         f"constexpr int A_RES_ROWS = {rows};\n\n"
         "__device__ __forceinline__ void matT_vec_split(\n"
         "    const float* sA, int ld, const float* gA, int gld, int depth,\n"
         "    const float* vec, float* part, int np, int chunks, int L)\n"
         "{\n"
         "    const int cgs = np >> 2;\n"
         "    for (int unit = threadIdx.x; unit < cgs * chunks;\n"
         "         unit += blockDim.x) {\n"
         "        const int ch = unit / cgs;\n"
         "        const int j = 4 * (unit - ch * cgs);\n"
         "        const int i1 = min(depth, ch * L + L);\n"
         "        int i = ch * L;\n"
         "        const bool res = i < A_RES_ROWS;\n"
         "        const int s = res ? ld : gld;\n"
         "        const float* mp = (res ? sA : gA) + (size_t)i * s + j;\n"
         "        float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;\n"
         "        for (; i + 3 < i1; i += 4, mp += 4 * s) {\n"
         "            const float4 v = f4(vec + i);\n"
         "            fma4(a0, f4(mp), v.x);\n"
         "            fma4(a1, f4(mp + s), v.y);\n"
         "            fma4(a0, f4(mp + 2 * s), v.z);\n"
         "            fma4(a1, f4(mp + 3 * s), v.w);\n"
         "        }\n"
         "        for (; i < i1; ++i, mp += s) fma4(a0, f4(mp), vec[i]);\n"
         "        *reinterpret_cast<float4*>(part + ch * np + j) =\n"
         "            add4(a0, a1);\n"
         "    }\n"
         "}\n\n"
         "template <bool REGS>\n__global__"),
        ("    if (resident & RES_A) {\n"
         "        load_rows(p, ld, A_p, mc, n, t, T);",
         "    const float* A_g = A_p;\n"
         "    if (resident & RES_A) {\n"
         "        load_rows(p, ld, A_p, min(mc, A_RES_ROWS), n, t, T);"),
        ("            matT_vec_chunks<true>(A_p, ld_a, mc, n, w, part, np, "
         "ch_a, L_a);",
         "            matT_vec_split(A_p, ld_a, A_g, n, mc, w, part, np, "
         "ch_a, L_a);"),
        ("            mat_vec_chunks(A_p, ld_a, mc, np, xt, part, kch_used, "
         "KL);",
         "        {\n"
         "            mat_vec_chunks(A_p, ld_a, min(mc, A_RES_ROWS), np, xt,\n"
         "                           part, 1, KL);\n"
         "            mat_vec_streamed(A_g + (size_t)A_RES_ROWS * n, n,\n"
         "                             mc - A_RES_ROWS, n, xt,\n"
         "                             part + A_RES_ROWS);\n"
         "        }"),
        ("    if (resident & RES_A) want += rows_m * ld;",
         "    if (resident & RES_A) want += A_RES_ROWS * ld;")]


def m2_geometry(n, m, ld, cluster, threads=0, m2="regs", a_resident=True):
    """The launcher's geometry for a cluster size, a block size and where M2
    ("regs", "smem" or "streamed") and A live."""
    rows_n, rows_m, threads, floats = kernels.m2_block(n, m, cluster, threads)
    resident = kernels.RES_M2_A if a_resident else 0
    if a_resident:
        floats += rows_m * ld
    if m2 == "regs":
        resident |= kernels.RES_M2_REGS
    elif m2 == "smem":
        resident |= kernels.RES_M2
        floats += rows_n * ld
    return (cluster, threads, ld, resident, floats)


def m2_launch(fn, args, iters, geometry):
    B, n = args[0].shape[:2]
    m = args[1].shape[1]
    outs = [torch.empty_like(t) for t in args[6:]]
    rc = fn(*(t.data_ptr() for t in (*args, *outs)), B, n, m, iters, 1e-6,
            1.6, *geometry, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"m2 launch failed: CUDA error {rc}, {geometry}")
    return outs


def m2_launcher(lib):
    fn = lib.admm_m2_launch
    fn.argtypes = kernels._LAUNCH_ARGTYPES["admm_m2"]
    fn.restype = ctypes.c_int
    return fn


def probe_m2(record, B, device, smem, build):
    n, m, it = MPC
    src = inputs(1, B, n, m, device)
    # M2 of the QP whose P is inputs()' K: K = P + A' rho A and its inverse
    # in float64, M2 = 2 K^-1 - K^-1 K K^-1 (a converging iteration, so that
    # two layouts' results can be compared), then A, q, l, u, rho, x, z, y
    P, A, rho = (src[i].double() for i in (1, 2, 6))
    K = P + torch.bmm((A * rho[:, :, None]).transpose(1, 2), A)
    Ki = torch.linalg.inv(K)
    args = [(2.0 * Ki - Ki @ K @ Ki).float().contiguous()] + src[2:]
    del P, A, rho, K, Ki
    lay = kernels.m2_layout(n, m, smem)
    real = m2_launcher(kernels._library("admm_m2"))
    ld = lay.ld
    pr1 = m2_geometry(n, m, ld, 1, 512, m2="smem", a_resident=False)
    for what, geo in (
            ("chosen: clusters of 2, M2 in registers", lay.geometry),
            ("clusters of 2, M2 in shared memory",
             m2_geometry(n, m, ld, 2, m2="smem")),
            ("clusters of 2, M2 in registers, A streamed",
             m2_geometry(n, m, ld, 2, a_resident=False)),
            ("clusters of 4, M2 in registers", m2_geometry(n, m, ld, 4)),
            ("clusters of 4, M2 in shared memory",
             m2_geometry(n, m, ld, 4, m2="smem")),
            ("one block, M2 in shared memory, A streamed (one-block layout)",
             pr1)):
        record("m2", what=what, geometry=geo,
               bytes_per_block=4 * geo[-1],
               ms=time_ms(lambda: m2_launch(real, args, it, geo), 1, 3))
    # block and cluster sizes, M2 in registers: interleaved rounds in one
    # call (a single sample of each is within the spread between samples);
    # 0 threads: m2_block's choice at that cluster size
    rivals = [(2, t) for t in sorted({384, 416, 448, 480, 512, lay.threads})]
    rivals += [(3, 0), (4, 0), (4, 256), (4, 384)]
    geos = {r: m2_geometry(n, m, ld, *r) for r in rivals}
    times = {r: [] for r in rivals}
    for _ in range(6):
        for r in rivals:
            times[r].append(time_ms(
                lambda: m2_launch(real, args, it, geos[r]), 1, 5))
    for r in rivals:
        record("m2", what="M2 in registers, cluster and block size",
               cluster=r[0], threads=geos[r][1],
               chosen=geos[r] == lay.geometry, rounds_ms=times[r],
               median_ms=float(np.median(times[r])), min_ms=min(times[r]))
    for iters in (0, 1):
        record("m2", what=f"chosen layout, {iters} iterations",
               ms=time_ms(lambda: m2_launch(real, args, iters,
                                            lay.geometry), 1, 3))
    active = kernels.m2_active_clusters(lay)
    for Bs in (active, 2 * active):
        part = [t[:Bs].contiguous() for t in args]
        record("m2", what="scenarios", B=Bs, clusters_at_once=active,
               ms=time_ms(lambda: m2_launch(real, part, it, lay.geometry),
                          1, 3))
    for name, subs in M2_VARIANTS.items():
        fn = m2_launcher(build_variant(name, subs, build, source="admm_m2.cu"))
        geos = ([("one-block layout", pr1)] if "one-block" in name else
                [("chosen layout", lay.geometry),
                 ("one-block layout", pr1)])
        for where, geo in geos:
            record("m2", variant=name, layout=where,
                   ms=time_ms(lambda: m2_launch(fn, args, it, geo), 1, 3))

    # one block per scenario: M2 does not fit registers (48 column groups x
    # 16 chunks of 12 rows is 768 threads, over the 512 of a block), so it
    # sits in shared memory, with as many rows of A beside it as fit, in
    # whole chunks of A' w; the other rows streamed
    rows_n, rows_m, threads, vec = kernels.m2_block(n, m, 1, 512)
    chunk = kernels._round4(-(-m // max(1, threads // (kernels._round4(n)
                                                        // 4))))
    rows = (smem // 4 - vec - rows_n * ld) // ld // chunk * chunk
    floats = vec + rows_n * ld + rows * ld
    geo = (1, threads, ld, kernels.RES_M2 | kernels.RES_M2_A, floats)
    fn = m2_launcher(build_variant("partial A", m2_partial_a_subs(rows),
                                   build, source="admm_m2.cu"))
    got = m2_launch(fn, args, it, geo)
    want = m2_launch(real, args, it, lay.geometry)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    record("m2", what="one block, M2 in shared memory, rows of A in shared "
           "memory, the rest streamed", rows_of_a_resident=rows,
           rows_of_a=m, geometry=geo, bytes_per_block=4 * floats,
           max_abs_diff_to_chosen=err,
           ms=time_ms(lambda: m2_launch(fn, args, it, geo), 1, 3))


def vpu_launch(fn, args, iters, geometry):
    B, n = args[0].shape[:2]
    m = args[2].shape[1]
    outs = [torch.empty_like(t) for t in args[7:]]
    rc = fn(*(t.data_ptr() for t in (*args, *outs)), B, n, m, iters, 1e-6,
            1.6, *geometry, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"vpu launch failed: CUDA error {rc}, {geometry}")
    return outs


# rows lane and lane + 32 of A in registers for A x_t (m <= 64): a patched
# copy of the warp loop kernels 2 and 3 share (warp_regs.cuh; the same
# results)
VPU_A_IN_REGISTERS = {"warp_regs.cuh": [
    ("    for (int it = 0; it < iters; ++it) {\n",
     "    float areg[2][WARP_N];\n"
     "#pragma unroll\n"
     "    for (int h = 0; h < 2; ++h)\n"
     "#pragma unroll\n"
     "        for (int k = 0; k < WARP_N; ++k)\n"
     "            areg[h][k] = lane + 32 * h < m && k < n\n"
     "                ? s.A[(lane + 32 * h) * ld + k] : 0.f;\n"
     "    for (int it = 0; it < iters; ++it) {\n"),
    ("        for (int i = lane; i < m; i += 32)\n"
     "            project(i, dot_row4(s.A + i * ld, s.xt, kp));\n",
     "        if (lane < m) project(lane, dot32(areg[0], s.xt));\n"
     "        if (lane + 32 < m) project(lane + 32, dot32(areg[1], s.xt));\n")]}


def probe_vpu(record, B, device, smem, n_sm, build):
    n, m, it = WBC
    assert m <= 64, "the patched copy holds two rows of A per lane"
    args = inputs(0, B, n, m, device)
    lay = kernels.vpu_layout(n, m, B, smem, n_sm)

    def vpu_launcher(lib):
        fn = lib.admm_vpu_launch
        fn.argtypes = kernels._LAUNCH_ARGTYPES["admm_vpu"]
        fn.restype = ctypes.c_int
        return fn

    real = vpu_launcher(kernels._library("admm_vpu"))
    aregs = vpu_launcher(build_variant("A in registers", [], build,
                                       source="admm_vpu.cu",
                                       header_subs=VPU_A_IN_REGISTERS))
    got = vpu_launch(aregs, args, it, lay.geometry)
    want = vpu_launch(real, args, it, lay.geometry)
    torch.cuda.synchronize()
    record("vpu", what="rows of A in registers vs shipped, max abs diff",
           err=max(float((a - b).abs().max()) for a, b in zip(got, want)))
    for g in (1, 2, 4, 8):
        geo = (g, 32 * g, lay.ld, lay.slot_floats)
        for A, fn in (("shared memory", real),
                      ("registers and shared memory", aregs)):
            record("vpu", path="warp", g=g, A=A, chosen=geo == lay.geometry,
                   ms=time_ms(lambda: vpu_launch(fn, args, it, geo), 2, 10))
    record("vpu", path="warp", what="chosen layout, 0 iterations (the load)",
           geometry=lay.geometry,
           ms=time_ms(lambda: vpu_launch(real, args, 0, lay.geometry), 2, 10))
    block = (0, kernels._pick_threads(n), 0, 0)
    record("vpu", path="block", what="one block per scenario (the block path)",
           ms=time_ms(lambda: vpu_launch(real, args, it, block), 2, 10))


# ---- kernel 3 (admm_packed.cu): the register path's load, other designs
#
# Patched copies of admm_packed.cu (the same results bit for bit; the
# shipped source has no switch).  Each replaces the shipped load's steps 1
# and 2 (K^-1 and K row by row to the odd stride n | 1, then into registers)
# or the whole load, or adds an L2 prefetch.  The block-staged and bulk
# designs copy K^-1 and K flat in 16-byte pieces, so they need n * n to be a
# multiple of four (n = 30 is).

PACKED_STEPS_1_2 = ("    // 1. K^-1 and K -> staging in A's place",
                    "    // 3. A's rows -> the slot at stride REG_LD")
PACKED_WHOLE_LOAD = ("    // 1. K^-1 and K -> staging in A's place",
                     "__global__ void __launch_bounds__(32 * MAX_REG_SLOTS)")

# row `lane` of K^-1 and column `lane` of K from a flat copy (stride n)
_FILL_FLAT = """#pragma unroll
    for (int k = 0; k < WARP_N; ++k) {
        kinv[k] = own && k < n ? stKinv[lane * n + k] : 0.f;
        kcol[k] = own && k < n ? stK[k * n + lane] : 0.f;
    }
    __syncwarp();
"""
_VECTORS = """    warp_regs::load_vectors(s, a.q + vn, a.l + vm, a.u + vm, a.rho + vm,
                            a.x0 + vn, a.z0 + vm, a.y0 + vm, n, m, lane, x,
                            q);
"""

# kernel 2's own per-warp load: K^-1's rows and K's columns straight from
# device memory into registers, A by load_rows (cp.async, 4 bytes each)
PACKED_KERNEL2_LOAD = """    const float* gKinv = a.Kinv + vn * n;
    const float* gK = a.K + vn * n;
    cluster_exchange::load_rows(s.A, REG_LD, a.A + vm * n, m, n, lane, 32);
    for (int k = m * REG_LD + lane; k < mp * REG_LD; k += 32) s.A[k] = 0.f;
#pragma unroll
    for (int k = 0; k < WARP_N; ++k) {
        kinv[k] = own && k < n ? gKinv[lane * n + k] : 0.f;
        kcol[k] = own && k < n ? gK[k * n + lane] : 0.f;
    }
""" + _VECTORS + """    cp_async_wait();
    __syncwarp();
}

"""

# one cp.async.bulk per matrix by lane 0, flat, counted by an mbarrier in
# x_t's place (x_t is first written by the iterations, after the barrier is
# gone); needs 16-byte multiples and alignment (n even, traps otherwise)
PACKED_BULK_STEPS_1_2 = """    const int nn = n * n;
    float* stKinv = s.A;
    float* stK = s.A + round4(nn);
    const float* gKinv = a.Kinv + vn * n;
    const float* gK = a.K + vn * n;
    uint64_t* bar = reinterpret_cast<uint64_t*>(s.xt);
    const unsigned bytes = 4u * (unsigned)nn;
    if (((bytes & 15u) | (unsigned)(reinterpret_cast<uintptr_t>(gKinv) & 15)
         | (unsigned)(reinterpret_cast<uintptr_t>(gK) & 15)) != 0u)
        __trap();
    if (lane == 0) {
        cluster_exchange::barrier_init(bar);
        asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
        cluster_exchange::barrier_expect(bar, 2u * bytes);
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\\n"
            :: "r"(cluster_exchange::shared_addr(stKinv)), "l"(gKinv),
               "r"(bytes), "r"(cluster_exchange::shared_addr(bar))
            : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\\n"
            :: "r"(cluster_exchange::shared_addr(stK)), "l"(gK),
               "r"(bytes), "r"(cluster_exchange::shared_addr(bar))
            : "memory");
    }
    __syncwarp();
""" + _VECTORS + """    cluster_exchange::barrier_wait(bar, 0);
""" + _FILL_FLAT + """    if (lane == 0)
        asm volatile("mbarrier.inval.shared::cta.b64 [%0];\\n"
                     :: "r"(cluster_exchange::shared_addr(bar)) : "memory");
    __syncwarp();
"""

# before it iterates, each warp asks L2 for the matrices of the scenario
# 2,112 ahead (the warps an H100 holds at once at g = 4: the warp that will
# take this one's place), one 128-byte line per lane and step
PACKED_L2_PREFETCH = [
    ("__global__ void __launch_bounds__(32 * MAX_REG_SLOTS)",
     """__device__ __forceinline__ void prefetch_scenario(const PackedArgs& a,
                                                  int b, int lane)
{
    const size_t nn = (size_t)a.n * a.n, mn = (size_t)a.m * a.n;
    const float* mats[3] = {a.Kinv + (size_t)b * nn, a.K + (size_t)b * nn,
                            a.A + (size_t)b * mn};
    const size_t counts[3] = {nn, nn, mn};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        for (size_t off = (size_t)lane * 32; off < counts[k]; off += 32 * 32)
            asm volatile("prefetch.global.L2 [%0];\\n" :: "l"(mats[k] + off));
        if (lane == 0)
            asm volatile("prefetch.global.L2 [%0];\\n"
                         :: "l"(mats[k] + counts[k] - 1));
    }
}

__global__ void __launch_bounds__(32 * MAX_REG_SLOTS)"""),
    ("    load_scenario(a, b, s, kinv, kcol, x, q, lane);\n",
     "    load_scenario(a, b, s, kinv, kcol, x, q, lane);\n"
     "    if (b + 2112 < a.B) prefetch_scenario(a, b + 2112, lane);\n")]

# the whole block copies its scenarios' K^-1 and K flat (16-byte cp.async),
# waits at one block barrier, then each warp fills its registers
PACKED_BLOCK_STAGED = [
    ("    if (b >= a.B) return;      // nothing below waits for another warp\n"
     "    const warp_regs::Slot s",
     "    const warp_regs::Slot s"),
    ("    float kinv[WARP_N], kcol[WARP_N], x, q;\n",
     """    {
        const int nn = a.n * a.n, c4 = nn >> 2;
        const int G = blockDim.x >> 5, b0 = blockIdx.x * G;
        const int Gv = min(G, a.B - b0);
        if ((nn & 3) != 0) __trap();
        for (int c = threadIdx.x; c < 2 * Gv * c4; c += blockDim.x) {
            const int mat = c / (Gv * c4);
            const int rest = c - mat * Gv * c4;
            const int w = rest / c4, k = rest - w * c4;
            cluster_exchange::cp_async16(
                smem + (size_t)w * slot_floats + mat * round4(nn) + 4 * k,
                (mat ? a.K : a.Kinv) + (size_t)(b0 + w) * nn + 4 * k);
        }
        cp_async_wait();
        __syncthreads();
    }
    if (b >= a.B) return;
    float kinv[WARP_N], kcol[WARP_N], x, q;
""")]
PACKED_BLOCK_STEPS_1_2 = """    const float* stKinv = s.A;
    const float* stK = s.A + round4(n * n);
""" + _VECTORS + _FILL_FLAT


def _between(src, start, end):
    """The text of `src` from `start` up to (not including) `end`."""
    i = src.index(start)
    return src[i:src.index(end, i)]


def probe_packed(record, B, device, smem, n_sm, build, rounds=6):
    """Kernel 3 at the WBC shape: the shipped design against kernel 2 and
    the patched designs (other loads, an L2 prefetch), in interleaved
    rounds, each also with 0 iterations (the load alone), the shipped design
    at g = 4, 8, 12, 16 scenarios per block, and on one wave of scenarios
    (B = 132 x 16)."""
    n, m, it = WBC
    args = inputs(0, B, n, m, device)
    lay = kernels.packed_layout(n, m, B, smem, n_sm,
                                kernels.packed_slot_floats)
    vlay = kernels.vpu_layout(n, m, B, smem, n_sm)
    record("packed", what="chosen layout", path=lay.path, g=lay.g,
           slot_floats=lay.slot_floats, vpu_geometry=vlay.geometry)

    def launcher_of(lib, name):
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = kernels._LAUNCH_ARGTYPES[name]
        fn.restype = ctypes.c_int
        return fn

    src = (_build.CSRC / "admm_packed.cu").read_text()
    steps = _between(src, *PACKED_STEPS_1_2)
    designs = {
        "shipped": (launcher_of(kernels._library("admm_packed"),
                                "admm_packed"), lay.geometry),
        "kernel 2": (launcher_of(kernels._library("admm_vpu"), "admm_vpu"),
                     vlay.geometry)}
    variants = {
        "per-warp cp.async.bulk + mbarrier": [
            (steps, PACKED_BULK_STEPS_1_2)],
        "L2 prefetch of the next wave": PACKED_L2_PREFETCH,
        "kernel 2's per-warp loads": [
            (_between(src, *PACKED_WHOLE_LOAD), PACKED_KERNEL2_LOAD)],
        "block-staged 16-byte cp.async": PACKED_BLOCK_STAGED + [
            (steps, PACKED_BLOCK_STEPS_1_2)]}
    for name, subs in variants.items():
        t0 = time.time()
        try:
            lib = build_variant(name, subs, build, source="admm_packed.cu")
        except RuntimeError as e:
            record("packed", design=name, error=str(e)[-2000:])
            continue
        designs[name] = (launcher_of(lib, "admm_packed"), lay.geometry)
        record("packed", design=name, build_s=round(time.time() - t0, 1))

    want = vpu_launch(designs["shipped"][0], args, it, lay.geometry)
    torch.cuda.synchronize()
    for name, (fn, geo) in designs.items():
        got = vpu_launch(fn, args, it, geo)
        torch.cuda.synchronize()
        record("packed", design=name, what="max abs diff to shipped, "
               "bit for bit = 0", err=max(float((a - b).abs().max())
                                          for a, b in zip(got, want)))
    cases = [(name, fn, geo, iters) for name, (fn, geo) in designs.items()
             for iters in (it, 0)]
    # the shipped design on one wave of scenarios (no next wave to prefetch)
    one_wave = inputs(0, 132 * 16, n, m, device)
    for g in (4, 8, 12, 16):
        geo = (kernels.PACKED_PATHS["registers"], g, lay.ld, lay.slot_floats)
        if geo != lay.geometry:
            cases.append((f"shipped, g={g}", designs["shipped"][0], geo, it))
    cases.append(("shipped, B=2112 (one wave)", designs["shipped"][0],
                  lay.geometry, it))
    times = {f"{c[0]}, iters={c[3]}": [] for c in cases}
    for r in range(rounds):
        order = cases if r % 2 == 0 else cases[::-1]
        for name, fn, geo, iters in order:
            src_args = one_wave if "one wave" in name else args
            times[f"{name}, iters={iters}"].append(time_ms(
                lambda: vpu_launch(fn, src_args, iters, geo), 2, 10))
    for key, ts in times.items():
        record("packed", design=key, rounds=[round(t, 6) for t in ts],
               median_ms=float(np.median(ts)))


def probe_mma(record, B, device, smem, n_sm, build):
    real = launcher(kernels._library("admm_mma"))
    wbc = inputs(0, B, *WBC[:2], device)
    mpc = inputs(1, B, *MPC[:2], device)
    chosen = {"wbc": kernels.mma_layout(*WBC[:2], B, smem, n_sm),
              "mpc": kernels.mma_layout(*MPC[:2], B, smem, n_sm)}
    record("layouts", what="chosen layouts", chosen=str(chosen))

    # ---- 1. layouts -----------------------------------------------------
    n, m, it = WBC
    for ld in (32, 36, 40, 48):
        fit = smem // (4 * warp_geometry(n, m, ld, 1)[-1])
        for g in (1, 2, kernels.MAX_MMA_SLOTS):
            geo = warp_geometry(n, m, ld, g)
            record("layouts", shape="wbc", path="warp", ld=ld, g=g,
                   fit_per_multiprocessor=fit,
                   ms=time_ms(lambda: launch(real, wbc, it, geo), 2, 10))
    record("layouts", shape="wbc", path="warp", what="load only (0 "
           "iterations)", ms=time_ms(
               lambda: launch(real, wbc, 0, chosen["wbc"].geometry), 2, 10))
    n, m, it = MPC
    # resident: 7 = K^-1, A and K in shared memory; 3 = K streamed from
    # device memory / L2 every iteration; 1 = A and K streamed (one block
    # per scenario with K^-1 resident is the design this kernel had before)
    for cluster, ld, threads, resident in (
            (3, 192, 256, 7), (3, 192, 384, 7), (3, 192, 512, 7),
            (3, 196, 384, 7), (3, 208, 384, 7), (4, 192, 384, 7),
            (4, 192, 512, 7), (5, 192, 384, 7), (6, 192, 384, 7),
            (8, 192, 256, 7), (8, 192, 512, 7), (4, 192, 384, 3),
            (2, 192, 384, 3), (2, 192, 512, 3), (1, 192, 512, 1)):
        geo = cluster_geometry(n, m, cluster, ld, threads, resident)
        record("layouts", shape="mpc", path="cluster", cluster=cluster,
               ld=ld, threads=threads, resident=resident,
               bytes_per_block=4 * geo[-1],
               ms=time_ms(lambda: launch(real, mpc, it, geo), 1, 3))
    for iters in (0, 1, 2):
        record("layouts", shape="mpc", path="cluster", what=f"{iters} "
               "iterations", ms=time_ms(
                   lambda: launch(real, mpc, iters, chosen["mpc"].geometry),
                   1, 3))

    # how the time grows with the number of scenarios in flight: one block
    # of warps per multiprocessor, a full multiprocessor, several waves
    n, m, it = WBC
    for Bs in (4 * n_sm, 8 * n_sm, 12 * n_sm, 24 * n_sm):
        part = [t[:Bs].contiguous() for t in wbc]
        geo = kernels.mma_layout(n, m, Bs, smem, n_sm).geometry
        record("layouts", shape="wbc", path="warp", what="scenarios", B=Bs,
               ms=time_ms(lambda: launch(real, part, it, geo), 2, 10))
    n, m, it = MPC
    for Bs in (1, n_sm // 3, 10 * (n_sm // 3)):
        part = [t[:Bs].contiguous() for t in mpc]
        record("layouts", shape="mpc", path="cluster", what="scenarios",
               B=Bs, ms=time_ms(lambda: launch(
                   real, part, it, chosen["mpc"].geometry), 1, 3))
    del part

    # ---- 2. variants (wrong results, times only) --------------------------
    for shape, args, iters in (("mpc", mpc, MPC[2]), ("wbc", wbc, WBC[2])):
        record("variants", shape=shape, variant="the kernel as shipped",
               ms=time_ms(lambda: launch(real, args, iters,
                                         chosen[shape].geometry), 1, 3))
    for name, subs in VARIANTS.items():
        t0 = time.time()
        fn = launcher(build_variant(name, subs, build))
        for shape, args, iters in (("mpc", mpc, MPC[2]),
                                   ("wbc", wbc, WBC[2])):
            if shape == "wbc" and "cluster" in name:
                continue     # the warp path has no exchange
            record("variants", shape=shape, variant=name,
                   build_s=round(time.time() - t0, 1),
                   ms=time_ms(lambda: launch(fn, args, iters,
                                             chosen[shape].geometry), 1, 3))

    probe_cluster_phases(record, mpc, MPC[2], chosen["mpc"], build)


# ---- kernels A and B against the designs they replaced -------------------

# kernel B's scalar-sweep block path, the design before the blocked one (a
# right-looking sweep, 2 x 192
# dependent steps, the matrix in shared memory at the stride n + 1), put
# back beside the shipped kernel as a second kernel and launcher
SWEEP_KERNEL = r'''__global__ void __launch_bounds__(1024)
spd_inverse_sweep_kernel(const float* __restrict__ K, float* __restrict__ ks,
                         float* __restrict__ s_out, float* li,
                         float* __restrict__ two_eye, int n, int in_smem)
{
    extern __shared__ __align__(16) float smem[];
    const int b = blockIdx.x;
    const int t = threadIdx.x, T = blockDim.x;
    const int lane = t & 31, warp = t >> 5, n_warps = T >> 5;
    const size_t nn = (size_t)n * n;
    const float* gK = K + (size_t)b * nn;
    float* gKs = ks + (size_t)b * nn;
    float* gLi = li + (size_t)b * nn;
    float* s = smem;                 // n: the Jacobi scale
    float* dL = s + n;               // n: the diagonal of L
    float* W = in_smem ? dL + n : gLi;
    const int ldw = in_smem ? n + 1 : n;

    for (int j = t; j < n; j += T) {
        const float sj = jacobi_scale(gK[(size_t)j * n + j]);
        s[j] = sj;
        s_out[(size_t)b * n + j] = sj;
    }
    __syncthreads();
    for (int k = t; k < n * n; k += T) {
        const int i = k / n, j = k - i * n;
        const float v = (gK[k] * s[i]) * s[j];
        gKs[k] = v;
        W[i * ldw + j] = v;
        two_eye[(size_t)b * nn + k] = i == j ? 2.0f : 0.f;
    }
    __syncthreads();

    // Cholesky of the lower triangle, right-looking, in place
    for (int j = 0; j < n; ++j) {
        const float piv = W[j * ldw + j];
        const float d = sqrtf(piv < 1e-10f ? 1e-10f : piv);
        if (t == 0) dL[j] = d;
        for (int i = j + 1 + t; i < n; i += T) W[i * ldw + j] /= d;
        __syncthreads();
        for (int i = j + 1 + warp; i < n; i += n_warps) {
            const float lij = W[i * ldw + j];
            for (int k = j + 1 + lane; k <= i; k += 32)
                W[i * ldw + k] = fmaf(-lij, W[k * ldw + j], W[i * ldw + k]);
        }
        __syncthreads();
    }

    // L^-1 by forward elimination of the identity, stored transposed in the
    // upper triangle: U[c][i] = L^-1[i][c], c <= i
    for (int k = t; k < n * n; k += T) {
        const int r = k / n, c = k - r * n;
        if (c >= r) W[r * ldw + c] = c == r ? 1.0f : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
        const float dk = dL[k];
        for (int c = t; c <= k; c += T) W[c * ldw + k] /= dk;
        __syncthreads();
        for (int c = warp; c <= k; c += n_warps) {
            const float xkc = W[c * ldw + k];
            for (int i = k + 1 + lane; i < n; i += 32)
                W[c * ldw + i] = fmaf(-W[i * ldw + k], xkc, W[c * ldw + i]);
        }
        __syncthreads();
    }

    // L^-1, row-major, zeros above the diagonal
    if (in_smem) {
        for (int k = t; k < n * n; k += T) {
            const int i = k / n, c = k - i * n;
            gLi[k] = c <= i ? W[c * ldw + i] : 0.f;
        }
    } else {
        for (int k = t; k < n * n; k += T) {
            const int i = k / n, c = k - i * n;
            if (c < i) {
                gLi[k] = gLi[(size_t)c * n + i];
                gLi[(size_t)c * n + i] = 0.f;
            }
        }
    }
}

'''
SWEEP_LAUNCH = r'''int spd_inverse_sweep_launch(const float* K, float* ks, float* s, float* li,
                              float* two_eye, int B, int n, int threads,
                              int in_smem, void* stream)
{
    if (B <= 0 || n <= WN || threads < 32 || threads > 1024 ||
        (threads & 31) != 0)
        return (int)cudaErrorInvalidValue;
    int max_smem = 0;
    int err = max_smem_optin(&max_smem);
    if (err != (int)cudaSuccess) return err;
    const size_t smem = sizeof(float) *
        ((size_t)2 * n + (in_smem ? (size_t)n * (n + 1) : 0));
    if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
    err = set_smem((const void*)spd_inverse_sweep_kernel, smem);
    if (err != (int)cudaSuccess) return err;
    spd_inverse_sweep_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        K, ks, s, li, two_eye, n, in_smem);
    return (int)cudaGetLastError();
}

'''
SWEEP_SUBS = [
    ("// M = 2 I - Ks X0, X = X0 M, T = Ks X:",
     SWEEP_KERNEL + "// M = 2 I - Ks X0, X = X0 M, T = Ks X:"),
    ("// The block path's guard, finite test and rescale",
     SWEEP_LAUNCH + "// The block path's guard, finite test and rescale")]

# kernel A's design before the register loop: kernel 4's warp body as a
# template on the Ruiz form, its
# norm-only instance the plain backend's solve, with kernel 4's slot
WARP_BODY_NORM_RUIZ = r'''        // norm-only: the loop carries D, E and c and reads the ORIGINAL |P|,
        // |A| through weighted abs-max reductions (the scaled matrix's column
        // max is c D_j max_i(D_i |P_ij|)); the scaling is applied once, after
        for (int it = 0; it < fp.equilibrate_iters; ++it) {
            float cn = 0.f;
            if (act) {
                float wp = 0.f, wa = 0.f;
                for (int i = 0; i < n; ++i)
                    wp = fmaxf(wp, fabsf(colP[i * ld]) * sD[i]);
                for (int i = 0; i < m; ++i)
                    wa = fmaxf(wa, fabsf(colA[i * ld]) * sE[i]);
                const float dj = sD[lane];
                cn = fmaxf((c * dj) * wp, dj * wa);
            }
            for (int i = lane; i < m; i += 32) {
                float wr = 0.f;
                for (int k = 0; k < n; ++k)
                    wr = fmaxf(wr, fabsf(sA[i * ld + k]) * sD[k]);
                const float cm = sE[i] * wr;
                sdm[i] = cm < 1e-10f ? 1.0f : rsqrtf(fmaxf(cm, 1e-12f));
            }
            __syncwarp();       // every lane has read this round's D and E
            if (act)
                sD[lane] *= cn < 1e-10f ? 1.0f : rsqrtf(fmaxf(cn, 1e-12f));
            for (int i = lane; i < m; i += 32) sE[i] *= sdm[i];
            __syncwarp();
            // cost scaling against the new D
            float pcol = 0.f, qmax = 0.f;
            if (act) {
                float wp = 0.f;
                for (int i = 0; i < n; ++i)
                    wp = fmaxf(wp, fabsf(colP[i * ld]) * sD[i]);
                const float dj = sD[lane];
                pcol = (c * dj) * wp;
                qmax = c * (fabsf(v.q[lane]) * dj);
            }
            pcol = warp_sum(pcol);
            qmax = warp_max(qmax);
            c *= 1.0f / fmaxf(fmaxf(pcol / (float)n, qmax), 1e-12f);
        }
        // P <- (c D_i) P_ij D_j, A <- E_i A_ij D_j, q <- c D q: lane j its
        // column
        if (act) {
            const float dj = sD[lane];
            for (int i = 0; i < n; ++i)
                colP[i * ld] = ((c * sD[i]) * colP[i * ld]) * dj;
            for (int i = 0; i < m; ++i)
                colA[i * ld] = (sE[i] * colA[i * ld]) * dj;
            v.q[lane] = (c * dj) * v.q[lane];
        }
        __syncwarp();
'''
WARP_BODY_SUBS = [
    ("__device__ __forceinline__ void warp_solve(const FusedIO& io,",
     "template <bool NORM_RUIZ>\n"
     "__device__ __forceinline__ void warp_solve(const FusedIO& io,"),
    ("    // ---- 1. full-rescale Ruiz + cost scaling: the matrices rescaled "
     "in place\n    // every round\n",
     "    if constexpr (NORM_RUIZ) {\n" + WARP_BODY_NORM_RUIZ + "    } else {\n"),
    ("    for (int i = lane; i < m; i += 32) {\n        const float li = "
     "v.l[i], ui = v.u[i];",
     "    }\n    for (int i = lane; i < m; i += 32) {\n        const float "
     "li = v.l[i], ui = v.u[i];"),
    ("    warp_solve(io, fp, ld);\n", "    warp_solve<false>(io, fp, ld);\n"),
    ("    plain_register_solve(io, fp);\n", "    warp_solve<true>(io, fp, ld);\n"),
    ("ld != PA ? -1 : plain_slot_floats(n, m)",
     "ld < n ? -1 : warp_slot_floats(n, m, ld)")]

# a design measured and not shipped: the factor launch writes L^-1 (zeros
# above the diagonal) and X0 = L^-T L^-1 is a fourth torch.bmm (six device
# ops an inverse, as the scalar sweep has)
LI_OUT_SUBS = [
    ("    // X0 = L^-T L^-1, symmetric, from L^-1 in W's lower triangle\n"
     "    for (int u = t; u < spd_blocked::tri(np / PW) * spd_blocked::UNITS;\n"
     "         u += T)\n"
     "        spd_blocked::x0_unit(W, ld, np, gX0, n, u,\n"
     "                             max(1, T / spd_blocked::UNITS));\n",
     "    // L^-1, row-major, zeros above the diagonal, over the X0 output\n"
     "    for (int i = warp; i < n; i += n_warps)\n"
     "        for (int c = lane; c < n; c += 32)\n"
     "            gX0[(size_t)i * n + c] = c <= i ? W[i * ld + c] : 0.f;\n")]


# the shipped block factorization with the cycle counter of thread 0 read
# after every barrier (s_out carries the sums: the inverse is not kept)
SPD_PHASES = ["load, Jacobi scale, pad", "diagonal block: factor and inverse",
              "panel solve, a block row of L^-1",
              "trailing update, the forward substitution's sums",
              "X0 = L^-T L^-1 and its store"]
SPD_CLOCK_HEADER_SUBS = [
    ("        ex.diag(W + c0 * ld + c0, ld);\n        ex.sync();\n",
     "        ex.diag(W + c0 * ld + c0, ld);\n        ex.sync();\n"
     "        ex.mark(1);\n"),
    ("                fwd_scale_unit(W, ld, p, u - R * UNITS);\n        }\n"
     "        ex.sync();\n",
     "                fwd_scale_unit(W, ld, p, u - R * UNITS);\n        }\n"
     "        ex.sync();\n        ex.mark(2);\n"),
    ("                fwd_update_unit(W, ld, P, p, u - tri(R) * UNITS);\n"
     "        }\n        ex.sync();\n",
     "                fwd_update_unit(W, ld, P, p, u - tri(R) * UNITS);\n"
     "        }\n        ex.sync();\n        ex.mark(3);\n")]
SPD_CLOCK_SUBS = [
    ("struct BlockExec {\n",
     "struct BlockExec {\n    long long prof[8] = {};\n"
     "    long long prev = 0;\n"
     "    __device__ void mark(int k)\n    {\n"
     "        const long long now = clock64();\n"
     "        prof[k] += now - prev;\n        prev = now;\n    }\n"),
    ("    BlockExec ex;\n    spd_blocked::factor_and_invert(ex, W, ld, P, np);\n",
     "    BlockExec ex;\n    ex.prev = clock64();\n"
     "    ex.prof[0] = ex.prev - start_;\n"
     "    spd_blocked::factor_and_invert(ex, W, ld, P, np);\n"),
    ("    const int np = spd_blocked::padded(n), ld = spd_blocked::stride(np);\n",
     "    const long long start_ = clock64();\n"
     "    const int np = spd_blocked::padded(n), ld = spd_blocked::stride(np);\n"),
    ("                             max(1, T / spd_blocked::UNITS));\n}\n",
     "                             max(1, T / spd_blocked::UNITS));\n"
     "    __syncthreads();\n    ex.mark(4);\n    if (t == 0)\n"
     "        for (int k_ = 0; k_ < 5; ++k_)\n"
     "            s_out[(size_t)b * n + k_] = (float)ex.prof[k_];\n}\n")]

# the shipped kernel A with one warp's cycle counter read at its phase
# boundaries (e_out carries the sums: the solve's scales are not kept)
PLAIN_PHASES = ["Ruiz, warm start", "K = P + sigma I + A' rho A",
                "K^-1", "iterations", "rho adaptation"]
PLAIN_CLOCK_SUBS = [
    ("    float* sW = smem + (size_t)warp * slot_floats;   // the inverse's "
     "scratch\n",
     "    float* sW = smem + (size_t)warp * slot_floats;   // the inverse's "
     "scratch\n    long long prof_[5] = {};\n    long long prev_ = clock64();\n"
     "#define MARK(k) { const long long now_ = clock64(); prof_[k] += now_ - "
     "prev_; prev_ = now_; }\n"),
    ("        for (int i = lane; i < mp; i += 32) {\n            const float rh "
     "= srpat[i] * rho_s;",
     "        MARK(round == 0 ? 0 : 4)\n        for (int i = lane; i < mp; i "
     "+= 32) {\n            const float rh = srpat[i] * rho_s;"),
    ("        // row `lane` of K^-1 = s X s, kept in registers:",
     "        MARK(1)\n        // row `lane` of K^-1 = s X s, kept in "
     "registers:"),
    ("        x = warp_regs::warp_register_iterations(",
     "        MARK(2)\n        x = warp_regs::warp_register_iterations("),
    ("        if (round + 1 < fp.n_rounds) {\n            // the residual "
     "ratios of the scaled problem",
     "        MARK(3)\n        if (round + 1 < fp.n_rounds) {\n            "
     "// the residual ratios of the scaled problem"),
    ("    if (lane == 0) io.c_out[b] = c;\n}\n\n// kernel 4's warp path",
     "    if (lane == 0) io.c_out[b] = c;\n    if (lane == 0)\n"
     "        for (int k_ = 0; k_ < 5; ++k_)\n"
     "            io.e_out[(size_t)b * m + k_] = (float)prof_[k_];\n}\n\n"
     "// kernel 4's warp path")]


def interleaved(record, kind, fns, rounds, warmup=2, reps=10, **tags):
    """Time each of `fns` (name -> callable) in `rounds` rounds, the order
    reversed every other round (a, b, b, a, ...); records each round's ms
    and the median per design."""
    names = list(fns)
    times = {k: [] for k in names}
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            times[k].append(time_ms(fns[k], warmup, reps))
    for k in names:
        record(kind, design=k, ms_rounds=[round(t, 5) for t in times[k]],
               ms_median=float(np.median(times[k])), **tags)
    return {k: float(np.median(times[k])) for k in names}


def spd_pipeline(lib, factor, K):
    """The block path with a factor launch `factor` that writes s, Ks, L^-1
    and 2 I (the scalar sweep's, or the blocked one with L^-1 out): X0 =
    L^-T L^-1 and
    the Newton-Schulz step on four torch.bmm, the guard launch as shipped."""
    B, n = K.shape[:2]
    Ks, Li, M = (torch.empty_like(K) for _ in range(3))
    s = K.new_empty((B, n))
    stream = torch.cuda.current_stream().cuda_stream
    rc = factor(K, Ks, s, Li, M, stream)
    if rc != 0:
        raise RuntimeError(f"factor launch failed: CUDA error {rc}")
    X0 = torch.bmm(Li.transpose(1, 2), Li)
    M.baddbmm_(Ks, X0, alpha=-1.0)
    X = torch.bmm(X0, M)
    T1 = torch.bmm(Ks, X, out=Li)
    rc = lib.spd_inverse_select_launch(X0.data_ptr(), M.data_ptr(),
                                       X.data_ptr(), T1.data_ptr(),
                                       s.data_ptr(), Ks.data_ptr(), B, n,
                                       stream)
    if rc != 0:
        raise RuntimeError(f"select launch failed: CUDA error {rc}")
    return Ks


def probe_spd(record, B, device, smem, n_sm, build, rounds=6):
    """Kernel B's block path at n = 192 (the MPC's K^-1): the shipped
    blocked factorization (X0 in the launch; three products) against the
    scalar sweep it replaced (patched copy; four products) and against the
    blocked factorization with X0 on torch.bmm (patched copy), whole
    chol_inverse and factor launch alone, in interleaved rounds at B = 1 and
    B; other block sizes; the share of each phase of the shipped factor
    launch (cycle counter)."""
    n = MPC[0]
    r = np.random.default_rng(13)
    Q = r.normal(size=(64, n, n))
    K64 = torch.as_tensor(Q @ Q.transpose(0, 2, 1) / n + np.eye(n),
                          dtype=torch.float32, device=device)
    old = build_variant("scalar sweep", SWEEP_SUBS, build,
                        source="spd_inverse.cu")
    old.spd_inverse_sweep_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    old.spd_inverse_select_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lio = build_variant("L^-1 out", LI_OUT_SUBS, build,
                        source="spd_inverse.cu")
    for fn in (lio.spd_inverse_factor_launch, lio.spd_inverse_select_launch):
        fn.argtypes = (kernels._ENTRY_POINTS["spd_inverse"]
                       [fn.__name__][0])
    lib = kernels._library("spd_inverse")
    for Bs in (1, B):
        K = K64[:1].contiguous() if Bs == 1 else K64.repeat(
            Bs // 64, 1, 1).contiguous()
        lay = kernels.spd_inverse_layout(n, Bs, smem, n_sm)
        outs = [torch.empty_like(K) for _ in range(3)] + [K.new_empty((Bs, n))]

        def factor_new(K_, Ks, s, Li, M, stream, threads=lay.threads):
            return lib.spd_inverse_factor_launch(
                K_.data_ptr(), Ks.data_ptr(), s.data_ptr(), Li.data_ptr(),
                M.data_ptr(), None, Bs, n, threads, 1, stream)

        def factor_li(K_, Ks, s, Li, M, stream):
            return lio.spd_inverse_factor_launch(
                K_.data_ptr(), Ks.data_ptr(), s.data_ptr(), Li.data_ptr(),
                M.data_ptr(), None, Bs, n, lay.threads, 1, stream)

        def factor_old(K_, Ks, s, Li, M, stream):
            return old.spd_inverse_sweep_launch(
                K_.data_ptr(), Ks.data_ptr(), s.data_ptr(), Li.data_ptr(),
                M.data_ptr(), Bs, n, 1024, 1, stream)

        X_new = kernels.chol_inverse(K)
        X_old = spd_pipeline(old, factor_old, K)
        X_li = spd_pipeline(lio, factor_li, K)
        torch.cuda.synchronize()
        eye = torch.eye(n, device=device, dtype=torch.float64)
        res = [float((eye - K.double() @ X.double()).flatten(1).norm(dim=1)
                     .max()) for X in (X_new, X_old, X_li)]
        record("spd", B=Bs, what="|I - K X|_F max, shipped / scalar sweep / X0 "
               "torch.bmm", residuals=res, layout=str(lay))
        Ks, Li, M, s = outs
        stream = torch.cuda.current_stream().cuda_stream
        interleaved(record, "spd", {
            "shipped (blocked), chol_inverse": lambda: kernels.chol_inverse(K),
            "scalar sweep (the design before), chol_inverse": lambda: spd_pipeline(
                old, factor_old, K),
            "blocked, X0 on torch.bmm, chol_inverse":
                lambda: spd_pipeline(lio, factor_li, K)}, rounds, B=Bs)
        interleaved(record, "spd", {
            "shipped (blocked), factor launch": lambda: factor_new(
                K, Ks, s, Li, M, stream),
            "scalar sweep (the design before), factor launch": lambda: factor_old(
                K, Ks, s, Li, M, stream)}, rounds, B=Bs)
        for threads in (128, 256, 512):
            record("spd", B=Bs, what="factor launch, threads per block",
                   threads=threads, ms=time_ms(lambda: factor_new(
                       K, Ks, s, Li, M, stream, threads), 2, 10))
        record("spd", B=Bs, what="torch.linalg.inv_ex (library call)",
               ms=time_ms(lambda: torch.linalg.inv_ex(K), 2, 10))
    # phase clocks at B: thread 0's cycles between barriers, per matrix
    clk = build_variant("kernel B phase clocks", SPD_CLOCK_SUBS, build,
                        source="spd_inverse.cu",
                        header_subs={"spd_blocked.h": SPD_CLOCK_HEADER_SUBS,
                                     # its include resolves to the copy
                                     "spd_inverse.cuh": []})
    clk.spd_inverse_factor_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    for Bs in (1, B):
        K = K64[:1].contiguous() if Bs == 1 else K64.repeat(
            Bs // 64, 1, 1).contiguous()
        lay = kernels.spd_inverse_layout(n, Bs, smem, n_sm)
        Ks, Li, M = (torch.empty_like(K) for _ in range(3))
        s = K.new_empty((Bs, n))
        rc = clk.spd_inverse_factor_launch(
            K.data_ptr(), Ks.data_ptr(), s.data_ptr(), Li.data_ptr(),
            M.data_ptr(), None, Bs, n, lay.threads, 1,
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"phase-clock launch failed: CUDA error {rc}")
        cycles = s[:, :len(SPD_PHASES)].double()
        total = cycles.sum(dim=1, keepdim=True)
        for k, name in enumerate(SPD_PHASES):
            record("spd", B=Bs, what="share of a matrix's cycles",
                   phase=name, share=round(float((cycles[:, k:k + 1]
                                                  / total).mean()), 4),
                   mean_cycles=float(cycles[:, k].mean()))


def plain_launch(lib, args, lay):
    B, n = args[1].shape
    m = args[3].shape[1]
    kw = FUSED_KW
    outs = [torch.empty_like(args[1]), torch.empty_like(args[3]),
            torch.empty_like(args[1]), torch.empty_like(args[3]),
            args[1].new_empty((B,))]
    rc = lib.admm_plain_warp_launch(
        *(t.data_ptr() for t in (*args, *outs)), B, n, m, kw["iters"],
        kw["adapt_rounds"], kw["equilibrate_iters"], kw["rho0"], kw["sigma"],
        kw["alpha"], kw["rho_eq_scale"], kw["inf"], lay.g, lay.ld,
        lay.slot_floats, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"plain-warp launch failed: CUDA error {rc}, {lay}")
    return outs


def probe_plainwarp(record, B, device, smem, n_sm, build, rounds=6):
    """Kernel A at the WBC shape: the shipped register-loop solve against
    its design before (kernel 4's warp body with the norm-only Ruiz,
    patched copy) in
    interleaved rounds at B = 1 and B; the share of each phase."""
    n, m = WBC[:2]
    args = fused_inputs(2, B, n, m, device)
    argtypes = kernels._ENTRY_POINTS["admm_fused"]["admm_plain_warp_launch"][0]
    old = build_variant("kernel 4 warp body", WARP_BODY_SUBS, build,
                        source="admm_fused.cu")
    old.admm_plain_warp_launch.argtypes = argtypes
    lib = kernels._library("admm_fused")
    for Bs in (1, B):
        part = [t[:Bs].contiguous() for t in args]
        lay = kernels.plain_warp_layout(n, m, Bs, smem, n_sm)
        lay_old = kernels.fused_layout(n, m, Bs, smem, n_sm)
        new_o = plain_launch(lib, part, lay)
        old_o = plain_launch(old, part, lay_old)
        ref = kernels.admm_solve_plain_reference(*part, **FUSED_KW)
        torch.cuda.synchronize()
        dx = [float((o[0] * o[2] - ref[0] * ref[2]).abs().max())
              for o in (new_o, old_o)]
        record("plainwarp", B=Bs, what="max |x - x_plain| (unscaled), "
               "shipped / the design before", dx=dx, layout=str(lay),
               layout_before=str(lay_old))
        interleaved(record, "plainwarp", {
            "shipped (register loop)": lambda: plain_launch(lib, part, lay),
            "kernel 4's warp body (the design before)": lambda: plain_launch(
                old, part, lay_old)}, rounds, B=Bs)
    clk = build_variant("kernel A phase clocks", PLAIN_CLOCK_SUBS, build,
                        source="admm_fused.cu")
    clk.admm_plain_warp_launch.argtypes = argtypes
    lay = kernels.plain_warp_layout(n, m, B, smem, n_sm)
    outs = plain_launch(clk, args, lay)
    torch.cuda.synchronize()
    cycles = outs[3][:, :len(PLAIN_PHASES)].double()
    total = cycles.sum(dim=1, keepdim=True)
    for k, name in enumerate(PLAIN_PHASES):
        record("plainwarp", B=B, what="share of a solve's cycles",
               phase=name, share=round(float((cycles[:, k:k + 1]
                                              / total).mean()), 4),
               mean_cycles=float(cycles[:, k].mean()))


# ------------------------------------- the WBC build and the plant step

# PR 11's design of the two rigid-body kernels (dyn/csrc/): a thread per
# scenario in blocks of 32, the whole per-scenario body one serial chain in
# local memory, dense 6 x 6 congruences and a dense 18 x 18 Cholesky.  Its
# per-scenario functions as they stood in rbd.h, put back into a patched
# copy of the header (namespace rbd::pr11, beside the shipped units; they
# call the shipped helpers: the 3 x 3 products, wrench, xf_to_parent).
THREAD_DESIGN = r"""
RBD_FN float r_sin(float x) { return sinf(x); }
RBD_FN double r_sin(double x) { return sin(x); }
RBD_FN float r_cos(float x) { return cosf(x); }
RBD_FN double r_cos(double x) { return cos(x); }

// rotation by `angle` about coordinate axis `ax`
template <typename T>
RBD_FN void axis_rot(int ax, T angle, T* R)
{
    const T c = r_cos(angle), s = r_sin(angle);
    for (int i = 0; i < 9; ++i) R[i] = T(0);
    const int a = (ax + 1) % 3, b = (ax + 2) % 3;
    R[3 * ax + ax] = T(1);
    R[3 * a + a] = c;
    R[3 * a + b] = -s;
    R[3 * b + a] = s;
    R[3 * b + b] = c;
}

template <typename T>
RBD_FN void leg_kin(const T* C, const T* q, Kin<T>& k)
{
    quat_to_rot(q + 3, k.R0);
    for (int i = 0; i < 3; ++i) k.p0[i] = q[i];
    for (int leg = 0; leg < 4; ++leg) {
        const T* Rp = k.R0;
        const T* pp = k.p0;
        for (int lvl = 0; lvl < 3; ++lvl) {
            axis_rot(axis_of(C, lvl), q[7 + 3 * leg + lvl], k.Rr[leg][lvl]);
            T d[3];
            mv3(Rp, placement(C, lvl, leg), d);
            for (int i = 0; i < 3; ++i) k.p[leg][lvl][i] = pp[i] + d[i];
            mm3(Rp, k.Rr[leg][lvl], k.Rw[leg][lvl]);
            Rp = k.Rw[leg][lvl];
            pp = k.p[leg][lvl];
        }
        T d[3];
        mv3(k.Rw[leg][2], C + C_FOOT + 3 * leg, d);
        for (int i = 0; i < 3; ++i) k.p[leg][3][i] = k.p[leg][2][i] + d[i];
    }
}

// tau (18) = M(q) a + C(q, v) v + g(q); a == nullptr means a = 0 (the bias
// vector).  extra: optional 6x6 base spatial-inertia addend.
template <typename T>
RBD_FN void rnea(const T* C, const Kin<T>& k, const T* v, const T* a,
                 const T* extra, T* tau)
{
    const T grav = C[C_GRAV];
    const T w0[3] = {v[3], v[4], v[5]};
    const T v0[3] = {v[0], v[1], v[2]};
    T wd0[3], vd0[3];
    for (int i = 0; i < 3; ++i) {
        wd0[i] = a ? a[3 + i] : T(0);
        vd0[i] = (a ? a[i] : T(0)) + grav * k.R0[6 + i];
    }
    T Ib[36];
    for (int i = 0; i < 36; ++i)
        Ib[i] = extra ? C[C_IBASE + i] + extra[i] : C[C_IBASE + i];
    T n0[3], f0[3];
    wrench(Ib, w0, v0, wd0, vd0, n0, f0);

    T sn[3] = {T(0), T(0), T(0)}, sf[3] = {T(0), T(0), T(0)};
    for (int leg = 0; leg < 4; ++leg) {
        T w[3][3], vl[3][3], wd[3][3], vd[3][3];
        const T *wp = w0, *vp = v0, *wdp = wd0, *vdp = vd0;
        for (int lvl = 0; lvl < 3; ++lvl) {
            const T* Rr = k.Rr[leg][lvl];
            const T* pl = placement(C, lvl, leg);
            const int ax = axis_of(C, lvl);
            const T qd = v[6 + 3 * leg + lvl];
            const T qdd = a ? a[6 + 3 * leg + lvl] : T(0);
            T sq[3] = {T(0), T(0), T(0)};
            sq[ax] = qd;
            T t[3], c[3];
            mtv3(Rr, wp, w[lvl]);
            w[lvl][ax] += qd;
            cross(wp, pl, t);
            for (int i = 0; i < 3; ++i) t[i] = vp[i] + t[i];
            mtv3(Rr, t, vl[lvl]);
            mtv3(Rr, wdp, wd[lvl]);
            wd[lvl][ax] += qdd;
            cross(w[lvl], sq, c);
            for (int i = 0; i < 3; ++i) wd[lvl][i] += c[i];
            cross(wdp, pl, t);
            for (int i = 0; i < 3; ++i) t[i] = vdp[i] + t[i];
            mtv3(Rr, t, vd[lvl]);
            cross(vl[lvl], sq, c);
            for (int i = 0; i < 3; ++i) vd[lvl][i] += c[i];
            wp = w[lvl];
            vp = vl[lvl];
            wdp = wd[lvl];
            vdp = vd[lvl];
        }
        T nc[3], fc[3];
        for (int lvl = 2; lvl >= 0; --lvl) {
            T nb[3], fb[3];
            wrench(C + C_INERTIA + 36 * lvl, w[lvl], vl[lvl], wd[lvl],
                   vd[lvl], nb, fb);
            if (lvl < 2)
                for (int i = 0; i < 3; ++i) {
                    nb[i] += nc[i];
                    fb[i] += fc[i];
                }
            tau[6 + 3 * leg + lvl] = nb[axis_of(C, lvl)];
            const T* Rr = k.Rr[leg][lvl];
            T c[3];
            mv3(Rr, fb, fc);
            mv3(Rr, nb, nc);
            cross(placement(C, lvl, leg), fc, c);
            for (int i = 0; i < 3; ++i) nc[i] += c[i];
        }
        for (int i = 0; i < 3; ++i) {
            sn[i] += nc[i];
            sf[i] += fc[i];
        }
    }
    for (int i = 0; i < 3; ++i) {
        tau[i] = f0[i] + sf[i];
        tau[3 + i] = n0[i] + sn[i];
    }
}

// 6x6 motion transform child <- parent: [[R', 0], [R' skew(pl)', R']]
template <typename T>
RBD_FN void spatial_x(const T* Rr, const T* pl, T* X)
{
    for (int i = 0; i < 36; ++i) X[i] = T(0);
    // skew(pl)' = -skew(pl)
    const T Sk[9] = {T(0), pl[2], -pl[1], -pl[2], T(0), pl[0],
                     pl[1], -pl[0], T(0)};
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            const T rt = Rr[3 * j + i];          // R'[i][j]
            X[6 * i + j] = rt;
            X[6 * (3 + i) + 3 + j] = rt;
            X[6 * (3 + i) + j] = Rr[i] * Sk[j] + Rr[3 + i] * Sk[3 + j]
                                 + Rr[6 + i] * Sk[6 + j];
        }
}

// out = base + X' Ic X (6x6)
template <typename T>
RBD_FN void congruence_add(const T* base, const T* X, const T* Ic, T* out)
{
    T XtI[36];
    for (int i = 0; i < 6; ++i)
        for (int j = 0; j < 6; ++j) {
            T s = T(0);
            for (int r = 0; r < 6; ++r) s += X[6 * r + i] * Ic[6 * r + j];
            XtI[6 * i + j] = s;
        }
    for (int i = 0; i < 6; ++i)
        for (int j = 0; j < 6; ++j) {
            T s = T(0);
            for (int r = 0; r < 6; ++r) s += XtI[6 * i + r] * X[6 * r + j];
            out[6 * i + j] = base ? base[6 * i + j] + s : s;
        }
}

// Mass matrix M (18x18): dense base block, 6x12 coupling, block-diagonal
// legs.  extra: optional 6x6 base spatial-inertia addend.
template <typename T>
RBD_FN void crba(const T* C, const Kin<T>& k, const T* extra, T* M)
{
    for (int i = 0; i < NV * NV; ++i) M[i] = T(0);
    const int a0 = axis_of(C, 0), a1 = axis_of(C, 1), a2 = axis_of(C, 2);
    T S[36];
    for (int i = 0; i < 36; ++i) S[i] = T(0);
    for (int leg = 0; leg < 4; ++leg) {
        const T* pl_h = placement(C, 0, leg);
        const T* pl_u = placement(C, 1, leg);
        const T* pl_l = placement(C, 2, leg);
        const T* Ic_l = C + C_INERTIA + 72;
        T X[36], Ic_u[36], Ic_h[36], Ib[36];
        spatial_x(k.Rr[leg][2], pl_l, X);
        congruence_add(C + C_INERTIA + 36, X, Ic_l, Ic_u);
        spatial_x(k.Rr[leg][1], pl_u, X);
        congruence_add(C + C_INERTIA, X, Ic_u, Ic_h);
        spatial_x(k.Rr[leg][0], pl_h, X);
        congruence_add((const T*)nullptr, X, Ic_h, Ib);
        for (int i = 0; i < 36; ++i) S[i] += Ib[i];

        // the joint motion subspaces are unit axes: I S is a column of I
        // and S' F a component of F
        T Fk[6], Fk_u[6], Fk_h[6], Fk_b[6];
        T Fh[6], Fh_h[6], Fh_b[6], Fa[6], Fa_b[6];
        for (int i = 0; i < 6; ++i) {
            Fk[i] = Ic_l[6 * i + a2];
            Fh[i] = Ic_u[6 * i + a1];
            Fa[i] = Ic_h[6 * i + a0];
        }
        xf_to_parent(k.Rr[leg][2], pl_l, Fk, Fk_u);
        xf_to_parent(k.Rr[leg][1], pl_u, Fk_u, Fk_h);
        xf_to_parent(k.Rr[leg][0], pl_h, Fk_h, Fk_b);
        xf_to_parent(k.Rr[leg][1], pl_u, Fh, Fh_h);
        xf_to_parent(k.Rr[leg][0], pl_h, Fh_h, Fh_b);
        xf_to_parent(k.Rr[leg][0], pl_h, Fa, Fa_b);
        const T m_kk = Fk[a2], m_hk = Fk_u[a1], m_ak = Fk_h[a0];
        const T m_hh = Fh[a1], m_ah = Fh_h[a0], m_aa = Fa[a0];
        const T blk[9] = {m_aa, m_ah, m_ak, m_ah, m_hh, m_hk,
                          m_ak, m_hk, m_kk};
        const int o = 6 + 3 * leg;
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j)
                M[NV * (o + i) + o + j] = blk[3 * i + j];
        // base coupling: spatial forces [ang; lin] -> rows [lin; ang]
        const T* cols[3] = {Fa_b, Fh_b, Fk_b};
        for (int j = 0; j < 3; ++j)
            for (int r = 0; r < 6; ++r) {
                const T val = cols[j][(r + 3) % 6];
                M[NV * r + o + j] = val;
                M[NV * (o + j) + r] = val;
            }
    }
    // base 6x6: [ang; lin] spatial inertia -> [lin; ang] generalized
    for (int i = 0; i < 36; ++i) {
        S[i] = C[C_IBASE + i] + S[i];
        if (extra) S[i] = S[i] + extra[i];
    }
    for (int i = 0; i < 6; ++i)
        for (int j = 0; j < 6; ++j)
            M[NV * i + j] = S[6 * ((i + 3) % 6) + (j + 3) % 6];
}

// (12x18) world-frame linear-velocity Jacobians of the four feet, row
// 3 * leg + i; joint columns only for each foot's own leg
template <typename T>
RBD_FN void foot_jacobians(const T* C, const Kin<T>& k, T* J)
{
    for (int i = 0; i < NF * NV; ++i) J[i] = T(0);
    for (int leg = 0; leg < 4; ++leg) {
        const T* pf = k.p[leg][3];
        T d[3], r[3];
        for (int i = 0; i < 3; ++i) d[i] = pf[i] - k.p0[i];
        mtv3(k.R0, d, r);
        // base_ang = -(R0 skew(r))
        const T Sk[9] = {T(0), -r[2], r[1], r[2], T(0), -r[0],
                         -r[1], r[0], T(0)};
        T cols[3][3];
        for (int lvl = 0; lvl < 3; ++lvl) {
            const T* Rw = k.Rw[leg][lvl];
            const int ax = axis_of(C, lvl);
            const T axw[3] = {Rw[ax], Rw[3 + ax], Rw[6 + ax]};
            T e[3];
            for (int i = 0; i < 3; ++i) e[i] = pf[i] - k.p[leg][lvl][i];
            cross(axw, e, cols[lvl]);
        }
        for (int i = 0; i < 3; ++i) {
            T* row = J + NV * (3 * leg + i);
            for (int j = 0; j < 3; ++j) {
                row[j] = k.R0[3 * i + j];
                row[3 + j] = -(k.R0[3 * i] * Sk[j]
                               + k.R0[3 * i + 1] * Sk[3 + j]
                               + k.R0[3 * i + 2] * Sk[6 + j]);
            }
            for (int lvl = 0; lvl < 3; ++lvl)
                row[6 + 3 * leg + lvl] = cols[lvl][i];
        }
    }
}

// (12) world-frame Jdot v per foot (classical acceleration, qdd = 0,
// gravity off)
template <typename T>
RBD_FN void foot_drifts(const T* C, const Kin<T>& k, const T* v, T* out)
{
    T w0[3], v0[3], a0[3], c[3];
    mv3(k.R0, v + 3, w0);
    mv3(k.R0, v, v0);
    cross(v + 3, v, c);
    mv3(k.R0, c, a0);
    for (int leg = 0; leg < 4; ++leg) {
        T w[3], vl[3], al[3] = {T(0), T(0), T(0)}, acc[3];
        for (int i = 0; i < 3; ++i) {
            w[i] = w0[i];
            vl[i] = v0[i];
            acc[i] = a0[i];
        }
        const T* pp = k.p0;
        for (int lvl = 0; lvl < 4; ++lvl) {
            const T* pn = k.p[leg][lvl];
            T r[3], t1[3], t2[3], t3[3];
            for (int i = 0; i < 3; ++i) r[i] = pn[i] - pp[i];
            // a += al x r + w x (w x r) (at the foot this is the answer)
            cross(al, r, t1);
            cross(w, r, t2);
            cross(w, t2, t3);
            if (lvl == 3) {
                for (int i = 0; i < 3; ++i)
                    out[3 * leg + i] = acc[i] + t1[i] + t3[i];
                break;
            }
            const T* Rw = k.Rw[leg][lvl];
            const int ax = axis_of(C, lvl);
            const T qd = v[6 + 3 * leg + lvl];
            const T sq[3] = {Rw[ax] * qd, Rw[3 + ax] * qd, Rw[6 + ax] * qd};
            T ws[3];
            cross(w, sq, ws);
            for (int i = 0; i < 3; ++i) {
                acc[i] = acc[i] + t1[i] + t3[i];
                vl[i] = vl[i] + t2[i];
                al[i] = al[i] + ws[i];
                w[i] = w[i] + sq[i];
            }
            pp = pn;
        }
    }
}

// integrate the generalized velocity (local convention) over dt
template <typename T>
RBD_FN void integrate_q(const T* q, const T* v, T dt, T* out)
{
    T R0[9], d[3];
    quat_to_rot(q + 3, R0);
    mv3(R0, v, d);
    for (int i = 0; i < 3; ++i) out[i] = q[i] + d[i] * dt;
    const T w[3] = {v[3] * dt, v[4] * dt, v[5] * dt};
    const T th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
    const T th = r_sqrt(th2 + T(1e-30));
    const T half = th / T(2);
    const T sinc_half = th < T(1e-8) ? T(0.5) - th2 / T(48) : r_sin(half) / th;
    const T x2 = w[0] * sinc_half, y2 = w[1] * sinc_half,
            z2 = w[2] * sinc_half, w2 = r_cos(half);
    const T x1 = q[3], y1 = q[4], z1 = q[5], w1 = q[6];
    T quat[4] = {w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                 w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                 w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                 w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2};
    const T nrm = r_sqrt(quat[0] * quat[0] + quat[1] * quat[1]
                         + quat[2] * quat[2] + quat[3] * quat[3]);
    for (int i = 0; i < 4; ++i) out[3 + i] = quat[i] / nrm;
    for (int i = 0; i < 12; ++i) out[7 + i] = q[7 + i] + v[6 + i] * dt;
}

// In-place Cholesky A = L L' of an n x n SPD matrix (lower triangle read,
// L written over it), then x = A^-1 b solved in place in b.
template <typename T>
RBD_FN void cholesky(T* A, int n)
{
    for (int j = 0; j < n; ++j) {
        T s = A[n * j + j];
        for (int k = 0; k < j; ++k) s -= A[n * j + k] * A[n * j + k];
        const T d = r_sqrt(s);
        A[n * j + j] = d;
        for (int i = j + 1; i < n; ++i) {
            T t = A[n * i + j];
            for (int k = 0; k < j; ++k) t -= A[n * i + k] * A[n * j + k];
            A[n * i + j] = t / d;
        }
    }
}

template <typename T>
RBD_FN void cholesky_solve(const T* L, int n, T* b)
{
    for (int i = 0; i < n; ++i) {
        T t = b[i];
        for (int k = 0; k < i; ++k) t -= L[n * i + k] * b[k];
        b[i] = t / L[n * i + i];
    }
    for (int i = n - 1; i >= 0; --i) {
        T t = b[i];
        for (int k = i + 1; k < n; ++k) t -= L[n * k + i] * b[k];
        b[i] = t / L[n * i + i];
    }
}

// ---- wbc/tsid.py::_build_wbc_qp for scenario b: (H, g, A, l, u, M, h, J)
// with J = JcT' (the wrapper hands back its transposed view)
template <typename T>
RBD_FN void wbc_build_one(const T* C, const WbcArgs<T>& a, long long b)
{
    const T* q = a.row(WI_Q, b);
    const T* v = a.row(WI_V, b);
    const T* cts = a.row(WI_CONTACTS, b);
    const T* f_mpc = a.row(WI_F_MPC, b);
    const T* pos_ref = a.row(WI_POS_REF, b);
    const T* vel_ref = a.row(WI_VEL_REF, b);
    const T* acc_ref = a.row(WI_ACC_REF, b);
    const T* q_post = a.row(WI_Q_POSTURE, b);
    const T* rpy_ref = a.row(WI_RPY_REF, b);
    const T* h_ref = a.row(WI_H_REF, b);
    const T* extra = a.row(WI_EXTRA, b);
    T* H = a.out[WO_H] + b * (NX * NX);
    T* g = a.out[WO_G] + b * NX;
    T* A = a.out[WO_A] + b * (NC * NX);
    T* l = a.out[WO_L] + b * NC;
    T* u = a.out[WO_U] + b * NC;
    T* M = a.out[WO_M] + b * (NV * NV);
    T* h = a.out[WO_BIAS] + b * NV;
    T* J = a.out[WO_J] + b * (NF * NV);
    const T* P = a.par;
    const bool exact_pin = P[WP_EXACT_PIN] != T(0);
    const T inf = P[WP_INF];

    Kin<T> k;
    leg_kin(C, q, k);
    crba(C, k, extra, M);
    rnea(C, k, v, (const T*)nullptr, extra, h);
    foot_jacobians(C, k, J);
    T drift[NF], foot_vel[NF], rpy[3];
    foot_drifts(C, k, v, drift);
    for (int r = 0; r < NF; ++r) {
        T s = T(0);
        for (int j = 0; j < NV; ++j) s += J[NV * r + j] * v[j];
        foot_vel[r] = s;
    }
    rot_to_rpy(k.R0, rpy);

    // ---- cost.  Swing-foot tracking weight-masked by (1 - contact): the
    // task rows J_i qdd = a_des_i - drift_i touch the qdd block only
    T w_rows[NF], b_t[NF];
    for (int leg = 0; leg < 4; ++leg) {
        const T w_leg = P[WP_W_FOOT] * (T(1) - cts[leg]);
        for (int i = 0; i < 3; ++i) {
            const int r = 3 * leg + i;
            const T pf = k.p[leg][3][i];
            const T a_des = acc_ref[r] + P[WP_KP_FOOT] * (pos_ref[r] - pf)
                            + P[WP_KD_FOOT] * (vel_ref[r] - foot_vel[r]);
            w_rows[r] = w_leg;
            b_t[r] = a_des - drift[r];
        }
    }
    for (int i = 0; i < NX; ++i) {
        for (int j = 0; j < NX; ++j) {
            T s = T(0);
            if (i < NV && j < NV)
                for (int r = 0; r < NF; ++r)
                    s += J[NV * r + i] * (w_rows[r] * J[NV * r + j]);
            H[NX * i + j] = s;
        }
    }
    for (int i = 0; i < NV; ++i) {
        T s = T(0);
        for (int r = 0; r < NF; ++r) s += J[NV * r + i] * (w_rows[r] * b_t[r]);
        g[i] = -s;
    }
    // force tracking
    for (int i = 0; i < NF; ++i) {
        H[NX * (NV + i) + NV + i] += P[WP_W_FORCE];
        g[NV + i] = -P[WP_W_FORCE] * f_mpc[i];
    }
    // posture
    for (int i = 0; i < 12; ++i) {
        const T a_post = P[WP_KP_POSTURE] * (q_post[i] - q[7 + i])
                         - P[WP_KD_POSTURE] * v[6 + i];
        H[NX * (6 + i) + 6 + i] += P[WP_W_POSTURE];
        g[6 + i] += -P[WP_W_POSTURE] * a_post;
    }
    // base height + roll + pitch (generalized coordinates 2, 3, 4)
    const T a_base[3] = {
        P[WP_KP_BASE] * (h_ref[0] - q[2]) - P[WP_KD_BASE] * v[2],
        P[WP_KP_BASE] * (rpy_ref[0] - rpy[0]) - P[WP_KD_BASE] * v[3],
        P[WP_KP_BASE] * (rpy_ref[1] - rpy[1]) - P[WP_KD_BASE] * v[4]};
    for (int i = 0; i < 3; ++i) {
        H[NX * (2 + i) + 2 + i] += P[WP_W_BASE];
        g[2 + i] += -P[WP_W_BASE] * a_base[i];
    }
    // strict convexity + swing-force ridge
    for (int i = 0; i < NV; ++i) H[NX * i + i] += P[WP_EPS];
    for (int i = 0; i < NF; ++i) {
        const T ridge = exact_pin ? T(0) : P[WP_W_PIN] * (T(1) - cts[i / 3]);
        H[NX * (NV + i) + NV + i] += P[WP_EPS] + ridge;
    }

    // ---- constraints (50 rows): base dynamics (6), torque bounds (12),
    // friction pyramid (20), stance contacts (12).  exact_pin zeroes the
    // swing forces' columns.
    T col_f[NF];
    for (int i = 0; i < NF; ++i) col_f[i] = exact_pin ? cts[i / 3] : T(1);
    for (int r = 0; r < NV; ++r) {
        T* row = A + NX * r;
        for (int j = 0; j < NV; ++j) row[j] = M[NV * r + j];
        for (int i = 0; i < NF; ++i) {
            const T val = -J[NV * i + r];
            row[NV + i] = exact_pin ? val * col_f[i] : val;
        }
    }
    for (int r = 0; r < 6; ++r) l[r] = u[r] = -h[r];
    for (int r = 6; r < NV; ++r) {
        l[r] = -P[WP_TAU_MAX] - h[r];
        u[r] = P[WP_TAU_MAX] - h[r];
    }
    const T mu = P[WP_MU];
    const T pyr[5][3] = {{T(1), T(0), -mu}, {T(1), T(0), mu},
                         {T(0), T(1), -mu}, {T(0), T(1), mu},
                         {T(0), T(0), T(1)}};
    const T pyr_l[5] = {-inf, T(0), -inf, T(0), P[WP_FZ_MIN]};
    const T pyr_u[5] = {T(0), inf, T(0), inf, P[WP_FZ_MAX]};
    for (int leg = 0; leg < 4; ++leg) {
        const bool stance = cts[leg] > T(0.5);
        for (int s = 0; s < 5; ++s) {
            const int r = NV + 5 * leg + s;
            T* row = A + NX * r;
            for (int j = 0; j < NX; ++j) row[j] = T(0);
            for (int i = 0; i < 3; ++i) {
                const T val = pyr[s][i];
                const int c = 3 * leg + i;
                row[NV + c] = exact_pin ? val * col_f[c] : val;
            }
            l[r] = stance ? pyr_l[s] : -inf;
            u[r] = stance ? pyr_u[s] : inf;
        }
    }
    for (int i = 0; i < NF; ++i) {
        const int r = NV + 20 + i;
        const T c = cts[i / 3];
        T* row = A + NX * r;
        for (int j = 0; j < NV; ++j) row[j] = J[NV * i + j] * c;
        for (int j = 0; j < NF; ++j) row[NV + j] = T(0);
        const T b_con = -drift[i] - P[WP_KD_CONTACT] * foot_vel[i];
        l[r] = c > T(0.5) ? b_con : -inf;
        u[r] = c > T(0.5) ? b_con : inf;
    }
}

// ---- one substep of env/plant.py: implicit-damping contact integration,
// cone clamp with anchor drag, explicit re-solve where clamped.  The two
// 18 x 18 SPD solves go by Cholesky (the plain version forms inverses).
template <typename T>
RBD_FN void plant_substep(const T* C, T* q, T* v, T* anchor, T* in_c,
                          const T* tau, const T* cp, const T* extra, T h_dt,
                          T* f_cl)
{
    const T kp_n = cp[0], kd_n = cp[1], kp_t = cp[2], kd_t = cp[3],
            mu = cp[4];
    Kin<T> k;
    leg_kin(C, q, k);
    T M[NV * NV], Me[NV * NV], J[NF * NV], bias[NV];
    crba(C, k, extra, M);
    rnea(C, k, v, (const T*)nullptr, extra, bias);
    foot_jacobians(C, k, J);

    T f_el[NF], inc[4];
    const T d_vec[3] = {kd_t, kd_t, kd_n};
    for (int leg = 0; leg < 4; ++leg) {
        const T* pf = k.p[leg][3];
        const bool below = pf[2] < T(0);
        if (below && in_c[leg] < T(0.5)) {
            anchor[2 * leg] = pf[0];
            anchor[2 * leg + 1] = pf[1];
        }
        inc[leg] = below ? T(1) : T(0);
        f_el[3 * leg] = -kp_t * (pf[0] - anchor[2 * leg]) * inc[leg];
        f_el[3 * leg + 1] = -kp_t * (pf[1] - anchor[2 * leg + 1]) * inc[leg];
        f_el[3 * leg + 2] = -kp_n * pf[2] * inc[leg];
    }
    // M_eff = M + h sum_active J' D J; rhs = M v + h (tau_gen - bias + J' f)
    T Mv[NV], rhs[NV], base[NV];
    for (int i = 0; i < NV; ++i) {
        T s = T(0);
        for (int j = 0; j < NV; ++j) s += M[NV * i + j] * v[j];
        Mv[i] = s;
    }
    for (int i = 0; i < NV; ++i) {
        for (int j = 0; j <= i; ++j) {
            T s = T(0);
            for (int r = 0; r < NF; ++r)
                s += J[NV * r + i]
                     * (J[NV * r + j] * (d_vec[r % 3] * inc[r / 3]));
            Me[NV * i + j] = M[NV * i + j] + h_dt * s;
        }
        base[i] = (i < 6 ? T(0) : tau[i - 6]) - bias[i];
    }
    for (int i = 0; i < NV; ++i) {
        T s = T(0);
        for (int r = 0; r < NF; ++r) s += f_el[r] * J[NV * r + i];
        rhs[i] = Mv[i] + h_dt * (base[i] + s);
    }
    cholesky(Me, NV);
    cholesky_solve(Me, NV, rhs);            // rhs is now v_imp

    // contact forces at the implicit velocity, then the cone clamp
    bool any_cl = false;
    for (int leg = 0; leg < 4; ++leg) {
        T fv[3];
        for (int i = 0; i < 3; ++i) {
            T s = T(0);
            for (int j = 0; j < NV; ++j)
                s += J[NV * (3 * leg + i) + j] * rhs[j];
            fv[i] = s;
        }
        T f_raw[3];
        for (int i = 0; i < 3; ++i)
            f_raw[i] = f_el[3 * leg + i] - d_vec[i] * fv[i] * inc[leg];
        const T fz = f_raw[2] > T(0) ? f_raw[2] : T(0);
        const T limit = mu * fz;
        const T ft_norm = r_sqrt(f_raw[0] * f_raw[0] + f_raw[1] * f_raw[1]);
        const bool over = ft_norm > limit;
        const T safe = ft_norm > T(1e-12) ? ft_norm : T(1e-12);
        const T scale = over ? limit / safe : T(1);
        const T ftx = f_raw[0] * scale, fty = f_raw[1] * scale;
        const bool active = inc[leg] > T(0.5);
        if (over && active) {
            anchor[2 * leg] = k.p[leg][3][0] + (ftx + kd_t * fv[0]) / kp_t;
            anchor[2 * leg + 1] = k.p[leg][3][1] + (fty + kd_t * fv[1]) / kp_t;
        }
        if ((over || f_raw[2] < T(0)) && active) any_cl = true;
        f_cl[3 * leg] = ftx * inc[leg];
        f_cl[3 * leg + 1] = fty * inc[leg];
        f_cl[3 * leg + 2] = fz * inc[leg];
    }
    // explicit recomputation with the clamped (bounded) forces
    if (any_cl) {
        for (int i = 0; i < NV; ++i) {
            T s = T(0);
            for (int r = 0; r < NF; ++r) s += f_cl[r] * J[NV * r + i];
            rhs[i] = Mv[i] + h_dt * (base[i] + s);
        }
        cholesky(M, NV);
        cholesky_solve(M, NV, rhs);
    }
    integrate_q(q, rhs, h_dt, Me);          // Me: scratch for the new q
    for (int i = 0; i < NQ; ++i) q[i] = Me[i];
    for (int i = 0; i < NV; ++i) v[i] = rhs[i];
    for (int leg = 0; leg < 4; ++leg) in_c[leg] = inc[leg];
}

// ---- env/plant.py::plant_step for scenario b: `substeps` substeps of
// h_dt; writes the new (q, v, anchor, in_contact) and the last substep's
// ground forces
template <typename T>
RBD_FN void plant_step_one(const T* C, const PlantArgs<T>& a, long long b)
{
    T q[NQ], v[NV], anchor[8], in_c[4], tau[12], cp[5], f[NF];
    const T* src = a.row(PI_Q, b);
    for (int i = 0; i < NQ; ++i) q[i] = src[i];
    src = a.row(PI_V, b);
    for (int i = 0; i < NV; ++i) v[i] = src[i];
    src = a.row(PI_ANCHOR, b);
    for (int i = 0; i < 8; ++i) anchor[i] = src[i];
    src = a.row(PI_IN_CONTACT, b);
    for (int i = 0; i < 4; ++i) in_c[i] = src[i];
    src = a.row(PI_TAU, b);
    for (int i = 0; i < 12; ++i) tau[i] = src[i];
    for (int i = 0; i < 5; ++i) cp[i] = a.row(PI_KP_N + i, b)[0];
    for (int i = 0; i < NF; ++i) f[i] = T(0);
    const T* extra = a.row(PI_EXTRA, b);
    const int substeps = (int)a.par[PP_SUBSTEPS];
    for (int s = 0; s < substeps; ++s)
        plant_substep(C, q, v, anchor, in_c, tau, cp, extra, a.par[PP_H_DT],
                      f);
    T* out = a.out[PO_Q] + b * NQ;
    for (int i = 0; i < NQ; ++i) out[i] = q[i];
    out = a.out[PO_V] + b * NV;
    for (int i = 0; i < NV; ++i) out[i] = v[i];
    out = a.out[PO_ANCHOR] + b * 8;
    for (int i = 0; i < 8; ++i) out[i] = anchor[i];
    out = a.out[PO_IN_CONTACT] + b * 4;
    for (int i = 0; i < 4; ++i) out[i] = in_c[i];
    out = a.out[PO_F] + b * NF;
    for (int i = 0; i < NF; ++i) out[i] = f[i];
}
"""


def thread_design_subs(name):
    """(kernel subs, header subs) of PR 11's design of `name`: the launch
    goes to a thread-per-scenario kernel over rbd::pr11's body."""
    one, args = {"wbc_build": ("wbc_build_one", "WbcArgs"),
                 "plant_step": ("plant_step_one", "PlantArgs")}[name]
    kernel = (f"template <typename T>\n__global__ void __launch_bounds__(32)"
              f"\n{name}_thread_kernel(const T* __restrict__ consts, "
              f"const rbd::{args}<T> args, int B)\n{{\n"
              "    const long long b = (long long)blockIdx.x * blockDim.x "
              "+ threadIdx.x;\n    if (b >= B) return;\n"
              f"    rbd::pr11::{one}<T>(consts, args, b);\n}}\n\n")
    subs = [("int last_layout[3];", kernel + "int last_layout[3];"),
            (f"    {name}_kernel<T><<<blocks, g * rbd::WARP, smem, stream>>>"
             "(\n        static_cast<const T*>(consts), a, B, slot);",
             f"    {name}_thread_kernel<T><<<(B + 31) / 32, 32, 0, stream>>>"
             "(\n        static_cast<const T*>(consts), a, B);")]
    header = [("}  // namespace rbd\n",
               "namespace pr11 {\n" + THREAD_DESIGN
               + "\n}  // namespace pr11\n\n}  // namespace rbd\n")]
    return subs, {"rbd.h": header}


# The phases of the shipped kernels, in the order their marks come: the
# frame's nine (both kernels), then each kernel's own.  A patched copy
# reads the cycle counter at every phase boundary of each warp (lane 0's
# view) and writes the sums over the outputs (WBC: H's first entries; plant:
# q's, then anchor's).  Store phases read the issue of the stores, not their
# completion.
FRAME_PHASES = ["kinematics",
                "transforms F, base inertia, rnea forward, Jacobian rows",
                "crba X' Ic X (lower leg), rnea's body wrenches",
                "crba X' Ic X (upper leg), rnea's backward pass",
                "crba X' Ic X (hip), joint forces, h's base rows",
                "M's entries"]
RBD_PHASES = {
    "wbc_build": ["load"] + FRAME_PHASES + [
        "drifts, J v, roll-pitch-yaw", "J'WJ entries, task rows",
        "stores: H, g", "stores: A, l, u", "stores: M, h, J"],
    "plant_step": ["load"] + FRAME_PHASES + [
        "contact law, M v", "M + h J'DJ, rhs",
        "arrow: legs' factors, V_L, y_L", "arrow: Schur complement, base rhs",
        "arrow: base factor and solves", "arrow: legs' back solves",
        "clamp", "re-solve rhs", "integrate", "stores"]}
# category of each `ex.sync();` of rbd.h in source order: frame_phases,
# wbc_build_warp, arrow_solve, plant_substep_warp, plant_step_warp
RBD_SYNC_MARKS = (list(range(1, 7)) + [0, 7, 8] + [9, 10, 11, 12]
                  + [7, 8, 13, 14, 15] + [0])
RBD_CLOCK_EXEC = (
    "    __device__ void sync() const { __syncwarp(); }\n};",
    "    __device__ void sync() const { __syncwarp(); }\n"
    "    long long* acc;\n    long long* last;\n"
    "    __device__ void mark(int k) const\n    {\n        __syncwarp();\n"
    "        const long long t = clock64();\n        acc[k] += t - *last;\n"
    "        *last = t;\n    }\n};")


def rbd_clock_header(src):
    """rbd.h with every phase boundary a mark (RBD_SYNC_MARKS) and the
    build's three store units a phase each."""
    parts = src.split("ex.sync();")
    if len(parts) - 1 != len(RBD_SYNC_MARKS):
        raise RuntimeError(f"rbd.h has {len(parts) - 1} phase boundaries, "
                           f"the clock patch knows {len(RBD_SYNC_MARKS)}")
    out = parts[0]
    for k, part in zip(RBD_SYNC_MARKS, parts[1:]):
        out += f"ex.mark({k});" + part
    for old, new in [RBD_CLOCK_EXEC, (
            "    RBD_EACH_LANE(ex, lane) {\n"
            "        wbc_cost_store_unit(lane, a, b, S);\n"
            "        wbc_constraint_store_unit(lane, a, b, S);\n"
            "        wbc_frame_store_unit(lane, a, b, S);\n    }\n",
            "    RBD_EACH_LANE(ex, lane) wbc_cost_store_unit(lane, a, b, S);\n"
            "    ex.mark(9);\n"
            "    RBD_EACH_LANE(ex, lane) wbc_constraint_store_unit(lane, a, "
            "b, S);\n    ex.mark(10);\n"
            "    RBD_EACH_LANE(ex, lane) wbc_frame_store_unit(lane, a, b, S);"
            "\n    ex.mark(11);\n")]:
        if old not in out:
            raise RuntimeError(f"clock patch: pattern not in rbd.h: {old!r}")
        out = out.replace(old, new)
    return out


def rbd_clock_subs(name):
    slot = {"wbc_build": "WbcSlot", "plant_step": "PlantSlot"}[name]
    n = len(RBD_PHASES[name])
    write = ("args.out[rbd::WO_H][b * 900 + k_] = (T)acc_[k_];"
             if name == "wbc_build" else
             "(k_ < 19 ? args.out[rbd::PO_Q][b * 19 + k_]\n"
             "                     : args.out[rbd::PO_ANCHOR][b * 8 + k_"
             " - 19]) = (T)acc_[k_];")
    end = ("" if name == "wbc_build" else "    ex.mark(16);\n")
    return [("    rbd::WarpExec ex;",
             "    long long acc_[24] = {}, last_ = clock64();\n"
             "    rbd::WarpExec ex{acc_, &last_};"),
            (f"        *reinterpret_cast<rbd::{slot}<T>*>(smem + (size_t)warp"
             " * slot));\n}",
             f"        *reinterpret_cast<rbd::{slot}<T>*>(smem + (size_t)warp"
             f" * slot));\n{end}    if ((threadIdx.x & 31) == 0)\n"
             f"        for (int k_ = 0; k_ < {n}; ++k_)\n            {write}"
             "\n}")]


def rbd_lib_launcher(lib, name):
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = rbd_kernels.LAUNCH_ARGTYPES + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lambda *a: fn(*a, torch.cuda.current_stream().cuda_stream)


def prepacked(run, fn):
    """`run(fn)` once; then a callable that repeats that very launch (the
    same operands, outputs written again): the kernel's time without the
    wrapper's packing and allocation on the host."""
    held = []

    def grab(*a):
        held.append(a)
        return fn(*a)

    keep = run(grab)
    return lambda: (keep, fn(*held[0]))[1]


def probe_rbd(record, kinds, B, device, build, rounds=6):
    """The WBC build and the plant step (float32, the main path's inputs,
    no payload) at B = 1 and B: the shipped warp-per-scenario kernels
    against PR 11's thread-per-scenario design (patched copy) in
    interleaved rounds, and against copies with 4 or 16 warps a block at B
    (each launch repeated on operands packed once: the kernels' own time,
    not the wrapper's packing); each design's largest error against the
    plain version; the cycles of each phase (patched copy, lane 0 of every
    warp)."""
    from chip_smoke import plant_step_inputs, wbc_build_inputs

    cfg = EngineConfig()
    tree = CascadeConfigured(SOLO12, cfg).tree
    specs = {}
    for name in kinds:
        subs, hdr = thread_design_subs(name)
        common = dict(source=f"{name}.cu", csrc=rbd_kernels.CSRC)
        specs[f"{name} PR 11"] = dict(subs=subs, header_subs=hdr, **common)
        specs[f"{name} clocks"] = dict(subs=rbd_clock_subs(name),
                                       header_subs={"rbd.h": rbd_clock_header},
                                       **common)
        for g in (4, 16):
            specs[f"{name} {g} warps"] = dict(subs=[], header_subs={"rbd.h": [
                ("constexpr int MAX_WARPS = 8;",
                 f"constexpr int MAX_WARPS = {g};")]}, **common)
    t0 = time.time()
    libs = build_variants(specs, build)
    record("rbd", what="patched copies built", seconds=time.time() - t0,
           copies=sorted(specs))
    t = lambda a: torch.tensor(a, device=device)  # noqa: E731
    w_in = wbc_build_inputs(B, 60)
    p_in = plant_step_inputs(B, 61, device)[0]
    for name in kinds:
        fns = {"shipped (a warp per scenario)": rbd_lib_launcher(
                   rbd_kernels._library(name), name),
               "PR 11 (a thread per scenario)": rbd_lib_launcher(
                   libs[f"{name} PR 11"], name)}
        for g in (4, 16):
            fns[f"{g} warps a block"] = rbd_lib_launcher(
                libs[f"{name} {g} warps"], name)
        clock = rbd_lib_launcher(libs[f"{name} clocks"], name)
        for Bs in (1, B):
            if name == "wbc_build":
                q, v = t(w_in[0][:Bs]), t(w_in[1][:Bs])
                refs = WbcRefs(**{k: t(a[:Bs]) for k, a in w_in[2].items()})
                run = lambda fn: tsid.run_wbc_build(  # noqa: E731
                    fn, tree, cfg.wbc, q, v, refs)[1]
                want = tsid.build_wbc_qp_reference(tree, cfg.wbc, q, v, refs)
                flat = lambda o: list(o)  # noqa: E731
            else:
                st = PlantState(**{k: t(p_in[k][:Bs]) for k in
                                   ("q", "v", "anchor", "in_contact")})
                cp = ContactParams(**{k: t(p_in[k][:Bs]) for k in
                                      ("kp_n", "kd_n", "kp_t", "kd_t", "mu")})
                tau = t(p_in["tau"][:Bs])
                run = lambda fn: plant.run_plant_step(  # noqa: E731
                    fn, tree, st, tau, 0.001, 2, cp)[1]
                want = plant.plant_step_reference(tree, st, tau, 0.001, 2,
                                                  cp)
                flat = lambda o: [o[0].q, o[0].v, o[0].anchor,  # noqa: E731
                                  o[0].in_contact, o[1]]
            errs = {}
            for k, fn in fns.items():
                got = run(fn)
                torch.cuda.synchronize()
                errs[k] = max(float(((g - w).abs().clamp_max(1e19).max()
                                     / w.abs().clamp_max(1e19).max()
                                     .clamp_min(1e-30)))
                              for g, w in zip(flat(got), flat(want)))
            record("rbd", kernel=name, B=Bs, what="largest error relative "
                   "to the plain version's largest entry, per output",
                   errs=errs, layout=str(rbd_kernels.last_layout(name)))
            timed = {k: prepacked(run, fn) for k, fn in fns.items()
                     if Bs == B or "warps a block" not in k}
            interleaved(record, "rbd", timed, rounds, reps=20, kernel=name,
                        B=Bs)
            out = flat(run(clock))
            torch.cuda.synchronize()
            if name == "wbc_build":
                cyc = out[0].reshape(Bs, -1)[:, :len(RBD_PHASES[name])]
            else:
                cyc = torch.cat([out[0], out[2].reshape(Bs, -1)], dim=1)[
                    :, :len(RBD_PHASES[name])]
            cyc = cyc.double()
            total = cyc.sum(dim=1, keepdim=True)
            for k, phase in enumerate(RBD_PHASES[name]):
                record("rbd", kernel=name, B=Bs, what="share of a warp's "
                       "cycles", phase=phase,
                       share=round(float((cyc[:, k:k + 1] / total).mean()),
                                   4), mean_cycles=float(cyc[:, k].mean()))


# The first design of the Ruiz kernel (a block per scenario, G = 4 row groups
# of a thread a column, all of P in shared memory where it fits), its ruiz.h
# and ruiz.cu as they were, less their head comments: the patched copy the
# shipped kernel is timed and held bit for bit against
FIRST_RUIZ_H = r"""#pragma once

#include <math.h>
#include <string.h>

#if defined(__CUDACC__)
#define RUIZ_FN __host__ __device__ __forceinline__
#else
#define RUIZ_FN inline
#endif

namespace ruiz {

constexpr int WARP = 32;
constexpr int GROUPS = 4;           // row groups: threads G x W
constexpr int MAX_WIDTH = 256;      // W: threads of a group (columns)
constexpr float INF = 1e20f;        // qp/admm.py's finite infinity
constexpr int SCRATCH = 40;         // warp sums (32), c, max |q| D, spare
constexpr int CHUNK = 8;            // rows of A loaded ahead

// threads of a row group: one a column, a multiple of 32, at most 256
RUIZ_FN int width(int n)
{
    const int w = (n + WARP - 1) / WARP * WARP;
    return w < MAX_WIDTH ? w : MAX_WIDTH;
}

RUIZ_FN int threads(int n) { return GROUPS * width(n); }

// `slots`: nonzeros of A kept per (row group, column), 0 for none
RUIZ_FN long long smem_floats(int n, int m, bool p_in_smem, int slots)
{
    return (p_in_smem ? (long long)n * n : 0) + n + m + 2LL * GROUPS * n
           + m + n + SCRATCH
           + (slots > 0 ? (long long)GROUPS * n * (1 + 2 * slots) : 0);
}

enum In { I_P, I_Q, I_A, I_L, I_U, I_COUNT };
enum Out { O_P, O_Q, O_A, O_L, O_U, O_D, O_E, O_C, O_COUNT };

struct Args {
    const float* in[I_COUNT];
    long long stride[I_COUNT];     // elements between two scenarios
    float* out[O_COUNT];           // contiguous, B rows each
    int n, m, iters;
    int p_in_smem;
    int slots;                     // nonzeros of A kept per (group, column)
};

// --------------------------------------------------------------- arithmetic

RUIZ_FN unsigned bits(float v)
{
#if defined(__CUDA_ARCH__)
    return __float_as_uint(v);
#else
    unsigned u;
    memcpy(&u, &v, sizeof(u));
    return u;
#endif
}

// maximum of two non-negative floats (or NaN) by their bit patterns
RUIZ_FN float mx(float a, float b) { return bits(a) >= bits(b) ? a : b; }

RUIZ_FN float rsqrt_of(float v)
{
#if defined(__CUDA_ARCH__)
    return rsqrtf(v);
#else
    return 1.0f / sqrtf(v);
#endif
}

// torch.where(v < 1e-10, 1, torch.rsqrt(torch.clamp_min(v, 1e-12)))
RUIZ_FN float scale_of(float v)
{
    return v < 1e-10f ? 1.0f : rsqrt_of(v < 1e-12f ? 1e-12f : v);
}

// --------------------------------------------------------------- host twin

#if !defined(__CUDA_ARCH__)
// Runs the units one after the other; the executor-owned steps on plain
// loops with the card's arithmetic.
struct HostExec {
    int block = 0;      // the kernel's threads (block_sum's layout)

    template <class F>
    void units(int count, F f)
    {
        for (int u = 0; u < count; ++u) f(u);
    }
    int threads() const { return block; }
    void sync() {}
    // lane `jc` of a warp offers v for row i: the warp's max reaches *dst
    void row_max(float* dst, float v, int /*jc*/) { *dst = mx(*dst, v); }
    // one unit's v into *dst
    void atomic_max(float* dst, float v) { *dst = mx(*dst, v); }
    // the card's tree: thread t sums v[t], v[t + T], ... in order; lanes
    // of each warp pairwise at offsets 16, 8, 4, 2, 1; the warps' sums in
    // order
    float block_sum(const float* v, int n, float* /*scratch*/)
    {
        const int T = block;
        float total = 0.0f;
        for (int w = 0; w < T / WARP; ++w) {
            float lane[WARP];
            for (int l = 0; l < WARP; ++l) {
                float s = 0.0f;
                for (int j = w * WARP + l; j < n; j += T) s = s + v[j];
                lane[l] = s;
            }
            for (int off = WARP / 2; off > 0; off /= 2)
                for (int l = 0; l < off; ++l)
                    lane[l] = lane[l] + lane[l + off];
            total = total + lane[0];
        }
        return total;
    }
};
#endif

// ------------------------------------------------------------------- body

// dst[k] = f(k, src[k]) for k in [0, total): thread t takes k = k0 + c T
// + t, c < CHUNK (consecutive threads on consecutive addresses), its CHUNK
// loads issued before any of its stores (a store may alias a later load
// for all the compiler knows, and would hold each load back).
template <class Ex, class F>
RUIZ_FN void streamed(Ex& ex, const float* src, float* dst, long long total,
                      F f)
{
    const int T = ex.threads();
    ex.units(T, [&](int t) {
        for (long long k0 = 0; k0 < total; k0 += (long long)T * CHUNK) {
            float v[CHUNK];
            for (int c = 0; c < CHUNK; ++c) {
                const long long k = k0 + (long long)c * T + t;
                v[c] = k < total ? src[k] : 0.0f;
            }
            for (int c = 0; c < CHUNK; ++c) {
                const long long k = k0 + (long long)c * T + t;
                if (k < total) dst[k] = f(k, v[c]);
            }
        }
    });
}

// Scenario b of `a`, its shared memory `s` (smem_floats).  Unit layout of
// the column passes: unit u = g W + jc is row group g (rows i = g, g + G,
// ...) on columns j = j0 + jc, j0 = 0, W, 2 W, ...: a warp's lanes share g
// and take consecutive columns, so that a row of P or A is read in
// consecutive addresses and a row's maximum is one warp reduction.
//
// Sparse A.  A zero entry adds nothing to a maximum of non-negative values,
// so the first round's pass over A also keeps each unit's nonzeros (row and
// |A_ij|, NaN included) in `slots` places per (group, column); where every
// unit's fit (the MPC's pyramid rows: at most 2 a group and column), the
// later rounds read those lists instead of A, with one shared atomic
// maximum per entry, and give the same bits.  Where one does not (a dense
// A), every round reads A.
template <class Ex>
RUIZ_FN void equilibrate(Ex& ex, const Args& a, long long b, float* s)
{
    const int n = a.n, m = a.m, W = width(n);
    const float* Pg = a.in[I_P] + b * a.stride[I_P];
    const float* q = a.in[I_Q] + b * a.stride[I_Q];
    const float* A = a.in[I_A] + b * a.stride[I_A];
    float* Ps = s;
    float* D = Ps + (a.p_in_smem ? (long long)n * n : 0);
    float* E = D + n;
    float* part_p = E + m;                 // [G][n] column maxima over P
    float* part_a = part_p + GROUPS * n;   // [G][n] column maxima over A
    float* war = part_a + GROUPS * n;      // [m] row maxima over A
    float* pcol = war + m;                 // [n]
    float* red = pcol + n;                 // scratch; c, max |q| D at 32, 33,
                                           // 1 at 34 while A is read whole
    float* nz_cnt = red + SCRATCH;         // [G][n] nonzeros kept
    float* nz_row = nz_cnt + GROUPS * n;   // [G][n][slots] their rows
    float* nz_val = nz_row + GROUPS * n * a.slots;   // and |A_ij|
    const float* P = a.p_in_smem ? Ps : Pg;
    const int S = a.slots;

    streamed(ex, Pg, Ps, a.p_in_smem ? (long long)n * n : 0,
             [](long long, float v) { return v; });
    ex.units(n, [&](int j) { D[j] = 1.0f; });
    ex.units(m, [&](int i) { E[i] = 1.0f; war[i] = 0.0f; });
    ex.units(1, [&](int) {
        red[32] = 1.0f;
        red[34] = S > 0 ? 0.0f : 1.0f;
    });
    ex.sync();

    for (int it = 0; it < a.iters; ++it) {
        const bool whole = it == 0 || red[34] != 0.0f;
        const bool keep = it == 0 && S > 0;
        // max_i D_i |P_ij|, max_i E_i |A_ij| by row group; max_j |A_ij| D_j
        ex.units(GROUPS * W, [&](int u) {
            const int g = u / W, jc = u % W;
            for (int j0 = 0; j0 < n; j0 += W) {
                const int j = j0 + jc;
                const bool live = j < n;
                float wp = 0.0f, wa = 0.0f;
                const float Dj = live ? D[j] : 0.0f;
                const int gj = g * n + j;
                // after the first round, the last round's cost scaling took
                // these maxima with the same D
                if (live && it > 0) wp = part_p[gj];
                if (live && it == 0)
                    for (int i = g; i < n; i += GROUPS)
                        wp = mx(wp, fabsf(P[(long long)i * n + j]) * D[i]);
                if (!whole) {
                    // the nonzeros kept in the first round
                    if (live)
                        for (int k = 0; k < (int)nz_cnt[gj]; ++k) {
                            const int i = (int)nz_row[gj * S + k];
                            const float v = nz_val[gj * S + k];
                            wa = mx(wa, v * E[i]);
                            ex.atomic_max(war + i, v * Dj);
                        }
                } else {
                    int kept = 0;
                    // CHUNK rows' loads issued before their maxima: the
                    // shared atomics of row_max would otherwise hold each
                    // load back
                    for (int i0 = g; i0 < m; i0 += GROUPS * CHUNK) {
                        float av[CHUNK];
                        for (int c = 0; c < CHUNK; ++c) {
                            const int i = i0 + c * GROUPS;
                            av[c] = live && i < m
                                        ? fabsf(A[(long long)i * n + j])
                                        : 0.0f;
                        }
                        for (int c = 0; c < CHUNK; ++c) {
                            const int i = i0 + c * GROUPS;
                            if (i < m) {
                                wa = mx(wa, av[c] * E[i]);
                                ex.row_max(war + i, av[c] * Dj, jc);
                                if (keep && live && av[c] != 0.0f) {
                                    if (kept < S) {
                                        nz_row[gj * S + kept] = (float)i;
                                        nz_val[gj * S + kept] = av[c];
                                    }
                                    ++kept;
                                }
                            }
                        }
                    }
                    if (keep && live) {
                        nz_cnt[gj] = (float)kept;
                        if (kept > S) red[34] = 1.0f;
                    }
                }
                if (live) {
                    part_p[g * n + j] = wp;
                    part_a[g * n + j] = wa;
                }
            }
        });
        ex.sync();
        // the scales: D from the columns, E from the rows (with the c of
        // this round's start)
        const float c = red[32];
        ex.units(n > m ? n : m, [&](int k) {
            if (k < n) {
                float wp = part_p[k], wa = part_a[k];
                for (int g = 1; g < GROUPS; ++g) {
                    wp = mx(wp, part_p[g * n + k]);
                    wa = mx(wa, part_a[g * n + k]);
                }
                const float cn = mx(c * D[k] * wp, D[k] * wa);
                D[k] = D[k] * scale_of(cn);
            }
            if (k < m) {
                E[k] = E[k] * scale_of(E[k] * war[k]);
                war[k] = 0.0f;
            }
            if (k == 0) red[33] = 0.0f;
        });
        ex.sync();
        // cost scaling against the new D: max_i D_i |P_ij| again
        ex.units(GROUPS * W, [&](int u) {
            const int g = u / W, jc = u % W;
            for (int j = jc; j < n; j += W) {
                float wp = 0.0f;
                for (int i = g; i < n; i += GROUPS)
                    wp = mx(wp, fabsf(P[(long long)i * n + j]) * D[i]);
                part_p[g * n + j] = wp;
            }
        });
        ex.sync();
        // the column norms; max_j |q_j| D_j into red[33] (whole warps: W
        // threads)
        ex.units(W, [&](int jc) {
            float qm = 0.0f;
            for (int j = jc; j < n; j += W) {
                float wp = part_p[j];
                for (int g = 1; g < GROUPS; ++g)
                    wp = mx(wp, part_p[g * n + j]);
                pcol[j] = c * D[j] * wp;
                qm = mx(qm, fabsf(q[j]) * D[j]);
            }
            ex.row_max(red + 33, qm, jc);
        });
        ex.sync();
        const float sum = ex.block_sum(pcol, n, red);
        ex.units(1, [&](int) {
            const float qmax = red[33];
            const float mean = sum * (1.0f / (float)n);
            const float v = mx(mean, c * qmax);
            const float gamma = 1.0f / (v < 1e-12f ? 1e-12f : v);
            red[32] = c * gamma;
        });
        ex.sync();
    }

    // the scaled problem: Pb = (c D_i) P_ij D_j, qb = c D q, Ab = E_i A_ij
    // D_j, the bounds E l, E u unless infinite
    const float c = red[32];
    float* Pb = a.out[O_P] + b * (long long)n * n;
    float* Ab = a.out[O_A] + b * (long long)m * n;
    streamed(ex, P, Pb, (long long)n * n, [&](long long k, float v) {
        return c * D[k / n] * v * D[k % n];
    });
    streamed(ex, A, Ab, (long long)m * n, [&](long long k, float v) {
        return E[k / n] * v * D[k % n];
    });
    ex.units(n, [&](int j) {
        a.out[O_Q][b * n + j] = c * D[j] * q[j];
        a.out[O_D][b * n + j] = D[j];
    });
    const float* l = a.in[I_L] + b * a.stride[I_L];
    const float* u = a.in[I_U] + b * a.stride[I_U];
    ex.units(m, [&](int i) {
        a.out[O_L][b * m + i] = l[i] <= -INF ? l[i] : E[i] * l[i];
        a.out[O_U][b * m + i] = u[i] >= INF ? u[i] : E[i] * u[i];
        a.out[O_E][b * m + i] = E[i];
    });
    ex.units(1, [&](int) { a.out[O_C][b] = c; });
}

}  // namespace ruiz
"""

FIRST_RUIZ_CU = r"""#include <cuda_runtime.h>

#include "ruiz.h"

namespace {

struct DevExec {
    template <class F>
    __device__ void units(int count, F f)
    {
        for (int u = threadIdx.x; u < count; u += blockDim.x) f(u);
    }
    __device__ int threads() const { return blockDim.x; }
    __device__ void sync() { __syncthreads(); }
    // every lane of a warp calls it for the same row
    __device__ void row_max(float* dst, float v, int jc)
    {
        const unsigned r = __reduce_max_sync(0xffffffffu, __float_as_uint(v));
        if ((jc & (ruiz::WARP - 1)) == 0)
            atomicMax(reinterpret_cast<unsigned*>(dst), r);
    }
    __device__ void atomic_max(float* dst, float v)
    {
        atomicMax(reinterpret_cast<unsigned*>(dst), __float_as_uint(v));
    }
    // the tree of ruiz::HostExec::block_sum; the total in thread 0
    __device__ float block_sum(const float* v, int n, float* scratch)
    {
        const int t = threadIdx.x, T = blockDim.x;
        float s = 0.0f;
        for (int j = t; j < n; j += T) s = s + v[j];
        for (int off = ruiz::WARP / 2; off > 0; off /= 2)
            s = s + __shfl_down_sync(0xffffffffu, s, off);
        if ((t & (ruiz::WARP - 1)) == 0) scratch[t / ruiz::WARP] = s;
        __syncthreads();
        float total = 0.0f;
        if (t == 0)
            for (int w = 0; w < T / ruiz::WARP; ++w)
                total = total + scratch[w];
        return total;
    }
};

__global__ void __launch_bounds__(ruiz::GROUPS * ruiz::MAX_WIDTH)
ruiz_kernel(const ruiz::Args a)
{
    extern __shared__ __align__(16) float smem[];
    DevExec ex;
    ruiz::equilibrate(ex, a, blockIdx.x, smem);
}

}  // namespace

extern "C" {

long long ruiz_smem_floats(int n, int m, int p_in_smem, int slots)
{
    return ruiz::smem_floats(n, m, p_in_smem != 0, slots);
}

int ruiz_threads(int n) { return ruiz::threads(n); }

int ruiz_launch(const void* const* in, const long long* stride,
                void* const* out, int B, int n, int m, int iters,
                int p_in_smem, int slots, void* stream)
{
    if (B < 1 || n < 1 || m < 1 || iters < 0 || slots < 0)
        return (int)cudaErrorInvalidValue;
    ruiz::Args a;
    for (int k = 0; k < ruiz::I_COUNT; ++k) {
        if (in[k] == nullptr) return (int)cudaErrorInvalidValue;
        a.in[k] = static_cast<const float*>(in[k]);
        a.stride[k] = stride[k];
    }
    for (int k = 0; k < ruiz::O_COUNT; ++k) {
        if (out[k] == nullptr) return (int)cudaErrorInvalidValue;
        a.out[k] = static_cast<float*>(out[k]);
    }
    a.n = n;
    a.m = m;
    a.iters = iters;
    a.p_in_smem = p_in_smem;
    a.slots = slots;
    const long long bytes =
        4 * ruiz::smem_floats(n, m, p_in_smem != 0, slots);
    int dev, optin;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    if (bytes > optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(ruiz_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    ruiz_kernel<<<B, ruiz::threads(n), (size_t)bytes,
                  (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

const char* ruiz_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
"""


def first_layout(n, m, smem):
    """(p_in_smem, slots) of the first design's layout: P in shared memory
    where its n^2 floats fit beside the rest, then 4 nonzeros of A kept per
    group and column where they fit too."""
    def floats(p, slots):
        return ((n * n if p else 0) + 4 * n + 2 * m + 8 * n + 40
                + (4 * n * (1 + 2 * slots) if slots else 0))
    p = 4 * floats(True, 0) <= smem
    return p, (4 if 4 * floats(p, 4) <= smem else 0)


# the shipped kernel with the cycle counter read at its stage boundaries
# (times only; the counts overwrite qb's first entries of each scenario).
# The cluster path's rank 0, summed over the rounds (a mark after every
# block barrier and around every exchange wait): the pass over A or its
# lists (and the first round's over P), D's update, the sends, the first
# wait, E and the cost pass over P, the norms, their sends, the second wait,
# the sum and c; then the load and the stores.  The warp path: the load, each
# of a round's five phases summed over the rounds, the stores.
RUIZ_CLOCK_SUBS = [
    ("    bool bulk_in;\n",
     "    bool bulk_in;\n    long long seg[11], last, t0, t_end;\n"
     "    int phase, syncs;\n"
     "    __device__ void mark(int k)\n    {\n"
     "        const long long now = clock64();\n"
     "        seg[k] += now - last;\n        last = now;\n    }\n"),
    ("    __device__ void sync() { __syncthreads(); }\n",
     "    __device__ void sync()\n    {\n        __syncthreads();\n"
     "        mark(phase);\n        ++phase;\n    }\n"),
    ("        if (threadIdx.x == 0) barrier_expect(bars + bar, bytes);\n"
     "        barrier_wait(bars + bar, (unsigned)(it & 1));\n",
     "        mark(phase);\n"
     "        if (threadIdx.x == 0) barrier_expect(bars + bar, bytes);\n"
     "        barrier_wait(bars + bar, (unsigned)(it & 1));\n"
     "        mark(phase + 1);\n        phase += 2;\n"),
    ("    __device__ void cluster_sync() { cg::this_cluster().sync(); }\n",
     "    __device__ void cluster_sync()\n    {\n"
     "        cg::this_cluster().sync();\n"
     "        if (++syncs == 2) t_end = clock64();\n    }\n"),
    ("        if (bulk_in) barrier_wait(bars + ruiz::BAR_LOAD, 0);\n",
     "        if (bulk_in) barrier_wait(bars + ruiz::BAR_LOAD, 0);\n"
     "        last = clock64();\n        seg[9] = last - t0;\n"),
    ("        sum = total;\n        qmax = m;\n",
     "        sum = total;\n        qmax = m;\n        mark(8);\n"
     "        phase = 0;\n"),
    ("    ex.bulk_in = false;\n",
     "    ex.bulk_in = false;\n    ex.syncs = ex.phase = 0;\n"
     "    for (int k = 0; k < 11; ++k) ex.seg[k] = 0;\n"
     "    ex.t0 = ex.last = clock64();\n"),
    ("    ruiz::equilibrate_cluster(ex, a, blockIdx.x / ex.C);\n",
     "    ruiz::equilibrate_cluster(ex, a, blockIdx.x / ex.C);\n"
     "    ex.seg[10] = clock64() - ex.t_end;\n    __syncthreads();\n"
     "    if (threadIdx.x == 0 && ex.k.r == 0)\n"
     "        for (int k = 0; k < 11; ++k)\n"
     "            a.out[ruiz::O_Q][(blockIdx.x / ex.C) * a.n + k] =\n"
     "                (float)ex.seg[k];\n"),
    ("    ruiz::Lane s;\n    int lane;\n",
     "    ruiz::Lane s;\n    int lane;\n    int calls, last;\n"
     "    long long t, cyc[7];\n"),
    ("        f(lane, s);\n",
     "        f(lane, s);\n        const long long now = clock64();\n"
     "        cyc[calls == 0 ? 0 : calls == last ? 6 : 1 + (calls - 1) % 5]"
     " +=\n            now - t;\n"
     "        t = now;\n        ++calls;\n"),
    ("    ruiz::equilibrate_warp(ex, a, b);\n",
     "    ex.calls = 0;\n    ex.last = 1 + 5 * a.iters;\n"
     "    for (int k = 0; k < 7; ++k) ex.cyc[k] = 0;\n    ex.t = clock64();\n"
     "    ruiz::equilibrate_warp(ex, a, b);\n"
     "    if (ex.lane == 0)\n"
     "        for (int k = 0; k < 7; ++k)\n"
     "            a.out[ruiz::O_Q][b * a.n + k] = (float)ex.cyc[k];\n"),
]
# patched copies of ruiz.h that undo one choice of the shipped design
# (right results, the same bits)
RUIZ_SUBS = {
    "Ab read from A": [
        ("        const bool lists = a.iters > 0 && S > 0",
         "        const bool lists = false && a.iters > 0 && S > 0")],
    "8 runs of rows over P": [
        ("constexpr int P_GROUPS = 16;", "constexpr int P_GROUPS = 8;")],
    "4 runs of rows over P": [
        ("constexpr int P_GROUPS = 16;", "constexpr int P_GROUPS = 4;")],
    "8 rows of A loaded ahead": [
        ("constexpr int CHUNK = 16; ", "constexpr int CHUNK = 8; ")],
    "row maxima by warp reductions": [
        ("                    ex.put(i, j, fabsf(s.a[i]) * s.D);\n",
         "                    const float r = ex.max_of(s, [i](const Lane& t) "
         "{\n                        return t.live ? fabsf(t.a[i]) * t.D "
         ": 0.0f;\n                    });\n"
         "                    if (j == (i & (WARP - 1))) s.war[i >> 5] = r;\n"),
        ("                if (j + WARP * k < m) s.war[k] = ex.row_max(j + WARP "
         "* k, n);\n", "                (void)j;\n")],
}
# which of them apply to which path
RUIZ_SUB_PATH = {"Ab read from A": "cluster", "8 runs of rows over P": "cluster",
                 "4 runs of rows over P": "cluster",
                 "8 rows of A loaded ahead": "cluster",
                 "row maxima by warp reductions": "warp"}
RUIZ_PHASES = {
    "cluster": ["pass over A or its lists (first round: and over P)",
                "D's update", "D's and the row maxima's sends", "first wait",
                "E and the cost pass over P", "the norms", "the norms' sends",
                "second wait", "sum and c", "load", "stores"],
    "warp": ["load", "column maxima, the row tile", "row maxima",
             "scales", "cost pass", "sum and c", "stores"]}


def ruiz_inputs(seed, B, n, m, device, shared_a):
    """Random SPD P (64 tiled to B), q, bounds with infinite entries, and A:
    the MPC's pyramid constant broadcast (stride 0) or random dense rows."""
    from mpctsid_tpu_torch.mpc.srb import _constraint_matrix

    r = np.random.default_rng(seed)
    src = min(B, 64)

    def dev(a):
        t = torch.as_tensor(a, dtype=torch.float32)
        return t.repeat((-(-B // src),) + (1,) * (t.dim() - 1))[:B].to(
            device).contiguous()

    Q = r.normal(size=(src, n, n))
    P = Q @ Q.transpose(0, 2, 1) / n + np.eye(n)
    lo = -np.abs(r.normal(size=(src, m))) - 0.1
    lo[:, ::5] = -1e20
    if shared_a:
        A = torch.as_tensor(_constraint_matrix(n // 12, 0.7),
                            dtype=torch.float32, device=device)
        A = A.expand(B, m, n)
    else:
        A = dev(r.normal(size=(src, m, n)))
    return [dev(P), dev(r.normal(size=(src, n))), A, dev(lo), dev(-lo)]


def ruiz_call(fn, args, iters, geometry):
    """One launch of a Ruiz library's `ruiz_launch` through
    kernels.run_ruiz's packing; `geometry` the launcher's arguments after
    `iters` (the first design's: p_in_smem, slots)."""
    rc, outs = kernels.run_ruiz(
        lambda *a: fn(*a, torch.cuda.current_stream().cuda_stream), *args,
        iters, geometry)
    if rc != 0:
        raise RuntimeError(f"ruiz launch failed: CUDA error {rc}")
    return outs


def graphed(call):
    """`call` captured as a one-launch CUDA graph (after a warm-up on a
    side stream): its replay, which times the device and not the host's
    packing."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call()
    return graph.replay


def probe_ruiz(record, B, device, smem, n_sm, build, rounds=6):
    """The shipped Ruiz kernel against its first design (a patched copy) at
    both shapes and B = 1, 256 and --batch, in interleaved rounds: bit for
    bit on the same inputs, the times, the layouts not chosen (clusters of
    1-8 blocks, P read from device memory, A read whole every round) and
    each phase's cycles (a patched copy that reads the cycle counter).
    Times are one-launch CUDA graphs' replays."""
    argtypes, restype = kernels._ENTRY_POINTS["ruiz"]["ruiz_launch"]
    specs = {"first": dict(subs=lambda _: FIRST_RUIZ_CU, source="ruiz.cu",
                          header_subs={"ruiz.h": lambda _: FIRST_RUIZ_H}),
             "clock": dict(subs=RUIZ_CLOCK_SUBS, source="ruiz.cu")}
    specs.update({name: dict(subs=[], source="ruiz.cu",
                             header_subs={"ruiz.h": subs})
                  for name, subs in RUIZ_SUBS.items()})
    libs = build_variants(specs, build)
    shipped = kernels._library("ruiz")
    for name, lib in libs.items():
        lib.ruiz_launch.argtypes = (argtypes if name != "first" else
                                    argtypes[:3] + [ctypes.c_int] * 6
                                    + [ctypes.c_void_p])
        lib.ruiz_launch.restype = restype
    fns = {"shipped": shipped.ruiz_launch}
    fns.update({name: lib.ruiz_launch for name, lib in libs.items()})
    for shape, (n, m), shared in (("mpc", (192, 320), True),
                                  ("wbc", (30, 50), False)):
        for b in sorted({1, 256, B}):
            args = ruiz_inputs(90, b, n, m, device, shared)
            lay = kernels.ruiz_layout(n, m, b, smem, n_sm)
            old = first_layout(n, m, smem)
            ship = ruiz_call(fns["shipped"], args, 8, lay.geometry)
            prev = ruiz_call(fns["first"], args, 8, old)
            plain = admm.ruiz_equilibrate(*args, 8)
            record("ruiz", what="bits", shape=shape, B=b, layout=str(lay),
                   blocks_per_sm=int(shipped.ruiz_blocks_per_sm(
                       lay.geometry[0], n, m, *lay.geometry[1:])),
                   parted_vs_first=sum(int((x != y).sum())
                                      for x, y in zip(ship, prev)),
                   parted_vs_plain=sum(int((x != y).sum())
                                       for x, y in zip(ship, plain)),
                   entries=sum(x.numel() for x in ship))
            del ship, prev, plain
            designs = {"shipped": lambda: ruiz_call(fns["shipped"], args, 8,
                                                    lay.geometry),
                       "first design": lambda: ruiz_call(fns["first"], args,
                                                           8, old)}
            for name in RUIZ_SUBS:
                if RUIZ_SUB_PATH[name] == lay.path:
                    designs[name] = (lambda name=name: ruiz_call(
                        fns[name], args, 8, lay.geometry))
            for k in (0, 1):
                designs[f"shipped, {k} rounds"] = (
                    lambda k=k: ruiz_call(fns["shipped"], args, k,
                                          lay.geometry))
            if lay.path == "cluster":
                for c in (1, 2, 3, 4, 6, 8):
                    if c != lay.cluster:
                        g = (1, c, int(lay.p_in_smem), lay.slots)
                        if 4 * kernels.ruiz_smem_floats(n, m, c, *g[2:]) \
                                <= smem:
                            designs[f"cluster of {c}"] = (
                                lambda g=g: ruiz_call(fns["shipped"], args,
                                                      8, g))
                if lay.slots:
                    g = lay.geometry[:3] + (0,)
                    designs["A read whole every round"] = (
                        lambda g=g: ruiz_call(fns["shipped"], args, 8, g))
                if lay.p_in_smem:
                    g = (1, lay.cluster, 0, lay.slots)
                    designs["P read from device memory"] = (
                        lambda g=g: ruiz_call(fns["shipped"], args, 8, g))
            else:
                for w in (1, 2, 4, 8):
                    if w != lay.warps:
                        g = (0, w, 0, 0)
                        designs[f"{w} warps a block"] = (
                            lambda g=g: ruiz_call(fns["shipped"], args, 8,
                                                  g))
                g = (1, 1, 1, 4)
                designs["cluster path, one block"] = (
                    lambda g=g: ruiz_call(fns["shipped"], args, 8, g))
            replays = {name: graphed(call) for name, call in designs.items()}
            interleaved(record, "ruiz", replays, rounds, warmup=2,
                        reps=10 if b > 1 else 50, shape=shape, B=b, n=n,
                        m=m)
            del replays
            torch.cuda.empty_cache()
            cyc = ruiz_call(fns["clock"], args, 8, lay.geometry)[1]
            torch.cuda.synchronize()
            phases = RUIZ_PHASES[lay.path]
            cyc = cyc[:, :len(phases)].double()
            total = cyc.sum(dim=1, keepdim=True)
            for k, phase in enumerate(phases):
                record("ruiz", what="share of a block's cycles"
                       if lay.path == "cluster" else
                       "share of a warp's cycles", shape=shape, B=b,
                       phase=phase,
                       share=round(float((cyc[:, k:k + 1] / total).mean()),
                                   4), mean_cycles=float(cyc[:, k].mean()))
            del args
            torch.cuda.empty_cache()


# The cycle counter of the first STAMP_BLOCKS blocks (N = 16): thread 0 at
# the start and after the models; producer thread 0 as it publishes each
# W_j and when it is done; consumer thread 0 when each W_j's wait returns
# and when it is done
MPC_STAMPS, MPC_STAMP_BLOCKS = 40, 4096
MPC_BUILD_CLOCK_SUBS = [
    ("// a block's units in turn (the models)\n",
     f"constexpr int STAMPS = {MPC_STAMPS}, STAMP_BLOCKS = {MPC_STAMP_BLOCKS};"
     "\n__device__ long long mpcb_stamps[STAMPS * STAMP_BLOCKS];\n"
     "__device__ __forceinline__ void stamp(int i, bool lead)\n{\n"
     "    if (lead && blockIdx.x < STAMP_BLOCKS && i < STAMPS)\n"
     "        mpcb_stamps[blockIdx.x * STAMPS + i] = clock64();\n}\n\n"
     "// a block's units in turn (the models)\n"),
    ("            asm volatile(\"mbarrier.arrive.shared::cta.b64 _, [%0];\\n\"\n"
     "                         :: \"r\"(shared_addr(bars + j)) : \"memory\");\n",
     "            asm volatile(\"mbarrier.arrive.shared::cta.b64 _, [%0];\\n\"\n"
     "                         :: \"r\"(shared_addr(bars + j)) : \"memory\");\n"
     "        stamp(2 + j, tid == 0);\n"),
    ("    __device__ void await(int j) const { barrier_wait(bars + j); }",
     "    __device__ void await(int j) const\n    {\n"
     "        barrier_wait(bars + j);\n        stamp(18 + j, tid == 0);\n"
     "    }"),
    ("    const long long b = blockIdx.x;\n    if (threadIdx.x == 0)\n",
     "    const long long b = blockIdx.x;\n    stamp(0, threadIdx.x == 0);\n"
     "    if (threadIdx.x == 0)\n"),
    ("    __syncthreads();\n    if ((int)threadIdx.x < PRODUCER_THREADS)\n"
     "        mpcb::producer(GroupExec{(int)threadIdx.x, PRODUCER_THREADS, 1, "
     "bars},\n                       a, N, b, sm);\n    else\n"
     "        mpcb::consumer(GroupExec{(int)threadIdx.x - PRODUCER_THREADS,\n"
     "                                 CONSUMER_THREADS, 2, bars},\n"
     "                       a, N, b, sm);\n",
     "    __syncthreads();\n    stamp(1, threadIdx.x == 0);\n"
     "    if ((int)threadIdx.x < PRODUCER_THREADS) {\n"
     "        mpcb::producer(GroupExec{(int)threadIdx.x, PRODUCER_THREADS, 1, "
     "bars},\n                       a, N, b, sm);\n"
     "        stamp(35, threadIdx.x == 0);\n    } else {\n"
     "        mpcb::consumer(GroupExec{(int)threadIdx.x - PRODUCER_THREADS,\n"
     "                                 CONSUMER_THREADS, 2, bars},\n"
     "                       a, N, b, sm);\n"
     "        stamp(34, (int)threadIdx.x == PRODUCER_THREADS);\n    }\n"),
    ('extern "C" {\n',
     'extern "C" {\n\nint mpc_build_stamps(long long* out, int n)\n{\n'
     "    return (int)cudaMemcpyFromSymbol(out, mpcb_stamps,\n"
     "                                     n * sizeof(long long));\n}\n")]


def mpc_build_phases(st, N=16):
    """{phase: cycles (one a block)} from the clock copy's stamps (blocks,
    MPC_STAMPS): stamp 2 + j is W_j published, 18 + j W_j's wait done."""
    pub = lambda j: st[:, 2 + j]  # noqa: E731
    got = lambda j: st[:, 18 + j]  # noqa: E731
    steps = np.stack([pub(j) - pub(j + 1) for j in range(N - 1)], 1)
    rows = np.stack([got(j) - got(j + 1) for j in range(N - 1)], 1)
    end = np.maximum(st[:, 34], st[:, 35])
    return {
        "models (all warps)": st[:, 1] - st[:, 0],
        "producer: free response, drift, step 15 to W_15": pub(N - 1)
        - st[:, 1],
        "producer: a step of the recursion (mean of 15)": steps.mean(1),
        "producer: all 16 steps": pub(0) - st[:, 1],
        "consumers: Su's columns and l, u, then W_15's wait": got(N - 1)
        - st[:, 1],
        "consumers: a row block and the next W's wait (mean of 15)":
            rows.mean(1),
        "consumers: waiting for W_j past their row block j + 1 (total)":
            np.clip(got(0) - pub(0), 0, None),
        "consumers: the last row block": st[:, 34] - got(0),
        "whole block": end - st[:, 0]}


def mpc_build_inputs(B, dtype, device):
    """B trot scenarios from standing at a walking command (values do not
    change the build's time)."""
    from mpctsid_tpu_torch.mpc import srb
    from mpctsid_tpu_torch.plan.gait import contacts_horizon

    cfg = EngineConfig()
    x0 = torch.zeros((B, 12), dtype=dtype, device=device)
    x0[:, 2] = SOLO12.h_ref
    vc = torch.tensor([0.3, 0.0, 0.2], dtype=dtype,
                      device=device).expand(B, 3).contiguous()
    x_ref = srb.reference_rollout_reference(SOLO12, cfg.mpc, x0, vc)
    feet = torch.as_tensor(SOLO12.shoulder_offsets, dtype=dtype,
                           device=device).expand(B, 16, 4, 3).contiguous()
    gid = torch.zeros((B,), dtype=torch.int32, device=device)
    ph = torch.arange(B, dtype=torch.int32, device=device) % 16
    return x0, x_ref, feet, contacts_horizon(gid, ph, 16, dtype)


# patched copies of the shipped header that undo or push one choice each
MPC_HEADER_VARIANTS = {
    f"{w} producer warp{'s' * (w > 1)}": [("constexpr int PRODUCER_WARPS = 5;",
                             f"constexpr int PRODUCER_WARPS = {w};")]
    for w in (1, 2, 4, 6)}
MPC_HEADER_VARIANTS.update({
    "3 blocks a multiprocessor (launch bounds)": [
        ("constexpr int MIN_BLOCKS_F32 = 4;",
         "constexpr int MIN_BLOCKS_F32 = 3;")],
    "no P rows": [("        ex.await(j);\n"
                   "        consumer_rows(ex, a, N, b, j, sm);",
                   "        ex.await(j);\n        if (N < 0)\n"
                   "            consumer_rows(ex, a, N, b, j, sm);")],
    # the diagonal's pin in one fused multiply-add, and with every op
    # rounded apart: which of them the first design's bits are
    "pin as one fma": [
        ("            acc[k][k] = (acc[k][k] + a.par[PAR_W_FORCE]) + pin;",
         "            acc[k][k] = mb_fma(a.par[PAR_W_PIN], (T)1 - ct[(c0 + k)"
         " / 3],\n                               acc[k][k] + "
         "a.par[PAR_W_FORCE]);\n            (void)pin;")],
    "pin rounded apart": [
        ("            acc[k][k] = (acc[k][k] + a.par[PAR_W_FORCE]) + pin;",
         "#if defined(__CUDA_ARCH__)\n"
         "            if constexpr (sizeof(T) == 4)\n"
         "                acc[k][k] = __fadd_rn(__fadd_rn(acc[k][k], "
         "a.par[PAR_W_FORCE]),\n"
         "                                      __fmul_rn(a.par[PAR_W_PIN], "
         "(T)1 - ct[(c0 + k) / 3]));\n"
         "            else\n"
         "                acc[k][k] = __dadd_rn(__dadd_rn(acc[k][k], "
         "a.par[PAR_W_FORCE]),\n"
         "                                      __dmul_rn(a.par[PAR_W_PIN], "
         "(T)1 - ct[(c0 + k) / 3]));\n"
         "            (void)pin;\n#else\n"
         "            acc[k][k] = (acc[k][k] + a.par[PAR_W_FORCE]) + pin;\n"
         "#endif")]})
# the consumers' waits for W_j: a back-off between polls, or suspended in
# the try_wait itself, instead of polling back to back
MPC_WAIT_VARIANTS = {
    "waits: 64 ns back-off": [(
        "        if (done) return;\n    }\n    __trap();",
        "        if (done) return;\n        __nanosleep(64);\n    }\n"
        "    __trap();")],
    "waits: 256 ns back-off": [(
        "        if (done) return;\n    }\n    __trap();",
        "        if (done) return;\n        __nanosleep(256);\n    }\n"
        "    __trap();")],
    "waits: suspended in try_wait": [(
        "            \"mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n\"",
        "            \"mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, "
        "%3;\\n\""), (
        "            : \"=r\"(done) : \"r\"(addr), \"r\"(0u) : \"memory\");",
        "            : \"=r\"(done) : \"r\"(addr), \"r\"(0u), \"r\"(20000u)\n"
        "            : \"memory\");")]}

# variants whose results are wrong on purpose (times only)
MPC_WRONG = ("no P rows", "first design, no P rows")

# each row block staged in shared memory (12 x n values after diag(Q),
# one block fewer a multiprocessor) and stored by one bulk copy of 9,216
# bytes, the stage free again once the copy engine has read it
MPC_BULK_STORE = dict(
    header=[
        ("    T* qd;      // diag(Q)\n",
         "    T* qd;      // diag(Q)\n    T* stage;   // a row block of P\n"),
        ("          d(m + 9 * N), g(d + NX * N), qd(g + NX * N)\n",
         "          d(m + 9 * N), g(d + NX * N), qd(g + NX * N),\n"
         "          stage(qd + 16)\n"),
        ("           + 2LL * BLK + 9LL * N + 2LL * NX * N + NX;",
         "           + 2LL * BLK + 9LL * N + 2LL * NX * N + 16\n"
         "           + (long long)NX * NU * N;"),
        ("    T* P = a.out[OUT_P] + b * n * n + (long long)(NX * j + r0) * n"
         " + NU * i\n           + c0;",
         "    T* P = sm.stage + (long long)r0 * n + NU * i + c0;"),
        ("        ex.await(j);\n        consumer_rows(ex, a, N, b, j, sm);\n"
         "    }\n",
         "        ex.await(j);\n        ex.stage_free();\n"
         "        consumer_rows(ex, a, N, b, j, sm);\n"
         "        ex.store_stage(a.out[OUT_P] + b * sm.n * sm.n\n"
         "                           + (long long)NX * j * sm.n,\n"
         "                       sm.stage, NX * sm.n * (int)sizeof(T));\n"
         "    }\n    ex.stage_free();\n"),
        ("constexpr int MIN_BLOCKS_F32 = 4;", "constexpr int MIN_BLOCKS_F32 = 3;"),
    ],
    cu=[("    __device__ void await(int j) const { barrier_wait(bars + j); }",
         "    __device__ void await(int j) const { barrier_wait(bars + j); }\n"
         "    // the stage's last bulk store has read it\n"
         "    __device__ void stage_free() const\n    {\n"
         "        if (tid == 0)\n"
         "            asm volatile(\"cp.async.bulk.wait_group.read 0;\\n\" ::: "
         "\"memory\");\n"
         "        sync();\n    }\n"
         "    __device__ void store_stage(void* dst, const void* src,\n"
         "                                int bytes) const\n    {\n"
         "        asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: "
         "\"memory\");\n"
         "        sync();\n        if (tid != 0) return;\n"
         "        asm volatile(\"cp.async.bulk.global.shared::cta.bulk_group\"\n"
         "                     \" [%0], [%1], %2;\\n\" :: \"l\"(dst),\n"
         "                     \"r\"(shared_addr(src)), \"r\"(bytes) : "
         "\"memory\");\n"
         "        asm volatile(\"cp.async.bulk.commit_group;\\n\" ::: "
         "\"memory\");\n    }")])


def probe_mpc_build(record, B, device, build, rounds=6):
    """The shipped MPC build (the pipelined block) against its first design
    (its mpc_build.h and .cu, FIRST_MPC_BUILD_H / FIRST_MPC_BUILD_CU,
    built as a patched copy): P, q, l and u bit for bit on chip_smoke.py
    phase 3h's inputs (float32 and float64, B = 1, 37 and --batch, mass
    none and given); then the times in interleaved rounds beside the
    copies of MPC_HEADER_VARIANTS (1 and 2 producer warps, the launch
    bounds at 3 blocks, no P rows, the pin's two roundings), the row
    blocks staged and bulk-stored (MPC_BULK_STORE) and the first design
    with and without its P rows, each with its share of the bound;
    the cycles of the producer's steps and the consumers' row blocks
    (`MPC_BUILD_CLOCK_SUBS`); ptxas' registers and spills of every build.
    Times are one-launch CUDA graphs' replays."""
    import threading

    from chip_smoke import mpc_build_bound_ms
    from chip_smoke import mpc_build_inputs as planned_inputs
    from mpctsid_tpu_torch.mpc import kernels as mk
    from mpctsid_tpu_torch.mpc import srb

    cfg = EngineConfig()
    csrc = mk.CSRC
    shipped_build = threading.Thread(target=_build.build_libraries, args=(
        kernels.build_specs() + mk.build_specs()
        + rbd_kernels.build_specs(),))
    shipped_build.start()
    first = dict(subs=lambda _: FIRST_MPC_BUILD_CU, source="mpc_build.cu",
                 csrc=csrc, header_subs={
                     "mpc_build.h": lambda _: FIRST_MPC_BUILD_H})
    specs = {"first design": first,
             "first design, no P rows": dict(first, header_subs={
                 "mpc_build.h": lambda _: FIRST_MPC_BUILD_H.replace(
                     "        if (u < N * n)\n            p_unit(",
                     "        if (u < N * n)\n            continue;\n"
                     "        else if (N < 0)\n            p_unit(")}),
             "clock": dict(subs=MPC_BUILD_CLOCK_SUBS, source="mpc_build.cu",
                           csrc=csrc)}
    specs.update({name: dict(subs=[], source="mpc_build.cu", csrc=csrc,
                             header_subs={"mpc_build.h": sub})
                  for name, sub in MPC_HEADER_VARIANTS.items()})
    specs.update({name: dict(subs=sub, source="mpc_build.cu", csrc=csrc)
                  for name, sub in MPC_WAIT_VARIANTS.items()})
    specs["bulk-stored row blocks"] = dict(
        subs=MPC_BULK_STORE["cu"], source="mpc_build.cu", csrc=csrc,
        header_subs={"mpc_build.h": MPC_BULK_STORE["header"]})
    libs = build_variants(specs, build)
    shipped_build.join()
    libs["shipped"] = mk._library()
    fns = {}
    for name, lib in libs.items():
        lib.mpc_build_launch.argtypes = mk.LAUNCH_ARGTYPES + [ctypes.c_void_p]
        lib.mpc_build_launch.restype = ctypes.c_int
        fns[name] = lib.mpc_build_launch
    logs = dict(VARIANT_LOGS, shipped=_build.BUILD_LOG.get("mpc_build"))
    for name in ("shipped", *specs):
        for row in ptxas_entries(logs.get(name)):
            record("mpcbuild", what="ptxas", library=name, **row)

    def call(name, args):
        stream = torch.cuda.current_stream().cuda_stream
        rc, outs = srb.run_mpc_build(
            lambda *a: fns[name](*a, stream), SOLO12, cfg.mpc, *args)
        if rc != 0:
            raise RuntimeError(f"mpc_build {name}: CUDA error {rc}")
        return outs

    def parted(got, want):
        return [int((g != w).sum()) for g, w in zip(got, want)]

    # the bits: every build against the first design on planned states
    inputs = {dt: planned_inputs(max(B, 37), dt, device)
              for dt in (torch.float32, torch.float64)}
    for b in sorted({1, 37, B}):
        for dtype in (torch.float32, torch.float64):
            for with_mass in (False, True):
                x, x_ref, feet, cont, mass = (t[:b] for t in inputs[dtype])
                args = (x, x_ref, feet, cont, mass if with_mass else None)
                ref = call("first design", args)
                names = ["shipped"] if b != 37 else [
                    n for n in fns if n not in MPC_WRONG
                    and n not in ("first design", "clock")]
                for name in names:
                    got = call(name, args)
                    record("mpcbuild", what="bits", B=b,
                           dtype=str(dtype)[6:], mass=with_mass,
                           design=name, parted_vs_first=parted(got, ref),
                           entries=[int(t.numel()) for t in ref],
                           symmetric=bool(torch.equal(
                               got[0], got[0].transpose(1, 2))))
                del ref
        torch.cuda.empty_cache()
    del inputs
    # the times and the cycles
    for b in sorted({1, B}):
        args = mpc_build_inputs(b, torch.float32, device)
        args64 = mpc_build_inputs(b, torch.float64, device)
        designs = {name: (lambda name=name: call(name, args))
                   for name in fns if name != "clock"}
        designs["shipped, float64"] = lambda: call("shipped", args64)
        designs["first design, float64"] = lambda: call("first design",
                                                         args64)
        replays = {name: graphed(c) for name, c in designs.items()}
        med = interleaved(record, "mpcbuild", replays, rounds, warmup=2,
                          reps=10 if b > 1 else 50, B=b)
        for name, ms in med.items():
            bound = mpc_build_bound_ms(
                b, 16, torch.float64 if "float64" in name else torch.float32)
            record("mpcbuild", what="share of the bound", B=b, design=name,
                   ms=ms, bound_ms=bound[0], bound_by=bound[1],
                   share=round(bound[0] / ms, 4))
        del replays
        call("clock", args)
        torch.cuda.synchronize()
        stamps = np.zeros(MPC_STAMPS * MPC_STAMP_BLOCKS, dtype=np.int64)
        rc = libs["clock"].mpc_build_stamps(
            stamps.ctypes.data_as(ctypes.c_void_p), stamps.size)
        if rc != 0:
            raise RuntimeError(f"mpc_build_stamps: CUDA error {rc}")
        st = stamps.reshape(MPC_STAMP_BLOCKS, MPC_STAMPS)[
            :min(b, MPC_STAMP_BLOCKS)].astype(np.float64)
        for phase, cyc in mpc_build_phases(st).items():
            record("mpcbuild", what="cycles of a block", B=b, phase=phase,
                   mean_cycles=float(cyc.mean()))
        del args, args64
        torch.cuda.empty_cache()


# ---- the solve tail (qp/csrc/solve_tail.cu over solve_tail.h)

# kkt_blocks with its aligned tiles held in registers (KKT_PIECES 16-byte
# pieces a thread, loaded before the setup) instead of coming in by bulk
# copy: the unaligned path's kernel taken for every launch
TAIL_REGISTER_KKT_SUBS = [
    ("    const long long smem = tail::kkt_smem_bytes(s.n, s.c, tile, V > 1,",
     "    const long long smem = tail::kkt_smem_bytes(s.n, s.c, tile, 0,"),
    ("        err = set_smem(tail_kkt_kernel_bulk<T>, smem);\n"
     "        if (err != cudaSuccess) return (int)err;\n"
     "        tail_kkt_kernel_bulk<T>\n",
     "        err = set_smem(tail_kkt_kernel<T, V16>, smem);\n"
     "        if (err != cudaSuccess) return (int)err;\n"
     "        tail_kkt_kernel<T, V16>\n")]


# The cycle counter of each block's thread 0 (a warp's lane 0 on the warp
# path) at the start, after every barrier and at the end of a launch, for
# the first STAMP_UNITS blocks (scenarios on the warp path)
TAIL_CLOCK_SUBS = [
    ("struct BlockExec {\n",
     "constexpr int STAMPS = 16, STAMP_UNITS = 8192;\n"
     "__device__ long long tail_stamps[STAMPS * STAMP_UNITS];\n"
     "__device__ __forceinline__ void stamp(long long unit, int i, bool lead)"
     "\n{\n    if (lead && unit < STAMP_UNITS && i < STAMPS)\n"
     "        tail_stamps[unit * STAMPS + i] = clock64();\n}\n\n"
     "struct BlockExec {\n    mutable int k = 1;\n"),
    ("    __device__ void sync() const { __syncthreads(); }",
     "    __device__ void sync() const\n    {\n        __syncthreads();\n"
     "        stamp(blockIdx.x, k++, threadIdx.x == 0);\n    }"),
    ("    Lane s;\n    int lane;\n",
     "    Lane s;\n    int lane;\n    long long unit = 1LL << 40;\n"
     "    mutable int k = 0;\n"),
    ("    __device__ void sync() const { __syncwarp(); }",
     "    __device__ void sync() const\n    {\n        __syncwarp();\n"
     "        stamp(unit, k++, lane == 0);\n    }"),
    # kkt_blocks' bulk kernel: start, setup, the copy's wait, the store
    ("    const int b = blockIdx.x / tiles, t = blockIdx.x - b * tiles;\n"
     "    const int step = blockDim.x * V, tile",
     "    stamp(blockIdx.x, 0, threadIdx.x == 0);\n"
     "    const int b = blockIdx.x / tiles, t = blockIdx.x - b * tiles;\n"
     "    const int step = blockDim.x * V, tile"),
    ("    tail::kkt_setup(BlockExec{}, a, s, (long long)b, tl, sm);\n"
     "    barrier_wait(bar, 0);\n",
     "    const BlockExec ex{};\n"
     "    tail::kkt_setup(ex, a, s, (long long)b, tl, sm);\n"
     "    barrier_wait(bar, 0);\n    stamp(blockIdx.x, 2, threadIdx.x == 0);\n"),
    ("        asm volatile(\"cp.async.bulk.wait_group.read 0;\\n\" ::: "
     "\"memory\");\n    }\n}",
     "        asm volatile(\"cp.async.bulk.wait_group.read 0;\\n\" ::: "
     "\"memory\");\n        stamp(blockIdx.x, 3, true);\n    }\n}"),
    # unscale's block path: start, its barriers, end
    ("    tail::unscale_block<T>(BlockExec{}, a, s, (long long)blockIdx.x,\n"
     "                           reinterpret_cast<T*>(smem));\n}",
     "    const BlockExec ex{};\n    stamp(blockIdx.x, 0, threadIdx.x == 0);\n"
     "    tail::unscale_block<T>(ex, a, s, (long long)blockIdx.x,\n"
     "                           reinterpret_cast<T*>(smem));\n"
     "    __syncthreads();\n    stamp(blockIdx.x, ex.k, threadIdx.x == 0);\n}"),
    # adapt_rho's block path: start, its barriers, end
    ("    tail::adapt_block<T>(BlockExec{}, a, s, (long long)blockIdx.x,\n"
     "                         reinterpret_cast<double*>(smem));\n}",
     "    const BlockExec ex{};\n    stamp(blockIdx.x, 0, threadIdx.x == 0);\n"
     "    tail::adapt_block<T>(ex, a, s, (long long)blockIdx.x,\n"
     "                         reinterpret_cast<double*>(smem));\n"
     "    __syncthreads();\n    stamp(blockIdx.x, ex.k, threadIdx.x == 0);\n}"),
    # the two-slot warp paths: a scenario's wait, then its barriers
    ("        barrier_wait(bars + cur, (k >> 1) & 1);\n",
     "        stamp(b, 0, lane == 0);\n"
     "        barrier_wait(bars + cur, (k >> 1) & 1);\n"
     "        stamp(b, 1, lane == 0);\n"),
    ("        [&](long long b, const T* Ps) {\n"
     "            tail::unscale_warp_rows(",
     "        [&](long long b, const T* Ps) {\n"
     "            ex.unit = b;\n            ex.k = 2;\n"
     "            tail::unscale_warp_rows("),
    ("        [&](long long b, const T* Ps) {\n"
     "            tail::adapt_warp_rows(",
     "        [&](long long b, const T* Ps) {\n"
     "            ex.unit = b;\n            ex.k = 2;\n"
     "            tail::adapt_warp_rows("),
    ('extern "C" {\n',
     'extern "C" {\n\nint solve_tail_stamps(long long* out, int n)\n{\n'
     "    return (int)cudaMemcpyFromSymbol(out, tail_stamps,\n"
     "                                     n * sizeof(long long));\n}\n")]
TAIL_STAMPS, TAIL_STAMP_UNITS = 16, 8192
# the phases between the stamps of each launch
TAIL_PHASES = {
    "tiles": ["rho_vec's rows and block entries (the tile's copy in "
              "flight)", "the copy's remaining wait",
              "pieces patched, the bulk store issued and read out"],
    "block": ["x, y", "products (P's rows streamed)", "row sums, z",
              "partial maxima", "prim, dual, ok"],
    "warp": ["waiting for the scenario's P and A", "x, y",
             "products, maxima, stores"],
    "adapt block": ["x, y", "products (P's rows streamed)", "row sums",
                    "the maxima (shuffles, one warp over the warps), rho"],
    "adapt warp": ["waiting for the scenario's P and A", "x, y",
                   "products, the maxima by shuffles, rho"]}
# patched copies of solve_tail.h that undo or push one choice each
TAIL_HEADER_VARIANTS = {
    "4 pieces a thread": ("constexpr int KKT_PIECES = 8;",
                          "constexpr int KKT_PIECES = 4;"),
    "16 pieces a thread": ("constexpr int KKT_PIECES = 8;",
                           "constexpr int KKT_PIECES = 16;"),
    "1 row a group": ("constexpr int ROW_GROUP = 2;",
                      "constexpr int ROW_GROUP = 1;"),
    "4 rows a group": ("constexpr int ROW_GROUP = 2;",
                       "constexpr int ROW_GROUP = 4;"),
    "rows' loads by j": ("constexpr int STREAM_NQ = 6;",
                         "constexpr int STREAM_NQ = 0;"),
    "adapt: 2 rows a group": ("constexpr int ADAPT_ROW_GROUP = 4;",
                              "constexpr int ADAPT_ROW_GROUP = 2;"),
    "adapt: 8 rows a group": ("constexpr int ADAPT_ROW_GROUP = 4;",
                              "constexpr int ADAPT_ROW_GROUP = 8;")}

# unscale's block path with P's rows by bulk copy through a ring of `slots`
# chunks of `rows` rows in shared memory (each chunk's mbarrier, the next
# chunks in flight while the block sums one) instead of from device memory:
# a kernel of its own (`tail_unscale_ring_kernel`) in place of the block
# kernel, for 16-byte aligned rows of P only
TAIL_RING_KERNEL = r"""
constexpr int RING_ROWS = %(rows)d, RING_SLOTS = %(slots)d;
constexpr int RING_HEAD = 16 * ((RING_SLOTS * 8 + 15) / 16);

// the block executor with the ring: P's rows through it (`p_rows`)
template <typename T>
struct RingExec : BlockExec {
    uint64_t* bars;
    T* ring;
    const T* P;
    int n;

    __device__ void issue(int c) const
    {
        if (threadIdx.x != 0) return;
        const int r0 = c * RING_ROWS, k = c %% RING_SLOTS;
        const int rows = n - r0 < RING_ROWS ? n - r0 : RING_ROWS;
        const unsigned bytes = (unsigned)(rows * n * sizeof(T));
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        barrier_expect(bars + k, bytes);
        bulk_load(ring + (long long)k * RING_ROWS * n, P + (long long)r0 * n,
                  bytes, bars + k);
    }
    template <int NQ>
    __device__ void p_rows(const T*, const T* x, T* lanes, int ld,
                           int) const
    {
        const int chunks = (n + RING_ROWS - 1) / RING_ROWS;
        for (int c = 0; c < chunks; ++c) {
            const int r0 = c * RING_ROWS;
            const int rows = n - r0 < RING_ROWS ? n - r0 : RING_ROWS;
            barrier_wait(bars + c %% RING_SLOTS, (c / RING_SLOTS) & 1);
            tail::row_groups<NQ, tail::ROW_GROUP>(BlockExec{},
                                 ring + (long long)(c %% RING_SLOTS)
                                            * RING_ROWS * n,
                                 rows, n, x, lanes, ld, r0);
            __syncthreads();
            if (c + RING_SLOTS < chunks) issue(c + RING_SLOTS);
        }
    }
};

template <typename T>
__global__ void __launch_bounds__(1024)
tail_unscale_ring_kernel(const tail::UnArgs<T> a, const tail::Shape s)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const long long b = blockIdx.x;
    RingExec<T> ex;
    ex.bars = reinterpret_cast<uint64_t*>(smem);
    ex.ring = reinterpret_cast<T*>(smem + RING_HEAD);
    ex.P = a.row(tail::UI_P, b);
    ex.n = s.n;
    if (threadIdx.x == 0) {
        for (int k = 0; k < RING_SLOTS; ++k) bulk_barrier_init(ex.bars + k);
        for (int c = 0; c < RING_SLOTS && c * RING_ROWS < s.n; ++c)
            ex.issue(c);
    }
    tail::unscale_block<T>(
        ex, a, s, b, ex.ring + (long long)RING_SLOTS * RING_ROWS * s.n);
}

"""


def tail_ring_subs(rows, slots):
    """solve_tail.cu with the block path's P rows through a ring of
    `slots` chunks of `rows` rows (TAIL_RING_KERNEL: its executor's
    `p_rows`, which `tail_ring_header` has the body call; BlockExec's reads
    them from device memory as the shipped body does)."""
    def sub(src):
        src = src.replace(
            "    __device__ void sync() const { __syncthreads(); }\n",
            "    __device__ void sync() const { __syncthreads(); }\n"
            "    template <int NQ, typename T>\n"
            "    __device__ void p_rows(const T* P, const T* x, T* lanes,\n"
            "                           int ld, int n) const\n    {\n"
            "        tail::row_groups<NQ, tail::ROW_GROUP>(*this, P, n, n, x,\n"
            "                                              lanes, ld, 0);\n"
            "    }\n", 1)
        at = src.index("// the warp paths, one slot:")
        src = (src[:at] + TAIL_RING_KERNEL % dict(rows=rows, slots=slots)
               + src[at:])
        old = ("        err = set_smem(tail_unscale_kernel_block<T>, smem);\n"
               "        if (err != cudaSuccess) return (int)err;\n"
               "        tail_unscale_kernel_block<T>\n")
        new = ("        const long long ring = RING_HEAD + (long long)"
               "RING_SLOTS * RING_ROWS * s.n * size;\n"
               "        err = set_smem(tail_unscale_ring_kernel<T>, "
               "smem + ring);\n"
               "        if (err != cudaSuccess) return (int)err;\n"
               "        tail_unscale_ring_kernel<T>\n"
               "            <<<blocks, threads, (size_t)(smem + ring), "
               "stream>>>(a, s);\n"
               "        if (false) tail_unscale_kernel_block<T>\n")
        if old not in src:
            raise RuntimeError("tail ring: the block kernel's launch is not "
                               "in solve_tail.cu")
        return src.replace(old, new)
    return sub


# ... and the body asking its executor for P's rows' partials
TAIL_RING_HEADER = [
    ("    row_groups<NQ, ROW_GROUP>(ex, P, n, n, S.x, S.lanes, ld, 0);\n"
     "    ex.sync();\n    // P x; A x of a dense A;",
     "    ex.template p_rows<NQ>(P, S.x, S.lanes, ld, n);\n    ex.sync();\n"
     "    // P x; A x of a dense A;")]
# the pieces a thread of kkt_blocks takes in each build
TAIL_PIECES = {"4 pieces a thread": 4, "16 pieces a thread": 16}


def ptxas_entries(log):
    """[{function, registers, smem, stack, spill_stores, spill_loads}] of
    every entry function in an `nvcc -Xptxas -v` log."""
    out, cur = [], None
    for line in (log or "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = dict(function=m.group(1))
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return out


def first_tail_geometry(entry, B, n, m, n_sm):
    """The first design's geometry (its kkt_layout and tail_layout)."""
    if entry == "kkt":
        total = -(-B * n * n // 4) + B * m
        return (256, max(1, min(-(-total // 256), 8 * n_sm)), 1)
    return (128, B, 1) if max(n, m) <= 64 else (512, B, 32)


def kkt_geometry(B, n, threads, pieces, vec):
    return (threads, B * -(-n * n // (threads * pieces * vec)), vec)


def probe_tail(record, B, device, smem, n_sm, build, rounds=6):
    """kkt_blocks and unscale (and adapt_rho, which kept its design)
    against their first design (FIRST_TAIL_H / FIRST_TAIL_CU, a patched
    copy) on phase 3i's problems at both shapes and B = 1, 256 and
    --batch: every output's bits against the first design's, then the
    times in interleaved rounds beside the layouts not chosen, the
    patched copies of TAIL_HEADER_VARIANTS and TAIL_REGISTER_KKT_SUBS, the
    library call for K and the plain chains, each with its share of the
    bound;
    the cycles of each phase (TAIL_CLOCK_SUBS); ptxas' registers, shared
    memory and spills of every entry.  Times are one-launch CUDA graphs'
    replays."""
    import threading

    from chip_smoke import (a_shared, kkt_bound_ms, tail_bound_ms,
                            tail_problems)
    from mpctsid_tpu_torch.mpc import kernels as mpc_kernels
    from mpctsid_tpu_torch.qp import tail

    # the libraries phase 3i's problems run on, built beside the copies
    shipped = threading.Thread(target=_build.build_libraries, args=(
        kernels.build_specs() + mpc_kernels.build_specs()
        + tail.build_specs(),))
    shipped.start()
    flags = tail.FLAGS
    specs = {"first design": dict(
                 subs=lambda _: FIRST_TAIL_CU, source="solve_tail.cu",
                 header_subs={"solve_tail.h": lambda _: FIRST_TAIL_H},
                 flags=flags),
             "clock": dict(subs=TAIL_CLOCK_SUBS, source="solve_tail.cu",
                           flags=flags),
             "16-byte pieces in registers": dict(
                 subs=TAIL_REGISTER_KKT_SUBS, source="solve_tail.cu",
                 flags=flags),
             "a ring of 3 chunks of 32 rows": dict(
                 subs=tail_ring_subs(32, 3), source="solve_tail.cu",
                 header_subs={"solve_tail.h": TAIL_RING_HEADER},
                 flags=flags),
             "a ring of 4 chunks of 16 rows": dict(
                 subs=tail_ring_subs(16, 4), source="solve_tail.cu",
                 header_subs={"solve_tail.h": TAIL_RING_HEADER},
                 flags=flags)}
    specs.update({name: dict(subs=[], source="solve_tail.cu",
                             header_subs={"solve_tail.h": [sub]},
                             flags=flags)
                  for name, sub in TAIL_HEADER_VARIANTS.items()})
    libs = build_variants(specs, build)
    shipped.join()
    libs["shipped"] = tail._library()
    for name, lib in libs.items():
        for entry in ("kkt", "adapt", "unscale"):
            fn = getattr(lib, f"solve_tail_{entry}_launch")
            fn.argtypes = tail.LAUNCH_ARGTYPES + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    logs = dict(VARIANT_LOGS, shipped=_build.BUILD_LOG.get("solve_tail"))
    for name in ("shipped", *specs):
        for row in ptxas_entries(logs.get(name)):
            record("tail", what="ptxas", library=name, **row)

    runs = {"kkt": tail.run_kkt, "adapt": tail.run_adapt,
            "unscale": tail.run_unscale}

    def call(lib, entry, args, geometry):
        fn = getattr(libs[lib], f"solve_tail_{entry}_launch")
        stream = torch.cuda.current_stream().cuda_stream
        rc, out = runs[entry](lambda *a: fn(*a, stream), *args, geometry)
        if rc != 0:
            raise RuntimeError(f"{lib} {entry} {geometry}: CUDA error {rc}")
        return out if isinstance(out, tuple) else (out,)

    def parted(got, want):
        return [int((g != w).sum()) for g, w in zip(got, want)]

    def timed(entry, shape, b, designs, bound, kernel_designs):
        """designs: name -> callable; kernel_designs: name -> (lib,
        geometry), held bit for bit against the first design first."""
        ref = call("first design", entry, args_of[entry],
                   first_tail_geometry(entry, b, n, m, n_sm))
        for name, (lib, geometry) in kernel_designs.items():
            record("tail", what="bits", kernel=entry, shape=shape, B=b,
                   design=name, geometry=list(geometry),
                   parted_vs_first=parted(call(lib, entry, args_of[entry],
                                               geometry), ref),
                   entries=[int(t.numel()) for t in ref])
        del ref
        replays = {name: graphed(c) for name, c in designs.items()}
        med = interleaved(record, "tail", replays, rounds, warmup=2,
                          reps=10 if b > 1 else 50, kernel=entry,
                          shape=shape, B=b, n=n, m=m)
        for name, ms in med.items():
            record("tail", what="share of the bound", kernel=entry,
                   shape=shape, B=b, design=name, ms=ms, bound_ms=bound[0],
                   bound_by=bound[1], share=round(bound[0] / ms, 4))
        del replays
        torch.cuda.empty_cache()

    def phases(entry, shape, b, args, geometry, path):
        call("clock", entry, args, geometry)
        torch.cuda.synchronize()
        st = np.zeros(TAIL_STAMPS * TAIL_STAMP_UNITS, dtype=np.int64)
        rc = libs["clock"].solve_tail_stamps(
            st.ctypes.data_as(ctypes.c_void_p), st.size)
        if rc != 0:
            raise RuntimeError(f"solve_tail_stamps: CUDA error {rc}")
        units = min(geometry[1] if path != "warp" else b, TAIL_STAMP_UNITS)
        st = st.reshape(TAIL_STAMP_UNITS, TAIL_STAMPS)[:units].astype(
            np.float64)
        names = TAIL_PHASES.get(f"{entry} {path}", TAIL_PHASES[path])
        total = st[:, len(names)] - st[:, 0]
        for k, phase in enumerate(names):
            cyc = st[:, k + 1] - st[:, k]
            record("tail", what="share of the cycles", kernel=entry,
                   shape=shape, B=b, phase=phase,
                   share=round(float((cyc / total).mean()), 4),
                   mean_cycles=float(cyc.mean()))

    for b in sorted({1, 256, B}):
        problems = tail_problems(b, device)
        for shape, (qp, scaled, eqf, rho_s, it, blocks, stol) in \
                problems.items():
            Ps, qs, As, ls, us, D, E, c = scaled
            x, z, y = it
            n, m = qs.shape[1], ls.shape[1]
            args_of = {"kkt": (Ps, As, eqf, rho_s, 1e-6, 1e3, blocks),
                       "adapt": (Ps, qs, As, x, z, y, rho_s, blocks),
                       "unscale": (*qp, x, y, D, E, c, stol, blocks)}
            nz = ((m // blocks[0]) * blocks[0] * blocks[1] if blocks
                  else m * n)
            if blocks is not None:
                lay = tail.kkt_layout(b, n, m, blocks, smem)
                pieces = tail.LAYOUT["kkt_pieces"]
                kd = {"shipped": ("shipped", lay.geometry),
                      "a value a piece": ("shipped", kkt_geometry(
                          b, n, lay.threads, pieces, 1)),
                      "16-byte pieces in registers": (
                          "16-byte pieces in registers", lay.geometry)}
                for t in (64, 256, 512):
                    kd[f"{t} threads"] = ("shipped", kkt_geometry(
                        b, n, t, pieces, lay.lanes))
                for name, p in TAIL_PIECES.items():
                    kd[name] = (name, kkt_geometry(b, n, lay.threads, p,
                                                   lay.lanes))
                K, rv = call("shipped", "kkt", args_of["kkt"], lay.geometry)
                Ko, rvo = tail.kkt_in_order(*args_of["kkt"])
                record("tail", what="bits", kernel="kkt", shape=shape, B=b,
                       design="shipped against kkt_in_order",
                       parted=parted((K, rv), (Ko, rvo)))
                A_b = As.expand(b, m, n)
                P_sig = Ps + 1e-6 * torch.eye(n, device=device)
                AtR = (A_b * rv[:, :, None]).transpose(1, 2)
                del K, rv, Ko, rvo
                designs = {name: (lambda lib=lib, g=g: call(
                               lib, "kkt", args_of["kkt"], g))
                           for name, (lib, g) in kd.items()}
                designs["first design"] = lambda: call(
                    "first design", "kkt", args_of["kkt"],
                    first_tail_geometry("kkt", b, n, m, n_sm))
                designs["library: torch.baddbmm"] = lambda: torch.baddbmm(
                    P_sig, AtR, A_b)
                designs["plain: _dense_kkt"] = lambda: admm._dense_kkt(
                    Ps, As, eqf, rho_s, 1e-6, 1e3)
                timed("kkt", shape, b, designs,
                      kkt_bound_ms(b, n, m, blocks, a_shared(As)), kd)
                del P_sig, AtR, A_b
                phases("kkt", shape, b, args_of["kkt"], lay.geometry, "tiles")
            # adapt_rho: the epilogue's layouts, beside those not chosen
            lay = tail.adapt_layout(n, m, b, smem, n_sm, blocks is None)
            kd = {"shipped": ("shipped", lay.geometry)}
            if lay.path == "warp":
                for w in (1, 2, 4, 8):
                    if 32 * w != lay.threads:
                        kd[f"{w} warps a block"] = (
                            "shipped", (32 * w, min(-(-b // w), n_sm), 2))
                w = lay.threads // 32
                kd["one slot, the lanes staging"] = (
                    "shipped", (lay.threads, -(-b // w), 1))
                kd["block path"] = ("shipped", (512, b, 32))
            else:
                for t in (256, 512, 1024):
                    if t != lay.threads:
                        kd[f"{t} threads"] = ("shipped", (t, b, 32))
                for name in ("adapt: 2 rows a group", "adapt: 8 rows a group",
                             "rows' loads by j"):
                    kd[name] = (name, lay.geometry)
            got = call("shipped", "adapt", args_of["adapt"], lay.geometry)
            ordered = tail.adapt_in_order(*args_of["adapt"], lanes=lay.lanes)
            record("tail", what="bits", kernel="adapt", shape=shape, B=b,
                   design="shipped against adapt_in_order",
                   parted=parted(got, (ordered,)))
            del got, ordered
            designs = {name: (lambda lib=lib, g=g: call(
                           lib, "adapt", args_of["adapt"], g))
                       for name, (lib, g) in kd.items()}
            designs["first design"] = lambda: call(
                "first design", "adapt", args_of["adapt"],
                first_tail_geometry("adapt", b, n, m, n_sm))
            designs["plain: _adapt_rho"] = lambda: admm._adapt_rho(
                *args_of["adapt"][:7])
            timed("adapt", shape, b, designs,
                  tail_bound_ms(b, n, m, nz, a_shared(As), False), kd)
            phases("adapt", shape, b, args_of["adapt"], lay.geometry,
                   lay.path)
            # unscale
            lay = tail.tail_layout(n, m, b, smem, n_sm, blocks is None)
            kd = {"shipped": ("shipped", lay.geometry)}
            if lay.path == "warp":
                for w in (1, 2, 4, 8):
                    if 32 * w != lay.threads:
                        kd[f"{w} warps a block"] = (
                            "shipped", (32 * w, min(-(-b // w), n_sm), 2))
                w = lay.threads // 32
                if -(-b // w) > lay.blocks:
                    kd["a scenario a warp"] = ("shipped",
                                               (lay.threads, -(-b // w), 2))
                kd["one slot, the lanes staging"] = (
                    "shipped", (lay.threads, -(-b // w), 1))
                kd["block path"] = ("shipped", (512, b, 32))
                kd["block path, 128 threads"] = ("shipped", (128, b, 32))
            else:
                for t in (256, 512, 1024):
                    if t != lay.threads:
                        kd[f"{t} threads"] = ("shipped", (t, b, 32))
                for name in ("1 row a group", "4 rows a group",
                             "rows' loads by j", "a ring of 3 chunks of 32 "
                             "rows", "a ring of 4 chunks of 16 rows"):
                    kd[name] = (name, lay.geometry)
            got = call("shipped", "unscale", args_of["unscale"],
                       lay.geometry)
            ordered = tail.unscale_in_order(*args_of["unscale"],
                                            lanes=lay.lanes)
            record("tail", what="bits", kernel="unscale", shape=shape, B=b,
                   design="shipped against unscale_in_order",
                   parted=parted(got, ordered))
            del got, ordered
            designs = {name: (lambda lib=lib, g=g: call(
                           lib, "unscale", args_of["unscale"], g))
                       for name, (lib, g) in kd.items()}
            designs["first design"] = lambda: call(
                "first design", "unscale", args_of["unscale"],
                first_tail_geometry("unscale", b, n, m, n_sm))
            designs["plain: _unscaled_solution"] = lambda: \
                admm._unscaled_solution(*args_of["unscale"][:11])
            timed("unscale", shape, b, designs,
                  tail_bound_ms(b, n, m, nz, a_shared(qp[2]), True), kd)
            phases("unscale", shape, b, args_of["unscale"], lay.geometry,
                   lay.path)
        del problems
        torch.cuda.empty_cache()



# The first design of kkt_blocks and unscale (and of adapt_rho, which kept
# it): qp/csrc/solve_tail.h and solve_tail.cu before their redesign,
# less their head comments, built as a patched copy.  kkt_blocks: a
# thread a run of four consecutive entries of K over the whole batch, a
# grid-stride loop; adapt_rho and unscale: a block a scenario.
FIRST_TAIL_H = r"""#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define TAIL_FN __host__ __device__ __forceinline__
#else
#define TAIL_FN inline
#endif

// the units of a phase: on the card this thread's, on the host all of them
#define TAIL_UNITS(ex, u, count)                                            \
    for (long long u = (ex).first(count); u >= 0 && u < (count);            \
         u = (ex).next(u))

namespace tail {

constexpr int PARTS = 32;       // partial maxima a quantity, one a unit
constexpr int MAXIMA = 7;       // adapt_rho's seven inf-norms
constexpr int MAX_LANES = 32;   // units (partial sums) a row of P at most
constexpr int KKT_RUN = 4;      // kkt_blocks: consecutive entries a unit

// ---- operands, in the order of the launchers' arrays
enum KktIn { KI_P, KI_A, KI_EQF, KI_RHO_S, KI_COUNT };
enum KktOut { KO_K, KO_RHO_VEC, KO_COUNT };
// sigma; rho_eq_scale - 1 (as the plain version's Python number)
enum KktPar { KP_SIGMA, KP_EQ_M1, KP_COUNT };
enum AdaptIn { AI_P, AI_Q, AI_A, AI_X, AI_Z, AI_Y, AI_RHO_S, AI_COUNT };
enum AdaptOut { AO_RHO_S, AO_COUNT };
enum UnIn { UI_P, UI_Q, UI_A, UI_L, UI_U, UI_XS, UI_YS, UI_D, UI_E, UI_C,
            UI_COUNT };
enum UnOut { UO_X, UO_Y, UO_Z, UO_PRIM, UO_DUAL, UO_OK, UO_COUNT };
enum UnPar { UP_STATUS_TOL, UP_COUNT };

// inputs, outputs, parameters of the three stages, the partial maxima,
// the partial sums a row (qp/tail.py::LAYOUT; -1 past the end)
inline int layout(int what)
{
    const int counts[] = {KI_COUNT, KO_COUNT, KP_COUNT, AI_COUNT, AO_COUNT,
                          UI_COUNT, UO_COUNT, UP_COUNT, PARTS, MAX_LANES};
    return what >= 0 && what < (int)(sizeof(counts) / sizeof(int))
               ? counts[what] : -1;
}

// values of a scenario's shared memory (adapt_rho: doubles; unscale: T):
// x (n), y (m), two m-vectors (A x; A x - z), two n-vectors (P x, A' y),
// the partial maxima and the `lanes` partial sums of each of P's rows and,
// when A is dense (`dense` 1), of A's rows
TAIL_FN long long smem_values(int n, int m, int dense, int lanes)
{
    return 3LL * n + 3LL * m + (long long)MAXIMA * PARTS
           + (long long)lanes * (n + (dense ? m : 0));
}

// A's structure: r x c blocks tiling (m, n), or dense (r = c = 0); the
// units a row of P (and of a dense A) is split over (1 or MAX_LANES)
struct Shape {
    int n, m, r, c, lanes;
    TAIL_FN bool blocks() const { return r > 0; }
};

template <typename T, int NI, int NO, int NP>
struct Args {
    const T* in[NI];
    long long stride[NI];
    T* out[NO];
    unsigned char* ok;      // unscale's ok (bytes); null elsewhere
    T par[NP > 0 ? NP : 1];

    TAIL_FN const T* row(int k, long long b) const
    {
        return in[k] + b * stride[k];
    }
};

template <typename T> using KktArgs = Args<T, KI_COUNT, KO_COUNT, KP_COUNT>;
template <typename T> using AdaptArgs = Args<T, AI_COUNT, AO_COUNT, 0>;
template <typename T> using UnArgs = Args<T, UI_COUNT, UO_COUNT - 1, UP_COUNT>;

// the launchers' arrays into Args (unscale's ok, its last output, is set
// by its launcher)
template <typename T, int NI, int NO, int NP>
inline void fill(Args<T, NI, NO, NP>& a, const void* const* in,
                 const long long* stride, void* const* out,
                 const double* par)
{
    for (int k = 0; k < NI; ++k) {
        a.in[k] = static_cast<const T*>(in[k]);
        a.stride[k] = stride[k];
    }
    for (int k = 0; k < NO; ++k) a.out[k] = static_cast<T*>(out[k]);
    a.ok = nullptr;
    for (int k = 0; k < NP; ++k) a.par[k] = (T)par[k];
}

// |v| and a NaN-propagating maximum (torch.amax, torch.maximum)
TAIL_FN float t_abs(float v) { return fabsf(v); }
TAIL_FN double t_abs(double v) { return fabs(v); }
TAIL_FN float t_sqrt(float v) { return sqrtf(v); }
TAIL_FN double t_sqrt(double v) { return sqrt(v); }
TAIL_FN bool t_finite(float v) { return isfinite(v); }
TAIL_FN bool t_finite(double v) { return isfinite(v); }
template <typename T>
TAIL_FN T nanmax(T a, T b)
{
    return (a != a || a > b) ? a : b;
}
template <typename T>
TAIL_FN T nanmin(T a, T b)
{
    return (a != a || a < b) ? a : b;
}

// ---- kkt_blocks: K's B n n entries in runs of KKT_RUN, then rho_vec's B m

template <typename T>
TAIL_FN T rho_of(const KktArgs<T>& a, long long b, int k)
{
    // (1 + eqf (s - 1)) rho_s, the plain version's three rounded ops
    const T t = T(1) + a.row(KI_EQF, b)[k] * a.par[KP_EQ_M1];
    return t * a.row(KI_RHO_S, b)[0];
}

// K[b, i, j]: the block's r terms in order, then P's entry, then sigma on
// the diagonal (the plain version's sum, then `+= P`, then the diagonal)
template <typename T>
TAIL_FN T kkt_value(const KktArgs<T>& a, const Shape& s, long long b, int i,
                    int j)
{
    const T* P = a.row(KI_P, b);
    T v = T(0);
    if (i / s.c == j / s.c) {
        const T* A = a.row(KI_A, b);
        const int k0 = (i / s.c) * s.r;
        for (int kk = 0; kk < s.r; ++kk) {
            const int k = k0 + kk;
            const T t = A[(long long)k * s.n + i] * rho_of(a, b, k);
            v = v + t * A[(long long)k * s.n + j];
        }
    }
    v = v + P[(long long)i * s.n + j];
    if (i == j) v = v + a.par[KP_SIGMA];
    return v;
}

// a unit is KKT_RUN consecutive entries of K over the batch (the last one
// may be shorter), then rho_vec's entries one a unit: a thread keeps
// KKT_RUN loads of P in flight
template <typename T, class Exec>
TAIL_FN void kkt_blocks(const Exec& ex, const KktArgs<T>& a, const Shape& s,
                        long long B)
{
    const long long nn = (long long)s.n * s.n, nK = B * nn;
    const long long runs = (nK + KKT_RUN - 1) / KKT_RUN;
    TAIL_UNITS(ex, u, runs + B * s.m) {
        if (u < runs) {
            const long long e0 = u * KKT_RUN;
            long long b = e0 / nn;
            int i = (int)((e0 % nn) / s.n), j = (int)(e0 % s.n);
            T v[KKT_RUN];
            for (int t = 0; t < KKT_RUN; ++t) {
                v[t] = e0 + t < nK ? kkt_value(a, s, b, i, j) : T(0);
                if (++j == s.n) {
                    j = 0;
                    if (++i == s.n) {
                        i = 0;
                        ++b;
                    }
                }
            }
            for (int t = 0; t < KKT_RUN; ++t)
                if (e0 + t < nK) a.out[KO_K][e0 + t] = v[t];
        } else {
            const long long f = u - runs;
            a.out[KO_RHO_VEC][f] = rho_of(a, f / s.m, (int)(f % s.m));
        }
    }
}

// ---- the dot products of one scenario (adapt_rho and unscale)
//
// A row of P (and of a dense A) is L units (s.lanes, 1 or MAX_LANES, a
// template constant): unit (row, l) sums the terms j = l, l + L, ... in
// order into its partial, so that a warp's units read one row's
// consecutive entries (L = 32, long rows; a unit a row for short ones,
// L = 1); the next phase sums a row's partials in order.  A block row of A (c terms) and a column of A'
// (a column block's r rows, or all m) are one unit each.

// The products are taken in the accumulator type V (the value type of the
// scenario's shared memory): T for unscale, double for adapt_rho.

// (A x)_k over row k's block columns
template <typename V, typename T>
TAIL_FN V a_block_row_dot(const T* A, const Shape& s, int k, const V* x)
{
    const int j0 = (k / s.r) * s.c;
    V v = V(0);
    for (int j = j0; j < j0 + s.c; ++j)
        v = v + V(A[(long long)k * s.n + j]) * x[j];
    return v;
}

// (A' y)_j: over column j's block rows, or all m
template <typename V, typename T>
TAIL_FN V a_col_dot(const T* A, const Shape& s, int j, const V* y)
{
    const int k0 = s.blocks() ? (j / s.c) * s.r : 0;
    const int k1 = s.blocks() ? k0 + s.r : s.m;
    V v = V(0);
    for (int k = k0; k < k1; ++k)
        v = v + V(A[(long long)k * s.n + j]) * y[k];
    return v;
}

// lane l's partial of row `row` of M (n columns) against x
template <int L, typename V, typename T>
TAIL_FN V lane_partial(const T* M, int n, int row, int l, const V* x)
{
    V v = V(0);
    for (int j = l; j < n; j += L)
        v = v + V(M[(long long)row * n + j]) * x[j];
    return v;
}

template <int L, typename V>
TAIL_FN V sum_lanes(const V* part)
{
    V v = part[0];
    for (int l = 1; l < L; ++l) v = v + part[l];
    return v;
}

// shared memory of a scenario
template <typename T>
struct Smem {
    T* x;      // n
    T* y;      // m
    T* ax;     // m: A x
    T* dz;     // m: A x - z
    T* px;     // n: P x
    T* aty;    // n: A' y
    T* part;   // MAXIMA x PARTS
    T* lanes;  // (n + dense rows of A) x s.lanes
    TAIL_FN Smem(T* base, int n, int m)
        : x(base), y(x + n), ax(y + m), dz(ax + m), px(dz + m), aty(px + n),
          part(aty + n), lanes(part + MAXIMA * PARTS)
    {
    }
};

// rows of the lane-split products: P's n, and A's m when A is dense
TAIL_FN int split_rows(const Shape& s) { return s.n + (s.blocks() ? 0 : s.m); }

// phase of the products: lane partials of P's rows (and a dense A's), the
// block rows of A, the columns of A'
template <int L, typename V, typename T, class Exec>
TAIL_FN void products(const Exec& ex, const Shape& s, const T* P,
                      const T* A, Smem<V>& S)
{
    const int n = s.n, m = s.m;
    const long long split = (long long)split_rows(s) * L;
    const long long rows = s.blocks() ? m : 0;
    TAIL_UNITS(ex, u, split + rows + n) {
        if (u < split) {
            const int row = (int)(u / L), l = (int)(u % L);
            S.lanes[u] = row < n ? lane_partial<L>(P, n, row, l, S.x)
                                 : lane_partial<L>(A, n, row - n, l, S.x);
        } else if (u < split + rows) {
            const int k = (int)(u - split);
            S.ax[k] = a_block_row_dot(A, s, k, S.x);
        } else {
            const int j = (int)(u - split - rows);
            S.aty[j] = a_col_dot(A, s, j, S.y);
        }
    }
}

// max in V over the entries e = p, p + PARTS, ... of v(e),
// NaN-propagating, from 0 (every quantity is an absolute value)
#define TAIL_PART_MAX(V, p, count, expr)                                    \
    [&]() {                                                                 \
        V acc = V(0);                                                       \
        for (int e = (int)(p); e < (count); e += PARTS)                     \
            acc = nanmax(acc, (expr));                                      \
        return acc;                                                         \
    }()

template <typename V>
TAIL_FN V max_parts(const V* part)
{
    V v = part[0];
    for (int p = 1; p < PARTS; ++p) v = nanmax(v, part[p]);
    return v;
}

// ---- adapt_rho: one scenario b
//
// In double whatever T is: the dual residual's numerator cancels (on the
// MPC's QP the swing forces' ridge makes |P x| up to 1e6 times the
// residual), so float32 sums in any order leave rho a few percent from
// the function's value; summed in double from the float32 inputs and
// rounded once, rho is that value to T's rounding.

template <int L, typename T, class Exec>
TAIL_FN void adapt_rho_body(const Exec& ex, const AdaptArgs<T>& a,
                            const Shape& s, long long b, double* smem)
{
    using D = double;
    const int n = s.n, m = s.m;
    Smem<D> S(smem, n, m);
    const T* P = a.row(AI_P, b);
    const T* q = a.row(AI_Q, b);
    const T* A = a.row(AI_A, b);
    const T* z = a.row(AI_Z, b);
    TAIL_UNITS(ex, u, n + m) {
        if (u < n) S.x[u] = D(a.row(AI_X, b)[u]);
        else S.y[u - n] = D(a.row(AI_Y, b)[u - n]);
    }
    ex.sync();
    products<L>(ex, s, P, A, S);
    ex.sync();
    TAIL_UNITS(ex, u, split_rows(s)) {
        if (u < n) S.px[u] = sum_lanes<L>(S.lanes + u * L);
        else S.ax[u - n] = sum_lanes<L>(S.lanes + u * L);
    }
    ex.sync();
    // the seven inf-norms, PARTS units each
    TAIL_UNITS(ex, u, MAXIMA * PARTS) {
        const int w = (int)u / PARTS, p = (int)u % PARTS;
        D v;
        switch (w) {
        case 0: v = TAIL_PART_MAX(D, p, m, t_abs(S.ax[e] - D(z[e]))); break;
        case 1: v = TAIL_PART_MAX(D, p, m, t_abs(S.ax[e])); break;
        case 2: v = TAIL_PART_MAX(D, p, m, t_abs(D(z[e]))); break;
        case 3:
            v = TAIL_PART_MAX(D, p, n,
                              t_abs((S.px[e] + D(q[e])) + S.aty[e]));
            break;
        case 4: v = TAIL_PART_MAX(D, p, n, t_abs(S.px[e])); break;
        case 5: v = TAIL_PART_MAX(D, p, n, t_abs(D(q[e]))); break;
        default: v = TAIL_PART_MAX(D, p, n, t_abs(S.aty[e])); break;
        }
        S.part[u] = v;
    }
    ex.sync();
    TAIL_UNITS(ex, u, 1) {
        D mx[MAXIMA];
        for (int w = 0; w < MAXIMA; ++w) mx[w] = max_parts(S.part + w * PARTS);
        const D tiny = D(T(1e-12));
        const D rp = mx[0] / nanmax(nanmax(mx[1], mx[2]), tiny);
        const D rd = mx[3] / nanmax(nanmax(mx[4], nanmax(mx[5], mx[6])),
                                    tiny);
        const D r = D(a.row(AI_RHO_S, b)[0]) * t_sqrt(rp / nanmax(rd, tiny));
        a.out[AO_RHO_S][b] = T(nanmin(nanmax(r, D(T(1e-3))), D(T(1e3))));
    }
}

// ---- unscale: one scenario b

template <int L, typename T, class Exec>
TAIL_FN void unscale_body(const Exec& ex, const UnArgs<T>& a, const Shape& s,
                          long long b, T* smem)
{
    const int n = s.n, m = s.m;
    Smem<T> S(smem, n, m);
    const T* P = a.row(UI_P, b);
    const T* q = a.row(UI_Q, b);
    const T* A = a.row(UI_A, b);
    TAIL_UNITS(ex, u, n + m) {
        if (u < n) {
            const T x = a.row(UI_D, b)[u] * a.row(UI_XS, b)[u];
            S.x[u] = x;
            a.out[UO_X][b * n + u] = x;
        } else {
            const int k = (int)u - n;
            const T y = (a.row(UI_E, b)[k] * a.row(UI_YS, b)[k])
                        / a.row(UI_C, b)[0];
            S.y[k] = y;
            a.out[UO_Y][b * m + k] = y;
        }
    }
    ex.sync();
    products<L>(ex, s, P, A, S);
    ex.sync();
    // P x; A x of a dense A; z = clip(A x, l, u) and A x - z
    TAIL_UNITS(ex, u, n + m) {
        if (u < n) {
            S.px[u] = sum_lanes<L>(S.lanes + u * L);
        } else {
            const int k = (int)u - n;
            const T ax = s.blocks() ? S.ax[k] : sum_lanes<L>(S.lanes + u * L);
            const T zu = nanmin(nanmax(ax, a.row(UI_L, b)[k]),
                                a.row(UI_U, b)[k]);
            a.out[UO_Z][b * m + k] = zu;
            S.dz[k] = ax - zu;
        }
    }
    ex.sync();
    // prim, dual and x's finiteness (1 where finite), PARTS units each
    TAIL_UNITS(ex, u, 3 * PARTS) {
        const int w = (int)u / PARTS, p = (int)u % PARTS;
        T v;
        if (w == 0) {
            v = TAIL_PART_MAX(T, p, m, t_abs(S.dz[e]));
        } else if (w == 1) {
            v = TAIL_PART_MAX(T, p, n, t_abs((S.px[e] + q[e]) + S.aty[e]));
        } else {
            v = T(1);
            for (int e = p; e < n; e += PARTS)
                if (!t_finite(S.x[e])) v = T(0);
        }
        S.part[u] = v;
    }
    ex.sync();
    TAIL_UNITS(ex, u, 1) {
        const T prim = max_parts(S.part);
        const T dual = max_parts(S.part + PARTS);
        bool finite = true;
        for (int p = 0; p < PARTS; ++p) finite &= S.part[2 * PARTS + p] > T(0);
        a.out[UO_PRIM][b] = prim;
        a.out[UO_DUAL][b] = dual;
        a.ok[b] = finite && prim < a.par[UP_STATUS_TOL] ? 1 : 0;
    }
}

// the two row splits a layout takes (qp/tail.py::tail_layout): a unit a
// row (lanes 1) or MAX_LANES units a row, each a compile-time constant
template <typename T, class Exec>
TAIL_FN void adapt_rho(const Exec& ex, const AdaptArgs<T>& a, const Shape& s,
                       long long b, double* smem)
{
    if (s.lanes == MAX_LANES) adapt_rho_body<MAX_LANES>(ex, a, s, b, smem);
    else adapt_rho_body<1>(ex, a, s, b, smem);
}

template <typename T, class Exec>
TAIL_FN void unscale(const Exec& ex, const UnArgs<T>& a, const Shape& s,
                     long long b, T* smem)
{
    if (s.lanes == MAX_LANES) unscale_body<MAX_LANES>(ex, a, s, b, smem);
    else unscale_body<1>(ex, a, s, b, smem);
}

#if !defined(__CUDA_ARCH__)
// the host executor: one thread runs every unit of a phase, in order or
// reversed
struct HostExec {
    bool reverse;

    long long first(long long n) const { return reverse ? n - 1 : 0; }
    long long next(long long u) const { return reverse ? u - 1 : u + 1; }
    void sync() const {}
};
#endif

}  // namespace tail
"""

FIRST_TAIL_CU = r"""#include <cuda_runtime.h>

#include "solve_tail.h"

namespace {

// every entry of the batch over the grid
struct GridExec {
    __device__ long long first(long long) const
    {
        return (long long)blockIdx.x * blockDim.x + threadIdx.x;
    }
    __device__ long long next(long long u) const
    {
        return u + (long long)gridDim.x * blockDim.x;
    }
};

// one scenario's units over a block
struct BlockExec {
    __device__ long long first(long long) const { return threadIdx.x; }
    __device__ long long next(long long u) const { return u + blockDim.x; }
    __device__ void sync() const { __syncthreads(); }
};

template <typename T>
__global__ void __launch_bounds__(1024)
tail_kkt_kernel(const tail::KktArgs<T> a, const tail::Shape s, long long B)
{
    tail::kkt_blocks<T>(GridExec{}, a, s, B);
}

template <typename T>
__global__ void __launch_bounds__(1024)
tail_adapt_kernel(const tail::AdaptArgs<T> a, const tail::Shape s)
{
    extern __shared__ __align__(16) unsigned char smem[];
    tail::adapt_rho<T>(BlockExec{}, a, s, (long long)blockIdx.x,
                       reinterpret_cast<double*>(smem));
}

template <typename T>
__global__ void __launch_bounds__(1024)
tail_unscale_kernel(const tail::UnArgs<T> a, const tail::Shape s)
{
    extern __shared__ __align__(16) unsigned char smem[];
    tail::unscale<T>(BlockExec{}, a, s, (long long)blockIdx.x,
                     reinterpret_cast<T*>(smem));
}

bool bad_shape(int B, int n, int m, int r, int c, int threads, int blocks,
               int lanes)
{
    if (B < 1 || n < 1 || m < 0 || threads < 32 || threads > 1024
        || threads % 32 != 0 || blocks < 1
        || (lanes != 1 && lanes != tail::MAX_LANES))
        return true;
    if (r == 0 && c == 0) return false;
    // r x c blocks tiling (m, n)
    return r < 1 || c < 1 || m % r != 0 || n % c != 0 || m / r != n / c;
}

// a block a scenario, its shared memory smem_values of V
template <typename V, class Kernel, class A>
int launch_scenarios(Kernel kernel, const A& a, tail::Shape s, int B,
                     int threads, cudaStream_t stream)
{
    const long long smem = tail::smem_values(s.n, s.m, !s.blocks(), s.lanes)
                           * (long long)sizeof(V);
    int dev, optin;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    if (smem > optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, threads, (size_t)smem, stream>>>(a, s);
    return (int)cudaGetLastError();
}

template <typename T>
int kkt(const void* const* in, const long long* stride, void* const* out,
        const double* par, int B, tail::Shape s, int threads, int blocks,
        cudaStream_t stream)
{
    if (!s.blocks()) return (int)cudaErrorInvalidValue;
    tail::KktArgs<T> a;
    tail::fill(a, in, stride, out, par);
    tail_kkt_kernel<T><<<blocks, threads, 0, stream>>>(a, s, (long long)B);
    return (int)cudaGetLastError();
}

template <typename T>
int adapt(const void* const* in, const long long* stride, void* const* out,
          const double* par, int B, tail::Shape s, int threads,
          cudaStream_t stream)
{
    tail::AdaptArgs<T> a;
    tail::fill(a, in, stride, out, par);
    return launch_scenarios<double>(tail_adapt_kernel<T>, a, s, B, threads,
                                    stream);
}

template <typename T>
int unscale(const void* const* in, const long long* stride, void* const* out,
            const double* par, int B, tail::Shape s, int threads,
            cudaStream_t stream)
{
    tail::UnArgs<T> a;
    tail::fill(a, in, stride, out, par);
    a.ok = static_cast<unsigned char*>(out[tail::UO_OK]);
    return launch_scenarios<T>(tail_unscale_kernel<T>, a, s, B, threads,
                               stream);
}

bool null_in(const void* const* p, int count)
{
    for (int k = 0; k < count; ++k)
        if (p[k] == nullptr) return true;
    return false;
}

}  // namespace

extern "C" {

// solve_tail.h's counts (qp/tail.py::LAYOUT)
int solve_tail_layout(int what) { return tail::layout(what); }

// values (floats or doubles) of a scenario's shared memory
long long solve_tail_smem_values(int n, int m, int dense, int lanes)
{
    return tail::smem_values(n, m, dense, lanes);
}

int solve_tail_kkt_launch(int dtype, const void* const* in,
                          const long long* stride, void* const* out,
                          const double* par, int B, int n, int m, int r,
                          int c, int threads, int blocks, int lanes,
                          void* stream)
{
    if (bad_shape(B, n, m, r, c, threads, blocks, lanes)
        || null_in(in, tail::KI_COUNT)
        || null_in((const void* const*)out, tail::KO_COUNT))
        return (int)cudaErrorInvalidValue;
    const tail::Shape s{n, m, r, c, lanes};
    if (dtype == 0)
        return kkt<float>(in, stride, out, par, B, s, threads, blocks,
                          (cudaStream_t)stream);
    if (dtype == 1)
        return kkt<double>(in, stride, out, par, B, s, threads, blocks,
                           (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

int solve_tail_adapt_launch(int dtype, const void* const* in,
                            const long long* stride, void* const* out,
                            const double* par, int B, int n, int m, int r,
                            int c, int threads, int blocks, int lanes,
                            void* stream)
{
    if (bad_shape(B, n, m, r, c, threads, blocks, lanes) || blocks != B
        || null_in(in, tail::AI_COUNT)
        || null_in((const void* const*)out, tail::AO_COUNT))
        return (int)cudaErrorInvalidValue;
    const tail::Shape s{n, m, r, c, lanes};
    if (dtype == 0)
        return adapt<float>(in, stride, out, par, B, s, threads,
                            (cudaStream_t)stream);
    if (dtype == 1)
        return adapt<double>(in, stride, out, par, B, s, threads,
                             (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

int solve_tail_unscale_launch(int dtype, const void* const* in,
                              const long long* stride, void* const* out,
                              const double* par, int B, int n, int m, int r,
                              int c, int threads, int blocks, int lanes,
                              void* stream)
{
    if (bad_shape(B, n, m, r, c, threads, blocks, lanes) || blocks != B
        || null_in(in, tail::UI_COUNT)
        || null_in((const void* const*)out, tail::UO_COUNT))
        return (int)cudaErrorInvalidValue;
    const tail::Shape s{n, m, r, c, lanes};
    if (dtype == 0)
        return unscale<float>(in, stride, out, par, B, s, threads,
                              (cudaStream_t)stream);
    if (dtype == 1)
        return unscale<double>(in, stride, out, par, B, s, threads,
                               (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

const char* solve_tail_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
"""


# The first design of the MPC QP build: mpc/csrc/mpc_build.h and
# mpc_build.cu before the pipeline, verbatim, built as a patched copy: a
# block of 384 threads a scenario, its phases one after another between
# __syncthreads(), P after the whole recursion, all 12 rows of every Su
# block in shared memory (22,704 values at N = 16).
FIRST_MPC_BUILD_H = r"""// The per-scenario body of the MPC QP build kernel (mpc_build.cu):
// mpc/srb.py's `build_mpc_qp`, the condensed centroidal MPC QP (P, q, l, u)
// of one scenario over its horizon's structure.
//
// Plain C++: every function is marked MPCB_FN, `__host__ __device__` under
// nvcc and plain `inline` under a host compiler, so the tests build this
// very arithmetic with g++ and run it on the CPU
// (tests/test_torch_mpc_build_kernel.py).  The body runs in phases over
// units (`MPCB_UNITS(ex, u, count)`) with a barrier between phases
// (`ex.sync()`): on the card (mpc_build.cu's BlockExec) a block's threads
// take the units in turn and the barrier is __syncthreads(); on the host
// (HostExec) one thread runs every unit of a phase, in order or reversed.
// A unit never reads what another unit writes in its own phase.
//
// What it computes, per scenario (A_k = I + E_k is the one-step model of
// step k: dt I at (0:3, 6:9), M_k = dt Rz_k' at (3:6, 9:12); Q = diag(q)):
//
//   1. the N one-step models (srb_discrete): M_k, and B_k (rows 6:9 dt / m
//      per foot, rows 9:12 dt I_w^-1 [r_f]x with the closed-form inverse of
//      the world inertia Rz I_b Rz'), B_k kept as Su's diagonal block;
//   2. the drift: x_{k+1} = A_k x_k + c_k from x0, d_k = x_{k+1} - x_ref_k;
//      and Su's blocks Su_{k,j} = A_k ... A_{j+1} B_j (j < k), a thread a
//      column of B_j walking k;
//   3. backwards, S_{N-1} = Q, S_j = Q + A_{j+1}' S_{j+1} A_{j+1}, g_{N-1}
//      = Q d_{N-1}, g_j = Q d_j + A_{j+1}' g_{j+1}; W_j = S_j B_j and
//      q_j = B_j' g_j (the sums over B's nonzero rows 6:12);
//   4. P_ij = Su_{j,i}' W_j for i <= j, every entry a 12-term dot product of
//      a column of a Su block and a column of a W block, P_ji = P_ij' by the
//      same expression (so P is exactly symmetric); the diagonal
//      (P_ii + w_force) + pin, in the plain version's order; the bound rows
//      l and u by the plain version's selects on contacts > 0.5.
//
// Bits.  P and q are the plain version's function in another order of
// sums (its P is Su' diag(Q) Su by cuBLAS, not even exactly symmetric):
// held to it within a tolerance, in float32 against the float64 plain
// version.  Each dot product is a chain of fused multiply-adds in a fixed
// order (`dot12`), so two launches agree bit for bit and an entry and its
// mirror are the same value.  l and u are the plain version's bit for bit.
//
// Shapes: x0 (12), x_ref (N, 12), feet (N, 4, 3), contacts (N, 4), mass
// (1, optional) a scenario, each a first row plus a stride in elements (0
// for a row shared by every scenario); P (n, n), q (n), l, u (m)
// contiguous, n = 12 N, m = 20 N.

#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define MPCB_FN __host__ __device__ __forceinline__
#else
#define MPCB_FN inline
#endif

// the units of a phase: on the card this thread's, on the host all of them
#define MPCB_UNITS(ex, u, count)                                            \
    for (int u = (ex).first(count); u >= 0 && u < (count); u = (ex).next(u))

namespace mpcb {

constexpr int NX = 12;          // state
constexpr int NU = 12;          // input: four feet's forces
constexpr int FEET = 4;
constexpr int ROWS_PER_FOOT = 5;
constexpr int BLK = NX * NU;    // values of a 12 x 12 block
constexpr int THREADS = 384;    // a block's threads: two rows of P at once

// ---- operands, in the order of the launcher's arrays
enum In { IN_X0, IN_XREF, IN_FEET, IN_CONTACTS, IN_MASS, IN_COUNT };
enum Out { OUT_P, OUT_Q, OUT_L, OUT_U, OUT_COUNT };
// dt; c_8 = -dt g; w_force; the ridge w_pin; fz_min, fz_max; the finite
// infinity of the bounds; dt / model mass; 1 if the mass input is given;
// diag(Q) (12); the body inertia I_b (3 x 3, row-major)
enum Par { PAR_DT, PAR_C8, PAR_W_FORCE, PAR_W_PIN, PAR_FZ_MIN, PAR_FZ_MAX,
           PAR_INF, PAR_DT_OVER_M, PAR_HAS_MASS, PAR_Q,
           PAR_IB = PAR_Q + NX, PAR_COUNT = PAR_IB + 9 };

// inputs, outputs, parameters, threads a block (mpc/kernels.py::LAYOUT;
// -1 past the end)
inline int layout(int what)
{
    const int counts[] = {IN_COUNT, OUT_COUNT, PAR_COUNT, THREADS};
    return what >= 0 && what < (int)(sizeof(counts) / sizeof(int))
               ? counts[what] : -1;
}

// Su's blocks before block row j: block (j, i), j >= i, is tri(j) + i
MPCB_FN int tri(int j) { return j * (j + 1) / 2; }

// values of a scenario's shared memory: Su's N (N + 1) / 2 blocks, the N
// W_j, S and S A_j, the N M_k (3 x 3), the drifts d and the g_j (N x 12)
MPCB_FN long long smem_values(int N)
{
    return (long long)(tri(N) + N + 2) * BLK + 9LL * N + 2LL * NX * N;
}

template <typename T>
struct Smem {
    T* su;
    T* w;
    T* s;
    T* t;
    T* m;
    T* d;
    T* g;

    MPCB_FN Smem(T* base, int N)
        : su(base), w(su + (long long)tri(N) * BLK), s(w + N * BLK),
          t(s + BLK), m(t + BLK), d(m + 9 * N), g(d + NX * N)
    {
    }
};

template <typename T>
struct Args {
    const T* in[IN_COUNT];
    long long stride[IN_COUNT];
    T* out[OUT_COUNT];
    T par[PAR_COUNT];

    MPCB_FN const T* row(int k, long long b) const
    {
        return in[k] + b * stride[k];
    }
};

// the launcher's arrays -> Args (host side: the kernel takes Args by value)
template <typename T>
inline void fill(Args<T>& a, const void* const* in, const long long* stride,
                 void* const* out, const double* par)
{
    for (int k = 0; k < IN_COUNT; ++k) {
        a.in[k] = static_cast<const T*>(in[k]);
        a.stride[k] = stride[k];
    }
    for (int k = 0; k < OUT_COUNT; ++k) a.out[k] = static_cast<T*>(out[k]);
    for (int k = 0; k < PAR_COUNT; ++k) a.par[k] = (T)par[k];
}

MPCB_FN float mb_sin(float a) { return sinf(a); }
MPCB_FN double mb_sin(double a) { return sin(a); }
MPCB_FN float mb_cos(float a) { return cosf(a); }
MPCB_FN double mb_cos(double a) { return cos(a); }
MPCB_FN float mb_fma(float a, float b, float c) { return fmaf(a, b, c); }
MPCB_FN double mb_fma(double a, double b, double c) { return fma(a, b, c); }

// sum_e x[e sx] y[e sy] over the 12 rows, a chain of fused multiply-adds
// from e = 0: every entry of P and its mirror go through it alike
template <typename T>
MPCB_FN T dot12(const T* x, int sx, const T* y, int sy)
{
    T acc = x[0] * y[0];
    for (int e = 1; e < NX; ++e) acc = mb_fma(x[e * sx], y[e * sy], acc);
    return acc;
}

// v <- A_k v in place (rows 0:6 read only rows 6:12, which stay)
template <typename T>
MPCB_FN void apply_a(const T* M, T dt, T* v)
{
    for (int i = 0; i < 3; ++i) v[i] = v[i] + dt * v[6 + i];
    for (int i = 0; i < 3; ++i)
        v[3 + i] = v[3 + i] + (M[3 * i] * v[9] + M[3 * i + 1] * v[10]
                               + M[3 * i + 2] * v[11]);
}

// (A_k' v)[c] for v[e] = v[e * sv]: column c of A_k has its 1 and, for
// c in 6:9, dt at row c - 6, for c in 9:12, M_k's column c - 9 at rows 3:6
template <typename T>
MPCB_FN T at_entry(const T* M, T dt, const T* v, int sv, int c)
{
    if (c < 6) return v[c * sv];
    if (c < 9) return v[c * sv] + dt * v[(c - 6) * sv];
    const int m = c - 9;
    return v[c * sv] + (M[m] * v[3 * sv] + M[3 + m] * v[4 * sv]
                        + M[6 + m] * v[5 * sv]);
}

// ---- 1. step k's model as seen from foot f: B_k's columns 3f:3f+3 into
// Su's diagonal block k, and (f = 0) M_k
template <typename T>
MPCB_FN void model_unit(const Args<T>& a, long long b, int k, int f,
                        const Smem<T>& sm)
{
    const T* xr = a.row(IN_XREF, b) + k * NX;
    const T* ft = a.row(IN_FEET, b) + (k * FEET + f) * 3;
    const T dt = a.par[PAR_DT];
    const T* Ib = a.par + PAR_IB;
    const T c = mb_cos(xr[5]), s = mb_sin(xr[5]);
    const T R[9] = {c, -s, (T)0, s, c, (T)0, (T)0, (T)0, (T)1};
    // I_w = (Rz I_b) Rz'
    T X[9], W[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            X[3 * i + j] = R[3 * i] * Ib[j] + R[3 * i + 1] * Ib[3 + j]
                           + R[3 * i + 2] * Ib[6 + j];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            W[3 * i + j] = X[3 * i] * R[3 * j] + X[3 * i + 1] * R[3 * j + 1]
                           + X[3 * i + 2] * R[3 * j + 2];
    // qp/blockinv.py::inv3: the adjugate over the determinant
    const T A00 = W[4] * W[8] - W[5] * W[7];
    const T A01 = W[2] * W[7] - W[1] * W[8];
    const T A02 = W[1] * W[5] - W[2] * W[4];
    const T A10 = W[5] * W[6] - W[3] * W[8];
    const T A11 = W[0] * W[8] - W[2] * W[6];
    const T A12 = W[2] * W[3] - W[0] * W[5];
    const T A20 = W[3] * W[7] - W[4] * W[6];
    const T A21 = W[1] * W[6] - W[0] * W[7];
    const T A22 = W[0] * W[4] - W[1] * W[3];
    const T det = W[0] * A00 + W[1] * A10 + W[2] * A20;
    const T inv[9] = {A00 / det, A01 / det, A02 / det, A10 / det, A11 / det,
                      A12 / det, A20 / det, A21 / det, A22 / det};
    // [r]x, r = foot - p_ref
    const T r0 = ft[0] - xr[0], r1 = ft[1] - xr[1], r2 = ft[2] - xr[2];
    const T K[9] = {(T)0, -r2, r1, r2, (T)0, -r0, -r1, r0, (T)0};
    // dt / m: the model's (a parameter) or reciprocal(m) * dt (PyTorch's
    // Python number over a tensor)
    const T bv = a.par[PAR_HAS_MASS] != (T)0
                     ? ((T)1 / a.row(IN_MASS, b)[0]) * dt
                     : a.par[PAR_DT_OVER_M];
    T* Bk = sm.su + (long long)(tri(k) + k) * BLK;
    for (int j = 0; j < 3; ++j) {
        const int col = 3 * f + j;
        for (int e = 0; e < 6; ++e) Bk[e * NU + col] = (T)0;
        for (int e = 0; e < 3; ++e)
            Bk[(6 + e) * NU + col] = e == j ? bv : (T)0;
        for (int e = 0; e < 3; ++e)
            Bk[(9 + e) * NU + col] =
                dt * (inv[3 * e] * K[j] + inv[3 * e + 1] * K[3 + j]
                      + inv[3 * e + 2] * K[6 + j]);
    }
    if (f == 0)
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j)
                sm.m[9 * k + 3 * i + j] = dt * R[3 * j + i];
}

// ---- 2. column c of Su's block column i: B_i's column, then A_k applied
// for k = i + 1 ... N - 1, each written into block (k, i)
template <typename T>
MPCB_FN void su_unit(const Args<T>& a, int N, int i, int c, const Smem<T>& sm)
{
    const T dt = a.par[PAR_DT];
    T v[NX];
    const T* Bi = sm.su + (long long)(tri(i) + i) * BLK;
    for (int e = 0; e < NX; ++e) v[e] = Bi[e * NU + c];
    for (int k = i + 1; k < N; ++k) {
        apply_a(sm.m + 9 * k, dt, v);
        T* blk = sm.su + (long long)(tri(k) + i) * BLK;
        for (int e = 0; e < NX; ++e) blk[e * NU + c] = v[e];
    }
}

// the free response from x0 and its drift from the reference
template <typename T>
MPCB_FN void drift_unit(const Args<T>& a, int N, long long b,
                        const Smem<T>& sm)
{
    const T* x0 = a.row(IN_X0, b);
    const T* xr = a.row(IN_XREF, b);
    const T dt = a.par[PAR_DT];
    T x[NX];
    for (int e = 0; e < NX; ++e) x[e] = x0[e];
    for (int k = 0; k < N; ++k) {
        apply_a(sm.m + 9 * k, dt, x);
        x[8] = x[8] + a.par[PAR_C8];
        for (int e = 0; e < NX; ++e) sm.d[k * NX + e] = x[e] - xr[k * NX + e];
    }
}

// ---- 4. rows 12 i ... 12 i + 11 of P at column col
template <typename T>
MPCB_FN void p_unit(const Args<T>& a, int N, long long b, int i, int col,
                    const Smem<T>& sm)
{
    const int n = N * NU, j = col / NU, c = col % NU;
    T* P = a.out[OUT_P] + b * n * n + (long long)(NX * i) * n + col;
    if (j > i) {
        // P_ij[r][c] = Su_{j,i}[:, r] . W_j[:, c]
        const T* su = sm.su + (long long)(tri(j) + i) * BLK;
        T y[NX];
        for (int e = 0; e < NX; ++e) y[e] = sm.w[j * BLK + e * NU + c];
        for (int r = 0; r < NX; ++r)
            P[(long long)r * n] = dot12(su + r, NU, y, 1);
    } else if (j < i) {
        // P_ij = P_ji': P_ij[r][c] = Su_{i,j}[:, c] . W_i[:, r]
        const T* su = sm.su + (long long)(tri(i) + j) * BLK;
        T x[NX];
        for (int e = 0; e < NX; ++e) x[e] = su[e * NU + c];
        for (int r = 0; r < NX; ++r)
            P[(long long)r * n] = dot12(x, 1, sm.w + i * BLK + r, NU);
    } else {
        // the diagonal block B_i' S_i B_i: its upper triangle as above,
        // the lower one as the mirror's expression
        const T* su = sm.su + (long long)(tri(i) + i) * BLK;
        const T* w = sm.w + i * BLK;
        const T pin = a.par[PAR_W_PIN]
                      * ((T)1 - a.row(IN_CONTACTS, b)[i * FEET + c / 3]);
        for (int r = 0; r < NX; ++r) {
            T v = r <= c ? dot12(su + r, NU, w + c, NU)
                         : dot12(su + c, NU, w + r, NU);
            if (r == c) v = (v + a.par[PAR_W_FORCE]) + pin;
            P[(long long)r * n] = v;
        }
    }
}

// the pyramid rows of (step, foot) kf: stance feet get the friction
// pyramid and the normal-force box, swing feet free rows
template <typename T>
MPCB_FN void bounds_unit(const Args<T>& a, int N, long long b, int kf)
{
    const int m = N * FEET * ROWS_PER_FOOT;
    const bool stance = a.row(IN_CONTACTS, b)[kf] > (T)0.5;
    const T inf = a.par[PAR_INF], ninf = -a.par[PAR_INF], zero = (T)0;
    T* l = a.out[OUT_L] + b * m + ROWS_PER_FOOT * kf;
    T* u = a.out[OUT_U] + b * m + ROWS_PER_FOOT * kf;
    l[0] = ninf;
    l[1] = stance ? zero : ninf;
    l[2] = ninf;
    l[3] = stance ? zero : ninf;
    l[4] = stance ? a.par[PAR_FZ_MIN] : ninf;
    u[0] = stance ? zero : inf;
    u[1] = inf;
    u[2] = stance ? zero : inf;
    u[3] = inf;
    u[4] = stance ? a.par[PAR_FZ_MAX] : inf;
}

// ---- the scenario b, in phases over the executor's units; `base` holds
// smem_values(N) values
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <typename T, class Exec>
MPCB_FN void build_scenario(const Exec& ex, const Args<T>& a, int N,
                            long long b, T* base)
{
    const Smem<T> sm(base, N);
    const int n = N * NU;
    const T dt = a.par[PAR_DT];
    const T* Q = a.par + PAR_Q;
    T* q = a.out[OUT_Q] + b * n;

    MPCB_UNITS(ex, u, N * FEET) model_unit(a, b, u / FEET, u % FEET, sm);
    ex.sync();
    MPCB_UNITS(ex, u, N * NU + 1) {
        if (u < N * NU)
            su_unit(a, N, u / NU, u % NU, sm);
        else
            drift_unit(a, N, b, sm);
    }
    ex.sync();
    // S_{N-1} = Q, g_{N-1} = Q d_{N-1}
    MPCB_UNITS(ex, u, BLK + NX) {
        if (u < BLK)
            sm.s[u] = u / NU == u % NU ? Q[u / NU] : (T)0;
        else
            sm.g[(N - 1) * NX + u - BLK] =
                Q[u - BLK] * sm.d[(N - 1) * NX + u - BLK];
    }
    ex.sync();
    for (int j = N - 1;; --j) {
        const T* Bj = sm.su + (long long)(tri(j) + j) * BLK;
        const T* gj = sm.g + j * NX;
        const T* Mj = sm.m + 9 * j;
        // W_j = S_j B_j and q_j = B_j' g_j over B's rows 6:12; T = S_j A_j
        MPCB_UNITS(ex, u, 2 * BLK + NX) {
            if (u < BLK) {
                const int r = u / NU, c = u % NU;
                T v = sm.s[r * NX + 6] * Bj[6 * NU + c];
                for (int e = 7; e < NX; ++e)
                    v = v + sm.s[r * NX + e] * Bj[e * NU + c];
                sm.w[j * BLK + u] = v;
            } else if (u < 2 * BLK) {
                const int e = u - BLK;
                if (j > 0) sm.t[e] = at_entry(Mj, dt, sm.s + (e / NX) * NX,
                                              1, e % NX);
            } else {
                const int c = u - 2 * BLK;
                T v = Bj[6 * NU + c] * gj[6];
                for (int e = 7; e < NX; ++e) v = v + Bj[e * NU + c] * gj[e];
                q[NU * j + c] = v;
            }
        }
        if (j == 0) break;
        ex.sync();
        // S_{j-1} = Q + A_j' (S_j A_j), g_{j-1} = Q d_{j-1} + A_j' g_j
        MPCB_UNITS(ex, u, BLK + NX) {
            if (u < BLK) {
                const int r = u / NX, c = u % NX;
                const T qd = r == c ? Q[r] : (T)0;
                sm.s[u] = qd + at_entry(Mj, dt, sm.t + c, NX, r);
            } else {
                const int e = u - BLK;
                sm.g[(j - 1) * NX + e] = Q[e] * sm.d[(j - 1) * NX + e]
                                         + at_entry(Mj, dt, gj, 1, e);
            }
        }
        ex.sync();
    }
    ex.sync();
    MPCB_UNITS(ex, u, N * n + N * FEET) {
        if (u < N * n)
            p_unit(a, N, b, u / n, u % n, sm);
        else
            bounds_unit(a, N, b, u - N * n);
    }
}

#if !defined(__CUDA_ARCH__)
// the host executor: one thread runs every unit of a phase, in order or
// reversed
struct HostExec {
    bool reverse;

    int first(int n) const { return reverse ? n - 1 : 0; }
    int next(int u) const { return reverse ? u - 1 : u + 1; }
    void sync() const {}
};
#endif

}  // namespace mpcb
"""

FIRST_MPC_BUILD_CU = r"""// The MPC QP build in one launch — CUDA, sm_90a.
//
// Computes mpc/srb.py::build_mpc_qp's (P, q, l, u) for a batch: the N
// one-step SRB models, the condensation over the horizon and the QP's cost
// and bound rows (its constraint matrix is a constant the wrapper hands
// back as a stride-0 view).  The JAX package has no Pallas kernel here: it
// leaves this stage to XLA under `jax.jit` (mpctsid_tpu/mpc/srb.py:120).
// Run op by op the plain PyTorch chain is about 196 kernels a call (16
// steps of three torch.bmm, the stacks, the dense Su' diag(Q) Su, the
// bound selects), each 1.3-1.9 us of a CUDA graph's replay at B = 1; at
// B = 4096 its dense P is 58 GFLOP and Su 604 MB of traffic.
//
// What bounds it on this card: bytes.  Over the horizon's structure
// (each A_k is I plus two 3 x 3 blocks, Su block lower-triangular, Q
// diagonal) a scenario needs about 1 MFLOP, and writes P: 147 KB in
// float32 (192 x 192), 604 MB at B = 4096, 0.19 ms at 3.35 TB/s.
//
// Design (first): a block of 384 threads per scenario, the body of
// mpc_build.h (shared with the CPU tests' host executor) in phases between
// __syncthreads(): the models (a thread a step and foot), Su's 136 blocks
// (a thread a column of B_j walking the horizon) and the drift, the
// backward recursion of S_j and g_j (16 steps of two phases: a thread an
// entry), then P: a thread a (row block, column), its column of W_j or of a
// Su block in registers, writing 12 rows, so a warp stores 32 consecutive
// values of a row.  Su, W, S and the drifts stay in dynamic shared memory
// (mpcb::smem_values(16) = 22,704 values: 91 KB in float32, two blocks a
// multiprocessor; 182 KB in float64, one).  No atomics, every sum in a
// fixed order: two launches agree bit for bit.  float and double (the
// contract's float64 condensation).
//
// Launch: mpc_build_launch(dtype, B, N, in, stride, out, par, stream) with
// the arrays in mpc_build.h's In / Out / Par order (the mass input may be
// null when PAR_HAS_MASS is 0); dtype 0 float, 1 double.  Returns a
// cudaError_t (0 on success; cudaErrorInvalidValue when the shared memory
// of N does not fit the device); launches on `stream` and allocates
// nothing.

#include <cuda_runtime.h>

#include "mpc_build.h"

namespace {

struct BlockExec {
    __device__ int first(int) const { return (int)threadIdx.x; }
    __device__ int next(int u) const { return u + (int)blockDim.x; }
    __device__ void sync() const { __syncthreads(); }
};

template <typename T>
__global__ void __launch_bounds__(mpcb::THREADS)
mpc_build_kernel(const mpcb::Args<T> a, int N)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const BlockExec ex{};
    mpcb::build_scenario<T>(ex, a, N, (long long)blockIdx.x,
                            reinterpret_cast<T*>(smem));
}

template <typename T>
int launch(int B, int N, const void* const* in, const long long* stride,
           void* const* out, const double* par, cudaStream_t stream)
{
    mpcb::Args<T> a;
    mpcb::fill(a, in, stride, out, par);
    int dev, optin;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    const long long smem = mpcb::smem_values(N) * (long long)sizeof(T);
    if (smem > optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(mpc_build_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    mpc_build_kernel<T><<<B, mpcb::THREADS, (size_t)smem, stream>>>(a, N);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// mpc_build.h's counts (mpc/kernels.py::LAYOUT)
int mpc_build_layout(int what) { return mpcb::layout(what); }

// values (floats or doubles) of a block's shared memory at horizon N
long long mpc_build_smem_values(int N) { return mpcb::smem_values(N); }

int mpc_build_launch(int dtype, int B, int N, const void* const* in,
                     const long long* stride, void* const* out,
                     const double* par, void* stream)
{
    if (B < 1 || N < 1) return (int)cudaErrorInvalidValue;
    for (int k = 0; k < mpcb::IN_COUNT; ++k)
        if (in[k] == nullptr
            && (k != mpcb::IN_MASS || par[mpcb::PAR_HAS_MASS] != 0.0))
            return (int)cudaErrorInvalidValue;
    for (int k = 0; k < mpcb::OUT_COUNT; ++k)
        if (out[k] == nullptr) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch<float>(B, N, in, stride, out, par,
                             (cudaStream_t)stream);
    if (dtype == 1)
        return launch<double>(B, N, in, stride, out, par,
                              (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

const char* mpc_build_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--out", default=None)
    ap.add_argument("--kernels", nargs="+", default=PARTS, choices=PARTS)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smem, n_sm = kernels.device_limits(device)
    smi = smi_line()
    build = os.path.join(str(_build.build_dir()), "probe_kernel_designs")
    os.makedirs(build, exist_ok=True)
    B = a.batch
    report = {"card": smi, "batch": B, "m2": [], "vpu": [], "packed": [],
              "layouts": [],
              "variants": [], "cluster_phases": [], "fused": [], "spd": [],
              "plainwarp": [], "rbd": [], "ruiz": [], "mpcbuild": [],
              "tail": []}

    def record(kind, **row):
        report[kind].append(row)
        print(f"  {kind}: {row}", flush=True)

    print(f"[{smi}] B={B}", flush=True)
    if "m2" in a.kernels:
        probe_m2(record, B, device, smem, build)
        torch.cuda.empty_cache()
    if "vpu" in a.kernels:
        probe_vpu(record, B, device, smem, n_sm, build)
    if "packed" in a.kernels:
        probe_packed(record, B, device, smem, n_sm, build)
    if "mma" in a.kernels:
        probe_mma(record, B, device, smem, n_sm, build)
    if "fused" in a.kernels:
        torch.cuda.empty_cache()
        probe_fused(record, B, device, smem, n_sm, build)
    if "spd" in a.kernels:
        torch.cuda.empty_cache()
        probe_spd(record, B, device, smem, n_sm, build)
    if "plainwarp" in a.kernels:
        probe_plainwarp(record, B, device, smem, n_sm, build)
    rbd_parts = [{"build": "wbc_build", "plant": "plant_step"}[k]
                 for k in ("build", "plant") if k in a.kernels]
    if rbd_parts:
        probe_rbd(record, rbd_parts, B, device, build)
    if "ruiz" in a.kernels:
        torch.cuda.empty_cache()
        probe_ruiz(record, B, device, smem, n_sm, build)
    if "mpcbuild" in a.kernels:
        torch.cuda.empty_cache()
        probe_mpc_build(record, B, device, build)
    if "tail" in a.kernels:
        torch.cuda.empty_cache()
        probe_tail(record, B, device, smem, n_sm, build)

    if a.out:
        os.makedirs(a.out, exist_ok=True)
        with open(os.path.join(a.out, "probe_kernel_designs.json"),
                  "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
