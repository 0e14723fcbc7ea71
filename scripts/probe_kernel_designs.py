#!/usr/bin/env python3
"""Where the time of the redesigned kernels goes: the M2 iteration
(admm_m2.cu), the generic refined iteration (admm_vpu.cu), the tensor-core
iteration (admm_mma.cu), the whole solve (admm_fused.cu), kernels B
(spd_inverse.cu) and A (admm_fused.cu's plain-backend solve), the WBC build
and the plant step (dyn/csrc/).

    python3 scripts/probe_kernel_designs.py [--batch 4096] [--out DIR]
        [--kernels m2 vpu packed mma fused spd plainwarp build plant ruiz]

Needs an NVIDIA GPU and nvcc.  All times are CUDA events at the main path's
shapes (WBC: n = 30, m = 50, 13 iterations, the whole solve 40 in 3 rounds;
MPC: n = 192, m = 320, 30 iterations), each with the card's name and power
limit.  `--kernels` picks the parts (default: all ten):

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
         "plant", "ruiz"]
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
                  header_subs=None, csrc=None):
    """A copy of `source` (and of the headers named in `header_subs`, a dict
    header -> substitutions; a callable there maps the header's whole text)
    with the (old, new) text substitutions applied, in its own directory;
    returns the nvcc command that builds it beside the real library (the
    copy's directory first on the include path, so the patched headers win)
    and the library's path."""
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
    return [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", vdir, "-I",
            str(csrc), "-o", so, os.path.join(vdir, source)], so


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
              "plainwarp": [], "rbd": [], "ruiz": []}

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

    if a.out:
        os.makedirs(a.out, exist_ok=True)
        with open(os.path.join(a.out, "probe_kernel_designs.json"),
                  "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
