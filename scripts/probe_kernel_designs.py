#!/usr/bin/env python3
"""Where the time of the two redesigned kernels goes: the tensor-core
iteration (admm_mma.cu) and the whole solve (admm_fused.cu).

    python3 scripts/probe_kernel_designs.py [--batch 4096] [--out DIR]

Needs an NVIDIA GPU and nvcc.  All times are CUDA events at the main path's
shapes (WBC: n = 30, m = 50, 13 iterations, the whole solve 40 in 3 rounds;
MPC: n = 192, m = 320, 30 iterations), each with the card's name and power
limit:

  1. layouts (admm_mma.cu): the launcher is called with geometries other
     than the one `kernels.mma_layout` chooses (row stride and scenarios per
     block on the warp path; row stride, threads per block and cluster size
     on the cluster path), to show what the choice is worth, and with
     fewer scenarios (one wave of blocks, several);
  2. variants (admm_mma.cu): copies of the source patched by text
     substitution and built beside the real library (the shipped source has
     no switch): the tile products skipped or stripped of one part at a
     time, the TF32 rounding done by the conversion instruction, a
     whole-cluster barrier added to every exchange, and a copy of the
     cluster path that reads the cycle counter after every product, block
     barrier and exchange of an iteration.  Their RESULTS ARE WRONG on purpose; only their times are
     read, to split the kernel's time into products, barriers, exchange
     and rounding;
  3. fused (admm_fused.cu): the whole solve with fewer iterations, rounds
     and Ruiz passes (what each part costs), with other numbers of
     scenarios per block, and a patched copy that reads the cycle counter at
     every phase boundary of one warp (the share of each phase of a round).

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

from mpctsid_tpu_torch.qp import _build, kernels  # noqa: E402

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


def build_variant(name, subs, out_dir, source="admm_mma.cu"):
    src = (_build.CSRC / source).read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"variant {name!r}: pattern not in the "
                               f"source: {old!r}")
        src = src.replace(old, new)
    tag = "".join(c if c.isalnum() else "_" for c in name)
    cu = os.path.join(out_dir, f"{source[:-3]}_{tag}.cu")
    so = os.path.join(out_dir, f"lib{source[:-3]}_{tag}.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", so, cu], check=True,
                   capture_output=True)
    return ctypes.CDLL(so)


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
MARKS = [
    "        // row `lane` of K = P + sigma I + (A rho)' A, in registers\n",
    "        // Jacobi scaling: row `lane` of Ks = s K s, kept in registers",
    "        // Cholesky, left-looking column sweep: lane i forms entry",
    "        // L^-1 by forward substitution, row-major into the lower",
    "        // row `lane` of X0 = L^-T L^-1, in registers, then TRANSPOSED",
    "        // one Newton-Schulz step.  M = 2I - Ks X0 column by column:",
    "        // X = X0 M, the same way over M\n",
    "        // r1 = |I - Ks X|_F^2\n",
    "        // divergence safeguard (a NaN compares false: back to X0), "
    "then the\n        // finite safeguard (identity in the scaled frame); "
    "K^-1 = s X s\n",
    "        warp_refined_iterations(sW, sK, sA, ld, n, m, fp.iters_per,",
    "        if (round + 1 < fp.n_rounds) {\n            // scaled residual "
    "ratios -> rho_s\n            float m_axz = 0.f, m_ax = 0.f, m_z = 0.f;"
    "\n            for (int i = lane; i < m; i += 32) {\n                "
    "const float ax = dot_strided(",
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
    for k, anchor in enumerate(MARKS):
        subs.append((anchor, mark.format(k=(k - 1) % len(MARKS)) + anchor))
    subs.append(("    if (lane == 0) io.c_out[b] = c;\n",
                 "    if (lane == 0) io.c_out[b] = c;\n    if (lane == 0)\n"
                 "        for (int k_ = 0; k_ < 11; ++k_)\n            "
                 "io.e_out[(size_t)b * m + k_] = (float)prof_[k_];\n"))
    plib = build_variant("phase clocks", subs, build, source="admm_fused.cu")
    outs = fused_launch(plib, args, FUSED_KW, lay)
    torch.cuda.synchronize()
    cycles = outs[3][:, :11].double()            # (B, 11) over 3 rounds
    total = cycles.sum(dim=1, keepdim=True)
    share = (cycles / total).mean(dim=0)
    for k, name in enumerate(PHASES):
        record("fused", what="share of the rounds' cycles", phase=name,
               share=round(float(share[k]), 4),
               mean_cycles_per_solve=float(cycles[:, k].mean()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--out", default=None)
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
    report = {"card": smi, "batch": B, "layouts": [], "variants": [],
              "cluster_phases": [], "fused": []}

    real = launcher(kernels._library("admm_mma"))
    wbc = inputs(0, B, *WBC[:2], device)
    mpc = inputs(1, B, *MPC[:2], device)
    chosen = {"wbc": kernels.mma_layout(*WBC[:2], B, smem, n_sm),
              "mpc": kernels.mma_layout(*MPC[:2], B, smem, n_sm)}
    print(f"[{smi}] B={B}; chosen layouts: {chosen}", flush=True)

    def record(kind, **row):
        report[kind].append(row)
        print(f"  {kind}: {row}", flush=True)

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

    # ---- 3. the whole-solve kernel ------------------------------------------
    del wbc, mpc
    torch.cuda.empty_cache()
    probe_fused(record, B, device, smem, n_sm, build)

    if a.out:
        os.makedirs(a.out, exist_ok=True)
        with open(os.path.join(a.out, "probe_kernel_designs.json"),
                  "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
