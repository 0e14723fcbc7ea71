#!/usr/bin/env python3
"""The estimator's tick (`est_step`, dyn/csrc/est_step.cu over est_step.h)
in its designs, on the card.

    python3 scripts/probe_est_designs.py [--batch 4096] [--rounds 8]
        [--out DIR]

Needs an NVIDIA GPU and nvcc.  The designs, each built with nvcc as a copy
of the library beside the shipped one (-fmad=false, as the library):

  first design: a warp a scenario, lane 0 the attitude chain alone, then
     lanes 0-3 the legs' kinematics at the corrected configuration and
     their odometry terms, then the fusion a lane an entry.  Its
     est_step.h and est_step.cu live on here verbatim (`FIRST_EST_STEP_H`,
     `FIRST_EST_STEP_CU`; the CPU tests build its header with g++);
  (a) lanes a scenario, the legs after the attitude: the shipped block
     (S scenarios, warp 0 the attitude, warps 1-4 a leg each, lane s
     scenario s, the rows loaded and stored by the whole block) with the
     first design's arithmetic: a barrier after the attitude, then each
     leg at the corrected configuration, its term rotated back by R0'
     (`LEVER_A_LEG`, `lever_a_header`: a patched copy of the shipped
     header);
  (b) the shipped design: (a) with the legs in the base frame, beside the
     attitude (one phase, one barrier fewer);
  (b) at 16, at 8: the shipped design with at most 16 or 8 scenarios a
     block (a patched EST_MAX_S; two or four times the blocks at
     B = 4096);
  (b) unrolled: the shipped design with the loops it keeps rolled (the
     integration steps, the legs' levels, the copies) unrolled: what its
     code size costs, every instruction fetched cold.

On chip_smoke.py phase 3j's inputs (`est_inputs`), the tick (est_step):

  bits.  Each design against the plain chain (`estimator_tick_reference`)
     at B = 1, 37 and --batch, float32 and float64, with and without the
     hint: each output's error over its largest entry (phase 3j's
     tolerances, 1e-5 / 1e-12), two launches bit for bit, and the entries
     whose bits part from the first design's;
  times. Float32, B = 1, 256 and --batch, in interleaved rounds of CUDA
     graph replays (each design's one launch, the launch floor: a one-kernel
     graph, a `fill_` of one element), beside the bound
     (chip_smoke.py::est_step_bound_ms);
  phases. Clocked copies of the first design, (a) and (b): lane 0 of every
     warp reads the cycle counter (clock64) before and after every barrier
     and at the start and the end.  Cycles of each phase, mean over the
     warps (the first design) or the blocks (a, b): the attitude, the legs,
     the fusion, the stores, the load, the waits at the barriers, the
     whole; at B = 1, 256 and --batch.

Prints what each copy's ptxas reports (registers, stack, spills) and one
JSON object at the end; with --out also writes it to
DIR/probe_est_designs.json.  Exits 1 if a design leaves the tolerances.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
import probe_kernel_designs as pkd  # noqa: E402
from mpctsid_tpu_torch.cascade import CascadeConfigured  # noqa: E402
from mpctsid_tpu_torch.config import EngineConfig  # noqa: E402
from mpctsid_tpu_torch.dyn import kernels as dk  # noqa: E402
from mpctsid_tpu_torch.est import filter as est_mod  # noqa: E402
from mpctsid_tpu_torch.model.solo12 import SOLO12  # noqa: E402
from mpctsid_tpu_torch.qp import _build  # noqa: E402

BITS_B = (1, 37)          # and --batch
TIMED_B = (1, 256)        # and --batch
GAINS = (0.001, 0.02, 0.97, 0.05)   # dt, alpha_tilt, alpha_vel, alpha_z

FIRST = "first design: a warp a scenario"
LEVER_A = "(a) lanes a scenario, legs after the attitude"
SHIPPED = "(b) shipped: legs in the base frame beside the attitude"
AT_16 = "(b) at most 16 scenarios a block"
AT_8 = "(b) at most 8 scenarios a block"
UNROLLED = "(b) with its loops unrolled"

# ------------------------------------------------------- lever (a) alone

# the first design's leg arithmetic on the block: the leg's kinematics at
# the corrected configuration (the estimate's position, the attitude's
# quaternion, the joints; rbd.h's `kin_unit` op for op, in registers as the
# shipped leg's), the residual J_f[:, 3:] [gyro, qd] from the Jacobian's
# columns, rotated back by R0'; the foot in the world frame
LEVER_A_LEG = r'''template <typename T>
RBD_FN void leg_unit(int leg, const T* C, const T* qo, const T* vo,
                     EstRow<T>& r)
{
    T R0[9], Rp[9], pj[3][3], ax[3][3];
    quat_to_rot(qo + 3, R0);
    T pp[3] = {r.q[0], r.q[1], r.q[2]};
    for (int i = 0; i < 9; ++i) Rp[i] = R0[i];
    RBD_UNROLL
    for (int lvl = 0; lvl < 3; ++lvl) {
        T sn, cs, Rr[9], Rw[9], d[3];
        r_sincos(qo[7 + 3 * leg + lvl], &sn, &cs);
        const int a = axis_of(C, lvl);
        axis_rot(a, cs, sn, Rr);
        mv3(Rp, placement(C, lvl, leg), d);
        for (int i = 0; i < 3; ++i) {
            pp[i] = pp[i] + d[i];
            pj[lvl][i] = pp[i];
        }
        mm3(Rp, Rr, Rw);
        for (int i = 0; i < 3; ++i) ax[lvl][i] = pick3(Rw + 3 * i, a);
        for (int i = 0; i < 9; ++i) Rp[i] = Rw[i];
    }
    T d[3], pf[3];
    mv3(Rp, C + C_FOOT + 3 * leg, d);
    for (int i = 0; i < 3; ++i) pf[i] = pp[i] + d[i];
    const T* g = vo + 3;
    const T* qd = vo + 6 + 3 * leg;
    T e0[3], rr[3];
    for (int c = 0; c < 3; ++c) e0[c] = pf[c] - r.q[c];
    mtv3(R0, e0, rr);
    const T Sk[9] = {T(0), -rr[2], rr[1], rr[2], T(0), -rr[0],
                     -rr[1], rr[0], T(0)};
    T cols[3][3];
    RBD_UNROLL
    for (int lvl = 0; lvl < 3; ++lvl) {
        T e[3];
        for (int m = 0; m < 3; ++m) e[m] = pf[m] - pj[lvl][m];
        cross(ax[lvl], e, cols[lvl]);
    }
    T res[3];
    RBD_UNROLL
    for (int i = 0; i < 3; ++i) {
        T s = T(0);
        for (int j = 0; j < 3; ++j) {
            const T ang = -(R0[3 * i] * Sk[j] + R0[3 * i + 1] * Sk[3 + j]
                            + R0[3 * i + 2] * Sk[6 + j]);
            s = s + ang * g[j];
        }
        for (int lvl = 0; lvl < 3; ++lvl) s = s + cols[lvl][i] * qd[lvl];
        res[i] = s;
    }
    T t[3];
    mtv3(R0, res, t);
    for (int i = 0; i < 3; ++i) {
        r.odo[leg][i] = -t[i];
        r.foot[leg][i] = pf[i];
    }
}

'''
SHIPPED_PHASE_2 = (
    "    EST_EACH(ex, u, EST_THREADS) {\n"
    "        const int role = u / WARP, s = u % WARP;\n"
    "        if (s >= n) continue;\n"
    "        if (role == 0)\n"
    "            attitude_unit<IMU>(cs, a, rows[s], qs + s * NQ, vs + s * NV);\n"
    "        else\n"
    "            leg_unit(role - 1, cs, qs + s * NQ, vs + s * NV, rows[s]);\n"
    "    }\n"
    "    ex.sync();\n")
LEVER_A_PHASES = (
    "    EST_EACH(ex, u, EST_THREADS) {\n"
    "        const int role = u / WARP, s = u % WARP;\n"
    "        if (s >= n || role != 0) continue;\n"
    "        attitude_unit<IMU>(cs, a, rows[s], qs + s * NQ, vs + s * NV);\n"
    "    }\n"
    "    ex.sync();\n"
    "    EST_EACH(ex, u, EST_THREADS) {\n"
    "        const int role = u / WARP, s = u % WARP;\n"
    "        if (s >= n || role == 0) continue;\n"
    "        leg_unit(role - 1, cs, qs + s * NQ, vs + s * NV, rows[s]);\n"
    "    }\n"
    "    ex.sync();\n")
FOOT_HEIGHT = ("        const T z = r.q[2] + ((R0[6] * p[0] + R0[7] * p[1]) "
               "+ R0[8] * p[2]);\n")


def replace_once(src: str, old: str, new: str, what: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"{what}: pattern not found once: {old!r}")
    return src.replace(old, new)


def lever_a_header(src: str) -> str:
    """The shipped est_step.h with the first design's leg arithmetic after
    the attitude (LEVER_A_LEG; the fusion's foot height the world z)."""
    start = src.index("template <typename T>\nRBD_FN void leg_unit(int leg,")
    end = src.index("// sum c and max(sum c, 1e-6) of a contact row")
    src = src[:start] + LEVER_A_LEG + src[end:]
    src = replace_once(src, SHIPPED_PHASE_2, LEVER_A_PHASES, "lever (a)")
    return replace_once(src, FOOT_HEIGHT, "        const T z = p[2];\n",
                        "lever (a)")


def unrolled(src: str) -> str:
    """The shipped header with the loops it keeps rolled (the integration
    steps, the legs' levels, the copies) unrolled."""
    if "RBD_UNROLL_BY(1)" not in src:
        raise RuntimeError("unrolled: no RBD_UNROLL_BY(1) in est_step.h")
    return src.replace("RBD_UNROLL_BY(1)", "RBD_UNROLL")


def at_most(S: int):
    def sub(src: str) -> str:
        return replace_once(src, "constexpr int EST_MAX_S = 32;",
                            f"constexpr int EST_MAX_S = {S};", "EST_MAX_S")
    return sub


# ---------------------------------------------------------- the clocks

# lane 0 of every warp writes the cycle counter: stamp i of row (block,
# warp) of the launch; a design's barriers each take two, before and after
EST_STAMPS, EST_STAMP_ROWS = 12, 1 << 13
STAMP_DEF = f'''#include "rbd.h"

#if defined(__CUDACC__)
__device__ long long est_stamps[{EST_STAMPS} * {EST_STAMP_ROWS}];
#endif
__host__ __device__ __forceinline__ void est_stamp(int i)
{{
#if defined(__CUDA_ARCH__)
    const long long row =
        (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
    if ((threadIdx.x & 31) == 0 && row < {EST_STAMP_ROWS})
        est_stamps[row * {EST_STAMPS} + i] = clock64();
#endif
}}
'''
STAMP_ENTRIES = r'''
extern "C" int est_stamps_read(long long* out, int n)
{
    return (int)cudaMemcpyFromSymbol(out, est_stamps,
                                     n * sizeof(long long));
}

extern "C" int est_stamps_clear()
{
    void* p = nullptr;
    cudaError_t err = cudaGetSymbolAddress(&p, est_stamps);
    if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(est_stamps));
    return (int)err;
}
'''


def stamp_syncs(src: str, body_start: str, body_end: str,
                start_at: str, end_at: str) -> str:
    """`src` with the stamp definitions, stamp 0 before `start_at`, every
    `    ex.sync();` between body_start and body_end between stamps 2k + 1
    and 2k + 2, and the last stamp after `end_at`."""
    src = replace_once(src, '#include "rbd.h"\n', STAMP_DEF, "clock")
    i, j = src.index(body_start), src.index(body_end)
    body = src[i:j]
    parts = body.split("    ex.sync();\n")
    out = parts[0]
    for k, part in enumerate(parts[1:]):
        out += (f"    est_stamp({2 * k + 1});\n    ex.sync();\n"
                f"    est_stamp({2 * k + 2});\n" + part)
    last = 2 * (len(parts) - 1) + 1
    out = replace_once(out, start_at, "    est_stamp(0);\n" + start_at,
                       "clock start")
    out = replace_once(out, end_at, end_at + f"    est_stamp({last});\n",
                       "clock end")
    return src[:i] + out + src[j:]


BLOCK_START = "template <bool IMU, typename T, class Exec>\nRBD_FN void est_block("
BLOCK_CLOCK = dict(
    body_start=BLOCK_START, body_end="}  // namespace est",
    start_at="    copy_rows<C_FOOT + 12>(ex, C, 0, 1, cs, 0);\n",
    end_at=("        else store_piece(vs - mv, vout, mv, NV * n, p - pq);"
            "\n    }\n"))
FIRST_CLOCK = dict(
    body_start="template <bool IMU, typename T, class Exec>\n"
               "RBD_FN void est_warp(",
    body_end="}  // namespace est",
    start_at="    RBD_EACH_LANE(ex, lane) {\n        if (lane == 0) "
             "attitude_unit<IMU>(C, a, b, S);\n",
    end_at="    RBD_EACH_LANE(ex, lane) position_unit(lane, a, b, S);\n")


def variant_specs() -> dict:
    """name -> pkd.write_variant's keyword arguments of every copy built:
    the first design, (a), (b) at 16, and the clocked copies."""
    common = dict(source="est_step.cu", csrc=dk.CSRC,
                  flags=dk.FLAGS["est_step"])
    same = lambda s: s  # noqa: E731
    first_cu = lambda _: FIRST_EST_STEP_CU  # noqa: E731
    clocked_cu = lambda s: s + STAMP_ENTRIES  # noqa: E731
    return {
        FIRST: dict(subs=first_cu,
                    header_subs={"est_step.h": lambda _: FIRST_EST_STEP_H},
                    **common),
        LEVER_A: dict(subs=same, header_subs={"est_step.h": lever_a_header},
                      **common),
        AT_16: dict(subs=same, header_subs={"est_step.h": at_most(16)},
                    **common),
        AT_8: dict(subs=same, header_subs={"est_step.h": at_most(8)},
                   **common),
        UNROLLED: dict(subs=same, header_subs={"est_step.h": unrolled},
                       **common),
        "clock: " + FIRST: dict(
            subs=lambda _: FIRST_EST_STEP_CU + STAMP_ENTRIES,
            header_subs={"est_step.h": lambda _: stamp_syncs(
                FIRST_EST_STEP_H, **FIRST_CLOCK)}, **common),
        "clock: " + LEVER_A: dict(
            subs=clocked_cu, header_subs={"est_step.h": lambda s: stamp_syncs(
                lever_a_header(s), **BLOCK_CLOCK)}, **common),
        "clock: " + SHIPPED: dict(
            subs=clocked_cu, header_subs={"est_step.h": lambda s: stamp_syncs(
                s, **BLOCK_CLOCK)}, **common),
    }


def launcher(lib):
    """est_step_launch of a built copy on the current stream (the
    wrappers' `launch_fn`: the C signature less the stream)."""
    fn = lib.est_step_launch
    fn.argtypes = dk.LAUNCH_ARGTYPES + [dk._PTR]
    fn.restype = dk._INT
    return lambda *a: fn(*a, torch.cuda.current_stream().cuda_stream)


def checked(rc_out):
    rc, out = rc_out
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return out


def tick_fns(libs, tree, d, hint=None):
    """design -> a callable that launches its tick on the inputs `d`
    (chip_smoke.py's est_inputs) and returns (q', v')."""
    args = (tree, d["est"], d["q_p"], d["v_p"], d["c"], *GAINS, hint)
    fns = {name: (lambda f=launcher(libs[name]):
                  checked(est_mod.run_est_step(f, *args)))
           for name in (FIRST, LEVER_A, AT_16, AT_8, UNROLLED)}
    fns[SHIPPED] = lambda: (lambda s: (s.q, s.v))(est_mod.estimator_tick(
        tree, d["est"], d["q_p"], d["v_p"], d["c"], base_pos_hint=hint))
    return {k: fns[k] for k in (FIRST, LEVER_A, SHIPPED, AT_16, AT_8,
                                UNROLLED)}


def probe_bits(record, libs, tree, B_max, device):
    worst = 0.0
    for B in (*BITS_B, B_max):
        for dtype in (torch.float32, torch.float64):
            d = cs.est_inputs(B, 120 + B, dtype, device)
            for h in (None, d["q_p"][:, 0:3]):
                want = est_mod.estimator_tick_reference(
                    tree, d["est"], d["q_p"], d["v_p"], d["c"],
                    base_pos_hint=h)
                fns = tick_fns(libs, tree, d, h)
                first = fns[FIRST]()
                for name, fn in fns.items():
                    got, again = fn(), fn()
                    rel = max(cs.rbd_rel_err(g, w)[0]
                              for g, w in zip(got, (want.q, want.v)))
                    ok = (rel <= cs.EST_REL[dtype]
                          and all(torch.equal(g, x)
                                  for g, x in zip(got, again)))
                    worst = max(worst, rel / cs.EST_REL[dtype]
                                if ok else float("inf"))
                    record("bits", design=name, B=B, dtype=str(dtype)[6:],
                           hint=h is not None, rel=rel, ok=ok,
                           parted_from_first=sum(
                               int((g != f).sum())
                               for g, f in zip(got, first)))
    return worst


def probe_times(record, libs, tree, B_max, rounds, device):
    one = torch.zeros(1, device=device)
    for B in (*TIMED_B, B_max):
        d = cs.est_inputs(B, 130 + B, torch.float32, device)
        fns = tick_fns(libs, tree, d)
        fns["launch floor (one fill_)"] = lambda: one.fill_(1.0)
        replays = {k: pkd.graphed(f) for k, f in fns.items()}
        ms = pkd.interleaved(record, "times", replays, rounds, B=B)
        record("summary", B=B, ms=ms,
               layout=tuple(dk.est_layout(B, torch.float32,
                                          *cs.kernels.device_limits(device))),
               bound_ms=cs.est_step_bound_ms(B)[0])


def first_phases(st):
    """{phase: mean cycles} of the first design's stamps (a row a warp, a
    scenario): stamps 2k + 1 / 2k + 2 around its four barriers."""
    ph = {"attitude (lane 0; lanes 1-12 the joints)": st[:, 1] - st[:, 0],
          "legs: kin_unit at the corrected pose": st[:, 3] - st[:, 2],
          "legs: residual, odometry term, height": st[:, 5] - st[:, 4],
          "fusion: v_lin and v' (stores inside)": st[:, 7] - st[:, 6],
          "fusion: x, y, z and q' (stores inside)": st[:, 9] - st[:, 8],
          "the four barriers": (st[:, 2] - st[:, 1]) + (st[:, 4] - st[:, 3])
          + (st[:, 6] - st[:, 5]) + (st[:, 8] - st[:, 7]),
          "whole warp": st[:, 9] - st[:, 0]}
    return {k: float(v.mean()) for k, v in ph.items()}


def block_phases(st, lever_a: bool):
    """{phase: mean cycles over the blocks} of a block design's stamps (5
    rows a block, row 0 warp 0: the attitude; rows 1-4 the legs): stamps
    2k + 1 / 2k + 2 around barrier k + 1 (load; the attitude beside the
    legs, or (a) the attitude, then the legs; v_lin; x, y, z)."""
    st = st.reshape(-1, 5, EST_STAMPS)
    w0, legs = st[:, 0], st[:, 1:]
    k = 2 if lever_a else 0       # (a) has one barrier more
    ph = {"load (block)": w0[:, 1] - w0[:, 0],
          "attitude (warp 0)": w0[:, 3] - w0[:, 2],
          "legs (slowest of warps 1-4)":
              (legs[:, :, 3 + k] - legs[:, :, 2 + k]).max(1),
          "fusion: v_lin, barrier, x y z (warp 0)":
              w0[:, 7 + k] - w0[:, 4 + k],
          "stores (block)": w0[:, 9 + k] - w0[:, 8 + k],
          "warp 0 waiting at the barriers": sum(
              w0[:, 2 * i + 2] - w0[:, 2 * i + 1] for i in range(4 + k // 2)),
          "whole block (warp 0)": w0[:, 9 + k] - w0[:, 0]}
    return {k_: float(v.mean()) for k_, v in ph.items()}


def probe_phases(record, libs, tree, B_max, device):
    for name in (FIRST, LEVER_A, SHIPPED):
        lib = libs["clock: " + name]
        for fn in ("est_stamps_read", "est_stamps_clear"):
            getattr(lib, fn).restype = ctypes.c_int
        lib.est_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        run = launcher(lib)
        for B in (*TIMED_B, B_max):
            d = cs.est_inputs(B, 140 + B, torch.float32, device)
            args = (tree, d["est"], d["q_p"], d["v_p"], d["c"], *GAINS, None)
            checked(est_mod.run_est_step(run, *args))     # warm
            torch.cuda.synchronize()
            if lib.est_stamps_clear() != 0:
                raise RuntimeError("est_stamps_clear failed")
            checked(est_mod.run_est_step(run, *args))
            torch.cuda.synchronize()
            if name == FIRST:
                rows = B
            else:
                rows = 5 * dk.est_layout(B, torch.float32,
                                         *cs.kernels.device_limits(
                                             device)).blocks
            buf = np.zeros(rows * EST_STAMPS, np.int64)
            if lib.est_stamps_read(buf.ctypes.data, buf.size) != 0:
                raise RuntimeError("est_stamps_read failed")
            st = buf.reshape(rows, EST_STAMPS)
            ph = (first_phases(st) if name == FIRST
                  else block_phases(st, name == LEVER_A))
            record("phases", design=name, B=B, cycles=ph)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cs.enforce_f32_matmuls()
    smi = pkd.smi_line()
    build = os.path.join(str(_build.build_dir()), "probe_est_designs")
    os.makedirs(build, exist_ok=True)
    _build.build_libraries(dk.build_specs())
    libs = pkd.build_variants(variant_specs(), build)
    tree = CascadeConfigured(SOLO12, EngineConfig()).tree
    report = {"card": smi, "batch": a.batch, "ptxas": {}, "bits": [],
              "times": [], "summary": [], "phases": []}

    def record(kind, **row):
        report[kind].append(row)
        print(f"  {kind}: {row}  [{smi}]", flush=True)

    print(f"[{smi}] B={a.batch}", flush=True)
    logs = {SHIPPED: _build.BUILD_LOG.get("est_step", ""),
            **pkd.VARIANT_LOGS}
    for name, log in logs.items():
        if name in variant_specs() or name == SHIPPED:
            report["ptxas"][name] = [
                e for e in pkd.ptxas_entries(log)
                if "est_step_kernel" in e["function"]]
            print(f"  ptxas {name}: {report['ptxas'][name]}", flush=True)
    worst = probe_bits(record, libs, tree, a.batch, device)
    probe_times(record, libs, tree, a.batch, a.rounds, device)
    probe_phases(record, libs, tree, a.batch, device)
    report["worst_over_tolerance"] = worst
    print(f"  largest error over its tolerance, every design: {worst:.3e}",
          flush=True)
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        with open(os.path.join(a.out, "probe_est_designs.json"), "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0 if worst <= 1.0 else 1


# ------------------------------------------------------- the first design:
# est_step.h and est_step.cu as they were before the redesign, verbatim

FIRST_EST_STEP_H = r"""// The per-scenario body of the estimator kernels (est_step.cu): one 1 kHz
// update of the complementary-filter state estimator
// (est/filter.py::estimator_update_reference), and in the tick entry the
// plant's IMU model before it (est/filter.py::imu_from_plant with
// qdd = None):
//
//   gyro  = v_plant[3:6],  accel = g R0(q_plant)[2, :]       (the tick)
//   q     = [q_est[0:7], q_joints]
//   q     = integrate_q(q, [0, gyro, 0], dt);  R0 = R(q)
//   corr  = (|a| > 1e-6 ? alpha_tilt : 0) R0' ((R0 a / max(|a|, 1e-6)) x e_z)
//   q     = integrate_q(q, [0, corr, 0], 1);   R0 = R(q)
//   resid_f = J_f[:, 3:] [gyro, qd]   (the base's angular columns
//             -R0 skew(r_f), r_f = R0' (p_f - p0), and the leg's own
//             columns axis x (p_f - p_joint))
//   v_odo = sum_f c_f (-R0' resid_f) / max(sum c, 1e-6)
//   v_pred = v_est[0:3] + dt (accel - g R0[2, :] - gyro x v_est[0:3])
//   v_lin = sum c > 0.5 ? alpha_vel v_pred + (1 - alpha_vel) v_odo : v_pred
//   xy    = hint ? hint[0:2] : q[0:2] + dt (R0 v_lin)[0:2]
//   z_int = q[2] + dt (R0 v_lin)[2],  z_kin = q[2] - sum_f c_f p_f,z / n
//   z     = sum c > 0.5 ? (1 - alpha_z) z_int + alpha_z z_kin : z_int
//   out:  q' = [xy, z, q[3:]] (19),  v' = [v_lin, gyro, qd] (18)
//
// A warp per scenario.  Lane 0 takes the IMU and the attitude chain (two
// integration steps through rbd.h's `integrate_base`, the plant's own),
// lanes 1-12 the joints; then lanes 0-3 run rbd.h's `kin_unit` on the
// corrected configuration, one leg each (the leg kinematics once, where
// the plain chain builds them twice: foot_jacobians and foot_positions);
// lanes 0-3 then take their foot's residual velocity, its odometry term
// and height; then the fusion a lane an entry.  The phases run through
// rbd.h's executors: on the card `WarpExec` (`__syncwarp()` between
// phases), on the host `HostExec` (the 32 lanes one after another, in
// either order), so the CPU tests build this arithmetic with g++
// (tests/test_torch_est_kernel.py).  No unit reads what another lane
// writes in its own phase.
//
// Bits.  The plain version takes the rotations and the Jacobian's products
// through `torch.matmul` and sin, cos and sqrt from PyTorch's math library;
// here they are rbd.h's products and the CUDA math library's: held to it
// within a tolerance.  The library is built with -fmad=false, so that the
// elementwise products and sums round as the plain version's ops do.

#pragma once

#include "rbd.h"

namespace rbd {
namespace est {

// operands, in the order of the launcher's arrays: each input a first row
// and a stride between scenarios (rbd::Args; an input the entry does not
// read may be null), each output contiguous (B, ...).  The update reads
// gyro, accel, the joints' positions and rates; the tick reads gyro, the
// joints and the plant's configuration (its IMU model), not accel.  The
// hint, a base position (3), is read where EP_HINT is set.
enum In {
    EI_Q, EI_V, EI_GYRO, EI_ACCEL, EI_QJ, EI_QDJ, EI_CONTACTS, EI_HINT,
    EI_PLANT_Q, EI_COUNT
};
enum Out { EO_Q, EO_V, EO_COUNT };
// dt, the gains and their complements (1 - alpha, formed by the caller in
// double as the plain chain's scalars are), the hint flag
enum Par {
    EP_DT, EP_ALPHA_TILT, EP_ALPHA_VEL, EP_BETA_VEL, EP_ALPHA_Z, EP_BETA_Z,
    EP_HINT, EP_COUNT
};

// what dyn/kernels.py checks (EST_LAYOUT): after rbd.h's own counts, the
// estimator's inputs, outputs and parameters
inline int layout(int what)
{
    if (what < L_PLANT_PAR + 1) return ::rbd::layout(what);
    switch (what - (L_PLANT_PAR + 1)) {
    case 0: return EI_COUNT;
    case 1: return EO_COUNT;
    case 2: return EP_COUNT;
    default: return -1;
    }
}

template <typename T> using EstArgs = Args<T, EI_COUNT, EO_COUNT, EP_COUNT>;

// a warp's slot of shared memory
template <typename T>
struct EstSlot {
    Kin<T> k;      // the corrected configuration's leg kinematics
    T q[NQ];       // the corrected configuration
    T gyro[3], accel[3];
    T vodo[4][3];  // each foot's odometry term -R0' resid_f
    T fz[4];       // each foot's height
    T vlin[3];     // the fused linear velocity
};

// lane 0: the IMU (the tick) and the attitude chain into S.q[0:7], S.gyro,
// S.accel
template <bool IMU, typename T>
RBD_FN void attitude_unit(const T* C, const EstArgs<T>& a, long long b,
                          EstSlot<T>& S)
{
    const T* g = a.row(EI_GYRO, b);
    T acc[3];
    if (IMU) {
        T Rp[9];
        quat_to_rot(a.row(EI_PLANT_Q, b) + 3, Rp);
        for (int i = 0; i < 3; ++i) acc[i] = C[C_GRAV] * Rp[6 + i];
    } else {
        for (int i = 0; i < 3; ++i) acc[i] = a.row(EI_ACCEL, b)[i];
    }
    const T* qe = a.row(EI_Q, b);
    T q[7];
    for (int i = 0; i < 7; ++i) q[i] = qe[i];
    const T dt = a.par[EP_DT];
    const T vg[6] = {T(0), T(0), T(0), g[0], g[1], g[2]};
    integrate_base(vg, dt, q);
    // the tilt correction toward the accelerometer's gravity direction
    T R[9], an[3], gm[3], tilt[3], c[3];
    quat_to_rot(q + 3, R);
    const T a_norm = r_sqrt(acc[0] * acc[0] + acc[1] * acc[1]
                            + acc[2] * acc[2]);
    // torch.clamp_min: NaN stays NaN
    const T den = a_norm < T(1e-6) ? T(1e-6) : a_norm;
    for (int i = 0; i < 3; ++i) an[i] = acc[i] / den;
    mv3(R, an, gm);
    const T e_z[3] = {T(0), T(0), T(1)};
    cross(gm, e_z, tilt);
    const T gain = a_norm > T(1e-6) ? a.par[EP_ALPHA_TILT] : T(0);
    mtv3(R, tilt, c);
    const T vc[6] = {T(0), T(0), T(0), gain * c[0], gain * c[1],
                     gain * c[2]};
    integrate_base(vc, T(1), q);
    for (int i = 0; i < 7; ++i) S.q[i] = q[i];
    for (int i = 0; i < 3; ++i) {
        S.gyro[i] = g[i];
        S.accel[i] = acc[i];
    }
}

// lanes 0-3, one leg each: J_f[:, 3:] [gyro, qd] written from the
// Jacobian's columns (rbd.h's `jacobian_unit`), its odometry term and the
// foot's height
template <typename T>
RBD_FN void leg_unit(int lane, const T* C, const T* qd, EstSlot<T>& S)
{
    if (lane >= 4) return;
    const int leg = lane;
    const Kin<T>& k = S.k;
    const T* pf = k.p[leg][3];
    T d[3], r[3];
    for (int c = 0; c < 3; ++c) d[c] = pf[c] - k.p0[c];
    mtv3(k.R0, d, r);
    // base_ang = -(R0 skew(r))
    const T Sk[9] = {T(0), -r[2], r[1], r[2], T(0), -r[0],
                     -r[1], r[0], T(0)};
    T cols[3][3];   // [level] the leg's joint column axis x (p_f - p_joint)
    for (int lvl = 0; lvl < 3; ++lvl) {
        const T* Rw = k.Rw[leg][lvl];
        const int ax = axis_of(C, lvl);
        const T axw[3] = {Rw[ax], Rw[3 + ax], Rw[6 + ax]};
        T e[3];
        for (int m = 0; m < 3; ++m) e[m] = pf[m] - k.p[leg][lvl][m];
        cross(axw, e, cols[lvl]);
    }
    T res[3];
    for (int i = 0; i < 3; ++i) {
        T s = T(0);
        for (int j = 0; j < 3; ++j) {
            const T ang = -(k.R0[3 * i] * Sk[j] + k.R0[3 * i + 1] * Sk[3 + j]
                            + k.R0[3 * i + 2] * Sk[6 + j]);
            s = s + ang * S.gyro[j];
        }
        for (int lvl = 0; lvl < 3; ++lvl)
            s = s + cols[lvl][i] * qd[3 * leg + lvl];
        res[i] = s;
    }
    T t[3];
    mtv3(k.R0, res, t);
    for (int i = 0; i < 3; ++i) S.vodo[leg][i] = -t[i];
    S.fz[leg] = pf[2];
}

// sum c and max(sum c, 1e-6) of a contact row
template <typename T>
RBD_FN void stance_sum(const T* c, T* c_sum, T* n_st)
{
    const T s = ((c[0] + c[1]) + c[2]) + c[3];
    *c_sum = s;
    *n_st = s < T(1e-6) ? T(1e-6) : s;
}

// lanes 0-2: v_lin[lane] (stored, and kept in the slot); lanes 3-17: v'
// entries gyro and qd
template <typename T>
RBD_FN void velocity_unit(int lane, const T* C, const EstArgs<T>& a,
                          long long b, EstSlot<T>& S)
{
    T* vo = a.out[EO_V] + b * NV;
    if (lane >= 3) {
        if (lane < 6) vo[lane] = S.gyro[lane - 3];
        else if (lane < NV) vo[lane] = a.row(EI_QDJ, b)[lane - 6];
        return;
    }
    const int j = lane;
    const T* c = a.row(EI_CONTACTS, b);
    T c_sum, n_st;
    stance_sum(c, &c_sum, &n_st);
    const T v_odo = (((S.vodo[0][j] * c[0] + S.vodo[1][j] * c[1])
                      + S.vodo[2][j] * c[2]) + S.vodo[3][j] * c[3]) / n_st;
    const T* vp = a.row(EI_V, b);
    T gxv[3];
    cross(S.gyro, vp, gxv);
    const T a_local = S.accel[j] - C[C_GRAV] * S.k.R0[6 + j];
    const T v_pred = vp[j] + a.par[EP_DT] * (a_local - gxv[j]);
    const T v_lin = c_sum > T(0.5)
        ? a.par[EP_ALPHA_VEL] * v_pred + a.par[EP_BETA_VEL] * v_odo
        : v_pred;
    S.vlin[j] = v_lin;
    vo[j] = v_lin;
}

// lanes 0-2: the base position's x, y and z; lanes 3-18: q' entries
// orientation and joints
template <typename T>
RBD_FN void position_unit(int lane, const EstArgs<T>& a, long long b,
                          const EstSlot<T>& S)
{
    T* qo = a.out[EO_Q] + b * NQ;
    if (lane >= 3) {
        if (lane < NQ) qo[lane] = S.q[lane];
        return;
    }
    const T* R0 = S.k.R0;
    const T vw = R0[3 * lane] * S.vlin[0] + R0[3 * lane + 1] * S.vlin[1]
                 + R0[3 * lane + 2] * S.vlin[2];
    const T dt = a.par[EP_DT];
    if (lane < 2) {
        qo[lane] = a.par[EP_HINT] != T(0) ? a.row(EI_HINT, b)[lane]
                                          : S.q[lane] + dt * vw;
        return;
    }
    const T* c = a.row(EI_CONTACTS, b);
    T c_sum, n_st;
    stance_sum(c, &c_sum, &n_st);
    const T fz = ((S.fz[0] * c[0] + S.fz[1] * c[1]) + S.fz[2] * c[2])
                 + S.fz[3] * c[3];
    const T z_kin = S.q[2] - fz / n_st;
    const T z_int = S.q[2] + dt * vw;
    qo[2] = c_sum > T(0.5)
        ? a.par[EP_BETA_Z] * z_int + a.par[EP_ALPHA_Z] * z_kin
        : z_int;
}

// the whole body of one scenario b; the IMU model first where IMU
template <bool IMU, typename T, class Exec>
RBD_FN void est_warp(const Exec& ex, const T* C, const EstArgs<T>& a,
                     long long b, EstSlot<T>& S)
{
    RBD_EACH_LANE(ex, lane) {
        if (lane == 0) attitude_unit<IMU>(C, a, b, S);
        else if (lane <= 12) S.q[6 + lane] = a.row(EI_QJ, b)[lane - 1];
    }
    ex.sync();
    RBD_EACH_LANE(ex, lane) kin_unit(lane, C, S.q, S.k);
    ex.sync();
    RBD_EACH_LANE(ex, lane) leg_unit(lane, C, a.row(EI_QDJ, b), S);
    ex.sync();
    RBD_EACH_LANE(ex, lane) velocity_unit(lane, C, a, b, S);
    ex.sync();
    RBD_EACH_LANE(ex, lane) position_unit(lane, a, b, S);
}

}  // namespace est
}  // namespace rbd
"""

FIRST_EST_STEP_CU = r"""// The state estimator's tick, and its update alone, in one launch each —
// CUDA, sm_90a.
//
// est_step: est/filter.py::estimator_tick for a batch: the plant's IMU
// model (imu_from_plant, qdd = None) and one complementary-filter update
// (estimator_update) on it, the cascade's estimator tick.  est_update:
// est/filter.py::estimator_update, gyro and accel given.  One kernel body
// (est_step.h's `est_warp`, the IMU model a template flag), two entry
// points.  The JAX package has no Pallas kernel here: its cascade leaves
// these ops to XLA under `jax.jit` (mpctsid_tpu/cascade/engine.py:243-249,
// mpctsid_tpu/est/filter.py:38-108).  Run op by op the plain PyTorch chain
// is about 630 kernels a tick (the attitude's two integrations, two sets of
// leg kinematics for foot_jacobians and foot_positions, the matmuls and
// the selects), each 1.3-1.9 us of a CUDA graph's replay: the node count,
// not the arithmetic, is the stage's time.
//
// What bounds it on this card: bytes.  Per scenario the tick reads 45
// values (the estimate's base pose and linear velocity, 10; the plant's
// quaternion, 4; its gyro and joint rates, 15; its joints, 12; the contact
// flags, 4) and writes 37, for about 2,000 operations
// (chip_smoke.py::est_step_bound_ms): at B = 4096 well under a launch.  The kernel's reason is to be one launch where the
// plain chain is hundreds.
//
// Design: a warp per scenario, rbd::warps_per_block's number a block (the
// WBC build's layout; dyn/kernels.py::rbd_layout), each warp with its slot
// (rbd::est::EstSlot: the leg kinematics, the corrected configuration, the
// sensors, the feet's odometry terms and heights, 320 values).  float and
// double.
//
// Launch: est_step_launch / est_update_launch(dtype, B, consts, in,
// stride, out, par, stream) with the arrays in est_step.h's In / Out / Par
// order; dtype 0 float, 1 double.  Returns a cudaError_t (0 on success);
// launches on `stream` and allocates nothing.

#include <cuda_runtime.h>

#include "est_step.h"

namespace {

// warp w of the block takes scenario b, its slot at w * slot bytes
template <bool IMU, typename T>
__device__ __forceinline__ void est_body(const T* __restrict__ consts,
                                         const rbd::est::EstArgs<T>& a,
                                         int B, int slot)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x / rbd::WARP;
    const long long b =
        (long long)blockIdx.x * (blockDim.x / rbd::WARP) + warp;
    if (b >= B) return;
    rbd::WarpExec ex;
    rbd::est::est_warp<IMU, T>(
        ex, consts, a, b,
        *reinterpret_cast<rbd::est::EstSlot<T>*>(smem + (size_t)warp * slot));
}

// the tick (the profiler tells the two entry points apart by their names)
template <typename T>
__global__ void __launch_bounds__(rbd::WARP * rbd::MAX_WARPS)
est_step_kernel(const T* __restrict__ consts,
                const rbd::est::EstArgs<T> args, int B, int slot)
{
    est_body<true, T>(consts, args, B, slot);
}

// the update alone
template <typename T>
__global__ void __launch_bounds__(rbd::WARP * rbd::MAX_WARPS)
est_update_kernel(const T* __restrict__ consts,
                  const rbd::est::EstArgs<T> args, int B, int slot)
{
    est_body<false, T>(consts, args, B, slot);
}

int last_layout[3];   // warps a block, blocks, shared bytes a block

template <bool IMU, typename T>
int launch(int B, const void* consts, const void* const* in,
           const long long* stride, void* const* out, const double* par,
           cudaStream_t stream)
{
    using namespace rbd::est;
    EstArgs<T> a;
    for (int k = 0; k < EI_COUNT; ++k) {
        a.in[k] = static_cast<const T*>(in[k]);
        a.stride[k] = stride[k];
    }
    for (int k = 0; k < EO_COUNT; ++k) a.out[k] = static_cast<T*>(out[k]);
    for (int k = 0; k < EP_COUNT; ++k) a.par[k] = (T)par[k];
    int dev, optin, n_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    const int slot = rbd::slot_bytes((int)sizeof(EstSlot<T>));
    const int g = rbd::warps_per_block(B, slot, optin, n_sm);
    if (g < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (B + g - 1) / g, smem = g * slot;
    if (IMU)
        est_step_kernel<T><<<blocks, g * rbd::WARP, smem, stream>>>(
            static_cast<const T*>(consts), a, B, slot);
    else
        est_update_kernel<T><<<blocks, g * rbd::WARP, smem, stream>>>(
            static_cast<const T*>(consts), a, B, slot);
    last_layout[0] = g;
    last_layout[1] = blocks;
    last_layout[2] = smem;
    return (int)cudaGetLastError();
}

// the pointers each entry reads: the tick the plant's configuration, the
// update accel; the hint where its flag is set
bool valid(int B, const void* consts, const void* const* in,
           void* const* out, const double* par, bool imu)
{
    using namespace rbd::est;
    if (B < 1 || consts == nullptr || par == nullptr) return false;
    for (int k = 0; k < EI_COUNT; ++k) {
        const bool needed = k == EI_HINT ? par[EP_HINT] != 0.0
                            : k == EI_ACCEL ? !imu
                            : k == EI_PLANT_Q ? imu : true;
        if (needed && in[k] == nullptr) return false;
    }
    for (int k = 0; k < EO_COUNT; ++k)
        if (out[k] == nullptr) return false;
    return true;
}

template <bool IMU>
int launch_dtype(int dtype, int B, const void* consts, const void* const* in,
                 const long long* stride, void* const* out,
                 const double* par, void* stream)
{
    if (!valid(B, consts, in, out, par, IMU))
        return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch<IMU, float>(B, consts, in, stride, out, par,
                                  (cudaStream_t)stream);
    if (dtype == 1)
        return launch<IMU, double>(B, consts, in, stride, out, par,
                                   (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// rbd.h's counts, then the estimator's (dyn/kernels.py::LAYOUT,
// EST_LAYOUT)
int est_step_layout(int what) { return rbd::est::layout(what); }

// values (floats or doubles) of a warp's slot: rbd::est::EstSlot
int est_step_slot_values()
{
    static_assert(sizeof(rbd::est::EstSlot<double>)
                  == 2 * sizeof(rbd::est::EstSlot<float>),
                  "slot of values");
    return (int)(sizeof(rbd::est::EstSlot<float>) / sizeof(float));
}

// the last launch's (tick or update) warps a block (0), blocks (1), shared
// bytes a block (2)
int est_step_last_layout(int what)
{
    return what >= 0 && what < 3 ? last_layout[what] : -1;
}

int est_step_launch(int dtype, int B, const void* consts,
                    const void* const* in, const long long* stride,
                    void* const* out, const double* par, void* stream)
{
    return launch_dtype<true>(dtype, B, consts, in, stride, out, par,
                              stream);
}

int est_update_launch(int dtype, int B, const void* consts,
                      const void* const* in, const long long* stride,
                      void* const* out, const double* par, void* stream)
{
    return launch_dtype<false>(dtype, B, consts, in, stride, out, par,
                               stream);
}

const char* est_step_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
"""


if __name__ == "__main__":
    sys.exit(main())
