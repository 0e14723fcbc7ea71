#!/usr/bin/env python3
"""The planner's redesigned kernels against their first designs, on the
card: the swing reference over a period (`plan_swing_at`) and the reference
rollout (`plan_rollout`).

    python3 scripts/probe_planner_designs.py [--kernels swing rollout]
        [--batch 4096] [--rounds 6] [--out DIR]

Needs an NVIDIA GPU and nvcc.  The first designs (the rollout a thread
per (scenario, step) repeating the recursion up to its step; the swing
reference at a tick a thread per (scenario, foot), launched at every
tick) live on here verbatim, as `FIRST_PLANNER_H` /
`FIRST_PLANNER_CU`, and are built as a copy of the library beside the
shipped one (`-fmad=false`, as the library).  On chip_smoke.py phase 3g's
inputs (`planner_inputs`), float32 and float64, B = 1, 37 and --batch:

  swing.   the period kernel at T = 20 (the cascade's) against the first
     design launched at each of the 20 fractions, and the shipped kernel
     at T = 1 (`swing_reference_at`) against the first design at one
     tick: entries whose bits part.  Then, float32, B = 1, 256 and
     --batch, in interleaved rounds of CUDA-graph replays: a period's
     swing references as the first design's 20 launches, as 20 launches of
     the new kernel at T = 1 and as one launch at T = 20; the other design
     the redesign could take, a thread per (scenario, foot) looping over
     the ticks (`LOOP_SWING`, a patched copy); and the staging's rows a
     block at 32 and 128 (patched copies of planner.h's SWING_ROWS);
  rollout. the shipped kernel against the first design (parted entries),
     then in interleaved rounds at B = 1, 256 and --batch beside patched
     copies with 64 and 256 threads a block.

Every timed set also times a one-kernel graph (a `fill_` of a one-element
tensor: the launch floor) and prints each time beside the floor and the
bound (chip_smoke.py's `plan_bounds`).  Prints one JSON object at the end;
with --out also writes it to DIR/probe_planner_designs.json.
"""

from __future__ import annotations

import argparse
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
from mpctsid_tpu_torch.config import EngineConfig  # noqa: E402
from mpctsid_tpu_torch.model.solo12 import SOLO12  # noqa: E402
from mpctsid_tpu_torch.mpc import srb  # noqa: E402
from mpctsid_tpu_torch.plan import kernels as pk  # noqa: E402
from mpctsid_tpu_torch.plan import swing  # noqa: E402
from mpctsid_tpu_torch.qp import _build  # noqa: E402

PARTS = ["swing", "rollout"]
BITS_B = (1, 37)          # and --batch
TIMED_B = (1, 256)        # and --batch

# The other design of the period kernel: a thread per (scenario, foot),
# its ticks one after another, storing straight to device memory (no
# staging), 64 scenarios a block.  Appended to a copy of planner.cu, its
# launcher in the period launcher's place.
LOOP_SWING_KERNEL = r'''
namespace {

template <typename T>
__global__ void __launch_bounds__(256)
plan_swing_loop_kernel(const planner::SwingAtArgs<T> a,
                       const int* __restrict__ tables, int B, int Tn)
{
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)B * planner::FEET) return;
    const long long b = t / planner::FEET;
    const int f = (int)(t % planner::FEET);
    planner::SwingBlock k;
    k.r0 = b * Tn;
    k.rows = Tn;
    k.b_lo = b;
    k.nb = 1;
    const planner::SwingFoot<T> p = planner::swing_setup(a, tables, k, f);
    T* const out[3] = {a.out[0] + k.r0 * 12, a.out[1] + k.r0 * 12,
                       a.out[2] + k.r0 * 12};
    for (int r = 0; r < Tn; ++r)
        planner::swing_tick(a, p,
                            planner::swing_frac(a, Tn, k, r * planner::FEET + f),
                            r * planner::FEET + f, out);
}

template <typename T>
int swing_loop(int B, int Tn, const void* tables, const void* const* in,
               const long long* stride, void* const* out, const double* par,
               cudaStream_t stream)
{
    planner::SwingAtArgs<T> a;
    planner::fill(a, in, stride, out, par);
    plan_swing_loop_kernel<T><<<blocks_of((long long)B * planner::FEET, 256),
                                256, 0, stream>>>(
        a, static_cast<const int*>(tables), B, Tn);
    return (int)cudaGetLastError();
}

}  // namespace
'''


def loop_swing_subs(src: str) -> str:
    """planner.cu with LOOP_SWING_KERNEL before its C entry points and the
    period launcher calling it."""
    anchor = 'extern "C" {'
    if anchor not in src:
        raise RuntimeError("loop variant: no C entry points in planner.cu")
    src = src.replace(anchor, LOOP_SWING_KERNEL + "\n" + anchor, 1)
    for d in ("float", "double"):
        old = f"? swing_at<{d}>(" if d == "float" else f": swing_at<{d}>("
        if old not in src:
            raise RuntimeError(f"loop variant: no {old!r} in planner.cu")
        src = src.replace(old, old.replace("swing_at<", "swing_loop<"))
    return src


def header_sub(old: str, new: str):
    def sub(src: str) -> str:
        if old not in src:
            raise RuntimeError(f"pattern not in planner.h: {old!r}")
        return src.replace(old, new)
    return sub


def variant_specs() -> dict:
    """name -> write_variant's keyword arguments of every copy built."""
    common = dict(source="planner.cu", csrc=pk.CSRC, flags=pk.FLAGS)
    same = lambda s: s  # noqa: E731
    rows = "constexpr int SWING_ROWS = 64;"
    threads = "constexpr int ROLL_THREADS = 128;"
    return {
        "first design": dict(subs=lambda _: FIRST_PLANNER_CU,
                             header_subs={"planner.h":
                                          lambda _: FIRST_PLANNER_H},
                             **common),
        "a thread per (scenario, foot) looping over ticks": dict(
            subs=loop_swing_subs, header_subs={"planner.h": same}, **common),
        "32 rows a block": dict(subs=same, header_subs={
            "planner.h": header_sub(rows, rows.replace("64", "32"))},
            **common),
        "128 rows a block": dict(subs=same, header_subs={
            "planner.h": header_sub(rows, rows.replace("64", "128"))},
            **common),
        "64 threads a block": dict(subs=lambda s: header_sub(
            threads, threads.replace("128", "64"))(s),
            header_subs={"planner.h": same}, **common),
        "256 threads a block": dict(subs=lambda s: header_sub(
            threads, threads.replace("128", "256"))(s),
            header_subs={"planner.h": same}, **common),
    }


def launcher(lib, kernel: str):
    """plan_<kernel>_launch of a built copy, on the current stream (the
    wrappers' `launch_fn`: the C signature less the stream)."""
    fn = getattr(lib, f"plan_{kernel}_launch")
    fn.argtypes = pk.LAUNCH_ARGTYPES + [pk._PTR]
    fn.restype = pk._INT

    def run(*a):
        return fn(*a, torch.cuda.current_stream().cuda_stream)
    return run


def checked(rc_out):
    rc, out = rc_out
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return out


def tensors(d: dict, B: int, dtype, device):
    t = lambda a: torch.tensor(a[:B], dtype=dtype, device=device)  # noqa
    return dict(gid=torch.tensor(d["gid"][:B], device=device),
                phase=torch.tensor(d["phase"][:B], device=device),
                x=t(d["x"]), v_cmd=t(d["v_cmd"]), lift=t(d["lift"]),
                td=t(d["td"]))


def parted(got, want) -> int:
    return sum(int((g != w).sum()) for g, w in zip(got, want))


def floor_fn(device):
    one = torch.zeros(1, device=device)
    return lambda: one.fill_(1.0)


def probe_swing(record, B_max, rounds, libs, device):
    cfg = EngineConfig()
    T = cfg.cascade.mpc_every
    dt, h = cfg.mpc.dt, cfg.cascade.swing_height
    d = cs.planner_inputs(B_max, 70)
    first = launcher(libs["first design"], "swing_at")
    for B in (*BITS_B, B_max):
        for dtype in (torch.float32, torch.float64):
            t = tensors(d, B, dtype, device)
            fracs = torch.tensor(np.arange(T) / T, dtype=dtype,
                                 device=device)
            args = (t["gid"], t["phase"])
            period = swing.swing_references_period(
                *args, fracs, t["lift"], t["td"], dt, h)
            ticks_first = [checked(swing.run_swing_at(
                first, *args, fracs[k:k + 1], t["lift"], t["td"], dt, h))
                for k in range(T)]
            stacked = [torch.stack([tk[i] for tk in ticks_first], dim=1)
                       for i in range(3)]
            at = [swing.swing_reference_at(*args, fracs[k:k + 1], t["lift"],
                                           t["td"], dt, h) for k in range(T)]
            n_period = parted(period, stacked)
            n_at = sum(parted(a, f) for a, f in zip(at, ticks_first))
            record("swing_bits", B=B, dtype=str(dtype)[6:],
                   period_vs_first_parted=n_period,
                   at_vs_first_parted=n_at,
                   entries=sum(s.numel() for s in stacked))
    variants = {k: launcher(libs[k], "swing_at")
                for k in ("a thread per (scenario, foot) looping over ticks",
                          "32 rows a block", "128 rows a block")}
    for B in (*TIMED_B, B_max):
        t = tensors(d, B, torch.float32, device)
        fracs = torch.tensor(np.arange(T) / T, dtype=torch.float32,
                             device=device)
        args = (t["gid"], t["phase"])
        rest = (t["lift"], t["td"], dt, h)
        want = swing.swing_references_period(*args, fracs, *rest)
        for name, fn in variants.items():
            got = checked(swing.run_swing_period(fn, *args, fracs, *rest))
            record("swing_variant_bits", B=B, design=name,
                   parted=parted(got, want))
        fns = {
            "first design, 20 launches": lambda: [checked(
                swing.run_swing_at(first, *args, fracs[k:k + 1], *rest))
                for k in range(T)],
            "new at T = 1, 20 launches": lambda: [
                swing.swing_reference_at(*args, fracs[k:k + 1], *rest)
                for k in range(T)],
            "new, one launch at T = 20": lambda: swing.swing_references_period(
                *args, fracs, *rest),
            "first design, one tick": lambda: checked(swing.run_swing_at(
                first, *args, fracs[3:4], *rest)),
            "new at T = 1, one tick": lambda: swing.swing_reference_at(
                *args, fracs[3:4], *rest),
            "launch floor (one fill_)": floor_fn(device)}
        for name, fn in variants.items():
            fns[name + ", one launch at T = 20"] = (
                lambda fn=fn: checked(swing.run_swing_period(
                    fn, *args, fracs, *rest)))
        replays = {k: pkd.graphed(f) for k, f in fns.items()}
        ms = pkd.interleaved(record, "swing_times", replays, rounds, B=B)
        tick = cs.plan_bounds(B, d, 16)["swing_reference_at"][0]
        record("swing_summary", B=B, ms=ms,
               bound_ms_one_tick=tick,
               bound_ms_period=period_bound_ms(B, T)[0])


def period_bound_ms(B: int, T: int):
    """chip_smoke.py's bound of the period kernel: the tables once, per
    scenario gait, phase, lift-off and touchdown in, T fractions once, 3 x
    T x 12 values out; about 65 operations a (tick, foot)."""
    return cs.bound_ms(B * (2 + 24 + 36 * T) + T + pk.LAYOUT["table_ints"],
                       B * T * 4 * 65)


def probe_rollout(record, B_max, rounds, libs, device):
    cfg = EngineConfig()
    N = cfg.mpc.horizon
    d = cs.planner_inputs(B_max, 70)
    first = launcher(libs["first design"], "rollout")
    for B in (*BITS_B, B_max):
        for dtype in (torch.float32, torch.float64):
            t = tensors(d, B, dtype, device)
            got = srb.reference_rollout(SOLO12, cfg.mpc, t["x"], t["v_cmd"])
            want = checked(srb.run_rollout(first, SOLO12, cfg.mpc, t["x"],
                                           t["v_cmd"]))
            record("rollout_bits", B=B, dtype=str(dtype)[6:],
                   parted=parted([got], [want]), entries=want.numel())
    variants = {k: launcher(libs[k], "rollout")
                for k in ("64 threads a block", "256 threads a block")}
    for B in (*TIMED_B, B_max):
        t = tensors(d, B, torch.float32, device)
        x, vc = t["x"], t["v_cmd"]
        want = srb.reference_rollout(SOLO12, cfg.mpc, x, vc)
        fns = {"first design": lambda: checked(srb.run_rollout(
                   first, SOLO12, cfg.mpc, x, vc)),
               "new": lambda: srb.reference_rollout(SOLO12, cfg.mpc, x, vc),
               "launch floor (one fill_)": floor_fn(device)}
        for name, fn in variants.items():
            got = checked(srb.run_rollout(fn, SOLO12, cfg.mpc, x, vc))
            record("rollout_variant_bits", B=B, design=name,
                   parted=parted([got], [want]))
            fns[name] = lambda fn=fn: checked(srb.run_rollout(
                fn, SOLO12, cfg.mpc, x, vc))
        replays = {k: pkd.graphed(f) for k, f in fns.items()}
        ms = pkd.interleaved(record, "rollout_times", replays, rounds, B=B)
        record("rollout_summary", B=B, ms=ms,
               bound_ms=cs.plan_bounds(B, d, N)["reference_rollout"][0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--out", default=None)
    ap.add_argument("--kernels", nargs="+", default=PARTS, choices=PARTS)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cs.enforce_f32_matmuls()
    smi = pkd.smi_line()
    build = os.path.join(str(_build.build_dir()), "probe_planner_designs")
    os.makedirs(build, exist_ok=True)
    # the shipped library and every copy, their nvcc processes together
    _build.build_libraries(pk.build_specs())
    libs = pkd.build_variants(variant_specs(), build)
    report = {"card": smi, "batch": a.batch, "swing_bits": [],
              "swing_variant_bits": [], "swing_times": [],
              "swing_summary": [], "rollout_bits": [],
              "rollout_variant_bits": [], "rollout_times": [],
              "rollout_summary": []}

    def record(kind, **row):
        report[kind].append(row)
        print(f"  {kind}: {row}  [{smi}]", flush=True)

    print(f"[{smi}] B={a.batch}", flush=True)
    if "swing" in a.kernels:
        probe_swing(record, a.batch, a.rounds, libs, device)
    if "rollout" in a.kernels:
        probe_rollout(record, a.batch, a.rounds, libs, device)
    bits = ([r["period_vs_first_parted"] + r["at_vs_first_parted"]
             for r in report["swing_bits"]]
            + [r["parted"] for r in report["rollout_bits"]
               + report["swing_variant_bits"]
               + report["rollout_variant_bits"]])
    report["parted_total"] = int(sum(bits))
    print(f"  entries parted from the first designs (and between the "
          f"variants): {report['parted_total']}", flush=True)
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        with open(os.path.join(a.out, "probe_planner_designs.json"),
                  "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0 if report["parted_total"] == 0 else 1



# ------------------------------------------------------- the first designs:
# planner.h and planner.cu as they were before the redesign, verbatim

FIRST_PLANNER_H = r"""// The planner's per-scenario arithmetic: the footstep horizon, the
// reference rollout and the swing reference (from given phases, and at a
// tick from the gait tables), for the kernels of planner.cu.
//
// Plain C++: every function is marked PLAN_FN, `__host__ __device__` under
// nvcc and plain `inline` under a host compiler, so the tests build this
// very arithmetic with g++ and run it on the CPU
// (tests/test_torch_plan_kernels.py).  One call computes what one thread of
// a kernel computes: a (scenario, foot) of the footstep horizon and of the
// swing references, a (scenario, step) of the reference rollout.  Templated
// on the value type (float, double).
//
// Rounding.  Each expression is the plain PyTorch version's, op by op and
// in its order: one rounding per op, no FMA (planner.cu is built with
// -fmad=false; a host compiler contracts nothing under -std=c++17).  Where
// PyTorch on the card rounds otherwise than the formula reads, the card's
// form is written: a tensor divided by a Python number is the product with
// its reciprocal (h / g -> h * (1 / g)); `1.0 / t` is t's reciprocal;
// s ** 3 is s * s * s and s ** 4, s ** 5 are pow(s, 4), pow(s, 5).  The
// plain version's rotations go through torch.bmm and torch.einsum, which
// cuBLAS rounds either as the FMA chain of a dot product in k order (a zero
// third term: fma(a1, b1, a0 b0)) or as two products and a sum, by the
// call's dtype and batch; the wrapper says which (`fused_*` parameters,
// plan/kernels.py::rotation_forms) and `dot2` forms it.
//
// Inputs reach a kernel as a first row and the stride between two
// scenarios' rows (0 for a row broadcast to every scenario), in elements.

#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define PLAN_FN __host__ __device__ __forceinline__
#else
#define PLAN_FN inline
#endif

namespace planner {

constexpr int N_GAITS = 5;      // model/gaits.py's tables
constexpr int PERIOD = 16;      // GAIT_PERIOD: MPC steps per gait cycle
constexpr int FEET = 4;
// the gait tables as one int array: stance flags [gait][phase][foot], the
// stance steps per period [gait][foot], then the swing tables' steps since
// lift-off and swing durations [gait][phase][foot] (plan/gait.py: TABLES,
// _STANCE_STEPS_NP, _BACK_NP, _DUR_NP)
constexpr int FLAG_INTS = N_GAITS * PERIOD * FEET;
constexpr int STANCE_OFF = FLAG_INTS;
constexpr int BACK_OFF = STANCE_OFF + N_GAITS * FEET;
constexpr int DUR_OFF = BACK_OFF + FLAG_INTS;
constexpr int TABLE_INTS = DUR_OFF + FLAG_INTS;

// ---- operands, in the order of the launchers' arrays
enum FootIn { FI_GAIT, FI_PHASE, FI_X, FI_VCMD, FI_FEET, FI_COUNT };
enum FootOut { FO_FEET, FO_TD, FO_COUNT };
// dt, h_ref, g, t_stance_factor, k_raibert, the forms of the command's
// rotation (bmm) and of the shoulders' (einsum): 1 fused, 0 not; the
// shoulder offsets [foot][3]
enum FootPar { FP_DT, FP_H_REF, FP_G, FP_TSF, FP_KR, FP_FUSED_BMM,
               FP_FUSED_EINSUM, FP_SH, FP_COUNT = FP_SH + 3 * FEET };
enum RollIn { RI_X, RI_VCMD, RI_COUNT };
// dt, h_ref, the form of the rotation (bmm)
enum RollPar { RP_DT, RP_H_REF, RP_FUSED_BMM, RP_COUNT };
enum SwingIn { SI_LIFT, SI_TD, SI_S, SI_T, SI_COUNT };
enum SwingOut { SO_POS, SO_VEL, SO_ACC, SO_COUNT };
enum SwingPar { SP_H64, SP_COUNT };     // 64 h_apex
// the swing reference at a tick: gait id and phase (int32), the tick's
// fraction of its MPC step, lift-off and touchdown points; dt, 64 h_apex
enum SwingAtIn { SA_GAIT, SA_PHASE, SA_TFRAC, SA_LIFT, SA_TD, SA_COUNT };
enum SwingAtPar { SAP_DT, SAP_H64, SAP_COUNT };

// the gait tables' ints and each kernel's operand counts: inputs, outputs,
// parameters of the footsteps, the rollout, the swing reference and the
// swing reference at a tick (plan/kernels.py::LAYOUT; -1 past the end)
inline int layout(int what)
{
    const int counts[] = {TABLE_INTS, FI_COUNT, FO_COUNT, FP_COUNT,
                          RI_COUNT, 1, RP_COUNT, SI_COUNT, SO_COUNT,
                          SP_COUNT, SA_COUNT, SO_COUNT, SAP_COUNT};
    return what >= 0 && what < (int)(sizeof(counts) / sizeof(int))
               ? counts[what] : -1;
}

template <typename T, int NI, int NO, int NP>
struct Args {
    const void* in[NI];
    long long stride[NI];
    T* out[NO];
    T par[NP];

    template <typename U>
    PLAN_FN const U* row(int k, long long b) const
    {
        return static_cast<const U*>(in[k]) + b * stride[k];
    }
};

template <typename T> using FootArgs = Args<T, FI_COUNT, FO_COUNT, FP_COUNT>;
template <typename T> using RollArgs = Args<T, RI_COUNT, 1, RP_COUNT>;
template <typename T>
using SwingArgs = Args<T, SI_COUNT, SO_COUNT, SP_COUNT>;
template <typename T>
using SwingAtArgs = Args<T, SA_COUNT, SO_COUNT, SAP_COUNT>;

// the launchers' arrays -> Args (host side: the kernels take Args by value)
template <typename T, int NI, int NO, int NP>
inline void fill(Args<T, NI, NO, NP>& a, const void* const* in,
                 const long long* stride, void* const* out,
                 const double* par)
{
    for (int k = 0; k < NI; ++k) {
        a.in[k] = in[k];
        a.stride[k] = stride[k];
    }
    for (int k = 0; k < NO; ++k) a.out[k] = static_cast<T*>(out[k]);
    for (int k = 0; k < NP; ++k) a.par[k] = (T)par[k];
}

PLAN_FN float p_sin(float a) { return sinf(a); }
PLAN_FN double p_sin(double a) { return sin(a); }
PLAN_FN float p_cos(float a) { return cosf(a); }
PLAN_FN double p_cos(double a) { return cos(a); }
PLAN_FN float p_sqrt(float a) { return sqrtf(a); }
PLAN_FN double p_sqrt(double a) { return sqrt(a); }
PLAN_FN float p_pow(float a, float e) { return powf(a, e); }
PLAN_FN double p_pow(double a, double e) { return pow(a, e); }
PLAN_FN float p_fma(float a, float b, float c) { return fmaf(a, b, c); }
PLAN_FN double p_fma(double a, double b, double c) { return fma(a, b, c); }

// a0 b0 + a1 b1 as a row of the plain version's 3 x 3 rotation (third term
// 0 x 0) rounds in cuBLAS: the FMA chain in k order, or two products and a
// sum
template <typename T>
PLAN_FN T dot2(T a0, T b0, T a1, T b1, bool fused)
{
    return fused ? p_fma(a1, b1, a0 * b0) : a0 * b0 + a1 * b1;
}

// torch.clamp_min: NaN stays NaN
template <typename T>
PLAN_FN T clamp_min(T v, T lo) { return v < lo ? lo : v; }

// Python's floor modulo of a phase (plan/gait.py indexes phase % PERIOD)
PLAN_FN int wrap(int p)
{
    const int r = p % PERIOD;
    return r < 0 ? r + PERIOD : r;
}

PLAN_FN int stance_flag(const int* tables, int g, int ph, int f)
{
    return tables[(g * PERIOD + wrap(ph)) * FEET + f];
}

PLAN_FN int stance_steps(const int* tables, int g, int f)
{
    return tables[STANCE_OFF + g * FEET + f];
}

// steps since lift-off and swing duration in steps (0 in stance)
PLAN_FN int swing_back(const int* tables, int g, int ph, int f)
{
    return tables[BACK_OFF + (g * PERIOD + wrap(ph)) * FEET + f];
}

PLAN_FN int swing_dur(const int* tables, int g, int ph, int f)
{
    return tables[DUR_OFF + (g * PERIOD + wrap(ph)) * FEET + f];
}

// ---- the footstep horizon: plan/footsteps.py::plan_footsteps_horizon for
// foot f of scenario b.  feet (B, N, 4, 3) and next_td (B, 4, 3).  The
// Raibert target (`raibert_touchdown`) is formed only at the steps where
// the foot goes from swing to stance: the only steps that read it.
template <typename T>
PLAN_FN void footsteps_foot(const FootArgs<T>& a, const int* tables, int N,
                            long long b, int f)
{
    const int g = *a.template row<int>(FI_GAIT, b);
    const int ph = *a.template row<int>(FI_PHASE, b);
    const T* x = a.template row<T>(FI_X, b);
    const T* vc = a.template row<T>(FI_VCMD, b);
    const T* cf = a.template row<T>(FI_FEET, b) + 3 * f;
    const T dt = a.par[FP_DT], h_ref = a.par[FP_H_REF];
    const T shx = a.par[FP_SH + 3 * f], shy = a.par[FP_SH + 3 * f + 1];
    const T t_stance = (T)stance_steps(tables, g, f) * dt;
    const T yaw0 = x[5], vx = x[6], vy = x[7], wz = vc[2];
    const T inv_g = (T)1 / a.par[FP_G];
    const bool fused_bmm = a.par[FP_FUSED_BMM] != (T)0;
    const bool fused_einsum = a.par[FP_FUSED_EINSUM] != (T)0;
    // current_feet * [1, 1, 0]
    T wx = cf[0] * (T)1, wy = cf[1] * (T)1, wzr = cf[2] * (T)0;
    T tdx = wx, tdy = wy, tdz = wzr;
    bool found = false;
    int prev = stance_flag(tables, g, ph, f);
    T* feet = a.out[FO_FEET];
    for (int k = 0; k < N; ++k) {
        const int ck = stance_flag(tables, g, ph + k, f);
        if (ck > 0 && prev == 0) {          // swing -> stance at step k
            const T yaw = yaw0 + wz * dt * (T)k;
            const T c = p_cos(yaw), s = p_sin(yaw);
            // v_ref_world = rot_z(yaw_k) [vcx, vcy, 0] (torch.bmm)
            const T vrx = dot2(c, vc[0], -s, vc[1], fused_bmm);
            const T vry = dot2(s, vc[0], c, vc[1], fused_bmm);
            const T pkx = x[0] + vx * dt * (T)k;
            const T pky = x[1] + vy * dt * (T)k;
            // shoulder = p_k + rot_z(yaw_k) sh_f (torch.einsum)
            T px = pkx + dot2(c, shx, -s, shy, fused_einsum);
            T py = pky + dot2(s, shx, c, shy, fused_einsum);
            const T ts = a.par[FP_TSF] * t_stance;
            px = px + ts * vx;
            py = py + ts * vy;
            px = px + a.par[FP_KR] * (vx - vrx);
            py = py + a.par[FP_KR] * (vy - vry);
            const T h = clamp_min(h_ref, (T)1e-3);
            const T cfg = (T)0.5 * p_sqrt(h * inv_g);
            px = px + cfg * (vy * wz);
            py = py + cfg * (-vx * wz);
            wx = px;
            wy = py;
            wzr = (T)0;
            if (!found) {
                tdx = px;
                tdy = py;
                tdz = (T)0;
                found = true;
            }
        }
        T* o = feet + ((b * N + k) * FEET + f) * 3;
        o[0] = wx;
        o[1] = wy;
        o[2] = wzr;
        prev = ck;
    }
    T* td = a.out[FO_TD] + (b * FEET + f) * 3;
    td[0] = tdx;
    td[1] = tdy;
    td[2] = tdz;
}

// ---- the reference rollout: mpc/srb.py::reference_rollout, step k of
// scenario b: the k + 1 steps of the recursion up to it (each thread of a
// scenario repeats its own prefix, so that a warp's threads write
// consecutive rows), the state after step k.  out (B, N, 12): [p_x, p_y,
// h_ref, 0, 0, yaw, v_world, 0, 0, wz].
template <typename T>
PLAN_FN void rollout_step(const RollArgs<T>& a, int N, long long b, int k)
{
    const T* x = a.template row<T>(RI_X, b);
    const T* vc = a.template row<T>(RI_VCMD, b);
    const T dt = a.par[RP_DT];
    const bool fused = a.par[RP_FUSED_BMM] != (T)0;
    T px = x[0], py = x[1], yaw = x[5], vwx = (T)0, vwy = (T)0;
    const T vbx = vc[0], vby = vc[1], wz = vc[2];
    for (int j = 0; j <= k; ++j) {
        const T c = p_cos(yaw), s = p_sin(yaw);
        // v_world = rot_z(yaw) [vbx, vby, 0] (torch.bmm)
        vwx = dot2(c, vbx, -s, vby, fused);
        vwy = dot2(s, vbx, c, vby, fused);
        px = px + vwx * dt;
        py = py + vwy * dt;
        yaw = yaw + wz * dt;
    }
    T* o = a.out[0] + (b * N + k) * 12;
    o[0] = px;
    o[1] = py;
    o[2] = a.par[RP_H_REF];
    o[3] = (T)0;
    o[4] = (T)0;
    o[5] = yaw;
    o[6] = vwx;
    o[7] = vwy;
    o[8] = (T)0;
    o[9] = (T)0;
    o[10] = (T)0;
    o[11] = wz;
}

// ---- the swing reference of one foot (plan/swing.py::
// swing_foot_ref_reference): the quintic xy and sextic z from lift-off
// `lo` to touchdown `td` at phase s of a swing of T seconds, apex H / 64;
// pos, vel, acc at element o (and o + 1, o + 2) of the outputs.
template <typename T>
PLAN_FN void swing_eval(const T* lo, const T* td, T s, T Tsw, T H,
                        T* const* out, long long o)
{
    const T ds = (T)1 / clamp_min(Tsw, (T)1e-6);
    const T s2 = s * s, s3 = s * s * s;
    const T s4 = p_pow(s, (T)4), s5 = p_pow(s, (T)5);
    const T blend = (T)10 * s3 - (T)15 * s4 + (T)6 * s5;
    const T dblend = ((T)30 * s2 - (T)60 * s3 + (T)30 * s4) * ds;
    const T ddblend = ((T)60 * s - (T)180 * s2 + (T)120 * s3) * ds * ds;
    const T one = (T)1 - s;
    const T one2 = one * one, one3 = one * one * one;
    for (int c = 0; c < 2; ++c) {
        const T d = td[c] - lo[c];
        out[SO_POS][o + c] = lo[c] + d * blend;
        out[SO_VEL][o + c] = d * dblend;
        out[SO_ACC][o + c] = d * ddblend;
    }
    out[SO_POS][o + 2] = H * s3 * one3;
    out[SO_VEL][o + 2] = H * ((T)3 * s2 * one3 - (T)3 * s3 * one2) * ds;
    out[SO_ACC][o + 2] = H * ((T)6 * s * one3 - (T)18 * s2 * one2
                              + (T)6 * s3 * one) * ds * ds;
}

// plan/swing.py::swing_foot_ref for foot f of scenario b.  pos, vel, acc
// (B, 4, 3).
template <typename T>
PLAN_FN void swing_foot(const SwingArgs<T>& a, long long b, int f)
{
    swing_eval(a.template row<T>(SI_LIFT, b) + 3 * f,
               a.template row<T>(SI_TD, b) + 3 * f,
               a.template row<T>(SI_S, b)[f], a.template row<T>(SI_T, b)[f],
               a.par[SP_H64], a.out, (b * FEET + f) * 3);
}

// ---- plan/swing.py::swing_reference_at for foot f of scenario b: the
// foot's steps since lift-off and swing duration from the gait tables, the
// swing's seconds T = dur dt and phase s = (back + t_frac) / max(dur, 1)
// (0 in stance), each one rounding as in the plain chain, then the
// reference as swing_foot's.
template <typename T>
PLAN_FN void swing_at_foot(const SwingAtArgs<T>& a, const int* tables,
                           long long b, int f)
{
    const int g = *a.template row<int>(SA_GAIT, b);
    const int ph = *a.template row<int>(SA_PHASE, b);
    const T back = (T)swing_back(tables, g, ph, f);
    const T dur = (T)swing_dur(tables, g, ph, f);
    const T tf = *a.template row<T>(SA_TFRAC, b);
    const T s = dur > (T)0 ? (back + tf) / clamp_min(dur, (T)1) : (T)0;
    swing_eval(a.template row<T>(SA_LIFT, b) + 3 * f,
               a.template row<T>(SA_TD, b) + 3 * f, s, dur * a.par[SAP_DT],
               a.par[SAP_H64], a.out, (b * FEET + f) * 3);
}

}  // namespace planner
"""

FIRST_PLANNER_CU = r"""// The planner's four kernels — CUDA, sm_90a, built with -fmad=false.
//
//   plan_footsteps: plan/footsteps.py::plan_footsteps_horizon, a thread per
//                   (scenario, foot): the 16-step horizon loop, the Raibert
//                   target at each swing -> stance transition, the first
//                   one kept as the next touchdown;
//   plan_rollout:   mpc/srb.py::reference_rollout, a thread per (scenario,
//                   step): the commanded-velocity rollout up to its step;
//   plan_swing:     plan/swing.py::swing_foot_ref, a thread per (scenario,
//                   foot): the quintic xy / sextic z reference and its
//                   derivatives;
//   plan_swing_at:  plan/swing.py::swing_reference_at, the same reference
//                   at a control tick with its whole per-tick chain, a
//                   thread per (scenario, foot): the foot's steps since
//                   lift-off and swing duration from the gait tables, the
//                   swing's seconds and phase, then plan_swing's
//                   evaluation.  With plan_swing and its plain prelude
//                   (the tables' gathers, T = dur dt, the phase's where
//                   and division) the host's swing graph was 17 kernels a
//                   tick, each a CUDA graph node of 1.3-1.9 us at B = 1.
//
// The JAX package has no Pallas kernel here: XLA fuses each of these chains
// under `jax.jit` (mpctsid_tpu/plan/footsteps.py:37, mpc/srb.py:53,
// plan/swing.py:14).  Op by op the plain PyTorch chains are about 911, 276,
// 56 and 72 kernels a call (the swing reference at a tick: its prelude's 16
// and the reference's 56), each 1.3-1.9 us of a CUDA graph's replay at
// B = 1.
//
// What bounds them on this card: neither bytes nor operations.  Per
// scenario the footstep horizon reads 20 values and writes 204, the rollout
// reads 6 and writes 192, the swing reference reads 32 and writes 36 (at a
// tick it reads 27 and 8 table entries); under 1,000 operations each.  At
// B = 1 a launch is one thread's chain of dependent steps (16 steps of sin,
// cos, sqrt): its latency is the time; at B = 4096 the writes (3.3 MB and
// 3.1 MB) are.  One thread per independent unit, 128 threads a block,
// nothing shared.  The rollout is a
// recursion over its 16 steps; a thread per step repeats the steps before
// its own (136 steps a scenario for 16) so that a warp writes 32
// consecutive rows of the output, not 32 rows 768 bytes apart.
//
// The arithmetic is planner.h's (shared with the CPU tests' g++ build),
// op by op the plain version's; -fmad=false keeps nvcc from contracting a
// product and a sum that PyTorch rounds apart.
//
// Launch: plan_<name>_launch(dtype, B, N, tables, in, stride, out, par,
// stream) with the arrays in planner.h's order (tables for the footsteps
// and the swing reference at a tick, N unused by the swing references);
// dtype 0 float, 1 double.
// Returns a cudaError_t (0 on success); launches on `stream` and allocates
// nothing.

#include <cuda_runtime.h>

#include "planner.h"

namespace {

constexpr int THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS)
plan_footsteps_kernel(const planner::FootArgs<T> a,
                      const int* __restrict__ tables, int N, int B)
{
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)B * planner::FEET) return;
    planner::footsteps_foot<T>(a, tables, N, t / planner::FEET,
                               (int)(t % planner::FEET));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
plan_rollout_kernel(const planner::RollArgs<T> a, int N, int B)
{
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)B * N) return;
    planner::rollout_step<T>(a, N, t / N, (int)(t % N));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
plan_swing_kernel(const planner::SwingArgs<T> a, int B)
{
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)B * planner::FEET) return;
    planner::swing_foot<T>(a, t / planner::FEET, (int)(t % planner::FEET));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
plan_swing_at_kernel(const planner::SwingAtArgs<T> a,
                     const int* __restrict__ tables, int B)
{
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)B * planner::FEET) return;
    planner::swing_at_foot<T>(a, tables, t / planner::FEET,
                              (int)(t % planner::FEET));
}

int blocks_of(long long threads)
{
    return (int)((threads + THREADS - 1) / THREADS);
}

template <typename T>
int footsteps(int B, int N, const void* tables, const void* const* in,
              const long long* stride, void* const* out, const double* par,
              cudaStream_t stream)
{
    planner::FootArgs<T> a;
    planner::fill(a, in, stride, out, par);
    plan_footsteps_kernel<T><<<blocks_of((long long)B * planner::FEET),
                               THREADS, 0, stream>>>(
        a, static_cast<const int*>(tables), N, B);
    return (int)cudaGetLastError();
}

template <typename T>
int rollout(int B, int N, const void* const* in, const long long* stride,
            void* const* out, const double* par, cudaStream_t stream)
{
    planner::RollArgs<T> a;
    planner::fill(a, in, stride, out, par);
    plan_rollout_kernel<T><<<blocks_of((long long)B * N), THREADS, 0,
                             stream>>>(a, N, B);
    return (int)cudaGetLastError();
}

template <typename T>
int swing(int B, const void* const* in, const long long* stride,
          void* const* out, const double* par, cudaStream_t stream)
{
    planner::SwingArgs<T> a;
    planner::fill(a, in, stride, out, par);
    plan_swing_kernel<T><<<blocks_of((long long)B * planner::FEET), THREADS,
                           0, stream>>>(a, B);
    return (int)cudaGetLastError();
}

template <typename T>
int swing_at(int B, const void* tables, const void* const* in,
             const long long* stride, void* const* out, const double* par,
             cudaStream_t stream)
{
    planner::SwingAtArgs<T> a;
    planner::fill(a, in, stride, out, par);
    plan_swing_at_kernel<T><<<blocks_of((long long)B * planner::FEET),
                              THREADS, 0, stream>>>(
        a, static_cast<const int*>(tables), B);
    return (int)cudaGetLastError();
}

bool valid(int dtype, int B, int n_in, const void* const* in, int n_out,
           void* const* out)
{
    if ((dtype != 0 && dtype != 1) || B < 1) return false;
    for (int k = 0; k < n_in; ++k)
        if (in[k] == nullptr) return false;
    for (int k = 0; k < n_out; ++k)
        if (out[k] == nullptr) return false;
    return true;
}

}  // namespace

extern "C" {

// planner.h's counts (plan/kernels.py::LAYOUT)
int planner_layout(int what) { return planner::layout(what); }

int plan_footsteps_launch(int dtype, int B, int N, const void* tables,
                          const void* const* in, const long long* stride,
                          void* const* out, const double* par, void* stream)
{
    if (!valid(dtype, B, planner::FI_COUNT, in, planner::FO_COUNT, out)
        || tables == nullptr || N < 1)
        return (int)cudaErrorInvalidValue;
    return dtype == 0
        ? footsteps<float>(B, N, tables, in, stride, out, par,
                           (cudaStream_t)stream)
        : footsteps<double>(B, N, tables, in, stride, out, par,
                            (cudaStream_t)stream);
}

int plan_rollout_launch(int dtype, int B, int N, const void* tables,
                        const void* const* in, const long long* stride,
                        void* const* out, const double* par, void* stream)
{
    (void)tables;
    if (!valid(dtype, B, planner::RI_COUNT, in, 1, out) || N < 1)
        return (int)cudaErrorInvalidValue;
    return dtype == 0
        ? rollout<float>(B, N, in, stride, out, par, (cudaStream_t)stream)
        : rollout<double>(B, N, in, stride, out, par, (cudaStream_t)stream);
}

int plan_swing_launch(int dtype, int B, int N, const void* tables,
                      const void* const* in, const long long* stride,
                      void* const* out, const double* par, void* stream)
{
    (void)N;
    (void)tables;
    if (!valid(dtype, B, planner::SI_COUNT, in, planner::SO_COUNT, out))
        return (int)cudaErrorInvalidValue;
    return dtype == 0
        ? swing<float>(B, in, stride, out, par, (cudaStream_t)stream)
        : swing<double>(B, in, stride, out, par, (cudaStream_t)stream);
}

int plan_swing_at_launch(int dtype, int B, int N, const void* tables,
                         const void* const* in, const long long* stride,
                         void* const* out, const double* par, void* stream)
{
    (void)N;
    if (!valid(dtype, B, planner::SA_COUNT, in, planner::SO_COUNT, out)
        || tables == nullptr)
        return (int)cudaErrorInvalidValue;
    return dtype == 0
        ? swing_at<float>(B, tables, in, stride, out, par,
                          (cudaStream_t)stream)
        : swing_at<double>(B, tables, in, stride, out, par,
                           (cudaStream_t)stream);
}

const char* planner_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
"""


if __name__ == "__main__":
    sys.exit(main())
