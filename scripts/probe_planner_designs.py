#!/usr/bin/env python3
"""The planner's redesigned kernels against their first designs, on the
card: the swing reference over a period (`plan_swing_at`), the reference
rollout (`plan_rollout`), the footstep horizon (`plan_footsteps`) and the
period head with the footstep plan (`period_plan`).

    python3 scripts/probe_planner_designs.py [--kernels swing rollout
        footsteps head swingref] [--batch 4096] [--rounds 6] [--out DIR]

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
     copies with 64 and 256 threads a block;
  footsteps. the shipped kernel (a warp per scenario, a unit per (step,
     foot)) against the first design (a thread per (scenario, foot) looping
     over the horizon: FIRST_PLANNER_H / _CU), parted entries, then
     interleaved rounds at B = 1, 256 and --batch;
  head. the period plan (one launch: the head, the footsteps and the
     touchdown select) against the first designs' chain (the period head
     kept verbatim as `FIRST_PERIOD_HEAD_H` / `FIRST_PERIOD_HEAD_CU`, built
     as a copy with -fmad=false, then the first footstep kernel on its
     outputs and the select as a torch.where): every output's parted
     entries, and the shipped period head (the plan off) against the first;
     then interleaved rounds at B = 1, 256 and --batch of the first chain
     (three launches), the shipped chain (period_head, plan_footsteps, the
     select), one period_plan, and each period head alone;
  swingref. the shipped swing reference (`plan_swing`: a block 64
     scenarios, a unit per (scenario, foot) into staging rows, the rows
     stored 16 bytes a thread) against its first design (a thread per
     (scenario, foot) storing its values where they lie: FIRST_PLANNER_H /
     _CU), parted entries, then interleaved rounds at B = 1, 256 and
     --batch.

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
from mpctsid_tpu_torch.cascade import CascadeConfigured, engine  # noqa: E402
from mpctsid_tpu_torch.config import EngineConfig  # noqa: E402
from mpctsid_tpu_torch.dyn import kernels as dk  # noqa: E402
from mpctsid_tpu_torch.model.solo12 import SOLO12  # noqa: E402
from mpctsid_tpu_torch.mpc import srb  # noqa: E402
from mpctsid_tpu_torch.plan import footsteps as fs  # noqa: E402
from mpctsid_tpu_torch.plan import kernels as pk  # noqa: E402
from mpctsid_tpu_torch.plan.gait import contacts_at  # noqa: E402
from mpctsid_tpu_torch.plan import swing  # noqa: E402
from mpctsid_tpu_torch.qp import _build  # noqa: E402

PARTS = ["swing", "rollout", "footsteps", "head", "swingref"]
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
        "first period head": dict(
            subs=lambda _: FIRST_PERIOD_HEAD_CU, source="period_head.cu",
            csrc=dk.CSRC, flags=dk.FLAGS["period_head"],
            header_subs={"period_head.h": lambda _: FIRST_PERIOD_HEAD_H}),
    }


def launcher(lib, kernel: str, argtypes=pk.LAUNCH_ARGTYPES):
    """plan_<kernel>_launch of a built copy (<kernel>_launch where
    `argtypes` are dyn/kernels.py's), on the current stream (the wrappers'
    `launch_fn`: the C signature less the stream)."""
    fn = getattr(lib, f"plan_{kernel}_launch" if argtypes is
                 pk.LAUNCH_ARGTYPES else f"{kernel}_launch")
    fn.argtypes = argtypes + [pk._PTR]
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


def probe_footsteps(record, B_max, rounds, libs, device):
    cfg = EngineConfig()
    d = cs.planner_inputs(B_max, 70)
    first = launcher(libs["first design"], "footsteps")

    def args(B, dtype):
        t = tensors(d, B, dtype, device)
        feet = torch.tensor(d["feet"][:B], dtype=dtype, device=device)
        return (SOLO12, cfg.mpc, cfg.cascade, t["gid"], t["phase"], t["x"],
                t["v_cmd"], feet)
    for B in (*BITS_B, B_max):
        for dtype in (torch.float32, torch.float64):
            a = args(B, dtype)
            got = fs.plan_footsteps_horizon(*a)
            want = checked(fs.run_footsteps(first, *a))
            record("footsteps_bits", B=B, dtype=str(dtype)[6:],
                   parted=parted(got, want),
                   entries=sum(w.numel() for w in want))
    for B in (*TIMED_B, B_max):
        a = args(B, torch.float32)
        fns = {"first design": lambda: checked(fs.run_footsteps(first, *a)),
               "new": lambda: fs.plan_footsteps_horizon(*a),
               "launch floor (one fill_)": floor_fn(device)}
        replays = {k: pkd.graphed(f) for k, f in fns.items()}
        ms = pkd.interleaved(record, "footsteps_times", replays, rounds, B=B)
        record("footsteps_summary", B=B, ms=ms,
               bound_ms=cs.plan_bounds(B, d, cfg.mpc.horizon)[
                   "plan_footsteps_horizon"][0])


def probe_swingref(record, B_max, rounds, libs, device):
    h = EngineConfig().cascade.swing_height
    d = cs.planner_inputs(B_max, 70)
    first = launcher(libs["first design"], "swing")

    def args(B, dtype):
        t = lambda a: torch.tensor(a[:B], dtype=dtype,  # noqa: E731
                                   device=device)
        return (t(d["lift"]), t(d["td"]), t(d["s"]), t(d["T"]), h)
    for B in (*BITS_B, 64, 65, B_max):
        for dtype in (torch.float32, torch.float64):
            a = args(B, dtype)
            got = swing.swing_foot_ref(*a)
            want = checked(swing.run_swing(first, *a))
            record("swingref_bits", B=B, dtype=str(dtype)[6:],
                   parted=parted(got, want),
                   entries=sum(w.numel() for w in want))
    for B in (*TIMED_B, B_max):
        a = args(B, torch.float32)
        fns = {"first design": lambda: checked(swing.run_swing(first, *a)),
               "new": lambda: swing.swing_foot_ref(*a),
               "launch floor (one fill_)": floor_fn(device)}
        replays = {k: pkd.graphed(f) for k, f in fns.items()}
        ms = pkd.interleaved(record, "swingref_times", replays, rounds, B=B)
        record("swingref_summary", B=B, ms=ms,
               bound_ms=cs.plan_bounds(B, d, 16)["swing_foot_ref"][0])


def probe_head(record, B_max, rounds, libs, device):
    cfg = EngineConfig()
    tree = CascadeConfigured(SOLO12, cfg).tree
    d = cs.planner_inputs(B_max, 70)
    head_first = launcher(libs["first period head"], "period_head",
                          dk.LAUNCH_ARGTYPES)
    foot_first = launcher(libs["first design"], "footsteps")

    def args(B, dtype):
        q, v, ts, lo, vi, vc = cs.period_head_inputs(B, 70 + B, dtype,
                                                     device)
        t = tensors(d, B, dtype, device)
        return t["gid"], t["phase"], q, v, ts, lo, t["td"], vi, vc

    def first_chain(gid, ph, q, v, ts, lo, td, vi, vc):
        h = checked(engine.run_period_head(head_first, tree, cfg.cascade, q,
                                           v, ts, lo, vi, vc))
        f, ntd = checked(fs.run_footsteps(foot_first, SOLO12, cfg.mpc,
                                          cfg.cascade, gid, ph, h[1], h[4],
                                          h[0]))
        swing = contacts_at(gid, ph, q.dtype) < 0.5
        return (*h, f, ntd, torch.where(swing[..., None], ntd, td))

    def new_chain(gid, ph, q, v, ts, lo, td, vi, vc):
        h = engine.period_head(tree, cfg.cascade, q, v, ts, lo, vi, vc)
        f, ntd = fs.plan_footsteps_horizon(SOLO12, cfg.mpc, cfg.cascade, gid,
                                           ph, h[1], h[4], h[0])
        swing = contacts_at(gid, ph, q.dtype) < 0.5
        return (*h, f, ntd, torch.where(swing[..., None], ntd, td))

    def plan(a):
        return engine.period_plan(SOLO12, tree, cfg, *a)

    for B in (*BITS_B, B_max):
        for dtype in (torch.float32, torch.float64):
            a = args(B, dtype)
            got, want = plan(a), first_chain(*a)
            head_new = engine.period_head(tree, cfg.cascade, *a[2:6],
                                          *a[7:])
            record("head_bits", B=B, dtype=str(dtype)[6:],
                   plan_vs_first_chain_parted=[parted([g], [w])
                                               for g, w in zip(got, want)],
                   plan_vs_new_chain_parted=parted(got, new_chain(*a)),
                   head_vs_first_parted=parted(head_new, want[:5]),
                   entries=sum(w.numel() for w in want))
    for B in (*TIMED_B, B_max):
        a = args(B, torch.float32)
        fns = {"first designs: head, footsteps, select (3 launches)":
               lambda: first_chain(*a),
               "new: period_head, plan_footsteps, select (3 launches)":
               lambda: new_chain(*a),
               "new: period_plan (one launch)": lambda: plan(a),

               "first period head alone": lambda: checked(
                   engine.run_period_head(head_first, tree, cfg.cascade,
                                          *a[2:6], *a[7:])),
               "new period head alone (the plan off)":
               lambda: engine.period_head(tree, cfg.cascade, *a[2:6],
                                          *a[7:]),
               "launch floor (one fill_)": floor_fn(device)}
        replays = {k: pkd.graphed(f) for k, f in fns.items()}
        ms = pkd.interleaved(record, "head_times", replays, rounds, B=B)
        record("head_summary", B=B, ms=ms,
               bound_ms_plan=cs.period_plan_bound_ms(B, d["gid"],
                                                     d["phase"])[0],
               bound_ms_head=cs.period_head_bound_ms(B)[0])


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
    # the shipped libraries and every copy, their nvcc processes together
    _build.build_libraries(pk.build_specs() + dk.build_specs())
    libs = pkd.build_variants(variant_specs(), build)
    report = {"card": smi, "batch": a.batch, "swing_bits": [],
              "swing_variant_bits": [], "swing_times": [],
              "swing_summary": [], "rollout_bits": [],
              "rollout_variant_bits": [], "rollout_times": [],
              "rollout_summary": [], "footsteps_bits": [],
              "footsteps_times": [], "footsteps_summary": [],
              "head_bits": [], "head_times": [], "head_summary": [],
              "swingref_bits": [], "swingref_times": [],
              "swingref_summary": []}

    def record(kind, **row):
        report[kind].append(row)
        print(f"  {kind}: {row}  [{smi}]", flush=True)

    print(f"[{smi}] B={a.batch}", flush=True)
    if "swing" in a.kernels:
        probe_swing(record, a.batch, a.rounds, libs, device)
    if "rollout" in a.kernels:
        probe_rollout(record, a.batch, a.rounds, libs, device)
    if "footsteps" in a.kernels:
        probe_footsteps(record, a.batch, a.rounds, libs, device)
    if "head" in a.kernels:
        probe_head(record, a.batch, a.rounds, libs, device)
    if "swingref" in a.kernels:
        probe_swingref(record, a.batch, a.rounds, libs, device)
    bits = ([r["period_vs_first_parted"] + r["at_vs_first_parted"]
             for r in report["swing_bits"]]
            + [r["parted"] for r in report["rollout_bits"]
               + report["swing_variant_bits"]
               + report["rollout_variant_bits"]
               + report["footsteps_bits"] + report["swingref_bits"]]
            + [sum(r["plan_vs_first_chain_parted"])
               + r["plan_vs_new_chain_parted"]
               + r["head_vs_first_parted"] for r in report["head_bits"]])
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


# ---------------------------------------------- the period head's first
# design: period_head.h and period_head.cu as they were before the plan
# went into it, verbatim

FIRST_PERIOD_HEAD_H = r"""// The per-scenario body of the period-head kernel (period_head.cu): what
// a controller computes of the measured state once per MPC period, before
// the footstep plan (cascade/engine.py::period_head):
//
//   feet_now  = foot_positions(q)                       (4 x 3, world)
//   x_srb     = srb_state(q, v) = [p, rpy, R0 v_lin, R0 w]   (12)
//   liftoff'  = to_swing > 0.5 ? feet_now : liftoff      (4 x 3)
//   v_meas    = [cy vx_w + sy vy_w, -sy vx_w + cy vy_w, wz_w], yaw = rpy[2]
//   v_int'    = clamp(v_int + gain (v_cmd - v_meas), -v_max, v_max)
//   v_used    = v_cmd + v_int'
//
// with gain = ki_vint * t_period.  The leg kinematics are rbd.h's
// `kin_unit` (the WBC build's and the plant step's), not a copy: lanes 0-3
// run one leg each.  Then lanes 0-11 take the feet and the lift-off select,
// lanes 12-23 the SRB state (a lane an entry), lanes 0-2 the integrator.
// The phases run through rbd.h's executors: on the card a warp per
// scenario (`WarpExec`, `__syncwarp()` between phases), on the host the 32
// lanes one after another in either order (`HostExec`), so the CPU tests
// build this arithmetic with g++ (tests/test_torch_period_head_kernel.py).
// No unit reads what another lane writes in its own phase.
//
// Bits.  The plain version (engine.py::period_head_reference) takes the
// rotations through `torch.bmm` / broadcast matmuls and atan2 / asin from
// PyTorch's math library; here they are rbd.h's products and the CUDA math
// library's: held to it within a tolerance.  The library is built with
// -fmad=false, so the integrator's products and sums round as the plain
// version's elementwise ops do.

#pragma once

#include "rbd.h"

namespace rbd {
namespace head {

// operands, in the order of the launcher's arrays: each input a first row
// and a stride between scenarios (rbd::Args), each output contiguous (B, ...)
enum In { HI_Q, HI_V, HI_TO_SWING, HI_LIFTOFF, HI_V_INT, HI_V_CMD, HI_COUNT };
enum Out { HO_FEET, HO_X_SRB, HO_LIFTOFF, HO_V_INT, HO_V_USED, HO_COUNT };
// gain = ki_vint * t_period; the integrator's bound v_int_max
enum Par { HP_GAIN, HP_V_INT_MAX, HP_COUNT };

// what dyn/kernels.py checks (HEAD_LAYOUT): after rbd.h's own counts,
// the head's inputs, outputs and parameters
inline int layout(int what)
{
    if (what < L_PLANT_PAR + 1) return ::rbd::layout(what);
    switch (what - (L_PLANT_PAR + 1)) {
    case 0: return HI_COUNT;
    case 1: return HO_COUNT;
    case 2: return HP_COUNT;
    default: return -1;
    }
}

template <typename T> using HeadArgs = Args<T, HI_COUNT, HO_COUNT, HP_COUNT>;

// a warp's slot of shared memory
template <typename T>
struct HeadSlot {
    Kin<T> k;
    T x[12];    // x_srb
};

// NaN-propagating clamp, as torch.clamp
template <typename T>
RBD_FN T clamp_nan(T v, T lo, T hi)
{
    return v != v ? v : (v < lo ? lo : (v > hi ? hi : v));
}

// entry e of x_srb (lanes 12-23, e = lane - 12)
template <typename T>
RBD_FN T srb_entry(int e, const T* q, const T* v, const T* R)
{
    if (e < 3) return q[e];
    if (e < 6) {
        T rpy[3];
        rot_to_rpy(R, rpy);
        return rpy[e - 3];
    }
    const T* w = e < 9 ? v : v + 3;
    const int i = (e - 6) % 3;
    return R[3 * i] * w[0] + R[3 * i + 1] * w[1] + R[3 * i + 2] * w[2];
}

// the whole body of one scenario b
template <typename T, class Exec>
RBD_FN void period_head_warp(const Exec& ex, const T* C,
                             const HeadArgs<T>& a, long long b,
                             HeadSlot<T>& S)
{
    const T* q = a.row(HI_Q, b);
    const T* v = a.row(HI_V, b);
    RBD_EACH_LANE(ex, lane) kin_unit(lane, C, q, S.k);
    ex.sync();
    RBD_EACH_LANE(ex, lane) {
        if (lane < 12) {
            const int leg = lane / 3, i = lane % 3;
            const T f = S.k.p[leg][3][i];
            const T sw = a.row(HI_TO_SWING, b)[leg];
            a.out[HO_FEET][b * 12 + lane] = f;
            a.out[HO_LIFTOFF][b * 12 + lane] =
                sw > T(0.5) ? f : a.row(HI_LIFTOFF, b)[lane];
        } else if (lane < 24) {
            const T x = srb_entry(lane - 12, q, v, S.k.R0);
            S.x[lane - 12] = x;
            a.out[HO_X_SRB][b * 12 + lane - 12] = x;
        }
    }
    ex.sync();
    RBD_EACH_LANE(ex, lane) {
        if (lane < 3) {
            T sy, cy;
            r_sincos(S.x[5], &sy, &cy);
            const T vm = lane == 0 ? cy * S.x[6] + sy * S.x[7]
                         : (lane == 1 ? -sy * S.x[6] + cy * S.x[7]
                                      : S.x[11]);
            const T vc = a.row(HI_V_CMD, b)[lane];
            const T vmax = a.par[HP_V_INT_MAX];
            const T vi = clamp_nan(
                a.row(HI_V_INT, b)[lane] + a.par[HP_GAIN] * (vc - vm),
                -vmax, vmax);
            a.out[HO_V_INT][b * 3 + lane] = vi;
            a.out[HO_V_USED][b * 3 + lane] = vc + vi;
        }
    }
}

}  // namespace head
}  // namespace rbd
"""

FIRST_PERIOD_HEAD_CU = r"""// The period head in one launch — CUDA, sm_90a.
//
// Computes cascade/engine.py::period_head for a batch: the foot positions,
// the SRB state, the lift-off select and the offset-free velocity
// integrator of a period boundary (period_head.h says what and how).  The
// JAX package has no Pallas kernel here: its cascade leaves these ops to
// XLA under `jax.jit` (mpctsid_tpu/cascade/engine.py:66, :176), and its
// host path runs them as eager device ops and numpy
// (mpctsid_tpu/host.py:269-290).  Run op by op the plain PyTorch chain is
// about 170 kernels (the LegKin chain, quat_to_rot, rot_to_rpy, two bmm,
// the stacks and the integrator), each 1.3-1.9 us of a CUDA graph's replay
// at B = 1: the node count, not the arithmetic, is the stage's time.
//
// What bounds it on this card: bytes.  Per scenario it reads 59 values
// (q, v, the lift-off mask and positions, v_int, v_cmd) and writes 42, for
// about 700 operations (chip_smoke.py::period_head_bound_ms).
//
// Design (first): a warp per scenario, rbd::warps_per_block's number a
// block (the WBC build's layout; dyn/kernels.py::rbd_layout), each warp
// with its slot (rbd::head::HeadSlot: the leg kinematics and x_srb, 288
// values).  float and double.
//
// Launch: period_head_launch(dtype, B, consts, in, stride, out, par,
// stream) with the arrays in period_head.h's In / Out / Par order; dtype 0
// float, 1 double.  Returns a cudaError_t (0 on success); launches on
// `stream` and allocates nothing.

#include <cuda_runtime.h>

#include "period_head.h"

namespace {

template <typename T>
__global__ void __launch_bounds__(rbd::WARP * rbd::MAX_WARPS)
period_head_kernel(const T* __restrict__ consts,
                   const rbd::head::HeadArgs<T> args, int B, int slot)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x / rbd::WARP;
    const long long b =
        (long long)blockIdx.x * (blockDim.x / rbd::WARP) + warp;
    if (b >= B) return;
    rbd::WarpExec ex;
    rbd::head::period_head_warp<T>(
        ex, consts, args, b,
        *reinterpret_cast<rbd::head::HeadSlot<T>*>(
            smem + (size_t)warp * slot));
}

int last_layout[3];   // warps a block, blocks, shared bytes a block

template <typename T>
int launch(int B, const void* consts, const void* const* in,
           const long long* stride, void* const* out, const double* par,
           cudaStream_t stream)
{
    rbd::head::HeadArgs<T> a;
    for (int k = 0; k < rbd::head::HI_COUNT; ++k) {
        a.in[k] = static_cast<const T*>(in[k]);
        a.stride[k] = stride[k];
    }
    for (int k = 0; k < rbd::head::HO_COUNT; ++k)
        a.out[k] = static_cast<T*>(out[k]);
    for (int k = 0; k < rbd::head::HP_COUNT; ++k) a.par[k] = (T)par[k];
    int dev, optin, n_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    const int slot =
        rbd::slot_bytes((int)sizeof(rbd::head::HeadSlot<T>));
    const int g = rbd::warps_per_block(B, slot, optin, n_sm);
    if (g < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (B + g - 1) / g, smem = g * slot;
    period_head_kernel<T><<<blocks, g * rbd::WARP, smem, stream>>>(
        static_cast<const T*>(consts), a, B, slot);
    last_layout[0] = g;
    last_layout[1] = blocks;
    last_layout[2] = smem;
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rbd.h's counts, then the head's (dyn/kernels.py::LAYOUT, HEAD_LAYOUT)
int period_head_layout(int what) { return rbd::head::layout(what); }

// values (floats or doubles) of a warp's slot: rbd::head::HeadSlot
int period_head_slot_values()
{
    static_assert(sizeof(rbd::head::HeadSlot<double>)
                  == 2 * sizeof(rbd::head::HeadSlot<float>),
                  "slot of values");
    return (int)(sizeof(rbd::head::HeadSlot<float>) / sizeof(float));
}

// the last launch's warps a block (0), blocks (1), shared bytes a block (2)
int period_head_last_layout(int what)
{
    return what >= 0 && what < 3 ? last_layout[what] : -1;
}

int period_head_launch(int dtype, int B, const void* consts,
                       const void* const* in, const long long* stride,
                       void* const* out, const double* par, void* stream)
{
    if (B < 1 || consts == nullptr) return (int)cudaErrorInvalidValue;
    for (int k = 0; k < rbd::head::HI_COUNT; ++k)
        if (in[k] == nullptr) return (int)cudaErrorInvalidValue;
    for (int k = 0; k < rbd::head::HO_COUNT; ++k)
        if (out[k] == nullptr) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch<float>(B, consts, in, stride, out, par,
                             (cudaStream_t)stream);
    if (dtype == 1)
        return launch<double>(B, consts, in, stride, out, par,
                              (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

const char* period_head_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
"""


if __name__ == "__main__":
    sys.exit(main())
