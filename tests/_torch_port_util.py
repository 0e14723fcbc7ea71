"""Shared helpers of the tests/test_torch_*.py parity tests.

Inputs are made with numpy from a seed and handed to both packages: to the
JAX package as float32 jax arrays (batched with jax.vmap, as its callers do),
to the port as float32 CPU tensors with the scenario axis written out.
"""

import dataclasses

import numpy as np
import torch

import jax.numpy as jnp

from mpctsid_tpu_torch.model.solo12 import SOLO12

# small shapes, several pytest workers: one intra-op thread each is fastest
torch.set_num_threads(1)

F32 = jnp.float32


def tt(a):
    """numpy -> float32 CPU tensor."""
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def jj(a):
    """numpy -> float32 jax array."""
    return jnp.asarray(np.asarray(a), F32)


def npy(t):
    """tensor or jax array -> numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def fields_to_numpy(state):
    """{field name: numpy array} of a (JAX or torch) state dataclass."""
    return {f.name: npy(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def random_qv(seed, B, spread=0.3):
    """Random full states near standing: q (B, 19) with unit quaternions, v
    (B, 18).  Feet land within a few cm of the ground plane, some below it."""
    r = np.random.default_rng(seed)
    q = np.zeros((B, 19))
    q[:, 0:2] = r.normal(size=(B, 2)) * 0.2
    q[:, 2] = SOLO12.h_ref + r.normal(size=B) * 0.01
    quat = np.concatenate([r.normal(size=(B, 3)) * 0.08, np.ones((B, 1))], 1)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] = SOLO12.q_stand + r.normal(size=(B, 12)) * spread * 0.5
    v = r.normal(size=(B, 18)) * spread
    return q.astype(np.float32), v.astype(np.float32)


def standing_q0(B):
    q0 = np.zeros((B, 19), np.float32)
    q0[:, 2] = SOLO12.h_ref
    q0[:, 6] = 1.0
    q0[:, 7:] = SOLO12.q_stand
    return q0



def random_qp(seed, n=24, m=40, eq=True):
    """The generator of tests/test_pallas_admm.py, as numpy arrays."""
    r = np.random.default_rng(seed)
    Q = r.normal(size=(n, n))
    P = Q @ Q.T / n + 0.1 * np.eye(n)
    q = r.normal(size=n)
    A = r.normal(size=(m, n))
    x_feas = r.normal(size=n) * 0.1
    margin = np.abs(r.normal(size=m)) + 0.1
    l = A @ x_feas - margin
    u = A @ x_feas + margin
    if eq:
        l[:4] = u[:4] = (A @ x_feas)[:4]
    return [np.asarray(a, np.float32) for a in (P, q, A, l, u)]


def stacked(seeds, **kw):
    qps = [random_qp(s, **kw) for s in seeds]
    return [np.stack([qp[i] for qp in qps]) for i in range(5)]


def build_packed_slot_floats(directory):
    """packed_slot::slot_floats of mpctsid_tpu_torch/qp/csrc/packed_slot.h
    (the count kernel 3's library exports as `admm_packed_slot_floats`),
    built with the host compiler into `directory`; a ctypes function
    (path, n, m) -> floats."""
    import ctypes
    import subprocess
    from pathlib import Path

    from mpctsid_tpu_torch.qp import _build

    d = Path(directory)
    cc = d / "slot.cc"
    cc.write_text('#include "packed_slot.h"\n'
                  'extern "C" int slot_floats(int path, int n, int m)\n'
                  '{ return packed_slot::slot_floats(path, n, m); }\n')
    so = d / "libslot.so"
    subprocess.run(["g++", "-std=c++17", "-shared", "-fPIC", "-O1", "-I",
                    str(_build.CSRC), "-o", str(so), str(cc)], check=True)
    fn = ctypes.CDLL(str(so)).slot_floats
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn



RBD_HARNESS = r'''
#include "rbd.h"

namespace {

template <typename T, int NI, int NO, int NP>
void fill(rbd::Args<T, NI, NO, NP>& a, const void* const* in,
          const long long* stride, void* const* out, const double* par)
{
    for (int k = 0; k < NI; ++k) {
        a.in[k] = static_cast<const T*>(in[k]);
        a.stride[k] = stride[k];
    }
    for (int k = 0; k < NO; ++k) a.out[k] = static_cast<T*>(out[k]);
    for (int k = 0; k < NP; ++k) a.par[k] = (T)par[k];
}

// a scenario at a time, its warp's lanes one after another (reversed when
// `reverse`), in a fresh slot filled with NaN: a unit that read what no
// earlier phase wrote would show
template <typename T>
int wbc(int B, const void* consts, const void* const* in,
        const long long* stride, void* const* out, const double* par,
        bool reverse)
{
    rbd::WbcArgs<T> a;
    fill(a, in, stride, out, par);
    rbd::HostExec ex{reverse};
    for (long long b = 0; b < B; ++b) {
        rbd::WbcSlot<T> S;
        T* raw = reinterpret_cast<T*>(&S);
        for (size_t i = 0; i < sizeof(S) / sizeof(T); ++i) raw[i] = NAN;
        rbd::wbc_build_warp<T>(ex, static_cast<const T*>(consts), a, b, S);
    }
    return 0;
}

template <typename T>
int plant(int B, const void* consts, const void* const* in,
          const long long* stride, void* const* out, const double* par,
          bool reverse)
{
    rbd::PlantArgs<T> a;
    fill(a, in, stride, out, par);
    rbd::HostExec ex{reverse};
    for (long long b = 0; b < B; ++b) {
        rbd::PlantSlot<T> S;
        T* raw = reinterpret_cast<T*>(&S);
        for (size_t i = 0; i < sizeof(S) / sizeof(T); ++i) raw[i] = NAN;
        rbd::plant_step_warp<T>(ex, static_cast<const T*>(consts), a, b, S);
    }
    return 0;
}

}  // namespace

extern "C" {

int rbd_layout(int what) { return rbd::layout(what); }

// values of a warp's slot: the build's (kind 0), the plant's (1)
int rbd_slot_values(int kind)
{
    return kind == 0 ? (int)(sizeof(rbd::WbcSlot<float>) / sizeof(float))
                     : (int)(sizeof(rbd::PlantSlot<float>) / sizeof(float));
}

int rbd_warps_per_block(long long B, int slot, int smem_optin, int n_sm)
{
    return rbd::warps_per_block(B, slot, smem_optin, n_sm);
}

#define RBD_ENTRY(name, body, reverse)                                     \
    int name(int dtype, int B, const void* consts, const void* const* in,  \
             const long long* stride, void* const* out, const double* par) \
    {                                                                      \
        return dtype == 0                                                  \
                   ? body<float>(B, consts, in, stride, out, par, reverse) \
                   : body<double>(B, consts, in, stride, out, par,         \
                                  reverse);                                \
    }

RBD_ENTRY(wbc_build_host, wbc, false)
RBD_ENTRY(plant_step_host, plant, false)
RBD_ENTRY(wbc_build_host_reversed, wbc, true)
RBD_ENTRY(plant_step_host_reversed, plant, true)

}
'''


def build_rbd_harness(directory):
    """mpctsid_tpu_torch/dyn/csrc/rbd.h, the warp-per-scenario core of the
    WBC-build and plant-step kernels, built with the host compiler into
    `directory`: each scenario's units run lane after lane between the
    phases (rbd::HostExec), with the kernels' C signature (less the
    stream).  Returns a namespace of ctypes functions: `wbc_build`,
    `plant_step` (the lanes in order) and `wbc_build_reversed`,
    `plant_step_reversed` (in reverse), which `wbc.tsid.run_wbc_build` /
    `env.plant.run_plant_step` take; `layout` (rbd.h's counts),
    `slot_values(kind)` (0 the build's slot, 1 the plant's) and
    `warps_per_block(B, slot bytes, shared bytes a block, SMs)`."""
    import ctypes
    import subprocess
    import types
    from pathlib import Path

    from mpctsid_tpu_torch.dyn import kernels

    d = Path(directory)
    cc = d / "rbd_harness.cc"
    cc.write_text(RBD_HARNESS)
    so = d / "librbd_harness.so"
    subprocess.run(["g++", "-std=c++17", "-shared", "-fPIC", "-O2", "-I",
                    str(kernels.CSRC), "-o", str(so), str(cc)], check=True)
    lib = ctypes.CDLL(str(so))
    fns = {}
    for name in ("wbc_build", "plant_step"):
        for tag in ("", "_reversed"):
            fn = getattr(lib, f"{name}_host{tag}")
            fn.argtypes = kernels.LAUNCH_ARGTYPES
            fn.restype = ctypes.c_int
            fns[name + tag] = fn
    lib.rbd_layout.argtypes = [ctypes.c_int]
    lib.rbd_layout.restype = ctypes.c_int
    lib.rbd_slot_values.argtypes = [ctypes.c_int]
    lib.rbd_slot_values.restype = ctypes.c_int
    lib.rbd_warps_per_block.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 3
    lib.rbd_warps_per_block.restype = ctypes.c_int
    return types.SimpleNamespace(layout=lib.rbd_layout,
                                 slot_values=lib.rbd_slot_values,
                                 warps_per_block=lib.rbd_warps_per_block,
                                 **fns)


PLANNER_HARNESS = r'''
#include <limits>
#include <vector>

#include "planner.h"

namespace {

// the footstep kernel's warps one after another, each scenario's lanes in
// order or reversed (planner::HostExec) from NaN-filled staging rows
template <typename T>
int footsteps_warps(bool reverse, int B, int N, const void* tables,
                    const void* const* in, const long long* stride,
                    void* const* out, const double* par)
{
    planner::FootArgs<T> a;
    planner::fill(a, in, stride, out, par);
    alignas(16) T stage[planner::FOOT_CHUNK * 12];
    for (long long b = 0; b < B; ++b) {
        for (auto& v : stage) v = std::numeric_limits<T>::quiet_NaN();
        const planner::FootScene<T> s{
            a.template row<T>(planner::FI_X, b),
            a.template row<T>(planner::FI_VCMD, b),
            a.template row<T>(planner::FI_FEET, b),
            *a.template row<int>(planner::FI_GAIT, b),
            *a.template row<int>(planner::FI_PHASE, b)};
        planner::footsteps_warp(planner::HostExec{reverse},
                                static_cast<const int*>(tables), N, s, a.par,
                                stage, a.out[planner::FO_FEET] + b * N * 12,
                                a.out[planner::FO_TD] + b * 12);
    }
    return 0;
}

template <typename T>
int footsteps(int B, int N, const void* tables, const void* const* in,
              const long long* stride, void* const* out, const double* par)
{
    return footsteps_warps<T>(false, B, N, tables, in, stride, out, par);
}

template <typename T>
int footsteps_reversed(int B, int N, const void* tables,
                       const void* const* in, const long long* stride,
                       void* const* out, const double* par)
{
    return footsteps_warps<T>(true, B, N, tables, in, stride, out, par);
}

// the rollout's pieces for scenario b, glued as the kernel glues them
// (its chunks of G lanes; the terms handed over by an array where the
// kernel's lanes shuffle them)
template <typename T>
void rollout_scenario(const planner::RollArgs<T>& a, int N, long long b)
{
    const T* x = a.template row<T>(planner::RI_X, b);
    const T* vc = a.template row<T>(planner::RI_VCMD, b);
    const T dt = a.par[planner::RP_DT];
    const bool fused = a.par[planner::RP_FUSED_BMM] != (T)0;
    const int G = planner::rollout_lanes(N);
    planner::RollTerm<T> terms[32];
    T px = x[0], py = x[1], yaw = x[5];
    for (int c0 = 0; c0 < N; c0 += G) {
        for (int l = 0; l < G; ++l)
            terms[l] = planner::rollout_term(yaw, l, vc[2], dt, vc[0], vc[1],
                                             fused);
        T last_x = px, last_y = py;
        for (int l = 0; l < G; ++l) {
            T qx = px, qy = py;
            planner::ordered_prefix(qx, qy, G, l, [&](int j, T& tx, T& ty) {
                tx = terms[j].tx;
                ty = terms[j].ty;
            });
            if (c0 + l < N)
                planner::rollout_row(a.out[0] + (b * N + c0 + l) * 12, qx, qy,
                                     a.par[planner::RP_H_REF], terms[l],
                                     vc[2]);
            last_x = qx;
            last_y = qy;
        }
        px = last_x;
        py = last_y;
        yaw = terms[G - 1].yaw_next;
    }
}

template <typename T>
int rollout(int B, int N, const void*, const void* const* in,
            const long long* stride, void* const* out, const double* par)
{
    planner::RollArgs<T> a;
    planner::fill(a, in, stride, out, par);
    for (long long b = 0; b < B; ++b) rollout_scenario<T>(a, N, b);
    return 0;
}

// the swing reference: the kernel's blocks of SWING_FOOT_ROWS scenarios
// one after another, each block's units in order or reversed, in a
// NaN-filled staging area, then the staging copied out
template <typename T>
int swing_blocks(bool reverse, int B, const void* const* in,
                 const long long* stride, void* const* out,
                 const double* par)
{
    planner::SwingArgs<T> a;
    planner::fill(a, in, stride, out, par);
    const int R = planner::SWING_FOOT_ROWS;
    std::vector<T> stage(36 * (size_t)R);
    T* const st[3] = {stage.data(), stage.data() + 12 * R,
                      stage.data() + 24 * R};
    for (long long b0 = 0; b0 < B; b0 += R) {
        const int rows = B - b0 < R ? (int)(B - b0) : R;
        for (auto& v : stage) v = std::numeric_limits<T>::quiet_NaN();
        for (int i = 0; i < planner::FEET * rows; ++i) {
            const int u = reverse ? planner::FEET * rows - 1 - i : i;
            planner::swing_foot_unit(a, b0, u, st);
        }
        for (int o = 0; o < planner::SO_COUNT; ++o)
            for (long long i = 0; i < 12LL * rows; ++i)
                a.out[o][b0 * 12 + i] = st[o][i];
    }
    return 0;
}

template <typename T>
int swing(int B, int, const void*, const void* const* in,
          const long long* stride, void* const* out, const double* par)
{
    return swing_blocks<T>(false, B, in, stride, out, par);
}

template <typename T>
int swing_reversed(int B, int, const void*, const void* const* in,
                   const long long* stride, void* const* out,
                   const double* par)
{
    return swing_blocks<T>(true, B, in, stride, out, par);
}

// the swing reference over a period (N its ticks): the kernel's blocks
// one after another, each block's phases in turn, their units in order or
// reversed, in NaN-filled staging and set-up areas
template <typename T>
int swing_period(bool reverse, int B, int N, const void* tables,
                 const void* const* in, const long long* stride,
                 void* const* out, const double* par)
{
    planner::SwingAtArgs<T> a;
    planner::fill(a, in, stride, out, par);
    const int R = planner::swing_block_rows(N);
    const T nan = std::numeric_limits<T>::quiet_NaN();
    std::vector<T> stage(36 * (size_t)R);
    std::vector<planner::SwingFoot<T>> feet(
        planner::FEET * (size_t)planner::swing_block_scenarios(N));
    T* const st[3] = {stage.data(), stage.data() + 12 * R,
                      stage.data() + 24 * R};
    const long long rows = (long long)B * N;
    for (long long blk = 0; blk * R < rows; ++blk) {
        const planner::SwingBlock k = planner::swing_block(B, N, blk);
        for (auto& v : stage) v = nan;
        for (auto& f : feet) f = {nan, nan, nan, nan, nan, nan, nan};
        if ((size_t)(planner::FEET * k.nb) > feet.size()) return -1;
        for (int i = 0; i < planner::FEET * k.nb; ++i) {
            const int u = reverse ? planner::FEET * k.nb - 1 - i : i;
            feet[u] = planner::swing_setup(a, static_cast<const int*>(tables),
                                           k, u);
        }
        for (int i = 0; i < planner::FEET * k.rows; ++i) {
            const int u = reverse ? planner::FEET * k.rows - 1 - i : i;
            planner::swing_tick(a, feet[planner::swing_setup_unit(N, k, u)],
                                planner::swing_frac(a, N, k, u), u, st);
        }
        for (int o = 0; o < planner::SO_COUNT; ++o)
            for (long long i = 0; i < 12LL * k.rows; ++i)
                a.out[o][k.r0 * 12 + i] = st[o][i];
    }
    return 0;
}

template <typename T>
int swing_at(int B, int N, const void* tables, const void* const* in,
             const long long* stride, void* const* out, const double* par)
{
    return swing_period<T>(false, B, N, tables, in, stride, out, par);
}

template <typename T>
int swing_at_reversed(int B, int N, const void* tables,
                      const void* const* in, const long long* stride,
                      void* const* out, const double* par)
{
    return swing_period<T>(true, B, N, tables, in, stride, out, par);
}

}  // namespace

#define PLAN_ENTRY(name, body)                                              \
    extern "C" int name(int dtype, int B, int N, const void* tables,        \
                        const void* const* in, const long long* stride,     \
                        void* const* out, const double* par)                \
    {                                                                       \
        return dtype == 0                                                   \
                   ? body<float>(B, N, tables, in, stride, out, par)        \
                   : body<double>(B, N, tables, in, stride, out, par);      \
    }

extern "C" int planner_layout(int what) { return planner::layout(what); }

PLAN_ENTRY(plan_footsteps_host, footsteps)
PLAN_ENTRY(plan_footsteps_reversed_host, footsteps_reversed)
PLAN_ENTRY(plan_rollout_host, rollout)
PLAN_ENTRY(plan_swing_host, swing)
PLAN_ENTRY(plan_swing_reversed_host, swing_reversed)
PLAN_ENTRY(plan_swing_at_host, swing_at)
PLAN_ENTRY(plan_swing_at_reversed_host, swing_at_reversed)
'''


def build_planner_harness(directory):
    """mpctsid_tpu_torch/plan/csrc/planner.h, the arithmetic of the
    planner's four kernels, built with the host compiler into `directory`
    (-std=c++17: no floating-point contraction), each kernel's units run
    one after another with the kernels' C signature (less the stream): the
    footsteps a warp per scenario, its lanes in order (`footsteps`) or
    reversed (`footsteps_reversed`) from NaN-filled staging rows; the
    rollout's pieces glued by an array, the kernel's chunks of lanes in
    turn (`rollout_scenario`), the swing reference block by block from
    NaN-filled staging (`swing`; `swing_reversed` each block's units
    reversed), the swing
    reference over a period block by block, phase by phase, from NaN-filled
    staging (`swing_at`; `swing_at_reversed` each phase's units reversed).
    Returns a namespace of ctypes functions `footsteps`,
    `footsteps_reversed`, `rollout`, `swing`, `swing_reversed`, `swing_at`,
    `swing_at_reversed`, which the wrappers' packing
    (`plan.footsteps.run_footsteps`, `mpc.srb.run_rollout`,
    `plan.swing.run_swing`, `plan.swing.run_swing_period`, `run_swing_at`)
    takes, and `layout(i)` (planner.h's counts)."""
    import ctypes
    import subprocess
    import types
    from pathlib import Path

    from mpctsid_tpu_torch.plan import kernels

    d = Path(directory).resolve()
    cc = d / "planner_harness.cc"
    cc.write_text(PLANNER_HARNESS)
    so = d / "libplanner_harness.so"
    subprocess.run(["g++", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-O2", "-I", str(kernels.CSRC), "-o", str(so),
                    str(cc)], check=True)
    lib = ctypes.CDLL(str(so))
    fns = {}
    for name in ("footsteps", "footsteps_reversed", "rollout", "swing",
                 "swing_reversed", "swing_at", "swing_at_reversed"):
        fn = getattr(lib, f"plan_{name}_host")
        fn.argtypes = kernels.LAUNCH_ARGTYPES
        fn.restype = ctypes.c_int
        fns[name] = fn
    lib.planner_layout.argtypes = [ctypes.c_int]
    lib.planner_layout.restype = ctypes.c_int
    return types.SimpleNamespace(layout=lib.planner_layout, **fns)


FIRST_PLANNER_HARNESS = r"""
#include "planner.h"

namespace {

template <typename T>
int footsteps(int B, int N, const void* tables, const void* const* in,
              const long long* stride, void* const* out, const double* par)
{
    planner::FootArgs<T> a;
    planner::fill(a, in, stride, out, par);
    for (long long b = 0; b < B; ++b)
        for (int f = 0; f < planner::FEET; ++f)
            planner::footsteps_foot<T>(a, static_cast<const int*>(tables), N,
                                       b, f);
    return 0;
}

template <typename T>
int rollout(int B, int N, const void*, const void* const* in,
            const long long* stride, void* const* out, const double* par)
{
    planner::RollArgs<T> a;
    planner::fill(a, in, stride, out, par);
    for (long long b = 0; b < B; ++b)
        for (int k = 0; k < N; ++k) planner::rollout_step<T>(a, N, b, k);
    return 0;
}

template <typename T>
int swing(int B, int, const void*, const void* const* in,
          const long long* stride, void* const* out, const double* par)
{
    planner::SwingArgs<T> a;
    planner::fill(a, in, stride, out, par);
    for (long long b = 0; b < B; ++b)
        for (int f = 0; f < planner::FEET; ++f)
            planner::swing_foot<T>(a, b, f);
    return 0;
}

template <typename T>
int swing_at(int B, int, const void* tables, const void* const* in,
             const long long* stride, void* const* out, const double* par)
{
    planner::SwingAtArgs<T> a;
    planner::fill(a, in, stride, out, par);
    for (long long b = 0; b < B; ++b)
        for (int f = 0; f < planner::FEET; ++f)
            planner::swing_at_foot<T>(a, static_cast<const int*>(tables), b,
                                      f);
    return 0;
}

}  // namespace

#define FIRST_ENTRY(name, body)                                             \
    extern "C" int name(int dtype, int B, int N, const void* tables,        \
                        const void* const* in, const long long* stride,     \
                        void* const* out, const double* par)                \
    {                                                                       \
        return dtype == 0                                                   \
                   ? body<float>(B, N, tables, in, stride, out, par)        \
                   : body<double>(B, N, tables, in, stride, out, par);      \
    }

FIRST_ENTRY(first_footsteps, footsteps)
FIRST_ENTRY(first_rollout, rollout)
FIRST_ENTRY(first_swing, swing)
FIRST_ENTRY(first_swing_at, swing_at)
"""


def build_first_planner_harness(directory):
    """The planner's first designs of the footstep horizon (a thread per
    (scenario, foot) looping over the steps, `footsteps_foot`), the
    reference rollout (a thread per step repeating the recursion up to it,
    `rollout_step`), the swing reference (a thread per (scenario, foot)
    storing its values where they lie, `swing_foot`) and the swing
    reference at a tick (`swing_at_foot`),
    whose planner.h lives on
    verbatim in scripts/probe_planner_designs.py (FIRST_PLANNER_H), built
    with the host compiler into `directory` (-ffp-contract=off), each
    thread one after another.  Returns a namespace of `footsteps`,
    `rollout`, `swing` and `swing_at` with the kernels' C signature less
    the stream (`plan.footsteps.run_footsteps`, `mpc.srb.run_rollout`,
    `plan.swing.run_swing`, `plan.swing.run_swing_at` take them; the first
    design's tick fraction is one value a scenario)."""
    import ctypes
    import re
    import subprocess
    import types
    from pathlib import Path

    from mpctsid_tpu_torch.plan import kernels

    script = (Path(__file__).resolve().parents[1] / "scripts"
              / "probe_planner_designs.py").read_text()
    source = re.search(r'FIRST_PLANNER_H = r"""(.*?)"""', script,
                       re.S).group(1)
    d = Path(directory).resolve()
    (d / "planner.h").write_text(source)
    cc = d / "first_planner.cc"
    cc.write_text(FIRST_PLANNER_HARNESS)
    so = d / "libfirst_planner.so"
    subprocess.run(["g++", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-O2", "-I", str(d), "-o", str(so), str(cc)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    fns = {}
    for name in ("footsteps", "rollout", "swing", "swing_at"):
        fn = getattr(lib, f"first_{name}")
        fn.argtypes = kernels.LAUNCH_ARGTYPES
        fn.restype = ctypes.c_int
        fns[name] = fn
    return types.SimpleNamespace(**fns)


RUIZ_HARNESS = r'''
#include <vector>

#include "ruiz.h"

extern "C" {

long long ruiz_smem_floats(int n, int m, int C, int p_in_smem, int slots)
{
    return ruiz::cluster_smem_floats(n, m, C, p_in_smem != 0, slots);
}

int ruiz_threads(int n, int C) { return ruiz::cluster_threads(n, C); }

int ruiz_slice_width(int n, int C) { return ruiz::slice_width(n, C); }

float ruiz_tree_sum(const float* v, int n) { return ruiz::tree_sum(v, n); }

// the first design's block sum: thread t of T sums v[t], v[t + T], ...;
// the lanes of each warp pairwise at 16, 8, 4, 2, 1; all T / 32 warps'
// sums in order, from 0
float ruiz_block_sum(const float* v, int n, int T)
{
    float total = 0.0f;
    for (int w = 0; w < T / 32; ++w) {
        float lane[32];
        for (int l = 0; l < 32; ++l) {
            float s = 0.0f;
            for (int j = w * 32 + l; j < n; j += T) s = s + v[j];
            lane[l] = s;
        }
        for (int off = 16; off > 0; off /= 2)
            for (int l = 0; l < off; ++l) lane[l] = lane[l] + lane[l + off];
        total = total + lane[0];
    }
    return total;
}

// a scenario at a time: on the warp path its 32 lanes in turn, on the
// cluster path its C ranks in turn, each in a fresh shared memory (and
// fresh registers) filled with NaN: a unit that read what no earlier phase
// wrote or sent would show
int ruiz_host(const void* const* in, const long long* stride,
              void* const* out, int B, int n, int m, int iters, int path,
              int size, int p_in_smem, int slots)
{
    ruiz::Args a;
    for (int k = 0; k < ruiz::I_COUNT; ++k) {
        a.in[k] = static_cast<const float*>(in[k]);
        a.stride[k] = stride[k];
    }
    for (int k = 0; k < ruiz::O_COUNT; ++k)
        a.out[k] = static_cast<float*>(out[k]);
    a.n = n;
    a.m = m;
    a.iters = iters;
    a.cluster = path == ruiz::PATH_CLUSTER ? size : 1;
    a.p_in_smem = p_in_smem;
    a.slots = slots;
    if (path == ruiz::PATH_WARP) {
        if (n > ruiz::WARP_N || m > ruiz::WARP_M) return 1;
        for (long long b = 0; b < B; ++b) {
            ruiz::HostWarp ex;
            for (auto& l : ex.lane) {
                for (auto& v : l.p) v = NAN;
                for (auto& v : l.a) v = NAN;
                l.e[0] = l.e[1] = l.war[0] = l.war[1] = NAN;
                l.D = l.q = l.wp = l.wa = l.pcol = l.qd = l.c = NAN;
            }
            ruiz::equilibrate_warp(ex, a, b);
        }
        return 0;
    }
    if (size < 1 || size > ruiz::MAX_CLUSTER) return 1;
    const long long floats =
        ruiz::cluster_smem_floats(n, m, size, p_in_smem != 0, slots);
    std::vector<float> s(floats * size);
    for (long long b = 0; b < B; ++b) {
        for (auto& v : s) v = NAN;
        ruiz::HostCluster ex;
        ex.C = size;
        for (int r = 0; r < size; ++r)
            ex.rank[r] = ruiz::Rank{r, s.data() + r * floats, NAN};
        ruiz::equilibrate_cluster(ex, a, b);
    }
    return 0;
}

}
'''


def build_ruiz_harness(directory):
    """mpctsid_tpu_torch/qp/csrc/ruiz.h, the Ruiz kernel's per-scenario
    bodies, built with the host compiler into `directory`: the warp path's
    lanes one after another in each phase (ruiz::HostWarp), the cluster
    path's ranks in turn (ruiz::HostCluster), in NaN-filled memory, with
    the launcher's C signature less the stream.  Returns a namespace of
    ctypes functions: `launch` (which `qp.kernels.run_ruiz` takes),
    `smem_floats(n, m, C, p_in_smem, slots)`, `threads(n, C)`,
    `slice_width(n, C)`, `tree_sum(v, n)` and `block_sum(v, n, T)` (the
    first design's sum over T threads)."""
    import ctypes
    import subprocess
    import types
    from pathlib import Path

    from mpctsid_tpu_torch.qp import _build

    d = Path(directory).resolve()
    cc = d / "ruiz_harness.cc"
    cc.write_text(RUIZ_HARNESS)
    so = d / "libruiz_harness.so"
    subprocess.run(["g++", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-O2", "-I", str(_build.CSRC), "-o", str(so),
                    str(cc)], check=True)
    lib = ctypes.CDLL(str(so))
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    FP = ctypes.POINTER(ctypes.c_float)
    lib.ruiz_host.argtypes = [ctypes.POINTER(P), ctypes.POINTER(LL),
                              ctypes.POINTER(P)] + [I] * 8
    lib.ruiz_host.restype = I
    lib.ruiz_smem_floats.argtypes = [I] * 5
    lib.ruiz_smem_floats.restype = LL
    lib.ruiz_threads.argtypes = [I, I]
    lib.ruiz_threads.restype = I
    lib.ruiz_slice_width.argtypes = [I, I]
    lib.ruiz_slice_width.restype = I
    lib.ruiz_tree_sum.argtypes = [FP, I]
    lib.ruiz_tree_sum.restype = ctypes.c_float
    lib.ruiz_block_sum.argtypes = [FP, I, I]
    lib.ruiz_block_sum.restype = ctypes.c_float

    def as_floats(v):
        v = np.ascontiguousarray(v, dtype=np.float32)
        return v.ctypes.data_as(FP), v

    def tree_sum(v, n):
        ptr, keep = as_floats(v)
        return lib.ruiz_tree_sum(ptr, n)

    def block_sum(v, n, T):
        ptr, keep = as_floats(v)
        return lib.ruiz_block_sum(ptr, n, T)

    return types.SimpleNamespace(launch=lib.ruiz_host,
                                 smem_floats=lib.ruiz_smem_floats,
                                 threads=lib.ruiz_threads,
                                 slice_width=lib.ruiz_slice_width,
                                 tree_sum=tree_sum, block_sum=block_sum)


MPC_BUILD_HARNESS = r'''
#include <limits>
#include <vector>

#include "mpc_build.h"

namespace {

// a small generator for the shuffled schedule (its seed settable)
unsigned long long g_seed = 1;

unsigned next_random(unsigned long long& s)
{
    s = s * 6364136223846793005ULL + 1442695040888963407ULL;
    return (unsigned)(s >> 33);
}

// the schedules of a scenario, each in fresh shared memory filled with NaN
// (a unit that read what no earlier phase wrote would show):
//   0  the card's pipeline in one thread: the models, the producer's start
//      and the consumers', then the producer's step j and the consumers'
//      row block j for j = N-1 ... 0;
//   1  the first design's phase order over the same units: the models; Su's
//      columns with the free response; the drift and S_{N-1}; the
//      recursion's two phases a step; then every row block and the bounds;
//   2  the pipeline with the row blocks delayed: after each producer step a
//      random number of the row blocks whose W_j is out run, in a random
//      order (the rest at the end), and each phase's units in order or
//      reversed at random;
//   3  a wrong one: row block N-1 before the step that makes W_{N-1} (what
//      the tests show the NaN fill catches).
// `reverse` runs every phase's units reversed (schedules 0 and 1).
template <typename T>
void scenario(const mpcb::Args<T>& a, int N, long long b,
              const mpcb::Smem<T>& sm, int schedule, bool reverse)
{
    using mpcb::HostExec;
    const HostExec ex{reverse};
    mpcb::model_phase(ex, a, N, b, sm);
    if (schedule == 0 || schedule == 3) {
        mpcb::producer_begin(ex, a, N, b, sm);
        mpcb::consumer_begin(ex, a, N, b, sm);
        for (int j = N - 1; j >= 0; --j) {
            if (schedule == 3 && j == N - 1)
                mpcb::consumer_rows(ex, a, N, b, j, sm);
            mpcb::producer_step(ex, a, N, b, j, sm);
            if (schedule == 0 || j < N - 1)
                mpcb::consumer_rows(ex, a, N, b, j, sm);
        }
        return;
    }
    if (schedule == 1) {
        MPCB_UNITS(ex, u, N * mpcb::NU + 1) {
            if (u < N * mpcb::NU)
                mpcb::su_unit(a, N, u / mpcb::NU, u % mpcb::NU, sm);
            else
                mpcb::free_response_unit(a, N, b, sm);
        }
        MPCB_UNITS(ex, u, mpcb::BLK + mpcb::NX * N) {
            if (u < mpcb::BLK)
                sm.s[u] = u / mpcb::NU == u % mpcb::NU ? sm.qd[u / mpcb::NU]
                                                       : (T)0;
            else
                mpcb::drift_unit(a, N, b, u - mpcb::BLK, sm);
        }
        for (int j = N - 1; j >= 0; --j) {
            MPCB_UNITS(ex, u, mpcb::BLK + mpcb::NX)
                mpcb::step_unit(a, N, b, j, u, sm);
            if (j > 0)
                MPCB_UNITS(ex, u, mpcb::BLK + mpcb::NX)
                    mpcb::back_unit(a, j, u, sm);
        }
        const int tiles = mpcb::row_block_tiles(N);
        MPCB_UNITS(ex, u, N * tiles + N * mpcb::FEET) {
            if (u < N * tiles)
                mpcb::p_tile(a, N, b, N - 1 - u / tiles, u % tiles, sm);
            else
                mpcb::bounds_unit(a, N, b, u - N * tiles);
        }
        return;
    }
    unsigned long long s = g_seed * 1000003ULL + (unsigned long long)b;
    auto coin = [&]() { return HostExec{(next_random(s) & 1) != 0}; };
    mpcb::producer_begin(coin(), a, N, b, sm);
    mpcb::consumer_begin(coin(), a, N, b, sm);
    std::vector<int> ready;
    auto run_some = [&](int count) {
        for (int k = 0; k < count && !ready.empty(); ++k) {
            const size_t at = next_random(s) % ready.size();
            const int j = ready[at];
            ready.erase(ready.begin() + (long)at);
            mpcb::consumer_rows(coin(), a, N, b, j, sm);
        }
    };
    for (int j = N - 1; j >= 0; --j) {
        mpcb::producer_step(coin(), a, N, b, j, sm);
        ready.push_back(j);
        run_some((int)(next_random(s) % 3));
    }
    run_some((int)ready.size());
}

template <typename T>
int build(int B, int N, const void* const* in, const long long* stride,
          void* const* out, const double* par, int schedule, bool reverse)
{
    mpcb::Args<T> a;
    mpcb::fill(a, in, stride, out, par);
    std::vector<T> smem((size_t)mpcb::smem_values(N));
    const mpcb::Smem<T> sm(smem.data(), N);
    for (long long b = 0; b < B; ++b) {
        for (auto& v : smem) v = std::numeric_limits<T>::quiet_NaN();
        scenario<T>(a, N, b, sm, schedule, reverse);
    }
    return 0;
}

int entry(int dtype, int B, int N, const void* const* in,
          const long long* stride, void* const* out, const double* par,
          int schedule, bool reverse)
{
    return dtype == 0
               ? build<float>(B, N, in, stride, out, par, schedule, reverse)
               : build<double>(B, N, in, stride, out, par, schedule,
                               reverse);
}

}  // namespace

#define MPCB_ENTRY(name, schedule, reverse)                                 \
    extern "C" int name(int dtype, int B, int N, const void* const* in,     \
                        const long long* stride, void* const* out,          \
                        const double* par)                                  \
    {                                                                       \
        return entry(dtype, B, N, in, stride, out, par, schedule, reverse); \
    }

MPCB_ENTRY(mpc_build_host, 0, false)
MPCB_ENTRY(mpc_build_host_reversed, 0, true)
MPCB_ENTRY(mpc_build_host_phases, 1, false)
MPCB_ENTRY(mpc_build_host_phases_reversed, 1, true)
MPCB_ENTRY(mpc_build_host_shuffled, 2, false)
MPCB_ENTRY(mpc_build_host_early, 3, false)

extern "C" {

void mpc_build_shuffle_seed(int seed) { g_seed = (unsigned long long)seed; }

int mpc_build_layout(int what) { return mpcb::layout(what); }

long long mpc_build_smem_values(int N) { return mpcb::smem_values(N); }

long long mpc_build_barrier_bytes(int N) { return mpcb::barrier_bytes(N); }

}  // extern "C"
'''


def build_mpc_build_harness(directory):
    """mpctsid_tpu_torch/mpc/csrc/mpc_build.h, the MPC build kernel's
    per-scenario body, built with the host compiler into `directory`: each
    scenario's units one after another in each phase (mpcb::HostExec, in
    order or reversed), in NaN-filled shared memory, with the launcher's C
    signature less the stream, in three schedules (the harness's head
    says which).  Returns a namespace of ctypes functions: `launch` and
    `launch_reversed` (the card's pipeline: the producer's step j, then the
    consumers' row block j), `phases` and `phases_reversed` (the first
    design's phase order over the same units), `shuffled` (the row blocks
    delayed at random, each after its step; `shuffle_seed(seed)` sets the
    draw) and `early` (row block N-1 before its step: wrong on purpose),
    all of which `mpc.srb.run_mpc_build` takes; `layout(i)`,
    `smem_values(N)` and `barrier_bytes(N)` (mpc_build.h's counts)."""
    import ctypes
    import subprocess
    import types
    from pathlib import Path

    from mpctsid_tpu_torch.mpc import kernels

    d = Path(directory).resolve()
    cc = d / "mpc_build_harness.cc"
    cc.write_text(MPC_BUILD_HARNESS)
    so = d / "libmpc_build_harness.so"
    subprocess.run(["g++", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-O2", "-I", str(kernels.CSRC), "-o", str(so),
                    str(cc)], check=True)
    lib = ctypes.CDLL(str(so))
    names = {"launch": "mpc_build_host",
             "launch_reversed": "mpc_build_host_reversed",
             "phases": "mpc_build_host_phases",
             "phases_reversed": "mpc_build_host_phases_reversed",
             "shuffled": "mpc_build_host_shuffled",
             "early": "mpc_build_host_early"}
    for name in names.values():
        getattr(lib, name).argtypes = kernels.LAUNCH_ARGTYPES
        getattr(lib, name).restype = ctypes.c_int
    lib.mpc_build_shuffle_seed.argtypes = [ctypes.c_int]
    lib.mpc_build_shuffle_seed.restype = None
    lib.mpc_build_layout.argtypes = [ctypes.c_int]
    lib.mpc_build_layout.restype = ctypes.c_int
    for fn in (lib.mpc_build_smem_values, lib.mpc_build_barrier_bytes):
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_longlong
    return types.SimpleNamespace(
        **{k: getattr(lib, v) for k, v in names.items()},
        shuffle_seed=lib.mpc_build_shuffle_seed,
        layout=lib.mpc_build_layout,
        smem_values=lib.mpc_build_smem_values,
        barrier_bytes=lib.mpc_build_barrier_bytes)


PERIOD_HEAD_HARNESS = r'''
#include <limits>

#include "period_head.h"

namespace {

// a scenario at a time, its warp's lanes one after another in each phase
// (reversed when `reverse`), from a slot filled with NaN; the plan's
// operands after the head's where PLAN (period_head.cu's launcher)
template <bool PLAN, typename T>
int head(int B, const void* consts, const void* const* in,
         const long long* stride, void* const* out, const double* par,
         bool reverse)
{
    using namespace rbd::head;
    HeadArgs<T> a;
    for (int k = 0; k < HI_COUNT; ++k) {
        a.in[k] = static_cast<const T*>(in[k]);
        a.stride[k] = stride[k];
    }
    for (int k = 0; k < HO_COUNT; ++k) a.out[k] = static_cast<T*>(out[k]);
    for (int k = 0; k < HP_COUNT; ++k) a.par[k] = (T)par[k];
    PlanArgs<T> p{};
    if (PLAN) {
        const void* const* pin = in + HI_COUNT;
        const long long* pst = stride + HI_COUNT;
        p.touchdown = static_cast<const T*>(pin[PLI_TOUCHDOWN]);
        p.gait = static_cast<const int*>(pin[PLI_GAIT]);
        p.phase = static_cast<const int*>(pin[PLI_PHASE]);
        p.tables = static_cast<const int*>(pin[PLI_TABLES]);
        p.td_stride = pst[PLI_TOUCHDOWN];
        p.gait_stride = pst[PLI_GAIT];
        p.phase_stride = pst[PLI_PHASE];
        for (int k = 0; k < PLO_COUNT; ++k)
            p.out[k] = static_cast<T*>(out[HO_COUNT + k]);
        p.N = (int)par[HP_COUNT + PLP_N];
        for (int k = 0; k < planner::FP_COUNT; ++k)
            p.fp[k] = (T)par[HP_COUNT + PLP_FOOT + k];
    }
    const rbd::HostExec ex{reverse};
    HeadSlot<T> S;
    T* raw = reinterpret_cast<T*>(&S);
    for (long long b = 0; b < B; ++b) {
        for (size_t i = 0; i < sizeof(S) / sizeof(T); ++i)
            raw[i] = std::numeric_limits<T>::quiet_NaN();
        period_warp<PLAN>(ex, static_cast<const T*>(consts), a, p, b, S);
    }
    return 0;
}

}  // namespace

#define HEAD_ENTRY(name, plan, reverse)                                     \
    extern "C" int name(int dtype, int B, const void* consts,               \
                        const void* const* in, const long long* stride,     \
                        void* const* out, const double* par)                \
    {                                                                       \
        return dtype == 0                                                   \
                   ? head<plan, float>(B, consts, in, stride, out, par,     \
                                       reverse)                             \
                   : head<plan, double>(B, consts, in, stride, out, par,    \
                                        reverse);                           \
    }

HEAD_ENTRY(period_head_host, false, false)
HEAD_ENTRY(period_head_host_reversed, false, true)
HEAD_ENTRY(period_plan_host, true, false)
HEAD_ENTRY(period_plan_host_reversed, true, true)

extern "C" int period_head_layout(int what)
{
    return rbd::head::layout(what);
}

extern "C" int period_head_slot_values()
{
    return (int)(sizeof(rbd::head::HeadSlot<float>) / sizeof(float));
}

extern "C" int period_head_warps_per_block(long long B, int slot, int optin,
                                           int n_sm)
{
    return rbd::warps_per_block(B, slot, optin, n_sm);
}
'''


def build_period_head_harness(directory):
    """mpctsid_tpu_torch/dyn/csrc/period_head.h (over rbd.h's leg
    kinematics and plan/csrc/planner.h's footstep units), the period-head
    and period-plan kernels' per-scenario body, built with the host
    compiler into `directory` (-ffp-contract=off, as the library's
    -fmad=false): each scenario's lanes one after another between the
    phases (rbd::HostExec), from a NaN-filled slot, with the kernels' C
    signature less the stream.  Returns a namespace of ctypes functions:
    `launch` and `launch_reversed` (the plan off, which
    `cascade.engine.run_period_head` takes), `plan` and `plan_reversed`
    (the plan on, which `cascade.engine.run_period_plan` takes),
    `layout(i)`, `slot_values()` and `warps_per_block(B, slot bytes,
    shared bytes, SMs)`."""
    import ctypes
    import subprocess
    import types
    from pathlib import Path

    from mpctsid_tpu_torch.dyn import kernels

    d = Path(directory).resolve()
    cc = d / "period_head_harness.cc"
    cc.write_text(PERIOD_HEAD_HARNESS)
    so = d / "libperiod_head_harness.so"
    subprocess.run(["g++", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-O2", "-I", str(kernels.CSRC), "-o", str(so),
                    str(cc)], check=True)
    lib = ctypes.CDLL(str(so))
    for name in ("period_head_host", "period_head_host_reversed",
                 "period_plan_host", "period_plan_host_reversed"):
        getattr(lib, name).argtypes = kernels.LAUNCH_ARGTYPES
        getattr(lib, name).restype = ctypes.c_int
    lib.period_head_layout.argtypes = [ctypes.c_int]
    lib.period_head_layout.restype = ctypes.c_int
    lib.period_head_slot_values.restype = ctypes.c_int
    lib.period_head_warps_per_block.argtypes = [ctypes.c_longlong] + [
        ctypes.c_int] * 3
    lib.period_head_warps_per_block.restype = ctypes.c_int
    return types.SimpleNamespace(
        launch=lib.period_head_host,
        launch_reversed=lib.period_head_host_reversed,
        plan=lib.period_plan_host, plan_reversed=lib.period_plan_host_reversed,
        layout=lib.period_head_layout, slot_values=lib.period_head_slot_values,
        warps_per_block=lib.period_head_warps_per_block)


EST_STEP_HARNESS = r'''
#include <limits>
#include <vector>

#include "est_step.h"

namespace {

using namespace rbd::est;

// the block's units one after another in a fixed shuffled order: unit
// (7919 i + 5) mod n of a phase of n (7919 a prime above every n here)
struct ShuffledExec {
    int first() const { return 0; }
    int step() const { return 1; }
    int unit(int i, int n) const { return (int)((7919LL * i + 5) % n); }
    void sync() const {}
};

template <typename T>
void fill(EstArgs<T>& a, const void* const* in, const long long* stride,
          void* const* out, const double* par)
{
    for (int k = 0; k < EI_COUNT; ++k) {
        a.in[k] = static_cast<const T*>(in[k]);
        a.stride[k] = stride[k];
    }
    for (int k = 0; k < EO_COUNT; ++k) a.out[k] = static_cast<T*>(out[k]);
    for (int k = 0; k < EP_COUNT; ++k) a.par[k] = (T)par[k];
}

// est_step.cu's launcher less the launch: blocks of S scenarios one after
// another, each on fresh NaN-filled shared memory (16-byte aligned), its
// units run by `ex`
template <bool IMU, typename T, class Exec>
int est(const Exec& ex, int S, int B, const void* consts,
        const void* const* in, const long long* stride, void* const* out,
        const double* par)
{
    if (S < 1 || S > EST_MAX_S || B < 1) return 1;
    EstArgs<T> a;
    fill(a, in, stride, out, par);
    const int n = est_smem_values(S, (int)sizeof(T));
    std::vector<T> buf(n + 16 / sizeof(T));
    T* smem = buf.data();
    while ((uintptr_t)smem % 16) ++smem;
    for (long long blk = 0; blk * S < B; ++blk) {
        for (int i = 0; i < n; ++i)
            smem[i] = std::numeric_limits<T>::quiet_NaN();
        est_block<IMU>(ex, static_cast<const T*>(consts), a, B, S, blk,
                       smem);
    }
    return 0;
}

template <bool IMU, typename T>
int est_order(int order, int S, int B, const void* consts,
              const void* const* in, const long long* stride,
              void* const* out, const double* par)
{
    if (order == 2)
        return est<IMU, T>(ShuffledExec{}, S, B, consts, in, stride, out,
                           par);
    return est<IMU, T>(rbd::est::HostExec{order == 1}, S, B, consts, in,
                       stride, out, par);
}

// each foot's odometry term and position, base frame (`leg_unit`), of B
// configurations q (B, 19), gyro (B, 3), qd (B, 12) into odo, foot
// (B, 4, 3)
template <typename T>
int legs(int B, const void* consts, const void* qp, const void* gp,
         const void* qdp, void* odo, void* foot)
{
    const T* C = static_cast<const T*>(consts);
    for (int b = 0; b < B; ++b) {
        T qo[rbd::NQ], vo[rbd::NV];
        for (int i = 0; i < rbd::NQ; ++i)
            qo[i] = static_cast<const T*>(qp)[b * rbd::NQ + i];
        for (int i = 0; i < 3; ++i)
            vo[3 + i] = static_cast<const T*>(gp)[b * 3 + i];
        for (int i = 0; i < 12; ++i)
            vo[6 + i] = static_cast<const T*>(qdp)[b * 12 + i];
        EstRow<T> r;
        for (int leg = 0; leg < 4; ++leg) {
            leg_unit(leg, C, qo, vo, r);
            for (int i = 0; i < 3; ++i) {
                static_cast<T*>(odo)[b * 12 + 3 * leg + i] = r.odo[leg][i];
                static_cast<T*>(foot)[b * 12 + 3 * leg + i] = r.foot[leg][i];
            }
        }
    }
    return 0;
}

}  // namespace

// the kernels' C signature, with the executor's order (0 in order, 1
// reversed, 2 shuffled) and S before it
extern "C" int est_host(int imu, int order, int S, int dtype, int B,
                        const void* consts, const void* const* in,
                        const long long* stride, void* const* out,
                        const double* par)
{
    if (imu)
        return dtype == 0
            ? est_order<true, float>(order, S, B, consts, in, stride, out, par)
            : est_order<true, double>(order, S, B, consts, in, stride, out,
                                      par);
    return dtype == 0
        ? est_order<false, float>(order, S, B, consts, in, stride, out, par)
        : est_order<false, double>(order, S, B, consts, in, stride, out,
                                   par);
}

extern "C" int est_legs(int dtype, int B, const void* consts, const void* q,
                        const void* gyro, const void* qd, void* odo,
                        void* foot)
{
    return dtype == 0 ? legs<float>(B, consts, q, gyro, qd, odo, foot)
                      : legs<double>(B, consts, q, gyro, qd, odo, foot);
}

extern "C" int est_step_layout(int what) { return rbd::est::layout(what); }

extern "C" int est_step_slot_values()
{
    return EST_ROW_VALUES + rbd::NQ + rbd::NV;
}

extern "C" int est_scenarios_host(long long B, int smem, int n_sm, int size)
{
    return est_scenarios(B, smem, n_sm, size);
}

extern "C" int est_smem_bytes_host(int S, int size)
{
    return est_smem_bytes(S, size);
}
'''

# executor orders of the host build
EST_ORDERS = {"in_order": 0, "reversed": 1, "shuffled": 2}


def build_est_step_harness(directory):
    """mpctsid_tpu_torch/dyn/csrc/est_step.h (over rbd.h's leg kinematics
    and integration step), the estimator kernels' body, built with the host
    compiler into `directory` (-ffp-contract=off, as the library's
    -fmad=false): a block of S scenarios at a time on NaN-filled shared
    memory, each phase's units one after another (in order, reversed or in
    a fixed shuffled order) between the barriers.  Returns a namespace:
    `launcher(imu, S=EST_MAX_S, order="in_order")`, a function with the
    kernels' C signature less the stream (`est.filter.run_est_step` takes
    the tick's, imu True; `run_est_update` the update's); `tick`,
    `tick_reversed`, `update`, `update_reversed` (S = EST_MAX_S);
    `legs(q, gyro, qd)` -> (odo, foot) (B, 4, 3), each foot's odometry term
    and position in the base frame (`leg_unit`); `layout(i)`,
    `slot_values()`, `scenarios(B, smem, n_sm, itemsize)` and
    `smem_bytes(S, itemsize)` (est_step.h's layout)."""
    import ctypes
    import subprocess
    import types
    from pathlib import Path

    import torch

    from mpctsid_tpu_torch.dyn import kernels
    from mpctsid_tpu_torch.model.solo12 import SOLO12
    from mpctsid_tpu_torch.model.tree import build_tree

    d = Path(directory).resolve()
    cc = d / "est_step_harness.cc"
    cc.write_text(EST_STEP_HARNESS)
    so = d / "libest_step_harness.so"
    subprocess.run(["g++", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-O2", "-I", str(kernels.CSRC), "-o", str(so),
                    str(cc)], check=True)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.est_host.argtypes = [I, I, I] + kernels.LAUNCH_ARGTYPES
    lib.est_host.restype = I
    lib.est_legs.argtypes = [I, I] + [P] * 6
    lib.est_legs.restype = I
    for name in ("est_step_layout", "est_step_slot_values"):
        getattr(lib, name).restype = I
    lib.est_step_layout.argtypes = [I]
    lib.est_scenarios_host.argtypes = [ctypes.c_longlong, I, I, I]
    lib.est_scenarios_host.restype = I
    lib.est_smem_bytes_host.argtypes = [I, I]
    lib.est_smem_bytes_host.restype = I
    tree = build_tree(SOLO12)

    def launcher(imu, S=kernels.EST_MAX_S, order="in_order"):
        code = EST_ORDERS[order]

        def run(*a):
            return lib.est_host(int(imu), code, S, *a)
        return run

    def legs(q, gyro, qd):
        q, gyro, qd = (x.contiguous() for x in (q, gyro, qd))
        B = q.shape[0]
        odo, foot = (q.new_empty((B, 4, 3)) for _ in range(2))
        consts = kernels.rbd_constants(tree, q.device, q.dtype)
        rc = lib.est_legs(0 if q.dtype == torch.float32 else 1, B,
                          consts.data_ptr(), q.data_ptr(), gyro.data_ptr(),
                          qd.data_ptr(), odo.data_ptr(), foot.data_ptr())
        assert rc == 0
        return odo, foot

    return types.SimpleNamespace(
        launcher=launcher, tick=launcher(True),
        tick_reversed=launcher(True, order="reversed"),
        update=launcher(False),
        update_reversed=launcher(False, order="reversed"), legs=legs,
        layout=lib.est_step_layout, slot_values=lib.est_step_slot_values,
        scenarios=lib.est_scenarios_host,
        smem_bytes=lib.est_smem_bytes_host)


FIRST_EST_HARNESS = r'''
#include <limits>

#include "est_step.h"

// the first design's leg units on a configuration: rbd.h's `kin_unit` on
// q (B, 19), then its `leg_unit` (the Jacobian's columns at the pose, the
// residual rotated back by R0'), each foot's odometry term into odo
// (B, 4, 3), the lanes one after another from a NaN-filled slot
template <typename T>
int first_legs(int B, const void* consts, const void* qp, const void* gp,
               const void* qdp, void* odo)
{
    using namespace rbd::est;
    const T* C = static_cast<const T*>(consts);
    const rbd::HostExec ex{false};
    EstSlot<T> S;
    T* raw = reinterpret_cast<T*>(&S);
    for (int b = 0; b < B; ++b) {
        for (size_t i = 0; i < sizeof(S) / sizeof(T); ++i)
            raw[i] = std::numeric_limits<T>::quiet_NaN();
        const T* q = static_cast<const T*>(qp) + b * rbd::NQ;
        for (int i = 0; i < 3; ++i)
            S.gyro[i] = static_cast<const T*>(gp)[b * 3 + i];
        RBD_EACH_LANE(ex, lane) rbd::kin_unit(lane, C, q, S.k);
        RBD_EACH_LANE(ex, lane)
            leg_unit(lane, C, static_cast<const T*>(qdp) + b * 12, S);
        for (int f = 0; f < 4; ++f)
            for (int i = 0; i < 3; ++i)
                static_cast<T*>(odo)[b * 12 + 3 * f + i] = S.vodo[f][i];
    }
    return 0;
}

extern "C" int first_est_legs(int dtype, int B, const void* consts,
                              const void* q, const void* gyro,
                              const void* qd, void* odo)
{
    return dtype == 0 ? first_legs<float>(B, consts, q, gyro, qd, odo)
                      : first_legs<double>(B, consts, q, gyro, qd, odo);
}
'''


def build_first_est_harness(directory):
    """The estimator's first design (a warp per scenario; its est_step.h
    lives on verbatim in scripts/probe_est_designs.py as FIRST_EST_STEP_H)
    built with the host compiler into `directory` (-ffp-contract=off) over
    the shipped rbd.h.  Returns `legs(q, gyro, qd)` -> odo (B, 4, 3): each
    foot's odometry term -R0' resid_f as that design forms it, from the
    Jacobian's columns at the pose q (rbd.h's `kin_unit`)."""
    import ctypes
    import re
    import subprocess
    from pathlib import Path

    import torch

    from mpctsid_tpu_torch.dyn import kernels
    from mpctsid_tpu_torch.model.solo12 import SOLO12
    from mpctsid_tpu_torch.model.tree import build_tree

    script = (Path(__file__).resolve().parents[1] / "scripts"
              / "probe_est_designs.py").read_text()
    source = re.search(r'FIRST_EST_STEP_H = r"""(.*?)"""', script,
                       re.S).group(1)
    d = Path(directory).resolve()
    (d / "est_step.h").write_text(source)
    cc = d / "first_est.cc"
    cc.write_text(FIRST_EST_HARNESS)
    so = d / "libfirst_est.so"
    subprocess.run(["g++", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-O2", "-I", str(d), "-I", str(kernels.CSRC),
                    "-o", str(so), str(cc)], check=True)
    lib = ctypes.CDLL(str(so))
    P = ctypes.c_void_p
    lib.first_est_legs.argtypes = [ctypes.c_int, ctypes.c_int] + [P] * 5
    lib.first_est_legs.restype = ctypes.c_int
    tree = build_tree(SOLO12)

    def legs(q, gyro, qd):
        q, gyro, qd = (x.contiguous() for x in (q, gyro, qd))
        odo = q.new_empty((q.shape[0], 4, 3))
        consts = kernels.rbd_constants(tree, q.device, q.dtype)
        rc = lib.first_est_legs(0 if q.dtype == torch.float32 else 1,
                                q.shape[0], consts.data_ptr(), q.data_ptr(),
                                gyro.data_ptr(), qd.data_ptr(),
                                odo.data_ptr())
        assert rc == 0
        return odo
    return legs


SOLVE_TAIL_HARNESS = r'''
#include <limits>
#include <vector>

#include "solve_tail.h"

namespace {

template <typename T>
void nan_fill(std::vector<T>& v)
{
    for (auto& e : v) e = std::numeric_limits<T>::quiet_NaN();
}

// kkt_blocks: the tiles of each scenario in turn (`threads` x KKT_PIECES
// pieces of V = `lanes` values a tile), each tile's setup units one after
// another in fresh NaN-filled shared memory, then its pieces one after
// another, P's values copied in, patched and copied out; all in order or
// reversed
template <typename T>
int kkt(const void* const* in, const long long* stride, void* const* out,
        const double* par, int B, tail::Shape s, int threads, int blocks,
        bool reverse)
{
    const int V = s.lanes;
    if (V > 4 || threads < 1 || tail::kkt_bad(B, s, threads, blocks, V))
        return 1;
    tail::KktArgs<T> a;
    tail::fill(a, in, stride, out, par);
    const int tile = threads * tail::KKT_PIECES * V;
    const int tiles = tail::kkt_tiles(s.n, tile);
    std::vector<T> smem((size_t)tail::kkt_smem_values(s.n, s.c, tile));
    // the card's aligned path patches the tile in shared memory, the
    // unaligned one in registers: the same arithmetic on the pieces
    for (int b = 0; b < B; ++b) {
        for (int k = 0; k < tiles; ++k) {
            const int t = reverse ? tiles - 1 - k : k;
            const tail::KktTile tl = tail::kkt_tile(s, tile, t);
            nan_fill(smem);
            tail::kkt_setup(tail::HostExec{reverse}, a, s, (long long)b, tl,
                            smem.data());
            const T* P = a.row(tail::KI_P, b);
            T* K = a.out[tail::KO_K] + (long long)b * s.n * s.n;
            const int pieces = (tl.e1 - tl.e0) / V;
            for (int p = 0; p < pieces; ++p) {
                const int e = tl.e0 + V * (reverse ? pieces - 1 - p : p);
                T v[4];
                for (int i = 0; i < V; ++i) v[i] = P[e + i];
                switch (V) {
                case 1: tail::kkt_piece<1>(a, s, tl, smem.data(), e, v); break;
                case 2: tail::kkt_piece<2>(a, s, tl, smem.data(), e, v); break;
                case 4: tail::kkt_piece<4>(a, s, tl, smem.data(), e, v); break;
                default: return 1;
                }
                for (int i = 0; i < V; ++i) K[e + i] = v[i];
            }
        }
    }
    return 0;
}

// adapt_rho, as unscale below: the warp path (lanes 1: the lanes stage the
// rows; lanes 2: the rows copied in whole at stride n, as the card's bulk
// copies) a scenario's 32 lanes one after another in each phase, the block
// path (lanes 32) its block's units; in order or reversed, from NaN-filled
// shared memory
template <typename T>
int adapt(const void* const* in, const long long* stride, void* const* out,
          const double* par, int B, tail::Shape s, int threads, int blocks,
          bool reverse)
{
    if (tail::scenario_bad(B, s, threads, blocks)) return 1;
    const int dense = !s.blocks(), n = s.n, m = s.m;
    if (s.lanes == 2
        && !tail::warp_bulk(in[tail::AI_P], stride[tail::AI_P],
                            in[tail::AI_A], stride[tail::AI_A], s,
                            sizeof(T)))
        return 1;
    tail::AdaptArgs<T> a;
    tail::fill(a, in, stride, out, par);
    std::vector<double> smem((size_t)(
        tail::adapt_smem_bytes(n, m, dense,
                               s.lanes == tail::MAX_LANES ? 0 : 1, s.lanes,
                               sizeof(T)) / 8));
    unsigned char* raw = reinterpret_cast<unsigned char*>(smem.data());
    for (long long k = 0; k < B; ++k) {
        const long long b = reverse ? B - 1 - k : k;
        nan_fill(smem);
        tail::HostWarp<tail::AdaptLane<T>> ex{reverse, {}};
        if (s.lanes == 1) {
            tail::adapt_warp<T>(ex, a, s, b, raw);
        } else if (s.lanes == 2) {
            T* Ps = reinterpret_cast<T*>(raw + 16);
            const T* P = a.row(tail::AI_P, b);
            const T* A = a.row(tail::AI_A, b);
            for (int e = 0; e < n * n; ++e) Ps[e] = P[e];
            if (dense)
                for (int e = 0; e < m * n; ++e) Ps[n * n + e] = A[e];
            double* xs = reinterpret_cast<double*>(
                raw + tail::adapt_rows_bytes(n, m, dense, 2, sizeof(T)));
            // each lane's inputs loaded ahead, as the card's warp loads
            // them a scenario ahead
            for (int l = 0; l < tail::WARP; ++l)
                tail::load_adapt_lane(ex.lane[l].in, a, s, b, l);
            tail::adapt_warp_rows(ex, a, s, b, Ps, Ps + n * n, n, xs, xs + n,
                                  [](int, tail::AdaptLane<T>&) {});
        } else {
            tail::adapt_block<T>(tail::HostExec{reverse}, a, s, b,
                                 smem.data());
        }
    }
    return 0;
}

// unscale: the warp path a scenario's 32 lanes one after another in each
// phase (lanes 1: the lanes stage the rows; lanes 2: the rows copied in
// whole at stride n, as the card's bulk copies, into a NaN-filled slot),
// the block path (lanes 32) its block's units; in order or reversed, from
// NaN-filled shared memory
template <typename T>
int unscale(const void* const* in, const long long* stride,
            void* const* out, const double* par, int B, tail::Shape s,
            int threads, int blocks, bool reverse)
{
    if (tail::scenario_bad(B, s, threads, blocks)) return 1;
    const int dense = !s.blocks(), n = s.n, m = s.m;
    if (s.lanes == 2
        && !tail::warp_bulk(in[tail::UI_P], stride[tail::UI_P],
                            in[tail::UI_A], stride[tail::UI_A], s,
                            sizeof(T)))
        return 1;
    tail::UnArgs<T> a;
    tail::fill(a, in, stride, out, par);
    a.ok = static_cast<unsigned char*>(out[tail::UO_OK]);
    std::vector<T> smem((size_t)(
        s.lanes == tail::MAX_LANES
            ? tail::block_smem_values(n, m, dense)
            : tail::warp_smem_bytes(n, m, dense, s.lanes, sizeof(T))
                  / sizeof(T)));
    for (long long k = 0; k < B; ++k) {
        const long long b = reverse ? B - 1 - k : k;
        nan_fill(smem);
        tail::HostWarp<tail::UnLane<T>> ex{reverse, {}};
        if (s.lanes == 1) {
            tail::unscale_warp<T>(ex, a, s, b, smem.data());
        } else if (s.lanes == 2) {
            T* Ps = smem.data();
            const T* P = a.row(tail::UI_P, b);
            const T* A = a.row(tail::UI_A, b);
            for (int e = 0; e < n * n; ++e) Ps[e] = P[e];
            if (dense)
                for (int e = 0; e < m * n; ++e) Ps[n * n + e] = A[e];
            T* xs = Ps + tail::slot_values(n, m, dense, n);
            // each lane's vector inputs loaded ahead, as the card's warp
            // loads them a scenario ahead
            for (int l = 0; l < tail::WARP; ++l)
                tail::load_lane(ex.lane[l].in, a, s, b, l);
            tail::unscale_warp_rows(ex, a, s, b, Ps, Ps + n * n, n, xs,
                                    xs + n, [](int, tail::UnLane<T>&) {});
        } else {
            tail::unscale_block<T>(tail::HostExec{reverse}, a, s, b,
                                   smem.data());
        }
    }
    return 0;
}

}  // namespace

#define TAIL_ENTRY(name, body, reverse)                                     \
    extern "C" int name(int dtype, const void* const* in,                   \
                        const long long* stride, void* const* out,          \
                        const double* par, int B, int n, int m, int r,      \
                        int c, int threads, int blocks, int lanes)          \
    {                                                                       \
        const tail::Shape s{n, m, r, c, lanes};                             \
        return dtype == 0                                                   \
                   ? body<float>(in, stride, out, par, B, s, threads,       \
                                 blocks, reverse)                           \
                   : body<double>(in, stride, out, par, B, s, threads,      \
                                  blocks, reverse);                         \
    }

TAIL_ENTRY(solve_tail_kkt_host, kkt, false)
TAIL_ENTRY(solve_tail_kkt_host_reversed, kkt, true)
TAIL_ENTRY(solve_tail_adapt_host, adapt, false)
TAIL_ENTRY(solve_tail_adapt_host_reversed, adapt, true)
TAIL_ENTRY(solve_tail_unscale_host, unscale, false)
TAIL_ENTRY(solve_tail_unscale_host_reversed, unscale, true)

extern "C" int solve_tail_layout(int what) { return tail::layout(what); }

extern "C" long long solve_tail_adapt_smem_bytes(int n, int m, int dense,
                                                 int warps, int slots,
                                                 int size)
{
    return tail::adapt_smem_bytes(n, m, dense, warps, slots, size);
}

extern "C" long long solve_tail_kkt_smem_bytes(int n, int c, int tile,
                                               int bulk, int size)
{
    return tail::kkt_smem_bytes(n, c, tile, bulk, size);
}

extern "C" long long solve_tail_unscale_smem_bytes(int n, int m, int dense,
                                                   int warps, int slots,
                                                   int size)
{
    return warps > 0
               ? warps * tail::warp_smem_bytes(n, m, dense, slots, size)
               : tail::block_smem_values(n, m, dense) * size;
}
'''


def build_solve_tail_harness(directory):
    """mpctsid_tpu_torch/qp/csrc/solve_tail.h, the solve-tail kernels'
    bodies, built with the host compiler into `directory`
    (-ffp-contract=off, as the library's -fmad=false): kkt_blocks' tiles
    in turn (each tile's setup units, then its pieces, one after another),
    adapt_rho's and unscale's units (block path) or lanes (warp path) one
    after another per phase of each scenario, from NaN-filled shared
    memory, in order or reversed, with the launchers' C signature less the
    stream and the launchers' checks of the geometry (a refused one
    returns 1).  Returns a namespace: `kkt`, `adapt`, `unscale` and their
    `*_reversed` twins (which qp/tail.py's `run_kkt`, `run_adapt`,
    `run_unscale` take), `layout(i)`, `adapt_smem_bytes(n, m, dense,
    warps, slots, size)`, `kkt_smem_bytes(n, c, tile, bulk, size)` and
    `unscale_smem_bytes(n, m, dense, warps, slots, size)`."""
    import ctypes
    import subprocess
    import types
    from pathlib import Path

    from mpctsid_tpu_torch.qp import _build, tail

    d = Path(directory).resolve()
    cc = d / "solve_tail_harness.cc"
    cc.write_text(SOLVE_TAIL_HARNESS)
    so = d / "libsolve_tail_harness.so"
    subprocess.run(["g++", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-O2", "-I", str(_build.CSRC), "-o", str(so),
                    str(cc)], check=True)
    lib = ctypes.CDLL(str(so))
    fns = {}
    for entry in ("kkt", "adapt", "unscale"):
        for tag in ("", "_reversed"):
            fn = getattr(lib, f"solve_tail_{entry}_host{tag}")
            fn.argtypes = tail.LAUNCH_ARGTYPES
            fn.restype = ctypes.c_int
            fns[entry + tag] = fn
    lib.solve_tail_layout.argtypes = [ctypes.c_int]
    lib.solve_tail_layout.restype = ctypes.c_int
    smem = {}
    for name, count in (("adapt_smem_bytes", 6), ("kkt_smem_bytes", 5),
                        ("unscale_smem_bytes", 6)):
        fn = getattr(lib, f"solve_tail_{name}")
        fn.argtypes = [ctypes.c_int] * count
        fn.restype = ctypes.c_longlong
        smem[name] = fn
    return types.SimpleNamespace(layout=lib.solve_tail_layout, **smem,
                                 **fns)


FIRST_DESIGN_HARNESS = r'''
#include <limits>
#include <vector>

#include "%(header)s"

namespace {

template <typename T>
void nan_fill(std::vector<T>& v)
{
    for (auto& e : v) e = std::numeric_limits<T>::quiet_NaN();
}

#if %(mpc)d
// the first MPC build: a scenario's phases, their units one after another
template <typename T>
int mpc(int B, int N, const void* const* in, const long long* stride,
        void* const* out, const double* par)
{
    mpcb::Args<T> a;
    mpcb::fill(a, in, stride, out, par);
    std::vector<T> smem((size_t)mpcb::smem_values(N));
    for (long long b = 0; b < B; ++b) {
        nan_fill(smem);
        mpcb::build_scenario<T>(mpcb::HostExec{false}, a, N, b, smem.data());
    }
    return 0;
}
#else
// the first adapt_rho: a scenario's units one after another per phase
template <typename T>
int adapt(const void* const* in, const long long* stride, void* const* out,
          const double* par, int B, int n, int m, int r, int c, int lanes)
{
    tail::AdaptArgs<T> a;
    tail::fill(a, in, stride, out, par);
    const tail::Shape s{n, m, r, c, lanes};
    std::vector<double> smem(
        (size_t)tail::smem_values(n, m, !s.blocks(), lanes));
    for (long long b = 0; b < B; ++b) {
        nan_fill(smem);
        tail::adapt_rho<T>(tail::HostExec{false}, a, s, b, smem.data());
    }
    return 0;
}
#endif

}  // namespace

extern "C" int first_design(int dtype, const void* const* in,
                            const long long* stride, void* const* out,
                            const double* par, int B, int n, int m, int r,
                            int c, int threads, int blocks, int lanes)
{
#if %(mpc)d
    (void)m; (void)r; (void)c; (void)threads; (void)blocks; (void)lanes;
    return dtype == 0 ? mpc<float>(B, n, in, stride, out, par)
                      : mpc<double>(B, n, in, stride, out, par);
#else
    (void)threads; (void)blocks;
    return dtype == 0 ? adapt<float>(in, stride, out, par, B, n, m, r, c,
                                     lanes)
                      : adapt<double>(in, stride, out, par, B, n, m, r, c,
                                      lanes);
#endif
}
'''


def build_first_design_harness(directory, kernel):
    """The first design of `kernel` ("mpc_build": its mpc_build.h;
    "adapt_rho": its solve_tail.h), whose sources live on verbatim in
    scripts/probe_kernel_designs.py (FIRST_MPC_BUILD_H, FIRST_TAIL_H),
    built with the host compiler into `directory` (-ffp-contract=off):
    each scenario's units one after another per phase, from NaN-filled
    shared memory.  Returns the launcher: for "mpc_build" with the MPC
    build's C signature less the stream (`mpc.srb.run_mpc_build` takes
    it), for "adapt_rho" with the solve tail's (`qp/tail.py::run_adapt`;
    the geometry's lanes the first design's units a row, 1 or 32)."""
    import ctypes
    import re
    import subprocess
    from pathlib import Path

    from mpctsid_tpu_torch.mpc import kernels as mk
    from mpctsid_tpu_torch.qp import tail

    name, header = {"mpc_build": ("FIRST_MPC_BUILD_H", "mpc_build.h"),
                    "adapt_rho": ("FIRST_TAIL_H", "solve_tail.h")}[kernel]
    script = (Path(__file__).resolve().parents[1] / "scripts"
              / "probe_kernel_designs.py").read_text()
    source = re.search(name + r' = r"""(.*?)"""', script, re.S).group(1)
    d = Path(directory).resolve()
    (d / header).write_text(source)
    cc = d / f"first_{kernel}.cc"
    cc.write_text(FIRST_DESIGN_HARNESS % dict(header=header,
                                              mpc=kernel == "mpc_build"))
    so = d / f"libfirst_{kernel}.so"
    subprocess.run(["g++", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-O2", "-I", str(d), "-o", str(so), str(cc)],
                   check=True)
    fn = ctypes.CDLL(str(so)).first_design
    fn.restype = ctypes.c_int
    fn.argtypes = tail.LAUNCH_ARGTYPES
    if kernel == "adapt_rho":
        return fn
    # the MPC build's signature (dtype, B, N, in, stride, out, par)
    return lambda dtype, B, N, ins, stride, outs, par: fn(
        dtype, ins, stride, outs, par, B, N, 0, 0, 0, 0, 0, 0)
