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
PLAN_ENTRY(plan_rollout_host, rollout)
PLAN_ENTRY(plan_swing_host, swing)
'''


def build_planner_harness(directory):
    """mpctsid_tpu_torch/plan/csrc/planner.h, the per-thread arithmetic of
    the planner's three kernels, built with the host compiler into
    `directory` (-std=c++17: no floating-point contraction), each kernel's
    threads run one after another with the kernels' C signature (less the
    stream).  Returns a namespace of ctypes functions `footsteps`,
    `rollout`, `swing`, which the wrappers' packing (`plan.footsteps.
    run_footsteps`, `mpc.srb.run_rollout`, `plan.swing.run_swing`) takes,
    and `layout(i)` (planner.h's counts)."""
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
    for name in ("footsteps", "rollout", "swing"):
        fn = getattr(lib, f"plan_{name}_host")
        fn.argtypes = kernels.LAUNCH_ARGTYPES
        fn.restype = ctypes.c_int
        fns[name] = fn
    lib.planner_layout.argtypes = [ctypes.c_int]
    lib.planner_layout.restype = ctypes.c_int
    return types.SimpleNamespace(layout=lib.planner_layout, **fns)


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
