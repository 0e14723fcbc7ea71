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
