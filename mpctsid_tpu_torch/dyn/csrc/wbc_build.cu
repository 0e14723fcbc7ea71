// The WBC QP build in one launch — CUDA, sm_90a.
//
// Computes wbc/tsid.py::_build_wbc_qp's whole tuple (H, g, A, l, u, M, h,
// JcT) for a batch: the mass matrix (crba), the bias (rnea at qdd = 0), the
// foot positions, Jacobians and drifts, and the cost and constraint rows of
// the TSID QP.  The JAX package has no Pallas kernel here: it leaves this
// stage to XLA, which fuses each elementwise chain under `jax.jit`
// (mpctsid_tpu/wbc/tsid.py:69).  Run op by op the plain PyTorch chain is
// about 824 kernels a tick, and replayed from a CUDA graph at B = 1 each
// costs 1.3-1.9 us: the node count, not the arithmetic, is the stage's time.
//
// What bounds it on this card: bytes.  Per scenario the inputs are 0.1-0.3
// KB and the outputs 3,088 values (H 900, A 1,500, M 324, J 216, g, l, u,
// h): 12.4 KB in float32 against about 12 k operations that the build
// needs (chip_smoke.py::rbd_ops), about one operation a byte where the
// card's f32 balance is 20.
//
// Design (second): a warp per scenario, up to rbd::MAX_WARPS a block, each
// with its slice of dynamic shared memory (rbd::WbcSlot: the inputs, the
// leg kinematics, M, J, the crba and rnea intermediates; 8.3 KB in float32,
// 16.5 KB in float64).  The per-scenario body is rbd::wbc_build_warp
// (rbd.h, shared with the CPU tests' host executor): phases of per-lane
// units between __syncwarp()s, the legs' chains one lane a leg, their
// congruences eight lanes a leg, and every output row stored by
// consecutive lanes at consecutive addresses, each value computed where it
// is stored.  The first design (PR 11: a thread per scenario, blocks of 32,
// its intermediates in local memory, strided stores) ran as one thread's
// serial chain at every B; scripts/probe_kernel_designs.py keeps it as a
// patched copy.  float and double (the contract's float64 build,
// `exact_pin`).
//
// Launch: wbc_build_launch(dtype, B, consts, in, stride, out, par, stream)
// with the arrays of rbd.h's WbcIn / WbcOut / WbcPar order; dtype 0 float,
// 1 double.  The layout (warps a block, shared bytes) is rbd::
// warps_per_block's on the current device (dyn/kernels.py::rbd_layout says
// the same); wbc_build_last_layout reports the last launch's.  Returns a
// cudaError_t (0 on success); launches on `stream` and allocates nothing.

#include <cuda_runtime.h>

#include "rbd.h"

namespace {

template <typename T>
__global__ void __launch_bounds__(rbd::WARP * rbd::MAX_WARPS)
wbc_build_kernel(const T* __restrict__ consts, const rbd::WbcArgs<T> args,
                 int B, int slot)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x / rbd::WARP;
    const long long b =
        (long long)blockIdx.x * (blockDim.x / rbd::WARP) + warp;
    if (b >= B) return;
    rbd::WarpExec ex;
    rbd::wbc_build_warp<T>(
        ex, consts, args, b,
        *reinterpret_cast<rbd::WbcSlot<T>*>(smem + (size_t)warp * slot));
}

int last_layout[3];   // warps a block, blocks, shared bytes a block

template <typename T>
int launch(int B, const void* consts, const void* const* in,
           const long long* stride, void* const* out, const double* par,
           cudaStream_t stream)
{
    rbd::WbcArgs<T> a;
    for (int k = 0; k < rbd::WI_COUNT; ++k) {
        a.in[k] = static_cast<const T*>(in[k]);
        a.stride[k] = stride[k];
    }
    for (int k = 0; k < rbd::WO_COUNT; ++k) a.out[k] = static_cast<T*>(out[k]);
    for (int k = 0; k < rbd::WP_COUNT; ++k) a.par[k] = (T)par[k];
    int dev, optin, n_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    const int slot = rbd::slot_bytes((int)sizeof(rbd::WbcSlot<T>));
    const int g = rbd::warps_per_block(B, slot, optin, n_sm);
    if (g < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (B + g - 1) / g, smem = g * slot;
    err = cudaFuncSetAttribute(wbc_build_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    wbc_build_kernel<T><<<blocks, g * rbd::WARP, smem, stream>>>(
        static_cast<const T*>(consts), a, B, slot);
    last_layout[0] = g;
    last_layout[1] = blocks;
    last_layout[2] = smem;
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int wbc_build_layout(int what) { return rbd::layout(what); }

// values (floats or doubles) of a warp's slot: rbd::WbcSlot
int wbc_build_slot_values()
{
    static_assert(sizeof(rbd::WbcSlot<double>)
                  == 2 * sizeof(rbd::WbcSlot<float>), "slot of values");
    return (int)(sizeof(rbd::WbcSlot<float>) / sizeof(float));
}

// the last launch's warps a block (0), blocks (1), shared bytes a block (2)
int wbc_build_last_layout(int what)
{
    return what >= 0 && what < 3 ? last_layout[what] : -1;
}

int wbc_build_launch(int dtype, int B, const void* consts,
                     const void* const* in, const long long* stride,
                     void* const* out, const double* par, void* stream)
{
    if (B < 1 || consts == nullptr) return (int)cudaErrorInvalidValue;
    for (int k = 0; k < rbd::WI_COUNT; ++k)
        if (in[k] == nullptr && k != rbd::WI_EXTRA)
            return (int)cudaErrorInvalidValue;
    for (int k = 0; k < rbd::WO_COUNT; ++k)
        if (out[k] == nullptr) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch<float>(B, consts, in, stride, out, par,
                             (cudaStream_t)stream);
    if (dtype == 1)
        return launch<double>(B, consts, in, stride, out, par,
                              (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

const char* wbc_build_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
