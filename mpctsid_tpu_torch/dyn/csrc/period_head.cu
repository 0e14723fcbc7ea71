// The period head in one launch — CUDA, sm_90a.
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
