// The plant step in one launch — CUDA, sm_90a.
//
// Computes env/plant.py::plant_step for a batch: every substep's mass
// matrix (crba) and bias (rnea), foot positions and Jacobians, the penalty
// contact law with implicit damping (M + h J' D J) v+ = M v + h (tau - bias
// + J' f_el), the Coulomb-cone / unilateral clamp with anchor drag and the
// explicit re-solve where a foot was clamped, then the configuration's
// integration; both substeps in one launch.  The JAX package has no Pallas
// kernel here: XLA fuses the stage under `jax.jit` (mpctsid_tpu/env/
// plant.py:66, :131).  Op by op the plain PyTorch chain is about 2,339
// kernels a tick, each 1.3-1.9 us of a CUDA graph's replay at B = 1.
//
// What bounds it on this card: operations, and far from the bound.  Per
// scenario the state and parameters are 66 values in (102 with the
// payload) and 61 out (0.5 KB in float32) against about 12.9 k operations
// that a substep needs (chip_smoke.py::rbd_ops: crba, rnea, J' D J, the
// factor and solves, with the model's zeros skipped).  At B = 1 the launch
// is one scenario's chain of dependent steps: its latency is the time.
//
// Design (second): a warp per scenario, up to rbd::MAX_WARPS a block, each
// with its slice of dynamic shared memory (rbd::PlantSlot: the state, the
// leg kinematics, M, M + h J' D J, J, the crba and rnea intermediates; 9.7
// KB in float32, 19.4 KB in float64).  The per-scenario body is
// rbd::plant_step_warp (rbd.h, shared with the CPU tests' host executor):
// the frame's phases as the build runs them, then the contact law lane by
// foot, M + h J' D J on its arrow's non-zeros, and the two SPD solves by
// the arrow structure (each leg's 3 x 3 factor on its own lane, the Schur
// complement of the 6 x 6 base block, the legs' solves): 873 operations
// where a dense 18 x 18 Cholesky takes 1,944, and short chains.  The
// re-solve is the scenario's branch, so the warp's.  The first design (PR
// 11: a thread per scenario, blocks of 32, dense Cholesky in local memory)
// ran as one thread's serial chain at every B; scripts/
// probe_kernel_designs.py keeps it as a patched copy.
//
// Launch: plant_step_launch(dtype, B, consts, in, stride, out, par, stream)
// with the arrays of rbd.h's PlantIn / PlantOut / PlantPar order; dtype 0
// float, 1 double.  The layout (warps a block, shared bytes) is rbd::
// warps_per_block's on the current device (dyn/kernels.py::rbd_layout says
// the same); plant_step_last_layout reports the last launch's.  Returns a
// cudaError_t (0 on success); launches on `stream` and allocates nothing.

#include <cuda_runtime.h>

#include "rbd.h"

namespace {

template <typename T>
__global__ void __launch_bounds__(rbd::WARP * rbd::MAX_WARPS)
plant_step_kernel(const T* __restrict__ consts, const rbd::PlantArgs<T> args,
                  int B, int slot)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x / rbd::WARP;
    const long long b =
        (long long)blockIdx.x * (blockDim.x / rbd::WARP) + warp;
    if (b >= B) return;
    rbd::WarpExec ex;
    rbd::plant_step_warp<T>(
        ex, consts, args, b,
        *reinterpret_cast<rbd::PlantSlot<T>*>(smem + (size_t)warp * slot));
}

int last_layout[3];   // warps a block, blocks, shared bytes a block

template <typename T>
int launch(int B, const void* consts, const void* const* in,
           const long long* stride, void* const* out, const double* par,
           cudaStream_t stream)
{
    rbd::PlantArgs<T> a;
    for (int k = 0; k < rbd::PI_COUNT; ++k) {
        a.in[k] = static_cast<const T*>(in[k]);
        a.stride[k] = stride[k];
    }
    for (int k = 0; k < rbd::PO_COUNT; ++k) a.out[k] = static_cast<T*>(out[k]);
    for (int k = 0; k < rbd::PP_COUNT; ++k) a.par[k] = (T)par[k];
    int dev, optin, n_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    const int slot = rbd::slot_bytes((int)sizeof(rbd::PlantSlot<T>));
    const int g = rbd::warps_per_block(B, slot, optin, n_sm);
    if (g < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (B + g - 1) / g, smem = g * slot;
    err = cudaFuncSetAttribute(plant_step_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    plant_step_kernel<T><<<blocks, g * rbd::WARP, smem, stream>>>(
        static_cast<const T*>(consts), a, B, slot);
    last_layout[0] = g;
    last_layout[1] = blocks;
    last_layout[2] = smem;
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int plant_step_layout(int what) { return rbd::layout(what); }

// values (floats or doubles) of a warp's slot: rbd::PlantSlot
int plant_step_slot_values()
{
    static_assert(sizeof(rbd::PlantSlot<double>)
                  == 2 * sizeof(rbd::PlantSlot<float>), "slot of values");
    return (int)(sizeof(rbd::PlantSlot<float>) / sizeof(float));
}

// the last launch's warps a block (0), blocks (1), shared bytes a block (2)
int plant_step_last_layout(int what)
{
    return what >= 0 && what < 3 ? last_layout[what] : -1;
}

int plant_step_launch(int dtype, int B, const void* consts,
                     const void* const* in, const long long* stride,
                     void* const* out, const double* par, void* stream)
{
    if (B < 1 || consts == nullptr) return (int)cudaErrorInvalidValue;
    for (int k = 0; k < rbd::PI_COUNT; ++k)
        if (in[k] == nullptr && k != rbd::PI_EXTRA)
            return (int)cudaErrorInvalidValue;
    for (int k = 0; k < rbd::PO_COUNT; ++k)
        if (out[k] == nullptr) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch<float>(B, consts, in, stride, out, par,
                             (cudaStream_t)stream);
    if (dtype == 1)
        return launch<double>(B, consts, in, stride, out, par,
                              (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

const char* plant_step_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
