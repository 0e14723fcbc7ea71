// The state estimator's tick, and its update alone, in one launch each —
// CUDA, sm_90a.
//
// est_step: est/filter.py::estimator_tick for a batch: the plant's IMU
// model (imu_from_plant, qdd = None) and one complementary-filter update
// (estimator_update) on it, the cascade's estimator tick.  est_update:
// est/filter.py::estimator_update, gyro and accel given.  One kernel body
// (est_step.h's `est_block`, the IMU model a template flag), two entry
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
// (chip_smoke.py::est_step_bound_ms): at B = 4096 well under a launch.  So
// the time is the launch and the chain's latency, and the design keeps the
// chain short and every warp's lanes busy with the same code.
//
// Design: a block of S scenarios (rbd::est::est_scenarios, mirrored by
// dyn/kernels.py::est_layout: B spread over the multiprocessors, at most
// 32), five warps.  The block's input rows and the model's constants come
// into shared memory by asynchronous copies, a value a thread, coalesced;
// then warp 0 runs the attitude chain and warps 1-4 one leg each, lane s
// on scenario s, side by side (the legs in the base frame need no
// corrected attitude); then v_lin and x, y, z a thread an entry; the
// block's q' and v' rows, staged in shared memory, are stored 16 bytes a
// thread.  Each warp runs its code once, fetched cold, so the code is kept
// small (est_step.h).  float and double.
//
// Launch: est_step_launch / est_update_launch(dtype, B, consts, in,
// stride, out, par, stream) with the arrays in est_step.h's In / Out / Par
// order; dtype 0 float, 1 double.  Returns a cudaError_t (0 on success);
// launches on `stream` and allocates nothing.

#include <cuda_runtime.h>

#include "est_step.h"

namespace {

using rbd::est::EST_THREADS;

// block blockIdx.x of S scenarios
template <bool IMU, typename T>
__device__ __forceinline__ void est_body(const T* __restrict__ consts,
                                         const rbd::est::EstArgs<T>& a,
                                         int B, int S)
{
    extern __shared__ __align__(16) unsigned char smem[];
    rbd::est::est_block<IMU, T>(rbd::est::BlockExec{}, consts, a, B, S,
                                blockIdx.x, reinterpret_cast<T*>(smem));
}

// the tick (the profiler tells the two entry points apart by their names)
template <typename T>
__global__ void __launch_bounds__(EST_THREADS)
est_step_kernel(const T* __restrict__ consts,
                const rbd::est::EstArgs<T> args, int B, int S)
{
    est_body<true, T>(consts, args, B, S);
}

// the update alone
template <typename T>
__global__ void __launch_bounds__(EST_THREADS)
est_update_kernel(const T* __restrict__ consts,
                  const rbd::est::EstArgs<T> args, int B, int S)
{
    est_body<false, T>(consts, args, B, S);
}

int last_layout[3];   // scenarios a block, blocks, shared bytes a block

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
    const int S = est_scenarios(B, optin, n_sm, (int)sizeof(T));
    if (S < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (B + S - 1) / S;
    const int smem = est_smem_bytes(S, (int)sizeof(T));
    if (IMU)
        est_step_kernel<T><<<blocks, EST_THREADS, smem, stream>>>(
            static_cast<const T*>(consts), a, B, S);
    else
        est_update_kernel<T><<<blocks, EST_THREADS, smem, stream>>>(
            static_cast<const T*>(consts), a, B, S);
    last_layout[0] = S;
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

// values (floats or doubles) a scenario takes in the block's shared
// memory: its rbd::est::EstRow, its q' row and its v' row
int est_step_slot_values()
{
    return rbd::est::EST_ROW_VALUES + rbd::NQ + rbd::NV;
}

// the last launch's (tick or update) scenarios a block (0), blocks (1),
// shared bytes a block (2)
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
