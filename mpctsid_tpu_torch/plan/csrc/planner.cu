// The planner's three kernels — CUDA, sm_90a, built with -fmad=false.
//
//   plan_footsteps: plan/footsteps.py::plan_footsteps_horizon, a thread per
//                   (scenario, foot): the 16-step horizon loop, the Raibert
//                   target at each swing -> stance transition, the first
//                   one kept as the next touchdown;
//   plan_rollout:   mpc/srb.py::reference_rollout, a thread per (scenario,
//                   step): the commanded-velocity rollout up to its step;
//   plan_swing:     plan/swing.py::swing_foot_ref, a thread per (scenario,
//                   foot): the quintic xy / sextic z reference and its
//                   derivatives.
//
// The JAX package has no Pallas kernel here: XLA fuses each of these chains
// under `jax.jit` (mpctsid_tpu/plan/footsteps.py:37, mpc/srb.py:53,
// plan/swing.py:14).  Op by op the plain PyTorch chains are about 911, 276
// and 56 kernels a call, each 1.3-1.9 us of a CUDA graph's replay at B = 1.
//
// What bounds them on this card: neither bytes nor operations.  Per
// scenario the footstep horizon reads 20 values and writes 204, the rollout
// reads 6 and writes 192, the swing reference reads 32 and writes 36;
// under 1,000 operations each.  At B = 1 a launch is one thread's chain of
// dependent steps (16 steps of sin, cos, sqrt): its latency is the time;
// at B = 4096 the writes (3.3 MB and 3.1 MB) are.  One thread per
// independent unit, 128 threads a block, nothing shared.  The rollout is a
// recursion over its 16 steps; a thread per step repeats the steps before
// its own (136 steps a scenario for 16) so that a warp writes 32
// consecutive rows of the output, not 32 rows 768 bytes apart.
//
// The arithmetic is planner.h's (shared with the CPU tests' g++ build),
// op by op the plain version's; -fmad=false keeps nvcc from contracting a
// product and a sum that PyTorch rounds apart.
//
// Launch: plan_<name>_launch(dtype, B, N, tables, in, stride, out, par,
// stream) with the arrays in planner.h's order (tables only for the
// footsteps, N unused by the swing reference); dtype 0 float, 1 double.
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

const char* planner_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
