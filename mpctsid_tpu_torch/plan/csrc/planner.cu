// The planner's four kernels — CUDA, sm_90a, built with -fmad=false.
//
//   plan_footsteps: plan/footsteps.py::plan_footsteps_horizon, a warp per
//                   scenario: a unit per (step, foot), 64 at N = 16, two a
//                   lane, each the Raibert target at the last swing ->
//                   stance transition up to its step (none where there is
//                   none), the rows staged in shared memory and written
//                   with 16-byte stores, the first transition's row kept
//                   as the next touchdown;
//   plan_rollout:   mpc/srb.py::reference_rollout, a group of G lanes per
//                   scenario (G = N's next power of two, at most 32: two
//                   scenarios a warp at N = 16): lane l takes step l of
//                   each chunk of G steps, one sin and cos of its own yaw;
//                   the positions are the ordered prefix sums of the
//                   steps' terms, read from the lanes before by shuffles;
//                   a block's rows staged in shared memory and written
//                   with 16-byte stores;
//   plan_swing:     plan/swing.py::swing_foot_ref, a block 64 scenarios:
//                   a unit per (scenario, foot) evaluating the quintic xy
//                   / sextic z reference and its derivatives into shared
//                   memory, the block's rows written with 16-byte stores;
//   plan_swing_at:  plan/swing.py::swing_references_period, the swing
//                   reference at each of a period's T ticks in one launch
//                   (swing_reference_at is the same kernel at T = 1): a
//                   block a run of (scenario, tick) rows, a unit per
//                   (scenario, foot) reading the gait tables, lift-off and
//                   touchdown once, then a unit per (scenario, tick, foot)
//                   evaluating the reference, the rows staged in shared
//                   memory and written with 16-byte stores.
//
// The JAX package has no Pallas kernel here: XLA fuses each of these chains
// under `jax.jit` (mpctsid_tpu/plan/footsteps.py:37, mpc/srb.py:53,
// plan/swing.py:14; the JAX cascade evaluates the swing reference every
// tick from tables taken once a period, cascade/engine.py:236-255).  Op by
// op the plain PyTorch chains are about 911, 276, 56 and 72 kernels a call
// (the swing reference at a tick: its prelude's 16 and the reference's
// 56), each 1.3-1.9 us of a CUDA graph's replay at B = 1.
//
// What bounds them on this card: neither bytes nor operations, but a
// launch and its dependent chain.  Per scenario the footstep horizon reads
// 20 values and writes 204, the rollout reads 6 and writes 192, the swing
// reference reads 32 and writes 36, over a period 27 and 8 table entries
// and writes 720 (T = 20); under 1,000 operations a scenario and tick.
// Hence the redesigns: the swing reference launched once a period where
// its inputs are fixed (it had been launched at every tick, each launch
// mostly latency), the rollout's recursion split so that a step costs one
// sin and cos (the first design repeated each step's prefix: 136 a
// scenario at N = 16, a chain of 16 on one thread at B = 1), the footstep
// horizon's 16-step chain on a thread per (scenario, foot) split into
// independent (step, foot) units (a step's value is the target at its last
// transition, a closed form in that step), and stores that a warp issues
// as contiguous 16-byte pieces (the first designs' scalar rows lay 48
// bytes apart).  On the cascade's main path the footstep units run inside
// the period plan (dyn/csrc/period_head.cu, one launch a period); this
// kernel serves plan_footsteps_horizon's other callers.
//
// The arithmetic is planner.h's (shared with the CPU tests' g++ build),
// op by op the plain version's; -fmad=false keeps nvcc from contracting a
// product and a sum that PyTorch rounds apart.
//
// Launch: plan_<name>_launch(dtype, B, N, tables, in, stride, out, par,
// stream) with the arrays in planner.h's order (tables for the footsteps
// and the swing reference over a period; N the horizon of the footsteps
// and the rollout, the period's ticks T of the swing reference, unused by
// plan_swing); dtype 0 float, 1 double.  The footsteps', the rollout's
// and the swing period's outputs must start on 16 bytes (the wrappers
// allocate them).
// Returns a cudaError_t (0 on success); launches on `stream` and allocates
// nothing.

#include <cuda_runtime.h>

#include "planner.h"

namespace {

constexpr int FOOT_WARPS = 4;     // scenarios (warps) a footstep block
constexpr int ROLL_THREADS = 128;
constexpr int SWING_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
// dynamic shared memory a block may take without opting in
constexpr long long SMEM_LIMIT = 48 * 1024;

// the block copies `bytes` (a multiple of 16) from shared memory to
// `dst`, 16 bytes a thread and consecutive threads on consecutive pieces
__device__ __forceinline__ void copy_out(void* dst, const void* src,
                                         long long bytes)
{
    const int4* s = static_cast<const int4*>(src);
    int4* d = static_cast<int4*>(dst);
    for (long long i = threadIdx.x; i < bytes / 16; i += blockDim.x)
        d[i] = s[i];
}

// a warp per scenario, blockDim.x / 32 of them a block, each with its
// staging rows (planner.h's footsteps_warp)
template <typename T>
__global__ void __launch_bounds__(planner::WARP * FOOT_WARPS)
plan_footsteps_kernel(const planner::FootArgs<T> a,
                      const int* __restrict__ tables, int N, int B)
{
    __shared__ __align__(16) T stage[FOOT_WARPS][planner::FOOT_CHUNK * 12];
    const int w = threadIdx.x / planner::WARP;
    const long long b =
        (long long)blockIdx.x * (blockDim.x / planner::WARP) + w;
    if (b >= B) return;
    const planner::FootScene<T> s{
        a.template row<T>(planner::FI_X, b),
        a.template row<T>(planner::FI_VCMD, b),
        a.template row<T>(planner::FI_FEET, b),
        *a.template row<int>(planner::FI_GAIT, b),
        *a.template row<int>(planner::FI_PHASE, b)};
    planner::footsteps_warp(planner::WarpExec{}, tables, N, s, a.par,
                            stage[w], a.out[planner::FO_FEET] + b * N * 12,
                            a.out[planner::FO_TD] + b * 12);
}

// G lanes a scenario, blockDim.x / G scenarios a block; the block's rows
// (B, N, 12) staged in shared memory, then copied out
template <typename T>
__global__ void __launch_bounds__(ROLL_THREADS)
plan_rollout_kernel(const planner::RollArgs<T> a, int N, int B, int G)
{
    extern __shared__ __align__(16) unsigned char smem[];
    T* stage = reinterpret_cast<T*>(smem);
    const int groups = blockDim.x / G;
    const int grp = threadIdx.x / G, l = threadIdx.x % G;
    const long long b0 = (long long)blockIdx.x * groups;
    const long long b = b0 + grp;
    // a group past the last scenario runs the last one's steps (its lanes
    // take part in the warp's shuffles) and stores nothing
    const long long bb = b < B ? b : B - 1;
    const T* x = a.template row<T>(planner::RI_X, bb);
    const T* vc = a.template row<T>(planner::RI_VCMD, bb);
    const T dt = a.par[planner::RP_DT], h = a.par[planner::RP_H_REF];
    const bool fused = a.par[planner::RP_FUSED_BMM] != (T)0;
    const T vbx = vc[0], vby = vc[1], wz = vc[2];
    T px = x[0], py = x[1], yaw = x[5];
    for (int c0 = 0; c0 < N; c0 += G) {
        const planner::RollTerm<T> t =
            planner::rollout_term(yaw, l, wz, dt, vbx, vby, fused);
        T qx = px, qy = py;
        planner::ordered_prefix(qx, qy, G, l, [&](int j, T& tx, T& ty) {
            tx = __shfl_sync(FULL, t.tx, j, G);
            ty = __shfl_sync(FULL, t.ty, j, G);
        });
        if (b < B && c0 + l < N)
            planner::rollout_row(stage + ((long long)grp * N + c0 + l) * 12,
                                 qx, qy, h, t, wz);
        // the next chunk starts where this chunk's last lane ends
        px = __shfl_sync(FULL, qx, G - 1, G);
        py = __shfl_sync(FULL, qy, G - 1, G);
        yaw = __shfl_sync(FULL, t.yaw_next, G - 1, G);
    }
    __syncthreads();
    const long long live = B - b0 < groups ? B - b0 : groups;
    copy_out(a.out[0] + b0 * N * 12, stage,
             live * N * 12 * (long long)sizeof(T));
}

// a block SWING_FOOT_ROWS scenarios of the (B, 4, 3) outputs: the
// (scenario, foot) units into the staging area, the staging copied out
// (planner.h's two phases)
template <typename T>
__global__ void __launch_bounds__(SWING_THREADS)
plan_swing_kernel(const planner::SwingArgs<T> a, int B)
{
    constexpr int R = planner::SWING_FOOT_ROWS;
    __shared__ __align__(16) T stage[3][12 * R];
    T* const st[3] = {stage[0], stage[1], stage[2]};
    const long long b0 = (long long)blockIdx.x * R;
    const int rows = B - b0 < R ? (int)(B - b0) : R;
    for (int u = threadIdx.x; u < planner::FEET * rows; u += blockDim.x)
        planner::swing_foot_unit(a, b0, u, st);
    __syncthreads();
#pragma unroll
    for (int o = 0; o < planner::SO_COUNT; ++o)
        copy_out(a.out[o] + b0 * 12, stage[o],
                 12LL * rows * (long long)sizeof(T));
}

// a block `swing_block_rows(Tn)` rows of the (B Tn, 4, 3) outputs: the
// (scenario, foot) set-ups, the (row, foot) evaluations into the staging
// area, the staging copied out (planner.h's three phases)
template <typename T>
__global__ void __launch_bounds__(SWING_THREADS)
plan_swing_at_kernel(const planner::SwingAtArgs<T> a,
                     const int* __restrict__ tables, int B, int Tn)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const planner::SwingBlock k = planner::swing_block(B, Tn, blockIdx.x);
    const int R = planner::swing_block_rows(Tn);
    T* s0 = reinterpret_cast<T*>(smem);
    T* const stage[3] = {s0, s0 + 12 * R, s0 + 24 * R};
    planner::SwingFoot<T>* feet =
        reinterpret_cast<planner::SwingFoot<T>*>(s0 + 36 * R);
    const int units = planner::FEET * k.rows;
    // the first phase-2 unit's tick fraction, read beside phase 1's reads
    T tf = (int)threadIdx.x < units
        ? planner::swing_frac(a, Tn, k, threadIdx.x) : (T)0;
    for (int u = threadIdx.x; u < planner::FEET * k.nb; u += blockDim.x)
        feet[u] = planner::swing_setup(a, tables, k, u);
    __syncthreads();
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
        if (u != (int)threadIdx.x) tf = planner::swing_frac(a, Tn, k, u);
        planner::swing_tick(a, feet[planner::swing_setup_unit(Tn, k, u)], tf,
                            u, stage);
    }
    __syncthreads();
#pragma unroll
    for (int o = 0; o < planner::SO_COUNT; ++o)
        copy_out(a.out[o] + k.r0 * 12, stage[o],
                 12LL * k.rows * (long long)sizeof(T));
}

int blocks_of(long long threads, int per_block)
{
    return (int)((threads + per_block - 1) / per_block);
}

// threads a block: `most`, or the work's units rounded up to a warp
int threads_for(long long units, int most)
{
    return units >= most ? most : (int)((units + 31) / 32 * 32);
}

bool aligned16(const void* p)
{
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <typename T>
int footsteps(int B, int N, const void* tables, const void* const* in,
              const long long* stride, void* const* out, const double* par,
              cudaStream_t stream)
{
    planner::FootArgs<T> a;
    planner::fill(a, in, stride, out, par);
    if (!aligned16(out[planner::FO_FEET]))
        return (int)cudaErrorMisalignedAddress;
    const int warps = B < FOOT_WARPS ? B : FOOT_WARPS;
    plan_footsteps_kernel<T><<<blocks_of(B, warps), warps * planner::WARP, 0,
                               stream>>>(
        a, static_cast<const int*>(tables), N, B);
    return (int)cudaGetLastError();
}

template <typename T>
int rollout(int B, int N, const void* const* in, const long long* stride,
            void* const* out, const double* par, cudaStream_t stream)
{
    planner::RollArgs<T> a;
    planner::fill(a, in, stride, out, par);
    const int G = planner::rollout_lanes(N);
    const int threads = threads_for((long long)B * G, ROLL_THREADS);
    const int groups = threads / G;
    const long long smem = (long long)groups * N * 12 * sizeof(T);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    if (!aligned16(out[0])) return (int)cudaErrorMisalignedAddress;
    plan_rollout_kernel<T><<<blocks_of(B, groups), threads, (size_t)smem,
                             stream>>>(a, N, B, G);
    return (int)cudaGetLastError();
}

template <typename T>
int swing(int B, const void* const* in, const long long* stride,
          void* const* out, const double* par, cudaStream_t stream)
{
    planner::SwingArgs<T> a;
    planner::fill(a, in, stride, out, par);
    for (int k = 0; k < planner::SO_COUNT; ++k)
        if (!aligned16(out[k])) return (int)cudaErrorMisalignedAddress;
    const int R = planner::SWING_FOOT_ROWS;
    const int threads = threads_for(
        planner::FEET * (long long)(B < R ? B : R), SWING_THREADS);
    plan_swing_kernel<T><<<blocks_of(B, R), threads, 0, stream>>>(a, B);
    return (int)cudaGetLastError();
}

template <typename T>
int swing_at(int B, int Tn, const void* tables, const void* const* in,
             const long long* stride, void* const* out, const double* par,
             cudaStream_t stream)
{
    planner::SwingAtArgs<T> a;
    planner::fill(a, in, stride, out, par);
    const int R = planner::swing_block_rows(Tn);
    const long long rows = (long long)B * Tn;
    const long long smem =
        (36LL * R + 7LL * planner::FEET * planner::swing_block_scenarios(Tn))
        * (long long)sizeof(T);
    for (int k = 0; k < planner::SO_COUNT; ++k)
        if (!aligned16(out[k])) return (int)cudaErrorMisalignedAddress;
    const int threads =
        threads_for(planner::FEET * (rows < R ? rows : R), SWING_THREADS);
    plan_swing_at_kernel<T><<<blocks_of(rows, R), threads, (size_t)smem,
                              stream>>>(
        a, static_cast<const int*>(tables), B, Tn);
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
    if (!valid(dtype, B, planner::SA_COUNT, in, planner::SO_COUNT, out)
        || tables == nullptr || N < 1)
        return (int)cudaErrorInvalidValue;
    return dtype == 0
        ? swing_at<float>(B, N, tables, in, stride, out, par,
                          (cudaStream_t)stream)
        : swing_at<double>(B, N, tables, in, stride, out, par,
                           (cudaStream_t)stream);
}

const char* planner_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
