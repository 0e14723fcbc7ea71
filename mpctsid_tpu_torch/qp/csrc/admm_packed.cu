// The packed ADMM iteration: several small scenarios per block, one warp
// each — CUDA, sm_90a.
//
// Replaces the TPU kernel `_admm_kernel_vpu_packed` (reached through
// `admm_iterate_vpu_packed` / `admm_iterate_packed`, backend "pallas_packed")
// of mpctsid_tpu/qp/pallas_kernels.py.  It computes the SAME function as the
// generic kernel (admm_vpu.cu): `iters` refined updates with K TRANSPOSED
// (admm_block.cuh, `refined_iterations`), for matrices small enough that a
// warp holds one scenario: the WBC QP, n = 30, m = 50.  f32 FMAs only; the
// five mat-vecs are computed here.  The TPU kernel packs G scenarios per grid
// step to amortise a per-step cost; here a block holds g scenarios, one warp
// each, and no barrier or reduction ever crosses scenarios (a NaN scenario
// cannot touch its neighbours).  Two paths, chosen by the wrapper's
// packed_layout() (slot sizes: packed_slot.h):
//
//   * REGISTER path (n <= 32: the WBC shape).  Per scenario the arithmetic
//     of the generic kernel's warp path, by the same code (warp_regs.cuh):
//     lane i holds row i of K^-1 and column i of K in registers, A sits in
//     the slot at a row stride of 36 floats, vector operands are read as
//     16-byte broadcasts; on the same inputs the two kernels give the same
//     bits.  What differs is the load: the generic kernel reads row `lane`
//     of K^-1 straight from device memory, the lanes n floats apart (no
//     read coalesced).  Here each warp copies its scenario's K^-1 and K row
//     by row with `cp.async` (one row per instruction, the lanes on
//     consecutive floats: coalesced) into a staging area in A's place, at
//     the odd stride n | 1, so that lane i reading row i (K^-1) and lane j
//     reading column j (K) hit 32 different banks for every n; then A's
//     rows follow into the same place.  No warp waits for another: a warp
//     starts iterating as soon as its own scenario has arrived.  Measured
//     (PERF.md): the load is half the kernel's time at the WBC shape
//     whatever its method (direct reads, these row copies, a block-wide
//     16-byte copy, one cp.async.bulk per matrix: within 3 %, their order
//     changing from call to call; an L2 prefetch of the next wave's
//     scenarios gained nothing), so the simplest ships.
//   * SHARED path (32 < n, as long as one scenario's K^-1, K and A fit a
//     block): K^-1, K, A and every vector in the warp's slice of shared
//     memory for all iterations, rows at the odd stride ld = n | 1 (free of
//     bank conflicts by rows and by columns), each lane owning output
//     elements lane, lane + 32, ... of every mat-vec; the loop is
//     admm_block.cuh's `warp_refined_iterations`, shared with the
//     whole-solve kernel's warp path.  The block copies its scenarios'
//     matrices together and synchronises once, before the loop.
//
// A scenario that fits neither path is refused by the wrapper, with the
// reason; this kernel never hands work to another.  The last block guards
// its tail (warps past B leave; on the shared path after the load).
//
// Bound on the card: as the generic kernel's (same bytes, same flops; at the
// WBC shape the bytes side).
//
// Plain C interface (loaded with ctypes), as admm_m2.cu.

#include <cuda_runtime.h>

#include "admm_block.cuh"
#include "cluster_exchange.cuh"
#include "packed_slot.h"
#include "warp_regs.cuh"

namespace {

using namespace admm_block;
using cluster_exchange::cp_async4;
using cluster_exchange::cp_async_wait;
using packed_slot::REG_LD;
using warp_regs::WARP_N;
using warp_regs::round4;

constexpr int MAX_REG_SLOTS = 16;     // register path: warps per block
constexpr int MAX_SHARED_SLOTS = 16;  // shared path: warps per block

struct PackedArgs {
    const float *Kinv, *K, *A, *q, *l, *u, *rho, *x0, *z0, *y0;
    float *x_out, *z_out, *y_out;
    int B, n, m, iters;
    float sigma, alpha;
};

// Scenario b into the warp: row `lane` of K^-1 and column `lane` of K into
// kinv / kcol (zero past n), x_lane and q_lane into x / q, A and the vectors
// into the slot.  Returns with the warp synchronised.
__device__ __forceinline__ void load_scenario(
    const PackedArgs& a, int b, const warp_regs::Slot& s,
    float (&kinv)[WARP_N], float (&kcol)[WARP_N], float& x, float& q,
    int lane)
{
    const int n = a.n, m = a.m;
    const int mp = round4(m);
    const size_t vn = (size_t)b * n, vm = (size_t)b * m;
    const bool own = lane < n;
    // 1. K^-1 and K -> staging in A's place, rows of stride n | 1, one row
    //    per instruction with the lanes on consecutive floats (coalesced)
    const int st = n | 1;
    float* stKinv = s.A;
    float* stK = s.A + packed_slot::stage_floats(n);
    const float* gKinv = a.Kinv + vn * n;
    const float* gK = a.K + vn * n;
    if (own)
        for (int i = 0; i < n; ++i) {
            cp_async4(stKinv + i * st + lane, gKinv + (size_t)i * n + lane);
            cp_async4(stK + i * st + lane, gK + (size_t)i * n + lane);
        }
    warp_regs::load_vectors(s, a.q + vn, a.l + vm, a.u + vm, a.rho + vm,
                            a.x0 + vn, a.z0 + vm, a.y0 + vm, n, m, lane, x,
                            q);
    cp_async_wait();
    __syncwarp();
    // 2. staging -> registers: lane i reads row i of K^-1 (the odd stride
    //    puts the 32 lanes on 32 banks), lane j column j of K
#pragma unroll
    for (int k = 0; k < WARP_N; ++k) {
        kinv[k] = own && k < n ? stKinv[lane * st + k] : 0.f;
        kcol[k] = own && k < n ? stK[k * st + lane] : 0.f;
    }
    __syncwarp();
    // 3. A's rows -> the slot at stride REG_LD, one row per instruction;
    //    columns n .. REG_LD - 1 and rows m .. round4(m) - 1 zero
    const float* gA = a.A + vm * n;
    for (int i = 0; i < mp; ++i) {
        float* row = s.A + i * REG_LD;
        if (i < m && own)
            cp_async4(row + lane, gA + (size_t)i * n + lane);
        else
            row[lane] = 0.f;
        if (lane < REG_LD - WARP_N) row[WARP_N + lane] = 0.f;
    }
    cp_async_wait();
    __syncwarp();
}

__global__ void __launch_bounds__(32 * MAX_REG_SLOTS)
admm_packed_regs_kernel(PackedArgs a, int slot_floats)
{
    extern __shared__ __align__(16) float smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int b = blockIdx.x * (blockDim.x >> 5) + warp;
    if (b >= a.B) return;      // nothing below waits for another warp
    const warp_regs::Slot s = warp_regs::carve_slot(
        smem + (size_t)warp * slot_floats, a.m,
        packed_slot::reg_a_floats(a.n, a.m));
    float kinv[WARP_N], kcol[WARP_N], x, q;
    load_scenario(a, b, s, kinv, kcol, x, q, lane);
    x = warp_regs::warp_register_iterations(kinv, kcol, s, REG_LD, a.n, a.m,
                                            a.iters, a.sigma, a.alpha, x, q,
                                            lane);
    const size_t vn = (size_t)b * a.n, vm = (size_t)b * a.m;
    warp_regs::store_results(s, x, a.x_out + vn, a.z_out + vm, a.y_out + vm,
                             a.n, a.m, lane);
}

__global__ void __launch_bounds__(32 * MAX_SHARED_SLOTS)
admm_packed_kernel(const float* __restrict__ Kinv, const float* __restrict__ K,
                   const float* __restrict__ A, const float* __restrict__ q,
                   const float* __restrict__ l, const float* __restrict__ u,
                   const float* __restrict__ rho, const float* __restrict__ x0,
                   const float* __restrict__ z0, const float* __restrict__ y0,
                   float* __restrict__ x_out, float* __restrict__ z_out,
                   float* __restrict__ y_out,
                   int B, int n, int m, int iters, float sigma, float alpha,
                   int ld, int slot_floats)
{
    extern __shared__ __align__(16) float smem[];
    const int T = blockDim.x;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int G = T >> 5;
    const int b0 = blockIdx.x * G;

    // the whole block copies the matrices of its scenarios, padded to ld
    for (int g = 0; g < G && b0 + g < B; ++g) {
        float* sKinv = smem + (size_t)g * slot_floats;
        float* sK = sKinv + n * ld;
        float* sA = sK + n * ld;
        const float* gKinv = Kinv + (size_t)(b0 + g) * n * n;
        const float* gK = K + (size_t)(b0 + g) * n * n;
        const float* gA = A + (size_t)(b0 + g) * m * n;
        for (int k = t; k < n * n; k += T) {
            const int i = k / n, j = k - i * n;
            sKinv[i * ld + j] = gKinv[k];
            sK[i * ld + j] = gK[k];
        }
        for (int k = t; k < m * n; k += T) {
            const int i = k / n, j = k - i * n;
            sA[i * ld + j] = gA[k];
        }
    }
    __syncthreads();

    const int b = b0 + warp;
    if (b >= B) return;

    float* sKinv = smem + (size_t)warp * slot_floats;
    float* sK = sKinv + n * ld;
    float* sA = sK + n * ld;
    float* sx = sA + m * ld;     // (n)
    float* sq = sx + n;          // (n)
    float* srhs = sq + n;        // (n)
    float* sxa = srhs + n;       // (n) x_a, then x_t in place
    float* sr = sxa + n;         // (n)
    float* sz = sr + n;          // (m)
    float* sy = sz + m;          // (m)
    float* sw = sy + m;          // (m)
    float* sl = sw + m;          // (m)
    float* su = sl + m;          // (m)
    float* srho = su + m;        // (m)
    float* srinv = srho + m;     // (m)

    for (int j = lane; j < n; j += 32) {
        sx[j] = x0[(size_t)b * n + j];
        sq[j] = q[(size_t)b * n + j];
    }
    for (int i = lane; i < m; i += 32) {
        const float r = rho[(size_t)b * m + i];
        const float zi = z0[(size_t)b * m + i];
        const float yi = y0[(size_t)b * m + i];
        sz[i] = zi;
        sy[i] = yi;
        sl[i] = l[(size_t)b * m + i];
        su[i] = u[(size_t)b * m + i];
        srho[i] = r;
        srinv[i] = 1.0f / r;
        sw[i] = r * zi - yi;
    }
    __syncwarp();

    WarpVecs v;
    v.x = sx;
    v.q = sq;
    v.rhs = srhs;
    v.xa = sxa;
    v.r = sr;
    v.z = sz;
    v.y = sy;
    v.w = sw;
    v.l = sl;
    v.u = su;
    v.rho = srho;
    v.rinv = srinv;
    // the loop is shared with the whole-solve kernel's warp path
    warp_refined_iterations(sKinv, sK, sA, ld, n, m, iters, sigma, alpha, v,
                            lane);

    for (int j = lane; j < n; j += 32) x_out[(size_t)b * n + j] = sx[j];
    for (int i = lane; i < m; i += 32) {
        z_out[(size_t)b * m + i] = sz[i];
        y_out[(size_t)b * m + i] = sy[i];
    }
}

// Opt in to `smem` bytes of dynamic shared memory where it exceeds 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem)
{
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// Floats of one scenario's slot on `path` (packed_slot.h): the count the
// wrapper's packed_layout() sizes launches with.
int admm_packed_slot_floats(int path, int n, int m)
{
    if (n <= 0 || m <= 0 || (path != packed_slot::PATH_REGISTERS &&
                              path != packed_slot::PATH_SHARED))
        return -1;
    return packed_slot::slot_floats(path, n, m);
}

// Launch on `stream` with the geometry of the wrapper's packed_layout():
// `path` (packed_slot.h: 1 register path, 0 shared path), `g` scenarios
// (warps) per block, A's row stride `ld` (REG_LD on the register path,
// n | 1 on the shared path) and `slot_floats` floats of shared memory per
// scenario; each is checked here.  Returns the CUDA error code of the launch
// (0 = success).
int admm_packed_launch(const float* Kinv, const float* K, const float* A,
                       const float* q, const float* l, const float* u,
                       const float* rho, const float* x0, const float* z0,
                       const float* y0, float* x_out, float* z_out,
                       float* y_out, int B, int n, int m, int iters,
                       float sigma, float alpha, int path, int g, int ld,
                       int slot_floats, void* stream)
{
    if (B <= 0 || n <= 0 || m <= 0 || iters < 0 || g < 1)
        return (int)cudaErrorInvalidValue;
    const bool regs = path == packed_slot::PATH_REGISTERS;
    if (!regs && path != packed_slot::PATH_SHARED)
        return (int)cudaErrorInvalidValue;
    if (slot_floats != packed_slot::slot_floats(path, n, m))
        return (int)cudaErrorInvalidValue;
    if (regs ? (n > WARP_N || g > MAX_REG_SLOTS || ld != REG_LD ||
                slot_floats != packed_slot::reg_a_floats(n, m) +
                                   warp_regs::vec_floats(m))
             : (g > MAX_SHARED_SLOTS || ld != (n | 1)))
        return (int)cudaErrorInvalidValue;

    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    int max_smem = 0;
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = sizeof(float) * (size_t)g * (size_t)slot_floats;
    if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;

    const int blocks = (B + g - 1) / g;
    if (regs) {
        err = allow_smem(admm_packed_regs_kernel, smem);
        if (err != cudaSuccess) return (int)err;
        const PackedArgs args = {Kinv, K, A, q, l, u, rho, x0, z0, y0,
                                 x_out, z_out, y_out, B, n, m, iters, sigma,
                                 alpha};
        admm_packed_regs_kernel<<<blocks, 32 * g, smem,
                                  (cudaStream_t)stream>>>(
            args, slot_floats);
        return (int)cudaGetLastError();
    }
    err = allow_smem(admm_packed_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    admm_packed_kernel<<<blocks, 32 * g, smem, (cudaStream_t)stream>>>(
        Kinv, K, A, q, l, u, rho, x0, z0, y0, x_out, z_out, y_out,
        B, n, m, iters, sigma, alpha, ld, slot_floats);
    return (int)cudaGetLastError();
}

const char* admm_packed_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
