// The generic ADMM iteration with the explicit refinement — CUDA, sm_90a.
//
// Replaces the TPU kernel `_admm_kernel_vpu` (reached through
// `admm_iterate_vpu`, backend "pallas_vpu" and, on that machine, "auto") of
// mpctsid_tpu/qp/pallas_kernels.py.  Per scenario, `iters` times, the update
// written out in admm_block.cuh (`refined_iterations`): two applications of
// K^-1 around the explicit residual rhs - K' x_a, then the z / y projection.
// Valid with equality rows, so it serves the WBC stage (n = 30, m = 50) as
// well as the MPC stage (n = 192, m = 320).  Any n, m, B >= 1, no padding.
// f32 FMAs only; the five mat-vecs are computed here, by this kernel.
//
// Two paths, chosen by the wrapper's vpu_layout() from (B, n, m), the
// block's shared-memory limit and the number of multiprocessors:
//
//   * WARP path (n <= 32: the WBC shape n = 30, m = 50).  One WARP per
//     scenario, several per block, no block barrier anywhere.  Lane i holds
//     row i of K^-1 in registers (for x_a = K^-1 rhs and K^-1 r), lane j
//     column j of K (for r = rhs - K' x_a); the vector operands are read
//     from the warp's slice of shared memory as 16-byte broadcasts, a
//     quarter of a shared-memory instruction per FMA.  A sits in the slice
//     (cp.async) with a row stride of 4 mod 8 floats: A' w reads a row per
//     step, lanes on neighbouring columns; A x_t reads 16-byte pieces of the
//     rows lane, lane + 32, ..., eight rows of a quarter warp on different
//     banks.  (Rows lane and lane + 32 of A also in registers for A x_t:
//     171 registers instead of 128, measured 9-20 % slower, 0.093-0.105
//     against 0.084-0.087 ms at the WBC shape, B = 4096, H100, in two
//     calls; a patched copy in scripts/probe_kernel_designs.py.)  The
//     elements of x, q, rhs, x_a, r and x_t that lane i owns stay in its
//     registers; only what the other lanes read goes to shared memory.
//   * BLOCK path (n > 32: the MPC shape).  One block per scenario (the TPU
//     kernel's one scenario per grid step), every vector in shared memory
//     for all iterations.  The matrices go to shared memory greedily, in the
//     order of their reads per iteration — K^-1 (twice), A (twice), K
//     (once) — as far as the block's opt-in limit allows, and are streamed
//     from global memory / L2 otherwise (MPC shape: K^-1 resident; A and K
//     stream).  Coalescing from row-major layouts: A' w and K' x_a reduce
//     over rows (one thread per column, rows dealt to `n_chunks` groups,
//     partial sums in shared memory); K^-1 rhs, K^-1 r and A x_t reduce over
//     columns (one warp per row, shuffle sum).  Seven __syncthreads() per
//     iteration (admm_block.cuh, `refined_iterations`).
//
// Bound on the card (chip_smoke.py computes it from the run's shapes): bytes
// = K^-1, K, A and the vectors once per scenario against the memory rate;
// operations = iters * (4 m n + 6 n^2) flops per scenario against the f32
// FMA peak.  At the WBC shape the bytes side is the larger.  The block path
// spends its time in barriers and shared-memory latency (0.646-0.655 ms at
// B = 4096, 35x the bound); the warp path has neither barrier nor a
// shared-memory read per FMA: 0.087-0.097 ms (the load alone 0.041;
// NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).

// Plain C interface (loaded with ctypes): device pointers and the stream as
// integers, launch on that stream, no allocation, no synchronisation; returns
// cudaGetLastError() of the launch.

#include <cuda_runtime.h>

#include "admm_block.cuh"
#include "cluster_exchange.cuh"
#include "warp_regs.cuh"

namespace {

using namespace admm_block;
using namespace cluster_exchange;

constexpr int MAX_WARP_SLOTS = 8;   // scenarios (warps) per block, at most

using warp_regs::WARP_N;
using warp_regs::round4;

// Floats of one scenario's slot on the warp path (the wrapper's
// vpu_layout() computes the same): A with round4(m) rows of stride ld,
// then the vectors of warp_regs.cuh.
__host__ __device__ __forceinline__ int vpu_slot_floats(int m, int ld)
{
    return round4(m) * ld + warp_regs::vec_floats(m);
}

struct VpuArgs {
    const float *Kinv, *K, *A, *q, *l, *u, *rho, *x0, *z0, *y0;
    float *x_out, *z_out, *y_out;
    int B, n, m, iters;
    float sigma, alpha;
};

// The update of refined_iterations (admm_block.cuh: K TRANSPOSED) by one
// warp per scenario; see the file's head.  The loop is warp_regs.cuh's,
// shared with the packed kernel's register path (admm_packed.cu).
__global__ void __launch_bounds__(32 * MAX_WARP_SLOTS)
admm_vpu_warp_kernel(VpuArgs a, int ld, int slot_floats)
{
    extern __shared__ __align__(16) float smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int b = blockIdx.x * (blockDim.x >> 5) + warp;
    if (b >= a.B) return;      // nothing below waits for another warp
    const int n = a.n, m = a.m;
    const int mp = round4(m);
    const warp_regs::Slot s =
        warp_regs::carve_slot(smem + (size_t)warp * slot_floats, m, mp * ld);

    // A -> the slot (asynchronously; pad columns zeroed), pad rows zeroed
    load_rows(s.A, ld, a.A + (size_t)b * m * n, m, n, lane, 32);
    for (int k = m * ld + lane; k < mp * ld; k += 32) s.A[k] = 0.f;
    // row `lane` of K^-1 and column `lane` of K, zero past n
    const float* gKinv = a.Kinv + (size_t)b * n * n;
    const float* gK = a.K + (size_t)b * n * n;
    const bool own = lane < n;
    float kinv[WARP_N], kcol[WARP_N];
#pragma unroll
    for (int k = 0; k < WARP_N; ++k) {
        kinv[k] = own && k < n ? gKinv[lane * n + k] : 0.f;
        kcol[k] = own && k < n ? gK[k * n + lane] : 0.f;
    }
    const size_t vn = (size_t)b * n, vm = (size_t)b * m;
    float x, q;
    warp_regs::load_vectors(s, a.q + vn, a.l + vm, a.u + vm, a.rho + vm,
                            a.x0 + vn, a.z0 + vm, a.y0 + vm, n, m, lane, x,
                            q);
    cp_async_wait();
    __syncwarp();

    x = warp_regs::warp_register_iterations(kinv, kcol, s, ld, n, m, a.iters,
                                            a.sigma, a.alpha, x, q, lane);
    warp_regs::store_results(s, x, a.x_out + vn, a.z_out + vm, a.y_out + vm,
                             n, m, lane);
}

__global__ void __launch_bounds__(1024)
admm_vpu_kernel(const float* __restrict__ Kinv, const float* __restrict__ K,
                const float* __restrict__ A, const float* __restrict__ q,
                const float* __restrict__ l, const float* __restrict__ u,
                const float* __restrict__ rho, const float* __restrict__ x0,
                const float* __restrict__ z0, const float* __restrict__ y0,
                float* __restrict__ x_out, float* __restrict__ z_out,
                float* __restrict__ y_out,
                int n, int m, int iters, float sigma, float alpha,
                int kinv_in_smem, int a_in_smem, int k_in_smem,
                int col_threads, int n_chunks)
{
    extern __shared__ __align__(16) float smem[];
    const int b = blockIdx.x;
    const int T = blockDim.x;
    const int t = threadIdx.x;

    const float* gKinv = Kinv + (size_t)b * n * n;
    const float* gK = K + (size_t)b * n * n;
    const float* gA = A + (size_t)b * m * n;

    IterVecs v;
    float* p = smem;
    v.x = p;    p += n;
    v.q = p;    p += n;
    v.rhs = p;  p += n;
    v.xa = p;   p += n;
    v.r = p;    p += n;
    v.xt = p;   p += n;
    v.z = p;    p += m;
    v.y = p;    p += m;
    v.w = p;    p += m;
    v.l = p;    p += m;
    v.u = p;    p += m;
    v.rho = p;  p += m;
    v.rinv = p; p += m;
    v.part = p; p += n_chunks * n;

    const float* Kinv_p = gKinv;
    const float* A_p = gA;
    const float* K_p = gK;
    if (kinv_in_smem) {
        for (int k = t; k < n * n; k += T) p[k] = gKinv[k];
        Kinv_p = p;
        p += n * n;
    }
    if (a_in_smem) {
        for (int k = t; k < m * n; k += T) p[k] = gA[k];
        A_p = p;
        p += m * n;
    }
    if (k_in_smem) {
        for (int k = t; k < n * n; k += T) p[k] = gK[k];
        K_p = p;
    }

    for (int j = t; j < n; j += T) {
        v.x[j] = x0[(size_t)b * n + j];
        v.q[j] = q[(size_t)b * n + j];
    }
    for (int i = t; i < m; i += T) {
        const float r = rho[(size_t)b * m + i];
        const float zi = z0[(size_t)b * m + i];
        const float yi = y0[(size_t)b * m + i];
        v.z[i] = zi;
        v.y[i] = yi;
        v.l[i] = l[(size_t)b * m + i];
        v.u[i] = u[(size_t)b * m + i];
        v.rho[i] = r;
        v.rinv[i] = 1.0f / r;
        v.w[i] = r * zi - yi;
    }
    __syncthreads();

    refined_iterations(Kinv_p, K_p, A_p, n, m, iters, sigma, alpha, v,
                       col_threads, n_chunks);

    for (int j = t; j < n; j += T) x_out[(size_t)b * n + j] = v.x[j];
    for (int i = t; i < m; i += T) {
        z_out[(size_t)b * m + i] = v.z[i];
        y_out[(size_t)b * m + i] = v.y[i];
    }
}

}  // namespace

extern "C" {

// Launch on `stream` with the geometry of the wrapper's vpu_layout():
//   g > 0:   the warp path, g scenarios (warps) per block, A's row stride
//            `ld` (a multiple of four, at least 32), `slot_floats` floats of
//            shared memory per scenario (checked here);
//   g == 0:  the block path, `threads` threads per block (a multiple of 32
//            in [32, 1024]).
// Returns the CUDA error code of the launch (0 = success).
int admm_vpu_launch(const float* Kinv, const float* K, const float* A,
                    const float* q, const float* l, const float* u,
                    const float* rho, const float* x0, const float* z0,
                    const float* y0, float* x_out, float* z_out, float* y_out,
                    int B, int n, int m, int iters, float sigma, float alpha,
                    int g, int threads, int ld, int slot_floats,
                    void* stream)
{
    if (B <= 0 || n <= 0 || m <= 0 || iters < 0)
        return (int)cudaErrorInvalidValue;

    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    int max_smem = 0;
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;

    if (g > 0) {
        if (g > MAX_WARP_SLOTS || n > WARP_N || (ld & 3) != 0 ||
            ld < WARP_N || slot_floats != vpu_slot_floats(m, ld))
            return (int)cudaErrorInvalidValue;
        const size_t smem = sizeof(float) * (size_t)g * (size_t)slot_floats;
        if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
        const VpuArgs args = {Kinv, K, A, q, l, u, rho, x0, z0, y0,
                              x_out, z_out, y_out, B, n, m, iters, sigma,
                              alpha};
        if (smem > 48 * 1024) {
            err = cudaFuncSetAttribute(
                admm_vpu_warp_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (err != cudaSuccess) return (int)err;
        }
        admm_vpu_warp_kernel<<<(B + g - 1) / g, 32 * g, smem, (cudaStream_t)stream>>>(
            args, ld, slot_floats);
        return (int)cudaGetLastError();
    }

    if (threads < 32 || threads > 1024 || (threads & 31) != 0)
        return (int)cudaErrorInvalidValue;
    const int n_up = (n + 31) / 32 * 32;
    const int col_threads = n_up < threads ? n_up : threads;
    const int n_chunks = threads / col_threads;
    const size_t vec_bytes = sizeof(float) *
        ((size_t)6 * n + (size_t)7 * m + (size_t)n_chunks * n);
    if (vec_bytes > (size_t)max_smem) return (int)cudaErrorInvalidValue;
    const Residency res = greedy_residency(
        vec_bytes, sizeof(float) * (size_t)n * (size_t)n,
        sizeof(float) * (size_t)m * (size_t)n, (size_t)max_smem);
    const size_t smem = res.smem;

    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(admm_vpu_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    admm_vpu_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        Kinv, K, A, q, l, u, rho, x0, z0, y0, x_out, z_out, y_out,
        n, m, iters, sigma, alpha, res.kinv, res.a, res.k,
        col_threads, n_chunks);
    return (int)cudaGetLastError();
}

const char* admm_vpu_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
