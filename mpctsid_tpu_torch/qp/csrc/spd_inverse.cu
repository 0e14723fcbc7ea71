// K^-1 of a batch of SPD matrices: the Jacobi-scaled Cholesky inverse with one
// guarded Newton-Schulz step — CUDA, sm_90a.
//
// Replaces the XLA compilation of the JAX package's
// `spd_inverse_chol(K, ns_steps=1)` (mpctsid_tpu/qp/blockinv.py:203), which
// the JAX package computes outside Pallas: K^-1 for the kernel backends of
// qp/admm.py (once per adapt round: twice per MPC solve, three times per WBC
// tick on backends "vpu", "packed", "mma").  Its plain version is the port's
// qp/blockinv.py::spd_inverse_chol, whose batched form is some 510 device ops
// at n = 30 and 3,404 at n = 192.  Per matrix:
//   s = 1 / sqrt(max(diag K, 1e-30)), Ks = s K s, L = chol(Ks) with the
//   1e-10 pivot floor, X0 = L^-T L^-1, X = X0 (2 I - Ks X0) kept only where
//   |I - Ks X|_F^2 < 4 |I - Ks X0|_F^2 + 1 (NaN: X0), the identity where the
//   kept X is not finite, K^-1 = s X s.
// Every reduction is over ONE matrix: one matrix never changes another.
//
// What bounds it on this card.  Operations: n^3 / 3 (Cholesky) + n^3 / 3
// (triangular inverse) + about 7 n^3 (X0 and the three products of the
// Newton-Schulz step and its guard); bytes: K in, K^-1 out.  At n = 30 that is
// 0.2 M FMAs per matrix in some 150 dependent steps; at n = 192 the
// factorization is 2.4 M FMAs (six panels, five block rows), the products
// 6.8 M FMAs.
//
// Two paths, chosen by the wrapper's `spd_inverse_layout` (qp/kernels.py):
//
//   * WARP path (spd_inverse_warp_kernel), n <= 32: one warp per matrix,
//     several per block, the whole function in one launch: kernel 4's warp
//     factorization (spd_inverse.cuh, shared with admm_fused.cu) over a
//     scratch of n rows of 32 floats; K is copied in and K^-1 out through
//     that scratch, so both device-memory passes are coalesced.
//   * BLOCK path, n > 32: one block per matrix for the factorization and
//     X0, the dense products of the Newton-Schulz step on cuBLAS through the
//     wrapper (as the JAX package leaves them to XLA).
//     spd_inverse_block_kernel writes s, Ks, X0 = L^-T L^-1 and 2 I into the
//     Newton-Schulz buffer; the wrapper forms M = 2 I - Ks X0 (in place), X =
//     X0 M and T = Ks X with torch.bmm; spd_newton_select_kernel takes the
//     guard (|M - I|^2 is |I - Ks X0|^2), the finite test and s X s.  Five
//     device ops per inverse.  The factorization is BLOCKED (spd_blocked.h):
//     panels of 32 columns, each diagonal block factored and inverted by one
//     warp in registers (spd_inverse.cuh's register sweep), the panel below
//     it and the trailing update in 4 x 4 register tiles per thread, L^-1
//     by blocked forward substitution in the same panel sweep (3 block
//     barriers a panel, 17 at n = 192, where a scalar right-looking sweep
//     needs 2 per column of each of its two sweeps: 768), then X0 from
//     L^-1's lower triangle.  The working matrix W (n padded to a multiple
//     of 32 with the identity, rows of n + 4 floats) lives in shared memory
//     up to n = 192 (175 KB with the panel buffer), loaded with one
//     cp.async.bulk per row where the rows are 16-byte aligned; larger n in
//     a device-memory workspace (the wrapper's), by the same code.
//
// Plain C interface (loaded with ctypes), as admm_m2.cu.

#include <cuda_runtime.h>

#include <stdint.h>

#include "admm_block.cuh"
#include "cluster_exchange.cuh"
#include "spd_blocked.h"
#include "spd_inverse.cuh"

namespace {

using cluster_exchange::barrier_expect;
using cluster_exchange::barrier_init;
using cluster_exchange::barrier_wait;
using cluster_exchange::shared_addr;
using spd_blocked::PW;

using spd_warp::FULL;
using spd_warp::WN;
using spd_warp::WS;

constexpr int MAX_SLOTS = 8;        // warp path: matrices (warps) per block

// 1 / sqrt(max(d, 1e-30)) with NaN kept NaN, as torch.clamp_min keeps it:
// the square root and the division both correctly rounded, so that s and
// Ks are the plain version's bit for bit
__device__ __forceinline__ float jacobi_scale(float d)
{
    return 1.0f / sqrtf(d < 1e-30f ? 1e-30f : d);
}

__global__ void __launch_bounds__(32 * MAX_SLOTS)
spd_inverse_warp_kernel(const float* __restrict__ K, float* __restrict__ out,
                        int B, int n)
{
    extern __shared__ __align__(16) float smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int b = blockIdx.x * (blockDim.x >> 5) + warp;
    if (b >= B) return;     // a whole warp: the block has no block barrier
    float* sW = smem + (size_t)warp * n * WS;
    const size_t nn = (size_t)n * n;

    // K through W (row stride n) for a coalesced load, row `lane` into
    // registers
    for (int k = lane; k < n * n; k += 32) sW[k] = K[(size_t)b * nn + k];
    __syncwarp();
    const bool act = lane < n;
    const int own = act ? lane : 0;
    float kr[WN];
#pragma unroll
    for (int j = 0; j < WN; ++j) kr[j] = j < n ? sW[own * n + j] : 0.f;
    const float si = act ? jacobi_scale(sW[own * n + own]) : 0.f;
    __syncwarp();

    float xr[WN];
    const bool bad = spd_warp::warp_scaled_inverse(kr, si, n, sW, lane, xr);

    // K^-1 = s X s (s I s where X is not finite), row `lane`, out through W
#pragma unroll
    for (int j = 0; j < WN; ++j) {
        const float sj = __shfl_sync(FULL, si, j);
        if (j < n && act) {
            const float xv = bad ? (j == lane ? 1.0f : 0.f) : xr[j];
            sW[lane * n + j] = (xv * sj) * si;
        }
    }
    __syncwarp();
    for (int k = lane; k < n * n; k += 32) out[(size_t)b * nn + k] = sW[k];
}

constexpr int MAX_BLOCK_THREADS = 512;  // block path

// The diagonal block D (32 x 32 at stride ld, lower triangle valid) by one
// warp: lane i loads row i, the register sweep of spd_inverse.cuh factors
// and inverts it, and L^-1 (zeros above the diagonal) goes over D.
__device__ __forceinline__ void diag_factor_warp(float* D, int ld, int lane)
{
    float r[PW];
#pragma unroll
    for (int q = 0; q < PW / 4; ++q) {
        float v[4];
        spd_blocked::load4(D + lane * ld + 4 * q, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) r[4 * q + e] = v[e];
    }
    __syncwarp();
    spd_warp::warp_chol_inverse(r, D, ld, PW, lane);
}

// spd_blocked::factor_and_invert's executor: the block's threads take the
// units in turn, a barrier between phases, warp 0 the diagonal blocks
struct BlockExec {
    __device__ int first() const { return threadIdx.x; }
    __device__ int step() const { return blockDim.x; }
    __device__ void sync() const { __syncthreads(); }
    __device__ void diag(float* D, int ld) const
    {
        if (threadIdx.x < 32) diag_factor_warp(D, ld, threadIdx.x);
    }
};

// rows [0, n) of K (row stride n) -> W (row stride ld) by one cp.async.bulk
// per row, counted by `bar`; every thread returns once all rows are in
__device__ __forceinline__ void bulk_load_rows(float* W, int ld,
                                               const float* K, int n,
                                               uint64_t* bar)
{
    const int t = threadIdx.x;
    if (t == 0) {
        barrier_init(bar);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (t == 0) barrier_expect(bar, (unsigned)(sizeof(float) * n * n));
    for (int i = t; i < n; i += blockDim.x)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\n"
            :: "r"(shared_addr(W + i * ld)), "l"(K + (size_t)i * n),
               "r"((unsigned)(sizeof(float) * n)), "r"(shared_addr(bar))
            : "memory");
    barrier_wait(bar, 0);
}

__global__ void __launch_bounds__(MAX_BLOCK_THREADS)
spd_inverse_block_kernel(const float* __restrict__ K, float* __restrict__ ks,
                         float* __restrict__ s_out, float* __restrict__ x0,
                         float* __restrict__ two_eye, float* work, int n,
                         int w_in_smem)
{
    extern __shared__ __align__(16) float smem[];
    const int b = blockIdx.x;
    const int t = threadIdx.x, T = blockDim.x;
    const int np = spd_blocked::padded(n), ld = spd_blocked::stride(np);
    const size_t nn = (size_t)n * n;
    const float* gK = K + (size_t)b * nn;
    float* gKs = ks + (size_t)b * nn;
    float* gX0 = x0 + (size_t)b * nn;
    float* gM = two_eye + (size_t)b * nn;
    float* s = smem;                                 // np: the Jacobi scale
    float* P = s + np;                               // np rows of PLD
    uint64_t* bar = reinterpret_cast<uint64_t*>(P + np * spd_blocked::PLD);
    float* W = w_in_smem ? P + np * spd_blocked::PLD + 4
                         : work + (size_t)b * np * ld;

    // K -> W: a bulk copy per row where the rows are 16-byte aligned.  The
    // element loops below run rows over warps and columns over lanes.
    const int lane = t & 31, warp = t >> 5, n_warps = T >> 5;
    if (w_in_smem && (n & 3) == 0 &&
        (reinterpret_cast<uintptr_t>(gK) & 15) == 0) {
        bulk_load_rows(W, ld, gK, n, bar);
    } else {
        for (int i = warp; i < n; i += n_warps)
            for (int j = lane; j < n; j += 32)
                W[i * ld + j] = gK[(size_t)i * n + j];
        __syncthreads();
    }
    for (int j = t; j < n; j += T) {
        const float sj = jacobi_scale(W[j * ld + j]);
        s[j] = sj;
        s_out[(size_t)b * n + j] = sj;
    }
    __syncthreads();
    // Ks = s K s (out and over W), 2 I, and the identity's pad
    for (int i = warp; i < np; i += n_warps) {
        const float si = i < n ? s[i] : 0.f;
        for (int j = lane; j < np; j += 32) {
            if (i < n && j < n) {
                const float v = (W[i * ld + j] * si) * s[j];
                W[i * ld + j] = v;
                gKs[(size_t)i * n + j] = v;
                gM[(size_t)i * n + j] = i == j ? 2.0f : 0.f;
            } else {
                W[i * ld + j] = i == j ? 1.0f : 0.f;
            }
        }
    }
    __syncthreads();

    BlockExec ex;
    spd_blocked::factor_and_invert(ex, W, ld, P, np);

    // X0 = L^-T L^-1, symmetric, from L^-1 in W's lower triangle
    for (int u = t; u < spd_blocked::tri(np / PW) * spd_blocked::UNITS;
         u += T)
        spd_blocked::x0_unit(W, ld, np, gX0, n, u,
                             max(1, T / spd_blocked::UNITS));
}

// M = 2 I - Ks X0, X = X0 M, T = Ks X: keep X where |I - T|^2 < 4 |M - I|^2
// + 1, else X0; the identity where that is not finite; out = s X s.  One block
// per matrix.
__global__ void __launch_bounds__(256)
spd_newton_select_kernel(const float* __restrict__ X0,
                         const float* __restrict__ M,
                         const float* __restrict__ X,
                         const float* __restrict__ T1,
                         const float* __restrict__ s,
                         float* __restrict__ out, int n)
{
    __shared__ float red[33];
    const int b = blockIdx.x, t = threadIdx.x, T = blockDim.x;
    const size_t nn = (size_t)n * n, base = (size_t)b * nn;
    float r0 = 0.f, r1 = 0.f;
    for (int k = t; k < n * n; k += T) {
        const int i = k / n, j = k - i * n;
        const float eye = i == j ? 1.0f : 0.f;
        const float d0 = M[base + k] - eye;
        const float d1 = eye - T1[base + k];
        r0 = fmaf(d0, d0, r0);
        r1 = fmaf(d1, d1, r1);
    }
    r0 = admm_block::block_sum(r0, red);
    r1 = admm_block::block_sum(r1, red);
    const float* sel = (r1 < r0 * 4.0f + 1.0f) ? X : X0;
    float bad = 0.f;
    for (int k = t; k < n * n; k += T)
        if (!isfinite(sel[base + k])) bad += 1.0f;
    bad = admm_block::block_sum(bad, red);
    const float* sb = s + (size_t)b * n;
    for (int k = t; k < n * n; k += T) {
        const int i = k / n, j = k - i * n;
        const float xv = bad > 0.f ? (i == j ? 1.0f : 0.f) : sel[base + k];
        out[base + k] = (xv * sb[i]) * sb[j];
    }
}

int max_smem_optin(int* max_smem)
{
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaDeviceGetAttribute(
        max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

int set_smem(const void* kernel, size_t bytes)
{
    if (bytes <= 48 * 1024) return (int)cudaSuccess;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// The warp path (n <= 32): g matrices (warps) per block, n * 32 floats of
// shared memory each.  Returns the CUDA error code of the launch.
int spd_inverse_warp_launch(const float* K, float* out, int B, int n, int g,
                            void* stream)
{
    if (B <= 0 || n <= 0 || n > WN || g <= 0 || g > MAX_SLOTS)
        return (int)cudaErrorInvalidValue;
    int max_smem = 0;
    int err = max_smem_optin(&max_smem);
    if (err != (int)cudaSuccess) return err;
    const size_t smem = sizeof(float) * (size_t)g * (size_t)n * WS;
    if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
    err = set_smem((const void*)spd_inverse_warp_kernel, smem);
    if (err != (int)cudaSuccess) return err;
    spd_inverse_warp_kernel<<<(B + g - 1) / g, 32 * g, smem,
                              (cudaStream_t)stream>>>(K, out, B, n);
    return (int)cudaGetLastError();
}

// The block path's factorization (n > 32): one block of `threads` (a
// multiple of 32, at most 512) per matrix; writes s (B, n), Ks and X0 =
// L^-T L^-1 (B, n, n) and 2 I into `two_eye` (B, n, n).  w_in_smem: the
// working matrix in shared memory (spd_blocked::smem_floats, checked here),
// else in `work`, B np (np + 4) floats, np = n rounded up to a multiple of
// 32.
// Returns the CUDA error code.
int spd_inverse_factor_launch(const float* K, float* ks, float* s, float* x0,
                              float* two_eye, float* work, int B, int n,
                              int threads, int w_in_smem, void* stream)
{
    if (B <= 0 || n <= WN || threads < 32 || threads > MAX_BLOCK_THREADS ||
        (threads & 31) != 0 || (!w_in_smem && work == nullptr))
        return (int)cudaErrorInvalidValue;
    int max_smem = 0;
    int err = max_smem_optin(&max_smem);
    if (err != (int)cudaSuccess) return err;
    const size_t smem =
        sizeof(float) * (size_t)spd_blocked::smem_floats(n, w_in_smem != 0);
    if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
    err = set_smem((const void*)spd_inverse_block_kernel, smem);
    if (err != (int)cudaSuccess) return err;
    spd_inverse_block_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        K, ks, s, x0, two_eye, work, n, w_in_smem);
    return (int)cudaGetLastError();
}

// The block path's guard, finite test and rescale (see the kernel).
int spd_inverse_select_launch(const float* X0, const float* M, const float* X,
                              const float* T1, const float* s, float* out,
                              int B, int n, void* stream)
{
    if (B <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
    spd_newton_select_kernel<<<B, 256, 0, (cudaStream_t)stream>>>(
        X0, M, X, T1, s, out, n);
    return (int)cudaGetLastError();
}

const char* spd_inverse_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
