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
// factorization is two sweeps of 192 dependent steps each, the products
// 6.8 M FMAs.
//
// Two paths, chosen by the wrapper's `spd_inverse_layout` (qp/kernels.py):
//
//   * WARP path (spd_inverse_warp_kernel), n <= 32: one warp per matrix,
//     several per block, the whole function in one launch: kernel 4's warp
//     factorization (spd_inverse.cuh, shared with admm_fused.cu) over a
//     scratch of n rows of 32 floats; K is copied in and K^-1 out through
//     that scratch, so both device-memory passes are coalesced.
//   * BLOCK path, n > 32: one block per matrix for what is sequential, the
//     dense products on cuBLAS through the wrapper (as the JAX package leaves
//     them to XLA).  spd_inverse_block_kernel writes s, Ks and L^-1 (full, zeros
//     above the diagonal) and 2 I into the Newton-Schulz buffer; the wrapper
//     forms X0 = L^-T L^-1, M = 2 I - Ks X0 (in place), X = X0 M and
//     T = Ks X with torch.bmm; spd_newton_select_kernel takes the guard
//     (|M - I|^2 is |I - Ks X0|^2), the finite test and s X s.  Six device
//     ops per inverse.  The factorization works on ONE matrix W with row
//     stride ldw: Ks's lower triangle is factored in place (right-looking:
//     column j, then the rank-1 update of the trailing lower triangle, rows
//     over warps and columns over lanes), L's diagonal kept in a vector; then
//     L^-1 by forward elimination (row k of L^-1 = row k of the eliminated
//     identity over L[k][k]; rank-1 update of the rows below), stored
//     TRANSPOSED in the upper triangle (U[c][i] = L^-1[i][c]), so both
//     sweeps read and write rows of W on consecutive lanes and columns at the
//     stride n + 1 (no bank conflicts).  W lives in shared memory when n (n +
//     1) + 2 n floats fit (n = 192: 146 KB of the 227 KB a block can take),
//     else in the matrix's own slice of the L^-1 output (row stride n), which
//     ends transposed in place.
//
// Plain C interface (loaded with ctypes), as admm_m2.cu.

#include <cuda_runtime.h>

#include "admm_block.cuh"
#include "spd_inverse.cuh"

namespace {

using spd_warp::FULL;
using spd_warp::WN;
using spd_warp::WS;

constexpr int MAX_SLOTS = 8;        // warp path: matrices (warps) per block

// 1 / sqrt(max(d, 1e-30)) with NaN kept NaN, as torch.clamp_min keeps it
__device__ __forceinline__ float jacobi_scale(float d)
{
    return rsqrtf(d < 1e-30f ? 1e-30f : d);
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

__global__ void __launch_bounds__(1024)
spd_inverse_block_kernel(const float* __restrict__ K, float* __restrict__ ks,
                         float* __restrict__ s_out, float* li,
                         float* __restrict__ two_eye, int n, int in_smem)
{
    extern __shared__ __align__(16) float smem[];
    const int b = blockIdx.x;
    const int t = threadIdx.x, T = blockDim.x;
    const int lane = t & 31, warp = t >> 5, n_warps = T >> 5;
    const size_t nn = (size_t)n * n;
    const float* gK = K + (size_t)b * nn;
    float* gKs = ks + (size_t)b * nn;
    float* gLi = li + (size_t)b * nn;
    float* s = smem;                 // n: the Jacobi scale
    float* dL = s + n;               // n: the diagonal of L
    float* W = in_smem ? dL + n : gLi;
    const int ldw = in_smem ? n + 1 : n;

    for (int j = t; j < n; j += T) {
        const float sj = jacobi_scale(gK[(size_t)j * n + j]);
        s[j] = sj;
        s_out[(size_t)b * n + j] = sj;
    }
    __syncthreads();
    for (int k = t; k < n * n; k += T) {
        const int i = k / n, j = k - i * n;
        const float v = (gK[k] * s[i]) * s[j];
        gKs[k] = v;
        W[i * ldw + j] = v;
        two_eye[(size_t)b * nn + k] = i == j ? 2.0f : 0.f;
    }
    __syncthreads();

    // Cholesky of the lower triangle, right-looking, in place
    for (int j = 0; j < n; ++j) {
        const float piv = W[j * ldw + j];
        const float d = sqrtf(piv < 1e-10f ? 1e-10f : piv);
        if (t == 0) dL[j] = d;
        for (int i = j + 1 + t; i < n; i += T) W[i * ldw + j] /= d;
        __syncthreads();
        for (int i = j + 1 + warp; i < n; i += n_warps) {
            const float lij = W[i * ldw + j];
            for (int k = j + 1 + lane; k <= i; k += 32)
                W[i * ldw + k] = fmaf(-lij, W[k * ldw + j], W[i * ldw + k]);
        }
        __syncthreads();
    }

    // L^-1 by forward elimination of the identity, stored transposed in the
    // upper triangle: U[c][i] = L^-1[i][c], c <= i
    for (int k = t; k < n * n; k += T) {
        const int r = k / n, c = k - r * n;
        if (c >= r) W[r * ldw + c] = c == r ? 1.0f : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
        const float dk = dL[k];
        for (int c = t; c <= k; c += T) W[c * ldw + k] /= dk;
        __syncthreads();
        for (int c = warp; c <= k; c += n_warps) {
            const float xkc = W[c * ldw + k];
            for (int i = k + 1 + lane; i < n; i += 32)
                W[c * ldw + i] = fmaf(-W[i * ldw + k], xkc, W[c * ldw + i]);
        }
        __syncthreads();
    }

    // L^-1, row-major, zeros above the diagonal
    if (in_smem) {
        for (int k = t; k < n * n; k += T) {
            const int i = k / n, c = k - i * n;
            gLi[k] = c <= i ? W[c * ldw + i] : 0.f;
        }
    } else {
        for (int k = t; k < n * n; k += T) {
            const int i = k / n, c = k - i * n;
            if (c < i) {
                gLi[k] = gLi[(size_t)c * n + i];
                gLi[(size_t)c * n + i] = 0.f;
            }
        }
    }
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

// The block path's factorization (n > 32): one block of `threads` per
// matrix; writes s (B, n), Ks and L^-1 (B, n, n) and 2 I into `two_eye`
// (B, n, n).  in_smem: the working matrix in shared memory (n (n + 1) + 2 n
// floats, checked here), else in `li`.  Returns the CUDA error code.
int spd_inverse_factor_launch(const float* K, float* ks, float* s, float* li,
                              float* two_eye, int B, int n, int threads,
                              int in_smem, void* stream)
{
    if (B <= 0 || n <= WN || threads < 32 || threads > 1024 ||
        (threads & 31) != 0)
        return (int)cudaErrorInvalidValue;
    int max_smem = 0;
    int err = max_smem_optin(&max_smem);
    if (err != (int)cudaSuccess) return err;
    const size_t smem = sizeof(float) *
        ((size_t)2 * n + (in_smem ? (size_t)n * (n + 1) : 0));
    if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
    err = set_smem((const void*)spd_inverse_block_kernel, smem);
    if (err != (int)cudaSuccess) return err;
    spd_inverse_block_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        K, ks, s, li, two_eye, n, in_smem);
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
