// Device code shared by the iteration and whole-solve kernels.
//
// Who shares what:
//   * warp_sum / warp_max, IterVecs, project_row: every kernel that includes
//     this header (admm_vpu.cu, admm_fused.cu, admm_mma.cu).
//   * Block-level pieces, one thread block per scenario (block_sum / block_max,
//     matT_vec_partial, sum_partials, warp_row_dot, greedy_residency,
//     refined_iterations): the generic iteration kernel (admm_vpu.cu) and the
//     block path of the whole-solve kernel (admm_fused.cu, n > 32).  The
//     tensor-core kernel (admm_mma.cu) takes sum_partials only.
//   * Warp-level pieces, one WARP per scenario (dot_strided, WarpVecs,
//     warp_refined_iterations): the packed iteration kernel (admm_packed.cu)
//     and the warp path of the whole-solve kernel (admm_fused.cu, n <= 32).
//     Both run the same refined iteration with K TRANSPOSED on matrices that
//     sit in the warp's own slice of shared memory; it is written once, here.
//
// The vectors of a scenario live in shared memory, its matrices in shared or
// global memory (the same code reads either: generic addressing).
//
// No pointer here is __restrict__ / read-only qualified on purpose: the
// whole-solve kernel rewrites its matrices in place (scaling, factorization)
// between the phases that read them, so a load must never go through the
// non-coherent read-only path.  (admm_m2.cu, whose matrices are never
// written, keeps its own read-only-qualified copy of the row reduction.)

#pragma once

#include <cuda_runtime.h>

namespace admm_block {

__device__ __forceinline__ float warp_sum(float v)
{
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ float warp_max(float v)
{
    for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

// ---- block-level pieces: one thread block per scenario ---------------------

// Sum (or max) over the whole block, returned to every thread.  `red` is 33
// floats of shared memory; every thread of the block must call.
__device__ __forceinline__ float block_sum(float v, float* red)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    v = warp_sum(v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
        float r = lane < n_warps ? red[lane] : 0.f;
        r = warp_sum(r);
        if (lane == 0) red[32] = r;
    }
    __syncthreads();
    const float out = red[32];
    __syncthreads();
    return out;
}

__device__ __forceinline__ float block_max(float v, float* red)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    v = warp_max(v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
        float r = lane < n_warps ? red[lane] : -INFINITY;
        r = warp_max(r);
        if (lane == 0) red[32] = r;
    }
    __syncthreads();
    const float out = red[32];
    __syncthreads();
    return out;
}

// Reduction over ROWS, coalesced from a row-major matrix:
// partial[c * cols + j] = sum over rows i = c, c + n_chunks, ... of
// mat[i * cols + j] * vec[i]; thread (c, j0) walks columns j0, j0 +
// col_threads, ...  The caller sums the chunks (sum_partials) after a
// __syncthreads().  This is mat' vec.
__device__ __forceinline__ void matT_vec_partial(
    const float* mat, int rows, int cols, const float* vec, float* partial,
    int col_threads, int n_chunks)
{
    const int t = threadIdx.x;
    const int c = t / col_threads;
    const int j0 = t - c * col_threads;
    if (c >= n_chunks) return;
    for (int j = j0; j < cols; j += col_threads) {
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int i = c;
        for (; i + 3 * n_chunks < rows; i += 4 * n_chunks) {
            a0 = fmaf(mat[(size_t)i * cols + j], vec[i], a0);
            a1 = fmaf(mat[(size_t)(i + n_chunks) * cols + j],
                      vec[i + n_chunks], a1);
            a2 = fmaf(mat[(size_t)(i + 2 * n_chunks) * cols + j],
                      vec[i + 2 * n_chunks], a2);
            a3 = fmaf(mat[(size_t)(i + 3 * n_chunks) * cols + j],
                      vec[i + 3 * n_chunks], a3);
        }
        for (; i < rows; i += n_chunks)
            a0 = fmaf(mat[(size_t)i * cols + j], vec[i], a0);
        partial[c * cols + j] = (a0 + a1) + (a2 + a3);
    }
}

__device__ __forceinline__ float sum_partials(const float* partial, int cols,
                                              int n_chunks, int j)
{
    float s = partial[j];
    for (int c = 1; c < n_chunks; ++c) s += partial[c * cols + j];
    return s;
}

// Reduction over COLUMNS by one warp: sum_k row[k] * vec[k], lanes on
// consecutive columns, shuffle sum; every lane gets the result.
__device__ __forceinline__ float warp_row_dot(const float* row,
                                              const float* vec, int n,
                                              int lane)
{
    float acc = 0.f;
    for (int k = lane; k < n; k += 32) acc = fmaf(row[k], vec[k], acc);
    return warp_sum(acc);
}

// The vectors of one scenario's iteration, all in shared memory.
struct IterVecs {
    float* x;     // (n) primal iterate
    float* q;     // (n)
    float* rhs;   // (n)
    float* xa;    // (n) first solve K^-1 rhs
    float* r;     // (n) explicit residual rhs - K' xa
    float* xt;    // (n) refined solve
    float* z;     // (m)
    float* y;     // (m)
    float* w;     // (m) rho * z - y, kept current by the z / y update
    float* l;     // (m)
    float* u;     // (m)
    float* rho;   // (m)
    float* rinv;  // (m) 1 / rho
    float* part;  // (n_chunks * n) partial sums of the row reductions
};

// The z / y tail of one update for constraint row i, given acc = (A x_t)[i]:
//     z_r = alpha acc + (1 - alpha) z;  z = clip(z_r + y / rho, l, u);
//     y   = y + rho (z_r - z);          w = rho z - y
__device__ __forceinline__ void project_row(const IterVecs& v, int i,
                                            float acc, float alpha,
                                            float one_m_alpha)
{
    const float zr = alpha * acc + one_m_alpha * v.z[i];
    const float yi = v.y[i];
    const float rh = v.rho[i];
    const float zn = fminf(fmaxf(zr + v.rinv[i] * yi, v.l[i]), v.u[i]);
    const float yn = yi + rh * (zr - zn);
    v.z[i] = zn;
    v.y[i] = yn;
    v.w[i] = rh * zn - yn;
}

// Which matrices of one scenario live in shared memory: greedily in the
// order of their reads per iteration — K^-1 (twice), A (twice), K (once) —
// as far as `max_smem` allows beyond the `base` bytes of the vectors; the
// rest is streamed from global memory / L2.  `smem` is the block's total.
struct Residency {
    int kinv, a, k;
    size_t smem;
};

inline Residency greedy_residency(size_t base, size_t nn_bytes,
                                  size_t mn_bytes, size_t max_smem)
{
    Residency r = {0, 0, 0, base};
    if (r.smem + nn_bytes <= max_smem) { r.kinv = 1; r.smem += nn_bytes; }
    if (r.smem + mn_bytes <= max_smem) { r.a = 1; r.smem += mn_bytes; }
    if (r.smem + nn_bytes <= max_smem) { r.k = 1; r.smem += nn_bytes; }
    return r;
}

// `iters` ADMM updates with the EXPLICIT refinement step, in the order and
// with the matrix sides of the TPU kernels `_admm_kernel_vpu` /
// `_admm_kernel_vpu_packed` / the loop body of `_admm_fused_kernel`:
//
//     rhs = sigma x - q + A' w             (w = rho z - y)
//     x_a = K^-1 rhs                       (K^-1 as given: row reduction)
//     r   = rhs - K' x_a                   (K TRANSPOSED: column reduction)
//     x_t = x_a + K^-1 r
//     z_t = A x_t
//     x   = alpha x_t + (1 - alpha) x
//     z_r = alpha z_t + (1 - alpha) z
//     z   = clip(z_r + y / rho, l, u)
//     y   = y + rho (z_r - z)
//
// K and K^-1 are symmetric only up to rounding, so the sides are part of
// the function.  The residual is formed explicitly, never folded: with
// equality rows (rho boosted 1e3, cond(K) ~ 1e4) that is what keeps the
// refined solve accurate.  On entry v.w holds rho z - y and the block is
// synchronised; on exit x, z, y, w are current and the block is synchronised.
__device__ __forceinline__ void refined_iterations(
    const float* Kinv, const float* K, const float* A, int n, int m,
    int iters, float sigma, float alpha, const IterVecs& v,
    int col_threads, int n_chunks)
{
    const int T = blockDim.x;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int n_warps = T >> 5;
    const float one_m_alpha = 1.0f - alpha;

    for (int it = 0; it < iters; ++it) {
        matT_vec_partial(A, m, n, v.w, v.part, col_threads, n_chunks);
        __syncthreads();
        for (int j = t; j < n; j += T)
            v.rhs[j] = (sigma * v.x[j] - v.q[j])
                       + sum_partials(v.part, n, n_chunks, j);
        __syncthreads();

        for (int i = warp; i < n; i += n_warps) {
            const float acc =
                warp_row_dot(Kinv + (size_t)i * n, v.rhs, n, lane);
            if (lane == 0) v.xa[i] = acc;
        }
        __syncthreads();

        matT_vec_partial(K, n, n, v.xa, v.part, col_threads, n_chunks);
        __syncthreads();
        for (int j = t; j < n; j += T)
            v.r[j] = v.rhs[j] - sum_partials(v.part, n, n_chunks, j);
        __syncthreads();

        for (int i = warp; i < n; i += n_warps) {
            const float corr =
                warp_row_dot(Kinv + (size_t)i * n, v.r, n, lane);
            if (lane == 0) {
                const float xt = v.xa[i] + corr;
                v.xt[i] = xt;
                v.x[i] = alpha * xt + one_m_alpha * v.x[i];
            }
        }
        __syncthreads();

        for (int i = warp; i < m; i += n_warps) {
            const float acc = warp_row_dot(A + (size_t)i * n, v.xt, n, lane);
            if (lane == 0) project_row(v, i, acc, alpha, one_m_alpha);
        }
        __syncthreads();
    }
}

// ---- warp-level pieces: one warp per scenario ------------------------------

// sum_k a[k * stride] * v[k], four independent accumulators
__device__ __forceinline__ float dot_strided(const float* a, int stride,
                                             const float* v, int len)
{
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    int k = 0;
    for (; k + 3 < len; k += 4) {
        a0 = fmaf(a[(k + 0) * stride], v[k + 0], a0);
        a1 = fmaf(a[(k + 1) * stride], v[k + 1], a1);
        a2 = fmaf(a[(k + 2) * stride], v[k + 2], a2);
        a3 = fmaf(a[(k + 3) * stride], v[k + 3], a3);
    }
    for (; k < len; ++k) a0 = fmaf(a[k * stride], v[k], a0);
    return (a0 + a1) + (a2 + a3);
}

// The vectors of one warp's scenario, all in the warp's slice of shared
// memory.
struct WarpVecs {
    float* x;     // (n)
    float* q;     // (n)
    float* rhs;   // (n)
    float* xa;    // (n) x_a, then x_t in place
    float* r;     // (n)
    float* z;     // (m)
    float* y;     // (m)
    float* w;     // (m) rho * z - y
    float* l;     // (m)
    float* u;     // (m)
    float* rho;   // (m)
    float* rinv;  // (m) 1 / rho
};

// `iters` updates of refined_iterations' function (K TRANSPOSED) by ONE warp.
// The scenario's K^-1, K and A lie in shared memory with the row stride ld;
// an ODD ld keeps both access patterns free of bank conflicts: lanes on
// consecutive columns of one row (A' w, K' x_a) and lanes on consecutive rows
// of one column (K^-1 rhs, K^-1 r, A x_t).  Each lane owns output elements
// (lane, lane + 32, ...) of every mat-vec, so a product needs no reduction
// across lanes; phases are separated by __syncwarp() only.  On entry v.w
// holds rho z - y and the warp is synchronised; on exit x, z, y, w are
// current and the warp is synchronised.
__device__ __forceinline__ void warp_refined_iterations(
    const float* sKinv, const float* sK, const float* sA, int ld, int n,
    int m, int iters, float sigma, float alpha, const WarpVecs& v, int lane)
{
    float* sx = v.x;
    float* sq = v.q;
    float* srhs = v.rhs;
    float* sxa = v.xa;
    float* sr = v.r;
    float* sz = v.z;
    float* sy = v.y;
    float* sw = v.w;
    float* sl = v.l;
    float* su = v.u;
    float* srho = v.rho;
    float* srinv = v.rinv;
    const float one_m_alpha = 1.0f - alpha;
    for (int it = 0; it < iters; ++it) {
        // rhs = sigma x - q + A' w
        for (int j = lane; j < n; j += 32)
            srhs[j] = (sigma * sx[j] - sq[j]) + dot_strided(sA + j, ld, sw, m);
        __syncwarp();
        // x_a = K^-1 rhs
        for (int i = lane; i < n; i += 32)
            sxa[i] = dot_strided(sKinv + i * ld, 1, srhs, n);
        __syncwarp();
        // r = rhs - K' x_a   (the explicit residual, K transposed)
        for (int j = lane; j < n; j += 32)
            sr[j] = srhs[j] - dot_strided(sK + j, ld, sxa, n);
        __syncwarp();
        // x_t = x_a + K^-1 r;  x <- alpha x_t + (1 - alpha) x
        for (int i = lane; i < n; i += 32) {
            const float xt = sxa[i] + dot_strided(sKinv + i * ld, 1, sr, n);
            sxa[i] = xt;
            sx[i] = alpha * xt + one_m_alpha * sx[i];
        }
        __syncwarp();
        // z_t = A x_t, then the z / y / w updates
        for (int i = lane; i < m; i += 32) {
            const float zt = dot_strided(sA + i * ld, 1, sxa, n);
            const float zr = alpha * zt + one_m_alpha * sz[i];
            const float yi = sy[i];
            const float rh = srho[i];
            const float zn = fminf(fmaxf(zr + srinv[i] * yi, sl[i]), su[i]);
            const float yn = yi + rh * (zr - zn);
            sz[i] = zn;
            sy[i] = yn;
            sw[i] = rh * zn - yn;
        }
        __syncwarp();
    }
}

}  // namespace admm_block
