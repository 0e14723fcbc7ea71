// ADMM iteration with the refinement folded into one map M2 — CUDA, sm_90a.
//
// Replaces the TPU kernel `_admm_kernel_m2_packed` (reached through
// `admm_iterate_m2` / `admm_iterate_m2_packed_batch`) of
// mpctsid_tpu/qp/pallas_kernels.py.  Per scenario, `iters` times:
//
//     w   = rho * z - y
//     rhs = sigma * x - q + A' w
//     x_t = M2' rhs            (the TPU kernel reduces M2 * rhs_col over rows,
//                               i.e. applies M2 TRANSPOSED; M2 is symmetric
//                               only up to rounding, so the side is fixed)
//     z_t = A x_t
//     x   = alpha x_t + (1 - alpha) x
//     z_r = alpha z_t + (1 - alpha) z
//     z   = clip(z_r + y / rho, l, u)
//     y   = y + rho (z_r - z)
//
// and (x, z, y) are written out.  A is dense and generic, any n, m, B >= 1.
// f32 FMAs only; the three mat-vecs are computed here, by this kernel.
//
// Design.  One block per scenario; the TPU kernel's packing of 8 scenarios
// per grid step, its inert padding scenarios and its row/column relayouts
// were scaffolding for that machine and are not carried over.
//   * Residency: every vector (x, q, rhs, x_t, z, y, w, l, u, rho, 1/rho)
//     lives in shared memory for all iterations.  M2 is copied to shared
//     memory once when n*n*4 bytes fit beside the vectors (n = 192: 147,456 B
//     of the block's 227 KB) and streamed from global memory otherwise.  M2
//     plus A (245,760 B at m = 320) does not fit, so A is streamed from
//     global memory / L2 twice per iteration.
//   * Coalescing with ONE layout of A (row-major (m, n), as the caller holds
//     it; no transposed copy is made):
//       A' w and M2' rhs reduce over ROWS: thread j owns column j, so a warp
//       reads 32 consecutive floats of one row; the rows are dealt out to
//       `n_chunks` thread groups whose partial sums meet in shared memory.
//       A x_t reduces over COLUMNS: one warp per row, lanes on consecutive
//       columns, warp-shuffle sum.
//   * Four __syncthreads() per iteration separate the phases.
//
// Bound on the card (see chip_smoke.py, which computes it from the run's
// shapes): the bytes that must move are M2 + A + the vectors once per
// scenario, against the memory rate; the work is iters * (4 m n + 2 n^2)
// flops per scenario against the f32 FMA peak.  At n = 192, m = 320,
// iters = 30 the flop time is the larger.  This kernel is not near it: it
// re-reads A from L2 sixty times per scenario and holds one block per SM.
// A structured-A variant (the MPC's A is block diagonal, 960 non-zeros of
// 61,440) and a tensor-core redesign are later work.
//
// Plain C interface (loaded with ctypes): the launcher takes device pointers
// and the stream as integers, launches on that stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

// partial[c * cols + j] = sum over rows i = c, c + n_chunks, ... of
// mat[i * cols + j] * vec[i]; thread (c, j0) walks columns j0, j0 +
// col_threads, ...  `mat` may point to shared or global memory.
__device__ __forceinline__ void matT_vec_partial(
    const float* __restrict__ mat, int rows, int cols,
    const float* __restrict__ vec, float* __restrict__ partial,
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

__global__ void __launch_bounds__(1024)
admm_m2_kernel(const float* __restrict__ M2, const float* __restrict__ A,
               const float* __restrict__ q, const float* __restrict__ l,
               const float* __restrict__ u, const float* __restrict__ rho,
               const float* __restrict__ x0, const float* __restrict__ z0,
               const float* __restrict__ y0,
               float* __restrict__ x_out, float* __restrict__ z_out,
               float* __restrict__ y_out,
               int n, int m, int iters, float sigma, float alpha,
               int m2_in_smem, int col_threads, int n_chunks, int part_len)
{
    extern __shared__ __align__(16) float smem[];
    const int b = blockIdx.x;
    const int T = blockDim.x;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int n_warps = T >> 5;

    const float* gM2 = M2 + (size_t)b * n * n;
    const float* gA = A + (size_t)b * m * n;

    float* sx = smem;            // (n) primal iterate
    float* sq = sx + n;          // (n)
    float* srhs = sq + n;        // (n)
    float* sxt = srhs + n;       // (n) x_t of this iteration
    float* sz = sxt + n;         // (m)
    float* sy = sz + m;          // (m)
    float* sw = sy + m;          // (m) rho * z - y
    float* sl = sw + m;          // (m)
    float* su = sl + m;          // (m)
    float* srho = su + m;        // (m)
    float* srinv = srho + m;     // (m) 1 / rho, formed here
    float* spart = srinv + m;    // (part_len) partial sums of the row reductions
    float* sM2 = spart + part_len;  // (n * n) when m2_in_smem

    for (int j = t; j < n; j += T) {
        sx[j] = x0[(size_t)b * n + j];
        sq[j] = q[(size_t)b * n + j];
    }
    for (int i = t; i < m; i += T) {
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
    const float* M2p = gM2;
    if (m2_in_smem) {
        const int nn = n * n;
        for (int k = t; k < nn; k += T) sM2[k] = gM2[k];
        M2p = sM2;
    }
    __syncthreads();

    const float one_m_alpha = 1.0f - alpha;
    for (int it = 0; it < iters; ++it) {
        // rhs = sigma x - q + A' w
        matT_vec_partial(gA, m, n, sw, spart, col_threads, n_chunks);
        __syncthreads();
        for (int j = t; j < n; j += T)
            srhs[j] = (sigma * sx[j] - sq[j])
                      + sum_partials(spart, n, n_chunks, j);
        __syncthreads();

        // x_t = M2' rhs;  x <- alpha x_t + (1 - alpha) x
        matT_vec_partial(M2p, n, n, srhs, spart, col_threads, n_chunks);
        __syncthreads();
        for (int j = t; j < n; j += T) {
            const float xt = sum_partials(spart, n, n_chunks, j);
            sxt[j] = xt;
            sx[j] = alpha * xt + one_m_alpha * sx[j];
        }
        __syncthreads();

        // z_t = A x_t, one warp per row; then the z / y / w updates
        for (int i = warp; i < m; i += n_warps) {
            const float* row = gA + (size_t)i * n;
            float acc = 0.f;
            for (int k = lane; k < n; k += 32) acc = fmaf(row[k], sxt[k], acc);
            for (int off = 16; off > 0; off >>= 1)
                acc += __shfl_xor_sync(0xffffffffu, acc, off);
            if (lane == 0) {
                const float zr = alpha * acc + one_m_alpha * sz[i];
                const float yi = sy[i];
                const float r = srho[i];
                const float zn = fminf(fmaxf(zr + srinv[i] * yi, sl[i]), su[i]);
                const float yn = yi + r * (zr - zn);
                sz[i] = zn;
                sy[i] = yn;
                sw[i] = r * zn - yn;
            }
        }
        __syncthreads();
    }

    for (int j = t; j < n; j += T) x_out[(size_t)b * n + j] = sx[j];
    for (int i = t; i < m; i += T) {
        z_out[(size_t)b * m + i] = sz[i];
        y_out[(size_t)b * m + i] = sy[i];
    }
}

}  // namespace

extern "C" {

// Launch on `stream`.  `threads` is the block size, a multiple of 32 in
// [32, 1024].  Returns the CUDA error code of the launch (0 = success).
int admm_m2_launch(const float* M2, const float* A, const float* q,
                   const float* l, const float* u, const float* rho,
                   const float* x0, const float* z0, const float* y0,
                   float* x_out, float* z_out, float* y_out,
                   int B, int n, int m, int iters, float sigma, float alpha,
                   int threads, void* stream)
{
    if (B <= 0 || n <= 0 || m <= 0 || iters < 0 || threads < 32 ||
        threads > 1024 || (threads & 31) != 0)
        return (int)cudaErrorInvalidValue;

    const int n_up = (n + 31) / 32 * 32;
    const int col_threads = n_up < threads ? n_up : threads;
    const int n_chunks = threads / col_threads;
    const int part_len = n_chunks * n;

    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    int max_smem = 0;
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;

    const size_t vec_bytes =
        sizeof(float) * ((size_t)4 * n + (size_t)7 * m + (size_t)part_len);
    const size_t m2_bytes = sizeof(float) * (size_t)n * (size_t)n;
    if (vec_bytes > (size_t)max_smem) return (int)cudaErrorInvalidValue;
    const int m2_in_smem = (vec_bytes + m2_bytes <= (size_t)max_smem) ? 1 : 0;
    const size_t smem = vec_bytes + (m2_in_smem ? m2_bytes : 0);

    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(admm_m2_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    admm_m2_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        M2, A, q, l, u, rho, x0, z0, y0, x_out, z_out, y_out,
        n, m, iters, sigma, alpha, m2_in_smem, col_threads, n_chunks,
        part_len);
    return (int)cudaGetLastError();
}

const char* admm_m2_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
