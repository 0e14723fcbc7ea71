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
// Design.  One block per scenario (the TPU kernel's one scenario per grid
// step), every vector in shared memory for all iterations.  The matrices go
// to shared memory greedily, in the order of their reads per iteration —
// K^-1 (twice), A (twice), K (once) — as far as the block's opt-in limit
// allows, and are streamed from global memory / L2 otherwise:
//   WBC shape:  K^-1 + K + A = 13,200 B: all resident.
//   MPC shape:  K^-1 (147,456 B) resident; A (245,760 B) and K stream.
// Coalescing from row-major layouts as in admm_m2.cu: A' w and K' x_a reduce
// over rows (one thread per column, rows dealt to `n_chunks` groups, partial
// sums in shared memory); K^-1 rhs, K^-1 r and A x_t reduce over columns (one
// warp per row, shuffle sum).  Seven __syncthreads() per iteration.
//
// Bound on the card (chip_smoke.py computes it from the run's shapes): bytes
// = K^-1, K, A and the vectors once per scenario against the memory rate;
// operations = iters * (4 m n + 6 n^2) flops per scenario against the f32
// FMA peak.  At the WBC shape the bytes side is the larger.  This kernel is
// not near it: a block of 128 threads spends its time in barriers and
// shared-memory latency, not in FMAs; the packed kernel (admm_packed.cu)
// is the form built for the tiny matrices.
//
// Plain C interface (loaded with ctypes): device pointers and the stream as
// integers, launch on that stream, no allocation, no synchronisation; returns
// cudaGetLastError() of the launch.

#include <cuda_runtime.h>

#include "admm_block.cuh"

namespace {

using namespace admm_block;

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

// Launch on `stream`.  `threads` is the block size, a multiple of 32 in
// [32, 1024].  Returns the CUDA error code of the launch (0 = success).
int admm_vpu_launch(const float* Kinv, const float* K, const float* A,
                    const float* q, const float* l, const float* u,
                    const float* rho, const float* x0, const float* z0,
                    const float* y0, float* x_out, float* z_out, float* y_out,
                    int B, int n, int m, int iters, float sigma, float alpha,
                    int threads, void* stream)
{
    if (B <= 0 || n <= 0 || m <= 0 || iters < 0 || threads < 32 ||
        threads > 1024 || (threads & 31) != 0)
        return (int)cudaErrorInvalidValue;

    const int n_up = (n + 31) / 32 * 32;
    const int col_threads = n_up < threads ? n_up : threads;
    const int n_chunks = threads / col_threads;

    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    int max_smem = 0;
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;

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
