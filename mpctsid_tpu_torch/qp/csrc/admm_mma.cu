// The generic ADMM iteration with every mat-vec on the tensor cores — CUDA,
// sm_90a.
//
// Replaces the TPU kernel `_admm_kernel` (reached through `admm_iterate`,
// backend "pallas") of mpctsid_tpu/qp/pallas_kernels.py: the form of the
// generic iteration whose five products are HIGHEST-precision `dot_general`s
// on the matrix unit.  Per scenario, `iters` times:
//
//     rhs = sigma x - q + A' w             (w = rho z - y; A transposed)
//     x_a = K^-1 rhs                       (K^-1 as given)
//     r   = rhs - K x_a                    (K AS GIVEN: unlike admm_vpu.cu)
//     x_t = x_a + K^-1 r                   (K^-1 as given)
//     z_t = A x_t                          (A as given)
//     x   = alpha x_t + (1 - alpha) x
//     z_r = alpha z_t + (1 - alpha) z
//     z   = clip(z_r + y / rho, l, u);   y = y + rho (z_r - z)
//
// K and K^-1 are symmetric only up to rounding, so the sides are part of the
// function.  Valid with equality rows (the residual is formed explicitly).
// Any n, m, B >= 1; no tensor is padded in device memory.
//
// Tensor-core mat-vec.  Every scenario has its own K^-1, K and A, so there
// is nothing to batch into the N dimension of a matrix product: each product
// is a true mat-vec, done with warp-level
//     mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32
// A 16 x 8 tile of the matrix is the A operand, the vector sits in the
// columns of the 8 x 8 B operand, and a warp owns 16 output rows.  Fragment
// layout used (lane = 4 g + t, g = 0..7, t = 0..3):
//     A (16 x 8):  a0 = (row g, k t)       a1 = (row g + 8, k t)
//                  a2 = (row g, k t + 4)   a3 = (row g + 8, k t + 4)
//     B (8 x 8):   b0 = (k t, col g)       b1 = (k t + 4, col g)
//     D (16 x 8):  d0, d1 = (row g, cols 2 t, 2 t + 1)
//                  d2, d3 = (row g + 8, cols 2 t, 2 t + 1)
// The sum over k does not care which depth index sits in which k slot, as
// long as A and B agree, so a 16-deep chunk is dealt as: lane t holds the
// four consecutive depth indices k0 + 4 t + c; c = 0, 1 feed slots t, t + 4
// of a first mma, c = 2, 3 those of a second.  "As given" then reads 16
// consecutive floats of a matrix row per group of four lanes (one 16-byte
// load per lane where the row length allows it) and "transposed" reads 8
// consecutive floats of a matrix row per t: the two sides differ only in
// the index arithmetic.  Ragged tiles (n = 30, m = 50) are zero-filled by
// predicate in registers; the vectors are zero-padded in shared memory.
//
// Precision.  Plain TF32 keeps 11 significant bits and would break the f32
// contract, so every operand is split in the kernel: p0 = rna_tf32(v),
// p1 = rna_tf32(v - p0) (two parts, "3xTF32"; the difference is exact), or
// three parts, which represent an f32 exactly.  The parts of the vector sit
// in columns 0, 1 (, 2) of B, so one mma per part of the matrix gives every
// cross term; with two parts that is two mma per tile.  The tensor core
// rounds its accumulator toward zero, so no running sum is kept in it: every
// mma starts from C = 0 (its eight-product partial sums are rounded once)
// and the partial sums are added in f32 registers, smallest part first.
// A' w, K^-1 rhs, K^-1 r and A x_t take two parts (PARTS), the cancelling
// product K x_a of the residual three (RESID_PARTS): the comment at
// `admm_iterate` in qp/kernels.py has the measured errors behind the choice.
//
// Layout.  One block per scenario, vectors in shared memory, matrices in
// shared memory greedily by reads per iteration (admm_block.cuh) and from
// global memory / L2 otherwise: all three at n = 30; K^-1 alone at n = 192.
// Work units are (16-row output tile, slice of the depth); the number of
// slices per product is chosen so that the warps of the block are evenly
// loaded, partial sums meet in shared memory.  Ten __syncthreads() per
// iteration.
//
// Bound on the card (chip_smoke.py computes it from the run's shapes): the
// same work as admm_vpu.cu — bytes = K^-1, K, A and the vectors once per
// scenario against the memory rate; operations = iters * (4 m n + 6 n^2)
// against the f32 peak.  One useful column of eight (two or three with the
// split parts) leaves the tensor cores mostly idle; at n = 192 the kernel is
// bound by streaming A (twice) and K from L2 every iteration, like
// admm_vpu.cu, and at n = 30 by barriers and shared-memory latency.
//
// Plain C interface (loaded with ctypes): device pointers and the stream as
// integers, launch on that stream, no allocation, no synchronisation; returns
// cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "admm_block.cuh"

namespace {

using namespace admm_block;

constexpr int MAX_KSPLIT = 8;   // depth slices per product, at most
constexpr int PARTS = 2;        // TF32 parts per operand: A' w, K^-1 ., A x_t
constexpr int RESID_PARTS = 3;  // and of K x_a (an exact split of an f32)

__host__ __device__ __forceinline__ int pad16(int v) { return (v + 15) & ~15; }

__device__ __forceinline__ uint32_t to_tf32(float x)
{
    uint32_t u;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
    return u;
}

// x = p[0] + p[1] (+ p[2]) up to 2^-23 |x| (two parts) or exactly (three);
// each remainder x - p[s] is exact in f32.
template <int NS>
__device__ __forceinline__ void split_tf32(float x, uint32_t (&p)[NS])
{
#pragma unroll
    for (int s = 0; s < NS; ++s) {
        p[s] = to_tf32(x);
        x -= __uint_as_float(p[s]);
    }
}

// D = A B with C = 0.
__device__ __forceinline__ void mma_m16n8k8_tf32(
    float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
    uint32_t b0, uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.0f));
}

// One 16 x 8 step: rows g, g + 8 of the tile against depth slots t, t + 4.
// e<row><slot> are this lane's matrix elements, v0 / v1 the vector elements
// of the two slots.  Column s of B holds part s of the vector; acc0 / acc1
// gain this lane's columns of rows g / g + 8.
template <int NS>
__device__ __forceinline__ void tile_step(
    float& acc0, float& acc1, float e00, float e10, float e01, float e11,
    float v0, float v1, int g)
{
    uint32_t a0[NS], a1[NS], a2[NS], a3[NS], p0[NS], p1[NS];
    split_tf32<NS>(e00, a0);
    split_tf32<NS>(e10, a1);
    split_tf32<NS>(e01, a2);
    split_tf32<NS>(e11, a3);
    split_tf32<NS>(v0, p0);
    split_tf32<NS>(v1, p1);
    uint32_t b0 = 0u, b1 = 0u;
#pragma unroll
    for (int s = 0; s < NS; ++s)
        if (g == s) { b0 = p0[s]; b1 = p1[s]; }
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int s = NS - 1; s >= 0; --s) {       // smallest part first
        float d[4];
        mma_m16n8k8_tf32(d, a0[s], a1[s], a2[s], a3[s], b0, b1);
        s0 += d[0] + d[1];
        s1 += d[2] + d[3];
    }
    acc0 += s0;
    acc1 += s1;
}

// How many depth slices make `n_warps` warps evenly loaded: least
// (rounds of units) x (chunks per unit).
__device__ __forceinline__ int pick_ksplit(int out_len, int depth, int n_warps)
{
    const int tiles = (out_len + 15) >> 4;
    const int chunks = (depth + 15) >> 4;
    int best = 1, best_cost = 0x7fffffff;
    for (int s = 1; s <= MAX_KSPLIT && s <= chunks; ++s) {
        const int cost = ((tiles * s + n_warps - 1) / n_warps)
                         * ((chunks + s - 1) / s);
        if (cost < best_cost) { best_cost = cost; best = s; }
    }
    return best;
}

// Partial products of a mat-vec on the tensor cores, the whole block:
//   TRANS = false:  out[i] = sum_k mat[i * ld + k] vec[k]   (mat as given)
//   TRANS = true:   out[j] = sum_i mat[i * ld + j] vec[i]   (mat transposed)
// out has `out_len` entries, the sum runs over `depth`.  `vec` lies in shared
// memory, 16-byte aligned and zero-padded to a multiple of 16.  Slice ks of
// the depth writes part[ks * out_pad + o]; the caller sums the `ksplit`
// slices (sum_partials) after a __syncthreads().  mat may lie in shared or
// global memory.
template <int NS, bool TRANS>
__device__ __forceinline__ void mma_matvec_partial(
    const float* mat, int ld, int out_len, int depth, const float* vec,
    float* part, int out_pad, int ksplit)
{
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int n_tiles = (out_len + 15) >> 4;
    const int n_chunks = (depth + 15) >> 4;
    const int per_slice = (n_chunks + ksplit - 1) / ksplit;
    const bool vec4 = !TRANS && (ld & 3) == 0 && (depth & 3) == 0
                      && (reinterpret_cast<uintptr_t>(mat) & 15) == 0;

    for (int unit = warp; unit < n_tiles * ksplit; unit += n_warps) {
        const int tile = unit % n_tiles;
        const int ks = unit / n_tiles;
        const int o0 = tile * 16 + g;
        const int o1 = o0 + 8;
        const bool in0 = o0 < out_len;
        const bool in1 = o1 < out_len;
        const int ch_end = min(n_chunks, (ks + 1) * per_slice);
        float acc0 = 0.f, acc1 = 0.f;
        for (int ch = ks * per_slice; ch < ch_end; ++ch) {
            const int kk = ch * 16 + 4 * t;
            const float4 vv = *reinterpret_cast<const float4*>(vec + kk);
            float e0[4], e1[4];
            if (TRANS) {
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const bool ink = kk + c < depth;
                    const float* row = mat + (size_t)(kk + c) * ld;
                    e0[c] = (ink && in0) ? row[o0] : 0.f;
                    e1[c] = (ink && in1) ? row[o1] : 0.f;
                }
            } else if (vec4) {
                const bool ink = kk < depth;
                const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
                const float4 r0 = (ink && in0)
                    ? *reinterpret_cast<const float4*>(
                          mat + (size_t)o0 * ld + kk) : z4;
                const float4 r1 = (ink && in1)
                    ? *reinterpret_cast<const float4*>(
                          mat + (size_t)o1 * ld + kk) : z4;
                e0[0] = r0.x; e0[1] = r0.y; e0[2] = r0.z; e0[3] = r0.w;
                e1[0] = r1.x; e1[1] = r1.y; e1[2] = r1.z; e1[3] = r1.w;
            } else {
                const float* row0 = mat + (size_t)o0 * ld + kk;
                const float* row1 = mat + (size_t)o1 * ld + kk;
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const bool ink = kk + c < depth;
                    e0[c] = (ink && in0) ? row0[c] : 0.f;
                    e1[c] = (ink && in1) ? row1[c] : 0.f;
                }
            }
            tile_step<NS>(acc0, acc1, e0[0], e1[0], e0[1], e1[1],
                          vv.x, vv.y, g);
            tile_step<NS>(acc0, acc1, e0[2], e1[2], e0[3], e1[3],
                          vv.z, vv.w, g);
        }
        // the parts' columns lie in lanes t = 0 (and t = 1): sum over t
        acc0 += __shfl_xor_sync(0xffffffffu, acc0, 1);
        acc1 += __shfl_xor_sync(0xffffffffu, acc1, 1);
        acc0 += __shfl_xor_sync(0xffffffffu, acc0, 2);
        acc1 += __shfl_xor_sync(0xffffffffu, acc1, 2);
        if (t == 0) {
            if (in0) part[ks * out_pad + o0] = acc0;
            if (in1) part[ks * out_pad + o1] = acc1;
        }
    }
}

__global__ void __launch_bounds__(512)
admm_mma_kernel(const float* __restrict__ Kinv, const float* __restrict__ K,
                const float* __restrict__ A, const float* __restrict__ q,
                const float* __restrict__ l, const float* __restrict__ u,
                const float* __restrict__ rho, const float* __restrict__ x0,
                const float* __restrict__ z0, const float* __restrict__ y0,
                float* __restrict__ x_out, float* __restrict__ z_out,
                float* __restrict__ y_out,
                int n, int m, int iters, float sigma, float alpha,
                int kinv_in_smem, int a_in_smem, int k_in_smem)
{
    extern __shared__ __align__(16) float smem[];
    const int b = blockIdx.x;
    const int T = blockDim.x;
    const int t = threadIdx.x;
    const int n_warps = T >> 5;
    const int np = pad16(n), mp = pad16(m);
    const int out_pad = np > mp ? np : mp;

    const float* gKinv = Kinv + (size_t)b * n * n;
    const float* gK = K + (size_t)b * n * n;
    const float* gA = A + (size_t)b * m * n;

    // vectors, each zero-padded to a multiple of 16 (the B operand reads
    // whole 16-deep chunks)
    const int vec_floats = 6 * np + 7 * mp;
    for (int k = t; k < vec_floats; k += T) smem[k] = 0.f;
    IterVecs v;
    float* p = smem;
    v.x = p;    p += np;
    v.q = p;    p += np;
    v.rhs = p;  p += np;
    v.xa = p;   p += np;
    v.r = p;    p += np;
    v.xt = p;   p += np;
    v.z = p;    p += mp;
    v.y = p;    p += mp;
    v.w = p;    p += mp;
    v.l = p;    p += mp;
    v.u = p;    p += mp;
    v.rho = p;  p += mp;
    v.rinv = p; p += mp;
    v.part = p; p += MAX_KSPLIT * out_pad;
    __syncthreads();

    const int nn4 = (n * n + 3) & ~3, mn4 = (m * n + 3) & ~3;
    const float* Kinv_p = gKinv;
    const float* A_p = gA;
    const float* K_p = gK;
    if (kinv_in_smem) {
        for (int k = t; k < n * n; k += T) p[k] = gKinv[k];
        Kinv_p = p;
        p += nn4;
    }
    if (a_in_smem) {
        for (int k = t; k < m * n; k += T) p[k] = gA[k];
        A_p = p;
        p += mn4;
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

    const int s_atw = pick_ksplit(n, m, n_warps);   // A' w: n out, m deep
    const int s_nn = pick_ksplit(n, n, n_warps);    // K^-1 ., K .
    const int s_ax = pick_ksplit(m, n, n_warps);    // A x_t: m out, n deep
    const float one_m_alpha = 1.0f - alpha;

    for (int it = 0; it < iters; ++it) {
        mma_matvec_partial<PARTS, true>(A_p, n, n, m, v.w, v.part, out_pad,
                                     s_atw);
        __syncthreads();
        for (int j = t; j < n; j += T)
            v.rhs[j] = (sigma * v.x[j] - v.q[j])
                       + sum_partials(v.part, out_pad, s_atw, j);
        __syncthreads();

        mma_matvec_partial<PARTS, false>(Kinv_p, n, n, n, v.rhs, v.part,
                                      out_pad, s_nn);
        __syncthreads();
        for (int i = t; i < n; i += T)
            v.xa[i] = sum_partials(v.part, out_pad, s_nn, i);
        __syncthreads();

        mma_matvec_partial<RESID_PARTS, false>(K_p, n, n, n, v.xa, v.part, out_pad,
                                       s_nn);                 // K as given
        __syncthreads();
        for (int j = t; j < n; j += T)
            v.r[j] = v.rhs[j] - sum_partials(v.part, out_pad, s_nn, j);
        __syncthreads();

        mma_matvec_partial<PARTS, false>(Kinv_p, n, n, n, v.r, v.part, out_pad,
                                      s_nn);
        __syncthreads();
        for (int i = t; i < n; i += T) {
            const float xt = v.xa[i] + sum_partials(v.part, out_pad, s_nn, i);
            v.xt[i] = xt;
            v.x[i] = alpha * xt + one_m_alpha * v.x[i];
        }
        __syncthreads();

        mma_matvec_partial<PARTS, false>(A_p, n, m, n, v.xt, v.part, out_pad,
                                      s_ax);
        __syncthreads();
        for (int i = t; i < m; i += T)
            project_row(v, i, sum_partials(v.part, out_pad, s_ax, i), alpha,
                        one_m_alpha);
        __syncthreads();
    }

    for (int j = t; j < n; j += T) x_out[(size_t)b * n + j] = v.x[j];
    for (int i = t; i < m; i += T) {
        z_out[(size_t)b * m + i] = v.z[i];
        y_out[(size_t)b * m + i] = v.y[i];
    }
}

}  // namespace

extern "C" {

// Launch on `stream`.  `threads` is the block size, a multiple of 32 in
// [32, 512].  Returns the CUDA error code of the launch (0 = success).
int admm_mma_launch(const float* Kinv, const float* K, const float* A,
                    const float* q, const float* l, const float* u,
                    const float* rho, const float* x0, const float* z0,
                    const float* y0, float* x_out, float* z_out, float* y_out,
                    int B, int n, int m, int iters, float sigma, float alpha,
                    int threads, void* stream)
{
    if (B <= 0 || n <= 0 || m <= 0 || iters < 0 || threads < 32 ||
        threads > 512 || (threads & 31) != 0)
        return (int)cudaErrorInvalidValue;

    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    int max_smem = 0;
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;

    const int np = pad16(n), mp = pad16(m);
    const size_t vec_bytes = sizeof(float) *
        ((size_t)6 * np + (size_t)7 * mp
         + (size_t)MAX_KSPLIT * (np > mp ? np : mp));
    if (vec_bytes > (size_t)max_smem) return (int)cudaErrorInvalidValue;
    // matrix regions rounded to 16 bytes, so each starts 16-byte aligned
    const size_t nn_bytes = sizeof(float) * (((size_t)n * n + 3) & ~(size_t)3);
    const size_t mn_bytes = sizeof(float) * (((size_t)m * n + 3) & ~(size_t)3);
    const Residency res = greedy_residency(vec_bytes, nn_bytes, mn_bytes,
                                           (size_t)max_smem);

    if (res.smem > 48 * 1024) {
        err = cudaFuncSetAttribute(admm_mma_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)res.smem);
        if (err != cudaSuccess) return (int)err;
    }
    admm_mma_kernel<<<B, threads, res.smem, (cudaStream_t)stream>>>(
        Kinv, K, A, q, l, u, rho, x0, z0, y0, x_out, z_out, y_out,
        n, m, iters, sigma, alpha, res.kinv, res.a, res.k);
    return (int)cudaGetLastError();
}

const char* admm_mma_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
