// The packed ADMM iteration: several small scenarios per block, one warp
// each — CUDA, sm_90a.
//
// Replaces the TPU kernel `_admm_kernel_vpu_packed` (reached through
// `admm_iterate_vpu_packed` / `admm_iterate_packed`, backend "pallas_packed")
// of mpctsid_tpu/qp/pallas_kernels.py.  It computes the SAME function as the
// generic kernel (admm_vpu.cu; the update and its matrix sides are written
// out in admm_block.cuh, where the warp-level loop itself lives:
// `warp_refined_iterations`), for matrices small enough that one scenario's
// K^-1, K and A fit in a fraction of a block's shared memory: the WBC QP,
// n = 30, m = 50.  f32 FMAs only; the five mat-vecs are computed here.
//
// Design.  The TPU kernel packs G scenarios per grid step to amortise the
// per-step cost.  On Hopper the cost to amortise is the block-wide barrier:
// the generic kernel pays seven per iteration for 128 threads that each do a
// handful of FMAs.  Here a WARP owns a scenario:
//   * its K^-1, K, A and all its vectors live in the warp's own slice of
//     shared memory for all iterations (15.6 KB at n = 30, m = 50, so up to
//     14 scenarios per block of 227 KB);
//   * each lane owns output elements (lane, lane + 32, ...) of every
//     mat-vec, so a product needs no reduction across lanes at all; phases
//     are separated by __syncwarp() only, and no barrier or reduction ever
//     crosses scenarios (a NaN scenario cannot touch its neighbours);
//   * rows are stored with an ODD stride ld = n | 1, so both access patterns
//     are free of bank conflicts: lanes on consecutive columns of one row
//     (A' w, K' x_a) and lanes on consecutive rows of one column
//     (K^-1 rhs, K^-1 r, A x_t);
//   * the block loads its scenarios' matrices together, coalesced, and
//     synchronises once, before the loop.
// The last block guards its tail (warps past B leave after the load); no
// inert padding scenario exists.  A scenario that does not fit is refused by
// the wrapper, with the reason; this kernel never hands work to another.
//
// Bound on the card: as the generic kernel's (same bytes, same flops).
//
// Plain C interface (loaded with ctypes), as admm_m2.cu.

#include <cuda_runtime.h>

#include "admm_block.cuh"

namespace {

using namespace admm_block;

__global__ void __launch_bounds__(512)
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

}  // namespace

extern "C" {

// Launch on `stream` with `g` scenarios (warps) per block, rows padded to
// `ld` floats and `slot_floats` floats of shared memory per scenario (the
// wrapper's packed_layout()).  Returns the CUDA error code of the launch.
int admm_packed_launch(const float* Kinv, const float* K, const float* A,
                       const float* q, const float* l, const float* u,
                       const float* rho, const float* x0, const float* z0,
                       const float* y0, float* x_out, float* z_out,
                       float* y_out, int B, int n, int m, int iters,
                       float sigma, float alpha, int g, int ld,
                       int slot_floats, void* stream)
{
    if (B <= 0 || n <= 0 || m <= 0 || iters < 0 || g < 1 || g > 16 ||
        ld < n || slot_floats < (2 * n + m) * ld + 5 * n + 7 * m)
        return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * (size_t)g * (size_t)slot_floats;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            admm_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int blocks = (B + g - 1) / g;
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
