// The whole ADMM solve in one launch — CUDA, sm_90a.
//
// Replaces the TPU kernel `_admm_fused_kernel` (reached through
// `admm_solve_fused` / `admm_solve_fused_batch`, backend "fused") of
// mpctsid_tpu/qp/pallas_kernels.py.  Per scenario, in that kernel's order:
//
//   1. `equilibrate_iters` rounds of FULL-RESCALE Ruiz equilibration with
//      cost scaling: column / row abs-max of the current P and A, the
//      matrices rescaled in place every round (not the norm-only form of
//      qp/admm.py), D, E, c accumulated; then the finite bounds scaled by E.
//   2. warm start x = x0 / D, y = y0 c / E, z = clip(A x, l, u).
//   3. `adapt_rounds` rounds of
//        K    = P + sigma I + A' diag(rho) A,   rho = rho_pat * rho_s
//        K^-1 by: Jacobi scaling s = rsqrt(max(diag K, 1e-30)), Cholesky of
//             Ks = s K s with the 1e-10 pivot floor, triangular inverse,
//             X0 = L^-T L^-1, ONE Newton-Schulz step X = X0 (2 I - Ks X0)
//             accepted only if |I - Ks X|_F^2 < 4 |I - Ks X0|_F^2 + 1, the
//             identity if the result is not finite, then K^-1 = s X s;
//        iters / adapt_rounds refined iterations (admm_block.cuh);
//        between rounds rho_s <- clip(rho_s sqrt(rp / rd), 1e-3, 1e3) from
//        the scaled residual ratios.
//   4. writes the SCALED x, y and the scales D, E, c; the caller unscales and
//      computes residuals and status in plain PyTorch, as the JAX caller does.
//
// What is NOT carried over from the TPU kernel: its blocked recursion with
// 8-aligned splits, the one-hot column masks, the Neumann-product triangular
// base case, the padding of n to a multiple of 8 and the inert padding
// scenarios.  Those exist because Mosaic cannot scatter or concatenate off
// its tiles.  Here the factorization is a left-looking column sweep and the
// triangular inverse a forward substitution, both in place in shared memory.
// Because n is not padded, the cost scale c of an n = 30 problem differs a
// little from the TPU kernel's (its padded identity columns enter mean(pcol));
// the solution of the QP does not depend on c.
//
// What bounds it on this card.  Operations (chip_smoke.py computes the bound
// from the run's shapes): bytes = P, A and six vectors in, five out;
// operations = the Ruiz passes, per round 2 m n^2 (K) + n^3 / 3 (Cholesky) +
// n^3 / 3 (inverse) + about 9 n^3 (X0, Newton-Schulz and its residuals), and
// (4 m n + 6 n^2) per iteration.  At the WBC shape (n = 30, m = 50) that is
// 0.7 M FMAs per scenario in some fifty dependent phases: a block of 128
// threads per scenario leaves most threads idle in most phases (at most
// 30 - j of them in column j of the Cholesky sweep) and pays a block barrier,
// or three for a reduction, after each.
//
// Design: two paths, chosen by the wrapper's `fused_layout`.
//
//   * WARP path (admm_fused_warp_kernel), n <= 32: ONE WARP per scenario,
//     several scenarios per block, no block barrier after the load.  Lane i
//     owns row i and column i of the n x n matrices and rows i, i + 32 of A.
//     A scenario's slot of shared memory holds the scratch matrix W of the
//     factorization (at the end K^-1), P, A, K and the vectors: 20.3 KB at
//     n = 30, m = 50, eleven scenarios per block.  P, A, K (and K^-1 once
//     done) have the odd row stride ld = n | 1: no bank conflicts by rows or
//     by columns, which is what the iterations need.  The warp's time goes
//     into shared-memory LOAD INSTRUCTIONS (one word per FMA in a product
//     whose other operand sits in registers), so W is laid out for 16-byte
//     loads: 32 floats per row, 16-byte aligned, and it holds TRANSPOSES: a
//     lane stores entry (i, j) of its row at W[j][i] (lanes on consecutive
//     words), and what all lanes read alike is then a ROW of W, eight
//     16-byte broadcasts instead of thirty 4-byte ones.
//       - Ruiz: lane j scales column j of P and A and takes its abs-max; the
//         sum and max over columns are shuffle reductions, identical in all
//         lanes, so rho_s and c are per-warp scalars with the same bits
//         everywhere.  Two __syncwarp() per round.
//       - K = P + sigma I + A' diag(rho) A: lane i accumulates row i in 32
//         registers, one row of A per step read as a broadcast.
//       - Row i of Ks = s K s stays in registers for the Newton-Schulz step.
//       - Cholesky: the same column sweep, lane i on row i, L' into W, the
//         pivot broadcast by a shuffle, one __syncwarp() per column.  L^-1 by
//         forward substitution, lane c on column c, row-major into the lower
//         triangle of W while L' still sits above the diagonal.
//       - X0 = L^-T L^-1: row i in registers (rows of L^-1 as 16-byte
//         broadcasts), then X0' over W.  M = 2 I - Ks X0 and X = X0 M:
//         column by column, the left operand's row in registers, the
//         result written over the row of W just read.  |I - Ks X|^2 the
//         same way, reduced on the fly.  The acceptance test, the finite
//         safeguard, the 1e-10 pivot floor and the Jacobi scaling are the
//         block path's to the letter.
//       - The iterations are `warp_refined_iterations` (admm_block.cuh), the
//         loop of the packed kernel, on K, W = K^-1 and A where they lie.
//   * BLOCK path (admm_fused_kernel), n > 32 or fewer than four slots per
//     block: one block per scenario, as before.  Six n x n matrices (P, K
//     and four work matrices: Ks; L then 2I - Ks X0 then K^-1; L^-1 then X;
//     X0) and A live in shared memory when they fit and in a
//     caller-allocated global workspace otherwise (n = 192: slow, but
//     right); the vectors are always in shared memory.
// Every reduction is over ONE scenario on both paths: the safeguards are per
// scenario by construction.  f32 FMAs only; no library call.  The order of
// summation differs between the paths (and from the plain version), so the
// kernel is held to a statistical gate and to the distance from a float64
// run (chip_smoke.py, phase 3c).
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W, B = 4096, n = 30,
// m = 50, 40 iterations in 3 rounds): 1.115 ms on the warp path; one block
// per scenario, the design before, 3.90 ms.  PERF.md keeps the table and the
// share of each phase.
//
// Plain C interface (loaded with ctypes), as admm_m2.cu.

#include <cuda_runtime.h>

#include "admm_block.cuh"

namespace {

using namespace admm_block;

struct FusedParams {
    int n, m, iters_per, n_rounds, equilibrate_iters;
    float rho0, sigma, alpha, rho_eq_scale, inf;
    int mats_in_smem, col_threads, n_chunks;
};

__global__ void __launch_bounds__(1024)
admm_fused_kernel(const float* __restrict__ P_in, const float* __restrict__ q_in,
                  const float* __restrict__ A_in, const float* __restrict__ l_in,
                  const float* __restrict__ u_in,
                  const float* __restrict__ eqf_in,
                  const float* __restrict__ x0_in,
                  const float* __restrict__ y0_in,
                  float* __restrict__ x_out, float* __restrict__ y_out,
                  float* __restrict__ d_out, float* __restrict__ e_out,
                  float* __restrict__ c_out, float* workspace, FusedParams fp)
{
    extern __shared__ __align__(16) float smem[];
    const int n = fp.n, m = fp.m;
    const int nn = n * n, mn = m * n;
    const int b = blockIdx.x;
    const int T = blockDim.x;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int n_warps = T >> 5;
    const float sigma = fp.sigma;

    IterVecs v;
    float* p = smem;
    v.x = p;    p += n;
    v.q = p;    p += n;
    v.rhs = p;  p += n;
    v.xa = p;   p += n;
    v.r = p;    p += n;
    v.xt = p;   p += n;
    float* sD = p;   p += n;
    float* sdn = p;  p += n;     // Ruiz column scale, later the Jacobi scale s
    v.z = p;    p += m;
    v.y = p;    p += m;
    v.w = p;    p += m;
    v.l = p;    p += m;
    v.u = p;    p += m;
    v.rho = p;  p += m;
    v.rinv = p; p += m;
    float* srpat = p; p += m;    // 1 + eqf (rho_eq_scale - 1)
    float* sE = p;    p += m;
    float* sdm = p;   p += m;    // Ruiz row scale
    v.part = p; p += fp.n_chunks * n;
    float* red = p;   p += 33;

    float* mats = fp.mats_in_smem
        ? p : workspace + (size_t)b * ((size_t)6 * nn + mn);
    float* P = mats;
    float* A = P + nn;
    float* K = A + mn;
    float* W1 = K + nn;          // Ks
    float* W2 = W1 + nn;         // L, then 2I - Ks X0, then K^-1
    float* W3 = W2 + nn;         // L^-1, then X
    float* W4 = W3 + nn;         // X0

    // ---- load ------------------------------------------------------------
    for (int k = t; k < nn; k += T) P[k] = P_in[(size_t)b * nn + k];
    for (int k = t; k < mn; k += T) A[k] = A_in[(size_t)b * mn + k];
    for (int j = t; j < n; j += T) {
        v.q[j] = q_in[(size_t)b * n + j];
        sD[j] = 1.0f;
    }
    for (int i = t; i < m; i += T) {
        v.l[i] = l_in[(size_t)b * m + i];
        v.u[i] = u_in[(size_t)b * m + i];
        srpat[i] = 1.0f + eqf_in[(size_t)b * m + i] * (fp.rho_eq_scale - 1.0f);
        sE[i] = 1.0f;
    }
    float c = 1.0f;
    __syncthreads();

    // ---- 1. full-rescale Ruiz + cost scaling ------------------------------
    for (int it = 0; it < fp.equilibrate_iters; ++it) {
        for (int j = t; j < n; j += T) {
            float mx = 0.f;
            for (int i = 0; i < n; ++i) mx = fmaxf(mx, fabsf(P[i * n + j]));
            for (int i = 0; i < m; ++i) mx = fmaxf(mx, fabsf(A[i * n + j]));
            sdn[j] = mx < 1e-10f ? 1.0f : rsqrtf(fmaxf(mx, 1e-12f));
        }
        for (int i = warp; i < m; i += n_warps) {
            float mx = 0.f;
            for (int k = lane; k < n; k += 32)
                mx = fmaxf(mx, fabsf(A[i * n + k]));
            mx = warp_max(mx);
            if (lane == 0)
                sdm[i] = mx < 1e-10f ? 1.0f : rsqrtf(fmaxf(mx, 1e-12f));
        }
        __syncthreads();
        for (int k = t; k < nn; k += T) {
            const int i = k / n, j = k - i * n;
            P[k] = (P[k] * sdn[i]) * sdn[j];
        }
        for (int k = t; k < mn; k += T) {
            const int i = k / n, j = k - i * n;
            A[k] = (A[k] * sdm[i]) * sdn[j];
        }
        for (int j = t; j < n; j += T) {
            v.q[j] *= sdn[j];
            sD[j] *= sdn[j];
        }
        for (int i = t; i < m; i += T) sE[i] *= sdm[i];
        __syncthreads();
        float psum = 0.f, qmax = 0.f;
        for (int j = t; j < n; j += T) {
            float mx = 0.f;
            for (int i = 0; i < n; ++i) mx = fmaxf(mx, fabsf(P[i * n + j]));
            psum += mx;
            qmax = fmaxf(qmax, fabsf(v.q[j]));
        }
        psum = block_sum(psum, red);
        qmax = block_max(qmax, red);
        const float gamma =
            1.0f / fmaxf(fmaxf(psum / (float)n, qmax), 1e-12f);
        for (int k = t; k < nn; k += T) P[k] *= gamma;
        for (int j = t; j < n; j += T) v.q[j] *= gamma;
        c *= gamma;
        __syncthreads();
    }
    for (int i = t; i < m; i += T) {
        const float li = v.l[i], ui = v.u[i];
        v.l[i] = li <= -fp.inf ? li : sE[i] * li;
        v.u[i] = ui >= fp.inf ? ui : sE[i] * ui;
    }

    // ---- 2. warm start ------------------------------------------------------
    for (int j = t; j < n; j += T)
        v.x[j] = x0_in[(size_t)b * n + j] / sD[j];
    for (int i = t; i < m; i += T)
        v.y[i] = (y0_in[(size_t)b * m + i] * c) / sE[i];
    __syncthreads();
    for (int i = warp; i < m; i += n_warps) {
        const float ax = warp_row_dot(A + (size_t)i * n, v.x, n, lane);
        if (lane == 0) v.z[i] = fminf(fmaxf(ax, v.l[i]), v.u[i]);
    }
    __syncthreads();

    // ---- 3. adapt rounds ----------------------------------------------------
    float rho_s = fp.rho0;
    for (int round = 0; round < fp.n_rounds; ++round) {
        for (int i = t; i < m; i += T) {
            const float rh = srpat[i] * rho_s;
            v.rho[i] = rh;
            v.rinv[i] = 1.0f / rh;
            v.w[i] = rh * v.z[i] - v.y[i];
        }
        __syncthreads();

        // K = P + sigma I + (A rho)' A
        for (int k = t; k < nn; k += T) {
            const int i = k / n, j = k - i * n;
            float acc = 0.f;
            for (int r = 0; r < m; ++r)
                acc = fmaf(A[r * n + i] * v.rho[r], A[r * n + j], acc);
            K[k] = (P[k] + (i == j ? sigma : 0.f)) + acc;
        }
        __syncthreads();

        // Jacobi scaling: Ks = K s_j s_i
        float* ss = sdn;
        for (int j = t; j < n; j += T)
            ss[j] = rsqrtf(fmaxf(K[j * n + j], 1e-30f));
        __syncthreads();
        for (int k = t; k < nn; k += T) {
            const int i = k / n, j = k - i * n;
            W1[k] = (K[k] * ss[j]) * ss[i];
        }
        __syncthreads();

        // Cholesky, left-looking column sweep: L (lower; the upper triangle
        // is never read).  Thread i forms its own entry of column j and, to
        // save a barrier, the pivot as well.
        float* L = W2;
        for (int j = 0; j < n; ++j) {
            for (int i = j + t; i < n; i += T) {
                float vi = W1[i * n + j], vj = W1[j * n + j];
                for (int k = 0; k < j; ++k) {
                    const float ljk = L[j * n + k];
                    vi = fmaf(-L[i * n + k], ljk, vi);
                    vj = fmaf(-ljk, ljk, vj);
                }
                L[i * n + j] = vi / sqrtf(fmaxf(vj, 1e-10f));
            }
            __syncthreads();
        }

        // L^-1 by forward substitution, one thread per column (lower; the
        // upper triangle is never read)
        float* Li = W3;
        for (int cc = t; cc < n; cc += T) {
            Li[cc * n + cc] = 1.0f / L[cc * n + cc];
            for (int i = cc + 1; i < n; ++i) {
                float acc = 0.f;
                for (int k = cc; k < i; ++k)
                    acc = fmaf(L[i * n + k], Li[k * n + cc], acc);
                Li[i * n + cc] = -acc / L[i * n + i];
            }
        }
        __syncthreads();

        // X0 = L^-T L^-1
        float* X0 = W4;
        for (int k = t; k < nn; k += T) {
            const int i = k / n, j = k - i * n;
            float acc = 0.f;
            for (int r = (i > j ? i : j); r < n; ++r)
                acc = fmaf(Li[r * n + i], Li[r * n + j], acc);
            X0[k] = acc;
        }
        __syncthreads();

        // one Newton-Schulz step: M = 2I - Ks X0 (over L), r0 = |I - Ks X0|^2
        float r0 = 0.f;
        for (int k = t; k < nn; k += T) {
            const int i = k / n, j = k - i * n;
            float acc = 0.f;
            for (int r = 0; r < n; ++r)
                acc = fmaf(W1[i * n + r], X0[r * n + j], acc);
            const float eye = i == j ? 1.0f : 0.f;
            const float d = eye - acc;
            r0 = fmaf(d, d, r0);
            W2[k] = 2.0f * eye - acc;
        }
        r0 = block_sum(r0, red);
        // X = X0 M (over L^-1)
        float* X = W3;
        for (int k = t; k < nn; k += T) {
            const int i = k / n, j = k - i * n;
            float acc = 0.f;
            for (int r = 0; r < n; ++r)
                acc = fmaf(X0[i * n + r], W2[r * n + j], acc);
            X[k] = acc;
        }
        __syncthreads();
        float r1 = 0.f;
        for (int k = t; k < nn; k += T) {
            const int i = k / n, j = k - i * n;
            float acc = 0.f;
            for (int r = 0; r < n; ++r)
                acc = fmaf(W1[i * n + r], X[r * n + j], acc);
            const float d = (i == j ? 1.0f : 0.f) - acc;
            r1 = fmaf(d, d, r1);
        }
        r1 = block_sum(r1, red);
        // divergence safeguard (a NaN compares false: back to X0), then the
        // finite safeguard (identity in the scaled frame)
        const float* sel = (r1 < r0 * 4.0f + 1.0f) ? X : X0;
        float bad = 0.f;
        for (int k = t; k < nn; k += T)
            if (!isfinite(sel[k])) bad += 1.0f;
        bad = block_sum(bad, red);
        float* Kinv = W2;
        for (int k = t; k < nn; k += T) {
            const int i = k / n, j = k - i * n;
            const float xv = bad > 0.f ? (i == j ? 1.0f : 0.f) : sel[k];
            Kinv[k] = (xv * ss[j]) * ss[i];
        }
        __syncthreads();

        refined_iterations(Kinv, K, A, n, m, fp.iters_per, sigma, fp.alpha, v,
                           fp.col_threads, fp.n_chunks);

        if (round + 1 < fp.n_rounds) {
            // scaled residual ratios -> rho_s
            float m_axz = 0.f, m_ax = 0.f, m_z = 0.f;
            for (int i = warp; i < m; i += n_warps) {
                const float ax = warp_row_dot(A + (size_t)i * n, v.x, n, lane);
                m_axz = fmaxf(m_axz, fabsf(ax - v.z[i]));
                m_ax = fmaxf(m_ax, fabsf(ax));
                m_z = fmaxf(m_z, fabsf(v.z[i]));
            }
            float m_d = 0.f, m_px = 0.f, m_q = 0.f, m_aty = 0.f;
            for (int j = t; j < n; j += T) {
                float px = 0.f, aty = 0.f;
                for (int i = 0; i < n; ++i)
                    px = fmaf(P[i * n + j], v.x[i], px);
                for (int i = 0; i < m; ++i)
                    aty = fmaf(A[i * n + j], v.y[i], aty);
                m_d = fmaxf(m_d, fabsf((px + v.q[j]) + aty));
                m_px = fmaxf(m_px, fabsf(px));
                m_q = fmaxf(m_q, fabsf(v.q[j]));
                m_aty = fmaxf(m_aty, fabsf(aty));
            }
            m_axz = block_max(m_axz, red);
            m_ax = block_max(m_ax, red);
            m_z = block_max(m_z, red);
            m_d = block_max(m_d, red);
            m_px = block_max(m_px, red);
            m_q = block_max(m_q, red);
            m_aty = block_max(m_aty, red);
            const float rp = m_axz / fmaxf(fmaxf(m_ax, m_z), 1e-12f);
            const float rd =
                m_d / fmaxf(fmaxf(m_px, fmaxf(m_q, m_aty)), 1e-12f);
            rho_s = fminf(fmaxf(rho_s * sqrtf(rp / fmaxf(rd, 1e-12f)), 1e-3f),
                          1e3f);
        }
    }

    // ---- 4. scaled iterates and the scales ---------------------------------
    for (int j = t; j < n; j += T) {
        x_out[(size_t)b * n + j] = v.x[j];
        d_out[(size_t)b * n + j] = sD[j];
    }
    for (int i = t; i < m; i += T) {
        y_out[(size_t)b * m + i] = v.y[i];
        e_out[(size_t)b * m + i] = sE[i];
    }
    if (t == 0) c_out[b] = c;
}

// ---- the warp path ----------------------------------------------------------

constexpr int WN = 32;              // largest n: lane i owns row and column i
constexpr int MAX_WARP_SLOTS = 12;  // scenarios (warps) per block
constexpr unsigned FULL = 0xffffffffu;

struct FusedIO {
    const float *P, *q, *A, *l, *u, *eqf, *x0, *y0;
    float *x_out, *y_out, *d_out, *e_out, *c_out;
    int B;
};

constexpr int WS = 32;   // row stride of the factorization's scratch matrix

// Floats of the scratch matrix W: n rows of WS floats while it is factored,
// n rows of ld floats once it holds K^-1.
__host__ __device__ __forceinline__ int scratch_floats(int n, int ld)
{
    return n * (ld > WS ? ld : WS);
}

// Floats of one scenario's slot, a multiple of four: W first, so that its
// rows are 16-byte aligned (the wrapper's fused_layout() computes the same).
__host__ __device__ __forceinline__ int warp_slot_floats(int n, int m, int ld)
{
    return (scratch_floats(n, ld) + (2 * n + m) * ld + 7 * n + 10 * m + 3)
           & ~3;
}

// sum_r row[r] * wrow[r] over all WS entries: the row in registers, wrow a
// row of W read by every lane alike in eight 16-byte broadcasts.  Entries
// past n are zero on both sides.
__device__ __forceinline__ float row_dot(const float (&row)[WN],
                                         const float* wrow)
{
    const float4* w4 = reinterpret_cast<const float4*>(wrow);
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int q = 0; q < WS / 4; ++q) {
        const float4 v = w4[q];
        a0 = fmaf(row[4 * q + 0], v.x, a0);
        a1 = fmaf(row[4 * q + 1], v.y, a1);
        a2 = fmaf(row[4 * q + 2], v.z, a2);
        a3 = fmaf(row[4 * q + 3], v.w, a3);
    }
    return (a0 + a1) + (a2 + a3);
}

__global__ void __launch_bounds__(32 * MAX_WARP_SLOTS)
admm_fused_warp_kernel(FusedIO io, FusedParams fp, int ld)
{
    extern __shared__ __align__(16) float smem[];
    const int n = fp.n, m = fp.m;
    const int T = blockDim.x;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int G = T >> 5;
    const int b0 = blockIdx.x * G;
    const int slot_floats = warp_slot_floats(n, m, ld);
    const float sigma = fp.sigma;

    // the whole block copies P and A of its scenarios, rows padded to ld
    for (int s = 0; s < G && b0 + s < io.B; ++s) {
        float* dP = smem + (size_t)s * slot_floats + scratch_floats(n, ld);
        float* dA = dP + n * ld;
        const float* gP = io.P + (size_t)(b0 + s) * n * n;
        const float* gA = io.A + (size_t)(b0 + s) * m * n;
        for (int k = t; k < n * n; k += T) {
            const int i = k / n, j = k - i * n;
            dP[i * ld + j] = gP[k];
        }
        for (int k = t; k < m * n; k += T) {
            const int i = k / n, j = k - i * n;
            dA[i * ld + j] = gA[k];
        }
    }
    __syncthreads();

    const int b = b0 + warp;
    if (b >= io.B) return;

    float* sW = smem + (size_t)warp * slot_floats;   // scratch, then K^-1
    float* sP = sW + scratch_floats(n, ld);
    float* sA = sP + n * ld;
    float* sK = sA + m * ld;
    float* p = sK + n * ld;
    WarpVecs v;
    v.x = p;    p += n;
    v.q = p;    p += n;
    v.rhs = p;  p += n;
    v.xa = p;   p += n;
    v.r = p;    p += n;
    float* sD = p;   p += n;
    float* sdn = p;  p += n;     // Ruiz column scale
    v.z = p;    p += m;
    v.y = p;    p += m;
    v.w = p;    p += m;
    v.l = p;    p += m;
    v.u = p;    p += m;
    v.rho = p;  p += m;
    v.rinv = p; p += m;
    float* srpat = p; p += m;    // 1 + eqf (rho_eq_scale - 1)
    float* sE = p;    p += m;
    float* sdm = p;              // Ruiz row scale

    // lane j owns column j and row j of the n x n matrices; lanes past n
    // carry zeros, read row / column 0 and store nothing
    const bool act = lane < n;
    const int own = act ? lane : 0;
    float* colP = sP + own;            // column `own` of P: colP[i * ld]
    float* colA = sA + own;

    if (act) {
        v.q[lane] = io.q[(size_t)b * n + lane];
        sD[lane] = 1.0f;
    }
    for (int i = lane; i < m; i += 32) {
        v.l[i] = io.l[(size_t)b * m + i];
        v.u[i] = io.u[(size_t)b * m + i];
        srpat[i] = 1.0f + io.eqf[(size_t)b * m + i] * (fp.rho_eq_scale - 1.0f);
        sE[i] = 1.0f;
    }
    float c = 1.0f;
    __syncwarp();

    // ---- 1. full-rescale Ruiz + cost scaling ------------------------------
    for (int it = 0; it < fp.equilibrate_iters; ++it) {
        if (act) {
            float mx = 0.f;
            for (int i = 0; i < n; ++i) mx = fmaxf(mx, fabsf(colP[i * ld]));
            for (int i = 0; i < m; ++i) mx = fmaxf(mx, fabsf(colA[i * ld]));
            sdn[lane] = mx < 1e-10f ? 1.0f : rsqrtf(fmaxf(mx, 1e-12f));
        }
        for (int i = lane; i < m; i += 32) {
            float mx = 0.f;
            for (int k = 0; k < n; ++k) mx = fmaxf(mx, fabsf(sA[i * ld + k]));
            sdm[i] = mx < 1e-10f ? 1.0f : rsqrtf(fmaxf(mx, 1e-12f));
        }
        __syncwarp();
        float psum = 0.f, qmax = 0.f;
        if (act) {
            const float dj = sdn[lane];
            for (int i = 0; i < n; ++i) {
                const float pv = (colP[i * ld] * sdn[i]) * dj;
                colP[i * ld] = pv;
                psum = fmaxf(psum, fabsf(pv));      // abs-max of the column
            }
            for (int i = 0; i < m; ++i)
                colA[i * ld] = (colA[i * ld] * sdm[i]) * dj;
            const float qj = v.q[lane] * dj;
            v.q[lane] = qj;
            sD[lane] *= dj;
            qmax = fabsf(qj);
        }
        for (int i = lane; i < m; i += 32) sE[i] *= sdm[i];
        psum = warp_sum(psum);
        qmax = warp_max(qmax);
        const float gamma =
            1.0f / fmaxf(fmaxf(psum / (float)n, qmax), 1e-12f);
        if (act) {
            for (int i = 0; i < n; ++i) colP[i * ld] *= gamma;
            v.q[lane] *= gamma;
        }
        c *= gamma;
        __syncwarp();
    }
    for (int i = lane; i < m; i += 32) {
        const float li = v.l[i], ui = v.u[i];
        v.l[i] = li <= -fp.inf ? li : sE[i] * li;
        v.u[i] = ui >= fp.inf ? ui : sE[i] * ui;
    }

    // ---- 2. warm start ------------------------------------------------------
    if (act) v.x[lane] = io.x0[(size_t)b * n + lane] / sD[lane];
    for (int i = lane; i < m; i += 32)
        v.y[i] = (io.y0[(size_t)b * m + i] * c) / sE[i];
    __syncwarp();
    for (int i = lane; i < m; i += 32) {
        const float ax = dot_strided(sA + i * ld, 1, v.x, n);
        v.z[i] = fminf(fmaxf(ax, v.l[i]), v.u[i]);
    }

    // ---- 3. adapt rounds ----------------------------------------------------
    float rho_s = fp.rho0;
    for (int round = 0; round < fp.n_rounds; ++round) {
        for (int i = lane; i < m; i += 32) {
            const float rh = srpat[i] * rho_s;
            v.rho[i] = rh;
            v.rinv[i] = 1.0f / rh;
            v.w[i] = rh * v.z[i] - v.y[i];
        }
        __syncwarp();

        // row `lane` of K = P + sigma I + (A rho)' A, in registers
        float kr[WN];
#pragma unroll
        for (int j = 0; j < WN; ++j) kr[j] = 0.f;
        for (int r = 0; r < m; ++r) {
            const float* ar = sA + r * ld;
            const float ai = ar[own] * v.rho[r];
#pragma unroll
            for (int j = 0; j < WN; ++j)
                if (j < n) kr[j] = fmaf(ai, ar[j], kr[j]);
        }
#pragma unroll
        for (int j = 0; j < WN; ++j)
            if (j < n) {
                kr[j] = (sP[own * ld + j] + (j == lane ? sigma : 0.f)) + kr[j];
                if (act) sK[lane * ld + j] = kr[j];
            }
        __syncwarp();

        // Jacobi scaling: row `lane` of Ks = s K s, kept in registers (ks);
        // zero in lanes past n and in columns past n
        const float si = act ? rsqrtf(fmaxf(sK[lane * ld + lane], 1e-30f))
                             : 0.f;
        float ks[WN];
#pragma unroll
        for (int j = 0; j < WN; ++j) {
            const float sj = __shfl_sync(FULL, si, j);
            ks[j] = j < n ? (kr[j] * sj) * si : 0.f;
        }
        // W is factored with the row stride WS and holds TRANSPOSES: a lane
        // stores its row's entry (i, j) at W[j][i], lanes on consecutive
        // words, and what every lane reads alike is then a row of W, in
        // 16-byte pieces.  Its columns past n must read as zero (the last
        // round's K^-1 lay here with another stride).
        if (act)
            for (int j = n; j < WS; ++j) sW[lane * WS + j] = 0.f;

        // Cholesky, left-looking column sweep: lane i forms entry (i, j) of
        // L and stores it at W[j][i]; the pivot's own sum comes from lane j.
        // Lanes above the diagonal store zeros.  Lane j keeps L[j][j].
        float diag = 1.0f;
#pragma unroll
        for (int j = 0; j < WN; ++j) {
            if (j < n) {
                float vi = ks[j];
                for (int k = 0; k < j; ++k)
                    vi = fmaf(-sW[k * WS + own], sW[k * WS + j], vi);
                const float vj = __shfl_sync(FULL, vi, j);
                const float lij =
                    lane >= j ? vi / sqrtf(fmaxf(vj, 1e-10f)) : 0.f;
                if (lane == j) diag = lij;
                if (act) sW[j * WS + lane] = lij;
                __syncwarp();
            }
        }

        // L^-1 by forward substitution, row-major into the lower triangle
        // of W (L' stays above the diagonal until every row has used it):
        // lane c forms column c; entry (i, c) needs row i of L, read by
        // every lane alike from column i of W, and column c of L^-1 above it
        for (int i = 0; i < n; ++i) {
            float acc = 0.f;
            for (int k = 0; k < i; ++k) {
                const float lkc = k >= lane ? sW[k * WS + own] : 0.f;
                acc = fmaf(sW[k * WS + i], lkc, acc);
            }
            const float lii = __shfl_sync(FULL, diag, i);
            if (lane <= i)
                sW[i * WS + lane] = lane == i ? 1.0f / lii : -acc / lii;
            __syncwarp();
        }
        for (int k = 0; k < n; ++k)          // L' has served: zeros above
            if (act && k < lane) sW[k * WS + lane] = 0.f;
        __syncwarp();

        // row `lane` of X0 = L^-T L^-1, in registers, then TRANSPOSED over W
        float x0r[WN];
#pragma unroll
        for (int j = 0; j < WN; ++j) x0r[j] = 0.f;
        for (int r = 0; r < n; ++r) {
            const float4* lr = reinterpret_cast<const float4*>(sW + r * WS);
            const float li = act ? sW[r * WS + lane] : 0.f;
#pragma unroll
            for (int q = 0; q < WS / 4; ++q) {
                const float4 v = lr[q];
                x0r[4 * q + 0] = fmaf(li, v.x, x0r[4 * q + 0]);
                x0r[4 * q + 1] = fmaf(li, v.y, x0r[4 * q + 1]);
                x0r[4 * q + 2] = fmaf(li, v.z, x0r[4 * q + 2]);
                x0r[4 * q + 3] = fmaf(li, v.w, x0r[4 * q + 3]);
            }
        }
        __syncwarp();
        if (act) {
#pragma unroll
            for (int j = 0; j < WN; ++j)
                if (j < n) sW[j * WS + lane] = x0r[j];
        }
        __syncwarp();

        // one Newton-Schulz step.  M = 2I - Ks X0 column by column: column j
        // of X0 is row j of W, read by every lane, then overwritten by
        // column j of M;  r0 = |I - Ks X0|_F^2
        float r0 = 0.f;
        for (int j = 0; j < n; ++j) {
            const float acc = row_dot(ks, sW + j * WS);
            const float eye = j == lane ? 1.0f : 0.f;
            const float d = act ? eye - acc : 0.f;
            r0 = fmaf(d, d, r0);
            __syncwarp();
            if (act) sW[j * WS + lane] = 2.0f * eye - acc;
        }
        r0 = warp_sum(r0);
        __syncwarp();
        // X = X0 M, the same way over M
        for (int j = 0; j < n; ++j) {
            const float acc = row_dot(x0r, sW + j * WS);
            __syncwarp();
            if (act) sW[j * WS + lane] = acc;
        }
        __syncwarp();
        // r1 = |I - Ks X|_F^2
        float r1 = 0.f;
        for (int j = 0; j < n; ++j) {
            const float acc = row_dot(ks, sW + j * WS);
            const float d = act ? (j == lane ? 1.0f : 0.f) - acc : 0.f;
            r1 = fmaf(d, d, r1);
        }
        r1 = warp_sum(r1);
        // divergence safeguard (a NaN compares false: back to X0), then the
        // finite safeguard (identity in the scaled frame); K^-1 = s X s
        const bool take_x = r1 < r0 * 4.0f + 1.0f;
        float bad = 0.f;
#pragma unroll
        for (int j = 0; j < WN; ++j)
            if (j < n && act) {
                x0r[j] = take_x ? sW[j * WS + lane] : x0r[j];
                if (!isfinite(x0r[j])) bad += 1.0f;
            }
        bad = warp_sum(bad);
        __syncwarp();
        // from here W holds K^-1 as given, rows padded to ld, as the
        // iterations read it
#pragma unroll
        for (int j = 0; j < WN; ++j) {
            const float sj = __shfl_sync(FULL, si, j);
            if (j < n && act) {
                const float xv = bad > 0.f ? (j == lane ? 1.0f : 0.f) : x0r[j];
                sW[lane * ld + j] = (xv * sj) * si;
            }
        }
        __syncwarp();

        warp_refined_iterations(sW, sK, sA, ld, n, m, fp.iters_per, sigma,
                                fp.alpha, v, lane);

        if (round + 1 < fp.n_rounds) {
            // scaled residual ratios -> rho_s
            float m_axz = 0.f, m_ax = 0.f, m_z = 0.f;
            for (int i = lane; i < m; i += 32) {
                const float ax = dot_strided(sA + i * ld, 1, v.x, n);
                m_axz = fmaxf(m_axz, fabsf(ax - v.z[i]));
                m_ax = fmaxf(m_ax, fabsf(ax));
                m_z = fmaxf(m_z, fabsf(v.z[i]));
            }
            float m_d = 0.f, m_px = 0.f, m_q = 0.f, m_aty = 0.f;
            if (act) {
                float px = 0.f, aty = 0.f;
                for (int i = 0; i < n; ++i)
                    px = fmaf(colP[i * ld], v.x[i], px);
                for (int i = 0; i < m; ++i)
                    aty = fmaf(colA[i * ld], v.y[i], aty);
                m_d = fabsf((px + v.q[lane]) + aty);
                m_px = fabsf(px);
                m_q = fabsf(v.q[lane]);
                m_aty = fabsf(aty);
            }
            m_axz = warp_max(m_axz);
            m_ax = warp_max(m_ax);
            m_z = warp_max(m_z);
            m_d = warp_max(m_d);
            m_px = warp_max(m_px);
            m_q = warp_max(m_q);
            m_aty = warp_max(m_aty);
            const float rp = m_axz / fmaxf(fmaxf(m_ax, m_z), 1e-12f);
            const float rd =
                m_d / fmaxf(fmaxf(m_px, fmaxf(m_q, m_aty)), 1e-12f);
            rho_s = fminf(fmaxf(rho_s * sqrtf(rp / fmaxf(rd, 1e-12f)), 1e-3f),
                          1e3f);
        }
    }

    // ---- 4. scaled iterates and the scales ---------------------------------
    if (act) {
        io.x_out[(size_t)b * n + lane] = v.x[lane];
        io.d_out[(size_t)b * n + lane] = sD[lane];
    }
    for (int i = lane; i < m; i += 32) {
        io.y_out[(size_t)b * m + i] = v.y[i];
        io.e_out[(size_t)b * m + i] = sE[i];
    }
    if (lane == 0) io.c_out[b] = c;
}

size_t vector_floats(int n, int m, int n_chunks)
{
    return (size_t)8 * n + (size_t)10 * m + (size_t)n_chunks * n + 33;
}

}  // namespace

extern "C" {

// Floats of global workspace the launch needs for B scenarios (0 when the
// matrices fit in shared memory), or a negative CUDA error code.
long long admm_fused_workspace_floats(int B, int n, int m, int threads)
{
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return -(long long)err;
    int max_smem = 0;
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return -(long long)err;
    const int n_up = (n + 31) / 32 * 32;
    const int col_threads = n_up < threads ? n_up : threads;
    const int n_chunks = threads / col_threads;
    const size_t mat_floats = (size_t)6 * n * n + (size_t)m * n;
    const size_t bytes =
        sizeof(float) * (vector_floats(n, m, n_chunks) + mat_floats);
    if (bytes <= (size_t)max_smem) return 0;
    return (long long)B * (long long)mat_floats;
}

// Launch on `stream` with the geometry of the wrapper's fused_layout():
//   g > 0:   the warp path (n <= 32), g scenarios (warps) per block, rows
//            padded to `ld` floats, `slot_floats` floats of shared memory per
//            scenario (checked here); `threads` and `workspace` are unused;
//   g == 0:  the block path, `threads` the block size, a multiple of 32 in
//            [32, 1024]; `workspace` holds admm_fused_workspace_floats()
//            floats (it may be null when that is 0).
// Returns the CUDA error code of the launch.
int admm_fused_launch(const float* P, const float* q, const float* A,
                      const float* l, const float* u, const float* eqf,
                      const float* x0, const float* y0,
                      float* x_out, float* y_out, float* d_out, float* e_out,
                      float* c_out, float* workspace,
                      int B, int n, int m, int iters, int adapt_rounds,
                      int equilibrate_iters, float rho0, float sigma,
                      float alpha, float rho_eq_scale, float inf,
                      int threads, int g, int ld, int slot_floats,
                      void* stream)
{
    if (B <= 0 || n <= 0 || m <= 0 || iters < 0 || equilibrate_iters < 0)
        return (int)cudaErrorInvalidValue;

    FusedParams fp;
    fp.n = n;
    fp.m = m;
    fp.n_rounds = adapt_rounds > 1 ? adapt_rounds : 1;
    fp.iters_per = iters / fp.n_rounds > 1 ? iters / fp.n_rounds : 1;
    fp.equilibrate_iters = equilibrate_iters;
    fp.rho0 = rho0;
    fp.sigma = sigma;
    fp.alpha = alpha;
    fp.rho_eq_scale = rho_eq_scale;
    fp.inf = inf;
    fp.mats_in_smem = 1;
    fp.col_threads = 0;
    fp.n_chunks = 0;

    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    int max_smem = 0;
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;

    if (g > 0) {
        const size_t smem = sizeof(float) * (size_t)g * (size_t)slot_floats;
        if (n > WN || g > MAX_WARP_SLOTS || ld < n ||
            slot_floats != warp_slot_floats(n, m, ld) ||
            smem > (size_t)max_smem)
            return (int)cudaErrorInvalidValue;
        if (smem > 48 * 1024) {
            err = cudaFuncSetAttribute(
                admm_fused_warp_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (err != cudaSuccess) return (int)err;
        }
        const FusedIO io = {P, q, A, l, u, eqf, x0, y0,
                            x_out, y_out, d_out, e_out, c_out, B};
        admm_fused_warp_kernel<<<(B + g - 1) / g, 32 * g, smem,
                                 (cudaStream_t)stream>>>(io, fp, ld);
        return (int)cudaGetLastError();
    }

    if (threads < 32 || threads > 1024 || (threads & 31) != 0)
        return (int)cudaErrorInvalidValue;
    const int n_up = (n + 31) / 32 * 32;
    fp.col_threads = n_up < threads ? n_up : threads;
    fp.n_chunks = threads / fp.col_threads;

    const size_t vec_bytes = sizeof(float) * vector_floats(n, m, fp.n_chunks);
    const size_t mat_bytes =
        sizeof(float) * ((size_t)6 * n * n + (size_t)m * n);
    if (vec_bytes > (size_t)max_smem) return (int)cudaErrorInvalidValue;
    fp.mats_in_smem = (vec_bytes + mat_bytes <= (size_t)max_smem) ? 1 : 0;
    if (!fp.mats_in_smem && workspace == nullptr)
        return (int)cudaErrorInvalidValue;
    const size_t smem = vec_bytes + (fp.mats_in_smem ? mat_bytes : 0);

    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(admm_fused_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    admm_fused_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        P, q, A, l, u, eqf, x0, y0, x_out, y_out, d_out, e_out, c_out,
        workspace, fp);
    return (int)cudaGetLastError();
}

const char* admm_fused_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
