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
// its tiles.  Here the factorization is a left-looking column sweep (one
// barrier per column) and the triangular inverse a forward substitution (one
// thread per column of L^-1, no barrier), both in place in shared memory.
// Because n is not padded, the cost scale c of an n = 30 problem differs a
// little from the TPU kernel's (its padded identity columns enter mean(pcol));
// the solution of the QP does not depend on c.
//
// Design.  One block per scenario.  Six n x n matrices (P, K and four work
// matrices: Ks; L then 2I - Ks X0 then K^-1; L^-1 then X; X0) and A live in
// shared memory when they fit (n = 30, m = 50: 27,600 B, so several blocks
// share an SM) and in a caller-allocated global workspace otherwise (n = 192:
// slow, but right); the vectors are always in shared memory.  Every
// reduction is block-wide over ONE scenario: the safeguards are per scenario
// by construction.  f32 FMAs only; no library call.
//
// Bound on the card (chip_smoke.py computes it from the run's shapes): bytes
// = P, A and six vectors in, five out; operations = the Ruiz passes, per
// round 2 m n^2 (K) + n^3 / 3 (Cholesky) + n^3 / 3 (inverse) + about 9 n^3
// (X0, Newton-Schulz and its residuals), and (4 m n + 6 n^2) per iteration.
// Operations are the larger side.  This kernel is far from it: the
// factorization's column sweep leaves most threads idle, and every phase
// ends in a barrier.
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

// Launch on `stream`.  `threads` is the block size, a multiple of 32 in
// [32, 1024]; `workspace` holds admm_fused_workspace_floats() floats (it
// may be null when that is 0).  Returns the CUDA error code of the launch.
int admm_fused_launch(const float* P, const float* q, const float* A,
                      const float* l, const float* u, const float* eqf,
                      const float* x0, const float* y0,
                      float* x_out, float* y_out, float* d_out, float* e_out,
                      float* c_out, float* workspace,
                      int B, int n, int m, int iters, int adapt_rounds,
                      int equilibrate_iters, float rho0, float sigma,
                      float alpha, float rho_eq_scale, float inf,
                      int threads, void* stream)
{
    if (B <= 0 || n <= 0 || m <= 0 || iters < 0 || equilibrate_iters < 0 ||
        threads < 32 || threads > 1024 || (threads & 31) != 0)
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
    const int n_up = (n + 31) / 32 * 32;
    fp.col_threads = n_up < threads ? n_up : threads;
    fp.n_chunks = threads / fp.col_threads;

    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    int max_smem = 0;
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;

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
