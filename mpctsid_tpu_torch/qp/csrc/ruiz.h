// The per-scenario body of the Ruiz kernel (ruiz.cu): qp/admm.py's
// `ruiz_equilibrate`, the norm-only modified-Ruiz equilibration of
// [[P, A'], [A, 0]] with the cost scaling, and the scaled problem.
//
// Plain C++: every function is marked RUIZ_FN, `__host__ __device__` under
// nvcc and plain `inline` under a host compiler, so the tests build this
// very arithmetic with g++ and run it on the CPU
// (tests/test_torch_ruiz_kernel.py).  The body runs in phases over units
// (`ex.units(count, f)`) with a block barrier between phases
// (`ex.sync()`); the kernel's threads take the units, the host executor
// (HostExec) runs them one after the other.  Two steps are the executor's
// own: `row_max` (a warp's maximum into a row's entry: a warp reduction
// and a shared atomic on the card) and `block_sum` (the one sum, in a fixed
// tree that the host twin repeats).
//
// Bits.  Every maximum is of non-negative values (or NaN) and is taken on
// their bit patterns as unsigned integers, which orders them as floats
// (NaN above +inf, so NaN propagates as torch.amax / torch.maximum do), in
// any order with the same result.  Each weighted entry D_i |P_ij| is one
// rounding, as in the plain version.  The products are the plain version's
// in its order; the scale is rsqrtf on the card (torch.rsqrt's) and
// 1 / sqrtf on the host (the CPU's torch.rsqrt); the mean of the column
// norms is the tree sum times 1/n (torch.mean on the card multiplies by
// that factor; PyTorch's own summation order is its reduction kernel's, so
// the mean may part from it by rounding).
//
// Shapes: P (n, n) and A (m, n) with contiguous rows, a scenario's first
// element at b * stride; q (n), l, u (m) likewise.  Shared memory (floats,
// `smem_floats`): P (n * n, where the layout keeps it there: `p_in_smem`),
// D (n), E (m), the column maxima of each of the G row groups (2 G n), the
// row maxima (m), the cost scaling's column norms (n) and 40 floats of
// reduction scratch.

#pragma once

#include <math.h>
#include <string.h>

#if defined(__CUDACC__)
#define RUIZ_FN __host__ __device__ __forceinline__
#else
#define RUIZ_FN inline
#endif

namespace ruiz {

constexpr int WARP = 32;
constexpr int GROUPS = 4;           // row groups: threads G x W
constexpr int MAX_WIDTH = 256;      // W: threads of a group (columns)
constexpr float INF = 1e20f;        // qp/admm.py's finite infinity
constexpr int SCRATCH = 40;         // warp sums (32), c, max |q| D, spare
constexpr int CHUNK = 8;            // rows of A loaded ahead

// threads of a row group: one a column, a multiple of 32, at most 256
RUIZ_FN int width(int n)
{
    const int w = (n + WARP - 1) / WARP * WARP;
    return w < MAX_WIDTH ? w : MAX_WIDTH;
}

RUIZ_FN int threads(int n) { return GROUPS * width(n); }

// `slots`: nonzeros of A kept per (row group, column), 0 for none
RUIZ_FN long long smem_floats(int n, int m, bool p_in_smem, int slots)
{
    return (p_in_smem ? (long long)n * n : 0) + n + m + 2LL * GROUPS * n
           + m + n + SCRATCH
           + (slots > 0 ? (long long)GROUPS * n * (1 + 2 * slots) : 0);
}

enum In { I_P, I_Q, I_A, I_L, I_U, I_COUNT };
enum Out { O_P, O_Q, O_A, O_L, O_U, O_D, O_E, O_C, O_COUNT };

struct Args {
    const float* in[I_COUNT];
    long long stride[I_COUNT];     // elements between two scenarios
    float* out[O_COUNT];           // contiguous, B rows each
    int n, m, iters;
    int p_in_smem;
    int slots;                     // nonzeros of A kept per (group, column)
};

// --------------------------------------------------------------- arithmetic

RUIZ_FN unsigned bits(float v)
{
#if defined(__CUDA_ARCH__)
    return __float_as_uint(v);
#else
    unsigned u;
    memcpy(&u, &v, sizeof(u));
    return u;
#endif
}

// maximum of two non-negative floats (or NaN) by their bit patterns
RUIZ_FN float mx(float a, float b) { return bits(a) >= bits(b) ? a : b; }

RUIZ_FN float rsqrt_of(float v)
{
#if defined(__CUDA_ARCH__)
    return rsqrtf(v);
#else
    return 1.0f / sqrtf(v);
#endif
}

// torch.where(v < 1e-10, 1, torch.rsqrt(torch.clamp_min(v, 1e-12)))
RUIZ_FN float scale_of(float v)
{
    return v < 1e-10f ? 1.0f : rsqrt_of(v < 1e-12f ? 1e-12f : v);
}

// --------------------------------------------------------------- host twin

#if !defined(__CUDA_ARCH__)
// Runs the units one after the other; the executor-owned steps on plain
// loops with the card's arithmetic.
struct HostExec {
    int block = 0;      // the kernel's threads (block_sum's layout)

    template <class F>
    void units(int count, F f)
    {
        for (int u = 0; u < count; ++u) f(u);
    }
    int threads() const { return block; }
    void sync() {}
    // lane `jc` of a warp offers v for row i: the warp's max reaches *dst
    void row_max(float* dst, float v, int /*jc*/) { *dst = mx(*dst, v); }
    // one unit's v into *dst
    void atomic_max(float* dst, float v) { *dst = mx(*dst, v); }
    // the card's tree: thread t sums v[t], v[t + T], ... in order; lanes
    // of each warp pairwise at offsets 16, 8, 4, 2, 1; the warps' sums in
    // order
    float block_sum(const float* v, int n, float* /*scratch*/)
    {
        const int T = block;
        float total = 0.0f;
        for (int w = 0; w < T / WARP; ++w) {
            float lane[WARP];
            for (int l = 0; l < WARP; ++l) {
                float s = 0.0f;
                for (int j = w * WARP + l; j < n; j += T) s = s + v[j];
                lane[l] = s;
            }
            for (int off = WARP / 2; off > 0; off /= 2)
                for (int l = 0; l < off; ++l)
                    lane[l] = lane[l] + lane[l + off];
            total = total + lane[0];
        }
        return total;
    }
};
#endif

// ------------------------------------------------------------------- body

// dst[k] = f(k, src[k]) for k in [0, total): thread t takes k = k0 + c T
// + t, c < CHUNK (consecutive threads on consecutive addresses), its CHUNK
// loads issued before any of its stores (a store may alias a later load
// for all the compiler knows, and would hold each load back).
template <class Ex, class F>
RUIZ_FN void streamed(Ex& ex, const float* src, float* dst, long long total,
                      F f)
{
    const int T = ex.threads();
    ex.units(T, [&](int t) {
        for (long long k0 = 0; k0 < total; k0 += (long long)T * CHUNK) {
            float v[CHUNK];
            for (int c = 0; c < CHUNK; ++c) {
                const long long k = k0 + (long long)c * T + t;
                v[c] = k < total ? src[k] : 0.0f;
            }
            for (int c = 0; c < CHUNK; ++c) {
                const long long k = k0 + (long long)c * T + t;
                if (k < total) dst[k] = f(k, v[c]);
            }
        }
    });
}

// Scenario b of `a`, its shared memory `s` (smem_floats).  Unit layout of
// the column passes: unit u = g W + jc is row group g (rows i = g, g + G,
// ...) on columns j = j0 + jc, j0 = 0, W, 2 W, ...: a warp's lanes share g
// and take consecutive columns, so that a row of P or A is read in
// consecutive addresses and a row's maximum is one warp reduction.
//
// Sparse A.  A zero entry adds nothing to a maximum of non-negative values,
// so the first round's pass over A also keeps each unit's nonzeros (row and
// |A_ij|, NaN included) in `slots` places per (group, column); where every
// unit's fit (the MPC's pyramid rows: at most 2 a group and column), the
// later rounds read those lists instead of A, with one shared atomic
// maximum per entry, and give the same bits.  Where one does not (a dense
// A), every round reads A.
template <class Ex>
RUIZ_FN void equilibrate(Ex& ex, const Args& a, long long b, float* s)
{
    const int n = a.n, m = a.m, W = width(n);
    const float* Pg = a.in[I_P] + b * a.stride[I_P];
    const float* q = a.in[I_Q] + b * a.stride[I_Q];
    const float* A = a.in[I_A] + b * a.stride[I_A];
    float* Ps = s;
    float* D = Ps + (a.p_in_smem ? (long long)n * n : 0);
    float* E = D + n;
    float* part_p = E + m;                 // [G][n] column maxima over P
    float* part_a = part_p + GROUPS * n;   // [G][n] column maxima over A
    float* war = part_a + GROUPS * n;      // [m] row maxima over A
    float* pcol = war + m;                 // [n]
    float* red = pcol + n;                 // scratch; c, max |q| D at 32, 33,
                                           // 1 at 34 while A is read whole
    float* nz_cnt = red + SCRATCH;         // [G][n] nonzeros kept
    float* nz_row = nz_cnt + GROUPS * n;   // [G][n][slots] their rows
    float* nz_val = nz_row + GROUPS * n * a.slots;   // and |A_ij|
    const float* P = a.p_in_smem ? Ps : Pg;
    const int S = a.slots;

    streamed(ex, Pg, Ps, a.p_in_smem ? (long long)n * n : 0,
             [](long long, float v) { return v; });
    ex.units(n, [&](int j) { D[j] = 1.0f; });
    ex.units(m, [&](int i) { E[i] = 1.0f; war[i] = 0.0f; });
    ex.units(1, [&](int) {
        red[32] = 1.0f;
        red[34] = S > 0 ? 0.0f : 1.0f;
    });
    ex.sync();

    for (int it = 0; it < a.iters; ++it) {
        const bool whole = it == 0 || red[34] != 0.0f;
        const bool keep = it == 0 && S > 0;
        // max_i D_i |P_ij|, max_i E_i |A_ij| by row group; max_j |A_ij| D_j
        ex.units(GROUPS * W, [&](int u) {
            const int g = u / W, jc = u % W;
            for (int j0 = 0; j0 < n; j0 += W) {
                const int j = j0 + jc;
                const bool live = j < n;
                float wp = 0.0f, wa = 0.0f;
                const float Dj = live ? D[j] : 0.0f;
                const int gj = g * n + j;
                // after the first round, the last round's cost scaling took
                // these maxima with the same D
                if (live && it > 0) wp = part_p[gj];
                if (live && it == 0)
                    for (int i = g; i < n; i += GROUPS)
                        wp = mx(wp, fabsf(P[(long long)i * n + j]) * D[i]);
                if (!whole) {
                    // the nonzeros kept in the first round
                    if (live)
                        for (int k = 0; k < (int)nz_cnt[gj]; ++k) {
                            const int i = (int)nz_row[gj * S + k];
                            const float v = nz_val[gj * S + k];
                            wa = mx(wa, v * E[i]);
                            ex.atomic_max(war + i, v * Dj);
                        }
                } else {
                    int kept = 0;
                    // CHUNK rows' loads issued before their maxima: the
                    // shared atomics of row_max would otherwise hold each
                    // load back
                    for (int i0 = g; i0 < m; i0 += GROUPS * CHUNK) {
                        float av[CHUNK];
                        for (int c = 0; c < CHUNK; ++c) {
                            const int i = i0 + c * GROUPS;
                            av[c] = live && i < m
                                        ? fabsf(A[(long long)i * n + j])
                                        : 0.0f;
                        }
                        for (int c = 0; c < CHUNK; ++c) {
                            const int i = i0 + c * GROUPS;
                            if (i < m) {
                                wa = mx(wa, av[c] * E[i]);
                                ex.row_max(war + i, av[c] * Dj, jc);
                                if (keep && live && av[c] != 0.0f) {
                                    if (kept < S) {
                                        nz_row[gj * S + kept] = (float)i;
                                        nz_val[gj * S + kept] = av[c];
                                    }
                                    ++kept;
                                }
                            }
                        }
                    }
                    if (keep && live) {
                        nz_cnt[gj] = (float)kept;
                        if (kept > S) red[34] = 1.0f;
                    }
                }
                if (live) {
                    part_p[g * n + j] = wp;
                    part_a[g * n + j] = wa;
                }
            }
        });
        ex.sync();
        // the scales: D from the columns, E from the rows (with the c of
        // this round's start)
        const float c = red[32];
        ex.units(n > m ? n : m, [&](int k) {
            if (k < n) {
                float wp = part_p[k], wa = part_a[k];
                for (int g = 1; g < GROUPS; ++g) {
                    wp = mx(wp, part_p[g * n + k]);
                    wa = mx(wa, part_a[g * n + k]);
                }
                const float cn = mx(c * D[k] * wp, D[k] * wa);
                D[k] = D[k] * scale_of(cn);
            }
            if (k < m) {
                E[k] = E[k] * scale_of(E[k] * war[k]);
                war[k] = 0.0f;
            }
            if (k == 0) red[33] = 0.0f;
        });
        ex.sync();
        // cost scaling against the new D: max_i D_i |P_ij| again
        ex.units(GROUPS * W, [&](int u) {
            const int g = u / W, jc = u % W;
            for (int j = jc; j < n; j += W) {
                float wp = 0.0f;
                for (int i = g; i < n; i += GROUPS)
                    wp = mx(wp, fabsf(P[(long long)i * n + j]) * D[i]);
                part_p[g * n + j] = wp;
            }
        });
        ex.sync();
        // the column norms; max_j |q_j| D_j into red[33] (whole warps: W
        // threads)
        ex.units(W, [&](int jc) {
            float qm = 0.0f;
            for (int j = jc; j < n; j += W) {
                float wp = part_p[j];
                for (int g = 1; g < GROUPS; ++g)
                    wp = mx(wp, part_p[g * n + j]);
                pcol[j] = c * D[j] * wp;
                qm = mx(qm, fabsf(q[j]) * D[j]);
            }
            ex.row_max(red + 33, qm, jc);
        });
        ex.sync();
        const float sum = ex.block_sum(pcol, n, red);
        ex.units(1, [&](int) {
            const float qmax = red[33];
            const float mean = sum * (1.0f / (float)n);
            const float v = mx(mean, c * qmax);
            const float gamma = 1.0f / (v < 1e-12f ? 1e-12f : v);
            red[32] = c * gamma;
        });
        ex.sync();
    }

    // the scaled problem: Pb = (c D_i) P_ij D_j, qb = c D q, Ab = E_i A_ij
    // D_j, the bounds E l, E u unless infinite
    const float c = red[32];
    float* Pb = a.out[O_P] + b * (long long)n * n;
    float* Ab = a.out[O_A] + b * (long long)m * n;
    streamed(ex, P, Pb, (long long)n * n, [&](long long k, float v) {
        return c * D[k / n] * v * D[k % n];
    });
    streamed(ex, A, Ab, (long long)m * n, [&](long long k, float v) {
        return E[k / n] * v * D[k % n];
    });
    ex.units(n, [&](int j) {
        a.out[O_Q][b * n + j] = c * D[j] * q[j];
        a.out[O_D][b * n + j] = D[j];
    });
    const float* l = a.in[I_L] + b * a.stride[I_L];
    const float* u = a.in[I_U] + b * a.stride[I_U];
    ex.units(m, [&](int i) {
        a.out[O_L][b * m + i] = l[i] <= -INF ? l[i] : E[i] * l[i];
        a.out[O_U][b * m + i] = u[i] >= INF ? u[i] : E[i] * u[i];
        a.out[O_E][b * m + i] = E[i];
    });
    ex.units(1, [&](int) { a.out[O_C][b] = c; });
}

}  // namespace ruiz
