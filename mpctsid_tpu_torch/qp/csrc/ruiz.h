// The per-scenario body of the Ruiz kernel (ruiz.cu): qp/admm.py's
// `ruiz_equilibrate`, the norm-only modified-Ruiz equilibration of
// [[P, A'], [A, 0]] with the cost scaling, and the scaled problem.
//
// Plain C++: every function is marked RUIZ_FN, `__host__ __device__` under
// nvcc and plain `inline` under a host compiler, so the tests build this
// very arithmetic with g++ and run it on the CPU
// (tests/test_torch_ruiz_kernel.py).  Two paths, each over an executor:
//
//   * the cluster path (`equilibrate_cluster`, any n): a thread-block
//     cluster of C blocks per scenario, block r owning the columns
//     [r w, (r + 1) w) of P and A (w = `slice_width`, a multiple of 4), its
//     columns of P in shared memory (`p_in_smem`) or read from device
//     memory.  The body runs in phases over units (`ex.units(count, f)`)
//     with a block barrier between phases (`ex.sync()`), inside stages that
//     each rank runs (`ex.each_rank(f)`); between stages the blocks
//     exchange (`ex.send4_all` into every block's copy, `ex.exchange` waits
//     for a step's bytes).  The card's executor (ruiz.cu) is one block of
//     the cluster; the host's (HostCluster) runs the cluster's ranks in
//     turn, stage by stage, and delivers each send at once.
//   * the warp path (`equilibrate_warp`, n <= 32 and m <= 64): a warp per
//     scenario, lane j holding column j of P and of A (`Lane`); rows are
//     broadcast by `ex.from` (a shuffle); the row maxima go through a
//     tile of the warp's own (`ex.put`, then lane i's `ex.row_max` over
//     row i; `ex.sync_lanes` between); a maximum over the lanes is
//     `ex.max_of` (one reduction on the bit patterns), the one sum
//     `ex.sum_of`.  The host's executor (HostWarp) runs the 32 lanes one
//     after another in each phase (`ex.lanes(f)`); a phase never reads
//     through `from` / `max_of` / `sum_of` / the tile what a lane writes
//     in it.
//
// Bits.  Every maximum is of non-negative values (or NaN) and is taken on
// their bit patterns as unsigned integers, which orders them as floats
// (NaN above +inf, so NaN propagates as torch.amax / torch.maximum do), in
// any order with the same result.  Each weighted entry D_i |P_ij| is one
// rounding, as in the plain version.  The products are the plain version's
// in its order; the scale is rsqrtf on the card (torch.rsqrt's) and
// 1 / sqrtf on the host (the CPU's torch.rsqrt).  The one sum, the mean of
// the column norms, is a fixed tree of n alone (`tree_sum`: the warps of a
// block of `tree_threads(n)` threads, lanes pairwise at 16, 8, 4, 2, 1,
// the warps' sums in order), which every path and every block of a cluster
// forms alike from all n norms, times 1/n (torch.mean on the card
// multiplies by that factor; PyTorch's own summation order is its reduction
// kernel's, so the mean may part from it by rounding).  So the outputs do
// not depend on the path, the cluster size or the block's threads.
//
// Shapes: P (n, n) and A (m, n) with contiguous rows, a scenario's first
// element at b * stride; q (n), l, u (m) likewise.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define RUIZ_FN __host__ __device__ __forceinline__
#define RUIZ_UNROLL _Pragma("unroll")
#else
#define RUIZ_FN inline
#define RUIZ_UNROLL
#endif

namespace ruiz {

constexpr int WARP = 32;
constexpr int GROUPS = 4;           // row groups of a block: threads G x W
constexpr int MAX_WIDTH = 96;       // W: threads of a group, at most
constexpr int TREE_WIDTH = 256;     // ... of the sum's tree
constexpr int MAX_CLUSTER = 8;      // the portable cluster size
constexpr int WARP_N = 32;          // the warp path: n <= 32,
constexpr int WARP_M = 64;          // m <= 64 (a column of A in registers)
constexpr int MAX_WARPS = 8;        // scenarios of a block on the warp path
constexpr int TILE_LD = WARP + 1;   // the warp path's row tile: [m][33]
constexpr int WARP_TILE = WARP_M * TILE_LD;   // its floats
constexpr float INF = 1e20f;        // qp/admm.py's finite infinity
constexpr int CHUNK = 16;           // rows of A loaded ahead
constexpr int HEAD = 8 + 2 * WARP;  // floats before the cluster path's
                                    // arrays: 3 mbarriers, two flags, the
                                    // sums' scratch
constexpr int P_GROUPS = 16;        // row groups of the passes over P
constexpr int MAX_KEPT = 4;         // kept nonzeros that Ab is written from

enum Path { PATH_WARP = 0, PATH_CLUSTER = 1 };
// the cluster path's mbarriers: P's columns in, then one per exchange step
enum Barrier { BAR_LOAD = 0, BAR_SCALES = 1, BAR_NORMS = 2 };

RUIZ_FN int round_up(int v, int k) { return (v + k - 1) / k * k; }

// threads of a row group: one a column, a multiple of 32, at most `cap`
RUIZ_FN int width(int cols, int cap = MAX_WIDTH)
{
    const int w = round_up(cols < 1 ? 1 : cols, WARP);
    return w < cap ? w : cap;
}

// the sum's tree: the threads of a block of G row groups of a thread a
// column, at most 256 (the block per scenario this kernel first had)
RUIZ_FN int tree_threads(int n) { return GROUPS * width(n, TREE_WIDTH); }

// columns of a block of the cluster (the last may have fewer)
RUIZ_FN int slice_width(int n, int C) { return round_up((n + C - 1) / C, 4); }

RUIZ_FN int slice_start(int n, int C, int r)
{
    const int j = r * slice_width(n, C);
    return j < n ? j : n;
}

RUIZ_FN int slice_cols(int n, int C, int r)
{
    const int j0 = slice_start(n, C, r), j1 = j0 + slice_width(n, C);
    return (j1 < n ? j1 : n) - j0;
}

RUIZ_FN int cluster_threads(int n, int C)
{
    return GROUPS * width(slice_width(n, C));
}

// The passes over P: a thread on 4 adjacent columns of the slice and a run
// of rows, `p_groups` runs of `p_rows` rows (a multiple of 4).
RUIZ_FN int p_groups(int n, int C)
{
    const int quads = slice_width(n, C) / 4;
    const int g = cluster_threads(n, C) / quads;
    return g < 1 ? 1 : g < P_GROUPS ? g : P_GROUPS;
}

RUIZ_FN int p_rows(int n, int C)
{
    const int g = p_groups(n, C);
    return round_up((n + g - 1) / g, 4);
}

// `slots`: nonzeros of A kept per (row group, column), 0 for none; every
// array a multiple of 4 floats (16-byte exchanges and loads)
RUIZ_FN long long cluster_smem_floats(int n, int m, int C, bool p_in_smem,
                                      int slots)
{
    const long long w = slice_width(n, C), n4 = round_up(n, 4),
                    m4 = round_up(m, 4);
    return HEAD + (p_in_smem ? n * w : 0) + n4 + 2 * m4 + C * m4
           + (long long)(P_GROUPS + GROUPS + 2) * w + 2 * n4
           + (slots > 0 ? GROUPS * w * (1 + 2LL * slots) : 0);
}

enum In { I_P, I_Q, I_A, I_L, I_U, I_COUNT };
enum Out { O_P, O_Q, O_A, O_L, O_U, O_D, O_E, O_C, O_COUNT };

struct Args {
    const float* in[I_COUNT];
    long long stride[I_COUNT];     // elements between two scenarios
    float* out[O_COUNT];           // contiguous, B rows each
    int n, m, iters;
    int cluster;                   // blocks a scenario (cluster path)
    int p_in_smem;                 // P's columns in shared memory
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

// maximum of two non-negative floats (or NaN) by their bit patterns (one
// unsigned max on the card)
RUIZ_FN float mx(float a, float b)
{
#if defined(__CUDA_ARCH__)
    return __uint_as_float(max(__float_as_uint(a), __float_as_uint(b)));
#else
    return bits(a) >= bits(b) ? a : b;
#endif
}

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

// c * gamma, gamma = 1 / max(mean column norm, c max_j |q_j| D_j, 1e-12)
RUIZ_FN float cost_scale(float c, float sum, float qmax, int n)
{
    const float mean = sum * (1.0f / (float)n);
    const float v = mx(mean, c * qmax);
    return c * (1.0f / (v < 1e-12f ? 1e-12f : v));
}

// Warps of the tree over n values that hold one
RUIZ_FN int tree_warps(int n)
{
    const int T = tree_threads(n), held = n < T ? n : T;
    return (held + WARP - 1) / WARP;
}

// The sum of v[0, n) in the tree: thread t of tree_threads(n) sums v[t],
// v[t + T], ... in order; the lanes of each warp pairwise at offsets 16, 8,
// 4, 2, 1; the warps' sums in order, from 0.  Warps that hold no value add
// +0, which leaves a sum of non-negative values as it is: they are skipped.
RUIZ_FN float tree_sum(const float* v, int n)
{
    const int T = tree_threads(n);
    float total = 0.0f;
    for (int w = 0; w < tree_warps(n); ++w) {
        float lane[WARP];
        for (int l = 0; l < WARP; ++l) {
            float s = 0.0f;
            for (int j = w * WARP + l; j < n; j += T) s = s + v[j];
            lane[l] = s;
        }
        for (int off = WARP / 2; off > 0; off /= 2)
            for (int l = 0; l < off; ++l) lane[l] = lane[l] + lane[l + off];
        total = total + lane[0];
    }
    return total;
}

// ----------------------------------------------------------- cluster path

struct F4 {
    float x, y, z, w;
};

// p[0, 4), 16-byte aligned
RUIZ_FN F4 load4(const float* p)
{
#if defined(__CUDA_ARCH__)
    const float4 v = *reinterpret_cast<const float4*>(p);
    return F4{v.x, v.y, v.z, v.w};
#else
    return F4{p[0], p[1], p[2], p[3]};
#endif
}

// The state a rank carries between stages (the card: a thread's registers;
// the host: one per rank).
struct Rank {
    int r;          // rank in the cluster
    float* s;       // its shared memory (cluster_smem_floats)
    float c;        // the cost scale
};

// A rank's arrays in its shared memory.
struct View {
    float* flag;      // 1 while A is read whole every round
    float* negz;      // 1 where this block's columns of A hold a -0.0
    float* scratch;   // [2][32] the sums' warp partials
    float* Ps;        // [n][w] this block's columns of P (p_in_smem)
    float* D;         // [n4] all columns' scales (each block sends its own)
    float* E;         // [m4] (every block forms all rows alike)
    float* war;       // [m4] row maxima over this block's columns
    float* wpart;     // [C][m4] every block's row maxima
    float* part_p;    // [P_GROUPS][w] column maxima over P by row run
    float* part_a;    // [G][w] ... over A
    float* stage;     // [2][w] this block's new D, or its norms and |q| D,
                      // before they are sent
    float* pcol;      // [n4] the column norms (each block sends its own)
    float* qd;        // [n4] |q_j| D_j
    float* nz_cnt;    // [G][w] nonzeros of A kept
    float* nz_row;    // [G][w][slots] their rows
    float* nz_val;    // ... and A_ij
    int j0, nc, w;    // first column, columns, the slice's width
    int m4;           // m rounded up to a multiple of 4
};

RUIZ_FN View view(const Args& a, const Rank& k)
{
    const int n = a.n, m = a.m, C = a.cluster;
    const int n4 = round_up(n, 4), m4 = round_up(m, 4);
    View v;
    v.m4 = m4;
    v.w = slice_width(n, C);
    v.j0 = slice_start(n, C, k.r);
    v.nc = slice_cols(n, C, k.r);
    float* p = k.s;
    v.flag = p + 6;
    v.negz = p + 7;
    v.scratch = p + 8;
    p += HEAD;
    v.Ps = p;
    p += a.p_in_smem ? (long long)n * v.w : 0;
    v.D = p;      p += n4;
    v.E = p;      p += m4;
    v.war = p;    p += m4;
    v.wpart = p;  p += (long long)C * m4;
    v.part_p = p; p += P_GROUPS * v.w;
    v.part_a = p; p += GROUPS * v.w;
    v.stage = p;  p += 2 * v.w;
    v.pcol = p;   p += n4;
    v.qd = p;     p += n4;
    v.nz_cnt = p; p += GROUPS * v.w;
    v.nz_row = p; p += (long long)GROUPS * v.w * a.slots;
    v.nz_val = p;
    return v;
}

// max_i |P_ij| w_i of this block's columns into part_p by runs of rows
// (w_i = D_i, or 1 where D is null): a unit on 4 adjacent columns (one
// 16-byte load of a row of the slice in shared memory) and p_rows(n, C)
// rows; the runs' maxima combine in any order
template <class Ex>
RUIZ_FN void p_maxima(Ex& ex, const Args& a, const View& v, const float* P,
                      int ld, const float* D)
{
    const int n = a.n, C = a.cluster;
    const int quads = v.w / 4, rows = p_rows(n, C);
    ex.units(p_groups(n, C) * quads, [&](int u) {
        const int g = u / quads, c = 4 * (u % quads);
        const int i0 = g * rows, i1 = i0 + rows < n ? i0 + rows : n;
        float w0 = 0.0f, w1 = 0.0f, w2 = 0.0f, w3 = 0.0f;
        int i = i0;
        if (a.p_in_smem)
            for (; i + 3 < i1; i += 4) {
                const F4 d = D ? load4(D + i) : F4{1.0f, 1.0f, 1.0f, 1.0f};
                const float dr[4] = {d.x, d.y, d.z, d.w};
                RUIZ_UNROLL
                for (int r = 0; r < 4; ++r) {
                    const F4 e = load4(P + (long long)(i + r) * ld + c);
                    w0 = mx(w0, fabsf(e.x) * dr[r]);
                    w1 = mx(w1, fabsf(e.y) * dr[r]);
                    w2 = mx(w2, fabsf(e.z) * dr[r]);
                    w3 = mx(w3, fabsf(e.w) * dr[r]);
                }
            }
        // the rest, and P in device memory: no read past the slice
        for (; i < i1; ++i) {
            const float di = D ? D[i] : 1.0f;
            const float* e = P + (long long)i * ld + c;
            if (c < v.nc) w0 = mx(w0, fabsf(e[0]) * di);
            if (c + 1 < v.nc) w1 = mx(w1, fabsf(e[1]) * di);
            if (c + 2 < v.nc) w2 = mx(w2, fabsf(e[2]) * di);
            if (c + 3 < v.nc) w3 = mx(w3, fabsf(e[3]) * di);
        }
        float* out = v.part_p + g * v.w + c;
        if (c < v.nc) out[0] = w0;
        if (c + 1 < v.nc) out[1] = w1;
        if (c + 2 < v.nc) out[2] = w2;
        if (c + 3 < v.nc) out[3] = w3;
    });
}

// column kk's maximum over the runs of part_p and the groups of part_a
RUIZ_FN float part_max(const float* part, int w, int groups, int kk)
{
    float r = part[kk];
    for (int g = 1; g < groups; ++g) r = mx(r, part[g * w + kk]);
    return r;
}

// Scenario b on the cluster path.  Unit layout of the passes over A: unit
// u = g W + jc is row group g (rows i = g, g + G, ...) on this block's
// columns jc, jc + W, ... (W = width(w)): a warp's lanes share g and take
// consecutive columns, so that a row of A is read in consecutive addresses
// and a row's maximum is one warp reduction.  The passes over P are
// p_maxima's.
//
// A round: (1) the column maxima of P (the first round; later rounds take
// the last cost pass's, which used the same D) and of A, and the row
// maxima of A over this block's columns; the new D of its columns; both
// sent to every block.  (2) E from every block's row maxima; the cost
// pass, max_i D_i |P_ij| with the new D; the column norms and |q_j| D_j
// sent to every block.  (3) c from all n norms, in every block alike.
// The first round weights P's rows by 1, not by D: a block that is ahead
// may already have sent its new D.  A block sends a step only after it has
// received the step before from every block, so nothing it sends
// overwrites what another block still reads.
//
// Sparse A.  A zero entry adds nothing to a maximum of non-negative values,
// so the first round's pass over A also keeps each unit's nonzeros (row and
// A_ij, NaN included) in `slots` places per (group, column); where every
// unit's fit (the MPC's pyramid rows: at most 2 a group and column), the
// later rounds read those lists instead of A, with one shared atomic
// maximum per entry, and give the same bits.  Where one does not (a dense
// A), every round reads A.  Where they fit and A's zeros in the block's
// columns are all +0 (no -0.0 seen), Ab is written from the lists too:
// E_i * A_ij * D_j with A_ij the kept value or +0, the plain version's
// product on the same values, so inf and NaN scales come out as it gives
// them.
template <class Ex>
RUIZ_FN void equilibrate_cluster(Ex& ex, const Args& a, long long b)
{
    const int n = a.n, m = a.m, C = a.cluster, S = a.slots;
    const float* Pg = a.in[I_P] + b * a.stride[I_P];
    const float* q = a.in[I_Q] + b * a.stride[I_Q];
    const float* A = a.in[I_A] + b * a.stride[I_A];
    const int W = width(slice_width(n, C));

    ex.each_rank([&](Rank& k) {
        const View v = view(a, k);
        if (a.p_in_smem) ex.load_rows(v.Ps, v.w, Pg + v.j0, n, n, v.nc);
        ex.units(round_up(n, 4), [&](int j) { v.D[j] = 1.0f; });
        ex.units(v.m4, [&](int i) {
            v.E[i] = 1.0f;
            v.war[i] = 0.0f;
        });
        ex.units(1, [&](int) {
            *v.flag = S > 0 ? 0.0f : 1.0f;
            *v.negz = 0.0f;
        });
        k.c = 1.0f;
    });
    // every block has started: from here on they store into each other
    ex.cluster_sync();
    if (a.p_in_smem) ex.wait_rows();

    for (int it = 0; it < a.iters; ++it) {
        ex.each_rank([&](Rank& k) {
            const View v = view(a, k);
            const float* P = a.p_in_smem ? v.Ps : Pg + v.j0;
            const int ldp = a.p_in_smem ? v.w : n;
            const bool whole = it == 0 || *v.flag != 0.0f;
            const bool keep = it == 0 && S > 0;
            // max_i |P_ij| (the first round; later rounds take the last
            // cost pass's, with the same D)
            if (it == 0) p_maxima(ex, a, v, P, ldp, nullptr);
            // max_i E_i |A_ij| by row group; max_j |A_ij| D_j over this
            // block's columns
            ex.units(GROUPS * W, [&](int u) {
                const int g = u / W;
                for (int c0 = 0; c0 < v.nc; c0 += W) {
                    const int jc = c0 + u % W;
                    const bool live = jc < v.nc;
                    float wa = 0.0f;
                    const float Dj = live ? v.D[v.j0 + jc] : 0.0f;
                    const int gj = g * v.w + jc;
                    if (!whole) {
                        // the nonzeros kept in the first round
                        if (live)
                            for (int kk = 0; kk < (int)v.nz_cnt[gj]; ++kk) {
                                const int i = (int)v.nz_row[gj * S + kk];
                                const float av =
                                    fabsf(v.nz_val[gj * S + kk]);
                                wa = mx(wa, av * v.E[i]);
                                ex.atomic_max(v.war + i, av * Dj);
                            }
                    } else {
                        int kept = 0;
                        // CHUNK rows' loads issued before their maxima:
                        // the shared atomics of row_max would otherwise
                        // hold each load back
                        for (int i0 = g; i0 < m; i0 += GROUPS * CHUNK) {
                            float ar[CHUNK];
                            for (int c = 0; c < CHUNK; ++c) {
                                const int i = i0 + c * GROUPS;
                                ar[c] = live && i < m
                                            ? A[(long long)i * n + v.j0 + jc]
                                            : 0.0f;
                            }
                            for (int c = 0; c < CHUNK; ++c) {
                                const int i = i0 + c * GROUPS;
                                const float av = fabsf(ar[c]);
                                if (i < m) {
                                    wa = mx(wa, av * v.E[i]);
                                    ex.row_max(v.war + i, av * Dj, jc);
                                    if (keep && live && av != 0.0f) {
                                        if (kept < S) {
                                            v.nz_row[gj * S + kept] =
                                                (float)i;
                                            v.nz_val[gj * S + kept] = ar[c];
                                        }
                                        ++kept;
                                    }
                                    if (keep && bits(ar[c]) == 0x80000000u)
                                        *v.negz = 1.0f;
                                }
                            }
                        }
                        if (keep && live) {
                            v.nz_cnt[gj] = (float)kept;
                            if (kept > S) *v.flag = 1.0f;
                        }
                    }
                    if (live) v.part_a[gj] = wa;
                }
            });
            ex.sync();
            // this block's new D (with the c of the round's start) and its
            // row maxima, to every block, four values a store (the pad
            // past n and m goes along)
            const int dq = (v.nc + 3) / 4, mq = v.m4 / 4;
            ex.units(4 * dq, [&](int kk) {
                float d = 1.0f;
                if (kk < v.nc) {
                    const float wp = part_max(v.part_p, v.w, p_groups(n, C),
                                              kk);
                    const float wa = part_max(v.part_a, v.w, GROUPS, kk);
                    const float Dk = v.D[v.j0 + kk];
                    d = Dk * scale_of(mx(k.c * Dk * wp, Dk * wa));
                }
                v.stage[kk] = d;
            });
            ex.sync();
            ex.units(dq > mq ? dq : mq, [&](int t) {
                if (t < dq)
                    ex.send4_all(k, v.D + v.j0 + 4 * t, load4(v.stage + 4 * t),
                                 BAR_SCALES);
                if (t < mq) {
                    float* w = v.war + 4 * t;
                    ex.send4_all(k, v.wpart + k.r * v.m4 + 4 * t, load4(w),
                                 BAR_SCALES);
                    w[0] = w[1] = w[2] = w[3] = 0.0f;
                }
            });
        });
        ex.exchange(BAR_SCALES, it,
                    4u * (unsigned)(round_up(n, 4) + C * round_up(m, 4)));
        ex.each_rank([&](Rank& k) {
            const View v = view(a, k);
            const float* P = a.p_in_smem ? v.Ps : Pg + v.j0;
            const int ldp = a.p_in_smem ? v.w : n;
            // E from the row maxima over all columns
            ex.units(m, [&](int i) {
                float w = v.wpart[i];
                for (int r = 1; r < C; ++r) w = mx(w, v.wpart[r * v.m4 + i]);
                v.E[i] = v.E[i] * scale_of(v.E[i] * w);
            });
            // cost scaling against the new D: max_i D_i |P_ij|
            p_maxima(ex, a, v, P, ldp, v.D);
            ex.sync();
            // this block's column norms and |q_j| D_j, to every block, four
            // a store (0 past n)
            const int dq = (v.nc + 3) / 4;
            ex.units(4 * dq, [&](int kk) {
                const int j = v.j0 + kk;
                float pc = 0.0f, qv = 0.0f;
                if (kk < v.nc) {
                    pc = k.c * v.D[j]
                         * part_max(v.part_p, v.w, p_groups(n, C), kk);
                    qv = fabsf(q[j]) * v.D[j];
                }
                v.stage[kk] = pc;
                v.stage[v.w + kk] = qv;
            });
            ex.sync();
            ex.units(dq, [&](int t) {
                ex.send4_all(k, v.pcol + v.j0 + 4 * t, load4(v.stage + 4 * t),
                             BAR_NORMS);
                ex.send4_all(k, v.qd + v.j0 + 4 * t,
                             load4(v.stage + v.w + 4 * t), BAR_NORMS);
            });
        });
        ex.exchange(BAR_NORMS, it, 8u * (unsigned)round_up(n, 4));
        ex.each_rank([&](Rank& k) {
            const View v = view(a, k);
            float sum, qmax;
            ex.sum_and_max(v.pcol, v.qd, n, v.scratch, sum, qmax);
            k.c = cost_scale(k.c, sum, qmax, n);
        });
    }
    // no block stores into another after this
    ex.cluster_sync();

    // the scaled problem: Pb = (c D_i) P_ij D_j, qb = c D q, Ab = E_i A_ij
    // D_j, the bounds E l, E u unless infinite; this block's columns, its
    // share of the rows
    ex.each_rank([&](Rank& k) {
        const View v = view(a, k);
        const float c = k.c;
        float* Pb = a.out[O_P] + b * (long long)n * n + v.j0;
        float* Ab = a.out[O_A] + b * (long long)m * n + v.j0;
        const float* Ag = A + v.j0;
        if (a.p_in_smem) {
            ex.units(GROUPS * W, [&](int u) {
                const int g = u / W;
                for (int jc = u % W; jc < v.nc; jc += W)
                    for (int i = g; i < n; i += GROUPS) {
                        float* e = v.Ps + (long long)i * v.w + jc;
                        *e = c * v.D[i] * *e * v.D[v.j0 + jc];
                    }
            });
            ex.store_rows(Pb, n, v.Ps, v.w, n, v.nc);
        } else {
            const float* P = Pg + v.j0;
            ex.units(GROUPS * W, [&](int u) {
                const int g = u / W;
                for (int jc = u % W; jc < v.nc; jc += W)
                    for (int i = g; i < n; i += GROUPS)
                        Pb[(long long)i * n + jc] =
                            c * v.D[i] * P[(long long)i * n + jc]
                            * v.D[v.j0 + jc];
            });
        }
        const bool lists = a.iters > 0 && S > 0 && S <= MAX_KEPT &&
                           *v.flag == 0.0f && *v.negz == 0.0f;
        ex.units(GROUPS * W, [&](int u) {
            const int g = u / W;
            for (int jc = u % W; jc < v.nc; jc += W) {
                const float Dj = v.D[v.j0 + jc];
                if (lists) {
                    const int gj = g * v.w + jc, cnt = (int)v.nz_cnt[gj];
                    int row[MAX_KEPT];
                    float val[MAX_KEPT];
                    RUIZ_UNROLL
                    for (int kk = 0; kk < MAX_KEPT; ++kk) {
                        row[kk] = kk < cnt ? (int)v.nz_row[gj * S + kk] : -1;
                        val[kk] = kk < cnt ? v.nz_val[gj * S + kk] : 0.0f;
                    }
                    for (int i = g; i < m; i += GROUPS) {
                        float aij = 0.0f;
                        RUIZ_UNROLL
                        for (int kk = 0; kk < MAX_KEPT; ++kk)
                            if (row[kk] == i) aij = val[kk];
                        Ab[(long long)i * n + jc] = v.E[i] * aij * Dj;
                    }
                    continue;
                }
                for (int i0 = g; i0 < m; i0 += GROUPS * CHUNK) {
                    float av[CHUNK];
                    for (int cc = 0; cc < CHUNK; ++cc) {
                        const int i = i0 + cc * GROUPS;
                        av[cc] = i < m ? Ag[(long long)i * n + jc] : 0.0f;
                    }
                    for (int cc = 0; cc < CHUNK; ++cc) {
                        const int i = i0 + cc * GROUPS;
                        if (i < m)
                            Ab[(long long)i * n + jc] = v.E[i] * av[cc] * Dj;
                    }
                }
            }
        });
        ex.units(v.nc, [&](int kk) {
            const int j = v.j0 + kk;
            a.out[O_Q][b * n + j] = c * v.D[j] * q[j];
            a.out[O_D][b * n + j] = v.D[j];
        });
        const float* l = a.in[I_L] + b * a.stride[I_L];
        const float* u = a.in[I_U] + b * a.stride[I_U];
        const int rows = (m + C - 1) / C, i0 = k.r * rows;
        ex.units(rows, [&](int r) {
            const int i = i0 + r;
            if (i < m) {
                a.out[O_L][b * m + i] = l[i] <= -INF ? l[i] : v.E[i] * l[i];
                a.out[O_U][b * m + i] = u[i] >= INF ? u[i] : v.E[i] * u[i];
                a.out[O_E][b * m + i] = v.E[i];
            }
        });
        if (k.r == 0) ex.units(1, [&](int) { a.out[O_C][b] = c; });
    });
}

// -------------------------------------------------------------- warp path

// Lane j's registers: column j of P and of A; rows j and j + 32 of E and
// of the row maxima.
struct Lane {
    float p[WARP_N];
    float a[WARP_M];
    float e[2], war[2];
    float D, q, wp, wa, pcol, qd, c;
    bool live;        // j < n
};

// Scenario b on the warp path: the same rounds as the cluster path's, with
// the lanes as the columns.
template <class Ex>
RUIZ_FN void equilibrate_warp(Ex& ex, const Args& a, long long b)
{
    const int n = a.n, m = a.m;
    const float* P = a.in[I_P] + b * a.stride[I_P];
    const float* q = a.in[I_Q] + b * a.stride[I_Q];
    const float* A = a.in[I_A] + b * a.stride[I_A];
    const auto D_of = [](const Lane& t) { return t.D; };

    // rows one after another: the lanes read consecutive addresses
    ex.lanes([&](int j, Lane& s) {
        s.live = j < n;
        RUIZ_UNROLL
        for (int i = 0; i < WARP_N; ++i)
            s.p[i] = s.live && i < n ? P[(long long)i * n + j] : 0.0f;
        RUIZ_UNROLL
        for (int i = 0; i < WARP_M; ++i)
            s.a[i] = s.live && i < m ? A[(long long)i * n + j] : 0.0f;
        s.q = s.live ? q[j] : 0.0f;
        s.D = 1.0f;
        s.e[0] = s.e[1] = 1.0f;
        s.war[0] = s.war[1] = 0.0f;
        s.c = 1.0f;
        s.wp = 0.0f;
    });
    for (int it = 0; it < a.iters; ++it) {
        // max_i |P_ij| (first round; later the last cost pass's), max_i
        // E_i |A_ij|; |A_ij| D_j into the row tile
        ex.lanes([&](int j, Lane& s) {
            if (it == 0) {
                float wp = 0.0f;
                RUIZ_UNROLL
                for (int i = 0; i < WARP_N; ++i)
                    if (i < n) wp = mx(wp, fabsf(s.p[i]) * 1.0f);
                s.wp = wp;
            }
            float wa = 0.0f;
            RUIZ_UNROLL
            for (int i = 0; i < WARP_M; ++i)
                if (i < m) {
                    const float Ei = ex.from(s, i & (WARP - 1),
                                             [i](const Lane& t) {
                                                 return t.e[i >> 5];
                                             });
                    wa = mx(wa, fabsf(s.a[i]) * Ei);
                    ex.put(i, j, fabsf(s.a[i]) * s.D);
                }
            s.wa = wa;
        });
        ex.sync_lanes();
        // lane i's rows i and i + 32: max_j |A_ij| D_j over the tile
        ex.lanes([&](int j, Lane& s) {
            RUIZ_UNROLL
            for (int k = 0; k < 2; ++k)
                if (j + WARP * k < m) s.war[k] = ex.row_max(j + WARP * k, n);
        });
        ex.sync_lanes();
        // the scales: D from the columns, E from the rows (with the c of
        // the round's start)
        ex.lanes([&](int j, Lane& s) {
            if (s.live) {
                const float cn = mx(s.c * s.D * s.wp, s.D * s.wa);
                s.D = s.D * scale_of(cn);
            }
            RUIZ_UNROLL
            for (int k = 0; k < 2; ++k)
                if (j + WARP * k < m)
                    s.e[k] = s.e[k] * scale_of(s.e[k] * s.war[k]);
        });
        // cost scaling against the new D
        ex.lanes([&](int, Lane& s) {
            float wp = 0.0f;
            RUIZ_UNROLL
            for (int i = 0; i < WARP_N; ++i)
                if (i < n) wp = mx(wp, fabsf(s.p[i]) * ex.from(s, i, D_of));
            s.wp = wp;
            s.pcol = s.live ? s.c * s.D * wp : 0.0f;
            s.qd = s.live ? fabsf(s.q) * s.D : 0.0f;
        });
        ex.lanes([&](int, Lane& s) {
            const float sum =
                ex.sum_of(s, n, [](const Lane& t) { return t.pcol; });
            const float qmax =
                ex.max_of(s, [](const Lane& t) { return t.qd; });
            s.c = cost_scale(s.c, sum, qmax, n);
        });
    }

    // the scaled problem, row by row
    float* Pb = a.out[O_P] + b * (long long)n * n;
    float* Ab = a.out[O_A] + b * (long long)m * n;
    const float* l = a.in[I_L] + b * a.stride[I_L];
    const float* u = a.in[I_U] + b * a.stride[I_U];
    ex.lanes([&](int j, Lane& s) {
        RUIZ_UNROLL
        for (int i = 0; i < WARP_N; ++i)
            if (i < n) {
                const float Di = ex.from(s, i, D_of);
                if (s.live)
                    Pb[(long long)i * n + j] = s.c * Di * s.p[i] * s.D;
            }
        RUIZ_UNROLL
        for (int i = 0; i < WARP_M; ++i)
            if (i < m) {
                const float Ei = ex.from(s, i & (WARP - 1),
                                         [i](const Lane& t) {
                                             return t.e[i >> 5];
                                         });
                if (s.live) Ab[(long long)i * n + j] = Ei * s.a[i] * s.D;
            }
        if (s.live) {
            a.out[O_Q][b * n + j] = s.c * s.D * s.q;
            a.out[O_D][b * n + j] = s.D;
        }
        RUIZ_UNROLL
        for (int k = 0; k < 2; ++k) {
            const int i = j + WARP * k;
            if (i < m) {
                a.out[O_L][b * m + i] = l[i] <= -INF ? l[i] : s.e[k] * l[i];
                a.out[O_U][b * m + i] = u[i] >= INF ? u[i] : s.e[k] * u[i];
                a.out[O_E][b * m + i] = s.e[k];
            }
        }
        if (j == 0) a.out[O_C][b] = s.c;
    });
}

// ------------------------------------------------------------- host twins

#if !defined(__CUDA_ARCH__)
// The cluster's ranks in turn, each stage of each rank's units one after
// another; a send lands in every rank's memory at once (a stage never
// reads what the same stage sends: see equilibrate_cluster).
struct HostCluster {
    int C = 1;
    Rank rank[MAX_CLUSTER];

    template <class F>
    void each_rank(F f)
    {
        for (int r = 0; r < C; ++r) f(rank[r]);
    }
    template <class F>
    void units(int count, F f)
    {
        for (int u = 0; u < count; ++u) f(u);
    }
    void sync() {}
    void cluster_sync() {}
    void exchange(int, int, unsigned) {}
    // lane `jc` of a warp offers v for row i: the warp's max reaches *dst
    void row_max(float* dst, float v, int /*jc*/) { *dst = mx(*dst, v); }
    void atomic_max(float* dst, float v) { *dst = mx(*dst, v); }
    // v into the copies of dst[0, 4) in every rank's memory
    void send4_all(const Rank& k, float* dst, F4 v, int /*bar*/)
    {
        const long long at = dst - k.s;
        for (int r = 0; r < C; ++r) {
            float* d = rank[r].s + at;
            d[0] = v.x;
            d[1] = v.y;
            d[2] = v.z;
            d[3] = v.w;
        }
    }
    void load_rows(float* dst, int ld, const float* src, int src_ld,
                   int rows, int cols)
    {
        for (int i = 0; i < rows; ++i)
            for (int j = 0; j < cols; ++j)
                dst[(long long)i * ld + j] = src[(long long)i * src_ld + j];
    }
    void wait_rows() {}
    void store_rows(float* dst, int dst_ld, const float* src, int ld,
                    int rows, int cols)
    {
        for (int i = 0; i < rows; ++i)
            for (int j = 0; j < cols; ++j)
                dst[(long long)i * dst_ld + j] = src[(long long)i * ld + j];
    }
    // tree_sum of v and the maximum of q
    void sum_and_max(const float* v, const float* q, int n, float*,
                     float& sum, float& qmax)
    {
        sum = ruiz::tree_sum(v, n);
        qmax = 0.0f;
        for (int j = 0; j < n; ++j) qmax = mx(qmax, q[j]);
    }
};

// The 32 lanes one after another in each phase; `from`, `max_of` and
// `sum_of` read the other lanes' registers.
struct HostWarp {
    Lane lane[WARP];
    float tile[WARP_TILE];

    void put(int i, int j, float v) { tile[i * TILE_LD + j] = v; }
    float row_max(int i, int n)
    {
        float r = 0.0f;
        for (int j = 0; j < n; ++j) r = mx(r, tile[i * TILE_LD + j]);
        return r;
    }
    void sync_lanes() {}

    template <class F>
    void lanes(F f)
    {
        for (int j = 0; j < WARP; ++j) f(j, lane[j]);
    }
    template <class G>
    float from(const Lane&, int src, G g) { return g(lane[src]); }
    template <class G>
    float max_of(const Lane&, G g)
    {
        float r = g(lane[0]);
        for (int j = 1; j < WARP; ++j) r = mx(r, g(lane[j]));
        return r;
    }
    template <class G>
    float sum_of(const Lane&, int n, G g)
    {
        float v[WARP];
        for (int j = 0; j < WARP; ++j) v[j] = g(lane[j]);
        return ruiz::tree_sum(v, n);
    }
};
#endif

}  // namespace ruiz
