// The per-scenario bodies of the solve-tail kernels (solve_tail.cu): three
// stages of qp/admm.py around the ADMM iterations, each the function of a
// plain PyTorch chain there.
//
//   kkt_blocks  (K, rho_vec) = (P + sigma I + A' diag(rho_vec) A, rho_vec),
//               rho_vec = (1 + eqf (rho_eq_scale - 1)) rho_s, for an A that
//               its caller DECLARES block diagonal: equal r x c blocks
//               tiling (m, n), block k at rows [k r, k r + r) and columns
//               [k c, k c + c) (the MPC's 5 x 3 friction pyramids,
//               mpc/srb.py::MPC_A_BLOCKS).  So A' diag(rho) A is block
//               diagonal with c x c blocks, and every entry of K outside
//               them is P's (plus sigma on the diagonal, which lies inside).
//               qp/admm.py::_run_block's dense chain (one torch.bmm over
//               all m rows) is its plain version.
//   adapt_rho   the per-scenario rho of the next adapt round from the
//               scaled problem and the iterate (qp/admm.py::_adapt_rho):
//               rp = |Ax - z| / max(|Ax|, |z|), rd = |Px + q + A'y| /
//               max(|Px|, |q|, |A'y|) (inf-norms, denominators clamped to
//               1e-12), rho_s sqrt(rp / max(rd, 1e-12)) clamped to
//               [1e-3, 1e3].  A dense, or block diagonal as declared.
//   unscale     the solve's epilogue (qp/admm.py::_unscaled_solution): x = D
//               xs, y = (E ys) / c, z = clip(A0 x, l0, u0), prim = |A0 x -
//               z|, dual = |P0 x + q0 + A0' y|, ok = x finite and prim <
//               status_tol.  A0 dense, or block diagonal as declared.
//
// Plain C++ marked TAIL_FN (`__host__ __device__` under nvcc), run in
// phases over units (`TAIL_UNITS`) with `ex.sync()` between phases: on the
// card (solve_tail.cu) a block's threads take the units in turn (one
// block a scenario for adapt_rho and unscale; kkt_blocks is one phase of
// independent entries over the whole batch); on the host (HostExec) one
// thread runs every unit, in order or reversed, so the CPU tests build
// this arithmetic with g++ (tests/test_torch_solve_tail_kernels.py).  A
// unit never reads what another unit writes in its own phase.
//
// Bits.  The library is built with -fmad=false: every product and sum
// rounds as PyTorch's elementwise ops round them.  So rho_vec, x and y are
// the plain versions' bit for bit (the same ops in the same order), and
// K's entries outside the blocks are P's bits.  The dot products (a
// block's r terms, a row of P) are sums in a fixed order where the plain
// versions call cuBLAS: K's blocks, z, prim and dual are held to them
// within a tolerance.  adapt_rho sums in double (see there): its rho is
// held to the plain version within the rounding that the residuals'
// cancellation allows the float32 chain.  The maxima are taken
// NaN-propagating, as torch.amax.
//
// Operands: each input a first row plus the stride between two
// scenarios' rows in elements (0 for one row shared by every scenario, as
// the MPC's constant A), a row's own elements contiguous; each output
// contiguous (B, ...); ok one byte a scenario.

#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define TAIL_FN __host__ __device__ __forceinline__
#else
#define TAIL_FN inline
#endif

// the units of a phase: on the card this thread's, on the host all of them
#define TAIL_UNITS(ex, u, count)                                            \
    for (long long u = (ex).first(count); u >= 0 && u < (count);            \
         u = (ex).next(u))

namespace tail {

constexpr int PARTS = 32;       // partial maxima a quantity, one a unit
constexpr int MAXIMA = 7;       // adapt_rho's seven inf-norms
constexpr int MAX_LANES = 32;   // units (partial sums) a row of P at most
constexpr int KKT_RUN = 4;      // kkt_blocks: consecutive entries a unit

// ---- operands, in the order of the launchers' arrays
enum KktIn { KI_P, KI_A, KI_EQF, KI_RHO_S, KI_COUNT };
enum KktOut { KO_K, KO_RHO_VEC, KO_COUNT };
// sigma; rho_eq_scale - 1 (as the plain version's Python number)
enum KktPar { KP_SIGMA, KP_EQ_M1, KP_COUNT };
enum AdaptIn { AI_P, AI_Q, AI_A, AI_X, AI_Z, AI_Y, AI_RHO_S, AI_COUNT };
enum AdaptOut { AO_RHO_S, AO_COUNT };
enum UnIn { UI_P, UI_Q, UI_A, UI_L, UI_U, UI_XS, UI_YS, UI_D, UI_E, UI_C,
            UI_COUNT };
enum UnOut { UO_X, UO_Y, UO_Z, UO_PRIM, UO_DUAL, UO_OK, UO_COUNT };
enum UnPar { UP_STATUS_TOL, UP_COUNT };

// inputs, outputs, parameters of the three stages, the partial maxima,
// the partial sums a row (qp/tail.py::LAYOUT; -1 past the end)
inline int layout(int what)
{
    const int counts[] = {KI_COUNT, KO_COUNT, KP_COUNT, AI_COUNT, AO_COUNT,
                          UI_COUNT, UO_COUNT, UP_COUNT, PARTS, MAX_LANES};
    return what >= 0 && what < (int)(sizeof(counts) / sizeof(int))
               ? counts[what] : -1;
}

// values of a scenario's shared memory (adapt_rho: doubles; unscale: T):
// x (n), y (m), two m-vectors (A x; A x - z), two n-vectors (P x, A' y),
// the partial maxima and the `lanes` partial sums of each of P's rows and,
// when A is dense (`dense` 1), of A's rows
TAIL_FN long long smem_values(int n, int m, int dense, int lanes)
{
    return 3LL * n + 3LL * m + (long long)MAXIMA * PARTS
           + (long long)lanes * (n + (dense ? m : 0));
}

// A's structure: r x c blocks tiling (m, n), or dense (r = c = 0); the
// units a row of P (and of a dense A) is split over (1 or MAX_LANES)
struct Shape {
    int n, m, r, c, lanes;
    TAIL_FN bool blocks() const { return r > 0; }
};

template <typename T, int NI, int NO, int NP>
struct Args {
    const T* in[NI];
    long long stride[NI];
    T* out[NO];
    unsigned char* ok;      // unscale's ok (bytes); null elsewhere
    T par[NP > 0 ? NP : 1];

    TAIL_FN const T* row(int k, long long b) const
    {
        return in[k] + b * stride[k];
    }
};

template <typename T> using KktArgs = Args<T, KI_COUNT, KO_COUNT, KP_COUNT>;
template <typename T> using AdaptArgs = Args<T, AI_COUNT, AO_COUNT, 0>;
template <typename T> using UnArgs = Args<T, UI_COUNT, UO_COUNT - 1, UP_COUNT>;

// the launchers' arrays into Args (unscale's ok, its last output, is set
// by its launcher)
template <typename T, int NI, int NO, int NP>
inline void fill(Args<T, NI, NO, NP>& a, const void* const* in,
                 const long long* stride, void* const* out,
                 const double* par)
{
    for (int k = 0; k < NI; ++k) {
        a.in[k] = static_cast<const T*>(in[k]);
        a.stride[k] = stride[k];
    }
    for (int k = 0; k < NO; ++k) a.out[k] = static_cast<T*>(out[k]);
    a.ok = nullptr;
    for (int k = 0; k < NP; ++k) a.par[k] = (T)par[k];
}

// |v| and a NaN-propagating maximum (torch.amax, torch.maximum)
TAIL_FN float t_abs(float v) { return fabsf(v); }
TAIL_FN double t_abs(double v) { return fabs(v); }
TAIL_FN float t_sqrt(float v) { return sqrtf(v); }
TAIL_FN double t_sqrt(double v) { return sqrt(v); }
TAIL_FN bool t_finite(float v) { return isfinite(v); }
TAIL_FN bool t_finite(double v) { return isfinite(v); }
template <typename T>
TAIL_FN T nanmax(T a, T b)
{
    return (a != a || a > b) ? a : b;
}
template <typename T>
TAIL_FN T nanmin(T a, T b)
{
    return (a != a || a < b) ? a : b;
}

// ---- kkt_blocks: K's B n n entries in runs of KKT_RUN, then rho_vec's B m

template <typename T>
TAIL_FN T rho_of(const KktArgs<T>& a, long long b, int k)
{
    // (1 + eqf (s - 1)) rho_s, the plain version's three rounded ops
    const T t = T(1) + a.row(KI_EQF, b)[k] * a.par[KP_EQ_M1];
    return t * a.row(KI_RHO_S, b)[0];
}

// K[b, i, j]: the block's r terms in order, then P's entry, then sigma on
// the diagonal (the plain version's sum, then `+= P`, then the diagonal)
template <typename T>
TAIL_FN T kkt_value(const KktArgs<T>& a, const Shape& s, long long b, int i,
                    int j)
{
    const T* P = a.row(KI_P, b);
    T v = T(0);
    if (i / s.c == j / s.c) {
        const T* A = a.row(KI_A, b);
        const int k0 = (i / s.c) * s.r;
        for (int kk = 0; kk < s.r; ++kk) {
            const int k = k0 + kk;
            const T t = A[(long long)k * s.n + i] * rho_of(a, b, k);
            v = v + t * A[(long long)k * s.n + j];
        }
    }
    v = v + P[(long long)i * s.n + j];
    if (i == j) v = v + a.par[KP_SIGMA];
    return v;
}

// a unit is KKT_RUN consecutive entries of K over the batch (the last one
// may be shorter), then rho_vec's entries one a unit: a thread keeps
// KKT_RUN loads of P in flight
template <typename T, class Exec>
TAIL_FN void kkt_blocks(const Exec& ex, const KktArgs<T>& a, const Shape& s,
                        long long B)
{
    const long long nn = (long long)s.n * s.n, nK = B * nn;
    const long long runs = (nK + KKT_RUN - 1) / KKT_RUN;
    TAIL_UNITS(ex, u, runs + B * s.m) {
        if (u < runs) {
            const long long e0 = u * KKT_RUN;
            long long b = e0 / nn;
            int i = (int)((e0 % nn) / s.n), j = (int)(e0 % s.n);
            T v[KKT_RUN];
            for (int t = 0; t < KKT_RUN; ++t) {
                v[t] = e0 + t < nK ? kkt_value(a, s, b, i, j) : T(0);
                if (++j == s.n) {
                    j = 0;
                    if (++i == s.n) {
                        i = 0;
                        ++b;
                    }
                }
            }
            for (int t = 0; t < KKT_RUN; ++t)
                if (e0 + t < nK) a.out[KO_K][e0 + t] = v[t];
        } else {
            const long long f = u - runs;
            a.out[KO_RHO_VEC][f] = rho_of(a, f / s.m, (int)(f % s.m));
        }
    }
}

// ---- the dot products of one scenario (adapt_rho and unscale)
//
// A row of P (and of a dense A) is L units (s.lanes, 1 or MAX_LANES, a
// template constant): unit (row, l) sums the terms j = l, l + L, ... in
// order into its partial, so that a warp's units read one row's
// consecutive entries (L = 32, long rows; a unit a row for short ones,
// L = 1); the next phase sums a row's partials in order.  A block row of A (c terms) and a column of A'
// (a column block's r rows, or all m) are one unit each.

// The products are taken in the accumulator type V (the value type of the
// scenario's shared memory): T for unscale, double for adapt_rho.

// (A x)_k over row k's block columns
template <typename V, typename T>
TAIL_FN V a_block_row_dot(const T* A, const Shape& s, int k, const V* x)
{
    const int j0 = (k / s.r) * s.c;
    V v = V(0);
    for (int j = j0; j < j0 + s.c; ++j)
        v = v + V(A[(long long)k * s.n + j]) * x[j];
    return v;
}

// (A' y)_j: over column j's block rows, or all m
template <typename V, typename T>
TAIL_FN V a_col_dot(const T* A, const Shape& s, int j, const V* y)
{
    const int k0 = s.blocks() ? (j / s.c) * s.r : 0;
    const int k1 = s.blocks() ? k0 + s.r : s.m;
    V v = V(0);
    for (int k = k0; k < k1; ++k)
        v = v + V(A[(long long)k * s.n + j]) * y[k];
    return v;
}

// lane l's partial of row `row` of M (n columns) against x
template <int L, typename V, typename T>
TAIL_FN V lane_partial(const T* M, int n, int row, int l, const V* x)
{
    V v = V(0);
    for (int j = l; j < n; j += L)
        v = v + V(M[(long long)row * n + j]) * x[j];
    return v;
}

template <int L, typename V>
TAIL_FN V sum_lanes(const V* part)
{
    V v = part[0];
    for (int l = 1; l < L; ++l) v = v + part[l];
    return v;
}

// shared memory of a scenario
template <typename T>
struct Smem {
    T* x;      // n
    T* y;      // m
    T* ax;     // m: A x
    T* dz;     // m: A x - z
    T* px;     // n: P x
    T* aty;    // n: A' y
    T* part;   // MAXIMA x PARTS
    T* lanes;  // (n + dense rows of A) x s.lanes
    TAIL_FN Smem(T* base, int n, int m)
        : x(base), y(x + n), ax(y + m), dz(ax + m), px(dz + m), aty(px + n),
          part(aty + n), lanes(part + MAXIMA * PARTS)
    {
    }
};

// rows of the lane-split products: P's n, and A's m when A is dense
TAIL_FN int split_rows(const Shape& s) { return s.n + (s.blocks() ? 0 : s.m); }

// phase of the products: lane partials of P's rows (and a dense A's), the
// block rows of A, the columns of A'
template <int L, typename V, typename T, class Exec>
TAIL_FN void products(const Exec& ex, const Shape& s, const T* P,
                      const T* A, Smem<V>& S)
{
    const int n = s.n, m = s.m;
    const long long split = (long long)split_rows(s) * L;
    const long long rows = s.blocks() ? m : 0;
    TAIL_UNITS(ex, u, split + rows + n) {
        if (u < split) {
            const int row = (int)(u / L), l = (int)(u % L);
            S.lanes[u] = row < n ? lane_partial<L>(P, n, row, l, S.x)
                                 : lane_partial<L>(A, n, row - n, l, S.x);
        } else if (u < split + rows) {
            const int k = (int)(u - split);
            S.ax[k] = a_block_row_dot(A, s, k, S.x);
        } else {
            const int j = (int)(u - split - rows);
            S.aty[j] = a_col_dot(A, s, j, S.y);
        }
    }
}

// max in V over the entries e = p, p + PARTS, ... of v(e),
// NaN-propagating, from 0 (every quantity is an absolute value)
#define TAIL_PART_MAX(V, p, count, expr)                                    \
    [&]() {                                                                 \
        V acc = V(0);                                                       \
        for (int e = (int)(p); e < (count); e += PARTS)                     \
            acc = nanmax(acc, (expr));                                      \
        return acc;                                                         \
    }()

template <typename V>
TAIL_FN V max_parts(const V* part)
{
    V v = part[0];
    for (int p = 1; p < PARTS; ++p) v = nanmax(v, part[p]);
    return v;
}

// ---- adapt_rho: one scenario b
//
// In double whatever T is: the dual residual's numerator cancels (on the
// MPC's QP the swing forces' ridge makes |P x| up to 1e6 times the
// residual), so float32 sums in any order leave rho a few percent from
// the function's value; summed in double from the float32 inputs and
// rounded once, rho is that value to T's rounding.

template <int L, typename T, class Exec>
TAIL_FN void adapt_rho_body(const Exec& ex, const AdaptArgs<T>& a,
                            const Shape& s, long long b, double* smem)
{
    using D = double;
    const int n = s.n, m = s.m;
    Smem<D> S(smem, n, m);
    const T* P = a.row(AI_P, b);
    const T* q = a.row(AI_Q, b);
    const T* A = a.row(AI_A, b);
    const T* z = a.row(AI_Z, b);
    TAIL_UNITS(ex, u, n + m) {
        if (u < n) S.x[u] = D(a.row(AI_X, b)[u]);
        else S.y[u - n] = D(a.row(AI_Y, b)[u - n]);
    }
    ex.sync();
    products<L>(ex, s, P, A, S);
    ex.sync();
    TAIL_UNITS(ex, u, split_rows(s)) {
        if (u < n) S.px[u] = sum_lanes<L>(S.lanes + u * L);
        else S.ax[u - n] = sum_lanes<L>(S.lanes + u * L);
    }
    ex.sync();
    // the seven inf-norms, PARTS units each
    TAIL_UNITS(ex, u, MAXIMA * PARTS) {
        const int w = (int)u / PARTS, p = (int)u % PARTS;
        D v;
        switch (w) {
        case 0: v = TAIL_PART_MAX(D, p, m, t_abs(S.ax[e] - D(z[e]))); break;
        case 1: v = TAIL_PART_MAX(D, p, m, t_abs(S.ax[e])); break;
        case 2: v = TAIL_PART_MAX(D, p, m, t_abs(D(z[e]))); break;
        case 3:
            v = TAIL_PART_MAX(D, p, n,
                              t_abs((S.px[e] + D(q[e])) + S.aty[e]));
            break;
        case 4: v = TAIL_PART_MAX(D, p, n, t_abs(S.px[e])); break;
        case 5: v = TAIL_PART_MAX(D, p, n, t_abs(D(q[e]))); break;
        default: v = TAIL_PART_MAX(D, p, n, t_abs(S.aty[e])); break;
        }
        S.part[u] = v;
    }
    ex.sync();
    TAIL_UNITS(ex, u, 1) {
        D mx[MAXIMA];
        for (int w = 0; w < MAXIMA; ++w) mx[w] = max_parts(S.part + w * PARTS);
        const D tiny = D(T(1e-12));
        const D rp = mx[0] / nanmax(nanmax(mx[1], mx[2]), tiny);
        const D rd = mx[3] / nanmax(nanmax(mx[4], nanmax(mx[5], mx[6])),
                                    tiny);
        const D r = D(a.row(AI_RHO_S, b)[0]) * t_sqrt(rp / nanmax(rd, tiny));
        a.out[AO_RHO_S][b] = T(nanmin(nanmax(r, D(T(1e-3))), D(T(1e3))));
    }
}

// ---- unscale: one scenario b

template <int L, typename T, class Exec>
TAIL_FN void unscale_body(const Exec& ex, const UnArgs<T>& a, const Shape& s,
                          long long b, T* smem)
{
    const int n = s.n, m = s.m;
    Smem<T> S(smem, n, m);
    const T* P = a.row(UI_P, b);
    const T* q = a.row(UI_Q, b);
    const T* A = a.row(UI_A, b);
    TAIL_UNITS(ex, u, n + m) {
        if (u < n) {
            const T x = a.row(UI_D, b)[u] * a.row(UI_XS, b)[u];
            S.x[u] = x;
            a.out[UO_X][b * n + u] = x;
        } else {
            const int k = (int)u - n;
            const T y = (a.row(UI_E, b)[k] * a.row(UI_YS, b)[k])
                        / a.row(UI_C, b)[0];
            S.y[k] = y;
            a.out[UO_Y][b * m + k] = y;
        }
    }
    ex.sync();
    products<L>(ex, s, P, A, S);
    ex.sync();
    // P x; A x of a dense A; z = clip(A x, l, u) and A x - z
    TAIL_UNITS(ex, u, n + m) {
        if (u < n) {
            S.px[u] = sum_lanes<L>(S.lanes + u * L);
        } else {
            const int k = (int)u - n;
            const T ax = s.blocks() ? S.ax[k] : sum_lanes<L>(S.lanes + u * L);
            const T zu = nanmin(nanmax(ax, a.row(UI_L, b)[k]),
                                a.row(UI_U, b)[k]);
            a.out[UO_Z][b * m + k] = zu;
            S.dz[k] = ax - zu;
        }
    }
    ex.sync();
    // prim, dual and x's finiteness (1 where finite), PARTS units each
    TAIL_UNITS(ex, u, 3 * PARTS) {
        const int w = (int)u / PARTS, p = (int)u % PARTS;
        T v;
        if (w == 0) {
            v = TAIL_PART_MAX(T, p, m, t_abs(S.dz[e]));
        } else if (w == 1) {
            v = TAIL_PART_MAX(T, p, n, t_abs((S.px[e] + q[e]) + S.aty[e]));
        } else {
            v = T(1);
            for (int e = p; e < n; e += PARTS)
                if (!t_finite(S.x[e])) v = T(0);
        }
        S.part[u] = v;
    }
    ex.sync();
    TAIL_UNITS(ex, u, 1) {
        const T prim = max_parts(S.part);
        const T dual = max_parts(S.part + PARTS);
        bool finite = true;
        for (int p = 0; p < PARTS; ++p) finite &= S.part[2 * PARTS + p] > T(0);
        a.out[UO_PRIM][b] = prim;
        a.out[UO_DUAL][b] = dual;
        a.ok[b] = finite && prim < a.par[UP_STATUS_TOL] ? 1 : 0;
    }
}

// the two row splits a layout takes (qp/tail.py::tail_layout): a unit a
// row (lanes 1) or MAX_LANES units a row, each a compile-time constant
template <typename T, class Exec>
TAIL_FN void adapt_rho(const Exec& ex, const AdaptArgs<T>& a, const Shape& s,
                       long long b, double* smem)
{
    if (s.lanes == MAX_LANES) adapt_rho_body<MAX_LANES>(ex, a, s, b, smem);
    else adapt_rho_body<1>(ex, a, s, b, smem);
}

template <typename T, class Exec>
TAIL_FN void unscale(const Exec& ex, const UnArgs<T>& a, const Shape& s,
                     long long b, T* smem)
{
    if (s.lanes == MAX_LANES) unscale_body<MAX_LANES>(ex, a, s, b, smem);
    else unscale_body<1>(ex, a, s, b, smem);
}

#if !defined(__CUDA_ARCH__)
// the host executor: one thread runs every unit of a phase, in order or
// reversed
struct HostExec {
    bool reverse;

    long long first(long long n) const { return reverse ? n - 1 : 0; }
    long long next(long long u) const { return reverse ? u - 1 : u + 1; }
    void sync() const {}
};
#endif

}  // namespace tail
