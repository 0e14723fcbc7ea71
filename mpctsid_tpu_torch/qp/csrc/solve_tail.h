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
// phases over units (`TAIL_UNITS`) with `ex.sync()` between phases, or
// over a warp's lanes (`ex.lanes`).  On the card (solve_tail.cu) a block's
// threads, or a warp's lanes, take the units; on the host (HostExec,
// HostWarp) one thread runs every unit or lane, in order or reversed, so
// the CPU tests build this arithmetic with g++
// (tests/test_torch_solve_tail_*.py).  A unit never reads what another
// unit writes in its own phase.  The designs:
//
//   kkt_blocks  a block a TILE of one scenario's K (`kkt_tile`: a run of
//               consecutive entries, P's rows being contiguous): the rows
//               of rho_vec the tile owns and the c x c block entries it
//               meets are formed once, the entries in shared memory
//               (`kkt_setup`), then the tile streams from P to K in pieces
//               of V values (16 bytes on the card), each piece patched
//               where it meets a diagonal block (`kkt_piece`).
//   adapt_rho   the epilogue's two paths (qp/tail.py::adapt_layout), its
//               sums in double: a WARP a scenario where n and m are at most
//               WARP_DIM (`adapt_warp_rows`: lane i the rows i, i + 32 of
//               P x and A x and the columns i, i + 32 of A' y, each in index
//               order), else a BLOCK a scenario (`adapt_block`: warps
//               streaming ADAPT_ROW_GROUP rows of P, lane l the terms j =
//               l, l + 32, ..., the 32 partials summed in order); the seven
//               inf-norms by the executor's maxima (shuffle trees).
//   unscale     two paths (qp/tail.py::tail_layout): a WARP a scenario
//               where n and m are at most WARP_DIM (`unscale_warp_rows`: P
//               and a dense A in the warp's shared memory, by bulk copy
//               into one of two slots or staged by the lanes, lane i the
//               rows i, i + 32, maxima by the executor's `max_of`), else a
//               BLOCK a scenario (`unscale_block`: each warp streams
//               ROW_GROUP rows of P at once, lane l the terms j = l, l + 32,
//               ..., then the 32 partials summed in order).
//
// Bits.  The library is built with -fmad=false: every product and sum
// rounds as PyTorch's elementwise ops round them.  So rho_vec, x and y are
// the plain versions' bit for bit (the same ops in the same order), and
// K's entries outside the blocks are 0 + P.  The dot products (a block's r
// terms, a row of P) are sums in a fixed order where the plain versions
// call cuBLAS: K's blocks, z, prim and dual are held to them within a
// tolerance, and bit for bit to the same order written out elementwise
// (tests/test_torch_solve_tail_redesign.py, chip_smoke.py phase 3i).
// adapt_rho sums in double (see there): its rho is held to the plain
// version within the rounding that the residuals' cancellation allows the
// float32 chain.  The maxima are taken NaN-propagating, as torch.amax, in
// any order with the same result.
//
// Operands: each input a first row plus the stride between two
// scenarios' rows in elements (0 for one row shared by every scenario, as
// the MPC's constant A), a row's own elements contiguous; each output
// contiguous (B, ...); ok one byte a scenario.

#pragma once

#include <math.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define TAIL_FN __host__ __device__ __forceinline__
#define TAIL_UNROLL _Pragma("unroll")
#define TAIL_UNROLL8 _Pragma("unroll 8")
#else
#define TAIL_FN inline
#define TAIL_UNROLL
#define TAIL_UNROLL8
#endif

// the units of a phase: on the card this thread's, on the host all of them
#define TAIL_UNITS(ex, u, count)                                            \
    for (long long u = (ex).first(count); u >= 0 && u < (count);            \
         u = (ex).next(u))

namespace tail {

constexpr int PARTS = 32;       // partial maxima a quantity, one a unit
constexpr int MAXIMA = 7;       // adapt_rho's seven inf-norms
constexpr int MAX_LANES = 32;   // units (partial sums) a row of P at most
constexpr int KKT_PIECES = 8;   // kkt_blocks: pieces of a tile a thread
constexpr int WARP = 32;
constexpr int WARP_DIM = 64;    // the warp paths: n, m at most this
constexpr int MAX_WARPS = 16;   // ... and scenarios a block at most
constexpr int ROW_GROUP = 2;    // unscale's block path: rows a warp streams
constexpr int ADAPT_ROW_GROUP = 4;  // ... adapt_rho's
constexpr int STREAM_NQ = 6;    // ... with n = 32 STREAM_NQ unrolled whole
constexpr int STAGE = 20;       // unscale's one-slot warp path: values a
                                // lane loads before it stores them

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
// the partial sums a row, then the constants of the layouts
// (qp/tail.py::LAYOUT; -1 past the end)
inline int layout(int what)
{
    const int counts[] = {KI_COUNT, KO_COUNT, KP_COUNT, AI_COUNT, AO_COUNT,
                          UI_COUNT, UO_COUNT, UP_COUNT, PARTS, MAX_LANES,
                          KKT_PIECES, WARP_DIM, MAX_WARPS};
    return what >= 0 && what < (int)(sizeof(counts) / sizeof(int))
               ? counts[what] : -1;
}

// A's structure: r x c blocks tiling (m, n), or dense (r = c = 0);
// `lanes` the path's (qp/tail.py's layouts: kkt_blocks' values a piece;
// adapt_rho's and unscale's warp path its slots, 1 or 2, their block path
// MAX_LANES)
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

// ---- kkt_blocks: a block a tile of one scenario's K
//
// A scenario's n^2 entries are cut into tiles of `tile` consecutive
// entries (a block's threads x KKT_PIECES pieces of V values; a scenario's
// last tile may be shorter).  A tile meets the rows i0..i1 and their
// groups g0..g1 (row i's diagonal block is group i / c: columns [g c,
// g c + c), A's rows [g r, g r + r)).

struct KktTile {
    int e0, e1;     // the tile's entries [e0, e1) of the scenario's K
    int i0, i1;     // the rows it meets
    int g0, g1;     // their groups
};

TAIL_FN int kkt_tiles(int n, int tile) { return (n * n + tile - 1) / tile; }

TAIL_FN KktTile kkt_tile(const Shape& s, int tile, int t)
{
    KktTile tl;
    tl.e0 = t * tile;
    tl.e1 = s.n * s.n - tl.e0 < tile ? s.n * s.n : tl.e0 + tile;
    tl.i0 = tl.e0 / s.n;
    tl.i1 = (tl.e1 - 1) / s.n;
    tl.g0 = tl.i0 / s.c;
    tl.g1 = tl.i1 / s.c;
    return tl;
}

// values of a tile's shared memory, over every tile of `tile` entries:
// the c block entries of each row it meets
TAIL_FN long long kkt_smem_values(int n, int c, int tile)
{
    const int len = tile < n * n ? tile : n * n;
    const int rows = (len - 1) / n + 2;
    return (long long)(rows < n ? rows : n) * c;
}

// bytes of a block's shared memory: the block entries and, on the card's
// aligned path (`bulk`), the tile itself after a 16-byte barrier
TAIL_FN long long kkt_smem_bytes(int n, int c, int tile, int bulk, int size)
{
    return (bulk ? 16LL + (long long)tile * size : 0LL)
           + kkt_smem_values(n, c, tile) * size;
}

template <typename T>
TAIL_FN T rho_of(const KktArgs<T>& a, long long b, int k)
{
    // (1 + eqf (s - 1)) rho_s, the plain version's three rounded ops
    const T t = T(1) + a.row(KI_EQF, b)[k] * a.par[KP_EQ_M1];
    return t * a.row(KI_RHO_S, b)[0];
}

// the tile's setup, one phase: rho_vec's rows of the groups met (each
// written out by the one tile that holds its group's first diagonal
// entry), and each met row's c block entries: the r terms (A[k, i] rho_k)
// A[k, j] in order of k from 0 (the plain version's sum; `+ P` and sigma
// come in `kkt_piece`), rho_k formed where it is used, so that every load
// of the phase is issued at once
template <typename T, class Exec>
TAIL_FN void kkt_setup(const Exec& ex, const KktArgs<T>& a, const Shape& s,
                       long long b, const KktTile& tl, T* blk)
{
    const int n = s.n, r = s.r, c = s.c;
    const long long rho_units = (long long)(tl.g1 - tl.g0 + 1) * r;
    const T* A = a.row(KI_A, b);
    TAIL_UNITS(ex, u, rho_units + (long long)(tl.i1 - tl.i0 + 1) * c) {
        if (u < rho_units) {
            const int k = tl.g0 * r + (int)u;
            const int anchor = (k / r) * c * (n + 1);
            if (anchor >= tl.e0 && anchor < tl.e1)
                a.out[KO_RHO_VEC][b * s.m + k] = rho_of(a, b, k);
            continue;
        }
        const int w = (int)(u - rho_units);
        const int i = tl.i0 + w / c, g = i / c;
        const int j = g * c + w % c;
        T v = T(0);
        for (int kk = 0; kk < r; ++kk) {
            const int k = g * r + kk;
            const T t = A[(long long)k * n + i] * rho_of(a, b, k);
            v = v + t * A[(long long)k * n + j];
        }
        blk[w] = v;
    }
    ex.sync();
}

// the piece of V entries at `e` (of the scenario's K, within one row), v
// holding P's values there: K = (block entry or 0) + P, then + sigma on
// the diagonal (the plain version's `+= P`, then the diagonal)
template <int V, typename T>
TAIL_FN void kkt_piece(const KktArgs<T>& a, const Shape& s,
                       const KktTile& tl, const T* smem, int e, T* v)
{
    const int i = e / s.n, j = e - i * s.n;
    const int jb = (i / s.c) * s.c;
    const T* blk = smem + (i - tl.i0) * s.c;
    TAIL_UNROLL
    for (int t = 0; t < V; ++t) {
        const int jj = j + t - jb;
        const bool in = jj >= 0 && jj < s.c;
        const T add = in ? blk[in ? jj : 0] : T(0);
        v[t] = add + v[t];
        if (j + t == i) v[t] = v[t] + a.par[KP_SIGMA];
    }
}

// what the launcher and the host build refuse: a piece of V values that
// straddles rows, a tile that is no whole number of pieces, a grid that
// is not B times the tiles
TAIL_FN bool kkt_bad(int B, const Shape& s, int threads, int blocks, int V)
{
    if (!s.blocks() || V < 1 || s.n % V != 0) return true;
    return (long long)blocks
           != (long long)B * kkt_tiles(s.n, threads * KKT_PIECES * V);
}

// ---- the dot products of one scenario (adapt_rho and unscale)
//
// A block row of A (c terms) and a column of A' (a column block's r rows,
// or all m) are one unit each, summed in index order.  The products are
// taken in the accumulator type V (the value type of the scenario's
// shared memory): T for unscale, double for adapt_rho.

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

// shared memory of a scenario
template <typename T>
struct Smem {
    T* x;      // n
    T* y;      // m
    T* ax;     // m: A x
    T* dz;     // m: A x - z (unscale), z (adapt_rho)
    T* px;     // n: P x
    T* aty;    // n: A' y
    T* part;   // MAXIMA x PARTS: unscale's partial maxima; adapt_rho's
               // block path: a warp's seven maxima (at most 32 warps)
    T* lanes;  // MAX_LANES x (P's rows, a dense A's, + 1), transposed
    TAIL_FN Smem(T* base, int n, int m)
        : x(base), y(x + n), ax(y + m), dz(ax + m), px(dz + m), aty(px + n),
          part(aty + n), lanes(part + MAXIMA * PARTS)
    {
    }
};

// rows whose products are split over a warp's lanes on the block paths:
// P's n, and A's m when A is dense
TAIL_FN int split_rows(const Shape& s) { return s.n + (s.blocks() ? 0 : s.m); }

// max in V over the entries e = p, p + PARTS, ... of v(e),
// NaN-propagating, from 0 (every quantity is an absolute value)
#define TAIL_PART_MAX(V, p, count, expr)                                    \
    [&]() {                                                                 \
        V acc = V(0);                                                       \
        for (int e = (int)(p); e < (count); e += PARTS)                     \
            acc = nanmax(acc, (expr));                                      \
        return acc;                                                         \
    }()

// ---- unscale: x and y of one scenario (both paths), the plain ops
template <typename T>
TAIL_FN T unscale_x(const UnArgs<T>& a, long long b, int u)
{
    return a.row(UI_D, b)[u] * a.row(UI_XS, b)[u];
}
template <typename T>
TAIL_FN T unscale_y(const UnArgs<T>& a, long long b, int k)
{
    return (a.row(UI_E, b)[k] * a.row(UI_YS, b)[k]) / a.row(UI_C, b)[0];
}

// ---- unscale's block path: one scenario b over a block
//
// Shared memory: Smem's vectors (its first 3 PARTS partial maxima used)
// and, transposed, lane l's partial of split row `row` at
// lanes[l (split + 1) + row] (odd stride: a warp's 32 stores and a
// thread's reads of one column fall in 32 banks).

TAIL_FN long long block_smem_values(int n, int m, int dense)
{
    const int split = n + (dense ? m : 0);
    return 3LL * n + 3LL * m + (long long)MAXIMA * PARTS
           + (long long)WARP * (split + 1);
}

// unit (group g, lane l) of the `rows` rows of M (n columns each, split
// rows row_off ...): the G rows from g G, lane l's terms j = l, l + 32,
// ... of each in order, from 0, in the accumulator type V.  NQ > 0: n = 32
// NQ, every load of the group issued before the first sum; NQ = 0: any n,
// the rows' loads of one j together.
template <int NQ, int G, typename V, typename T>
TAIL_FN void row_group(const T* M, int rows, int n, int g, int l,
                       const V* x, V* lanes, int ld, int row_off)
{
    const int r0 = g * G;
    const T* R[G];
    TAIL_UNROLL
    for (int rr = 0; rr < G; ++rr)
        R[rr] = M + (long long)(r0 + rr < rows ? r0 + rr : rows - 1) * n;
    V acc[G];
    if (NQ > 0) {
        T v[G][NQ > 0 ? NQ : 1];
        TAIL_UNROLL
        for (int rr = 0; rr < G; ++rr)
            TAIL_UNROLL
            for (int qq = 0; qq < NQ; ++qq) v[rr][qq] = R[rr][l + WARP * qq];
        TAIL_UNROLL
        for (int rr = 0; rr < G; ++rr) {
            acc[rr] = V(0);
            TAIL_UNROLL
            for (int qq = 0; qq < NQ; ++qq)
                acc[rr] = acc[rr] + V(v[rr][qq]) * x[l + WARP * qq];
        }
    } else {
        TAIL_UNROLL
        for (int rr = 0; rr < G; ++rr) acc[rr] = V(0);
        for (int j = l; j < n; j += WARP) {
            T v[G];
            TAIL_UNROLL
            for (int rr = 0; rr < G; ++rr) v[rr] = R[rr][j];
            TAIL_UNROLL
            for (int rr = 0; rr < G; ++rr)
                acc[rr] = acc[rr] + V(v[rr]) * x[j];
        }
    }
    TAIL_UNROLL
    for (int rr = 0; rr < G; ++rr)
        if (r0 + rr < rows)
            lanes[(long long)l * ld + row_off + r0 + rr] = acc[rr];
}

// the row groups of `rows` rows of M over a phase's units
template <int NQ, int G, typename V, typename T, class Exec>
TAIL_FN void row_groups(const Exec& ex, const T* M, int rows, int n,
                        const V* x, V* lanes, int ld, int row_off)
{
    const long long groups = (rows + G - 1) / G;
    TAIL_UNITS(ex, u, groups * WARP)
        row_group<NQ, G>(M, rows, n, (int)(u / WARP), (int)(u % WARP), x,
                         lanes, ld, row_off);
}

// a split row's 32 partials, in order
template <typename T>
TAIL_FN T sum_column(const T* lanes, int ld, int row)
{
    T v = lanes[row];
    for (int l = 1; l < WARP; ++l) v = v + lanes[(long long)l * ld + row];
    return v;
}

// the largest of PARTS partial maxima, NaN-propagating, by four chains
// side by side (any order gives the same value)
template <typename V>
TAIL_FN V max_tree(const V* part)
{
    constexpr int Q = PARTS / 4;
    V a0 = part[0], a1 = part[Q], a2 = part[2 * Q], a3 = part[3 * Q];
    TAIL_UNROLL
    for (int p = 1; p < Q; ++p) {
        a0 = nanmax(a0, part[p]);
        a1 = nanmax(a1, part[Q + p]);
        a2 = nanmax(a2, part[2 * Q + p]);
        a3 = nanmax(a3, part[3 * Q + p]);
    }
    return nanmax(nanmax(a0, a1), nanmax(a2, a3));
}

template <int NQ, typename T, class Exec>
TAIL_FN void unscale_block_body(const Exec& ex, const UnArgs<T>& a,
                                const Shape& s, long long b, T* smem)
{
    const int n = s.n, m = s.m;
    Smem<T> S(smem, n, m);
    const T* P = a.row(UI_P, b);
    const T* q = a.row(UI_Q, b);
    const T* A = a.row(UI_A, b);
    TAIL_UNITS(ex, u, n + m) {
        if (u < n) {
            const T x = unscale_x(a, b, (int)u);
            S.x[u] = x;
            a.out[UO_X][b * n + u] = x;
        } else {
            const int k = (int)u - n;
            const T y = unscale_y(a, b, k);
            S.y[k] = y;
            a.out[UO_Y][b * m + k] = y;
        }
    }
    ex.sync();
    // the products: the block rows of A, the columns of A', the split rows
    // a group of ROW_GROUP a warp
    const int split = split_rows(s), ld = split + 1;
    const long long rows = s.blocks() ? m : 0;
    TAIL_UNITS(ex, u, rows + n) {
        if (u < rows) S.ax[u] = a_block_row_dot(A, s, (int)u, S.x);
        else S.aty[u - rows] = a_col_dot(A, s, (int)(u - rows), S.y);
    }
    if (!s.blocks())
        row_groups<NQ, ROW_GROUP>(ex, A, m, n, S.x, S.lanes, ld, n);
    row_groups<NQ, ROW_GROUP>(ex, P, n, n, S.x, S.lanes, ld, 0);
    ex.sync();
    // P x; A x of a dense A; z = clip(A x, l, u) and A x - z
    TAIL_UNITS(ex, u, n + m) {
        if (u < n) {
            S.px[u] = sum_column(S.lanes, ld, (int)u);
        } else {
            const int k = (int)u - n;
            const T ax = s.blocks() ? S.ax[k] : sum_column(S.lanes, ld, n + k);
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
    // prim, dual and ok, a unit each
    TAIL_UNITS(ex, u, 3) {
        if (u == 1) {
            a.out[UO_DUAL][b] = max_tree(S.part + PARTS);
            continue;
        }
        const T prim = max_tree(S.part);
        if (u == 0) {
            a.out[UO_PRIM][b] = prim;
            continue;
        }
        bool finite = true;
        for (int p = 0; p < PARTS; ++p) finite &= S.part[2 * PARTS + p] > T(0);
        a.ok[b] = finite && prim < a.par[UP_STATUS_TOL] ? 1 : 0;
    }
}

template <typename T, class Exec>
TAIL_FN void unscale_block(const Exec& ex, const UnArgs<T>& a,
                           const Shape& s, long long b, T* smem)
{
    if (s.n == WARP * STREAM_NQ)
        unscale_block_body<STREAM_NQ>(ex, a, s, b, smem);
    else
        unscale_block_body<0>(ex, a, s, b, smem);
}

// ---- unscale's warp path: one scenario b over a warp
//
// Lane i sums rows i, i + 32 of P x and A x and columns i, i + 32 of A' y,
// each over its terms in index order (lane_partial<1>'s and a_col_dot's
// sums), from P's rows and a dense A's in the warp's shared memory at a
// row stride ld; the maxima and the finiteness flag over the lanes by the
// executor.  Two ways in (qp/tail.py::tail_layout, `lanes`): 2 slots, a
// persistent warp whose next scenario's P and A arrive by bulk copy into
// one slot while it works on the other (the card's; ld = n: rows i and
// i + 16 of an even n share a bank); 1 slot, the warp's lanes stage them
// through registers at the odd stride `warp_ld` (any alignment; the host
// build runs both).

TAIL_FN int warp_ld(int n) { return n | 1; }

// values of a warp's slot: P's n rows and a dense A's m at stride ld
TAIL_FN long long slot_values(int n, int m, int dense, int ld)
{
    return (long long)(n + (dense ? m : 0)) * ld;
}

// bytes of one warp's shared memory, a multiple of 16: 1 slot (staged
// through registers at warp_ld), x, y; or 2 slots at ld = n after two
// mbarriers, x, y
TAIL_FN long long warp_smem_bytes(int n, int m, int dense, int slots,
                                  int size)
{
    const long long v =
        slots == 1 ? slot_values(n, m, dense, warp_ld(n)) + n + m
                   : 2 * slot_values(n, m, dense, n) + n + m;
    return (16 * (slots == 2) + v * size + 15) / 16 * 16;
}

// a lane's vector inputs, entries l and l + 32: D, xs, q (n); E, ys, l0,
// u0 (m); and c
template <typename T>
struct LaneIn {
    T d[2], xs[2], q[2], e[2], ys[2], lo[2], hi[2], c;
};

// lane l's vector inputs of scenario b (zeros past n and m), loaded ahead
// of their use where the executor can
template <typename T>
TAIL_FN void load_lane(LaneIn<T>& v, const UnArgs<T>& a, const Shape& s,
                       long long b, int l)
{
    for (int k = 0; k < 2; ++k) {
        const int u = l + WARP * k;
        const bool in_n = u < s.n, in_m = u < s.m;
        v.d[k] = in_n ? a.row(UI_D, b)[u] : T(0);
        v.xs[k] = in_n ? a.row(UI_XS, b)[u] : T(0);
        v.q[k] = in_n ? a.row(UI_Q, b)[u] : T(0);
        v.e[k] = in_m ? a.row(UI_E, b)[u] : T(0);
        v.ys[k] = in_m ? a.row(UI_YS, b)[u] : T(0);
        v.lo[k] = in_m ? a.row(UI_L, b)[u] : T(0);
        v.hi[k] = in_m ? a.row(UI_U, b)[u] : T(0);
    }
    v.c = a.row(UI_C, b)[0];
}

// a lane's state: its vector inputs, its part of the maxima
template <typename T>
struct UnLane {
    LaneIn<T> in;
    T prim, dual;
    bool finite;
};

// row . x over j in index order from 0, in the accumulator type V
template <typename V, typename T>
TAIL_FN V row_dot(const T* row, const V* x, int n)
{
    V v = V(0);
    TAIL_UNROLL8
    for (int j = 0; j < n; ++j) v = v + V(row[j]) * x[j];
    return v;
}

// lane l's part of the warp's copy of P's n rows and then A's m (m 0: no
// A) into shared memory at row stride ld: the values l, l + 32, ... of the
// two, STAGE of them loaded before any is stored
template <typename T>
TAIL_FN void stage_rows(int l, const T* P, const T* A, int n, int m, int ld,
                        T* Ps, T* As)
{
    const int pp = n * n, count = pp + m * n;
    for (int e0 = 0; e0 < count; e0 += WARP * STAGE) {
        T v[STAGE];
        TAIL_UNROLL
        for (int q = 0; q < STAGE; ++q) {
            const int e = e0 + q * WARP + l;
            if (e < count) v[q] = e < pp ? P[e] : A[e - pp];
        }
        TAIL_UNROLL
        for (int q = 0; q < STAGE; ++q) {
            const int e = e0 + q * WARP + l;
            if (e >= count) continue;
            const int f = e < pp ? e : e - pp, row = f / n;
            (e < pp ? Ps : As)[row * ld + f - row * n] = v[q];
        }
    }
}

// scenario b from its rows in the warp's shared memory (Ps, and As when A
// is dense, at stride ld), with the x and y arrays xs, ys and each lane's
// vector inputs in its state.  The rows may still be arriving in the
// first phase (`stage(l, st)`, lane l's part of their copy, which may also
// load the inputs) and are read only after the warp's barrier.  Lane l's
// chains (rows l, l + 32 of A x, row l of P x, and row l + 32 and the
// columns l, l + 32 of A' y) are each summed in index order from 0; the
// rows of one pass over j side by side.
template <typename T, class Ex, class Stage>
TAIL_FN void unscale_warp_rows(Ex& ex, const UnArgs<T>& a, const Shape& s,
                               long long b, const T* Ps, const T* As, int ld,
                               T* xs, T* ys, Stage stage)
{
    const int n = s.n, m = s.m;
    const bool dense = !s.blocks();
    const T* A = a.row(UI_A, b);
    ex.lanes([&](int l, UnLane<T>& st) {
        stage(l, st);
        for (int k = 0; k < 2; ++k) {
            const int u = l + WARP * k;
            if (u < n) {
                const T x = st.in.d[k] * st.in.xs[k];
                xs[u] = x;
                a.out[UO_X][b * n + u] = x;
            }
            if (u < m) {
                const T y = (st.in.e[k] * st.in.ys[k]) / st.in.c;
                ys[u] = y;
                a.out[UO_Y][b * m + u] = y;
            }
        }
    });
    ex.sync();
    ex.lanes([&](int l, UnLane<T>& st) {
        // rows l and l + 32 of A x (dense: one pass over j beside row l of
        // P x), rows past the end clamped and their sums dropped
        T ax[2] = {T(0), T(0)}, px0 = T(0);
        const T* p0 = Ps + (l < n ? l : n - 1) * ld;
        if (dense && m > 0) {
            const T* a0 = As + (l < m ? l : m - 1) * ld;
            const T* a1 = As + (l + WARP < m ? l + WARP : m - 1) * ld;
            TAIL_UNROLL8
            for (int j = 0; j < n; ++j) {
                const T xj = xs[j];
                ax[0] = ax[0] + a0[j] * xj;
                ax[1] = ax[1] + a1[j] * xj;
                px0 = px0 + p0[j] * xj;
            }
        } else {
            px0 = row_dot(p0, xs, n);
            for (int k = 0; k < 2; ++k)
                if (l + WARP * k < m)
                    ax[k] = a_block_row_dot(A, s, l + WARP * k, xs);
        }
        st.prim = T(0);
        for (int k = 0; k < 2; ++k) {
            const int r = l + WARP * k;
            if (r >= m) continue;
            const T zu = nanmin(nanmax(ax[k], st.in.lo[k]), st.in.hi[k]);
            a.out[UO_Z][b * m + r] = zu;
            st.prim = nanmax(st.prim, t_abs(ax[k] - zu));
        }
        // columns l and l + 32 of A' y (dense: one pass over k)
        T aty[2] = {T(0), T(0)};
        if (dense) {
            const int c0 = l < n ? l : n - 1;
            const int c1 = l + WARP < n ? l + WARP : n - 1;
            TAIL_UNROLL8
            for (int k = 0; k < m; ++k) {
                const T yk = ys[k];
                aty[0] = aty[0] + As[k * ld + c0] * yk;
                aty[1] = aty[1] + As[k * ld + c1] * yk;
            }
        } else {
            for (int k = 0; k < 2; ++k)
                if (l + WARP * k < n)
                    aty[k] = a_col_dot(A, s, l + WARP * k, ys);
        }
        st.dual = T(0);
        st.finite = true;
        for (int k = 0; k < 2; ++k) {
            const int i = l + WARP * k;
            if (i >= n) continue;
            const T px = k == 0 ? px0 : row_dot(Ps + i * ld, xs, n);
            st.dual = nanmax(st.dual, t_abs((px + st.in.q[k]) + aty[k]));
            st.finite = st.finite && t_finite(xs[i]);
        }
    });
    ex.lanes([&](int l, UnLane<T>& st) {
        const T prim =
            ex.max_of(st, [](const UnLane<T>& t) { return t.prim; });
        const T dual =
            ex.max_of(st, [](const UnLane<T>& t) { return t.dual; });
        const bool finite =
            ex.all_of(st, [](const UnLane<T>& t) { return t.finite; });
        if (l == 0) {
            a.out[UO_PRIM][b] = prim;
            a.out[UO_DUAL][b] = dual;
            a.ok[b] = finite && prim < a.par[UP_STATUS_TOL] ? 1 : 0;
        }
    });
    ex.sync();
}

// the one-slot way (rows the bulk copies cannot take): the lanes stage P's
// and a dense A's rows at warp_ld and load their vector inputs
template <typename T, class Ex>
TAIL_FN void unscale_warp(Ex& ex, const UnArgs<T>& a, const Shape& s,
                          long long b, T* smem)
{
    const int n = s.n, m = s.m, ld = warp_ld(n);
    const bool dense = !s.blocks();
    T* Ps = smem;
    T* As = Ps + n * ld;
    T* xs = Ps + slot_values(n, m, dense, ld);
    const T* P = a.row(UI_P, b);
    const T* A = a.row(UI_A, b);
    unscale_warp_rows(ex, a, s, b, Ps, As, ld, xs, xs + n,
                      [&](int l, UnLane<T>& st) {
        load_lane(st.in, a, s, b, l);
        stage_rows(l, P, A, n, dense ? m : 0, ld, Ps, As);
    });
}

// ---- adapt_rho: one scenario b
//
// In double whatever T is: the dual residual's numerator cancels (on the
// MPC's QP the swing forces' ridge makes |P x| up to 1e6 times the
// residual), so float32 sums in any order leave rho a few percent from
// the function's value; summed in double from the float32 inputs and
// rounded once, rho is that value to T's rounding.  The sums keep the
// first design's orders, so rho keeps its bits: a row of P (or of
// a dense A) over j in index order on the warp path, as 32 partials over
// j = l, l + 32, ... summed in order of l on the block path; A's block
// rows and A' y's columns in index order.  The seven inf-norms are maxima
// of absolute values (NaN-propagating): the same in any order.

// quantity 0 |A x - z|, 1 |A x|, 2 |z| of row k; 3 |P x + q + A' y|, 4
// |P x|, 5 |q|, 6 |A' y| of column i: into the running maxima mx
TAIL_FN void adapt_prim(double* mx, double ax, double z)
{
    mx[0] = nanmax(mx[0], t_abs(ax - z));
    mx[1] = nanmax(mx[1], t_abs(ax));
    mx[2] = nanmax(mx[2], t_abs(z));
}

TAIL_FN void adapt_dual(double* mx, double px, double q, double aty)
{
    mx[3] = nanmax(mx[3], t_abs((px + q) + aty));
    mx[4] = nanmax(mx[4], t_abs(px));
    mx[5] = nanmax(mx[5], t_abs(q));
    mx[6] = nanmax(mx[6], t_abs(aty));
}

// rho from the seven maxima: rho_s sqrt(rp / max(rd, 1e-12)) in [1e-3, 1e3]
template <typename T>
TAIL_FN T adapt_finish(const double* mx, T rho_s)
{
    using D = double;
    const D tiny = D(T(1e-12));
    const D rp = mx[0] / nanmax(nanmax(mx[1], mx[2]), tiny);
    const D rd = mx[3] / nanmax(nanmax(mx[4], nanmax(mx[5], mx[6])), tiny);
    const D r = D(rho_s) * t_sqrt(rp / nanmax(rd, tiny));
    return T(nanmin(nanmax(r, D(T(1e-3))), D(T(1e3))));
}

// the block path (MPC shape): Smem<double>'s vectors (z in dz), a warp's
// seven maxima in `part`, the 32 partials of each split row transposed in
// `lanes` (unscale's block path's layout, block_smem_values doubles), then
// q (n)
TAIL_FN long long adapt_block_values(int n, int m, int dense)
{
    return block_smem_values(n, m, dense) + n;
}

template <int NQ, typename T, class Exec>
TAIL_FN void adapt_block_body(const Exec& ex, const AdaptArgs<T>& a,
                              const Shape& s, long long b, double* smem)
{
    using D = double;
    const int n = s.n, m = s.m;
    Smem<D> S(smem, n, m);
    D* qs = smem + block_smem_values(n, m, !s.blocks());
    const T* P = a.row(AI_P, b);
    const T* A = a.row(AI_A, b);
    // x, y and the maxima's z and q, so that the last phases read no
    // device memory
    TAIL_UNITS(ex, u, 2 * (n + m)) {
        if (u < n) S.x[u] = D(a.row(AI_X, b)[u]);
        else if (u < n + m) S.y[u - n] = D(a.row(AI_Y, b)[u - n]);
        else if (u < n + 2 * m) S.dz[u - n - m] = D(a.row(AI_Z, b)[u - n - m]);
        else qs[u - n - 2 * m] = D(a.row(AI_Q, b)[u - n - 2 * m]);
    }
    ex.sync();
    // the products: the block rows of A, the columns of A', the split rows
    // a group of ROW_GROUP a warp
    const int split = split_rows(s), ld = split + 1;
    const long long rows = s.blocks() ? m : 0;
    TAIL_UNITS(ex, u, rows + n) {
        if (u < rows) S.ax[u] = a_block_row_dot(A, s, (int)u, S.x);
        else S.aty[u - rows] = a_col_dot(A, s, (int)(u - rows), S.y);
    }
    if (!s.blocks())
        row_groups<NQ, ADAPT_ROW_GROUP>(ex, A, m, n, S.x, S.lanes, ld, n);
    row_groups<NQ, ADAPT_ROW_GROUP>(ex, P, n, n, S.x, S.lanes, ld, 0);
    ex.sync();
    TAIL_UNITS(ex, u, split) {
        if (u < n) S.px[u] = sum_column(S.lanes, ld, (int)u);
        else S.ax[u - n] = sum_column(S.lanes, ld, (int)u);
    }
    ex.sync();
    // the maxima: each unit's share of the entries, then the block's
    D mx[MAXIMA];
    for (int w = 0; w < MAXIMA; ++w) mx[w] = D(0);
    const int width = ex.width();
    TAIL_UNITS(ex, u, width) {
        for (long long e = u; e < m; e += width)
            adapt_prim(mx, S.ax[e], S.dz[e]);
        for (long long e = u; e < n; e += width)
            adapt_dual(mx, S.px[e], qs[e], S.aty[e]);
    }
    ex.block_max(mx, S.part);
    TAIL_UNITS(ex, u, 1)
        a.out[AO_RHO_S][b] = adapt_finish(mx, a.row(AI_RHO_S, b)[0]);
}

template <typename T, class Exec>
TAIL_FN void adapt_block(const Exec& ex, const AdaptArgs<T>& a,
                         const Shape& s, long long b, double* smem)
{
    if (s.n == WARP * STREAM_NQ)
        adapt_block_body<STREAM_NQ>(ex, a, s, b, smem);
    else
        adapt_block_body<0>(ex, a, s, b, smem);
}

// the warp path (the WBC shape): a lane's inputs, entries l and l + 32: x,
// q (n); y, z (m); and rho_s
template <typename T>
struct AdaptLaneIn {
    T x[2], q[2], y[2], z[2], rho;
};

template <typename T>
TAIL_FN void load_adapt_lane(AdaptLaneIn<T>& v, const AdaptArgs<T>& a,
                             const Shape& s, long long b, int l)
{
    for (int k = 0; k < 2; ++k) {
        const int u = l + WARP * k;
        const bool in_n = u < s.n, in_m = u < s.m;
        v.x[k] = in_n ? a.row(AI_X, b)[u] : T(0);
        v.q[k] = in_n ? a.row(AI_Q, b)[u] : T(0);
        v.y[k] = in_m ? a.row(AI_Y, b)[u] : T(0);
        v.z[k] = in_m ? a.row(AI_Z, b)[u] : T(0);
    }
    v.rho = a.row(AI_RHO_S, b)[0];
}

// a lane's state: its inputs, its part of the seven maxima
template <typename T>
struct AdaptLane {
    AdaptLaneIn<T> in;
    double mx[MAXIMA];
};

// bytes of one warp's shared memory in adapt_rho, a multiple of 16: the
// rows as unscale's warp path keeps them (1 slot at warp_ld, or 2 slots
// at ld = n after two mbarriers), then x and y in double
TAIL_FN long long adapt_rows_bytes(int n, int m, int dense, int slots,
                                   int size)
{
    const long long v = slots == 1 ? slot_values(n, m, dense, warp_ld(n))
                                   : 2 * slot_values(n, m, dense, n);
    return 16 * (slots == 2) + (v * size + 7) / 8 * 8;
}

TAIL_FN long long adapt_warp_smem_bytes(int n, int m, int dense, int slots,
                                        int size)
{
    return (adapt_rows_bytes(n, m, dense, slots, size) + 8LL * (n + m) + 15)
           / 16 * 16;
}

// bytes of a block's shared memory in adapt_rho: `warps` warps of `slots`
// slots on the warp path, or (warps 0) the block path
TAIL_FN long long adapt_smem_bytes(int n, int m, int dense, int warps,
                                   int slots, int size)
{
    return warps > 0 ? warps * adapt_warp_smem_bytes(n, m, dense, slots, size)
                     : adapt_block_values(n, m, dense) * 8;
}

// scenario b from its rows in the warp's shared memory (Ps, and As when A
// is dense, at stride ld), x and y in double at xs and ys: lane l's rows
// l, l + 32 of A x and of P x, its columns l, l + 32 of A' y, each summed
// in index order from 0 (the rows of one pass over j side by side), its
// part of the maxima, then the warp's by the executor.  The rows may still
// be arriving in the first phase (`stage(l, st)`, which may also load the
// lane's inputs) and are read only after the warp's barrier.
template <typename T, class Ex, class Stage>
TAIL_FN void adapt_warp_rows(Ex& ex, const AdaptArgs<T>& a, const Shape& s,
                             long long b, const T* Ps, const T* As, int ld,
                             double* xs, double* ys, Stage stage)
{
    using D = double;
    const int n = s.n, m = s.m;
    const bool dense = !s.blocks();
    const T* A = a.row(AI_A, b);
    ex.lanes([&](int l, AdaptLane<T>& st) {
        stage(l, st);
        for (int k = 0; k < 2; ++k) {
            const int u = l + WARP * k;
            if (u < n) xs[u] = D(st.in.x[k]);
            if (u < m) ys[u] = D(st.in.y[k]);
        }
    });
    ex.sync();
    ex.lanes([&](int l, AdaptLane<T>& st) {
        for (int w = 0; w < MAXIMA; ++w) st.mx[w] = D(0);
        // rows l and l + 32 of A x (dense: one pass over j beside row l of
        // P x), rows past the end clamped and their sums dropped
        D ax[2] = {D(0), D(0)}, px0 = D(0);
        const T* p0 = Ps + (l < n ? l : n - 1) * ld;
        if (dense && m > 0) {
            const T* a0 = As + (l < m ? l : m - 1) * ld;
            const T* a1 = As + (l + WARP < m ? l + WARP : m - 1) * ld;
            TAIL_UNROLL8
            for (int j = 0; j < n; ++j) {
                const D xj = xs[j];
                ax[0] = ax[0] + D(a0[j]) * xj;
                ax[1] = ax[1] + D(a1[j]) * xj;
                px0 = px0 + D(p0[j]) * xj;
            }
        } else {
            px0 = row_dot(p0, xs, n);
            for (int k = 0; k < 2; ++k)
                if (l + WARP * k < m)
                    ax[k] = a_block_row_dot(A, s, l + WARP * k, xs);
        }
        for (int k = 0; k < 2; ++k)
            if (l + WARP * k < m) adapt_prim(st.mx, ax[k], D(st.in.z[k]));
        // columns l and l + 32 of A' y (dense: one pass over k)
        D aty[2] = {D(0), D(0)};
        if (dense) {
            const int c0 = l < n ? l : n - 1;
            const int c1 = l + WARP < n ? l + WARP : n - 1;
            TAIL_UNROLL8
            for (int k = 0; k < m; ++k) {
                const D yk = ys[k];
                aty[0] = aty[0] + D(As[k * ld + c0]) * yk;
                aty[1] = aty[1] + D(As[k * ld + c1]) * yk;
            }
        } else {
            for (int k = 0; k < 2; ++k)
                if (l + WARP * k < n)
                    aty[k] = a_col_dot(A, s, l + WARP * k, ys);
        }
        for (int k = 0; k < 2; ++k) {
            const int i = l + WARP * k;
            if (i >= n) continue;
            const D px = k == 0 ? px0 : row_dot(Ps + i * ld, xs, n);
            adapt_dual(st.mx, px, D(st.in.q[k]), aty[k]);
        }
    });
    ex.lanes([&](int l, AdaptLane<T>& st) {
        D mx[MAXIMA];
        for (int w = 0; w < MAXIMA; ++w)
            mx[w] = ex.max_of(st, [w](const AdaptLane<T>& t) {
                return t.mx[w];
            });
        if (l == 0) a.out[AO_RHO_S][b] = adapt_finish(mx, st.in.rho);
    });
    ex.sync();
}

// the one-slot way: the lanes stage P's and a dense A's rows at warp_ld
// and load their inputs; `smem` holds adapt_warp_smem_bytes(.., 1, ..)
template <typename T, class Ex>
TAIL_FN void adapt_warp(Ex& ex, const AdaptArgs<T>& a, const Shape& s,
                        long long b, unsigned char* smem)
{
    const int n = s.n, m = s.m, ld = warp_ld(n);
    const bool dense = !s.blocks();
    T* Ps = reinterpret_cast<T*>(smem);
    T* As = Ps + n * ld;
    double* xs = reinterpret_cast<double*>(
        smem + adapt_rows_bytes(n, m, dense, 1, (int)sizeof(T)));
    const T* P = a.row(AI_P, b);
    const T* A = a.row(AI_A, b);
    adapt_warp_rows(ex, a, s, b, Ps, As, ld, xs, xs + n,
                    [&](int l, AdaptLane<T>& st) {
        load_adapt_lane(st.in, a, s, b, l);
        stage_rows(l, P, A, n, dense ? m : 0, ld, Ps, As);
    });
}

// whether bulk copies take these rows: each scenario's (count values of
// `size` bytes) 16-byte aligned and a whole number of 16-byte pieces
TAIL_FN bool rows_bulk(const void* p, long long stride, long long count,
                       int size)
{
    return (uintptr_t)p % 16 == 0 && (stride * size) % 16 == 0
           && (count * size) % 16 == 0;
}

// whether the two-slot warp path takes the operands: P's rows and a dense
// A's
TAIL_FN bool warp_bulk(const void* P, long long p_stride, const void* A,
                          long long a_stride, const Shape& s, int size)
{
    return rows_bulk(P, p_stride, (long long)s.n * s.n, size)
           && (s.blocks()
               || rows_bulk(A, a_stride, (long long)s.m * s.n, size));
}

// what the launchers of adapt_rho and unscale and the host build refuse:
// lanes 1 or 2 is the warp path (n, m at most WARP_DIM; threads a whole
// number of warps, at most MAX_WARPS; 1 slot: blocks the scenarios over
// them; 2 slots: at most that many, the warps walking the rest), lanes
// MAX_LANES the block path (a block a scenario)
TAIL_FN bool scenario_bad(int B, const Shape& s, int threads, int blocks)
{
    if (s.lanes == 1 || s.lanes == 2) {
        const int w = threads / WARP, need = (B + w - 1) / w;
        return s.n > WARP_DIM || s.m > WARP_DIM || w < 1 || w > MAX_WARPS
               || threads % WARP != 0 || blocks < 1
               || (s.lanes == 1 ? blocks != need : blocks > need);
    }
    return s.lanes != MAX_LANES || blocks != B;
}

#if !defined(__CUDA_ARCH__)
// the host executors: one thread runs every unit of a phase, or every
// lane of a warp, in order or reversed
struct HostExec {
    bool reverse;

    long long first(long long n) const { return reverse ? n - 1 : 0; }
    long long next(long long u) const { return reverse ? u - 1 : u + 1; }
    void sync() const {}
    // adapt_rho's block maxima: any number of units (here 96, a block's
    // threads on the card) running into the same maxima make the block's
    int width() const { return 96; }
    void block_max(double*, double*) const {}
};

// a warp's lanes, each with its state (UnLane, AdaptLane)
template <class Lane>
struct HostWarp {
    bool reverse;
    Lane lane[WARP];

    template <class F>
    void lanes(F f)
    {
        for (int k = 0; k < WARP; ++k) {
            const int l = reverse ? WARP - 1 - k : k;
            f(l, lane[l]);
        }
    }
    void sync() const {}
    template <class G>
    auto max_of(const Lane&, G g) const
    {
        auto v = g(lane[0]);
        for (int l = 1; l < WARP; ++l) v = nanmax(v, g(lane[l]));
        return v;
    }
    template <class G>
    bool all_of(const Lane&, G g) const
    {
        bool v = true;
        for (int l = 0; l < WARP; ++l) v = v && g(lane[l]);
        return v;
    }
};
#endif

}  // namespace tail
