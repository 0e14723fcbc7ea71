// The blocked factorization of the SPD-inverse kernel's block path
// (spd_inverse.cu, n > 32): the Cholesky factor of Ks = s K s and its
// inverse L^-1, in place in ONE working matrix W, by panels of 32 columns.
//
// Plain C++: every function is marked SPD_FN, `__host__ __device__` under
// nvcc and plain `inline` under a host compiler, so the tests build this
// very arithmetic with g++ and run it on the CPU in the kernel's panel order
// (tests/test_torch_spd_blocked.py).  The kernel maps its threads onto the
// units below and puts a block barrier where `factor_and_invert` calls
// `ex.sync()`; the host executor runs the units one after the other.  Only
// the diagonal block's warp code (shuffles) exists for the device alone,
// beside its host twin `diag_factor_host`, which runs the same per-lane
// arithmetic lane after lane.
//
// W: np = round32(n) rows of ld = np + 4 floats (rows 16-byte aligned, a
// stride of 4 mod 32 banks: the 16-byte reads of eight consecutive rows by
// a quarter warp hit 32 different banks).  Rows and columns n .. np - 1 are
// the identity's (the pad), so the factor and the inverse of the real part
// are those of K alone: every entry (i, j) of L and of L^-1 depends on
// entries with indices <= max(i, j) only, and the pad lies past them all.
// Only the lower triangle is kept; the upper off-diagonal blocks serve as
// the forward substitution's scratch.
//
// Per panel p (columns c0 = 32 p .. c0 + 31), three block barriers:
//   1. diagonal block: one warp, lane i on row i in registers, the column
//      sweep of spd_inverse.cuh (the pivot floor 1e-10 per column) and, in
//      the same sweep, its triangular inverse, lane c on column c; L11^-1
//      is written over the block (L11 itself is never needed again);
//   2. panel: L21 = A21 L11^-T into the panel buffer P (rows below the
//      block, stride PLD), 4 x 4 register tiles per thread; beside it block
//      row p of L^-1: L^-1_pj = -L^-1_pp T_pj over the block (p, j), j < p;
//   3. trailing update A22 -= L21 L21' over the lower triangle's 32 x 32
//      tiles (the diagonal tiles whole), 4 x 4 register tiles read from P;
//      beside it the forward substitution's sums T_ij += L_ip L^-1_pj for
//      every block row i > p and column j <= p (L_ip from P), which
//      accumulate T_ij = sum_{k=j}^{i-1} L_ik L^-1_kj in W's unused upper
//      block (j, i) until block row i of L^-1 is formed.
// L itself is never stored: each panel lives in P for its own phase 3.  At
// the end W's lower triangle holds L^-1, the diagonal blocks' upper
// triangles zeros; `x0_unit` then forms X0 = L^-T L^-1 from it.
//
// A register tile: thread (ti, tk) of a tile's 64 owns rows ti + 8a (a < 4)
// and four columns (`tile_product`).  Eight consecutive threads then read
// eight consecutive rows of the left operand in 16-byte pieces
// (conflict-free) and the same piece of the right one (a broadcast).  Each
// entry is one FMA chain in k order, on the host as on the device.

#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define SPD_FN __host__ __device__ __forceinline__
#else
#define SPD_FN inline
#endif

namespace spd_blocked {

constexpr int PW = 32;          // panel width: a warp's lanes
constexpr int PLD = PW + 4;     // row stride of the panel buffer P
constexpr int TR = 4;           // a thread's register tile: TR x TR
constexpr int UNITS = 64;       // threads per 32 x 32 tile
constexpr float PIVOT_FLOOR = 1e-10f;

SPD_FN int padded(int n) { return (n + PW - 1) / PW * PW; }
SPD_FN int stride(int np) { return np + 4; }
SPD_FN int tri(int r) { return r * (r + 1) / 2; }

// Floats of the block's shared memory: the Jacobi scale (np), P (np rows),
// a 16-byte slot for the load's transaction barrier, and W when it lives
// there.
SPD_FN int smem_floats(int n, bool w_in_smem)
{
    const int np = padded(n);
    return np + np * PLD + 4 + (w_in_smem ? np * stride(np) : 0);
}

// lower-triangle tile `idx` (row-major over r >= c) -> (r, c)
SPD_FN void tile_rc(int idx, int& r, int& c)
{
    r = 0;
    while (tri(r + 1) <= idx) ++r;
    c = idx - tri(r);
}

// ---- the diagonal block's per-lane arithmetic (device warp and host twin)

// L[j][j] from the pivot; a NaN pivot stays NaN (as torch.clamp_min keeps it)
SPD_FN float pivot_root(float piv)
{
    return sqrtf(piv < PIVOT_FLOOR ? PIVOT_FLOOR : piv);
}

// v / d from the reciprocal inv_d = 1 / d (one division a column, the same
// in every lane: no lane takes another path through it): the product and one
// FMA step on its residual, as a division's own refinement does
SPD_FN float div_by(float v, float d, float inv_d)
{
    const float q = v * inv_d;
    return fmaf(fmaf(-q, d, v), inv_d, q);
}

// entry (lane, j) of L from the lane's updated value v, the root d and its
// reciprocal inv_d
SPD_FN float column_entry(int lane, int j, float v, float d, float inv_d)
{
    return lane > j ? div_by(v, d, inv_d) : (lane == j ? d : 0.f);
}

// entry (i, c = lane) of L^-1 from acc = sum_{k<i} L[i][k] L^-1[k][c],
// lii = L[i][i] and inv_lii = 1 / lii
SPD_FN float inverse_entry(int lane, int i, float acc, float lii,
                           float inv_lii)
{
    return lane == i ? inv_lii : (lane < i ? -div_by(acc, lii, inv_lii) : 0.f);
}

#if !defined(__CUDA_ARCH__)
// The diagonal block D (32 x 32, stride ld, lower triangle valid) -> its
// Cholesky factor's inverse over it (zeros above the diagonal): the warp
// sweep of spd_inverse.cuh (`warp_chol_inverse`) lane after lane.  Lane c's
// acc[k] sums L[k][j] L^-1[j][c] over j < k in j order.
inline void diag_factor_host(float* D, int ld)
{
    float r[PW][PW], l[PW], acc[PW][PW] = {};
    for (int lane = 0; lane < PW; ++lane)
        for (int k = 0; k < PW; ++k)
            r[lane][k] = k <= lane ? D[lane * ld + k] : 0.f;
    for (int j = 0; j < PW; ++j) {
        const float d = pivot_root(r[j][j]);
        const float inv_d = 1.0f / d;
        float x[PW];
        for (int lane = 0; lane < PW; ++lane) {
            l[lane] = column_entry(lane, j, r[lane][j], d, inv_d);
            x[lane] = inverse_entry(lane, j, acc[lane][j], d, inv_d);
            r[lane][j] = l[lane];
            D[j * ld + lane] = x[lane];
        }
        for (int k = j + 1; k < PW; ++k)
            for (int lane = 0; lane < PW; ++lane) {
                if (lane >= k)
                    r[lane][k] = fmaf(-l[lane], l[k], r[lane][k]);
                acc[lane][k] = fmaf(l[k], x[lane], acc[lane][k]);
            }
    }
}
#endif

// ---- the register tile

SPD_FN void load4(const float* p, float (&v)[4])
{
#if defined(__CUDA_ARCH__)
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
#else
    for (int k = 0; k < 4; ++k) v[k] = p[k];
#endif
}

SPD_FN void store4(float* p, const float (&v)[4])
{
#if defined(__CUDA_ARCH__)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
#else
    for (int k = 0; k < 4; ++k) p[k] = v[k];
#endif
}

// acc[a][b] += sum_{k < depth} X[(ti + 8a) ldx + k] Y(k, j_b), one FMA chain
// per entry in k order.  YT: the rows of Y are the tile's columns, Y(k, j)
// = Y[j ldy + k], and thread tk's columns are j_b = tk + 8b (eight
// consecutive threads share them: a broadcast); else Y(k, j) = Y[k ldy + j]
// and j_b = 4 tk + b (one 16-byte piece, likewise shared).  depth: a
// multiple of 4; the rows of X and Y 16-byte aligned.
template <bool YT>
SPD_FN void tile_product(const float* X, int ldx, const float* Y, int ldy,
                         int depth, int ti, int tk, float (&acc)[TR][TR])
{
    for (int k = 0; k < depth; k += 4) {
        float x[TR][4], y[TR][4];
#pragma unroll
        for (int a = 0; a < TR; ++a) load4(X + (ti + 8 * a) * ldx + k, x[a]);
        if constexpr (YT) {
#pragma unroll
            for (int b = 0; b < TR; ++b)
                load4(Y + (tk + 8 * b) * ldy + k, y[b]);
        } else {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                float v[4];
                load4(Y + (k + kk) * ldy + 4 * tk, v);
#pragma unroll
                for (int b = 0; b < TR; ++b) y[b][kk] = v[b];
            }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int a = 0; a < TR; ++a)
#pragma unroll
                for (int b = 0; b < TR; ++b)
                    acc[a][b] = fmaf(x[a][kk], y[b][kk], acc[a][b]);
    }
}

// sign * acc -> the tile's entries of C (stride ldc): row ti + 8a, column
// j_b as in tile_product (with YT false, 16-byte stores)
template <bool YT>
SPD_FN void tile_store(float* C, int ldc, int ti, int tk, float sign,
                       const float (&acc)[TR][TR])
{
#pragma unroll
    for (int a = 0; a < TR; ++a) {
        float* row = C + (ti + 8 * a) * ldc;
        if constexpr (YT) {
#pragma unroll
            for (int b = 0; b < TR; ++b) row[tk + 8 * b] = sign * acc[a][b];
        } else {
            const float v[4] = {sign * acc[a][0], sign * acc[a][1],
                                sign * acc[a][2], sign * acc[a][3]};
            store4(row + 4 * tk, v);
        }
    }
}

SPD_FN void tile_zero(float (&acc)[TR][TR])
{
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
        for (int b = 0; b < TR; ++b) acc[a][b] = 0.f;
}

// ---- the units of work between two barriers

// 2. L21 = A21 L11^-T, row tile r of the panel below the diagonal block c0
SPD_FN void panel_unit(const float* W, int ld, float* P, int c0, int u)
{
    const int r = u / UNITS, ti = u % UNITS % 8, tk = u % UNITS / 8;
    float acc[TR][TR];
    tile_zero(acc);
    tile_product<true>(W + (c0 + PW + PW * r) * ld + c0, ld,
                       W + c0 * ld + c0, ld, PW, ti, tk, acc);
    tile_store<true>(P + PW * r * PLD, PLD, ti, tk, 1.0f, acc);
}

// 3. A22 -= L21 L21' on lower tile `u / UNITS` of the trailing matrix
SPD_FN void update_unit(float* W, int ld, const float* P, int c0, int u)
{
    int r, c;
    tile_rc(u / UNITS, r, c);
    const int ti = u % UNITS % 8, tk = u % UNITS / 8;
    float acc[TR][TR];
    tile_zero(acc);
    tile_product<true>(P + PW * r * PLD, PLD, P + PW * c * PLD, PLD, PW, ti,
                       tk, acc);
    float* C = W + (c0 + PW + PW * r) * ld + c0 + PW + PW * c;
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
        for (int b = 0; b < TR; ++b) {
            float& e = C[(ti + 8 * a) * ld + tk + 8 * b];
            e = e - acc[a][b];
        }
}

// load the tile's entries of C (stride ldc) into acc (the layout of
// tile_store<false>)
SPD_FN void tile_load_nn(const float* C, int ldc, int ti, int tk,
                         float (&acc)[TR][TR])
{
#pragma unroll
    for (int a = 0; a < TR; ++a)
        load4(C + (ti + 8 * a) * ldc + 4 * tk, acc[a]);
}

// forward substitution at panel k: T_ij (+)= L_ik L^-1_kj for every block
// row i > k and block column j <= k, tile u / UNITS of the (P - 1 - k) x
// (k + 1) grid; L_ik from the panel buffer, T_ij in W's unused upper block
// (j, i)
SPD_FN void fwd_update_unit(float* W, int ld, const float* P, int k, int u)
{
    const int t = u / UNITS, ti = u % UNITS % 8, tk = u % UNITS / 8;
    const int i = k + 1 + t / (k + 1), j = t % (k + 1);
    float* T = W + PW * j * ld + PW * i;
    float acc[TR][TR];
    if (j < k)
        tile_load_nn(T, ld, ti, tk, acc);
    else
        tile_zero(acc);
    tile_product<false>(P + PW * (i - k - 1) * PLD, PLD,
                        W + PW * k * ld + PW * j, ld, PW, ti, tk, acc);
    tile_store<false>(T, ld, ti, tk, 1.0f, acc);
}

// block row i of L^-1 once its sums are complete: L^-1_ij = -L^-1_ii T_ij
// over the block (i, j) of W, j = u / UNITS < i
SPD_FN void fwd_scale_unit(float* W, int ld, int i, int u)
{
    const int j = u / UNITS, ti = u % UNITS % 8, tk = u % UNITS / 8;
    float acc[TR][TR];
    tile_zero(acc);
    tile_product<false>(W + PW * i * ld + PW * i, ld,
                        W + PW * j * ld + PW * i, ld, PW, ti, tk, acc);
    tile_store<false>(W + PW * i * ld + PW * j, ld, ti, tk, -1.0f, acc);
}

// X0 = L^-T L^-1 on a lower tile (r >= c) of the np x np grid: entry (i, j)
// = sum_{k >= max(i, j)} L^-1[k][i] L^-1[k][j], one FMA chain in k order
// (the tile (c, r) would form the same products in the same order, so the
// tile is also stored transposed: X0 is symmetric bit for bit).  The real
// part (indices < n) goes to out (row stride n).  Unit u's tile: the tiles
// go out g (= threads / UNITS) at a time, every other round in reverse, so
// that the deep tiles of the first rows meet the shallow ones of the last.
SPD_FN void x0_unit(const float* W, int ld, int np, float* out, int n, int u,
                    int g)
{
    const int q = u / UNITS, round = q / g, pos = q % g;
    const int tiles = tri(np / PW), size = tiles - round * g < g
                                               ? tiles - round * g : g;
    int r, c;
    tile_rc(round % 2 ? round * g + size - 1 - pos : q, r, c);
    const int ti = u % UNITS % 8, tk = u % UNITS / 8;
    float acc[TR][TR];
    tile_zero(acc);
#pragma unroll 4
    for (int k = PW * r; k < np; ++k) {
        const float* row = W + k * ld;
        float x[TR], y[4];
#pragma unroll
        for (int a = 0; a < TR; ++a) x[a] = row[PW * r + ti + 8 * a];
        load4(row + PW * c + 4 * tk, y);
#pragma unroll
        for (int a = 0; a < TR; ++a)
#pragma unroll
            for (int b = 0; b < TR; ++b)
                acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
        for (int b = 0; b < TR; ++b) {
            const int i = PW * r + ti + 8 * a, j = PW * c + 4 * tk + b;
            if (i < n && j < n) {
                out[i * n + j] = acc[a][b];
                out[j * n + i] = acc[a][b];
            }
        }
}

// ---- the panel order

// W (np x np at stride ld, the pad the identity's) -> L^-1 in its lower
// triangle; P: np rows of PLD floats.  `ex` supplies first() / step() (the
// units a thread takes), sync() (a block barrier) and diag(D, ld) (the
// diagonal block, by one warp).
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class Exec>
SPD_FN void factor_and_invert(Exec& ex, float* W, int ld, float* P, int np)
{
    const int panels = np / PW;
    for (int p = 0; p < panels; ++p) {
        const int c0 = PW * p, R = panels - 1 - p;
        ex.diag(W + c0 * ld + c0, ld);
        ex.sync();
        for (int u = ex.first(); u < (R + p) * UNITS; u += ex.step()) {
            if (u < R * UNITS)
                panel_unit(W, ld, P, c0, u);
            else
                fwd_scale_unit(W, ld, p, u - R * UNITS);
        }
        ex.sync();
        if (R == 0) break;
        for (int u = ex.first(); u < (tri(R) + R * (p + 1)) * UNITS;
             u += ex.step()) {
            if (u < tri(R) * UNITS)
                update_unit(W, ld, P, c0, u);
            else
                fwd_update_unit(W, ld, P, p, u - tri(R) * UNITS);
        }
        ex.sync();
    }
}

#if !defined(__CUDA_ARCH__)
// the host executor: one "thread" runs every unit
struct HostExec {
    int first() const { return 0; }
    int step() const { return 1; }
    void sync() const {}
    void diag(float* D, int ld) const { diag_factor_host(D, ld); }
};
#endif

}  // namespace spd_blocked
