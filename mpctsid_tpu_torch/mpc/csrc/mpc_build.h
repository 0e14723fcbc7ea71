// The per-scenario body of the MPC QP build kernel (mpc_build.cu):
// mpc/srb.py's `build_mpc_qp`, the condensed centroidal MPC QP (P, q, l, u)
// of one scenario over its horizon's structure.
//
// Plain C++: every function is marked MPCB_FN, `__host__ __device__` under
// nvcc and plain `inline` under a host compiler, so the tests build this
// very arithmetic with g++ and run it on the CPU
// (tests/test_torch_mpc_build_*.py).  The body runs over units
// (`MPCB_UNITS(ex, u, count)`) with a barrier between phases (`ex.sync()`),
// in two groups after a first block-wide phase: a PRODUCER that runs the
// backward recursion a step at a time and publishes each W_j
// (`ex.publish(j)`), and CONSUMERS that walk Su's columns and then, for
// j = N-1 ... 0, wait for W_j (`ex.await(j)`) and form row block j of P.
// On the card (mpc_build.cu) a group's threads take its units in turn, the
// group's barrier is a named barrier and W_j's is an mbarrier; on the host
// (HostExec) one thread runs every unit of a phase, in order or reversed,
// the producer's step j before the consumers' row block j (or any later
// point).  A unit never reads what another unit writes in its own phase,
// and a row block reads nothing that a later producer step writes.
//
// What it computes, per scenario (A_k = I + E_k is the one-step model of
// step k: dt I at (0:3, 6:9), M_k = dt Rz_k' at (3:6, 9:12); Q = diag(q)):
//
//   1. the N one-step models (srb_discrete): M_k, and B_k (rows 6:9 dt / m
//      per foot, rows 9:12 dt I_w^-1 [r_f]x with the closed-form inverse of
//      the world inertia Rz I_b Rz');
//   2. the drift: x_{k+1} = A_k x_k + c_k from x0, d_k = x_{k+1} - x_ref_k;
//      and Su's blocks Su_{k,j} = A_k ... A_{j+1} B_j (j < k), a thread a
//      column of B_j walking k;
//   3. backwards, S_{N-1} = Q, S_j = Q + A_{j+1}' S_{j+1} A_{j+1}, g_{N-1}
//      = Q d_{N-1}, g_j = Q d_j + A_{j+1}' g_{j+1}; W_j = S_j B_j and
//      q_j = B_j' g_j (the sums over B's nonzero rows 6:12), a step two
//      phases of 156 units;
//   4. P_ij = Su_{j,i}' W_j for i <= j, every entry a 12-term dot product of
//      a column of a Su block and a column of a W block, P_ji = P_ij' by the
//      same terms in the same order (so P is exactly symmetric); the
//      diagonal (P_ii + w_force) + pin, in the plain version's order; the
//      bound rows l and u by the plain version's selects on contacts > 0.5.
//
// Su stored once per distinct row.  A_k leaves rows 6:12 of a vector as
// they are (`apply_a`), so rows 6:12 of every Su_{k,i} are those of B_i:
// shared memory keeps rows 0:6 of each block (block row k as one 6 x 12
// (k + 1) matrix, the diagonal block's zeros included) and rows 6:12 of the
// N B_i once, side by side (a 6 x 12 N matrix), as the W_j are (12 x 12 N).
// So a row of four consecutive columns of any operand of P is 16 bytes in
// a row of one of these matrices, and the warps' loads of neighbouring
// columns fall on neighbouring banks.
//
// Row block j of P (rows 12 j ... 12 j + 11) needs W_j ... W_{N-1} and Su
// only: P_{j,i} for i > j is Su_{i,j}' W_i, for i < j W_j' Su_{j,i}, and
// the diagonal block B_j' W_j.  The recursion makes W_{N-1} first, so the
// consumers stream P out a row block at a time behind it.  A consumer unit
// is a 4 x 4 tile of the row block (`p_tile`): per term e, four values of
// its rows' operand and four of its columns', 16 fused multiply-adds.
//
// Bits.  P and q are the plain version's function in another order of
// sums (its P is Su' diag(Q) Su by cuBLAS, not even exactly symmetric):
// held to it within a tolerance, in float32 against the float64 plain
// version.  Each entry of P is a chain of fused multiply-adds over e = 0 ...
// 11 in order, its first term a product, so two launches agree bit for bit
// and an entry and its mirror are the same value.  The recursion's sums are
// the first design's expressions, which nvcc contracts as it did
// there (the library is built without -fmad=false).  l and u are the plain
// version's bit for bit.
//
// Shapes: x0 (12), x_ref (N, 12), feet (N, 4, 3), contacts (N, 4), mass
// (1, optional) a scenario, each a first row plus a stride in elements (0
// for a row shared by every scenario); P (n, n), q (n), l, u (m)
// contiguous, n = 12 N, m = 20 N.

#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define MPCB_FN __host__ __device__ __forceinline__
#define MPCB_UNROLL _Pragma("unroll")
#else
#define MPCB_FN inline
#define MPCB_UNROLL
#endif

// the units of a phase: on the card this thread's, on the host all of them
#define MPCB_UNITS(ex, u, count)                                            \
    for (int u = (ex).first(count); u >= 0 && u < (count); u = (ex).next(u))

namespace mpcb {

constexpr int NX = 12;          // state
constexpr int NU = 12;          // input: four feet's forces
constexpr int FEET = 4;
constexpr int ROWS_PER_FOOT = 5;
constexpr int BLK = NX * NU;    // values of a 12 x 12 block
constexpr int HALF = 6;         // rows 0:6 of a Su block; rows 6:12 are B's
constexpr int THREADS = 384;    // a block's threads
constexpr int PRODUCER_WARPS = 5;   // the recursion's warps (a unit a
                                    // thread a phase); the rest consume
// blocks a multiprocessor the launch bounds guarantee by registers
// (`__launch_bounds__(THREADS, blocks)`), float and double: as many as
// shared memory holds at N = 16
constexpr int MIN_BLOCKS_F32 = 4;
constexpr int MIN_BLOCKS_F64 = 2;

// ---- operands, in the order of the launcher's arrays
enum In { IN_X0, IN_XREF, IN_FEET, IN_CONTACTS, IN_MASS, IN_COUNT };
enum Out { OUT_P, OUT_Q, OUT_L, OUT_U, OUT_COUNT };
// dt; c_8 = -dt g; w_force; the ridge w_pin; fz_min, fz_max; the finite
// infinity of the bounds; dt / model mass; 1 if the mass input is given;
// diag(Q) (12); the body inertia I_b (3 x 3, row-major)
enum Par { PAR_DT, PAR_C8, PAR_W_FORCE, PAR_W_PIN, PAR_FZ_MIN, PAR_FZ_MAX,
           PAR_INF, PAR_DT_OVER_M, PAR_HAS_MASS, PAR_Q,
           PAR_IB = PAR_Q + NX, PAR_COUNT = PAR_IB + 9 };

// inputs, outputs, parameters, threads a block, producer warps, the
// launch bounds' blocks (float, double) (mpc/kernels.py::LAYOUT; -1 past
// the end)
inline int layout(int what)
{
    const int counts[] = {IN_COUNT, OUT_COUNT, PAR_COUNT, THREADS,
                          PRODUCER_WARPS, MIN_BLOCKS_F32, MIN_BLOCKS_F64};
    return what >= 0 && what < (int)(sizeof(counts) / sizeof(int))
               ? counts[what] : -1;
}

// Su's blocks before block row k: block (k, i), k >= i, is tri(k) + i
MPCB_FN int tri(int k) { return k * (k + 1) / 2; }

// values of a scenario's shared memory: rows 0:6 of Su's N (N + 1) / 2
// blocks, rows 6:12 of the N B_i, the N W_j, S and S A_j, the N M_k
// (3 x 3), the drifts d and the g_j (N x 12), diag(Q)
MPCB_FN long long smem_values(int N)
{
    return (long long)HALF * NU * tri(N) + (long long)(HALF + NX) * NU * N
           + 2LL * BLK + 9LL * N + 2LL * NX * N + NX;
}

// bytes before the values: one 8-byte mbarrier a step, rounded to 16
MPCB_FN long long barrier_bytes(int N) { return (8LL * N + 15) / 16 * 16; }

// bytes of a block's dynamic shared memory, values of `size` bytes
MPCB_FN long long smem_bytes(int N, int size)
{
    return barrier_bytes(N) + smem_values(N) * size;
}

template <typename T>
struct Smem {
    int n;      // 12 N: the row stride of bl and w
    T* su;      // block row k: a 6 x 12 (k + 1) matrix at su + 72 tri(k)
    T* bl;      // rows 6:12 of B_i at columns 12 i (6 x n)
    T* w;       // W_j at columns 12 j (12 x n)
    T* s;       // S_j
    T* t;       // S_j A_j
    T* m;
    T* d;
    T* g;
    T* qd;      // diag(Q)

    MPCB_FN Smem(T* base, int N)
        : n(N * NU), su(base), bl(su + (long long)HALF * NU * tri(N)),
          w(bl + HALF * n), s(w + NX * n), t(s + BLK), m(t + BLK),
          d(m + 9 * N), g(d + NX * N), qd(g + NX * N)
    {
    }

    // rows 0:6 of block row k and its row stride
    MPCB_FN T* su_row(int k) const
    {
        return su + (long long)HALF * NU * tri(k);
    }
    MPCB_FN int su_ld(int k) const { return NU * (k + 1); }
};

template <typename T>
struct Args {
    const T* in[IN_COUNT];
    long long stride[IN_COUNT];
    T* out[OUT_COUNT];
    T par[PAR_COUNT];

    MPCB_FN const T* row(int k, long long b) const
    {
        return in[k] + b * stride[k];
    }
};

// the launcher's arrays -> Args (host side: the kernel takes Args by value)
template <typename T>
inline void fill(Args<T>& a, const void* const* in, const long long* stride,
                 void* const* out, const double* par)
{
    for (int k = 0; k < IN_COUNT; ++k) {
        a.in[k] = static_cast<const T*>(in[k]);
        a.stride[k] = stride[k];
    }
    for (int k = 0; k < OUT_COUNT; ++k) a.out[k] = static_cast<T*>(out[k]);
    for (int k = 0; k < PAR_COUNT; ++k) a.par[k] = (T)par[k];
}

MPCB_FN float mb_sin(float a) { return sinf(a); }
MPCB_FN double mb_sin(double a) { return sin(a); }
MPCB_FN float mb_cos(float a) { return cosf(a); }
MPCB_FN double mb_cos(double a) { return cos(a); }
MPCB_FN float mb_fma(float a, float b, float c) { return fmaf(a, b, c); }
MPCB_FN double mb_fma(double a, double b, double c) { return fma(a, b, c); }

// four consecutive values (16-byte aligned on the card: one or two 16-byte
// accesses)
template <typename T>
MPCB_FN void load4(const T* p, T* v)
{
#if defined(__CUDA_ARCH__)
    if constexpr (sizeof(T) == 4) {
        const float4 f = *reinterpret_cast<const float4*>(p);
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    } else {
        const double2 f0 = reinterpret_cast<const double2*>(p)[0];
        const double2 f1 = reinterpret_cast<const double2*>(p)[1];
        v[0] = f0.x; v[1] = f0.y; v[2] = f1.x; v[3] = f1.y;
    }
#else
    for (int k = 0; k < 4; ++k) v[k] = p[k];
#endif
}

template <typename T>
MPCB_FN void store4(T* p, const T* v)
{
#if defined(__CUDA_ARCH__)
    if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
        reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
        reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
    }
#else
    for (int k = 0; k < 4; ++k) p[k] = v[k];
#endif
}

// v <- A_k v in place (rows 0:6 read only rows 6:12, which stay)
template <typename T>
MPCB_FN void apply_a(const T* M, T dt, T* v)
{
    for (int i = 0; i < 3; ++i) v[i] = v[i] + dt * v[6 + i];
    for (int i = 0; i < 3; ++i)
        v[3 + i] = v[3 + i] + (M[3 * i] * v[9] + M[3 * i + 1] * v[10]
                               + M[3 * i + 2] * v[11]);
}

// (A_k' v)[c] for v[e] = v[e * sv]: column c of A_k has its 1 and, for
// c in 6:9, dt at row c - 6, for c in 9:12, M_k's column c - 9 at rows 3:6
template <typename T>
MPCB_FN T at_entry(const T* M, T dt, const T* v, int sv, int c)
{
    if (c < 6) return v[c * sv];
    if (c < 9) return v[c * sv] + dt * v[(c - 6) * sv];
    const int m = c - 9;
    return v[c * sv] + (M[m] * v[3 * sv] + M[3 + m] * v[4 * sv]
                        + M[6 + m] * v[5 * sv]);
}

// ---- 1. step k's model as seen from foot f: B_k's columns 3f:3f+3 (rows
// 0:6 into the diagonal block of Su's block row k, rows 6:12 into bl), and
// (f = 0) M_k and diag(Q)
template <typename T>
MPCB_FN void model_unit(const Args<T>& a, long long b, int k, int f,
                        const Smem<T>& sm)
{
    const T* xr = a.row(IN_XREF, b) + k * NX;
    const T* ft = a.row(IN_FEET, b) + (k * FEET + f) * 3;
    const T dt = a.par[PAR_DT];
    const T* Ib = a.par + PAR_IB;
    const T c = mb_cos(xr[5]), s = mb_sin(xr[5]);
    const T R[9] = {c, -s, (T)0, s, c, (T)0, (T)0, (T)0, (T)1};
    // I_w = (Rz I_b) Rz'
    T X[9], W[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            X[3 * i + j] = R[3 * i] * Ib[j] + R[3 * i + 1] * Ib[3 + j]
                           + R[3 * i + 2] * Ib[6 + j];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            W[3 * i + j] = X[3 * i] * R[3 * j] + X[3 * i + 1] * R[3 * j + 1]
                           + X[3 * i + 2] * R[3 * j + 2];
    // qp/blockinv.py::inv3: the adjugate over the determinant
    const T A00 = W[4] * W[8] - W[5] * W[7];
    const T A01 = W[2] * W[7] - W[1] * W[8];
    const T A02 = W[1] * W[5] - W[2] * W[4];
    const T A10 = W[5] * W[6] - W[3] * W[8];
    const T A11 = W[0] * W[8] - W[2] * W[6];
    const T A12 = W[2] * W[3] - W[0] * W[5];
    const T A20 = W[3] * W[7] - W[4] * W[6];
    const T A21 = W[1] * W[6] - W[0] * W[7];
    const T A22 = W[0] * W[4] - W[1] * W[3];
    const T det = W[0] * A00 + W[1] * A10 + W[2] * A20;
    const T inv[9] = {A00 / det, A01 / det, A02 / det, A10 / det, A11 / det,
                      A12 / det, A20 / det, A21 / det, A22 / det};
    // [r]x, r = foot - p_ref
    const T r0 = ft[0] - xr[0], r1 = ft[1] - xr[1], r2 = ft[2] - xr[2];
    const T K[9] = {(T)0, -r2, r1, r2, (T)0, -r0, -r1, r0, (T)0};
    // dt / m: the model's (a parameter) or reciprocal(m) * dt (PyTorch's
    // Python number over a tensor)
    const T bv = a.par[PAR_HAS_MASS] != (T)0
                     ? ((T)1 / a.row(IN_MASS, b)[0]) * dt
                     : a.par[PAR_DT_OVER_M];
    T* lo = sm.su_row(k) + NU * k;
    T* hi = sm.bl + NU * k;
    const int ld = sm.su_ld(k);
    for (int j = 0; j < 3; ++j) {
        const int col = 3 * f + j;
        for (int e = 0; e < HALF; ++e) lo[e * ld + col] = (T)0;
        for (int e = 0; e < 3; ++e)
            hi[e * sm.n + col] = e == j ? bv : (T)0;
        for (int e = 0; e < 3; ++e)
            hi[(3 + e) * sm.n + col] =
                dt * (inv[3 * e] * K[j] + inv[3 * e + 1] * K[3 + j]
                      + inv[3 * e + 2] * K[6 + j]);
    }
    if (f == 0)
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j)
                sm.m[9 * k + 3 * i + j] = dt * R[3 * j + i];
    if (k == 0 && f == 0)
        for (int e = 0; e < NX; ++e) sm.qd[e] = a.par[PAR_Q + e];
}

// ---- 2. column c of Su's block column i: B_i's column, then A_k applied
// for k = i + 1 ... N - 1, rows 0:6 written into block (k, i)
template <typename T>
MPCB_FN void su_unit(const Args<T>& a, int N, int i, int c, const Smem<T>& sm)
{
    const T dt = a.par[PAR_DT];
    T v[NX];
    const T* lo = sm.su_row(i) + NU * i + c;
    for (int e = 0; e < HALF; ++e) v[e] = lo[e * sm.su_ld(i)];
    for (int e = HALF; e < NX; ++e)
        v[e] = sm.bl[(e - HALF) * sm.n + NU * i + c];
    for (int k = i + 1; k < N; ++k) {
        apply_a(sm.m + 9 * k, dt, v);
        T* blk = sm.su_row(k) + NU * i + c;
        const int ld = sm.su_ld(k);
        for (int e = 0; e < HALF; ++e) blk[e * ld] = v[e];
    }
}

// the free response from x0, x_{k+1} into d (one unit: a chain over k)
template <typename T>
MPCB_FN void free_response_unit(const Args<T>& a, int N, long long b,
                                const Smem<T>& sm)
{
    const T* x0 = a.row(IN_X0, b);
    const T dt = a.par[PAR_DT];
    T x[NX];
    for (int e = 0; e < NX; ++e) x[e] = x0[e];
    for (int k = 0; k < N; ++k) {
        apply_a(sm.m + 9 * k, dt, x);
        x[8] = x[8] + a.par[PAR_C8];
        for (int e = 0; e < NX; ++e) sm.d[k * NX + e] = x[e];
    }
}

// entry u of the drift d = x - x_ref (over d's x), and of g_{N-1} = Q d_{N-1}
template <typename T>
MPCB_FN void drift_unit(const Args<T>& a, int N, long long b, int u,
                        const Smem<T>& sm)
{
    const T v = sm.d[u] - a.row(IN_XREF, b)[u];
    sm.d[u] = v;
    if (u >= (N - 1) * NX) sm.g[u] = sm.qd[u - (N - 1) * NX] * v;
}

// ---- 3. the recursion's step j, first phase, unit u of BLK + NX: (u <
// BLK) entry (r, c) of W_j = S_j B_j over B's rows 6:12 and, for j > 0, of
// T = S_j A_j, both from row r of S_j; else q_j = B_j' g_j over those rows
template <typename T>
MPCB_FN void step_unit(const Args<T>& a, int N, long long b, int j, int u,
                       const Smem<T>& sm)
{
    const T dt = a.par[PAR_DT];
    const T* Bj = sm.bl + NU * j;       // B_j's row 6 + e at Bj + e n
    if (u < BLK) {
        const int r = u / NU, c = u % NU;
        T v = sm.s[r * NX + 6] * Bj[c];
        for (int e = 7; e < NX; ++e)
            v = v + sm.s[r * NX + e] * Bj[(e - HALF) * sm.n + c];
        sm.w[r * sm.n + NU * j + c] = v;
        if (j > 0) sm.t[u] = at_entry(sm.m + 9 * j, dt, sm.s + r * NX, 1, c);
    } else {
        const T* gj = sm.g + j * NX;
        const int c = u - BLK;
        T v = Bj[c] * gj[6];
        for (int e = 7; e < NX; ++e)
            v = v + Bj[(e - HALF) * sm.n + c] * gj[e];
        a.out[OUT_Q][b * N * NU + NU * j + c] = v;
    }
}

// ... second phase (j > 0), unit u of BLK + NX: S_{j-1} = Q + A_j' (S_j A_j),
// g_{j-1} = Q d_{j-1} + A_j' g_j
template <typename T>
MPCB_FN void back_unit(const Args<T>& a, int j, int u, const Smem<T>& sm)
{
    const T dt = a.par[PAR_DT];
    const T* Mj = sm.m + 9 * j;
    if (u < BLK) {
        const int r = u / NX, c = u % NX;
        const T qd = r == c ? sm.qd[r] : (T)0;
        sm.s[u] = qd + at_entry(Mj, dt, sm.t + c, NX, r);
    } else {
        const int e = u - BLK;
        sm.g[(j - 1) * NX + e] = sm.qd[e] * sm.d[(j - 1) * NX + e]
                                 + at_entry(Mj, dt, sm.g + j * NX, 1, e);
    }
}

// ---- 4. four rows of an operand of P's entries: rows 0:6 at lo + e slo,
// rows 6:12 at hi + (e - 6) shi
template <typename T>
struct Rows4 {
    const T* lo;
    int slo;
    const T* hi;
    int shi;

    MPCB_FN const T* at(int e) const
    {
        return e < HALF ? lo + e * slo : hi + (e - HALF) * shi;
    }
};

// the 4 x 4 products acc[r][c] = sum_e R[e][r] C[e][c], each a chain of
// fused multiply-adds over e = 0 ... 11 from the product of term 0
template <typename T>
MPCB_FN void tile_dot(const Rows4<T>& R, const Rows4<T>& C, T acc[4][4])
{
    T rv[4], cv[4];
    load4(R.at(0), rv);
    load4(C.at(0), cv);
    MPCB_UNROLL
    for (int r = 0; r < 4; ++r)
        MPCB_UNROLL
        for (int c = 0; c < 4; ++c) acc[r][c] = rv[r] * cv[c];
    MPCB_UNROLL
    for (int e = 1; e < NX; ++e) {
        load4(R.at(e), rv);
        load4(C.at(e), cv);
        MPCB_UNROLL
        for (int r = 0; r < 4; ++r)
            MPCB_UNROLL
            for (int c = 0; c < 4; ++c)
                acc[r][c] = mb_fma(rv[r], cv[c], acc[r][c]);
    }
}

// the tiles of a row block: 3 quads of rows by 3 N quads of columns
MPCB_FN int row_block_tiles(int N) { return 9 * N; }

// tile u of row block j: rows 12 j + r0 ... r0 + 3, columns 12 i + c0 ...
// c0 + 3.  For i > j the terms Su_{i,j}[e][r] W_i[e][c]; for i < j W_j[e][r]
// Su_{j,i}[e][c]; in the diagonal block B_j[e][min] W_j[e][max] of the row
// and column, then (v + w_force) + pin on the diagonal (every entry and its
// mirror the same terms in the same order: the first design's)
template <typename T>
MPCB_FN void p_tile(const Args<T>& a, int N, long long b, int j, int u,
                    const Smem<T>& sm)
{
    const int n = sm.n, rq = u / (3 * N), cq = u % (3 * N);
    const int i = cq / 3, r0 = 4 * rq, c0 = 4 * (cq % 3);
    // B_j's and W_j's rows at column 12 j + o
    auto b_rows = [&](int k, int o) {
        return Rows4<T>{sm.su_row(k) + NU * k + o, sm.su_ld(k),
                        sm.bl + NU * k + o, n};
    };
    auto w_rows = [&](int k, int o) {
        const T* p = sm.w + NU * k + o;
        return Rows4<T>{p, n, p + HALF * n, n};
    };
    Rows4<T> R, C;
    if (i > j) {
        R = Rows4<T>{sm.su_row(i) + NU * j + r0, sm.su_ld(i),
                     sm.bl + NU * j + r0, n};
        C = w_rows(i, c0);
    } else if (i < j) {
        R = w_rows(j, r0);
        C = Rows4<T>{sm.su_row(j) + NU * i + c0, sm.su_ld(j),
                     sm.bl + NU * i + c0, n};
    } else if (r0 <= c0) {
        R = b_rows(j, r0);
        C = w_rows(j, c0);
    } else {
        R = w_rows(j, r0);
        C = b_rows(j, c0);
    }
    T acc[4][4];
    tile_dot(R, C, acc);
    if (i == j && r0 == c0) {
        // below the diagonal: the mirror's terms, B_j[e][c] W_j[e][r]
        MPCB_UNROLL
        for (int r = 1; r < 4; ++r)
            MPCB_UNROLL
            for (int c = 0; c < r; ++c) acc[r][c] = acc[c][r];
        const T* ct = a.row(IN_CONTACTS, b) + j * FEET;
        MPCB_UNROLL
        for (int k = 0; k < 4; ++k) {
            const T pin = a.par[PAR_W_PIN] * ((T)1 - ct[(c0 + k) / 3]);
            acc[k][k] = (acc[k][k] + a.par[PAR_W_FORCE]) + pin;
        }
    }
    T* P = a.out[OUT_P] + b * n * n + (long long)(NX * j + r0) * n + NU * i
           + c0;
    MPCB_UNROLL
    for (int r = 0; r < 4; ++r) store4(P + (long long)r * n, acc[r]);
}

// the pyramid rows of (step, foot) kf: stance feet get the friction
// pyramid and the normal-force box, swing feet free rows
template <typename T>
MPCB_FN void bounds_unit(const Args<T>& a, int N, long long b, int kf)
{
    const int m = N * FEET * ROWS_PER_FOOT;
    const bool stance = a.row(IN_CONTACTS, b)[kf] > (T)0.5;
    const T inf = a.par[PAR_INF], ninf = -a.par[PAR_INF], zero = (T)0;
    T* l = a.out[OUT_L] + b * m + ROWS_PER_FOOT * kf;
    T* u = a.out[OUT_U] + b * m + ROWS_PER_FOOT * kf;
    l[0] = ninf;
    l[1] = stance ? zero : ninf;
    l[2] = ninf;
    l[3] = stance ? zero : ninf;
    l[4] = stance ? a.par[PAR_FZ_MIN] : ninf;
    u[0] = stance ? zero : inf;
    u[1] = inf;
    u[2] = stance ? zero : inf;
    u[3] = inf;
    u[4] = stance ? a.par[PAR_FZ_MAX] : inf;
}

// ---- the phases of scenario b; `sm` over smem_values(N) values

// the block's first phase: the models (its barrier is the caller's)
template <typename T, class Exec>
MPCB_FN void model_phase(const Exec& ex, const Args<T>& a, int N, long long b,
                         const Smem<T>& sm)
{
    MPCB_UNITS(ex, u, N * FEET) model_unit(a, b, u / FEET, u % FEET, sm);
}

// the producer's start: the free response and S_{N-1} = Q, then the drift
// and g_{N-1} = Q d_{N-1}
template <typename T, class Exec>
MPCB_FN void producer_begin(const Exec& ex, const Args<T>& a, int N,
                            long long b, const Smem<T>& sm)
{
    MPCB_UNITS(ex, u, BLK + 1) {
        if (u < BLK)
            sm.s[u] = u / NU == u % NU ? sm.qd[u / NU] : (T)0;
        else
            free_response_unit(a, N, b, sm);
    }
    ex.sync();
    MPCB_UNITS(ex, u, NX * N) drift_unit(a, N, b, u, sm);
    ex.sync();
}

// the producer's step j: W_j (published once the phase is done), q_j and
// T; then S_{j-1} and g_{j-1}
template <typename T, class Exec>
MPCB_FN void producer_step(const Exec& ex, const Args<T>& a, int N,
                           long long b, int j, const Smem<T>& sm)
{
    MPCB_UNITS(ex, u, BLK + NX) step_unit(a, N, b, j, u, sm);
    ex.sync();
    ex.publish(j);
    if (j == 0) return;
    MPCB_UNITS(ex, u, BLK + NX) back_unit(a, j, u, sm);
    ex.sync();
}

// the consumers' start: Su's columns and the bound rows (the barrier
// before the row blocks is the caller's)
template <typename T, class Exec>
MPCB_FN void consumer_begin(const Exec& ex, const Args<T>& a, int N,
                            long long b, const Smem<T>& sm)
{
    MPCB_UNITS(ex, u, N * NU + N * FEET) {
        if (u < N * NU)
            su_unit(a, N, u / NU, u % NU, sm);
        else
            bounds_unit(a, N, b, u - N * NU);
    }
}

// the consumers' row block j, once W_j is published
template <typename T, class Exec>
MPCB_FN void consumer_rows(const Exec& ex, const Args<T>& a, int N,
                           long long b, int j, const Smem<T>& sm)
{
    MPCB_UNITS(ex, u, row_block_tiles(N)) p_tile(a, N, b, j, u, sm);
}

// each group's whole part, in the card's order
template <typename T, class Exec>
MPCB_FN void producer(const Exec& ex, const Args<T>& a, int N, long long b,
                      const Smem<T>& sm)
{
    producer_begin(ex, a, N, b, sm);
    for (int j = N - 1; j >= 0; --j) producer_step(ex, a, N, b, j, sm);
}

template <typename T, class Exec>
MPCB_FN void consumer(const Exec& ex, const Args<T>& a, int N, long long b,
                      const Smem<T>& sm)
{
    consumer_begin(ex, a, N, b, sm);
    ex.sync();
    for (int j = N - 1; j >= 0; --j) {
        ex.await(j);
        consumer_rows(ex, a, N, b, j, sm);
    }
}

#if !defined(__CUDA_ARCH__)
// the host executor: one thread runs every unit of a phase, in order or
// reversed; a step's W_j is there when the step has run
struct HostExec {
    bool reverse;

    int first(int n) const { return reverse ? n - 1 : 0; }
    int next(int u) const { return reverse ? u - 1 : u + 1; }
    void sync() const {}
    void publish(int) const {}
    void await(int) const {}
};
#endif

}  // namespace mpcb
