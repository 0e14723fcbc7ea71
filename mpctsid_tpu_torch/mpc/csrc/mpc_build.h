// The per-scenario body of the MPC QP build kernel (mpc_build.cu):
// mpc/srb.py's `build_mpc_qp`, the condensed centroidal MPC QP (P, q, l, u)
// of one scenario over its horizon's structure.
//
// Plain C++: every function is marked MPCB_FN, `__host__ __device__` under
// nvcc and plain `inline` under a host compiler, so the tests build this
// very arithmetic with g++ and run it on the CPU
// (tests/test_torch_mpc_build_kernel.py).  The body runs in phases over
// units (`MPCB_UNITS(ex, u, count)`) with a barrier between phases
// (`ex.sync()`): on the card (mpc_build.cu's BlockExec) a block's threads
// take the units in turn and the barrier is __syncthreads(); on the host
// (HostExec) one thread runs every unit of a phase, in order or reversed.
// A unit never reads what another unit writes in its own phase.
//
// What it computes, per scenario (A_k = I + E_k is the one-step model of
// step k: dt I at (0:3, 6:9), M_k = dt Rz_k' at (3:6, 9:12); Q = diag(q)):
//
//   1. the N one-step models (srb_discrete): M_k, and B_k (rows 6:9 dt / m
//      per foot, rows 9:12 dt I_w^-1 [r_f]x with the closed-form inverse of
//      the world inertia Rz I_b Rz'), B_k kept as Su's diagonal block;
//   2. the drift: x_{k+1} = A_k x_k + c_k from x0, d_k = x_{k+1} - x_ref_k;
//      and Su's blocks Su_{k,j} = A_k ... A_{j+1} B_j (j < k), a thread a
//      column of B_j walking k;
//   3. backwards, S_{N-1} = Q, S_j = Q + A_{j+1}' S_{j+1} A_{j+1}, g_{N-1}
//      = Q d_{N-1}, g_j = Q d_j + A_{j+1}' g_{j+1}; W_j = S_j B_j and
//      q_j = B_j' g_j (the sums over B's nonzero rows 6:12);
//   4. P_ij = Su_{j,i}' W_j for i <= j, every entry a 12-term dot product of
//      a column of a Su block and a column of a W block, P_ji = P_ij' by the
//      same expression (so P is exactly symmetric); the diagonal
//      (P_ii + w_force) + pin, in the plain version's order; the bound rows
//      l and u by the plain version's selects on contacts > 0.5.
//
// Bits.  P and q are the plain version's function in another order of
// sums (its P is Su' diag(Q) Su by cuBLAS, not even exactly symmetric):
// held to it within a tolerance, in float32 against the float64 plain
// version.  Each dot product is a chain of fused multiply-adds in a fixed
// order (`dot12`), so two launches agree bit for bit and an entry and its
// mirror are the same value.  l and u are the plain version's bit for bit.
//
// Shapes: x0 (12), x_ref (N, 12), feet (N, 4, 3), contacts (N, 4), mass
// (1, optional) a scenario, each a first row plus a stride in elements (0
// for a row shared by every scenario); P (n, n), q (n), l, u (m)
// contiguous, n = 12 N, m = 20 N.

#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define MPCB_FN __host__ __device__ __forceinline__
#else
#define MPCB_FN inline
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
constexpr int THREADS = 384;    // a block's threads: two rows of P at once

// ---- operands, in the order of the launcher's arrays
enum In { IN_X0, IN_XREF, IN_FEET, IN_CONTACTS, IN_MASS, IN_COUNT };
enum Out { OUT_P, OUT_Q, OUT_L, OUT_U, OUT_COUNT };
// dt; c_8 = -dt g; w_force; the ridge w_pin; fz_min, fz_max; the finite
// infinity of the bounds; dt / model mass; 1 if the mass input is given;
// diag(Q) (12); the body inertia I_b (3 x 3, row-major)
enum Par { PAR_DT, PAR_C8, PAR_W_FORCE, PAR_W_PIN, PAR_FZ_MIN, PAR_FZ_MAX,
           PAR_INF, PAR_DT_OVER_M, PAR_HAS_MASS, PAR_Q,
           PAR_IB = PAR_Q + NX, PAR_COUNT = PAR_IB + 9 };

// inputs, outputs, parameters, threads a block (mpc/kernels.py::LAYOUT;
// -1 past the end)
inline int layout(int what)
{
    const int counts[] = {IN_COUNT, OUT_COUNT, PAR_COUNT, THREADS};
    return what >= 0 && what < (int)(sizeof(counts) / sizeof(int))
               ? counts[what] : -1;
}

// Su's blocks before block row j: block (j, i), j >= i, is tri(j) + i
MPCB_FN int tri(int j) { return j * (j + 1) / 2; }

// values of a scenario's shared memory: Su's N (N + 1) / 2 blocks, the N
// W_j, S and S A_j, the N M_k (3 x 3), the drifts d and the g_j (N x 12)
MPCB_FN long long smem_values(int N)
{
    return (long long)(tri(N) + N + 2) * BLK + 9LL * N + 2LL * NX * N;
}

template <typename T>
struct Smem {
    T* su;
    T* w;
    T* s;
    T* t;
    T* m;
    T* d;
    T* g;

    MPCB_FN Smem(T* base, int N)
        : su(base), w(su + (long long)tri(N) * BLK), s(w + N * BLK),
          t(s + BLK), m(t + BLK), d(m + 9 * N), g(d + NX * N)
    {
    }
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

// sum_e x[e sx] y[e sy] over the 12 rows, a chain of fused multiply-adds
// from e = 0: every entry of P and its mirror go through it alike
template <typename T>
MPCB_FN T dot12(const T* x, int sx, const T* y, int sy)
{
    T acc = x[0] * y[0];
    for (int e = 1; e < NX; ++e) acc = mb_fma(x[e * sx], y[e * sy], acc);
    return acc;
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

// ---- 1. step k's model as seen from foot f: B_k's columns 3f:3f+3 into
// Su's diagonal block k, and (f = 0) M_k
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
    T* Bk = sm.su + (long long)(tri(k) + k) * BLK;
    for (int j = 0; j < 3; ++j) {
        const int col = 3 * f + j;
        for (int e = 0; e < 6; ++e) Bk[e * NU + col] = (T)0;
        for (int e = 0; e < 3; ++e)
            Bk[(6 + e) * NU + col] = e == j ? bv : (T)0;
        for (int e = 0; e < 3; ++e)
            Bk[(9 + e) * NU + col] =
                dt * (inv[3 * e] * K[j] + inv[3 * e + 1] * K[3 + j]
                      + inv[3 * e + 2] * K[6 + j]);
    }
    if (f == 0)
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j)
                sm.m[9 * k + 3 * i + j] = dt * R[3 * j + i];
}

// ---- 2. column c of Su's block column i: B_i's column, then A_k applied
// for k = i + 1 ... N - 1, each written into block (k, i)
template <typename T>
MPCB_FN void su_unit(const Args<T>& a, int N, int i, int c, const Smem<T>& sm)
{
    const T dt = a.par[PAR_DT];
    T v[NX];
    const T* Bi = sm.su + (long long)(tri(i) + i) * BLK;
    for (int e = 0; e < NX; ++e) v[e] = Bi[e * NU + c];
    for (int k = i + 1; k < N; ++k) {
        apply_a(sm.m + 9 * k, dt, v);
        T* blk = sm.su + (long long)(tri(k) + i) * BLK;
        for (int e = 0; e < NX; ++e) blk[e * NU + c] = v[e];
    }
}

// the free response from x0 and its drift from the reference
template <typename T>
MPCB_FN void drift_unit(const Args<T>& a, int N, long long b,
                        const Smem<T>& sm)
{
    const T* x0 = a.row(IN_X0, b);
    const T* xr = a.row(IN_XREF, b);
    const T dt = a.par[PAR_DT];
    T x[NX];
    for (int e = 0; e < NX; ++e) x[e] = x0[e];
    for (int k = 0; k < N; ++k) {
        apply_a(sm.m + 9 * k, dt, x);
        x[8] = x[8] + a.par[PAR_C8];
        for (int e = 0; e < NX; ++e) sm.d[k * NX + e] = x[e] - xr[k * NX + e];
    }
}

// ---- 4. rows 12 i ... 12 i + 11 of P at column col
template <typename T>
MPCB_FN void p_unit(const Args<T>& a, int N, long long b, int i, int col,
                    const Smem<T>& sm)
{
    const int n = N * NU, j = col / NU, c = col % NU;
    T* P = a.out[OUT_P] + b * n * n + (long long)(NX * i) * n + col;
    if (j > i) {
        // P_ij[r][c] = Su_{j,i}[:, r] . W_j[:, c]
        const T* su = sm.su + (long long)(tri(j) + i) * BLK;
        T y[NX];
        for (int e = 0; e < NX; ++e) y[e] = sm.w[j * BLK + e * NU + c];
        for (int r = 0; r < NX; ++r)
            P[(long long)r * n] = dot12(su + r, NU, y, 1);
    } else if (j < i) {
        // P_ij = P_ji': P_ij[r][c] = Su_{i,j}[:, c] . W_i[:, r]
        const T* su = sm.su + (long long)(tri(i) + j) * BLK;
        T x[NX];
        for (int e = 0; e < NX; ++e) x[e] = su[e * NU + c];
        for (int r = 0; r < NX; ++r)
            P[(long long)r * n] = dot12(x, 1, sm.w + i * BLK + r, NU);
    } else {
        // the diagonal block B_i' S_i B_i: its upper triangle as above,
        // the lower one as the mirror's expression
        const T* su = sm.su + (long long)(tri(i) + i) * BLK;
        const T* w = sm.w + i * BLK;
        const T pin = a.par[PAR_W_PIN]
                      * ((T)1 - a.row(IN_CONTACTS, b)[i * FEET + c / 3]);
        for (int r = 0; r < NX; ++r) {
            T v = r <= c ? dot12(su + r, NU, w + c, NU)
                         : dot12(su + c, NU, w + r, NU);
            if (r == c) v = (v + a.par[PAR_W_FORCE]) + pin;
            P[(long long)r * n] = v;
        }
    }
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

// ---- the scenario b, in phases over the executor's units; `base` holds
// smem_values(N) values
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <typename T, class Exec>
MPCB_FN void build_scenario(const Exec& ex, const Args<T>& a, int N,
                            long long b, T* base)
{
    const Smem<T> sm(base, N);
    const int n = N * NU;
    const T dt = a.par[PAR_DT];
    const T* Q = a.par + PAR_Q;
    T* q = a.out[OUT_Q] + b * n;

    MPCB_UNITS(ex, u, N * FEET) model_unit(a, b, u / FEET, u % FEET, sm);
    ex.sync();
    MPCB_UNITS(ex, u, N * NU + 1) {
        if (u < N * NU)
            su_unit(a, N, u / NU, u % NU, sm);
        else
            drift_unit(a, N, b, sm);
    }
    ex.sync();
    // S_{N-1} = Q, g_{N-1} = Q d_{N-1}
    MPCB_UNITS(ex, u, BLK + NX) {
        if (u < BLK)
            sm.s[u] = u / NU == u % NU ? Q[u / NU] : (T)0;
        else
            sm.g[(N - 1) * NX + u - BLK] =
                Q[u - BLK] * sm.d[(N - 1) * NX + u - BLK];
    }
    ex.sync();
    for (int j = N - 1;; --j) {
        const T* Bj = sm.su + (long long)(tri(j) + j) * BLK;
        const T* gj = sm.g + j * NX;
        const T* Mj = sm.m + 9 * j;
        // W_j = S_j B_j and q_j = B_j' g_j over B's rows 6:12; T = S_j A_j
        MPCB_UNITS(ex, u, 2 * BLK + NX) {
            if (u < BLK) {
                const int r = u / NU, c = u % NU;
                T v = sm.s[r * NX + 6] * Bj[6 * NU + c];
                for (int e = 7; e < NX; ++e)
                    v = v + sm.s[r * NX + e] * Bj[e * NU + c];
                sm.w[j * BLK + u] = v;
            } else if (u < 2 * BLK) {
                const int e = u - BLK;
                if (j > 0) sm.t[e] = at_entry(Mj, dt, sm.s + (e / NX) * NX,
                                              1, e % NX);
            } else {
                const int c = u - 2 * BLK;
                T v = Bj[6 * NU + c] * gj[6];
                for (int e = 7; e < NX; ++e) v = v + Bj[e * NU + c] * gj[e];
                q[NU * j + c] = v;
            }
        }
        if (j == 0) break;
        ex.sync();
        // S_{j-1} = Q + A_j' (S_j A_j), g_{j-1} = Q d_{j-1} + A_j' g_j
        MPCB_UNITS(ex, u, BLK + NX) {
            if (u < BLK) {
                const int r = u / NX, c = u % NX;
                const T qd = r == c ? Q[r] : (T)0;
                sm.s[u] = qd + at_entry(Mj, dt, sm.t + c, NX, r);
            } else {
                const int e = u - BLK;
                sm.g[(j - 1) * NX + e] = Q[e] * sm.d[(j - 1) * NX + e]
                                         + at_entry(Mj, dt, gj, 1, e);
            }
        }
        ex.sync();
    }
    ex.sync();
    MPCB_UNITS(ex, u, N * n + N * FEET) {
        if (u < N * n)
            p_unit(a, N, b, u / n, u % n, sm);
        else
            bounds_unit(a, N, b, u - N * n);
    }
}

#if !defined(__CUDA_ARCH__)
// the host executor: one thread runs every unit of a phase, in order or
// reversed
struct HostExec {
    bool reverse;

    int first(int n) const { return reverse ? n - 1 : 0; }
    int next(int u) const { return reverse ? u - 1 : u + 1; }
    void sync() const {}
};
#endif

}  // namespace mpcb
