// The body of the estimator kernels (est_step.cu): one 1 kHz update of the
// complementary-filter state estimator
// (est/filter.py::estimator_update_reference), and in the tick entry the
// plant's IMU model before it (est/filter.py::imu_from_plant with
// qdd = None):
//
//   gyro  = v_plant[3:6],  accel = g R0(q_plant)[2, :]       (the tick)
//   q     = [q_est[0:7], q_joints]
//   q     = integrate_q(q, [0, gyro, 0], dt);  R0 = R(q)
//   corr  = (|a| > 1e-6 ? alpha_tilt : 0) R0' ((R0 a / max(|a|, 1e-6)) x e_z)
//   q     = integrate_q(q, [0, corr, 0], 1);   R0 = R(q)
//   resid_f = J_f[:, 3:] [gyro, qd]   (the base's angular columns
//             -R0 skew(r_f), r_f = R0' (p_f - p0), and the leg's own
//             columns axis x (p_f - p_joint))
//   v_odo = sum_f c_f (-R0' resid_f) / max(sum c, 1e-6)
//   v_pred = v_est[0:3] + dt (accel - g R0[2, :] - gyro x v_est[0:3])
//   v_lin = sum c > 0.5 ? alpha_vel v_pred + (1 - alpha_vel) v_odo : v_pred
//   xy    = hint ? hint[0:2] : q[0:2] + dt (R0 v_lin)[0:2]
//   z_int = q[2] + dt (R0 v_lin)[2],  z_kin = q[2] - sum_f c_f p_f,z / n
//   z     = sum c > 0.5 ? (1 - alpha_z) z_int + alpha_z z_kin : z_int
//   out:  q' = [xy, z, q[3:]] (19),  v' = [v_lin, gyro, qd] (18)
//
// The legs do not wait for the attitude.  Both attitude steps pass a zero
// linear velocity, so q[0:3] stays the estimate's.  A foot's odometry term
// -R0' resid_f = r_f x gyro - sum_j col_j qd_j, with r_f the foot and
// col_j = axis_j x (p_f - p_j) both in the base frame: R0 cancels.  So each
// leg takes rbd.h's `kin_unit` arithmetic on the identity base pose
// (q = [0, 0, 0, 0, 0, 0, 1, joints]: R0 = I and p0 = 0 exactly, the
// rotation products round to the base-frame values), and only the fusion
// reads the corrected R0: in R0 v_lin and in each foot's world height
// q[2] + R0[2, :] r_f.
//
// A block of S scenarios (est_layout; at most EST_MAX_S), EST_THREADS
// threads, five phases between barriers (`est_block`):
//   1. load: the model's constants the units read, and the block's input
//      rows, a value a unit, consecutive units on consecutive values of a
//      row (asynchronous copies on the card); the pass-through entries
//      straight into the block's output rows (gyro and qd at v'[3:18], the
//      joints at q'[7:19]), the others into the scenario's `EstRow`;
//   2. a unit per (role, scenario), role = warp: warp 0 the IMU model and
//      the attitude chain (`attitude_unit`), warps 1-4 one leg each
//      (`leg_unit`); lane s takes scenario s, so the 32 lanes of a warp
//      run the same code, and the four legs' warps the same code;
//   3. a unit per (entry, scenario): v_lin (`velocity_unit`);
//   4. a unit per (entry, scenario): x, y, z (`position_unit`);
//   5. the block's q' and v' rows (contiguous in the outputs) stored 16
//      bytes a unit (`store_piece`).
// The executors run a phase's units: on the card `BlockExec` (thread t unit
// t, __syncthreads() between phases), on the host `HostExec` (the units
// one after another, in order or reversed), so the CPU tests build this
// arithmetic with g++ (tests/test_torch_est_kernel.py).  No unit reads what
// another unit writes in its own phase.
//
// Code size.  A warp runs its role's code once, so every instruction is
// fetched cold and straight-line code costs its fetch: the loops over the
// integration steps, the legs' levels and the copies are not unrolled, and
// the four legs share one code path (the leg a value, not a template).
//
// Bits.  The plain version takes the rotations and the Jacobian's products
// through `torch.matmul` and sin, cos and sqrt from PyTorch's math library;
// here they are rbd.h's products and the CUDA math library's, and the legs'
// terms are formed in the base frame (their columns' sum through w and m,
// `leg_unit`): held to it within a tolerance.  The
// library is built with -fmad=false, so that the elementwise products and
// sums round as the plain version's ops do.

#pragma once

#include <stdint.h>
#include <string.h>

#include "rbd.h"

namespace rbd {
namespace est {

// operands, in the order of the launcher's arrays: each input a first row
// and a stride between scenarios (rbd::Args; an input the entry does not
// read may be null), each output contiguous (B, ...).  The update reads
// gyro, accel, the joints' positions and rates; the tick reads gyro, the
// joints and the plant's configuration (its IMU model), not accel.  The
// hint, a base position (3), is read where EP_HINT is set.
enum In {
    EI_Q, EI_V, EI_GYRO, EI_ACCEL, EI_QJ, EI_QDJ, EI_CONTACTS, EI_HINT,
    EI_PLANT_Q, EI_COUNT
};
enum Out { EO_Q, EO_V, EO_COUNT };
// dt, the gains and their complements (1 - alpha, formed by the caller in
// double as the plain chain's scalars are), the hint flag
enum Par {
    EP_DT, EP_ALPHA_TILT, EP_ALPHA_VEL, EP_BETA_VEL, EP_ALPHA_Z, EP_BETA_Z,
    EP_HINT, EP_COUNT
};

// what dyn/kernels.py checks (EST_LAYOUT): after rbd.h's own counts, the
// estimator's inputs, outputs and parameters
inline int layout(int what)
{
    if (what < L_PLANT_PAR + 1) return ::rbd::layout(what);
    switch (what - (L_PLANT_PAR + 1)) {
    case 0: return EI_COUNT;
    case 1: return EO_COUNT;
    case 2: return EP_COUNT;
    default: return -1;
    }
}

template <typename T> using EstArgs = Args<T, EI_COUNT, EO_COUNT, EP_COUNT>;

constexpr int EST_MAX_S = 32;             // scenarios a block at most
constexpr int EST_ROLES = 5;              // warp 0 the attitude, 1-4 legs
constexpr int EST_THREADS = EST_ROLES * WARP;

// a scenario's values in the block's shared memory, an odd number of them
// (lane s of a phase-2 warp on row s: no two lanes on one bank)
template <typename T>
struct EstRow {
    T q[7];        // est.q[0:7]
    T v[3];        // est.v[0:3]
    T quat[4];     // the plant's quaternion (the tick's IMU model)
    T c[4];        // the contact flags
    T hint[2];     // the hint's x and y
    T acc[3];      // the accelerometer (the tick's model, else the input)
    T R0[9];       // the corrected attitude
    T odo[4][3];   // each foot's odometry term, base frame
    T foot[4][3];  // each foot, base frame
    T pad;
};
constexpr int EST_ROW_VALUES = 57;
static_assert(sizeof(EstRow<double>) == EST_ROW_VALUES * sizeof(double)
                  && sizeof(EstRow<float>) == EST_ROW_VALUES * sizeof(float),
              "a row of EST_ROW_VALUES values");

// the block's shared memory, in values of a `size`-byte type: the q' rows
// and the v' rows of S scenarios, each with room to start as far past a
// 16-byte boundary as its rows in the output do (16 bytes rounded up), then
// S rows, then the model's constants (rbd.h's Const layout; the units read
// the placements, the feet, the axes and gravity)
RBD_FN constexpr int est_round16(int values, int size)
{
    return (values * size + 15) / 16 * 16 / size;
}
RBD_FN constexpr int est_smem_values(int S, int size)
{
    return est_round16(NQ * S + 16 / size, size)
           + est_round16(NV * S + 16 / size, size) + EST_ROW_VALUES * S
           + C_SIZE;
}
RBD_FN constexpr int est_smem_bytes(int S, int size)
{
    return est_smem_values(S, size) * size;
}
static_assert(est_smem_bytes(EST_MAX_S, 8) <= 48 * 1024,
              "a block's shared memory within the default 48 KB");

// scenarios a block (dyn/kernels.py::est_layout computes the same): B
// spread over the `n_sm` multiprocessors, at most EST_MAX_S, no more than
// fit in `smem` bytes; 0 when one does not
inline int est_scenarios(long long B, int smem, int n_sm, int size)
{
    long long S = (B + (n_sm > 0 ? n_sm : 1) - 1) / (n_sm > 0 ? n_sm : 1);
    if (S > EST_MAX_S) S = EST_MAX_S;
    if (S < 1) S = 1;
    while (S > 1 && est_smem_bytes((int)S, size) > smem) --S;
    return est_smem_bytes((int)S, size) <= smem ? (int)S : 0;
}

// the executors.  EST_EACH(ex, u, n) runs its body once for each unit
// u < n the executor gives this thread.
#define EST_EACH(ex, u, n)                                                  \
    for (int u##_i = (ex).first(), u = (ex).unit(u##_i, (n)); u##_i < (n); \
         u##_i += (ex).step(), u = (ex).unit(u##_i, (n)))

// copy_rows<W>(ex, src, stride, n, dst, dst_stride): W values of each of n
// rows, from src (the first row; stride between rows) to dst (dst_stride
// between rows), a value a unit, consecutive units on consecutive values of
// a row.  On the host each value in turn; on the card an asynchronous copy
// (cp.async) from device to shared memory each, which copy_wait(ex) waits
// for: the block's inputs in one trip to device memory.
#if defined(__CUDACC__)
struct BlockExec {
    __device__ int first() const { return threadIdx.x; }
    __device__ int step() const { return blockDim.x; }
    __device__ int unit(int i, int) const { return i; }
    __device__ void sync() const { __syncthreads(); }
};

template <int W, typename T>
__device__ __forceinline__ void copy_rows(const BlockExec&, const T* src,
                                          long long stride, int n, T* dst,
                                          int dst_stride)
{
    RBD_UNROLL_BY(1)
    for (int u = threadIdx.x; u < W * n; u += blockDim.x) {
        const int s = u / W, i = u % W;
        const unsigned d =
            (unsigned)__cvta_generic_to_shared(dst + s * dst_stride + i);
        const T* p = src + s * stride + i;
        if (sizeof(T) == 8)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                         :: "r"(d), "l"(p) : "memory");
        else
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                         :: "r"(d), "l"(p) : "memory");
    }
}

__device__ __forceinline__ void copy_wait(const BlockExec&)
{
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}
#endif

#if !defined(__CUDA_ARCH__)
// the host executor: one thread runs every unit, in order or reversed
struct HostExec {
    bool reverse;
    int first() const { return 0; }
    int step() const { return 1; }
    int unit(int i, int n) const { return reverse ? n - 1 - i : i; }
    void sync() const {}
};

template <int W, typename T, class Exec>
inline void copy_rows(const Exec& ex, const T* src, long long stride, int n,
                      T* dst, int dst_stride)
{
    EST_EACH(ex, u, W * n) {
        const int s = u / W, i = u % W;
        dst[s * dst_stride + i] = src[s * stride + i];
    }
}

template <class Exec>
inline void copy_wait(const Exec&) {}
#endif

// phase 2, role 0: the IMU (the tick) and the attitude chain: the corrected
// quaternion into the q' row, R0 and the accelerometer into the scenario's
// row.  The two integration steps are one loop's two turns (the gyro's over
// dt, then the tilt correction's over 1), so that their code is fetched
// once.
template <bool IMU, typename T>
RBD_FN void attitude_unit(const T* C, const EstArgs<T>& a, EstRow<T>& r,
                          T* qo, const T* vo)
{
    T acc[3];
    if (IMU) {
        T Rp[9];
        quat_to_rot(r.quat, Rp);
        for (int i = 0; i < 3; ++i) acc[i] = C[C_GRAV] * Rp[6 + i];
    } else {
        for (int i = 0; i < 3; ++i) acc[i] = r.acc[i];
    }
    const T a_norm = r_sqrt(acc[0] * acc[0] + acc[1] * acc[1]
                            + acc[2] * acc[2]);
    // torch.clamp_min: NaN stays NaN
    const T den = a_norm < T(1e-6) ? T(1e-6) : a_norm;
    const T gain = a_norm > T(1e-6) ? a.par[EP_ALPHA_TILT] : T(0);
    T q[7], w[3] = {vo[3], vo[4], vo[5]}, h = a.par[EP_DT];
    for (int i = 0; i < 7; ++i) q[i] = r.q[i];
    RBD_UNROLL_BY(1)
    for (int step = 0;; ++step) {
        const T v[6] = {T(0), T(0), T(0), w[0], w[1], w[2]};
        integrate_base(v, h, q);
        T R[9];
        quat_to_rot(q + 3, R);
        if (step == 1) {
            for (int i = 0; i < 9; ++i) r.R0[i] = R[i];
            break;
        }
        // the tilt correction toward the accelerometer's gravity direction
        T an[3], gm[3], tilt[3], c[3];
        for (int i = 0; i < 3; ++i) an[i] = acc[i] / den;
        mv3(R, an, gm);
        const T e_z[3] = {T(0), T(0), T(1)};
        cross(gm, e_z, tilt);
        mtv3(R, tilt, c);
        for (int i = 0; i < 3; ++i) w[i] = gain * c[i];
        h = T(1);
    }
    for (int i = 0; i < 4; ++i) qo[3 + i] = q[3 + i];
    if (IMU)
        for (int i = 0; i < 3; ++i) r.acc[i] = acc[i];
}

// phase 2, role 1 + leg: the leg's kinematics on the identity base pose
// (rbd.h's `kin_unit` at q = [0, 0, 0, 0, 0, 0, 1, joints], op for op: R0 =
// I exactly, so the rotations and positions are the base frame's), the
// foot's odometry term r x gyro - sum_j col_j qd_j (r the foot, col_j joint
// j's axis a_j x (r - p_j)) and the foot itself into the scenario's row.
// The levels are a loop that carries the sums w = sum_j qd_j a_j and
// m = sum_j qd_j (a_j x p_j), so that sum_j col_j qd_j = w x r - m and the
// term is r x (gyro + w) + m: the loop keeps nothing a level (its code is
// fetched once, its values stay in registers).
template <typename T>
RBD_FN void leg_unit(int leg, const T* C, const T* qo, const T* vo,
                     EstRow<T>& r)
{
    const T* qd = vo + 6 + 3 * leg;
    T Rp[9] = {T(1), T(0), T(0), T(0), T(1), T(0), T(0), T(0), T(1)};
    T pp[3] = {T(0), T(0), T(0)}, w[3] = {T(0), T(0), T(0)},
      m[3] = {T(0), T(0), T(0)};
    RBD_UNROLL_BY(1)
    for (int lvl = 0; lvl < 3; ++lvl) {
        T sn, cs, Rr[9], Rw[9], d[3], ax[3], axp[3];
        r_sincos(qo[7 + 3 * leg + lvl], &sn, &cs);
        const int a = axis_of(C, lvl);
        axis_rot(a, cs, sn, Rr);
        mv3(Rp, placement(C, lvl, leg), d);
        for (int i = 0; i < 3; ++i) pp[i] = pp[i] + d[i];
        mm3(Rp, Rr, Rw);
        for (int i = 0; i < 3; ++i) ax[i] = pick3(Rw + 3 * i, a);
        cross(ax, pp, axp);
        for (int i = 0; i < 3; ++i) {
            w[i] = w[i] + qd[lvl] * ax[i];
            m[i] = m[i] + qd[lvl] * axp[i];
        }
        for (int i = 0; i < 9; ++i) Rp[i] = Rw[i];
    }
    T d[3], pf[3], gw[3], t[3];
    mv3(Rp, C + C_FOOT + 3 * leg, d);
    for (int i = 0; i < 3; ++i) {
        pf[i] = pp[i] + d[i];
        gw[i] = vo[3 + i] + w[i];
    }
    cross(pf, gw, t);
    for (int i = 0; i < 3; ++i) {
        r.odo[leg][i] = t[i] + m[i];
        r.foot[leg][i] = pf[i];
    }
}

// sum c and max(sum c, 1e-6) of a contact row (torch.clamp_min)
template <typename T>
RBD_FN void stance_sum(const T* c, T* c_sum, T* n_st)
{
    const T s = ((c[0] + c[1]) + c[2]) + c[3];
    *c_sum = s;
    *n_st = s < T(1e-6) ? T(1e-6) : s;
}

// phase 3, unit (j, s): v_lin[j] into scenario s's v' row
template <typename T>
RBD_FN void velocity_unit(int j, const T* C, const EstArgs<T>& a,
                          const EstRow<T>& r, T* vo)
{
    const T* c = r.c;
    T c_sum, n_st;
    stance_sum(c, &c_sum, &n_st);
    // (gyro x v)[j] as rbd.h's `cross` forms it
    const T* g = vo + 3;
    const int j1 = j == 2 ? 0 : j + 1, j2 = j == 0 ? 2 : j - 1;
    const T gxv = g[j1] * r.v[j2] - g[j2] * r.v[j1];
    const T v_odo = (((r.odo[0][j] * c[0] + r.odo[1][j] * c[1])
                      + r.odo[2][j] * c[2]) + r.odo[3][j] * c[3]) / n_st;
    const T a_local = r.acc[j] - C[C_GRAV] * r.R0[6 + j];
    const T v_pred = r.v[j] + a.par[EP_DT] * (a_local - gxv);
    vo[j] = c_sum > T(0.5)
        ? a.par[EP_ALPHA_VEL] * v_pred + a.par[EP_BETA_VEL] * v_odo
        : v_pred;
}

// phase 4, unit (j, s): x (j = 0), y (1) or z (2) into scenario s's q' row
template <typename T>
RBD_FN void position_unit(int j, const EstArgs<T>& a, const EstRow<T>& r,
                          T* qo, const T* vo)
{
    const T* R0 = r.R0;
    const T vw = R0[3 * j] * vo[0] + R0[3 * j + 1] * vo[1]
                 + R0[3 * j + 2] * vo[2];
    const T dt = a.par[EP_DT];
    if (j < 2) {
        qo[j] = a.par[EP_HINT] != T(0) ? r.hint[j] : r.q[j] + dt * vw;
        return;
    }
    const T* c = r.c;
    T c_sum, n_st;
    stance_sum(c, &c_sum, &n_st);
    T fz = T(0);
    for (int f = 0; f < 4; ++f) {
        const T* p = r.foot[f];
        const T z = r.q[2] + ((R0[6] * p[0] + R0[7] * p[1]) + R0[8] * p[2]);
        fz = f == 0 ? z * c[0] : fz + z * c[f];
    }
    const T z_kin = r.q[2] - fz / n_st;
    const T z_int = r.q[2] + dt * vw;
    qo[2] = c_sum > T(0.5)
        ? a.par[EP_BETA_Z] * z_int + a.par[EP_ALPHA_Z] * z_kin
        : z_int;
}

// phase 5, unit p: the p-th 16-byte piece of the staging `src`, which
// holds n values at [m, m + n) (src 16-byte aligned; dst, their place in
// the output, m values past a 16-byte boundary); a piece that reaches past
// either end value by value
template <typename T>
RBD_FN void store_piece(const T* src, T* dst, int m, int n, int p)
{
    constexpr int V = 16 / (int)sizeof(T);
    const int lo = p * V, hi = lo + V;
    if (lo >= m && hi <= m + n) {
#if defined(__CUDA_ARCH__)
        *reinterpret_cast<int4*>(dst + (lo - m)) =
            *reinterpret_cast<const int4*>(src + lo);
#else
        memcpy(dst + (lo - m), src + lo, 16);
#endif
        return;
    }
    for (int i = lo < m ? m : lo; i < hi && i < m + n; ++i)
        dst[i - m] = src[i];
}

// values by which p lies past a 16-byte boundary
template <typename T>
RBD_FN int past16(const T* p)
{
    return (int)((uintptr_t)p % 16 / sizeof(T));
}

// block `blk` of S scenarios (its last block fewer) on `smem`
// (est_smem_values(S) values, 16-byte aligned); the IMU model first where
// IMU
template <bool IMU, typename T, class Exec>
RBD_FN void est_block(const Exec& ex, const T* C, const EstArgs<T>& a,
                      long long B, int S, long long blk, T* smem)
{
    const long long b0 = blk * S;
    const int n = B - b0 < S ? (int)(B - b0) : S;
    T* const qout = a.out[EO_Q] + b0 * NQ;
    T* const vout = a.out[EO_V] + b0 * NV;
    const int mq = past16(qout), mv = past16(vout);
    constexpr int V = 16 / (int)sizeof(T);
    T* const qs = smem + mq;     // the q' rows
    T* const vs = smem + est_round16(NQ * S + V, sizeof(T)) + mv;
    EstRow<T>* const rows = reinterpret_cast<EstRow<T>*>(
        smem + est_round16(NQ * S + V, sizeof(T))
        + est_round16(NV * S + V, sizeof(T)));
    T* const cs = rows[0].q + EST_ROW_VALUES * S;   // the constants' copy
    // the constants the units read (the placements and the feet, the axes
    // and gravity), then the inputs' rows
    constexpr int RW = EST_ROW_VALUES;
    copy_rows<C_FOOT + 12>(ex, C, 0, 1, cs, 0);
    copy_rows<C_SIZE - C_AXIS>(ex, C + C_AXIS, 0, 1, cs + C_AXIS, 0);
    copy_rows<7>(ex, a.row(EI_Q, b0), a.stride[EI_Q], n, rows[0].q, RW);
    copy_rows<3>(ex, a.row(EI_V, b0), a.stride[EI_V], n, rows[0].v, RW);
    copy_rows<3>(ex, a.row(EI_GYRO, b0), a.stride[EI_GYRO], n, vs + 3, NV);
    copy_rows<12>(ex, a.row(EI_QDJ, b0), a.stride[EI_QDJ], n, vs + 6, NV);
    copy_rows<12>(ex, a.row(EI_QJ, b0), a.stride[EI_QJ], n, qs + 7, NQ);
    if (IMU)
        copy_rows<4>(ex, a.row(EI_PLANT_Q, b0) + 3, a.stride[EI_PLANT_Q], n,
                     rows[0].quat, RW);
    else
        copy_rows<3>(ex, a.row(EI_ACCEL, b0), a.stride[EI_ACCEL], n,
                     rows[0].acc, RW);
    copy_rows<4>(ex, a.row(EI_CONTACTS, b0), a.stride[EI_CONTACTS], n,
                 rows[0].c, RW);
    if (a.par[EP_HINT] != T(0))
        copy_rows<2>(ex, a.row(EI_HINT, b0), a.stride[EI_HINT], n,
                     rows[0].hint, RW);
    copy_wait(ex);
    ex.sync();
    EST_EACH(ex, u, EST_THREADS) {
        const int role = u / WARP, s = u % WARP;
        if (s >= n) continue;
        if (role == 0)
            attitude_unit<IMU>(cs, a, rows[s], qs + s * NQ, vs + s * NV);
        else
            leg_unit(role - 1, cs, qs + s * NQ, vs + s * NV, rows[s]);
    }
    ex.sync();
    EST_EACH(ex, u, 3 * n) {
        const int s = u % n;
        velocity_unit(u / n, cs, a, rows[s], vs + s * NV);
    }
    ex.sync();
    EST_EACH(ex, u, 3 * n) {
        const int s = u % n;
        position_unit(u / n, a, rows[s], qs + s * NQ, vs + s * NV);
    }
    ex.sync();
    const int pq = (mq + NQ * n + V - 1) / V, pv = (mv + NV * n + V - 1) / V;
    EST_EACH(ex, p, pq + pv) {
        if (p < pq) store_piece(smem, qout, mq, NQ * n, p);
        else store_piece(vs - mv, vout, mv, NV * n, p - pq);
    }
}

}  // namespace est
}  // namespace rbd
