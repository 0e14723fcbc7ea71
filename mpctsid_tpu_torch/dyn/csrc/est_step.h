// The per-scenario body of the estimator kernels (est_step.cu): one 1 kHz
// update of the complementary-filter state estimator
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
// A warp per scenario.  Lane 0 takes the IMU and the attitude chain (two
// integration steps through rbd.h's `integrate_base`, the plant's own),
// lanes 1-12 the joints; then lanes 0-3 run rbd.h's `kin_unit` on the
// corrected configuration, one leg each (the leg kinematics once, where
// the plain chain builds them twice: foot_jacobians and foot_positions);
// lanes 0-3 then take their foot's residual velocity, its odometry term
// and height; then the fusion a lane an entry.  The phases run through
// rbd.h's executors: on the card `WarpExec` (`__syncwarp()` between
// phases), on the host `HostExec` (the 32 lanes one after another, in
// either order), so the CPU tests build this arithmetic with g++
// (tests/test_torch_est_kernel.py).  No unit reads what another lane
// writes in its own phase.
//
// Bits.  The plain version takes the rotations and the Jacobian's products
// through `torch.matmul` and sin, cos and sqrt from PyTorch's math library;
// here they are rbd.h's products and the CUDA math library's: held to it
// within a tolerance.  The library is built with -fmad=false, so that the
// elementwise products and sums round as the plain version's ops do.

#pragma once

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

// a warp's slot of shared memory
template <typename T>
struct EstSlot {
    Kin<T> k;      // the corrected configuration's leg kinematics
    T q[NQ];       // the corrected configuration
    T gyro[3], accel[3];
    T vodo[4][3];  // each foot's odometry term -R0' resid_f
    T fz[4];       // each foot's height
    T vlin[3];     // the fused linear velocity
};

// lane 0: the IMU (the tick) and the attitude chain into S.q[0:7], S.gyro,
// S.accel
template <bool IMU, typename T>
RBD_FN void attitude_unit(const T* C, const EstArgs<T>& a, long long b,
                          EstSlot<T>& S)
{
    const T* g = a.row(EI_GYRO, b);
    T acc[3];
    if (IMU) {
        T Rp[9];
        quat_to_rot(a.row(EI_PLANT_Q, b) + 3, Rp);
        for (int i = 0; i < 3; ++i) acc[i] = C[C_GRAV] * Rp[6 + i];
    } else {
        for (int i = 0; i < 3; ++i) acc[i] = a.row(EI_ACCEL, b)[i];
    }
    const T* qe = a.row(EI_Q, b);
    T q[7];
    for (int i = 0; i < 7; ++i) q[i] = qe[i];
    const T dt = a.par[EP_DT];
    const T vg[6] = {T(0), T(0), T(0), g[0], g[1], g[2]};
    integrate_base(vg, dt, q);
    // the tilt correction toward the accelerometer's gravity direction
    T R[9], an[3], gm[3], tilt[3], c[3];
    quat_to_rot(q + 3, R);
    const T a_norm = r_sqrt(acc[0] * acc[0] + acc[1] * acc[1]
                            + acc[2] * acc[2]);
    // torch.clamp_min: NaN stays NaN
    const T den = a_norm < T(1e-6) ? T(1e-6) : a_norm;
    for (int i = 0; i < 3; ++i) an[i] = acc[i] / den;
    mv3(R, an, gm);
    const T e_z[3] = {T(0), T(0), T(1)};
    cross(gm, e_z, tilt);
    const T gain = a_norm > T(1e-6) ? a.par[EP_ALPHA_TILT] : T(0);
    mtv3(R, tilt, c);
    const T vc[6] = {T(0), T(0), T(0), gain * c[0], gain * c[1],
                     gain * c[2]};
    integrate_base(vc, T(1), q);
    for (int i = 0; i < 7; ++i) S.q[i] = q[i];
    for (int i = 0; i < 3; ++i) {
        S.gyro[i] = g[i];
        S.accel[i] = acc[i];
    }
}

// lanes 0-3, one leg each: J_f[:, 3:] [gyro, qd] written from the
// Jacobian's columns (rbd.h's `jacobian_unit`), its odometry term and the
// foot's height
template <typename T>
RBD_FN void leg_unit(int lane, const T* C, const T* qd, EstSlot<T>& S)
{
    if (lane >= 4) return;
    const int leg = lane;
    const Kin<T>& k = S.k;
    const T* pf = k.p[leg][3];
    T d[3], r[3];
    for (int c = 0; c < 3; ++c) d[c] = pf[c] - k.p0[c];
    mtv3(k.R0, d, r);
    // base_ang = -(R0 skew(r))
    const T Sk[9] = {T(0), -r[2], r[1], r[2], T(0), -r[0],
                     -r[1], r[0], T(0)};
    T cols[3][3];   // [level] the leg's joint column axis x (p_f - p_joint)
    for (int lvl = 0; lvl < 3; ++lvl) {
        const T* Rw = k.Rw[leg][lvl];
        const int ax = axis_of(C, lvl);
        const T axw[3] = {Rw[ax], Rw[3 + ax], Rw[6 + ax]};
        T e[3];
        for (int m = 0; m < 3; ++m) e[m] = pf[m] - k.p[leg][lvl][m];
        cross(axw, e, cols[lvl]);
    }
    T res[3];
    for (int i = 0; i < 3; ++i) {
        T s = T(0);
        for (int j = 0; j < 3; ++j) {
            const T ang = -(k.R0[3 * i] * Sk[j] + k.R0[3 * i + 1] * Sk[3 + j]
                            + k.R0[3 * i + 2] * Sk[6 + j]);
            s = s + ang * S.gyro[j];
        }
        for (int lvl = 0; lvl < 3; ++lvl)
            s = s + cols[lvl][i] * qd[3 * leg + lvl];
        res[i] = s;
    }
    T t[3];
    mtv3(k.R0, res, t);
    for (int i = 0; i < 3; ++i) S.vodo[leg][i] = -t[i];
    S.fz[leg] = pf[2];
}

// sum c and max(sum c, 1e-6) of a contact row
template <typename T>
RBD_FN void stance_sum(const T* c, T* c_sum, T* n_st)
{
    const T s = ((c[0] + c[1]) + c[2]) + c[3];
    *c_sum = s;
    *n_st = s < T(1e-6) ? T(1e-6) : s;
}

// lanes 0-2: v_lin[lane] (stored, and kept in the slot); lanes 3-17: v'
// entries gyro and qd
template <typename T>
RBD_FN void velocity_unit(int lane, const T* C, const EstArgs<T>& a,
                          long long b, EstSlot<T>& S)
{
    T* vo = a.out[EO_V] + b * NV;
    if (lane >= 3) {
        if (lane < 6) vo[lane] = S.gyro[lane - 3];
        else if (lane < NV) vo[lane] = a.row(EI_QDJ, b)[lane - 6];
        return;
    }
    const int j = lane;
    const T* c = a.row(EI_CONTACTS, b);
    T c_sum, n_st;
    stance_sum(c, &c_sum, &n_st);
    const T v_odo = (((S.vodo[0][j] * c[0] + S.vodo[1][j] * c[1])
                      + S.vodo[2][j] * c[2]) + S.vodo[3][j] * c[3]) / n_st;
    const T* vp = a.row(EI_V, b);
    T gxv[3];
    cross(S.gyro, vp, gxv);
    const T a_local = S.accel[j] - C[C_GRAV] * S.k.R0[6 + j];
    const T v_pred = vp[j] + a.par[EP_DT] * (a_local - gxv[j]);
    const T v_lin = c_sum > T(0.5)
        ? a.par[EP_ALPHA_VEL] * v_pred + a.par[EP_BETA_VEL] * v_odo
        : v_pred;
    S.vlin[j] = v_lin;
    vo[j] = v_lin;
}

// lanes 0-2: the base position's x, y and z; lanes 3-18: q' entries
// orientation and joints
template <typename T>
RBD_FN void position_unit(int lane, const EstArgs<T>& a, long long b,
                          const EstSlot<T>& S)
{
    T* qo = a.out[EO_Q] + b * NQ;
    if (lane >= 3) {
        if (lane < NQ) qo[lane] = S.q[lane];
        return;
    }
    const T* R0 = S.k.R0;
    const T vw = R0[3 * lane] * S.vlin[0] + R0[3 * lane + 1] * S.vlin[1]
                 + R0[3 * lane + 2] * S.vlin[2];
    const T dt = a.par[EP_DT];
    if (lane < 2) {
        qo[lane] = a.par[EP_HINT] != T(0) ? a.row(EI_HINT, b)[lane]
                                          : S.q[lane] + dt * vw;
        return;
    }
    const T* c = a.row(EI_CONTACTS, b);
    T c_sum, n_st;
    stance_sum(c, &c_sum, &n_st);
    const T fz = ((S.fz[0] * c[0] + S.fz[1] * c[1]) + S.fz[2] * c[2])
                 + S.fz[3] * c[3];
    const T z_kin = S.q[2] - fz / n_st;
    const T z_int = S.q[2] + dt * vw;
    qo[2] = c_sum > T(0.5)
        ? a.par[EP_BETA_Z] * z_int + a.par[EP_ALPHA_Z] * z_kin
        : z_int;
}

// the whole body of one scenario b; the IMU model first where IMU
template <bool IMU, typename T, class Exec>
RBD_FN void est_warp(const Exec& ex, const T* C, const EstArgs<T>& a,
                     long long b, EstSlot<T>& S)
{
    RBD_EACH_LANE(ex, lane) {
        if (lane == 0) attitude_unit<IMU>(C, a, b, S);
        else if (lane <= 12) S.q[6 + lane] = a.row(EI_QJ, b)[lane - 1];
    }
    ex.sync();
    RBD_EACH_LANE(ex, lane) kin_unit(lane, C, S.q, S.k);
    ex.sync();
    RBD_EACH_LANE(ex, lane) leg_unit(lane, C, a.row(EI_QDJ, b), S);
    ex.sync();
    RBD_EACH_LANE(ex, lane) velocity_unit(lane, C, a, b, S);
    ex.sync();
    RBD_EACH_LANE(ex, lane) position_unit(lane, a, b, S);
}

}  // namespace est
}  // namespace rbd
