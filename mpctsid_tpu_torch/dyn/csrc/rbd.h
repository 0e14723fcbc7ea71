// The per-scenario rigid-body core of the WBC-build and plant-step kernels.
//
// Plain C++ templated on the scalar (float, double).  Every function is
// marked RBD_FN: `__host__ __device__` under nvcc, plain `inline` under a
// host compiler, so the tests build this very arithmetic with g++ and hold
// it against the plain PyTorch versions on the CPU
// (tests/test_torch_rbd_kernels.py).  The .cu files only map a thread to its
// scenario and call `wbc_build_one` / `plant_step_one`.
//
// Counterparts of mpctsid_tpu_torch/dyn/rigid_body.py (same conventions):
//
//   q = [p_base(3), quat_xyzw(4), q_joints(12)]            (19)
//   v = [v_base_linear_LOCAL(3), w_base_LOCAL(3), qdot(12)] (18)
//
//   quat_to_rot, rot_to_rpy, Kin (LegKin), leg_kin (fk / foot_positions),
//   rnea, crba (both with the optional base-inertia addend of
//   point_mass_spatial), foot_jacobians, foot_drifts, integrate_q, and a
//   dense SPD Cholesky factor and solve.
//
// The leg kinematics are computed ONCE per configuration (`leg_kin`) and
// shared by every function that needs them; the plain chain builds them
// once per function.
//
// The model's constants are data: dyn/kernels.py::rbd_constants packs
// dyn/rigid_body.py::LegConsts (placements, spatial inertias, foot offset),
// the joint axes and gravity into one small device tensor laid out as
// `Const` says.  Nothing of the robot is written here beyond the topology
// the plain module assumes too: four identical three-joint chains on a
// floating base, each joint turning about one coordinate axis of its frame.
//
// Arrays are row-major; a 3x3 rotation R is R[3 * row + col].

#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define RBD_FN __host__ __device__ __forceinline__
#else
#define RBD_FN inline
#endif

namespace rbd {

constexpr int NQ = 19;   // configuration
constexpr int NV = 18;   // generalized velocity
constexpr int NF = 12;   // foot forces
constexpr int NX = 30;   // WBC decision variable [qdd; f]
constexpr int NC = 50;   // WBC constraint rows

// ---- the model's constants (dyn/kernels.py::rbd_constants packs them)
enum Const : int {
    C_PL = 0,        // [level][leg][3] joint placement in the parent frame
    C_FOOT = 36,     // [leg][3] foot point in the lower-leg frame
    C_INERTIA = 48,  // [level][6][6] spatial inertia ([ang; lin]), all legs
    C_IBASE = 156,   // [6][6] base spatial inertia
    C_AXIS = 192,    // [level] joint axis index (0 x, 1 y, 2 z)
    C_GRAV = 195,    // gravity, m/s^2
    C_SIZE = 196
};

// ---- the kernels' arguments.  in[k] is the first row of input k, stride[k]
// the elements between two scenarios' rows (0: one row for every scenario);
// a row's own elements are contiguous.  out[k] is contiguous (B, ...).
// par holds the scalar parameters.  wbc/tsid.py and env/plant.py fill them
// in this order.
enum WbcIn : int {
    WI_Q, WI_V, WI_CONTACTS, WI_F_MPC, WI_POS_REF, WI_VEL_REF, WI_ACC_REF,
    WI_Q_POSTURE, WI_RPY_REF, WI_H_REF, WI_EXTRA, WI_COUNT
};
enum WbcOut : int {
    WO_H, WO_G, WO_A, WO_L, WO_U, WO_M, WO_BIAS, WO_J, WO_COUNT
};
enum WbcPar : int {
    WP_W_FOOT, WP_W_FORCE, WP_W_POSTURE, WP_W_BASE, WP_KP_FOOT, WP_KD_FOOT,
    WP_KP_POSTURE, WP_KD_POSTURE, WP_KP_BASE, WP_KD_BASE, WP_MU, WP_TAU_MAX,
    WP_FZ_MIN, WP_FZ_MAX, WP_KD_CONTACT, WP_W_PIN, WP_EPS, WP_INF,
    WP_EXACT_PIN, WP_COUNT
};
enum PlantIn : int {
    PI_Q, PI_V, PI_ANCHOR, PI_IN_CONTACT, PI_TAU, PI_KP_N, PI_KD_N, PI_KP_T,
    PI_KD_T, PI_MU, PI_EXTRA, PI_COUNT
};
enum PlantOut : int { PO_Q, PO_V, PO_ANCHOR, PO_IN_CONTACT, PO_F, PO_COUNT };
enum PlantPar : int { PP_H_DT, PP_SUBSTEPS, PP_COUNT };

// what dyn/kernels.py checks against its own copy of these counts
enum Layout : int {
    L_CONST_SIZE, L_WBC_IN, L_WBC_OUT, L_WBC_PAR, L_PLANT_IN, L_PLANT_OUT,
    L_PLANT_PAR
};
inline int layout(int what)
{
    switch (what) {
    case L_CONST_SIZE: return C_SIZE;
    case L_WBC_IN: return WI_COUNT;
    case L_WBC_OUT: return WO_COUNT;
    case L_WBC_PAR: return WP_COUNT;
    case L_PLANT_IN: return PI_COUNT;
    case L_PLANT_OUT: return PO_COUNT;
    case L_PLANT_PAR: return PP_COUNT;
    default: return -1;
    }
}

template <typename T, int NI, int NO, int NP>
struct Args {
    const T* in[NI];
    long long stride[NI];
    T* out[NO];
    T par[NP];

    RBD_FN const T* row(int k, long long b) const
    {
        return in[k] == nullptr ? nullptr : in[k] + b * stride[k];
    }
};

template <typename T> using WbcArgs = Args<T, WI_COUNT, WO_COUNT, WP_COUNT>;
template <typename T>
using PlantArgs = Args<T, PI_COUNT, PO_COUNT, PP_COUNT>;

// ---- scalar functions of both types
RBD_FN float r_sin(float x) { return sinf(x); }
RBD_FN double r_sin(double x) { return sin(x); }
RBD_FN float r_cos(float x) { return cosf(x); }
RBD_FN double r_cos(double x) { return cos(x); }
RBD_FN float r_sqrt(float x) { return sqrtf(x); }
RBD_FN double r_sqrt(double x) { return sqrt(x); }
RBD_FN float r_atan2(float y, float x) { return atan2f(y, x); }
RBD_FN double r_atan2(double y, double x) { return atan2(y, x); }
RBD_FN float r_asin(float x) { return asinf(x); }
RBD_FN double r_asin(double x) { return asin(x); }

// ---- small vectors and matrices
template <typename T>
RBD_FN void cross(const T* a, const T* b, T* out)
{
    const T x = a[1] * b[2] - a[2] * b[1];
    const T y = a[2] * b[0] - a[0] * b[2];
    const T z = a[0] * b[1] - a[1] * b[0];
    out[0] = x;
    out[1] = y;
    out[2] = z;
}

template <typename T>
RBD_FN void mv3(const T* R, const T* x, T* out)   // out = R x
{
    for (int i = 0; i < 3; ++i)
        out[i] = R[3 * i] * x[0] + R[3 * i + 1] * x[1] + R[3 * i + 2] * x[2];
}

template <typename T>
RBD_FN void mtv3(const T* R, const T* x, T* out)  // out = R' x
{
    for (int i = 0; i < 3; ++i)
        out[i] = R[i] * x[0] + R[3 + i] * x[1] + R[6 + i] * x[2];
}

template <typename T>
RBD_FN void mm3(const T* A, const T* B, T* out)   // out = A B
{
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            out[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j]
                             + A[3 * i + 2] * B[6 + j];
}

template <typename T>
RBD_FN void mv6(const T* I, const T* x, T* out)   // out = I x, 6x6
{
    for (int i = 0; i < 6; ++i) {
        T s = T(0);
        for (int j = 0; j < 6; ++j) s += I[6 * i + j] * x[j];
        out[i] = s;
    }
}

template <typename T>
RBD_FN int axis_of(const T* C, int level)
{
    return (int)C[C_AXIS + level];
}

template <typename T>
RBD_FN const T* placement(const T* C, int level, int leg)
{
    return C + C_PL + 3 * (4 * level + leg);
}

// (4,) xyzw quaternion -> rotation
template <typename T>
RBD_FN void quat_to_rot(const T* qt, T* R)
{
    const T x = qt[0], y = qt[1], z = qt[2], w = qt[3];
    const T n = x * x + y * y + z * z + w * w;
    const T s = T(2) / n;
    R[0] = T(1) - s * (y * y + z * z);
    R[1] = s * (x * y - w * z);
    R[2] = s * (x * z + w * y);
    R[3] = s * (x * y + w * z);
    R[4] = T(1) - s * (x * x + z * z);
    R[5] = s * (y * z - w * x);
    R[6] = s * (x * z - w * y);
    R[7] = s * (y * z + w * x);
    R[8] = T(1) - s * (x * x + y * y);
}

// rotation -> roll, pitch, yaw
template <typename T>
RBD_FN void rot_to_rpy(const T* R, T* rpy)
{
    T r20 = R[6];
    r20 = r20 < T(-1) ? T(-1) : (r20 > T(1) ? T(1) : r20);
    rpy[0] = r_atan2(R[7], R[8]);
    rpy[1] = -r_asin(r20);
    rpy[2] = r_atan2(R[3], R[0]);
}

// rotation by `angle` about coordinate axis `ax`
template <typename T>
RBD_FN void axis_rot(int ax, T angle, T* R)
{
    const T c = r_cos(angle), s = r_sin(angle);
    for (int i = 0; i < 9; ++i) R[i] = T(0);
    const int a = (ax + 1) % 3, b = (ax + 2) % 3;
    R[3 * ax + ax] = T(1);
    R[3 * a + a] = c;
    R[3 * a + b] = -s;
    R[3 * b + a] = s;
    R[3 * b + b] = c;
}

// ---- leg kinematics, once per configuration (rigid_body.py::LegKin)
template <typename T>
struct Kin {
    T R0[9];
    T p0[3];
    T Rr[4][3][9];   // [leg][level] rotation relative to the parent
    T Rw[4][3][9];   // [leg][level] world rotation
    T p[4][4][3];    // [leg][hip, upper, lower, foot] world position
};

template <typename T>
RBD_FN void leg_kin(const T* C, const T* q, Kin<T>& k)
{
    quat_to_rot(q + 3, k.R0);
    for (int i = 0; i < 3; ++i) k.p0[i] = q[i];
    for (int leg = 0; leg < 4; ++leg) {
        const T* Rp = k.R0;
        const T* pp = k.p0;
        for (int lvl = 0; lvl < 3; ++lvl) {
            axis_rot(axis_of(C, lvl), q[7 + 3 * leg + lvl], k.Rr[leg][lvl]);
            T d[3];
            mv3(Rp, placement(C, lvl, leg), d);
            for (int i = 0; i < 3; ++i) k.p[leg][lvl][i] = pp[i] + d[i];
            mm3(Rp, k.Rr[leg][lvl], k.Rw[leg][lvl]);
            Rp = k.Rw[leg][lvl];
            pp = k.p[leg][lvl];
        }
        T d[3];
        mv3(k.Rw[leg][2], C + C_FOOT + 3 * leg, d);
        for (int i = 0; i < 3; ++i) k.p[leg][3][i] = k.p[leg][2][i] + d[i];
    }
}

// f = I a + v x* I v of a body with velocity (w, vl), acceleration (wd, vd)
template <typename T>
RBD_FN void wrench(const T* I, const T* w, const T* vl, const T* wd,
                   const T* vd, T* n, T* f)
{
    const T mom[6] = {w[0], w[1], w[2], vl[0], vl[1], vl[2]};
    const T acc[6] = {wd[0], wd[1], wd[2], vd[0], vd[1], vd[2]};
    T Iv[6], fb[6], c1[3], c2[3];
    mv6(I, mom, Iv);
    mv6(I, acc, fb);
    cross(w, Iv, c1);
    cross(vl, Iv + 3, c2);
    for (int i = 0; i < 3; ++i) n[i] = fb[i] + c1[i] + c2[i];
    cross(w, Iv + 3, c1);
    for (int i = 0; i < 3; ++i) f[i] = fb[3 + i] + c1[i];
}

// tau (18) = M(q) a + C(q, v) v + g(q); a == nullptr means a = 0 (the bias
// vector).  extra: optional 6x6 base spatial-inertia addend.
template <typename T>
RBD_FN void rnea(const T* C, const Kin<T>& k, const T* v, const T* a,
                 const T* extra, T* tau)
{
    const T grav = C[C_GRAV];
    const T w0[3] = {v[3], v[4], v[5]};
    const T v0[3] = {v[0], v[1], v[2]};
    T wd0[3], vd0[3];
    for (int i = 0; i < 3; ++i) {
        wd0[i] = a ? a[3 + i] : T(0);
        vd0[i] = (a ? a[i] : T(0)) + grav * k.R0[6 + i];
    }
    T Ib[36];
    for (int i = 0; i < 36; ++i)
        Ib[i] = extra ? C[C_IBASE + i] + extra[i] : C[C_IBASE + i];
    T n0[3], f0[3];
    wrench(Ib, w0, v0, wd0, vd0, n0, f0);

    T sn[3] = {T(0), T(0), T(0)}, sf[3] = {T(0), T(0), T(0)};
    for (int leg = 0; leg < 4; ++leg) {
        T w[3][3], vl[3][3], wd[3][3], vd[3][3];
        const T *wp = w0, *vp = v0, *wdp = wd0, *vdp = vd0;
        for (int lvl = 0; lvl < 3; ++lvl) {
            const T* Rr = k.Rr[leg][lvl];
            const T* pl = placement(C, lvl, leg);
            const int ax = axis_of(C, lvl);
            const T qd = v[6 + 3 * leg + lvl];
            const T qdd = a ? a[6 + 3 * leg + lvl] : T(0);
            T sq[3] = {T(0), T(0), T(0)};
            sq[ax] = qd;
            T t[3], c[3];
            mtv3(Rr, wp, w[lvl]);
            w[lvl][ax] += qd;
            cross(wp, pl, t);
            for (int i = 0; i < 3; ++i) t[i] = vp[i] + t[i];
            mtv3(Rr, t, vl[lvl]);
            mtv3(Rr, wdp, wd[lvl]);
            wd[lvl][ax] += qdd;
            cross(w[lvl], sq, c);
            for (int i = 0; i < 3; ++i) wd[lvl][i] += c[i];
            cross(wdp, pl, t);
            for (int i = 0; i < 3; ++i) t[i] = vdp[i] + t[i];
            mtv3(Rr, t, vd[lvl]);
            cross(vl[lvl], sq, c);
            for (int i = 0; i < 3; ++i) vd[lvl][i] += c[i];
            wp = w[lvl];
            vp = vl[lvl];
            wdp = wd[lvl];
            vdp = vd[lvl];
        }
        T nc[3], fc[3];
        for (int lvl = 2; lvl >= 0; --lvl) {
            T nb[3], fb[3];
            wrench(C + C_INERTIA + 36 * lvl, w[lvl], vl[lvl], wd[lvl],
                   vd[lvl], nb, fb);
            if (lvl < 2)
                for (int i = 0; i < 3; ++i) {
                    nb[i] += nc[i];
                    fb[i] += fc[i];
                }
            tau[6 + 3 * leg + lvl] = nb[axis_of(C, lvl)];
            const T* Rr = k.Rr[leg][lvl];
            T c[3];
            mv3(Rr, fb, fc);
            mv3(Rr, nb, nc);
            cross(placement(C, lvl, leg), fc, c);
            for (int i = 0; i < 3; ++i) nc[i] += c[i];
        }
        for (int i = 0; i < 3; ++i) {
            sn[i] += nc[i];
            sf[i] += fc[i];
        }
    }
    for (int i = 0; i < 3; ++i) {
        tau[i] = f0[i] + sf[i];
        tau[3 + i] = n0[i] + sn[i];
    }
}

// 6x6 motion transform child <- parent: [[R', 0], [R' skew(pl)', R']]
template <typename T>
RBD_FN void spatial_x(const T* Rr, const T* pl, T* X)
{
    for (int i = 0; i < 36; ++i) X[i] = T(0);
    // skew(pl)' = -skew(pl)
    const T Sk[9] = {T(0), pl[2], -pl[1], -pl[2], T(0), pl[0],
                     pl[1], -pl[0], T(0)};
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            const T rt = Rr[3 * j + i];          // R'[i][j]
            X[6 * i + j] = rt;
            X[6 * (3 + i) + 3 + j] = rt;
            X[6 * (3 + i) + j] = Rr[i] * Sk[j] + Rr[3 + i] * Sk[3 + j]
                                 + Rr[6 + i] * Sk[6 + j];
        }
}

// out = base + X' Ic X (6x6)
template <typename T>
RBD_FN void congruence_add(const T* base, const T* X, const T* Ic, T* out)
{
    T XtI[36];
    for (int i = 0; i < 6; ++i)
        for (int j = 0; j < 6; ++j) {
            T s = T(0);
            for (int r = 0; r < 6; ++r) s += X[6 * r + i] * Ic[6 * r + j];
            XtI[6 * i + j] = s;
        }
    for (int i = 0; i < 6; ++i)
        for (int j = 0; j < 6; ++j) {
            T s = T(0);
            for (int r = 0; r < 6; ++r) s += XtI[6 * i + r] * X[6 * r + j];
            out[6 * i + j] = base ? base[6 * i + j] + s : s;
        }
}

// spatial force [n; f] of a child, in its parent's frame
template <typename T>
RBD_FN void xf_to_parent(const T* Rr, const T* pl, const T* F, T* out)
{
    T c[3];
    mv3(Rr, F + 3, out + 3);
    mv3(Rr, F, out);
    cross(pl, out + 3, c);
    for (int i = 0; i < 3; ++i) out[i] += c[i];
}

// Mass matrix M (18x18): dense base block, 6x12 coupling, block-diagonal
// legs.  extra: optional 6x6 base spatial-inertia addend.
template <typename T>
RBD_FN void crba(const T* C, const Kin<T>& k, const T* extra, T* M)
{
    for (int i = 0; i < NV * NV; ++i) M[i] = T(0);
    const int a0 = axis_of(C, 0), a1 = axis_of(C, 1), a2 = axis_of(C, 2);
    T S[36];
    for (int i = 0; i < 36; ++i) S[i] = T(0);
    for (int leg = 0; leg < 4; ++leg) {
        const T* pl_h = placement(C, 0, leg);
        const T* pl_u = placement(C, 1, leg);
        const T* pl_l = placement(C, 2, leg);
        const T* Ic_l = C + C_INERTIA + 72;
        T X[36], Ic_u[36], Ic_h[36], Ib[36];
        spatial_x(k.Rr[leg][2], pl_l, X);
        congruence_add(C + C_INERTIA + 36, X, Ic_l, Ic_u);
        spatial_x(k.Rr[leg][1], pl_u, X);
        congruence_add(C + C_INERTIA, X, Ic_u, Ic_h);
        spatial_x(k.Rr[leg][0], pl_h, X);
        congruence_add((const T*)nullptr, X, Ic_h, Ib);
        for (int i = 0; i < 36; ++i) S[i] += Ib[i];

        // the joint motion subspaces are unit axes: I S is a column of I
        // and S' F a component of F
        T Fk[6], Fk_u[6], Fk_h[6], Fk_b[6];
        T Fh[6], Fh_h[6], Fh_b[6], Fa[6], Fa_b[6];
        for (int i = 0; i < 6; ++i) {
            Fk[i] = Ic_l[6 * i + a2];
            Fh[i] = Ic_u[6 * i + a1];
            Fa[i] = Ic_h[6 * i + a0];
        }
        xf_to_parent(k.Rr[leg][2], pl_l, Fk, Fk_u);
        xf_to_parent(k.Rr[leg][1], pl_u, Fk_u, Fk_h);
        xf_to_parent(k.Rr[leg][0], pl_h, Fk_h, Fk_b);
        xf_to_parent(k.Rr[leg][1], pl_u, Fh, Fh_h);
        xf_to_parent(k.Rr[leg][0], pl_h, Fh_h, Fh_b);
        xf_to_parent(k.Rr[leg][0], pl_h, Fa, Fa_b);
        const T m_kk = Fk[a2], m_hk = Fk_u[a1], m_ak = Fk_h[a0];
        const T m_hh = Fh[a1], m_ah = Fh_h[a0], m_aa = Fa[a0];
        const T blk[9] = {m_aa, m_ah, m_ak, m_ah, m_hh, m_hk,
                          m_ak, m_hk, m_kk};
        const int o = 6 + 3 * leg;
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j)
                M[NV * (o + i) + o + j] = blk[3 * i + j];
        // base coupling: spatial forces [ang; lin] -> rows [lin; ang]
        const T* cols[3] = {Fa_b, Fh_b, Fk_b};
        for (int j = 0; j < 3; ++j)
            for (int r = 0; r < 6; ++r) {
                const T val = cols[j][(r + 3) % 6];
                M[NV * r + o + j] = val;
                M[NV * (o + j) + r] = val;
            }
    }
    // base 6x6: [ang; lin] spatial inertia -> [lin; ang] generalized
    for (int i = 0; i < 36; ++i) {
        S[i] = C[C_IBASE + i] + S[i];
        if (extra) S[i] = S[i] + extra[i];
    }
    for (int i = 0; i < 6; ++i)
        for (int j = 0; j < 6; ++j)
            M[NV * i + j] = S[6 * ((i + 3) % 6) + (j + 3) % 6];
}

// (12x18) world-frame linear-velocity Jacobians of the four feet, row
// 3 * leg + i; joint columns only for each foot's own leg
template <typename T>
RBD_FN void foot_jacobians(const T* C, const Kin<T>& k, T* J)
{
    for (int i = 0; i < NF * NV; ++i) J[i] = T(0);
    for (int leg = 0; leg < 4; ++leg) {
        const T* pf = k.p[leg][3];
        T d[3], r[3];
        for (int i = 0; i < 3; ++i) d[i] = pf[i] - k.p0[i];
        mtv3(k.R0, d, r);
        // base_ang = -(R0 skew(r))
        const T Sk[9] = {T(0), -r[2], r[1], r[2], T(0), -r[0],
                         -r[1], r[0], T(0)};
        T cols[3][3];
        for (int lvl = 0; lvl < 3; ++lvl) {
            const T* Rw = k.Rw[leg][lvl];
            const int ax = axis_of(C, lvl);
            const T axw[3] = {Rw[ax], Rw[3 + ax], Rw[6 + ax]};
            T e[3];
            for (int i = 0; i < 3; ++i) e[i] = pf[i] - k.p[leg][lvl][i];
            cross(axw, e, cols[lvl]);
        }
        for (int i = 0; i < 3; ++i) {
            T* row = J + NV * (3 * leg + i);
            for (int j = 0; j < 3; ++j) {
                row[j] = k.R0[3 * i + j];
                row[3 + j] = -(k.R0[3 * i] * Sk[j]
                               + k.R0[3 * i + 1] * Sk[3 + j]
                               + k.R0[3 * i + 2] * Sk[6 + j]);
            }
            for (int lvl = 0; lvl < 3; ++lvl)
                row[6 + 3 * leg + lvl] = cols[lvl][i];
        }
    }
}

// (12) world-frame Jdot v per foot (classical acceleration, qdd = 0,
// gravity off)
template <typename T>
RBD_FN void foot_drifts(const T* C, const Kin<T>& k, const T* v, T* out)
{
    T w0[3], v0[3], a0[3], c[3];
    mv3(k.R0, v + 3, w0);
    mv3(k.R0, v, v0);
    cross(v + 3, v, c);
    mv3(k.R0, c, a0);
    for (int leg = 0; leg < 4; ++leg) {
        T w[3], vl[3], al[3] = {T(0), T(0), T(0)}, acc[3];
        for (int i = 0; i < 3; ++i) {
            w[i] = w0[i];
            vl[i] = v0[i];
            acc[i] = a0[i];
        }
        const T* pp = k.p0;
        for (int lvl = 0; lvl < 4; ++lvl) {
            const T* pn = k.p[leg][lvl];
            T r[3], t1[3], t2[3], t3[3];
            for (int i = 0; i < 3; ++i) r[i] = pn[i] - pp[i];
            // a += al x r + w x (w x r) (at the foot this is the answer)
            cross(al, r, t1);
            cross(w, r, t2);
            cross(w, t2, t3);
            if (lvl == 3) {
                for (int i = 0; i < 3; ++i)
                    out[3 * leg + i] = acc[i] + t1[i] + t3[i];
                break;
            }
            const T* Rw = k.Rw[leg][lvl];
            const int ax = axis_of(C, lvl);
            const T qd = v[6 + 3 * leg + lvl];
            const T sq[3] = {Rw[ax] * qd, Rw[3 + ax] * qd, Rw[6 + ax] * qd};
            T ws[3];
            cross(w, sq, ws);
            for (int i = 0; i < 3; ++i) {
                acc[i] = acc[i] + t1[i] + t3[i];
                vl[i] = vl[i] + t2[i];
                al[i] = al[i] + ws[i];
                w[i] = w[i] + sq[i];
            }
            pp = pn;
        }
    }
}

// integrate the generalized velocity (local convention) over dt
template <typename T>
RBD_FN void integrate_q(const T* q, const T* v, T dt, T* out)
{
    T R0[9], d[3];
    quat_to_rot(q + 3, R0);
    mv3(R0, v, d);
    for (int i = 0; i < 3; ++i) out[i] = q[i] + d[i] * dt;
    const T w[3] = {v[3] * dt, v[4] * dt, v[5] * dt};
    const T th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
    const T th = r_sqrt(th2 + T(1e-30));
    const T half = th / T(2);
    const T sinc_half = th < T(1e-8) ? T(0.5) - th2 / T(48) : r_sin(half) / th;
    const T x2 = w[0] * sinc_half, y2 = w[1] * sinc_half,
            z2 = w[2] * sinc_half, w2 = r_cos(half);
    const T x1 = q[3], y1 = q[4], z1 = q[5], w1 = q[6];
    T quat[4] = {w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                 w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                 w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                 w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2};
    const T nrm = r_sqrt(quat[0] * quat[0] + quat[1] * quat[1]
                         + quat[2] * quat[2] + quat[3] * quat[3]);
    for (int i = 0; i < 4; ++i) out[3 + i] = quat[i] / nrm;
    for (int i = 0; i < 12; ++i) out[7 + i] = q[7 + i] + v[6 + i] * dt;
}

// In-place Cholesky A = L L' of an n x n SPD matrix (lower triangle read,
// L written over it), then x = A^-1 b solved in place in b.
template <typename T>
RBD_FN void cholesky(T* A, int n)
{
    for (int j = 0; j < n; ++j) {
        T s = A[n * j + j];
        for (int k = 0; k < j; ++k) s -= A[n * j + k] * A[n * j + k];
        const T d = r_sqrt(s);
        A[n * j + j] = d;
        for (int i = j + 1; i < n; ++i) {
            T t = A[n * i + j];
            for (int k = 0; k < j; ++k) t -= A[n * i + k] * A[n * j + k];
            A[n * i + j] = t / d;
        }
    }
}

template <typename T>
RBD_FN void cholesky_solve(const T* L, int n, T* b)
{
    for (int i = 0; i < n; ++i) {
        T t = b[i];
        for (int k = 0; k < i; ++k) t -= L[n * i + k] * b[k];
        b[i] = t / L[n * i + i];
    }
    for (int i = n - 1; i >= 0; --i) {
        T t = b[i];
        for (int k = i + 1; k < n; ++k) t -= L[n * k + i] * b[k];
        b[i] = t / L[n * i + i];
    }
}

// ---- wbc/tsid.py::_build_wbc_qp for scenario b: (H, g, A, l, u, M, h, J)
// with J = JcT' (the wrapper hands back its transposed view)
template <typename T>
RBD_FN void wbc_build_one(const T* C, const WbcArgs<T>& a, long long b)
{
    const T* q = a.row(WI_Q, b);
    const T* v = a.row(WI_V, b);
    const T* cts = a.row(WI_CONTACTS, b);
    const T* f_mpc = a.row(WI_F_MPC, b);
    const T* pos_ref = a.row(WI_POS_REF, b);
    const T* vel_ref = a.row(WI_VEL_REF, b);
    const T* acc_ref = a.row(WI_ACC_REF, b);
    const T* q_post = a.row(WI_Q_POSTURE, b);
    const T* rpy_ref = a.row(WI_RPY_REF, b);
    const T* h_ref = a.row(WI_H_REF, b);
    const T* extra = a.row(WI_EXTRA, b);
    T* H = a.out[WO_H] + b * (NX * NX);
    T* g = a.out[WO_G] + b * NX;
    T* A = a.out[WO_A] + b * (NC * NX);
    T* l = a.out[WO_L] + b * NC;
    T* u = a.out[WO_U] + b * NC;
    T* M = a.out[WO_M] + b * (NV * NV);
    T* h = a.out[WO_BIAS] + b * NV;
    T* J = a.out[WO_J] + b * (NF * NV);
    const T* P = a.par;
    const bool exact_pin = P[WP_EXACT_PIN] != T(0);
    const T inf = P[WP_INF];

    Kin<T> k;
    leg_kin(C, q, k);
    crba(C, k, extra, M);
    rnea(C, k, v, (const T*)nullptr, extra, h);
    foot_jacobians(C, k, J);
    T drift[NF], foot_vel[NF], rpy[3];
    foot_drifts(C, k, v, drift);
    for (int r = 0; r < NF; ++r) {
        T s = T(0);
        for (int j = 0; j < NV; ++j) s += J[NV * r + j] * v[j];
        foot_vel[r] = s;
    }
    rot_to_rpy(k.R0, rpy);

    // ---- cost.  Swing-foot tracking weight-masked by (1 - contact): the
    // task rows J_i qdd = a_des_i - drift_i touch the qdd block only
    T w_rows[NF], b_t[NF];
    for (int leg = 0; leg < 4; ++leg) {
        const T w_leg = P[WP_W_FOOT] * (T(1) - cts[leg]);
        for (int i = 0; i < 3; ++i) {
            const int r = 3 * leg + i;
            const T pf = k.p[leg][3][i];
            const T a_des = acc_ref[r] + P[WP_KP_FOOT] * (pos_ref[r] - pf)
                            + P[WP_KD_FOOT] * (vel_ref[r] - foot_vel[r]);
            w_rows[r] = w_leg;
            b_t[r] = a_des - drift[r];
        }
    }
    for (int i = 0; i < NX; ++i) {
        for (int j = 0; j < NX; ++j) {
            T s = T(0);
            if (i < NV && j < NV)
                for (int r = 0; r < NF; ++r)
                    s += J[NV * r + i] * (w_rows[r] * J[NV * r + j]);
            H[NX * i + j] = s;
        }
    }
    for (int i = 0; i < NV; ++i) {
        T s = T(0);
        for (int r = 0; r < NF; ++r) s += J[NV * r + i] * (w_rows[r] * b_t[r]);
        g[i] = -s;
    }
    // force tracking
    for (int i = 0; i < NF; ++i) {
        H[NX * (NV + i) + NV + i] += P[WP_W_FORCE];
        g[NV + i] = -P[WP_W_FORCE] * f_mpc[i];
    }
    // posture
    for (int i = 0; i < 12; ++i) {
        const T a_post = P[WP_KP_POSTURE] * (q_post[i] - q[7 + i])
                         - P[WP_KD_POSTURE] * v[6 + i];
        H[NX * (6 + i) + 6 + i] += P[WP_W_POSTURE];
        g[6 + i] += -P[WP_W_POSTURE] * a_post;
    }
    // base height + roll + pitch (generalized coordinates 2, 3, 4)
    const T a_base[3] = {
        P[WP_KP_BASE] * (h_ref[0] - q[2]) - P[WP_KD_BASE] * v[2],
        P[WP_KP_BASE] * (rpy_ref[0] - rpy[0]) - P[WP_KD_BASE] * v[3],
        P[WP_KP_BASE] * (rpy_ref[1] - rpy[1]) - P[WP_KD_BASE] * v[4]};
    for (int i = 0; i < 3; ++i) {
        H[NX * (2 + i) + 2 + i] += P[WP_W_BASE];
        g[2 + i] += -P[WP_W_BASE] * a_base[i];
    }
    // strict convexity + swing-force ridge
    for (int i = 0; i < NV; ++i) H[NX * i + i] += P[WP_EPS];
    for (int i = 0; i < NF; ++i) {
        const T ridge = exact_pin ? T(0) : P[WP_W_PIN] * (T(1) - cts[i / 3]);
        H[NX * (NV + i) + NV + i] += P[WP_EPS] + ridge;
    }

    // ---- constraints (50 rows): base dynamics (6), torque bounds (12),
    // friction pyramid (20), stance contacts (12).  exact_pin zeroes the
    // swing forces' columns.
    T col_f[NF];
    for (int i = 0; i < NF; ++i) col_f[i] = exact_pin ? cts[i / 3] : T(1);
    for (int r = 0; r < NV; ++r) {
        T* row = A + NX * r;
        for (int j = 0; j < NV; ++j) row[j] = M[NV * r + j];
        for (int i = 0; i < NF; ++i) {
            const T val = -J[NV * i + r];
            row[NV + i] = exact_pin ? val * col_f[i] : val;
        }
    }
    for (int r = 0; r < 6; ++r) l[r] = u[r] = -h[r];
    for (int r = 6; r < NV; ++r) {
        l[r] = -P[WP_TAU_MAX] - h[r];
        u[r] = P[WP_TAU_MAX] - h[r];
    }
    const T mu = P[WP_MU];
    const T pyr[5][3] = {{T(1), T(0), -mu}, {T(1), T(0), mu},
                         {T(0), T(1), -mu}, {T(0), T(1), mu},
                         {T(0), T(0), T(1)}};
    const T pyr_l[5] = {-inf, T(0), -inf, T(0), P[WP_FZ_MIN]};
    const T pyr_u[5] = {T(0), inf, T(0), inf, P[WP_FZ_MAX]};
    for (int leg = 0; leg < 4; ++leg) {
        const bool stance = cts[leg] > T(0.5);
        for (int s = 0; s < 5; ++s) {
            const int r = NV + 5 * leg + s;
            T* row = A + NX * r;
            for (int j = 0; j < NX; ++j) row[j] = T(0);
            for (int i = 0; i < 3; ++i) {
                const T val = pyr[s][i];
                const int c = 3 * leg + i;
                row[NV + c] = exact_pin ? val * col_f[c] : val;
            }
            l[r] = stance ? pyr_l[s] : -inf;
            u[r] = stance ? pyr_u[s] : inf;
        }
    }
    for (int i = 0; i < NF; ++i) {
        const int r = NV + 20 + i;
        const T c = cts[i / 3];
        T* row = A + NX * r;
        for (int j = 0; j < NV; ++j) row[j] = J[NV * i + j] * c;
        for (int j = 0; j < NF; ++j) row[NV + j] = T(0);
        const T b_con = -drift[i] - P[WP_KD_CONTACT] * foot_vel[i];
        l[r] = c > T(0.5) ? b_con : -inf;
        u[r] = c > T(0.5) ? b_con : inf;
    }
}

// ---- one substep of env/plant.py: implicit-damping contact integration,
// cone clamp with anchor drag, explicit re-solve where clamped.  The two
// 18 x 18 SPD solves go by Cholesky (the plain version forms inverses).
template <typename T>
RBD_FN void plant_substep(const T* C, T* q, T* v, T* anchor, T* in_c,
                          const T* tau, const T* cp, const T* extra, T h_dt,
                          T* f_cl)
{
    const T kp_n = cp[0], kd_n = cp[1], kp_t = cp[2], kd_t = cp[3],
            mu = cp[4];
    Kin<T> k;
    leg_kin(C, q, k);
    T M[NV * NV], Me[NV * NV], J[NF * NV], bias[NV];
    crba(C, k, extra, M);
    rnea(C, k, v, (const T*)nullptr, extra, bias);
    foot_jacobians(C, k, J);

    T f_el[NF], inc[4];
    const T d_vec[3] = {kd_t, kd_t, kd_n};
    for (int leg = 0; leg < 4; ++leg) {
        const T* pf = k.p[leg][3];
        const bool below = pf[2] < T(0);
        if (below && in_c[leg] < T(0.5)) {
            anchor[2 * leg] = pf[0];
            anchor[2 * leg + 1] = pf[1];
        }
        inc[leg] = below ? T(1) : T(0);
        f_el[3 * leg] = -kp_t * (pf[0] - anchor[2 * leg]) * inc[leg];
        f_el[3 * leg + 1] = -kp_t * (pf[1] - anchor[2 * leg + 1]) * inc[leg];
        f_el[3 * leg + 2] = -kp_n * pf[2] * inc[leg];
    }
    // M_eff = M + h sum_active J' D J; rhs = M v + h (tau_gen - bias + J' f)
    T Mv[NV], rhs[NV], base[NV];
    for (int i = 0; i < NV; ++i) {
        T s = T(0);
        for (int j = 0; j < NV; ++j) s += M[NV * i + j] * v[j];
        Mv[i] = s;
    }
    for (int i = 0; i < NV; ++i) {
        for (int j = 0; j <= i; ++j) {
            T s = T(0);
            for (int r = 0; r < NF; ++r)
                s += J[NV * r + i]
                     * (J[NV * r + j] * (d_vec[r % 3] * inc[r / 3]));
            Me[NV * i + j] = M[NV * i + j] + h_dt * s;
        }
        base[i] = (i < 6 ? T(0) : tau[i - 6]) - bias[i];
    }
    for (int i = 0; i < NV; ++i) {
        T s = T(0);
        for (int r = 0; r < NF; ++r) s += f_el[r] * J[NV * r + i];
        rhs[i] = Mv[i] + h_dt * (base[i] + s);
    }
    cholesky(Me, NV);
    cholesky_solve(Me, NV, rhs);            // rhs is now v_imp

    // contact forces at the implicit velocity, then the cone clamp
    bool any_cl = false;
    for (int leg = 0; leg < 4; ++leg) {
        T fv[3];
        for (int i = 0; i < 3; ++i) {
            T s = T(0);
            for (int j = 0; j < NV; ++j)
                s += J[NV * (3 * leg + i) + j] * rhs[j];
            fv[i] = s;
        }
        T f_raw[3];
        for (int i = 0; i < 3; ++i)
            f_raw[i] = f_el[3 * leg + i] - d_vec[i] * fv[i] * inc[leg];
        const T fz = f_raw[2] > T(0) ? f_raw[2] : T(0);
        const T limit = mu * fz;
        const T ft_norm = r_sqrt(f_raw[0] * f_raw[0] + f_raw[1] * f_raw[1]);
        const bool over = ft_norm > limit;
        const T safe = ft_norm > T(1e-12) ? ft_norm : T(1e-12);
        const T scale = over ? limit / safe : T(1);
        const T ftx = f_raw[0] * scale, fty = f_raw[1] * scale;
        const bool active = inc[leg] > T(0.5);
        if (over && active) {
            anchor[2 * leg] = k.p[leg][3][0] + (ftx + kd_t * fv[0]) / kp_t;
            anchor[2 * leg + 1] = k.p[leg][3][1] + (fty + kd_t * fv[1]) / kp_t;
        }
        if ((over || f_raw[2] < T(0)) && active) any_cl = true;
        f_cl[3 * leg] = ftx * inc[leg];
        f_cl[3 * leg + 1] = fty * inc[leg];
        f_cl[3 * leg + 2] = fz * inc[leg];
    }
    // explicit recomputation with the clamped (bounded) forces
    if (any_cl) {
        for (int i = 0; i < NV; ++i) {
            T s = T(0);
            for (int r = 0; r < NF; ++r) s += f_cl[r] * J[NV * r + i];
            rhs[i] = Mv[i] + h_dt * (base[i] + s);
        }
        cholesky(M, NV);
        cholesky_solve(M, NV, rhs);
    }
    integrate_q(q, rhs, h_dt, Me);          // Me: scratch for the new q
    for (int i = 0; i < NQ; ++i) q[i] = Me[i];
    for (int i = 0; i < NV; ++i) v[i] = rhs[i];
    for (int leg = 0; leg < 4; ++leg) in_c[leg] = inc[leg];
}

// ---- env/plant.py::plant_step for scenario b: `substeps` substeps of
// h_dt; writes the new (q, v, anchor, in_contact) and the last substep's
// ground forces
template <typename T>
RBD_FN void plant_step_one(const T* C, const PlantArgs<T>& a, long long b)
{
    T q[NQ], v[NV], anchor[8], in_c[4], tau[12], cp[5], f[NF];
    const T* src = a.row(PI_Q, b);
    for (int i = 0; i < NQ; ++i) q[i] = src[i];
    src = a.row(PI_V, b);
    for (int i = 0; i < NV; ++i) v[i] = src[i];
    src = a.row(PI_ANCHOR, b);
    for (int i = 0; i < 8; ++i) anchor[i] = src[i];
    src = a.row(PI_IN_CONTACT, b);
    for (int i = 0; i < 4; ++i) in_c[i] = src[i];
    src = a.row(PI_TAU, b);
    for (int i = 0; i < 12; ++i) tau[i] = src[i];
    for (int i = 0; i < 5; ++i) cp[i] = a.row(PI_KP_N + i, b)[0];
    for (int i = 0; i < NF; ++i) f[i] = T(0);
    const T* extra = a.row(PI_EXTRA, b);
    const int substeps = (int)a.par[PP_SUBSTEPS];
    for (int s = 0; s < substeps; ++s)
        plant_substep(C, q, v, anchor, in_c, tau, cp, extra, a.par[PP_H_DT],
                      f);
    T* out = a.out[PO_Q] + b * NQ;
    for (int i = 0; i < NQ; ++i) out[i] = q[i];
    out = a.out[PO_V] + b * NV;
    for (int i = 0; i < NV; ++i) out[i] = v[i];
    out = a.out[PO_ANCHOR] + b * 8;
    for (int i = 0; i < 8; ++i) out[i] = anchor[i];
    out = a.out[PO_IN_CONTACT] + b * 4;
    for (int i = 0; i < 4; ++i) out[i] = in_c[i];
    out = a.out[PO_F] + b * NF;
    for (int i = 0; i < NF; ++i) out[i] = f[i];
}

}  // namespace rbd
