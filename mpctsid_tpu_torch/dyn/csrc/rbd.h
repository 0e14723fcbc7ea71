// The rigid-body core of the WBC-build and plant-step kernels: a warp per
// scenario.
//
// Plain C++ templated on the scalar (float, double).  Every function is
// marked RBD_FN: `__host__ __device__` under nvcc, plain `inline` under a
// host compiler.  The arithmetic is cut into UNITS: a unit takes a lane
// index (0-31) and the warp's slice of shared memory (`WbcSlot`,
// `PlantSlot`), reads what earlier phases wrote there and writes what its
// lane owns.  `wbc_build_warp` and `plant_step_warp` run the units in phases
// through an executor that puts a `sync()` between two phases: on the card
// (`WarpExec`) each thread of a warp runs its own lane's units and the sync
// is `__syncwarp()`; on the host (`HostExec`) one thread runs the 32 lanes
// one after another, in either order.  So the tests build this very
// arithmetic with g++ (tests/test_torch_rbd_kernels.py, _rbd_warp.py) and
// hold it against the plain PyTorch versions on the CPU; no unit reads
// what another lane writes in the same phase, which they check by running
// the lanes in both orders, bit for bit.  No shuffles, no atomics: the bits
// do not depend on the order the lanes run in.
//
// Counterparts of mpctsid_tpu_torch/dyn/rigid_body.py (same conventions):
//
//   q = [p_base(3), quat_xyzw(4), q_joints(12)]            (19)
//   v = [v_base_linear_LOCAL(3), w_base_LOCAL(3), qdot(12)] (18)
//
//   quat_to_rot, rot_to_rpy, Kin (LegKin), the leg kinematics (fk /
//   foot_positions), rnea at qdd = 0, crba (both with the optional
//   base-inertia addend of point_mass_spatial), foot_jacobians,
//   foot_drifts, integrate_q, and the SPD solve of a matrix with M's arrow
//   structure.
//
// How the lanes split the work (`frame_phases`, shared by both kernels):
// one lane per leg for the chains down a leg (kinematics, rnea's forward
// and backward passes, the foot drifts), one per body for its wrench and
// one per joint for its force; six lanes per leg for its three crba
// congruences X' Ic X (a row each, in registers; the motion transform's
// zero block skipped); one lane per foot row for the Jacobian; the whole
// warp for element-wise work (the motion transforms, M, J' W J, the
// WBC's rows), each loop over one kind of entry so that a round's lanes
// take one path.  The build writes its 3,088 output values row by row,
// lane j on column j: consecutive lanes at consecutive addresses, each
// value computed where it is stored (H from the non-zeros of J' W J, the
// constraint rows from M and J).  The plant's two SPD solves use the
// arrow structure of M and M + h J' D J (each leg couples only to the
// base): a 3 x 3 factor per leg, the legs' Schur complements taken from the
// 6 x 6 base block, one 6 x 6 factor, the solves leg by leg.
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

#define RBD_PRAGMA(x) _Pragma(#x)
#if defined(__CUDACC__)
#define RBD_FN __host__ __device__ __forceinline__
#define RBD_UNROLL _Pragma("unroll")
#define RBD_UNROLL_BY(n) RBD_PRAGMA(unroll n)
#else
#define RBD_FN inline
#define RBD_UNROLL
#define RBD_UNROLL_BY(n)
#endif

namespace rbd {

constexpr int NQ = 19;   // configuration
constexpr int NV = 18;   // generalized velocity
constexpr int NF = 12;   // foot forces
constexpr int NX = 30;   // WBC decision variable [qdd; f]
constexpr int NC = 50;   // WBC constraint rows
constexpr int WARP = 32;
constexpr int MAX_WARPS = 8;  // scenarios (warps) per block at most

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

// ---- the launch layout (dyn/kernels.py::rbd_layout computes the same):
// a warp's slot of shared memory rounded to 16 bytes; scenarios (warps) per
// block: what fits in the `smem_optin` bytes a block may have, at most
// MAX_WARPS, and no more than spreads B over `n_sm` multiprocessors; 0 when
// no slot fits
inline int slot_bytes(int bytes) { return (bytes + 15) / 16 * 16; }
inline int warps_per_block(long long B, int slot, int smem_optin, int n_sm)
{
    const int fit = smem_optin / slot;
    if (fit < 1) return 0;
    const long long spread = (B + n_sm - 1) / (n_sm > 0 ? n_sm : 1);
    int g = fit < MAX_WARPS ? fit : MAX_WARPS;
    if (spread < g) g = (int)spread;
    return g < 1 ? 1 : g;
}

// ---- scalar functions of both types
RBD_FN float r_sqrt(float x) { return sqrtf(x); }
RBD_FN double r_sqrt(double x) { return sqrt(x); }
RBD_FN float r_atan2(float y, float x) { return atan2f(y, x); }
RBD_FN double r_atan2(double y, double x) { return atan2(y, x); }
RBD_FN float r_asin(float x) { return asinf(x); }
RBD_FN double r_asin(double x) { return asin(x); }
RBD_FN void r_sincos(float x, float* s, float* c) { sincosf(x, s, c); }
RBD_FN void r_sincos(double x, double* s, double* c) { sincos(x, s, c); }

// v[k] of a 3-vector for a k known only at run time (a joint's axis, a
// lane's row).  Selects, not an index: a local array indexed at run time
// would live in local memory.
template <typename T>
RBD_FN T pick3(const T* v, int k)
{
    return k == 0 ? v[0] : (k == 1 ? v[1] : v[2]);
}

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

// rotation about coordinate axis `ax` by the angle of cosine c, sine s
template <typename T>
RBD_FN void axis_rot(int ax, T c, T s, T* R)
{
    // R[a][b] = -s, R[b][a] = s for a = ax + 1, b = ax + 2 (mod 3)
    RBD_UNROLL
    for (int i = 0; i < 3; ++i)
        RBD_UNROLL
        for (int j = 0; j < 3; ++j)
            R[3 * i + j] = i == j ? (i == ax ? T(1) : c)
                           : (i == ax || j == ax ? T(0)
                              : (i == (ax + 1) % 3 ? -s : s));
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

// ---- a warp's slice of shared memory

// leg kinematics, once per configuration (rigid_body.py::LegKin)
template <typename T>
struct Kin {
    T R0[9];
    T p0[3];
    T Rr[4][3][9];   // [leg][level] rotation relative to the parent
    T Rw[4][3][9];   // [leg][level] world rotation
    T p[4][4][3];    // [leg][hip, upper, lower, foot] world position
};

// what both kernels compute of a configuration (`frame_phases`)
template <typename T>
struct Frame {
    Kin<T> k;
    T F[4][3][9];      // [leg][level] lower-left block R' skew(pl)' of the
                       // motion transform X = [[R', 0], [F, R']]
    T Ic[4][2][36];    // [leg] composite inertia of the hip [0] and the
                       // upper [1] subtree, each in its own frame
    T Ib[4][36];       // [leg] the leg's composite inertia in the base frame
    T blk[4][9];       // [leg] its 3 x 3 block of M
    T cols[4][3][6];   // [leg][joint] the joint's spatial force in the base
                       // frame: its column of M's base coupling
    T fw[4][3][12];    // [leg][level] rnea's forward pass: w, v, wd, vd
    T fw0[12];         // rnea: the base's w, v, wd, vd
    T Ibase[36];       // the base's spatial inertia with the addend
    T wr[4][3][6];     // [leg][level] rnea: the body's own wrench [n; f]
    T legw[4][6];      // [leg] rnea: the wrench the leg puts on the base
    T basew[6];        // rnea: the base's own wrench [n; f]
    T M[NV * NV];      // mass matrix
    T h[NV];           // bias (rnea at qdd = 0)
    T J[NF * NV];      // foot Jacobians, row 3 * leg + i
};

template <typename T>
struct WbcSlot {
    T q[NQ], v[NV], cts[4], f_mpc[NF], pos_ref[NF], vel_ref[NF],
        acc_ref[NF], q_post[12], rpy_ref[2], h_ref[1], extra[36];
    Frame<T> fr;
    T drift[NF];       // J-dot v per foot row
    T foot_vel[NF];    // J v
    T wb[NF];          // swing-tracking weight * (a_des - drift)
    T rpy[3];
    T Hq[NV * NV];     // J' W J (its structural non-zeros)
};

template <typename T>
struct PlantSlot {
    T q[NQ], v[NV], anchor[8], in_c[4], tau[12], cp[5], extra[36];
    Frame<T> fr;
    T Me[NV * NV];     // M + h J' D J (lower triangle, arrow non-zeros)
    T Mv[NV], base[NV], rhs[NV];
    T y[NV];           // the arrow solve's intermediate
    T Lf[4 * 12];      // its legs' factors: L_L (3 x 3), 1 / diagonal
    T vi[NV];          // the new velocity
    T inc[4], f_el[NF], f_cl[NF], clamp[4];
};

// the executors.  RBD_EACH_LANE(ex, lane) runs its body once for each lane
// the executor gives this thread: its own on the card, all 32 on the host.
#define RBD_EACH_LANE(ex, lane)                                             \
    for (int lane##_i = (ex).first(), lane = (ex).lane(lane##_i);           \
         lane##_i < ::rbd::WARP;                                            \
         lane##_i += (ex).step(), lane = (ex).lane(lane##_i))

#if defined(__CUDACC__)
struct WarpExec {
    __device__ int first() const { return threadIdx.x & (WARP - 1); }
    __device__ int step() const { return WARP; }
    __device__ int lane(int i) const { return i; }
    __device__ void sync() const { __syncwarp(); }
};
#endif

#if !defined(__CUDA_ARCH__)
// the host executor: one thread runs every lane, in order or reversed
struct HostExec {
    bool reverse;
    int first() const { return 0; }
    int step() const { return 1; }
    int lane(int i) const { return reverse ? WARP - 1 - i : i; }
    void sync() const {}
};
#endif

// ---- units of the frame: kinematics, rnea, crba, Jacobians

// lanes 0-3, one leg each: rotations and positions down the leg
template <typename T>
RBD_FN void kin_unit(int lane, const T* C, const T* q, Kin<T>& k)
{
    if (lane >= 4) return;
    const int leg = lane;
    T Rp[9], pp[3] = {q[0], q[1], q[2]}, sn[3], cs[3];
    RBD_UNROLL
    for (int lvl = 0; lvl < 3; ++lvl)
        r_sincos(q[7 + 3 * leg + lvl], &sn[lvl], &cs[lvl]);
    quat_to_rot(q + 3, Rp);
    if (leg == 0)
        for (int i = 0; i < 9; ++i) k.R0[i] = Rp[i];
    if (leg == 1)
        for (int i = 0; i < 3; ++i) k.p0[i] = q[i];
    for (int lvl = 0; lvl < 3; ++lvl) {
        T Rr[9], Rw[9], d[3];
        axis_rot(axis_of(C, lvl), cs[lvl], sn[lvl], Rr);
        mv3(Rp, placement(C, lvl, leg), d);
        for (int i = 0; i < 3; ++i) {
            pp[i] = pp[i] + d[i];
            k.p[leg][lvl][i] = pp[i];
        }
        mm3(Rp, Rr, Rw);
        for (int i = 0; i < 9; ++i) {
            k.Rr[leg][lvl][i] = Rr[i];
            k.Rw[leg][lvl][i] = Rw[i];
            Rp[i] = Rw[i];
        }
    }
    T d[3];
    mv3(Rp, C + C_FOOT + 3 * leg, d);
    for (int i = 0; i < 3; ++i) k.p[leg][3][i] = pp[i] + d[i];
}

// all lanes: the 108 entries of the motion transforms' F blocks, the
// base's inertia with the optional addend
template <typename T>
RBD_FN void transform_unit(int lane, const T* C, const T* extra,
                           Frame<T>& fr)
{
    for (int e = lane; e < 36; e += WARP)
        fr.Ibase[e] = extra ? C[C_IBASE + e] + extra[e] : C[C_IBASE + e];
    for (int e = lane; e < 4 * 3 * 9; e += WARP) {
        const int leg = e / 27, lvl = (e / 9) % 3, i = (e % 9) / 3,
                  j = e % 3;
        const T* Rr = fr.k.Rr[leg][lvl];
        const T* pl = placement(C, lvl, leg);
        // skew(pl)' = -skew(pl)
        const T Sk[9] = {T(0), pl[2], -pl[1], -pl[2], T(0), pl[0],
                         pl[1], -pl[0], T(0)};
        fr.F[leg][lvl][3 * i + j] = Rr[i] * Sk[j] + Rr[3 + i] * Sk[3 + j]
                                    + Rr[6 + i] * Sk[6 + j];
    }
}

// lanes 0-3: rnea's forward pass down leg `lane` at qdd = 0; lane 4: the
// base's own velocity and acceleration (gravity as an acceleration up)
template <typename T>
RBD_FN void rnea_forward_unit(int lane, const T* C, const T* v, Frame<T>& fr)
{
    if (lane > 4) return;
    const T grav = C[C_GRAV];
    const T w0[3] = {v[3], v[4], v[5]};
    const T v0[3] = {v[0], v[1], v[2]};
    T wd[3] = {T(0), T(0), T(0)}, vd[3];
    for (int i = 0; i < 3; ++i) vd[i] = grav * fr.k.R0[6 + i];
    if (lane == 4) {
        for (int i = 0; i < 3; ++i) {
            fr.fw0[i] = w0[i];
            fr.fw0[3 + i] = v0[i];
            fr.fw0[6 + i] = wd[i];
            fr.fw0[9 + i] = vd[i];
        }
        return;
    }
    const int leg = lane;
    T w[3] = {w0[0], w0[1], w0[2]}, vl[3] = {v0[0], v0[1], v0[2]};
    for (int lvl = 0; lvl < 3; ++lvl) {
        const T* Rr = fr.k.Rr[leg][lvl];
        const T* pl = placement(C, lvl, leg);
        const int ax = axis_of(C, lvl);
        const T qd = v[6 + 3 * leg + lvl];
        T sq[3], t[3], c[3], wn[3], vn[3], wdn[3], vdn[3];
        mtv3(Rr, w, wn);
        RBD_UNROLL
        for (int i = 0; i < 3; ++i) {
            sq[i] = i == ax ? qd : T(0);
            if (i == ax) wn[i] += qd;
        }
        cross(w, pl, t);
        for (int i = 0; i < 3; ++i) t[i] = vl[i] + t[i];
        mtv3(Rr, t, vn);
        mtv3(Rr, wd, wdn);
        cross(wn, sq, c);
        for (int i = 0; i < 3; ++i) wdn[i] += c[i];
        cross(wd, pl, t);
        for (int i = 0; i < 3; ++i) t[i] = vd[i] + t[i];
        mtv3(Rr, t, vdn);
        cross(vn, sq, c);
        for (int i = 0; i < 3; ++i) vdn[i] += c[i];
        T* out = fr.fw[leg][lvl];
        for (int i = 0; i < 3; ++i) {
            w[i] = out[i] = wn[i];
            vl[i] = out[3 + i] = vn[i];
            wd[i] = out[6 + i] = wdn[i];
            vd[i] = out[9 + i] = vdn[i];
        }
    }
}

// lanes 0-11, one body (leg, level) each, and lane 12, the base: its own
// wrench
template <typename T>
RBD_FN void body_wrench_unit(int lane, const T* C, Frame<T>& fr)
{
    if (lane > 12) return;
    const int leg = lane / 3, lvl = lane % 3;
    const T* f = lane < 12 ? fr.fw[leg][lvl] : fr.fw0;
    const T* I = lane < 12 ? C + C_INERTIA + 36 * lvl : fr.Ibase;
    T* out = lane < 12 ? fr.wr[leg][lvl] : fr.basew;
    wrench(I, f, f + 3, f + 6, f + 9, out, out + 3);
}

// lanes 0-3: rnea's backward pass up leg `lane`: the joint torques of h
// and the wrench the leg puts on the base
template <typename T>
RBD_FN void rnea_backward_unit(int lane, const T* C, Frame<T>& fr)
{
    if (lane >= 4) return;
    const int leg = lane;
    T nc[3], fc[3];
    for (int lvl = 2; lvl >= 0; --lvl) {
        const T* wr = fr.wr[leg][lvl];
        T nb[3], fb[3];
        for (int i = 0; i < 3; ++i) {
            nb[i] = lvl < 2 ? wr[i] + nc[i] : wr[i];
            fb[i] = lvl < 2 ? wr[3 + i] + fc[i] : wr[3 + i];
        }
        fr.h[6 + 3 * leg + lvl] = pick3(nb, axis_of(C, lvl));
        const T* Rr = fr.k.Rr[leg][lvl];
        T c[3];
        mv3(Rr, fb, fc);
        mv3(Rr, nb, nc);
        cross(placement(C, lvl, leg), fc, c);
        for (int i = 0; i < 3; ++i) nc[i] += c[i];
    }
    for (int i = 0; i < 3; ++i) {
        fr.legw[leg][i] = nc[i];
        fr.legw[leg][3 + i] = fc[i];
    }
}

// lanes 0-5: the base's six entries of h, the legs' wrenches summed
template <typename T>
RBD_FN void bias_base_unit(int lane, Frame<T>& fr)
{
    if (lane >= 6) return;
    // h = [f; n]: the generalized order is [lin; ang]
    const int c = lane < 3 ? 3 + lane : lane - 3;
    T s = T(0);
    for (int leg = 0; leg < 4; ++leg) s += fr.legw[leg][c];
    fr.h[lane] = fr.basew[c] + s;
}

// lanes 0-23, six a leg, lane (leg, i): row i of parent + X' Ic X for
// level lvl's motion transform X = [[R', 0], [F, R']]: row i of X' Ic (X's
// column i against Ic's rows) in registers, then its products with X's
// columns, the zero block skipped.  Ic is the composite inertia of the
// subtree below the joint (the lower leg's own at level 2); the result the
// upper subtree's composite (level 2), the hip's (level 1), the leg's in
// the base frame (level 0, no parent body)
template <typename T>
RBD_FN void congruence_unit(int lane, const T* C, Frame<T>& fr, int lvl)
{
    if (lane >= 24) return;
    const int leg = lane / 6, i = lane % 6;
    const T* Rr = fr.k.Rr[leg][lvl];
    const T* F = fr.F[leg][lvl];
    const T* Ic = lvl == 2 ? C + C_INERTIA + 72 : fr.Ic[leg][lvl];
    const T* parent = lvl == 2 ? C + C_INERTIA + 36
                               : (lvl == 1 ? C + C_INERTIA : nullptr);
    T* out = lvl == 2 ? fr.Ic[leg][1] : (lvl == 1 ? fr.Ic[leg][0]
                                                  : fr.Ib[leg]);
    // X's column i: R''s column i over F's for i < 3, zeros over R''s
    // column i - 3 below
    T x[6];
    RBD_UNROLL
    for (int r = 0; r < 3; ++r) {
        x[r] = i < 3 ? Rr[3 * i + r] : T(0);
        x[3 + r] = i < 3 ? F[3 * r + i] : Rr[3 * (i - 3) + r];
    }
    T row[6];
    RBD_UNROLL
    for (int j = 0; j < 6; ++j) {
        T s = T(0);
        RBD_UNROLL
        for (int r = 0; r < 6; ++r) s += x[r] * Ic[6 * r + j];
        row[j] = s;
    }
    RBD_UNROLL
    for (int j = 0; j < 6; ++j) {
        T s = T(0);
        if (j < 3) {
            RBD_UNROLL
            for (int r = 0; r < 3; ++r) s += row[r] * Rr[3 * j + r];
            RBD_UNROLL
            for (int r = 0; r < 3; ++r) s += row[3 + r] * F[3 * r + j];
        } else {
            RBD_UNROLL
            for (int r = 0; r < 3; ++r)
                s += row[3 + r] * Rr[3 * (j - 3) + r];
        }
        out[6 * i + j] = parent ? parent[6 * i + j] + s : s;
    }
}

// lanes 0-11, one joint (leg, level) each: the joint's unit-axis column of
// its subtree's composite inertia carried up to the base: M's leg block
// entries on the way (the joint motion subspaces are unit axes: I S is a
// column of I and S' F a component of F), M's base coupling at the end
template <typename T>
RBD_FN void joint_force_unit(int lane, const T* C, Frame<T>& fr)
{
    if (lane >= 12) return;
    const int leg = lane / 3, j = lane % 3;
    const T* Ic = j == 2 ? C + C_INERTIA + 72 : fr.Ic[leg][j];
    const int aj = axis_of(C, j);
    T f[6];
    for (int i = 0; i < 6; ++i) f[i] = Ic[6 * i + aj];
    fr.blk[leg][4 * j] = pick3(f, aj);
    for (int l = j; l >= 0; --l) {
        T fp[6];
        xf_to_parent(fr.k.Rr[leg][l], placement(C, l, leg), f, fp);
        for (int i = 0; i < 6; ++i) f[i] = fp[i];
        if (l > 0) {
            const T m = pick3(f, axis_of(C, l - 1));
            fr.blk[leg][3 * (l - 1) + j] = m;
            fr.blk[leg][3 * j + l - 1] = m;
        }
    }
    for (int i = 0; i < 6; ++i) fr.cols[leg][j][i] = f[i];
}

// row i of the lower triangle's entry e: e = i (i + 1) / 2 + j, i < 6
RBD_FN int tri_row(int e)
{
    return (e >= 1) + (e >= 3) + (e >= 6) + (e >= 10) + (e >= 15);
}

// all lanes: the 324 entries of M, a loop for each kind so that a round's
// lanes take one path.  Base 6x6: the [ang; lin] spatial inertia (base +
// legs + addend) -> [lin; ang] generalized; base coupling: the joints'
// forces [ang; lin] -> rows [lin; ang], and its transpose; the legs'
// blocks; zeros between two legs
template <typename T>
RBD_FN void mass_matrix_unit(int lane, const T* C, const T* extra,
                             Frame<T>& fr)
{
    T* M = fr.M;
    for (int e = lane; e < 36; e += WARP) {
        const int i = e / 6, j = e % 6;
        const int idx = 6 * ((i + 3) % 6) + (j + 3) % 6;
        T s = T(0);
        RBD_UNROLL
        for (int leg = 0; leg < 4; ++leg) s += fr.Ib[leg][idx];
        s = C[C_IBASE + idx] + s;
        M[NV * i + j] = extra ? s + extra[idx] : s;
    }
    for (int e = lane; e < 72; e += WARP) {
        const int i = e / 12, j = 6 + e % 12;
        const T val = fr.cols[(j - 6) / 3][(j - 6) % 3][(i + 3) % 6];
        M[NV * i + j] = val;
        M[NV * j + i] = val;
    }
    for (int e = lane; e < 36; e += WARP) {
        const int o = 6 + 3 * (e / 9), t = e % 9;
        M[NV * (o + t / 3) + o + t % 3] = fr.blk[e / 9][t];
    }
    for (int e = lane; e < 108; e += WARP) {
        // leg pair (la, lb), la != lb, and entry t of their 3 x 3 block
        const int p = e / 9, t = e % 9, la = p / 3, lb = p % 3 + (p % 3 >= la);
        M[NV * (6 + 3 * la + t / 3) + 6 + 3 * lb + t % 3] = T(0);
    }
}

// lanes 0-11, one foot row (3 * leg + i) each: the world-frame
// linear-velocity Jacobian row, joint columns only for the foot's own leg
template <typename T>
RBD_FN void jacobian_unit(int lane, const T* C, Frame<T>& fr)
{
    if (lane >= NF) return;
    const Kin<T>& k = fr.k;
    const int leg = lane / 3, i = lane % 3;
    const T* pf = k.p[leg][3];
    T d[3], r[3];
    for (int c = 0; c < 3; ++c) d[c] = pf[c] - k.p0[c];
    mtv3(k.R0, d, r);
    // base_ang = -(R0 skew(r))
    const T Sk[9] = {T(0), -r[2], r[1], r[2], T(0), -r[0],
                     -r[1], r[0], T(0)};
    T* row = fr.J + NV * lane;
    for (int j = 0; j < 3; ++j) {
        row[j] = k.R0[3 * i + j];
        row[3 + j] = -(k.R0[3 * i] * Sk[j] + k.R0[3 * i + 1] * Sk[3 + j]
                       + k.R0[3 * i + 2] * Sk[6 + j]);
    }
    for (int j = 6; j < NV; ++j) row[j] = T(0);
    for (int lvl = 0; lvl < 3; ++lvl) {
        const T* Rw = k.Rw[leg][lvl];
        const int ax = axis_of(C, lvl);
        const T axw[3] = {Rw[ax], Rw[3 + ax], Rw[6 + ax]};
        T e[3], c[3];
        for (int m = 0; m < 3; ++m) e[m] = pf[m] - k.p[leg][lvl][m];
        cross(axw, e, c);
        row[6 + 3 * leg + lvl] = pick3(c, i);
    }
}

// ---- the frame in phases: kinematics, M (crba), h (rnea at qdd = 0), J
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <typename T, class Exec>
RBD_FN void frame_phases(const Exec& ex, const T* C, const T* q, const T* v,
                         const T* extra, Frame<T>& fr)
{
    RBD_EACH_LANE(ex, lane) kin_unit(lane, C, q, fr.k);
    ex.sync();
    RBD_EACH_LANE(ex, lane) {
        transform_unit(lane, C, extra, fr);
        rnea_forward_unit(lane, C, v, fr);
        jacobian_unit(lane, C, fr);
    }
    ex.sync();
    RBD_EACH_LANE(ex, lane) {
        congruence_unit(lane, C, fr, 2);
        body_wrench_unit(lane, C, fr);
    }
    ex.sync();
    RBD_EACH_LANE(ex, lane) {
        congruence_unit(lane, C, fr, 1);
        rnea_backward_unit(lane, C, fr);
    }
    ex.sync();
    RBD_EACH_LANE(ex, lane) {
        congruence_unit(lane, C, fr, 0);
        joint_force_unit(lane, C, fr);
        bias_base_unit(lane, fr);
    }
    ex.sync();
    RBD_EACH_LANE(ex, lane) mass_matrix_unit(lane, C, extra, fr);
    ex.sync();
}

// ---- the WBC build: wbc/tsid.py::_build_wbc_qp for one scenario,
// (H, g, A, l, u, M, h, J) with J = JcT' (the wrapper hands back its
// transposed view)

// elements lane, lane + 32, ... of an n-vector: src -> dst
template <typename T>
RBD_FN void copy_row(int lane, const T* src, T* dst, int n)
{
    for (int i = lane; i < n; i += WARP) dst[i] = src[i];
}

// all lanes: the scenario's input rows into the slot
template <typename T>
RBD_FN void wbc_load_unit(int lane, const WbcArgs<T>& a, long long b,
                          WbcSlot<T>& S)
{
    copy_row(lane, a.row(WI_Q, b), S.q, NQ);
    copy_row(lane, a.row(WI_V, b), S.v, NV);
    copy_row(lane, a.row(WI_CONTACTS, b), S.cts, 4);
    copy_row(lane, a.row(WI_F_MPC, b), S.f_mpc, NF);
    copy_row(lane, a.row(WI_POS_REF, b), S.pos_ref, NF);
    copy_row(lane, a.row(WI_VEL_REF, b), S.vel_ref, NF);
    copy_row(lane, a.row(WI_ACC_REF, b), S.acc_ref, NF);
    copy_row(lane, a.row(WI_Q_POSTURE, b), S.q_post, 12);
    copy_row(lane, a.row(WI_RPY_REF, b), S.rpy_ref, 2);
    copy_row(lane, a.row(WI_H_REF, b), S.h_ref, 1);
    if (a.in[WI_EXTRA]) copy_row(lane, a.row(WI_EXTRA, b), S.extra, 36);
}

// lanes 0-3, one leg each: the foot's drift (world-frame J-dot v:
// classical acceleration, qdd = 0, gravity off); lanes 4-15, one foot row
// each: J v; lane 16: roll, pitch, yaw
template <typename T>
RBD_FN void wbc_task_unit(int lane, const T* C, WbcSlot<T>& S)
{
    const Kin<T>& k = S.fr.k;
    const T* v = S.v;
    if (lane >= 4 && lane < 4 + NF) {
        const T* row = S.fr.J + NV * (lane - 4);
        T s = T(0);
        RBD_UNROLL
        for (int j = 0; j < NV; ++j) s += row[j] * v[j];
        S.foot_vel[lane - 4] = s;
    } else if (lane == 16) {
        rot_to_rpy(k.R0, S.rpy);
    }
    if (lane >= 4) return;
    const int leg = lane;
    T w[3], vl[3], al[3] = {T(0), T(0), T(0)}, acc[3], c[3];
    mv3(k.R0, v + 3, w);
    mv3(k.R0, v, vl);
    cross(v + 3, v, c);
    mv3(k.R0, c, acc);
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
                S.drift[3 * leg + i] = acc[i] + t1[i] + t3[i];
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

// sum over the rows r of [r0, r0 + N) of x[r] * y[r] (strides sx, sy),
// unrolled: N is 3 (a leg's rows) or 12 (every foot row)
template <typename T, int N>
RBD_FN T dot_rows(const T* x, int sx, const T* y, int sy, int r0)
{
    T s = T(0);
    RBD_UNROLL
    for (int r = 0; r < N; ++r) s += x[sx * (r0 + r)] * y[sy * (r0 + r)];
    return s;
}

// all lanes: the 216 entries of J' W J that are not structurally zero
// (base x base: 12 rows; base x leg, leg x base, a leg's own block: its 3
// rows), into Hq; lanes 0-11: the swing-tracking rows' weight and target
// J_i qdd = a_des_i - drift_i, weighted by (1 - contact)
template <typename T>
RBD_FN void wbc_weight_unit(int lane, const T* P, WbcSlot<T>& S)
{
    const T* J = S.fr.J;
    for (int e = lane; e < 216; e += WARP) {
        int i, j;
        if (e < 36) {
            i = e / 6;
            j = e % 6;
        } else if (e < 108) {
            i = (e - 36) / 12;
            j = 6 + (e - 36) % 12;
        } else if (e < 180) {
            i = 6 + (e - 108) / 6;
            j = (e - 108) % 6;
        } else {
            const int o = 6 + 3 * ((e - 180) / 9), t = (e - 180) % 9;
            i = o + t / 3;
            j = o + t % 3;
        }
        T s;
        if (e < 36) {
            s = T(0);
            RBD_UNROLL
            for (int r = 0; r < NF; ++r)
                s += J[NV * r + i]
                     * (P[WP_W_FOOT] * (T(1) - S.cts[r / 3]) * J[NV * r + j]);
        } else {
            const int r0 = 3 * (((i < 6 ? j : i) - 6) / 3);
            const T w = P[WP_W_FOOT] * (T(1) - S.cts[r0 / 3]);
            s = T(0);
            RBD_UNROLL
            for (int r = 0; r < 3; ++r)
                s += J[NV * (r0 + r) + i] * (w * J[NV * (r0 + r) + j]);
        }
        S.Hq[NV * i + j] = s;
    }
    if (lane >= NF) return;
    const int r = lane, leg = r / 3, i = r % 3;
    const T w_leg = P[WP_W_FOOT] * (T(1) - S.cts[leg]);
    const T a_des = S.acc_ref[r]
                    + P[WP_KP_FOOT] * (S.pos_ref[r] - S.fr.k.p[leg][3][i])
                    + P[WP_KD_FOOT] * (S.vel_ref[r] - S.foot_vel[r]);
    S.wb[r] = w_leg * (a_des - S.drift[r]);
}

// the stores: rows across lanes, lane j on column j, so that each row
// leaves by consecutive lanes at consecutive addresses; each block of rows
// its own loop.  H (30 x 30): J' W J on the qdd block, the diagonal tasks,
// the strict-convexity and swing-force ridges; g (30)
template <typename T>
RBD_FN void wbc_cost_store_unit(int lane, const WbcArgs<T>& a, long long b,
                                const WbcSlot<T>& S)
{
    const T* P = a.par;
    const bool exact_pin = P[WP_EXACT_PIN] != T(0);
    const int j = lane;
    if (j >= NX) return;
    T* H = a.out[WO_H] + b * (NX * NX) + j;
    // the qdd rows: J' W J where it is not structurally zero
    const int leg_j = j < 6 ? -1 : (j - 6) / 3;
    RBD_UNROLL_BY(6)
    for (int i = 0; i < NV; ++i) {
        const bool nz = j < NV && (i < 6 || leg_j < 0 || (i - 6) / 3 == leg_j);
        T s = nz ? S.Hq[NV * i + j] : T(0);
        if (i == j) {
            if (i >= 6) s += P[WP_W_POSTURE];          // posture
            if (i >= 2 && i < 5) s += P[WP_W_BASE];    // height, roll, pitch
            s = s + P[WP_EPS];
        }
        H[NX * i] = s;
    }
    // the force rows: force tracking, then the ridges, on the diagonal
    const T diag = j >= NV
        ? P[WP_W_FORCE] + (P[WP_EPS] + (exact_pin ? T(0)
              : P[WP_W_PIN] * (T(1) - S.cts[(j - NV) / 3])))
        : T(0);
    RBD_UNROLL_BY(6)
    for (int i = NV; i < NX; ++i) H[NX * i] = i == j ? diag : T(0);
    T g;
    if (j >= NV) {
        g = -P[WP_W_FORCE] * S.f_mpc[j - NV];
    } else {
        const T s = j < 6 ? dot_rows<T, NF>(S.fr.J + j, NV, S.wb, 1, 0)
                          : dot_rows<T, 3>(S.fr.J + j, NV, S.wb, 1,
                                           3 * ((j - 6) / 3));
        g = -s;
        if (j >= 6) {
            const T a_post = P[WP_KP_POSTURE] * (S.q_post[j - 6] - S.q[1 + j])
                             - P[WP_KD_POSTURE] * S.v[j];
            g += -P[WP_W_POSTURE] * a_post;
        }
        if (j >= 2 && j < 5) {
            const T ref = j == 2 ? S.h_ref[0] : S.rpy_ref[j - 3];
            const T now = j == 2 ? S.q[2] : S.rpy[j - 3];
            const T a_base = P[WP_KP_BASE] * (ref - now)
                             - P[WP_KD_BASE] * S.v[j];
            g += -P[WP_W_BASE] * a_base;
        }
    }
    a.out[WO_G][b * NX + j] = g;
}

// A (50 x 30): base dynamics (6) and torque bounds (12) [M, -J'], the
// friction pyramid (20), the stance contacts (12); exact_pin zeroes the
// swing forces' columns.  The bounds l, u
template <typename T>
RBD_FN void wbc_constraint_store_unit(int lane, const WbcArgs<T>& a,
                                      long long b, const WbcSlot<T>& S)
{
    const T* P = a.par;
    const bool exact_pin = P[WP_EXACT_PIN] != T(0);
    const T mu = P[WP_MU], inf = P[WP_INF];
    const T* J = S.fr.J;
    const int j = lane;
    if (j < NX) {
        T* A = a.out[WO_A] + b * (NC * NX) + j;
        // column j's force (j >= 18): its leg, its axis, its pin factor
        const int f = j - NV, leg = f / 3, ax = f % 3;
        const T pin = j >= NV && exact_pin ? S.cts[leg] : T(1);
        RBD_UNROLL_BY(6)
        for (int r = 0; r < NV; ++r)
            A[NX * r] = j < NV ? S.fr.M[NV * r + j]
                               : (exact_pin ? -J[NV * f + r] * pin
                                            : -J[NV * f + r]);
        // pyramid row s of each leg: (1, 0, -mu), (1, 0, mu), (0, 1, -mu),
        // (0, 1, mu), (0, 0, 1) on its force's columns
        RBD_UNROLL_BY(5)
        for (int r = 0; r < 20; ++r) {
            const int s = r % 5;
            T val = T(0);
            if (j >= NV && leg == r / 5)
                val = ax == 2 ? (s == 4 ? T(1) : (s % 2 == 0 ? -mu : mu))
                              : (s < 4 && ax == s / 2 ? T(1) : T(0));
            A[NX * (NV + r)] = exact_pin ? val * pin : val;
        }
        RBD_UNROLL_BY(4)
        for (int i = 0; i < NF; ++i)
            A[NX * (NV + 20 + i)] = j < NV ? J[NV * i + j] * S.cts[i / 3]
                                           : T(0);
    }
    T* l = a.out[WO_L] + b * NC;
    T* u = a.out[WO_U] + b * NC;
    for (int r = lane; r < NC; r += WARP) {
        T lo, hi;
        if (r < 6) {
            lo = hi = -S.fr.h[r];
        } else if (r < NV) {
            lo = -P[WP_TAU_MAX] - S.fr.h[r];
            hi = P[WP_TAU_MAX] - S.fr.h[r];
        } else if (r < NV + 20) {
            const int s = (r - NV) % 5;
            const bool stance = S.cts[(r - NV) / 5] > T(0.5);
            lo = !stance || s % 2 == 0 ? -inf : T(0);
            hi = !stance || s % 2 == 1 ? inf : T(0);
            if (stance && s == 4) {
                lo = P[WP_FZ_MIN];
                hi = P[WP_FZ_MAX];
            }
        } else {
            const int i = r - NV - 20;
            const T b_con = -S.drift[i] - P[WP_KD_CONTACT] * S.foot_vel[i];
            const bool stance = S.cts[i / 3] > T(0.5);
            lo = stance ? b_con : -inf;
            hi = stance ? b_con : inf;
        }
        l[r] = lo;
        u[r] = hi;
    }
}

// M, h, J as the frame holds them
template <typename T>
RBD_FN void wbc_frame_store_unit(int lane, const WbcArgs<T>& a, long long b,
                                 const WbcSlot<T>& S)
{
    copy_row(lane, S.fr.M, a.out[WO_M] + b * (NV * NV), NV * NV);
    copy_row(lane, S.fr.J, a.out[WO_J] + b * (NF * NV), NF * NV);
    copy_row(lane, S.fr.h, a.out[WO_BIAS] + b * NV, NV);
}

#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <typename T, class Exec>
RBD_FN void wbc_build_warp(const Exec& ex, const T* C, const WbcArgs<T>& a,
                           long long b, WbcSlot<T>& S)
{
    RBD_EACH_LANE(ex, lane) wbc_load_unit(lane, a, b, S);
    ex.sync();
    frame_phases(ex, C, S.q, S.v, a.in[WI_EXTRA] ? S.extra : (const T*)0,
                 S.fr);
    RBD_EACH_LANE(ex, lane) wbc_task_unit(lane, C, S);
    ex.sync();
    RBD_EACH_LANE(ex, lane) wbc_weight_unit(lane, a.par, S);
    ex.sync();
    RBD_EACH_LANE(ex, lane) {
        wbc_cost_store_unit(lane, a, b, S);
        wbc_constraint_store_unit(lane, a, b, S);
        wbc_frame_store_unit(lane, a, b, S);
    }
}

// ---- the plant step: env/plant.py::plant_step for one scenario,
// `substeps` substeps of implicit-damping contact integration, the cone
// clamp with anchor drag and the explicit re-solve where a foot was clamped

// all lanes: the state, torques and contact parameters into the slot
template <typename T>
RBD_FN void plant_load_unit(int lane, const PlantArgs<T>& a, long long b,
                            PlantSlot<T>& S)
{
    copy_row(lane, a.row(PI_Q, b), S.q, NQ);
    copy_row(lane, a.row(PI_V, b), S.v, NV);
    copy_row(lane, a.row(PI_ANCHOR, b), S.anchor, 8);
    copy_row(lane, a.row(PI_IN_CONTACT, b), S.in_c, 4);
    copy_row(lane, a.row(PI_TAU, b), S.tau, 12);
    if (a.in[PI_EXTRA]) copy_row(lane, a.row(PI_EXTRA, b), S.extra, 36);
    if (lane < 5) S.cp[lane] = a.row(PI_KP_N + lane, b)[0];
    if (lane < NF) S.f_cl[lane] = T(0);
}

// lanes 0-3, one foot each: contact below the ground (a new contact
// anchors where it touched) and the elastic force (world): anchored
// tangential spring, normal spring
template <typename T>
RBD_FN void contact_unit(int lane, PlantSlot<T>& S)
{
    if (lane >= 4) return;
    const int leg = lane;
    const T kp_n = S.cp[0], kp_t = S.cp[2];
    const T* pf = S.fr.k.p[leg][3];
    const bool below = pf[2] < T(0);
    if (below && S.in_c[leg] < T(0.5)) {
        S.anchor[2 * leg] = pf[0];
        S.anchor[2 * leg + 1] = pf[1];
    }
    const T inc = below ? T(1) : T(0);
    S.inc[leg] = inc;
    S.f_el[3 * leg] = -kp_t * (pf[0] - S.anchor[2 * leg]) * inc;
    S.f_el[3 * leg + 1] = -kp_t * (pf[1] - S.anchor[2 * leg + 1]) * inc;
    S.f_el[3 * leg + 2] = -kp_n * pf[2] * inc;
}

// lanes 0-17: row i of M v and tau_gen - bias
template <typename T>
RBD_FN void momentum_unit(int lane, PlantSlot<T>& S)
{
    if (lane >= NV) return;
    const T* row = S.fr.M + NV * lane;
    T s = T(0);
    RBD_UNROLL
    for (int j = 0; j < NV; ++j) s += row[j] * S.v[j];
    S.Mv[lane] = s;
    S.base[lane] = (lane < 6 ? T(0) : S.tau[lane - 6]) - S.fr.h[lane];
}

// all lanes: M_eff = M + h sum_active J' D J on the 117 lower non-zeros of
// its arrow: the base block (21 entries, every foot row), the base
// coupling (72) and the legs' blocks (24; each from its leg's three rows)
template <typename T>
RBD_FN void meff_unit(int lane, T h_dt, PlantSlot<T>& S)
{
    const T* J = S.fr.J;
    const T kd_n = S.cp[1], kd_t = S.cp[3];
    for (int e = lane; e < 117; e += WARP) {
        int i, j, r0 = 0;
        if (e < 21) {
            i = tri_row(e);
            j = e - i * (i + 1) / 2;
        } else if (e < 93) {
            i = 6 + (e - 21) / 6;
            j = (e - 21) % 6;
            r0 = 3 * ((i - 6) / 3);
        } else {
            const int t = (e - 93) % 6, ii = t < 1 ? 0 : (t < 3 ? 1 : 2);
            r0 = 3 * ((e - 93) / 6);
            i = 6 + r0 + ii;
            j = 6 + r0 + t - ii * (ii + 1) / 2;
        }
        T s = T(0);
        if (e < 21) {
            RBD_UNROLL
            for (int r = 0; r < NF; ++r)
                s += J[NV * r + i] * (J[NV * r + j]
                                      * ((r % 3 == 2 ? kd_n : kd_t)
                                         * S.inc[r / 3]));
        } else {
            RBD_UNROLL
            for (int r = 0; r < 3; ++r)
                s += J[NV * (r0 + r) + i] * (J[NV * (r0 + r) + j]
                                             * ((r == 2 ? kd_n : kd_t)
                                                * S.inc[r0 / 3]));
        }
        S.Me[NV * i + j] = S.fr.M[NV * i + j] + h_dt * s;
    }
}

// lanes 0-17: rhs = M v + h (tau_gen - bias + J' f) for the forces f
template <typename T>
RBD_FN void rhs_unit(int lane, T h_dt, const T* f, PlantSlot<T>& S)
{
    if (lane >= NV) return;
    const T* J = S.fr.J + lane;
    const T s = lane < 6 ? dot_rows<T, NF>(f, 1, J, NV, 0)
                         : dot_rows<T, 3>(f, 1, J, NV, 3 * ((lane - 6) / 3));
    S.rhs[lane] = S.Mv[lane] + h_dt * (S.base[lane] + s);
}

// ---- the arrow solve: A x = b for an SPD A (18 x 18, lower triangle)
// whose legs couple only to the base.  With the legs first, A = [[D, C],
// [C', B0]]: each leg's 3 x 3 block D_L = L_L L_L', V_L = L_L^-1 C_L
// (3 x 6), the base's Schur complement S = B0 - sum V_L' V_L = L_S L_S';
// then y_L = L_L^-1 b_L, x_0 = L_S^-T L_S^-1 (b_0 - sum V_L' y_L),
// x_L = L_L^-T (y_L - V_L x_0).  The small factors live in registers (a
// division per column, then products by its reciprocal); V_L and S are
// written over A.

// the Cholesky factor of the N x N SPD block at A (row stride NV, lower
// triangle read) in registers: L (lower, row-major) and the reciprocals of
// its diagonal
template <typename T, int N>
RBD_FN void chol_regs(const T* A, T* L, T* inv)
{
    RBD_UNROLL
    for (int i = 0; i < N; ++i)
        RBD_UNROLL
        for (int j = 0; j <= i; ++j) L[N * i + j] = A[NV * i + j];
    RBD_UNROLL
    for (int j = 0; j < N; ++j) {
        T s = L[N * j + j];
        RBD_UNROLL
        for (int k = 0; k < j; ++k) s -= L[N * j + k] * L[N * j + k];
        const T d = r_sqrt(s);
        L[N * j + j] = d;
        inv[j] = T(1) / d;
        RBD_UNROLL
        for (int i = j + 1; i < N; ++i) {
            T t = L[N * i + j];
            RBD_UNROLL
            for (int k = 0; k < j; ++k) t -= L[N * i + k] * L[N * j + k];
            L[N * i + j] = t * inv[j];
        }
    }
}

// L y = b in place (forward), L' x = y in place (backward)
template <typename T, int N>
RBD_FN void forward_regs(const T* L, const T* inv, T* b)
{
    RBD_UNROLL
    for (int i = 0; i < N; ++i) {
        T t = b[i];
        RBD_UNROLL
        for (int k = 0; k < i; ++k) t -= L[N * i + k] * b[k];
        b[i] = t * inv[i];
    }
}

template <typename T, int N>
RBD_FN void backward_regs(const T* L, const T* inv, T* b)
{
    RBD_UNROLL
    for (int i = N - 1; i >= 0; --i) {
        T t = b[i];
        RBD_UNROLL
        for (int k = i + 1; k < N; ++k) t -= L[N * k + i] * b[k];
        b[i] = t * inv[i];
    }
}

// lanes 0-23, one (leg, base column) each: the leg's factor, V_L's column
// in place of C_L's (lane c = 0 also keeps the factor in Lf); lanes 24-27:
// the leg's factor again and y_L
template <typename T>
RBD_FN void arrow_couple_unit(int lane, T* A, const T* b, T* y, T* Lf)
{
    if (lane >= 28) return;
    const int leg = lane < 24 ? lane / 6 : lane - 24, o = 6 + 3 * leg;
    T L[9], inv[3], x[3];
    chol_regs<T, 3>(A + (NV + 1) * o, L, inv);
    if (lane < 24) {
        const int c = lane % 6;
        RBD_UNROLL
        for (int k = 0; k < 3; ++k) x[k] = A[NV * (o + k) + c];
        forward_regs<T, 3>(L, inv, x);
        RBD_UNROLL
        for (int k = 0; k < 3; ++k) A[NV * (o + k) + c] = x[k];
        if (c == 0) {
            RBD_UNROLL
            for (int k = 0; k < 9; ++k) Lf[12 * leg + k] = L[k];
            RBD_UNROLL
            for (int k = 0; k < 3; ++k) Lf[12 * leg + 9 + k] = inv[k];
        }
    } else {
        RBD_UNROLL
        for (int k = 0; k < 3; ++k) x[k] = b[o + k];
        forward_regs<T, 3>(L, inv, x);
        RBD_UNROLL
        for (int k = 0; k < 3; ++k) y[o + k] = x[k];
    }
}

// lanes 0-20, one (i, j) of the base block's lower triangle each: S;
// lanes 21-26: b_0 - sum V' y_L
template <typename T>
RBD_FN void arrow_schur_unit(int lane, T* A, const T* b, T* y)
{
    if (lane < 21) {
        const int i = tri_row(lane), j = lane - i * (i + 1) / 2;
        T s = A[NV * i + j];
        RBD_UNROLL
        for (int r = 6; r < NV; ++r) s -= A[NV * r + i] * A[NV * r + j];
        A[NV * i + j] = s;
    } else if (lane < 27) {
        const int c = lane - 21;
        T s = b[c];
        RBD_UNROLL
        for (int r = 6; r < NV; ++r) s -= A[NV * r + c] * y[r];
        y[c] = s;
    }
}

// lane 0: S's factor and x_0
template <typename T>
RBD_FN void arrow_base_unit(int lane, const T* A, const T* y, T* x)
{
    if (lane != 0) return;
    T L[36], inv[6], t[6];
    chol_regs<T, 6>(A, L, inv);
    RBD_UNROLL
    for (int i = 0; i < 6; ++i) t[i] = y[i];
    forward_regs<T, 6>(L, inv, t);
    backward_regs<T, 6>(L, inv, t);
    RBD_UNROLL
    for (int i = 0; i < 6; ++i) x[i] = t[i];
}

// lanes 0-3: x_L
template <typename T>
RBD_FN void arrow_back_unit(int lane, const T* A, const T* y, const T* Lf,
                            T* x)
{
    if (lane >= 4) return;
    const int o = 6 + 3 * lane;
    T t[3];
    RBD_UNROLL
    for (int k = 0; k < 3; ++k) {
        T s = y[o + k];
        RBD_UNROLL
        for (int c = 0; c < 6; ++c) s -= A[NV * (o + k) + c] * x[c];
        t[k] = s;
    }
    backward_regs<T, 3>(Lf + 12 * lane, Lf + 12 * lane + 9, t);
    RBD_UNROLL
    for (int k = 0; k < 3; ++k) x[o + k] = t[k];
}

#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <typename T, class Exec>
RBD_FN void arrow_solve(const Exec& ex, T* A, const T* b, T* y, T* Lf, T* x)
{
    RBD_EACH_LANE(ex, lane) arrow_couple_unit(lane, A, b, y, Lf);
    ex.sync();
    RBD_EACH_LANE(ex, lane) arrow_schur_unit(lane, A, b, y);
    ex.sync();
    RBD_EACH_LANE(ex, lane) arrow_base_unit(lane, A, y, x);
    ex.sync();
    RBD_EACH_LANE(ex, lane) arrow_back_unit(lane, A, y, Lf, x);
    ex.sync();
}

// lanes 0-3, one foot each: its force at the implicit velocity, the
// Coulomb-cone / unilateral clamp, the anchor dragged where the cone clamps
template <typename T>
RBD_FN void clamp_unit(int lane, PlantSlot<T>& S)
{
    if (lane >= 4) return;
    const int leg = lane;
    const T kp_t = S.cp[2], kd_t = S.cp[3], mu = S.cp[4];
    const T d_vec[3] = {kd_t, kd_t, S.cp[1]};
    const T inc = S.inc[leg];
    T fv[3], f_raw[3];
    RBD_UNROLL
    for (int i = 0; i < 3; ++i) {
        const T* row = S.fr.J + NV * (3 * leg + i);
        T s = T(0);
        RBD_UNROLL
        for (int j = 0; j < NV; ++j) s += row[j] * S.vi[j];
        fv[i] = s;
        f_raw[i] = S.f_el[3 * leg + i] - d_vec[i] * fv[i] * inc;
    }
    const T fz = f_raw[2] > T(0) ? f_raw[2] : T(0);
    const T limit = mu * fz;
    const T ft_norm = r_sqrt(f_raw[0] * f_raw[0] + f_raw[1] * f_raw[1]);
    const bool over = ft_norm > limit;
    const T safe = ft_norm > T(1e-12) ? ft_norm : T(1e-12);
    const T scale = over ? limit / safe : T(1);
    const T ftx = f_raw[0] * scale, fty = f_raw[1] * scale;
    const bool active = inc > T(0.5);
    const T* pf = S.fr.k.p[leg][3];
    if (over && active) {
        S.anchor[2 * leg] = pf[0] + (ftx + kd_t * fv[0]) / kp_t;
        S.anchor[2 * leg + 1] = pf[1] + (fty + kd_t * fv[1]) / kp_t;
    }
    S.clamp[leg] = (over || f_raw[2] < T(0)) && active ? T(1) : T(0);
    S.f_cl[3 * leg] = ftx * inc;
    S.f_cl[3 * leg + 1] = fty * inc;
    S.f_cl[3 * leg + 2] = fz * inc;
}

// the base's position and orientation q[0:7] over dt, in place, from the
// base's velocity v[0:6] (integrate_q's local convention): the plant's
// integration (lane 0 of `integrate_unit`) and the estimator's attitude
// steps (est_step.h)
template <typename T>
RBD_FN void integrate_base(const T* v, T dt, T* q)
{
    T R0[9], d[3];
    quat_to_rot(q + 3, R0);
    mv3(R0, v, d);
    const T w[3] = {v[3] * dt, v[4] * dt, v[5] * dt};
    const T th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
    const T th = r_sqrt(th2 + T(1e-30));
    T sh, ch;
    r_sincos(th / T(2), &sh, &ch);
    const T sinc_half = th < T(1e-8) ? T(0.5) - th2 / T(48) : sh / th;
    const T x2 = w[0] * sinc_half, y2 = w[1] * sinc_half,
            z2 = w[2] * sinc_half, w2 = ch;
    const T x1 = q[3], y1 = q[4], z1 = q[5], w1 = q[6];
    const T quat[4] = {w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                       w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                       w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                       w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2};
    const T nrm = r_sqrt(quat[0] * quat[0] + quat[1] * quat[1]
                         + quat[2] * quat[2] + quat[3] * quat[3]);
    for (int i = 0; i < 3; ++i) q[i] = q[i] + d[i] * dt;
    for (int i = 0; i < 4; ++i) q[3 + i] = quat[i] / nrm;
}

// lane 0: the base's position and orientation over dt (`integrate_base`);
// lanes 1-12: the joints; lanes 0-17: v; lanes 0-3: contacts
template <typename T>
RBD_FN void integrate_unit(int lane, T dt, PlantSlot<T>& S)
{
    const T* v = S.vi;
    T* q = S.q;
    if (lane == 0) {
        integrate_base(v, dt, q);
    } else if (lane <= 12) {
        q[6 + lane] = q[6 + lane] + v[5 + lane] * dt;
    }
    if (lane < NV) S.v[lane] = v[lane];
    if (lane < 4) S.in_c[lane] = S.inc[lane];
}

// one substep of env/plant.py: (M + h J' D J) v+ = M v + h (tau_gen - bias
// + J' f_el), the clamp, the explicit re-solve with M where a foot was
// clamped (the branch is the scenario's, so the warp's), the integration
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <typename T, class Exec>
RBD_FN void plant_substep_warp(const Exec& ex, const T* C, const T* extra,
                               T h_dt, PlantSlot<T>& S)
{
    frame_phases(ex, C, S.q, S.v, extra, S.fr);
    RBD_EACH_LANE(ex, lane) {
        contact_unit(lane, S);
        momentum_unit(lane, S);
    }
    ex.sync();
    RBD_EACH_LANE(ex, lane) {
        meff_unit(lane, h_dt, S);
        rhs_unit(lane, h_dt, S.f_el, S);
    }
    ex.sync();
    arrow_solve(ex, S.Me, S.rhs, S.y, S.Lf, S.vi);
    RBD_EACH_LANE(ex, lane) clamp_unit(lane, S);
    ex.sync();
    if (S.clamp[0] + S.clamp[1] + S.clamp[2] + S.clamp[3] > T(0)) {
        RBD_EACH_LANE(ex, lane) rhs_unit(lane, h_dt, S.f_cl, S);
        ex.sync();
        arrow_solve(ex, S.fr.M, S.rhs, S.y, S.Lf, S.vi);
    }
    RBD_EACH_LANE(ex, lane) integrate_unit(lane, h_dt, S);
    ex.sync();
}

// all lanes: the new state and the last substep's ground forces out
template <typename T>
RBD_FN void plant_store_unit(int lane, const PlantArgs<T>& a, long long b,
                             const PlantSlot<T>& S)
{
    copy_row(lane, S.q, a.out[PO_Q] + b * NQ, NQ);
    copy_row(lane, S.v, a.out[PO_V] + b * NV, NV);
    copy_row(lane, S.anchor, a.out[PO_ANCHOR] + b * 8, 8);
    copy_row(lane, S.in_c, a.out[PO_IN_CONTACT] + b * 4, 4);
    copy_row(lane, S.f_cl, a.out[PO_F] + b * NF, NF);
}

#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <typename T, class Exec>
RBD_FN void plant_step_warp(const Exec& ex, const T* C,
                            const PlantArgs<T>& a, long long b,
                            PlantSlot<T>& S)
{
    RBD_EACH_LANE(ex, lane) plant_load_unit(lane, a, b, S);
    ex.sync();
    const T* extra = a.in[PI_EXTRA] ? S.extra : (const T*)0;
    const int substeps = (int)a.par[PP_SUBSTEPS];
    for (int s = 0; s < substeps; ++s)
        plant_substep_warp(ex, C, extra, a.par[PP_H_DT], S);
    RBD_EACH_LANE(ex, lane) plant_store_unit(lane, a, b, S);
}

}  // namespace rbd
