// The planner's per-scenario arithmetic: the footstep horizon, the
// reference rollout and the swing reference, for the kernels of
// planner.cu.
//
// Plain C++: every function is marked PLAN_FN, `__host__ __device__` under
// nvcc and plain `inline` under a host compiler, so the tests build this
// very arithmetic with g++ and run it on the CPU
// (tests/test_torch_plan_kernels.py).  One call computes what one thread of
// a kernel computes: a (scenario, foot) of the footstep horizon and of the
// swing reference, a (scenario, step) of the reference rollout.  Templated
// on the value type (float, double).
//
// Rounding.  Each expression is the plain PyTorch version's, op by op and
// in its order: one rounding per op, no FMA (planner.cu is built with
// -fmad=false; a host compiler contracts nothing under -std=c++17).  Where
// PyTorch on the card rounds otherwise than the formula reads, the card's
// form is written: a tensor divided by a Python number is the product with
// its reciprocal (h / g -> h * (1 / g)); `1.0 / t` is t's reciprocal;
// s ** 3 is s * s * s and s ** 4, s ** 5 are pow(s, 4), pow(s, 5).  The
// plain version's rotations go through torch.bmm and torch.einsum, which
// cuBLAS rounds either as the FMA chain of a dot product in k order (a zero
// third term: fma(a1, b1, a0 b0)) or as two products and a sum, by the
// call's dtype and batch; the wrapper says which (`fused_*` parameters,
// plan/kernels.py::rotation_forms) and `dot2` forms it.
//
// Inputs reach a kernel as a first row and the stride between two
// scenarios' rows (0 for a row broadcast to every scenario), in elements.

#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define PLAN_FN __host__ __device__ __forceinline__
#else
#define PLAN_FN inline
#endif

namespace planner {

constexpr int N_GAITS = 5;      // model/gaits.py's tables
constexpr int PERIOD = 16;      // GAIT_PERIOD: MPC steps per gait cycle
constexpr int FEET = 4;
// the gait tables as one int array: stance flags [gait][phase][foot], then
// the stance steps per period [gait][foot] (plan/gait.py: TABLES,
// _STANCE_STEPS_NP)
constexpr int TABLE_INTS = N_GAITS * PERIOD * FEET + N_GAITS * FEET;

// ---- operands, in the order of the launchers' arrays
enum FootIn { FI_GAIT, FI_PHASE, FI_X, FI_VCMD, FI_FEET, FI_COUNT };
enum FootOut { FO_FEET, FO_TD, FO_COUNT };
// dt, h_ref, g, t_stance_factor, k_raibert, the forms of the command's
// rotation (bmm) and of the shoulders' (einsum): 1 fused, 0 not; the
// shoulder offsets [foot][3]
enum FootPar { FP_DT, FP_H_REF, FP_G, FP_TSF, FP_KR, FP_FUSED_BMM,
               FP_FUSED_EINSUM, FP_SH, FP_COUNT = FP_SH + 3 * FEET };
enum RollIn { RI_X, RI_VCMD, RI_COUNT };
// dt, h_ref, the form of the rotation (bmm)
enum RollPar { RP_DT, RP_H_REF, RP_FUSED_BMM, RP_COUNT };
enum SwingIn { SI_LIFT, SI_TD, SI_S, SI_T, SI_COUNT };
enum SwingOut { SO_POS, SO_VEL, SO_ACC, SO_COUNT };
enum SwingPar { SP_H64, SP_COUNT };     // 64 h_apex

// the gait tables' ints and each kernel's operand counts: inputs, outputs,
// parameters of the footsteps, the rollout, the swing reference
// (plan/kernels.py::LAYOUT; -1 past the end)
inline int layout(int what)
{
    const int counts[] = {TABLE_INTS, FI_COUNT, FO_COUNT, FP_COUNT,
                          RI_COUNT, 1, RP_COUNT, SI_COUNT, SO_COUNT,
                          SP_COUNT};
    return what >= 0 && what < (int)(sizeof(counts) / sizeof(int))
               ? counts[what] : -1;
}

template <typename T, int NI, int NO, int NP>
struct Args {
    const void* in[NI];
    long long stride[NI];
    T* out[NO];
    T par[NP];

    template <typename U>
    PLAN_FN const U* row(int k, long long b) const
    {
        return static_cast<const U*>(in[k]) + b * stride[k];
    }
};

template <typename T> using FootArgs = Args<T, FI_COUNT, FO_COUNT, FP_COUNT>;
template <typename T> using RollArgs = Args<T, RI_COUNT, 1, RP_COUNT>;
template <typename T>
using SwingArgs = Args<T, SI_COUNT, SO_COUNT, SP_COUNT>;

// the launchers' arrays -> Args (host side: the kernels take Args by value)
template <typename T, int NI, int NO, int NP>
inline void fill(Args<T, NI, NO, NP>& a, const void* const* in,
                 const long long* stride, void* const* out,
                 const double* par)
{
    for (int k = 0; k < NI; ++k) {
        a.in[k] = in[k];
        a.stride[k] = stride[k];
    }
    for (int k = 0; k < NO; ++k) a.out[k] = static_cast<T*>(out[k]);
    for (int k = 0; k < NP; ++k) a.par[k] = (T)par[k];
}

PLAN_FN float p_sin(float a) { return sinf(a); }
PLAN_FN double p_sin(double a) { return sin(a); }
PLAN_FN float p_cos(float a) { return cosf(a); }
PLAN_FN double p_cos(double a) { return cos(a); }
PLAN_FN float p_sqrt(float a) { return sqrtf(a); }
PLAN_FN double p_sqrt(double a) { return sqrt(a); }
PLAN_FN float p_pow(float a, float e) { return powf(a, e); }
PLAN_FN double p_pow(double a, double e) { return pow(a, e); }
PLAN_FN float p_fma(float a, float b, float c) { return fmaf(a, b, c); }
PLAN_FN double p_fma(double a, double b, double c) { return fma(a, b, c); }

// a0 b0 + a1 b1 as a row of the plain version's 3 x 3 rotation (third term
// 0 x 0) rounds in cuBLAS: the FMA chain in k order, or two products and a
// sum
template <typename T>
PLAN_FN T dot2(T a0, T b0, T a1, T b1, bool fused)
{
    return fused ? p_fma(a1, b1, a0 * b0) : a0 * b0 + a1 * b1;
}

// torch.clamp_min: NaN stays NaN
template <typename T>
PLAN_FN T clamp_min(T v, T lo) { return v < lo ? lo : v; }

// Python's floor modulo of a phase (plan/gait.py indexes phase % PERIOD)
PLAN_FN int wrap(int p)
{
    const int r = p % PERIOD;
    return r < 0 ? r + PERIOD : r;
}

PLAN_FN int stance_flag(const int* tables, int g, int ph, int f)
{
    return tables[(g * PERIOD + wrap(ph)) * FEET + f];
}

PLAN_FN int stance_steps(const int* tables, int g, int f)
{
    return tables[N_GAITS * PERIOD * FEET + g * FEET + f];
}

// ---- the footstep horizon: plan/footsteps.py::plan_footsteps_horizon for
// foot f of scenario b.  feet (B, N, 4, 3) and next_td (B, 4, 3).  The
// Raibert target (`raibert_touchdown`) is formed only at the steps where
// the foot goes from swing to stance: the only steps that read it.
template <typename T>
PLAN_FN void footsteps_foot(const FootArgs<T>& a, const int* tables, int N,
                            long long b, int f)
{
    const int g = *a.template row<int>(FI_GAIT, b);
    const int ph = *a.template row<int>(FI_PHASE, b);
    const T* x = a.template row<T>(FI_X, b);
    const T* vc = a.template row<T>(FI_VCMD, b);
    const T* cf = a.template row<T>(FI_FEET, b) + 3 * f;
    const T dt = a.par[FP_DT], h_ref = a.par[FP_H_REF];
    const T shx = a.par[FP_SH + 3 * f], shy = a.par[FP_SH + 3 * f + 1];
    const T t_stance = (T)stance_steps(tables, g, f) * dt;
    const T yaw0 = x[5], vx = x[6], vy = x[7], wz = vc[2];
    const T inv_g = (T)1 / a.par[FP_G];
    const bool fused_bmm = a.par[FP_FUSED_BMM] != (T)0;
    const bool fused_einsum = a.par[FP_FUSED_EINSUM] != (T)0;
    // current_feet * [1, 1, 0]
    T wx = cf[0] * (T)1, wy = cf[1] * (T)1, wzr = cf[2] * (T)0;
    T tdx = wx, tdy = wy, tdz = wzr;
    bool found = false;
    int prev = stance_flag(tables, g, ph, f);
    T* feet = a.out[FO_FEET];
    for (int k = 0; k < N; ++k) {
        const int ck = stance_flag(tables, g, ph + k, f);
        if (ck > 0 && prev == 0) {          // swing -> stance at step k
            const T yaw = yaw0 + wz * dt * (T)k;
            const T c = p_cos(yaw), s = p_sin(yaw);
            // v_ref_world = rot_z(yaw_k) [vcx, vcy, 0] (torch.bmm)
            const T vrx = dot2(c, vc[0], -s, vc[1], fused_bmm);
            const T vry = dot2(s, vc[0], c, vc[1], fused_bmm);
            const T pkx = x[0] + vx * dt * (T)k;
            const T pky = x[1] + vy * dt * (T)k;
            // shoulder = p_k + rot_z(yaw_k) sh_f (torch.einsum)
            T px = pkx + dot2(c, shx, -s, shy, fused_einsum);
            T py = pky + dot2(s, shx, c, shy, fused_einsum);
            const T ts = a.par[FP_TSF] * t_stance;
            px = px + ts * vx;
            py = py + ts * vy;
            px = px + a.par[FP_KR] * (vx - vrx);
            py = py + a.par[FP_KR] * (vy - vry);
            const T h = clamp_min(h_ref, (T)1e-3);
            const T cfg = (T)0.5 * p_sqrt(h * inv_g);
            px = px + cfg * (vy * wz);
            py = py + cfg * (-vx * wz);
            wx = px;
            wy = py;
            wzr = (T)0;
            if (!found) {
                tdx = px;
                tdy = py;
                tdz = (T)0;
                found = true;
            }
        }
        T* o = feet + ((b * N + k) * FEET + f) * 3;
        o[0] = wx;
        o[1] = wy;
        o[2] = wzr;
        prev = ck;
    }
    T* td = a.out[FO_TD] + (b * FEET + f) * 3;
    td[0] = tdx;
    td[1] = tdy;
    td[2] = tdz;
}

// ---- the reference rollout: mpc/srb.py::reference_rollout, step k of
// scenario b: the k + 1 steps of the recursion up to it (each thread of a
// scenario repeats its own prefix, so that a warp's threads write
// consecutive rows), the state after step k.  out (B, N, 12): [p_x, p_y,
// h_ref, 0, 0, yaw, v_world, 0, 0, wz].
template <typename T>
PLAN_FN void rollout_step(const RollArgs<T>& a, int N, long long b, int k)
{
    const T* x = a.template row<T>(RI_X, b);
    const T* vc = a.template row<T>(RI_VCMD, b);
    const T dt = a.par[RP_DT];
    const bool fused = a.par[RP_FUSED_BMM] != (T)0;
    T px = x[0], py = x[1], yaw = x[5], vwx = (T)0, vwy = (T)0;
    const T vbx = vc[0], vby = vc[1], wz = vc[2];
    for (int j = 0; j <= k; ++j) {
        const T c = p_cos(yaw), s = p_sin(yaw);
        // v_world = rot_z(yaw) [vbx, vby, 0] (torch.bmm)
        vwx = dot2(c, vbx, -s, vby, fused);
        vwy = dot2(s, vbx, c, vby, fused);
        px = px + vwx * dt;
        py = py + vwy * dt;
        yaw = yaw + wz * dt;
    }
    T* o = a.out[0] + (b * N + k) * 12;
    o[0] = px;
    o[1] = py;
    o[2] = a.par[RP_H_REF];
    o[3] = (T)0;
    o[4] = (T)0;
    o[5] = yaw;
    o[6] = vwx;
    o[7] = vwy;
    o[8] = (T)0;
    o[9] = (T)0;
    o[10] = (T)0;
    o[11] = wz;
}

// ---- the swing reference: plan/swing.py::swing_foot_ref for foot f of
// scenario b.  pos, vel, acc (B, 4, 3).
template <typename T>
PLAN_FN void swing_foot(const SwingArgs<T>& a, long long b, int f)
{
    const T* lo = a.template row<T>(SI_LIFT, b) + 3 * f;
    const T* td = a.template row<T>(SI_TD, b) + 3 * f;
    const T s = a.template row<T>(SI_S, b)[f];
    const T ds = (T)1 / clamp_min(a.template row<T>(SI_T, b)[f], (T)1e-6);
    const T H = a.par[SP_H64];
    const T s2 = s * s, s3 = s * s * s;
    const T s4 = p_pow(s, (T)4), s5 = p_pow(s, (T)5);
    const T blend = (T)10 * s3 - (T)15 * s4 + (T)6 * s5;
    const T dblend = ((T)30 * s2 - (T)60 * s3 + (T)30 * s4) * ds;
    const T ddblend = ((T)60 * s - (T)180 * s2 + (T)120 * s3) * ds * ds;
    const T one = (T)1 - s;
    const T one2 = one * one, one3 = one * one * one;
    const long long o = (b * FEET + f) * 3;
    for (int c = 0; c < 2; ++c) {
        const T d = td[c] - lo[c];
        a.out[SO_POS][o + c] = lo[c] + d * blend;
        a.out[SO_VEL][o + c] = d * dblend;
        a.out[SO_ACC][o + c] = d * ddblend;
    }
    a.out[SO_POS][o + 2] = H * s3 * one3;
    a.out[SO_VEL][o + 2] = H * ((T)3 * s2 * one3 - (T)3 * s3 * one2) * ds;
    a.out[SO_ACC][o + 2] = H * ((T)6 * s * one3 - (T)18 * s2 * one2
                                + (T)6 * s3 * one) * ds * ds;
}

}  // namespace planner
