// The planner's per-scenario arithmetic: the footstep horizon, the
// reference rollout and the swing reference (from given phases, and over a
// period's ticks from the gait tables), for the kernels of planner.cu and,
// the footstep horizon, for the period plan (dyn/csrc/period_head.h).
//
// Plain C++: every function is marked PLAN_FN, `__host__ __device__` under
// nvcc and plain `inline` under a host compiler, so the tests build this
// very arithmetic with g++ and run it on the CPU
// (tests/test_torch_plan_kernels.py, tests/test_torch_plan_period.py,
// tests/test_torch_period_plan.py).
// One call computes what one unit of a kernel computes: a (step, foot) of
// the footstep horizon (`footsteps_warp` glues a scenario's on a warp), a
// (scenario, foot) of the swing reference from given phases; a
// step's terms of the reference rollout and their ordered prefix (the
// kernel hands terms between lanes by shuffles, the tests' host glue by
// an array); a (scenario, foot) set-up and a (scenario, tick, foot)
// evaluation of the swing reference over a period.
// Templated on the value type (float, double).
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
#include <string.h>

#if defined(__CUDACC__)
#define PLAN_FN __host__ __device__ __forceinline__
#else
#define PLAN_FN inline
#endif

namespace planner {

constexpr int N_GAITS = 5;      // model/gaits.py's tables
constexpr int PERIOD = 16;      // GAIT_PERIOD: MPC steps per gait cycle
constexpr int FEET = 4;
// the gait tables as one int array: stance flags [gait][phase][foot], the
// stance steps per period [gait][foot], then the swing tables' steps since
// lift-off and swing durations [gait][phase][foot] (plan/gait.py: TABLES,
// _STANCE_STEPS_NP, _BACK_NP, _DUR_NP)
constexpr int FLAG_INTS = N_GAITS * PERIOD * FEET;
constexpr int STANCE_OFF = FLAG_INTS;
constexpr int BACK_OFF = STANCE_OFF + N_GAITS * FEET;
constexpr int DUR_OFF = BACK_OFF + FLAG_INTS;
constexpr int TABLE_INTS = DUR_OFF + FLAG_INTS;

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
// the swing reference over a period's ticks: gait id and phase (int32),
// the ticks' fractions of their MPC step (a row of T), lift-off and
// touchdown points; dt, 64 h_apex
enum SwingAtIn { SA_GAIT, SA_PHASE, SA_TFRAC, SA_LIFT, SA_TD, SA_COUNT };
enum SwingAtPar { SAP_DT, SAP_H64, SAP_COUNT };

// the gait tables' ints and each kernel's operand counts: inputs, outputs,
// parameters of the footsteps, the rollout, the swing reference and the
// swing reference over a period (plan/kernels.py::LAYOUT; -1 past the end)
inline int layout(int what)
{
    const int counts[] = {TABLE_INTS, FI_COUNT, FO_COUNT, FP_COUNT,
                          RI_COUNT, 1, RP_COUNT, SI_COUNT, SO_COUNT,
                          SP_COUNT, SA_COUNT, SO_COUNT, SAP_COUNT};
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
template <typename T>
using SwingAtArgs = Args<T, SA_COUNT, SO_COUNT, SAP_COUNT>;

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
    return tables[STANCE_OFF + g * FEET + f];
}

// steps since lift-off and swing duration in steps (0 in stance)
PLAN_FN int swing_back(const int* tables, int g, int ph, int f)
{
    return tables[BACK_OFF + (g * PERIOD + wrap(ph)) * FEET + f];
}

PLAN_FN int swing_dur(const int* tables, int g, int ph, int f)
{
    return tables[DUR_OFF + (g * PERIOD + wrap(ph)) * FEET + f];
}

// ---- the footstep horizon: plan/footsteps.py::plan_footsteps_horizon.
// feet (B, N, 4, 3) and next_td (B, 4, 3).  Row (k, f) of feet is the
// Raibert target (`raibert_touchdown`) at the last step j <= k where foot f
// goes from swing to stance, or the current foot * [1, 1, 0] where there is
// none; next_td is the target at the first such step (row 0 where there is
// none).  So no row depends on another: a unit per (step, foot)
// (`footstep_unit`) finds its step j (`footstep_source`, from the foot's
// transitions over a period, `foot_transitions`) and forms the target
// there (`raibert_at`, the first design's loop body at k = j, op by op and
// in its order: its bits), a lane without a transition before its step
// forming none.  `footsteps_warp` runs a scenario's 4 N units on a
// warp's 32 lanes, FOOT_CHUNK steps at a time staged in shared memory and
// copied out in 16-byte pieces.

constexpr int WARP = 32;
constexpr int FOOT_CHUNK = 16;  // steps a warp stages at a time (64 units)

// what a scenario's footstep units read: x_srb (12 values), the command
// (3), the current feet (4 x 3), the gait id and phase
template <typename T>
struct FootScene {
    const T* x;
    const T* vc;
    const T* cf;
    int g, ph;
};

// foot f's swing -> stance transitions over a period, as the first
// design's scan finds them: bit i set where the stance flag at phase
// ph + i is > 0 and the one at ph + i - 1 is 0 (the tables repeat every
// PERIOD phases).  Step k >= 1 of the horizon is a transition where bit
// k % PERIOD is set (`transition_at`); step 0 never is (the scan's `prev`
// starts at the flag at ph itself).  The period's 16 flags in one pass, no
// load waiting on another.
PLAN_FN unsigned foot_transitions(const int* tables, int g, int ph, int f)
{
    unsigned pos = 0u, zero = 0u;       // bit i: the flag at ph + i
    for (int i = 0; i < PERIOD; ++i) {
        const int c = stance_flag(tables, g, ph + i, f);
        pos |= (unsigned)(c > 0) << i;
        zero |= (unsigned)(c == 0) << i;
    }
    const unsigned prev_zero = (zero << 1) | (zero >> (PERIOD - 1));
    return pos & prev_zero & ((1u << PERIOD) - 1u);
}

PLAN_FN bool transition_at(unsigned trans, int i)
{
    return i > 0 && ((trans >> (i % PERIOD)) & 1u) != 0u;
}

// the last transition step j <= k, or -1
PLAN_FN int footstep_source(unsigned trans, int k)
{
    for (int i = k; i > 0; --i)
        if (transition_at(trans, i)) return i;
    return -1;
}

// the first transition step within the horizon of N steps, or -1
PLAN_FN int footstep_first(unsigned trans, int N)
{
    for (int i = 1; i < N; ++i)
        if (transition_at(trans, i)) return i;
    return -1;
}

// the Raibert target (x, y) of foot f at step j; `fp` the FootPar values
template <typename T>
PLAN_FN void raibert_at(const int* tables, const FootScene<T>& s, const T* fp,
                        int f, int j, T& tx, T& ty)
{
    const T* x = s.x;
    const T* vc = s.vc;
    const T dt = fp[FP_DT], h_ref = fp[FP_H_REF];
    const T shx = fp[FP_SH + 3 * f], shy = fp[FP_SH + 3 * f + 1];
    const T t_stance = (T)stance_steps(tables, s.g, f) * dt;
    const T yaw0 = x[5], vx = x[6], vy = x[7], wz = vc[2];
    const T inv_g = (T)1 / fp[FP_G];
    const bool fused_bmm = fp[FP_FUSED_BMM] != (T)0;
    const bool fused_einsum = fp[FP_FUSED_EINSUM] != (T)0;
    const T yaw = yaw0 + wz * dt * (T)j;
    const T c = p_cos(yaw), sn = p_sin(yaw);
    // v_ref_world = rot_z(yaw_j) [vcx, vcy, 0] (torch.bmm)
    const T vrx = dot2(c, vc[0], -sn, vc[1], fused_bmm);
    const T vry = dot2(sn, vc[0], c, vc[1], fused_bmm);
    const T pkx = x[0] + vx * dt * (T)j;
    const T pky = x[1] + vy * dt * (T)j;
    // shoulder = p_j + rot_z(yaw_j) sh_f (torch.einsum)
    T px = pkx + dot2(c, shx, -sn, shy, fused_einsum);
    T py = pky + dot2(sn, shx, c, shy, fused_einsum);
    const T ts = fp[FP_TSF] * t_stance;
    px = px + ts * vx;
    py = py + ts * vy;
    px = px + fp[FP_KR] * (vx - vrx);
    py = py + fp[FP_KR] * (vy - vry);
    const T h = clamp_min(h_ref, (T)1e-3);
    const T cfg = (T)0.5 * p_sqrt(h * inv_g);
    px = px + cfg * (vy * wz);
    py = py + cfg * (-vx * wz);
    tx = px;
    ty = py;
}

// row (k, f) of the feet into o[0..2]; `trans` foot f's transitions
template <typename T>
PLAN_FN void footstep_unit(const int* tables, const FootScene<T>& s,
                           const T* fp, unsigned trans, int k, int f, T* o)
{
    const int j = footstep_source(trans, k);
    if (j < 0) {                    // current_feet * [1, 1, 0]
        const T* cf = s.cf + 3 * f;
        o[0] = cf[0] * (T)1;
        o[1] = cf[1] * (T)1;
        o[2] = cf[2] * (T)0;
        return;
    }
    raibert_at(tables, s, fp, f, j, o[0], o[1]);
    o[2] = (T)0;
}

// piece i of 16 bytes from src to dst
PLAN_FN void copy16(void* dst, const void* src, long long i)
{
#if defined(__CUDA_ARCH__)
    static_cast<int4*>(dst)[i] = static_cast<const int4*>(src)[i];
#else
    memcpy(static_cast<char*>(dst) + 16 * i,
           static_cast<const char*>(src) + 16 * i, 16);
#endif
}

// the executors of `footsteps_warp` (dyn/csrc/rbd.h's have the same
// shape): a phase runs its body for each lane the executor gives this
// thread, its own on the card, all 32 on the host in order or reversed;
// sync() between two phases.  No unit reads what another lane writes in
// its own phase.
#if defined(__CUDACC__)
struct WarpExec {
    __device__ int first() const { return threadIdx.x & (WARP - 1); }
    __device__ int step() const { return WARP; }
    __device__ int lane(int i) const { return i; }
    __device__ void sync() const { __syncwarp(); }
};
#endif

#if !defined(__CUDA_ARCH__)
struct HostExec {
    bool reverse;
    int first() const { return 0; }
    int step() const { return 1; }
    int lane(int i) const { return reverse ? WARP - 1 - i : i; }
    void sync() const {}
};
#endif

// one scenario's horizon of N steps on a warp: per chunk of FOOT_CHUNK
// steps (1) the units (k, f) in `stage` (FOOT_CHUNK x 12 values, 16-byte
// aligned) at row k's 12 values, unit u = 4 k + f on lane u % 32 (so a
// lane's feet are all lane % 4, whose transitions it finds once a phase);
// (2) the chunk copied to `feet` (the scenario's N x 12 values, 16-byte
// aligned) in 16-byte pieces, and lane 4 i + f (i < 3) takes entry i of
// foot f's next touchdown into td[3 f + i] where its row (the first
// transition's, else row 0) is in the chunk.  Ends with a sync.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <typename T, class Exec>
PLAN_FN void footsteps_warp(const Exec& ex, const int* tables, int N,
                            const FootScene<T>& s, const T* fp, T* stage,
                            T* feet, T* td)
{
    for (int c0 = 0; c0 < N; c0 += FOOT_CHUNK) {
        const int steps = N - c0 < FOOT_CHUNK ? N - c0 : FOOT_CHUNK;
        for (int i = ex.first(); i < WARP; i += ex.step()) {
            const int lane = ex.lane(i), f = lane % FEET;
            const unsigned trans = foot_transitions(tables, s.g, s.ph, f);
            for (int u = lane; u < FEET * steps; u += WARP)
                footstep_unit(tables, s, fp, trans, c0 + u / FEET, f,
                              stage + 3 * u);
        }
        ex.sync();
        for (int i = ex.first(); i < WARP; i += ex.step()) {
            const int lane = ex.lane(i), f = lane % FEET;
            const long long pieces = 12LL * steps * (long long)sizeof(T) / 16;
            for (long long p = lane; p < pieces; p += WARP)
                copy16(feet + 12LL * c0, stage, p);
            if (lane < 3 * FEET) {
                const int j = footstep_first(
                    foot_transitions(tables, s.g, s.ph, f), N);
                const int row = j < 0 ? 0 : j, e = 3 * f + lane / FEET;
                if (row >= c0 && row < c0 + steps)
                    td[e] = stage[12 * (row - c0) + e];
            }
        }
        ex.sync();
    }
}

// ---- the reference rollout: mpc/srb.py::reference_rollout.  out (B, N,
// 12), row k the state after step k: [p_x, p_y, h_ref, 0, 0, yaw_{k+1},
// v_world_k, 0, 0, wz], where
//     yaw_{k+1} = yaw_k + wz dt,  v_world_k = rot_z(yaw_k) [vbx, vby, 0],
//     p_{k+1} = p_k + v_world_k dt.
// Two pieces: step k's terms from its own yaw (`rollout_term`: k adds of
// wz dt, one sin and cos), then p_{k+1} = ((p_0 + t_0) + t_1) ... + t_k,
// the ordered prefix of the terms t_j = v_world_j dt (`ordered_prefix`):
// the recursion's own operations in its order, so its bits.  The steps go
// in chunks of G lanes (`rollout_lanes`); a chunk starts from the yaw and
// the positions that the last lane of the chunk before reached.

// lanes a scenario's steps take at a time: N's next power of two, at most
// a warp
PLAN_FN int rollout_lanes(int N)
{
    int g = 1;
    while (g < N && g < 32) g *= 2;
    return g;
}

template <typename T>
struct RollTerm {
    T yaw_next;     // yaw_{k+1}
    T vwx, vwy;     // v_world_k
    T tx, ty;       // v_world_k dt
};

// step k = (chunk's first step) + l: yaw_k by l adds from the chunk's first
// yaw, its rotation (torch.bmm's form) and terms
template <typename T>
PLAN_FN RollTerm<T> rollout_term(T yaw_first, int l, T wz, T dt, T vbx,
                                 T vby, bool fused)
{
    T yaw = yaw_first;
    for (int i = 0; i < l; ++i) yaw = yaw + wz * dt;
    const T c = p_cos(yaw), s = p_sin(yaw);
    RollTerm<T> r;
    r.vwx = dot2(c, vbx, -s, vby, fused);
    r.vwy = dot2(s, vbx, c, vby, fused);
    r.tx = r.vwx * dt;
    r.ty = r.vwy * dt;
    r.yaw_next = yaw + wz * dt;
    return r;
}

// (px, py) + t_0 + ... + t_l in that order, t_j = get(j) for every j < G
// (the card's shuffles need every lane to ask for every j)
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <typename T, typename Get>
PLAN_FN void ordered_prefix(T& px, T& py, int G, int l, Get get)
{
    for (int j = 0; j < G; ++j) {
        T tx, ty;
        get(j, tx, ty);
        if (j <= l) {
            px = px + tx;
            py = py + ty;
        }
    }
}

// row k of the output
template <typename T>
PLAN_FN void rollout_row(T* o, T px, T py, T h_ref, const RollTerm<T>& t,
                         T wz)
{
    o[0] = px;
    o[1] = py;
    o[2] = h_ref;
    o[3] = (T)0;
    o[4] = (T)0;
    o[5] = t.yaw_next;
    o[6] = t.vwx;
    o[7] = t.vwy;
    o[8] = (T)0;
    o[9] = (T)0;
    o[10] = (T)0;
    o[11] = wz;
}

// ---- the swing reference of one foot (plan/swing.py::
// swing_foot_ref_reference): the quintic xy and sextic z from lift-off
// `lo` to touchdown at phase s of a swing whose seconds' reciprocal is ds
// (1 / max(T, 1e-6)), apex H / 64; d = touchdown - lift-off (x, y); pos,
// vel, acc at element o (and o + 1, o + 2) of the outputs.
template <typename T>
PLAN_FN void swing_poly(T s, T ds, T lo0, T lo1, T d0, T d1, T H,
                        T* const* out, long long o)
{
    const T s2 = s * s, s3 = s * s * s;
    const T s4 = p_pow(s, (T)4), s5 = p_pow(s, (T)5);
    const T blend = (T)10 * s3 - (T)15 * s4 + (T)6 * s5;
    const T dblend = ((T)30 * s2 - (T)60 * s3 + (T)30 * s4) * ds;
    const T ddblend = ((T)60 * s - (T)180 * s2 + (T)120 * s3) * ds * ds;
    const T one = (T)1 - s;
    const T one2 = one * one, one3 = one * one * one;
    out[SO_POS][o] = lo0 + d0 * blend;
    out[SO_VEL][o] = d0 * dblend;
    out[SO_ACC][o] = d0 * ddblend;
    out[SO_POS][o + 1] = lo1 + d1 * blend;
    out[SO_VEL][o + 1] = d1 * dblend;
    out[SO_ACC][o + 1] = d1 * ddblend;
    out[SO_POS][o + 2] = H * s3 * one3;
    out[SO_VEL][o + 2] = H * ((T)3 * s2 * one3 - (T)3 * s3 * one2) * ds;
    out[SO_ACC][o + 2] = H * ((T)6 * s * one3 - (T)18 * s2 * one2
                              + (T)6 * s3 * one) * ds * ds;
}

template <typename T>
PLAN_FN T swing_rate(T Tsw) { return (T)1 / clamp_min(Tsw, (T)1e-6); }

// ---- plan/swing.py::swing_foot_ref, outputs pos, vel, acc (B, 4, 3).  A
// block of the kernel takes SWING_FOOT_ROWS scenarios (rows of 12 values)
// in two phases:
//   1. a unit per (scenario, foot) (`swing_foot_unit`): the foot's phase,
//      swing rate, lift-off and step, then `swing_poly` into a staging
//      area of the block's rows (three arrays of rows x 12 values);
//   2. the staging copied out, the block's rows being contiguous.
// Every value is the first design's (a thread per (scenario, foot)
// storing its values where they lie), op by op.
constexpr int SWING_FOOT_ROWS = 64;

// phase 1, unit u < 4 rows of the block whose first scenario is b0: foot
// u % 4 of scenario b0 + u / 4, into `out` (pos, vel, acc of the block's
// rows) at 3 u
template <typename T>
PLAN_FN void swing_foot_unit(const SwingArgs<T>& a, long long b0, int u,
                             T* const* out)
{
    const long long b = b0 + u / FEET;
    const int f = u % FEET;
    const T* lo = a.template row<T>(SI_LIFT, b) + 3 * f;
    const T* td = a.template row<T>(SI_TD, b) + 3 * f;
    swing_poly(a.template row<T>(SI_S, b)[f],
               swing_rate(a.template row<T>(SI_T, b)[f]), lo[0], lo[1],
               td[0] - lo[0], td[1] - lo[1], a.par[SP_H64], out, 3LL * u);
}

// ---- plan/swing.py::swing_references_period: the swing reference at
// each of a period's T ticks (swing_reference_at at every fraction of the
// row), outputs (B, T, 4, 3).  Row r = b T + t of the (B T, 4, 3)
// outputs; a block of the kernel takes `swing_block_rows(T)` rows (whole
// scenarios where T <= SWING_ROWS) in three phases:
//   1. a unit per (scenario, foot) the block touches (`swing_setup`): the
//      foot's steps since lift-off and swing duration from the gait tables,
//      the swing's seconds' reciprocal, lift-off and the step, read once;
//   2. a unit per (row, foot) (`swing_tick`): the tick's fraction
//      (`swing_frac`), the phase s = (back + t_frac) / max(dur, 1) (0 in
//      stance), then `swing_poly` into a staging area of the block's rows
//      (three arrays of rows x 12 values);
//   3. the staging copied out, the block's rows being contiguous.
// Every value is the plain chain's at its tick, op by op: slice [:, t]
// is the reference at fraction t alone (the kernel at T = 1).
constexpr int SWING_ROWS = 64;

PLAN_FN int swing_block_rows(int T)
{
    return T <= SWING_ROWS ? T * (SWING_ROWS / T) : SWING_ROWS;
}

// the most scenarios the rows of one block touch
PLAN_FN int swing_block_scenarios(int T)
{
    return (swing_block_rows(T) - 1) / T + 2;
}

template <typename T>
struct SwingFoot {
    T back, dur, ds;    // steps since lift-off and duration; 1 / seconds
    T lo0, lo1, d0, d1; // lift-off and touchdown - lift-off (x, y)
};

// block `blk`'s rows [r0, r0 + rows) of the B T rows and their scenarios
// [b_lo, b_lo + nb)
struct SwingBlock {
    long long r0, b_lo;
    int rows, nb;
};

PLAN_FN SwingBlock swing_block(long long B, int T, long long blk)
{
    const int R = swing_block_rows(T);
    SwingBlock k;
    k.r0 = blk * R;
    const long long left = B * T - k.r0;
    k.rows = left < R ? (int)left : R;
    k.b_lo = k.r0 / T;
    k.nb = (int)((k.r0 + k.rows - 1) / T - k.b_lo + 1);
    return k;
}

// phase 1, unit u < 4 nb: foot u % 4 of the block's scenario u / 4
template <typename T>
PLAN_FN SwingFoot<T> swing_setup(const SwingAtArgs<T>& a, const int* tables,
                                 const SwingBlock& k, int u)
{
    const long long b = k.b_lo + u / FEET;
    const int f = u % FEET;
    const int g = *a.template row<int>(SA_GAIT, b);
    const int ph = *a.template row<int>(SA_PHASE, b);
    const T* lo = a.template row<T>(SA_LIFT, b) + 3 * f;
    const T* td = a.template row<T>(SA_TD, b) + 3 * f;
    SwingFoot<T> p;
    p.back = (T)swing_back(tables, g, ph, f);
    p.dur = (T)swing_dur(tables, g, ph, f);
    p.ds = swing_rate(p.dur * a.par[SAP_DT]);
    p.lo0 = lo[0];
    p.lo1 = lo[1];
    p.d0 = td[0] - lo[0];
    p.d1 = td[1] - lo[1];
    return p;
}

// phase 2, unit u < 4 rows: foot u % 4 of the block's row u / 4 ...
// whose set-up is the block's phase-1 unit `swing_setup_unit`
PLAN_FN int swing_setup_unit(int Tn, const SwingBlock& k, int u)
{
    return (int)((k.r0 + u / FEET) / Tn - k.b_lo) * FEET + u % FEET;
}

// ... at the fraction `swing_frac` of its tick ...
template <typename T>
PLAN_FN T swing_frac(const SwingAtArgs<T>& a, int Tn, const SwingBlock& k,
                     int u)
{
    const long long r = k.r0 + u / FEET;
    const long long b = r / Tn;
    return a.template row<T>(SA_TFRAC, b)[r - b * Tn];
}

// ... into `out` (pos, vel, acc of the block's rows) at 3 u
template <typename T>
PLAN_FN void swing_tick(const SwingAtArgs<T>& a, const SwingFoot<T>& p, T tf,
                        int u, T* const* out)
{
    const T s = p.dur > (T)0 ? (p.back + tf) / clamp_min(p.dur, (T)1)
                             : (T)0;
    swing_poly(s, p.ds, p.lo0, p.lo1, p.d0, p.d1, a.par[SAP_H64], out,
               3LL * u);
}

}  // namespace planner
