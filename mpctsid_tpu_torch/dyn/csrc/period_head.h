// The per-scenario body of the period-head and period-plan kernels
// (period_head.cu): what a controller computes of the measured state once
// per MPC period, before the footstep plan (cascade/engine.py::period_head)
// and, in the period plan, the footstep plan and the touchdown select too
// (cascade/engine.py::period_plan):
//
//   feet_now  = foot_positions(q)                       (4 x 3, world)
//   x_srb     = srb_state(q, v) = [p, rpy, R0 v_lin, R0 w]   (12)
//   liftoff'  = to_swing > 0.5 ? feet_now : liftoff      (4 x 3)
//   v_meas    = [cy vx_w + sy vy_w, -sy vx_w + cy vy_w, wz_w], yaw = rpy[2]
//   v_int'    = clamp(v_int + gain (v_cmd - v_meas), -v_max, v_max)
//   v_used    = v_cmd + v_int'
//
//   fsteps, next_td = plan_footsteps_horizon(x_srb, v_used, feet_now)
//   touchdown' = stance flag at phase < 0.5 ? next_td : touchdown
//
// with gain = ki_vint * t_period.  The leg kinematics are rbd.h's
// `kin_unit` (the WBC build's and the plant step's), not a copy: lanes 0-3
// run one leg each.  Then lanes 0-11 take the feet and the lift-off select,
// lanes 12-23 the SRB state (a lane an entry), lanes 0-2 the integrator.
// The plan (a template flag: off, the period head; on, the period plan)
// then runs the footstep horizon's (step, foot) units on the slot's x_srb,
// v_used and feet (plan/csrc/planner.h's `footsteps_warp`, included, not
// copied: two units a lane at N = 16, the rows staged in the slot and
// written with 16-byte stores), and lanes 0-11 take the touchdown select.
// The phases run through rbd.h's executors: on the card a warp per
// scenario (`WarpExec`, `__syncwarp()` between phases), on the host the 32
// lanes one after another in either order (`HostExec`), so the CPU tests
// build this arithmetic with g++ (tests/test_torch_period_head_kernel.py,
// tests/test_torch_period_plan.py).
// No unit reads what another lane writes in its own phase.
//
// Bits.  The plain version (engine.py::period_head_reference) takes the
// rotations through `torch.bmm` / broadcast matmuls and atan2 / asin from
// PyTorch's math library; here they are rbd.h's products and the CUDA math
// library's: held to it within a tolerance.  The library is built with
// -fmad=false, so the integrator's products and sums round as the plain
// version's elementwise ops do, and the footstep units as the planner's
// kernel (planner.cu, -fmad=false): the plan's outputs are the bits of
// plan_footsteps_horizon launched on the head's outputs.

#pragma once

#include "rbd.h"
#include "../../plan/csrc/planner.h"

namespace rbd {
namespace head {

// operands, in the order of the launcher's arrays: each input a first row
// and a stride between scenarios (rbd::Args), each output contiguous (B, ...)
enum In { HI_Q, HI_V, HI_TO_SWING, HI_LIFTOFF, HI_V_INT, HI_V_CMD, HI_COUNT };
enum Out { HO_FEET, HO_X_SRB, HO_LIFTOFF, HO_V_INT, HO_V_USED, HO_COUNT };
// gain = ki_vint * t_period; the integrator's bound v_int_max
enum Par { HP_GAIN, HP_V_INT_MAX, HP_COUNT };
// the period plan's operands after the head's: inputs the touchdown points
// (4 x 3), the gait id and phase (int32 rows), the gait tables (planner.h's
// ints, stride 0); outputs the footsteps (N x 4 x 3, 16-byte aligned), the
// next touchdown and the touchdown points (4 x 3 each); parameters the
// horizon N, then planner.h's FootPar values
enum PlanIn { PLI_TOUCHDOWN, PLI_GAIT, PLI_PHASE, PLI_TABLES, PLI_COUNT };
enum PlanOut { PLO_FSTEPS, PLO_NEXT_TD, PLO_TOUCHDOWN, PLO_COUNT };
enum PlanPar { PLP_N, PLP_FOOT, PLP_COUNT = PLP_FOOT + planner::FP_COUNT };

// what dyn/kernels.py checks (HEAD_LAYOUT): after rbd.h's own counts,
// the head's inputs, outputs and parameters, then the plan's
inline int layout(int what)
{
    if (what < L_PLANT_PAR + 1) return ::rbd::layout(what);
    switch (what - (L_PLANT_PAR + 1)) {
    case 0: return HI_COUNT;
    case 1: return HO_COUNT;
    case 2: return HP_COUNT;
    case 3: return PLI_COUNT;
    case 4: return PLO_COUNT;
    case 5: return PLP_COUNT;
    default: return -1;
    }
}

template <typename T> using HeadArgs = Args<T, HI_COUNT, HO_COUNT, HP_COUNT>;

// the plan's operands (the launcher fills them from the arrays' tails)
template <typename T>
struct PlanArgs {
    const T* touchdown;
    const int* gait;
    const int* phase;
    const int* tables;
    long long td_stride, gait_stride, phase_stride;
    T* out[PLO_COUNT];
    int N;
    T fp[planner::FP_COUNT];
};

// a warp's slot of shared memory
template <typename T>
struct HeadSlot {
    T stage[planner::FOOT_CHUNK * 12];  // the plan's rows (16-byte aligned:
                                        // the slot's start)
    Kin<T> k;
    T x[12];      // x_srb
    T vu[3];      // v_used
    T feet[12];   // feet_now
    T td[12];     // the next touchdown
};

// NaN-propagating clamp, as torch.clamp
template <typename T>
RBD_FN T clamp_nan(T v, T lo, T hi)
{
    return v != v ? v : (v < lo ? lo : (v > hi ? hi : v));
}

// entry e of x_srb (lanes 12-23, e = lane - 12)
template <typename T>
RBD_FN T srb_entry(int e, const T* q, const T* v, const T* R)
{
    if (e < 3) return q[e];
    if (e < 6) {
        T rpy[3];
        rot_to_rpy(R, rpy);
        return rpy[e - 3];
    }
    const T* w = e < 9 ? v : v + 3;
    const int i = (e - 6) % 3;
    return R[3 * i] * w[0] + R[3 * i + 1] * w[1] + R[3 * i + 2] * w[2];
}

// the whole body of one scenario b; the plan's phases where PLAN
template <bool PLAN, typename T, class Exec>
RBD_FN void period_warp(const Exec& ex, const T* C, const HeadArgs<T>& a,
                        const PlanArgs<T>& p, long long b, HeadSlot<T>& S)
{
    const T* q = a.row(HI_Q, b);
    const T* v = a.row(HI_V, b);
    RBD_EACH_LANE(ex, lane) kin_unit(lane, C, q, S.k);
    ex.sync();
    RBD_EACH_LANE(ex, lane) {
        if (lane < 12) {
            const int leg = lane / 3, i = lane % 3;
            const T f = S.k.p[leg][3][i];
            const T sw = a.row(HI_TO_SWING, b)[leg];
            if (PLAN) S.feet[lane] = f;
            a.out[HO_FEET][b * 12 + lane] = f;
            a.out[HO_LIFTOFF][b * 12 + lane] =
                sw > T(0.5) ? f : a.row(HI_LIFTOFF, b)[lane];
        } else if (lane < 24) {
            const T x = srb_entry(lane - 12, q, v, S.k.R0);
            S.x[lane - 12] = x;
            a.out[HO_X_SRB][b * 12 + lane - 12] = x;
        }
    }
    ex.sync();
    RBD_EACH_LANE(ex, lane) {
        if (lane < 3) {
            T sy, cy;
            r_sincos(S.x[5], &sy, &cy);
            const T vm = lane == 0 ? cy * S.x[6] + sy * S.x[7]
                         : (lane == 1 ? -sy * S.x[6] + cy * S.x[7]
                                      : S.x[11]);
            const T vc = a.row(HI_V_CMD, b)[lane];
            const T vmax = a.par[HP_V_INT_MAX];
            const T vi = clamp_nan(
                a.row(HI_V_INT, b)[lane] + a.par[HP_GAIN] * (vc - vm),
                -vmax, vmax);
            a.out[HO_V_INT][b * 3 + lane] = vi;
            a.out[HO_V_USED][b * 3 + lane] = vc + vi;
            if (PLAN) S.vu[lane] = vc + vi;
        }
    }
    if (!PLAN) return;
    ex.sync();
    const int g = p.gait[b * p.gait_stride];
    const int ph = p.phase[b * p.phase_stride];
    const planner::FootScene<T> scene{S.x, S.vu, S.feet, g, ph};
    planner::footsteps_warp(ex, p.tables, p.N, scene, p.fp, S.stage,
                            p.out[PLO_FSTEPS] + b * p.N * 12, S.td);
    RBD_EACH_LANE(ex, lane) {
        if (lane < 12) {
            const T td = S.td[lane];
            // contacts_at(gait, phase) < 0.5: the foot swings
            const T stance =
                (T)planner::stance_flag(p.tables, g, ph, lane / 3);
            p.out[PLO_NEXT_TD][b * 12 + lane] = td;
            p.out[PLO_TOUCHDOWN][b * 12 + lane] =
                stance < T(0.5) ? td : p.touchdown[b * p.td_stride + lane];
        }
    }
}

// the period head alone (the plan off)
template <typename T, class Exec>
RBD_FN void period_head_warp(const Exec& ex, const T* C,
                             const HeadArgs<T>& a, long long b,
                             HeadSlot<T>& S)
{
    period_warp<false>(ex, C, a, PlanArgs<T>{}, b, S);
}

}  // namespace head
}  // namespace rbd
