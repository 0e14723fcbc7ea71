// The per-scenario body of the period-head kernel (period_head.cu): what
// a controller computes of the measured state once per MPC period, before
// the footstep plan (cascade/engine.py::period_head):
//
//   feet_now  = foot_positions(q)                       (4 x 3, world)
//   x_srb     = srb_state(q, v) = [p, rpy, R0 v_lin, R0 w]   (12)
//   liftoff'  = to_swing > 0.5 ? feet_now : liftoff      (4 x 3)
//   v_meas    = [cy vx_w + sy vy_w, -sy vx_w + cy vy_w, wz_w], yaw = rpy[2]
//   v_int'    = clamp(v_int + gain (v_cmd - v_meas), -v_max, v_max)
//   v_used    = v_cmd + v_int'
//
// with gain = ki_vint * t_period.  The leg kinematics are rbd.h's
// `kin_unit` (the WBC build's and the plant step's), not a copy: lanes 0-3
// run one leg each.  Then lanes 0-11 take the feet and the lift-off select,
// lanes 12-23 the SRB state (a lane an entry), lanes 0-2 the integrator.
// The phases run through rbd.h's executors: on the card a warp per
// scenario (`WarpExec`, `__syncwarp()` between phases), on the host the 32
// lanes one after another in either order (`HostExec`), so the CPU tests
// build this arithmetic with g++ (tests/test_torch_period_head_kernel.py).
// No unit reads what another lane writes in its own phase.
//
// Bits.  The plain version (engine.py::period_head_reference) takes the
// rotations through `torch.bmm` / broadcast matmuls and atan2 / asin from
// PyTorch's math library; here they are rbd.h's products and the CUDA math
// library's: held to it within a tolerance.  The library is built with
// -fmad=false, so the integrator's products and sums round as the plain
// version's elementwise ops do.

#pragma once

#include "rbd.h"

namespace rbd {
namespace head {

// operands, in the order of the launcher's arrays: each input a first row
// and a stride between scenarios (rbd::Args), each output contiguous (B, ...)
enum In { HI_Q, HI_V, HI_TO_SWING, HI_LIFTOFF, HI_V_INT, HI_V_CMD, HI_COUNT };
enum Out { HO_FEET, HO_X_SRB, HO_LIFTOFF, HO_V_INT, HO_V_USED, HO_COUNT };
// gain = ki_vint * t_period; the integrator's bound v_int_max
enum Par { HP_GAIN, HP_V_INT_MAX, HP_COUNT };

// what dyn/kernels.py checks (HEAD_LAYOUT): after rbd.h's own counts,
// the head's inputs, outputs and parameters
inline int layout(int what)
{
    if (what < L_PLANT_PAR + 1) return ::rbd::layout(what);
    switch (what - (L_PLANT_PAR + 1)) {
    case 0: return HI_COUNT;
    case 1: return HO_COUNT;
    case 2: return HP_COUNT;
    default: return -1;
    }
}

template <typename T> using HeadArgs = Args<T, HI_COUNT, HO_COUNT, HP_COUNT>;

// a warp's slot of shared memory
template <typename T>
struct HeadSlot {
    Kin<T> k;
    T x[12];    // x_srb
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

// the whole body of one scenario b
template <typename T, class Exec>
RBD_FN void period_head_warp(const Exec& ex, const T* C,
                             const HeadArgs<T>& a, long long b,
                             HeadSlot<T>& S)
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
        }
    }
}

}  // namespace head
}  // namespace rbd
