"""Swing-foot trajectories (counterpart of the JAX package's plan/swing.py).

Quintic xy from lift-off to touchdown, sextic z = 64 h s^3 (1-s)^3 with apex
h, zero velocity/acceleration at both ends.  Evaluates all four feet of every
scenario at once; stance feet get zeros via the mask the caller applies.

`swing_foot_ref` is, on CUDA tensors, one launch of the hand-written kernel
`plan_swing` (plan/csrc/planner.cu: a block 64 scenarios, a unit per
scenario and foot, the rows staged and stored 16 bytes a thread;
plan/kernels.py); on CPU tensors it runs its plain version,
`swing_foot_ref_reference` (about 56 kernels a call on the card).

`swing_references_period` is the reference at each of a period's ticks
with its whole per-tick chain (the gait's swing tables, the swing's
seconds and phase), what the cascade takes once a period (the JAX
engine's `swing_tables` once a period and `swing_foot_ref` at each tick,
mpctsid_tpu/cascade/engine.py:236-255): on CUDA tensors one launch of the
kernel `plan_swing_at`, on CPU tensors its plain version,
`swing_references_period_reference`.  `swing_reference_at`, the reference
at one tick (what the host path's WBC graph takes every tick), is the
same kernel at one tick.
"""

from __future__ import annotations

import numbers

import torch

from mpctsid_tpu_torch.plan import kernels
from mpctsid_tpu_torch.plan.gait import swing_tables


def swing_foot_ref(p_liftoff, p_touchdown, s, T, h_apex):
    """(pos, vel, acc), each (B, 4, 3).

    p_liftoff/p_touchdown (B, 4, 3); s (B, 4) normalized phases; T (B, 4)
    swing durations in seconds; h_apex the apex height (a number).

    CUDA tensors: one launch of the kernel `plan_swing` (float32 or
    float64), or an exception.  CPU tensors: the plain version,
    `swing_foot_ref_reference`."""
    kernels.require_dtype("p_liftoff", p_liftoff)
    if p_liftoff.device.type == "cpu":
        return swing_foot_ref_reference(p_liftoff, p_touchdown, s, T, h_apex)
    out = kernels.launch("swing", run_swing, p_liftoff.device, p_liftoff,
                         p_touchdown, s, T, h_apex)
    swing_foot_ref.launches += 1
    return out


swing_foot_ref.launches = 0


def run_swing(launch_fn, p_liftoff, p_touchdown, s, T, h_apex):
    """(rc, (pos, vel, acc)): the swing kernel's operands packed for
    `launch_fn` (plan/kernels.py's signature less the stream), its outputs
    allocated here."""
    if not isinstance(h_apex, numbers.Real):
        raise TypeError(f"h_apex must be a number, got {type(h_apex)}")
    like = p_liftoff
    B = like.shape[0]
    ins = [kernels.rows("p_liftoff", p_liftoff, B, (4, 3), like),
           kernels.rows("p_touchdown", p_touchdown, B, (4, 3), like),
           kernels.rows("s", s, B, (4,), like),
           kernels.rows("T", T, B, (4,), like)]
    outs = [like.new_empty((B, 4, 3)) for _ in range(3)]
    # the plain version's 64.0 * h_apex, a Python (double) product
    rc = kernels.call(launch_fn, like.dtype, B, 1, None, ins, outs,
                      [64.0 * float(h_apex)])
    return rc, tuple(outs)


def swing_foot_ref_reference(p_liftoff, p_touchdown, s, T, h_apex):
    """Plain version of `swing_foot_ref` (any device and dtype)."""
    s = s[..., None]
    ds = 1.0 / torch.clamp_min(T, 1e-6)[..., None]
    d = p_touchdown[..., 0:2] - p_liftoff[..., 0:2]
    # quintic 10 s^3 - 15 s^4 + 6 s^5
    s2, s3, s4, s5 = s * s, s ** 3, s ** 4, s ** 5
    blend = 10.0 * s3 - 15.0 * s4 + 6.0 * s5
    dblend = (30.0 * s2 - 60.0 * s3 + 30.0 * s4) * ds
    ddblend = (60.0 * s - 180.0 * s2 + 120.0 * s3) * ds * ds
    xy = p_liftoff[..., 0:2] + d * blend
    vxy = d * dblend
    axy = d * ddblend
    # sextic z = 64 h s^3 (1-s)^3
    one = 1.0 - s
    z = 64.0 * h_apex * s3 * one ** 3
    vz = 64.0 * h_apex * (3.0 * s2 * one ** 3 - 3.0 * s3 * one ** 2) * ds
    az = 64.0 * h_apex * (6.0 * s * one ** 3 - 18.0 * s2 * one ** 2
                          + 6.0 * s3 * one) * ds * ds
    pos = torch.cat([xy, z], dim=-1)
    vel = torch.cat([vxy, vz], dim=-1)
    acc = torch.cat([axy, az], dim=-1)
    return pos, vel, acc


def swing_references_period(gait_id, phase, fracs, liftoff, touchdown, dt,
                            h_apex):
    """(pos, vel, acc), each (B, T, 4, 3): the swing reference at each of
    T ticks; slice [:, t] is `swing_reference_at` at fraction fracs[t],
    bit for bit.

    gait_id, phase (B,) or (1,) integers; fracs (T,) the ticks' fractions
    of their MPC step, one row shared by every scenario (or (1, T), or
    (B, T) a row each), in liftoff's dtype; liftoff/touchdown (B, 4, 3);
    dt the MPC step in seconds and h_apex the apex height (numbers).

    CUDA tensors: one launch of the kernel `plan_swing_at` (float32 or
    float64), or an exception.  CPU tensors: the plain version,
    `swing_references_period_reference`."""
    kernels.require_dtype("liftoff", liftoff)
    if liftoff.device.type == "cpu":
        return swing_references_period_reference(
            gait_id, phase, fracs, liftoff, touchdown, dt, h_apex)
    out = kernels.launch("swing_at", run_swing_period, liftoff.device,
                         gait_id, phase, fracs, liftoff, touchdown, dt,
                         h_apex)
    swing_references_period.launches += 1
    return out


swing_references_period.launches = 0


def run_swing_period(launch_fn, gait_id, phase, fracs, liftoff, touchdown,
                     dt, h_apex):
    """(rc, (pos, vel, acc)): the kernel's operands packed for `launch_fn`
    (plan/kernels.py's signature less the stream, N the ticks T), its
    outputs allocated here.  Gait ids must lie in [0, 5): the kernel reads
    its tables without a check."""
    for what, v in (("dt", dt), ("h_apex", h_apex)):
        if not isinstance(v, numbers.Real):
            raise TypeError(f"{what} must be a number, got {type(v)}")
    if not isinstance(fracs, torch.Tensor) or fracs.dim() not in (1, 2) or \
            fracs.shape[-1] < 1:
        raise ValueError("fracs must be a (T,), (1, T) or (B, T) tensor, "
                         f"got {getattr(fracs, 'shape', type(fracs))}")
    rows = fracs[None] if fracs.dim() == 1 else fracs
    like = liftoff
    B, T = like.shape[0], rows.shape[1]
    ins = [kernels.int_rows("gait_id", gait_id, B, like),
           kernels.int_rows("phase", phase, B, like),
           kernels.rows("fracs", rows, B, (T,), like),
           kernels.rows("liftoff", liftoff, B, (4, 3), like),
           kernels.rows("touchdown", touchdown, B, (4, 3), like)]
    outs = [like.new_empty((B, T, 4, 3)) for _ in range(3)]
    rc = kernels.call(launch_fn, like.dtype, B, T,
                      kernels.gait_tables(like.device), ins, outs,
                      [dt, 64.0 * float(h_apex)])
    return rc, tuple(outs)


def swing_references_period_reference(gait_id, phase, fracs, liftoff,
                                      touchdown, dt, h_apex):
    """Plain version of `swing_references_period` (any device and dtype):
    `swing_reference_at_reference` at each fraction, stacked."""
    rows = fracs[None] if fracs.dim() == 1 else fracs
    ticks = [swing_reference_at_reference(gait_id, phase, rows[:, t],
                                          liftoff, touchdown, dt, h_apex)
             for t in range(rows.shape[1])]
    return tuple(torch.stack([tick[k] for tick in ticks], dim=1)
                 for k in range(3))


def swing_reference_at(gait_id, phase, t_frac, liftoff, touchdown, dt,
                       h_apex):
    """(pos, vel, acc), each (B, 4, 3): the swing reference at a control
    tick.

    gait_id, phase (B,) or (1,) integers; t_frac (B,) or (1,) (a row shared
    by every scenario) the tick's fraction of its MPC step, in liftoff's
    dtype; liftoff/touchdown (B, 4, 3); dt the MPC step in seconds and
    h_apex the apex height (numbers).  A foot's swing lasts T = dur dt
    seconds and is at phase s = (back + t_frac) / max(dur, 1) (0 in
    stance), back and dur its steps since lift-off and swing duration from
    the gait's tables.

    CUDA tensors: one launch of the kernel `plan_swing_at` (the period
    kernel at one tick; float32 or float64), or an exception.  CPU
    tensors: the plain version, `swing_reference_at_reference`."""
    kernels.require_dtype("liftoff", liftoff)
    if liftoff.device.type == "cpu":
        return swing_reference_at_reference(gait_id, phase, t_frac, liftoff,
                                            touchdown, dt, h_apex)
    out = kernels.launch("swing_at", run_swing_at, liftoff.device, gait_id,
                         phase, t_frac, liftoff, touchdown, dt, h_apex)
    swing_reference_at.launches += 1
    return out


swing_reference_at.launches = 0


def run_swing_at(launch_fn, gait_id, phase, t_frac, liftoff, touchdown, dt,
                 h_apex):
    """(rc, (pos, vel, acc)): `run_swing_period` at one tick, t_frac a
    scenario's (or every scenario's) one fraction; the outputs (B, 4, 3)."""
    if not isinstance(t_frac, torch.Tensor):
        raise TypeError(f"t_frac must be a torch.Tensor, got {type(t_frac)}")
    rows = t_frac[:, None] if t_frac.dim() == 1 else t_frac
    rc, outs = run_swing_period(launch_fn, gait_id, phase, rows, liftoff,
                                touchdown, dt, h_apex)
    return rc, tuple(o[:, 0] for o in outs)


def swing_reference_at_reference(gait_id, phase, t_frac, liftoff, touchdown,
                                 dt, h_apex):
    """Plain version of `swing_reference_at` (any device and dtype): the
    swing tables' gathers, T, s, then `swing_foot_ref_reference`."""
    back, _, dur, _ = swing_tables(gait_id, phase, liftoff.dtype)
    T_swing = dur * dt
    frac = t_frac.reshape(-1, 1)
    s = torch.where(dur > 0, (back + frac) / torch.clamp_min(dur, 1.0),
                    torch.zeros_like(dur))
    return swing_foot_ref_reference(liftoff, touchdown, s, T_swing, h_apex)
