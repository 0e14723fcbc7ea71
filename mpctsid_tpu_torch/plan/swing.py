"""Swing-foot trajectories (counterpart of the JAX package's plan/swing.py).

Quintic xy from lift-off to touchdown, sextic z = 64 h s^3 (1-s)^3 with apex
h, zero velocity/acceleration at both ends.  Evaluates all four feet of every
scenario at once; stance feet get zeros via the mask the caller applies.

`swing_foot_ref` is, on CUDA tensors, one launch of the hand-written kernel
`plan_swing` (plan/csrc/planner.cu: a thread per scenario and foot;
plan/kernels.py); on CPU tensors it runs its plain version,
`swing_foot_ref_reference` (about 56 kernels a call on the card).
"""

from __future__ import annotations

import numbers

import torch

from mpctsid_tpu_torch.plan import kernels


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
