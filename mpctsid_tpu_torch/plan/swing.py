"""Swing-foot trajectories (counterpart of the JAX package's plan/swing.py).

Quintic xy from lift-off to touchdown, sextic z = 64 h s^3 (1-s)^3 with apex
h, zero velocity/acceleration at both ends.  Evaluates all four feet of every
scenario at once; stance feet get zeros via the mask the caller applies.
"""

from __future__ import annotations

import torch


def swing_foot_ref(p_liftoff, p_touchdown, s, T, h_apex):
    """(pos, vel, acc), each (B, 4, 3).

    p_liftoff/p_touchdown (B, 4, 3); s (B, 4) normalized phases; T (B, 4)
    swing durations in seconds."""
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
