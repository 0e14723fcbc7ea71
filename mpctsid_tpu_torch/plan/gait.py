"""Gait scheduling: periodic contact tables + precomputed swing-phase data
(counterpart of the JAX package's plan/gait.py, batch written out).

Every swing quantity (steps since lift-off, steps until touchdown, swing
duration) is PRECOMPUTED into constant lookup tables indexed by
(gait_id, phase, leg), so a gait roll is an integer increment and every query
is one gather with the per-scenario index tensors `gait_id` (B,) and
`phase` (B,).  Batches mix gaits freely.

The tables are numpy constants; `device_constant` puts each on a device once.
"""

from __future__ import annotations

import numpy as np
import torch

from mpctsid_tpu_torch.model.gaits import GAIT_PERIOD, gait_tables
from mpctsid_tpu_torch.utils import device_constant

TABLES = gait_tables()  # (5, 16, 4) numpy constant


def _swing_tables_np():
    """Constant (5, 16, 4) arrays: steps since lift-off (back), steps until
    touchdown (fwd), swing duration (dur, in MPC steps; 0 in stance)."""
    n_g = TABLES.shape[0]
    back = np.zeros((n_g, GAIT_PERIOD, 4))
    fwd = np.zeros((n_g, GAIT_PERIOD, 4))
    dur = np.zeros((n_g, GAIT_PERIOD, 4))
    for g in range(n_g):
        for ph in range(GAIT_PERIOD):
            for leg in range(4):
                col = TABLES[g, :, leg]
                if col[ph] > 0.5:
                    continue
                b = 0
                while col[(ph - b - 1) % GAIT_PERIOD] < 0.5 and b < GAIT_PERIOD:
                    b += 1
                f = 0
                while col[(ph + f + 1) % GAIT_PERIOD] < 0.5 and f < GAIT_PERIOD:
                    f += 1
                back[g, ph, leg] = b
                fwd[g, ph, leg] = f
                dur[g, ph, leg] = b + f + 1
    return back, fwd, dur


_BACK_NP, _FWD_NP, _DUR_NP = _swing_tables_np()
_STANCE_STEPS_NP = TABLES.sum(axis=1)  # (5 gaits, 4 legs)


def _table(name: str, arr: np.ndarray, device, dtype):
    return device_constant(("gait", name), lambda: arr, device, dtype)


def contacts_at(gait_id, phase, dtype=torch.float32):
    """(B, 4) stance flags at integer phases; gait_id, phase are (B,) ints."""
    t = _table("tables", TABLES, gait_id.device, dtype)
    return t[gait_id.long(), (phase % GAIT_PERIOD).long()]


def contacts_horizon(gait_id, phase, n: int, dtype=torch.float32):
    """(B, n, 4) contact schedule for MPC steps [phase, phase + n)."""
    t = _table("tables", TABLES, gait_id.device, dtype)
    steps = torch.arange(n, device=phase.device)
    idx = (phase.long()[:, None] + steps[None, :]) % GAIT_PERIOD
    return t[gait_id.long()[:, None], idx]


def swing_tables(gait_id, phase, dtype=torch.float32):
    """(back, fwd, dur, stance_steps), each (B, 4)."""
    dev = gait_id.device
    g = gait_id.long()
    ph = (phase % GAIT_PERIOD).long()
    back = _table("back", _BACK_NP, dev, dtype)[g, ph]
    fwd = _table("fwd", _FWD_NP, dev, dtype)[g, ph]
    dur = _table("dur", _DUR_NP, dev, dtype)[g, ph]
    stance = _table("stance", _STANCE_STEPS_NP, dev, dtype)[g]
    return back, fwd, dur, stance
