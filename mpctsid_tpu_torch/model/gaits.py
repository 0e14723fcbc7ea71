"""Gait definitions as fixed-shape contact-schedule tables (pure data, numpy).

The reference keeps a variable-length gait matrix (rows = phases with a duration
column, cols = 4 feet in {0,1}) and rolls it one step per MPC period
(SURVEY.md §2.1 "Gait scheduler"; gait set trot/walk/bound/static from
BASELINE.json:8).  A row-compressed variable-length matrix is hostile to vmap, so
the batch-friendly representation is the *expanded* periodic table instead: a fixed
(GAIT_PERIOD, 4) 0/1 array at MPC-step resolution (dt = 20 ms), indexed modulo the
gait period by a per-scenario phase counter.  Rolling is an integer increment;
gathering the horizon-16 contact matrix is a take along axis 0.  All gaits share
GAIT_PERIOD rows so a batch can mix gaits as an integer gait-id per scenario.

This is the PyTorch port's own copy of the gait tables (numpy only); the port
imports nothing from the JAX package, and tests/test_torch_imports.py holds
the two copies equal value by value.
"""

from __future__ import annotations

import dataclasses

import numpy as np

GAIT_PERIOD = 16  # MPC steps per gait cycle (0.32 s at dt = 20 ms)
N_FEET = 4


@dataclasses.dataclass(frozen=True)
class GaitDef:
    name: str
    table: np.ndarray  # (GAIT_PERIOD, 4) float64 in {0,1}; 1 = stance

    def __post_init__(self):
        assert self.table.shape == (GAIT_PERIOD, N_FEET), self.table.shape

    def contacts_at(self, phase: int) -> np.ndarray:
        return self.table[phase % GAIT_PERIOD]

    def horizon(self, phase: int, n: int) -> np.ndarray:
        """(n, 4) contact schedule for MPC steps [phase, phase+n)."""
        idx = (phase + np.arange(n)) % GAIT_PERIOD
        return self.table[idx]

    def stance_duration(self, leg: int) -> int:
        return int(self.table[:, leg].sum())


def _make(name: str, rows) -> GaitDef:
    return GaitDef(name, np.asarray(rows, dtype=np.float64))


def _phase_table(stance_mask_fn) -> np.ndarray:
    t = np.zeros((GAIT_PERIOD, N_FEET))
    for k in range(GAIT_PERIOD):
        t[k] = stance_mask_fn(k)
    return t


# Trot: diagonal pairs (FL+HR / FR+HL) alternate every half period.
TROT = _make("trot", _phase_table(
    lambda k: [1, 0, 0, 1] if k < GAIT_PERIOD // 2 else [0, 1, 1, 0]))

# Walk: one foot swings at a time, 75% duty cycle, order FL, HR, FR, HL.
_WALK_ORDER = (0, 3, 1, 2)
WALK = _make("walk", _phase_table(
    lambda k: [0.0 if _WALK_ORDER[4 * k // GAIT_PERIOD] == leg else 1.0
               for leg in range(N_FEET)]))

# Bound: front pair and hind pair alternate, separated by double-support
# phases (4 front / 4 all / 4 hind / 4 all at dt=20ms).  A pure 50%-duty
# alternating bound keeps a single pair loaded for 0.16 s, which is statically
# unbalanceable for this controller family (no flight-phase handling) — the
# closed-loop robot pitches over within ~10 gait cycles (oracle-verified).
# The double-support variant is stable at 0.25-0.3 m/s in both the f64 oracle
# and the f32 device cascade (tests/test_cascade_jax.py::test_gait_sweep).
BOUND = _make("bound", _phase_table(
    lambda k: [1, 1, 0, 0] if k < 4 else
              [1, 1, 1, 1] if k < 8 else
              [0, 0, 1, 1] if k < 12 else
              [1, 1, 1, 1]))

# Pace: LATERAL pairs (FL+HL / FR+HR) alternate, with the same
# double-support separators as the bound (4 left / 4 all / 4 right / 4 all)
# and for the same reason — a 50%-duty pace keeps one lateral pair loaded
# for 0.16 s, which this controller family cannot balance in roll (no
# flight/aerial handling).  Foot order is [FL, FR, HL, HR] (model/solo12).
PACE = _make("pace", _phase_table(
    lambda k: [1, 0, 1, 0] if k < 4 else
              [1, 1, 1, 1] if k < 8 else
              [0, 1, 0, 1] if k < 12 else
              [1, 1, 1, 1]))

# Static stand: all four feet down.
STATIC = _make("static", np.ones((GAIT_PERIOD, N_FEET)))

GAITS = {"trot": TROT, "walk": WALK, "bound": BOUND, "static": STATIC,
         "pace": PACE}
GAIT_IDS = {"trot": 0, "walk": 1, "bound": 2, "static": 3, "pace": 4}


def gait_tables() -> np.ndarray:
    """(5, GAIT_PERIOD, 4) stacked tables indexed by GAIT_IDS, for batched lookup."""
    return np.stack([TROT.table, WALK.table, BOUND.table, STATIC.table,
                     PACE.table])
