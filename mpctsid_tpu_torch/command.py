"""Command source: scripted velocity profiles (replaces the reference's
joystick / velocity-profile input, SURVEY.md §2.1 "Command source").

Profiles are plain (n_periods, 3) arrays of [vx, vy, wz] at the MPC cadence,
consumed by cascade_rollout's scan; generators below cover the family-typical
test profiles (constant, ramp, sinusoidal weave, segment scripts).
This is the PyTorch port's own copy of the command profiles (numpy only); the port
imports nothing from the JAX package, and tests/test_torch_imports.py holds
the two copies equal value by value.
"""

from __future__ import annotations

import numpy as np


def constant(n_periods: int, vx=0.0, vy=0.0, wz=0.0) -> np.ndarray:
    return np.tile(np.asarray([vx, vy, wz], np.float32), (n_periods, 1))


def ramp(n_periods: int, v_target, t_ramp_periods: int) -> np.ndarray:
    """Linear ramp from zero to v_target over t_ramp_periods, then hold."""
    v_target = np.asarray(v_target, np.float32)
    a = np.minimum(np.arange(n_periods) / max(t_ramp_periods, 1), 1.0)
    return (a[:, None] * v_target[None, :]).astype(np.float32)


def weave(n_periods: int, vx=0.3, wz_amp=0.4,
          period_s: float = 2.0, dt: float = 0.02) -> np.ndarray:
    """Forward walk with sinusoidal yaw-rate weaving."""
    t = np.arange(n_periods) * dt
    out = np.zeros((n_periods, 3), np.float32)
    out[:, 0] = vx
    out[:, 2] = wz_amp * np.sin(2.0 * np.pi * t / period_s)
    return out


def segments(spec: list[tuple[float, tuple[float, float, float]]],
             dt: float = 0.02) -> np.ndarray:
    """Piecewise-constant script: [(duration_s, (vx, vy, wz)), ...]."""
    chunks = [np.tile(np.asarray(v, np.float32), (max(int(round(d / dt)), 1), 1))
              for d, v in spec]
    return np.concatenate(chunks, axis=0)
