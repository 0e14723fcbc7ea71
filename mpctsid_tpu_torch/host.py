"""Host-side single-robot controller: the reference's `Controller.compute()`
surface wired to device solves through the native real-time runtime
(counterpart of the JAX package's host.py).

Deployment shape:

    1 kHz loop (RtExecutor / robot interface)       planner thread
    ------------------------------------            -----------------------
    sensors -> estimator -> HostController.compute  snapshot queue ->
      reads latest COMPLETED plan                     MPC graph replay on the
      (native PlanBuffer, one-solve-stale,            planner's own stream
       wait-free seqlock read)                        -> PlanBuffer.publish
      swing + WBC graph replays -> torques

The batched simulation path (cascade/engine.py) runs all of this for B
scenarios at once; THIS module drives one physical robot, where the 1 kHz
loop is a host loop by necessity and the MPC must never block it.

Each device call is one batch-of-one call of the port's batched functions,
and on CUDA each is one captured CUDA graph (`utils/graphs.py`), the
counterpart of the JAX package's `jax.jit(..., donate_argnums=...)`:

  * `_boundary` (once per period): foot positions, the SRB state, lift-off
    bookkeeping, the offset-free velocity integrator and the touchdown
    targets (`plan_footsteps_horizon`).  In the JAX package these are eager
    device ops between its jitted calls; here they are captured too, so that
    nothing on the card runs eagerly;
  * `_mpc` (once per period): footsteps, reference rollout, the contact
    horizon, `build_mpc_qp` and `admm_solve` (with the default `auto_mpc`,
    the M2 iteration kernel, two launches per solve);
  * `_swing_ref` and `_wbc` (every tick): the swing-foot references, then
    `WbcRefs`, `solve_wbc` and the torque clip.

The ok-select of the warm starts (keep the previous one after a failed
solve) happens inside the graph, which writes the new warm start into the
same static buffer that the next replay reads: what donation is in the JAX
package.  Everything that changes from tick to tick (q, v, the contacts, the
plan column, the gait phase, the swing fraction, the command) reaches the
device as tensors in one packed static buffer, copied in with one
host-to-device copy per tick; the results come back in one device-to-host
copy.  Host-side bookkeeping (gait table, plan column, impedance law,
telemetry) is numpy, as in the JAX package.

Use async_mpc=False for a synchronous (blocking) MPC at period boundaries:
deterministic, for tests and parity checks; async_mpc=True for the
deployment behaviour.  `device="cpu"` runs every call eagerly (the tests);
the default is the card.
"""

from __future__ import annotations

import contextlib
import queue
import threading

import numpy as np
import torch

from mpctsid_tpu_torch import dyn
from mpctsid_tpu_torch.cascade.engine import (N_MPC_ROWS, N_MPC_VARS,
                                              N_WBC_ROWS, N_WBC_VARS,
                                              srb_state)
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.model.gaits import GAIT_IDS, GAIT_PERIOD
from mpctsid_tpu_torch.model.solo12 import Solo12Model
from mpctsid_tpu_torch.model.tree import build_tree
from mpctsid_tpu_torch.mpc.srb import build_mpc_qp, reference_rollout
from mpctsid_tpu_torch.plan.footsteps import plan_footsteps_horizon
from mpctsid_tpu_torch.plan.gait import (TABLES, contacts_horizon,
                                         swing_tables)
from mpctsid_tpu_torch.plan.swing import swing_foot_ref
from mpctsid_tpu_torch.qp.admm import admm_solve
from mpctsid_tpu_torch.utils import enforce_f32_matmuls, resolve_device
from mpctsid_tpu_torch.utils.graphs import CapturedCall
from mpctsid_tpu_torch.wbc.tsid import WbcRefs, solve_wbc

__all__ = ["HostController"]

# the packed per-tick input: column slices of one (1, TICK_LEN) buffer
_Q, _V = slice(0, 19), slice(19, 37)
_CONTACTS, _F_USED = slice(37, 41), slice(41, 53)
_PHASE, _T_FRAC = slice(53, 54), slice(54, 55)
_TO_SWING, _V_CMD = slice(55, 59), slice(59, 62)   # read at boundaries only
TICK_LEN = 62
# the MPC's snapshot: [x_srb 12 | feet 12 | biased command 3 | phase 1]
SNAP_LEN = 28
# the WBC's result: [tau 12 | qdd 18 | ok 1]
WBC_OUT_LEN = 31


class HostController:
    """compute(q, v) -> torques at the WBC rate; MPC solves never block."""

    # telemetry record layout (TELEM_LEN floats per 1 kHz tick):
    # [tick, phase, wbc_ok, tau_0..tau_11]
    TELEM_LEN = 15

    def __init__(self, model: Solo12Model, cfg: EngineConfig,
                 q0: np.ndarray, async_mpc: bool = False,
                 mpc_iters: int = None, mpc_rounds: int = None,
                 wbc_iters: int = None, wbc_rounds: int = None,
                 telemetry: bool = False, device="cuda"):
        # solver budgets default from the config tree (engine.py parity)
        mpc_iters = cfg.solver.mpc_iters if mpc_iters is None else mpc_iters
        mpc_rounds = (cfg.solver.mpc_adapt_rounds if mpc_rounds is None
                      else mpc_rounds)
        wbc_iters = cfg.solver.wbc_iters if wbc_iters is None else wbc_iters
        wbc_rounds = (cfg.solver.wbc_adapt_rounds if wbc_rounds is None
                      else wbc_rounds)
        enforce_f32_matmuls()
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.model = model
        self.cfg = cfg
        self.tree = build_tree(model)
        self.gait_id = GAIT_IDS[cfg.gait]
        self.async_mpc = async_mpc
        self.k = 0                     # WBC tick counter
        self.phase = 0                 # gait phase (MPC periods)
        self.horizon = N = cfg.mpc.horizon

        q0 = np.asarray(q0, np.float32).reshape(19)
        c0 = self._contacts(0)
        self.prev_contacts = c0

        # gravity-compensation fallback plan, id -1 (period it covers: all)
        n_st = max(float(c0.sum()), 1.0)
        fb = np.zeros((N, 4, 3), np.float32)
        fb[:, :, 2] = model.total_mass * model.g / n_st * c0
        self.f_plan = fb
        self.plan_period = 0   # period the current f_plan was solved in
        self._pending_plan = None      # sync mode: plan awaiting its period

        # --- device state (static buffers the graphs read and write) -------
        f32 = dict(dtype=torch.float32, device=dev)
        gid = torch.full((1,), self.gait_id, dtype=torch.int32, device=dev)
        q0_t = torch.as_tensor(q0).to(dev)[None]
        feet0 = dyn.foot_positions(self.tree, q0_t) * torch.tensor(
            [1.0, 1.0, 0.0], **f32)
        liftoff = feet0.clone()
        touchdown = feet0.clone()
        v_int = torch.zeros((1, 3), **f32)   # velocity-error integral
        q_stand = torch.as_tensor(np.asarray(model.q_stand, np.float32)).to(
            dev)[None]
        rpy_ref = torch.zeros((1, 2), **f32)
        h_ref = torch.full((1,), model.h_ref, **f32)

        tick0 = np.zeros((1, TICK_LEN), np.float32)
        tick0[0, _Q] = q0
        tick0[0, _CONTACTS] = c0
        tick0[0, _F_USED] = (fb[1] * c0[:, None]).reshape(-1)
        tick0[0, _V_CMD] = cfg.v_ref
        tick = torch.as_tensor(tick0).to(dev)
        snap = torch.zeros((1, SNAP_LEN), **f32)
        swing = torch.zeros((1, 36), **f32)
        mpc_out = torch.zeros((1, N_MPC_VARS + 1), **f32)
        wbc_out = torch.zeros((1, WBC_OUT_LEN), **f32)
        self._tick = tick
        self._v_int = v_int

        # host staging: pinned on the card, so that the per-tick copies are
        # plain DMA on the tick's stream
        card = dev.type == "cuda"
        self._tick_host = torch.zeros((1, TICK_LEN), pin_memory=card)
        self._snap_host = torch.zeros((1, SNAP_LEN), pin_memory=card)
        self._wbc_host = torch.zeros((1, WBC_OUT_LEN), pin_memory=card)
        self._mpc_host = torch.zeros((1, N_MPC_VARS + 1), pin_memory=card)
        self._stream = torch.cuda.Stream(dev) if card else None

        tau_max = cfg.wbc.tau_max
        mpc_every = cfg.cascade.mpc_every
        t_period = mpc_every * cfg.cascade.wbc_dt

        # --- the device calls ------------------------------------------
        def _boundary(tick, liftoff, touchdown, v_int, out):
            q, v = tick[:, _Q], tick[:, _V]
            phase = tick[:, _PHASE][:, 0].to(torch.int32)
            contacts = tick[:, _CONTACTS]
            feet_now = dyn.foot_positions(self.tree, q)
            liftoff.copy_(torch.where(tick[:, _TO_SWING][..., None] > 0.5,
                                      feet_now, liftoff))
            x_srb = srb_state(q, v)
            # offset-free velocity integrator (cascade/engine.py twin): bias
            # the command handed to the planner thread / sync solve
            cy, sy = torch.cos(x_srb[:, 5]), torch.sin(x_srb[:, 5])
            v_meas = torch.stack([cy * x_srb[:, 6] + sy * x_srb[:, 7],
                                  -sy * x_srb[:, 6] + cy * x_srb[:, 7],
                                  x_srb[:, 11]], dim=-1)
            v_cmd = tick[:, _V_CMD]
            v_int.copy_(torch.clamp(
                v_int + cfg.cascade.ki_vint * t_period * (v_cmd - v_meas),
                -cfg.cascade.v_int_max, cfg.cascade.v_int_max))
            v_used = v_cmd + v_int
            # touchdown targets of the swinging feet (cheap planner op)
            _, next_td = plan_footsteps_horizon(
                model, cfg.mpc, cfg.cascade, gid, phase, x_srb, v_used,
                feet_now)
            touchdown.copy_(torch.where((contacts < 0.5)[..., None], next_td,
                                        touchdown))
            out.copy_(torch.cat([x_srb, feet_now.reshape(1, 12), v_used,
                                 tick[:, _PHASE]], dim=1))
            return out

        def _mpc(snap, warm_x, warm_y, out):
            x_srb, v_used = snap[:, 0:12], snap[:, 24:27]
            feet = snap[:, 12:24].reshape(1, 4, 3)
            phase = snap[:, 27].to(torch.int32)
            fsteps, _ = plan_footsteps_horizon(
                model, cfg.mpc, cfg.cascade, gid, phase, x_srb, v_used, feet)
            x_ref = reference_rollout(model, cfg.mpc, x_srb, v_used)
            cont = contacts_horizon(gid, phase, N)
            P, q_lin, A, l, u = build_mpc_qp(model, cfg.mpc, x_srb, x_ref,
                                             fsteps, cont)
            sol = admm_solve(P, q_lin, A, l, u, x0=warm_x, y0=warm_y,
                             iters=mpc_iters, adapt_rounds=mpc_rounds,
                             rho=0.1, backend=cfg.solver.mpc_backend)
            ok = sol.ok[:, None]
            warm_x.copy_(torch.where(ok, sol.x, warm_x))
            warm_y.copy_(torch.where(ok, sol.y, warm_y))
            out.copy_(torch.cat([sol.x, ok.to(sol.x.dtype)], dim=1))
            return out

        def _swing_ref(tick, liftoff, touchdown, out):
            phase = tick[:, _PHASE][:, 0].to(torch.int32)
            back, _, dur, _ = swing_tables(gid, phase)
            T_swing = dur * cfg.mpc.dt
            s = torch.where(dur > 0, (back + tick[:, _T_FRAC])
                            / torch.clamp_min(dur, 1.0), torch.zeros_like(dur))
            pos, vel, acc = swing_foot_ref(liftoff, touchdown, s, T_swing,
                                           cfg.cascade.swing_height)
            out.copy_(torch.cat([pos.reshape(1, 12), vel.reshape(1, 12),
                                 acc.reshape(1, 12)], dim=1))
            return out

        def _wbc(tick, swing, warm_x, warm_y, out):
            refs = WbcRefs(
                contacts=tick[:, _CONTACTS],
                f_mpc=tick[:, _F_USED].reshape(1, 4, 3),
                foot_pos_ref=swing[:, 0:12].reshape(1, 4, 3),
                foot_vel_ref=swing[:, 12:24].reshape(1, 4, 3),
                foot_acc_ref=swing[:, 24:36].reshape(1, 4, 3),
                q_posture=q_stand, base_rpy_ref=rpy_ref, h_ref=h_ref)
            tau, qdd, _, sol = solve_wbc(self.tree, cfg.wbc, tick[:, _Q],
                                         tick[:, _V], refs, iters=wbc_iters,
                                         adapt_rounds=wbc_rounds,
                                         warm_x=warm_x, warm_y=warm_y,
                                         backend=cfg.solver.wbc_backend)
            tau = torch.clamp(tau, -tau_max, tau_max)
            ok = sol.ok[:, None]
            warm_x.copy_(torch.where(ok, sol.x, warm_x))
            warm_y.copy_(torch.where(ok, sol.y, warm_y))
            out.copy_(torch.cat([tau, qdd, ok.to(tau.dtype)], dim=1))
            return out

        # every graph is captured here, before the planner thread starts:
        # CUDA work on another thread during a capture is an error
        self._boundary = CapturedCall(
            _boundary, dict(tick=tick, liftoff=liftoff, touchdown=touchdown,
                            v_int=v_int, out=snap), dev, "host boundary")
        # sync mode: the MPC reads the boundary's snapshot in place; async:
        # a buffer of its own, filled by the planner thread
        mpc_snap = snap.clone() if async_mpc else snap
        self._mpc = CapturedCall(
            _mpc, dict(snap=mpc_snap,
                       warm_x=torch.zeros((1, N_MPC_VARS), **f32),
                       warm_y=torch.zeros((1, N_MPC_ROWS), **f32),
                       out=mpc_out), dev, "host MPC solve")
        self._swing_ref = CapturedCall(
            _swing_ref, dict(tick=tick, liftoff=liftoff, touchdown=touchdown,
                             out=swing), dev, "host swing reference")
        self._wbc = CapturedCall(
            _wbc, dict(tick=tick, swing=swing,
                       warm_x=torch.zeros((1, N_WBC_VARS), **f32),
                       warm_y=torch.zeros((1, N_WBC_ROWS), **f32),
                       out=wbc_out), dev, "host WBC solve")
        if card:
            torch.cuda.synchronize(dev)

        # per-tick telemetry through the native wait-free ring: push costs
        # no allocation or lock in the 1 kHz loop; drain_telemetry() from
        # any other thread
        self._telem = None
        if telemetry:
            from mpctsid_tpu_torch.native import TelemetryRing
            self._telem = TelemetryRing(self.TELEM_LEN, capacity=8192)

        if async_mpc:
            from mpctsid_tpu_torch.native import PlanBuffer
            self._buf = PlanBuffer(N * 12)
            self._buf.publish(fb.reshape(-1), 0)
            self._q: "queue.Queue" = queue.Queue(maxsize=2)
            self._stop = threading.Event()
            self._planner_error = None
            self._plan_stream = torch.cuda.Stream(dev) if card else None
            self._planner = threading.Thread(target=self._planner_loop,
                                             daemon=True)
            self._planner.start()

    # --- helpers ------------------------------------------------------------
    def _contacts(self, phase: int) -> np.ndarray:
        """(4,) stance flags of this robot's gait at `phase` (host table)."""
        return TABLES[self.gait_id, phase % GAIT_PERIOD].astype(np.float32)

    def _on(self, stream):
        return (torch.cuda.stream(stream) if stream is not None
                else contextlib.nullcontext())

    @property
    def v_int(self) -> np.ndarray:
        """The velocity-error integral [vx, vy, wz] (read from the device)."""
        return self._v_int[0].cpu().numpy()

    # --- planner thread (async mode): MPC graph -> PlanBuffer --------------
    def _planner_loop(self):
        try:
            while not self._stop.is_set():
                try:
                    snap, phase = self._q.get(timeout=0.1)
                except queue.Empty:
                    continue
                with self._on(self._plan_stream):
                    out = self._mpc(snap=snap)
                    res = out.cpu()      # waits for the planner's stream only
                res = res.numpy()[0]
                if res[-1] > 0.5:
                    self._buf.publish(res[:-1], phase)
                # a failed solve publishes nothing: the consumer keeps the
                # last feasible plan
        except Exception as e:   # the thread ends; close() re-raises it
            self._planner_error = e

    def close(self):
        """Stop the planner thread (async mode); re-raises what ended it."""
        if self.async_mpc:
            self._stop.set()
            self._planner.join(timeout=5.0)
            if self._planner.is_alive():
                raise RuntimeError("the planner thread did not stop in 5 s")
            if self._planner_error is not None:
                raise RuntimeError("the planner thread failed") from \
                    self._planner_error

    # --- the 1 kHz surface --------------------------------------------------
    def compute(self, q: np.ndarray, v: np.ndarray,
                v_cmd: np.ndarray | None = None) -> np.ndarray:
        """One WBC tick from measured state; returns 12 joint torques."""
        cfg = self.cfg
        mpc_every = cfg.cascade.mpc_every
        q = np.asarray(q, np.float32).reshape(19)
        v = np.asarray(v, np.float32).reshape(18)
        boundary = self.k % mpc_every == 0
        if boundary:
            to_swing = self._consume_plan()

        contacts = self._contacts(self.phase)
        # the plan solved in period p covers period p+k with column k; the
        # nominal staleness is one period -> column 1 (engine.py parity).  An
        # older plan (planner behind, failed solves) reads deeper columns.
        col = int(np.clip(self.phase - self.plan_period, 1,
                          self.horizon - 1))
        tick = self._tick_host.numpy()[0]
        tick[_Q] = q
        tick[_V] = v
        tick[_CONTACTS] = contacts
        tick[_F_USED] = (self.f_plan[col] * contacts[:, None]).reshape(-1)
        tick[_PHASE] = self.phase
        tick[_T_FRAC] = (self.k % mpc_every) / mpc_every
        if boundary:
            tick[_TO_SWING] = to_swing
            tick[_V_CMD] = cfg.v_ref if v_cmd is None else v_cmd

        # one copy in, the graphs, one copy out, one wait: on the tick's
        # own stream, which never waits behind the planner's
        with self._on(self._stream):
            self._tick.copy_(self._tick_host, non_blocking=True)
            if boundary:
                snap = self._boundary()
                if self.async_mpc:
                    self._snap_host.copy_(snap, non_blocking=True)
                else:
                    self._mpc_host.copy_(self._mpc(), non_blocking=True)
            self._swing_ref()
            self._wbc_host.copy_(self._wbc(), non_blocking=True)
            if self._stream is not None:
                self._stream.synchronize()
        if boundary:
            self._hand_over_plan()
        res = self._wbc_host.numpy()[0]
        ok = bool(res[-1] > 0.5)
        if ok:
            qdd_j = res[12 + 6:12 + 18]
            tau_ff = res[0:12]
        else:  # impedance fallback
            qdd_j = np.zeros(12, np.float32)
            tau_ff = np.zeros(12, np.float32)

        # joint-impedance actuator command (matches cascade/engine.py)
        wbc_dt = cfg.cascade.wbc_dt
        qd_des = v[6:] + qdd_j * wbc_dt
        q_des = q[7:] + v[6:] * wbc_dt + 0.5 * qdd_j * wbc_dt ** 2
        if not ok:
            q_des = np.asarray(self.model.q_stand, np.float32)
            qd_des = np.zeros(12, np.float32)
        tau_cmd = np.clip(tau_ff + 6.0 * (q_des - q[7:])
                          + 0.3 * (qd_des - v[6:]),
                          -cfg.wbc.tau_max, cfg.wbc.tau_max)
        if self._telem is not None:
            rec = np.empty(self.TELEM_LEN, np.float32)
            rec[0] = self.k
            rec[1] = self.phase
            rec[2] = float(ok)
            rec[3:15] = tau_cmd
            self._telem.push(rec)
        self.k += 1
        return tau_cmd

    def drain_telemetry(self, max_records: int = 4096) -> np.ndarray:
        """(n, TELEM_LEN) records accumulated since the last drain (empty
        array when telemetry is off)."""
        if self._telem is None:
            return np.empty((0, self.TELEM_LEN), np.float32)
        return self._telem.pop(max_records)

    def _consume_plan(self) -> np.ndarray:
        """The host's part of a period boundary, before the tick's inputs
        are packed: advance the phase, take up the latest plan; returns the
        feet that lift off now."""
        if self.k > 0:
            self.phase += 1
        contacts = self._contacts(self.phase)
        to_swing = ((contacts < 0.5) & (self.prev_contacts > 0.5)).astype(
            np.float32)
        self.prev_contacts = contacts
        if self.async_mpc:
            # consume the latest COMPLETED plan (one-solve-stale)
            pid, flat = self._buf.read_latest()
            if pid >= 0 and pid > self.plan_period:
                self.f_plan = flat.reshape(self.horizon, 4, 3)
                self.plan_period = int(pid)
        elif self._pending_plan is not None:
            # synchronous: the plan solved at the previous boundary becomes
            # consumable now (one-solve-stale, engine.py parity)
            self.f_plan, self.plan_period = self._pending_plan
            self._pending_plan = None
        return to_swing

    def _hand_over_plan(self):
        """After a boundary tick: async, hand the planner thread the
        snapshot (never waiting for it); sync, hold a successful solve for
        the next boundary.  A failed solve leaves the pending slot empty:
        the current f_plan keeps being consumed at deeper columns."""
        if self.async_mpc:
            try:
                self._q.put_nowait((self._snap_host.clone(), self.phase))
            except queue.Full:
                pass  # planner is behind; skip this period's solve
            return
        res = self._mpc_host.numpy()[0]
        if res[-1] > 0.5:
            self._pending_plan = (res[:-1].reshape(self.horizon, 4, 3).copy(),
                                  self.phase)
