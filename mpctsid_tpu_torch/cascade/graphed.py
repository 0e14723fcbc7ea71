"""The batched cascade as one device program: `cascade_period` captured as
one CUDA graph per (batch, configuration) and replayed once per period (the
port's counterpart of the JAX package's `jax.jit(cascade_rollout)`, whose
scan over periods XLA compiles into one program).

    ctl, plant, metrics = cascade_rollout_graphed(
        cc, ctl, plant, gait_id, v_cmd, contact_params, n_periods)

The arguments and the results are those of `cascade_rollout`, which stays
the eager reference: a replay launches the kernels and ops of the eager
period on the same inputs, so the results are the same bits.

A `PeriodRunner` holds static buffers, one tensor per field of the
`ControllerState`, the `PlantState`, the `EstimatorState` (with
`use_estimator`) and the `ContactParams`, plus the gait ids, a (B, 3)
command and the payload when one is given.  Its captured function runs
`cascade_period` on them and ends by copying the new state into the same
buffers it read (donation in place, as the JAX package donates the scan's
carry) and the metrics into static metric buffers.  It does so on the CPU
too, where no graph exists and the function runs eagerly, so that the tests
see the aliasing the card has.  `cascade_rollout_graphed` copies the
caller's state into the buffers (the caller's tensors are never written),
then per period copies that period's command in, replays, and copies each
metric out into a (B, n_periods, ...) tensor before the next replay
overwrites it.

Every Python number of the period is baked in at capture: the budgets, the
backends, the flags, each unrolled tick's `frac = t / mpc_every`.  So they
are the runner's key, and whatever changes from call to call (state,
command, gait ids, friction and the other contact parameters, payload)
lives in the buffers.  Runners are cached by that key, at most
`MAX_RUNNERS` of them (the JAX sweep keeps `lru_cache(maxsize=4)` of its
compiled chunk runners); `clear_runners()` closes them all and frees their
graphs' pools.  On the card a runner captures when it is built (one eager
warm-up period, then the capture: `utils/graphs.py::CapturedCall`); a
capture that fails raises, naming the call, and there is no eager fallback.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from mpctsid_tpu_torch.cascade.engine import (CascadeConfigured,
                                              ControllerState, _to_device,
                                              cascade_period)
from mpctsid_tpu_torch.env.plant import ContactParams, PlantState
from mpctsid_tpu_torch.est.filter import EstimatorState
from mpctsid_tpu_torch.utils import enforce_f32_matmuls, resolve_device
from mpctsid_tpu_torch.utils.graphs import CapturedCall

__all__ = ["MAX_RUNNERS", "PeriodRunner", "period_runner",
           "cascade_rollout_graphed", "clear_runners", "cached_runners"]

MAX_RUNNERS = 4

def _resolved(cfg, solver_kw: dict) -> dict:
    """cascade_period's keywords besides the state, with the config's
    defaults filled in, so that an explicit default and an omitted one
    share a runner."""
    defaults = dict(est_mocap=False, payload_known=True,
                    mpc_iters=cfg.solver.mpc_iters,
                    mpc_rounds=cfg.solver.mpc_adapt_rounds,
                    wbc_iters=cfg.solver.wbc_iters,
                    wbc_rounds=cfg.solver.wbc_adapt_rounds,
                    mpc_backend=cfg.solver.mpc_backend,
                    wbc_backend=cfg.solver.wbc_backend)
    unknown = set(solver_kw) - set(defaults)
    if unknown:
        raise TypeError(f"unexpected keyword arguments {sorted(unknown)}")
    return {k: (defaults[k] if solver_kw.get(k) is None else solver_kw[k])
            for k in defaults}


def _flatten(states: dict) -> dict:
    """{"ctl.phase": tensor, ...} of the states given (None skipped)."""
    return {f"{prefix}.{f.name}": getattr(st, f.name)
            for prefix, st in states.items() if st is not None
            for f in dataclasses.fields(st)}


def _state(cls, prefix: str, buffers: dict):
    return cls(**{f.name: buffers[f"{prefix}.{f.name}"]
                  for f in dataclasses.fields(cls)})


def _device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class PeriodRunner:
    """`cascade_period` over static buffers for one key; one CUDA graph on
    the card.  `load(...)` copies a state in, `__call__(v_cmd)` copies the
    command in and runs one period (a replay on the card), returning the
    static metric buffers; `state()` clones the state out."""

    def __init__(self, cc: CascadeConfigured, key: tuple, kw: dict,
                 use_estimator: bool, ctl, plant, gait_id, contact_params,
                 est, payload, device):
        self.cc = cc
        self.key = key
        self.kw = dict(kw)
        self.use_estimator = use_estimator
        self.replays = 0
        self.metrics = None
        states = dict(ctl=ctl, plant=plant, cp=contact_params,
                      est=est if use_estimator else None)
        buffers = {k: t.clone() for k, t in _flatten(states).items()}
        buffers["gait_id"] = gait_id.to(torch.int64).clone()
        buffers["v_cmd"] = plant.q.new_zeros((plant.q.shape[0], 3))
        if payload is not None:
            buffers["payload"] = payload.clone()
        self.buffers = buffers
        tag = (f"B={plant.q.shape[0]}, mpc {kw['mpc_backend']}, wbc "
               f"{kw['wbc_backend']}" + (", estimator" if use_estimator
                                         else "")
               + ("" if payload is None else ", payload"))
        self.call = CapturedCall(self._period, buffers, device,
                                 f"cascade period ({tag})")

    def _period(self, **buf):
        """One period on the buffers; writes the new state back into them
        and the metrics into the static metric buffers."""
        ctl = _state(ControllerState, "ctl", buf)
        plant = _state(PlantState, "plant", buf)
        cp = _state(ContactParams, "cp", buf)
        est = (_state(EstimatorState, "est", buf) if self.use_estimator
               else None)
        new_ctl, new_plant, new_est, metrics = cascade_period(
            self.cc, ctl, plant, buf["gait_id"], buf["v_cmd"], cp, est=est,
            use_estimator=self.use_estimator, payload=buf.get("payload"),
            **self.kw)
        if self.metrics is None:
            self.metrics = {k: torch.empty_like(t)
                            for k, t in metrics.items()}
        for k, t in metrics.items():
            self.metrics[k].copy_(t)
        new = _flatten(dict(ctl=new_ctl, plant=new_plant,
                            est=new_est if self.use_estimator else None))
        for k, t in new.items():
            buf[k].copy_(t)
        return self.metrics

    def load(self, ctl, plant, gait_id, contact_params, est=None,
             payload=None) -> None:
        """Copy a state (tensors on the runner's device, the shapes and
        dtypes it was built for) into the static buffers."""
        states = dict(ctl=ctl, plant=plant, cp=contact_params,
                      est=est if self.use_estimator else None)
        values = _flatten(states)
        values["gait_id"] = gait_id
        if payload is not None:
            values["payload"] = payload
        if set(values) != set(self.buffers) - {"v_cmd"}:
            raise ValueError("the state does not match the runner's key")
        for k, t in values.items():
            self.buffers[k].copy_(t)

    def __call__(self, v_cmd):
        """One period at command v_cmd (B, 3); returns the static metric
        buffers, which the next call overwrites."""
        self.replays += 1
        return self.call(v_cmd=v_cmd)

    def state(self):
        """(ctl, plant, est) cloned out of the buffers; est None without the
        estimator."""
        clone = {k: t.clone() for k, t in self.buffers.items()
                 if k.startswith(("ctl.", "plant.", "est."))}
        est = (_state(EstimatorState, "est", clone) if self.use_estimator
               else None)
        return (_state(ControllerState, "ctl", clone),
                _state(PlantState, "plant", clone), est)

    def close(self) -> None:
        if self.call.device.type == "cuda":
            torch.cuda.synchronize(self.call.device)
        self.call.close()
        self.metrics = None


_RUNNERS: "collections.OrderedDict[tuple, PeriodRunner]" = (
    collections.OrderedDict())


def cached_runners() -> list:
    """The cached runners, least recently used first."""
    return list(_RUNNERS.values())


def clear_runners() -> None:
    """Close every cached runner and empty the cache (on the card,
    `torch.cuda.empty_cache()` then returns the graphs' pools)."""
    while _RUNNERS:
        _RUNNERS.popitem(last=False)[1].close()


def _on_device(ctl, plant, gait_id, contact_params, est, payload, dev):
    """The states moved to `dev`, as cascade_rollout moves them."""
    plant = _to_device(plant, dev)
    gait_id = torch.as_tensor(gait_id).to(dev)
    if payload is not None:
        payload = torch.as_tensor(payload, dtype=plant.q.dtype).to(dev)
    return (_to_device(ctl, dev), plant, gait_id,
            _to_device(contact_params, dev), _to_device(est, dev), payload)


def period_runner(cc: CascadeConfigured, ctl, plant, gait_id,
                  contact_params, est=None, use_estimator: bool = False,
                  payload=None, device="cuda", **solver_kw) -> PeriodRunner:
    """The cached runner for this configuration and these states' shapes,
    built (and on the card captured, from the given state) on first use.
    Its buffers hold whatever the last user left in them: `load` first."""
    if use_estimator and est is None:
        raise ValueError("use_estimator=True needs est, an EstimatorState "
                         "(est.filter.estimator_init)")
    dev = _device(device)
    kw = _resolved(cc.cfg, solver_kw)
    ctl, plant, gait_id, contact_params, est, payload = _on_device(
        ctl, plant, gait_id, contact_params, est, payload, dev)
    states = dict(ctl=ctl, plant=plant, cp=contact_params,
                  est=est if use_estimator else None)
    shapes = tuple((k, tuple(t.shape), t.dtype)
                   for k, t in _flatten(states).items())
    key = (cc, dev, plant.q.shape[0], plant.q.dtype, bool(use_estimator),
           payload is not None, shapes, tuple(gait_id.shape),
           tuple(sorted(kw.items())))
    runner = _RUNNERS.get(key)
    if runner is not None:
        _RUNNERS.move_to_end(key)
        return runner
    runner = PeriodRunner(cc, key, kw, bool(use_estimator), ctl, plant,
                          gait_id, contact_params, est, payload, dev)
    _RUNNERS[key] = runner
    while len(_RUNNERS) > MAX_RUNNERS:
        _RUNNERS.popitem(last=False)[1].close()
    return runner


def cascade_rollout_graphed(cc: CascadeConfigured, ctl: ControllerState,
                            plant: PlantState, gait_id, v_cmd,
                            contact_params: ContactParams, n_periods: int,
                            est=None, use_estimator: bool = False,
                            payload=None, device="cuda", **solver_kw):
    """`cascade_rollout` with each period a replay of the cached runner's
    graph: the same arguments, the same return value (ctl, plant, metrics
    stacked on axis 1 as (B, n_periods, ...), on the device), the same
    bits."""
    enforce_f32_matmuls()
    dev = _device(device)
    ctl, plant, gait_id, contact_params, est, payload = _on_device(
        ctl, plant, gait_id, contact_params, est, payload, dev)
    v_cmd = torch.as_tensor(v_cmd, dtype=plant.q.dtype).to(dev)
    if v_cmd.dim() == 2:
        v_seq = v_cmd[:, None, :].expand(-1, n_periods, -1)
    else:
        v_seq = v_cmd
    if v_seq.shape[1] != n_periods:
        raise ValueError(f"v_cmd profile has {v_seq.shape[1]} periods, "
                         f"n_periods is {n_periods}")
    if n_periods < 1:
        raise ValueError(f"n_periods must be at least 1, got {n_periods}")
    runner = period_runner(cc, ctl, plant, gait_id, contact_params, est=est,
                           use_estimator=use_estimator, payload=payload,
                           device=dev, **solver_kw)
    runner.load(ctl, plant, gait_id, contact_params, est=est,
                payload=payload)
    stacked = None
    for k in range(n_periods):
        out = runner(v_seq[:, k])
        if stacked is None:
            stacked = {name: t.new_empty((t.shape[0], n_periods)
                                         + tuple(t.shape[1:]))
                       for name, t in out.items()}
        for name, t in out.items():
            stacked[name][:, k].copy_(t)
    new_ctl, new_plant, _ = runner.state()
    return new_ctl, new_plant, stacked
