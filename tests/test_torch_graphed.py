"""The graphed rollout (mpctsid_tpu_torch/cascade/graphed.py) on the CPU.

On the CPU a runner holds no graph: its function runs eagerly on the static
buffers, with the same donation in place (the new state written into the
buffers it read, the metrics into static metric buffers) that the card
replays.  So these tests see the aliasing of the card:
`cascade_rollout_graphed` against `cascade_rollout` bit for bit, over the backends (on the CPU every
kernel backend runs its plain version), the estimator, the payload and the
command; stale buffers; the caller's tensors; the copy-out of each period's
metrics; host reads inside the period; the runner cache; the entry points
that call it.  The capture itself runs on the card (chip_smoke.py phase 12).

Full Solo-12, B = 2, two periods from standing.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mpctsid_tpu_torch.cascade import engine, graphed
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.env.plant import ContactParams, PlantState
from mpctsid_tpu_torch.est.filter import estimator_init
from mpctsid_tpu_torch.model.gaits import GAIT_IDS
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.utils.graphs import CapturedCall

from _torch_port_util import random_qv, standing_q0, tt

B = 2
PERIODS = 2
GAITS = ("trot", "bound")
MU = (0.6, 0.9)
PAYLOAD = (0.1, 0.35)
V_CONST = ((0.3, 0.0, 0.0), (0.2, 0.05, 0.1))
V_PROFILE = (((0.3, 0.0, 0.0), (0.1, 0.0, 0.3)),
             ((0.2, 0.05, 0.1), (0.25, -0.05, 0.0)))

# (MPC backend, WBC backend, use_estimator, est_mocap, payload, command):
# every backend, the estimator on and off (hint-free and with the mocap
# hint), no payload, a known and an unknown one, a constant command and a
# per-period profile
CASES = {
    "plain": ("auto_mpc", "xla", False, False, None, "constant"),
    "fused-estimator-known-profile": ("auto_mpc", "fused", True, False,
                                      "known", "profile"),
    "vpu-unknown": ("auto_mpc", "vpu", False, False, "unknown", "constant"),
    "packed-mocap-profile": ("m2", "packed", True, True, None, "profile"),
    "pallas-estimator-unknown": ("pallas", "pallas", True, False, "unknown",
                                 "constant"),
    "torch-known-profile": ("torch", "torch", False, False, "known",
                            "profile"),
}

# the tensor methods that read a value on the host
HOST_READS = ("__bool__", "item", "tolist", "numpy", "cpu", "__int__",
              "__float__", "nonzero")


@contextlib.contextmanager
def no_host_reads():
    """Every method of HOST_READS (and torch.nonzero) raises inside."""
    saved = {n: getattr(torch.Tensor, n) for n in HOST_READS}
    saved_nonzero = torch.nonzero

    def refuse(name):
        def f(*args, **kwargs):
            raise AssertionError(f"host read inside the period: {name}")
        return f

    for n in HOST_READS:
        setattr(torch.Tensor, n, refuse(f"Tensor.{n}"))
    torch.nonzero = refuse("torch.nonzero")
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)
        torch.nonzero = saved_nonzero


def _inputs(q0=None, gaits=GAITS, mu=MU, cfg=None):
    """(cc, ctl, plant, gait ids, contact params) at q0 (default standing)."""
    cfg = cfg or EngineConfig()
    cc = engine.CascadeConfigured(SOLO12, cfg)
    q0 = standing_q0(B) if q0 is None else q0
    gid = np.array([GAIT_IDS[g] for g in gaits], np.int32)
    ctl = engine.init_controller(SOLO12, cfg, cc.tree, q0, gid, device="cpu")
    plant = PlantState.init(q0, device="cpu")
    cp = dataclasses.replace(ContactParams.default(B, device="cpu"),
                             mu=tt(mu))
    return cc, ctl, plant, gid, cp


def _flat(ctl, plant, metrics=None, est=None) -> dict:
    out = {}
    for prefix, st in (("ctl", ctl), ("plant", plant), ("est", est)):
        if st is not None:
            out.update({f"{prefix}.{f.name}": getattr(st, f.name)
                        for f in dataclasses.fields(st)})
    out.update({f"metric.{k}": t for k, t in (metrics or {}).items()})
    return out


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_bitwise(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        assert torch.equal(_bits(g), _bits(w)), k


def _run_case(name):
    """Eager and graphed rollouts of one case from the same inputs; the
    caller's tensors cloned before the call and kept after it."""
    mpc, wbc, use_est, mocap, payload, command = CASES[name]
    cc, ctl, plant, gid, cp = _inputs()
    est = estimator_init(standing_q0(B), device="cpu") if use_est else None
    v = np.asarray(V_CONST if command == "constant" else V_PROFILE,
                   np.float32)
    kw = dict(mpc_backend=mpc, wbc_backend=wbc, est_mocap=mocap)
    if payload is not None:
        kw.update(payload=tt(PAYLOAD), payload_known=payload == "known")
    args = (cc, ctl, plant, gid, v, cp)
    common = dict(n_periods=PERIODS, est=est, use_estimator=use_est,
                  device="cpu", **kw)
    callers = _flat(ctl, plant, est=est)
    callers.update({f"cp.{f.name}": getattr(cp, f.name)
                    for f in dataclasses.fields(cp)})
    before = {k: t.clone() for k, t in callers.items()}
    eager = engine.cascade_rollout(*args, **common)
    graphed.clear_runners()
    got = graphed.cascade_rollout_graphed(*args, **common)
    (runner,) = graphed.cached_runners()
    # the static metric buffers as the rollout left them (other tests run
    # the runner again)
    left = {k: (t.clone(), t.data_ptr()) for k, t in runner.metrics.items()}
    return dict(eager=eager, got=got, before=before, callers=callers,
                runner=runner, left=left)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return _run_case(request.param)


def test_graphed_rollout_equals_eager_bit_for_bit(case):
    (c_e, p_e, m_e), (c_g, p_g, m_g) = case["eager"], case["got"]
    assert_bitwise(_flat(c_g, p_g, m_g), _flat(c_e, p_e, m_e))
    assert case["runner"].replays == PERIODS
    assert all(t.shape[:2] == (B, PERIODS) for t in m_g.values())


def test_the_callers_tensors_are_never_written(case):
    runner = case["runner"]
    owned = {t.data_ptr() for t in runner.buffers.values()}
    for k, t in case["callers"].items():
        assert torch.equal(_bits(t), _bits(case["before"][k])), k
        assert t.data_ptr() not in owned, k
    c_g, p_g, _ = case["got"]
    for t in _flat(c_g, p_g).values():
        assert t.data_ptr() not in owned


def test_the_period_reads_nothing_on_the_host(case):
    """The runner's function, run on its buffers with every host read
    refused, as the capture on the card requires."""
    runner = case["runner"]
    with no_host_reads():
        out = runner.call.fn(**runner.call.inputs)
    assert out is runner.metrics


def test_the_guard_refuses_every_host_read():
    t = torch.ones(2)
    # looked up at the call, inside the guard
    reads = [lambda: bool(t[0]), lambda: t.item(), lambda: t.tolist(),
             lambda: t.numpy(), lambda: t.cpu(), lambda: int(t[0]),
             lambda: float(t[0]), lambda: t.nonzero(),
             lambda: torch.nonzero(t)]
    with no_host_reads():
        for read in reads:
            with pytest.raises(AssertionError, match="host read"):
                read()
    assert bool(t[0]) and t.nonzero().shape == (2, 1)


def test_period_metrics_survive_the_later_periods(case):
    """The runner's metric buffers are static: every period overwrites
    them, so each period's metrics must be copied out before the next.
    After the rollout they hold the LAST period; the stacked metrics still
    hold the first, which differs from it."""
    _, _, m_e = case["eager"]
    _, _, m_g = case["got"]
    assert set(case["left"]) == set(m_e)
    for k, (t, ptr) in case["left"].items():
        assert torch.equal(_bits(t), _bits(m_e[k][:, -1])), k
        assert torch.equal(_bits(m_g[k][:, 0]), _bits(m_e[k][:, 0])), k
        assert ptr != m_g[k].data_ptr()
    for k in ("x_srb", "tau_rms", "est_xy_err"):
        if k in m_g:
            assert not torch.equal(m_g[k][:, 0], m_g[k][:, -1]), k


def test_one_runner_serves_two_initial_states():
    """A cached runner used twice in a row from different states, gait
    ids, friction and commands: each result equals eager (a buffer that
    kept the first call's values would show)."""
    graphed.clear_runners()
    q, v = random_qv(7, B, spread=0.1)
    first = _inputs()
    second = _inputs(q0=q, gaits=("walk", "pace"), mu=(0.9, 0.5))
    second[2].v.copy_(tt(v) * 0.1)
    cmds = (np.asarray(V_CONST, np.float32),
            np.asarray([[0.1, 0.05, 0.2], [0.0, 0.0, -0.2]], np.float32))
    results = []
    for (cc, ctl, plant, gid, cp), cmd in zip((first, second), cmds):
        got = graphed.cascade_rollout_graphed(cc, ctl, plant, gid, cmd, cp,
                                              n_periods=1, device="cpu")
        results.append((got, (cc, ctl, plant, gid, cmd, cp)))
    (runner,) = graphed.cached_runners()
    assert runner.replays == 2
    for (c_g, p_g, m_g), args in results:
        c_e, p_e, m_e = engine.cascade_rollout(*args, n_periods=1,
                                               device="cpu")
        assert_bitwise(_flat(c_g, p_g, m_g), _flat(c_e, p_e, m_e))


def _key_variants():
    """(name, keywords of period_runner over the base inputs): each makes
    another runner than the base's."""
    return [
        ("batch", dict(batch=3)),
        ("config", dict(cfg=EngineConfig(gait="walk"))),
        ("mpc backend", dict(mpc_backend="torch")),
        ("wbc backend", dict(wbc_backend="fused")),
        ("mpc iters", dict(mpc_iters=20)),
        ("mpc rounds", dict(mpc_rounds=1)),
        ("wbc iters", dict(wbc_iters=30)),
        ("wbc rounds", dict(wbc_rounds=2)),
        ("estimator", dict(use_estimator=True)),
        ("mocap", dict(use_estimator=True, est_mocap=True)),
        ("payload", dict(payload=True)),
        ("payload unknown", dict(payload=True, payload_known=False)),
    ]


def _runner(batch=B, cfg=None, payload=False, use_estimator=False, **kw):
    cfg = cfg or EngineConfig()
    cc = engine.CascadeConfigured(SOLO12, cfg)
    q0 = standing_q0(batch)
    gid = np.zeros(batch, np.int32)
    ctl = engine.init_controller(SOLO12, cfg, cc.tree, q0, gid, device="cpu")
    return graphed.period_runner(
        cc, ctl, PlantState.init(q0, device="cpu"), gid,
        ContactParams.default(batch, device="cpu"),
        est=estimator_init(q0, device="cpu") if use_estimator else None,
        use_estimator=use_estimator,
        payload=torch.zeros(batch) if payload else None, device="cpu", **kw)


def test_runner_cache_key():
    """Identical configurations share one runner (an explicit default is
    the default); each field of the key makes another; the cache keeps at
    most MAX_RUNNERS, closing the least recently used."""
    graphed.clear_runners()
    base = _runner()
    cfg = EngineConfig()
    assert _runner() is base
    assert _runner(mpc_backend=cfg.solver.mpc_backend,
                   wbc_iters=cfg.solver.wbc_iters,
                   payload_known=True) is base
    seen = [base]
    for name, kw in _key_variants():
        r = _runner(**kw)
        assert all(r is not s for s in seen), name
        seen.append(r)
        assert len(graphed.cached_runners()) <= graphed.MAX_RUNNERS
    assert graphed.cached_runners() == seen[-graphed.MAX_RUNNERS:]
    assert base.call.closed and not seen[-1].call.closed
    with pytest.raises(RuntimeError, match="closed"):
        base(torch.zeros(B, 3))
    # a recently used runner is the last to go
    keep = seen[-graphed.MAX_RUNNERS]
    assert _runner(**_key_variants()[-graphed.MAX_RUNNERS][1]) is keep
    _runner()
    assert keep in graphed.cached_runners()
    graphed.clear_runners()
    assert graphed.cached_runners() == [] and keep.call.closed
    with pytest.raises(TypeError, match="unexpected"):
        _runner(wbc_budget=3)


def test_the_rollout_refuses_what_the_eager_one_refuses():
    cc, ctl, plant, gid, cp = _inputs()
    v = np.zeros((B, 2, 3), np.float32)
    with pytest.raises(ValueError, match="periods"):
        graphed.cascade_rollout_graphed(cc, ctl, plant, gid, v, cp,
                                        n_periods=3, device="cpu")
    with pytest.raises(ValueError, match="EstimatorState"):
        graphed.cascade_rollout_graphed(cc, ctl, plant, gid, v, cp,
                                        n_periods=2, use_estimator=True,
                                        device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            graphed.cascade_rollout_graphed(cc, ctl, plant, gid, v, cp,
                                            n_periods=2)


def test_captured_call_on_the_cpu_runs_eagerly_and_closes():
    buf = torch.zeros(3)

    def bump(x):
        x.add_(1.0)
        return x

    call = CapturedCall(bump, {"x": buf}, "cpu", "bump")
    assert call.graph is None and call.capture_seconds == 0.0
    assert call.pool_bytes == 0
    assert call(x=torch.ones(3)) is buf and buf.tolist() == [2.0] * 3
    call.close()
    with pytest.raises(RuntimeError, match="'bump' was closed"):
        call()


# --- the entry points go through the runner (counted, not read) ----------

def _only_runner():
    (runner,) = graphed.cached_runners()
    return runner


def test_run_cli_goes_through_the_runner(capsys):
    from mpctsid_tpu_torch import run
    graphed.clear_runners()
    assert run.main(["--cpu", "--seconds", "0.02"]) == 0
    assert _only_runner().replays == 1
    out = capsys.readouterr().out
    assert "ticks/s without it" in out and "capture" in out


def test_run_sweep_goes_through_the_runner():
    from mpctsid_tpu_torch.sweep import SweepState, run_sweep
    graphed.clear_runners()
    st = run_sweep(SweepState.fresh(3, 4, 1), 2, verbose=False,
                   device="cpu")
    assert st.cursor == 4
    runner = _only_runner()
    assert runner.replays == 2                     # two chunks, one runner
    assert runner.buffers["ctl.phase"].shape == (2,)


def test_sharded_rollout_goes_through_the_runner(tmp_path):
    from mpctsid_tpu_torch.dist import (init_scenario_group,
                                        sharded_cascade_rollout)
    graphed.clear_runners()
    cc, ctl, plant, gid, cp = _inputs()
    group = init_scenario_group("cpu", f"file://{tmp_path}/store", 0, 1)
    try:
        run = sharded_cascade_rollout(cc, 1, group=group, device="cpu")
        _, _, metrics, summary = run(ctl, plant, gid,
                                     np.asarray(V_CONST, np.float32), cp)
    finally:
        dist.destroy_process_group()
    assert _only_runner().replays == 1
    assert int(summary["n_total"]) == B and metrics["x_srb"].shape[:2] == (
        B, 1)
