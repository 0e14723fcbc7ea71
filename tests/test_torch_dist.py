"""The port's scenario sharding (mpctsid_tpu_torch/dist/) and the entry
twins (mpctsid_tpu_torch/entry.py) on the CPU: the summary against the JAX
module's formulas (mpctsid_tpu/dist/mesh.py) written in numpy, a gloo group
of two processes against the unsharded rollout, and the dry run.

Every subprocess has a time limit of its own."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.dist import (scenario_summary, shard_scenarios,
                                    tree_map)
from mpctsid_tpu_torch.entry import _CHILD_ENV, dryrun_multichip, entry
from mpctsid_tpu_torch.model.solo12 import SOLO12

ROOT = Path(__file__).resolve().parents[1]
SUBPROCESS_TIMEOUT_S = 300


def _random_metrics(seed, B=7, periods=3):
    """Metrics of a rollout's shapes (numpy, seeded), with some scenarios
    fallen (z < 0.1), some failed MPC solves and uneven WBC success."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(B, periods, 12)).astype(np.float32)
    x[:, :, 2] = r.uniform(0.0, 0.3, size=(B, periods))
    x[:2, -1, 2] = (0.05, 0.25)          # at least one fallen, one upright
    ok = r.uniform(size=(B, periods)) > 0.1
    ok[0, 1], ok[1] = False, True        # at least one failed, one clean
    return {
        "x_srb": x,
        "tau_rms": r.uniform(0.1, 2.0, size=(B, periods)).astype(np.float32),
        "mpc_prim_res": r.uniform(0, 1e-3, size=(B, periods)).astype(
            np.float32),
        "mpc_ok": ok,
        "wbc_ok_frac": r.choice([0.9, 0.95, 1.0], size=(B, periods)).astype(
            np.float32),
    }


def _jax_module_summary(m):
    """mpctsid_tpu/dist/mesh.py:100-126 on one shard (psum, pmax, pmin the
    identity), written in numpy."""
    n_total = m["mpc_prim_res"].shape[0] * 1.0
    return {
        "mean_mpc_prim_res": m["mpc_prim_res"].sum() / (
            n_total * m["mpc_prim_res"].shape[1]),
        "max_mpc_prim_res": m["mpc_prim_res"].max(),
        "mean_tau_rms": m["tau_rms"].sum() / (
            n_total * m["tau_rms"].shape[1]),
        "n_upright": float((m["x_srb"][:, -1, 2] > 0.1).sum()),
        "n_mpc_fail": float(np.any(~m["mpc_ok"], axis=1).sum()),
        "min_wbc_ok_frac": m["wbc_ok_frac"].min(),
        "n_total": n_total,
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_summary_formulas_match_the_jax_module(seed):
    m = _random_metrics(seed)
    got = scenario_summary({k: torch.as_tensor(v) for k, v in m.items()},
                           lambda t, op: t)
    want = _jax_module_summary(m)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-6,
                                   err_msg=k)
    assert 0 < want["n_upright"] < 7 and 0 < want["n_mpc_fail"] < 7


def test_summary_over_two_shards_equals_the_whole_batch():
    """reduce() combining the shards' values (what all_reduce does) gives
    the whole batch's summary."""
    m = _random_metrics(3, B=8)
    halves = [{k: torch.as_tensor(v[i * 4:(i + 1) * 4]) for k, v in m.items()}
              for i in range(2)]
    # each shard's local values, reduced by hand in a first pass
    locals_ = [[] for _ in halves]
    for i, h in enumerate(halves):
        scenario_summary(h, lambda t, op, i=i: locals_[i].append(t) or t)
    ops = {"sum": lambda a, b: a + b, "max": torch.maximum,
           "min": torch.minimum}
    calls = iter(range(len(locals_[0])))

    def reduce(t, op):
        j = next(calls)
        return ops[op](locals_[0][j], locals_[1][j])

    got = scenario_summary(halves[0], reduce)
    want = _jax_module_summary(m)
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-6,
                                   err_msg=k)


def test_shard_scenarios_slices_every_leaf():
    fn, args = entry(device="cpu")
    part = shard_scenarios(args, 1, 4)
    for whole, piece in zip(tree_map(lambda x: x, args), part):
        leaves_w, leaves_p = [], []
        tree_map(leaves_w.append, whole)
        tree_map(leaves_p.append, piece)
        for w, p in zip(leaves_w, leaves_p):
            assert torch.equal(w[2:4], p)
    with pytest.raises(ValueError, match="do not split"):
        shard_scenarios(args, 0, 3)
    with pytest.raises(ValueError, match="disagree"):
        shard_scenarios((torch.zeros(4, 2), torch.zeros(3)), 0, 2)


_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from mpctsid_tpu_torch.config import EngineConfig
    from mpctsid_tpu_torch.dist import (init_scenario_group, shard_scenarios,
                                        shard_scenarios_multihost,
                                        sharded_cascade_rollout)
    from mpctsid_tpu_torch.entry import _example_batch
    from mpctsid_tpu_torch.model.solo12 import SOLO12

    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    group = init_scenario_group("cpu", init, rank, world)
    try:
        r = np.random.default_rng(5)
        B = 8
        vc = np.stack([r.uniform(0.0, 0.4, B), r.uniform(-0.1, 0.1, B),
                       r.uniform(-0.3, 0.3, B)], -1).astype(np.float32)
        cfg = EngineConfig(gait="trot", v_ref=(0.3, 0.0, 0.0))
        cc, args = _example_batch(B, cfg, SOLO12, "cpu", v_cmd=vc)
        args[4].mu = torch.as_tensor(r.uniform(0.5, 0.9, B),
                                     dtype=torch.float32)
        local = shard_scenarios_multihost(shard_scenarios(args, rank, world),
                                          group)
        ctl, plant, metrics, summary = sharded_cascade_rollout(
            cc, 1, group=group, device="cpu")(*local)
        uneven = shard_scenarios(args, 0, 2) if rank else \\
            shard_scenarios(args, 0, 4)
        try:
            shard_scenarios_multihost(uneven, group)
            refused = 0
        except ValueError:
            refused = 1
        np.savez(out, q=plant.q.numpy(), v=plant.v.numpy(),
                 f_plan=ctl.f_plan.numpy(), refused=refused,
                 **{"m_" + k: t.numpy() for k, t in metrics.items()},
                 **{"s_" + k: t.numpy() for k, t in summary.items()})
    finally:
        dist.destroy_process_group()
""")


def test_sharded_rollout_on_two_gloo_processes_equals_unsharded(tmp_path):
    """B = 8 as 2 x 4 on a gloo group of two processes, one period, against
    the unsharded B = 8 rollout in this process: per-scenario outputs bit
    for bit (no operation of the cascade reduces over scenarios), the
    summary within float32 rounding of the sums' order (1e-6 relative)."""
    from mpctsid_tpu_torch.cascade import cascade_rollout
    from mpctsid_tpu_torch.entry import _example_batch, _free_port

    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    init = f"tcp://localhost:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(rank), "2", init,
         str(tmp_path / f"rank{rank}.npz")], cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=open(tmp_path / f"err{rank}", "w"))
        for rank in range(2)]
    try:
        for p in procs:
            p.wait(timeout=SUBPROCESS_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"err{rank}").read_text()[-3000:]

    r = np.random.default_rng(5)
    B = 8
    vc = np.stack([r.uniform(0.0, 0.4, B), r.uniform(-0.1, 0.1, B),
                   r.uniform(-0.3, 0.3, B)], -1).astype(np.float32)
    cfg = EngineConfig(gait="trot", v_ref=(0.3, 0.0, 0.0))
    cc, args = _example_batch(B, cfg, SOLO12, "cpu", v_cmd=vc)
    args[4].mu = torch.as_tensor(r.uniform(0.5, 0.9, B), dtype=torch.float32)
    ctl, plant, metrics = cascade_rollout(cc, *args, n_periods=1,
                                          device="cpu")
    want = scenario_summary(metrics, lambda t, op: t)

    got = [np.load(tmp_path / f"rank{rank}.npz") for rank in range(2)]
    for key, whole in (("q", plant.q), ("v", plant.v),
                       ("f_plan", ctl.f_plan),
                       *((f"m_{k}", t) for k, t in metrics.items())):
        sharded = np.concatenate([g[key] for g in got])
        np.testing.assert_array_equal(sharded, whole.numpy(), err_msg=key)
    for k, t in want.items():
        for g in got:
            np.testing.assert_allclose(g[f"s_{k}"], t.numpy(), rtol=1e-6,
                                       err_msg=k)
    assert float(want["n_total"]) == 8.0
    assert [int(g["refused"]) for g in got] == [1, 1]


def test_entry_runs_one_cascade_period_on_the_cpu():
    fn, args = entry(device="cpu")
    x = fn(*args)
    assert tuple(x.shape) == (8, 12)
    assert bool(torch.isfinite(x).all())
    assert float((x[:, 2] - SOLO12.h_ref).abs().max()) < 0.03


def test_dryrun_multichip_two_gloo_processes(capfd):
    dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out
    assert "dryrun_multichip(2): OK" in out
    assert "4 upright" in out, out


def test_dryrun_multichip_refuses_without_the_cards_or_inside_a_rank(
        monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            dryrun_multichip(2)
    else:
        with pytest.raises(RuntimeError, match="cards"):
            dryrun_multichip(torch.cuda.device_count() + 1)
    monkeypatch.setenv(_CHILD_ENV, "1")
    with pytest.raises(RuntimeError, match="ranks of ranks"):
        dryrun_multichip(2, device="cpu")
