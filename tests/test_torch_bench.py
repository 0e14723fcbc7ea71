"""The port's bench (mpctsid_tpu_torch/bench.py) against the JAX bench
(bench.py at the repository root) on the CPU.

The JAX bench's timed rollouts compile the whole cascade; these tests never
run them.  Where the JAX bench's guards are needed, `cascade_rollout` is
replaced (pytest's monkeypatch, on the JAX package's `cascade` module, which
the JAX bench imports when it is called) by a stub that makes a metrics
table from its inputs: the guards of both benches then read one table.  The
port's own rollouts run on `device="cpu"` at B = 2-4 and a few periods.
"""

import hashlib
import json
import math
import os
import tempfile
from pathlib import Path

import numpy as np
import pytest

# the JAX bench sets its compile cache at import (setdefault): keep it in a
# temporary directory
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(tempfile.gettempdir(), "jax_test_cache"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench as jbench  # noqa: E402
import mpctsid_tpu.cascade as jcascade  # noqa: E402
from mpctsid_tpu.config import EngineConfig as JEngineConfig  # noqa: E402
from mpctsid_tpu_torch import bench  # noqa: E402
from mpctsid_tpu_torch.cascade import graphed  # noqa: E402
from mpctsid_tpu_torch.config import EngineConfig  # noqa: E402

from _torch_port_util import fields_to_numpy, npy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the JAX package's records, which no run of the port's bench may touch
RECORDS = ("RESULTS.md", "BENCH_DETAIL.json", "MULTIHOST_32K.json",
           "ROOFLINE.json")
GUARD_KEYS = {"upright_frac", "mean_vx_err", "vx_track_frac", "mean_mpc_res",
              "mean_mpc_dual_res", "wbc_ok_frac", "mpc_fail_frac"}
MIX = ["trot", "walk", "bound", "static"]

VARIANTS = {
    "plain": dict(),
    "gait_mix": dict(gait_mix=MIX),
    "mu_spread": dict(mu_spread=True),
    "payload_spread": dict(payload_spread=True),
}


def _digests() -> dict:
    return {name: hashlib.sha256((ROOT / name).read_bytes()).hexdigest()
            for name in RECORDS}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_build_batch_matches_the_jax_bench(variant):
    """B = 16.  The numpy draws (gait ids, commands, friction, payload) are
    the same numbers: bit for bit.  The controller state is computed by two
    packages' float32 kinematics (foot positions, the gravity warm start):
    1e-6, the budget of the port's init_controller against the JAX one."""
    kw = VARIANTS[variant]
    jcc, jargs = jbench.build_batch(JEngineConfig(), 16, **kw)
    cc, args = bench.build_batch(EngineConfig(), 16, device="cpu", **kw)
    assert len(args) == len(jargs) == (6 if "payload_spread" in kw else 5)
    ctl, plant, gid, vc, cp = args[:5]
    jctl, jplant, jgid, jvc, jcp = jargs[:5]
    np.testing.assert_array_equal(npy(gid), np.asarray(jgid))
    np.testing.assert_array_equal(npy(vc), np.asarray(jvc))
    for name, want in fields_to_numpy(jcp).items():
        np.testing.assert_array_equal(npy(getattr(cp, name)), want,
                                      err_msg=name)
    if len(args) == 6:
        np.testing.assert_array_equal(npy(args[5]), np.asarray(jargs[5]))
    for name, want in fields_to_numpy(jplant).items():
        np.testing.assert_array_equal(npy(getattr(plant, name)), want,
                                      err_msg=name)
    got = fields_to_numpy(ctl)
    for name, want in fields_to_numpy(jctl).items():
        np.testing.assert_allclose(got[name], want, rtol=0, atol=1e-6,
                                   err_msg=name)
    assert cc.cfg == EngineConfig() and cc.model.total_mass == pytest.approx(
        jcc.model.total_mass)


def _stub_rollout(cc, ctl, plant, gid, v_cmd, cp, n_periods, payload=None):
    """A stand-in for the JAX cascade_rollout of ONE scenario: a metrics
    table made from the command, the gait id and the period index, with
    bound scenarios fallen by the end, some walk solves failed and some
    trot WBC ticks failed."""
    k = jnp.arange(n_periods, dtype=jnp.float32)
    g = gid.astype(jnp.float32)
    rise = 1.0 - jnp.exp(-k / 6.0)
    height = jnp.where((gid == 2) & (k >= n_periods - 2), 0.1, 0.24)
    yaw = 0.02 * k * v_cmd[2]
    x = jnp.zeros((n_periods, 12), jnp.float32)
    x = x.at[:, 2].set(height).at[:, 5].set(yaw)
    x = x.at[:, 6].set(v_cmd[0] * rise * jnp.cos(yaw) * (0.8 + 0.05 * g))
    x = x.at[:, 7].set(v_cmd[0] * rise * jnp.sin(yaw) + 0.01 * v_cmd[1])
    metrics = {
        "x_srb": x,
        "mpc_prim_res": 1e-6 * (k + 1.0) * (1.0 + g),
        "mpc_dual_res": 1e-5 / (k + 1.0) * (1.0 + v_cmd[0]),
        "mpc_ok": ~((gid == 1) & (jnp.arange(n_periods) % 7 == 3)),
        "wbc_ok_frac": 1.0 - 0.05 * (gid == 0) * (jnp.arange(n_periods) % 2),
    }
    return ctl, plant, metrics


@pytest.mark.parametrize("mix", [MIX, ["static"]], ids=["mixed", "standing"])
def test_guards_equal_the_jax_bench_on_one_metrics_table(monkeypatch, mix):
    """The JAX measure_cascade's guards over the stub's table and the port's
    cascade_guards over the same table: every key equal (the same numpy
    arithmetic on the same float32 numbers).  "standing": no scenario has
    a command, vx_track_frac is the 1.0 of an empty set."""
    monkeypatch.setattr(jcascade, "cascade_rollout", _stub_rollout)
    cc, args = jbench.build_batch(JEngineConfig(), 16, gait_mix=mix)
    _, want = jbench.measure_cascade(cc, args, periods=5, reps=1)
    # the table the JAX guards read: the same jitted program at their window
    table = jax.jit(jax.vmap(lambda *a: _stub_rollout(
        cc, *a, n_periods=max(6, bench.GUARD_PERIODS))))(*args)[2]
    got = bench.cascade_guards({k: np.asarray(v) for k, v in table.items()},
                               np.asarray(args[3]))
    assert set(got) == set(want) == GUARD_KEYS
    assert got == want
    if mix == MIX:
        assert got["upright_frac"] < 1.0 and got["mpc_fail_frac"] > 0.0
        assert got["wbc_ok_frac"] < 1.0 and 0.0 < got["vx_track_frac"] < 1.0
    else:
        assert got["vx_track_frac"] == 1.0


def test_mpc_qp_batch_matches_the_jax_bench():
    """B = 4 over four gaits: the condensed QPs of the batch's initial
    states, to tests/test_torch_mpc.py's budget for build_mpc_qp (atol 1e-5,
    the budget the JAX package's own tests give its assembly against the
    oracle; the 1e6 ridge-pinned diagonal relatively, one f32 ulp there is
    0.06; the constraint rows bit for bit)."""
    mix = ["trot", "walk", "bound", "pace"]
    jcc, jargs = jbench.build_batch(JEngineConfig(), 4, gait_mix=mix)
    cc, args = bench.build_batch(EngineConfig(), 4, gait_mix=mix,
                                 device="cpu")
    P, q, A, l, u = [npy(t) for t in bench._mpc_qp_batch(cc, args)]
    Pj, qj, Aj, lj, uj = [np.asarray(t)
                          for t in jbench._mpc_qp_batch(jcc, jargs)]
    assert P.shape == (4, 192, 192) and A.shape == (4, 320, 192)
    np.testing.assert_allclose(q, qj, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(A, Aj)
    np.testing.assert_array_equal(l, lj)
    np.testing.assert_array_equal(u, uj)
    off = ~np.eye(192, dtype=bool)
    assert np.abs((P - Pj)[:, off]).max() < 1e-5
    dP = np.diagonal(P, axis1=1, axis2=2)
    dPj = np.diagonal(Pj, axis1=1, axis2=2)
    pinned = dPj > 1e5
    assert pinned.any() and (~pinned).any()
    np.testing.assert_allclose(dP[pinned], dPj[pinned], rtol=2e-7)
    np.testing.assert_allclose(dP[~pinned], dPj[~pinned], rtol=0, atol=1e-5)


def test_measure_cascade_on_the_cpu_goes_through_the_runner(monkeypatch):
    """B = 4, one timed period, one rep, a guard window of 2 periods: the
    row has the JAX bench's guard keys and finite values, and every rollout
    (2 warm-up, 2 timed, 1 guard: 8 periods) replayed the one runner."""
    monkeypatch.setattr(bench, "GUARD_PERIODS", 2)
    graphed.clear_runners()
    cc, args = bench.build_batch(EngineConfig(), 4, device="cpu")
    tps, guards = bench.measure_cascade(cc, args, periods=1, reps=1)
    assert set(guards) == GUARD_KEYS
    assert math.isfinite(tps) and tps > 0
    assert all(math.isfinite(v) for v in guards.values())
    (runner,) = graphed.cached_runners()
    assert runner.replays == (1 + 2) * 2 + 2
    graphed.clear_runners()


def test_the_cli_prints_the_jax_headline_keys_and_writes_nothing_else(
        monkeypatch, tmp_path, capsys):
    """main(["--cpu", "--out", DIR]) at B = 2, one timed period, a guard
    window of 2: the last line of stdout is one JSON object with the keys of
    the JAX bench's headline (run here over the stub rollout); the working
    directory and DIR stay empty, the JAX package's records byte-identical."""
    monkeypatch.setattr(jcascade, "cascade_rollout", _stub_rollout)
    want, _ = jbench.headline()

    measure = bench.measure_cascade
    monkeypatch.setattr(bench, "CPU_B", 2)
    monkeypatch.setattr(bench, "GUARD_PERIODS", 2)
    monkeypatch.setattr(bench, "measure_cascade",
                        lambda cc, args, periods=5, reps=3: measure(
                            cc, args, periods=1, reps=1))
    cwd, out = tmp_path / "cwd", tmp_path / "out"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    before, listing = _digests(), sorted(os.listdir(ROOT))
    assert bench.main(["--cpu", "--out", str(out)]) == 0
    graphed.clear_runners()
    last = capsys.readouterr().out.strip().splitlines()[-1]
    row = json.loads(last)
    assert set(row) == set(want)
    assert row["unit"] == want["unit"] == "solves/s"
    assert "B=2, trot" in row["metric"]
    assert row["vs_baseline"] == round(row["value"] / bench.TARGET, 2)
    assert all(math.isfinite(v) for k, v in row.items()
               if k not in ("metric", "unit"))
    assert os.listdir(cwd) == [] and not out.exists()
    assert _digests() == before and sorted(os.listdir(ROOT)) == listing


def test_write_results_renders_no_roofline_and_no_multihost_row(tmp_path):
    """RESULTS_TORCH.md and BENCH_DETAIL_TORCH.json, and nothing else, in
    the given directory: the preset rows as given, no TPU roofline section
    (ROOFLINE.json holds a TPU's peaks) and no MULTIHOST_32K.json row (a
    JAX CPU-mesh run)."""
    before = _digests()
    head = {"config": "headline_B16_trot", "metric": "m", "value": 1.0,
            "unit": "solves/s", "upright_frac": 1.0}
    rows = [{"config": "config2_gait_sweep", "metric": "cascade ticks/s",
             "value": 2.5, "unit": "solves/s", "wbc_ok_frac": 1.0}]
    bench.write_results(head, rows, tmp_path / "o", device="cpu")
    assert sorted(os.listdir(tmp_path / "o")) == [
        "BENCH_DETAIL_TORCH.json", "RESULTS_TORCH.md"]
    text = (tmp_path / "o" / "RESULTS_TORCH.md").read_text()
    assert "config2_gait_sweep" in text and "headline_B16_trot" in text
    assert "oofline" not in text and "multihost" not in text.lower()
    assert "CPU" in text
    detail = json.loads((tmp_path / "o" / "BENCH_DETAIL_TORCH.json")
                        .read_text())
    assert detail == {"headline": head, "presets": rows}
    assert _digests() == before


def test_config5_runs_two_gloo_processes_with_the_jax_stand_ins_keys():
    """measure_sharded at B = 4 on the CPU: two gloo processes of two
    scenarios each, timed 3 periods against 1; rank 0's line has the keys
    of scripts/bench_sharded_cpu.py, every scenario counted and upright."""
    row = bench.measure_sharded(4, "cpu")
    assert set(row) == {"ticks_per_s", "batch", "n_devices", "protocol",
                        "upright_frac", "max_mpc_prim_res", "n_mpc_fail"}
    assert row["batch"] == 4 and row["n_devices"] == 2
    assert row["protocol"] == "differential 3-vs-1 period"
    assert row["upright_frac"] == 1.0 and row["n_mpc_fail"] == 0.0
    assert math.isfinite(row["ticks_per_s"]) and row["ticks_per_s"] > 0
