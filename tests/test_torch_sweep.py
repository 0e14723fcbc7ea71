"""Port parity for sweep.py: Monte-Carlo scenario sweeps with checkpoints.

`scenario_params` is pure numpy and is held equal to the JAX package's value
by value; the checkpoint round-trips; an interrupted and resumed sweep equals
the uninterrupted one bit for bit within the port; the padded tail never
reaches the stored metrics; and one small sweep (8 scenarios of mixed gaits,
commands, friction and payload, chunks of 4, 2 periods) is held against the
JAX package's `run_sweep` on the same draws.
"""

import json
import os

import numpy as np
import pytest
import torch

import mpctsid_tpu.sweep as jsweep
from mpctsid_tpu_torch import sweep as tsweep
from mpctsid_tpu_torch.sweep import (METRIC_KEYS, SweepState, run_sweep,
                                     scenario_params, summarize)

import _torch_port_util  # noqa: F401  (pins torch to one thread)

TOTAL = 8
CHUNK = 4
PERIODS = 2
SEED = 7


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_scenario_params_equal_jax_value_by_value(seed):
    idx = np.arange(3, 40)
    got = scenario_params(seed, idx)
    want = jsweep.scenario_params(seed, idx)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert tsweep.METRIC_KEYS == jsweep.METRIC_KEYS


def test_scenario_params_chunk_invariant():
    """Per-scenario draws depend only on (seed, index), never on chunking."""
    whole = scenario_params(SEED, np.arange(12))
    a = scenario_params(SEED, np.arange(0, 5))
    b = scenario_params(SEED, np.arange(5, 12))
    for w, x, y in zip(whole, a, b):
        np.testing.assert_array_equal(np.concatenate([x, y]), w)
    p_all = whole[3]
    assert p_all.min() >= 0.0 and p_all.max() <= 0.4 and p_all.std() > 0.05


def test_sweep_state_round_trip(tmp_path):
    """to_bytes / from_bytes and save / load keep every field, NaN tails
    included, bit for bit; save replaces the file atomically and leaves no
    temporary behind; loaded arrays are writable copies."""
    st = SweepState.fresh(SEED, 10, 3)
    assert list(st.metrics) == METRIC_KEYS and st.cursor == 0
    assert all(v.dtype == np.float32 and np.isnan(v).all()
               for v in st.metrics.values())
    r = np.random.default_rng(0)
    for k in METRIC_KEYS:
        st.metrics[k][:6] = r.normal(size=6)
    st.cursor = 6
    back = SweepState.from_bytes(st.to_bytes())
    path = str(tmp_path / "s.npz")
    st.save(path)
    st.save(path)                                  # replaces, no error
    assert os.listdir(tmp_path) == ["s.npz"]
    for other in (back, SweepState.load(path)):
        assert (other.seed, other.total, other.cursor, other.n_periods) == \
            (SEED, 10, 6, 3)
        assert list(other.metrics) == METRIC_KEYS
        for k in METRIC_KEYS:
            assert other.metrics[k].dtype == np.float32
            np.testing.assert_array_equal(_bits(other.metrics[k]),
                                          _bits(st.metrics[k]))
            other.metrics[k][0] = 1.0              # writable


def test_checkpoint_is_a_numpy_archive_and_not_the_jax_packages_format():
    """The port's checkpoint is an .npz archive; the JAX package's is flax
    msgpack.  Same fields, different files: neither package reads the
    other's."""
    st = SweepState.fresh(1, 4, 2)
    data = st.to_bytes()
    assert data[:2] == b"PK"                       # a zip archive
    with pytest.raises(Exception):
        jsweep.SweepState.from_bytes(data)
    with pytest.raises(Exception):
        SweepState.from_bytes(jsweep.SweepState.fresh(1, 4, 2).to_bytes())


@pytest.fixture(scope="module")
def port_sweep():
    st = run_sweep(SweepState.fresh(SEED, TOTAL, PERIODS), CHUNK,
                   verbose=False, device="cpu")
    assert st.cursor == TOTAL
    return st


def test_interrupt_resume_bitwise(tmp_path, port_sweep):
    ckpt = str(tmp_path / "sweep.npz")
    st = run_sweep(SweepState.fresh(SEED, TOTAL, PERIODS), CHUNK,
                   ckpt_path=ckpt, max_chunks=1, verbose=False, device="cpu")
    assert st.cursor == CHUNK and os.path.exists(ckpt)
    del st
    resumed = SweepState.load(ckpt)
    assert resumed.cursor == CHUNK
    assert np.isnan(resumed.metrics["final_z"][CHUNK:]).all()
    resumed = run_sweep(resumed, CHUNK, ckpt_path=ckpt, verbose=False,
                        device="cpu")
    assert resumed.cursor == TOTAL
    for k in METRIC_KEYS:
        np.testing.assert_array_equal(_bits(resumed.metrics[k]),
                                      _bits(port_sweep.metrics[k]), err_msg=k)
    on_disk = SweepState.load(ckpt)
    assert on_disk.cursor == TOTAL
    s = summarize(resumed)
    assert s["scenarios"] == TOTAL and s["upright_frac"] == 1.0


def test_tail_padding_does_not_leak(port_sweep):
    """total not divisible by chunk: the tail chunk is padded to the chunk's
    shape by repeating the last scenario, and no padding reaches the table.
    The first 6 scenarios in chunks of 4 (4 + 2 padded to 4) against the
    same scenarios in one chunk of 6 and against the 8-scenario sweep."""
    st = run_sweep(SweepState.fresh(SEED, 6, PERIODS), 4, verbose=False,
                   device="cpu")
    assert st.cursor == 6
    assert all(v.shape == (6,) and not np.isnan(v).any()
               for v in st.metrics.values())
    one = run_sweep(SweepState.fresh(SEED, 6, PERIODS), 6, verbose=False,
                    device="cpu")
    for k in METRIC_KEYS:
        # the first chunk is the 8-scenario sweep's first chunk, bit for bit
        np.testing.assert_array_equal(_bits(st.metrics[k][:4]),
                                      _bits(port_sweep.metrics[k][:4]),
                                      err_msg=k)
        # chunk 4 against chunk 6, as the JAX package's own test asserts for
        # JAX: every scenario is computed by per-scenario arithmetic (batched
        # products of one scenario's matrices, elementwise masks), so the
        # batch size does not change a bit on the CPU
        np.testing.assert_array_equal(_bits(st.metrics[k]),
                                      _bits(one.metrics[k]), err_msg=k)


@pytest.fixture(scope="module")
def jax_sweep():
    st = jsweep.run_sweep(jsweep.SweepState.fresh(SEED, TOTAL, PERIODS),
                          CHUNK, verbose=False)
    assert st.cursor == TOTAL
    return st


# after two periods (40 ticks) from standing the two packages' plants sit
# within the one-period budgets of tests/test_torch_cascade.py (q 2e-3; base
# velocity 5e-2, which the WBC's chaotic f32 noise sets)
SWEEP_ATOL = {"final_z": 2e-3, "final_x": 2e-3, "vx_err": 5e-2,
              "max_mpc_res": 1e-3, "min_wbc_ok_frac": 0.0}


def test_small_sweep_matches_jax_run_sweep(port_sweep, jax_sweep):
    for k in ("upright", "mpc_fail"):
        np.testing.assert_array_equal(port_sweep.metrics[k],
                                      jax_sweep.metrics[k], err_msg=k)
    for k, atol in SWEEP_ATOL.items():
        np.testing.assert_allclose(port_sweep.metrics[k],
                                   jax_sweep.metrics[k], atol=atol,
                                   err_msg=k)
    s_t, s_j = summarize(port_sweep), summarize(jax_sweep)
    assert s_t["scenarios"] == s_j["scenarios"] == TOTAL
    assert s_t["upright_frac"] == s_j["upright_frac"]
    assert s_t["mpc_fail_total"] == s_j["mpc_fail_total"]


def test_summarize_of_an_empty_and_a_partial_sweep():
    st = SweepState.fresh(0, 4, 2)
    assert summarize(st) == {"scenarios": 0, "upright_frac": 0.0,
                             "mean_vx_err": 0.0, "max_mpc_res": 0.0,
                             "mpc_fail_total": 0.0}
    st.metrics["upright"][:2] = [1.0, 0.0]
    st.metrics["vx_err"][:2] = [0.1, 0.3]
    st.metrics["max_mpc_res"][:2] = [1e-3, 2e-3]
    st.metrics["mpc_fail"][:2] = [0.0, 2.0]
    st.cursor = 2
    s = summarize(st)
    assert s["scenarios"] == 2 and s["upright_frac"] == 0.5
    assert s["mean_vx_err"] == pytest.approx(0.2)
    assert s["max_mpc_res"] == pytest.approx(2e-3)
    assert s["mpc_fail_total"] == 2.0


def test_cli_on_the_cpu_writes_a_checkpoint_and_resumes(tmp_path, capsys):
    ckpt, out = str(tmp_path / "c.npz"), str(tmp_path / "r.jsonl")
    argv = ["--cpu", "--total", "3", "--chunk", "2", "--periods", "1",
            "--seed", "5", "--ckpt", ckpt, "--jsonl", out]
    assert tsweep.main(argv) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["scenarios"] == 3 and first["upright_frac"] == 1.0
    rows = [json.loads(line) for line in open(out)]
    assert [r["scenario"] for r in rows] == [0, 1, 2]
    assert set(rows[0]) == {"scenario", *METRIC_KEYS}
    # a finished checkpoint resumes to the same summary without running
    assert tsweep.main(argv + ["--resume"]) == 0
    captured = capsys.readouterr()
    assert "resuming at 3/3" in captured.err
    assert json.loads(captured.out.strip().splitlines()[-1]) == first


def test_run_sweep_defaults_to_the_gpu_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        run_sweep(SweepState.fresh(0, 2, 1), 2, verbose=False)
    with pytest.raises(RuntimeError, match="cuda"):
        tsweep.main(["--total", "2", "--chunk", "2", "--periods", "1"])
