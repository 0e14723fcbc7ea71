"""The port's native real-time runtime (mpctsid_tpu_torch/native/): the JAX
package's eight tests of tests/test_native_runtime.py, run against the port's
own loader, plus the port's copy of the source held byte-equal to
native/rt_runtime.cc and built where the port builds, never into the JAX
loader's file."""

import hashlib
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from mpctsid_tpu_torch.native import (PlanBuffer, RtExecutor, TelemetryRing,
                                      ensure_built)
from mpctsid_tpu_torch.native import runtime

ROOT = Path(__file__).resolve().parents[1]


def test_source_is_a_byte_equal_copy_of_native_rt_runtime():
    assert runtime.SOURCE == ROOT / "mpctsid_tpu_torch" / "native" / \
        "rt_runtime.cc"
    assert runtime.SOURCE.read_bytes() == \
        (ROOT / "native" / "rt_runtime.cc").read_bytes()


def test_build_goes_to_the_port_build_dir_and_not_the_jax_loaders_file(
        tmp_path):
    """In a fresh interpreter with an empty build directory: the library is
    built there, named by the source's hash, and the JAX loader's
    mpctsid_tpu/native/_rt_runtime.so is neither created nor changed."""
    jax_so = ROOT / "mpctsid_tpu" / "native" / "_rt_runtime.so"

    def fingerprint():
        if not jax_so.exists():
            return None
        return (jax_so.stat().st_mtime_ns,
                hashlib.sha256(jax_so.read_bytes()).hexdigest())

    before = fingerprint()
    build = tmp_path / "build"
    code = ("from mpctsid_tpu_torch.native import runtime as r; "
            "r.ensure_built(); print(r.library_path())")
    env = dict(os.environ, MPCTSID_TORCH_BUILD_DIR=str(build))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    so = Path(out.stdout.strip().splitlines()[-1])
    assert so.parent == build and so.exists(), so
    assert so.name.startswith("librt_runtime-") and so.suffix == ".so"
    assert [p.name for p in build.iterdir()] == [so.name]
    assert fingerprint() == before


def test_builds_and_loads():
    lib = ensure_built()
    assert lib is not None
    assert ensure_built() is lib


def test_plan_buffer_basic_roundtrip():
    pb = PlanBuffer(192)
    pid, _ = pb.read_latest()
    assert pid == -1  # nothing published yet
    plan = np.arange(192, dtype=np.float32)
    pb.publish(plan, 7)
    pid, out = pb.read_latest()
    assert pid == 7
    np.testing.assert_array_equal(out, plan)


def test_plan_buffer_latest_wins():
    pb = PlanBuffer(16)
    for i in range(10):
        pb.publish(np.full(16, float(i), np.float32), i)
    pid, out = pb.read_latest()
    assert pid == 9
    assert np.all(out == 9.0)


def test_plan_buffer_concurrent_no_tearing():
    """Reader must never observe a torn plan (mixed halves of two writes)."""
    n = 4096
    pb = PlanBuffer(n)
    pb.publish(np.zeros(n, np.float32), 0)
    stop = threading.Event()
    torn = []

    def writer():
        i = 1
        while not stop.is_set():
            pb.publish(np.full(n, float(i), np.float32), i)
            i += 1

    def reader():
        while not stop.is_set():
            pid, out = pb.read_latest()
            if pid >= 0 and not np.all(out == out[0]):
                torn.append(pid)

    tw = threading.Thread(target=writer)
    tr = threading.Thread(target=reader)
    tw.start()
    tr.start()
    time.sleep(1.0)
    stop.set()
    tw.join(timeout=10)
    tr.join(timeout=10)
    assert not tw.is_alive() and not tr.is_alive()
    assert not torn, f"torn reads observed for plan ids {torn[:5]}"


def test_rt_executor_holds_period():
    ticks = []
    ex = RtExecutor(period_s=0.001)
    t0 = time.monotonic()
    ex.run(200, lambda k: ticks.append(k))
    wall = time.monotonic() - t0
    st = ex.stats
    assert st["ticks"] == 200
    assert ticks == list(range(200))
    # 200 ticks at 1 kHz = 0.2 s; generous bounds for a shared VM
    assert 0.15 < wall < 1.0
    assert st["mean_jitter_us"] < 5000.0


def test_one_solve_stale_pattern():
    """A slow producer + 1 kHz consumer: the consumer always sees the latest
    COMPLETED plan, never blocks, never sees a partial write."""
    pb = PlanBuffer(192)
    pb.publish(np.zeros(192, np.float32), 0)  # fallback plan
    seen = []

    def producer():
        for i in range(1, 6):
            time.sleep(0.02)  # 50 Hz MPC cadence
            pb.publish(np.full(192, float(i), np.float32), i)

    tp = threading.Thread(target=producer)
    tp.start()
    ex = RtExecutor(period_s=0.001)
    ex.run(120, lambda k: seen.append(pb.read_latest()[0]))
    tp.join(timeout=10)
    assert not tp.is_alive()
    ids = np.array(seen)
    assert ids[0] <= 1
    assert ids[-1] >= 4
    assert np.all(np.diff(ids) >= 0), "plan ids must be monotone"


def test_telemetry_ring_roundtrip_and_drop_count():
    tr = TelemetryRing(4, capacity=8)   # rounds to 8 slots
    for i in range(8):
        assert tr.push(np.full(4, float(i), np.float32))
    # ring full: further pushes are DROPPED (producer never blocks)
    assert not tr.push(np.zeros(4, np.float32))
    assert tr.dropped == 1
    out = tr.pop()
    assert out.shape == (8, 4)
    np.testing.assert_array_equal(out[:, 0], np.arange(8, dtype=np.float32))
    # drained: space again, FIFO order preserved across wrap
    assert tr.push(np.full(4, 99.0, np.float32))
    out = tr.pop()
    assert out.shape == (1, 4)
    assert out[0, 0] == 99.0


def test_telemetry_ring_concurrent_producer_consumer():
    """One producer pushing sequence-stamped records, one consumer draining:
    every record that is not counted dropped arrives exactly once, in
    order."""
    tr = TelemetryRing(2, capacity=64)
    N = 20000
    got = []
    stop = threading.Event()

    def consumer():
        while True:
            out = tr.pop(256)
            if out.size:
                got.append(out.copy())
            if stop.is_set():
                # the producer has finished: drain what is left, keeping it
                rest = tr.pop(256)
                if rest.size == 0:
                    break
                got.append(rest.copy())
            time.sleep(0)

    th = threading.Thread(target=consumer)
    th.start()
    pushed = []
    for i in range(N):
        rec = np.asarray([i, 2 * i], np.float32)
        if tr.push(rec):
            pushed.append(i)
    stop.set()
    th.join(timeout=10)
    assert not th.is_alive()
    seq = np.concatenate([g[:, 0] for g in got]) if got else np.empty(0)
    assert len(seq) == len(pushed)
    np.testing.assert_array_equal(seq, np.asarray(pushed, np.float32))
