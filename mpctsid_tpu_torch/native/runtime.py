"""ctypes bindings for the native C++ real-time runtime (counterpart of the
JAX package's native/runtime.py, with its own copy of the source).

`rt_runtime.cc` beside this file is a copy of the repository's
`native/rt_runtime.cc` (tests/test_torch_native.py holds the two byte-equal):
plain C++17 with a C interface, no CUDA.  `ensure_built` compiles it at first
use with

    g++ -O2 -std=c++17 -shared -fPIC -o <build dir>/librt_runtime-<hash>.so \
        rt_runtime.cc -lpthread

into the port's build directory (`qp/_build.py::build_dir()`,
`build/mpctsid_tpu_torch/`, git-ignored); the file name carries a hash of the
source and the flags, so an edited source is never served by a stale build.
A missing compiler or a failed build raises, naming the command: there is no
fallback.  Importing this module builds nothing.

Three objects, the same classes and names as the JAX package's loader:
`PlanBuffer` (wait-free seqlock double buffer with one-solve-stale reads),
`TelemetryRing` (wait-free SPSC ring of fixed-size float records) and
`RtExecutor` (fixed-period executor with absolute deadlines and jitter
statistics).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["PlanBuffer", "TelemetryRing", "RtExecutor", "ensure_built",
           "library_path", "SOURCE", "GXX_FLAGS"]

SOURCE = Path(__file__).resolve().parent / "rt_runtime.cc"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB = None


def library_path() -> Path:
    """Where the built library lives: the port's build directory, the file
    name carrying a hash of the source and the flags."""
    from mpctsid_tpu_torch.qp._build import build_dir

    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return build_dir() / f"librt_runtime-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build the native runtime: {e} "
                           f"({' '.join(cmd)})") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed building the native runtime "
                           f"({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, so)


def ensure_built() -> ctypes.CDLL:
    """Compile (if this source's library is missing) and load the library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        lib.plan_buffer_create.restype = ctypes.c_void_p
        lib.plan_buffer_create.argtypes = [ctypes.c_int]
        lib.plan_buffer_destroy.argtypes = [ctypes.c_void_p]
        lib.plan_buffer_publish.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.plan_buffer_read.restype = ctypes.c_int64
        lib.plan_buffer_read.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.rt_executor_create.restype = ctypes.c_void_p
        lib.rt_executor_create.argtypes = [ctypes.c_int64]
        lib.rt_executor_destroy.argtypes = [ctypes.c_void_p]
        lib.rt_executor_run.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_int64),
            ctypes.c_void_p]
        lib.rt_executor_ticks.restype = ctypes.c_int64
        lib.rt_executor_ticks.argtypes = [ctypes.c_void_p]
        lib.rt_executor_overruns.restype = ctypes.c_int64
        lib.rt_executor_overruns.argtypes = [ctypes.c_void_p]
        lib.rt_executor_max_jitter_us.restype = ctypes.c_double
        lib.rt_executor_max_jitter_us.argtypes = [ctypes.c_void_p]
        lib.rt_executor_mean_jitter_us.restype = ctypes.c_double
        lib.rt_executor_mean_jitter_us.argtypes = [ctypes.c_void_p]
        lib.telemetry_ring_create.restype = ctypes.c_void_p
        lib.telemetry_ring_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.telemetry_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.telemetry_ring_push.restype = ctypes.c_int
        lib.telemetry_ring_push.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.telemetry_ring_pop.restype = ctypes.c_int
        lib.telemetry_ring_pop.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.telemetry_ring_dropped.restype = ctypes.c_int64
        lib.telemetry_ring_dropped.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


def _floats(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class PlanBuffer:
    """Wait-free SPSC double buffer with one-solve-stale read semantics."""

    def __init__(self, n: int):
        self._lib = ensure_built()
        self._n = n
        self._h = ctypes.c_void_p(self._lib.plan_buffer_create(n))

    def publish(self, plan: np.ndarray, plan_id: int) -> None:
        arr = np.ascontiguousarray(plan, dtype=np.float32).reshape(-1)
        if arr.size != self._n:
            raise ValueError(f"plan has {arr.size} floats, the buffer "
                             f"{self._n}")
        self._lib.plan_buffer_publish(self._h, _floats(arr), plan_id)

    def read_latest(self) -> tuple[int, np.ndarray]:
        """(id of the latest completed plan, -1 if none; the plan)."""
        out = np.empty(self._n, np.float32)
        pid = self._lib.plan_buffer_read(self._h, _floats(out))
        return int(pid), out

    def __del__(self):
        h = getattr(self, "_h", None)
        if h is not None:
            self._lib.plan_buffer_destroy(h)


class TelemetryRing:
    """Wait-free SPSC ring of fixed-size float records.

    The 1 kHz loop `push`es one record per tick: no allocation, lock or
    syscall, and it NEVER blocks (a full ring drops the record and counts
    it).  A logger thread `pop`s batches."""

    def __init__(self, record_len: int, capacity: int = 4096):
        self._lib = ensure_built()
        self._len = record_len
        self._h = ctypes.c_void_p(
            self._lib.telemetry_ring_create(record_len, capacity))

    def push(self, record: np.ndarray) -> bool:
        arr = np.ascontiguousarray(record, dtype=np.float32).reshape(-1)
        if arr.size != self._len:
            raise ValueError(f"record has {arr.size} floats, the ring "
                             f"{self._len}")
        return bool(self._lib.telemetry_ring_push(self._h, _floats(arr)))

    def pop(self, max_records: int = 1024) -> np.ndarray:
        """Drain up to max_records; returns an (n, record_len) array."""
        out = np.empty((max_records, self._len), np.float32)
        n = self._lib.telemetry_ring_pop(self._h, _floats(out), max_records)
        return out[:n]

    @property
    def dropped(self) -> int:
        return int(self._lib.telemetry_ring_dropped(self._h))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h is not None:
            self._lib.telemetry_ring_destroy(h)


class RtExecutor:
    """Fixed-period executor with absolute deadlines and jitter statistics."""

    _CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_int64)

    def __init__(self, period_s: float):
        self._lib = ensure_built()
        self._h = ctypes.c_void_p(
            self._lib.rt_executor_create(int(period_s * 1e9)))

    def run(self, ticks: int, callback) -> None:
        """callback(tick_index) is invoked at each period boundary."""
        cb = self._CB(lambda _user, k: callback(int(k)))
        self._lib.rt_executor_run(self._h, ticks, cb, None)

    @property
    def stats(self) -> dict:
        return {
            "ticks": int(self._lib.rt_executor_ticks(self._h)),
            "overruns": int(self._lib.rt_executor_overruns(self._h)),
            "max_jitter_us": float(
                self._lib.rt_executor_max_jitter_us(self._h)),
            "mean_jitter_us": float(
                self._lib.rt_executor_mean_jitter_us(self._h)),
        }

    def __del__(self):
        h = getattr(self, "_h", None)
        if h is not None:
            self._lib.rt_executor_destroy(h)
