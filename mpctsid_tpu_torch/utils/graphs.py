"""A fixed-shape device call captured as one CUDA graph (the port's
counterpart of `jax.jit` with donated arguments on a fixed-shape call).

    call = CapturedCall(fn, {"x": x_buf, "warm": warm_buf}, device, "wbc")
    out = call(x=new_x)      # copy_ into the static inputs, replay

`fn(**static_inputs)` must take and return tensors of fixed shapes and may
write into its inputs in place: a warm start written back into the buffer
that the next call reads is what donation is in the JAX package.  On CUDA:

  * `fn` runs once eagerly on a side stream first.  Three caches fill at
    first use with host-to-device copies or builds, which a capture cannot
    contain: `utils.device_constant`, the rigid-body constants
    (`dyn/rigid_body.py::_CONSTS_CACHE`) and the kernel libraries
    (`qp/kernels.py::_library`, which may start `nvcc`).  The static inputs
    are restored after this warm-up, so it leaves no trace in the state.
  * then the garbage collector runs, and one `torch.cuda.CUDAGraph` is
    captured, on a memory pool of its own; a capture that fails raises,
    naming the call.  (A dropped controller's graphs sit in reference
    cycles until a collection frees them; one that ran during a capture
    would tear a graph down mid-capture, and the capture fails with
    cudaErrorStreamCaptureInvalidated.  `torch.cuda.graph` no longer
    collects first by default, so this module does.)  There is no eager
    fallback on the card and no switch to turn capture off.
  * `__call__(**new_values)` copies the new values into the static inputs
    (on the current stream), replays the graph on the current stream and
    returns the static outputs.  The caller copies out what it keeps before
    the next replay overwrites them.
  * `capture_seconds` is the wall time of warm-up, capture and
    instantiation, up to a synchronize; `pool_bytes` what the caching
    allocator reserved over the capture (the graph's pool: it keeps the
    eager call's peak for the graph's lifetime).  `close()` drops the graph
    and its outputs, so that `torch.cuda.empty_cache()` can hand the pool
    back; a closed call refuses to run.

On the CPU there is no graph: `__call__` copies the new values in the same
way and calls `fn` eagerly, so the same caller code runs in the tests.

Python numbers inside `fn` are baked into the graph at capture: whatever
changes from call to call must be a tensor among the static inputs.  The
kernels' launch counters count Python calls, so a replay does not move them;
they move at the warm-up and the capture.
"""

from __future__ import annotations

import gc
import time
from typing import Callable

import torch

__all__ = ["CapturedCall"]


class CapturedCall:
    """`fn` over fixed static input buffers; one CUDA graph on the card."""

    def __init__(self, fn: Callable, static_inputs: dict, device,
                 name: str = None):
        self.fn = fn
        self.inputs = dict(static_inputs)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.name = name or getattr(fn, "__name__", "call")
        for key, t in self.inputs.items():
            if not isinstance(t, torch.Tensor) or t.device != self.device:
                raise ValueError(f"{self.name}: static input {key!r} must "
                                 f"be a tensor on {self.device}")
        self.graph = None
        self.outputs = None
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        self.closed = False
        if self.device.type == "cuda":
            self._capture()

    def _capture(self) -> None:
        dev = self.device
        t0 = time.perf_counter()
        saved = {k: t.clone() for k, t in self.inputs.items()}
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.fn(**self.inputs)
            for k, t in self.inputs.items():
                t.copy_(saved[k])
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        gc.collect()
        # `torch.cuda.graph` empties the allocator's cache on entry; do it
        # first, so that the growth of reserved memory is the graph's pool
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                outputs = self.fn(**self.inputs)
        except Exception as e:
            raise RuntimeError(
                f"capturing {self.name!r} as a CUDA graph failed: {e}") from e
        torch.cuda.synchronize(dev)
        self.graph = graph
        self.outputs = outputs
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_seconds = time.perf_counter() - t0

    def close(self) -> None:
        """Drop the graph and its static outputs (the pool goes back to the
        caching allocator with them)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = None
        self.outputs = None
        self.closed = True

    def __call__(self, **new_values):
        if self.closed:
            raise RuntimeError(f"{self.name!r} was closed")
        for key, value in new_values.items():
            self.inputs[key].copy_(value, non_blocking=True)
        if self.graph is None:
            return self.fn(**self.inputs)
        self.graph.replay()
        return self.outputs
