"""The launch machinery of the MPC QP build kernel (mpc/csrc/mpc_build.cu
over mpc_build.h), wrapped by mpc/srb.py::build_mpc_qp.

The wrapper owns its packing (`srb.run_mpc_build`); this module knows the
kernel's C signature

    mpc_build_launch(dtype, B, N, in, stride, out, par, stream) -> rc

and its layout.  Each per-scenario input is handed over as its first row
and the stride between two scenarios' rows (0 for a row shared by every
scenario; dyn/kernels.py's `rows`), so that slices of a packed buffer (the
host path's snapshot) need no copy; the optional mass input may be a null
pointer.  `call` runs any launcher with that signature less the stream: the
CUDA library's (`launch`), or the CPU tests' host build of mpc_build.h.  A
launch goes on PyTorch's current stream and allocates its outputs through
PyTorch, so a CUDA graph captures it as it is; any failure raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from mpctsid_tpu_torch.plan.kernels import require_dtype

__all__ = ["LIBRARY", "CSRC", "LAYOUT", "LAUNCH_ARGTYPES", "NX", "BLK",
           "smem_values", "MpcBuildLayout", "mpc_build_layout", "call",
           "launch", "build_specs", "require_dtype"]

CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARY = ("mpc_build", ("mpc_build.cu",), ("mpc_build.h",))

# mpc_build.h's counts (`mpcb::layout`): inputs, outputs, parameters,
# threads a block.  The library is refused if its counts differ.
LAYOUT = dict(inputs=5, outputs=4, params=30, threads=384)
NX = 12
BLK = NX * NX

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
_DTYPE_BYTES = {torch.float32: 4, torch.float64: 8}

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
LAUNCH_ARGTYPES = [_INT, _INT, _INT, ctypes.POINTER(_PTR),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(_PTR),
                   ctypes.POINTER(ctypes.c_double)]


def smem_values(N: int) -> int:
    """Values of a block's shared memory at horizon N (`mpcb::smem_values`:
    Su's N (N + 1) / 2 blocks, the N W_j, S and S A_j, the N M_k, the
    drifts and the g_j)."""
    return (N * (N + 1) // 2 + N + 2) * BLK + 9 * N + 2 * NX * N


class MpcBuildLayout(NamedTuple):
    blocks: int             # one a scenario
    threads: int            # a block's
    smem_bytes: int         # a block's dynamic shared memory
    blocks_per_sm: int      # resident blocks a multiprocessor, by shared
                            # memory and threads


def mpc_build_layout(B: int, N: int, dtype, smem_optin: int,
                     smem_per_sm: int = 233472,
                     threads_per_sm: int = 2048) -> MpcBuildLayout:
    """The launch of B scenarios at horizon N in `dtype` on a device whose
    block may opt in to `smem_optin` bytes of shared memory (the SM's
    `smem_per_sm` less 1 KB a block reserved by the runtime): a block of
    LAYOUT["threads"] per scenario, all of Su in shared memory.  Raises
    ValueError when it does not fit (N > 18 in float64, N > 26 in float32
    on an H100)."""
    if B < 1 or N < 1:
        raise ValueError(f"B and N must be >= 1, got {B}, {N}")
    smem = smem_values(N) * _DTYPE_BYTES[dtype]
    if smem > smem_optin:
        raise ValueError(f"the MPC build at N = {N} in {dtype} needs {smem} "
                         f"bytes of shared memory a block, over the "
                         f"device's {smem_optin}")
    threads = LAYOUT["threads"]
    per_sm = max(1, min(smem_per_sm // (smem + 1024),
                        threads_per_sm // threads))
    return MpcBuildLayout(B, threads, smem, per_sm)


def call(launch_fn, dtype, B: int, N: int, ins, outs, par) -> int:
    """Run `launch_fn(dtype, B, N, in, stride, out, par) -> rc` on the
    operands: `ins` a list of (tensor or None, stride) in mpc_build.h's
    input order, `outs` the output tensors, `par` the scalar parameters."""
    return launch_fn(
        _DTYPE_CODE[dtype], B, N,
        (_PTR * len(ins))(*[None if t is None else t.data_ptr()
                            for t, _ in ins]),
        (ctypes.c_longlong * len(ins))(*[s for _, s in ins]),
        (_PTR * len(outs))(*[t.data_ptr() for t in outs]),
        (ctypes.c_double * len(par))(*[float(p) for p in par]))


def build_specs() -> list:
    """(name, sources, headers, source directory) of the library, for
    `qp/_build.py::build_libraries` (chip_smoke.py builds it beside the
    other kernels, every nvcc started together; it is otherwise built at
    its first launch)."""
    name, src, hdr = LIBRARY
    return [(name, src, hdr, CSRC)]


_LIBS: dict = {}


def _library():
    """The built library (builds it on first use), its layout checked
    against LAYOUT."""
    lib = _LIBS.get("mpc_build")
    if lib is None:
        from mpctsid_tpu_torch.qp import _build

        name, src, hdr = LIBRARY
        lib = _build.load_library(name, src, hdr, csrc=CSRC)
        lib.mpc_build_launch.argtypes = LAUNCH_ARGTYPES + [_PTR]
        lib.mpc_build_launch.restype = _INT
        lib.mpc_build_error_string.argtypes = [_INT]
        lib.mpc_build_error_string.restype = ctypes.c_char_p
        lib.mpc_build_layout.argtypes = [_INT]
        lib.mpc_build_layout.restype = _INT
        lib.mpc_build_smem_values.argtypes = [_INT]
        lib.mpc_build_smem_values.restype = ctypes.c_longlong
        got = [lib.mpc_build_layout(i) for i in range(len(LAYOUT))]
        if got != list(LAYOUT.values()):
            raise RuntimeError(f"mpc_build: the library's layout {got} is "
                               f"not mpc/kernels.py's {list(LAYOUT.values())}")
        _LIBS["mpc_build"] = lib
    return lib


def launch(run, dev: torch.device, *args, **kw):
    """`run(launch_fn, *args, **kw) -> (rc, out)` through the library's
    `mpc_build_launch` on the current stream of `dev`; returns `out`,
    raises on a launch error."""
    if dev.type != "cuda":
        raise RuntimeError(f"mpc_build runs on cuda or cpu, not {dev}")
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc, out = run(lambda *a: lib.mpc_build_launch(*a, stream), *args,
                      **kw)
    if rc != 0:
        msg = lib.mpc_build_error_string(rc).decode()
        raise RuntimeError(f"mpc_build kernel launch failed: CUDA error "
                           f"{rc}: {msg}")
    return out
