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
           "smem_values", "barrier_bytes", "smem_bytes", "MpcBuildLayout",
           "mpc_build_layout", "last_layout", "call", "launch", "build_specs",
           "require_dtype"]

CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARY = ("mpc_build", ("mpc_build.cu",), ("mpc_build.h",))

# mpc_build.h's counts (`mpcb::layout`): inputs, outputs, parameters,
# threads a block, the producer's warps, the blocks a multiprocessor the
# launch bounds guarantee by registers in float32 and float64.  The library
# is refused if its counts differ.
LAYOUT = dict(inputs=5, outputs=4, params=30, threads=384, producer_warps=5,
              min_blocks_f32=4, min_blocks_f64=2)
NX = 12
BLK = NX * NX
HALF = 6        # rows 0:6 of a Su block; rows 6:12 are B's, stored once

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
_DTYPE_BYTES = {torch.float32: 4, torch.float64: 8}
_MIN_BLOCKS = {torch.float32: "min_blocks_f32",
               torch.float64: "min_blocks_f64"}

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
LAUNCH_ARGTYPES = [_INT, _INT, _INT, ctypes.POINTER(_PTR),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(_PTR),
                   ctypes.POINTER(ctypes.c_double)]


def smem_values(N: int) -> int:
    """Values of a block's shared memory at horizon N (`mpcb::smem_values`):
    rows 0:6 of Su's N (N + 1) / 2 blocks, rows 6:12 of the N B_i, the N
    W_j, S and S A_j, the N M_k, the drifts and the g_j, diag(Q)."""
    return (HALF * NX * (N * (N + 1) // 2) + (HALF + NX) * NX * N + 2 * BLK
            + 9 * N + 2 * NX * N + NX)


def barrier_bytes(N: int) -> int:
    """Bytes of the N mbarriers (one a step of the recursion) before the
    values, rounded to 16 (`mpcb::barrier_bytes`)."""
    return (8 * N + 15) // 16 * 16


def smem_bytes(N: int, dtype) -> int:
    """Bytes of a block's dynamic shared memory (`mpcb::smem_bytes`)."""
    return barrier_bytes(N) + smem_values(N) * _DTYPE_BYTES[dtype]


class MpcBuildLayout(NamedTuple):
    blocks: int             # one a scenario
    threads: int            # a block's
    smem_bytes: int         # a block's dynamic shared memory
    blocks_per_sm: int      # resident blocks a multiprocessor, by shared
                            # memory, threads and the launch bounds'
                            # registers


def mpc_build_layout(B: int, N: int, dtype, smem_optin: int,
                     smem_per_sm: int = 233472,
                     threads_per_sm: int = 2048) -> MpcBuildLayout:
    """The launch of B scenarios at horizon N in `dtype` on a device whose
    block may opt in to `smem_optin` bytes of shared memory (the SM's
    `smem_per_sm` less 1 KB a block reserved by the runtime): a block of
    LAYOUT["threads"] per scenario, Su (rows 0:6 of each block, rows 6:12
    of each B_i once) in shared memory; resident blocks as shared memory
    and threads allow, at most the launch bounds' (4 in float32, 2 in
    float64 at N = 16 on an H100).  Raises ValueError when it does not fit
    (N > 24 in float64, N > 36 in float32 on an H100)."""
    if B < 1 or N < 1:
        raise ValueError(f"B and N must be >= 1, got {B}, {N}")
    smem = smem_bytes(N, dtype)
    if smem > smem_optin:
        raise ValueError(f"the MPC build at N = {N} in {dtype} needs {smem} "
                         f"bytes of shared memory a block, over the "
                         f"device's {smem_optin}")
    threads = LAYOUT["threads"]
    per_sm = max(1, min(smem_per_sm // (smem + 1024),
                        threads_per_sm // threads,
                        LAYOUT[_MIN_BLOCKS[dtype]]))
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
        for fn in (lib.mpc_build_smem_values, lib.mpc_build_last_layout):
            fn.argtypes = [_INT]
            fn.restype = ctypes.c_longlong
        got = [lib.mpc_build_layout(i) for i in range(len(LAYOUT))]
        if got != list(LAYOUT.values()):
            raise RuntimeError(f"mpc_build: the library's layout {got} is "
                               f"not mpc/kernels.py's {list(LAYOUT.values())}")
        _LIBS["mpc_build"] = lib
    return lib


def last_layout() -> tuple:
    """(threads, blocks, bytes of dynamic shared memory, resident blocks a
    multiprocessor by the occupancy API) of the library's last launch
    (chip_smoke.py holds it against `mpc_build_layout`)."""
    lib = _library()
    return tuple(int(lib.mpc_build_last_layout(i)) for i in range(4))


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
