"""The launch machinery of the planner's four hand-written kernels
(plan/csrc/planner.cu over planner.h, one library):

  * `plan_footsteps`, wrapped by plan/footsteps.py::plan_footsteps_horizon;
  * `plan_rollout`, wrapped by mpc/srb.py::reference_rollout;
  * `plan_swing`, wrapped by plan/swing.py::swing_foot_ref;
  * `plan_swing_at`, wrapped by plan/swing.py::swing_reference_at.

Each stage owns its wrapper and its plain PyTorch version; this module
knows the kernels' common C signature

    plan_<name>_launch(dtype, B, N, tables, in, stride, out, par, stream)
        -> rc

and packs operands for it.  Each per-scenario input is handed over as its
first row and the stride between two scenarios' rows (0 for a row shared by
every scenario), so that slices of a packed buffer (the host path's
snapshots) and expanded rows need no copy; only an input whose rows are not
contiguous is copied (dyn/kernels.py's `rows`).  `call` runs any launcher
with that signature less the stream: the CUDA library's (`launch`), or the
CPU tests' host build of planner.h.  The gait tables go to the card once per
device as one int32 tensor (`gait_tables`).  A launch goes on PyTorch's
current stream and allocates its outputs through PyTorch, so a CUDA graph
captures it as it is; any failure raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from mpctsid_tpu_torch.dyn.kernels import rows
from mpctsid_tpu_torch.plan.gait import (_BACK_NP, _DUR_NP, _STANCE_STEPS_NP,
                                         TABLES)
from mpctsid_tpu_torch.utils import device_constant

__all__ = ["LIBRARY", "CSRC", "FLAGS", "LAYOUT", "LAUNCH_ARGTYPES",
           "gait_tables", "rows", "int_rows", "call", "launch",
           "build_specs", "require_dtype", "rotation_forms"]

CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARY = ("planner", ("planner.cu",), ("planner.h",))
FLAGS = ("-fmad=false",)

# planner.h's counts (`planner_layout`): the gait tables' ints; inputs,
# outputs and parameters of the footsteps, the rollout, the swing
# reference and the swing reference at a tick.  The library is refused if
# its counts differ.
LAYOUT = dict(table_ints=980, foot_in=5, foot_out=2, foot_par=19,
              roll_in=2, roll_out=1, roll_par=3, swing_in=4, swing_out=3,
              swing_par=1, swing_at_in=5, swing_at_out=3, swing_at_par=2)

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
LAUNCH_ARGTYPES = [_INT, _INT, _INT, _PTR, ctypes.POINTER(_PTR),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(_PTR),
                   ctypes.POINTER(ctypes.c_double)]


def _tables_np() -> np.ndarray:
    """planner.h's table layout: stance flags [gait][phase][foot], the
    stance steps per period [gait][foot], then the swing tables' steps
    since lift-off and swing durations [gait][phase][foot]."""
    out = np.concatenate([TABLES.ravel(), _STANCE_STEPS_NP.ravel(),
                          _BACK_NP.ravel(), _DUR_NP.ravel()])
    assert out.size == LAYOUT["table_ints"]
    return np.rint(out).astype(np.int32)


def gait_tables(device) -> torch.Tensor:
    """The gait tables as planner.h's int32 array on `device`, once."""
    return device_constant("planner_tables", _tables_np, device, torch.int32)


def rotation_forms(dtype, B: int) -> tuple[bool, bool]:
    """(bmm fused, einsum fused): how the plain versions' 3 x 3 rotations
    round on an H100 for a batch of B in `dtype`, so that the kernels give
    their bits.  The third term of each row is 0 x 0, and cuBLAS forms the
    other two either as the FMA chain of a dot product in k order
    (fma(a1, b1, a0 b0)) or as two products and a sum, by the call's dtype
    and batch.  Measured with `scripts/probe_rotation_forms.py` against
    torch.bmm(rot_z(yaw), v[:, :, None]) and torch.einsum("bij,fj->bfi",
    rot_z(yaw), shoulders): float32 bmm fused up to B = 12288 and not from
    14000 on, float32 einsum not fused up to B = 5 and fused from 6;
    float64 bmm never fused, einsum always.  Where a threshold is wrong
    (another cuBLAS, a batch between two measured ones) the kernels part
    from the plain version by an ulp of these sums, no more (chip_smoke.py
    phase 3g counts the entries that part)."""
    if dtype == torch.float64:
        return False, True
    return B <= 12288, B >= 6


def require_dtype(what: str, t) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor, got {type(t)}")
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} must be float32 or float64, got {t.dtype}")


def int_rows(name: str, t, B: int, like):
    """(int32 rows, stride) of a (B,) or (1,) integer tensor (gait ids,
    phases)."""
    if not isinstance(t, torch.Tensor) or t.dtype.is_floating_point or \
            t.dtype == torch.bool:
        raise TypeError(f"{name} must be an integer tensor, got "
                        f"{getattr(t, 'dtype', type(t))}")
    return rows(name, t.to(torch.int32), B, (1,), like, torch.int32)


def call(launch_fn, dtype, B: int, N: int, tables, ins, outs, par) -> int:
    """Run `launch_fn(dtype, B, N, tables, in, stride, out, par) -> rc` on
    the operands: `ins` a list of (tensor, stride) in planner.h's input
    order, `outs` the output tensors, `par` the scalar parameters."""
    return launch_fn(
        _DTYPE_CODE[dtype], B, N,
        None if tables is None else tables.data_ptr(),
        (_PTR * len(ins))(*[t.data_ptr() for t, _ in ins]),
        (ctypes.c_longlong * len(ins))(*[s for _, s in ins]),
        (_PTR * len(outs))(*[t.data_ptr() for t in outs]),
        (ctypes.c_double * len(par))(*[float(p) for p in par]))


def build_specs() -> list:
    """(name, sources, headers, source directory, flags) of the library, for
    `qp/_build.py::build_libraries` (chip_smoke.py builds it beside the
    other kernels, every nvcc started together; it is otherwise built at
    its first launch)."""
    name, src, hdr = LIBRARY
    return [(name, src, hdr, CSRC, FLAGS)]


_LIBS: dict = {}


def _library():
    """The built library (builds it on first use), its layout checked
    against LAYOUT."""
    lib = _LIBS.get("planner")
    if lib is None:
        from mpctsid_tpu_torch.qp import _build

        name, src, hdr = LIBRARY
        lib = _build.load_library(name, src, hdr, csrc=CSRC, flags=FLAGS)
        for kernel in ("footsteps", "rollout", "swing", "swing_at"):
            fn = getattr(lib, f"plan_{kernel}_launch")
            fn.argtypes = LAUNCH_ARGTYPES + [_PTR]
            fn.restype = _INT
        lib.planner_error_string.argtypes = [_INT]
        lib.planner_error_string.restype = ctypes.c_char_p
        lib.planner_layout.argtypes = [_INT]
        lib.planner_layout.restype = _INT
        got = [lib.planner_layout(i) for i in range(len(LAYOUT))]
        if got != list(LAYOUT.values()):
            raise RuntimeError(f"planner: the library's layout {got} is not "
                               f"plan/kernels.py's {list(LAYOUT.values())}")
        _LIBS["planner"] = lib
    return lib


def launch(kernel: str, run, dev: torch.device, *args, **kw):
    """`run(launch_fn, *args, **kw) -> (rc, out)` through the library's
    `plan_<kernel>_launch` on the current stream of `dev`; returns `out`,
    raises on a launch error."""
    if dev.type != "cuda":
        raise RuntimeError(f"plan_{kernel} runs on cuda or cpu, not {dev}")
    lib = _library()
    fn = getattr(lib, f"plan_{kernel}_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc, out = run(lambda *a: fn(*a, stream), *args, **kw)
    if rc != 0:
        msg = lib.planner_error_string(rc).decode()
        raise RuntimeError(f"plan_{kernel} kernel launch failed: CUDA error "
                           f"{rc}: {msg}")
    return out
