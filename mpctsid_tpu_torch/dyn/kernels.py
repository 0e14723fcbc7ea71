"""The launch and operand machinery of the hand-written kernels built
over the rigid-body core dyn/csrc/rbd.h.

rbd.h holds the per-scenario arithmetic (leg kinematics once per
configuration, crba, rnea, foot Jacobians and drifts, integration, the
arrow-structured SPD solve) as per-lane units of a warp, and the whole body
of each kernel; the .cu files under dyn/csrc/ map a warp to its scenario,
`rbd_layout`'s number of them a block, each with its slot of shared memory:

  * `wbc_build` (wbc_build.cu): the WBC QP build, wrapped by
    wbc/tsid.py::wbc_build;
  * `plant_step` (plant_step.cu): the plant step, every substep in one
    launch, wrapped by env/plant.py::plant_step;
  * `period_head` (period_head.cu over period_head.h): a period boundary's
    foot positions, SRB state, lift-off select and velocity integrator,
    wrapped by cascade/engine.py::period_head; its second entry point
    `period_plan`, the same and the footstep horizon (plan/csrc/planner.h's
    units) and the touchdown select in one launch, wrapped by
    cascade/engine.py::period_plan;
  * `est_step` (est_step.cu over est_step.h): the state estimator's tick,
    the plant's IMU model and one complementary-filter update, wrapped by
    est/filter.py::estimator_tick; its second entry point `est_update`,
    the update with the IMU's readings given, wrapped by
    est/filter.py::estimator_update.  It alone takes another layout: a
    block of `est_layout`'s S scenarios, a warp a role (the attitude, each
    leg) and a lane a scenario.

Each stage owns its wrapper, its plain PyTorch version and its constants;
this module knows only the kernels' common C signature:

    <entry>_launch(dtype, B, consts, in, stride, out, par, stream) -> rc

(`ENTRIES`: a library's entry points, `<name>` unless listed)

The model's constants (dyn/rigid_body.py::LegConsts, its joint axes and
gravity) go to the card once per tree, device and dtype as one small tensor
(`rbd_constants`).  Each per-scenario input is handed over as its first row
and the stride between two scenarios' rows (0 for a row broadcast to every
scenario, as `expand` leaves it), so that slices and expanded constants need
no copy; only an input whose rows are not contiguous is copied (`rows`).
`call` runs any launcher with that signature less the stream: the CUDA
library's (`launch`), or the CPU tests' host build of rbd.h.  A launch goes
on PyTorch's current stream and allocates its outputs through PyTorch and
nothing else, so a CUDA graph captures it as it is; any failure raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from mpctsid_tpu_torch.dyn.rigid_body import GRAV, _consts
from mpctsid_tpu_torch.model.tree import NV
from mpctsid_tpu_torch.utils import device_constant

__all__ = ["rbd_constants", "rows", "check_batch", "call", "launch",
           "build_specs", "rbd_layout", "last_layout", "RbdLayout",
           "est_layout", "est_last_layout", "EstLayout", "EST_MAX_S",
           "LIBRARIES", "LAYOUT", "HEAD_LAYOUT", "EST_LAYOUT", "LAYOUTS",
           "SLOT_VALUES", "MAX_WARPS", "ENTRIES",
           "LAUNCH_ARGTYPES", "CSRC"]

CSRC = Path(__file__).resolve().parent / "csrc"

# name -> (sources, headers) under dyn/csrc/; one shared library per kernel,
# so that their nvcc processes run side by side
LIBRARIES = {
    "wbc_build": (("wbc_build.cu",), ("rbd.h",)),
    "plant_step": (("plant_step.cu",), ("rbd.h",)),
    "period_head": (("period_head.cu",),
                    ("rbd.h", "period_head.h", "../../plan/csrc/planner.h")),
    "est_step": (("est_step.cu",), ("rbd.h", "est_step.h")),
}
# the entry points of a library that has more than its name's
ENTRIES = {"period_head": ("period_head", "period_plan"),
           "est_step": ("est_step", "est_update")}
# nvcc flags after qp/_build.py's common ones: the period head and the
# estimator contract no product and sum that their plain versions round
# apart
FLAGS = {"period_head": ("-fmad=false",), "est_step": ("-fmad=false",)}

# rbd.h's counts, in the order of its enum Layout: the constants' size and
# the number of inputs, outputs and parameters of each kernel.  The
# libraries report theirs (`<name>_layout`) and are refused if they differ.
LAYOUT = dict(const_size=196, wbc_in=11, wbc_out=8, wbc_par=19, plant_in=11,
              plant_out=5, plant_par=2)
# period_head.h's counts after rbd.h's (`rbd::head::layout`): its inputs,
# outputs and parameters, then the period plan's after them (touchdown,
# gait, phase, tables; footsteps, next touchdown, touchdown; the horizon
# and planner.h's 19 FootPar values)
HEAD_LAYOUT = dict(head_in=6, head_out=5, head_par=2, plan_in=4, plan_out=3,
                   plan_par=20)
# est_step.h's counts after rbd.h's (`rbd::est::layout`): its inputs
# (the estimate, the IMU's readings, the joints, contacts, the hint, the
# plant's configuration), outputs (q', v') and parameters (dt, the gains
# and their complements, the hint flag)
EST_LAYOUT = dict(est_in=9, est_out=2, est_par=7)
# the counts each library reports, in the order of its `_layout(i)`
LAYOUTS = {"wbc_build": LAYOUT, "plant_step": LAYOUT,
           "period_head": {**LAYOUT, **HEAD_LAYOUT},
           "est_step": {**LAYOUT, **EST_LAYOUT}}

# values (floats or doubles) of a warp's slice of shared memory: rbd.h's
# WbcSlot and PlantSlot, period_head.h's HeadSlot (the plan's 16 staged
# steps, the leg kinematics, x_srb, v_used, the feet and the next
# touchdown; the head alone uses the same slot); the estimator's, a
# scenario's share of its block: est_step.h's EstRow (57: the estimate's
# pose and velocity, the IMU, contacts, hint, R0, the feet and their
# odometry terms) and its q' and v' rows (19 + 18).  The libraries report
# theirs (`<name>_slot_values`) and are refused if they differ.
SLOT_VALUES = {"wbc_build": 2279, "plant_step": 2372, "period_head": 507,
               "est_step": 94}
MAX_WARPS = 8           # rbd.h's MAX_WARPS: scenarios (warps) a block
EST_MAX_S = 32          # est_step.h's EST_MAX_S: scenarios a block
_EST_ROW = 57           # est_step.h's EST_ROW_VALUES

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
LAUNCH_ARGTYPES = [_INT, _INT, _PTR, ctypes.POINTER(_PTR),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(_PTR),
                   ctypes.POINTER(ctypes.c_double)]


# ---------------------------------------------------------------- constants

def _pack_constants(C) -> np.ndarray:
    """rbd.h's `Const` layout from a LegConsts: placements [level][leg][3],
    foot offsets [leg][3], level inertias [level][6][6], base inertia,
    joint axis per level, gravity."""
    parts = [C.pl_hip, C.pl_upper, C.pl_lower, C.foot_off, C.I_hip,
             C.I_upper, C.I_lower, C.I_base, C.axes]
    out = np.concatenate([p.detach().cpu().double().numpy().ravel()
                          for p in parts] + [np.array([GRAV])])
    assert out.size == LAYOUT["const_size"]
    return out


def rbd_constants(tree, device, dtype) -> torch.Tensor:
    """The model's constants packed for the kernels, on `device` in `dtype`,
    built once per (tree, device, dtype)."""
    C = _consts(tree, torch.empty(0, dtype=torch.float64))
    return device_constant(("rbd_constants", id(C)),
                           lambda: _pack_constants(C), device, dtype)


# ------------------------------------------------------------------ layout

class RbdLayout(NamedTuple):
    """How one launch of a rigid-body kernel is laid out."""
    warps: int         # scenarios (warps) a block
    blocks: int
    slot_bytes: int    # shared bytes of a warp's slot
    smem_bytes: int    # dynamic shared bytes a block


def rbd_layout(name: str, B: int, dtype, smem_bytes: int,
               n_sm: int) -> RbdLayout:
    """The layout a launch of kernel `name` takes (rbd.h's
    `warps_per_block`, which the launcher runs on the device's limits): a
    warp per scenario with its slot (SLOT_VALUES of `dtype`, rounded to 16
    bytes), as many warps a block as fit in `smem_bytes`, at most MAX_WARPS
    and no more than spread B over `n_sm` multiprocessors.  Raises where no
    slot fits."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    slot = -(-SLOT_VALUES[name] * itemsize // 16) * 16
    fit = smem_bytes // slot
    if fit < 1:
        raise ValueError(f"{name}: a {slot}-byte slot does not fit in "
                         f"{smem_bytes} bytes of shared memory")
    g = max(1, min(MAX_WARPS, fit, -(-B // max(1, n_sm))))
    return RbdLayout(g, -(-B // g), slot, g * slot)


class EstLayout(NamedTuple):
    """How one launch of the estimator's kernels is laid out."""
    scenarios: int     # S, scenarios a block (a lane each in every warp)
    blocks: int
    smem_bytes: int    # dynamic shared bytes a block


def _est_smem_bytes(S: int, itemsize: int) -> int:
    """est_step.h's est_smem_bytes: the q' and the v' rows of S scenarios,
    each with 16 bytes of room for the rows' offset from a 16-byte
    boundary, rounded up to 16 bytes, then S EstRows, then a copy of the
    model's constants (LAYOUT's const_size values)."""
    def round16(values):
        return -(-values * itemsize // 16) * 16 // itemsize
    extra = 16 // itemsize
    return itemsize * (round16(19 * S + extra) + round16(18 * S + extra)
                       + _EST_ROW * S + LAYOUT["const_size"])


def est_layout(B: int, dtype, smem_bytes: int, n_sm: int) -> EstLayout:
    """The layout a launch of `est_step` or `est_update` takes (est_step.h's
    `est_scenarios`, which the launcher runs on the device's limits): S
    scenarios a block, B spread over `n_sm` multiprocessors, at most
    EST_MAX_S, no more than fit in `smem_bytes`.  Raises where one scenario
    does not fit."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    S = max(1, min(EST_MAX_S, -(-B // max(1, n_sm))))
    while S > 1 and _est_smem_bytes(S, itemsize) > smem_bytes:
        S -= 1
    need = _est_smem_bytes(S, itemsize)
    if need > smem_bytes:
        raise ValueError(f"est_step: a {need}-byte block does not fit in "
                         f"{smem_bytes} bytes of shared memory")
    return EstLayout(S, -(-B // S), need)


def est_last_layout() -> EstLayout:
    """The layout the last launch of `est_step` or `est_update` took, as
    its library reports it."""
    fn = _library("est_step").est_step_last_layout
    return EstLayout(*(fn(i) for i in range(3)))


def last_layout(name: str) -> RbdLayout:
    """The layout the last launch of kernel `name` took, as its library
    reports it."""
    fn = getattr(_library(name), f"{name}_last_layout")
    g, blocks, smem = (fn(i) for i in range(3))
    return RbdLayout(g, blocks, smem // max(1, g), smem)


# ---------------------------------------------------------- operand packing

def rows(name: str, t, B: int, tail: tuple, like: torch.Tensor,
         dtype=None):
    """(tensor, stride): `t` as rows of shape `tail` for B scenarios (a
    leading axis of B, or of 1 for one row shared by all; a (B,) tensor for
    a tail of (1,)), its first row's elements contiguous; the stride between
    two rows in elements (0 when shared).  Raises unless `t` is a tensor of
    `dtype` (`like`'s unless given) on `like`'s device and of that shape;
    copies only a tensor whose rows are not contiguous.  The planner's and
    the Ruiz kernel's wrappers hand their operands over the same way."""
    want = like.dtype if dtype is None else dtype
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if tail == (1,) and t.dim() == 1:
        t = t[:, None]
    if t.dtype != want:
        raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, not on {like.device}: "
                         "one device only")
    if t.dim() != 1 + len(tail) or tuple(t.shape[1:]) != tail or \
            t.shape[0] not in (1, B):
        raise ValueError(f"{name} must be ({B}, {', '.join(map(str, tail))})"
                         f" or (1, ...), got {tuple(t.shape)}")
    if not t[0].is_contiguous():
        t = t.contiguous()
    stride = t.stride(0) if t.shape[0] > 1 else 0
    return t, stride


def check_batch(q, v) -> int:
    """B of a (B, 19) configuration and (B, 18) velocity in float32 or
    float64; raises otherwise."""
    if not isinstance(q, torch.Tensor) or not isinstance(v, torch.Tensor):
        raise TypeError("q and v must be torch.Tensors")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or float64, got {q.dtype}")
    if q.dim() != 2 or q.shape[1] != 19 or q.shape[0] < 1:
        raise ValueError(f"q must be (B, 19), got {tuple(q.shape)}")
    B = q.shape[0]
    if tuple(v.shape) != (B, NV):
        raise ValueError(f"v must be ({B}, {NV}), got {tuple(v.shape)}")
    return B


def call(launch_fn, tree, q, ins, outs, par) -> int:
    """Run `launch_fn(dtype, B, consts, in, stride, out, par) -> rc` on the
    operands: `ins` a list of (tensor or None, stride) in rbd.h's input
    order, `outs` the output tensors, `par` the scalar parameters, q the
    batch's configuration (its dtype, device and B)."""
    consts = rbd_constants(tree, q.device, q.dtype)
    ptrs = [None if t is None else t.data_ptr() for t, _ in ins]
    return launch_fn(_DTYPE_CODE[q.dtype], q.shape[0], consts.data_ptr(),
                     (_PTR * len(ins))(*ptrs),
                     (ctypes.c_longlong * len(ins))(*[s for _, s in ins]),
                     (_PTR * len(outs))(*[t.data_ptr() for t in outs]),
                     (ctypes.c_double * len(par))(*[float(p) for p in par]))


# ---------------------------------------------------------------- libraries

def build_specs() -> list:
    """(name, sources, headers, source directory) of each library, for
    `qp/_build.py::build_libraries` (chip_smoke.py builds them beside the
    qp/ kernels, every nvcc started together; each is otherwise built at
    its first launch)."""
    return [(name, src, hdr, CSRC, FLAGS.get(name, ()))
            for name, (src, hdr) in LIBRARIES.items()]


_LIBS: dict = {}


def _library(name: str):
    """The built library of one kernel (builds it on first use), its
    layout checked against LAYOUT."""
    lib = _LIBS.get(name)
    if lib is None:
        from mpctsid_tpu_torch.qp import _build

        lib = _build.load_library(name, *LIBRARIES[name], csrc=CSRC,
                                  flags=FLAGS.get(name, ()))
        for entry in ENTRIES.get(name, (name,)):
            fn = getattr(lib, f"{entry}_launch")
            fn.argtypes = LAUNCH_ARGTYPES + [_PTR]
            fn.restype = _INT
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [_INT]
        err.restype = ctypes.c_char_p
        for entry in ("layout", "last_layout"):
            fn = getattr(lib, f"{name}_{entry}")
            fn.argtypes = [_INT]
            fn.restype = _INT
        lib_slot = getattr(lib, f"{name}_slot_values")
        lib_slot.restype = _INT
        want = list(LAYOUTS[name].values())
        got = [getattr(lib, f"{name}_layout")(i) for i in range(len(want))]
        if got != want or lib_slot() != SLOT_VALUES[name]:
            raise RuntimeError(
                f"{name}: the library's layout {got} and slot of "
                f"{lib_slot()} values are not dyn/kernels.py's {want} and "
                f"{SLOT_VALUES[name]}")
        _LIBS[name] = lib
    return lib


def launch(name: str, run, dev: torch.device, *args, entry: str = None,
           **kw):
    """`run(launch_fn, *args, **kw) -> (rc, out)` through the CUDA library
    of kernel `name` (its entry point `entry`, `name` unless given) on the
    current stream of `dev`; returns `out`, raises on a launch error."""
    entry = entry or name
    if dev.type != "cuda":
        raise RuntimeError(f"{entry} runs on cuda or cpu, not {dev}")
    lib = _library(name)
    fn = getattr(lib, f"{entry}_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc, out = run(lambda *a: fn(*a, stream), *args, **kw)
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}: "
                           f"{msg}")
    return out
