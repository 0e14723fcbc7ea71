"""The solve-tail kernels (qp/csrc/solve_tail.cu over solve_tail.h) and
their wrappers: three stages of qp/admm.py around the ADMM iterations.

  * `kkt_blocks` (entry `kkt_blocks`): (K, rho_vec) = (P + sigma I + A'
    diag(rho_vec) A, (1 + eqf (rho_eq_scale - 1)) rho_s) for an A that the
    caller declares block diagonal (`a_blocks = (r, c)`: equal r x c blocks
    tiling (m, n); the MPC's `mpc/srb.py::MPC_A_BLOCKS`).  The kernel never
    guesses the structure: the declaration is checked against the shapes
    (`check_blocks`), not against A's values.  Plain version:
    qp/admm.py::_dense_kkt (the dense product over all m rows).
  * `adapt_rho` (entry `adapt_rho`): the per-scenario rho of the next adapt
    round, its sums in float64 (the residual ratio cancels: float32 sums
    leave rho up to 15 % from the function's value on the MPC's QPs).  A
    dense, or its declared blocks only.  Plain version:
    qp/admm.py::_adapt_rho.
  * `unscale` (entry `unscale`): the solve's epilogue, (x, y, z, prim, dual,
    ok).  A dense, or its declared blocks only.  Plain version:
    qp/admm.py::_unscaled_solution.

Routing (as every wrapper of the port): on CPU tensors, and only because
they lie on the CPU, the plain version runs; on float32 CUDA tensors the
kernel launches on PyTorch's current stream, or the wrapper raises (any
other dtype on CUDA: TypeError).  qp/admm.py calls them on its kernel
backends ("m2", "vpu", "packed", "mma") and, for `unscale`, after the
whole-solve kernels (`fused` and kernel A, the default WBC solve); its
plain backend keeps the plain versions.  A launch
allocates its outputs through PyTorch and nothing else and synchronizes
nothing, so a CUDA graph captures it as it is.  `<wrapper>.launches`
counts launches.

A is read through its batch stride (the MPC's constant A is a stride-0
view: never copied).  Each launch's geometry is a pure layout function of
the shapes and the device's limits (`kkt_layout`, `tail_layout`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from mpctsid_tpu_torch.dyn.kernels import rows
from mpctsid_tpu_torch.qp.kernels import device_limits

__all__ = ["kkt_blocks", "adapt_rho", "unscale", "check_blocks",
           "kkt_layout", "tail_layout", "TailLayout", "smem_values",
           "run_kkt", "run_adapt", "run_unscale", "LIBRARY", "LAYOUT",
           "LAUNCH_ARGTYPES", "FLAGS", "build_specs"]

LIBRARY = ("solve_tail", ("solve_tail.cu",), ("solve_tail.h",))
# every product and sum rounds as PyTorch's elementwise ops round them
FLAGS = ("-fmad=false",)

# solve_tail.h's counts (`tail::layout`): inputs, outputs and parameters of
# kkt_blocks, adapt_rho, unscale, then the partial maxima a quantity and the
# partial sums a row at most.  The library is refused if its counts differ.
LAYOUT = dict(kkt_in=4, kkt_out=2, kkt_par=2, adapt_in=7, adapt_out=1,
              unscale_in=10, unscale_out=6, unscale_par=1, parts=32,
              max_lanes=32)
MAXIMA = 7               # adapt_rho's inf-norms (solve_tail.h, MAXIMA)
KKT_RUN = 4              # kkt_blocks: consecutive entries of K a thread
KKT_THREADS = 256        # kkt_blocks: threads a block
KKT_BLOCKS_PER_SM = 8    # ... and blocks a multiprocessor of the grid
TAIL_THREADS = 512       # adapt_rho / unscale: a block a scenario
TAIL_THREADS_SMALL = 128     # ... when n and m are at most SMALL_DIM
SMALL_DIM = 64

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# (dtype, in, stride, out, par, B, n, m, r, c, threads, blocks, lanes), the
# stream
LAUNCH_ARGTYPES = [_INT, ctypes.POINTER(_PTR),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(_PTR),
                   ctypes.POINTER(ctypes.c_double)] + [_INT] * 8


def smem_values(n: int, m: int, dense: bool, lanes: int) -> int:
    """Values of a scenario's shared memory in adapt_rho (doubles) and
    unscale (the operands' type) (`tail::smem_values`): x, y, A x, A x - z,
    P x, A' y, the partial maxima, and the `lanes` partial sums of each of
    P's rows and (`dense`) A's."""
    return (3 * n + 3 * m + MAXIMA * LAYOUT["parts"]
            + lanes * (n + (m if dense else 0)))


def check_blocks(n: int, m: int, a_blocks) -> tuple:
    """(r, c) of a declaration that A (m, n) is block diagonal with equal
    r x c blocks tiling it; raises ValueError unless m = k r and n = k c
    for one k >= 1.  None declares nothing: (0, 0), the dense path."""
    if a_blocks is None:
        return 0, 0
    r, c = (int(v) for v in a_blocks)
    if r < 1 or c < 1 or m % r or n % c or m // r != n // c:
        raise ValueError(f"a_blocks={tuple(a_blocks)} does not tile A of "
                         f"shape ({m}, {n}) with equal blocks: m must be k r "
                         "and n k c for one k")
    return r, c


class TailLayout(NamedTuple):
    threads: int
    blocks: int
    smem_bytes: int     # dynamic shared memory a block (0 for kkt_blocks)
    lanes: int          # units a row of P (1 for kkt_blocks)

    @property
    def geometry(self) -> tuple:
        """(threads, blocks, lanes): what the launchers take."""
        return self.threads, self.blocks, self.lanes


def kkt_layout(B: int, n: int, m: int, n_sm: int) -> TailLayout:
    """kkt_blocks over B scenarios: one thread a run of KKT_RUN entries of
    K and an entry of rho_vec, KKT_THREADS a block, a grid of at most
    KKT_BLOCKS_PER_SM blocks a multiprocessor walking the rest."""
    total = -(-B * n * n // KKT_RUN) + B * m
    blocks = max(1, min(-(-total // KKT_THREADS), KKT_BLOCKS_PER_SM * n_sm))
    return TailLayout(KKT_THREADS, blocks, 0, 1)


def tail_layout(n: int, m: int, B: int, smem_optin: int, dense: bool,
                dtype=torch.float32) -> TailLayout:
    """adapt_rho and unscale over B scenarios, A `dense` or its blocks
    declared: a block a scenario; when n and m are at most SMALL_DIM (the
    WBC shape) TAIL_THREADS_SMALL threads and a unit a row of P, else
    TAIL_THREADS and MAX_LANES units a row (their reads of a row
    consecutive); the scenario's vectors and partial sums in shared
    memory, values of `dtype` (adapt_rho's: float64, whatever its
    operands').  Raises ValueError when they do not fit the `smem_optin`
    bytes a block may have."""
    small = max(n, m) <= SMALL_DIM
    lanes = 1 if small else LAYOUT["max_lanes"]
    itemsize = torch.empty((), dtype=dtype).element_size()
    smem = smem_values(n, m, dense, lanes) * itemsize
    if smem > smem_optin:
        raise ValueError(f"the solve tail at n = {n}, m = {m} needs {smem} "
                         f"bytes of shared memory a block, over the "
                         f"device's {smem_optin}")
    return TailLayout(TAIL_THREADS_SMALL if small else TAIL_THREADS, B, smem,
                      lanes)


# ------------------------------------------------------------------ packing

def _dims(P, A):
    if not isinstance(P, torch.Tensor) or not isinstance(A, torch.Tensor):
        raise TypeError("P and A must be torch.Tensors")
    if P.dtype not in _DTYPE_CODE:
        raise TypeError(f"P must be float32 or float64, got {P.dtype}")
    if P.dim() != 3 or P.shape[1] != P.shape[2] or P.shape[0] < 1:
        raise ValueError(f"P must be (B, n, n), got {tuple(P.shape)}")
    B, n = P.shape[0], P.shape[1]
    if A.dim() != 3 or A.shape[0] not in (1, B) or A.shape[2] != n:
        raise ValueError(f"A must be ({B}, m, {n}), got {tuple(A.shape)}")
    return B, n, A.shape[1]


def _call(launch_fn, P, ins, outs, par, B, n, m, blocks_rc, geometry):
    ptrs = [t.data_ptr() for t, _ in ins]
    return launch_fn(
        _DTYPE_CODE[P.dtype], (_PTR * len(ins))(*ptrs),
        (ctypes.c_longlong * len(ins))(*[s for _, s in ins]),
        (_PTR * len(outs))(*[t.data_ptr() for t in outs]),
        (ctypes.c_double * max(1, len(par)))(*[float(p) for p in par]),
        B, n, m, *blocks_rc, *geometry)


def run_kkt(launch_fn, P, A, eqf, rho_s, sigma: float, rho_eq_scale: float,
            a_blocks, geometry):
    """(rc, (K, rho_vec)): kkt_blocks' operands packed for `launch_fn`
    (the library's launcher less the stream, or the CPU tests' host
    build), `geometry` a layout's (threads, blocks, lanes), its outputs
    allocated here."""
    B, n, m = _dims(P, A)
    rc_blocks = check_blocks(n, m, a_blocks)
    if rc_blocks == (0, 0):
        raise ValueError("kkt_blocks needs a_blocks: the dense K is the "
                         "plain version's")
    ins = [rows("P", P, B, (n, n), P), rows("A", A, B, (m, n), P),
           rows("eqf", eqf, B, (m,), P), rows("rho_s", rho_s, B, (1,), P)]
    outs = (P.new_empty((B, n, n)), P.new_empty((B, m)))
    rc = _call(launch_fn, P, ins, outs, [sigma, rho_eq_scale - 1.0], B, n, m,
               rc_blocks, geometry)
    return rc, outs


def run_adapt(launch_fn, P, q, A, x, z, y, rho_s, a_blocks, geometry):
    """(rc, rho_s): adapt_rho's operands packed for `launch_fn`."""
    B, n, m = _dims(P, A)
    ins = [rows("P", P, B, (n, n), P), rows("q", q, B, (n,), P),
           rows("A", A, B, (m, n), P), rows("x", x, B, (n,), P),
           rows("z", z, B, (m,), P), rows("y", y, B, (m,), P),
           rows("rho_s", rho_s, B, (1,), P)]
    outs = (P.new_empty((B,)),)
    rc = _call(launch_fn, P, ins, outs, [], B, n, m,
               check_blocks(n, m, a_blocks), geometry)
    return rc, outs[0]


def run_unscale(launch_fn, P0, q0, A0, l0, u0, xs, ys, D, E, c,
                status_tol: float, a_blocks, geometry):
    """(rc, (x, y, z, prim, dual, ok)): unscale's operands packed for
    `launch_fn`; ok a bool tensor."""
    B, n, m = _dims(P0, A0)
    ins = [rows("P0", P0, B, (n, n), P0), rows("q0", q0, B, (n,), P0),
           rows("A0", A0, B, (m, n), P0), rows("l0", l0, B, (m,), P0),
           rows("u0", u0, B, (m,), P0), rows("xs", xs, B, (n,), P0),
           rows("ys", ys, B, (m,), P0), rows("D", D, B, (n,), P0),
           rows("E", E, B, (m,), P0), rows("c", c, B, (1,), P0)]
    outs = (P0.new_empty((B, n)), P0.new_empty((B, m)), P0.new_empty((B, m)),
            P0.new_empty((B,)), P0.new_empty((B,)),
            torch.empty((B,), dtype=torch.bool, device=P0.device))
    rc = _call(launch_fn, P0, ins, outs, [status_tol], B, n, m,
               check_blocks(n, m, a_blocks), geometry)
    return rc, outs


# ---------------------------------------------------------------- wrappers

def _require_float32(P) -> None:
    if P.dtype != torch.float32:
        raise TypeError(f"the solve-tail kernels take float32 on the card, "
                        f"got {P.dtype}")


def kkt_blocks(P, A, eqf, rho_s, sigma: float, rho_eq_scale: float,
               a_blocks):
    """(K (B, n, n), rho_vec (B, m)) of one adapt round, A (B or 1, m, n)
    block diagonal as `a_blocks` declares (see the module docstring).

    CUDA tensors: one launch of the hand-written kernel (float32, else
    TypeError; a declaration that does not tile A: ValueError).  CPU
    tensors: the plain version, qp/admm.py::_dense_kkt."""
    B, n, m = _dims(P, A)
    if P.device.type == "cpu":
        check_blocks(n, m, a_blocks)
        from mpctsid_tpu_torch.qp import admm

        return admm._dense_kkt(P, A, eqf, rho_s, sigma, rho_eq_scale)
    _require_float32(P)
    dev = P.device
    lay = kkt_layout(B, n, m, device_limits(dev)[1])
    out = _launch("kkt", run_kkt, dev, P, A, eqf, rho_s, sigma, rho_eq_scale,
                  a_blocks, lay.geometry)
    kkt_blocks.launches += 1
    return out


kkt_blocks.launches = 0


def adapt_rho(P, q, A, x, z, y, rho_s, a_blocks=None):
    """The per-scenario rho (B,) of the next adapt round from the scaled
    problem and the iterate (see the module docstring).

    CUDA tensors: one launch of the hand-written kernel (float32, else
    TypeError).  CPU tensors: the plain version, qp/admm.py::_adapt_rho."""
    B, n, m = _dims(P, A)
    if P.device.type == "cpu":
        check_blocks(n, m, a_blocks)
        from mpctsid_tpu_torch.qp import admm

        return admm._adapt_rho(P, q, A, x, z, y, rho_s)
    _require_float32(P)
    dev = P.device
    lay = tail_layout(n, m, B, device_limits(dev)[0], a_blocks is None,
                      torch.float64)
    out = _launch("adapt", run_adapt, dev, P, q, A, x, z, y, rho_s, a_blocks,
                  lay.geometry)
    adapt_rho.launches += 1
    return out


adapt_rho.launches = 0


def unscale(P0, q0, A0, l0, u0, xs, ys, D, E, c, status_tol: float,
            a_blocks=None):
    """The solve's epilogue from the scaled solution (xs, ys) and the
    scales (D, E, c): (x, y, z, prim_res, dual_res, ok), see the module
    docstring.

    CUDA tensors: one launch of the hand-written kernel (float32, else
    TypeError); x and y are the plain version's bits.  CPU tensors: the
    plain version, qp/admm.py::_unscaled_solution."""
    B, n, m = _dims(P0, A0)
    if P0.device.type == "cpu":
        check_blocks(n, m, a_blocks)
        from mpctsid_tpu_torch.qp import admm

        s = admm._unscaled_solution(P0, q0, A0, l0, u0, xs, ys, D, E, c,
                                    status_tol)
        return s.x, s.y, s.z, s.prim_res, s.dual_res, s.ok
    _require_float32(P0)
    dev = P0.device
    lay = tail_layout(n, m, B, device_limits(dev)[0], a_blocks is None)
    out = _launch("unscale", run_unscale, dev, P0, q0, A0, l0, u0, xs, ys, D,
                  E, c, status_tol, a_blocks, lay.geometry)
    unscale.launches += 1
    return out


unscale.launches = 0


# ---------------------------------------------------------------- library

def build_specs() -> list:
    """(name, sources, headers, source directory, flags) of the library,
    for `qp/_build.py::build_libraries` (chip_smoke.py builds it beside the
    other kernels; it is otherwise built at its first launch)."""
    from mpctsid_tpu_torch.qp._build import CSRC

    name, src, hdr = LIBRARY
    return [(name, src, hdr, CSRC, FLAGS)]


_LIBS: dict = {}


def _library():
    """The built library (builds it on first use), its counts checked
    against LAYOUT."""
    lib = _LIBS.get("solve_tail")
    if lib is None:
        from mpctsid_tpu_torch.qp import _build

        name, src, hdr = LIBRARY
        lib = _build.load_library(name, src, hdr, flags=FLAGS)
        for entry in ("kkt", "adapt", "unscale"):
            fn = getattr(lib, f"solve_tail_{entry}_launch")
            fn.argtypes = LAUNCH_ARGTYPES + [_PTR]
            fn.restype = _INT
        lib.solve_tail_error_string.argtypes = [_INT]
        lib.solve_tail_error_string.restype = ctypes.c_char_p
        lib.solve_tail_layout.argtypes = [_INT]
        lib.solve_tail_layout.restype = _INT
        lib.solve_tail_smem_values.argtypes = [_INT] * 4
        lib.solve_tail_smem_values.restype = ctypes.c_longlong
        got = [lib.solve_tail_layout(i) for i in range(len(LAYOUT))]
        if got != list(LAYOUT.values()):
            raise RuntimeError(f"solve_tail: the library's layout {got} is "
                               f"not qp/tail.py's {list(LAYOUT.values())}")
        _LIBS["solve_tail"] = lib
    return lib


def _launch(entry: str, run, dev: torch.device, *args):
    """`run(launch_fn, *args) -> (rc, out)` through the library's
    `solve_tail_<entry>_launch` on the current stream of `dev`; returns
    `out`, raises on a launch error."""
    if dev.type != "cuda":
        raise RuntimeError(f"solve_tail runs on cuda or cpu, not {dev}")
    lib = _library()
    fn = getattr(lib, f"solve_tail_{entry}_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc, out = run(lambda *a: fn(*a, stream), *args)
    if rc != 0:
        msg = lib.solve_tail_error_string(rc).decode()
        raise RuntimeError(f"solve_tail {entry} kernel launch failed: CUDA "
                           f"error {rc}: {msg}")
    return out
