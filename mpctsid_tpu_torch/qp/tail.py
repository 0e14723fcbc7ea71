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
    leave rho up to 15 % from the function's value on the MPC's QPs), on
    the epilogue's layouts (a warp a scenario at the WBC shape, a block at
    the MPC's).  A dense, or its declared blocks only.  Plain version:
    qp/admm.py::_adapt_rho; its sums written out, `adapt_in_order`.
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
the shapes and the device's limits (`kkt_layout`, `adapt_layout`,
`tail_layout`), which the launchers check.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from mpctsid_tpu_torch.dyn.kernels import rows
from mpctsid_tpu_torch.qp.kernels import device_limits

__all__ = ["kkt_blocks", "adapt_rho", "unscale", "check_blocks",
           "kkt_layout", "adapt_layout", "tail_layout", "TailLayout",
           "adapt_smem_bytes", "kkt_smem_values", "kkt_smem_bytes",
           "unscale_smem_bytes", "bulk_rows",
           "run_kkt", "run_adapt", "run_unscale", "kkt_in_order",
           "adapt_in_order", "unscale_in_order", "last_layout", "LIBRARY",
           "LAYOUT", "LAUNCH_ARGTYPES", "FLAGS", "build_specs"]

LIBRARY = ("solve_tail", ("solve_tail.cu",),
           ("solve_tail.h", "cluster_exchange.cuh"))
_ENTRIES = ("kkt", "adapt", "unscale")    # solve_tail_<entry>_launch
# every product and sum rounds as PyTorch's elementwise ops round them
FLAGS = ("-fmad=false",)

# solve_tail.h's counts (`tail::layout`): inputs, outputs and parameters of
# kkt_blocks, adapt_rho, unscale, the partial maxima a quantity and the
# partial sums a row at most, then the layouts' constants: the pieces of a
# kkt_blocks tile a thread, unscale's warp path (n and m at most
# `warp_dim`, at most `max_warps` scenarios a block).  The library is
# refused if its counts differ.
LAYOUT = dict(kkt_in=4, kkt_out=2, kkt_par=2, adapt_in=7, adapt_out=1,
              unscale_in=10, unscale_out=6, unscale_par=1, parts=32,
              max_lanes=32, kkt_pieces=8, warp_dim=64, max_warps=16)
MAXIMA = 7               # adapt_rho's inf-norms (solve_tail.h, MAXIMA)
KKT_THREADS = 128        # kkt_blocks: threads a block (a tile)
TAIL_THREADS = 512       # adapt_rho's and unscale's block paths: a scenario
TAIL_THREADS_LARGE_B = 256    # unscale's where B is at least
LARGE_B_WAVES = 4             # this many blocks a multiprocessor

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# (dtype, in, stride, out, par, B, n, m, r, c, threads, blocks, lanes), the
# stream
LAUNCH_ARGTYPES = [_INT, ctypes.POINTER(_PTR),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(_PTR),
                   ctypes.POINTER(ctypes.c_double)] + [_INT] * 8


def _block_values(n: int, m: int, dense: bool) -> int:
    """Values of a scenario's shared memory on the block paths
    (`tail::block_smem_values`): x, y, A x, A x - z, P x, A' y, the partial
    maxima, then the 32 partials of each of P's rows and (`dense`) A's at a
    stride of the rows + 1."""
    split = n + (m if dense else 0)
    return (3 * n + 3 * m + MAXIMA * LAYOUT["parts"]
            + LAYOUT["max_lanes"] * (split + 1))


def adapt_smem_bytes(n: int, m: int, dense: bool, warps: int, slots: int,
                     itemsize: int) -> int:
    """Bytes of a block's shared memory in adapt_rho
    (`tail::adapt_smem_bytes`).  The warp path, `warps` warps, each
    (`tail::adapt_warp_smem_bytes`, rounded to 16): the rows as unscale's
    warp path keeps them (1 slot at the odd stride n | 1; or 2 slots at
    stride n after two mbarriers), rounded to 8 bytes, then x and y in
    float64.  The block path (`warps` 0): its vectors, the warps' maxima,
    the partials and q, in float64."""
    if warps > 0:
        split = n + (m if dense else 0)
        rows = split * (n | 1) if slots == 1 else 2 * split * n
        head = 16 * (slots == 2) + -(-rows * itemsize // 8) * 8
        return warps * (-(-(head + 8 * (n + m)) // 16) * 16)
    return (_block_values(n, m, dense) + n) * 8


def kkt_smem_values(n: int, c: int, tile: int) -> int:
    """Values of a kkt_blocks tile's shared memory, tiles of `tile`
    entries (`tail::kkt_smem_values`): the c block entries of each row a
    tile meets, at most."""
    return min(n, (min(tile, n * n) - 1) // n + 2) * c


def kkt_smem_bytes(n: int, c: int, tile: int, bulk: bool,
                   itemsize: int) -> int:
    """Bytes of a kkt_blocks block's shared memory (`tail::kkt_smem_bytes`):
    the block entries and, where the tile comes in by bulk copy (`bulk`),
    the tile after its 16-byte barrier."""
    return ((16 + tile * itemsize) if bulk else 0) + \
        kkt_smem_values(n, c, tile) * itemsize


def unscale_smem_bytes(n: int, m: int, dense: bool, warps: int, slots: int,
                       itemsize: int) -> int:
    """Bytes of a block's shared memory in unscale
    (`solve_tail_unscale_smem_bytes`).  The warp path, `warps` warps, each
    (`tail::warp_smem_bytes`, rounded to 16 bytes): 1 slot, P's rows and a
    dense A's at the odd stride n | 1, x, y; or 2 slots at stride n after
    two mbarriers, x, y.  The block path (`warps` 0): adapt_rho's vectors
    and maxima, then the 32 partials of each split row at a stride of the
    rows + 1."""
    split = n + (m if dense else 0)
    if warps > 0:
        if slots == 1:
            v = split * (n | 1) + n + m
        else:
            v = 2 * split * n + n + m
        return warps * (-(-(16 * (slots == 2) + v * itemsize) // 16) * 16)
    return _block_values(n, m, dense) * itemsize


def bulk_rows(t: torch.Tensor, count: int) -> bool:
    """Whether each scenario's rows of `t` (count values) lie 16-byte
    aligned and fill whole 16-byte pieces, as the kernels' bulk copies and
    16-byte loads need (solve_tail.h `rows_bulk`): contiguous rows, the
    first at a 16-byte boundary, the scenario stride a multiple of 16
    bytes (or 0)."""
    size = t.element_size()
    stride = t.stride(0) if t.shape[0] > 1 else 0
    return (t[0].is_contiguous() and t.data_ptr() % 16 == 0
            and stride * size % 16 == 0 and count * size % 16 == 0)


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
    path: str           # "tiles" (kkt_blocks), "block" or "warp"
    threads: int
    blocks: int
    smem_bytes: int     # dynamic shared memory a block
    lanes: int          # kkt_blocks: values a piece; adapt_rho and the
                        # block path: units a row of P; the warp path: its
                        # slots (1 or 2)

    @property
    def geometry(self) -> tuple:
        """(threads, blocks, lanes): what the launchers take."""
        return self.threads, self.blocks, self.lanes


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _fit(name: str, smem: int, smem_optin: int) -> None:
    if smem > smem_optin:
        raise ValueError(f"{name} needs {smem} bytes of shared memory a "
                         f"block, over the device's {smem_optin}")


def kkt_layout(B: int, n: int, m: int, a_blocks, smem_optin: int,
               dtype=torch.float32, aligned: bool = True) -> TailLayout:
    """kkt_blocks over B scenarios: a block of KKT_THREADS a tile of
    KKT_THREADS x `kkt_pieces` pieces of one scenario's K, B times its
    tiles in all.  Where P is `aligned` (`bulk_rows`) and n a multiple of
    a 16-byte piece (float4 / double2), the tile comes in by one bulk copy
    and leaves by one bulk store (its buffer in shared memory); else a
    piece is a value, held in registers.  Raises ValueError where a
    block's shared memory does not fit `smem_optin`."""
    r, c = check_blocks(n, m, a_blocks)
    if r == 0:
        raise ValueError("kkt_blocks needs a_blocks")
    size = _itemsize(dtype)
    vec = 16 // size if aligned and n % (16 // size) == 0 else 1
    tile = KKT_THREADS * LAYOUT["kkt_pieces"] * vec
    tiles = -(-n * n // tile)
    smem = kkt_smem_bytes(n, c, tile, vec > 1, size)
    _fit(f"kkt_blocks at n = {n}, a_blocks = {(r, c)}", smem, smem_optin)
    return TailLayout("tiles", KKT_THREADS, B * tiles, smem, vec)


def _warp_layout(name: str, B: int, smem_optin: int, n_sm: int,
                 slot_bytes, aligned: bool) -> TailLayout:
    """The warp path of adapt_rho and unscale: a warp a scenario, as many a
    block as fit `smem_optin` (a warp's bytes `slot_bytes(slots)`), at most
    `max_warps` and no more than spread B over `n_sm` multiprocessors;
    where the rows are `aligned` two slots (lanes 2) and at most `n_sm`
    blocks, each warp walking its scenarios, else one slot (lanes 1) and a
    block for each `warps` scenarios."""
    slots = 2 if aligned else 1
    slot = slot_bytes(slots)
    _fit(name, slot, smem_optin)
    warps = max(1, min(LAYOUT["max_warps"], smem_optin // slot,
                       -(-B // max(1, n_sm))))
    blocks = -(-B // warps)
    if slots == 2:
        blocks = min(blocks, n_sm)
    return TailLayout("warp", 32 * warps, blocks, warps * slot, slots)


def adapt_layout(n: int, m: int, B: int, smem_optin: int, n_sm: int,
                 dense: bool, dtype=torch.float32,
                 aligned: bool = True) -> TailLayout:
    """adapt_rho over B scenarios, A `dense` or its blocks declared: the
    epilogue's layouts (`tail_layout`), its sums in float64.  Where n and m
    are at most `warp_dim` (the WBC shape): the warp path, a lane a row of
    P and of A and a column of A' (lanes: its slots, 2 where P and a dense
    A are `aligned`).  Else the block path, a block of TAIL_THREADS a
    scenario, rows of P streamed a warp ADAPT_ROW_GROUP at a time (lanes
    `max_lanes`; 512 threads read faster than 256 at every B measured).
    Raises ValueError where one scenario does not fit `smem_optin`."""
    size = _itemsize(dtype)
    if max(n, m) <= LAYOUT["warp_dim"]:
        return _warp_layout(
            f"adapt_rho at n = {n}, m = {m}", B, smem_optin, n_sm,
            lambda slots: adapt_smem_bytes(n, m, dense, 1, slots, size),
            aligned)
    smem = adapt_smem_bytes(n, m, dense, 0, 1, size)
    _fit(f"adapt_rho at n = {n}, m = {m}", smem, smem_optin)
    return TailLayout("block", TAIL_THREADS, B, smem, LAYOUT["max_lanes"])


def tail_layout(n: int, m: int, B: int, smem_optin: int, n_sm: int,
                dense: bool, dtype=torch.float32,
                aligned: bool = True) -> TailLayout:
    """unscale over B scenarios, A `dense` or its blocks declared.  Where n
    and m are at most `warp_dim` (the WBC shape): the warp path, a warp a
    scenario, as many a block as fit `smem_optin`, at most `max_warps` and
    no more than spread B over `n_sm` multiprocessors.  Where P and a
    dense A are `aligned` (`bulk_rows`; lanes 2, two slots): at most
    `n_sm` blocks, each warp walking its scenarios, the next one's rows
    arriving by bulk copy while it works on the current one; else (lanes
    1, one slot) a block for each `warps` scenarios, the lanes staging the
    rows.  Else the block path: a block a scenario, rows of P streamed a
    warp `row_group` at a time (lanes `max_lanes`), TAIL_THREADS a block,
    TAIL_THREADS_LARGE_B (more blocks a multiprocessor) where B is at
    least LARGE_B_WAVES blocks a multiprocessor.  Raises ValueError where
    one scenario does not fit."""
    size = _itemsize(dtype)
    if max(n, m) <= LAYOUT["warp_dim"]:
        return _warp_layout(
            f"unscale at n = {n}, m = {m}", B, smem_optin, n_sm,
            lambda slots: unscale_smem_bytes(n, m, dense, 1, slots, size),
            aligned)
    smem = unscale_smem_bytes(n, m, dense, 0, 1, size)
    _fit(f"unscale at n = {n}, m = {m}", smem, smem_optin)
    threads = (TAIL_THREADS_LARGE_B if B >= LARGE_B_WAVES * n_sm
               else TAIL_THREADS)
    return TailLayout("block", threads, B, smem, LAYOUT["max_lanes"])


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


# -------------------------------------- the kernels' sums, written out

def _nanmax(a, b):
    return torch.where((a != a) | (a > b), a, b)


def _nanmin(a, b):
    return torch.where((a != a) | (a < b), a, b)


def kkt_in_order(P, A, eqf, rho_s, sigma: float, rho_eq_scale: float,
                 a_blocks):
    """(K, rho_vec) of `kkt_blocks` by elementwise PyTorch ops in the
    kernel's order (solve_tail.h `kkt_setup`, `kkt_piece`): each block
    entry's r terms (A[k, i] rho_k) A[k, j] from 0 in order of k, then + P,
    then + sigma on the diagonal; off the blocks 0 + P.  Each op rounds
    once, as the kernel's under -fmad=false, so on any device this is the
    kernel's K bit for bit (the checks of the CPU tests and chip_smoke.py
    phase 3i)."""
    B, n, m = _dims(P, A)
    r, c = check_blocks(n, m, a_blocks)
    G = n // c
    A = A.expand(B, m, n)
    rho_vec = (1.0 + eqf * (rho_eq_scale - 1.0)) * rho_s[:, None]
    Ab = torch.stack([A[:, g * r:(g + 1) * r, g * c:(g + 1) * c]
                      for g in range(G)], 1)           # (B, G, r, c)
    rb = rho_vec.reshape(B, G, r)
    v = P.new_zeros((B, G, c, c))
    for kk in range(r):
        t = Ab[:, :, kk, :] * rb[:, :, kk, None]
        v = v + t[..., :, None] * Ab[:, :, kk, None, :]
    K = torch.zeros_like(P) + P
    for g in range(G):
        sl = slice(g * c, (g + 1) * c)
        K[:, sl, sl] = v[:, g] + P[:, sl, sl]
    diag = K.diagonal(dim1=-2, dim2=-1)
    diag.copy_(diag + sigma)
    return K, rho_vec.contiguous()


def _rows_dot(M, x, lanes: int):
    """Each row of M (B, rows, n) against x (B, n) in M's dtype: over j in
    index order from 0 (`lanes` 1 or 2, the warp paths), or as 32 partials
    over j = l, l + 32, ... each from 0, summed in order of l (`lanes` 32,
    the block paths)."""
    n = M.shape[2]
    if lanes != LAYOUT["max_lanes"]:
        v = M.new_zeros(M.shape[:2])
        for j in range(n):
            v = v + M[:, :, j] * x[:, j, None]
        return v
    parts = []
    for ln in range(LAYOUT["max_lanes"]):
        p = M.new_zeros(M.shape[:2])
        for j in range(ln, n, LAYOUT["max_lanes"]):
            p = p + M[:, :, j] * x[:, j, None]
        parts.append(p)
    v = parts[0]
    for p in parts[1:]:
        v = v + p
    return v


def _a_products(A, x, y, a_blocks, lanes: int):
    """(A x, A' y) in x's dtype as the kernels sum them: A's block rows and
    A' y's columns in index order over the declared blocks, or a dense A's
    rows by `_rows_dot` and its columns over k in index order."""
    B, n = x.shape
    m = y.shape[1]
    r, cb = check_blocks(n, m, a_blocks)
    A = A.expand(B, m, n).to(x.dtype)
    aty = x.new_zeros((B, n))
    if not r:
        for k in range(m):
            aty = aty + A[:, k, :] * y[:, k, None]
        return _rows_dot(A, x, lanes), aty
    ax = x.new_zeros((B, m))
    k = torch.arange(m, device=x.device)
    j0 = (k // r) * cb
    for jj in range(cb):
        cols = (j0 + jj)[None, :, None].expand(B, m, 1)
        ax = ax + A.gather(2, cols)[..., 0] * x.gather(
            1, (j0 + jj)[None].expand(B, m))
    j = torch.arange(n, device=x.device)
    k0 = (j // cb) * r
    for kk in range(r):
        rws = (k0 + kk)[None, None, :].expand(B, 1, n)
        aty = aty + A.gather(1, rws)[:, 0] * y.gather(
            1, (k0 + kk)[None].expand(B, n))
    return ax, aty


def adapt_in_order(P, q, A, x, z, y, rho_s, a_blocks=None, lanes: int = 1):
    """rho (B,) of `adapt_rho` by elementwise float64 PyTorch ops in the
    kernel's order (solve_tail.h `adapt_warp_rows`, `adapt_block_body`): x
    and y widened to float64, P x (and a dense A's x) as `_rows_dot` sums
    them for `lanes` (the path's: 1 or 2 the warp path, 32 the block
    path), A's block rows and A' y's columns in index order, the seven
    inf-norms NaN-propagating, rho = rho_s sqrt(rp / max(rd, tiny))
    clamped to [1e-3, 1e3] with the bounds rounded to P's dtype first, then
    rounded once to P's dtype.  Each op rounds once, as the kernel's under
    -fmad=false, so on any device this is the kernel's rho bit for bit (the
    checks of the CPU tests and chip_smoke.py phase 3i)."""
    B, n, m = _dims(P, A)
    d = torch.float64
    x, y = x.to(d), y.to(d)
    px = _rows_dot(P.to(d), x, lanes)
    ax, aty = _a_products(A, x, y, a_blocks, lanes)
    z, q = z.to(d), q.to(d)

    def amax(v):    # of absolute values: the kernel's maximum from 0
        return v.amax(dim=1) if v.shape[1] else v.new_zeros((B,))

    def const(v):   # T(v) widened, as the kernel's D(T(v))
        return torch.tensor(v, dtype=P.dtype).to(d).item()

    tiny = const(1e-12)
    rp = amax((ax - z).abs()) / _nanmax(
        _nanmax(amax(ax.abs()), amax(z.abs())), torch.full_like(px[:, 0],
                                                                tiny))
    rd = amax(((px + q) + aty).abs()) / _nanmax(_nanmax(
        amax(px.abs()), _nanmax(amax(q.abs()), amax(aty.abs()))),
        torch.full_like(px[:, 0], tiny))
    r = rho_s.to(d) * torch.sqrt(rp / _nanmax(rd, torch.full_like(rd, tiny)))
    r = _nanmin(_nanmax(r, torch.full_like(r, const(1e-3))),
                torch.full_like(r, const(1e3)))
    return r.to(P.dtype)


def unscale_in_order(P0, q0, A0, l0, u0, xs, ys, D, E, c, status_tol: float,
                     a_blocks=None, lanes: int = 1):
    """(x, y, z, prim, dual, ok) of `unscale` by elementwise PyTorch ops
    in the kernel's order: a row of P (and of a dense A) summed over j in
    index order from 0 (`lanes` 1, the warp path) or as 32 partials over j
    = l, l + 32, ... each from 0, then summed in order of l (`lanes` 32,
    the block path); A's block rows and A' y's columns in index order;
    the maxima NaN-propagating.  On any device the kernel's outputs bit for
    bit."""
    B, n, m = _dims(P0, A0)
    x = D * xs
    y = E * ys / c[:, None]
    px = _rows_dot(P0, x, lanes)
    ax, aty = _a_products(A0, x, y, a_blocks, lanes)
    z = _nanmin(_nanmax(ax, l0), u0)

    def amax(v):    # of absolute values: the kernel's maximum from 0
        return v.amax(dim=1) if v.shape[1] else v.new_zeros((B,))

    prim = amax((ax - z).abs())
    dual = amax(((px + q0) + aty).abs())
    ok = torch.isfinite(x).all(dim=1) & (prim < status_tol)
    return x, y, z, prim, dual, ok


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
    lay = kkt_layout(B, n, m, a_blocks, device_limits(dev)[0],
                     aligned=bulk_rows(P, n * n))
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
    dense = a_blocks is None
    aligned = bulk_rows(P, n * n) and (not dense or bulk_rows(A, m * n))
    lay = adapt_layout(n, m, B, *device_limits(dev), dense, aligned=aligned)
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
    dense = a_blocks is None
    aligned = bulk_rows(P0, n * n) and (not dense or bulk_rows(A0, m * n))
    lay = tail_layout(n, m, B, *device_limits(dev), dense, aligned=aligned)
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
        for entry in _ENTRIES:
            fn = getattr(lib, f"solve_tail_{entry}_launch")
            fn.argtypes = LAUNCH_ARGTYPES + [_PTR]
            fn.restype = _INT
        lib.solve_tail_error_string.argtypes = [_INT]
        lib.solve_tail_error_string.restype = ctypes.c_char_p
        lib.solve_tail_layout.argtypes = [_INT]
        lib.solve_tail_layout.restype = _INT
        lib.solve_tail_last_layout.argtypes = [_INT, _INT]
        lib.solve_tail_last_layout.restype = ctypes.c_longlong
        for name, count in (("adapt_smem_bytes", 6), ("kkt_smem_bytes", 5),
                            ("unscale_smem_bytes", 6)):
            fn = getattr(lib, f"solve_tail_{name}")
            fn.argtypes = [_INT] * count
            fn.restype = ctypes.c_longlong
        got = [lib.solve_tail_layout(i) for i in range(len(LAYOUT))]
        if got != list(LAYOUT.values()):
            raise RuntimeError(f"solve_tail: the library's layout {got} is "
                               f"not qp/tail.py's {list(LAYOUT.values())}")
        _LIBS["solve_tail"] = lib
    return lib


def last_layout(entry: str) -> TailLayout:
    """The geometry the library's last launch of `entry` ("kkt", "adapt",
    "unscale") took, as it reports it (chip_smoke.py holds it against the
    layout functions)."""
    lib = _library()
    k = _ENTRIES.index(entry)
    threads, blocks, smem, lanes = (int(lib.solve_tail_last_layout(k, i))
                                    for i in range(4))
    path = ("tiles" if entry == "kkt" else
            "warp" if lanes in (1, 2) else "block")
    return TailLayout(path, threads, blocks, smem, lanes)


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
