"""Shared utilities: precision policy, device resolution, device constants.

Precision.  The engine's QP core (Newton-Schulz polish of the explicit
inverse, the ADMM fixed point) assumes full-f32 products; with reduced-
precision matmuls the closed loop diverges.  On an NVIDIA card the trap is
TF32, which keeps about three decimal digits.  `enforce_f32_matmuls` switches
it off for matrix products and asserts that it stayed off; every entry point
of the port calls it.  The hand-written kernels use f32 FMAs, except
qp/csrc/admm_mma.cu, whose tensor-core products take every operand split
into two or three TF32 parts and so keep f32 accuracy.

Device.  `resolve_device` turns the `device=` argument of an entry point into
a `torch.device` and raises when CUDA is asked for and absent: no code path
silently continues on the CPU.

Constants.  Model constants (leg placements, gait tables, the friction-
pyramid matrices) are numpy data.  In eager PyTorch, rebuilding them per call
would be a host-to-device copy per tick, so `device_constant` builds each one
once per (key, device, dtype) and hands back the cached tensor.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["enforce_f32_matmuls", "resolve_device", "device_constant"]


def enforce_f32_matmuls() -> None:
    """Pin matrix products to full float32 and assert the setting holds."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if (torch.backends.cuda.matmul.allow_tf32 is not False
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "could not pin matrix products to full float32: allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32}, precision="
            f"{torch.get_float32_matmul_precision()}")


def resolve_device(device="cuda") -> torch.device:
    """`device=` of an entry point -> torch.device; raises if CUDA is absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (CLI: --cpu) to run on the CPU")
    return dev


_CONSTANTS: dict = {}


def device_constant(key, build: Callable[[], np.ndarray], device,
                    dtype=torch.float32) -> torch.Tensor:
    """Tensor of the numpy array `build()` on `device`, built once per
    (key, device, dtype).  Callers must not write into the result."""
    device = torch.device(device)
    full_key = (key, device.type, device.index, dtype)
    t = _CONSTANTS.get(full_key)
    if t is None:
        t = torch.as_tensor(np.asarray(build()), dtype=dtype, device=device)
        _CONSTANTS[full_key] = t
    return t
