"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each `.cu` file under qp/csrc/ has a plain C interface (no PyTorch headers),
so `nvcc` compiles it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build dir>/<name>-<source hash>.so <sources>

The build directory is `build/mpctsid_tpu_torch/` beside the package (the
repository's .gitignore lists `build/`); the environment variable
`MPCTSID_TORCH_BUILD_DIR` overrides it.  The library's file name carries a
hash of its sources and flags, so an edited source is never served by a stale
build.  Nothing here runs when the package is imported: a machine without
`nvcc` imports every module, and only a launch on a CUDA tensor reaches
`load_library`, which raises if the toolchain is missing or the build fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load_library", "build_dir", "find_nvcc", "BUILD_SECONDS",
           "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# name -> seconds the build took in this process (0.0 when a cached library
# of the same sources was found in the build directory)
BUILD_SECONDS: dict[str, float] = {}

_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("MPCTSID_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "mpctsid_tpu_torch"


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME / the toolkit PyTorch found / the PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home:
            cand = Path(home) / "bin" / "nvcc"
            if cand.exists():
                return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc was not found (CUDA_HOME, PyTorch's CUDA_HOME, PATH): the "
        "port's CUDA kernels are built from source at first use and cannot "
        "run without the CUDA toolkit")


def load_library(name: str, sources: tuple[str, ...],
                 extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (once per source hash) and load qp/csrc/<sources> as lib<name>."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    paths = [CSRC / s for s in sources]
    h = hashlib.sha256()
    for p in paths:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS + tuple(extra_flags)).encode())
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"lib{name}-{h.hexdigest()[:16]}.so"
    if so.exists():
        BUILD_SECONDS[name] = 0.0
    else:
        nvcc = find_nvcc()
        tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
               *[str(p) for p in paths]]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name} ({' '.join(cmd)}):\n"
                f"{r.stdout}\n{r.stderr}")
        os.replace(tmp, so)
        BUILD_SECONDS[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    return lib
