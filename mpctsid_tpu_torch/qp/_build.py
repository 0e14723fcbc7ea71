"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each `.cu` file under qp/csrc/ has a plain C interface (no PyTorch headers),
so `nvcc` compiles it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <build dir>/<name>-<hash>.so <sources>

One library per kernel; `build_libraries` starts one `nvcc` per missing
library, all together, and waits for them (what `-Xptxas -v` reports —
registers, spills, static shared memory — is kept in `BUILD_LOG`).

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

__all__ = ["load_library", "build_libraries", "build_dir", "find_nvcc",
           "BUILD_SECONDS", "BUILD_LOG", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> seconds the build took in this process (0.0 when a cached library
# of the same sources was found in the build directory)
BUILD_SECONDS: dict[str, float] = {}
# name -> what nvcc printed when it built the library in this process
BUILD_LOG: dict[str, str] = {}

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


def _target(name: str, sources: tuple[str, ...],
            headers: tuple[str, ...]) -> Path:
    """The library's path: its name carries a hash of sources, headers and
    flags."""
    h = hashlib.sha256()
    for f in (*sources, *headers):
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_libraries(specs) -> None:
    """Build every library of `specs` that the build directory lacks, one
    `nvcc` process each, all started together.

    specs: iterable of (name, sources, headers); file names under qp/csrc/.
    Raises if the toolchain is missing or any build fails."""
    jobs = []
    for name, sources, headers in specs:
        so = _target(name, sources, headers)
        if so.exists():
            BUILD_SECONDS.setdefault(name, 0.0)
            continue
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(CSRC / s) for s in sources]]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, so, tmp, cmd, proc, time.perf_counter()))
    failed = []
    for name, so, tmp, cmd, proc, t0 in jobs:
        out, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed building {name} "
                          f"({' '.join(cmd)}):\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str, sources: tuple[str, ...],
                 headers: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (once per source hash) and load qp/csrc/<sources> as lib<name>."""
    lib = _LIBS.get(name)
    if lib is None:
        build_libraries([(name, sources, headers)])
        lib = ctypes.CDLL(str(_target(name, sources, headers)))
        _LIBS[name] = lib
    return lib
