"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by nvcc, at
first use, into its own shared library under `kernels/build/` (listed in
.gitignore), then loaded with ctypes. A library newer than its source is
reused. nvcc writes under a temporary name that is renamed into place, so
concurrent first uses never load a half-written file. Nothing here runs at
import time: the CPU tests import every module of the package.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "kernels", "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, dict] = {}  # name -> {"seconds", "ptxas"} of this process's builds


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def build(name: str) -> str:
    """Compile csrc/<name>.cu into build/lib<name>.so unless it is current;
    returns the library path. Raises with nvcc's output on failure."""
    src = os.path.join(CSRC, f"{name}.cu")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_log[name] = {"seconds": time.perf_counter() - t0,
                       "ptxas": (r.stdout + r.stderr).strip()}
    return so


def build_all() -> list[str]:
    """Build every kernel source of the package (csrc/*.cu) with one nvcc
    each, all started together; returns the library paths. Raises on the
    first failure, after every build has ended."""
    names = sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = [pool.submit(build, n) for n in names]
    return [f.result() for f in futures]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _loaded[name] = lib
    return lib
