"""Build the CUDA kernels from ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/*.cu`` becomes its own shared library with a plain C interface,
compiled for ``sm_90a`` into ``build/torch_kernels/`` at the repository root
(``.gitignore`` lists ``build/``). All sources compile in parallel, at first
use; nothing is built or loaded when a module is imported, so the package
imports on a machine with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
KERNEL_SOURCES = ("tpconv_rec", "tpconv_pb", "tpconv_cross_rev", "tpconv_rec_g", "tpconv_cross_g")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (set CUDA_HOME)")
    return path


def _stale(name: str) -> bool:
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    if not os.path.exists(lib):
        return True
    deps = [os.path.join(CSRC, f) for f in os.listdir(CSRC) if f == f"{name}.cu" or f.endswith(".cuh")]
    return max(os.path.getmtime(p) for p in deps) > os.path.getmtime(lib)


def build(names=KERNEL_SOURCES) -> dict:
    """Compile the stale libraries, all at once. Returns {name: compiler log}
    (ptxas prints each kernel's registers and shared memory); raises on a
    failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        if _stale(name):
            out = os.path.join(BUILD_DIR, f"lib{name}.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", out, os.path.join(CSRC, f"{name}.cu")]
            procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, p in procs.items():
        logs[name] = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{logs[name]}")
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building every kernel source
    first if any is missing or stale."""
    with _lock:
        if name not in _libs:
            if any(_stale(n) for n in KERNEL_SOURCES):
                build()
            lib = ctypes.CDLL(os.path.join(BUILD_DIR, f"lib{name}.so"))
            lib.cbt_error_string.argtypes = [ctypes.c_int]
            lib.cbt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def timed_build() -> tuple:
    """Force a fresh build of every kernel: (seconds, {name: log})."""
    with _lock:
        for name in KERNEL_SOURCES:
            lib = os.path.join(BUILD_DIR, f"lib{name}.so")
            if os.path.exists(lib) and name not in _libs:
                os.remove(lib)
        t0 = time.perf_counter()
        logs = build()
        return time.perf_counter() - t0, logs


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({lib.cbt_error_string(code).decode()})")
