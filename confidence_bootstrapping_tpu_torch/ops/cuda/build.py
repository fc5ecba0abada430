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
KERNEL_SOURCES = ("tpconv_rec", "tpconv_pb", "tpconv_cross_rev", "tpconv_rec_g", "tpconv_cross_g", "tpconv_edge",
                  "tpconv_bwd", "tpconv_cross")
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


def stale(names=KERNEL_SOURCES) -> list:
    """The libraries missing from ``build/torch_kernels`` or older than their
    sources: what ``load`` would build first."""
    return [n for n in names if _stale(n)]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building every kernel source
    first if any is missing or stale."""
    with _lock:
        if name not in _libs:
            if stale():
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


def hgmma_counts(names=KERNEL_SOURCES) -> dict:
    """{name: HGMMA (wgmma) instructions in the built library's SASS}, by
    ``cuobjdump -sass``: above zero where a kernel runs on the tensor cores."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    counts = {}
    for name in names:
        sass = subprocess.run([cuobjdump, "-sass", os.path.join(BUILD_DIR, f"lib{name}.so")], capture_output=True,
                              text=True, check=True).stdout
        counts[name] = sum(" HGMMA." in line for line in sass.splitlines())
    return counts


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({lib.cbt_error_string(code).decode()})")
