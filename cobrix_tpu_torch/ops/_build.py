"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` into ``lib<name>.so``, loaded with ``ctypes``. A build is
keyed by a hash of the source and the flags, and lands in
``cobrix_tpu_torch/_build/<hash>/`` (git-ignored), so the first use in a
fresh checkout compiles and later uses load. Only sources in this
package go into a build.

Nothing here runs at import time: the CPU tests import every module,
and a machine without a GPU need not have ``nvcc``.

`count_launch` adds one to a wrapper's ``launches`` counter under a lock:
the pipelined read launches from several worker threads, and a bare
``+=`` on a function attribute can lose counts there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_launch_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> (seconds, ptxas report) of the build this process ran or loaded
build_info: Dict[str, tuple] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of cobrix_tpu_torch compile at "
        "first use and need the CUDA toolkit (set CUDA_HOME or put nvcc "
        "on PATH)")


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], f"lib{name}.so")


def kernel_names() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def build(names: List[str] = None) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together. Returns name -> library path."""
    names = kernel_names() if names is None else list(names)
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    procs = {}
    t0 = time.perf_counter()
    failed = []
    try:
        for n, p in todo.items():
            os.makedirs(os.path.dirname(p), exist_ok=True)
            tmp = f"{p}.{os.getpid()}.tmp"
            procs[n] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                 os.path.join(CSRC, f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp)
        for n, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, paths[n])
            build_info[n] = (time.perf_counter() - t0, log)
    finally:
        # no compiler outlives the call, whatever raised
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for n in names:
        build_info.setdefault(n, (0.0, "loaded from an earlier build"))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _libs[name] = lib
        return lib


def count_launch(wrapper) -> None:
    """One more launch on `wrapper.launches` (a plain int attribute that
    callers read and reset), atomically across threads."""
    with _launch_lock:
        wrapper.launches += 1
