"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface, so ``nvcc`` compiles it in
seconds into ``_build/lib<name>-<hash>.so`` (the hash covers the source,
every header in ``csrc/`` and the flags, so an edited source or header never
loads a stale library), and ``ctypes`` loads it. Nothing here runs at
import time: the CPU tests import every module on a host with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# name -> nvcc's output of the build that produced the loaded library
# (ptxas registers / shared memory / spills), or "" when it was cached.
BUILD_LOGS: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of distributeddeeplearning_tpu_torch are built from "
        "source at first use"
    )


def _target(name: str) -> tuple[str, str]:
    """(source, library path) of ``csrc/<name>.cu``. The sources include
    headers of ``csrc/`` by name, so the hash takes every one of them."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (src, *headers):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names) -> dict[str, str]:
    """Compile every source in ``names`` that has no current library, one
    ``nvcc`` per source, all started together. Returns name -> .so path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths, procs = {}, {}
    for name in names:
        src, out = _target(name)
        paths[name] = out
        if os.path.exists(out):
            BUILD_LOGS.setdefault(name, "")
            continue
        # Compile to a process-unique path, then publish atomically.
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (tmp, out, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            if os.path.exists(tmp):
                os.unlink(tmp)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _LIBS[name] = lib
        return lib
