"""The C++ data loader (``loader.cc``, a copy of the JAX package's), built
with g++ at first use into the package's ``_build/`` and bound with ctypes.

Two dataset kinds:

- ``native_image``: synthetic images assembled by the C++ worker pool
  (xoshiro256++ uniforms, so the values differ from ``SyntheticImages``;
  the contract is the same: batch ``i`` is a pure function of ``(seed,
  i)``);
- ``record_file_image``: fixed-size binary records (CIFAR-10's layout:
  ``label_bytes`` little-endian label bytes, then the uint8 payload),
  shuffled per epoch, scaled to [0, 1) float32, and augmented (crop and
  flip, ``data.augment_images``'s bits) inside the worker pool.

There is no numpy fallback: where the library cannot be built, making the
dataset raises, so a run never measures another generator than the one it
names. ``iter_from`` streams through the threaded prefetch ring;
``batch(i)`` uses the synchronous fill.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_M64 = (1 << 64) - 1
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "loader.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17", "-Wall")
_LOCK = threading.Lock()
_LIB: list = []


def splitmix64(x: int) -> int:
    """loader.cc's splitmix64 on Python ints (64-bit wrap)."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def library_path() -> str:
    """``_build/libloader-<hash>.so``: the hash covers the source and the
    flags, so an edited source never loads a stale library."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libloader-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile ``loader.cc`` unless its library exists; raise on failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++ or $CXX) to build the "
                           "native data loader")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"  # publish atomically
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, _SRC, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"native loader build failed ({cxx} exited "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    sigs = {
        "ddl_loader_create_synthetic": (vp, [i64, i64, i64, ctypes.c_uint64,
                                             ctypes.c_int, ctypes.c_int]),
        "ddl_loader_create_file": (vp, [ctypes.c_char_p, i64, i64, i64,
                                        ctypes.c_uint64, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int]),
        "ddl_loader_num_records": (i64, [vp]),
        "ddl_loader_enable_augment": (None, [vp, i64, i64, i64, i64,
                                             ctypes.c_int]),
        "ddl_loader_fill": (None, [vp, i64, f32p, i32p]),
        "ddl_loader_start": (None, [vp, i64]),
        "ddl_loader_next": (i64, [vp, f32p, i32p]),
        "ddl_loader_destroy": (None, [vp]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def load_library() -> ctypes.CDLL:
    """The bound loader library, built at the first call."""
    with _LOCK:
        if not _LIB:
            _LIB.append(_bind(ctypes.CDLL(build())))
        return _LIB[0]


def _ptrs(data: np.ndarray, labels: np.ndarray):
    return (data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))


class _Handle:
    """Owns one C++ Loader; releases it when collected."""

    def __init__(self, lib, ptr):
        if not ptr:
            raise RuntimeError("native loader creation failed")
        self.lib, self.ptr = lib, ptr

    def __del__(self):
        if getattr(self, "ptr", None):
            self.lib.ddl_loader_destroy(self.ptr)
            self.ptr = None

    def fill(self, index: int, data: np.ndarray, labels: np.ndarray):
        self.lib.ddl_loader_fill(self.ptr, index, *_ptrs(data, labels))

    def start(self, index: int):
        self.lib.ddl_loader_start(self.ptr, index)

    def next(self, data: np.ndarray, labels: np.ndarray) -> int:
        return self.lib.ddl_loader_next(self.ptr, *_ptrs(data, labels))


def _as_image(flat: np.ndarray, size: int, channels: int, layout: str):
    b = flat.shape[0]
    if layout == "chw":  # CIFAR-10 binary is planar; the models take NHWC
        return flat.reshape(b, channels, size, size).transpose(0, 2, 3, 1)
    return flat.reshape(b, size, size, channels)


class _NativeDataset:
    """The stream over one C++ loader: ``batch(i)`` fills synchronously,
    ``iter_from(i)`` restarts the worker pool's ring at ``i``."""

    def _buffers(self):
        return (np.empty((self.batch_size, self._sample), np.float32),
                np.empty((self.batch_size,), np.int32))

    def batch(self, index: int):
        data, labels = self._buffers()
        self._h.fill(index, data, labels)
        return self._pack(data, labels)

    def iter_from(self, start: int = 0):
        # One prefetch ring per dataset: a newer iterator takes the stream
        # over, and the superseded one fails instead of yielding the new
        # stream's batches.
        self._gen += 1
        gen = self._gen
        self._h.start(start)
        while True:
            if self._gen != gen:
                raise RuntimeError(
                    "a newer iter_from() took over this native loader; "
                    "create a separate dataset for concurrent iteration")
            data, labels = self._buffers()
            if self._h.next(data, labels) < 0:
                # Stop() interrupted the wait: the buffers were never
                # written.
                raise RuntimeError("native loader stream stopped "
                                   "(superseded or shutting down)")
            yield self._pack(data, labels)

    def __iter__(self):
        return self.iter_from(0)


@dataclasses.dataclass
class NativeSyntheticImages(_NativeDataset):
    """Synthetic image batches assembled by the C++ worker pool."""

    batch_size: int
    image_size: int = 32
    channels: int = 3
    num_classes: int = 10
    seed: int = 0
    num_threads: int = 2
    prefetch_depth: int = 4

    def __post_init__(self):
        self._sample = self.image_size * self.image_size * self.channels
        self._gen = 0
        lib = load_library()
        self._h = _Handle(lib, lib.ddl_loader_create_synthetic(
            self.batch_size, self._sample, self.num_classes, self.seed,
            self.num_threads, self.prefetch_depth))

    def _pack(self, data, labels):
        return {"image": _as_image(data, self.image_size, self.channels,
                                   "hwc"),
                "label": labels}


@dataclasses.dataclass
class RecordFileImages(_NativeDataset):
    """A binary fixed-record image file (CIFAR-10 style) via the C++
    loader; ``augment`` crops and flips in the worker pool (the eval split
    never augments: ``config.eval_dataset_kwargs``)."""

    path: str
    batch_size: int
    image_size: int = 32
    channels: int = 3
    label_bytes: int = 1
    layout: str = "chw"  # payload order in the file
    shuffle: bool = True
    seed: int = 0
    num_threads: int = 2
    prefetch_depth: int = 4
    augment: bool = False
    aug_pad: int = 4

    def __post_init__(self):
        if not self.path:
            raise ValueError("record_file_image requires data.path")
        self._sample = self.image_size * self.image_size * self.channels
        self._gen = 0
        lib = load_library()
        self._h = _Handle(lib, lib.ddl_loader_create_file(
            self.path.encode(), self.batch_size,
            self._sample + self.label_bytes, self.label_bytes, self.seed,
            self.num_threads, self.prefetch_depth, int(self.shuffle)))
        if self.augment:
            lib.ddl_loader_enable_augment(
                self._h.ptr, self.aug_pad, self.image_size, self.image_size,
                self.channels, int(self.layout == "chw"))

    @property
    def num_records(self) -> int:
        return int(self._h.lib.ddl_loader_num_records(self._h.ptr))

    def _pack(self, data, labels):
        return {"image": _as_image(data, self.image_size, self.channels,
                                   self.layout),
                "label": labels}
