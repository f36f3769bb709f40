"""Native (C++) host runtime for FLGP.

The reference's graph-builder hot loops live in C++ under RcppParallel/TBB
(/root/reference/src/Utils.cpp:72-192, /root/reference/src/lae.cpp:15-153);
its Pólya-Gamma draws round-trip to a host package
(reference src/PGLogitModel.h:20-21).  Here the *compute path* is
JAX/XLA on the accelerator; this module is the native runtime around it:

* ``MatrixFile`` / ``write_matrix`` — memory-mapped binary matrices with a
  32-byte header, the on-disk format for datasets larger than host RAM.
* ``StreamLoader`` — double-buffered chunked row reader (prefetch thread)
  feeding the n-sharded spectral pipeline.
* ``knn`` / ``lae_weights`` — threaded host-side brute-force kNN and LAE
  (std::thread pool), used for CPU pre-processing of out-of-core datasets
  and as independent oracles for the JAX kernels.
* ``polya_gamma`` — Devroye PG(b, c) sampler, the statistical oracle for the
  on-device vectorized sampler in ``flgp_tpu.ops.polya_gamma``.

Built on demand with g++ (C ABI + ctypes; no pybind11 in this image).  Every
entry point raises ``NativeUnavailable`` if no toolchain exists, so the pure
JAX path never depends on this module.
"""

from __future__ import annotations

import ctypes
import os
import queue
import subprocess
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "flgp_host.cpp")
_LIB_PATH = os.path.join(_HERE, "libflgp_host.so")

_DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.float64): 1, np.dtype(np.int32): 2}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}


class NativeUnavailable(RuntimeError):
    """Raised when the native library cannot be built or loaded."""


_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None


def build(force: bool = False) -> str:
    """Compile the shared library (idempotent; rebuilds if the source is newer)."""
    if (
        not force
        and os.path.exists(_LIB_PATH)
        and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)
    ):
        return _LIB_PATH
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
        "-DNDEBUG", _SRC, "-o", _LIB_PATH,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeUnavailable(f"g++ failed:\n{proc.stderr[-2000:]}")
    return _LIB_PATH


def _load() -> ctypes.CDLL:
    global _lib, _lib_error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _lib_error is not None:
            raise NativeUnavailable(_lib_error)
        try:
            path = build()
            lib = ctypes.CDLL(path)
        except (OSError, NativeUnavailable) as e:  # pragma: no cover
            _lib_error = str(e)
            raise NativeUnavailable(_lib_error) from e

        i64, i32, u64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64
        p = ctypes.c_void_p
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        i32p = ctypes.POINTER(ctypes.c_int32)

        lib.flgp_knn.argtypes = [f32p, i64, i64, f32p, i64, i64, i32p, f32p, i32]
        lib.flgp_knn.restype = None
        lib.flgp_lae.argtypes = [f32p, i64, i64, f32p, i32p, i64, i32, f32p, i32]
        lib.flgp_lae.restype = None
        lib.flgp_pg_draw.argtypes = [u64, i32p, f64p, i64, f64p, i32]
        lib.flgp_pg_draw.restype = None
        lib.flgp_matrix_write.argtypes = [ctypes.c_char_p, p, i64, i64, i32]
        lib.flgp_matrix_write.restype = i64
        lib.flgp_matrix_open.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(i64), ctypes.POINTER(i64), ctypes.POINTER(i32)
        ]
        lib.flgp_matrix_open.restype = p
        lib.flgp_matrix_read.argtypes = [p, i64, i64, ctypes.c_void_p]
        lib.flgp_matrix_read.restype = i64
        lib.flgp_matrix_prefetch.argtypes = [p, i64, i64]
        lib.flgp_matrix_prefetch.restype = None
        lib.flgp_matrix_close.argtypes = [p]
        lib.flgp_matrix_close.restype = None
        lib.flgp_knn_stream.argtypes = [p, f32p, i64, i64, i64, i32p, f32p, i32]
        lib.flgp_knn_stream.restype = i64
        lib.flgp_hardware_threads.argtypes = []
        lib.flgp_hardware_threads.restype = ctypes.c_int

        _lib = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


# ---------------------------------------------------------------------------
# Threaded host kernels
# ---------------------------------------------------------------------------


def knn(X: np.ndarray, U: np.ndarray, r: int, n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Host brute-force kNN: (indices (n, r) int32, sqdists (n, r) f32)."""
    lib = _load()
    X = np.ascontiguousarray(X, np.float32)
    U = np.ascontiguousarray(U, np.float32)
    n, d = X.shape
    s = U.shape[0]
    idx = np.empty((n, r), np.int32)
    dist = np.empty((n, r), np.float32)
    lib.flgp_knn(_f32p(X), n, d, _f32p(U), s, r, _i32p(idx), _f32p(dist), n_threads)
    return idx, dist


def lae_weights(
    X: np.ndarray, U: np.ndarray, knn_idx: np.ndarray, iters: int = 150, n_threads: int = 0
) -> np.ndarray:
    """Host LAE weights (n, r) matching flgp_tpu.ops.lae.lae_weights."""
    lib = _load()
    X = np.ascontiguousarray(X, np.float32)
    U = np.ascontiguousarray(U, np.float32)
    knn_idx = np.ascontiguousarray(knn_idx, np.int32)
    n, d = X.shape
    r = knn_idx.shape[1]
    w = np.empty((n, r), np.float32)
    lib.flgp_lae(_f32p(X), n, d, _f32p(U), _i32p(knn_idx), r, iters, _f32p(w), n_threads)
    return w


def polya_gamma(seed: int, b: np.ndarray, c: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """PG(b_i, c_i) draws (integer counts), Devroye sampler."""
    lib = _load()
    b = np.ascontiguousarray(b, np.int32)
    c = np.ascontiguousarray(c, np.float64)
    out = np.empty(c.shape, np.float64)
    lib.flgp_pg_draw(np.uint64(seed), _i32p(b), _f64p(c), c.size, _f64p(out), n_threads)
    return out


def hardware_threads() -> int:
    return int(_load().flgp_hardware_threads())


# ---------------------------------------------------------------------------
# Memory-mapped matrix files + streaming loader
# ---------------------------------------------------------------------------


def write_matrix(path: str, data: np.ndarray) -> None:
    """Write a 2-D array in the FLGP0001 mmap format."""
    lib = _load()
    data = np.ascontiguousarray(data)
    code = _DTYPE_CODES.get(data.dtype)
    if code is None:
        raise ValueError(f"unsupported dtype {data.dtype}")
    rc = lib.flgp_matrix_write(
        path.encode(), data.ctypes.data_as(ctypes.c_void_p), data.shape[0], data.shape[1], code
    )
    if rc != 0:
        raise OSError(f"flgp_matrix_write({path}) failed with code {rc}")


class MatrixFile:
    """Memory-mapped read-only matrix (rows served by the native loader)."""

    def __init__(self, path: str):
        lib = _load()
        rows = ctypes.c_int64()
        cols = ctypes.c_int64()
        code = ctypes.c_int32()
        handle = lib.flgp_matrix_open(
            path.encode(), ctypes.byref(rows), ctypes.byref(cols), ctypes.byref(code)
        )
        if not handle:
            raise OSError(f"cannot open {path} as an FLGP matrix")
        self._lib = lib
        self._handle = handle
        self.shape = (rows.value, cols.value)
        self.dtype = _CODE_DTYPES[code.value]

    def read(self, start: int, count: int) -> np.ndarray:
        count = min(count, self.shape[0] - start)
        out = np.empty((max(count, 0), self.shape[1]), self.dtype)
        got = self._lib.flgp_matrix_read(
            self._handle, start, count, out.ctypes.data_as(ctypes.c_void_p)
        )
        return out[:got]

    def prefetch(self, start: int, count: int) -> None:
        self._lib.flgp_matrix_prefetch(self._handle, start, count)

    def knn_stream(
        self, U: np.ndarray, r: int, chunk_rows: int = 1 << 16, n_threads: int = 0
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Out-of-core kNN over the whole file without materializing X."""
        if self.dtype != np.float32:
            raise ValueError("knn_stream requires a float32 matrix")
        U = np.ascontiguousarray(U, np.float32)
        n = self.shape[0]
        idx = np.empty((n, r), np.int32)
        dist = np.empty((n, r), np.float32)
        got = self._lib.flgp_knn_stream(
            self._handle, _f32p(U), U.shape[0], r, chunk_rows, _i32p(idx), _f32p(dist), n_threads
        )
        if got != n:
            raise OSError("knn_stream failed")
        return idx, dist

    def close(self) -> None:
        if self._handle:
            self._lib.flgp_matrix_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class StreamLoader:
    """Double-buffered chunk iterator over a MatrixFile.

    A background thread reads (and madvise-prefetches) the next chunk while
    the caller consumes the current one — host IO overlaps device compute
    when feeding row shards to the sharded spectral pipeline.
    """

    def __init__(self, mat: MatrixFile, chunk_rows: int, depth: int = 2):
        self.mat = mat
        self.chunk_rows = chunk_rows
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._thread: Optional[threading.Thread] = None

    def _producer(self):
        n = self.mat.shape[0]
        for lo in range(0, n, self.chunk_rows):
            self.mat.prefetch(lo + self.chunk_rows, self.chunk_rows)
            self._q.put((lo, self.mat.read(lo, self.chunk_rows)))
        self._q.put(None)

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item
