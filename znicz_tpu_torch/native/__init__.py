"""Native host-side loader core — the port of ``znicz_tpu/native``
(C++ through ctypes, as the reference binds its native pieces).

``loader_core.cpp`` and ``infer_core.cpp`` (the C++ inference runtime
of ``infer.py``) are byte-for-byte copies of the reference's sources
(tests/test_torch_port_isolation.py holds them equal).  :func:`build`
compiles one at first use with ``g++ -O3 -shared -fPIC -std=c++17
-pthread`` (and its link flags: ``-lz`` for the runtime's zlib) into
``znicz_tpu_torch/_build/`` (git-ignored), named by a hash of the source
and the flags; the build writes a temporary file that is renamed into
place, so concurrent processes (the tests' workers) never load a torn
library.

One divergence from the reference: the reference quietly serves numpy
when no compiler is found (``native.available()``).  Here a failed
build raises with the compiler's output; the loaders take numpy only
where the reference does for other reasons (a non-contiguous source, a
dtype mismatch).

:func:`gather_rows` is the loaders' minibatch gather: ``dst[i] =
src[idx[i]]``, rows with ``idx < 0`` zeroed, on up to 8 threads.  ctypes
releases the GIL for the call, so a prefetch worker's gather runs beside
the main thread's step issue.  :class:`XorShift128P` is the reference's
native xorshift128+ stream over the same library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / "loader_core.cpp"
BUILD_DIR = _PKG / "_build"
#: the host compiler (the reference's, ``g++``)
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
#: the gather's thread count when the caller gives none (the reference's)
MAX_THREADS = 8

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path(source: Optional[Path] = None,
                 link_flags: tuple = ()) -> Path:
    """Where the library built from ``source`` (``SOURCE`` by default)
    lives: named by the source and by a hash of its bytes, the compiler
    and the flags."""
    source = SOURCE if source is None else source
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join((CXX,) + CXX_FLAGS + tuple(link_flags))
                  .encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def build(source: Optional[Path] = None, link_flags: tuple = ()) -> Path:
    """Compile ``source`` (``SOURCE``, ``loader_core.cpp``, by default)
    unless it is built, with ``link_flags`` after the source (``-lz`` for
    ``infer_core.cpp``); returns the library's path.  Raises with the
    compiler's output when the build fails or the compiler is
    missing."""
    source = SOURCE if source is None else source
    path = library_path(source, link_flags)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(source), "-o", str(tmp), *link_flags]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=180)
    except OSError as exc:
        raise RuntimeError(f"the native {source.stem} cannot be built: "
                           f"{' '.join(cmd)}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the native {source.stem} failed to build "
                           f"({' '.join(cmd)} exited {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, path)
    return path


def lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            so.gather_rows.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int]
            so.gather_rows.restype = None
            so.xorshift128p_fill.argtypes = [
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
            so.xorshift128p_fill.restype = None
            so.shuffle_indices.argtypes = [
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
            so.shuffle_indices.restype = None
            _lib = so
        return _lib


class XorShift128P:
    """The native xorshift128+ stream (the reference PRNG family): the
    reference's splitmix64 seeding and ``loader_core.cpp``'s fill and
    Fisher-Yates shuffle, so a seed gives the reference's bits."""

    def __init__(self, seed: int) -> None:
        # splitmix64 seeding, never an all-zero state; the arithmetic in
        # Python ints (numpy uint64 scalars warn on the wrapping
        # multiplies), stored as uint64
        self.state = np.empty(2, np.uint64)
        mask = (1 << 64) - 1
        z = int(seed or 0xDEADBEEF) & mask
        for i in range(2):
            z = (z + 0x9E3779B97F4A7C15) & mask
            x = z
            x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
            x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
            self.state[i] = np.uint64(x ^ (x >> 31))

    def _state_ptr(self):
        return self.state.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))

    def uniform(self, n: int) -> np.ndarray:
        """``n`` float32 uniforms in [0, 1), advancing the stream."""
        out = np.empty(int(n), np.float32)
        lib().xorshift128p_fill(
            self._state_ptr(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size)
        return out

    def shuffle(self, idx: np.ndarray) -> None:
        """Shuffle a C-contiguous int64 array in place."""
        if idx.dtype != np.int64 or not idx.flags.c_contiguous:
            raise ValueError(f"shuffle needs a C-contiguous int64 array, "
                             f"got {idx.dtype}")
        lib().shuffle_indices(
            self._state_ptr(),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), idx.size)


def gather_rows(src: np.ndarray, idx: np.ndarray, dst: np.ndarray,
                n_threads: int = 0) -> None:
    """``dst[i] = src[idx[i]]`` for every row of ``idx`` (rows with
    ``idx < 0`` zeroed) by the threaded native gather.  ``src`` and
    ``dst`` must be C-contiguous with the same dtype and row shape,
    ``idx`` int64 with one entry a row of ``dst``."""
    if not (src.flags.c_contiguous and dst.flags.c_contiguous):
        raise ValueError("gather_rows needs C-contiguous src and dst")
    if src.dtype != dst.dtype or src.shape[1:] != dst.shape[1:]:
        raise ValueError(f"gather_rows: src {src.dtype}{src.shape} and dst "
                         f"{dst.dtype}{dst.shape} rows differ")
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if idx.shape != (dst.shape[0],):
        raise ValueError(f"gather_rows: {idx.shape} indices for "
                         f"{dst.shape[0]} rows")
    if idx.size and int(idx.max()) >= src.shape[0]:
        raise ValueError(f"gather_rows: index {int(idx.max())} past "
                         f"{src.shape[0]} rows")
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:]))
    if n_threads <= 0:
        n_threads = min(MAX_THREADS, os.cpu_count() or 1)
    lib().gather_rows(
        src.ctypes.data, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dst.ctypes.data, idx.size, row_bytes, n_threads)
