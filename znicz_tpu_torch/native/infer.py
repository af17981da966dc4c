"""ctypes binding of the native inference runtime (``infer_core.cpp``,
the libVeles/libZnicz rebuild) — the port of
``znicz_tpu/native/infer.py``.

``NativeForward(path)`` loads a utils/export.py forward package entirely
in C++ (ZIP + NPY + manifest parsing, an f32 op set on the host CPU) and
serves ``__call__(x) -> np.ndarray`` like ``ExportedForward``, with no
Python or torch in the serving path after load: ``serve --native``.  It
runs on the host because the user chose it, not as a fallback.

``infer_core.cpp`` is a byte-for-byte copy of the reference's source
(the drift check in tests/test_torch_port_isolation.py), built at first
use by ``native.build`` with ``-lz``.  One divergence: the reference's
``available()`` lets its callers serve something else when no compiler
or zlib is found; here :func:`lib` raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from znicz_tpu_torch import native

SOURCE = Path(__file__).resolve().parent / "infer_core.cpp"
#: the runtime reads the package's deflated members through zlib
LINK_FLAGS = ("-lz",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def lib() -> ctypes.CDLL:
    """The loaded runtime, built on first use; raises when it cannot be
    built."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(native.build(SOURCE, LINK_FLAGS)))
            so.znicz_infer_load.argtypes = [ctypes.c_char_p]
            so.znicz_infer_load.restype = ctypes.c_void_p
            so.znicz_infer_error.argtypes = [ctypes.c_void_p]
            so.znicz_infer_error.restype = ctypes.c_char_p
            so.znicz_infer_input_rank.argtypes = [ctypes.c_void_p]
            so.znicz_infer_input_rank.restype = ctypes.c_int
            so.znicz_infer_input_shape.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
            so.znicz_infer_output_numel.argtypes = [ctypes.c_void_p]
            so.znicz_infer_output_numel.restype = ctypes.c_int64
            so.znicz_infer_run.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
            so.znicz_infer_run.restype = ctypes.c_int
            so.znicz_infer_free.argtypes = [ctypes.c_void_p]
            _lib = so
        return _lib


class NativeForward:
    """A forward package served by the C++ runtime.

    Usable directly as a serve/engine.py backend: the C++ op set takes
    any batch length, so ``static_shapes = False`` tells the engine to
    skip bucket padding (there is no per-shape graph on this path).
    """

    #: nothing materializes per shape: the engine serves exact sizes
    static_shapes = False

    def __init__(self, path: str) -> None:
        L = lib()
        self._lib = L
        self._h = L.znicz_infer_load(os.fsencode(path))
        if not self._h:
            raise ValueError(
                f"cannot load {path!r}: "
                f"{L.znicz_infer_error(None).decode()}")
        rank = L.znicz_infer_input_rank(self._h)
        shape = (ctypes.c_int64 * rank)()
        L.znicz_infer_input_shape(self._h, shape)
        self.input_shape = tuple(int(d) for d in shape)
        self.output_numel = int(L.znicz_infer_output_numel(self._h))
        # serving metadata parity with ExportedForward (GET / reports it)
        self.meta = {"format": "znicz_tpu.forward", "runtime": "native",
                     "input_shape": list(self.input_shape)}

    def __call__(self, x) -> np.ndarray:
        if not self._h:
            raise RuntimeError("NativeForward is closed")
        x = np.ascontiguousarray(x, np.float32)
        if x.shape[1:] != self.input_shape:
            raise ValueError(f"input shape {x.shape[1:]} != package "
                             f"input {self.input_shape}")
        batch = x.shape[0]
        out = np.empty(batch * self.output_numel, np.float32)
        rc = self._lib.znicz_infer_run(
            self._h, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(batch),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise RuntimeError(
                self._lib.znicz_infer_error(self._h).decode())
        return out.reshape(batch, -1)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.znicz_infer_free(self._h)
            self._h = None

    def __del__(self):  # noqa: D105 — best-effort native cleanup
        try:
            self.close()
        except Exception:  # pragma: no cover
            pass
