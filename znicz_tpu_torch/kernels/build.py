"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``; no PyTorch headers are involved, so a build takes seconds.
Libraries are built at first use into ``znicz_tpu_torch/_build/``
(git-ignored), named by a hash of their source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds
and an unchanged one loads the library already there.
:func:`build` starts one ``nvcc`` per missing library, all together,
and waits for them all.  A failed build raises with the compiler's
output; nothing here falls back to anything.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: -Xptxas -v makes ptxas report registers, shared memory and spills per
#: kernel into the build log beside each library
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}


def nvcc() -> str:
    """Path of ``nvcc`` as ``torch.utils.cpp_extension`` finds it
    (``$CUDA_HOME``, then ``nvcc`` on ``PATH``, then the toolkit's
    default install)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit on this host "
                           "(set CUDA_HOME) — the port's CUDA kernels "
                           "build only where one is installed")
    path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found at {path}")
    return path


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names) -> dict:
    """Build every library in ``names`` that is not built yet, one
    ``nvcc`` each, all started together; returns ``{name: path}``.
    Each build writes a temporary file that is renamed into place, so
    a concurrent or interrupted build never leaves a torn library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        path = paths[name]
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """nvcc's output (ptxas resource usage) from the build of ``name``."""
    return library_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build([name])[name]))
        return lib
