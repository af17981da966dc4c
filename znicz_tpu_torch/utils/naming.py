"""Small shared utilities for the service layer."""

from __future__ import annotations

import hashlib
import os
import re
import threading


def slugify(name) -> str:
    """Free-text display name -> filesystem-safe slug (workflow names
    flow into report/summary paths)."""
    return re.sub(r"[^a-z0-9_.-]+", "_", str(name).lower()) or "workflow"


#: (realpath) -> ((mtime_ns, size), fingerprint dict) — fingerprints of
#: multi-MB packages are polled by readiness probes and adoption gates;
#: re-hashing an UNCHANGED file every tick is pure waste, so the hash is
#: memoized until the file's (mtime, size) identity moves.  Bounded: one entry per distinct package path.
_FP_CACHE: dict = {}
_FP_LOCK = threading.Lock()


def package_fingerprint(path: str) -> dict:
    """Content identity of one export package file — what a serving
    worker reports on ``GET /readyz`` and what a rolling weight update
    gates convergence on: two workers serve the same weights
    iff their fingerprints match, whatever paths the bytes arrived by.

    Deliberately stdlib-only (the fleet modules follow federation.py's
    convention of never importing jax themselves) and
    content-addressed: sha256 over the file bytes, with the basename
    and size as human-readable corroboration.  Cached by
    ``(path, mtime, size)``: repeated probes of an unchanged package
    (readiness polling, the learn plane's adoption gate) answer from
    memory; an atomically replaced package (export/publish both
    tmp+rename, which moves mtime) re-hashes."""
    key = os.path.realpath(path)
    while True:
        st = os.stat(path)
        ident = (st.st_mtime_ns, st.st_size)
        with _FP_LOCK:
            cached = _FP_CACHE.get(key)
            if cached is not None and cached[0] == ident:
                return dict(cached[1])
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        # a concurrent atomic replace between the stat and the read
        # would cache new bytes under the old identity — re-stat and
        # only trust a hash bracketed by one stable identity
        st2 = os.stat(path)
        if (st2.st_mtime_ns, st2.st_size) == ident:
            break
    fp = {"sha256": h.hexdigest(),
          "file": os.path.basename(path),
          "bytes": st.st_size}
    with _FP_LOCK:
        _FP_CACHE[key] = (ident, fp)
    return dict(fp)
