"""Flight recorder — self-contained crash post-mortems, the port of
``znicz_tpu/observe/flight.py``.

When a process dies, the telemetry that explains why dies with it: the
tracer ring, the watchtower's time series and the registry are all in
memory.  ``dump()`` freezes them into one atomically written
``flight_<ts>_<reason>.json`` artifact:

- the newest N trace-ring events (``workflow.step`` spans around the
  crash, the failing delivery marked ``error: true`` by the run loop,
  plus every ``resilience.*`` and ``watchtower.trip`` instant);
- the last K samples of the global watchtower ring (a fresh sample is
  taken at dump time, so even a never-sampled process records its
  state at the moment of failure);
- the registry snapshot, the registered live planes, a config and
  device fingerprint, and the tail of the JSONL log sink when one is
  configured.

Triggers: explicit ``dump()``; the supervisor dumps into its snapshot
directory before every restore-and-resume and on budget exhaustion;
``auto_dump()`` fires on injected faults and watchtower rule trips but
is a no-op until ``configure(dir=...)`` opts in, and is rate-limited to
one artifact per ``min_interval_s``.

The artifact's schema is the reference's, so its viewer reads the
port's artifacts.  One field differs: the fingerprint's ``mesh`` names
the CUDA device, and a ``torch`` entry the torch and CUDA versions, and
both only when CUDA is already initialized in the process
(``torch.cuda.is_initialized()``) — a dump never boots the card, as the
reference's never boots a backend.
"""

from __future__ import annotations

import json
import os
import platform
import sys
import time
from typing import Optional

from znicz_tpu_torch.core import logger as _logger
from znicz_tpu_torch.observe import registry as _reg
from znicz_tpu_torch.observe import trace as _trace
from znicz_tpu_torch.observe import watchtower as _watchtower

#: artifact schema identifier, the reference's
SCHEMA = "znicz_tpu.flight/2"
_READABLE_SCHEMAS = ("znicz_tpu.flight/1", SCHEMA)

#: auto-dump configuration (process-global); ``dir=None`` keeps
#: auto_dump a no-op
_config = {"dir": None, "last_spans": 256, "last_samples": 120,
           "log_lines": 200, "min_interval_s": 1.0}
# None, not 0.0: time.monotonic() counts from boot, so on a machine up
# for less than min_interval_s a 0.0 sentinel would read as "dumped
# recently" and suppress the first artifact
_last_auto_dump: Optional[float] = None


def configure(dir: Optional[str] = None, last_spans: int = 256,
              last_samples: int = 120, log_lines: int = 200,
              min_interval_s: float = 1.0) -> None:
    """Opt in to automatic dumps into ``dir``, at most one per
    ``min_interval_s``; ``configure()`` with no dir disables.
    Reconfiguring resets the rate limiter."""
    global _last_auto_dump
    _config.update(dir=dir, last_spans=int(last_spans),
                   last_samples=int(last_samples),
                   log_lines=int(log_lines),
                   min_interval_s=float(min_interval_s))
    _last_auto_dump = None


def configured() -> bool:
    return _config["dir"] is not None


#: live-subsystem snapshot providers embedded into every artifact under
#: ``planes``: name -> zero-arg callable returning a JSON-able dict (the
#: continuous batcher registers its admission ledger).  Newest
#: registration per name wins; a raising provider degrades to an error
#: string.
_planes: dict = {}


def register_plane(name: str, fn) -> None:
    _planes[str(name)] = fn


def unregister_plane(name: str, fn=None) -> None:
    """Remove a provider — with ``fn`` given, only if it is still the
    registered one (a torn-down batcher must not evict its
    replacement)."""
    if fn is None or _planes.get(str(name)) is fn:
        _planes.pop(str(name), None)


def planes() -> dict:
    """Snapshot of every registered provider's current document."""
    return {name: fn() for name, fn in list(_planes.items())}


def _jsonable(value):
    """Best-effort JSON coercion for config trees (numpy scalars,
    tuples) — a fingerprint must never fail a dump."""
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set)):
        return [_jsonable(v) for v in value]
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    try:
        return float(value)
    except (TypeError, ValueError):
        return repr(value)


def _config_fingerprint() -> dict:
    """The active config tree and the device — enough to answer "what
    was this process running" from the artifact alone."""
    out: dict = {"argv": list(sys.argv)}
    try:
        from znicz_tpu_torch.core.config import root

        out["root"] = _jsonable(root.as_dict())
    except Exception:  # noqa: BLE001 — fingerprint is best-effort
        out["root"] = None
    out["mesh"] = None
    torch = sys.modules.get("torch")
    # only a CUDA context that already exists: a dump never boots the card
    if torch is not None and torch.cuda.is_initialized():
        try:
            from znicz_tpu_torch.snapshotter import process_rank_world

            dev = torch.cuda.current_device()
            out["mesh"] = {"platform": "gpu",
                           "device_kind": torch.cuda.get_device_name(dev),
                           "device_count": torch.cuda.device_count(),
                           "process_index": process_rank_world()[0]}
            out["torch"] = {"version": torch.__version__,
                            "cuda": torch.version.cuda}
        except Exception:  # noqa: BLE001
            out["mesh"] = None
    return out


def _log_tail(max_lines: int) -> list:
    """Tail of the newest configured JSONL log sink ([] without one)."""
    paths = [p for p in _logger.jsonl_paths() if os.path.isfile(p)]
    if not paths:
        return []
    newest = max(paths, key=os.path.getmtime)
    try:
        with open(newest, "rb") as f:
            # at most ~256 KiB off the end: a dump stays O(artifact)
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - 262144))
            lines = f.read().decode("utf-8", "replace").splitlines()
    except OSError:
        return []
    return lines[-max_lines:]


def build_artifact(reason: str, extra: Optional[dict] = None,
                   last_spans: Optional[int] = None,
                   last_samples: Optional[int] = None) -> dict:
    """Assemble (but do not write) one flight document."""
    n_spans = last_spans if last_spans is not None else \
        _config["last_spans"]
    n_samples = last_samples if last_samples is not None else \
        _config["last_samples"]
    # one fresh ring sample: >= 1 time-series sample even in a process
    # that never attached the watchtower
    tower = _watchtower.WATCHTOWER
    tower.flight_sample()
    ts_doc = tower.ring.to_dict(last_n=n_samples)
    ts_doc["summary"] = tower.ring.summary()
    ts_doc["rules"] = [r.snapshot() for r in tower.rules]
    docs = {}
    for name, fn in list(_planes.items()):
        try:
            docs[name] = _jsonable(fn())
        except Exception as exc:  # noqa: BLE001 — a dead plane must
            docs[name] = {"error": repr(exc)}     # not fail the dump
    now = time.time()
    return {
        "schema": SCHEMA,
        "reason": str(reason),
        "ts": round(now, 6),
        "iso": time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(now)),
        "host": platform.node(),
        "pid": os.getpid(),
        "extra": _jsonable(extra or {}),
        "spans": _trace.TRACER.tail(n_spans),
        "timeseries": ts_doc,
        "metrics": _reg.REGISTRY.snapshot(),
        "planes": docs,
        "config": _config_fingerprint(),
        "log_tail": _log_tail(_config["log_lines"]),
    }


def dump(dir: Optional[str] = None, reason: str = "manual",
         extra: Optional[dict] = None, last_spans: Optional[int] = None,
         last_samples: Optional[int] = None) -> str:
    """Write one flight artifact atomically (tmp + fsync + rename) into
    ``dir`` (default: the configured auto-dump dir, else CWD); returns
    the artifact path."""
    target_dir = dir or _config["dir"] or "."
    os.makedirs(target_dir, exist_ok=True)
    doc = build_artifact(reason, extra, last_spans, last_samples)
    stamp = time.strftime("%Y%m%dT%H%M%S", time.localtime(doc["ts"]))
    micros = int((doc["ts"] % 1) * 1e6)
    slug = "".join(c if c.isalnum() else "_" for c in doc["reason"])[:32]
    path = os.path.join(target_dir,
                        f"flight_{stamp}_{micros:06d}_{slug}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)     # a crash mid-dump leaves no torn artifact
    return path


def auto_dump(reason: str, **ctx) -> Optional[str]:
    """Event-triggered dump (fault fired, rule trip): a no-op until
    :func:`configure` set a directory, rate-limited, and never raises —
    the failure path must not fail harder because the recorder did."""
    global _last_auto_dump
    if _config["dir"] is None:
        return None
    now = time.monotonic()
    if _last_auto_dump is not None and \
            now - _last_auto_dump < _config["min_interval_s"]:
        return None
    try:
        path = dump(reason=reason, extra=ctx)
    except Exception:  # noqa: BLE001
        return None
    # stamped after a successful write: a failed attempt must not arm
    # the rate limiter
    _last_auto_dump = now
    return path


def load(path: str) -> dict:
    """Read and schema-check one artifact."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") not in _READABLE_SCHEMAS:
        raise ValueError(f"{path}: not a flight artifact "
                         f"(schema={doc.get('schema')!r}, "
                         f"expected one of {_READABLE_SCHEMAS})")
    return doc
