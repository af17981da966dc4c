"""Logger mixin — rebuild of veles/logger.py :: Logger.

Every framework object mixes this in to get a named, lazily-created logger
(``self.info(...)``, ``self.debug(...)``, ...).  The reference adds colored
console output and an optional MongoDB sink; here the sinks are stdlib
logging: the human-readable console format by default, plus an opt-in
JSONL structured stream (``configure(jsonl_path=...)``) so log lines and
the observability plane's point events (znicz_tpu.observe.trace
instants — faults, recompiles, restarts) share ONE machine-readable
file a tool can tail.
"""

from __future__ import annotations

import json
import logging
import os
import time


_configured = False
_jsonl_paths: set[str] = set()


def jsonl_paths() -> list[str]:
    """Paths with an attached JSONL sink (the flight recorder reads the
    newest one's tail into crash artifacts)."""
    return sorted(_jsonl_paths)

#: the observability plane's point events log through this name, so a
#: JSONL sink interleaves them with ordinary log records
EVENT_LOGGER = "znicz_tpu.events"


class JsonlHandler(logging.FileHandler):
    """One JSON object per record: ``{"ts", "level", "logger", "msg"}``
    plus an ``"event"``/``"args"`` pair when the record carries a
    structured observe event (see :func:`event_log`), plus ``"rank"``
    inside an elastic fleet (``$ZNICZ_TPU_ELASTIC_RANK``) so merged
    fleet logs stay attributable per worker.

    ``max_bytes > 0`` bounds the sink with a keep-1 rollover: when the
    next record would cross the limit, the live file is atomically
    renamed to ``<path>.1`` (replacing the previous rollover) and a
    fresh file starts — a long supervised run holds at most
    ``2 * max_bytes`` of events on disk instead of growing without
    limit."""

    def __init__(self, path: str, max_bytes: int = 0) -> None:
        self.max_bytes = int(max_bytes)
        # fleet rank tag: inside an elastic fleet every
        # record carries the worker's rank, so N workers' JSONL streams
        # merge into one attributable log.  Read once — the env is the
        # per-process contract resilience/elastic.py sets at spawn
        # (core must not import the resilience plane, which imports it)
        rank = os.environ.get("ZNICZ_TPU_ELASTIC_RANK")
        try:
            self.rank = int(rank) if rank is not None else None
        except ValueError:
            self.rank = None
        super().__init__(path, mode="a", delay=True)

    def _rollover(self) -> None:
        if self.stream is not None:
            self.stream.close()
            self.stream = None
        os.replace(self.baseFilename, self.baseFilename + ".1")

    def emit(self, record: logging.LogRecord) -> None:
        try:
            doc = {"ts": round(record.created, 6),
                   "iso": time.strftime(
                       "%Y-%m-%dT%H:%M:%S",
                       time.localtime(record.created)),
                   "level": record.levelname,
                   "logger": record.name,
                   "msg": record.getMessage()}
            if self.rank is not None:
                doc["rank"] = self.rank
            event = getattr(record, "observe_event", None)
            if event is not None:
                doc["event"] = event
                doc["args"] = getattr(record, "observe_args", None)
            line = json.dumps(doc) + "\n"
            stream = self.stream or self._open()
            self.stream = stream
            if self.max_bytes and stream.tell() and \
                    stream.tell() + len(line) > self.max_bytes:
                self._rollover()
                stream = self.stream = self._open()
            stream.write(line)
            stream.flush()
        except Exception:  # noqa: BLE001 — logging must never raise
            self.handleError(record)


def configure(level: int = logging.INFO,
              jsonl_path: str | None = None,
              max_bytes: int = 0) -> None:
    """Idempotent logging setup.  The human console format installs
    once; each distinct ``jsonl_path`` additionally attaches ONE
    :class:`JsonlHandler` on the root logger (opt-in — the default
    stays plain text).  ``max_bytes`` bounds the sink via the handler's
    keep-1 rollover (0 = unbounded, the historical behavior)."""
    global _configured
    if not _configured:
        logging.basicConfig(
            level=level,
            format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
            datefmt="%H:%M:%S",
        )
        _configured = True
    if jsonl_path and jsonl_path not in _jsonl_paths:
        handler = JsonlHandler(jsonl_path, max_bytes=max_bytes)
        handler.setLevel(level)
        logging.getLogger().addHandler(handler)
        # observe-plane events log at INFO on the dedicated events
        # logger; when something else configured logging first the root
        # may sit at WARNING, which would silently drop them before the
        # sink — pin the events logger to the sink's level
        events = logging.getLogger(EVENT_LOGGER)
        if events.getEffectiveLevel() > level:
            events.setLevel(level)
        _jsonl_paths.add(jsonl_path)


def event_log(name: str, args: dict | None) -> None:
    """Observe-plane point events ride the logging tree (INFO on the
    dedicated events logger, default-silent on console at WARNING-level
    roots, captured verbatim by any JSONL sink)."""
    logging.getLogger(EVENT_LOGGER).info(
        "event %s", name,
        extra={"observe_event": name, "observe_args": args or {}})


class Logger:
    """Mixin: named logger + convenience methods."""

    @property
    def logger(self) -> logging.Logger:
        log = getattr(self, "_logger", None)
        if log is None:
            configure()
            log = logging.getLogger(type(self).__name__)
            self._logger = log
        return log

    def debug(self, msg: str, *args) -> None:
        self.logger.debug(msg, *args)

    def info(self, msg: str, *args) -> None:
        self.logger.info(msg, *args)

    def warning(self, msg: str, *args) -> None:
        self.logger.warning(msg, *args)

    def error(self, msg: str, *args) -> None:
        self.logger.error(msg, *args)

    # pickling: loggers hold locks/handlers; drop and recreate lazily
    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_logger", None)
        return state
