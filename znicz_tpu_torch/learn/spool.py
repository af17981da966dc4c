"""Feedback spool — the crash-safe traffic log between the serving
fleet and the trainer; the port of ``znicz_tpu/learn/spool.py``
(standard library only, so a copy of it).

One spool is a DIRECTORY of append-only JSONL segments::

    spool/
        seg_00000000.jsonl      one JSON record per line
        seg_00000001.jsonl      (writers roll at segment_bytes)
        CURSOR.json             the trainer's published consumption floor

**Writers** are the serving workers (`--feedback-spool`): every
accepted request becomes one record appended as a SINGLE ``os.write``
to an ``O_APPEND`` fd — POSIX append atomicity is what lets N worker
processes share one segment without a coordinator, and it fixes a
TOTAL ORDER over records the moment the bytes land, which is the
property the trainer's bit-exact resume stands on (two readers of the
same byte range always see the same records, whenever they read).

**Crash model**: a writer SIGKILL'd mid-``write`` leaves at most one
torn fragment.  If nothing follows it, the fragment just sits at EOF
(never a complete line, never consumed); if another worker appends
after it, the fragment and that line merge into one unparseable line —
the reader counts it (``znicz_learn_spool_torn_total``), skips it, and
keeps going.  Torn traffic is LOST (it was never acknowledged as
trained), never a crash and never a half-parsed record.

**Bounded**: a writer that rolls past ``max_segments`` unlinks the
oldest segment (``znicz_learn_spool_dropped_segments_total``).  A
cursor pointing into a dropped segment fails loudly at read time — a
trainer that fell a whole retention window behind must say so, not
silently skip.

**Reader** (:class:`SpoolReader`): a cursor is ``{"seg", "offset",
"records"}``.  ``read(cursor, n)`` returns exactly the next ``n``
parseable records and the advanced cursor; re-reading from a saved
cursor returns byte-identical results (exactly-once replay — the
snapshot-resume contract of ``loader/spool.py``).  A partial line at
the EOF of the TOP segment is "not written yet" (the reader waits); the
same bytes below a higher segment are "torn by a dead writer" (counted
and skipped) — both verdicts are stable once made, because segments are
never un-created and appended bytes never change.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from znicz_tpu_torch.observe import registry as _reg

SEGMENT_PREFIX = "seg_"
SEGMENT_SUFFIX = ".jsonl"
CURSOR_FILE = "CURSOR.json"

_M_RECORDS = _reg.counter(
    "znicz_learn_spool_records_total",
    "feedback records appended to the spool by serving workers, by "
    "record kind (generate / predict)",
    labelnames=("kind",))
_M_TORN = _reg.counter(
    "znicz_learn_spool_torn_total",
    "unparseable spool lines skipped by the reader — a writer died "
    "mid-append (the record was never acknowledged; skipping is the "
    "crash-safety contract, docs/LEARNING.md)")
_M_DROPPED = _reg.counter(
    "znicz_learn_spool_dropped_segments_total",
    "spool segments unlinked by writer retention (max_segments) — "
    "records a trainer never consumed before the window closed")
_M_LAG = _reg.gauge(
    "znicz_learn_spool_lag_records",
    "complete records in the spool beyond the trainer's consumption "
    "cursor (stamped at each epoch ingest) — the trainer's backlog")


class SpoolTimeout(TimeoutError):
    """``SpoolReader.read`` ran out of wait budget before ``n`` records
    existed — the spool's writers have gone quiet."""


class SpoolGone(RuntimeError):
    """The cursor points into a segment writer retention dropped."""


def segment_name(seq: int) -> str:
    return f"{SEGMENT_PREFIX}{seq:08d}{SEGMENT_SUFFIX}"


def segment_seq(name: str) -> Optional[int]:
    if not (name.startswith(SEGMENT_PREFIX) and
            name.endswith(SEGMENT_SUFFIX)):
        return None
    body = name[len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)]
    return int(body) if body.isdigit() else None


def list_segments(directory: str) -> list:
    """Sorted segment sequence numbers present in ``directory``."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(s for s in (segment_seq(n) for n in names)
                  if s is not None)


def initial_cursor(directory: str) -> dict:
    """Where a cold trainer starts: the oldest RETAINED segment (the
    spool may already have rolled since boot)."""
    segs = list_segments(directory)
    return {"seg": segs[0] if segs else 0, "offset": 0, "records": 0}


def read_cursor_file(directory: str) -> Optional[dict]:
    try:
        with open(os.path.join(directory, CURSOR_FILE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def write_cursor_file(directory: str, cursor: dict) -> None:
    """Atomically publish the trainer's consumption floor — operator
    visibility and retention guidance, NOT the resume authority (that
    is the training snapshot, which carries the cursor inside the
    loader state)."""
    path = os.path.join(directory, CURSOR_FILE)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump({**cursor, "ts": round(time.time(), 3)}, f)
        os.replace(tmp, path)
    except OSError:
        pass                    # full disk must not kill the trainer


class FeedbackSpool:
    """Multi-process-safe spool writer; see module docstring.  One
    instance per worker process; ``append`` is one ``os.write`` to an
    ``O_APPEND`` fd, so concurrent workers interleave whole records,
    never bytes."""

    def __init__(self, directory: str, segment_bytes: int = 16 << 20,
                 max_segments: int = 16) -> None:
        if segment_bytes < 1 or max_segments < 2:
            raise ValueError(f"need segment_bytes >= 1 and "
                             f"max_segments >= 2, got {segment_bytes}/"
                             f"{max_segments}")
        self.directory = str(directory)
        self.segment_bytes = int(segment_bytes)
        self.max_segments = int(max_segments)
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()     # threaded HTTP handlers share
        self._fd: Optional[int] = None    # one writer per process
        self._seq: Optional[int] = None
        self._needs_newline = False       # segment tail is a dead
        #                                   writer's torn fragment

    # -- segment management --------------------------------------------------
    def _open_top(self) -> None:
        """(Re)open the top segment, rolling to a fresh one when the
        top is full; GC segments past the retention window."""
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None
        segs = list_segments(self.directory)
        seq = segs[-1] if segs else 0
        path = os.path.join(self.directory, segment_name(seq))
        try:
            if os.path.getsize(path) >= self.segment_bytes:
                seq += 1
        except OSError:
            pass                          # not created yet: seq stands
        self._seq = seq
        self._fd = os.open(
            os.path.join(self.directory, segment_name(seq)),
            os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        # a segment whose tail is not "\n" ends in a dead writer's torn
        # fragment: prefix our first append with a newline so ONLY the
        # fragment is lost (as its own unparseable line), not our
        # record merged into it.  A racing double-prefix just leaves an
        # empty line, which the reader skips silently.
        try:
            size = os.fstat(self._fd).st_size
            if size:
                with open(os.path.join(self.directory,
                                       segment_name(seq)), "rb") as f:
                    f.seek(size - 1)
                    self._needs_newline = f.read(1) != b"\n"
            else:
                self._needs_newline = False
        except OSError:
            self._needs_newline = False
        # retention: every writer may GC; unlink is idempotent enough
        # (a racing second unlink just ENOENTs)
        for old in [s for s in segs if s <= seq - self.max_segments]:
            try:
                os.unlink(os.path.join(self.directory,
                                       segment_name(old)))
                _M_DROPPED.inc()
            except OSError:
                pass

    def append(self, record: dict) -> None:
        """Append one record (one line, one syscall).  Raises
        ``ValueError`` on a record that does not serialize; swallows
        ``OSError`` after one reopen attempt — feedback must never
        take the serving worker down."""
        line = (json.dumps(record, separators=(",", ":")) + "\n").encode()
        with self._lock:
            for attempt in (0, 1):
                if self._fd is None or \
                        os.fstat(self._fd).st_size >= self.segment_bytes:
                    self._open_top()
                try:
                    if self._needs_newline:
                        line = b"\n" + line
                        self._needs_newline = False
                    os.write(self._fd, line)
                    break
                except OSError:
                    if attempt:           # reopened once already: drop
                        return            # the record, keep serving
                    self._fd = None
        _M_RECORDS.labels(kind=str(record.get("kind", "unknown"))).inc()

    # -- the serving planes' record shapes -----------------------------------
    def append_generate(self, request_id: str, prompt, tokens) -> None:
        """One accepted generation: the prompt and the continuation the
        client actually received, with request-id provenance."""
        self.append({"kind": "generate", "rid": str(request_id),
                     "prompt": [int(t) for t in prompt],
                     "tokens": [int(t) for t in tokens],
                     "ts": round(time.time(), 3)})

    def append_predict(self, request_id: str, inputs, outputs) -> None:
        """One served prediction: the labeled (input, output) pair."""
        self.append({"kind": "predict", "rid": str(request_id),
                     "input": inputs, "output": outputs,
                     "ts": round(time.time(), 3)})

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None


class SpoolReader:
    """Cursor-driven exactly-once reader; see module docstring."""

    def __init__(self, directory: str, poll_s: float = 0.05) -> None:
        self.directory = str(directory)
        self.poll_s = float(poll_s)

    def _segment_path(self, seq: int) -> str:
        return os.path.join(self.directory, segment_name(seq))

    def _scan(self, cursor: dict, budget: Optional[int],
              records: list, count_torn: bool = True) -> dict:
        """One non-blocking sweep from ``cursor``: parse complete lines
        into ``records`` until ``budget`` is met or the data runs out.
        Returns the advanced cursor.  Once the budget is met the cursor
        NEVER advances past a segment boundary — the end cursor of a
        read is therefore canonical (independent of whether a later
        rotation has happened by scan time), which is what lets a
        snapshot's stored span replay to the identical end offset.
        ``count_torn=False`` suppresses the torn counter (lag probes
        re-scan the same backlog every epoch and must not re-count the
        same dead line)."""
        seg = int(cursor["seg"])
        offset = int(cursor["offset"])
        count = int(cursor["records"])
        while budget is None or len(records) < budget:
            path = self._segment_path(seg)
            segs = list_segments(self.directory)
            if not os.path.exists(path):
                if segs and seg < segs[0]:
                    raise SpoolGone(
                        f"cursor points into segment {seg} but the "
                        f"spool retains only {segs[0]}..{segs[-1]} — "
                        f"the trainer fell behind the retention window")
                if segs and seg < segs[-1]:
                    seg += 1              # a gap the GC tore open
                    offset = 0
                    continue
                break                     # top not created yet: no data
            with open(path, "rb") as f:
                f.seek(offset)
                chunk = f.read()
            newline = chunk.rfind(b"\n")
            complete, tail = (chunk[:newline + 1], chunk[newline + 1:]) \
                if newline >= 0 else (b"", chunk)
            # split on \n ONLY (json.dumps output never contains raw
            # control bytes, but a torn fragment must not be re-split
            # on them either)
            for raw in complete.split(b"\n")[:-1]:
                consumed = len(raw) + 1
                if budget is not None and len(records) >= budget:
                    break
                offset += consumed
                if not raw:
                    continue              # writer newline-prefix races
                try:
                    records.append(json.loads(raw))
                    count += 1
                except ValueError:
                    if count_torn:        # merged/torn line: skip it
                        _M_TORN.inc()
            else:
                # every complete line consumed — the budget check comes
                # BEFORE any segment advance: a read that is satisfied
                # exactly at a segment's end must return (seg, end),
                # whether or not a later rotation exists by now
                if budget is not None and len(records) >= budget:
                    break
                if seg < (list_segments(self.directory) or [seg])[-1]:
                    # a higher segment exists: this one is finished;
                    # a leftover fragment is a dead writer's torn line
                    if tail and count_torn:
                        _M_TORN.inc()
                    seg += 1
                    offset = 0
                    continue
                break                     # top segment: wait for more
        return {"seg": seg, "offset": offset, "records": count}

    def read(self, cursor: dict, n: int,
             wait_s: Optional[float] = None) -> tuple:
        """-> ``(records, new_cursor)`` — exactly the next ``n``
        parseable records after ``cursor``.  Blocks up to ``wait_s``
        for writers to produce them (None = do not wait); raises
        :class:`SpoolTimeout` on an exhausted wait and
        :class:`SpoolGone` on a cursor below the retention window.
        Replaying a stored cursor returns identical records — the
        exactly-once contract."""
        if n < 1:
            raise ValueError(f"need n >= 1, got {n}")
        deadline = None if wait_s is None else time.monotonic() + wait_s
        records: list = []
        while True:
            cursor = self._scan(cursor, n, records)
            if len(records) >= n:
                return records, cursor
            if deadline is None or time.monotonic() > deadline:
                raise SpoolTimeout(
                    f"spool {self.directory!r} produced only "
                    f"{len(records)}/{n} records within the wait "
                    f"budget (writers quiet?)")
            time.sleep(self.poll_s)

    def lag(self, cursor: dict) -> int:
        """Complete records currently readable beyond ``cursor`` (the
        trainer's backlog; also stamped on the lag gauge)."""
        records: list = []
        try:
            self._scan(dict(cursor), None, records, count_torn=False)
        except SpoolGone:
            pass
        _M_LAG.set(float(len(records)))
        return len(records)
