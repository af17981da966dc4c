"""Manhole — a live REPL into a running training process, the port of
``znicz_tpu/utils/manhole.py`` (rebuild of the reference's vendored
``veles/external/manhole`` service, SURVEY.md §3.3 "Misc ext").

A background thread serves a line-oriented Python REPL on an AF_UNIX
socket; connect with ``nc -U <path>`` while training runs and inspect the
live workflow — ``wf.decision.metrics_history``, ``wf.step.loss``, pause
via gates, etc.  The namespace is handed in by the owner (``Launcher``
passes ``wf``/``launcher``/``root``).

Design points:
- AF_UNIX socket with 0600 permissions inside a 0700 directory (the
  upstream manhole's trust model: filesystem permissions gate access, so
  other local users on a shared host cannot reach the exec() REPL — a
  127.0.0.1 TCP port would be open to every local uid);
- expressions are evaluated and their repr written back; statements are
  exec'd with stdout redirected to the socket; exceptions return their
  traceback instead of killing the connection;
- the serving thread is a daemon: an abandoned manhole never blocks
  process exit.

A copy of the reference's module, under the drift check of
``tests/test_torch_port_isolation.py``.
"""

from __future__ import annotations

import contextlib
import io
import os
import socket
import tempfile
import threading
import traceback
from typing import Optional

from znicz_tpu_torch.core.logger import Logger

BANNER = "znicz-tpu manhole — live namespace: %s\n"
PROMPT = ">>> "


class Manhole(Logger):
    """Serve a REPL over a 0600-permission AF_UNIX socket in a daemon
    thread."""

    def __init__(self, namespace: Optional[dict] = None,
                 path: Optional[str] = None) -> None:
        super().__init__()
        self.namespace = dict(namespace or {})
        #: socket path; None/"" = auto-create a private 0700 temp dir
        self.path = path or None
        self._own_dir: Optional[str] = None
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._stopping = False

    def start(self) -> str:
        """Bind and serve; returns the socket path (useful with path=None)."""
        if self.path is None:
            # mkdtemp creates the directory 0700 — the socket inside is
            # unreachable by other uids even before its own chmod lands
            self._own_dir = tempfile.mkdtemp(prefix="znicz-manhole-")
            self.path = os.path.join(self._own_dir, "manhole.sock")
        elif os.path.exists(self.path):
            # a previous run's stale socket: bind() would raise
            # EADDRINUSE.  Only ever unlink a DEAD socket — a typo'd
            # path must not delete a user file, and a live manhole
            # served by another process must not be stolen (a probe
            # connect succeeding means someone is accepting there)
            import stat
            if not stat.S_ISSOCK(os.lstat(self.path).st_mode):
                raise FileExistsError(
                    f"{self.path!r} exists and is not a socket — refusing "
                    f"to replace it")
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            probe.settimeout(0.2)
            try:
                probe.connect(self.path)
            except OSError:
                os.unlink(self.path)             # nobody accepting: stale
            else:
                raise FileExistsError(
                    f"{self.path!r} is a live socket served by another "
                    f"process — refusing to steal it")
            finally:
                probe.close()
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        # the socket must never exist world-connectable, even for one
        # instruction under a permissive umask: mask at creation, then
        # tighten to exactly 0600
        old_umask = os.umask(0o177)
        try:
            self._sock.bind(self.path)
        finally:
            os.umask(old_umask)
        os.chmod(self.path, 0o600)
        self._sock.listen(2)
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="manhole")
        self._thread.start()
        self.info(f"manhole listening on {self.path} (nc -U {self.path})")
        return self.path

    def stop(self) -> None:
        self._stopping = True
        bound = self._sock is not None
        if bound:
            # closing a listening socket does not reliably wake a thread
            # blocked in accept() on Linux — shut it down first, and poke
            # it with a throwaway connect so the acceptor observes EOF
            with contextlib.suppress(OSError):
                self._sock.shutdown(socket.SHUT_RDWR)
            with contextlib.suppress(OSError):
                poke = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                poke.settimeout(0.2)
                poke.connect(self.path)
                poke.close()
            with contextlib.suppress(OSError):
                self._sock.close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        # only remove what THIS instance created: a stop() on a
        # never-started manhole must not delete a foreign file/socket
        if bound and self.path is not None:
            with contextlib.suppress(OSError):
                os.unlink(self.path)
        if self._own_dir is not None:
            with contextlib.suppress(OSError):
                os.rmdir(self._own_dir)

    # -- internals ----------------------------------------------------------
    def _serve(self) -> None:
        while not self._stopping:
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return                                   # closed by stop()
            threading.Thread(target=self._session, args=(conn,),
                             daemon=True, name="manhole-conn").start()

    def _session(self, conn: socket.socket) -> None:
        # SEPARATE reader and writer: a single makefile("rw") wraps one
        # TextIOWrapper whose write() discards its decoded read-ahead
        # buffer, so commands sent in one burst vanished after the first
        # response was echoed (lost "x = ..." lines, observed in tests)
        rf = conn.makefile("r", encoding="utf-8", newline="\n")
        wf = conn.makefile("w", encoding="utf-8", newline="\n")
        try:
            names = [n for n in sorted(self.namespace)
                     if not n.startswith("_")]       # hide _, __builtins__
            wf.write(BANNER % ", ".join(names) + PROMPT)
            wf.flush()
            for line in rf:
                line = line.rstrip("\r\n")
                if line in ("exit()", "quit()", "\x04"):
                    break
                out = self._run(line)
                if out:
                    wf.write(out if out.endswith("\n") else out + "\n")
                wf.write(PROMPT)
                wf.flush()
        except (OSError, ValueError):
            pass                                         # client went away
        finally:
            # separate suppressions: wf.close() flushing into a dead
            # client raises, and that must not leak the socket fd
            with contextlib.suppress(OSError):
                rf.close()
            with contextlib.suppress(OSError):
                wf.close()
            with contextlib.suppress(OSError):
                conn.close()

    def _run(self, line: str) -> str:
        """One REPL step: eval expressions (returning repr), exec
        statements (returning captured stdout), tracebacks on error."""
        if not line.strip():
            return ""
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                try:
                    code = compile(line, "<manhole>", "eval")
                except SyntaxError:
                    exec(compile(line, "<manhole>", "exec"), self.namespace)
                    result = None
                else:
                    result = eval(code, self.namespace)  # noqa: S307
        except Exception:  # noqa: BLE001 — REPL contract: show, don't die
            return traceback.format_exc(limit=8)
        text = buf.getvalue()
        if result is not None:
            self.namespace["_"] = result
            text += repr(result) + "\n"
        return text
