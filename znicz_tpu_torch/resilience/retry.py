"""Bounded retries with exponential backoff and seeded jitter — the
port's copy of ``znicz_tpu/resilience/retry.py`` (numpy, threading and
time; its probe is the port's).

One reusable :class:`RetryPolicy` covers every flaky-I/O surface in the
tree: loader file reads (``loader/image.py``, ``loader/pickles.py``),
snapshot writes (``snapshotter.py``, ``parallel/checkpoint.py``) and the
RESTful client (``loader/restful.py :: predict_remote``).  The policy is
deliberately *dumb and deterministic*: attempt count, exponential delay,
jitter from a seeded generator (two policies with the same seed back off
identically — chaos tests pin the schedule), an exception filter so
programming errors (``ValueError``, architecture mismatches) never get
retried, and an optional per-attempt timeout for calls that can wedge.

Injected clocks (``sleep=``, ``clock=``) make the unit tests instant.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Callable, Optional, Tuple, Type

import numpy as np

from znicz_tpu_torch.observe import probe as _probe


class AttemptTimeout(Exception):
    """One attempt exceeded the policy's per-attempt ``timeout``.

    Always counts as retryable — a wedged call is the textbook transient.
    The timed-out attempt keeps running in its daemon thread (Python
    cannot kill threads); the policy abandons it and tries again.
    """


class RetryPolicy:
    """``policy.call(fn, *args, **kwargs)`` with bounded retries.

    Parameters
    ----------
    max_attempts:  total tries including the first (>= 1).
    base_delay:    backoff before the 2nd attempt, seconds.
    multiplier:    exponential growth factor per further attempt.
    max_delay:     backoff ceiling, seconds.
    jitter:        +/- fraction of the delay drawn from the seeded rng
                   (0.25 -> delay * U[0.75, 1.25]); 0 disables.
    retryable:     exception classes worth retrying; anything else
                   propagates immediately.  ``AttemptTimeout`` is always
                   retryable.
    timeout:       per-attempt wall-clock limit (None = unbounded).
    seed:          jitter stream seed (deterministic schedules).
    sleep/clock:   injectable for tests (fake clock).
    """

    def __init__(self, max_attempts: int = 3, base_delay: float = 0.05,
                 multiplier: float = 2.0, max_delay: float = 2.0,
                 jitter: float = 0.25,
                 retryable: Tuple[Type[BaseException], ...] = (OSError,),
                 timeout: Optional[float] = None, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{max_attempts}")
        if not 0.0 <= jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {jitter}")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.multiplier = float(multiplier)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self.retryable = tuple(retryable)
        self.timeout = timeout
        self.seed = int(seed)
        self._rng = np.random.default_rng(seed)
        self._sleep = sleep
        self._clock = clock
        # observability (read by tests and the supervisor report)
        self.total_attempts = 0
        self.total_retries = 0
        self.last_delays: list[float] = []

    def delay_for(self, attempt: int) -> float:
        """Backoff after failed attempt ``attempt`` (1-based), jittered."""
        d = min(self.max_delay,
                self.base_delay * self.multiplier ** (attempt - 1))
        if self.jitter:
            d *= 1.0 + self.jitter * float(self._rng.uniform(-1.0, 1.0))
        return d

    def _attempt(self, fn, args, kwargs):
        if self.timeout is None:
            return fn(*args, **kwargs)
        box: dict = {}

        def runner():
            try:
                box["value"] = fn(*args, **kwargs)
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                box["error"] = exc

        t = threading.Thread(target=runner, daemon=True)
        start = self._clock()
        t.start()
        t.join(self.timeout)
        if t.is_alive():
            raise AttemptTimeout(
                f"attempt exceeded {self.timeout}s "
                f"(elapsed {self._clock() - start:.3f}s)")
        if "error" in box:
            raise box["error"]
        return box.get("value")

    def call(self, fn: Callable, *args, **kwargs):
        self.last_delays = []
        for attempt in range(1, self.max_attempts + 1):
            self.total_attempts += 1
            try:
                return self._attempt(fn, args, kwargs)
            except (self.retryable + (AttemptTimeout,)) as exc:
                if attempt == self.max_attempts:
                    raise
                self.total_retries += 1
                # telemetry plane: each retry is a counter + timeline
                # instant so flaky-I/O storms correlate with the steps
                # they stall
                _probe.resilience_event(
                    "retry", site=getattr(fn, "__name__", repr(fn)),
                    attempt=attempt, error=type(exc).__name__)
                d = self.delay_for(attempt)
                self.last_delays.append(d)
                self._sleep(d)

    def wrap(self, fn: Callable) -> Callable:
        """Decorator form: ``decoded = policy.wrap(_decode)(path, shape)``."""

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        return wrapped


#: shared default for loader file reads and snapshot writes: 3 attempts,
#: 50 ms -> 100 ms backoff, retries OSError only (a corrupt pickle or an
#: architecture mismatch is not transient).  Instantiated once so its
#: counters aggregate process-wide I/O flakiness.
DEFAULT_IO_RETRY = RetryPolicy(max_attempts=3, base_delay=0.05,
                               multiplier=2.0, max_delay=1.0,
                               retryable=(OSError,), seed=0)
