"""Unit — the dataflow-graph node; the port's copy of
``znicz_tpu/core/units.py`` (rebuild of veles/units.py :: Unit).

A Unit has:
- a lifecycle: ``initialize()`` once, ``run()`` per control-graph firing,
  ``stop()`` at shutdown;
- **control links**: ``b.link_from(a)`` means "b fires after a"; a unit with
  several incoming links fires when *all* of them have signalled since its
  last run (reference semantics — this is what makes the
  Repeater -> ... -> Repeater training loop a well-defined cycle);
- **gates**: ``gate_block`` (do not fire, do not propagate) and ``gate_skip``
  (do not run, but propagate the signal) — ``core.mutable.Bool``
  cells, usually composite expressions over Decision flags;
- **data links**: ``b.link_attrs(a, "input", ("input", "output"))`` aliases
  b.input to a.output — reads/writes forward to the provider, zero-copy
  (reference: link_attrs / LinkableAttribute).

Execution is a deterministic single-threaded event walk driven by
``Workflow.run`` — the reference used a ThreadPool, but the device work
inside a step is already asynchronous on the device's stream, and a
deterministic host walk is what makes runs bit-reproducible.  Per-unit
wall-time accounting is kept (reference: Workflow timing stats table).
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Dict, Optional

from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.core.mutable import Bool, LinkableAttribute
from znicz_tpu_torch.observe import probe

if TYPE_CHECKING:
    from znicz_tpu_torch.core.workflow import Workflow


class Unit(Logger):
    """Base control/data-graph node.

    The reference additionally mixes a 5-method Distributable protocol
    into every unit (veles/distributable.py — master/slave payloads over
    ZeroMQ).  That protocol has no counterpart by design: the gradient
    plane is a collective inside the step and host-side state
    travels through the snapshotter's explicit state dicts (SURVEY.md
    §3.4 "the entire protocol disappears"), so no vestigial mixin is
    kept."""

    def __init__(self, workflow: Optional["Workflow"] = None,
                 name: Optional[str] = None, **kwargs) -> None:
        super().__init__()
        object.__setattr__(self, "_linked", {})   # attr name -> LinkableAttribute
        self.name = name or type(self).__name__
        self.workflow: Optional["Workflow"] = None
        self.links_from: Dict["Unit", bool] = {}  # provider -> fired?
        self.links_to: list["Unit"] = []
        self.gate_block = Bool(False)
        self.gate_skip = Bool(False)
        self.initialized = False
        self.run_was_called = False
        self._run_count = 0
        self._run_time = 0.0
        self._observers = None   # cached registry children, first run
        if workflow is not None:
            workflow.add_unit(self)

    # -- data links ---------------------------------------------------------
    def __getattr__(self, name: str):
        # linked names never reach here (__getattribute__ intercepts them)
        raise AttributeError(f"{type(self).__name__!s} has no attribute {name!r}")

    def __getattribute__(self, name: str):
        if not name.startswith("_"):
            try:
                linked = object.__getattribute__(self, "_linked")
            except AttributeError:
                linked = None
            if linked and name in linked:
                return linked[name].get()
        return object.__getattribute__(self, name)

    def __setattr__(self, name: str, value) -> None:
        if not name.startswith("_"):
            try:
                linked = object.__getattribute__(self, "_linked")
            except AttributeError:
                linked = None
            if linked and name in linked:
                linked[name].set(value)
                return
        object.__setattr__(self, name, value)

    def link_attrs(self, provider: "Unit", *attrs) -> "Unit":
        """Alias attributes from ``provider``.  Each entry is either a name
        (same on both sides) or a ``(my_name, provider_name)`` pair."""
        for attr in attrs:
            if isinstance(attr, tuple):
                mine, theirs = attr
            else:
                mine, theirs = attr, attr
            # drop any plain instance attribute shadowing the link
            self.__dict__.pop(mine, None)
            object.__getattribute__(self, "_linked")[mine] = LinkableAttribute(
                provider, theirs)
        return self

    def unlink_attr(self, name: str) -> None:
        object.__getattribute__(self, "_linked").pop(name, None)

    # -- control links ------------------------------------------------------
    def link_from(self, *providers: "Unit") -> "Unit":
        for provider in providers:
            if self not in provider.links_to:
                provider.links_to.append(self)
            self.links_from.setdefault(provider, False)
        return self

    def unlink_all(self) -> None:
        for provider in list(self.links_from):
            provider.links_to.remove(self)
        self.links_from.clear()
        for consumer in list(self.links_to):
            consumer.links_from.pop(self, None)
        self.links_to.clear()

    # -- lifecycle ----------------------------------------------------------
    def initialize(self, device=None, **kwargs) -> None:
        """Override; call super().initialize() last or set initialized."""
        self.initialized = True

    def run(self) -> None:
        """Override with the unit's work."""

    def stop(self) -> None:
        """Override for shutdown cleanup."""

    # -- scheduler interface (driven by Workflow.run) -----------------------
    def _signal(self, source: Optional["Unit"], queue: list) -> None:
        """A control signal arrived from ``source``.  ``queue`` holds
        ``(source, target)`` pairs consumed by Workflow.run."""
        if source is not None:
            if source in self.links_from:
                self.links_from[source] = True
            if not all(self.links_from.values()):
                return  # wait for remaining providers
        if bool(self.gate_block):
            # blocked: swallow the signal; marks stay set so a later unblock
            # re-attempt (next signal) can fire — matches reference gating
            return
        for key in self.links_from:
            self.links_from[key] = False
        if not bool(self.gate_skip):
            self._timed_run()
        queue.extend((self, target) for target in self.links_to)

    def _timed_run(self) -> None:
        start = time.monotonic()
        self.run()
        self.run_was_called = True
        self._run_count += 1
        dt = time.monotonic() - start
        self._run_time += dt
        # donate per-unit timing to the shared telemetry plane — the
        # registry children timing_table()/GET /metrics read.  Cached
        # handles keep the hot path at one locked pair-increment.
        if probe.enabled():
            obs = self._observers
            if obs is None:
                wf = self.workflow
                obs = self._observers = probe.unit_observers(
                    wf.name if wf is not None else "", self.name)
            probe.unit_run(obs, dt)

    @property
    def timing(self) -> tuple[int, float]:
        return self._run_count, self._run_time

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class TrivialUnit(Unit):
    """A unit that does nothing on run (control-graph plumbing node).
    Reference: veles/units.py :: TrivialUnit."""
