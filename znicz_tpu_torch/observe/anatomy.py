"""Step-time anatomy — phase-attributed accounting for train steps and
decode rounds, the port of ``znicz_tpu/observe/anatomy.py``.

Producers stamp phase boundaries and the accountant turns them into

- ``znicz_anatomy_phase_seconds{plane,phase}`` histograms — wall seconds
  of one phase of one step (``plane`` names the producer: ``fused``,
  ``transformer``, ``pipeline``, ``serve``);
- ``znicz_anatomy_step_seconds{plane}`` — the whole step, measured at
  the same clock so per-phase sums reconcile against it;
- ``znicz_anatomy_steps_total{plane}`` — step count (pre-touched at
  init so a fleet delta rule sees the child from its first sample);
- ``znicz_anatomy_mfu{plane}`` — model FLOPs (``utils/flops.py``) over
  measured step wall time against the device's peak (the H100's bf16
  tensor-core peak; nominal on the CPU via ``$ZNICZ_TPU_PEAK_FLOPS``);
- complete-spans ``anatomy.<plane>.<phase>`` on the shared tracer ring.

Phase taxonomy (the label vocabulary — producers reuse, never invent):

==============  =============================================================
phase           meaning
==============  =============================================================
``input_wait``  consumer blocked on the input pipeline (prefetcher ring
                empty — the loader is the bottleneck)
``stage``       host->device staging of one batch
``zero_gather`` ZeRO shard_params regather: flat shards -> full weights
``grad``        forward + backward compute producing per-rank local grads
``collective``  the gradient sum over the mesh (quantized or f32)
``update``      optimizer apply: grads + state -> new params
``prefill``     serving: prompt attach / KV-cache prefill of admitted rows
``decode``      serving: one batched decode dispatch over live rows
``verify``      serving: speculative draft+verify round
==============  =============================================================

Host-clock semantics: phases are wall times between host stamps.  A
train-step producer in its anatomy mode runs each phase eagerly and
stamps after ``torch.cuda.synchronize()`` (the reference's
``block_until_ready``), so the phases sum to the step wall by
construction; that loses the overlap a device profiler would show and
costs nothing when off.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

from znicz_tpu_torch.observe import registry as _reg
from znicz_tpu_torch.observe import trace as _trace

#: the closed phase vocabulary (docs/OBSERVABILITY.md catalogue) —
#: :func:`pretouch` materializes exactly these children per plane
PHASES = ("input_wait", "stage", "zero_gather", "grad", "collective",
          "update", "prefill", "decode", "verify")

#: phases a train-step plane owns (the subset pretouch uses for fused /
#: transformer planes; serving planes own prefill/decode/verify)
TRAIN_PHASES = ("zero_gather", "grad", "collective", "update")
SERVE_PHASES = ("prefill", "decode", "verify")

_PHASE_SECONDS = _reg.histogram(
    "znicz_anatomy_phase_seconds",
    "wall seconds of one phase of one step, attributed at dispatch "
    "boundaries (phase taxonomy in docs/OBSERVABILITY.md)",
    labelnames=("plane", "phase"))
_STEP_SECONDS = _reg.histogram(
    "znicz_anatomy_step_seconds",
    "whole-step wall seconds measured at the same clock as the phase "
    "stamps (per-phase sums reconcile against this)",
    labelnames=("plane",))
_STEPS = _reg.counter(
    "znicz_anatomy_steps_total",
    "steps accounted by the anatomy layer (delta-rule companion to the "
    "histograms)", labelnames=("plane",))
_MFU = _reg.gauge(
    "znicz_anatomy_mfu",
    "model-FLOPs utilisation: analytic step FLOPs / (step wall seconds "
    "x peak FLOPs); nominal-peak CPU fallback via $ZNICZ_TPU_PEAK_FLOPS",
    labelnames=("plane",))


def _probe_enabled() -> bool:
    # late import: probe imports registry/trace like we do, and keeping
    # anatomy off probe's import path lets probe expose thin delegating
    # hooks without a cycle
    from znicz_tpu_torch.observe import probe as _probe
    return _probe.enabled()


def pretouch(plane: str, phases: Optional[Sequence[str]] = None) -> None:
    """Materialize every child this plane will ever emit, BEFORE the
    first fleet sample (the delta-rule lesson: a labeled child
    absent at the baseline sample makes a fleet delta/quantile rule
    silently never trip).  Histogram/gauge children materialize on
    ``labels()``; the counter additionally takes an ``inc(0)`` so a
    ``skip_zero`` snapshot keeps it too."""
    for phase in (phases if phases is not None else PHASES):
        _PHASE_SECONDS.labels(plane=plane, phase=phase)
    _STEP_SECONDS.labels(plane=plane)
    _STEPS.labels(plane=plane).inc(0.0)
    _MFU.labels(plane=plane).set(0.0)


def observe_phase(plane: str, phase: str, dt_s: float,
                  t0: Optional[float] = None) -> None:
    """One already-timed phase from a producer that owns its own clock
    (prefetcher input-wait/stage, the serving batcher's round phases):
    histogram observation + a complete-span on the tracer ring.  ``t0``
    is the phase's ``time.perf_counter()`` start when the producer has
    it (exact span placement); defaults to now-minus-duration."""
    if not _probe_enabled():
        return
    _PHASE_SECONDS.labels(plane=plane, phase=phase).observe(dt_s)
    start = t0 if t0 is not None else time.perf_counter() - dt_s
    _trace.TRACER.complete(f"anatomy.{plane}.{phase}", start, dt_s)


class StepAnatomy:
    """Cursor-based accountant for one producer plane.

    The producer calls :meth:`begin` at step start, :meth:`stamp` at
    each phase boundary (charging cursor->now to that phase), and
    :meth:`finish` at step end — which emits the step histogram, the
    steps counter, the tracer spans, and (when the producer registered
    an analytic FLOPs figure via :meth:`set_flops`) the MFU gauge.

    Children are resolved once at construction — the stamping hot path
    is two ``perf_counter`` reads and one histogram observe.
    """

    __slots__ = ("plane", "_phase_children", "_step_child", "_steps",
                 "_mfu", "_t0", "_cursor", "_spans", "_flops",
                 "_peak")

    def __init__(self, plane: str,
                 phases: Optional[Sequence[str]] = None) -> None:
        self.plane = str(plane)
        phases = tuple(phases if phases is not None else PHASES)
        pretouch(self.plane, phases)
        self._phase_children = {
            p: _PHASE_SECONDS.labels(plane=self.plane, phase=p)
            for p in phases}
        self._step_child = _STEP_SECONDS.labels(plane=self.plane)
        self._steps = _STEPS.labels(plane=self.plane)
        self._mfu = _MFU.labels(plane=self.plane)
        self._t0 = self._cursor = 0.0
        self._spans: list = []
        self._flops: float = 0.0
        self._peak: Optional[float] = None

    # -- MFU wiring ---------------------------------------------------------
    def set_flops(self, flops_per_step: float) -> None:
        """Analytic model FLOPs of ONE step (``utils/flops.
        train_step_flops`` for the fused plane).  Resolves the peak once;
        a backend without a known peak (bare CPU, no
        ``$ZNICZ_TPU_PEAK_FLOPS``) leaves the MFU gauge at 0 — absent
        would break the pre-touch contract."""
        from znicz_tpu_torch.utils import flops as _flops
        self._flops = float(flops_per_step)
        self._peak = _flops.peak_flops()

    # -- stamping -----------------------------------------------------------
    def begin(self) -> float:
        self._t0 = self._cursor = time.perf_counter()
        self._spans.clear()
        return self._t0

    def stamp(self, phase: str, now: Optional[float] = None) -> None:
        """Charge cursor->now to ``phase`` and advance the cursor."""
        now = time.perf_counter() if now is None else now
        dt = now - self._cursor
        self._spans.append((phase, self._cursor, dt))
        self._cursor = now
        child = self._phase_children.get(phase)
        if child is None:       # producer used an out-of-vocabulary
            child = _PHASE_SECONDS.labels(plane=self.plane,  # phase —
                                          phase=phase)       # still count
            self._phase_children[phase] = child
        child.observe(dt)

    def observe(self, phase: str, dt_s: float) -> None:
        """Record an externally-timed phase WITHOUT moving the cursor
        (e.g. input-wait measured by the loader before begin())."""
        self._phase_children.get(phase, _PHASE_SECONDS.labels(
            plane=self.plane, phase=phase)).observe(dt_s)
        self._spans.append((phase, time.perf_counter() - dt_s, dt_s))

    def finish(self) -> float:
        """Close the step: whole-step histogram + counter + tracer spans
        + MFU.  Returns the step wall seconds."""
        now = time.perf_counter()
        wall = now - self._t0
        self._step_child.observe(wall)
        self._steps.inc()
        if self._flops and self._peak and wall > 0.0:
            self._mfu.set(self._flops / (wall * self._peak))
        tracer = _trace.TRACER
        if tracer.enabled:
            for phase, start, dt in self._spans:
                tracer.complete(f"anatomy.{self.plane}.{phase}",
                                start, dt)
            tracer.complete(f"anatomy.{self.plane}.step", self._t0, wall)
        self._spans.clear()
        return wall
