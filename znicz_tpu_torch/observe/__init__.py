"""znicz_tpu_torch.observe — the port's telemetry plane, the reference's
``znicz_tpu/observe`` (every module but ``probe.py`` and ``flight.py``
a copy of it).

One process-global metrics registry (``registry.REGISTRY``), one
bounded-ring span tracer (``trace.TRACER``), the instrumentation hooks
the runtime calls (``probe``), the step-anatomy accountant
(``anatomy``), the watchtower (``watchtower.WATCHTOWER``), the flight
recorder (``flight``) and the fleet federation plane (``federation``).
``python -m znicz_tpu_torch trace out.json workflow.py`` exports a run's
timeline; ``python -m znicz_tpu_torch flight artifact.json``
pretty-prints a flight.
"""

from znicz_tpu_torch.observe.registry import (REGISTRY, Registry, counter,
                                              gauge, histogram,
                                              quantile_from_buckets)
from znicz_tpu_torch.observe.trace import (TRACER, Tracer, export_trace,
                                           instant, span)
from znicz_tpu_torch.observe.probe import (check_recompiles,
                                           compile_cache_event,
                                           compile_cache_stats,
                                           compile_observed,
                                           enabled, resilience_event,
                                           set_enabled, staged_bytes,
                                           time_compiles, watch_compiles)
from znicz_tpu_torch.observe.anatomy import StepAnatomy, observe_phase
from znicz_tpu_torch.observe.watchtower import (WATCHTOWER, Rule,
                                                TimeSeriesRing, Watchtower)
from znicz_tpu_torch.observe import flight
from znicz_tpu_torch.observe import federation
from znicz_tpu_torch.observe.federation import (FleetAggregator,
                                                MetricsExporter, merge_traces,
                                                next_request_id,
                                                start_metrics_export)

__all__ = ["REGISTRY", "Registry", "counter", "gauge", "histogram",
           "quantile_from_buckets",
           "TRACER", "Tracer", "span", "instant", "export_trace",
           "set_enabled", "enabled", "watch_compiles",
           "check_recompiles", "staged_bytes", "resilience_event",
           "compile_observed", "time_compiles",
           "compile_cache_event", "compile_cache_stats",
           "StepAnatomy", "observe_phase",
           "WATCHTOWER", "Watchtower", "Rule", "TimeSeriesRing",
           "flight", "federation", "FleetAggregator", "MetricsExporter",
           "merge_traces", "next_request_id", "start_metrics_export"]
