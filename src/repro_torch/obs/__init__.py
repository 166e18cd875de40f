"""Serving telemetry (counterpart of ``repro/obs``).

The hot-path half lives beside the scheduler's pool state on the device:
fixed-size event rings, per-iteration sample rings and counters written
in place (``rings``), so the loop adds no host synchronization and a
captured step graph carries its own ring writes.  The host half turns the
harvested rings into typed spans and histograms (``rings.harvest_obs``),
keeps a pull-style metrics registry with Prometheus-text and JSON
exporters (``metrics``), and records JSON-lines span traces for the
serving drivers (``trace``).

Telemetry is a flag fixed when a scheduler is built: with ``obs=None``
the scheduler runs exactly the ops it ran before telemetry existed
(``fingerprint.scheduler_fingerprint`` hashes them), and a metrics-on
scheduler emits the same tokens -- the rings only read values the loop
already computes.
"""
from .fingerprint import (graph_fingerprint, hlo_fingerprint,
                          scheduler_fingerprint)
from .hostinfo import BENCH_SCHEMA_VERSION, host_fingerprint, host_matches
from .metrics import REGISTRY, MetricsRegistry
from .rings import (EV_ADMIT, EV_FINISH, EV_FIRST, ObsConfig, ObsSnapshot,
                    harvest_obs, init_obs_state)
from .trace import SpanTracer, get_tracer, set_trace_path, span

__all__ = [
    "ObsConfig", "ObsSnapshot", "init_obs_state", "harvest_obs",
    "EV_ADMIT", "EV_FIRST", "EV_FINISH",
    "MetricsRegistry", "REGISTRY",
    "SpanTracer", "get_tracer", "set_trace_path", "span",
    "host_fingerprint", "host_matches", "BENCH_SCHEMA_VERSION",
    "hlo_fingerprint", "scheduler_fingerprint", "graph_fingerprint",
]
