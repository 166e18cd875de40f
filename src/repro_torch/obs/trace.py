"""Structured span tracing for the serving drivers (host side).

Counterpart of ``repro/obs/trace.py``.  Spans bracket the COARSE phases
of a serve call -- pack, compile (graph capture and the kernel build),
prefill, decode, the scheduler's workload -- not per-iteration events
(those live in the device rings, ``obs/rings.py``).

Each closed span is appended to an in-memory list and, when the tracer
was given a path, written as one JSON line:

    {"name": "serve.workload", "t0": ..., "dur_s": ..., "attrs": {...}}

A span also enters ``torch.profiler.record_function(name)``, where the
reference enters ``jax.profiler.TraceAnnotation``, so a torch profiler
trace collected around a serve call shows the same phase boundaries as
the JSON-lines file.  A span synchronizes nothing: it closes on the host
clock where its driver already syncs with the device.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch


class SpanTracer:
    """Collects closed spans; optionally appends them to a JSONL file."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.spans: List[Dict] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[Dict]:
        """Time a ``with`` block as span ``name``.  The yielded dict is
        the span's attrs -- callers may add results discovered inside
        the block (e.g. token counts) before it closes."""
        a = dict(attrs)
        t0 = time.time()
        with torch.profiler.record_function(name):
            yield a
        rec = dict(name=name, t0=round(t0, 6),
                   dur_s=round(time.time() - t0, 6), attrs=a)
        with self._lock:
            self.spans.append(rec)
            if self.path:
                with open(self.path, "a") as f:
                    f.write(json.dumps(rec, sort_keys=True) + "\n")

    def drain(self) -> List[Dict]:
        """Return and clear the collected spans."""
        with self._lock:
            out, self.spans = self.spans, []
        return out


_TRACER = SpanTracer()


def get_tracer() -> SpanTracer:
    return _TRACER


def set_trace_path(path: Optional[str]) -> None:
    """Point the process-global tracer's JSONL sink at ``path``."""
    _TRACER.path = path


def span(name: str, **attrs):
    """``with span("serve.pack"): ...`` against the global tracer."""
    return _TRACER.span(name, **attrs)
