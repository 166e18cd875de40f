"""Pull-style metrics registry with Prometheus-text and JSON exporters.

Counterpart of ``repro/obs/metrics.py``, kept as the port's own copy (the
port imports nothing of the reference): the host-side half of the
telemetry subsystem, pure Python.  Metrics are created lazily and
identified by (name, sorted label items); a second registration with the
same identity returns the same instrument, so module-level callers never
need to coordinate.

Exporters:

  * ``export_prometheus()`` -- the text exposition format (one
    ``# HELP``/``# TYPE`` header per metric family, ``name{labels} value``
    samples, histograms as cumulative ``_bucket``/``_sum``/``_count``).
  * ``snapshot()`` -- a JSON-able dict mirror of the same samples, the
    form ``serve --metrics`` returns in ``stats["metrics"]``.

There is one process-global ``REGISTRY``; tests build private
``MetricsRegistry()`` instances.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

LabelItems = Tuple[Tuple[str, str], ...]


def _label_items(labels: Optional[Dict[str, str]]) -> LabelItems:
    if not labels:
        return ()
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"bad label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_labels(items: LabelItems) -> str:
    if not items:
        return ""
    esc = lambda v: v.replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")
    return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in items) + "}"


def _fmt_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"                  # Prometheus text-format literal
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class Counter:
    """Monotone counter; ``inc`` with a negative amount is an error."""

    def __init__(self, name: str, help: str = "", labels: LabelItems = ()):
        self.name, self.help, self.labels = name, help, labels
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    def __init__(self, name: str, help: str = "", labels: LabelItems = ()):
        self.name, self.help, self.labels = name, help, labels
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self._value += amount

    @property
    def value(self) -> float:
        return self._value


DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0)


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics)."""

    def __init__(self, name: str, help: str = "", labels: LabelItems = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.name, self.help, self.labels = name, help, labels
        self.buckets = bs
        self.counts = [0] * (len(bs) + 1)     # + the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def observe_many(self, values: Sequence[float]) -> None:
        for v in values:
            self.observe(v)

    def quantile(self, q: float) -> float:
        """Linear-in-bucket quantile estimate (NaN when empty)."""
        if not self.count:
            return float("nan")
        target = q * self.count
        cum = 0
        lo = 0.0
        for i, b in enumerate(self.buckets):
            if cum + self.counts[i] >= target:
                frac = (target - cum) / max(self.counts[i], 1)
                return lo + frac * (b - lo)
            cum += self.counts[i]
            lo = b
        return self.buckets[-1]


class MetricsRegistry:
    """Create-or-get instruments; export everything on demand."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, LabelItems], object] = {}

    def _get(self, cls, name: str, help: str,
             labels: Optional[Dict[str, str]], **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        key = (name, _label_items(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help, key[1], **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    # -- exporters ------------------------------------------------------

    def _families(self) -> Dict[str, List[object]]:
        fams: Dict[str, List[object]] = {}
        with self._lock:
            for (name, _), m in sorted(self._metrics.items()):
                fams.setdefault(name, []).append(m)
        return fams

    def export_prometheus(self) -> str:
        """Text exposition format (version 0.0.4)."""
        lines: List[str] = []
        for name, ms in self._families().items():
            kind = {Counter: "counter", Gauge: "gauge",
                    Histogram: "histogram"}[type(ms[0])]
            if ms[0].help:
                lines.append(f"# HELP {name} {ms[0].help}")
            lines.append(f"# TYPE {name} {kind}")
            for m in ms:
                if isinstance(m, Histogram):
                    cum = 0
                    for b, c in zip(list(m.buckets) + [float("inf")],
                                    m.counts):
                        cum += c
                        it = m.labels + (("le", _fmt_value(b)),)
                        lines.append(
                            f"{name}_bucket{_fmt_labels(it)} {cum}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(m.labels)} "
                        f"{_fmt_value(m.sum)}")
                    lines.append(
                        f"{name}_count{_fmt_labels(m.labels)} {m.count}")
                else:
                    lines.append(f"{name}{_fmt_labels(m.labels)} "
                                 f"{_fmt_value(m.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict:
        """JSON-able mirror of every sample the text exporter emits."""
        out: Dict = {}
        for name, ms in self._families().items():
            fam = []
            for m in ms:
                rec: Dict = {"labels": dict(m.labels)}
                if isinstance(m, Histogram):
                    rec.update(type="histogram",
                               buckets=[[b, c] for b, c in
                                        zip(m.buckets, m.counts)],
                               inf=m.counts[-1], sum=m.sum, count=m.count)
                else:
                    rec.update(type=("counter" if isinstance(m, Counter)
                                     else "gauge"), value=m.value)
                fam.append(rec)
            out[name] = fam
        return out


REGISTRY = MetricsRegistry()
