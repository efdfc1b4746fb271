"""Process-global metrics registry: labeled counters / gauges / histograms.

The observability layer's first pillar, the port's own copy of the JAX
package's `repro.obs.metrics` (standard library only; for the same calls
its snapshots, JSONL lines and Prometheus text are the same). Design
constraints, in order:

1. **Free when off.** The ambient registry defaults to `NULL_REGISTRY`
   (`enabled == False`), whose instrument factories return shared no-op
   singletons: a disabled hot loop allocates no metric object (the serving
   engine also guards its instrumentation behind one `registry.enabled`
   check per step). `instrument_count()` counts the real instruments ever
   built, so a test can pin this.
2. **Ambient.** `use_metrics(registry)` installs a registry for a `with`
   block, so the serving engine and the memory layers never thread a
   registry argument through every call; `current()` reads it.
3. **Bounded label cardinality.** Instruments are keyed by
   (name, sorted label items). Past `max_series` distinct label sets per
   metric name, new sets fold into one `{"overflow": "true"}` series (with
   a single warning) instead of growing without bound.

Exporters: `snapshot()` (plain dict, JSON-stable), `append_jsonl(path)`
(one snapshot per line) and `to_prometheus()` (Prometheus text exposition
format).
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
import warnings
from collections.abc import Iterable

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "NULL_REGISTRY", "current", "use_metrics", "instrument_count"]

# default histogram buckets: latencies in seconds (spans, step times) and
# small rates both land usefully on a log-ish grid
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# module-wide count of real instrument objects ever constructed: a
# metrics-off serving loop must leave it unchanged
_n_instruments = 0


def instrument_count() -> int:
    """Total real (non-null) instruments constructed in this process."""
    return _n_instruments


def _bump():
    global _n_instruments
    _n_instruments += 1


LabelKey = tuple[tuple[str, str], ...]


def _label_key(labels: dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing value."""

    kind = "counter"
    __slots__ = ("value",)

    def __init__(self):
        _bump()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increments must be >= 0, got {amount}")
        self.value += amount

    def export(self) -> dict:
        return {"value": self.value}


class Gauge:
    """Point-in-time value (set / add)."""

    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self):
        _bump()
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def add(self, amount: float) -> None:
        self.value += amount

    def export(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Fixed-bucket histogram with sum/count (Prometheus-style cumulative
    buckets on export)."""

    kind = "histogram"
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Iterable[float] = DEFAULT_BUCKETS):
        _bump()
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)   # +inf tail
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        self.sum += value
        self.count += 1
        for i, edge in enumerate(self.buckets):
            if value <= edge:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def export(self) -> dict:
        cum, acc = [], 0
        for c in self.counts:
            acc += c
            cum.append(acc)
        return {"sum": self.sum, "count": self.count,
                "buckets": {("+Inf" if i == len(self.buckets)
                             else repr(self.buckets[i])): cum[i]
                            for i in range(len(self.counts))}}


class _NullInstrument:
    """Shared do-nothing instrument returned by the null registry."""

    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def add(self, amount: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass


_NULL_INSTRUMENT = _NullInstrument()


class _NullRegistry:
    """The ambient default: everything is a no-op, nothing is allocated."""

    enabled = False

    def counter(self, name: str, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str, *, buckets=DEFAULT_BUCKETS,
                  **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def snapshot(self) -> dict:
        return {}


NULL_REGISTRY = _NullRegistry()


class MetricsRegistry:
    """Labeled instrument store. One registry per process (or per bench
    phase); instruments are created on first use and shared thereafter."""

    enabled = True

    def __init__(self, *, max_series: int = 512):
        if max_series <= 0:
            raise ValueError(f"max_series must be positive, got {max_series}")
        self.max_series = max_series
        # name -> {label_key -> instrument}; kinds tracked per name so a
        # counter name can't silently come back as a gauge
        self._series: dict[str, dict[LabelKey, object]] = {}
        self._kinds: dict[str, str] = {}
        self._overflowed: set = set()
        self._lock = threading.Lock()

    # -- instrument factories ------------------------------------------------

    def _get(self, kind: str, name: str, labels: dict[str, str], make):
        key = _label_key(labels)
        with self._lock:
            series = self._series.setdefault(name, {})
            prev_kind = self._kinds.setdefault(name, kind)
            if prev_kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {prev_kind}, "
                    f"requested as {kind}")
            inst = series.get(key)
            if inst is None:
                if len(series) >= self.max_series:
                    # cardinality guard: fold the overflow into one series
                    if name not in self._overflowed:
                        self._overflowed.add(name)
                        warnings.warn(
                            f"metric {name!r} exceeded max_series="
                            f"{self.max_series} label sets; folding further "
                            "label sets into the overflow series",
                            RuntimeWarning, stacklevel=3)
                    key = _label_key({"overflow": "true"})
                    inst = series.get(key)
                    if inst is None:
                        inst = series[key] = make()
                else:
                    inst = series[key] = make()
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, *, buckets=DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get("histogram", name, labels,
                         lambda: Histogram(buckets))

    # -- exporters -----------------------------------------------------------

    def snapshot(self) -> dict:
        """Plain-dict export: {name: {"kind": ..., "series": [{"labels":
        {...}, ...instrument fields...}]}} — JSON round-trip stable."""
        out: dict = {}
        with self._lock:
            for name, series in sorted(self._series.items()):
                rows: list[dict] = []
                for key in sorted(series):
                    row = {"labels": dict(key)}
                    row.update(series[key].export())
                    rows.append(row)
                out[name] = {"kind": self._kinds[name], "series": rows}
        return out

    def append_jsonl(self, path: str, *, meta: dict | None = None) -> None:
        """Append one snapshot line: {"ts": ..., "metrics": {...}, **meta}."""
        rec = {"ts": time.time(), "metrics": self.snapshot()}
        if meta:
            rec.update(meta)
        with open(path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (counters get a `_total`
        suffix; histograms expand to `_bucket{le=...}` / `_sum` /
        `_count`)."""
        lines: list[str] = []
        snap = self.snapshot()
        for name, ent in snap.items():
            kind = ent["kind"]
            pname = f"{name}_total" if (kind == "counter"
                                        and not name.endswith("_total")) \
                else name
            lines.append(f"# TYPE {pname} {kind}")
            for row in ent["series"]:
                lab = row["labels"]
                if kind == "histogram":
                    for le, c in row["buckets"].items():
                        lines.append(f"{pname}_bucket"
                                     f"{_prom_labels({**lab, 'le': le})} {c}")
                    lines.append(f"{pname}_sum{_prom_labels(lab)} "
                                 f"{row['sum']}")
                    lines.append(f"{pname}_count{_prom_labels(lab)} "
                                 f"{row['count']}")
                else:
                    lines.append(f"{pname}{_prom_labels(lab)} "
                                 f"{row['value']}")
        return "\n".join(lines) + "\n"

    @staticmethod
    def value(snapshot: dict, name: str, **labels) -> float | None:
        """Pull one series' value out of a `snapshot()` dict (None when the
        series doesn't exist)."""
        ent = snapshot.get(name)
        if not ent:
            return None
        want = dict(_label_key(labels))
        for row in ent["series"]:
            if row["labels"] == want:
                return row.get("value", row.get("sum"))
        return None


def _prom_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


# ---------------------------------------------------------------------------
# ambient registry
# ---------------------------------------------------------------------------

_current = NULL_REGISTRY


def current():
    """The ambient registry (`NULL_REGISTRY` unless `use_metrics` is
    active). Hot paths read `.enabled` once and skip all instrumentation
    when False."""
    return _current


@contextlib.contextmanager
def use_metrics(registry: MetricsRegistry | None = None):
    """Install `registry` as the ambient metrics sink for the block (a
    fresh `MetricsRegistry` when called with None). Yields the registry."""
    global _current
    reg = MetricsRegistry() if registry is None else registry
    prev = _current
    _current = reg
    try:
        yield reg
    finally:
        _current = prev
