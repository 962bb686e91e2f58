"""Unified metrics registry: counters, gauges, fixed-bucket histograms.

Counterpart of ``jumbo_mae_tpu_tpu/obs/metrics.py``, the same names, the
same Prometheus text from :meth:`MetricsRegistry.render` and the same
:meth:`MetricsRegistry.snapshot`. The port's warm cache, batch jobs,
request tracer, cost meter, admission gate, autoscaler, publisher,
engine, micro-batcher, pool, scheduler, SLO tracker, memory watcher,
capture sentinel and lock watchdog report through it, and
``obs/exporter.py`` serves it; the training layers' own metrics are still
to port (ROADMAP A7). The train loop's
``AverageMeter`` lives in ``utils/meters.py``.

Design constraints, in order:

- **Hot-path cheap.** A counter ``inc`` is one lock + one float add; metric
  *handles* are resolved once at instrument-time (``registry.counter(...)``
  / ``family.labels(...)``), never per observation. Disabling telemetry is
  swapping the default registry for :data:`NULL_REGISTRY`, whose handles are
  no-ops — instrumented code never branches.
- **Thread-safe.** Every metric guards its state with its own lock: many
  client threads hit the same histogram.
- **Fixed buckets.** Histograms are cumulative fixed-bound buckets (the
  Prometheus model): O(len(buckets)) memory forever, mergeable across
  scrapes, p50/p99 recoverable by the scraper — no unbounded sample lists
  on the request path.
"""

from __future__ import annotations

import threading
from bisect import bisect_left

# Request/step latency default bounds (seconds). Wide on purpose: the same
# buckets serve sub-ms CPU smoke forwards and multi-second chip steps.
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
# Occupancy/fraction bounds for 0..1 ratios (batch fill, data-wait share).
RATIO_BUCKETS = (0.1, 0.25, 0.5, 0.75, 0.9, 1.0)


class Counter:
    """Monotonic float counter."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up, got {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Instantaneous value; settable and incrementable."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus semantics: a bucket with
    upper bound ``le`` counts every observation ``<= le``; ``+Inf`` is
    implicit)."""

    __slots__ = ("_lock", "bounds", "_counts", "_sum", "_count")

    def __init__(self, buckets=LATENCY_BUCKETS):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError(f"buckets must be sorted and non-empty: {buckets}")
        self._lock = threading.Lock()
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last slot = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        idx = bisect_left(self.bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    def observe_many(self, values) -> None:
        """Record a batch of observations under ONE lock hand-off — the
        per-request shape for hot serving paths (the micro-batcher records a
        whole flushed batch's latencies at once)."""
        bounds, counts = self.bounds, self._counts
        with self._lock:
            s = 0.0
            for v in values:
                counts[bisect_left(bounds, v)] += 1
                s += v
            self._sum += s
            self._count += len(values)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def cumulative(self) -> list[tuple[float, int]]:
        """``[(le, cumulative_count), ..., (inf, total)]`` — the scrape shape."""
        with self._lock:
            counts = list(self._counts)
        out, running = [], 0
        for bound, c in zip((*self.bounds, float("inf")), counts):
            running += c
            out.append((bound, running))
        return out

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper bound of the bucket the q-th
        observation falls in) — a readout for reports/tests, not a substitute
        for scraper-side histogram_quantile."""
        cum = self.cumulative()
        total = cum[-1][1]
        if total == 0:
            return 0.0
        rank = q * total
        for bound, running in cum:
            if running >= rank:
                return bound
        return cum[-1][0]  # pragma: no cover - rank <= total always matches


class _NullCounter(Counter):
    def inc(self, amount: float = 1.0) -> None:
        pass


class _NullGauge(Gauge):
    def set(self, value: float) -> None:
        pass

    def inc(self, amount: float = 1.0) -> None:
        pass


class _NullHistogram(Histogram):
    def observe(self, value: float) -> None:
        pass

    def observe_many(self, values) -> None:
        pass


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """One named metric with a fixed label schema; ``labels(...)`` resolves
    (and caches) the child for one label-value tuple. A label-less metric is
    a family with a single ``()`` child, and the family proxies the child's
    methods so instrument sites never special-case."""

    def __init__(self, name: str, kind: str, help: str, labelnames, **kw):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._kw = kw
        self._children: dict[tuple, Counter | Gauge | Histogram] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self.labels()  # eager default child → always rendered

    def labels(self, *values, **kwvalues):
        if kwvalues:
            values = tuple(str(kwvalues[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got {values}"
            )
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.get(values)
                if child is None:
                    child = _TYPES[self.kind](**self._kw)
                    self._children[values] = child
        return child

    def children(self) -> dict[tuple, Counter | Gauge | Histogram]:
        with self._lock:
            return dict(self._children)

    # label-less convenience: family.inc()/set()/observe() hit the () child
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def dec(self, amount: float = 1.0) -> None:
        self.labels().dec(amount)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def observe_many(self, values) -> None:
        self.labels().observe_many(values)

    @property
    def value(self):
        return self.labels().value

    @property
    def count(self):
        return self.labels().count

    @property
    def sum(self):
        return self.labels().sum

    def quantile(self, q: float) -> float:
        return self.labels().quantile(q)

    def cumulative(self):
        return self.labels().cumulative()


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class MetricsRegistry:
    """Thread-safe collection of metric families.

    ``counter/gauge/histogram`` are get-or-create and type-checked, so every
    layer can ask for its handle independently (the engine, the batcher and
    the train loop may all run in one process) and re-registration with a
    conflicting type fails loudly instead of silently splitting a name.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, Family] = {}

    def _get(self, name: str, kind: str, help: str, labelnames, **kw) -> Family:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = Family(name, kind, help, labelnames, **kw)
                    self._families[name] = fam
        if fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}, not {kind}"
            )
        if fam.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered with labels "
                f"{fam.labelnames}, not {tuple(labelnames)}"
            )
        return fam

    def counter(self, name: str, help: str = "", labels=()) -> Family:
        return self._get(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "", labels=()) -> Family:
        return self._get(name, "gauge", help, labels)

    def histogram(
        self, name: str, help: str = "", labels=(), buckets=LATENCY_BUCKETS
    ) -> Family:
        return self._get(name, "histogram", help, labels, buckets=buckets)

    def families(self) -> list[Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def render(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines: list[str] = []
        for fam in self.families():
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for values, child in sorted(fam.children().items()):
                pairs = [
                    f'{n}="{_escape_label(v)}"'
                    for n, v in zip(fam.labelnames, values)
                ]
                base = ",".join(pairs)
                if fam.kind == "histogram":
                    for le, cum in child.cumulative():
                        sel = ",".join([*pairs, f'le="{_fmt(le)}"'])
                        lines.append(f"{fam.name}_bucket{{{sel}}} {cum}")
                    sfx = f"{{{base}}}" if base else ""
                    lines.append(f"{fam.name}_sum{sfx} {_fmt(child.sum)}")
                    lines.append(f"{fam.name}_count{sfx} {child.count}")
                else:
                    sfx = f"{{{base}}}" if base else ""
                    lines.append(f"{fam.name}{sfx} {_fmt(child.value)}")
        return "\n".join(lines) + "\n" if lines else ""

    def snapshot(self) -> dict:
        """Nested plain-python readout (tests / JSON reports): name →
        {labels-tuple-as-str: value-or-histogram-dict}."""
        out: dict = {}
        for fam in self.families():
            entry: dict = {}
            for values, child in fam.children().items():
                key = ",".join(values)
                if fam.kind == "histogram":
                    entry[key] = {"count": child.count, "sum": child.sum}
                else:
                    entry[key] = child.value
            out[fam.name] = entry
        return out


class NullRegistry(MetricsRegistry):
    """Telemetry-off registry: hands out no-op metric children, so swapping
    the default registry disables every instrument site with zero branches
    in instrumented code."""

    def counter(self, name, help="", labels=()):
        fam = Family(name, "counter", help, labels)
        fam._children.clear()
        _null_children(fam, _NullCounter)
        return fam

    def gauge(self, name, help="", labels=()):
        fam = Family(name, "gauge", help, labels)
        fam._children.clear()
        _null_children(fam, _NullGauge)
        return fam

    def histogram(self, name, help="", labels=(), buckets=LATENCY_BUCKETS):
        fam = Family(name, "histogram", help, labels, buckets=buckets)
        fam._children.clear()
        _null_children(fam, _NullHistogram, buckets=buckets)
        return fam

    def render(self) -> str:
        return ""


def _null_children(fam: Family, cls, **kw):
    null = cls(**kw)
    fam.labels = lambda *a, **k: null  # type: ignore[method-assign]
    if not fam.labelnames:
        fam._children[()] = null


NULL_REGISTRY = NullRegistry()
_default = MetricsRegistry()
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry every instrument site reports to
    unless handed an explicit one."""
    return _default


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process default (telemetry off = ``NULL_REGISTRY``); returns
    the previous registry so callers can restore it."""
    global _default
    with _default_lock:
        prev, _default = _default, registry
    return prev

