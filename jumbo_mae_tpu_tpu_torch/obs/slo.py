"""Declarative serving SLOs: rolling windows, burn rates, a degraded flag.

Counterpart of ``jumbo_mae_tpu_tpu/obs/slo.py``. An objective is one
line of intent — ``p99_latency_ms<=250`` (no more than 1 % of requests
slower than 250 ms), ``success_rate>=0.99`` — parsed by
:func:`parse_slo`. :class:`SLOTracker` evaluates every objective over two
rolling windows:

- **burn rate** = observed violation fraction / error budget. A latency
  objective ``pNN_latency_ms<=T`` has budget ``(100 - NN) / 100``; a
  ``success_rate>=S`` objective has budget ``1 - S``;
- an objective **breaches** when the slow window burns above
  ``burn_threshold`` and the fast window agrees (or holds no samples: a
  stalled request stream must not mask a breach);
- a breach latches **degraded** for one slow window: the signal
  ``/healthz`` surfaces (through :meth:`HealthState.degraded_when`) and
  the autoscaler keys on.

Every evaluation publishes the ``slo_*`` gauges: values, thresholds, burn
rates, breach flags, the degraded flag, the shed rate and any attached
probes (queue depth, batch occupancy). The weight-swap controller's
canary gate (``infer/replicaset.py``) runs a tracker of its own on
``NULL_REGISTRY``. ``evaluate()``, ``worst_burn()``, ``degraded()`` and
the gauges give what the JAX package's give on the same observations and
clock.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from dataclasses import dataclass

from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry

_SPEC_RE = re.compile(r"^\s*(?P<metric>[a-z0-9_]+)\s*(?P<op><=|>=)\s*(?P<threshold>[0-9.]+)\s*$")
_LATENCY_RE = re.compile(r"^p(?P<pct>\d{1,2}(?:\.\d+)?)_latency_ms$")


@dataclass(frozen=True)
class SLOObjective:
    """One parsed objective: ``metric`` is ``pNN_latency_ms`` (op ``<=``,
    threshold in ms) or ``success_rate`` (op ``>=``, threshold in (0, 1))."""

    metric: str
    op: str
    threshold: float

    @property
    def name(self) -> str:
        return f"{self.metric}{self.op}{self.threshold:g}"

    @property
    def percentile(self) -> float | None:
        m = _LATENCY_RE.match(self.metric)
        return float(m.group("pct")) if m else None

    @property
    def budget(self) -> float:
        """The error budget, as a fraction of requests."""
        pct = self.percentile
        if pct is not None:
            return max((100.0 - pct) / 100.0, 1e-6)
        return max(1.0 - self.threshold, 1e-6)


def parse_slo(spec: str) -> list[SLOObjective]:
    """``"p99_latency_ms<=250;success_rate>=0.99"`` → objectives. An
    unknown metric or a wrong operator raises: a typo must not evaluate
    to "never breached"."""
    objectives: list[SLOObjective] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        m = _SPEC_RE.match(part)
        if not m:
            raise ValueError(f"bad SLO objective {part!r}; expected metric<=N or metric>=N")
        metric, op, thr = m.group("metric"), m.group("op"), float(m.group("threshold"))
        if _LATENCY_RE.match(metric):
            if op != "<=":
                raise ValueError(f"latency objective {metric} needs <=, got {op}")
        elif metric == "success_rate":
            if op != ">=":
                raise ValueError(f"success_rate needs >=, got {op}")
            if not 0.0 < thr < 1.0:
                raise ValueError(f"success_rate threshold must be in (0,1), got {thr}")
        else:
            raise ValueError(f"unknown SLO metric {metric!r} (pNN_latency_ms or success_rate)")
        objectives.append(SLOObjective(metric, op, thr))
    if not objectives:
        raise ValueError(f"empty SLO spec {spec!r}")
    return objectives


class SLOTracker:
    """Rolling-window SLO evaluation over finished requests: feed
    :meth:`observe` with each request's latency and outcome (``"ok"``,
    ``"late"``, ``"deadline"``, ``"shed"``, ...), or :meth:`observe_trace`
    as a :class:`RequestTracer` ``on_finish`` hook, then :meth:`evaluate`
    (the exporter's pre-scrape hook and the ``/healthz`` probe both call
    it). ``probes`` maps gauge-name suffixes to zero-arg callables sampled
    at each evaluation (``{"queue_depth": fn}`` publishes
    ``slo_queue_depth``). ``clock`` is injectable for deterministic
    tests."""

    def __init__(
        self,
        objectives: list[SLOObjective],
        *,
        window_s: float = 60.0,
        fast_window_s: float = 0.0,
        burn_threshold: float = 1.0,
        registry=None,
        probes: dict | None = None,
        max_samples: int = 200_000,
        clock=time.monotonic,
    ):
        if not objectives:
            raise ValueError("SLOTracker needs at least one objective")
        self.objectives = tuple(objectives)
        self.window_s = float(window_s)
        self.fast_window_s = float(fast_window_s) or max(self.window_s / 12.0, 1.0)
        self.burn_threshold = float(burn_threshold)
        self._clock = clock
        self._probes = dict(probes or {})
        self._lock = threading.Lock()
        # (t, latency_s, outcome), bounded so a flood cannot grow memory
        self._samples: deque = deque(maxlen=int(max_samples))
        self._last_breach_t: float | None = None
        self.last_report: dict | None = None
        reg = registry if registry is not None else get_registry()
        self._g_value = reg.gauge("slo_value", "current value of each SLO metric", labels=("objective",))
        self._g_threshold = reg.gauge("slo_threshold", "configured threshold per objective", labels=("objective",))
        self._g_burn = reg.gauge(
            "slo_burn_rate", "error-budget burn rate per objective and window", labels=("objective", "window")
        )
        self._g_breached = reg.gauge("slo_breached", "1 while the objective is in breach", labels=("objective",))
        self._g_degraded = reg.gauge("slo_degraded", "1 while any objective breached within the last window_s")
        self._g_shed = reg.gauge("slo_shed_rate", "shed requests / finished requests over window_s")
        self._registry = reg
        self._g_probes = {name: reg.gauge(f"slo_{name}", f"SLO probe: {name}") for name in self._probes}
        for obj in self.objectives:
            self._g_threshold.labels(obj.name).set(obj.threshold)

    def add_probe(self, name: str, fn) -> None:
        """Attach a probe after construction (the tracker usually exists
        before the batcher or pool it watches): ``fn`` is sampled at each
        evaluation and published as ``slo_<name>``."""
        with self._lock:
            if name not in self._g_probes:
                self._g_probes[name] = self._registry.gauge(f"slo_{name}", f"SLO probe: {name}")
            self._probes[name] = fn

    def observe(self, latency_s: float | None, outcome: str) -> None:
        with self._lock:
            self._samples.append((self._clock(), latency_s, outcome))

    def observe_trace(self, tr) -> None:
        """The :class:`RequestTracer` ``on_finish`` feed."""
        self.observe(tr.latency_s, tr.outcome)

    @staticmethod
    def _window(samples, now: float, span: float):
        cutoff = now - span
        return [s for s in samples if s[0] >= cutoff]

    @staticmethod
    def _ok_latencies(window) -> list[float]:
        return [lat for _, lat, out in window if out == "ok" and lat is not None]

    @classmethod
    def _violation_frac(cls, window, obj: SLOObjective) -> float:
        if not window:
            return 0.0
        if obj.percentile is not None:
            # latency: violations among the requests that completed
            ok = cls._ok_latencies(window)
            return sum(1 for lat in ok if lat * 1000.0 > obj.threshold) / len(ok) if ok else 0.0
        return sum(1 for _, _, out in window if out != "ok") / len(window)

    @classmethod
    def _value(cls, window, obj: SLOObjective) -> float:
        if obj.percentile is not None:
            ok = sorted(cls._ok_latencies(window))
            if not ok:
                return 0.0
            # nearest-rank sample percentile
            rank = min(len(ok) - 1, max(0, int(obj.percentile / 100.0 * len(ok))))
            return ok[rank] * 1000.0
        if not window:
            return 1.0
        return sum(1 for _, _, out in window if out == "ok") / len(window)

    def evaluate(self, now: float | None = None) -> dict:
        """Every objective over both windows: refreshes the ``slo_*``
        gauges and returns the verdict dict (values, burn rates, breaches,
        ``degraded``, ``shed_rate``; the ``/healthz`` probe body)."""
        now = self._clock() if now is None else now
        with self._lock:
            samples = list(self._samples)
        slow = self._window(samples, now, self.window_s)
        fast = self._window(samples, now, self.fast_window_s)
        report: dict = {"window_s": self.window_s, "fast_window_s": self.fast_window_s, "samples": len(slow),
                        "objectives": []}
        breached_any = False
        for obj in self.objectives:
            burn_slow = self._violation_frac(slow, obj) / obj.budget
            burn_fast = self._violation_frac(fast, obj) / obj.budget
            breached = bool(slow) and burn_slow > self.burn_threshold and (
                not fast or burn_fast > self.burn_threshold
            )
            breached_any = breached_any or breached
            value = self._value(slow, obj)
            self._g_value.labels(obj.name).set(value)
            self._g_burn.labels(obj.name, "slow").set(burn_slow)
            self._g_burn.labels(obj.name, "fast").set(burn_fast)
            self._g_breached.labels(obj.name).set(1.0 if breached else 0.0)
            report["objectives"].append({
                "name": obj.name,
                "value": round(value, 4),
                "threshold": obj.threshold,
                "burn_slow": round(burn_slow, 4),
                "burn_fast": round(burn_fast, 4),
                "breached": breached,
            })
        if breached_any:
            with self._lock:
                self._last_breach_t = now
        degraded = self._degraded_at(now)
        report["degraded"] = degraded
        self._g_degraded.set(1.0 if degraded else 0.0)
        shed = sum(1 for _, _, out in slow if out == "shed")
        self._g_shed.set(shed / len(slow) if slow else 0.0)
        report["shed_rate"] = round(shed / len(slow), 4) if slow else 0.0
        with self._lock:
            probes = list(self._probes.items())
        for name, fn in probes:
            try:
                self._g_probes[name].set(float(fn()))
            except Exception:  # noqa: BLE001 - a probe must not break an evaluation
                pass
        self.last_report = report
        return report

    def worst_burn(self, now: float | None = None) -> float:
        """A fresh evaluation's worst slow-window burn rate."""
        rep = self.evaluate(now)
        return max((o["burn_slow"] for o in rep["objectives"]), default=0.0)

    def _degraded_at(self, now: float) -> bool:
        with self._lock:
            last = self._last_breach_t
        return last is not None and (now - last) <= self.window_s

    def degraded(self) -> bool:
        """The latched breach flag: true within one slow window of the
        last breach."""
        self.evaluate()
        return self._degraded_at(self._clock())

    def healthz_info(self) -> dict:
        """The ``/healthz`` probe body: a fresh evaluation."""
        return self.evaluate()
