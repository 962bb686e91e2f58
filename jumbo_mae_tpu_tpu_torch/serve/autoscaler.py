"""Roofline-driven autoscaler: SLO burn and queue state → replica count.

Counterpart of ``jumbo_mae_tpu_tpu/serve/autoscaler.py``, on the port's
``obs/perfmodel.py`` and :meth:`ReplicaSet.scale_to`. A reconcile tick
reads three signals and computes a target:

- **demand** — an EWMA of the pool's arrival rate plus the backlog
  amortized over one reconcile interval (a queue that grew is demand the
  current capacity already failed to serve);
- **capacity** — requests/s one replica sustains: the roofline
  prediction (:func:`roofline_capacity`) for the serving forward, known
  before any traffic, and a live served-rate estimate; the larger wins;
- **SLO burn** — :meth:`SLOTracker.worst_burn`; burning budget faster
  than it accrues (or an open replica breaker) forces a step up even
  when the demand model disagrees.

``target = ceil(demand * headroom / capacity)`` clamped to
``[min_replicas, max_replicas]``. Up at once; down one step at a time
and only after ``down_hold`` ticks of low demand. Actuation goes through
:meth:`ReplicaSet.scale_to`, which drains a slot before it removes it.

On one H100 the replicas share the card (``infer/replicaset.py``): a
second replica adds crash isolation and a second queue, not a second
device, so the roofline capacity per replica overstates what two
replicas add. The model is the JAX package's all the same; its first
measured ratio on the card is in PERF.md.

Every decision that changes the pool journals an ``autoscale`` event
with its inputs; ``serve_autoscale_*`` metrics show the same live.
``tick()`` is public and the clock injectable: tests drive the reconcile
without the daemon thread.
"""

from __future__ import annotations

import math
import threading
import time

from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry


def roofline_capacity(
    flops_per_item: float,
    bytes_per_item: float,
    chip=None,
    *,
    utilization: float = 0.5,
) -> float:
    """Requests/s one replica sustains, from the roofline model: the
    paper's chip-speed envelope derated by ``utilization`` (a serving
    replica also pays host transfer, dispatch, and coalescing gaps — half
    the roofline is the honest default until measured). ``chip`` defaults
    to the card's row (:func:`detect_chip` of ``"cuda"``, which raises
    without one)."""
    from jumbo_mae_tpu_tpu_torch.obs.perfmodel import detect_chip, roofline

    spec = chip if chip is not None else detect_chip("cuda")
    pred = roofline(flops_per_item, bytes_per_item, spec)
    return pred.throughput_per_sec * float(utilization)


class Autoscaler:
    """Reconcile loop sizing a :class:`ReplicaSet` between
    ``min_replicas`` and ``max_replicas``.

    ``capacity_fn()`` returns predicted requests/s per replica (wire it
    to :func:`roofline_capacity`); without one, only the live estimate is
    used. ``slo`` is an :class:`SLOTracker` (or ``None``). ``start=False``
    skips the daemon thread — tests call :meth:`tick` directly.
    """

    def __init__(
        self,
        replicaset,
        *,
        min_replicas: int = 1,
        max_replicas: int = 4,
        interval_s: float = 1.0,
        slo=None,
        capacity_fn=None,
        headroom: float = 1.2,
        burn_max: float = 1.0,
        down_hold: int = 3,
        drain_timeout_s: float = 10.0,
        tracer=None,
        registry=None,
        clock=time.monotonic,
        start: bool = True,
    ):
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"[{min_replicas}, {max_replicas}]"
            )
        self.rs = replicaset
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.interval_s = float(interval_s)
        self.slo = slo
        self._capacity_fn = capacity_fn
        self.headroom = float(headroom)
        self.burn_max = float(burn_max)
        self.down_hold = int(down_hold)
        self.drain_timeout_s = float(drain_timeout_s)
        self._tracer = tracer
        self._clock = clock
        reg = registry if registry is not None else get_registry()
        self._m_target = reg.gauge(
            "serve_autoscale_target",
            "replica count the autoscaler last decided on",
        )
        self._m_events = reg.counter(
            "serve_autoscale_events_total",
            "pool resizes actuated, by direction (up|down)",
            labels=("direction",),
        )
        self._m_demand = reg.gauge(
            "serve_autoscale_demand",
            "estimated demand (req/s) at the last reconcile tick",
        )
        self._m_capacity = reg.gauge(
            "serve_autoscale_capacity",
            "estimated per-replica capacity (req/s) at the last tick",
        )
        self._last_t: float | None = None
        self._last_submitted: int | None = None
        self._last_served: int | None = None
        self._rate_ewma = 0.0
        self._live_capacity: float | None = None
        self._down_ticks = 0
        self.events: list[dict] = []
        self._closed = False
        self._thread = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="autoscaler"
            )
            self._thread.start()

    # ------------------------------------------------------------ signals

    def _observe(self, stats: dict, now: float) -> tuple[float, float]:
        """Update rate EWMAs from pool counters; returns
        (demand req/s, per-replica capacity req/s)."""
        submitted = stats["requests_submitted"]
        served = sum(r["served"] for r in stats["replicas"].values())
        if self._last_t is not None:
            dt = max(now - self._last_t, 1e-6)
            rate = max(submitted - self._last_submitted, 0) / dt
            self._rate_ewma = 0.4 * rate + 0.6 * self._rate_ewma
            healthy = max(stats["healthy"], 1)
            served_rate = max(served - self._last_served, 0) / dt / healthy
            # the live estimate only *raises* confidence while busy: an
            # idle pool serves 0/s because nothing arrived, not because
            # it can't
            if served_rate > 0:
                self._live_capacity = (
                    served_rate
                    if self._live_capacity is None
                    else max(self._live_capacity * 0.7, served_rate)
                )
        self._last_t = now
        self._last_submitted = submitted
        self._last_served = served
        backlog_rate = stats["queue_depth"] / max(self.interval_s, 1e-6)
        demand = self._rate_ewma + backlog_rate
        predicted = None
        if self._capacity_fn is not None:
            try:
                predicted = float(self._capacity_fn())
            except Exception:  # noqa: BLE001 — a broken model must not stop reconciles
                predicted = None
        candidates = [
            c for c in (predicted, self._live_capacity) if c and c > 0
        ]
        capacity = max(candidates) if candidates else 1.0
        return demand, capacity

    # ---------------------------------------------------------- reconcile

    def tick(self, now: float | None = None) -> dict:
        """One reconcile: read signals, decide, actuate. Returns the
        decision dict (also journaled when the pool changed)."""
        now = self._clock() if now is None else now
        stats = self.rs.stats()
        current = len(stats["replicas"])
        demand, capacity = self._observe(stats, now)
        self._m_demand.set(demand)
        self._m_capacity.set(capacity)
        burn = self.slo.worst_burn() if self.slo is not None else 0.0
        want = math.ceil(demand * self.headroom / capacity) if demand > 0 else 0
        reason = "demand"
        if burn > self.burn_max or stats["breaker_open"]:
            # budget burning or quorum lost: the demand model is wrong or
            # capacity is degraded — step up past whatever it says
            want = max(want, current + 1)
            reason = "burn" if burn > self.burn_max else "breaker"
        target = min(max(want, self.min_replicas), self.max_replicas)
        decision = {
            "t": round(now, 3),
            "current": current,
            "target": target,
            "demand_rps": round(demand, 3),
            "capacity_rps": round(capacity, 3),
            "burn": round(burn, 3),
            "queue_depth": stats["queue_depth"],
            "occupancy": stats.get("batch_occupancy", 0.0),
            "reason": reason,
        }
        self._m_target.set(target)
        if target > current:
            self._down_ticks = 0
            self._actuate(target, "up", decision)
        elif target < current:
            # sustained-low gate, then one step at a time: a drain is
            # cheap to repeat next tick, a killed burst is not
            self._down_ticks += 1
            if self._down_ticks >= self.down_hold and burn <= self.burn_max:
                self._actuate(current - 1, "down", decision)
                self._down_ticks = 0
        else:
            self._down_ticks = 0
        return decision

    def _actuate(self, target: int, direction: str, decision: dict) -> None:
        report = self.rs.scale_to(
            target, drain_timeout_s=self.drain_timeout_s
        )
        decision["scaled_from"] = report["from"]
        decision["scaled_to"] = report["to"]
        if report["to"] == report["from"]:
            return  # nothing moved (slot not removable yet) — retry next tick
        self._m_events.labels(direction).inc()
        self.events.append(decision)
        if self._tracer is not None:
            self._tracer.event("autoscale", direction=direction, **decision)

    def close(self, timeout_s: float = 5.0) -> None:
        self._closed = True
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _loop(self) -> None:
        while not self._closed:
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — a bad tick must not kill the loop
                pass
            time.sleep(self.interval_s)
