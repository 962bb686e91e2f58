"""Weighted multi-tenant admission: token-bucket quotas, priority classes
and device-second budgets.

Counterpart of ``jumbo_mae_tpu_tpu/serve/admission.py``. Every request
names a tenant, every tenant has a priority class, and under pressure the
low classes shed first:

- ``interactive`` sheds only at full pressure (and jumps the continuous
  scheduler's dispatch order);
- ``batch`` sheds when the pool is clearly loaded;
- ``scavenger`` sheds at the first sign of load.

Three shed reasons, all subclasses of ``infer/batching.py``'s
:class:`QueueFullError`: **quota** (:class:`TenantQuotaError`, the
tenant's token bucket is empty), **pressure**
(:class:`TenantPressureError`, pool pressure crossed the class's
threshold) and **budget** (:class:`TenantBudgetError`: the tenant spent
its ``budget=`` device-seconds over its window, by the attached
:class:`~jumbo_mae_tpu_tpu_torch.serve.costmeter.CostMeter`, so it sheds
at scavenger-class pressure; at zero pressure it is still admitted — a
budget bounds a tenant's claim on contended capacity, it is not a kill
switch). Buckets refill at ``rate`` tokens/s up to ``burst``; the clock
is injectable. The ``serve_admit_*`` metrics and
``serve_tenant_budget_remaining`` are the JAX package's, and so is its
watched lock (``obs.lockwatch``'s ``serve.admission``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from jumbo_mae_tpu_tpu_torch.infer.batching import QueueFullError
from jumbo_mae_tpu_tpu_torch.obs import lockwatch
from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry

# priority order: index 0 sheds last and jumps the queue first
CLASSES = ("interactive", "batch", "scavenger")

# pool pressure (0..1) at which each class starts shedding
CLASS_SHED_PRESSURE = {"interactive": 1.0, "batch": 0.85, "scavenger": 0.5}

# the continuous scheduler's score bonus per class
CLASS_WEIGHT = {"interactive": 1.0, "batch": 0.35, "scavenger": 0.0}


class TenantQuotaError(QueueFullError):
    """The tenant's token bucket is empty: over its contracted rate."""


class TenantPressureError(QueueFullError):
    """Pool pressure crossed this tenant's class shed threshold."""


class TenantBudgetError(QueueFullError):
    """The tenant spent its device-second budget and the pool is
    contended: shed at scavenger-class pressure until the window rolls."""


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's contract: a class, an optional rate limit and an
    optional device-second budget over a window (the meter's default
    window when ``None``)."""

    name: str
    tclass: str = "batch"
    rate: float | None = None  # requests per second
    burst: float | None = None  # bucket capacity; default max(rate, 1)
    budget: float | None = None  # device-seconds per accounting window
    budget_window_s: float | None = None

    def __post_init__(self):
        if self.tclass not in CLASSES:
            raise ValueError(f"unknown tenant class {self.tclass!r} for {self.name!r}; expected one of {CLASSES}")
        if self.rate is not None and self.rate <= 0:
            raise ValueError(f"tenant {self.name!r} rate must be > 0")
        if self.budget is not None and self.budget <= 0:
            raise ValueError(f"tenant {self.name!r} budget must be > 0")
        if self.budget_window_s is not None and self.budget_window_s <= 0:
            raise ValueError(f"tenant {self.name!r} window must be > 0")


def parse_tenants(spec: str) -> list[TenantSpec]:
    """``"web=interactive:rate=50:burst=100,scrape=batch:rate=5:budget=2"``:
    comma-separated ``name=class[:rate=N][:burst=N][:budget=D][:window=W]``.
    Typos raise: a silent default would demote a tenant to ``batch``."""
    tenants: list[TenantSpec] = []
    seen: set[str] = set()
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(f"bad tenant entry {entry!r}; expected name=class[:rate=N]")
        name, _, rest = entry.partition("=")
        name = name.strip()
        if not name:
            raise ValueError(f"empty tenant name in {entry!r}")
        if name in seen:
            raise ValueError(f"duplicate tenant {name!r}")
        seen.add(name)
        parts = rest.split(":")
        opts = {"rate": None, "burst": None, "budget": None, "window": None}
        for opt in parts[1:]:
            key, _, val = opt.partition("=")
            key = key.strip()
            if key not in opts:
                raise ValueError(f"unknown tenant option {key!r} in {entry!r} (rate, burst, budget, window)")
            opts[key] = float(val)
        tenants.append(TenantSpec(name, parts[0].strip(), opts["rate"], opts["burst"], opts["budget"], opts["window"]))
    if not tenants:
        raise ValueError(f"empty tenant spec {spec!r}")
    return tenants


class _Bucket:
    """One tenant's token bucket; the caller holds the admission lock."""

    __slots__ = ("rate", "capacity", "tokens", "t")

    def __init__(self, rate: float, burst: float | None, now: float):
        self.rate = float(rate)
        self.capacity = float(burst) if burst is not None else max(rate, 1.0)
        self.tokens = self.capacity
        self.t = now

    def take(self, now: float) -> bool:
        self.tokens = min(self.capacity, self.tokens + (now - self.t) * self.rate)
        self.t = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class AdmissionController:
    """Admit-or-shed gate in front of the scheduler. ``pressure_fn()``
    returns pool pressure in [0, 1] (the scheduler's pending depth /
    ``max_queue``, or the pool's); without one only quotas apply.
    ``meter`` prices ``budget=`` tenants. An unknown tenant is admitted
    as ``batch`` with no quota: admission shapes traffic, it does not
    authenticate."""

    def __init__(self, tenants, *, pressure_fn=None, meter=None, registry=None, clock=time.monotonic):
        self._clock = clock
        self._pressure_fn = pressure_fn
        self._meter = meter
        self._specs = {t.name: t for t in tenants}
        self._lock = lockwatch.lock("serve.admission")
        now = clock()
        self._buckets = {t.name: _Bucket(t.rate, t.burst, now) for t in tenants if t.rate is not None}
        self._default = TenantSpec("_default", "batch")
        reg = registry if registry is not None else get_registry()
        self._m_admitted = reg.counter("serve_admit_total", "requests admitted past the tenant gate",
                                       labels=("tenant", "class"))
        self._m_shed = reg.counter("serve_admit_shed_total",
                                   "requests shed at admission by reason (quota|pressure|budget)",
                                   labels=("tenant", "class", "reason"))
        self._m_pressure = reg.gauge("serve_admit_pressure", "pool pressure sampled at the last admission decision")
        self._m_budget_left = reg.gauge("serve_tenant_budget_remaining",
                                        "device-seconds left in the tenant's budget window (budgeted tenants)",
                                        labels=("tenant", "class"))
        # every configured tenant is scrapeable (at zero) from construction
        for sp in self._specs.values():
            self._m_admitted.labels(sp.name, sp.tclass)
            for reason in ("quota", "pressure", "budget"):
                self._m_shed.labels(sp.name, sp.tclass, reason)
            if sp.budget is not None:
                self._m_budget_left.labels(sp.name, sp.tclass).set(sp.budget)
        self._admitted_n: dict[str, int] = {}
        self._shed_n: dict[tuple[str, str], int] = {}

    def set_pressure_fn(self, fn) -> None:
        self._pressure_fn = fn

    def set_meter(self, meter) -> None:
        """Late-bind the cost meter that prices ``budget=`` tenants."""
        self._meter = meter

    def spec(self, tenant: str | None) -> TenantSpec:
        if tenant is None:
            return self._default
        return self._specs.get(tenant, TenantSpec(tenant, "batch"))

    def pressure(self) -> float:
        if self._pressure_fn is None:
            return 0.0
        try:
            return max(0.0, float(self._pressure_fn()))
        except Exception:  # noqa: BLE001 - a broken probe must not shed traffic
            return 0.0

    def admit(self, tenant: str | None) -> TenantSpec:
        """Gate one request: the tenant's spec, or a typed shed. Pressure is
        checked before budget and quota: under load a low class sheds even
        with tokens in the bank. A budgeted tenant past its window's budget
        sheds at scavenger pressure, never at zero pressure."""
        sp = self.spec(tenant)
        pressure = self.pressure()
        self._m_pressure.set(pressure)
        if pressure >= CLASS_SHED_PRESSURE[sp.tclass]:
            self._shed(sp, "pressure")
            raise TenantPressureError(
                f"tenant {sp.name!r} ({sp.tclass}) shed at pressure {pressure:.2f} >= "
                f"{CLASS_SHED_PRESSURE[sp.tclass]}"
            )
        if sp.budget is not None and self._meter is not None:
            used = self._meter.window_usage(sp.name, sp.budget_window_s)
            self._m_budget_left.labels(sp.name, sp.tclass).set(max(0.0, sp.budget - used))
            if used >= sp.budget and pressure >= CLASS_SHED_PRESSURE["scavenger"]:
                self._shed(sp, "budget")
                raise TenantBudgetError(
                    f"tenant {sp.name!r} over budget ({used:.3f}s >= {sp.budget:g}s device-time per window) "
                    f"at pressure {pressure:.2f}"
                )
        bucket = self._buckets.get(sp.name)
        if bucket is not None:
            with self._lock:
                ok = bucket.take(self._clock())
            if not ok:
                self._shed(sp, "quota")
                raise TenantQuotaError(
                    f"tenant {sp.name!r} over quota ({bucket.rate:g} req/s, burst {bucket.capacity:g})"
                )
        self._m_admitted.labels(sp.name, sp.tclass).inc()
        with self._lock:
            self._admitted_n[sp.name] = self._admitted_n.get(sp.name, 0) + 1
        return sp

    def _shed(self, sp: TenantSpec, reason: str) -> None:
        self._m_shed.labels(sp.name, sp.tclass, reason).inc()
        with self._lock:
            key = (sp.name, reason)
            self._shed_n[key] = self._shed_n.get(key, 0) + 1

    def stats(self) -> dict:
        with self._lock:
            return {"admitted": dict(self._admitted_n), "shed": {f"{t}:{r}": n for (t, r), n in self._shed_n.items()}}
