"""Tenant cost metering: who consumed the device, and how much was pad.

Counterpart of ``jumbo_mae_tpu_tpu/serve/costmeter.py``. On every
flushed batch the replica pool calls :meth:`CostMeter.observe_batch` with
the measured wall time of the run and the request traces it served. The
meter looks up the graph's :class:`~jumbo_mae_tpu_tpu_torch.obs.costmodel.ProgramCost`
for that ``(task, bucket)``, splits the batch's cost across its occupied
rows and adds it to per-tenant ledgers.

Attribution model — conservation first:

- every occupied row is billed ``run_s / rows`` device-seconds and
  ``exec_flops / rows`` FLOPs, so per-tenant sums reconcile *exactly*
  with the batch-level measurements (``sum device_s == sum run_s``,
  ``sum flops == exec_flops × batches``);
- a token-packed group whose traces all carry ``tokens`` is split
  token-pro-rata instead (a 448 px request does 4× the work of a 224 px
  one), which keeps the same sums;
- padding is an attribution *within* that total, not on top of it: a
  batch at pad fraction ``p`` moves ``run_s × p`` of its bill into the
  dispatching tenants' ``waste`` accounts.

Three read paths: ``serve_tenant_*{tenant,class}`` counters and gauges,
``device_ms``/``cost_flops`` stamped onto each access-log row, and
periodic ``tenant_usage`` journal events (``tools/cost_doctor.py``). The
admission gate reads :meth:`CostMeter.window_usage` for ``budget=``: an
over-budget tenant degrades to scavenger-class shedding.

``chip`` prices device-seconds against a roofline
:class:`~jumbo_mae_tpu_tpu_torch.obs.perfmodel.ChipSpec` in snapshots;
the caller names it (``detect_chip(device)``). Without one the snapshot
carries no roofline utilization: the meter never guesses the card. The
ledgers are guarded by ``obs.lockwatch``'s ``serve.costmeter``, as in the
JAX module.

The meter never raises on the hot path: a missing cost table bills
device time only, and a meter error must not kill a flush.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Iterable

from jumbo_mae_tpu_tpu_torch.obs import lockwatch

_TENANT_LABELS = ("tenant", "class")


def default_cost_fn(engine, task: str, bucket: int):
    """Resolve analytic cost from a real engine's published cost table."""
    from jumbo_mae_tpu_tpu_torch.obs.costmodel import lookup_cost

    return lookup_cost(getattr(engine, "cost_reports", None), task, bucket)


class _Ledger:
    """One tenant's running bill."""

    __slots__ = (
        "tclass",
        "requests",
        "batches",
        "device_s",
        "flops",
        "bytes_accessed",
        "waste_device_s",
        "waste_flops",
        "window",
    )

    def __init__(self, tclass: str):
        self.tclass = tclass
        self.requests = 0
        self.batches = 0
        self.device_s = 0.0
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.waste_device_s = 0.0
        self.waste_flops = 0.0
        # (timestamp, device_s) samples for budget-window accounting
        self.window: deque[tuple[float, float]] = deque()


def _cost_field(cost, name: str) -> float:
    if cost is None:
        return 0.0
    if isinstance(cost, dict):
        val = cost.get(name, 0.0)
    else:
        val = getattr(cost, name, 0.0)
    try:
        return max(0.0, float(val or 0.0))
    except (TypeError, ValueError):
        return 0.0


class CostMeter:
    """Per-tenant usage ledger fed by the replica set's flush loop.

    ``tenants`` seeds the ledger (and eagerly registers metric children)
    for every configured tenant; unknown tenants appearing at dispatch
    time get ledgers on demand. ``cost_fn(engine, task, bucket)`` resolves
    the analytic per-execution cost (``ProgramCost`` or a plain dict with
    ``flops``/``bytes_accessed``); ``None`` engines or lookups bill
    device-time only. ``chip`` prices device-seconds against a roofline
    :class:`~jumbo_mae_tpu_tpu_torch.obs.perfmodel.ChipSpec` in snapshots
    (none: no roofline utilization in them).
    """

    def __init__(
        self,
        tenants: Iterable[Any] = (),
        *,
        cost_fn: Callable[[Any, str, int], Any] | None = default_cost_fn,
        chip=None,
        tracer=None,
        registry=None,
        window_s: float = 60.0,
        journal_interval_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._cost_fn = cost_fn
        self._chip = chip
        self._tracer = tracer
        self._window_s = float(window_s)
        self._journal_interval_s = float(journal_interval_s)
        self._clock = clock
        self._lock = lockwatch.lock("serve.costmeter")
        self._ledgers: dict[str, _Ledger] = {}
        self._budgets: dict[str, tuple[float, float]] = {}
        # batch-level totals the conservation tests reconcile against
        self.total_batches = 0
        self.total_device_s = 0.0
        self.total_flops = 0.0
        self._t_journal = clock()

        if registry is None:
            from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry

            registry = get_registry()
        reg = registry
        self._m_requests = reg.counter(
            "serve_tenant_requests_total",
            "requests served (reached a device batch) per tenant",
            labels=_TENANT_LABELS,
        )
        self._m_device_s = reg.counter(
            "serve_tenant_device_seconds_total",
            "device wall-seconds attributed to the tenant, pro-rata per occupied row",
            labels=_TENANT_LABELS,
        )
        self._m_flops = reg.counter(
            "serve_tenant_flops_total",
            "executable FLOPs attributed to the tenant, pro-rata per occupied row",
            labels=_TENANT_LABELS,
        )
        self._m_waste_s = reg.counter(
            "serve_tenant_waste_device_seconds_total",
            "share of the tenant's device-seconds that bought bucket padding",
            labels=_TENANT_LABELS,
        )
        self._m_share = reg.gauge(
            "serve_tenant_capacity_share",
            "tenant's fraction of metered device-seconds over the budget window",
            labels=_TENANT_LABELS,
        )
        for spec in tenants:
            name = getattr(spec, "name", str(spec))
            self._ledger(name, getattr(spec, "tclass", "batch"))
            budget = getattr(spec, "budget", None)
            if budget is not None:
                win = getattr(spec, "budget_window_s", None) or self._window_s
                self._budgets[name] = (float(budget), float(win))

    # -- ledger plumbing ---------------------------------------------------

    def _ledger(self, tenant: str, tclass: str | None) -> _Ledger:
        led = self._ledgers.get(tenant)
        if led is None:
            led = _Ledger(tclass or "batch")
            self._ledgers[tenant] = led
            labels = (tenant, led.tclass)
            # eager children: the tenant is scrapeable from first sight
            self._m_requests.labels(*labels)
            self._m_device_s.labels(*labels)
            self._m_flops.labels(*labels)
            self._m_waste_s.labels(*labels)
            self._m_share.labels(*labels)
        return led

    def _prune(self, led: _Ledger, now: float, window: float) -> float:
        cutoff = now - window
        win = led.window
        while win and win[0][0] < cutoff:
            win.popleft()
        return sum(s for _, s in win)

    # -- hot path ----------------------------------------------------------

    def observe_batch(
        self, *, run_s: float, traces, batch: int, engine=None
    ) -> None:
        """Attribute one flushed batch. Called by ``ReplicaSet._flush``
        after a successful run, before per-request finish — so the stamped
        ``device_s``/``cost_flops`` land on every access-log row."""
        try:
            self._observe(run_s=run_s, traces=traces, batch=batch, engine=engine)
        except Exception:  # noqa: BLE001 - metering must never kill a flush
            pass

    def _observe(self, *, run_s: float, traces, batch: int, engine) -> None:
        traces = [tr for tr in traces if tr is not None]
        if not traces:
            return
        n = max(int(batch), len(traces), 1)
        run_s = max(0.0, float(run_s))
        lead = traces[0]
        task = getattr(lead, "task", None) or "predict"
        bucket = getattr(lead, "bucket", None) or n
        pad = getattr(lead, "pad_fraction", None)
        if pad is None:
            pad = max(0.0, (int(bucket) - n) / int(bucket)) if bucket else 0.0
        pad = min(1.0, max(0.0, float(pad)))

        cost = None
        if self._cost_fn is not None:
            try:
                cost = self._cost_fn(engine, task, int(bucket))
            except Exception:  # noqa: BLE001 - cost lookup is best-effort
                cost = None
        exec_flops = _cost_field(cost, "flops")
        exec_bytes = _cost_field(cost, "bytes_accessed")

        # token-packed groups carry per-trace token counts: a 896px request
        # in the pack did ~49x the work of a 224px one, so uniform per-row
        # split would cross-subsidize. Token-pro-rata shares preserve the
        # conservation law (per-trace sums still equal batch totals).
        tok = [float(getattr(tr, "tokens", None) or 0) for tr in traces]
        tok_total = sum(tok)
        token_weighted = tok_total > 0 and all(t > 0 for t in tok)

        row_s = run_s / n
        row_flops = exec_flops / n
        row_bytes = exec_bytes / n
        waste_s_per_trace = run_s * pad / len(traces)
        waste_flops_per_trace = exec_flops * pad / len(traces)
        now = self._clock()

        with self._lock:
            self.total_batches += 1
            self.total_device_s += run_s
            self.total_flops += exec_flops
            seen: set[str] = set()
            for j, tr in enumerate(traces):
                if token_weighted:
                    share = tok[j] / tok_total
                    row_s = run_s * share
                    row_flops = exec_flops * share
                    row_bytes = exec_bytes * share
                    waste_s_per_trace = run_s * pad * share
                    waste_flops_per_trace = exec_flops * pad * share
                tr.device_s = row_s
                tr.cost_flops = row_flops if row_flops > 0.0 else None
                tenant = getattr(tr, "tenant", None) or "_default"
                led = self._ledger(tenant, getattr(tr, "tclass", None))
                led.requests += 1
                if tenant not in seen:
                    seen.add(tenant)
                    led.batches += 1
                led.device_s += row_s
                led.flops += row_flops
                led.bytes_accessed += row_bytes
                led.waste_device_s += waste_s_per_trace
                led.waste_flops += waste_flops_per_trace
                led.window.append((now, row_s))
                labels = (tenant, led.tclass)
                self._m_requests.labels(*labels).inc()
                self._m_device_s.labels(*labels).inc(row_s)
                if row_flops:
                    self._m_flops.labels(*labels).inc(row_flops)
                if waste_s_per_trace:
                    self._m_waste_s.labels(*labels).inc(waste_s_per_trace)
            self._update_shares(now)
        self._maybe_journal(now)

    def _update_shares(self, now: float) -> None:
        usage = {
            t: self._prune(led, now, self._window_s)
            for t, led in self._ledgers.items()
        }
        total = sum(usage.values())
        for tenant, win_s in usage.items():
            led = self._ledgers[tenant]
            share = win_s / total if total > 0.0 else 0.0
            self._m_share.labels(tenant, led.tclass).set(share)

    # -- budget + reporting ------------------------------------------------

    def window_usage(self, tenant: str, window_s: float | None = None) -> float:
        """Device-seconds the tenant consumed over the trailing window."""
        with self._lock:
            led = self._ledgers.get(tenant)
            if led is None:
                return 0.0
            return self._prune(led, self._clock(), window_s or self._window_s)

    def budget_for(self, tenant: str) -> tuple[float, float] | None:
        """(device-seconds, window-seconds) budget, if one is configured."""
        return self._budgets.get(tenant)

    def over_budget(self, tenant: str) -> bool:
        budget = self._budgets.get(tenant)
        if budget is None:
            return False
        limit, window = budget
        return self.window_usage(tenant, window) >= limit

    def snapshot(self) -> dict:
        """Ledger totals for reports: per-tenant bill + batch-level sums."""
        now = self._clock()
        with self._lock:
            tenants = {}
            win_usage = {
                t: self._prune(led, now, self._window_s)
                for t, led in self._ledgers.items()
            }
            win_total = sum(win_usage.values())
            for tenant, led in self._ledgers.items():
                budget = self._budgets.get(tenant)
                row = {
                    "class": led.tclass,
                    "requests": led.requests,
                    "device_s": led.device_s,
                    "flops": led.flops,
                    "bytes_accessed": led.bytes_accessed,
                    "waste_device_s": led.waste_device_s,
                    "waste_flops": led.waste_flops,
                    "window_device_s": win_usage[tenant],
                    "share": win_usage[tenant] / win_total if win_total else 0.0,
                }
                if budget is not None:
                    limit, window = budget
                    used = self._prune(led, now, window)
                    row["budget_device_s"] = limit
                    row["budget_window_s"] = window
                    row["budget_used_s"] = used
                    row["over_budget"] = used >= limit
                tenants[tenant] = row
            out = {
                "tenants": tenants,
                "total_batches": self.total_batches,
                "total_device_s": self.total_device_s,
                "total_flops": self.total_flops,
            }
        if self._chip is not None:
            out["chip"] = getattr(self._chip, "name", str(self._chip))
            peak = getattr(self._chip, "peak_tflops", 0.0) or 0.0
            if peak and out["total_device_s"] > 0.0:
                # achieved fraction of what the chip could have delivered
                # over the metered device-time
                out["roofline_utilization"] = out["total_flops"] / (
                    out["total_device_s"] * peak * 1e12
                )
        return out

    def _maybe_journal(self, now: float) -> None:
        if self._tracer is None:
            return
        if now - self._t_journal < self._journal_interval_s:
            return
        self._t_journal = now
        self._journal()

    def _journal(self) -> None:
        if self._tracer is None:
            return
        snap = self.snapshot()
        for tenant, row in snap["tenants"].items():
            fields = {
                "tenant": tenant,
                "class": row["class"],
                "requests": row["requests"],
                "device_s": round(row["device_s"], 6),
                "flops": row["flops"],
                "waste_device_s": round(row["waste_device_s"], 6),
                "window_device_s": round(row["window_device_s"], 6),
                "share": round(row["share"], 4),
            }
            if "budget_device_s" in row:
                fields["budget_device_s"] = row["budget_device_s"]
                fields["over_budget"] = row["over_budget"]
            try:
                self._tracer.event("tenant_usage", **fields)
            except Exception:  # noqa: BLE001 - journaling is best-effort
                return

    def flush(self) -> None:
        """Force a final ``tenant_usage`` emission (shutdown path)."""
        self._journal()
