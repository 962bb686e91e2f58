"""Per-request trace context for the serving path.

Counterpart of ``jumbo_mae_tpu_tpu/obs/reqtrace.py``, ported as it is.
The aggregate counters say *how much* the serving stack did; this module
says *what happened to request 8 131*. Every request the continuous
scheduler or the replica pool takes gets a :class:`RequestTrace` — a
monotonic request id plus wall/perf timestamps — so the latency
breakdown survives per request:

- **queue_wait** — ``submit()`` start → admission into a batch;
- **admission** — admitted → the batch's flush began (coalescing wait);
- **compute** — the batched forward (the engine's graph replay);
- **fetch** — device→host transfer of the result rows;
- plus the **bucket**, the batch size, the **pad fraction**, the packed
  **tokens**, the cost meter's **device_s**/**cost_flops** stamps, and
  the terminal **outcome**: ``ok | shed | deadline | late | aborted |
  shutdown`` (``late`` = the deadline passed after admission).

With the replicated tier (``infer/replicaset.py``) a trace also carries
``replica_id``, ``retries`` and ``requeued_from``: who served it and who
failed to.

Each finished trace lands in labeled ``request_*`` histograms of the
metrics registry and, with an :class:`AccessLog`, as one JSONL row of a
crash-safe rotated-segment log (the ``obs/journal.py`` writer) that
``tools/cost_doctor.py`` reads offline. A pool or scheduler built
without a tracer pays nothing: every hook site is a ``None`` check.
"""

from __future__ import annotations

import itertools
import threading
import time
from pathlib import Path
from typing import Callable

from jumbo_mae_tpu_tpu_torch.obs.journal import RunJournal
from jumbo_mae_tpu_tpu_torch.obs.metrics import RATIO_BUCKETS, get_registry

OUTCOMES = ("ok", "shed", "deadline", "late", "aborted", "shutdown")


class RequestTrace:
    """One request's context: identity, timestamps, and the breakdown
    filled in as it moves through the pipeline. Plain slots — created per
    request on the submit path."""

    __slots__ = (
        "rid", "task", "deadline_ms", "wall_ts", "t0", "t_admit", "t_flush",
        "queue_wait_s", "admission_s", "compute_s", "fetch_s",
        "batch", "bucket", "pad_fraction", "latency_s", "outcome", "error",
        "replica_id", "retries", "requeued_from", "tenant", "tclass",
        "device_s", "cost_flops", "tokens",
    )

    def __init__(
        self,
        rid: int,
        task: str,
        deadline_ms: float | None,
        tenant: str | None = None,
        tclass: str | None = None,
    ):
        self.rid = rid
        self.task = task
        self.deadline_ms = deadline_ms
        self.tenant = tenant
        self.tclass = tclass
        self.wall_ts = time.time()
        self.t0 = time.perf_counter()
        self.t_admit = None
        self.t_flush = None
        self.queue_wait_s = None
        self.admission_s = None
        self.compute_s = None
        self.fetch_s = None
        self.batch = None
        self.bucket = None
        self.pad_fraction = None
        self.latency_s = None
        self.outcome = None
        self.error = None
        self.replica_id = None
        self.retries = 0
        self.requeued_from = None
        self.device_s = None
        self.cost_flops = None
        # patch+CLS token count, stamped by the packed scheduler path —
        # the costmeter bills device time token-pro-rata when present
        self.tokens = None


class AccessLog:
    """Thread-safe crash-safe JSONL access log: the journal's rotated-
    segment writer behind one lock (trace rows come from the collector
    thread AND from shedding submit threads).

    ``fsync=False`` by default — the access log is per-request, not
    log-cadence; a flush per line plus the reader's torn-tail tolerance is
    the crash-safety contract serving can afford. Readable by
    :func:`obs.journal.read_journal` (and ``tools/cost_doctor.py``).
    """

    def __init__(
        self,
        directory: str | Path,
        *,
        max_bytes: int = 8 * 1024 * 1024,
        keep: int = 16,
        fsync: bool = False,
    ):
        self._journal = RunJournal(
            directory, max_bytes=max_bytes, keep=keep, fsync=fsync
        )
        self._lock = threading.Lock()

    @property
    def path(self) -> Path:
        return self._journal.path

    def event(self, etype: str, **fields) -> dict:
        with self._lock:
            return self._journal.event(etype, **fields)

    def close(self) -> None:
        with self._lock:
            self._journal.close()

    def __enter__(self) -> "AccessLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _ms(seconds) -> float | None:
    return None if seconds is None else round(seconds * 1000.0, 3)


class RequestTracer:
    """Creates, advances, and finishes :class:`RequestTrace` objects.

    ``breakdown`` is a zero-arg callable returning the engine's per-call
    compute/fetch/bucket/pad breakdown for the current thread
    (:meth:`InferenceEngine.last_breakdown`) — invoked on the collector
    thread right after ``run_fn`` returns, so it sees exactly the predict
    the flushed batch ran. ``on_finish`` receives every finished trace
    (the SLO tracker's feed); ``access_log`` gets one ``request`` row per
    finished trace. All three are optional and independent.
    """

    def __init__(
        self,
        *,
        registry=None,
        access_log: AccessLog | None = None,
        breakdown: Callable[[], dict | None] | None = None,
        on_finish: Callable[[RequestTrace], None] | None = None,
    ):
        reg = registry if registry is not None else get_registry()
        self.access_log = access_log
        self._breakdown = breakdown
        self._on_finish = on_finish
        self._next_rid = itertools.count().__next__  # GIL-atomic
        self._m_latency = reg.histogram(
            "request_latency_seconds",
            "end-to-end request latency by terminal outcome",
            labels=("outcome",),
        )
        self._m_queue = reg.histogram(
            "request_queue_wait_seconds",
            "submit() start to batch admission (includes submit-side stalls)",
        )
        self._m_admission = reg.histogram(
            "request_admission_seconds",
            "batch admission to flush start (coalescing wait)",
        )
        self._m_compute = reg.histogram(
            "request_compute_seconds",
            "batched forward (dispatch + device execution) per request",
        )
        self._m_fetch = reg.histogram(
            "request_fetch_seconds", "device-to-host result fetch per request"
        )
        self._m_pad = reg.histogram(
            "request_pad_fraction",
            "padding rows / bucket for the chunk that served the request",
            buckets=RATIO_BUCKETS,
        )
        self._m_outcomes = reg.counter(
            "request_outcomes_total",
            "finished requests by terminal outcome",
            labels=("outcome",),
        )

    # ------------------------------------------------------------ lifecycle

    def begin(
        self,
        *,
        task: str = "",
        deadline_ms: float | None = None,
        tenant: str | None = None,
        tclass: str | None = None,
    ) -> RequestTrace:
        return RequestTrace(self._next_rid(), task, deadline_ms, tenant, tclass)

    def admitted(self, tr: RequestTrace) -> None:
        tr.t_admit = time.perf_counter()
        tr.queue_wait_s = tr.t_admit - tr.t0

    def flush_begin(self, traces) -> None:
        now = time.perf_counter()
        for tr in traces:
            tr.t_flush = now
            if tr.t_admit is not None:
                tr.admission_s = now - tr.t_admit

    def flush_end(self, traces, *, run_s: float, batch: int, breakdown=None) -> None:
        """Stamp the batch-level breakdown onto every trace in the flush.
        With an engine breakdown available, compute/fetch are the engine's
        own split; otherwise the whole ``run_fn`` wall time is compute.
        ``breakdown`` overrides the constructor callable for this flush —
        a replica set has one engine per replica, so the right
        ``last_breakdown`` is only known at the call site."""
        fn = breakdown if breakdown is not None else self._breakdown
        bd = fn() if fn is not None else None
        for tr in traces:
            tr.batch = batch
            if bd is not None:
                tr.compute_s = bd.get("compute_s")
                tr.fetch_s = bd.get("fetch_s")
                tr.bucket = bd.get("bucket")
                tr.pad_fraction = bd.get("pad_fraction")
            else:
                tr.compute_s = run_s

    def finish(self, tr: RequestTrace, outcome: str, *, error: str | None = None) -> None:
        tr.outcome = outcome
        tr.error = error
        now = time.perf_counter()
        tr.latency_s = now - tr.t0
        if tr.queue_wait_s is None:
            # never admitted (shed / deadline / shutdown): everything the
            # caller waited is pre-admission time
            tr.queue_wait_s = tr.latency_s
        self._m_latency.labels(outcome).observe(tr.latency_s)
        self._m_outcomes.labels(outcome).inc()
        self._m_queue.observe(tr.queue_wait_s)
        if tr.admission_s is not None:
            self._m_admission.observe(tr.admission_s)
        if tr.compute_s is not None:
            self._m_compute.observe(tr.compute_s)
        if tr.fetch_s is not None:
            self._m_fetch.observe(tr.fetch_s)
        if tr.pad_fraction is not None:
            self._m_pad.observe(tr.pad_fraction)
        if self.access_log is not None:
            row = {
                "rid": tr.rid,
                "outcome": outcome,
                "lat_ms": _ms(tr.latency_s),
                "queue_wait_ms": _ms(tr.queue_wait_s),
            }
            if tr.task:
                row["task"] = tr.task
            for key, val in (
                ("admission_ms", _ms(tr.admission_s)),
                ("compute_ms", _ms(tr.compute_s)),
                ("fetch_ms", _ms(tr.fetch_s)),
                ("batch", tr.batch),
                ("bucket", tr.bucket),
                ("pad", tr.pad_fraction),
                ("tokens", tr.tokens),
                ("device_ms", _ms(tr.device_s)),
                ("cost_flops", tr.cost_flops),
                ("deadline_ms", tr.deadline_ms),
                ("tenant", tr.tenant),
                ("class", tr.tclass),
                ("replica", tr.replica_id),
                ("retries", tr.retries or None),
                ("requeued_from", tr.requeued_from),
                ("err", error),
            ):
                if val is not None:
                    row[key] = val
            self.access_log.event("request", **row)
        if self._on_finish is not None:
            self._on_finish(tr)

    def event(self, etype: str, **fields) -> None:
        """Write a non-request event (e.g. an SLO summary) into the access
        log, when one is attached."""
        if self.access_log is not None:
            self.access_log.event(etype, **fields)

    def close(self) -> None:
        if self.access_log is not None:
            self.access_log.close()
