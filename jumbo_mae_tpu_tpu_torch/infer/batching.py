"""Micro-batching queue: coalesce single-image requests into batches.

Counterpart of ``jumbo_mae_tpu_tpu/infer/batching.py``. Callers
``submit()`` one image and get a future; a collector thread drains the
queue into a batch, waiting at most ``max_delay_ms`` from the first queued
request and never past ``max_batch``, runs the batch through ``run_fn``
once and routes row ``i`` of the result to request ``i``.

The contracts kept:

- **FIFO and row routing.** A batch is the next ``k`` requests in arrival
  order and results go back by row index, so responses never cross
  between concurrent callers. A ``run_fn`` failure fails exactly the
  requests of that batch; later batches proceed.
- **Bounded, not buffered.** With ``max_queue`` a submit against a full
  queue raises :class:`QueueFullError` at once. A request's
  ``deadline_ms`` expires it with :class:`DeadlineExceededError` when it
  is still queued at batch admission, and again at resolution when it
  passed during coalescing or inside ``run_fn`` (a ``late`` request).
- **Shutdown resolves everyone.** :meth:`MicroBatcher.close` fails every
  pending future with :class:`ShutdownError` (or, ``drain=False``, still
  flushes what was queued before it): no caller blocks forever.

``run_fn`` runs on the collector thread: with the engine behind it, every
forward of a ``--serve`` run happens there, while callers only submit.

**Telemetry, as in the JAX module.** The ``infer_*`` request metrics
(``registry``, default the process registry): requests collected into
batches, batches, failed, shed, expired (``infer_deadline_exceeded_total``),
late and aborted requests, the queue depth at each collect, the batch
occupancy and the submit → result latency. With a
:class:`~jumbo_mae_tpu_tpu_torch.obs.reqtrace.RequestTracer` every
request carries a trace from the first line of ``submit()`` to its
outcome (``ok|shed|deadline|late|aborted|shutdown``), finished before its
future resolves, exactly once. The trace begins *before* the
``serve.submit`` fault point, so an injected submit stall is queue wait
where the caller felt it. The locks are ``obs.lockwatch``'s
``batcher.depth`` and ``batcher.occupancy``.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable

import numpy as np

from jumbo_mae_tpu_tpu_torch.faults.inject import fault_point
from jumbo_mae_tpu_tpu_torch.obs import lockwatch
from jumbo_mae_tpu_tpu_torch.obs.metrics import RATIO_BUCKETS, get_registry

_STOP = object()


class QueueFullError(RuntimeError):
    """Raised by ``submit()`` when the queue holds ``max_queue`` requests:
    shed or retry elsewhere, do not wait."""


class DeadlineExceededError(TimeoutError):
    """Set on a request whose ``deadline_ms`` passed, before admission to a
    batch (``expired``) or after it, during coalescing or compute
    (``late``)."""


class ShutdownError(RuntimeError):
    """Set on pending request futures when the batcher closes."""


class OccupancyWindow:
    """Batch occupancy (flushed size / ``max_batch``) as an EWMA over
    flushes (``alpha`` each) and a mean over the last ``window`` flushes,
    so a snapshot reflects the recent regime, not the last batch."""

    def __init__(self, max_batch: int, *, alpha: float = 0.2, window: int = 64):
        self.max_batch = max(int(max_batch), 1)
        self.alpha = float(alpha)
        self._recent: deque = deque(maxlen=int(window))
        self._ewma: float | None = None
        self._last = 0
        self._n = 0
        self._lock = lockwatch.lock("batcher.occupancy")

    def observe(self, size: int) -> None:
        occ = min(size / self.max_batch, 1.0)
        with self._lock:
            self._recent.append(occ)
            self._ewma = occ if self._ewma is None else self.alpha * occ + (1.0 - self.alpha) * self._ewma
            self._last = size
            self._n += 1

    def snapshot(self) -> dict:
        with self._lock:
            recent, ewma, last, n = list(self._recent), self._ewma, self._last, self._n
        return {
            "ewma": round(ewma, 4) if ewma is not None else 0.0,
            "window_mean": round(sum(recent) / len(recent), 4) if recent else 0.0,
            "last": round(last / self.max_batch, 4),
            "batches": n,
        }


class MicroBatcher:
    """Thread-safe request coalescer in front of a batched ``run_fn``.

    ``max_delay_ms`` bounds the wait for co-travellers, ``max_batch`` the
    batch handed to ``run_fn``, ``max_queue`` (``None``: unbounded) the
    submitted-but-unflushed requests. ``pass_meta=True`` calls
    ``run_fn(batch, metas)`` with each request's ``submit(meta=...)``.
    ``batch_sizes`` records every flushed batch's size. ``registry`` takes
    the ``infer_*`` metrics, ``tracer`` traces every request under
    ``task``. Use as a context manager or call :meth:`close`."""

    def __init__(
        self,
        run_fn: Callable[..., Any],
        *,
        max_batch: int = 32,
        max_delay_ms: float = 5.0,
        max_queue: int | None = None,
        pass_meta: bool = False,
        registry=None,
        tracer=None,
        task: str = "",
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.run_fn = run_fn
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay_ms) / 1000.0
        self.max_queue = max_queue
        self.pass_meta = bool(pass_meta)
        self.batch_sizes: list[int] = []
        self._occ = OccupancyWindow(self.max_batch)
        self._tracer = tracer
        self.task = task
        reg = registry if registry is not None else get_registry()
        self._m_latency = reg.histogram("infer_request_latency_seconds", "request latency: submit() to resolved future")
        self._m_occupancy = reg.histogram("infer_batch_occupancy", "flushed batch size / max_batch",
                                          buckets=RATIO_BUCKETS)
        self._m_depth = reg.gauge("infer_queue_depth", "queued requests sampled at batch collect")
        self._m_requests = reg.counter("infer_requests_total", "requests collected into batches")
        self._m_batches = reg.counter("infer_batches_total", "batches flushed through run_fn")
        self._m_failed = reg.counter("infer_requests_failed_total", "requests failed by a run_fn error")
        self._m_shed = reg.counter("infer_requests_shed_total",
                                   "submits rejected with QueueFullError (queue at max_queue)")
        self._m_expired = reg.counter("infer_deadline_exceeded_total",
                                      "requests expired past their deadline before batch admission")
        self._m_late = reg.counter(
            "infer_requests_late_total",
            "requests whose deadline passed after admission (during coalescing or compute) — failed at resolution, "
            "not resolved ok")
        self._m_aborted = reg.counter("infer_requests_aborted_total", "pending requests failed by close()")
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._counts = dict.fromkeys(
            ("submitted", "shed", "requests", "batches", "failed", "expired", "late", "aborted"), 0
        )
        self._latency_s: deque = deque(maxlen=4096)  # submit → resolved, recent requests
        self._depth = 0  # submitted, not yet popped by the collector
        self._depth_bytes = 0
        self._lock = lockwatch.lock("batcher.depth")
        self._closed = False
        self._drain = True
        self._thread = threading.Thread(target=self._loop, daemon=True, name="microbatcher")
        self._thread.start()

    # ------------------------------------------------------------- client

    def submit(self, image: np.ndarray, *, deadline_ms: float | None = None, meta=None) -> Future:
        """Enqueue one request (one image, no batch dim); the future
        resolves to its row of the batched result. Raises
        :class:`QueueFullError` when ``max_queue`` requests are pending.
        With a tracer the future carries the request id as ``fut.rid``."""
        # the trace begins before the fault point: an injected submit stall
        # is queue wait the caller felt
        tr = self._tracer.begin(task=self.task, deadline_ms=deadline_ms) if self._tracer is not None else None
        arr = np.asarray(image)
        try:
            fault_point("serve.submit")
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            with self._lock:
                self._counts["submitted"] += 1
                if self.max_queue is not None and self._depth >= self.max_queue:
                    self._counts["shed"] += 1
                    self._m_shed.inc()
                    raise QueueFullError(f"request queue full ({self._depth}/{self.max_queue})")
                self._depth += 1
                self._depth_bytes += arr.nbytes
        except BaseException as e:  # noqa: BLE001 - classify, trace, re-raise
            if tr is not None:
                if isinstance(e, QueueFullError):
                    self._tracer.finish(tr, "shed")
                elif self._closed:
                    self._tracer.finish(tr, "shutdown")
                else:
                    self._tracer.finish(tr, "aborted", error=f"{type(e).__name__}: {e}")
            raise
        fut: Future = Future()
        if tr is not None:
            fut.rid = tr.rid
        deadline = None if deadline_ms is None else time.monotonic() + float(deadline_ms) / 1000.0
        self._q.put((arr, fut, time.perf_counter(), deadline, meta, tr))
        return fut

    def __call__(self, image: np.ndarray, *, deadline_ms: float | None = None):
        """Blocking convenience: submit and wait."""
        return self.submit(image, deadline_ms=deadline_ms).result()

    def stats(self) -> dict:
        """A live snapshot: queue depth and bytes, batch occupancy (EWMA,
        last flush, window mean, lifetime mean), the request counts
        (submitted, shed, served, batches, failed, expired, late, aborted)
        and the submit → result latency's p50/p99 over recent requests."""
        with self._lock:
            depth, depth_bytes = self._depth, self._depth_bytes
            counts = dict(self._counts)
            lat = sorted(self._latency_s)
        sizes = self.batch_sizes
        mean = sum(sizes) / len(sizes) if sizes else 0.0
        occ = self._occ.snapshot()
        submitted, shed = counts["submitted"], counts["shed"]
        return {
            "queue_depth": depth,
            "queue_bytes": max(depth_bytes, 0),
            "batch_occupancy": occ["ewma"],
            "last_batch_occupancy": occ["last"],
            "window_batch_occupancy": occ["window_mean"],
            "mean_batch_occupancy": round(mean / self.max_batch, 4),
            "requests_submitted": submitted,
            "requests_shed": shed,
            "shed_rate": round(shed / submitted, 4) if submitted else 0.0,
            **{f"requests_{k}": counts[k] for k in ("failed", "expired", "late", "aborted")},
            "requests_served": counts["requests"],
            "batches": counts["batches"],
            "latency_p50_s": lat[len(lat) // 2] if lat else 0.0,
            "latency_p99_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))] if lat else 0.0,
        }

    def close(self, drain: bool = True) -> None:
        """Stop the collector and resolve every pending request.
        ``drain=True``: pending requests fail with :class:`ShutdownError`
        without another ``run_fn`` call; ``drain=False``: requests queued
        before the close still flush."""
        if self._closed:
            return
        self._drain = drain
        self._closed = True
        self._q.put(_STOP)
        self._thread.join()
        # a racing submit counts its depth before its put(): sweep until
        # the depth drains (bounded, so an accounting fault cannot hang)
        sweep_deadline = time.monotonic() + 5.0
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                with self._lock:
                    depth = self._depth
                if depth <= 0 or time.monotonic() > sweep_deadline:
                    break
                time.sleep(0.001)
                continue
            if item is _STOP:
                continue
            self._dec(item)
            self._abort(item)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------------------------------------------------- collector

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counts[key] += n

    def _dec(self, item) -> None:
        with self._lock:
            self._depth -= 1
            self._depth_bytes -= item[0].nbytes

    def _abort(self, item) -> None:
        self._count("aborted")
        self._m_aborted.inc()
        if item[5] is not None:
            # the trace finishes before the future resolves: a caller that
            # saw its future done can rely on its access-log row
            self._tracer.finish(item[5], "shutdown")
        item[1].set_exception(ShutdownError("MicroBatcher closed"))

    def _admit(self, item, batch: list) -> None:
        """One popped request: shut down, expired, or into the batch."""
        self._dec(item)
        if self._closed and self._drain:
            self._abort(item)
            return
        if item[3] is not None and time.monotonic() > item[3]:
            self._count("expired")
            self._m_expired.inc()
            if item[5] is not None:
                self._tracer.finish(item[5], "deadline")
            item[1].set_exception(DeadlineExceededError("request deadline passed while queued"))
            return
        if item[5] is not None:
            self._tracer.admitted(item[5])
        batch.append(item)

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is _STOP:
                return
            batch: list = []
            self._admit(item, batch)
            if not batch:
                continue
            self._m_depth.set(self._q.qsize() + 1)
            deadline = time.monotonic() + self.max_delay
            stop = False
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                self._admit(nxt, batch)
            self._flush(batch)
            if stop:
                return

    def _flush(self, batch: list) -> None:
        self.batch_sizes.append(len(batch))
        self._occ.observe(len(batch))
        self._count("batches")
        self._count("requests", len(batch))
        self._m_batches.inc()
        self._m_requests.inc(len(batch))
        self._m_occupancy.observe(len(batch) / self.max_batch)
        traces = [it[5] for it in batch if it[5] is not None]
        if traces:
            self._tracer.flush_begin(traces)
        t_run = time.perf_counter()
        try:
            stacked = np.stack([it[0] for it in batch])
            out = self.run_fn(stacked, [it[4] for it in batch]) if self.pass_meta else self.run_fn(stacked)
        except BaseException as e:  # noqa: BLE001 - routed to the batch's waiters
            self._count("failed", len(batch))
            self._m_failed.inc(len(batch))
            err = f"{type(e).__name__}: {e}"
            for it in batch:
                if it[5] is not None:
                    self._tracer.finish(it[5], "aborted", error=err)
                it[1].set_exception(e)
            return
        done = time.perf_counter()
        if traces:
            # on the collector thread, right after run_fn: the engine's
            # thread-local breakdown still belongs to this batch's predict
            self._tracer.flush_end(traces, run_s=done - t_run, batch=len(batch))
        with self._lock:
            self._latency_s.extend(done - it[2] for it in batch)
        # one lock hand-off for the batch's latencies, before the waiters wake
        self._m_latency.observe_many([done - it[2] for it in batch])
        rows = [{k: v[i] for k, v in out.items()} for i in range(len(batch))] if isinstance(out, dict) else out
        now = time.monotonic()
        for it, row in zip(batch, rows):
            if it[3] is not None and now > it[3]:
                self._count("late")
                self._m_late.inc()
                if it[5] is not None:
                    self._tracer.finish(it[5], "late")
                it[1].set_exception(DeadlineExceededError("request deadline passed during batch coalescing/compute"))
            else:
                if it[5] is not None:
                    self._tracer.finish(it[5], "ok")
                it[1].set_result(row)
