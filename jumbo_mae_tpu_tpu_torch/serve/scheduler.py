"""Continuous batching: late arrivals join pending batches until cutoff.

Counterpart of ``jumbo_mae_tpu_tpu/serve/scheduler.py``, with its
request tracer (``obs/reqtrace.py``), its ``serve.submit`` fault site and
its metrics (``serve_sched_batches_total{reason}``,
``serve_sched_batch_occupancy``, ``serve_sched_queue_depth``,
``serve_sched_priority_jumps_total``; :meth:`stats` reads the same
counts). The per-replica micro-batching loop is FIFO per flush, and
the pool router splits concurrent arrivals across replicas, so each
replica flushes a half-empty batch. :class:`ContinuousScheduler`
centralizes coalescing: one dispatcher thread owns per-``(task,
shape)`` accumulators; an arrival joins its accumulator's pending batch
up to a deadline-aware cutoff. A batch is *ready* when it fills or its
cutoff passes; among ready batches the dispatcher takes the highest

    score = occupancy + oldest_wait / max_delay + max(class weight)

so full batches go first, no waiter starves and interactive tenants
outrank batch and scavenger ones at equal fill. Within a batch, slots go
to the highest class first. A cutoff-triggered partial batch is cut to
its floor bucket when that still carries every due entry (zero pad rows).
Dispatch hands the group to :meth:`ReplicaSet.submit_group`, which runs
it on ONE replica as one flush.

``packed=True`` keeps ONE token accumulator instead: mixed resolutions
and the encoder-sharing tasks coalesce, a batch fills when its tokens
(``seq_len_fn(image)``) reach ``token_budget``, and the backend serves
the group through the engine's token-packed path. A ``seq_len_fn`` also
stamps each trace's ``tokens``, which the cost meter bills by.

With a ``tracer`` every request gets a trace at submit: a shed finishes
it ``shed`` (the typed admission error's class name in ``err``), a
closed scheduler ``shutdown``, an expiry in the accumulator
``deadline``; a dispatched entry hands its trace to the backend, which
finishes it.

Exactly once: after :meth:`submit` enqueues an entry only the dispatcher
thread touches it, and it leaves one way — expired, failed (dispatch
error, shutdown), or chained to the backend future that resolves it.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from jumbo_mae_tpu_tpu_torch.faults.inject import fault_point
from jumbo_mae_tpu_tpu_torch.infer.batching import DeadlineExceededError, OccupancyWindow, QueueFullError, ShutdownError
from jumbo_mae_tpu_tpu_torch.infer.bucketing import floor_bucket
from jumbo_mae_tpu_tpu_torch.obs import lockwatch
from jumbo_mae_tpu_tpu_torch.obs.metrics import RATIO_BUCKETS, get_registry
from jumbo_mae_tpu_tpu_torch.serve.admission import CLASS_WEIGHT, CLASSES

_STOP = object()

# an entry with a deadline dispatches this fraction of max_delay before
# it, or compute eats the rest of its budget
_DEADLINE_MARGIN = 0.25


class _Entry:
    __slots__ = ("image", "fut", "tr", "tenant", "tclass", "deadline", "meta", "task", "t_submit", "tokens")

    def __init__(self, image, fut, tenant, tclass, deadline, meta, task, now, tokens=None, tr=None):
        self.image = image
        self.fut = fut
        self.tr = tr
        self.tenant = tenant
        self.tclass = tclass
        self.deadline = deadline  # absolute clock instant, or None
        self.meta = meta
        self.task = task
        self.t_submit = now
        self.tokens = tokens  # packed: patch + CLS tokens


class ContinuousScheduler:
    """Cross-request batch assembler in front of a dispatch backend.

    ``dispatch(items)`` takes ``[(image, deadline, meta), ...]`` (with a
    ``tracer``, ``(image, deadline, meta, trace)``) and returns one
    future per item (:meth:`ReplicaSet.submit_group`).
    ``admission`` is an optional
    :class:`~jumbo_mae_tpu_tpu_torch.serve.admission.AdmissionController`.
    ``clock`` must be ``time.monotonic``-like: deadlines are absolute on
    it. ``packed`` switches to the one token accumulator. ``registry``
    takes the ``serve_sched_*`` metrics."""

    def __init__(
        self,
        dispatch,
        *,
        max_batch: int = 32,
        max_delay_ms: float = 5.0,
        max_queue: int | None = None,
        admission=None,
        tracer=None,
        task: str = "",
        registry=None,
        clock=time.monotonic,
        packed: bool = False,
        token_budget: int | None = None,
        seq_len_fn=None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if packed:
            if seq_len_fn is None:
                raise ValueError(
                    "packed=True needs seq_len_fn (e.g. lambda img: engine.seq_len(img.shape[0])) to price "
                    "entries in tokens"
                )
            if not token_budget or token_budget < 1:
                raise ValueError(f"packed=True needs a positive token_budget, got {token_budget}")
        self.packed = bool(packed)
        self.token_budget = int(token_budget) if token_budget else None
        self._seq_len_fn = seq_len_fn
        self._dispatch = dispatch
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay_ms) / 1000.0
        self.max_queue = max_queue
        self.admission = admission
        self._tracer = tracer
        self.task = task
        self._clock = clock
        reg = registry if registry is not None else get_registry()
        self._m_batches = reg.counter(
            "serve_sched_batches_total",
            "batches dispatched by the continuous scheduler, by trigger (full|cutoff|aligned|close)",
            labels=("reason",))
        self._m_occupancy = reg.histogram("serve_sched_batch_occupancy",
                                          "dispatched batch size / max_batch (continuous scheduler)",
                                          buckets=RATIO_BUCKETS)
        self._m_depth = reg.gauge("serve_sched_queue_depth", "requests pending in scheduler accumulators")
        self._m_jumps = reg.counter(
            "serve_sched_priority_jumps_total",
            "dispatch slots a higher class took ahead of an earlier-arrived lower-class request")
        self._occ = OccupancyWindow(self.max_batch)
        self._depth = 0
        self._depth_lock = lockwatch.lock("serve.sched.depth")
        self._dispatched = 0
        self._expired = 0
        self._jumps = 0
        self._by_reason: dict[str, int] = {}
        self._closed = False
        self._drain = True
        self._wake: queue.SimpleQueue = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="continuous-scheduler")
        self._thread.start()

    # ------------------------------------------------------------- client

    def submit(self, image, *, task: str | None = None, deadline_ms: float | None = None, meta=None,
               tenant: str | None = None) -> Future:
        """Admit one request into its accumulator; returns a future. Sheds
        typed: the admission controller's errors when one is attached, and
        :class:`QueueFullError` at ``max_queue``; a packed request over
        ``token_budget`` raises ``ValueError``."""
        arr = np.asarray(image)
        task = task if task is not None else self.task
        tclass = self.admission.spec(tenant).tclass if self.admission is not None else None
        tr = (self._tracer.begin(task=task, deadline_ms=deadline_ms, tenant=tenant, tclass=tclass)
              if self._tracer is not None else None)
        tokens = None
        try:
            fault_point("serve.submit")
            if self._closed:
                raise ShutdownError("ContinuousScheduler is closed")
            if self._seq_len_fn is not None:
                # priced up front: a misaligned or oversized request sheds here
                tokens = int(self._seq_len_fn(arr))
                if self.packed and tokens > self.token_budget:
                    raise ValueError(
                        f"request needs {tokens} tokens > token_budget={self.token_budget} — raise the budget or "
                        "resize"
                    )
            if self.admission is not None:
                self.admission.admit(tenant)
            with self._depth_lock:
                if self.max_queue is not None and self._depth >= self.max_queue:
                    raise QueueFullError(f"scheduler queue full ({self._depth}/{self.max_queue})")
                self._depth += 1
        except BaseException as e:  # noqa: BLE001 - classify, trace, re-raise
            if tr is not None:
                if isinstance(e, QueueFullError):
                    # the typed shed (quota, pressure, budget) rides in err
                    self._tracer.finish(tr, "shed", error=type(e).__name__ if type(e) is not QueueFullError else None)
                elif isinstance(e, ShutdownError) or self._closed:
                    self._tracer.finish(tr, "shutdown")
                else:
                    self._tracer.finish(tr, "aborted", error=f"{type(e).__name__}: {e}")
            raise
        fut: Future = Future()
        if tr is not None:
            fut.rid = tr.rid
            tr.tokens = tokens
        now = self._clock()
        deadline = None if deadline_ms is None else now + float(deadline_ms) / 1000.0
        self._wake.put(_Entry(arr, fut, tenant, tclass, deadline, meta, task, now, tokens, tr))
        return fut

    def pressure(self) -> float:
        """Pending depth / ``max_queue`` (0 when unbounded): the admission
        controller's pressure signal."""
        if not self.max_queue:
            return 0.0
        with self._depth_lock:
            return self._depth / self.max_queue

    def stats(self) -> dict:
        with self._depth_lock:
            depth = self._depth
        occ = self._occ.snapshot()
        return {
            "queue_depth": depth,
            "pressure": self.pressure(),
            "dispatched": self._dispatched,
            "expired": self._expired,
            "batch_occupancy": occ["ewma"],
            "window_batch_occupancy": occ["window_mean"],
            "batches": occ["batches"],
            "batches_by_reason": dict(self._by_reason),
            "priority_jumps": self._jumps,
        }

    def close(self, drain: bool = True, timeout_s: float = 10.0) -> None:
        """Stop the dispatcher and resolve every undispatched entry:
        ``drain=True`` fails them with :class:`ShutdownError`,
        ``drain=False`` dispatches them first."""
        if self._closed:
            return
        self._drain = drain
        self._closed = True
        self._wake.put(_STOP)
        self._thread.join(timeout=timeout_s)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --------------------------------------------------------- dispatcher

    def _cutoff(self, entry: _Entry) -> float:
        cut = entry.t_submit + self.max_delay
        if entry.deadline is not None:
            cut = min(cut, entry.deadline - _DEADLINE_MARGIN * self.max_delay)
        return cut

    def _key(self, entry: _Entry) -> tuple:
        """Per-(task, shape) accumulators; one token accumulator packed."""
        if self.packed:
            return ("__packed__",)
        return (entry.task, entry.image.shape)

    def _loop(self) -> None:
        buckets: dict[tuple, list[_Entry]] = {}  # this thread's alone: no locks
        while True:
            try:
                item = self._wake.get(timeout=self._next_wait(buckets))
            except queue.Empty:
                item = None
            while item is not None:
                if item is _STOP:
                    self._shutdown(buckets)
                    return
                buckets.setdefault(self._key(item), []).append(item)
                try:  # a burst lands in its accumulators in one pass
                    item = self._wake.get_nowait()
                except queue.Empty:
                    item = None
            self._expire(buckets)
            self._dispatch_ready(buckets)
            self._m_depth.set(sum(len(v) for v in buckets.values()))

    def _next_wait(self, buckets) -> float:
        """Sleep until the earliest pending cutoff (bounded), or idle."""
        if not any(buckets.values()):
            return 0.25
        earliest = min(self._cutoff(e) for v in buckets.values() for e in v)
        return max(min(earliest - self._clock(), 0.25), 0.0005)

    def _expire(self, buckets) -> None:
        """Fail pending entries whose deadline passed: they take no slot."""
        now = self._clock()
        for key, entries in buckets.items():
            keep = []
            for e in entries:
                if e.deadline is not None and now > e.deadline:
                    self._expired += 1
                    self._dec(1)
                    if e.tr is not None:
                        self._tracer.finish(e.tr, "deadline")
                    e.fut.set_exception(DeadlineExceededError("request deadline passed in scheduler accumulator"))
                else:
                    keep.append(e)
            buckets[key] = keep

    @staticmethod
    def _weight(e: _Entry) -> float:
        return CLASS_WEIGHT.get(e.tclass, CLASS_WEIGHT["batch"]) if e.tclass is not None else CLASS_WEIGHT["batch"]

    def _dispatch_ready(self, buckets) -> None:
        while True:
            now = self._clock()
            best_key, best_score, best_reason = None, None, None
            for key, entries in buckets.items():
                if not entries:
                    continue
                if self.packed:
                    tok = sum(e.tokens or 0 for e in entries)
                    full = tok >= self.token_budget or len(entries) >= self.max_batch
                    occ = min(tok / self.token_budget, 1.0)
                else:
                    full = len(entries) >= self.max_batch
                    occ = min(len(entries) / self.max_batch, 1.0)
                if not (full or any(self._cutoff(e) <= now for e in entries)):
                    continue
                oldest = max(now - e.t_submit for e in entries)
                score = occ + oldest / self.max_delay + max(self._weight(e) for e in entries)
                if best_score is None or score > best_score:
                    best_key, best_score, best_reason = key, score, "full" if full else "cutoff"
            if best_key is None:
                return
            self._dispatch_bucket(buckets, best_key, best_reason)

    def _order(self, entries: list[_Entry], now: float, due_first: bool) -> list[int]:
        """Indices by (due first, when asked), class rank, arrival."""
        rank = {c: i for i, c in enumerate(CLASSES)}
        return sorted(range(len(entries)), key=lambda i: (
            (0 if self._cutoff(entries[i]) <= now else 1) if due_first else 0,
            rank.get(entries[i].tclass, rank["batch"]),
            entries[i].t_submit,
        ))

    def _take_batch(self, entries: list[_Entry], reason: str) -> tuple[list[_Entry], str]:
        """Up to ``max_batch`` entries, the highest class first (FIFO
        within a class). A cutoff-triggered partial batch is cut to its
        floor bucket when every due entry fits (``aligned``): the engine
        pads a flush to a power-of-two bucket, so 8 now and 3 held back
        computes 8 rows where 11 computes 16."""
        if self.packed:
            return self._take_packed(entries, reason)
        n = min(len(entries), self.max_batch)
        now = self._clock()
        if reason == "cutoff" and len(entries) < self.max_batch:
            due = sum(1 for e in entries if self._cutoff(e) <= now)
            fb = floor_bucket(len(entries), self.max_batch)
            if fb < len(entries) and due <= fb:
                n = fb
                reason = "aligned"
        if n == len(entries):
            batch = list(entries)
            entries.clear()
            return batch, reason
        # over-full: the highest class takes the slots; aligned: due
        # entries first, whatever their class
        chosen = set(self._order(entries, now, reason == "aligned")[:n])
        self._jump(len(chosen - set(range(n))))  # chosen past an earlier arrival
        batch = [entries[i] for i in sorted(chosen)]
        entries[:] = [e for i, e in enumerate(entries) if i not in chosen]
        return batch, reason

    def _take_packed(self, entries: list[_Entry], reason: str) -> tuple[list[_Entry], str]:
        """Fill the token budget greedily in priority order (due first, then
        class, then arrival). An entry that would overflow the remaining
        budget is skipped, not a wall: smaller ones behind it may top up
        the rung. The head of the order is always taken, so a skipped
        entry ships first in a later dispatch."""
        chosen: list[int] = []
        tok = 0
        for i in self._order(entries, self._clock(), True):
            if chosen and len(chosen) >= self.max_batch:
                break
            t = entries[i].tokens or 0
            if chosen and tok + t > self.token_budget:
                continue
            chosen.append(i)
            tok += t
        chosen_set = set(chosen)
        self._jump(len(chosen_set - set(range(len(chosen)))))
        batch = [entries[i] for i in sorted(chosen_set)]
        entries[:] = [e for i, e in enumerate(entries) if i not in chosen_set]
        return batch, reason

    def _jump(self, n: int) -> None:
        if n:
            self._jumps += n
            self._m_jumps.inc(n)

    def _dispatch_bucket(self, buckets, key, reason: str) -> None:
        batch, reason = self._take_batch(buckets[key], reason)
        if not batch:
            return
        self._dec(len(batch))
        self._by_reason[reason] = self._by_reason.get(reason, 0) + 1
        self._m_batches.labels(reason).inc()
        if self.packed:
            self._m_occupancy.observe(min(sum(e.tokens or 0 for e in batch) / self.token_budget, 1.0))
        else:
            self._m_occupancy.observe(len(batch) / self.max_batch)
        self._occ.observe(len(batch))
        self._dispatched += len(batch)
        if self._tracer is not None:
            items = [(e.image, e.deadline, e.meta, e.tr) for e in batch]
        else:
            items = [(e.image, e.deadline, e.meta) for e in batch]
        try:
            backend_futs = self._dispatch(items)
        except BaseException as exc:  # noqa: BLE001 - the backend finished the traces; the futures carry it
            for entry in batch:
                entry.fut.set_exception(exc)
            return
        for entry, bfut in zip(batch, backend_futs):
            bfut.add_done_callback(self._chain(entry.fut))

    @staticmethod
    def _chain(caller_fut: Future):
        def copy(bfut: Future) -> None:
            for attr in ("replica", "retries", "requeued_from"):  # the pool's attribution
                if hasattr(bfut, attr):
                    setattr(caller_fut, attr, getattr(bfut, attr))
            exc = bfut.exception()
            if exc is not None:
                caller_fut.set_exception(exc)
            else:
                caller_fut.set_result(bfut.result())

        return copy

    def _dec(self, k: int) -> None:
        with self._depth_lock:
            self._depth -= k

    def _shutdown(self, buckets) -> None:
        while True:  # racers enqueued behind the stop sentinel
            try:
                item = self._wake.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                buckets.setdefault(self._key(item), []).append(item)
        if not self._drain:
            for key in list(buckets):
                while buckets[key]:
                    self._dispatch_bucket(buckets, key, "close")
            return
        for entries in buckets.values():
            for e in entries:
                self._dec(1)
                if e.tr is not None:
                    self._tracer.finish(e.tr, "shutdown")
                e.fut.set_exception(ShutdownError("ContinuousScheduler closed"))
            entries.clear()
