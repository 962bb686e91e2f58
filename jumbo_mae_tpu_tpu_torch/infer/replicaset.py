"""Replicated serving tier: a supervised pool of inference engine workers.

Counterpart of ``jumbo_mae_tpu_tpu/infer/replicaset.py``. One engine behind
one queue means one wedged predict or one bad checkpoint load takes the
serving path down. :class:`ReplicaSet` runs N replicas, each an engine and
its own micro-batching worker thread (``max_batch``/``max_delay_ms``/
``max_queue``/deadline semantics of ``infer/batching.py``), behind a
router that gives each request to the least-loaded healthy replica.

- **Crash isolation.** A replica whose predict raises is marked down; its
  in-flight and queued requests are requeued onto the survivors with the
  failed replica in the request's excluded set, so a retry never lands
  on the replica that failed it. A predict that hangs past
  ``hang_timeout_s`` is declared hung by the supervisor, its slot
  replaced and its requests requeued the same way; the hung thread's
  late result loses the per-request settle race, so **every future
  resolves exactly once** (ok, ok after retries, or a typed error). A
  future carries its attribution: ``replica``, ``retries`` and
  ``requeued_from`` (the replicas that failed it, comma-joined).
- **Self-healing.** The supervisor restarts down replicas with capped
  exponential backoff (the engine comes back through the provider), and
  opens a breaker (:meth:`ReplicaSet.degraded`) while healthy replicas
  are below ``quorum``; the pool keeps serving on what survives.
- **Groups.** :meth:`ReplicaSet.submit_group` lands a group the
  continuous scheduler shaped on one replica, which flushes it as one
  batch, never merged with a neighbouring group.
- **Lifecycle.** ``pause``/``resume``/``wait_idle`` (the swap
  controller's flip window), ``scale_to`` (drain, then retire the last
  slot), ``preempt`` (drain a replica and let the supervisor bring up a
  new incarnation, without a failure count).

:class:`WeightSwapController` promotes a new checkpoint through three
gates and rolls back at the first failure: **parity** (the canary
replica, paused and drained, is flipped with ``swap_weights``; its
feature cosine against the live weights on a fixed probe must reach
``parity_min_cosine``), **canary** (the flipped replica serves live
traffic while an ``obs/slo.py`` burn-rate tracker watches its outcomes
for ``canary_requests`` requests, bounded by ``canary_timeout_s``), and
**promote** (the other replicas flipped one at a time, pause → drain →
swap → resume, so the pool never stops serving).

On one H100 the replicas share one card: each holds its own weights and
graphs and its worker replays them, and the card runs one forward at a
time. They give crash isolation, a place to canary a swap and rolling
restarts, not throughput.

**Tracing and metering.** With a ``tracer`` (``obs/reqtrace.py``) each
request carries a trace: admitted when a worker takes it into a batch,
the flush's breakdown stamped on it (the replica's engine's
``last_breakdown``), and finished with its replica, retries and requeue
trail; the pool's lifecycle (crashes, hangs, restarts, scaling,
preemptions, the breaker) lands in the same log as events. A
``costmeter`` (``serve/costmeter.py``) is handed each good flush's wall
time and traces before they finish, so every access-log row carries its
``device_ms`` and ``cost_flops``.

**Telemetry and health, as in the JAX module.** The pool publishes the
``serve_replica_*`` families and the ``infer_*`` request families of
``infer/batching.py`` (``registry``, default the process registry), the
controller the ``serve_swap_*`` families; :meth:`ReplicaSet.stats` reads
the same counts. With a ``health`` (``obs/exporter.HealthState``) each
good flush beats ``replica.<name>``, the pool's stats are the
``replicas`` probe of ``/healthz``, and :meth:`ReplicaSet.degraded` is the
breaker an owner hands to ``degraded_when``. The fault sites are the JAX
module's: ``serve.submit`` at every submit, ``serve.replica`` (key: the
replica's name) around each flush's run, ``serve.preempt`` (key: the
replica's name) once a supervisor pass per routable replica, where a
firing is a preemption notice, and ``ckpt.load`` (key: the pushed path,
data: the restored tree) in the swap's restore. The locks are
``obs.lockwatch``'s ``replicaset.{request,depth,live,state,scale,swap}``
(and the port's ``replicaset.counts`` for :meth:`ReplicaSet.stats`).

**The swap's memory gate.** With a ``headroom_fn(host_bytes,
card_bytes)`` (``obs/memwatch.MemoryWatcher.headroom_check``), the
controller asks, after the restore and before it picks a canary, whether
the swap's double buffer fits: the restored tree and the host snapshot of
the live weights, twice the tree's bytes, in host memory (the JAX check),
and the models the port's swap builds aside on the card before it copies
(:meth:`InferenceEngine.swap_device_bytes`) in the card's free memory. A
refusal is verdict ``rejected`` at stage ``"headroom"`` before any
replica flips; a probe that raises never vetoes.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable

import numpy as np

from jumbo_mae_tpu_tpu_torch.faults.inject import fault_point
from jumbo_mae_tpu_tpu_torch.infer.batching import (
    DeadlineExceededError,
    OccupancyWindow,
    QueueFullError,
    ShutdownError,
)
from jumbo_mae_tpu_tpu_torch.infer.quant import feature_cosine
from jumbo_mae_tpu_tpu_torch.obs import lockwatch
from jumbo_mae_tpu_tpu_torch.obs.memwatch import tree_nbytes
from jumbo_mae_tpu_tpu_torch.obs.metrics import NULL_REGISTRY, RATIO_BUCKETS, get_registry
from jumbo_mae_tpu_tpu_torch.obs.slo import SLOTracker, parse_slo

_STOP = object()


class PoolUnhealthyError(RuntimeError):
    """No healthy replica can take (or retry) a request."""


class RetriesExhaustedError(RuntimeError):
    """A request was requeued off failing replicas more than
    ``max_retries`` times; the last replica error is in the message."""


class _Request:
    """One routed request: payload, future, and the settle latch that makes
    its resolution exactly-once under requeue and hung-replica races."""

    __slots__ = ("image", "meta", "deadline", "fut", "tr", "excluded", "retries", "t0", "gid", "_settled", "_lock")

    def __init__(self, image, meta, deadline, fut, tr=None, gid=None):
        self.image = image
        self.meta = meta
        self.deadline = deadline
        self.fut = fut
        self.tr = tr
        self.excluded: set[str] = set()
        self.retries = 0
        self.t0 = time.perf_counter()
        # submit_group's id: a worker coalesces only requests sharing it
        self.gid = gid
        self._settled = False
        self._lock = lockwatch.lock("replicaset.request")

    def settle(self) -> bool:
        """Claim the right to resolve this request; exactly one caller
        wins."""
        with self._lock:
            if self._settled:
                return False
            self._settled = True
            return True

    @property
    def settled(self) -> bool:
        return self._settled


class _Replica:
    """One slot incarnation: an engine, its queue, its worker thread and
    the state the supervisor reads."""

    __slots__ = ("idx", "name", "gen", "engine", "q", "thread", "state", "busy_since", "pending", "served")

    def __init__(self, idx: int, gen: int, engine):
        self.idx = idx
        self.name = f"r{idx}"
        self.gen = gen
        self.engine = engine
        self.q: queue.SimpleQueue = queue.SimpleQueue()
        self.thread: threading.Thread | None = None
        self.state = "up"  # up | paused | down
        self.busy_since: float | None = None
        self.pending: tuple = ()  # the in-flight batch
        self.served = 0


class ReplicaSet:
    """Supervised pool of N engine workers with micro-batching semantics.

    ``engine_provider(idx)`` builds replica ``idx``'s engine, at
    construction and at every restart; ``run(engine, batch, metas)`` is
    the batched predict (``batch`` is a stacked array, or the list of
    images when a group mixes shapes). ``tracer`` traces every request and
    logs the pool's events under ``task``; ``breakdown(engine)`` gives a
    flush's compute/fetch/bucket/pad split (``lambda e:
    e.last_breakdown()`` for an engine; without it a trace's compute is
    the run's wall time); ``costmeter`` bills each flush. ``registry``
    takes the metrics, ``health`` the heartbeats and the ``replicas``
    probe.
    Use as a context manager or call :meth:`close`: every pending future
    resolves within a bounded sweep, even with a wedged worker."""

    def __init__(
        self,
        engine_provider: Callable[[int], Any],
        run: Callable[[Any, Any, list], Any],
        *,
        replicas: int = 2,
        max_batch: int = 32,
        max_delay_ms: float = 5.0,
        max_queue: int | None = None,
        max_retries: int = 2,
        hang_timeout_s: float = 30.0,
        restart_backoff_s: float = 0.25,
        restart_backoff_max_s: float = 8.0,
        quorum: int | None = None,
        supervise_interval_s: float = 0.05,
        tracer=None,
        task: str = "",
        registry=None,
        health=None,
        breakdown: Callable[[Any], dict | None] | None = None,
        costmeter=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if quorum is not None and not 1 <= quorum <= replicas:
            raise ValueError(f"quorum must be in [1, {replicas}], got {quorum}")
        self._provider = engine_provider
        self._run = run
        self.n = int(replicas)
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay_ms) / 1000.0
        self.max_queue = max_queue
        self.max_retries = int(max_retries)
        self.hang_timeout_s = float(hang_timeout_s)
        self.restart_backoff_s = float(restart_backoff_s)
        self.restart_backoff_max_s = float(restart_backoff_max_s)
        # default quorum: a majority, recomputed when scale_to resizes the
        # pool; an explicit quorum is pinned
        self._explicit_quorum = quorum is not None
        self.quorum = quorum if quorum is not None else self.n // 2 + 1
        self._interval = float(supervise_interval_s)
        self._tracer = tracer
        self.task = task
        self._health = health
        self._breakdown = breakdown
        self._costmeter = costmeter
        self._clock = clock
        self._observers: list[Callable] = []

        reg = registry if registry is not None else get_registry()
        # the pool's own families (serve_replica_*) ...
        self._m_up = reg.gauge("serve_replica_up", "replica is up and routable (1) or not (0)", labels=("replica",))
        self._m_restarts = reg.counter("serve_replica_restarts_total", "replica restarts completed by the supervisor",
                                       labels=("replica",))
        self._m_crashes = reg.counter("serve_replica_crashes_total",
                                      "replica predict failures by kind (crash|hang|restart_error)",
                                      labels=("replica", "kind"))
        self._m_served = reg.counter("serve_replica_requests_total", "requests resolved ok, by serving replica",
                                     labels=("replica",))
        self._m_requeued = reg.counter(
            "serve_replica_requeued_total",
            "in-flight/queued requests requeued off a failed replica, attributed to the replica that failed them",
            labels=("replica",))
        self._m_preempted = reg.counter(
            "serve_replica_preempted_total",
            "replicas drained and retired by preemption notice (pause -> idle -> down -> supervisor restart); never "
            "drops in-flight work",
            labels=("replica",))
        self._m_healthy = reg.gauge("serve_replica_healthy_count", "replicas currently up or paused")
        self._m_quorum = reg.gauge("serve_replica_quorum", "healthy-replica floor for the breaker")
        self._m_breaker = reg.gauge("serve_replica_breaker_open",
                                    "1 while healthy replicas < quorum (degraded in /healthz)")
        self._m_breaker_trips = reg.counter("serve_replica_breaker_trips_total", "times the pool dropped below quorum")
        # ... and the micro-batcher's request families, so a dashboard or a
        # doctor reads the replicated tier unchanged
        self._m_latency = reg.histogram("infer_request_latency_seconds", "request latency: submit() to resolved future")
        self._m_requests = reg.counter("infer_requests_total", "requests collected into batches")
        self._m_batches = reg.counter("infer_batches_total", "batches flushed through run_fn")
        self._m_shed = reg.counter("infer_requests_shed_total",
                                   "submits rejected with QueueFullError (queue at max_queue)")
        self._m_expired = reg.counter("infer_deadline_exceeded_total",
                                      "requests expired past their deadline before batch admission")
        self._m_late = reg.counter(
            "infer_requests_late_total",
            "requests whose deadline passed after admission (during coalescing or compute) — failed at resolution, "
            "not resolved ok")
        self._m_aborted = reg.counter("infer_requests_aborted_total", "pending requests failed by close()")
        self._m_occupancy = reg.histogram("infer_batch_occupancy", "flushed batch size / max_batch",
                                          buckets=RATIO_BUCKETS)
        self._m_quorum.set(self.quorum)
        self._occ = OccupancyWindow(self.max_batch)
        self._counts: dict = {k: 0 for k in ("batches", "requests", "expired", "late", "aborted", "breaker_trips")}
        self._per_replica: dict[str, dict[str, int]] = {}

        self._depth = 0
        self._submitted = 0
        self._shed_n = 0
        self._gid = itertools.count(1)
        self._depth_lock = lockwatch.lock("replicaset.depth")
        self._count_lock = lockwatch.lock("replicaset.counts")
        self._live: set[_Request] = set()
        self._live_lock = lockwatch.lock("replicaset.live")
        self._closed = False
        self._drain = True
        self._breaker_open = False
        self._canary_pref: str | None = None
        self._state_lock = lockwatch.lock("replicaset.state")
        self._scale_lock = lockwatch.lock("replicaset.scale")
        # slots removed by scale_to: the supervisor keeps rescuing their
        # queues, so a submit that raced the removal is requeued, not lost
        self._retired: list[_Replica] = []

        self._slots: list[_Replica] = []
        self._fails = [0] * self.n
        self._restart_at = [0.0] * self.n
        self._restarting = [False] * self.n
        for idx in range(self.n):
            rep = _Replica(idx, gen=0, engine=self._provider(idx))
            self._slots.append(rep)
            self._start_worker(rep)
            self._m_up.labels(rep.name).set(1)
            # the preemption counter scrapes as 0 from boot
            self._m_preempted.labels(rep.name)
            self._beat(rep)
        self._update_health()
        if self._health is not None:
            self._health.probe("replicas", self.stats)
        self._supervisor = threading.Thread(target=self._supervise, daemon=True, name="replicaset-supervisor")
        self._supervisor.start()

    # ------------------------------------------------------------- client

    def _admit_depth(self, k: int, traces) -> _Replica:
        """Count ``k`` submits against ``max_queue`` and pick their replica;
        raises typed (shed, shutdown, unroutable), each trace finished
        first."""
        try:
            fault_point("serve.submit")
            if self._closed:
                raise ShutdownError("ReplicaSet is closed")
            with self._depth_lock:
                self._submitted += k
                if self.max_queue is not None and self._depth + k > self.max_queue:
                    self._m_shed.inc(k)
                    self._shed_n += k
                    raise QueueFullError(f"request queue full ({self._depth}+{k}/{self.max_queue})")
                self._depth += k
            target = self._pick(frozenset())
            if target is None:
                with self._depth_lock:
                    self._depth -= k
                raise PoolUnhealthyError(
                    f"no healthy replica (healthy={self._healthy_count()}, quorum={self.quorum})")
        except BaseException as e:  # noqa: BLE001 - classify, trace, re-raise
            if self._tracer is not None:
                if isinstance(e, QueueFullError):
                    outcome, err = "shed", None
                elif isinstance(e, ShutdownError) or self._closed:
                    outcome, err = "shutdown", None
                else:
                    outcome, err = "aborted", f"{type(e).__name__}: {e}"
                for tr in traces:
                    self._tracer.finish(tr, outcome, error=err)
            raise
        return target

    def submit(self, image: np.ndarray, *, deadline_ms: float | None = None, meta=None,
               tenant: str | None = None, tclass: str | None = None) -> Future:
        """Route one request to a healthy replica; returns a future for its
        row of the batched result. Raises :class:`QueueFullError` at
        ``max_queue``, :class:`ShutdownError` after :meth:`close` and
        :class:`PoolUnhealthyError` when no replica is routable.
        ``tenant``/``tclass`` ride into the trace row; they do not change
        routing."""
        tr = (self._tracer.begin(task=self.task, deadline_ms=deadline_ms, tenant=tenant, tclass=tclass)
              if self._tracer is not None else None)
        target = self._admit_depth(1, [tr] if tr is not None else [])
        deadline = None if deadline_ms is None else time.monotonic() + float(deadline_ms) / 1000.0
        rec = _Request(np.asarray(image), meta, deadline, Future(), tr)
        if tr is not None:
            rec.fut.rid = tr.rid
        with self._live_lock:
            self._live.add(rec)
        target.q.put(rec)
        return rec.fut

    def submit_group(self, items) -> list[Future]:
        """Route a pre-coalesced group to ONE replica as a unit: the
        continuous scheduler's dispatch. ``items`` are ``(image, deadline,
        meta)`` or ``(image, deadline, meta, trace)`` with ``deadline`` an
        absolute ``time.monotonic()`` instant or ``None`` and ``trace`` one
        the caller began (or ``None``). The group lands consecutively on the
        least-loaded replica and (for ``len(items) <= max_batch``) flushes
        as one batch. On shed, shutdown or no routable replica the group
        fails as a unit: every trace is finished, the typed error is raised
        and no future is made."""
        k = len(items)
        if k == 0:
            return []
        items = [(*it, None) if len(it) == 3 else tuple(it) for it in items]
        target = self._admit_depth(k, [it[3] for it in items if it[3] is not None])
        gid = next(self._gid)
        recs = []
        for image, deadline, meta, tr in items:
            rec = _Request(np.asarray(image), meta, deadline, Future(), tr, gid=gid)
            if tr is not None:
                rec.fut.rid = tr.rid
            recs.append(rec)
        with self._live_lock:
            self._live.update(recs)
        for rec in recs:
            target.q.put(rec)
        return [rec.fut for rec in recs]

    def __call__(self, image, *, deadline_ms: float | None = None):
        return self.submit(image, deadline_ms=deadline_ms).result()

    def add_observer(self, fn: Callable) -> None:
        """``fn(replica_name, outcome, latency_s, retries)`` on every
        resolved request: the canary window's feed."""
        self._observers.append(fn)

    def remove_observer(self, fn: Callable) -> None:
        try:
            self._observers.remove(fn)
        except ValueError:
            pass

    # ----------------------------------------------------------- lifecycle

    def replica(self, idx: int) -> _Replica:
        return self._slots[idx]

    def generation(self, idx: int) -> int:
        return self._slots[idx].gen

    def first_routable(self) -> _Replica | None:
        return self._pick(frozenset())

    def _healthy_count(self) -> int:
        return sum(1 for rep in self._slots if rep.state in ("up", "paused"))

    def degraded(self) -> bool:
        """The breaker: true while healthy replicas are below quorum."""
        return self._breaker_open

    def pause(self, idx: int) -> None:
        """Take a replica out of routing (it drains what it already has)."""
        with self._state_lock:
            rep = self._slots[idx]
            if rep.state == "up":
                rep.state = "paused"

    def resume(self, idx: int) -> None:
        with self._state_lock:
            rep = self._slots[idx]
            if rep.state == "paused":
                rep.state = "up"

    def wait_idle(self, idx: int, timeout_s: float = 10.0) -> bool:
        """Block until replica ``idx`` holds nothing queued or in flight
        (True) or ``timeout_s`` passes (False)."""
        deadline = self._clock() + timeout_s
        while self._clock() < deadline:
            rep = self._slots[idx]
            if rep.q.empty() and rep.busy_since is None and not rep.pending:
                return True
            time.sleep(0.005)
        return False

    def set_engine_provider(self, fn: Callable[[int], Any]) -> None:
        """Repoint restarts at a new engine source (a promoted swap must
        survive a later restart)."""
        self._provider = fn

    def set_costmeter(self, meter) -> None:
        """Late-bind the tenant cost meter (usually built after the pool,
        beside the admission controller it feeds)."""
        self._costmeter = meter

    # ------------------------------------------------------------- scaling

    def scale_to(self, n: int, *, drain_timeout_s: float = 10.0) -> dict:
        """Resize the pool to ``n`` replicas one slot at a time. Growth
        builds engines through the provider; shrink removes the *last*
        slot only after pausing and draining it, so no in-flight request
        is killed. A slot that is down, restarting or does not drain stops
        the shrink. Returns ``{"from", "to", "added", "removed",
        "stopped"}``."""
        if n < 1:
            raise ValueError(f"scale target must be >= 1, got {n}")
        with self._scale_lock:
            start = len(self._slots)
            added: list[str] = []
            removed: list[str] = []
            stopped: str | None = None
            while len(self._slots) < n and not self._closed:
                name = self._add_slot()
                if name is None:
                    stopped = "engine provider failed"
                    break
                added.append(name)
            while len(self._slots) > n and not self._closed:
                name = self._remove_last_slot(drain_timeout_s)
                if name is None:
                    stopped = "last slot not removable (down/restarting/undrained)"
                    break
                removed.append(name)
            return {"from": start, "to": len(self._slots), "added": added, "removed": removed, "stopped": stopped}

    def _resized(self) -> None:
        """Caller holds the state lock."""
        self.n = len(self._slots)
        if not self._explicit_quorum:
            self.quorum = self.n // 2 + 1
            self._m_quorum.set(self.quorum)
        self._update_health()

    def _add_slot(self) -> str | None:
        idx = len(self._slots)
        try:
            engine = self._provider(idx)  # outside the state lock: a build takes seconds
        except BaseException as e:  # noqa: BLE001 - a provider error is a failed scale step
            self._event("replica_restart_failed", replica=f"r{idx}", err=f"{type(e).__name__}: {e}")
            return None
        rep = _Replica(idx, gen=0, engine=engine)
        with self._state_lock:
            self._slots.append(rep)
            self._fails.append(0)
            self._restart_at.append(0.0)
            self._restarting.append(False)
            self._resized()
        self._start_worker(rep)
        self._m_up.labels(rep.name).set(1)
        self._beat(rep)
        self._event("replica_added", replica=rep.name, pool=self.n)
        return rep.name

    def _remove_last_slot(self, drain_timeout_s: float) -> str | None:
        with self._state_lock:
            if len(self._slots) <= 1:
                return None
            rep = self._slots[-1]
            if self._restarting[rep.idx] or rep.state == "down":
                return None
            we_paused = rep.state == "up"
            if we_paused:
                rep.state = "paused"
        if not self.wait_idle(rep.idx, drain_timeout_s):
            with self._state_lock:
                if we_paused and not self._stale(rep) and rep.state == "paused":
                    rep.state = "up"
            return None
        with self._state_lock:
            # a crash or hang during the drain hands the slot to the supervisor
            if self._stale(rep) or rep.idx != len(self._slots) - 1 or rep.state != "paused":
                return None
            self._slots.pop()
            self._fails.pop()
            self._restart_at.pop()
            self._restarting.pop()
            self._resized()
            self._retired.append(rep)
        rep.q.put(_STOP)
        self._m_up.labels(rep.name).set(0)
        self._event("replica_removed", replica=rep.name, gen=rep.gen, pool=self.n)
        self._drain_slot(rep, "replica removed")
        rep.engine = None  # the engine's memory goes with the slot
        return rep.name

    def preempt(self, idx: int, *, drain_timeout_s: float = 10.0) -> bool:
        """A preemption notice: take replica ``idx`` out of routing, let it
        finish what it holds, then retire the incarnation (no request
        dropped). The slot goes down without a failure count, so the
        supervisor brings a new one up after one plain backoff. False when
        the slot is not preemptible now or the drain timed out."""
        with self._state_lock:
            if self._closed or idx >= len(self._slots):
                return False
            rep = self._slots[idx]
            if rep.state not in ("up", "paused") or self._restarting[idx]:
                return False
            we_paused = rep.state == "up"
            rep.state = "paused"
        if not self.wait_idle(idx, drain_timeout_s):
            with self._state_lock:
                if we_paused and not self._stale(rep) and rep.state == "paused":
                    rep.state = "up"
            return False
        with self._state_lock:
            if self._stale(rep) or rep.state != "paused":
                return False
            rep.state = "down"
            self._m_up.labels(rep.name).set(0)
            # a plain backoff, no failure count: preemption is not a crash
            self._restart_at[idx] = self._clock() + self.restart_backoff_s
            self._update_health()
        self._bump(rep.name, "preempted")
        self._m_preempted.labels(rep.name).inc()
        self._event("replica_preempted", replica=rep.name, gen=rep.gen)
        rep.q.put(_STOP)
        self._drain_slot(rep, "replica preempted")
        return True

    def pressure(self) -> float:
        """Pending depth / ``max_queue`` (0 when unbounded): the admission
        controller's pool-side pressure signal."""
        if not self.max_queue:
            return 0.0
        with self._depth_lock:
            return self._depth / self.max_queue

    def stats(self) -> dict:
        """A snapshot: each replica's state, incarnation, queue, served
        requests, restarts, crashes by kind, requeues off it and
        preemptions; the pool's health, breaker, queue, shed, batch
        occupancy and request outcome counts."""
        with self._depth_lock:
            depth, submitted, shed = self._depth, self._submitted, self._shed_n
        occ = self._occ.snapshot()
        with self._state_lock:
            slots = list(self._slots)
            fails = list(self._fails)
        with self._count_lock:
            counts = dict(self._counts)
            per = {k: dict(v) for k, v in self._per_replica.items()}
        return {
            "replicas": {
                rep.name: {
                    "state": rep.state,
                    "gen": rep.gen,
                    "queued": rep.q.qsize(),
                    "served": rep.served,
                    "restarts": fails[i] if i < len(fails) else 0,
                    **per.get(rep.name, {}),
                }
                for i, rep in enumerate(slots)
            },
            "healthy": self._healthy_count(),
            "quorum": self.quorum,
            "breaker_open": self._breaker_open,
            "queue_depth": depth,
            "requests_submitted": submitted,
            "requests_shed": shed,
            "batch_occupancy": occ["ewma"],
            "window_batch_occupancy": occ["window_mean"],
            "batches_flushed": occ["batches"],
            **{f"requests_{k}": counts[k] for k in ("expired", "late", "aborted")},
            "breaker_trips": counts["breaker_trips"],
        }

    def close(self, drain: bool = True, timeout_s: float = 10.0):
        """Stop everything and resolve every pending request. Joins are
        bounded; what is left is failed with :class:`ShutdownError` (the
        settle latch keeps a late result from resolving it twice)."""
        if self._closed:
            return
        self._drain = drain
        # latched under the state lock: a restart re-checks it under the
        # same lock, so no slot respawns after the sweep below
        with self._state_lock:
            self._closed = True
        self._supervisor.join(timeout=max(1.0, self._interval * 4))
        for rep in self._slots:
            rep.q.put(_STOP)
        deadline = time.monotonic() + timeout_s
        for rep in self._slots:
            if rep.thread is not None:
                rep.thread.join(timeout=max(0.0, deadline - time.monotonic()))
        with self._live_lock:
            leftovers = list(self._live)
        for rec in leftovers:
            if rec.settle():
                self._count("aborted")
                self._m_aborted.inc()
                self._finish(rec, "shutdown", exc=ShutdownError("ReplicaSet closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- router

    def _pick(self, excluded) -> _Replica | None:
        best, best_sz = None, None
        pref, pref_sz = None, None
        for rep in self._slots:
            if rep.state != "up" or rep.name in excluded:
                continue
            sz = rep.q.qsize()
            if best is None or sz < best_sz:
                best, best_sz = rep, sz
            if rep.name == self._canary_pref:
                pref, pref_sz = rep, sz
        # a canary under evaluation takes ties, or an idle pool would send
        # everything to the first slot and starve the canary window
        if pref is not None and pref_sz <= best_sz:
            return pref
        return best

    def set_canary_preference(self, name: str | None) -> None:
        """Route queue-size ties to this replica; ``None`` restores plain
        least-loaded routing."""
        self._canary_pref = name

    def _event(self, etype: str, **fields) -> None:
        if self._tracer is not None:
            self._tracer.event(etype, **fields)

    def _beat(self, rep: _Replica) -> None:
        if self._health is not None:
            self._health.beat(f"replica.{rep.name}")

    def _count(self, key: str, n: int = 1) -> None:
        with self._count_lock:
            self._counts[key] += n

    def _bump(self, replica: str, key: str, n: int = 1) -> None:
        with self._count_lock:
            per = self._per_replica.setdefault(replica, {})
            per[key] = per.get(key, 0) + n

    def _finish(self, rec: _Request, outcome: str, *, result=None, exc=None, replica: str | None = None,
                error: str | None = None) -> None:
        """Resolve a settled record: the trace row first (a caller that sees
        the future done can rely on the row), attribution on the future,
        then its result or error, then the observers."""
        with self._live_lock:
            self._live.discard(rec)
        if rec.tr is not None:
            rec.tr.replica_id = replica
            rec.tr.retries = rec.retries
            if rec.excluded:
                rec.tr.requeued_from = ",".join(sorted(rec.excluded))
            self._tracer.finish(rec.tr, outcome, error=error)
        fut = rec.fut
        fut.replica = replica
        fut.retries = rec.retries
        fut.requeued_from = ",".join(sorted(rec.excluded)) if rec.excluded else None
        fut.outcome = outcome
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
        lat = time.perf_counter() - rec.t0
        for fn in list(self._observers):
            try:
                fn(replica, outcome, lat, rec.retries)
            except Exception:  # noqa: BLE001 - an observer must not kill serving
                pass

    def _requeue(self, rec: _Request, from_rep: _Replica, err: str) -> None:
        """Move one request off a failed replica: excluded set, retry
        budget, a survivor; terminal failures resolve typed."""
        if rec.settled:
            return
        rec.excluded.add(from_rep.name)
        rec.retries += 1
        self._bump(from_rep.name, "requeued")
        self._m_requeued.labels(from_rep.name).inc()
        if self._closed and self._drain:
            if rec.settle():
                self._count("aborted")
                self._m_aborted.inc()
                self._finish(rec, "shutdown", exc=ShutdownError("ReplicaSet closed"))
            return
        if rec.retries > self.max_retries:
            if rec.settle():
                self._finish(rec, "aborted", exc=RetriesExhaustedError(
                    f"retries exhausted after {rec.retries} attempts; last error on {from_rep.name}: {err}"),
                    error=f"RetriesExhaustedError: last error on {from_rep.name}: {err}")
            return
        target = self._pick(rec.excluded)
        if target is None:
            if rec.settle():
                self._finish(rec, "aborted", exc=PoolUnhealthyError(
                    f"no surviving replica outside {sorted(rec.excluded)} to retry on (last error: {err})"),
                    error="PoolUnhealthyError: no surviving replica")
            return
        with self._depth_lock:
            self._depth += 1
        target.q.put(rec)

    def _drain_slot(self, rep: _Replica, err: str) -> None:
        """Requeue everything queued on a down slot."""
        while True:
            try:
                item = rep.q.get_nowait()
            except queue.Empty:
                return
            if item is _STOP:
                continue
            with self._depth_lock:
                self._depth -= 1
            self._requeue(item, rep, err)

    # ------------------------------------------------------------- worker

    def _start_worker(self, rep: _Replica) -> None:
        rep.thread = threading.Thread(target=self._worker, args=(rep,), daemon=True,
                                      name=f"replica-{rep.name}-g{rep.gen}")
        rep.thread.start()

    def _stale(self, rep: _Replica) -> bool:
        # a removed slot's worker reads as stale, not as an IndexError
        return rep.idx >= len(self._slots) or self._slots[rep.idx] is not rep

    def _worker(self, rep: _Replica) -> None:
        carry: _Request | None = None  # lookahead from another group
        try:
            while not self._stale(rep):
                if carry is not None:
                    item, carry = carry, None
                else:
                    try:
                        item = rep.q.get(timeout=0.05)
                    except queue.Empty:
                        if self._closed:
                            return
                        continue
                    if item is _STOP:
                        return
                batch: list[_Request] = []
                self._admit(item, batch)
                coalesce_deadline = time.monotonic() + self.max_delay
                stop = False
                while len(batch) < self.max_batch:
                    remaining = coalesce_deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        nxt = rep.q.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if nxt is _STOP:
                        stop = True
                        break
                    # a group flushes as shaped: never across a group boundary
                    if batch and nxt.gid != batch[0].gid:
                        carry = nxt
                        break
                    self._admit(nxt, batch)
                if batch and not self._flush(rep, batch):
                    return  # crashed: the restart is the supervisor's
                if stop:
                    return
        finally:
            if carry is not None:
                # a lookahead never admitted: back through the requeue path
                with self._depth_lock:
                    self._depth -= 1
                self._requeue(carry, rep, "worker exited holding lookahead")

    def _admit(self, rec: _Request, batch: list) -> None:
        with self._depth_lock:
            self._depth -= 1
        if rec.settled:
            return  # resolved elsewhere (a requeue or hung-replica race)
        if self._closed and self._drain:
            if rec.settle():
                self._count("aborted")
                self._m_aborted.inc()
                self._finish(rec, "shutdown", exc=ShutdownError("ReplicaSet closed"))
            return
        if rec.deadline is not None and time.monotonic() > rec.deadline:
            if rec.settle():
                self._count("expired")
                self._m_expired.inc()
                self._finish(rec, "deadline", exc=DeadlineExceededError("request deadline passed while queued"))
            return
        if rec.tr is not None:
            self._tracer.admitted(rec.tr)
        batch.append(rec)

    def _flush(self, rep: _Replica, batch: list[_Request]) -> bool:
        """Run one batch on this replica; False when it crashed."""
        self._count("batches")
        self._count("requests", len(batch))
        self._m_batches.inc()
        self._m_requests.inc(len(batch))
        self._m_occupancy.observe(len(batch) / self.max_batch)
        self._occ.observe(len(batch))
        traces = [rec.tr for rec in batch if rec.tr is not None]
        if traces:
            self._tracer.flush_begin(traces)
        # pending and busy_since go up before the fault point: an injected
        # delay (the hang model) must be visible to the supervisor, and a
        # hang's in-flight records findable
        rep.pending = tuple(batch)
        rep.busy_since = self._clock()
        # the engine this flush runs on, read once: a scale-down can retire
        # the slot (and drop ``rep.engine``) while a batch it took is still
        # coalescing or running, and the batch must finish on what it began
        engine = rep.engine
        t_run = time.perf_counter()
        try:
            fault_point("serve.replica", key=rep.name)
            # a packed group mixes resolutions: no common stack shape, so
            # the run gets the image list
            if len({rec.image.shape for rec in batch}) == 1:
                images = np.stack([rec.image for rec in batch])
            else:
                images = [rec.image for rec in batch]
            out = self._run(engine, images, [rec.meta for rec in batch])
        except BaseException as e:  # noqa: BLE001 - crash-isolate the replica
            rep.busy_since = None
            rep.pending = ()
            self._on_failure(rep, batch, e, kind="crash")
            return False
        done = time.perf_counter()
        rep.busy_since = None
        rep.pending = ()
        if traces:
            bd = self._breakdown
            self._tracer.flush_end(traces, run_s=done - t_run, batch=len(batch),
                                   breakdown=(lambda: bd(engine)) if bd is not None else None)
            if self._costmeter is not None:
                # before the finish loop: the stamped device_s/cost_flops
                # land on every access-log row of this batch
                self._costmeter.observe_batch(run_s=done - t_run, traces=traces, batch=len(batch), engine=engine)
        self._m_latency.observe_many([done - rec.t0 for rec in batch])
        rows = [{k: v[i] for k, v in out.items()} for i in range(len(batch))] if isinstance(out, dict) else out
        now_mono = time.monotonic()
        for rec, row in zip(batch, rows):
            if rec.deadline is not None and now_mono > rec.deadline:
                if rec.settle():
                    self._count("late")
                    self._m_late.inc()
                    self._finish(rec, "late", replica=rep.name, exc=DeadlineExceededError(
                        "request deadline passed during batch coalescing/compute"))
            elif rec.settle():
                rep.served += 1
                self._m_served.labels(rep.name).inc()
                self._finish(rec, "ok", result=row, replica=rep.name)
        # a whole good batch resets the slot's backoff, unless a restart
        # already replaced this incarnation
        if not self._stale(rep):
            self._fails[rep.idx] = 0
            self._beat(rep)
        return True

    # --------------------------------------------------------- supervisor

    def _on_failure(self, rep: _Replica, batch, exc, *, kind: str) -> None:
        err = f"{type(exc).__name__}: {exc}"
        self._bump(rep.name, f"crashes_{kind}")
        self._m_crashes.labels(rep.name, kind).inc()
        self._event("replica_crash", replica=rep.name, kind=kind, gen=rep.gen, err=err)
        self._mark_down(rep)
        for rec in batch:
            self._requeue(rec, rep, err)
        self._drain_slot(rep, err)

    def _backoff(self, idx: int) -> None:
        """Caller holds the state lock: one more failure, the next restart
        after a capped exponential backoff."""
        self._fails[idx] += 1
        backoff = min(self.restart_backoff_s * 2 ** (self._fails[idx] - 1), self.restart_backoff_max_s)
        self._restart_at[idx] = self._clock() + backoff

    def _mark_down(self, rep: _Replica) -> None:
        with self._state_lock:
            if self._stale(rep) or rep.state == "down":
                return
            rep.state = "down"
            self._m_up.labels(rep.name).set(0)
            self._backoff(rep.idx)
            self._update_health()

    def _update_health(self) -> None:
        healthy = self._healthy_count()
        self._m_healthy.set(healthy)
        open_now = healthy < self.quorum
        if open_now and not self._breaker_open:
            self._breaker_open = True
            self._m_breaker.set(1)
            self._m_breaker_trips.inc()
            self._count("breaker_trips")
            self._event("breaker_open", healthy=healthy, quorum=self.quorum)
        elif not open_now and self._breaker_open:
            self._breaker_open = False
            self._m_breaker.set(0)
            self._event("breaker_close", healthy=healthy, quorum=self.quorum)

    def _supervise(self) -> None:
        while not self._closed:
            now = self._clock()
            for rep in list(self._retired):
                self._drain_slot(rep, "replica removed")
            for rep in list(self._slots):
                if rep.state in ("up", "paused"):
                    try:
                        # a preemption notice: ticked once per routable
                        # replica per supervisor pass (key: its name)
                        fault_point("serve.preempt", key=rep.name)
                    except Exception:
                        # drained on a thread: a drain must not stall hang
                        # detection for the other replicas
                        threading.Thread(target=self.preempt, args=(rep.idx,), daemon=True,
                                         name=f"replica-preempt-{rep.name}").start()
                        continue
                    busy = rep.busy_since
                    if busy is not None and now - busy > self.hang_timeout_s:
                        # a hung predict: abandon the thread, rescue the work
                        self._bump(rep.name, "crashes_hang")
                        self._m_crashes.labels(rep.name, "hang").inc()
                        self._event("replica_hang", replica=rep.name, gen=rep.gen, busy_s=round(now - busy, 3))
                        self._mark_down(rep)
                        for rec in list(rep.pending):
                            self._requeue(rec, rep, "hung predict")
                        self._drain_slot(rep, "hung predict")
                elif rep.state == "down":
                    idx = rep.idx
                    # racing submits may still land on a dead queue
                    self._drain_slot(rep, "replica down")
                    if now >= self._restart_at[idx] and not self._restarting[idx]:
                        self._restarting[idx] = True
                        threading.Thread(target=self._restart_slot, args=(idx,), daemon=True,
                                         name=f"replica-restart-{rep.name}").start()
            time.sleep(self._interval)

    def _restart_slot(self, idx: int) -> None:
        old = self._slots[idx]
        try:
            try:
                engine = self._provider(idx)
            except BaseException as e:  # noqa: BLE001 - a provider error is a failed restart
                self._bump(old.name, "crashes_restart_error")
                self._m_crashes.labels(old.name, "restart_error").inc()
                self._event("replica_restart_failed", replica=old.name, err=f"{type(e).__name__}: {e}")
                with self._state_lock:
                    self._backoff(idx)
                return
            if self._closed:
                return
            rep = _Replica(idx, gen=old.gen + 1, engine=engine)
            with self._state_lock:
                if self._closed:  # the shutdown latch (see close)
                    return
                self._slots[idx] = rep
            self._start_worker(rep)
            self._m_up.labels(rep.name).set(1)
            self._m_restarts.labels(rep.name).inc()
            self._bump(rep.name, "restarted")
            self._event("replica_restart", replica=rep.name, gen=rep.gen)
            self._beat(rep)
            with self._state_lock:
                self._update_health()
            self._drain_slot(old, "superseded incarnation")
        finally:
            self._restarting[idx] = False


class WeightSwapController:
    """Parity- and canary-gated weight hot swap over a :class:`ReplicaSet`
    (the gates are in the module docstring).

    ``restore_fn(path) -> (params, batch_stats)`` defaults to
    ``train.checkpoint.restore_inference_state`` (a host-side tree: the
    double buffer lives in host memory). ``features_fn(engine, images)``
    defaults to ``engine.features``: the probe both parity legs run.
    ``on_promote(ckpt)`` lets the owner repoint the replica provider.
    ``headroom_fn(host_bytes, card_bytes)`` is the memory gate (the module
    docstring). ``counts`` holds the attempts, promotions, rollbacks and
    rejections, as the ``serve_swap_*`` counters of ``registry`` do;
    ``last_report`` the last swap's report."""

    def __init__(
        self,
        replicaset: ReplicaSet,
        *,
        restore_fn=None,
        features_fn=None,
        parity_images=None,
        parity_min_cosine: float = 0.98,
        canary_slo: str = "success_rate>=0.99",
        canary_requests: int = 16,
        canary_timeout_s: float = 30.0,
        drain_timeout_s: float = 10.0,
        on_promote=None,
        headroom_fn=None,
        registry=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.rs = replicaset
        self._restore_fn = restore_fn
        self._features_fn = features_fn or (lambda engine, images: engine.features(images))
        self.parity_images = parity_images
        self.parity_min_cosine = float(parity_min_cosine)
        self.canary_slo = canary_slo
        self.canary_requests = int(canary_requests)
        self.canary_timeout_s = float(canary_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self._on_promote = on_promote
        self._headroom_fn = headroom_fn
        self._clock = clock
        self._swap_lock = lockwatch.lock("replicaset.swap")
        self.last_report: dict | None = None
        self.counts = {"attempts": 0, "promoted": 0, "rolled_back": 0, "rejected": 0}
        reg = registry if registry is not None else get_registry()
        self._m_attempts = reg.counter("serve_swap_attempts_total", "weight hot-swap attempts")
        self._m_promoted = reg.counter("serve_swap_promoted_total", "hot-swaps promoted to the full pool")
        self._m_rollbacks = reg.counter(
            "serve_swap_rollbacks_total",
            "hot-swaps rolled back (parity gate, canary breach, canary crash, or promote failure)")
        self._m_rejected = reg.counter(
            "serve_swap_rejected_total",
            "hot-swaps rejected before any replica was flipped (restore/graft failure, memory headroom, no routable "
            "canary)")
        self._m_active = reg.gauge("serve_swap_active", "1 while a swap is in flight")
        self._m_parity = reg.gauge("serve_swap_parity_cosine", "min feature cosine of the last swap's parity gate")
        self._m_canary_burn = reg.gauge("serve_swap_canary_burn",
                                        "worst slow-window burn rate of the last canary evaluation")

    def _restore(self, ckpt: str):
        if self._restore_fn is not None:
            params, stats = self._restore_fn(ckpt)
        else:
            from jumbo_mae_tpu_tpu_torch.train.checkpoint import restore_inference_state

            params, stats = restore_inference_state(ckpt)
        # the bad-push site: `corrupt` diverges the tree (parity must catch
        # it), `raise` models an unreadable checkpoint
        params = fault_point("ckpt.load", key=str(ckpt), data=params)
        return params, stats

    def _event(self, etype: str, **fields) -> None:
        self.rs._event(etype, **fields)

    def _card_need(self) -> int:
        """Card bytes the swap builds aside: the largest of the replicas'
        engines' (one engine swaps at a time; 0 for engines without a
        card)."""
        need = 0
        for rep in list(self.rs._slots):
            fn = getattr(rep.engine, "swap_device_bytes", None)
            if fn is not None:
                need = max(need, int(fn()))
        return need

    def _parity(self, engine, reference_feats) -> dict:
        cand = np.asarray(self._features_fn(engine, self.parity_images))
        cos = feature_cosine(np.asarray(reference_feats), cand)
        cos_min = float(np.min(cos))
        self._m_parity.set(cos_min)
        return {
            "cosine_min": cos_min,
            "cosine_mean": float(np.mean(cos)),
            "tolerance": self.parity_min_cosine,
            "within_tolerance": cos_min >= self.parity_min_cosine,
        }

    def _reject(self, report: dict, stage: str, err: str) -> dict:
        report.update(verdict="rejected", stage=stage, error=err)
        self.counts["rejected"] += 1
        self._m_rejected.inc()
        self._event("swap_rejected", ckpt=report["ckpt"], stage=stage, err=err)
        return report

    def _rollback(self, report: dict, stage: str, detail: str) -> dict:
        report.update(verdict="rolled_back", stage=stage, detail=detail)
        self.counts["rolled_back"] += 1
        self._m_rollbacks.inc()
        self._event("swap_rollback", ckpt=report["ckpt"], stage=stage, detail=detail)
        return report

    def swap(self, ckpt: str) -> dict:
        """Run one checkpoint through restore → parity → canary → promote;
        returns the report (``verdict``: promoted, rolled_back or
        rejected; ``stage``). One swap at a time."""
        with self._swap_lock:
            report = self._swap(str(ckpt))
            self.last_report = report
            return report

    def _swap(self, ckpt: str) -> dict:
        self.counts["attempts"] += 1
        self._m_attempts.inc()
        self._m_active.set(1)
        self._event("swap_start", ckpt=ckpt)
        try:
            return self._swap_gated(ckpt)
        finally:
            self._m_active.set(0)

    def _swap_gated(self, ckpt: str) -> dict:
        report: dict = {"ckpt": ckpt, "verdict": None, "stage": None}
        try:
            params, stats = self._restore(ckpt)
        except BaseException as e:  # noqa: BLE001 - an unreadable push is a verdict
            return self._reject(report, "restore", f"{type(e).__name__}: {e}")
        if self._headroom_fn is not None:
            # the double buffer: the restored tree and the snapshot of the
            # live one on the host, and the models built aside on the card
            need = 2 * tree_nbytes(params)
            try:
                shortfall = self._headroom_fn(need, self._card_need())
            except Exception:  # noqa: BLE001 - a broken probe must not block swaps
                shortfall = None
            if shortfall:
                return self._reject(report, "headroom", str(shortfall))
        canary = self.rs.first_routable()
        if canary is None:
            return self._reject(report, "canary_pick", "no routable replica")
        report["canary"] = canary.name
        canary_gen = canary.gen
        self.rs.pause(canary.idx)
        try:
            self.rs.wait_idle(canary.idx, self.drain_timeout_s)
            if self.parity_images is None:
                self.parity_images = self._default_probe(canary.engine)
            ref = np.asarray(self._features_fn(canary.engine, self.parity_images))
            try:
                snap = canary.engine.swap_weights(params, stats, ckpt=ckpt)
            except BaseException as e:  # noqa: BLE001 - a graft failure leaves the old weights live
                return self._reject(report, "graft", f"{type(e).__name__}: {e}")
            try:
                parity = self._parity(canary.engine, ref)
            except BaseException as e:  # noqa: BLE001 - a probe crash is a failed gate
                canary.engine.restore_snapshot(snap)
                return self._rollback(report, "parity", f"probe error: {type(e).__name__}: {e}")
            report["parity"] = parity
            if not parity["within_tolerance"]:
                canary.engine.restore_snapshot(snap)
                return self._rollback(
                    report, "parity", f"cosine_min {parity['cosine_min']:.4f} < {self.parity_min_cosine}")
        finally:
            self.rs.resume(canary.idx)
        self._event("swap_canary", ckpt=ckpt, replica=canary.name,
                    cosine_min=report.get("parity", {}).get("cosine_min"))
        breach, canary_report = self._canary_window(canary, canary_gen)
        report["canary_eval"] = canary_report
        if breach:
            if self.rs.generation(canary.idx) == canary_gen:
                self.rs.pause(canary.idx)
                self.rs.wait_idle(canary.idx, self.drain_timeout_s)
                canary.engine.restore_snapshot(snap)
                self.rs.resume(canary.idx)
            # else the canary crashed and the provider rebuilt it on the old weights
            return self._rollback(report, "canary", canary_report["why"])
        # promote: the other replicas one at a time, never all at once
        flipped = [(canary.idx, canary_gen, snap)]
        for rep in list(self.rs._slots):
            if rep.idx == canary.idx or rep.state != "up":
                continue
            self.rs.pause(rep.idx)
            self.rs.wait_idle(rep.idx, self.drain_timeout_s)
            try:
                flipped.append((rep.idx, rep.gen, rep.engine.swap_weights(params, stats, ckpt=ckpt)))
            except BaseException as e:  # noqa: BLE001 - undo the partial promote
                self.rs.resume(rep.idx)
                for idx, gen, s2 in flipped:
                    if self.rs.generation(idx) == gen:
                        self.rs.pause(idx)
                        self.rs.wait_idle(idx, self.drain_timeout_s)
                        self.rs.replica(idx).engine.restore_snapshot(s2)
                        self.rs.resume(idx)
                return self._rollback(report, "promote", f"{rep.name}: {type(e).__name__}: {e}")
            self.rs.resume(rep.idx)
        if self._on_promote is not None:
            try:
                self._on_promote(ckpt)
            except Exception:  # noqa: BLE001 - bookkeeping must not fail a shipped swap
                pass
        self.counts["promoted"] += 1
        self._m_promoted.inc()
        self._event("swap_promoted", ckpt=ckpt)
        report.update(verdict="promoted", stage="promote")
        return report

    @staticmethod
    def _default_probe(engine) -> np.ndarray:
        size = getattr(engine, "image_size", 32)
        return np.random.RandomState(0).randint(0, 256, (4, size, size, 3)).astype(np.uint8)

    def _canary_window(self, canary, canary_gen: int) -> tuple[bool, dict]:
        """Only the canary's live outcomes, through a burn-rate tracker of
        its own; returns (breached, report)."""
        tracker = SLOTracker(parse_slo(self.canary_slo), window_s=max(self.canary_timeout_s, 1.0),
                             registry=NULL_REGISTRY)
        seen = {"n": 0}
        crashed = {"requests": 0, "why": "canary replica crashed during the window"}

        def feed(replica, outcome, latency_s, retries):
            if replica == canary.name:
                seen["n"] += 1
                tracker.observe(latency_s, outcome)

        self.rs.add_observer(feed)
        self.rs.set_canary_preference(canary.name)
        try:
            deadline = self._clock() + self.canary_timeout_s
            while self._clock() < deadline:
                if seen["n"] >= self.canary_requests:
                    break
                if self.rs.generation(canary.idx) != canary_gen:
                    return True, {**crashed, "requests": seen["n"]}
                time.sleep(0.01)
        finally:
            self.rs.set_canary_preference(None)
            self.rs.remove_observer(feed)
        if self.rs.generation(canary.idx) != canary_gen:
            return True, {**crashed, "requests": seen["n"]}
        ev = tracker.evaluate()
        worst = max((o["burn_slow"] for o in ev["objectives"]), default=0.0)
        self._m_canary_burn.set(worst)
        breached = bool(ev["degraded"]) or any(o["breached"] for o in ev["objectives"])
        why = (
            "canary SLO breached: " + "; ".join(
                f"{o['name']}={o['value']} (burn {o['burn_slow']})" for o in ev["objectives"] if o["breached"])
            if breached else "ok"
        )
        return breached, {"requests": seen["n"], "burn_worst": worst, "objectives": ev["objectives"], "why": why}
