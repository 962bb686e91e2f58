"""Opt-in instrumented locks: runtime lock-order and long-hold sentinel.

Counterpart of ``jumbo_mae_tpu_tpu/obs/lockwatch.py``, the same switches,
graph, metrics and journal event. It watches the orders threads actually
take the serving tier's locks in, and turns an inversion into a metric
and a journal event instead of a deadlock.

Usage: construct locks through the factory instead of ``threading.Lock``::

    self._lock = lockwatch.lock("engine.master")

With lockwatch disabled (the default) the factory returns a plain
``threading.Lock``: no overhead, the same behavior. Enabled
(``GRAFT_LOCKWATCH=1`` in the environment, or :func:`enable`), it returns
a wrapper that keeps a per-thread stack of held lockwatch locks and a
process-global first-seen acquisition-order graph:

* acquiring B while holding A records the directed edge A→B; if B→A was
  ever observed before, that is an **order inversion**: two threads on
  the two paths can deadlock. It increments
  ``lock_order_violations_total``, journals a ``lock_order_violation``
  event (when a journal is attached), and warns once per pair.
* a hold longer than ``GRAFT_LOCKWATCH_HOLD_S`` seconds (default 0.5) is
  a **blocking-while-held** proxy: something slow (a capture, an fsync,
  a device sync) ran under the lock. It increments
  ``lock_blocking_while_held_total{lock=...}``.

Per-lock metrics: ``lock_acquire_total{lock}``,
``lock_wait_seconds{lock}``, ``lock_hold_seconds{lock}``,
``lock_order_violations_total``, ``lock_blocking_while_held_total{lock}``.

The sentinel's own bookkeeping runs under one internal lock that is never
held across user code, metrics, or the journal: lockwatch cannot deadlock
the thing it watches.
"""

from __future__ import annotations

import os
import threading
import time
import warnings

__all__ = [
    "lock",
    "rlock",
    "enable",
    "disable",
    "enabled",
    "attach_journal",
    "order_edges",
    "violations",
    "reset",
    "WatchedLock",
    "WatchedRLock",
]

_ENV_VAR = "GRAFT_LOCKWATCH"
_HOLD_ENV_VAR = "GRAFT_LOCKWATCH_HOLD_S"

_enabled = os.environ.get(_ENV_VAR, "") not in ("", "0", "false")
_hold_threshold_s = float(os.environ.get(_HOLD_ENV_VAR, "0.5") or "0.5")

# --- process-global sentinel state -------------------------------------
_state_lock = threading.Lock()   # guards the maps below; never held
                                 # across user code / metrics / journal
_edges: dict[tuple[str, str], dict] = {}      # (held, acquired) -> info
_violations: list[dict] = []
_warned_pairs: set[frozenset] = set()
_journal = None                  # attach_journal() target (duck-typed)

_held = threading.local()        # per-thread stack of held lock names

_metrics = None                  # lazy _Metrics singleton


def _held_stack() -> list:
    stack = getattr(_held, "stack", None)
    if stack is None:
        stack = _held.stack = []
    return stack


class _Metrics:
    def __init__(self):
        from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry

        reg = get_registry()
        self.acquires = reg.counter(
            "lock_acquire_total",
            "lockwatch: acquisitions per instrumented lock",
            labels=("lock",),
        )
        self.wait = reg.histogram(
            "lock_wait_seconds",
            "lockwatch: time spent waiting to acquire",
            labels=("lock",),
        )
        self.hold = reg.histogram(
            "lock_hold_seconds",
            "lockwatch: time the lock was held",
            labels=("lock",),
        )
        self.order_violations = reg.counter(
            "lock_order_violations_total",
            "lockwatch: acquisition-order inversions observed (A before B "
            "on one thread, B before A on another)",
        )
        self.long_holds = reg.counter(
            "lock_blocking_while_held_total",
            "lockwatch: holds longer than GRAFT_LOCKWATCH_HOLD_S — "
            "something blocking ran under the lock",
            labels=("lock",),
        )


def _get_metrics() -> _Metrics:
    global _metrics
    if _metrics is None:
        _metrics = _Metrics()
    return _metrics


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Turn the factory on for locks created *after* this call."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def attach_journal(journal) -> None:
    """Journal ``lock_order_violation`` events to ``journal`` (anything
    with an ``event(etype, **fields)`` method); pass None to detach."""
    global _journal
    _journal = journal


def order_edges() -> dict:
    """Snapshot of the observed acquisition-order graph (test/debug)."""
    with _state_lock:
        return {k: dict(v) for k, v in _edges.items()}


def violations() -> list[dict]:
    with _state_lock:
        return [dict(v) for v in _violations]


def reset() -> None:
    """Drop all observed edges/violations (tests)."""
    global _metrics
    with _state_lock:
        _edges.clear()
        _violations.clear()
        _warned_pairs.clear()
    _metrics = None


def _record_acquisition(name: str, holder_stack: list[str]) -> list[dict]:
    """Record edges holder→name; return inversion records to publish
    (computed under the state lock, published by the caller outside it)."""
    inversions: list[dict] = []
    thread = threading.current_thread().name
    with _state_lock:
        for holder in holder_stack:
            if holder == name:
                continue
            edge = (holder, name)
            if edge not in _edges:
                _edges[edge] = {"thread": thread, "count": 0}
            _edges[edge]["count"] += 1
            reverse = _edges.get((name, holder))
            if reverse is not None:
                pair = frozenset((holder, name))
                record = {
                    "held": holder,
                    "acquired": name,
                    "thread": thread,
                    "reverse_thread": reverse["thread"],
                    "reverse_count": reverse["count"],
                }
                _violations.append(record)
                if pair not in _warned_pairs:
                    _warned_pairs.add(pair)
                    inversions.append(record)
                else:
                    inversions.append(None)  # counted, not re-warned
    return inversions


def _publish_inversions(inversions: list) -> None:
    metrics = _get_metrics()
    for record in inversions:
        metrics.order_violations.inc()
        if record is None:
            continue
        warnings.warn(
            f"lockwatch: lock-order inversion — thread "
            f"{record['thread']!r} acquired {record['acquired']!r} while "
            f"holding {record['held']!r}, but thread "
            f"{record['reverse_thread']!r} has taken them in the opposite "
            "order; these two paths can deadlock",
            RuntimeWarning,
            stacklevel=4,
        )
        journal = _journal
        if journal is not None:
            try:
                journal.event("lock_order_violation", **record)
            except Exception:  # noqa: BLE001 — the sentinel must not kill serving
                pass


class WatchedLock:
    """Drop-in for ``threading.Lock`` with order/hold instrumentation."""

    __slots__ = ("name", "_lock", "_acquired_at")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._acquired_at = {}  # thread ident -> monotonic acquire time

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        t0 = time.monotonic()
        ok = self._lock.acquire(blocking, timeout)
        if not ok:
            return False
        waited = time.monotonic() - t0
        stack = _held_stack()
        inversions = _record_acquisition(self.name, list(stack))
        stack.append(self.name)
        self._acquired_at[threading.get_ident()] = time.monotonic()
        metrics = _get_metrics()
        metrics.acquires.labels(lock=self.name).inc()
        metrics.wait.labels(lock=self.name).observe(waited)
        if inversions:
            _publish_inversions(inversions)
        return True

    def release(self) -> None:
        held_s = None
        t0 = self._acquired_at.pop(threading.get_ident(), None)
        if t0 is not None:
            held_s = time.monotonic() - t0
        stack = _held_stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        elif self.name in stack:  # released out of LIFO order: still remove
            stack.remove(self.name)
        self._lock.release()
        if held_s is not None:
            metrics = _get_metrics()
            metrics.hold.labels(lock=self.name).observe(held_s)
            if held_s > _hold_threshold_s:
                metrics.long_holds.labels(lock=self.name).inc()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"WatchedLock({self.name!r}, locked={self.locked()})"


class WatchedRLock(WatchedLock):
    """Drop-in for ``threading.RLock``: a thread's outermost acquire and
    release are instrumented as :class:`WatchedLock`'s, its nested ones
    only counted (a re-entry is not a new edge)."""

    __slots__ = ("_owner", "_depth")

    def __init__(self, name: str):
        super().__init__(name)
        self._lock = threading.RLock()
        self._owner = None
        self._depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._owner == threading.get_ident():
            self._lock.acquire()
            self._depth += 1
            return True
        if not super().acquire(blocking, timeout):
            return False
        self._owner = threading.get_ident()
        self._depth = 1
        return True

    def release(self) -> None:
        if self._depth > 1:
            self._depth -= 1
            self._lock.release()
            return
        self._owner = None
        self._depth = 0
        super().release()

    def locked(self) -> bool:
        return self._owner is not None

    def __repr__(self) -> str:
        return f"WatchedRLock({self.name!r}, locked={self.locked()})"


def lock(name: str):
    """Lock factory: a :class:`WatchedLock` when lockwatch is enabled,
    else a plain ``threading.Lock`` (zero overhead, identical semantics)."""
    if _enabled:
        return WatchedLock(name)
    return threading.Lock()


def rlock(name: str):
    """Reentrant lock factory: a :class:`WatchedRLock` when lockwatch is
    enabled, else a plain ``threading.RLock``. The port's engine holds its
    replay lock across nested dispatches; the JAX package has no
    reentrant lock to watch."""
    if _enabled:
        return WatchedRLock(name)
    return threading.RLock()
