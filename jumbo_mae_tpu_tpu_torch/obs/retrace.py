"""Capture sentinel: no new graph after warmup, enforced at runtime.

Counterpart of ``jumbo_mae_tpu_tpu/obs/retrace.py``. A steady serving
loop must not build executables: after warmup every (task key, bucket)
the traffic reaches is already captured, and a capture on the request
path (a missed bucket, a shape that escaped padding, a dtype drift) costs
a request the eager first run and the capture, many times a replay. The
JAX sentinel counts XLA compiles from ``jax.monitoring``. The port's
engine builds no XLA program; what it builds is a CUDA graph per key (on
the CPU, a key's first eager run), counted in ``compile_counts``, and
each one calls the engine's ``on_compile(task_key, bucket)`` hook. This
sentinel is that hook (:meth:`RetraceSentinel.on_compile`). The train
loop's step is eager and builds nothing either; its counterpart of an XLA
compile is the first dispatch of a (tag, signature) the loop has not
dispatched before, which is exactly what ``jax.jit`` would compile again
(:meth:`RetraceSentinel.dispatch`). Protocol:

* ``note(tag, tree)``: record the signature (shapes and dtypes of the
  tensors and arrays) of what is about to be dispatched; cheap, no device
  access. ``dispatch(tag, tree)`` notes, and counts a signature new to
  ``tag`` as one compile through ``on_compile(tag, leading dimension)``.
* ``arm()``: warmup is over: from here every capture is a violation
  unless inside an ``expected()`` block (a swap, a replica restart, a
  scale-up build).
* a violation warns, journals a ``retrace`` event (when a journal is
  given) naming the key and bucket and the most recent signature change
  it saw (tag, previous and new signature, the per-leaf diff).

Metrics: ``retrace_compiles_total{loop}`` (every capture seen),
``retrace_events_total{loop}`` (violations), ``retrace_armed{loop}``.
"""

from __future__ import annotations

import threading
import warnings
from collections.abc import Mapping
from contextlib import contextmanager

from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry

__all__ = ["RetraceSentinel"]


def _leaves(tree) -> list:
    """The leaves of a tree of mappings, lists and tuples, in order (a
    mapping's in sorted key order, as a pytree flattens a dict)."""
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [] if tree is None else [tree]


def _signature(tree) -> tuple:
    """Abstract signature of a tree: ``((shape, dtype), ...)`` per leaf;
    a tensor's dtype without its ``torch.`` prefix."""
    sig = []
    for leaf in _leaves(tree):
        shape = tuple(getattr(leaf, "shape", ()))
        dtype = str(getattr(leaf, "dtype", type(leaf).__name__)).removeprefix("torch.")
        sig.append((shape, dtype))
    return tuple(sig)


def _sig_diff(prev: tuple, new: tuple) -> list[dict]:
    """Per-leaf differences between two signatures."""
    diff = []
    for i in range(max(len(prev), len(new))):
        p = prev[i] if i < len(prev) else None
        n = new[i] if i < len(new) else None
        if p != n:
            diff.append({
                "leaf": i,
                "prev_shape": list(p[0]) if p else None,
                "prev_dtype": p[1] if p else None,
                "new_shape": list(n[0]) if n else None,
                "new_dtype": n[1] if n else None,
            })
    return diff


class RetraceSentinel:
    """One armed watcher over a loop's dispatch signatures; its
    :meth:`on_compile` is the engines' ``on_compile`` hook."""

    def __init__(self, name: str = "train", *, journal=None, registry=None):
        self.name = name
        self._journal = journal
        self._lock = threading.Lock()
        self._armed = False
        self._expected_depth = 0
        self._sigs: dict[str, tuple] = {}
        self._dispatched: set[tuple[str, tuple]] = set()
        self._last_change: dict | None = None
        self.compiles = 0  # every capture seen while live
        self.expected_compiles = 0
        self.violations: list[dict] = []
        self._closed = False
        reg = registry if registry is not None else get_registry()
        self._m_compiles = reg.counter(
            "retrace_compiles_total", "backend compiles observed by the retrace sentinel", labels=("loop",)
        )
        self._m_events = reg.counter(
            "retrace_events_total",
            "unexpected recompiles after warmup (each journals a `retrace` event)",
            labels=("loop",),
        )
        self._m_armed = reg.gauge(
            "retrace_armed", "1 once warmup ended and the zero-recompile contract is live", labels=("loop",)
        )
        self._m_armed.labels(loop=name).set(0)

    # -- protocol --------------------------------------------------------

    def note(self, tag: str, tree) -> bool:
        """Record the signature about to be dispatched under ``tag``;
        returns whether ``tag`` had not been noted with it before."""
        sig = _signature(tree)
        with self._lock:
            prev = self._sigs.get(tag)
            if prev is not None and prev != sig:
                self._last_change = {"tag": tag, "prev": prev, "new": sig, "diff": _sig_diff(prev, sig)}
            self._sigs[tag] = sig
            new = (tag, sig) not in self._dispatched
            self._dispatched.add((tag, sig))
        return new

    def dispatch(self, tag: str, tree) -> None:
        """An eager loop's dispatch of ``tree`` under ``tag``: noted, and a
        signature the loop has not dispatched under ``tag`` before counts
        as one compile (``on_compile(tag, leading dimension of the first
        leaf)``), as a jitted step would compile it."""
        if self.note(tag, tree):
            shape = next((leaf.shape for leaf in _leaves(tree) if getattr(leaf, "shape", ())), ())
            self.on_compile(tag, int(shape[0]) if shape else 0)

    def arm(self) -> None:
        with self._lock:
            self._armed = True
            self._last_change = None
        self._m_armed.labels(loop=self.name).set(1)

    def disarm(self) -> None:
        with self._lock:
            self._armed = False
        self._m_armed.labels(loop=self.name).set(0)

    @contextmanager
    def expected(self, reason: str = ""):
        """Captures inside this block are legitimate (a swap, a replica
        restart or a scale-up build)."""
        with self._lock:
            self._expected_depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._expected_depth -= 1

    # -- the engine's hook -------------------------------------------------

    def on_compile(self, task_key: str, bucket: int) -> None:
        """One capture (on the CPU, one first run) of ``(task_key,
        bucket)``."""
        with self._lock:
            if self._closed:
                return
            self.compiles += 1
            armed = self._armed and self._expected_depth == 0
            change = self._last_change
            self._last_change = None
            if armed:
                record = {
                    "loop": self.name,
                    "task": task_key,
                    "bucket": int(bucket),
                    "tag": change["tag"] if change else None,
                    "prev_sig": [list(s) for s in change["prev"]] if change else None,
                    "new_sig": [list(s) for s in change["new"]] if change else None,
                    "diff": change["diff"] if change else None,
                }
                self.violations.append(record)
            else:
                self.expected_compiles += 1
        self._m_compiles.labels(loop=self.name).inc()
        if not armed:
            return
        self._m_events.labels(loop=self.name).inc()
        attribution = (
            f"last signature change: `{record['tag']}` {record['diff']}" if change
            else "no noted signature changed — a bucket the warmup did not capture"
        )
        warnings.warn(
            f"retrace sentinel[{self.name}]: unexpected capture of {task_key}/b{bucket} after warmup. {attribution}",
            RuntimeWarning,
            stacklevel=2,
        )
        journal = self._journal
        if journal is not None:
            try:
                journal.event("retrace", **record)
            except Exception:  # noqa: BLE001 - observability must not kill the loop
                pass

    # -- readout ---------------------------------------------------------

    def summary(self) -> dict:
        with self._lock:
            return {
                "loop": self.name,
                "compiles": self.compiles,
                "expected": self.expected_compiles,
                "violations": len(self.violations),
            }

    def assert_steady(self) -> None:
        """Raise if any unexpected capture happened after ``arm()``."""
        if self.violations:
            first = self.violations[0]
            raise AssertionError(
                f"retrace sentinel[{self.name}]: {len(self.violations)} unexpected capture(s) after warmup; first: "
                f"{first['task']}/b{first['bucket']} tag={first['tag']} diff={first['diff']}"
            )

    def close(self) -> None:
        """Disarm and stop counting (the engines may outlive the loop)."""
        self.disarm()
        with self._lock:
            self._closed = True
