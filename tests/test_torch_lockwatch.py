"""The port's lock watchdog (``obs/lockwatch.py``) against the JAX
package's, on the CPU.

The same acquisition script runs on named threads through both modules
(each with the watchdog on, a fresh default registry and a 50 ms long-hold
threshold): the first-seen order graph, the inversions and the
``lock_*`` counters must be equal, and a long hold is counted. With the
watchdog off ``lock()`` is a plain ``threading.Lock``. The port's
reentrant variant (its engine's replay lock) records a thread's
outermost acquire only. Every module global the tests touch is restored.
"""

import threading
import time
import warnings

import pytest

from jumbo_mae_tpu_tpu.obs import lockwatch as jlw
from jumbo_mae_tpu_tpu.obs import metrics as jmetrics
from jumbo_mae_tpu_tpu_torch.obs import lockwatch as plw
from jumbo_mae_tpu_tpu_torch.obs import metrics as pmetrics

PAIRS = ((jlw, jmetrics), (plw, pmetrics))


@pytest.fixture
def watched(monkeypatch):
    """Both modules on, reset, a 50 ms hold threshold and a fresh default
    registry each; everything restored after."""
    regs = []
    for lw, metrics in PAIRS:
        monkeypatch.setattr(lw, "_enabled", True)
        monkeypatch.setattr(lw, "_hold_threshold_s", 0.05)
        lw.reset()
        reg = metrics.MetricsRegistry()
        prev = metrics.set_registry(reg)
        regs.append((metrics, prev, reg))
    yield [r for _, _, r in regs]
    for (lw, _), (metrics, prev, _) in zip(PAIRS, regs):
        metrics.set_registry(prev)
        lw.reset()


def run_script(lw) -> None:
    """Thread t1 takes a then b (and holds b 80 ms), t2 takes b then a (an
    inversion), t3 takes a then c; one after the other, so nothing
    deadlocks."""
    a, b, c = lw.lock("a"), lw.lock("b"), lw.lock("c")

    def t1():
        with a:
            with b:
                time.sleep(0.08)

    def t2():
        with b:
            with a:
                pass

    def t3():
        with a:
            with c:
                pass

    for name, fn in (("t1", t1), ("t2", t2), ("t3", t3)):
        th = threading.Thread(target=fn, name=name)
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()


def counters(reg) -> dict:
    snap = reg.snapshot()
    out = {name: snap.get(name, {}) for name in
           ("lock_acquire_total", "lock_order_violations_total", "lock_blocking_while_held_total")}
    for name in ("lock_wait_seconds", "lock_hold_seconds"):
        out[name] = {k: v["count"] for k, v in snap.get(name, {}).items()}
    return out


def test_order_graph_inversions_and_counters_equal_jax(watched):
    results = []
    for (lw, _), reg in zip(PAIRS, watched):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run_script(lw)
        results.append((lw.order_edges(), lw.violations(), counters(reg),
                        sum("lock-order inversion" in str(w.message) for w in caught)))
    assert results[0] == results[1]
    edges, violations, c, warned = results[1]
    assert set(edges) == {("a", "b"), ("b", "a"), ("a", "c")}
    assert violations == [{"held": "b", "acquired": "a", "thread": "t2", "reverse_thread": "t1", "reverse_count": 1}]
    assert warned == 1
    assert c["lock_order_violations_total"] == {"": 1.0}
    assert c["lock_acquire_total"] == {"a": 3.0, "b": 2.0, "c": 1.0}
    assert c["lock_blocking_while_held_total"] == {"a": 1.0, "b": 1.0}  # t1 held both over its 80 ms
    assert c["lock_hold_seconds"] == {"a": 3, "b": 2, "c": 1}


def test_journal_gets_one_event_per_inverted_pair(watched):
    for lw, _ in PAIRS:
        events = []

        class Journal:
            def event(self, etype, **fields):
                events.append((etype, fields["held"], fields["acquired"]))

        lw.attach_journal(Journal())
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                run_script(lw)
                run_script(lw)  # the same pair again: counted, not journaled again
        finally:
            lw.attach_journal(None)
        assert events == [("lock_order_violation", "b", "a")]
        assert len(lw.violations()) == 3  # the second run inverts both orders


def test_off_is_a_plain_lock(monkeypatch):
    for lw, _ in PAIRS:
        monkeypatch.setattr(lw, "_enabled", False)
        assert type(lw.lock("x")) is type(threading.Lock())
        assert not lw.enabled()
    assert type(plw.rlock("x")) is type(threading.RLock())
    monkeypatch.setattr(plw, "_enabled", True)
    assert isinstance(plw.lock("x"), plw.WatchedLock) and isinstance(plw.rlock("x"), plw.WatchedRLock)


def test_reentrant_lock_records_the_outermost_acquire(watched):
    r, b = plw.rlock("replay"), plw.lock("b")
    with r:
        with r:  # a nested dispatch: no self-edge, no second acquisition
            with b:
                assert r.locked()
    assert not r.locked()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with b:
            with r:
                pass
    assert set(plw.order_edges()) == {("replay", "b"), ("b", "replay")}
    assert len(plw.violations()) == 1 and len(caught) == 1
    assert counters(watched[1])["lock_acquire_total"] == {"replay": 2.0, "b": 2.0}
