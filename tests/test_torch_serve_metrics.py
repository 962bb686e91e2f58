"""The serving tier's metrics, health hooks, swap memory gate and fault
sites: the port against the JAX package, on the CPU.

- **Metrics parity.** The same scripted traffic, with stand-in engines and
  ``run_fn``s both packages accept, goes through the JAX and the port's
  ``MicroBatcher``, ``ReplicaSet`` and ``ContinuousScheduler``, each on a
  fresh registry: every counter and gauge of the families the two
  packages share (requests, batches, shed, expired, late, aborted,
  failed, crashes, restarts, requeues, preemptions, the breaker, swaps by
  verdict) comes out equal, and the histograms equal in count. The
  scripts gate the stand-ins, so routing and batching are forced.
- **Stats and registry agree.** What the port's ``stats()`` reports is
  the registry's count, on the same traffic.
- **The swap's memory gate**, held to the JAX package's asserted contract
  (``tests/test_replicaset.py``): a double buffer that does not fit is
  rejected at stage ``"headroom"`` before any replica flips, a probe that
  raises does not veto; and the card side refuses, naming the card,
  through a faked ``torch.cuda.mem_get_info``.
- **Fault sites**, with the JAX site names and keys, held to the JAX
  tests' asserted contracts (their harness seeds ``random.Random`` with a
  tuple, which this Python refuses, so they are not run here):
  ``serve.replica`` (a crash, then a restart), ``serve.preempt`` (drained,
  nothing dropped), ``ckpt.load:corrupt`` (rolled back at parity),
  ``serve.submit`` (the submit raises, the others serve).

Every wait is bounded; every pool is closed in a ``finally``.
"""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

import jumbo_mae_tpu_tpu.infer as jinfer
import jumbo_mae_tpu_tpu.serve.scheduler as jsched
import jumbo_mae_tpu_tpu_torch.infer as pinfer
import jumbo_mae_tpu_tpu_torch.serve.scheduler as psched
from jumbo_mae_tpu_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from jumbo_mae_tpu_tpu_torch.faults import clear_plan, install_plan
from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal
from jumbo_mae_tpu_tpu_torch.obs.memwatch import MB, MemoryWatcher
from jumbo_mae_tpu_tpu_torch.obs.metrics import MetricsRegistry
from jumbo_mae_tpu_tpu_torch.obs.reqtrace import AccessLog, RequestTracer
from test_torch_scheduler import Clock, Recorder, random_trace


class StubEngine:
    """A versioned stand-in engine: a swap and a rollback move a value."""

    def __init__(self, idx, version="v0", card_bytes=0):
        self.idx = idx
        self.version = version
        self.card_bytes = card_bytes

    def swap_weights(self, params, batch_stats=None, *, ckpt=""):
        snap = {"version": self.version}
        self.version = params
        return snap

    def restore_snapshot(self, snap):
        self.version = snap["version"]

    def swap_device_bytes(self):
        return self.card_bytes


def img(v=0.0):
    return np.full((2, 2, 3), v, np.float32)


def run_echo(eng, batch, metas):
    return {"y": batch[:, 0, 0, 0].astype(np.float64)}


def until(cond, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.002)


def settle(futs, timeout: float = 10.0) -> list:
    out = []
    for f in futs:
        e = f.exception(timeout=timeout)
        out.append(type(e).__name__ if e is not None else "ok")
    return out


def families(reg, names) -> dict:
    """Counters and gauges by value, histograms by count."""
    snap = reg.snapshot()
    return {n: {k: (v["count"] if isinstance(v, dict) else v) for k, v in snap.get(n, {}).items()} for n in names}


def headers(reg, names) -> list[str]:
    """The ``# HELP`` and ``# TYPE`` lines of ``names`` as rendered: the
    JAX package's text, byte for byte, is the contract."""
    return [ln for ln in reg.render().splitlines() if ln.startswith("#") and ln.split(" ")[2] in names]


REQUEST_FAMILIES = ("infer_requests_total", "infer_batches_total", "infer_requests_shed_total",
                    "infer_deadline_exceeded_total", "infer_requests_late_total", "infer_requests_aborted_total",
                    "infer_request_latency_seconds", "infer_batch_occupancy")
POOL_FAMILIES = REQUEST_FAMILIES + (
    "serve_replica_up", "serve_replica_healthy_count", "serve_replica_quorum", "serve_replica_breaker_open",
    "serve_replica_breaker_trips_total", "serve_replica_crashes_total", "serve_replica_restarts_total",
    "serve_replica_requests_total", "serve_replica_requeued_total", "serve_replica_preempted_total")


# -------------------------------------------------------- the micro-batcher


def batcher_script(pkg: str) -> tuple:
    """A gated run: r0 parks the collector; five more queue behind it, the
    sixth sheds (max_queue 5); one expires in the queue; one batch fails;
    one request finishes late; a close aborts what is still queued."""
    reg = JaxRegistry() if pkg == "jax" else MetricsRegistry()
    cls = jinfer.MicroBatcher if pkg == "jax" else pinfer.MicroBatcher
    gate, slow = threading.Event(), threading.Event()

    def run_fn(batch):
        if batch[0, 0, 0, 0] == 0.0:
            gate.wait(10)
        if np.any(batch[:, 0, 0, 0] < 0):
            raise RuntimeError("bad batch")
        if slow.is_set():
            time.sleep(0.15)
        return batch[:, 0, 0, 0].astype(np.float64)

    mb = cls(run_fn, max_batch=4, max_delay_ms=20.0, max_queue=5, registry=reg)
    futs, shed = [mb.submit(img(0.0))], 0
    try:
        until(lambda: mb.stats()["queue_depth"] == 0)
        time.sleep(0.08)  # past the 20 ms coalescing window: r0 parked alone in run_fn
        futs.append(mb.submit(img(1.0), deadline_ms=1.0))  # expires while queued
        futs += [mb.submit(img(v)) for v in (2.0, 3.0, -1.0, 4.0)]
        try:
            mb.submit(img(9.0))
        except Exception as e:  # noqa: BLE001 - each package's QueueFullError
            shed += type(e).__name__ == "QueueFullError"
        time.sleep(0.01)
        gate.set()
        outcomes = settle(futs)
        slow.set()
        late = mb.submit(img(5.0), deadline_ms=50.0)
        late_out = settle([late])
        slow.clear()
        gate.clear()
        parked = mb.submit(img(0.0))
        until(lambda: mb.stats()["queue_depth"] == 0)
        time.sleep(0.08)  # past the 20 ms coalescing window: parked's batch is in run_fn
        queued = [mb.submit(img(6.0)) for _ in range(2)]
        closer = threading.Thread(target=mb.close)
        closer.start()
        until(lambda: mb._closed)
        gate.set()
        closer.join(timeout=10)
        end = settle([parked] + queued)
    finally:
        gate.set()
        mb.close()
    names = REQUEST_FAMILIES + ("infer_requests_failed_total", "infer_queue_depth")
    return (outcomes, shed, late_out, end), (families(reg, names), headers(reg, names)), mb


def test_microbatcher_counters_equal_jax():
    jax_out, (jax_fams, jax_headers), _ = batcher_script("jax")
    port_out, (port_fams, port_headers), mb = batcher_script("port")
    assert port_out == jax_out and port_headers == jax_headers
    assert port_out[0] == ["ok", "DeadlineExceededError"] + ["RuntimeError"] * 4  # one batch of four failed
    assert port_out[1:] == (1, ["DeadlineExceededError"], ["ok", "ShutdownError", "ShutdownError"])
    assert port_fams == jax_fams
    assert port_fams["infer_requests_aborted_total"] == {"": 2.0}
    assert port_fams["infer_requests_late_total"] == {"": 1.0}
    assert port_fams["infer_requests_shed_total"] == {"": 1.0}
    # the port's stats() reads the registry's counts
    st = mb.stats()
    c = {n: v.get("", 0.0) for n, v in port_fams.items()}
    assert (st["requests_shed"], st["requests_expired"], st["requests_late"], st["requests_aborted"],
            st["requests_failed"], st["requests_served"], st["batches"]) == \
        (c["infer_requests_shed_total"], c["infer_deadline_exceeded_total"], c["infer_requests_late_total"],
         c["infer_requests_aborted_total"], c["infer_requests_failed_total"], c["infer_requests_total"],
         c["infer_batches_total"])


def test_microbatcher_traces_every_outcome_once(tmp_path):
    """The tracer hooks: one access-log row per resolved future, each with
    its outcome, the trace finished before the future resolves.

    The first request's batch is inside ``run_fn`` (an event set there)
    before the others are submitted: with a 1-ms coalescing window, an
    empty queue alone does not say that its batch has closed."""
    log = AccessLog(tmp_path / "acc")
    tracer = RequestTracer(registry=MetricsRegistry(), access_log=log)
    gate, running = threading.Event(), threading.Event()

    def run_fn(batch):
        running.set()
        gate.wait(10)
        if np.any(batch[:, 0, 0, 0] < 0):
            raise RuntimeError("bad batch")
        return batch[:, 0, 0, 0]

    mb = pinfer.MicroBatcher(run_fn, max_batch=2, max_delay_ms=1.0, max_queue=3, registry=MetricsRegistry(),
                             tracer=tracer, task="features")
    try:
        futs = [mb.submit(img(1.0))]
        assert running.wait(10), "the first batch never reached run_fn"
        futs.append(mb.submit(img(2.0), deadline_ms=1.0))
        futs += [mb.submit(img(-1.0)), mb.submit(img(-2.0))]
        with pytest.raises(pinfer.QueueFullError):
            mb.submit(img(3.0))
        time.sleep(0.01)
        gate.set()
        outcomes = settle(futs)
        assert all(hasattr(f, "rid") for f in futs)
    finally:
        gate.set()
        mb.close()
    tracer.close()
    rows = {r["rid"]: r for r in read_journal(log.path) if r.get("type") == "request"}
    assert len(rows) == 5
    assert [rows[f.rid]["outcome"] for f in futs] == ["ok", "deadline", "aborted", "aborted"]
    assert outcomes == ["ok", "DeadlineExceededError", "RuntimeError", "RuntimeError"]
    assert sorted(r["outcome"] for r in rows.values()).count("shed") == 1
    assert rows[futs[0].rid]["task"] == "features" and rows[futs[0].rid]["compute_ms"] is not None


# ----------------------------------------------------------------- the pool


def pool(pkg: str, run=run_echo, provider=None, **kw):
    reg = JaxRegistry() if pkg == "jax" else MetricsRegistry()
    cls = jinfer.ReplicaSet if pkg == "jax" else pinfer.ReplicaSet
    kw.setdefault("replicas", 2)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_delay_ms", 1.0)
    kw.setdefault("supervise_interval_s", 0.02)
    return cls(provider or (lambda i: StubEngine(i)), run, registry=reg, **kw), reg


def busy(rs, idx: int = 0) -> bool:
    return rs.replica(idx).busy_since is not None


def scen_crash(pkg):
    """r1 always raises: X parks r0, Y queues on r0, Z routes to r1,
    crashes and is requeued onto r0; the breaker opens (quorum 2)."""
    gate = threading.Event()

    def run(eng, batch, metas):
        if eng.idx == 1:
            raise RuntimeError("boom")
        gate.wait(10)
        return run_echo(eng, batch, metas)

    rs, reg = pool(pkg, run, restart_backoff_s=30.0)
    try:
        futs = [rs.submit(img(1.0))]
        until(lambda: busy(rs))
        futs += [rs.submit(img(2.0)), rs.submit(img(3.0))]
        until(lambda: rs.stats()["replicas"]["r1"]["state"] == "down")
        gate.set()
        out = settle(futs)
    finally:
        gate.set()
        rs.close()
    return out, rs, reg


def scen_terminal(pkg):
    """Every flush raises: retries exhausted (max_retries 0)."""
    def run(eng, batch, metas):
        raise RuntimeError("always")

    rs, reg = pool(pkg, run, max_retries=0, restart_backoff_s=30.0)
    try:
        out = settle([rs.submit(img(1.0))])
    finally:
        rs.close()
    return out, rs, reg


def scen_breaker(pkg):
    well, gate = threading.Event(), threading.Event()

    def run(eng, batch, metas):
        if eng.idx == 0:
            gate.wait(10)
        if eng.idx == 1 and not well.is_set():
            raise RuntimeError("r1 sick")
        return run_echo(eng, batch, metas)

    rs, reg = pool(pkg, run, quorum=2, restart_backoff_s=0.3)
    try:
        futs = [rs.submit(img(1.0))]
        until(lambda: busy(rs))
        futs += [rs.submit(img(2.0)), rs.submit(img(3.0))]
        until(rs.degraded, 5.0)
        well.set()
        gate.set()
        until(lambda: not rs.degraded() and rs.generation(1) == 1)
        out = settle(futs)
    finally:
        gate.set()
        rs.close()
    return out, rs, reg


def scen_shed_deadline_late(pkg):
    """One replica, max_batch 1, max_queue 3: parked on a gate, two queue
    (one expires there), the fourth sheds; then a late one."""
    gate, slow = threading.Event(), threading.Event()

    def run(eng, batch, metas):
        gate.wait(10)
        if slow.is_set():
            time.sleep(0.15)
        return run_echo(eng, batch, metas)

    rs, reg = pool(pkg, run, replicas=1, max_batch=1, max_queue=3)
    try:
        futs = [rs.submit(img(1.0))]
        until(lambda: busy(rs))
        futs += [rs.submit(img(2.0), deadline_ms=1.0), rs.submit(img(3.0))]
        shed = 0
        for _ in range(2):
            try:
                rs.submit(img(4.0))
            except Exception as e:  # noqa: BLE001 - each package's QueueFullError
                shed += type(e).__name__ == "QueueFullError"
        time.sleep(0.01)
        gate.set()
        out = settle(futs)
        slow.set()
        out += settle([rs.submit(img(5.0), deadline_ms=50.0)])
    finally:
        gate.set()
        rs.close()
    return (out, shed), rs, reg


def scen_group(pkg):
    gate = threading.Event()

    def run(eng, batch, metas):
        gate.wait(10)
        return {"y": np.array([float(np.asarray(b)[0, 0, 0]) for b in batch])}

    rs, reg = pool(pkg, run, replicas=1, max_batch=16)
    try:
        now = time.monotonic()
        futs = [rs.submit(img(9.0))]
        until(lambda: busy(rs))
        for v, k in ((1.0, 2), (2.0, 3)):
            items = [(img(v), now + 30.0, None) for _ in range(k)]
            futs += rs.submit_group([(*it, None) for it in items] if pkg == "jax" else items)
        gate.set()
        out = settle(futs)
    finally:
        gate.set()
        rs.close()
    return out, rs, reg


def scen_preempt(pkg):
    rs, reg = pool(pkg, restart_backoff_s=0.05)
    try:
        futs = [rs.submit(img(float(i))) for i in range(8)]
        out = settle(futs)
        ok = rs.preempt(1)
        until(lambda: rs.stats()["replicas"]["r1"]["state"] == "up" and rs.generation(1) == 1)
    finally:
        rs.close()
    return (out, ok), rs, reg


def scen_scale(pkg):
    rs, reg = pool(pkg)
    try:
        up = rs.scale_to(3)
        out = settle([rs.submit(img(float(i))) for i in range(6)])
        down = rs.scale_to(1)
        out += settle([rs.submit(img(7.0))])
    finally:
        rs.close()
    return (out, up["added"], down["removed"]), rs, reg


# scenario -> the families whose values the script forces (batching under
# a 1 ms coalescing window is the host's timing where the script does not
# gate it: those scenarios compare what does not depend on it)
UNGATED = ("infer_batches_total", "infer_batch_occupancy", "serve_replica_requests_total")
SCENARIOS = {
    "crash": (scen_crash, POOL_FAMILIES),
    "terminal": (scen_terminal, POOL_FAMILIES),
    "breaker": (scen_breaker, POOL_FAMILIES),
    "shed_deadline_late": (scen_shed_deadline_late, POOL_FAMILIES),
    "group": (scen_group, POOL_FAMILIES),
    "preempt": (scen_preempt, tuple(f for f in POOL_FAMILIES if f not in UNGATED)),
    "scale": (scen_scale, tuple(f for f in POOL_FAMILIES if f not in UNGATED)),
}


def stats_agree(rs, reg) -> None:
    """The port's stats() against its registry, on the same traffic."""
    st = rs.stats()
    c = reg.snapshot()
    one = lambda n: c[n].get("", 0.0)  # noqa: E731
    assert st["requests_shed"] == one("infer_requests_shed_total")
    assert st["requests_expired"] == one("infer_deadline_exceeded_total")
    assert st["requests_late"] == one("infer_requests_late_total")
    assert st["requests_aborted"] == one("infer_requests_aborted_total")
    assert st["batches_flushed"] == one("infer_batches_total")
    assert st["breaker_trips"] == one("serve_replica_breaker_trips_total")
    assert st["healthy"] == one("serve_replica_healthy_count") and st["quorum"] == one("serve_replica_quorum")
    for name, r in st["replicas"].items():
        assert r.get("requeued", 0) == c["serve_replica_requeued_total"].get(name, 0.0)
        assert r.get("preempted", 0) == c["serve_replica_preempted_total"].get(name, 0.0)
        assert r.get("restarted", 0) == c["serve_replica_restarts_total"].get(name, 0.0)
        for kind in ("crash", "hang", "restart_error"):
            assert r.get(f"crashes_{kind}", 0) == c["serve_replica_crashes_total"].get(f"{name},{kind}", 0.0)
        assert (r["state"] in ("up", "paused")) == (c["serve_replica_up"][name] == 1.0)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pool_metrics_equal_jax(name):
    scenario, fams = SCENARIOS[name]
    jax_out, _, jreg = scenario("jax")
    port_out, rs, preg = scenario("port")
    assert port_out == jax_out
    assert families(preg, fams) == families(jreg, fams)
    assert headers(preg, fams) == headers(jreg, fams)
    stats_agree(rs, preg)


def test_pool_metrics_name_what_happened():
    out, rs, reg = scen_crash("port")
    assert out == ["ok", "ok", "ok"]
    f = families(reg, POOL_FAMILIES)
    assert f["serve_replica_crashes_total"] == {"r1,crash": 1.0}
    assert f["serve_replica_requeued_total"] == {"r1": 1.0}
    assert f["serve_replica_up"] == {"r0": 1.0, "r1": 0.0}
    assert f["serve_replica_breaker_open"] == {"": 1.0} and f["serve_replica_breaker_trips_total"] == {"": 1.0}
    assert f["infer_requests_total"] == {"": 4.0} and f["serve_replica_requests_total"] == {"r0": 3.0}
    (out, ok), rs, reg = scen_preempt("port")
    assert ok and out == ["ok"] * 8
    f = families(reg, POOL_FAMILIES)
    assert f["serve_replica_preempted_total"] == {"r0": 0.0, "r1": 1.0}
    assert f["serve_replica_restarts_total"] == {"r1": 1.0} and f["serve_replica_crashes_total"] == {}


def test_pool_health_beats_and_replicas_probe():
    from jumbo_mae_tpu_tpu_torch.obs.exporter import HealthState

    health = HealthState(ready=True)
    rs, _ = pool("port", health=health)
    try:
        health.watch("replica.r0", 30.0)
        health.watch("replica.r1", 30.0)
        ok, body = health.report()
        assert ok and body["info"]["replicas"]["replicas"]["r0"]["state"] == "up"  # beaten at construction
        before = health._beats["replica.r0"]
        rs.submit(img(1.0)).result(timeout=10)
        until(lambda: health._beats["replica.r0"] > before or health._beats["replica.r1"] > before)
        health.degraded_when(rs.degraded)
        assert health.report()[1]["degraded"] is False
    finally:
        rs.close()


# ------------------------------------------------------------ the scheduler


SCHED_FAMILIES = ("serve_sched_batches_total", "serve_sched_batch_occupancy", "serve_sched_priority_jumps_total")


def simulate_metrics(pkg: str, trace: list, **kw) -> tuple:
    """``test_torch_scheduler``'s scripted trace on an injected clock, each
    scheduler on a fresh registry; the groups, expiries, metrics and the
    port's stats."""
    mod = jsched if pkg == "jax" else psched
    reg = JaxRegistry() if pkg == "jax" else MetricsRegistry()
    clock, rec = Clock(), Recorder()
    sched = mod.ContinuousScheduler(rec, clock=clock, registry=reg, **kw)
    buckets: dict = {}
    try:
        for dt_ms, arrivals in trace:
            clock.t += dt_ms / 1000.0
            for rid, task, shape, tclass, deadline_ms, tokens in arrivals:
                deadline = None if deadline_ms is None else clock.t + deadline_ms / 1000.0
                args = (np.zeros(shape, np.uint8), Future()) + ((None,) if pkg == "jax" else ())
                e = mod._Entry(*args, None, tclass, deadline, rid, task, clock.t, tokens)
                buckets.setdefault(sched._key(e), []).append(e)
                with sched._depth_lock:
                    sched._depth += 1
            sched._expire(buckets)
            sched._dispatch_ready(buckets)
    finally:
        sched.close()
    names = SCHED_FAMILIES + ("serve_sched_queue_depth",)
    return rec.groups, (families(reg, SCHED_FAMILIES), headers(reg, names)), \
        reg.snapshot()["serve_sched_batch_occupancy"], sched


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_scheduler_metrics_equal_jax(seed, packed):
    trace = random_trace(seed, packed=packed)
    kw = dict(max_batch=4, max_delay_ms=10.0)
    if packed:
        kw = dict(max_batch=32, max_delay_ms=10.0, packed=True, token_budget=160, seq_len_fn=lambda a: a.shape[0])
    jg, (jf, jh), jocc, _ = simulate_metrics("jax", trace, **kw)
    pg, (pf, ph), pocc, sched = simulate_metrics("port", trace, **kw)
    assert pg == jg and pf == jf and ph == jh
    assert {k: v["count"] for k, v in pocc.items()} == {k: v["count"] for k, v in jocc.items()}
    assert pf["serve_sched_batches_total"] and sum(pf["serve_sched_batches_total"].values()) == len(pg)
    st = sched.stats()
    assert st["batches_by_reason"] == {k: int(v) for k, v in pf["serve_sched_batches_total"].items()}
    assert st["priority_jumps"] == pf["serve_sched_priority_jumps_total"].get("", 0.0)


# -------------------------------------------------------------- the swap


def swap_rig(pkg: str, *, restore_fn=None, features=None, provider=None, **ctl_kw):
    rs, reg = pool(pkg, lambda eng, batch, metas: {"y": np.zeros(len(batch))}, replicas=3,
                   provider=provider)

    def default_features(eng, images):
        f = np.ones((len(images), 8))
        if isinstance(eng.version, str) and "bad" in eng.version:
            f[:, ::2] = -1.0  # the direction flips: the cosine collapses
        return f

    cls = jinfer.WeightSwapController if pkg == "jax" else pinfer.WeightSwapController
    ctl = cls(rs, restore_fn=restore_fn or (lambda p: (p.rsplit("/", 1)[-1], None)),
              features_fn=features or default_features, parity_images=np.zeros((4, 2, 2, 3), np.uint8),
              canary_requests=0, canary_timeout_s=1.0, registry=reg, **ctl_kw)
    return rs, ctl, reg


SWAP_FAMILIES = ("serve_swap_attempts_total", "serve_swap_promoted_total", "serve_swap_rejected_total",
                 "serve_swap_rollbacks_total", "serve_swap_active", "serve_swap_parity_cosine")


def missing(path):
    raise FileNotFoundError(path)


def test_swap_metrics_equal_jax():
    out = []
    for pkg in ("jax", "port"):
        rs, ctl, reg = swap_rig(pkg, restore_fn=lambda p: missing(p) if "missing" in p else (p.rsplit("/", 1)[-1], None))
        try:
            reps = [ctl.swap(p) for p in ("/push/v1", "/push/vbad", "/push/missing")]
            versions = [rs.replica(i).engine.version for i in range(3)]
        finally:
            rs.close()
        out.append(([(r["verdict"], r["stage"]) for r in reps], versions, families(reg, SWAP_FAMILIES),
                    headers(reg, SWAP_FAMILIES + ("serve_swap_canary_burn",))))
    assert out[0] == out[1]
    assert out[1][0] == [("promoted", "promote"), ("rolled_back", "parity"), ("rejected", "restore")]
    assert out[1][2]["serve_swap_attempts_total"] == {"": 3.0} and out[1][2]["serve_swap_active"] == {"": 0.0}


def test_swap_headroom_rejection():
    """The JAX contract: a push whose double buffer (the new tree and the
    rollback snapshot) does not fit is rejected before any parity probe,
    canary pick or flip; a probe that raises does not veto."""
    calls = []

    def tight(need, card):
        calls.append((need, card))
        return "needs 512 KiB but only 1 KiB of host memory is safely available"

    params = {"w": np.zeros((256, 256), np.float32)}
    rs, ctl, reg = swap_rig("port", restore_fn=lambda p: (params, None), headroom_fn=tight)
    try:
        rep = ctl.swap("/push/v1")
        assert rep["verdict"] == "rejected" and rep["stage"] == "headroom" and "512 KiB" in rep["error"]
        assert calls == [(2 * 256 * 256 * 4, 0)]  # the double-buffered tree's bytes; stand-ins hold no card
        assert [rs.replica(i).engine.version for i in range(3)] == ["v0"] * 3
        assert reg.snapshot()["serve_swap_rejected_total"] == {"": 1.0}
    finally:
        rs.close()
    rs2, ctl2, _ = swap_rig("port", headroom_fn=lambda need, card: 1 / 0)
    try:
        assert ctl2.swap("/push/v1")["verdict"] == "promoted"
    finally:
        rs2.close()


def test_swap_card_headroom_refusal_names_the_card(monkeypatch):
    """The port's swap builds each served model aside on the card: the
    gate holds those bytes against the card's free memory
    (``torch.cuda.mem_get_info``, faked to 300 MiB free), and refuses
    naming the card; nothing flips and the pool keeps serving."""
    import torch

    from jumbo_mae_tpu_tpu_torch.obs import memwatch

    monkeypatch.setattr(memwatch, "host_available_bytes", lambda: 64 * 1024 * MB)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (300 * MB, 80 * 1024 * MB))
    watcher = MemoryWatcher(registry=MetricsRegistry(), device="cuda:0")
    rs, ctl, reg = swap_rig("port", headroom_fn=watcher.headroom_check,
                            provider=lambda i: StubEngine(i, card_bytes=512 * MB))
    try:
        rep = ctl.swap("/push/v1")
        assert (rep["verdict"], rep["stage"]) == ("rejected", "headroom")
        assert "512 MiB" in rep["error"] and "card memory on cuda:0" in rep["error"]
        assert [rs.replica(i).engine.version for i in range(3)] == ["v0"] * 3
        assert rs.submit(img(1.0)).result(timeout=10) is not None
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (2048 * MB, 80 * 1024 * MB))
        assert ctl.swap("/push/v2")["verdict"] == "promoted"  # room again: the same gate passes
        assert [rs.replica(i).engine.version for i in range(3)] == ["v2"] * 3
    finally:
        rs.close()


# -------------------------------------------------------------- fault sites


@pytest.fixture
def fault_plan():
    yield install_plan
    clear_plan()


def test_serve_replica_fault_crashes_then_restarts(fault_plan):
    """``serve.replica:raise@key~r1,n<1``: r1's first flush crashes, its
    request is requeued onto r0 and every future resolves once, ok; the
    supervisor restarts r1, whose next flush serves.

    The first request is inside r0's ``run`` (an event set there) before
    the next two are submitted, so the router sees r0 holding it and an
    empty queue on each replica: the second queues on r0, the third goes
    to r1."""
    fault_plan("serve.replica:raise(RuntimeError)@key~r1,n<1")
    gate, r0_running = threading.Event(), threading.Event()

    def run(eng, batch, metas):
        if eng.idx == 0:
            r0_running.set()
            gate.wait(10)
        return run_echo(eng, batch, metas)

    rs, reg = pool("port", run, restart_backoff_s=0.05)
    try:
        futs = [rs.submit(img(1.0))]
        assert r0_running.wait(10), "r0 never ran the first batch"
        assert busy(rs)
        futs += [rs.submit(img(2.0)), rs.submit(img(3.0))]
        until(lambda: reg.snapshot().get("serve_replica_crashes_total", {}).get("r1,crash") == 1.0)
        gate.set()
        assert settle(futs) == ["ok"] * 3
        assert [f.replica for f in futs] == ["r0"] * 3 and futs[2].requeued_from == "r1"
        # the restart thread counts the restart after it puts the new r1 in
        # its slot: wait for the count too, or a fast request can beat it
        until(lambda: rs.generation(1) == 1 and rs.stats()["replicas"]["r1"]["state"] == "up"
              and reg.snapshot().get("serve_replica_restarts_total", {}).get("r1") == 1.0)
        rs.pause(0)
        f = rs.submit(img(4.0))
        assert f.result(timeout=10)["y"] == 4.0 and f.replica == "r1"
        snap = reg.snapshot()
        assert snap["serve_replica_restarts_total"] == {"r1": 1.0}
        assert snap["serve_replica_requeued_total"] == {"r1": 1.0}
    finally:
        gate.set()
        rs.close()


def test_serve_preempt_fault_drains_via_the_supervisor(fault_plan, tmp_path):
    """``serve.preempt:raise@n=1`` fires at the supervisor's second site
    visit (r1 on the first pass): r1 drains as a manual preempt would,
    nothing dropped, and the log names the preemption."""
    log = AccessLog(tmp_path / "access")
    tracer = RequestTracer(registry=MetricsRegistry(), access_log=log)
    fault_plan("serve.preempt:raise@n=1")
    rs, reg = pool("port", tracer=tracer, restart_backoff_s=0.05)
    try:
        futs = [rs.submit(img(float(i))) for i in range(30)]
        assert settle(futs) == ["ok"] * 30
        until(lambda: reg.snapshot()["serve_replica_preempted_total"].get("r1") == 1.0)
        until(lambda: rs.generation(1) == 1)
    finally:
        rs.close()
        tracer.close()
    events = [e["type"] for e in read_journal(log.path)]
    assert "replica_preempted" in events and "replica_crash" not in events


def test_ckpt_load_corrupt_rolls_the_swap_back(fault_plan):
    """``ckpt.load:corrupt`` perturbs the restored tree; the parity gate
    catches it (the stand-in's features read the tree)."""
    fault_plan("ckpt.load:corrupt(4)")

    def features(eng, images):
        v = eng.version
        if isinstance(v, dict):
            return np.tile(np.asarray(v["w.kernel"], np.float64).reshape(-1), (len(images), 1))
        return np.ones((len(images), 8))

    rs, ctl, reg = swap_rig("port", restore_fn=lambda p: ({"w.kernel": np.ones((4, 2), np.float32)}, None),
                            features=features)
    try:
        rep = ctl.swap("/push/corrupt")
        assert (rep["verdict"], rep["stage"]) == ("rolled_back", "parity")
        assert reg.snapshot()["serve_swap_rollbacks_total"] == {"": 1.0}
        assert [rs.replica(i).engine.version for i in range(3)] == ["v0"] * 3
    finally:
        rs.close()


def test_serve_submit_fault_site(fault_plan):
    """``serve.submit:raise@n=1``: the second submit raises, in the
    micro-batcher (the JAX chaos test's contract), the pool and the
    scheduler; the others serve."""
    fault_plan("serve.submit:raise(RuntimeError)@n=1")
    with pinfer.MicroBatcher(lambda b: b.sum(axis=(1, 2, 3)), max_batch=2, max_delay_ms=1.0,
                             registry=MetricsRegistry()) as mb:
        f = mb.submit(np.ones((2, 2, 1)))
        with pytest.raises(RuntimeError, match="fault injected"):
            mb.submit(np.ones((2, 2, 1)))
        assert f.result(timeout=5) == 4.0
    for make in ("pool", "sched"):
        fault_plan("serve.submit:raise(RuntimeError)@n=1")
        rs, _ = pool("port", replicas=1)
        front = rs if make == "pool" else psched.ContinuousScheduler(rs.submit_group, max_batch=2, max_delay_ms=1.0,
                                                                     registry=MetricsRegistry())
        try:
            f = front.submit(img(4.0))
            with pytest.raises(RuntimeError, match="fault injected"):
                front.submit(img(5.0))
            assert f.result(timeout=10)["y"] == 4.0
        finally:
            if front is not rs:
                front.close()
            rs.close()


# --------------------------------------------------------------- the engine


ENGINE_FAMILIES = ("infer_images_total", "infer_predict_seconds", "infer_bucket_cache_hits_total",
                   "infer_bucket_cache_misses_total", "infer_compile_seconds", "infer_pad_fraction",
                   "infer_encoder_cache_events_total", "infer_encoder_cache_bytes", "serve_pack_token_pad_fraction",
                   "serve_pack_segments_per_dispatch", "serve_pack_budget_occupancy", "serve_pack_dispatches_total",
                   "serve_pack_parity_min", "serve_pack_parity_failures_total")


def engine_traffic(eng) -> None:
    from test_torch_packed_model import images

    imgs = np.stack(images((32,) * 6, seed=3))
    eng.warmup(("features",), buckets=(1, 2))
    eng.features(imgs[:1])
    eng.features(imgs[:3])  # bucket 4: a miss
    eng.features(imgs[:6])  # chunks of 4 and 2
    for _ in range(2):  # the encoder cache: two misses, then two hits
        eng.reconstruct(imgs[:2], seed=1)
    eng.reconstruct(imgs[1:5], seed=1)  # past its 4 entries: an eviction
    eng.predict_packed(images((32, 24, 16), seed=4))
    eng.packed_parity(images((32, 16), seed=5))


def test_engine_metrics_equal_jax():
    """Both engines (the smoke recipe in float32, an 11-way head, a 4-entry
    encoder cache) serve the same calls: the counts of every engine family
    and the packed path's values are equal; the compile keys alike. The
    warm-start gauge is set by the warmup."""
    from jumbo_mae_tpu_tpu.config import load_config as jax_load_config
    from jumbo_mae_tpu_tpu.infer import InferenceEngine as JaxEngine
    from jumbo_mae_tpu_tpu_torch.config import load_config
    from test_torch_packed_model import OVERRIDES, RECIPE

    jreg, preg = JaxRegistry(), MetricsRegistry()
    kw = dict(max_batch=4, max_tokens=512, labels=11, encoder_cache=4)
    jeng = JaxEngine(jax_load_config(RECIPE, OVERRIDES), warm_cache=False, registry=jreg, **kw)
    peng = pinfer.InferenceEngine(load_config(RECIPE, OVERRIDES), warm_cache=False, registry=preg, device="cpu", **kw)
    engine_traffic(jeng)
    engine_traffic(peng)
    got, want = families(preg, ENGINE_FAMILIES), families(jreg, ENGINE_FAMILIES)
    named = ENGINE_FAMILIES + ("infer_bucket_compile_seconds", "infer_warm_start_seconds", "infer_compile_seconds")
    assert headers(preg, named) == headers(jreg, named)
    cos = ("serve_pack_parity_min",)
    assert {k: v for k, v in got.items() if k not in cos} == {k: v for k, v in want.items() if k not in cos}
    assert got["serve_pack_parity_min"][""] == pytest.approx(want["serve_pack_parity_min"][""], abs=1e-6)
    assert got["infer_encoder_cache_events_total"] == {"hit": 3.0, "miss": 5.0, "evict": 1.0}
    bucket_keys = lambda reg: set(reg.snapshot()["infer_bucket_compile_seconds"])  # noqa: E731
    assert bucket_keys(preg) == bucket_keys(jreg)
    assert preg.gauge("infer_warm_start_seconds").value > 0
    # the memory watcher's probes: no graph pool on the CPU, a predicted
    # peak per captured key only where one is known (none without a card)
    assert peng.executable_cache_bytes() == 0 and peng.predicted_peak_hbm() == {}
    assert peng.swap_device_bytes() == 0


def test_quant_compression_and_parity_gauges_equal_jax():
    from jumbo_mae_tpu_tpu.config import load_config as jax_load_config
    from jumbo_mae_tpu_tpu.infer import InferenceEngine as JaxEngine
    from jumbo_mae_tpu_tpu.infer.quant import parity_report as jax_parity
    from jumbo_mae_tpu_tpu_torch.config import load_config
    from jumbo_mae_tpu_tpu_torch.infer.quant import parity_report
    from test_torch_packed_model import OVERRIDES, RECIPE

    imgs = np.random.default_rng(2).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    out = []
    for make, cfg, reg, parity in (
        (JaxEngine, jax_load_config(RECIPE, OVERRIDES), JaxRegistry(), jax_parity),
        (pinfer.InferenceEngine, load_config(RECIPE, OVERRIDES), MetricsRegistry(), parity_report),
    ):
        extra = {} if make is JaxEngine else {"device": "cpu"}
        ref = make(cfg, max_batch=4, warm_cache=False, registry=reg, **extra)
        q = make(cfg, max_batch=4, warm_cache=False, registry=reg, quant="int8", **extra)
        rep = parity(ref, q, imgs, registry=reg)
        snap = reg.snapshot()
        out.append((snap["infer_quant_compression"], sorted(snap["infer_quant_parity"]), rep["within_tolerance"]))
    assert out[0][1:] == out[1][1:] and set(out[0][0]) == set(out[1][0]) == {"features"}
    assert out[1][0]["features"] == pytest.approx(out[0][0]["features"], rel=2e-2)
