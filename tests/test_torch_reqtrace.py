"""The port's request tracer and access log (``obs/reqtrace.py``) against
the JAX package's, on the CPU:

- the same begin/admitted/flush/finish sequence (every outcome, with and
  without an engine breakdown, tenants, tokens, the meter's stamps and a
  requeue trail) gives access-log rows whose keys and non-time values
  equal JAX's, the same ``request_*`` histogram counts, and the same
  non-request events;
- the pool and scheduler trace what they touch: a replicated pool
  behind the continuous scheduler writes one row per request with its
  replica, tenant and class, shed rows carry the typed shed's name, a
  preemption is journaled as ``replica_preempted`` (the count ``cli.batch``
  reads as ``replica_preemptions``, equal to the pool's), and both
  packages' pools give the same rows for the same scripted traffic.
"""

import time
from concurrent.futures import wait

import numpy as np
import pytest

from jumbo_mae_tpu_tpu.infer.replicaset import ReplicaSet as JaxReplicaSet
from jumbo_mae_tpu_tpu.obs.journal import read_journal as jax_read_journal
from jumbo_mae_tpu_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from jumbo_mae_tpu_tpu.obs.reqtrace import AccessLog as JaxAccessLog
from jumbo_mae_tpu_tpu.obs.reqtrace import RequestTracer as JaxTracer
from jumbo_mae_tpu_tpu_torch.infer.replicaset import ReplicaSet
from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal
from jumbo_mae_tpu_tpu_torch.obs.metrics import MetricsRegistry
from jumbo_mae_tpu_tpu_torch.obs.reqtrace import OUTCOMES, AccessLog, RequestTracer
from jumbo_mae_tpu_tpu_torch.serve import AdmissionController, ContinuousScheduler, TenantSpec

# wall/perf-clock columns: equal only in their presence
TIME_KEYS = {"ts", "lat_ms", "queue_wait_ms", "admission_ms"}


def script(tracer, rng_seed: int) -> None:
    """A fixed trace sequence: requests through every outcome, batches with
    and without a breakdown, packed tokens, meter stamps and requeues."""
    rng = np.random.default_rng(rng_seed)
    breakdowns = [None, {"compute_s": 0.004, "fetch_s": 0.0005, "bucket": 8, "pad_fraction": 0.25},
                  {"compute_s": 0.0125, "fetch_s": 0.001, "bucket": 64, "pad_fraction": 0.0}]
    for b in range(6):
        n = int(rng.integers(1, 5))
        traces = [tracer.begin(task=["features", "logits", ""][b % 3], deadline_ms=[None, 250.0][b % 2],
                               tenant=["web", "scrape", None][(b + i) % 3],
                               tclass=["interactive", "batch", None][(b + i) % 3]) for i in range(n)]
        for tr in traces:
            tracer.admitted(tr)
        tracer.flush_begin(traces)
        bd = breakdowns[b % 3]
        tracer.flush_end(traces, run_s=0.01 * (b + 1), batch=n, breakdown=(lambda bd=bd: bd) if bd else None)
        for i, tr in enumerate(traces):
            if b % 2:
                tr.tokens = 52 + 16 * i
            tr.device_s = 0.002 * (i + 1)
            tr.cost_flops = 1e9 * (i + 1) if i % 2 == 0 else None
            tr.replica_id = f"r{i % 2}"
            tr.retries = i % 3
            tr.requeued_from = "r1" if i % 3 else None
            outcome = OUTCOMES[(b + i) % len(OUTCOMES)]
            tracer.finish(tr, outcome, error="RuntimeError: boom" if outcome == "aborted" else None)
    # never admitted: a shed with its typed reason, a shutdown
    tracer.finish(tracer.begin(task="features", tenant="scrape", tclass="batch"), "shed", error="TenantBudgetError")
    tracer.finish(tracer.begin(task="features"), "shutdown")
    tracer.event("autoscale", direction="up", current=1, target=2)


def rows_of(events) -> list[dict]:
    return [{k: v for k, v in e.items() if k not in TIME_KEYS} for e in events]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_access_log_rows_equal_jax(tmp_path, seed):
    preg, jreg = MetricsRegistry(), JaxRegistry()
    plog, jlog = AccessLog(tmp_path / "port"), JaxAccessLog(tmp_path / "jax")
    port, ref = RequestTracer(registry=preg, access_log=plog), JaxTracer(registry=jreg, access_log=jlog)
    script(port, seed)
    script(ref, seed)
    port.close()
    ref.close()
    got, want = read_journal(tmp_path / "port"), jax_read_journal(tmp_path / "jax")
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert TIME_KEYS & g.keys() == TIME_KEYS & w.keys()
    assert rows_of(got) == rows_of(want)
    for name in ("request_latency_seconds", "request_queue_wait_seconds", "request_compute_seconds",
                 "request_fetch_seconds", "request_pad_fraction", "request_admission_seconds"):
        pc = {k: v["count"] for k, v in preg.snapshot()[name].items()}
        jc = {k: v["count"] for k, v in jreg.snapshot()[name].items()}
        assert pc == jc, name
    assert preg.snapshot()["request_outcomes_total"] == jreg.snapshot()["request_outcomes_total"]


class Stub:
    """An engine stand-in: one row per image, its first pixel."""

    def __init__(self, idx):
        self.idx = idx


def run_stub(engine, batch, metas):
    return {"y": np.array([float(np.asarray(b)[0, 0, 0]) for b in batch])}


def pool(pkg: str, tracer, **kw):
    cls = JaxReplicaSet if pkg == "jax" else ReplicaSet
    extra = {"registry": JaxRegistry()} if pkg == "jax" else {}
    return cls(Stub, run_stub, tracer=tracer, task="features", max_batch=1, max_delay_ms=0.0, **extra, **kw)


def img(v: float) -> np.ndarray:
    return np.full((4, 4, 3), v, np.float32)


@pytest.mark.parametrize("replicas", [1, 2])
def test_pool_rows_equal_jax(tmp_path, replicas):
    """One request at a time through each package's pool: the same rows
    (outcome, task, batch, replica, tenant, class, deadline)."""
    rows = {}
    for pkg in ("port", "jax"):
        log_cls, tr_cls, reg = ((AccessLog, RequestTracer, MetricsRegistry()) if pkg == "port"
                                else (JaxAccessLog, JaxTracer, JaxRegistry()))
        tracer = tr_cls(registry=reg, access_log=log_cls(tmp_path / pkg))
        rs = pool(pkg, tracer, replicas=replicas)
        try:
            for i in range(6):
                fut = rs.submit(img(float(i)), deadline_ms=[None, 5000.0][i % 2],
                                tenant=["web", "scrape"][i % 2], tclass=["interactive", "batch"][i % 2])
                assert fut.result(timeout=10)["y"] == float(i) and fut.rid == i
        finally:
            rs.close()
            tracer.close()
        reader = read_journal if pkg == "port" else jax_read_journal
        rows[pkg] = [{k: v for k, v in r.items() if k not in TIME_KEYS | {"compute_ms", "replica"}}
                     for r in reader(tmp_path / pkg) if r["type"] == "request"]
    assert rows["port"] == rows["jax"] and len(rows["port"]) == 6
    assert all(r["outcome"] == "ok" and r["batch"] == 1 and r["task"] == "features" for r in rows["port"])


def test_scheduler_and_pool_trace_every_request(tmp_path):
    """Behind admission and the continuous scheduler: one row per request,
    its replica and tenant; a shed row names the typed shed; a preemption
    is journaled, and the journal's count equals the pool's."""
    tracer = RequestTracer(registry=MetricsRegistry(), access_log=AccessLog(tmp_path / "acc"))
    rs = ReplicaSet(Stub, run_stub, replicas=2, max_batch=4, max_delay_ms=1.0, tracer=tracer, task="features",
                    restart_backoff_s=0.01)
    specs = [TenantSpec("web", "interactive"), TenantSpec("scrape", "batch", rate=1.0, burst=2.0)]
    adm = AdmissionController(specs, registry=MetricsRegistry())
    sched = ContinuousScheduler(rs.submit_group, max_batch=4, max_delay_ms=2.0, admission=adm, tracer=tracer,
                                task="features")
    futs, shed = [], 0
    try:
        for i in range(12):
            try:
                futs.append(sched.submit(img(float(i)), tenant=["web", "scrape"][i % 2]))
            except Exception as e:  # noqa: BLE001 - the quota shed
                assert type(e).__name__ == "TenantQuotaError"
                shed += 1
        done, _ = wait(futs, timeout=10)
        assert len(done) == len(futs) == 8 and shed == 4
        assert rs.preempt(1, drain_timeout_s=5.0)
        deadline = time.monotonic() + 10
        while rs.stats()["replicas"]["r1"]["state"] != "up":
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert rs.preempt(0, drain_timeout_s=5.0)
    finally:
        sched.close()
        pool_preempted = sum(r.get("preempted", 0) for r in rs.stats()["replicas"].values())
        rs.close()
        tracer.close()
    events = read_journal(tmp_path / "acc")
    req = [e for e in events if e["type"] == "request"]
    assert len(req) == 12
    ok = [r for r in req if r["outcome"] == "ok"]
    assert len(ok) == 8 and all(r["replica"] in ("r0", "r1") and r["tenant"] in ("web", "scrape") for r in ok)
    assert {r["class"] for r in ok} == {"interactive", "batch"}
    sheds = [r for r in req if r["outcome"] == "shed"]
    assert len(sheds) == 4 and all(r["err"] == "TenantQuotaError" and r["tenant"] == "scrape" for r in sheds)
    logged = sum(1 for e in events if e["type"] == "replica_preempted")
    assert logged == pool_preempted == 2
    assert any(e["type"] == "replica_restart" for e in events)


def test_a_flush_finishes_on_its_engine_when_the_slot_is_retired(tmp_path):
    """A scale-down retires a slot (``rep.engine = None``) while a batch it
    took is still in flight: the flush's trace breakdown and bill read the
    engine the batch ran on, and every future resolves."""
    class Engine(Stub):
        def last_breakdown(self):
            return {"compute_s": 0.001, "fetch_s": 0.0, "bucket": 1, "pad_fraction": 0.0}

    tracer = RequestTracer(registry=MetricsRegistry(), access_log=AccessLog(tmp_path / "acc"))
    rs = ReplicaSet(Engine, None, replicas=1, max_batch=1, max_delay_ms=0.0, tracer=tracer, task="features",
                    breakdown=lambda eng: eng.last_breakdown())

    def run(engine, batch, metas):
        rs.replica(0).engine = None  # the slot retired mid-flush
        return run_stub(engine, batch, metas)

    rs._run = run
    try:
        fut = rs.submit(img(3.0))
        assert fut.result(timeout=10)["y"] == 3.0
    finally:
        rs.close()
        tracer.close()
    (row,) = [e for e in read_journal(tmp_path / "acc") if e["type"] == "request"]
    assert row["outcome"] == "ok" and row["bucket"] == 1 and row["compute_ms"] == 1.0
