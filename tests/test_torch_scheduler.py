"""The port's continuous scheduler and tenant admission (``serve/``)
against the JAX package's, on the CPU.

The dispatch decisions are a function of the accumulators and the clock,
so both packages' schedulers are held to each other on scripted arrival
traces with one injected clock: at every tick the same entries arrive,
``_expire`` and ``_dispatch_ready`` run, and the groups handed to the
backend (by request id) and the expiries must be equal — per-(task,
shape) accumulators, the deadline-aware cutoff, the score, the aligned
partial batch, class priority in an over-full batch, and the packed
token accumulator with its skim. Admission is held to JAX's on the same
tenants, pressures and clock. The threaded paths (coalescing, close,
dispatch errors, one flush on one replica) run with bounded waits.
"""

import threading
import time
from concurrent.futures import Future, wait

import numpy as np
import pytest

import jumbo_mae_tpu_tpu.serve.admission as jadm
import jumbo_mae_tpu_tpu.serve.scheduler as jsched
import jumbo_mae_tpu_tpu_torch.serve.admission as padm
import jumbo_mae_tpu_tpu_torch.serve.scheduler as psched
from jumbo_mae_tpu_tpu.infer.batching import QueueFullError as JaxQueueFullError
from jumbo_mae_tpu_tpu.obs.metrics import MetricsRegistry
from jumbo_mae_tpu_tpu_torch.infer import DeadlineExceededError, QueueFullError, ReplicaSet, ShutdownError


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class Recorder:
    """A dispatch backend that records each group's request ids and
    resolves its futures at once."""

    def __init__(self):
        self.groups = []

    def __call__(self, items):
        self.groups.append([it[2] for it in items])  # meta = request id
        futs = []
        for _ in items:
            f = Future()
            f.set_result(None)
            futs.append(f)
        return futs


def simulate(pkg: str, trace: list, **kw) -> tuple[list, list]:
    """Run ``trace`` — ticks of ``(dt_ms, [(rid, task, shape, tclass,
    deadline_ms or None, tokens), ...])`` — through one package's
    scheduler logic on an injected clock; returns (groups, expired ids)."""
    mod = jsched if pkg == "jax" else psched
    clock, rec = Clock(), Recorder()
    extra = {"registry": MetricsRegistry()} if pkg == "jax" else {}
    sched = mod.ContinuousScheduler(rec, clock=clock, **kw, **extra)
    buckets: dict = {}
    entries = []
    try:
        for dt_ms, arrivals in trace:
            clock.t += dt_ms / 1000.0
            for rid, task, shape, tclass, deadline_ms, tokens in arrivals:
                img = np.zeros(shape, np.uint8)
                deadline = None if deadline_ms is None else clock.t + deadline_ms / 1000.0
                fut = Future()
                args = (img, fut, None) if pkg == "jax" else (img, fut)
                e = mod._Entry(*args, None, tclass, deadline, rid, task, clock.t, tokens)
                entries.append(e)
                buckets.setdefault(sched._key(e), []).append(e)
                with sched._depth_lock:
                    sched._depth += 1
            sched._expire(buckets)
            sched._dispatch_ready(buckets)
    finally:
        sched.close()
    # each package raises its own DeadlineExceededError
    expired = [e.meta for e in entries if e.fut.done() and type(e.fut.exception()).__name__ == "DeadlineExceededError"]
    return rec.groups, sorted(expired)


def random_trace(seed: int, *, packed: bool) -> list:
    rng = np.random.default_rng(seed)
    classes = (None, "interactive", "batch", "scavenger")
    shapes = [(4, 4, 3), (6, 6, 3)] if not packed else [(s, s, 3) for s in (4, 6, 8, 10)]
    trace, rid = [], 0
    for _ in range(60):
        arrivals = []
        for _ in range(int(rng.poisson(1.5))):
            shape = shapes[rng.integers(len(shapes))]
            dl = None if rng.random() < 0.6 else float(rng.uniform(1.0, 40.0))
            task = "features" if packed or rng.random() < 0.7 else "logits"
            tokens = shape[0] * shape[0] + 3 if packed else None
            arrivals.append((rid, task, shape, classes[rng.integers(len(classes))], dl, tokens))
            rid += 1
        trace.append((float(rng.choice([0.5, 1.0, 2.0, 5.0, 9.0])), arrivals))
    trace.append((200.0, []))  # past every cutoff: everything left dispatches
    return trace


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("max_batch", [4, 16])
def test_dispatch_composition_equals_jax(seed, max_batch):
    trace = random_trace(seed, packed=False)
    kw = dict(max_batch=max_batch, max_delay_ms=10.0)
    got, want = simulate("port", trace, **kw), simulate("jax", trace, **kw)
    assert got == want
    assert sum(map(len, got[0])) + len(got[1]) == sum(len(a) for _, a in trace)


@pytest.mark.parametrize("seed", range(4))
def test_packed_dispatch_composition_equals_jax(seed):
    trace = random_trace(seed, packed=True)
    kw = dict(max_batch=32, max_delay_ms=10.0, packed=True, token_budget=160, seq_len_fn=lambda a: a.shape[0])
    got, want = simulate("port", trace, **kw), simulate("jax", trace, **kw)
    assert got == want


def test_scripted_aligned_priority_and_skim():
    """The three rules on fixed traces: an aligned partial batch (6
    pending, 3 due → 4 now), interactive entries jumping scavengers in an
    over-full batch, and the packed skim past an overflowing entry."""
    aligned = [(0.0, [(i, "f", (4, 4, 3), None, None, None) for i in range(3)]),
               (6.0, [(i, "f", (4, 4, 3), None, None, None) for i in range(3, 6)]),
               (5.0, []), (20.0, [])]
    for pkg in ("jax", "port"):
        assert simulate(pkg, aligned, max_batch=16, max_delay_ms=10.0)[0] == [[0, 1, 2, 3], [4, 5]]
    jump = [(0.0, [(0, "f", (4, 4, 3), "scavenger", None, None), (1, "f", (4, 4, 3), "scavenger", None, None),
                   (2, "f", (4, 4, 3), "interactive", None, None)])]
    for pkg in ("jax", "port"):
        assert simulate(pkg, jump, max_batch=2, max_delay_ms=10.0)[0][0] == [0, 2]
    skim = [(0.0, [(0, "f", (60, 60, 3), None, None, 60), (1, "f", (50, 50, 3), None, None, 50),
                   (2, "f", (30, 30, 3), None, None, 30)]), (20.0, []), (20.0, [])]
    kw = dict(max_batch=64, max_delay_ms=10.0, packed=True, token_budget=100, seq_len_fn=lambda a: a.shape[0])
    for pkg in ("jax", "port"):
        assert simulate(pkg, skim, **kw)[0] == [[0, 2], [1]]


# ------------------------------------------------------------- admission


@pytest.mark.parametrize("spec", ["web=interactive:rate=50:burst=100,scrape=batch:rate=5:budget=2",
                                  "a=scavenger, b=batch:window=30:budget=1", "solo=interactive"])
def test_parse_tenants_equals_jax(spec):
    assert [vars(t) for t in padm.parse_tenants(spec)] == [vars(t) for t in jadm.parse_tenants(spec)]


@pytest.mark.parametrize("bad", ["", "x", "=batch", "a=gold", "a=batch:speed=3", "a=batch,a=batch",
                                 "a=batch:rate=0"])
def test_parse_tenants_rejects_as_jax(bad):
    with pytest.raises(ValueError):
        padm.parse_tenants(bad)
    with pytest.raises(ValueError):
        jadm.parse_tenants(bad)


def test_admission_decisions_equal_jax():
    spec = "web=interactive:rate=20:burst=3,scrape=batch:rate=5,fill=scavenger"
    rng = np.random.default_rng(0)
    clocks = Clock(), Clock()
    pressure = {"p": 0.0}
    port = padm.AdmissionController(padm.parse_tenants(spec), pressure_fn=lambda: pressure["p"], clock=clocks[0])
    ref = jadm.AdmissionController(jadm.parse_tenants(spec), pressure_fn=lambda: pressure["p"], clock=clocks[1],
                                   registry=MetricsRegistry())
    for _ in range(300):
        dt = float(rng.exponential(0.05))
        for c in clocks:
            c.t += dt
        pressure["p"] = float(rng.choice([0.0, 0.3, 0.6, 0.9, 1.0]))
        tenant = ["web", "scrape", "fill", "stranger", None][rng.integers(5)]
        outs = []
        for ctl in (port, ref):
            try:
                sp = ctl.admit(tenant)
                outs.append(("ok", sp.name, sp.tclass))
            except (QueueFullError, JaxQueueFullError) as e:
                outs.append((type(e).__name__,))
        assert outs[0] == outs[1]
    assert port.stats() == ref.stats()
    assert padm.CLASSES == jadm.CLASSES and padm.CLASS_WEIGHT == jadm.CLASS_WEIGHT
    assert padm.CLASS_SHED_PRESSURE == jadm.CLASS_SHED_PRESSURE


# ------------------------------------------------------- threaded paths


def img(v=0.0):
    return np.full((4, 4, 3), v, np.float32)


class Stub(Recorder):
    def __init__(self, gate=None, fail=None):
        super().__init__()
        self.gate, self.fail = gate, fail

    def __call__(self, items):
        if self.gate is not None:
            assert self.gate.wait(timeout=10)
        if self.fail is not None:
            raise self.fail
        futs = []
        for image, _, meta in items:
            f = Future()
            f.set_result({"y": float(image[0, 0, 0])})
            futs.append(f)
        self.groups.append([it[2] for it in items])
        return futs


def test_coalesces_concurrent_arrivals_into_one_flush():
    stub = Stub()
    with psched.ContinuousScheduler(stub, max_batch=8, max_delay_ms=30.0) as sched:
        futs = [sched.submit(img(i), meta=i) for i in range(8)]
        done, _ = wait(futs, timeout=10)
        assert len(done) == 8
    assert stub.groups[0] == list(range(8))
    assert [f.result(timeout=0)["y"] for f in futs] == [float(i) for i in range(8)]


def test_deadline_expires_while_pending_and_queue_full_sheds():
    gate = threading.Event()
    stub = Stub(gate=gate)
    sched = psched.ContinuousScheduler(stub, max_batch=2, max_delay_ms=5.0, max_queue=3)
    try:
        blockers = [sched.submit(img()) for _ in range(2)]
        time.sleep(0.02)
        doomed = sched.submit(img(), deadline_ms=30.0)
        time.sleep(0.08)  # the deadline passes while the dispatcher is gated
        gate.set()
        with pytest.raises(DeadlineExceededError):
            doomed.result(timeout=10)
        wait(blockers, timeout=10)
    finally:
        sched.close()
    assert sched.stats()["expired"] == 1
    gate2 = threading.Event()
    sched = psched.ContinuousScheduler(Stub(gate=gate2), max_batch=4, max_delay_ms=5.0, max_queue=2)
    try:
        keep = [sched.submit(img()) for _ in range(2)]
        with pytest.raises(QueueFullError):
            sched.submit(img())
        gate2.set()
        wait(keep, timeout=10)
    finally:
        sched.close()


def test_close_drains_or_dispatches_and_errors_fail_the_batch():
    gate = threading.Event()
    sched = psched.ContinuousScheduler(Stub(gate=gate), max_batch=8, max_delay_ms=500.0)
    pending = [sched.submit(img()) for _ in range(3)]
    gate.set()
    sched.close(drain=True)
    for f in pending:
        with pytest.raises(ShutdownError):
            f.result(timeout=5)
    with pytest.raises(ShutdownError):
        sched.submit(img())
    sched = psched.ContinuousScheduler(Stub(), max_batch=8, max_delay_ms=500.0)
    pending = [sched.submit(img(i)) for i in range(3)]
    sched.close(drain=False)
    done, _ = wait(pending, timeout=10)
    assert len(done) == 3 and all(f.exception() is None for f in pending)
    with psched.ContinuousScheduler(Stub(fail=RuntimeError("backend down")), max_batch=2, max_delay_ms=2.0) as s:
        for f in [s.submit(img()) for _ in range(2)]:
            with pytest.raises(RuntimeError, match="backend down"):
                f.result(timeout=10)


def test_packed_needs_seq_len_and_refuses_oversized():
    with pytest.raises(ValueError, match="seq_len_fn"):
        psched.ContinuousScheduler(Stub(), packed=True, token_budget=100)
    with pytest.raises(ValueError, match="token_budget"):
        psched.ContinuousScheduler(Stub(), packed=True, seq_len_fn=len)
    with psched.ContinuousScheduler(Stub(), max_batch=8, packed=True, token_budget=100,
                                    seq_len_fn=lambda a: a.shape[0]) as sched:
        with pytest.raises(ValueError, match="token_budget"):
            sched.submit(np.zeros((101, 101, 3), np.float32))


def test_group_lands_on_one_replica_as_one_flush():
    flushes = []

    def run(eng, batch, metas):
        flushes.append((eng, len(metas)))
        return {"y": np.asarray(batch)[:, 0, 0, 0].astype(np.float64)}

    rs = ReplicaSet(lambda i: i, run, replicas=3, max_batch=8, max_delay_ms=20.0, supervise_interval_s=0.02)
    sched = psched.ContinuousScheduler(rs.submit_group, max_batch=8, max_delay_ms=20.0)
    try:
        futs = [sched.submit(img(i)) for i in range(8)]
        done, _ = wait(futs, timeout=10)
        assert len(done) == 8
        assert [f.result(timeout=0)["y"] for f in futs] == [float(i) for i in range(8)]
        assert {f.replica for f in futs} == {f"r{flushes[0][0]}"}
    finally:
        sched.close()
        rs.close()
    assert [n for _, n in flushes] == [8]


def test_tenant_classes_jump_and_pressure_sheds_low_classes_first():
    """With admission, an over-full accumulator gives its slots to the
    interactive tenant ahead of earlier scavengers, and the scheduler's
    pressure sheds the scavenger first."""
    gate = threading.Event()
    stub = Stub(gate=gate)
    adm = padm.AdmissionController(padm.parse_tenants("vip=interactive,fill=scavenger"))
    sched = psched.ContinuousScheduler(stub, max_batch=2, max_delay_ms=5.0, max_queue=8, admission=adm)
    adm.set_pressure_fn(sched.pressure)
    try:
        first = [sched.submit(img(0), tenant="fill", meta=i) for i in range(2)]
        time.sleep(0.05)  # the first full batch holds the dispatcher on the gate
        late = [sched.submit(img(1), tenant="fill", meta=10 + i) for i in range(2)]
        time.sleep(0.02)
        vips = [sched.submit(img(2), tenant="vip", meta=20 + i) for i in range(2)]
        with pytest.raises(padm.TenantPressureError):  # 4 pending of 8: scavengers shed
            sched.submit(img(3), tenant="fill")
        gate.set()
        done, _ = wait(first + late + vips, timeout=10)
        assert len(done) == 6
    finally:
        sched.close()
    assert stub.groups[1] == [20, 21]
    assert sched.stats()["priority_jumps"] == 2
    assert adm.stats()["shed"] == {"fill:pressure": 1}
