"""The port's ReplicaSet and WeightSwapController against the JAX
package's, on the CPU.

Both packages' pools are driven with the same versioned stand-in engine
through the same scripted scenarios (the timings force one routing, so
the outcome is the same run to run): crash-requeue, a hung replica,
restart backoff, the quorum breaker, ``submit_group``, ``scale_to``,
retries exhausted, a fully excluded pool, and the three swap verdicts
(a good push promoted, a corrupt one rolled back at parity, a canary
breach rolled back, an unreadable one rejected). Each future's result or
error type, ``replica``, ``retries`` and ``requeued_from`` (the JAX
package's from its access log, the port's from the future) and each
swap report's verdict and stage must be equal. Then the port's own
``InferenceEngine`` on the CPU behind a 2-replica pool takes one hot swap
promoted and one corrupt push rejected.

Every wait has an explicit bound (``result(timeout=...)``,
``join(timeout=...)``).
"""

import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jumbo_mae_tpu_tpu.infer as jinfer
import jumbo_mae_tpu_tpu_torch.infer as pinfer
from jumbo_mae_tpu_tpu.obs import AccessLog, RequestTracer
from jumbo_mae_tpu_tpu.obs.journal import read_journal
from jumbo_mae_tpu_tpu.obs.metrics import MetricsRegistry
from jumbo_mae_tpu_tpu_torch.config import load_config
from torch_port_util import random_images


class StubEngine:
    """Versioned stand-in for InferenceEngine: swap and restore move a string."""

    def __init__(self, idx, version="v0"):
        self.idx = idx
        self.version = version

    def swap_weights(self, params, batch_stats=None, *, ckpt=""):
        snap = {"version": self.version}
        self.version = params
        return snap

    def restore_snapshot(self, snap):
        self.version = snap["version"]


def img(v=0.0):
    return np.full((2, 2, 3), v, np.float32)


def run_echo(eng, batch, metas):
    return {"y": batch[:, 0, 0, 0].astype(np.float64)}


def until(cond, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.002)


def busy(rs, idx: int = 0) -> bool:
    return rs.replica(idx).busy_since is not None


class Side:
    """One package's pool, futures and their attribution."""

    def __init__(self, pkg: str, tmp_path: Path, run=run_echo, provider=None, **kw):
        self.pkg = pkg
        kw.setdefault("replicas", 2)
        kw.setdefault("max_batch", 4)
        kw.setdefault("max_delay_ms", 1.0)
        kw.setdefault("supervise_interval_s", 0.02)
        provider = provider or (lambda i: StubEngine(i))
        if pkg == "jax":
            self.reg = MetricsRegistry()
            self.log = AccessLog(tmp_path / "access")
            self.tracer = RequestTracer(registry=self.reg, access_log=self.log)
            self.rs = jinfer.ReplicaSet(provider, run, registry=self.reg, tracer=self.tracer, **kw)
        else:
            self.rs = pinfer.ReplicaSet(provider, run, **kw)
        self.futs = []

    def submit(self, v, **kw):
        f = self.rs.submit(img(v), **kw)
        self.futs.append(f)
        return f

    def outcomes(self, timeout=10.0) -> list[tuple]:
        """(result or error type, replica, retries, requeued_from) per
        future, in submission order; closes the pool."""
        for f in self.futs:
            f.exception(timeout=timeout)
        self.rs.close()
        if self.pkg == "jax":
            self.log.close()
            rows = {r["rid"]: r for r in read_journal(self.log.path) if r.get("type") == "request"}
            attrs = [(rows[f.rid].get("replica"), rows[f.rid].get("retries") or 0, rows[f.rid].get("requeued_from"))
                     for f in self.futs]
        else:
            attrs = [(f.replica, f.retries, f.requeued_from) for f in self.futs]
        out = []
        for f, a in zip(self.futs, attrs):
            e = f.exception(timeout=0)
            val = type(e).__name__ if e is not None else float(f.result()["y"])
            out.append((val, *a))
        return out


def both(tmp_path, scenario, **kw) -> tuple:
    """``scenario(side)`` on each package; returns (jax outcome, port outcome)."""
    res = []
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        res.append(scenario(Side(pkg, d, **kw)))
    return tuple(res)


def test_crash_requeues_to_survivor_with_attribution(tmp_path):
    """r1 always raises. X parks r0 on a gate, Y waits in r0's queue, so
    Z routes to r1, crashes there and is requeued onto r0."""

    def scenario(side):
        gate = threading.Event()

        def run(eng, batch, metas):
            if eng.idx == 1:
                raise RuntimeError("boom")
            gate.wait(10)
            return run_echo(eng, batch, metas)

        side.rs._run = run
        side.submit(1.0)
        until(lambda: busy(side.rs))
        side.submit(2.0)
        side.submit(3.0)
        until(lambda: side.rs.stats()["replicas"]["r1"]["state"] == "down")
        gate.set()
        return side.outcomes()

    jax_out, port_out = both(tmp_path, scenario, restart_backoff_s=30.0)
    assert jax_out == port_out
    assert port_out[2] == (3.0, "r0", 1, "r1")


def test_hang_detected_requeued_and_late_result_loses(tmp_path):
    def scenario(side):
        hung = threading.Event()

        def run(eng, batch, metas):
            if eng.idx == 0 and not hung.is_set():
                hung.set()
                time.sleep(1.0)  # >> hang_timeout_s
            return run_echo(eng, batch, metas)

        side.rs._run = run
        side.submit(5.0)
        out = side.outcomes()
        time.sleep(1.0)  # the hung thread wakes; its settle loses
        return out, side.futs[0].result(timeout=0)["y"]

    jax_out, port_out = both(tmp_path, scenario, hang_timeout_s=0.15, supervise_interval_s=0.03,
                             restart_backoff_s=30.0)
    assert jax_out == port_out
    assert port_out[0] == [(5.0, "r1", 1, "r0")]


def test_restart_backoff_recovers_with_a_new_generation(tmp_path):
    def scenario(side):
        crashed = threading.Event()

        def run(eng, batch, metas):
            if not crashed.is_set():
                crashed.set()
                raise RuntimeError("first batch dies")
            return run_echo(eng, batch, metas)

        side.rs._run = run
        side.submit(1.0).exception(timeout=10)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and side.rs.stats()["replicas"]["r0"]["state"] != "up":
            time.sleep(0.02)
        gen = side.rs.generation(0)
        side.submit(2.0)
        return side.outcomes(), gen

    jax_out, port_out = both(tmp_path, scenario, replicas=1, restart_backoff_s=0.05, max_retries=0)
    assert jax_out == port_out
    assert port_out == ([("RetriesExhaustedError", None, 1, "r0"), (2.0, "r0", 0, None)], 1)


def test_provider_failure_backs_off_then_recovers(tmp_path):
    def scenario(side):
        builds = {"n": 0}

        def provider(idx):
            builds["n"] += 1
            if builds["n"] in (1, 2):  # the first two rebuilds fail
                raise RuntimeError("provider down")
            return StubEngine(idx)

        first = threading.Event()

        def run(eng, batch, metas):
            if not first.is_set():
                first.set()
                raise RuntimeError("die once")
            return run_echo(eng, batch, metas)

        side.rs._run = run
        side.rs.set_engine_provider(provider)
        side.submit(1.0).exception(timeout=10)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and side.rs.stats()["replicas"]["r0"]["state"] != "up":
            time.sleep(0.02)
        side.submit(2.0)
        return side.outcomes(), builds["n"]

    jax_out, port_out = both(tmp_path, scenario, replicas=1, restart_backoff_s=0.03, max_retries=0)
    assert jax_out == port_out
    assert port_out[1] == 3


def test_quorum_breaker_opens_and_closes(tmp_path):
    def scenario(side):
        well = threading.Event()

        def run(eng, batch, metas):
            if eng.idx == 1 and not well.is_set():
                raise RuntimeError("r1 sick")
            return run_echo(eng, batch, metas)

        seen = [side.rs.degraded()]
        gate = threading.Event()
        # park r0 so the second request routes to the sick r1
        side.rs._run = lambda eng, b, m: (eng.idx == 0 and gate.wait(10), run(eng, b, m))[1]
        side.submit(1.0)
        until(lambda: busy(side.rs))
        side.submit(2.0)
        side.submit(3.0)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not side.rs.degraded():
            time.sleep(0.01)
        seen.append(side.rs.degraded())
        well.set()
        gate.set()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and side.rs.degraded():
            time.sleep(0.02)
        seen.append(side.rs.degraded())
        return side.outcomes(), seen

    jax_out, port_out = both(tmp_path, scenario, quorum=2, restart_backoff_s=0.3)
    assert jax_out == port_out
    assert port_out[1] == [False, True, False]


@pytest.mark.parametrize("max_retries,err", [(0, "RetriesExhaustedError"), (5, "PoolUnhealthyError")])
def test_terminal_failures_are_typed(tmp_path, max_retries, err):
    def scenario(side):
        def run(eng, batch, metas):
            raise RuntimeError("always")

        side.rs._run = run
        side.submit(1.0)
        out = side.outcomes()
        return out

    jax_out, port_out = both(tmp_path, scenario, max_retries=max_retries, restart_backoff_s=30.0)
    assert jax_out == port_out
    assert port_out[0][0] == err


def test_submit_group_flushes_each_group_whole(tmp_path):
    def scenario(side):
        gate = threading.Event()
        flushes = []

        def run(eng, batch, metas):
            gate.wait(10)
            flushes.append(len(metas))
            return {"y": np.array([float(np.asarray(b)[0, 0, 0]) for b in batch])}

        side.rs._run = run
        now = time.monotonic()
        decoy = side.submit(9.0)
        until(lambda: busy(side.rs))
        items = lambda v, k: [(np.full((4, 4, 3), v, np.float32), now + 30.0, None) for _ in range(k)]  # noqa: E731
        if side.pkg == "jax":
            g1 = side.rs.submit_group([(*it, None) for it in items(1.0, 2)])
            g2 = side.rs.submit_group([(*it, None) for it in items(2.0, 3)])
        else:
            g1 = side.rs.submit_group(items(1.0, 2))
            g2 = side.rs.submit_group(items(2.0, 3))
        gate.set()
        vals = [f.result(timeout=10)["y"] for f in [decoy] + g1 + g2]
        side.rs.close()
        return flushes, vals

    jax_out, port_out = both(tmp_path, scenario, replicas=1, max_batch=16)
    assert jax_out == port_out
    assert port_out[0] == [1, 2, 3]


def test_scale_to_up_and_down(tmp_path):
    def scenario(side):
        up = side.rs.scale_to(3)
        for i in range(6):
            side.submit(float(i))
        for f in side.futs:
            f.result(timeout=10)
        down = side.rs.scale_to(1)
        side.submit(7.0)
        quorum = side.rs.quorum
        return up, down, quorum, [o[0] for o in side.outcomes()]

    jax_out, port_out = both(tmp_path, scenario)
    assert jax_out == port_out
    assert port_out[0]["added"] == ["r2"] and port_out[1]["removed"] == ["r2", "r1"] and port_out[2] == 1


def test_preempt_drains_and_restarts_without_a_failure(tmp_path):
    def scenario(side):
        for i in range(8):
            side.submit(float(i))
        ok = side.rs.preempt(1)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and side.rs.stats()["replicas"]["r1"]["state"] != "up":
            time.sleep(0.02)
        st = side.rs.stats()["replicas"]["r1"]
        return ok, st["gen"], st["restarts"], [o[0] for o in side.outcomes()]

    jax_out, port_out = both(tmp_path, scenario, restart_backoff_s=0.05)
    assert jax_out == port_out
    assert port_out[:3] == (True, 1, 0)


def test_pool_pressure_equals_jax(tmp_path):
    """C5: the pool's pressure signal (pending depth / ``max_queue``, 0 when
    unbounded) that ``cli.batch`` and ``cli.predict`` feed to admission.
    The port's pool had none, so the CLIs' probe raised and admission read
    pool pressure 0 whatever the backlog."""
    def scenario(side):
        gate = threading.Event()

        def run(eng, batch, metas):
            gate.wait(10)
            return {"y": np.array([float(np.asarray(b)[0, 0, 0]) for b in batch])}

        side.rs._run = run
        seen = [side.rs.pressure()]
        side.submit(0.0)
        until(lambda: busy(side.rs))
        for i in range(1, 7):
            side.submit(float(i))
            seen.append(side.rs.pressure())
        gate.set()
        for f in side.futs:
            f.result(timeout=10)
        seen.append(side.rs.pressure())
        side.rs.close()
        return seen

    jax_out, port_out = both(tmp_path, scenario, replicas=1, max_batch=1, max_queue=8)
    assert jax_out == port_out == [0.0, *(i / 8 for i in range(1, 7)), 0.0]
    (tmp_path / "u").mkdir()
    unbounded = both(tmp_path / "u", lambda side: (side.rs.pressure(), side.rs.close())[0], replicas=1)
    assert unbounded == (0.0, 0.0)


# ------------------------------------------------------------- hot swap


def swap_rig(pkg: str, run=None, *, features=None, **ctl_kw):
    kw = dict(replicas=3, max_batch=4, max_delay_ms=1.0, supervise_interval_s=0.02)
    run = run or (lambda eng, batch, metas: {"y": np.zeros(len(batch))})
    if pkg == "jax":
        reg = MetricsRegistry()
        rs = jinfer.ReplicaSet(lambda i: StubEngine(i), run, registry=reg, **kw)
        ctl_cls, extra = jinfer.WeightSwapController, {"registry": reg}
    else:
        rs = pinfer.ReplicaSet(lambda i: StubEngine(i), run, **kw)
        ctl_cls, extra = pinfer.WeightSwapController, {}

    def default_features(eng, images):
        f = np.ones((len(images), 8))
        if isinstance(eng.version, str) and "bad" in eng.version:
            f[:, ::2] = -1.0  # the direction flips: the cosine collapses
        return f

    ctl_kw.setdefault("restore_fn", lambda p: (Path(p).name, None))
    ctl_kw.setdefault("features_fn", features or default_features)
    ctl_kw.setdefault("parity_images", np.zeros((4, 2, 2, 3), np.uint8))
    ctl_kw.setdefault("canary_requests", 2)
    ctl_kw.setdefault("canary_timeout_s", 3.0)
    return rs, ctl_cls(rs, **ctl_kw, **extra)


def traffic(rs, stop, deadline_ms=None):
    def loop():
        while not stop.is_set():
            try:
                rs.submit(img(), deadline_ms=deadline_ms).result(timeout=5)
            except Exception:
                pass
            time.sleep(0.005)

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    return t


def swap_both(push: str, run=None, traffic_deadline_ms=None, **kw) -> list[tuple]:
    out = []
    for pkg in ("jax", "port"):
        promoted = []
        rs, ctl = swap_rig(pkg, run, on_promote=promoted.append, **kw)
        stop = threading.Event()
        t = traffic(rs, stop, traffic_deadline_ms)
        try:
            rep = ctl.swap(push)
        finally:
            stop.set()
            t.join(timeout=10)
        versions = [rs.replica(i).engine.version for i in range(3)]
        served = rs.submit(img()).result(timeout=5) is not None
        rs.close()
        par = rep.get("parity")
        out.append((rep["verdict"], rep["stage"], par and par["within_tolerance"], versions, promoted, served))
    return out


def test_swap_promotes_under_load():
    jax_out, port_out = swap_both("/push/v1")
    assert jax_out == port_out == ("promoted", "promote", True, ["v1"] * 3, ["/push/v1"], True)


def test_corrupt_push_rolls_back_at_parity():
    jax_out, port_out = swap_both("/push/vbad")
    assert jax_out == port_out == ("rolled_back", "parity", False, ["v0"] * 3, [], True)


def test_canary_breach_rolls_back():
    def run(eng, batch, metas):
        if eng.version == "vslow":
            time.sleep(0.12)
        return {"y": np.zeros(len(batch))}

    jax_out, port_out = swap_both("/push/vslow", run, traffic_deadline_ms=60.0,
                                  features=lambda eng, images: np.ones((len(images), 8)),
                                  canary_requests=4, canary_timeout_s=5.0)
    assert jax_out == port_out == ("rolled_back", "canary", True, ["v0"] * 3, [], True)


def test_unreadable_push_rejected():
    def restore(path):
        raise FileNotFoundError(path)

    jax_out, port_out = swap_both("/push/missing", restore_fn=restore)
    assert jax_out == port_out == ("rejected", "restore", None, ["v0"] * 3, [], True)


# ------------------------------------------------------- the real engine

RECIPE = Path(__file__).resolve().parent.parent / "recipes" / "smoke_cpu.yaml"


def test_real_engine_pool_hot_swap_promotes_and_rejects_a_corrupt_push():
    """The port's InferenceEngine on the CPU behind a 2-replica pool: a
    push of a retrained tree promotes through parity and canary with no
    failed request, the pool serves its features, and no replica
    captured or first-ran anything for the swap; a corrupt push (its
    weights scrambled) is rolled back at parity and the pool serves the
    promoted weights unchanged."""
    from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine

    cfg = load_config(RECIPE, ["model.overrides.dtype=float32"])
    engines = []

    def provider(idx):
        eng = InferenceEngine(cfg, max_batch=4, device="cpu")
        eng.warmup(("features",), buckets=(1, 2, 4))
        engines.append(eng)
        return eng

    rs = pinfer.ReplicaSet(provider, lambda eng, batch, metas: eng.predict(batch, task="features"),
                           replicas=2, max_batch=4, max_delay_ms=2.0, supervise_interval_s=0.02)
    x = random_images(np.random.default_rng(3), 4, 32)
    other = InferenceEngine(load_config(RECIPE, ["model.overrides.dtype=float32", "run.init_seed=9"]),
                            max_batch=4, device="cpu")
    good = {n: t.detach().clone() for n, t in other.model("features").state_dict().items()}
    gen = torch.Generator().manual_seed(0)
    bad = {n: t[torch.randperm(t.shape[0], generator=gen)] * -3.0 if t.dim() > 1 else t for n, t in good.items()}
    pushes = {"/push/good": good, "/push/bad": bad}
    ctl = pinfer.WeightSwapController(rs, restore_fn=lambda p: (pushes[p], None), parity_images=x,
                                      parity_min_cosine=0.98, canary_requests=2, canary_timeout_s=20.0)
    counts = [dict(e.compile_counts) for e in engines]
    stop, failures = threading.Event(), []

    def loop():
        while not stop.is_set():
            try:
                rs.submit(x[0]).result(timeout=30)
            except Exception as e:  # noqa: BLE001 - recorded and asserted empty below
                failures.append(e)
            time.sleep(0.01)

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    try:
        # parity would refuse a retrained tree whose features moved far;
        # the gate here holds the candidate to the threshold it is given
        ctl.parity_min_cosine = -1.0
        rep = ctl.swap("/push/good")
        ctl.parity_min_cosine = 0.98
        assert rep["verdict"] == "promoted", rep
        want = other.features(x)
        got = np.stack([rs.submit(im).result(timeout=30) for im in x])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        live = [rs.replica(i).engine.features(x) for i in range(2)]
        rep2 = ctl.swap("/push/bad")
    finally:
        stop.set()
        t.join(timeout=30)
    assert (rep2["verdict"], rep2["stage"]) == ("rolled_back", "parity") and rep2["parity"]["cosine_min"] < 0.98
    assert not failures
    assert [dict(e.compile_counts) for e in engines] == counts  # no first run for any swap
    for i in range(2):  # the rollback serves the promoted weights bit for bit
        np.testing.assert_array_equal(rs.replica(i).engine.features(x), live[i])
    rs.close()
