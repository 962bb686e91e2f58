"""The port's SLO tracker (``obs/slo.py``) against the JAX package's, on
the CPU: the same spec, the same observation sequence and the same
injected clock give equal ``evaluate()`` reports, ``worst_burn()`` and
``degraded()`` verdicts, step by step; and the registry side (the
``slo_*`` gauges, probes, ``add_probe``, ``observe_trace``,
``healthz_info``) renders the same Prometheus text as the JAX tracker's
registry, under the fake clock of the JAX package's
``tests/test_serve_slo.py``."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from jumbo_mae_tpu_tpu.obs.metrics import MetricsRegistry
from jumbo_mae_tpu_tpu_torch.obs import metrics as pmetrics
from jumbo_mae_tpu_tpu.obs.slo import SLOTracker as JaxTracker
from jumbo_mae_tpu_tpu.obs.slo import parse_slo as jax_parse
from jumbo_mae_tpu_tpu_torch.obs.slo import SLOObjective, SLOTracker, parse_slo

OUTCOMES = ("ok", "ok", "ok", "late", "deadline", "shed", "aborted")
SPECS = ["p99_latency_ms<=100;success_rate>=0.9", "success_rate>=0.99", "p50_latency_ms<=20",
         "p95_latency_ms<=250; success_rate>=0.5"]


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def pair(spec: str, **kw):
    clock = Clock()
    return (SLOTracker(parse_slo(spec), clock=clock, registry=pmetrics.MetricsRegistry(), **kw),
            JaxTracker(jax_parse(spec), clock=clock, registry=MetricsRegistry(), **kw), clock)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tracker_equals_jax_over_a_trace(spec, seed):
    port, ref, clock = pair(spec, window_s=30.0, fast_window_s=4.0)
    rng = np.random.default_rng(seed)
    for step in range(300):
        clock.t += float(rng.exponential(0.25))
        out = OUTCOMES[rng.integers(len(OUTCOMES))] if rng.random() < 0.3 else "ok"
        lat = None if out == "shed" else float(rng.lognormal(-3.5, 1.2))
        port.observe(lat, out)
        ref.observe(lat, out)
        if step % 7 == 0:
            assert port.evaluate() == ref.evaluate()
            assert port.worst_burn() == ref.worst_burn()
            assert port.degraded() == ref.degraded()
    clock.t += 45.0  # the samples age out; the latch releases after a window
    assert port.evaluate() == ref.evaluate() and port.degraded() == ref.degraded()


@settings(max_examples=40, deadline=None, database=None)
@given(events=st.lists(st.tuples(st.floats(0.0, 3.0), st.sampled_from(OUTCOMES),
                                  st.one_of(st.none(), st.floats(0.0, 1.0))), max_size=60),
       spec=st.sampled_from(SPECS), fast=st.sampled_from([0.0, 2.0]))
def test_tracker_equals_jax_on_drawn_sequences(events, spec, fast):
    port, ref, clock = pair(spec, window_s=10.0, fast_window_s=fast)
    for dt, out, lat in events:
        clock.t += dt
        port.observe(lat, out)
        ref.observe(lat, out)
    assert port.evaluate() == ref.evaluate()
    assert port.worst_burn() == ref.worst_burn()
    assert port.degraded() == ref.degraded()


def test_latch_and_empty_fast_window_as_jax():
    port, ref, clock = pair("success_rate>=0.9", window_s=60.0, fast_window_s=5.0)
    for t in (port, ref):
        for _ in range(10):
            t.observe(None, "aborted")
    clock.t += 10.0  # the breach is outside the fast window: still a breach
    assert port.evaluate() == ref.evaluate()
    assert port.evaluate()["objectives"][0]["breached"] is True
    clock.t += 30.0
    for t in (port, ref):
        for _ in range(200):
            t.observe(0.01, "ok")
    assert port.degraded() is ref.degraded() is True  # latched within a window
    clock.t += 61.0
    assert port.degraded() is ref.degraded() is False


@pytest.mark.parametrize("spec", SPECS + ["success_rate>=0.999;p95_latency_ms<=5"])
def test_parse_equals_jax(spec):
    got, want = parse_slo(spec), jax_parse(spec)
    assert [(o.metric, o.op, o.threshold, o.name, o.budget, o.percentile) for o in got] == \
        [(o.metric, o.op, o.threshold, o.name, o.budget, o.percentile) for o in want]
    assert all(isinstance(o, SLOObjective) for o in got)


@pytest.mark.parametrize("bad", ["", "p99_latency_ms>=5", "success_rate<=0.5", "success_rate>=1.5",
                                 "qps>=10", "p99_latency_ms<5", "p99.9_latency_ms<=5"])
def test_parse_rejects_as_jax(bad):
    with pytest.raises(ValueError):
        parse_slo(bad)
    with pytest.raises(ValueError):
        jax_parse(bad)
    with pytest.raises(ValueError):
        SLOTracker([])


# ------------------------------------------------------- the registry side


FakeClock = Clock


def gauges(reg) -> str:
    return reg.render()


def twin(spec: str, **kw):
    """The two trackers, each on its own registry, one fake clock."""
    clock = FakeClock()
    regs = (pmetrics.MetricsRegistry(), MetricsRegistry())
    return (SLOTracker(parse_slo(spec), registry=regs[0], clock=clock, **kw),
            JaxTracker(jax_parse(spec), registry=regs[1], clock=clock, **kw), regs, clock)


def test_slo_tracker_burn_and_latch_gauges_equal_jax():
    depth = {"v": 7}
    port, ref, (preg, jreg), clock = twin("p99_latency_ms<=100;success_rate>=0.9", window_s=60.0,
                                          fast_window_s=5.0, probes={"queue_depth": lambda: depth["v"]})
    for t in (port, ref):
        for _ in range(99):
            t.observe(0.01, "ok")
    assert port.evaluate() == ref.evaluate() and not port.last_report["degraded"]
    assert gauges(preg) == gauges(jreg)
    # 10 slow requests of ~109: ~9 % violations against a 1 % budget
    for t in (port, ref):
        for _ in range(10):
            t.observe(0.5, "ok")
    rep = port.evaluate()
    assert rep == ref.evaluate()
    lat = rep["objectives"][0]
    assert lat["breached"] and rep["degraded"]
    assert lat["burn_slow"] == pytest.approx(10 / 109 / 0.01, rel=1e-3)
    assert gauges(preg) == gauges(jreg)
    assert preg.gauge("slo_degraded", "x").value == 1.0 and preg.gauge("slo_queue_depth", "x").value == 7.0
    assert preg.gauge("slo_breached", "x", labels=("objective",)).labels("p99_latency_ms<=100").value == 1.0
    # the degraded flag stays latched for window_s after the samples age out
    clock.t += 61.0
    rep = port.evaluate()
    assert rep == ref.evaluate() and rep["samples"] == 0 and rep["degraded"] is False
    assert gauges(preg) == gauges(jreg) and preg.gauge("slo_degraded", "x").value == 0.0


def test_slo_shed_rate_and_add_probe_equal_jax():
    port, ref, (preg, jreg), _ = twin("success_rate>=0.5", window_s=60.0)
    depth = {"v": 7}
    for t in (port, ref):
        t.observe(0.01, "ok")
        t.observe(None, "shed")
        t.add_probe("queue_depth", lambda: depth["v"])
        t.add_probe("broken", lambda: 1 / 0)  # must not break an evaluation
    assert port.evaluate() == ref.evaluate()
    assert port.last_report["shed_rate"] == pytest.approx(0.5)
    assert gauges(preg) == gauges(jreg) and preg.gauge("slo_queue_depth", "x").value == 7.0
    depth["v"] = 3
    port.evaluate()
    ref.evaluate()
    assert gauges(preg) == gauges(jreg) and preg.gauge("slo_queue_depth", "x").value == 3.0


def test_observe_trace_and_healthz_info_equal_jax():
    """The tracker as a RequestTracer ``on_finish`` hook: the same finished
    traces (latency, outcome) into both trackers give equal ``/healthz``
    bodies and gauges; the port's tracer calls the hook once per finished
    request."""
    from types import SimpleNamespace

    from jumbo_mae_tpu_tpu_torch.obs.reqtrace import RequestTracer

    port, ref, (preg, jreg), clock = twin("p50_latency_ms<=20;success_rate>=0.75", window_s=30.0)
    outcomes = ["ok", "ok", "shed", "late", "ok", "deadline", "ok", "aborted"]
    for i, outcome in enumerate(outcomes):
        clock.t += 0.5
        tr = SimpleNamespace(latency_s=None if outcome == "shed" else 0.004 * (i + 1), outcome=outcome)
        port.observe_trace(tr)
        ref.observe_trace(tr)
    info = port.healthz_info()
    assert info == ref.healthz_info()
    assert info["samples"] == len(outcomes) and info["shed_rate"] == pytest.approx(1 / 8)
    assert [o["name"] for o in info["objectives"]] == ["p50_latency_ms<=20", "success_rate>=0.75"]
    assert port.last_report == info
    assert gauges(preg) == gauges(jreg)
    seen = []
    tracer = RequestTracer(registry=pmetrics.MetricsRegistry(), on_finish=seen.append)
    for outcome in ("ok", "shed"):
        tr = tracer.begin(task="features")
        tracer.finish(tr, outcome)
    assert [t.outcome for t in seen] == ["ok", "shed"]


def test_null_registry_tracker_publishes_nothing():
    """The canary window's tracker: the verdicts, no gauges."""
    t = SLOTracker(parse_slo("success_rate>=0.99"), registry=pmetrics.NULL_REGISTRY)
    t.observe(None, "aborted")
    assert t.evaluate()["objectives"][0]["breached"] is True
    assert pmetrics.NULL_REGISTRY.render() == ""
