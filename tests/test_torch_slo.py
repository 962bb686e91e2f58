"""The port's SLO tracker (``obs/slo.py``) against the JAX package's, on
the CPU: the same spec, the same observation sequence and the same
injected clock give equal ``evaluate()`` reports, ``worst_burn()`` and
``degraded()`` verdicts, step by step."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from jumbo_mae_tpu_tpu.obs.metrics import MetricsRegistry
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
    return (SLOTracker(parse_slo(spec), clock=clock, **kw),
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
