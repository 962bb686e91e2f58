"""The port's exporter (``obs/exporter.py``) against the JAX package's, on
the CPU.

Every server binds port 0 on loopback and is closed by its ``with``
block; every ``urlopen`` has a timeout. The cases of the JAX package's
``tests/test_obs.py`` (``/metrics``, ``/healthz`` 200/503, 404,
heartbeats), ``tests/test_serve_slo.py`` (composed ``degraded_when``,
pre-scrape hooks, the micro-batcher's ``serving`` probe) and
``tests/test_diagnostics.py`` (uptime, ``build_info``) run on the port.
Then the same registry contents and the same ``HealthState`` calls go
through both packages: ``/metrics`` is byte-equal and ``/healthz`` equal
in status and body, with the process's uptime, the build's identity
(``build_info`` names the port's torch where the JAX one names JAX) and
the heartbeat ages masked.
"""

import json
import re
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from jumbo_mae_tpu_tpu.obs import exporter as jexp
from jumbo_mae_tpu_tpu.obs import metrics as jmetrics
from jumbo_mae_tpu_tpu_torch.infer.batching import MicroBatcher
from jumbo_mae_tpu_tpu_torch.obs import exporter as pexp
from jumbo_mae_tpu_tpu_torch.obs import metrics as pmetrics
from jumbo_mae_tpu_tpu_torch.obs.exporter import HealthState, TelemetryServer
from jumbo_mae_tpu_tpu_torch.obs.metrics import MetricsRegistry


def get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_exporter_metrics_and_healthz_over_socket():
    reg = MetricsRegistry()
    reg.counter("served_total", "x").inc(7)
    health = HealthState()
    with TelemetryServer(reg, health, host="127.0.0.1", port=0) as srv:
        url = f"http://127.0.0.1:{srv.port}"
        status, body = get(f"{url}/healthz")  # not ready yet: 503 with a JSON body
        assert status == 503 and json.loads(body)["ready"] is False
        health.set_ready(True)
        status, body = get(f"{url}/healthz")
        assert status == 200 and json.loads(body)["ok"] is True
        status, body = get(f"{url}/metrics")
        assert status == 200 and "served_total 7" in body
        assert get(f"{url}/nope")[0] == 404


def test_healthz_liveness_heartbeats():
    health = HealthState(ready=True)
    health.watch("step", max_age_s=0.2)
    ok, report = health.report()
    assert not ok  # watched but never beaten: not live
    assert report["checks"]["step"]["age_s"] is None
    health.beat("step")
    ok, report = health.report()
    assert ok and report["checks"]["step"]["ok"]
    time.sleep(0.25)
    assert not health.report()[0]  # a stale heartbeat
    health.unwatch("step")
    assert health.report()[0]


def test_healthstate_degraded_when_does_not_flip_ok():
    h = HealthState(ready=True)
    flag = {"v": False}
    h.degraded_when(lambda: flag["v"])
    ok, body = h.report()
    assert ok and body["degraded"] is False
    flag["v"] = True
    ok, body = h.report()
    assert ok and body["degraded"] is True  # soft: never the 503 verdict
    # predicates compose by OR; an erroring one reports only while no other says True
    h.degraded_when(lambda: 1 / 0)
    ok, body = h.report()
    assert ok and body["degraded"] is True
    flag["v"] = False
    ok, body = h.report()
    assert ok and "probe error" in body["degraded"]


def test_exporter_pre_scrape_hooks_and_serving_probe():
    reg = MetricsRegistry()
    health = HealthState(ready=True)
    calls = {"n": 0}

    def bump():
        calls["n"] += 1
        reg.gauge("test_prescrape_runs", "x").set(calls["n"])

    mb = MicroBatcher(lambda b: b, registry=reg, max_batch=2)
    try:
        health.probe("serving", mb.stats)
        srv = TelemetryServer(registry=reg, health=health, host="127.0.0.1", port=0)
        srv.add_pre_scrape(bump)
        srv.add_pre_scrape(lambda: 1 / 0)  # a broken hook must not break scrapes
        with srv:
            mb.submit(np.zeros(1)).result(5.0)
            base = f"http://127.0.0.1:{srv.port}"
            _, text = get(base + "/metrics")
            assert "test_prescrape_runs 1" in text and "process_uptime_seconds" in text
            assert "infer_requests_total 1" in text
            status, body = get(base + "/healthz")
            body = json.loads(body)
            assert status == 200 and body["ok"]
            assert body["info"]["serving"]["requests_submitted"] == 1 and body["info"]["serving"]["queue_depth"] == 0
    finally:
        mb.close()
    assert calls["n"] == 1


def test_exporter_uptime_and_build_info():
    import torch

    from jumbo_mae_tpu_tpu_torch import __version__

    reg = MetricsRegistry()
    with TelemetryServer(registry=reg, host="127.0.0.1", port=0) as srv:
        _, body = get(f"http://127.0.0.1:{srv.port}/metrics")
    line = next(ln for ln in body.splitlines() if ln.startswith("process_uptime_seconds "))
    assert float(line.split()[-1]) > 0  # a scrape refreshes it
    assert f'build_info{{version="{__version__}",torch_version="{torch.__version__}"}} 1' in body


def test_close_releases_the_port_and_a_null_registry_serves_nothing():
    with TelemetryServer(registry=pmetrics.NULL_REGISTRY, host="127.0.0.1", port=0) as srv:
        url = f"http://127.0.0.1:{srv.port}"
        assert get(url + "/metrics") == (200, "")
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url + "/metrics", timeout=2)


# ------------------------------------------------- the two packages alike


def fill(metrics, reg):
    """The same contents into either package's registry."""
    reg.counter("served_total", "requests served", labels=("task",)).labels("features").inc(7)
    reg.counter("served_total", "requests served", labels=("task",)).labels("logits").inc(2.5)
    reg.gauge("queue_depth", "queued").set(3)
    reg.gauge("label_escape", "odd labels", labels=("path",)).labels('a"b\\c\nd').set(-1.25)
    h = reg.histogram("latency_seconds", "latency", labels=("outcome",))
    for v in (0.0005, 0.003, 0.2, 0.2, 7.0, 100.0):
        h.labels("ok").observe(v)
    occ = reg.histogram("occupancy", "fill", buckets=metrics.RATIO_BUCKETS)
    occ.observe_many([0.1, 0.5, 1.0, 0.75])
    reg.counter("never_touched_total", "zero from boot")


def drive(exp_mod, metrics) -> tuple:
    reg = metrics.MetricsRegistry()
    fill(metrics, reg)
    health = exp_mod.HealthState()
    flag = {"v": False}
    out = []
    with exp_mod.TelemetryServer(reg, health, host="127.0.0.1", port=0) as srv:
        url = f"http://127.0.0.1:{srv.port}"
        out.append(get(url + "/healthz"))  # not ready
        health.set_ready(True, detail="engine up (ckpt=yes)")
        health.watch("replica.r0", 30.0)
        health.watch("never_beaten", 1.0)
        health.beat("replica.r0")
        health.probe("replicas", lambda: {"r0": {"state": "up", "served": 3}})
        health.probe("broken", lambda: 1 / 0)
        health.degraded_when(lambda: flag["v"])
        out.append(get(url + "/healthz"))  # not live: a watched name never beaten
        health.unwatch("never_beaten")
        flag["v"] = True
        out.append(get(url + "/healthz"))  # degraded, still 200
        out.append(get(url + "/metrics"))
        out.append(get(url + "/metrics"))
        out.append(get(url + "/missing"))
    return out


def mask_metrics(text: str) -> str:
    text = re.sub(r"(?m)^process_uptime_seconds .*$", "process_uptime_seconds <uptime>", text)
    return re.sub(r"(?m)^build_info\{.*\} 1$", "build_info{<this build>} 1", text)


def mask_health(body: str) -> dict:
    doc = json.loads(body)
    for check in doc.get("checks", {}).values():
        if check["age_s"] is not None:
            check["age_s"] = "<age>"
    return doc


def test_metrics_bytes_and_healthz_equal_jax():
    ref = drive(jexp, jmetrics)
    port = drive(pexp, pmetrics)
    for i in (0, 1, 2):
        assert port[i][0] == ref[i][0]
        assert mask_health(port[i][1]) == mask_health(ref[i][1])
    assert [s for s, _ in port] == [503, 503, 200, 200, 200, 404]
    for i in (3, 4):
        assert mask_metrics(port[i][1]).encode() == mask_metrics(ref[i][1]).encode()
    assert port[5] == ref[5]
    body = json.loads(port[2][1])
    assert body["degraded"] is True and body["detail"] == "engine up (ckpt=yes)"
    assert body["info"]["broken"].startswith("probe error: ZeroDivisionError")
    assert 'label_escape{path="a\\"b\\\\c\\nd"} -1.25' in port[3][1]
