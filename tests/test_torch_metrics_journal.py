"""The port's metrics registry and run journal against the JAX package's.

- the same operations on both registries render the same Prometheus text,
  byte for byte, and give the same ``snapshot()``: counters, gauges,
  histograms, labels, escaping, the label-less proxies and the null
  registry;
- the same events into both journals read back equal, timestamps aside,
  through rotation at a small ``max_bytes`` with ``keep``, a torn tail, and
  ``read_merged_journal`` over two hosts; each package reads the other's;
- ``env_fingerprint`` names torch and no ``jax`` key.
"""

import json

import pytest

from jumbo_mae_tpu_tpu.obs import journal as jax_journal
from jumbo_mae_tpu_tpu.obs import metrics as jax_metrics
from jumbo_mae_tpu_tpu_torch import obs as port_obs
from jumbo_mae_tpu_tpu_torch.obs import doctor_common as port_doctor
from jumbo_mae_tpu_tpu_torch.obs import journal as port_journal
from jumbo_mae_tpu_tpu_torch.obs import metrics as port_metrics
from jumbo_mae_tpu_tpu.obs import doctor_common as jax_doctor


def _drive(m, reg):
    """One scripted set of operations on a registry of module ``m``."""
    c = reg.counter("req_total", "requests served", labels=("task", "code"))
    c.labels("features", "200").inc()
    c.labels(task="logits", code="500").inc(2.5)
    c.labels("features", "200").inc(3)
    g = reg.gauge("queue_depth", "pending requests")
    g.set(7)
    g.inc(2)
    g.dec(0.5)
    h = reg.histogram("latency_seconds", "request latency", labels=("task",))
    h.labels("features").observe(0.003)
    h.labels("features").observe_many([0.02, 0.7, 45.0, 0.001])
    r = reg.histogram("fill", "batch fill", buckets=m.RATIO_BUCKETS)
    r.observe(0.3)
    r.observe(1.0)
    esc = reg.counter("escaped_total", 'odd "labels"', labels=("path",))
    esc.labels('a\\b"c\nd').inc()
    reg.counter("bare_total")  # a help-less, untouched family still renders
    big = reg.gauge("big", "large and fractional values", labels=("k",))
    big.labels("huge").set(1e16)
    big.labels("frac").set(0.1 + 0.2)
    big.labels("neg").set(-3)
    reg.counter("req_total", "requests served", labels=("task", "code"))  # get-or-create
    return c, g, h


@pytest.mark.parametrize("registry", ["plain", "null"])
def test_render_and_snapshot_equal_jax(registry):
    if registry == "plain":
        regs = jax_metrics.MetricsRegistry(), port_metrics.MetricsRegistry()
    else:
        regs = jax_metrics.NullRegistry(), port_metrics.NullRegistry()
    (jc, jg, jh), (pc, pg, ph) = _drive(jax_metrics, regs[0]), _drive(port_metrics, regs[1])
    assert regs[1].render() == regs[0].render()
    assert regs[1].snapshot() == regs[0].snapshot()
    assert (pg.value, ph.labels("features").quantile(0.5)) == (jg.value, jh.labels("features").quantile(0.5))
    assert ph.labels("features").cumulative() == jh.labels("features").cumulative()
    if registry == "plain":
        assert "le=\"+Inf\"" in regs[1].render() and '\\"c\\nd' in regs[1].render()
    else:
        assert regs[1].render() == ""


def test_registry_refusals_and_exports_match_jax():
    for m in (jax_metrics, port_metrics):
        reg = m.MetricsRegistry()
        reg.counter("x_total", labels=("a",))
        with pytest.raises(ValueError, match="already registered as counter"):
            reg.gauge("x_total", labels=("a",))
        with pytest.raises(ValueError, match="already registered with labels"):
            reg.counter("x_total", labels=("b",))
        with pytest.raises(ValueError, match="counters only go up"):
            reg.counter("y_total").inc(-1)
        with pytest.raises(ValueError, match="takes labels"):
            reg.counter("x_total", labels=("a",)).labels("1", "2")
    assert port_metrics.LATENCY_BUCKETS == jax_metrics.LATENCY_BUCKETS
    assert port_metrics.RATIO_BUCKETS == jax_metrics.RATIO_BUCKETS
    assert port_obs.get_registry() is port_metrics.get_registry()
    prev = port_metrics.set_registry(port_metrics.NULL_REGISTRY)
    try:
        assert port_obs.get_registry() is port_metrics.NULL_REGISTRY
    finally:
        port_metrics.set_registry(prev)


def _events(journal):
    journal.event("run_start", config={"lr": 1e-3, "name": "x" * 40}, env={"a": 1})
    for step in range(12):
        journal.event("step", step=step, loss=float("nan") if step == 5 else 1.0 / (step + 1),
                      extra=[1, float("inf"), float("-inf")])
    journal.event("shutdown", reason="completed")


def _strip(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def test_journals_read_back_equal_with_rotation_and_torn_tail(tmp_path, monkeypatch):
    # one wall clock for both writers: a line's length (and so where a
    # segment rotates) depends on how many digits its ``ts`` rounds to
    import time

    monkeypatch.setattr(time, "time", lambda: 1792282165.125)
    dirs = {}
    for name, m in (("jax", jax_journal), ("port", port_journal)):
        d = tmp_path / name / "journal"
        with m.RunJournal(d, max_bytes=300, keep=4, fsync=False) as j:
            _events(j)
        dirs[name] = d
    segs = {n: sorted(p.name for p in d.iterdir()) for n, d in dirs.items()}
    assert segs["port"] == segs["jax"] and len(segs["port"]) == 4  # rotated, pruned to keep
    for d in dirs.values():  # a SIGKILL mid-line in the newest segment
        last = sorted(d.iterdir())[-1]
        with open(last, "a") as f:
            f.write('{"ts": 1.0, "seq": 99, "type": "st')
    got = {n: _strip(port_journal.read_journal(d)) for n, d in dirs.items()}
    want = {n: _strip(jax_journal.read_journal(d)) for n, d in dirs.items()}
    assert got["port"] == got["jax"] == want["jax"] == want["port"]
    assert got["port"][-1]["type"] == "shutdown" and all(e["seq"] != 99 for e in got["port"])
    # a restarted writer opens a new segment after the highest index
    with port_journal.RunJournal(dirs["port"], fsync=False) as j:
        j.event("job_start", shards=1)
    assert sorted(p.name for p in dirs["port"].iterdir())[-1] == f"journal-{int(segs['port'][-1][8:13]) + 1:05d}.jsonl"


def test_merged_journal_over_two_hosts_equals_jax(tmp_path):
    run = tmp_path / "run"
    for host, sub in ((0, "journal"), (1, "journal-host1")):
        with port_journal.RunJournal(run / sub, host=host, fsync=False) as j:
            for i in range(3):
                j.event("step", step=i, host_note=host)
    # a legacy row without host in host 1's dir, and a torn tail there
    seg = sorted((run / "journal-host1").iterdir())[-1]
    with open(seg, "a") as f:
        f.write(json.dumps({"ts": 0.5, "seq": 7, "type": "quarantine"}) + "\n" + '{"ts": 2')
    got = port_journal.read_merged_journal(run)
    assert got == jax_journal.read_merged_journal(run)
    assert [e["host"] for e in got].count(1) == 4 and got[0]["type"] == "quarantine"
    assert port_journal.journal_dir(run) == jax_journal.journal_dir(run) == run / "journal"
    assert port_journal.JOURNAL_EVENTS == jax_journal.JOURNAL_EVENTS
    with pytest.raises(FileNotFoundError):
        port_journal.read_journal(tmp_path / "nothing")


def test_env_fingerprint_names_torch_not_jax():
    fp = port_journal.env_fingerprint()
    assert "torch" in fp and "cuda" in fp and "process_count" in fp and "device_count" in fp
    assert not any("jax" in k for k in fp)
    json.dumps(fp)


def test_doctor_helpers_equal_jax():
    for v in (3, 2.5, 1 / 3, "nan", float("inf"), 1e20, True):
        assert port_doctor.fmt_num(v) == jax_doctor.fmt_num(v)
    idx = [5, 6, 7, 12, 3, 3]
    assert port_doctor.contiguous_windows(idx) == jax_doctor.contiguous_windows(idx)
    w = port_doctor.contiguous_windows(idx)
    assert port_doctor.spans_text(w, "request") == jax_doctor.spans_text(w, "request")
