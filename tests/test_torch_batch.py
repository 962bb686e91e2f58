"""The port's resumable offline batch jobs (``batch/``, ``cli/batch.py``,
``tools/batch_doctor.py``), mirroring ``tests/test_batch.py``, and held to
the JAX package's:

- part files are torn-tail tolerant; leases claim in order, expire, steal
  and fence; a job completes and its rerun is a no-op;
- a worker killed by the ``batch.worker`` fault site, a torn partial, a
  graceful stop and a SIGKILLed ``cli.batch`` process each resume to a
  manifest byte-identical to a fault-free run; a quarantined shard is
  left out and the job completes;
- ``batch_doctor``'s exit codes (0; 2 on corruption, orphans, absence)
  and its steal attribution;
- across the packages: the same shards and the same deterministic submit
  give byte-equal part files and ``manifest.json`` through the JAX
  package's ``BatchJobRunner`` and the port's, the same record bytes for
  numpy and torch values, and each package's doctor passes the other's
  job directory;
- ``cli.batch`` bills every batch through the cost meter: a tenant's
  ``budget=``/``window=`` is enforced (over budget under pressure it sheds
  and the runner retries), ``tenant_usage`` in the summary bills Σ bucket
  × ``--model-gflops-per-item`` × 1e9 FLOPs, ``<out>/access`` holds one
  row per request and ``cost_doctor`` reconciles it; with a recipe it
  serves engine replicas on the CPU when asked.
"""

import json
import os
import signal
import struct
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.batch import BatchJobRunner as JaxRunner
from jumbo_mae_tpu_tpu.batch import JobSpec as JaxSpec
from jumbo_mae_tpu_tpu.batch.partfile import encode_record as jax_encode_record
from jumbo_mae_tpu_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from jumbo_mae_tpu_tpu_torch import faults
from jumbo_mae_tpu_tpu_torch.batch import (
    BatchJobRunner,
    JobSpec,
    LeaseTable,
    part_stem,
    read_manifest,
    scan_part,
)
from jumbo_mae_tpu_tpu_torch.batch.partfile import MAGIC, append_record, encode_record, iter_records
from jumbo_mae_tpu_tpu_torch.cli import batch as cli_batch
from jumbo_mae_tpu_tpu_torch.data.tario import QUARANTINE, RetryPolicy, write_tar_samples
from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal
from jumbo_mae_tpu_tpu_torch.obs.metrics import MetricsRegistry
from jumbo_mae_tpu_tpu_torch.tools import batch_doctor

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def fault_plan():
    yield faults.install_plan
    faults.clear_plan()
    QUARANTINE.clear()


def stub_submit(image, *, task=None, deadline_ms=None, meta=None, tenant=None):
    """A deterministic ``ContinuousScheduler.submit`` stand-in: the result
    depends only on the input bytes."""
    f = Future()
    f.set_result({"sum": int(image.astype(np.int64).sum()), "head": image[:4].astype(np.float32) / 7.0})
    return f


def make_shards(root: Path, n_shards=3, n_samples=8) -> list[str]:
    urls = []
    for i in range(n_shards):
        url = str(root / f"shard{i}.tar")
        write_tar_samples(url, [{"__key__": f"s{i}-{j}", "bin": bytes([i, j] * 16)} for j in range(n_samples)])
        urls.append(url)
    return urls


def run_job(shards, out, *, runner_cls=BatchJobRunner, spec_cls=JobSpec, registry=MetricsRegistry, **kw):
    spec_kw = dict(workers=2, submit_window=3, lease_s=0.3)
    spec_kw.update(kw)
    spec = spec_cls(shards=tuple(shards), output_dir=str(out), **spec_kw)
    runner = runner_cls(spec, stub_submit, registry=registry())
    return runner.run(), runner


def files_of(job: Path) -> dict[str, bytes]:
    out = {"manifest.json": (job / "manifest.json").read_bytes()}
    out.update({p.name: p.read_bytes() for p in sorted((job / "parts").iterdir())})
    return out


# -------------------------------------------------------------- partfile


def test_scan_truncates_torn_tail_not_prefix(tmp_path):
    p = tmp_path / "x.partial"
    with open(p, "wb") as f:
        for i in range(5):
            append_record(f, encode_record(f"k{i}", {"v": i}))
    whole = p.stat().st_size
    assert scan_part(p) == (5, whole)
    with open(p, "r+b") as f:
        f.truncate(whole - 3)
    n, good = scan_part(p)
    assert n == 4 and [r["key"] for r in iter_records(p)] == ["k0", "k1", "k2", "k3"]
    data = bytearray(p.read_bytes())
    data[good - 2] ^= 0xFF
    p.write_bytes(bytes(data))
    assert scan_part(p)[0] == 3
    assert scan_part(tmp_path / "absent.partial") == (0, 0)


def test_bad_magic_stops_scan(tmp_path):
    p = tmp_path / "x.partial"
    with open(p, "wb") as f:
        append_record(f, encode_record("k", {"v": 1}))
        f.write(b"GARBAGEGARBAGE")
    assert scan_part(p)[0] == 1
    assert MAGIC == b"JMB1" and struct.calcsize("<4sI8s") == 16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64, torch.bool])
def test_encoding_is_deterministic_and_equals_jax(dtype):
    rng = np.random.default_rng(0)
    ref = rng.standard_normal(6).astype(np.float32)
    t = torch.from_numpy(ref).to(dtype)
    as_np = t.float().numpy() if dtype == torch.bfloat16 else t.numpy()
    out = {"b": np.float32(1.5), "a": np.arange(3), "flag": np.bool_(True), "t": t, "scalar": t[0], "raw": b"xyz"}
    want = {**out, "t": as_np, "scalar": as_np[0]}
    assert encode_record("k", out) == encode_record("k", dict(reversed(out.items())))
    assert encode_record("k", out) == jax_encode_record("k", want)
    with pytest.raises(TypeError):
        encode_record("k", {"x": object()})


# ---------------------------------------------------------------- leases


def test_lease_claim_order_renew_complete():
    t = LeaseTable(["a", "b"], lease_s=10.0)
    s1, l1 = t.claim("w0")
    assert s1 == "a" and t.holds("a", "w0", l1) and t.renew("a", "w0", l1)
    assert t.claim("w1") == ("b", 2)
    assert t.complete("a", "w0", l1)
    assert t.counts() == {"pending": 0, "leased": 1, "done": 1} and not t.done()


def test_lease_expiry_steal_fences_old_holder():
    now = [0.0]
    events = []

    class J:
        def event(self, etype, **f):
            events.append({"type": etype, **f})

    t = LeaseTable(["a"], lease_s=1.0, clock=lambda: now[0], journal=J())
    _, l1 = t.claim("w0")
    assert t.claim("w1") is None
    now[0] = 2.0
    s2, l2 = t.claim("w1")
    assert (s2, t.steals) == ("a", 1) and l2 > l1  # the fence is monotone
    assert not t.holds("a", "w0", l1) and not t.renew("a", "w0", l1) and not t.complete("a", "w0", l1)
    assert not t.release("a", "w0", l1)
    assert t.complete("a", "w1", l2) and t.done()
    steal = [e for e in events if e.get("stolen_from")]
    assert steal and steal[0]["stolen_from"] == "w0" and steal[0]["lease"] == l2


def test_lease_release_makes_claimable_immediately():
    t = LeaseTable(["a"], lease_s=100.0)
    _, l1 = t.claim("w0")
    assert t.release("a", "w0", l1)
    assert t.claim("w1") is not None
    t.mark_done("a")
    assert t.done()


# ------------------------------------------------------------- job runner


def test_job_completes_and_rerun_is_noop(tmp_path):
    shards = make_shards(tmp_path)
    s, _ = run_job(shards, tmp_path / "out")
    assert s["complete"] and s["total_samples"] == 24
    m = read_manifest(tmp_path / "out" / "manifest.json")
    assert [e["shard"] for e in m["shards"]] == shards
    s2, _ = run_job(shards, tmp_path / "out")
    assert s2["already_complete"]
    events = [e["type"] for e in read_journal(tmp_path / "out" / "journal")]
    assert {"job_start", "job_lease", "job_shard_done", "job_complete"} <= set(events)


def test_job_metrics_have_eager_children(tmp_path):
    reg = MetricsRegistry()
    spec = JobSpec(shards=tuple(make_shards(tmp_path, n_shards=1)), output_dir=str(tmp_path / "o"))
    BatchJobRunner(spec, stub_submit, registry=reg)
    text = reg.render()
    for name in ("batch_job_shards", "batch_samples_processed_total", "batch_samples_resumed_total",
                 "batch_lease_steals_total", "batch_worker_crashes_total", "batch_submit_retries_total"):
        assert f"# TYPE {name} " in text
    assert 'batch_job_shards{state="pending"} 0' in text


def test_worker_killed_by_fault_steal_and_byte_identical(tmp_path, fault_plan):
    shards = make_shards(tmp_path)
    run_job(shards, tmp_path / "ctrl")
    fault_plan("batch.worker:raise@key~w0,n<1")
    s, runner = run_job(shards, tmp_path / "flt")
    faults.clear_plan()
    assert s["complete"] and s["lease_steals"] >= 1 and runner._m_crashes.value == 1
    assert files_of(tmp_path / "ctrl") == files_of(tmp_path / "flt")
    leases = [e for e in read_journal(tmp_path / "flt" / "journal") if e["type"] == "job_lease" and e.get("stolen_from")]
    assert leases and leases[0]["stolen_from"] == "w0"


def test_torn_partial_resumes_byte_identical(tmp_path):
    shards = make_shards(tmp_path, n_shards=1, n_samples=10)
    run_job(shards, tmp_path / "ctrl", workers=1)
    run_job(shards, tmp_path / "flt", workers=1)
    parts = tmp_path / "flt" / "parts"
    part = next(parts.glob("*.part"))
    partial = parts / (part.name[: -len(".part")] + ".partial")
    part.rename(partial)
    with open(partial, "r+b") as f:
        f.truncate(partial.stat().st_size - 5)
    (tmp_path / "flt" / "manifest.json").unlink()
    s, runner = run_job(shards, tmp_path / "flt", workers=1)
    assert s["complete"] and runner._m_resumed.value >= 9
    assert files_of(tmp_path / "ctrl") == files_of(tmp_path / "flt")


def test_graceful_stop_resumes_to_identical_manifest(tmp_path):
    shards = make_shards(tmp_path, n_shards=4, n_samples=12)
    run_job(shards, tmp_path / "ctrl")
    slow = threading.Event()

    def slow_submit(image, **kw):
        if not slow.is_set():
            time.sleep(0.01)
        return stub_submit(image, **kw)

    spec = JobSpec(shards=tuple(shards), output_dir=str(tmp_path / "flt"), workers=1, submit_window=2, lease_s=5.0)
    runner = BatchJobRunner(spec, slow_submit, registry=MetricsRegistry())
    out = {}
    t = threading.Thread(target=lambda: out.update(runner.run()))
    t.start()
    time.sleep(0.08)
    runner.request_stop()
    t.join(timeout=10.0)
    assert not t.is_alive() and not out["complete"]
    assert read_manifest(tmp_path / "flt" / "manifest.json") is None
    events = [e for e in read_journal(tmp_path / "flt" / "journal") if e["type"] == "shutdown"]
    assert events and events[-1]["reason"] == "preempted"
    slow.set()
    s, _ = run_job(shards, tmp_path / "flt")
    assert s["complete"]
    assert files_of(tmp_path / "ctrl") == files_of(tmp_path / "flt")


def test_quarantined_shard_excluded_job_completes(tmp_path, fault_plan):
    shards = make_shards(tmp_path, n_shards=2)
    bad = str(tmp_path / "bad.tar")
    Path(bad).write_bytes(b"not a tar at all")
    s, _ = run_job([shards[0], bad, shards[1]], tmp_path / "out", retry=RetryPolicy(attempts=2, backoff_s=0.01))
    assert s["complete"] and s["quarantined"] == [bad]
    m = read_manifest(tmp_path / "out" / "manifest.json")
    assert [e["shard"] for e in m["shards"]] == shards
    done = [e for e in read_journal(tmp_path / "out" / "journal")
            if e["type"] == "job_shard_done" and e.get("status") == "quarantined"]
    assert len(done) == 1 and done[0]["shard"] == bad


def test_submit_retries_typed_sheds(tmp_path):
    from jumbo_mae_tpu_tpu_torch.infer.batching import QueueFullError
    from jumbo_mae_tpu_tpu_torch.infer.replicaset import PoolUnhealthyError

    calls = []

    def flaky(image, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise QueueFullError("full")
        if len(calls) == 2:
            raise PoolUnhealthyError("healing")
        return stub_submit(image, **kw)

    reg = MetricsRegistry()
    spec = JobSpec(shards=tuple(make_shards(tmp_path, n_shards=1, n_samples=3)), output_dir=str(tmp_path / "o"),
                   workers=1)
    s = BatchJobRunner(spec, flaky, registry=reg).run()
    assert s["complete"] and reg.snapshot()["batch_submit_retries_total"][""] == 2


def test_job_spec_validation(tmp_path):
    with pytest.raises(ValueError):
        JobSpec(shards=(), output_dir=str(tmp_path))
    with pytest.raises(ValueError):
        JobSpec(shards=("a", "a"), output_dir=str(tmp_path))
    with pytest.raises(ValueError):
        JobSpec(shards=("a",), output_dir=str(tmp_path), workers=0)
    assert part_stem("gs://b/p/train-0001.tar") != part_stem("gs://b/q/train-0001.tar")
    assert part_stem("gs://b/p/train-0001.tar").startswith("train-0001-")


# ----------------------------------------------------- across the packages


@pytest.mark.parametrize("fault", [None, "batch.worker:raise@key~w0,n<1"])
def test_parts_and_manifest_byte_equal_jax(tmp_path, fault_plan, fault):
    from jumbo_mae_tpu_tpu import faults as jax_faults

    shards = make_shards(tmp_path, n_shards=3, n_samples=9)
    try:
        if fault:
            jax_faults.install_plan(fault)
        run_job(shards, tmp_path / "jax", runner_cls=JaxRunner, spec_cls=JaxSpec, registry=JaxRegistry)
    finally:
        jax_faults.clear_plan()
    if fault:
        fault_plan(fault)
    s, _ = run_job(shards, tmp_path / "port")
    assert s["complete"] and (s["lease_steals"] >= 1) == bool(fault)
    assert files_of(tmp_path / "port") == files_of(tmp_path / "jax")
    assert len(files_of(tmp_path / "port")) == 4


def test_each_doctor_passes_the_other_package_s_job(tmp_path):
    import tools.batch_doctor as jax_doctor

    shards = make_shards(tmp_path, n_shards=2)
    run_job(shards, tmp_path / "jax", runner_cls=JaxRunner, spec_cls=JaxSpec, registry=JaxRegistry)
    run_job(shards, tmp_path / "port")
    assert batch_doctor.main([str(tmp_path / "jax"), "--out", str(tmp_path / "a.md")]) == 0
    assert jax_doctor.main([str(tmp_path / "port"), "--out", str(tmp_path / "b.md")]) == 0
    assert "reconciles 100%" in (tmp_path / "a.md").read_text()
    assert "reconciles 100%" in (tmp_path / "b.md").read_text()


# ---------------------------------------------------------------- doctor


def test_batch_doctor_exit_codes_and_steal_attribution(tmp_path, fault_plan, capsys):
    shards = make_shards(tmp_path)
    fault_plan("batch.worker:raise@key~w0,n<1")
    run_job(shards, tmp_path / "job")
    faults.clear_plan()
    assert batch_doctor.main([str(tmp_path / "job")]) == 0
    report = capsys.readouterr().out
    assert "stolen from `w0`" in report and "reconciles 100%" in report
    part = next((tmp_path / "job" / "parts").glob("*.part"))
    data = bytearray(part.read_bytes())
    data[-1] ^= 0xFF
    part.write_bytes(bytes(data))
    assert batch_doctor.main([str(tmp_path / "job")]) == 2
    assert batch_doctor.main([str(tmp_path / "nowhere")]) == 2


def test_batch_doctor_flags_orphan_part(tmp_path):
    run_job(make_shards(tmp_path, n_shards=1), tmp_path / "job")
    (tmp_path / "job" / "parts" / "stray-deadbeef.part").write_bytes(b"")
    assert batch_doctor.main([str(tmp_path / "job")]) == 2


# --------------------------------------------------- cli.batch (subprocess)


def _batch_cmd(shards, out, per_item_ms) -> list[str]:
    return [sys.executable, "-m", "jumbo_mae_tpu_tpu_torch.cli.batch", *shards, "--out", str(out), "--workers", "2",
            "--lease-s", "1.0", "--service-per-item-ms", str(per_item_ms)]


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("GRAFT_FAULTS", None)
    return env


def test_sigkill_midrun_restart_manifest_byte_identical(tmp_path):
    shards = make_shards(tmp_path, n_shards=3, n_samples=10)
    env = _env()
    ctrl = subprocess.run(_batch_cmd(shards, tmp_path / "ctrl", 0.2), env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert ctrl.returncode == 0, ctrl.stderr[-2000:]
    proc = subprocess.Popen(_batch_cmd(shards, tmp_path / "flt", 30.0), env=env, cwd=REPO,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    deadline = time.monotonic() + 60.0
    parts = tmp_path / "flt" / "parts"
    while time.monotonic() < deadline:
        if parts.is_dir() and any(p.stat().st_size > 0 for p in parts.glob("*.partial")):
            break
        time.sleep(0.05)
    proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=30)
    assert read_manifest(tmp_path / "flt" / "manifest.json") is None
    resumed = subprocess.run(_batch_cmd(shards, tmp_path / "flt", 0.2), env=env, cwd=REPO, capture_output=True,
                             text=True, timeout=120)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    summary = json.loads(resumed.stdout.strip().splitlines()[-1])
    assert summary["complete"] and summary["samples_resumed"] > 0
    assert files_of(tmp_path / "ctrl") == files_of(tmp_path / "flt")
    doc = subprocess.run([sys.executable, "-m", "jumbo_mae_tpu_tpu_torch.tools.batch_doctor", str(tmp_path / "flt"),
                          "--out", str(tmp_path / "d.md")], env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert doc.returncode == 0, doc.stderr


def test_sigterm_drains_and_exits_resumable(tmp_path):
    # 40 samples a shard at 30 ms an item: the first durable window lands
    # long before the job could end, so the signal always meets work
    shards = make_shards(tmp_path, n_shards=2, n_samples=40)
    proc = subprocess.Popen(_batch_cmd(shards, tmp_path / "job", 30.0), env=_env(), cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    parts = tmp_path / "job" / "parts"
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline and not (parts.is_dir() and any(p.stat().st_size for p in parts.glob("*"))):
        time.sleep(0.05)
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=60)
    assert proc.returncode == 3 and "draining (resumable)" in err
    assert not json.loads(out.strip().splitlines()[-1])["complete"]


def test_cli_refuses_budgets_and_names_a5_4(tmp_path):
    """Budgets are enforced now (A5.4 is done): a malformed budget or
    window is what the CLI refuses, naming the tenant."""
    shards = make_shards(tmp_path, n_shards=1)
    with pytest.raises(ValueError, match="'batch' budget must be > 0"):
        cli_batch.main([*shards, "--out", str(tmp_path / "o"), "--tenants", "batch=batch:budget=0"])
    with pytest.raises(ValueError, match="'batch' window must be > 0"):
        cli_batch.main([*shards, "--out", str(tmp_path / "o"), "--tenants", "batch=batch:window=-1"])
    with pytest.raises(ValueError, match="unknown tenant option"):
        cli_batch.main([*shards, "--out", str(tmp_path / "o"), "--tenants", "batch=batch:budgt=2"])
    doc = cli_batch.__doc__
    assert "A5.4" not in doc and "tenant_usage" in doc and "cost_doctor" in doc
    flags = {a.dest for a in cli_batch.build_parser()._actions}
    assert {"tenants", "workers", "replicas", "max_batch", "lease_s", "submit_window", "config"} <= flags


def test_cli_stub_job_summary(tmp_path, capsys):
    shards = make_shards(tmp_path, n_shards=2, n_samples=5)
    assert cli_batch.main([*shards, "--out", str(tmp_path / "o"), "--service-overhead-ms", "0",
                           "--service-per-item-ms", "0"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["complete"] and summary["total_samples"] == 10 and summary["samples_processed"] == 10
    assert summary["replica_preemptions"] == 0
    assert summary["tenant_usage"]["batch"]["requests"] == 10  # the stub at 1 GFLOP an item
    assert summary["tenant_usage"]["batch"]["flops"] == 10 * 1e9
    part = tmp_path / "o" / "parts" / f"{part_stem(shards[1])}.part"
    want = [{"sum": 16 * (1 + j), "dim": 256} for j in range(5)]  # bytes([1, j] * 16), zero-padded to 256
    assert [r["out"] for r in iter_records(part)] == want


def test_cli_serves_engine_replicas_on_the_cpu(tmp_path, capsys):
    """With ``--config`` the job's samples are image members, decoded and
    served through two engine replicas; each record is the engine's
    feature row for that image."""
    pytest.importorskip("PIL")
    from jumbo_mae_tpu_tpu_torch.config import load_config
    from jumbo_mae_tpu_tpu_torch.data.toy import write_toy_shards
    from jumbo_mae_tpu_tpu_torch.data.shards import expand_shards
    from jumbo_mae_tpu_tpu_torch.data.tario import iter_tar_samples
    from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine

    urls = write_toy_shards(tmp_path / "shards", image_size=32, n_train=24, n_val=8, shard_size=12)
    shards = expand_shards(urls["train"])
    recipe = str(REPO / "recipes" / "smoke_cpu.yaml")
    argv = [*shards, "--out", str(tmp_path / "o"), "--config", recipe, "--device", "cpu", "--max-batch", "4",
            "--task", "features"]
    assert cli_batch.main(argv) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["complete"] and summary["total_samples"] == 24 and summary["engines"]["built"] == 2
    cfg = load_config(recipe)
    eng = InferenceEngine(cfg, device="cpu", warm_cache=False, max_batch=4)
    decode = cli_batch.image_decoder(eng.image_size, cfg.data.test_crop_ratio)
    samples = list(iter_tar_samples(shards[1]))
    want = eng.features(np.stack([decode(s) for s in samples]))
    part = tmp_path / "o" / "parts" / f"{part_stem(shards[1])}.part"
    got = list(iter_records(part))
    assert [r["key"] for r in got] == [s["__key__"] for s in samples]
    np.testing.assert_allclose(np.array([r["out"] for r in got], np.float32), want, rtol=1e-5, atol=1e-5)


def test_cli_budgeted_tenants_bill_and_log(tmp_path, capsys):
    """Two budgeted tenants' specs on the gate, the job submitting as one:
    ``tenant_usage`` bills Σ bucket × GFLOPs × 1e9 (the stub's bucket is
    its batch), every request has an ``ok`` row in ``<out>/access`` with
    its device_ms and cost_flops, the budget's rows journal it, and
    ``cost_doctor`` reconciles the rows with the ledger."""
    from jumbo_mae_tpu_tpu_torch.tools import cost_doctor

    shards = make_shards(tmp_path, n_shards=2, n_samples=9)
    out = tmp_path / "o"
    assert cli_batch.main([*shards, "--out", str(out), "--service-overhead-ms", "0.5", "--service-per-item-ms", "0.1",
                           "--tenants", "batch=batch:budget=0.002:window=2,web=interactive:budget=5",
                           "--model-gflops-per-item", "2.5", "--max-batch", "4"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["complete"] and summary["total_samples"] == 18
    events = read_journal(out / "access")
    rows = [e for e in events if e["type"] == "request"]
    ok = [r for r in rows if r["outcome"] == "ok"]
    assert len(ok) == 18 and all(r["tenant"] == "batch" and r["device_ms"] is not None for r in ok)
    assert all(r["outcome"] in ("ok", "shed") for r in rows)
    usage = summary["tenant_usage"]["batch"]
    # each flush bills bucket x 2.5 GFLOPs and the stub's bucket is its
    # batch: the flushes' buckets sum to the 18 samples
    assert usage["flops"] == pytest.approx(18 * 2.5e9, rel=1e-12)
    assert usage["requests"] == 18 and usage["budget_device_s"] == 0.002 and "over_budget" in usage
    assert summary["tenant_usage"]["web"]["requests"] == 0
    assert sum(r["cost_flops"] for r in ok) == pytest.approx(usage["flops"], rel=1e-12)
    assert cost_doctor.main([str(out / "access"), "--out", str(tmp_path / "cost.md")]) == 0
    report = (tmp_path / "cost.md").read_text()
    assert "agree" in report and "**disagree**" not in report and "| batch | batch | " in report
