"""The port's serve, memory, run and perf doctors
(``tools/{serve,mem,run,perf}_doctor.py``) against the JAX package's
top-level tools, on fixtures in ``tmp_path`` written with the port's
access log and journal (the ledger's rows with JAX's ``make_row``): the
same report on stdout (or in ``--out``) and the same exit code, on the
cases of the JAX package's ``tests/test_serve_slo.py``,
``tests/test_memwatch.py``, ``tests/test_diagnostics.py`` (the run
doctor: an incident, a torn journal, a healthy run, no journal) and
``tests/test_costmodel.py`` (the perf doctor: a steady ledger, a
regression, a higher-is-better drop, an improvement, the noise band,
nothing to read, and a journal). One deliberate difference, ROADMAP C.R6:
on step rows that nest the drift under ``metrics``, as both train CLIs
write them, the port's perf doctor prints the drift line and JAX's does
not; rows with the drift at the top level read alike.

The port's ledger (``obs/perfledger.py``): ``make_row`` has JAX's keys,
``env_key`` is stable across calls and leaves out pid and argv,
``append_row``/``read_ledger`` survive a torn final line, and
``resolve_history_path`` reads ``$BENCH_HISTORY`` and takes
``off``/``0``/``none`` to disable it."""

import json

import pytest

import tools.mem_doctor as jax_mem_doctor
import tools.perf_doctor as jax_perf_doctor
import tools.run_doctor as jax_run_doctor
import tools.serve_doctor as jax_serve_doctor
from jumbo_mae_tpu_tpu.obs import perfledger as jledger
from jumbo_mae_tpu_tpu.obs.perfmodel import chip_spec as jax_chip_spec
from jumbo_mae_tpu_tpu.obs.perfmodel import prediction_asdict, roofline
from jumbo_mae_tpu_tpu_torch.obs import perfledger as tledger
from jumbo_mae_tpu_tpu_torch.obs.journal import RunJournal
from jumbo_mae_tpu_tpu_torch.obs.reqtrace import AccessLog
from jumbo_mae_tpu_tpu_torch.tools import mem_doctor, perf_doctor, run_doctor, serve_doctor

MB = 1024 * 1024


def write_access_log(tmp_path):
    """20 fast ok, 10 slow queue-wait-dominated ok (rids 20-29), 4 shed: a
    queue-pressure incident; plus a pool's events."""
    log = AccessLog(tmp_path / "access")
    for rid in range(20):
        log.event("request", rid=rid, outcome="ok", lat_ms=20.0, queue_wait_ms=4.0, admission_ms=2.0, compute_ms=12.0,
                  fetch_ms=2.0, batch=8, bucket=8, pad=0.0, replica=f"r{rid % 2}")
    for rid in range(20, 30):
        log.event("request", rid=rid, outcome="ok", lat_ms=600.0, queue_wait_ms=520.0, admission_ms=30.0,
                  compute_ms=40.0, fetch_ms=10.0, batch=2, bucket=2, pad=0.5, replica="r0", retries=1,
                  requeued_from="r1")
    for rid in range(30, 34):
        log.event("request", rid=rid, outcome="shed", lat_ms=0.1, queue_wait_ms=0.1)
    log.event("replica_crash", replica="r1", kind="crash", gen=0, err="RuntimeError: boom")
    log.event("swap_rollback", ckpt="/push/bad", stage="parity", detail="cosine_min -0.5 < 0.98")
    log.close()
    return tmp_path / "access"


def both(port_main, jax_main, argv, capsys) -> tuple:
    out = []
    for main in (port_main, jax_main):
        rc = main(list(argv))
        out.append((rc, capsys.readouterr().out))
    return out


@pytest.mark.parametrize("extra", [["--slo", "p99_latency_ms<=150;success_rate>=0.9"], [],
                                   ["--window-s", "0.5", "--slo", "success_rate>=0.99"]])
def test_serve_doctor_equals_jax(tmp_path, capsys, extra):
    path = write_access_log(tmp_path)
    (rc, report), ref = both(serve_doctor.main, jax_serve_doctor.main, [str(path), *extra], capsys)
    assert (rc, report) == ref and rc == 0
    assert "requests 20–29" in report and "queue_wait" in report and "← dominant" in report
    assert "requests 30–33" in report and "worst bucket by p99: **2**" in report
    if not extra:
        assert "auto slow-request threshold" in report


def test_serve_doctor_out_file_and_missing_logs(tmp_path, capsys):
    path = write_access_log(tmp_path)
    for main, name in ((serve_doctor.main, "p.md"), (jax_serve_doctor.main, "j.md")):
        assert main([str(path), "--slo", "p99_latency_ms<=150", "--out", str(tmp_path / name)]) == 0
    assert (tmp_path / "p.md").read_text() == (tmp_path / "j.md").read_text()
    assert "breached" in (tmp_path / "p.md").read_text()
    empty = AccessLog(tmp_path / "empty")
    empty.event("slo_summary", report={})  # events, no request rows
    empty.close()
    for main in (serve_doctor.main, jax_serve_doctor.main):
        assert main([str(tmp_path / "nope")]) == 2
        assert main([str(tmp_path / "empty")]) == 2


def run_dir(tmp_path, *, leak: bool, with_device: bool = True):
    with RunJournal(tmp_path / "journal", host=0) as j:
        j.event("run_start", config={}, env={}, start_step=0)
        for i in range(6):
            fields = {
                "step": 5 * (i + 1),
                "rss_bytes": 1000 * MB + (i * 64 * MB if leak else 0),
                "py_alloc_blocks": 100000 + i,
                "components": {"replica0_exec_cache": i * 60 * MB if leak else 0, "warmcache_disk": 4096},
            }
            if with_device:
                fields.update(device_bytes=700 * MB, device_peak_bytes=800 * MB,
                              hbm_drift={"features:cls/b64": 0.8}, hbm_capacity_bytes=80 * 1024 * MB)
            j.event("mem_sample", **fields)
        if leak:
            j.event("mem_leak_suspect", step=30, component="replica0_exec_cache", rss_growth_bytes=320 * MB,
                    robust_growth_bytes=320 * MB, slope_bytes_per_sample=64 * MB,
                    component_slope_bytes_per_sample=60 * MB, window=6, window_span_s=50.0)
        j.event("shutdown", reason="completed", step=30)
    return tmp_path


@pytest.mark.parametrize("leak,with_device,rc", [(True, True, 2), (False, True, 0), (False, False, 0)])
def test_mem_doctor_equals_jax(tmp_path, capsys, leak, with_device, rc):
    d = run_dir(tmp_path, leak=leak, with_device=with_device)
    (got_rc, report), ref = both(mem_doctor.main, jax_mem_doctor.main, [str(d)], capsys)
    assert (got_rc, report) == ref and got_rc == rc
    if leak:
        assert "leak suspected: **replica0_exec_cache**" in report and "| replica0_exec_cache |" in report
    if with_device:
        assert "OOM risk **low**" in report and "| features:cls/b64 | 0.8 |" in report  # 800 MiB of 80 GiB
    else:
        assert "OOM risk not assessable" in report and "no drift ratios" in report


def test_mem_doctor_nothing_to_diagnose(tmp_path, capsys):
    for main in (mem_doctor.main, jax_mem_doctor.main):
        assert main([str(tmp_path)]) == 2  # no journal at all
    with RunJournal(tmp_path / "journal", host=0) as j:
        j.event("run_start", config={}, env={}, start_step=0)
    for main in (mem_doctor.main, jax_mem_doctor.main):
        assert main([str(tmp_path)]) == 2  # a journal without mem samples
        assert "no mem_sample rows" in capsys.readouterr().err


# ------------------------------------------------------------- the run doctor


def incident_journal(tmp_path):
    """tests/test_diagnostics.py's incident: steps 5-7 non-finite with a
    diag row naming ``patch_embed``, a rollback, a flight record, a
    quarantined shard, a compiled program."""
    j = RunJournal(tmp_path / "journal")
    j.event("run_start", config={"run": {"name": "t", "mode": "pretrain", "training_steps": 12, "train_batch_size": 16}},
            env={"python": "3.10", "jax": "0.4", "backend": "cpu", "device_count": 1, "hostname": "h", "pid": 1},
            start_step=0, diag_every=1, diag_groups=["patch_embed", "jumbo_mlp", "decoder"])
    j.event("compiled_program", program="train_step", flops=1e9, bytes_accessed=2e8, source="analytic")
    for s in (1, 2, 3, 4):
        j.event("step", step=s, data_wait_fraction=0.05,
                metrics={"train/loss": 1.0, "train/grad_norm": 0.3 + 0.01 * s, "perf/images_per_sec": 300.0})
    for s in (5, 6, 7):
        j.event("sentinel_bad_step", step=s, loss="nan", reason="device_skip", streak=s - 4)
    j.event("step", step=7, metrics={"train/loss": "nan"}, data_wait_fraction=0.04, bad_steps=[5, 6, 7], diag_step=7,
            diag={"patch_embed": {"grad_norm": "nan", "param_norm": 1.0, "update_ratio": 0.0},
                  "jumbo_mlp": {"grad_norm": 2.0, "param_norm": 3.0, "update_ratio": 0.001},
                  "decoder": {"grad_norm": 1.0, "param_norm": 2.0, "update_ratio": 0.001}})
    j.event("rollback", from_step=7, to_step=4, rollbacks=1, bad_steps=[5, 6, 7])
    j.event("flight_record", reason="sentinel_rollback", path="x.json")
    j.event("quarantine", shards=["s3.tar"])
    j.event("step", step=12, metrics={"train/loss": 0.9, "perf/images_per_sec": 200.0}, data_wait_fraction=0.7)
    j.event("shutdown", reason="completed", step=12)
    j.close()
    return tmp_path


def test_run_doctor_equals_jax_on_an_incident(tmp_path, capsys):
    run_dir = incident_journal(tmp_path)
    flight = tmp_path / "flight.json"
    flight.write_text(json.dumps({"steps": [{"step": 6, "diag": {"decoder": {"grad_norm": "inf"}}}]}))
    for extra in ([], ["--flightrec", str(flight)], ["--flightrec", str(tmp_path / "missing.json")]):
        (rc, report), ref = both(run_doctor.main, jax_run_doctor.main, [str(run_dir), *extra], capsys)
        assert (rc, report) == ref and rc == 0
        assert "steps 5–7" in report and "**patch_embed**" in report and "1 sentinel rollback" in report
        assert "quarantined" in report and "completed" in report and "**data-bound**" in report
    for main, name in ((run_doctor.main, "p.md"), (jax_run_doctor.main, "j.md")):
        assert main([str(run_dir / "journal"), "--out", str(tmp_path / name)]) == 0
    assert (tmp_path / "p.md").read_text() == (tmp_path / "j.md").read_text()


def test_run_doctor_tolerates_a_torn_journal_and_needs_one(tmp_path, capsys):
    run_dir = incident_journal(tmp_path / "torn")
    seg = sorted((run_dir / "journal").glob("journal-*.jsonl"))[-1]
    with open(seg, "a") as f:
        f.write('{"torn": tr')
    (rc, report), ref = both(run_doctor.main, jax_run_doctor.main, [str(run_dir)], capsys)
    assert (rc, report) == ref and rc == 0 and "steps 5–7" in report
    assert both(run_doctor.main, jax_run_doctor.main, [str(tmp_path / "none")], capsys) == [(2, ""), (2, "")]
    empty = tmp_path / "empty" / "journal"
    empty.mkdir(parents=True)
    (empty / "journal-000000.jsonl").write_text("")
    assert both(run_doctor.main, jax_run_doctor.main, [str(empty)], capsys) == [(2, ""), (2, "")]


def test_run_doctor_healthy_run(tmp_path, capsys):
    j = RunJournal(tmp_path / "journal")
    j.event("run_start", config={}, env={}, start_step=0)
    j.event("step", step=5, metrics={"train/loss": 0.9})
    j.event("shutdown", reason="completed", step=5)
    j.close()
    (rc, report), ref = both(run_doctor.main, jax_run_doctor.main, [str(tmp_path)], capsys)
    assert (rc, report) == ref and rc == 0 and "no incidents recorded" in report


# ------------------------------------------------------------ the perf doctor


def jax_ledger(tmp_path, values, *, leg="ms_step_bf16", metric="ms_step"):
    """tests/test_costmodel.py's ledger: one row a value, JAX's make_row."""
    path = tmp_path / "BENCH_HISTORY.jsonl"
    pred = prediction_asdict(roofline(5e10, 2e9, jax_chip_spec("cpu"), batch=8))
    for v in values:
        jledger.append_row(path, jledger.make_row(bench="train", metric=metric, legs={leg: v},
                                                  quantiles={"p50_ms": v}, prediction=pred))
    return path


@pytest.mark.parametrize("values,leg,extra,code", [
    ([100.0, 102.0, 98.0, 101.0], "ms_step_bf16", [], 0),  # steady
    ([100.0, 102.0, 98.0, 160.0], "ms_step_bf16", [], 2),  # a regression
    ([1000.0, 990.0, 1010.0, 600.0], "engine_imgs_per_sec", [], 2),  # higher is better, dropped
    ([100.0, 102.0, 98.0, 60.0], "ms_step_bf16", [], 0),  # an improvement
    ([100.0, 102.0, 98.0, 106.0], "ms_step_bf16", ["--noise", "0.08"], 0),
    ([100.0, 102.0, 98.0, 106.0], "ms_step_bf16", ["--noise", "0.02"], 2),
])
def test_perf_doctor_ledger_mode_equals_jax(tmp_path, capsys, values, leg, extra, code):
    path = jax_ledger(tmp_path, values, leg=leg)
    (rc, report), ref = both(perf_doctor.main, jax_perf_doctor.main, [str(path), *extra], capsys)
    assert (rc, report) == ref and rc == code
    assert leg in report and ("REGRESSION" in report) == (code == 2)
    if code == 2 and leg == "ms_step_bf16":
        assert "roofline term: bandwidth" in report


def test_perf_doctor_nothing_to_read(tmp_path, capsys):
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    for path in (tmp_path / "nope.jsonl", empty):
        assert both(perf_doctor.main, jax_perf_doctor.main, [str(path)], capsys) == [(2, ""), (2, "")]


def test_perf_doctor_journal_mode_and_the_nested_drift(tmp_path, capsys):
    # no drift: the same report
    j = RunJournal(tmp_path / "a" / "journal")
    j.event("compiled_program", program="train_step", flops=1e9, bytes_accessed=1e8, peak_bytes=5e7,
            source="compiled", cost_schema=1)
    j.event("step", step=1, metrics={"train/loss": 1.0})
    j.close()
    (rc, report), ref = both(perf_doctor.main, jax_perf_doctor.main, [str(tmp_path / "a")], capsys)
    assert (rc, report) == ref and rc == 0 and "| train_step | 1000000000 |" in report
    assert "1 compiled program(s) with XLA cost accounting" in report
    # the drift at the top level: both read it
    j = RunJournal(tmp_path / "b" / "journal")
    j.event("compiled_program", program="train_step", flops=1e9, bytes_accessed=1e8, source="compiled")
    for s, d in ((1, 3.0), (2, 5.0), (3, 4.0)):
        j.event("step", step=s, metrics={}, **{"perf/predict_vs_measured": d})
    j.close()
    (rc, report), ref = both(perf_doctor.main, jax_perf_doctor.main, [str(tmp_path / "b")], capsys)
    assert (rc, report) == ref and rc == 0 and "last 4×, median 4×" in report
    # nested under metrics, as both CLIs write it (C.R6): the port reads it
    j = RunJournal(tmp_path / "c" / "journal")
    j.event("compiled_program", program="train_step", flops=1e9, bytes_accessed=1e8, source="analytic")
    for s, d in ((1, 3.0), (2, 5.0), (3, 4.0)):
        j.event("step", step=s, metrics={"perf/predict_vs_measured": d})
    j.close()
    (rc, report), (jrc, jreport) = both(perf_doctor.main, jax_perf_doctor.main, [str(tmp_path / "c")], capsys)
    assert rc == jrc == 0
    assert "last 4×, median 4×" in report and "predicted-vs-measured" not in jreport
    assert "with analytic cost accounting" in report and "with XLA cost accounting" in jreport


# ------------------------------------------------------------ the ledger


def test_ledger_rows_keys_env_key_and_torn_lines(tmp_path, monkeypatch):
    kw = dict(bench="train", metric="ms_step", legs={"ms_step": 1.0}, quantiles={"p50_ms": 1.0},
              prediction={"bound": "compute"}, extra={"note": "x"})
    row, jrow = tledger.make_row(**kw), jledger.make_row(**kw)
    assert row.keys() == jrow.keys() and row["schema"] == tledger.LEDGER_SCHEMA == jledger.LEDGER_SCHEMA
    assert tledger.DEFAULT_LEDGER == jledger.DEFAULT_LEDGER
    assert row["env"]["device_kind"] and "pid" not in row["env"] and "argv" not in row["env"]
    assert {"torch", "backend", "device_count", "hostname"} <= row["env"].keys()
    env = tledger.comparable_env()
    assert tledger.env_key(env) == tledger.env_key(tledger.comparable_env()) == row["env_key"]
    monkeypatch.setattr("sys.argv", ["other", "--flag"])
    assert tledger.env_key(tledger.comparable_env()) == row["env_key"]
    path = tmp_path / "sub" / "BENCH_HISTORY.jsonl"
    assert tledger.append_row(path, row)
    with open(path, "a") as f:
        f.write('{"schema": 1, "bench": "tr')  # a crash mid-write
    assert tledger.append_row(path, tledger.make_row(**dict(kw, legs={"ms_step": 2.0})))
    rows = tledger.read_ledger(path)
    assert [r["legs"]["ms_step"] for r in rows] == [1.0, 2.0]
    assert [r["legs"]["ms_step"] for r in jledger.read_ledger(path)] == [1.0, 2.0]
    # best-effort: a directory where the file should be fails without raising
    assert not tledger.append_row(tmp_path, row)
    monkeypatch.setenv("BENCH_HISTORY", str(tmp_path / "env.jsonl"))
    assert tledger.resolve_history_path() == tmp_path / "env.jsonl"
    assert tledger.resolve_history_path("cli.jsonl").name == "cli.jsonl"
    for off in ("off", "0", "none", "OFF", ""):
        monkeypatch.setenv("BENCH_HISTORY", off)
        assert tledger.resolve_history_path() is None and jledger.resolve_history_path() is None
    monkeypatch.delenv("BENCH_HISTORY")
    assert str(tledger.resolve_history_path()) == str(jledger.resolve_history_path()) == "BENCH_HISTORY.jsonl"
