"""The port's serve and memory doctors (``tools/serve_doctor.py``,
``tools/mem_doctor.py``) against the JAX package's top-level tools, on
fixtures in ``tmp_path`` written with the port's access log and journal:
the same report on stdout (or in ``--out``) and the same exit code, on
the cases of the JAX package's ``tests/test_serve_slo.py`` and
``tests/test_memwatch.py``."""

import pytest

import tools.mem_doctor as jax_mem_doctor
import tools.serve_doctor as jax_serve_doctor
from jumbo_mae_tpu_tpu_torch.obs.journal import RunJournal
from jumbo_mae_tpu_tpu_torch.obs.reqtrace import AccessLog
from jumbo_mae_tpu_tpu_torch.tools import mem_doctor, serve_doctor

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
