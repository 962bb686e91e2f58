"""What watches a live training run, on the CPU, against the JAX package.

(a) The goodput ledger: both packages' ``GoodputLedger`` driven by the
    same scripted calls on a fake clock (the cases of ``test_goodput.py``):
    the same snapshots, fractions, conservation errors, reports and
    ``goodput_*`` gauges, and the same refusals.
(b) ``stitch_generations``, ``advise_ckpt_interval`` and the goodput
    doctor (the port's ``tools/goodput_doctor.py`` against the top-level
    one) on the same journals: equal dicts, the same report text and exit
    codes.
(c) The flight recorder: the same dumps for the same steps and events
    (``written_at`` aside), file names, the ring bound, a new file per
    dump, ``ring_bytes``, the SIGTERM and excepthook chains with
    uninstall, and the atexit fallback.
(d) The hang watchdog under the same beats, arms, ``expected()`` windows
    and checks on a fake clock, with an injected ``exit_fn``: the same
    verdicts and fired ``info``; the poll thread fires on its own.
(e) The chrome trace: the same ``(name, ph)`` counts for the same spans;
    ``trace()`` writes a ``torch.profiler`` trace that names the regions.
(f) The port's CLI on ``recipes/smoke_cpu.yaml``: a child process wedged
    by ``fleet.wedge`` at step 2 (deadline 2 s) exits 44 with
    ``hang_detected``, a ``reason: "hang"`` goodput report and a flight
    record; a SIGTERM dumps the
    recorder and then saves; ``run.telemetry`` on port 0 answers
    ``/metrics`` and ``/healthz`` mid-run, and ``run.chrome_trace`` writes
    its trace (``run.profile_dir`` is ``trace()`` around the engine, held
    on the card by ``chip_smoke.py`` phase 27).
"""

import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from collections import Counter
from pathlib import Path

import pytest
import torch

import tools.goodput_doctor as jdoctor
from jumbo_mae_tpu_tpu.obs import flightrec as jflightrec
from jumbo_mae_tpu_tpu.obs import goodput as jgoodput
from jumbo_mae_tpu_tpu.obs import hangwatch as jhangwatch
from jumbo_mae_tpu_tpu.obs import metrics as jmetrics
from jumbo_mae_tpu_tpu_torch.cli import train as ttrain
from jumbo_mae_tpu_tpu_torch.config import load_config
from jumbo_mae_tpu_tpu_torch.obs import flightrec as tflightrec
from jumbo_mae_tpu_tpu_torch.obs import goodput as tgoodput
from jumbo_mae_tpu_tpu_torch.obs import hangwatch as thangwatch
from jumbo_mae_tpu_tpu_torch.obs import metrics as tmetrics
from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal
from jumbo_mae_tpu_tpu_torch.tools import goodput_doctor as tdoctor
from jumbo_mae_tpu_tpu_torch.train.engine import EXIT_HANG

# the packages' obs/__init__.py export the function ``trace`` over the module
jtrace = importlib.import_module("jumbo_mae_tpu_tpu.obs.trace")
ttrace = importlib.import_module("jumbo_mae_tpu_tpu_torch.obs.trace")
REPO = Path(__file__).resolve().parent.parent
SMOKE = REPO / "recipes" / "smoke_cpu.yaml"
SIDES = {"jax": (jgoodput, jflightrec, jhangwatch, jmetrics, jtrace),
         "port": (tgoodput, tflightrec, thangwatch, tmetrics, ttrace)}


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# ------------------------------------------------------------------ (a) the ledger

# each script: (op, *args); "check" records every reading of the ledger
LEDGER_SCRIPTS = {
    "first_dispatch_compiles": [("advance", 5.0), ("note_step", 1, 4.0), ("note_step", 2, 0.5), ("check",)],
    "rollback_recompute": [("note_step", 1, 1.0), *[("note_step", s, 0.5) for s in (1, 2, 3, 4)],
                           ("advance", 10.0), ("note_rollback", 4, 2), ("note_step", 3, 0.5), ("check",),
                           ("note_step", 4, 0.5), ("note_step", 5, 0.5), ("check",)],
    "double_rollback_high_watermark": [("note_step", 0, 1.0), ("note_rollback", 6, 2), ("note_rollback", 4, 2),
                                       *[("note_step", s, 0.25) for s in (3, 4, 5, 6, 7)], ("advance", 9.0),
                                       ("check",)],
    "idle_residual": [("advance", 10.0), ("add", "productive", 3.0), ("add", "data_wait", 2.0), ("check",)],
    "over_attribution": [("advance", 1.0), ("add", "productive", 3.0), ("check",)],
    "negative_spans": [("advance", 1.0), ("add", "eval", -5.0), ("note_step", 1, -2.0), ("check",)],
    "every_bucket": [("advance", 30.0), ("note_step", 1, 2.0), ("add", "data_wait", 0.25), ("add", "eval", 1.5),
                     ("add", "ckpt_save", 0.75), ("add", "ckpt_restore", 1.25), ("add", "hang_latency", 3.0),
                     ("add", "restart_downtime", 0.5), ("add", "compile", 0.125), ("note_step", 2, 1.0),
                     ("check",), ("advance", 2.5), ("check",)],
}


def _drive_ledger(mod, metrics, script, generation=0):
    clock, reg = FakeClock(), metrics.MetricsRegistry()
    led = mod.GoodputLedger(generation=generation, clock=clock, registry=reg)
    seen = []
    for op, *args in script:
        if op == "advance":
            clock.t += args[0]
        elif op == "check":
            led.publish()
            seen.append((led.snapshot(), led.fraction(), led.conservation_error(), led.wall_s(),
                         led.report(step=7, reason="interval"), led.report(), reg.snapshot()))
        else:
            getattr(led, op)(*args)
    for bad in ("coffee", "idle"):  # idle is computed, never charged
        with pytest.raises(KeyError):
            led.add(bad, 1.0)
    return seen


@pytest.mark.parametrize("name", sorted(LEDGER_SCRIPTS))
def test_ledger_equals_jax(name):
    script = LEDGER_SCRIPTS[name]
    got = _drive_ledger(tgoodput, tmetrics, script, generation=3)
    want = _drive_ledger(jgoodput, jmetrics, script, generation=3)
    assert got == want and len(got) >= 1
    snap, _, _, wall, rep, *_ = got[-1]
    assert set(rep["buckets"]) == set(tgoodput.GOODPUT_BUCKETS) and rep["generation"] == 3
    assert sum(snap.values()) >= wall - 1e-9  # idle absorbs the residual
    assert tgoodput.GOODPUT_BUCKETS == jgoodput.GOODPUT_BUCKETS
    assert [tgoodput.bucket_display(b) for b in (*tgoodput.GOODPUT_BUCKETS, "x_y")] == \
        [jgoodput.bucket_display(b) for b in (*jgoodput.GOODPUT_BUCKETS, "x_y")]


# ------------------------------------------------- (b) stitching, advisor and doctor


def _buckets(**kw):
    return {b: float(kw.get(b, 0.0)) for b in jgoodput.GOODPUT_BUCKETS}


def _two_generations():
    """An elastic run killed by a hang and relaunched (``test_goodput.py``'s
    journal): gen 0 trains to step 8, commits 4, wedges; gen 1 resumes
    from 4 and completes at 10."""
    return [
        {"ts": 1000.5, "type": "run_start", "generation": 0, "start_step": 0},
        *({"ts": 1000.0 + s, "type": "step", "step": s} for s in range(1, 9)),
        {"ts": 1004.5, "type": "checkpoint_save", "step": 4, "save_seconds": 0.4},
        {"ts": 1012.0, "type": "hang_detected", "step": 8, "stalled_s": 4.0, "deadline_s": 4.0},
        {"ts": 1012.5, "type": "goodput_report", "generation": 0, "wall_s": 12.5, "steps": 7, "reason": "hang",
         "buckets": _buckets(productive=6.0, compile=1.0, data_wait=0.5, ckpt_save=0.4, idle=4.6)},
        {"ts": 1016.0, "type": "elastic_restart", "role": "supervisor", "reason": "hang", "generation": 1,
         "backoff_s": 0.5},
        {"ts": 1020.5, "type": "run_start", "generation": 1, "start_step": 4},
        *({"ts": 1021.0 + i, "type": "step", "step": 5 + i} for i in range(6)),
        {"ts": 1027.0, "type": "checkpoint_save", "step": 10, "save_seconds": 0.4},
        {"ts": 1030.0, "type": "goodput_report", "generation": 1, "wall_s": 10.0, "steps": 9, "reason": "completed",
         "buckets": _buckets(productive=4.0, compile=1.0, data_wait=0.3, ckpt_save=0.4, ckpt_restore=0.5,
                             rollback_recompute=1.0, idle=2.8)},
        {"ts": 1029.0, "type": "goodput_report", "host": 1, "generation": 1, "wall_s": 9.0, "steps": 9,
         "buckets": {"productive": 99.0}},  # a host-1 row is not host 0's record
        {"ts": 1030.0, "type": "shutdown", "reason": "completed", "step": 10},
    ]


JOURNALS = {
    "two_generations": _two_generations(),
    "one_generation": [
        {"ts": 10.0, "type": "run_start", "generation": 0, "start_step": 0},
        {"ts": 12.0, "type": "step", "step": 2},
        {"ts": 13.0, "type": "checkpoint_save", "step": 2, "save_seconds": "bad"},
        {"ts": 14.0, "type": "goodput_report", "generation": 0, "wall_s": 5.0, "steps": 2,
         "buckets": {"productive": 3.0, "compile": 1.0, "idle": 1.0, "eval": "x"}},
        {"ts": 14.0, "type": "shutdown", "reason": "completed", "step": 2},
    ],
    "no_checkpoint": [
        {"ts": 10.0, "type": "run_start", "generation": 0, "start_step": 0},
        {"ts": 12.0, "type": "shutdown", "reason": "completed", "step": 0},
    ],
    "empty": [],
}


def _write_journal(directory: Path, events: list[dict]) -> None:
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / "journal-00000.jsonl", "w") as f:
        for i, e in enumerate(events):
            f.write(json.dumps({"seq": i, **e}) + "\n")


@pytest.mark.parametrize("name", sorted(JOURNALS))
def test_stitch_and_doctor_equal_jax(name, tmp_path, capsys):
    events = JOURNALS[name]
    got = tgoodput.stitch_generations([dict(e) for e in events])
    assert got == jgoodput.stitch_generations([dict(e) for e in events])
    if not events:
        # an empty journal: nothing to report, exit 2 in both doctors
        _write_journal(tmp_path / "journal", events)
        assert tdoctor.main([str(tmp_path)]) == jdoctor.main([str(tmp_path)]) == 2
        assert tdoctor.main([str(tmp_path / "nothing")]) == jdoctor.main([str(tmp_path / "nothing")]) == 2
        return
    _write_journal(tmp_path / "journal", events)
    assert tdoctor.diagnose(events) == jdoctor.diagnose(events)
    assert tdoctor.main([str(tmp_path), "--out", str(tmp_path / "t.md")]) == 0
    assert jdoctor.main([str(tmp_path), "--out", str(tmp_path / "j.md")]) == 0
    report = (tmp_path / "t.md").read_text()
    assert report == (tmp_path / "j.md").read_text()
    assert "conservation: **OK**" in report
    if name == "two_generations":
        assert got["failures"] == 1 and got["steps_lost"] == 4 and "| 1 | hang |" in report
        assert "top non-productive bucket: **restart downtime**" in report and "run.ckpt_every=" in report


@pytest.mark.parametrize("args", [
    (2.0, 10000.0, 0.5, None), (1.0, 0.0, 0.1, 800.0), (0.0, 0.0, 0.0, None), (3.7, -5.0, 0.02, 12.5),
    (0.25, 3600.0, 1e-9, None),
])
def test_advisor_equals_jax(args):
    cost, mtbf, step, span = args
    got = tgoodput.advise_ckpt_interval(cost, mtbf, step, observed_span_s=span)
    assert got == jgoodput.advise_ckpt_interval(cost, mtbf, step, observed_span_s=span)
    assert got["ckpt_every"] >= 1


# ----------------------------------------------------------- (c) the flight recorder


def _feed(fr, n_steps: int, n_events: int) -> None:
    for i in range(n_steps):
        fr.record_step(i, {"loss": float("nan") if i == 3 else float(i), "grad_norm": i / 7, "skipped": i == 3})
    for i in range(n_events):
        fr.record_event({"type": f"e{i}", "ts": 1.5 * i, "payload": [i, {"x": float("inf")}]})


@pytest.mark.parametrize("host,capacity,event_capacity", [(0, 4, 2), (0, 256, 128), (1, 1, 1), (3, 0, 0)])
def test_flight_recorder_dumps_equal_jax(tmp_path, host, capacity, event_capacity):
    dumps = {}
    for side, (_, frmod, *_) in SIDES.items():
        fr = frmod.FlightRecorder(tmp_path / side, capacity=capacity, event_capacity=event_capacity, host=host)
        _feed(fr, 10, 3)
        paths = [fr.dump("nonfinite_step", extra={"bad_steps": [3], "first_nonfinite_group": None}),
                 fr.dump("sentinel_rollback")]
        assert fr.dumps == [str(p) for p in paths] and paths[0] != paths[1]
        data = [json.loads(p.read_text()) for p in paths]
        for d in data:
            assert abs(d.pop("written_at") - time.time()) < 60
        dumps[side] = (data, fr.ring_bytes())
        tag = "" if host == 0 else f"h{host}-"
        assert all(p.name.startswith(f"flightrec-{tag}") for p in paths)
        assert [p.name.rsplit("-", 2)[-2:] for p in paths] == [["01", "nonfinite_step.json"],
                                                               ["02", "sentinel_rollback.json"]]
    (tdata, tbytes), (jdata, jbytes) = dumps["port"], dumps["jax"]
    assert tdata == jdata and tbytes == jbytes
    ring = max(1, capacity)
    assert [s["step"] for s in tdata[0]["steps"]] == list(range(10))[-ring:]
    assert len(tdata[0]["events"]) == min(3, max(1, event_capacity)) and tdata[0]["host"] == host
    if capacity >= 7:
        assert tdata[0]["steps"][3]["loss"] == "nan"  # a non-finite loss dumps as a string


def test_flight_recorder_hooks_chain_and_uninstall(tmp_path):
    for side, (_, frmod, *_) in SIDES.items():
        fr = frmod.FlightRecorder(tmp_path / side)
        hits, seen = [], []
        prev_sig, prev_hook = signal.getsignal(signal.SIGTERM), sys.excepthook
        try:
            signal.signal(signal.SIGTERM, lambda s, f: hits.append(s))
            mine = signal.getsignal(signal.SIGTERM)
            sys.excepthook = lambda *a: seen.append(a)
            hook = sys.excepthook
            assert fr.install() and fr.install()  # a second install is a no-op
            handler = signal.getsignal(signal.SIGTERM)
            handler(signal.SIGTERM, None)  # the dump, then the previous handler
            sys.excepthook(ValueError, ValueError("boom"), None)
            assert hits == [signal.SIGTERM] and len(seen) == 1
            names = [Path(d).name for d in fr.dumps]
            assert names[0].endswith(f"-01-signal_{int(signal.SIGTERM)}.json")
            assert names[1].endswith("-02-exception.json")
            assert json.loads(Path(fr.dumps[1]).read_text())["extra"] == {"error": "ValueError: boom"}
            fr.uninstall()
            assert signal.getsignal(signal.SIGTERM) is mine
            if side == "port":
                assert sys.excepthook is hook
            else:
                # the reference's uninstall compares a fresh bound method with
                # `is`, so its hook stays installed (ROADMAP C.R)
                assert sys.excepthook == fr._excepthook
                sys.excepthook = hook
            # a handler replaced since install is not put back over
            fr.install()
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
            fr.uninstall()
            assert signal.getsignal(signal.SIGTERM) is signal.SIG_IGN
        finally:
            signal.signal(signal.SIGTERM, prev_sig)
            sys.excepthook = prev_hook
        # the atexit fallback writes only when something abnormal was seen
        # and nothing was dumped
        quiet = frmod.FlightRecorder(tmp_path / side / "quiet")
        quiet._atexit()
        assert quiet.dumps == []
        quiet.mark_abnormal()
        quiet._atexit()
        assert [Path(d).name.endswith("-01-atexit.json") for d in quiet.dumps] == [True]
        quiet._atexit()
        assert len(quiet.dumps) == 1


# -------------------------------------------------------------- (d) the hang watchdog

# (op, *args) against the watchdog at the fake clock's time
HANG_SCRIPTS = {
    "unarmed_never_fires": [("beat", 1), ("advance", 100.0), ("check",)],
    "armed_fires_once": [("beat", 1), ("arm",), ("advance", 4.0), ("beat", 2), ("advance", 9.5), ("check",),
                         ("advance", 0.5), ("check",), ("advance", 5.0), ("check",)],
    "expected_suspends_and_restarts": [("arm",), ("beat", 3), ("enter", "eval"), ("advance", 50.0), ("check",),
                                       ("enter", "checkpoint"), ("exit",), ("advance", 50.0), ("check",),
                                       ("exit",), ("advance", 9.0), ("check",), ("advance", 1.0), ("check",)],
    "disarm_stands_down": [("arm",), ("beat", 5), ("advance", 8.0), ("disarm",), ("advance", 30.0), ("check",),
                           ("arm",), ("advance", 9.0), ("check",), ("advance", 2.0), ("check",)],
    "zero_deadline_never_fires": [("deadline", 0.0), ("arm",), ("advance", 1e6), ("check",)],
}


def _drive_hangwatch(mod, script):
    clock, exits, infos, drained = FakeClock(), [], [], []
    hw = mod.HangWatchdog(10.0, clock=clock, exit_fn=exits.append, drain=lambda: drained.append(clock.t))
    hw.on_fire(infos.append)
    hw.on_fire(lambda info: 1 / 0)  # a raising callback is swallowed: the exit must happen
    open_windows, trace = [], []
    for op, *args in script:
        if op == "advance":
            clock.t += args[0]
        elif op == "check":
            trace.append((hw.check(), hw.fired, clock.t))
        elif op == "enter":
            cm = hw.expected(args[0])
            cm.__enter__()
            open_windows.append(cm)
        elif op == "exit":
            open_windows.pop().__exit__(None, None, None)
        elif op == "deadline":
            hw.deadline_s = args[0]
        else:
            getattr(hw, op)(*args)
    return trace, infos, exits, drained


@pytest.mark.parametrize("name", sorted(HANG_SCRIPTS))
def test_hang_watchdog_equals_jax(name):
    got = _drive_hangwatch(thangwatch, HANG_SCRIPTS[name])
    assert got == _drive_hangwatch(jhangwatch, HANG_SCRIPTS[name])
    trace, infos, exits, drained = got
    assert len(infos) == len(exits) == len(drained) == sum(fired for fired, _, _ in trace) <= 1
    if infos:
        assert exits == [EXIT_HANG] and infos[0]["stalled_s"] >= infos[0]["deadline_s"] == 10.0
    assert thangwatch.DEFAULT_EXIT_CODE == jhangwatch.DEFAULT_EXIT_CODE == EXIT_HANG


def test_hang_watchdog_poll_thread_fires_and_stops():
    exits, done = [], threading.Event()

    def exit_fn(code):
        exits.append(code)
        done.set()

    hw = thangwatch.HangWatchdog(0.05, exit_fn=exit_fn, poll_s=0.01, drain=lambda: None)
    hw.start()
    hw.start()  # idempotent
    hw.arm()
    assert done.wait(5.0) and exits == [EXIT_HANG] and hw.fired
    hw.stop()
    quiet = thangwatch.HangWatchdog(0.05, exit_fn=exits.append, poll_s=0.01)
    quiet.start()
    quiet.stop()  # never armed: nothing fires
    assert exits == [EXIT_HANG] and not quiet.fired


# --------------------------------------------------------------- (e) traces


def test_chrome_trace_counts_equal_jax(tmp_path):
    counts = {}
    for side, (_, _, _, metrics, tr) in SIDES.items():
        reg = metrics.MetricsRegistry()
        tr.start_chrome_trace()
        try:
            for i in range(5):
                with tr.span("data_wait", registry=reg):
                    pass
                t = tr.span_timer("train_step", registry=reg)
                with t:
                    pass
                assert t.last_s >= 0.0
            tr.span_timer("checkpoint_save", registry=reg).observe(0.25)
            with pytest.raises(RuntimeError), tr.span("eval", registry=reg):
                raise RuntimeError("the span still closes")
            data = json.loads(tr.export_chrome_trace(tmp_path / side / "trace.json").read_text())
        finally:
            tr.stop_chrome_trace()
        counts[side] = (Counter((e["name"], e["ph"]) for e in data["traceEvents"]), data["displayTimeUnit"],
                        {k: v for k, v in reg.snapshot()["span_seconds"].items()})
        with tr.span("after_stop", registry=reg):
            pass  # stopped: the histogram still counts, the buffer takes nothing
        assert json.loads(tr.export_chrome_trace(tmp_path / side / "t2.json").read_text())["traceEvents"] == []
    (tc, tunit, tsnap), (jc, junit, jsnap) = counts["port"], counts["jax"]
    assert tc == jc == Counter({("data_wait", "X"): 5, ("train_step", "X"): 5, ("checkpoint_save", "X"): 1,
                                ("eval", "X"): 1})
    assert tunit == junit == "ms"
    assert {k: v["count"] for k, v in tsnap.items()} == {k: v["count"] for k, v in jsnap.items()}


def test_profile_names_the_regions(tmp_path, capsys):
    with ttrace.trace(None), ttrace.trace(""):
        pass  # falsy: a no-op
    assert list(tmp_path.iterdir()) == []
    x = torch.randn(64, 64)
    with ttrace.trace(tmp_path / "prof"):
        with ttrace.annotate("watch_region"):
            for _ in range(3):
                x = torch.mm(x, x).tanh()
    (path,) = (tmp_path / "prof").glob("profile-*.json")
    names = Counter(e.get("name") for e in json.loads(path.read_text())["traceEvents"])
    assert names["watch_region"] == 1 and names["aten::mm"] == 3
    assert f"[obs] device profile -> {path} ({path.stat().st_size} bytes" in capsys.readouterr().out


# ----------------------------------------------------------- (f) the port's CLI


def _overrides(out, steps, *extra):
    return [f"run.output_dir={out}", f"run.training_steps={steps}", f"optim.training_steps={steps}",
            "run.sanity_eval=false", *extra]


# the watchdog arms after step 1 and step 2's beat follows at once (no log
# window between), so the wedge of step 2 is the only stall it can see:
# on a loaded CPU a whole step can take longer than the deadline
HANG_DEADLINE_S = 2.0


def test_a_wedged_step_exits_44_with_its_records(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    argv = [sys.executable, "-m", "jumbo_mae_tpu_tpu_torch.cli.train", "--config", str(SMOKE), "--device", "cpu",
            "--set", *_overrides(tmp_path, 6, f"run.hangwatch_deadline_s={HANG_DEADLINE_S:g}", "run.log_interval=100",
                                 "run.faults=fleet.wedge:delay(60)@key~2,n<1")]
    r = subprocess.run(argv, cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == EXIT_HANG, r.stdout[-2000:] + r.stderr[-2000:]
    assert "[train] HANG: no step progress for" in r.stdout and "exiting 44" in r.stdout
    events = read_journal(tmp_path / "smoke_cpu")
    (hang,) = [e for e in events if e["type"] == "hang_detected"]
    assert hang["step"] == 2 and hang["deadline_s"] == HANG_DEADLINE_S <= hang["stalled_s"] < 60 and hang["host"] == 0
    (report,) = [e for e in events if e["type"] == "goodput_report"]
    assert report["reason"] == "hang" and report["step"] == 2 and report["buckets"]["hang_latency"] >= HANG_DEADLINE_S
    assert report["conservation_error"] == 0.0 and report["steps"] == 0  # step 1 compiled, step 2 wedged
    assert [e["type"] for e in events] == ["run_start", "hang_detected", "goodput_report"]
    (rec,) = (tmp_path / "smoke_cpu").glob("flightrec-*-hang_detected.json")
    data = json.loads(rec.read_text())
    assert data["extra"]["step"] == 2 and data["extra"]["stalled_s"] == hang["stalled_s"]
    assert [e["type"] for e in data["events"]] == ["run_start", "hang_detected", "goodput_report"]


def test_sigterm_dumps_the_recorder_then_saves(tmp_path, monkeypatch):
    real = ttrain.make_train_step

    def sigterm_at_3(**kw):
        step = real(**kw)

        def wrapped(state, batch, *inject):
            out = step(state, batch, *inject)
            if out[0].step == 3:
                os.kill(os.getpid(), signal.SIGTERM)  # delivered to this process's handler chain
            return out

        return wrapped

    monkeypatch.setattr(ttrain, "make_train_step", sigterm_at_3)
    before = signal.getsignal(signal.SIGTERM)
    out = ttrain.train(load_config(SMOKE, _overrides(tmp_path, 6, "run.log_interval=1", "run.eval_interval=100")),
                       device="cpu")
    assert out["_exit_reason"] == "preempted" and signal.getsignal(signal.SIGTERM) is before
    run_dir = tmp_path / "smoke_cpu"
    (rec,) = run_dir.glob(f"flightrec-*-01-signal_{int(signal.SIGTERM)}.json")
    data = json.loads(rec.read_text())
    events = read_journal(run_dir)
    (save,) = [e for e in events if e["type"] == "checkpoint_save"]
    assert save["step"] == 3 and save["preemption"] is True
    assert data["written_at"] <= save["ts"]  # the dump first, then the graceful save
    assert [s["step"] for s in data["steps"]] == [1, 2]  # step 3's window was not fetched yet
    report = [e for e in events if e["type"] == "goodput_report"]
    assert [(r["step"], r["reason"]) for r in report] == [(3, "preempted")]  # a preemption save writes none
    assert events[-1]["type"] == "shutdown" and events[-1]["reason"] == "preempted"


def test_telemetry_answers_mid_run_and_traces_are_written(tmp_path, monkeypatch):
    servers, scraped = [], {}

    class Recorded(ttrain.TelemetryServer):
        def start(self):
            servers.append(super().start())
            return servers[-1]

    real = ttrain.make_train_step

    def scrape_at_3(**kw):
        step = real(**kw)

        def wrapped(state, batch, *inject):
            out = step(state, batch, *inject)
            if out[0].step == 3:
                base = f"http://127.0.0.1:{servers[0].port}"
                with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
                    scraped["metrics"] = r.read().decode()
                with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
                    scraped["healthz"] = (r.status, json.loads(r.read()))
            return out

        return wrapped

    monkeypatch.setattr(ttrain, "TelemetryServer", Recorded)
    monkeypatch.setattr(ttrain, "make_train_step", scrape_at_3)
    ct = tmp_path / "chrome.json"
    out = ttrain.train(load_config(SMOKE, _overrides(
        tmp_path, 6, "run.telemetry=true", "run.telemetry_port=0", "run.telemetry_host=127.0.0.1",
        "run.log_interval=1", "run.eval_interval=100", f"run.chrome_trace={ct}",
    )), device="cpu")
    assert out["_exit_reason"] == "completed"
    text = scraped["metrics"]
    for name in ("train_steps_total", "train_mfu", "goodput_fraction", 'span_seconds_count{name="train_step"}',
                 "run_generation", "train_grad_norm", 'goodput_bucket_seconds{bucket="compile"}'):
        assert name in text, name
    status, body = scraped["healthz"]
    assert status == 200 and body["ready"] and {"journal", "memory", "quarantined_shards"} <= set(body["info"])
    with pytest.raises(OSError):  # closed with the run
        urllib.request.urlopen(f"http://127.0.0.1:{servers[0].port}/healthz", timeout=2)
    names = Counter(e["name"] for e in json.loads(ct.read_text())["traceEvents"])
    assert names["train_step"] == names["data_wait"] == 6 and names["checkpoint_save"] == 1
    assert not ttrace._TRACER.enabled  # the span buffer stops with the run
