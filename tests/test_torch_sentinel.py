"""The training run's safety layers on the CPU, against the JAX package.

(a) The port's ``DivergenceSentinel`` and the JAX one fed the same seeded
    metric streams (NaN losses, guard skips, spikes, recoveries, rollbacks
    until the budget is spent): the same verdicts, EMA (rtol 1e-12),
    streaks, counters and ``on_event`` payloads.
(b) Both CLIs on ``recipes/smoke_cpu.yaml`` under the scripted divergence
    ``train.loss:nan@n=4..6`` (steps 5-7), patience 3, a log window a
    step, a save every 4 steps and ``run.slo`` set (accepted and not read
    by either train CLI): the ordered ``(type, step)`` rows of
    ``run_start``, ``step``, ``checkpoint_save``, ``sentinel_*``,
    ``rollback`` (from, to), ``mem_sample``, ``goodput_report`` and
    ``shutdown`` and the ``flight_record`` rows' reasons are equal, and so
    are the counters' deltas, the goodput reports' ``step``, ``reason``,
    ``steps``, ``recompute_steps``, ``conservation_error`` and bucket keys,
    and the ``train_*``, ``goodput_*`` and ``span_seconds`` family names
    of the two registries. Left out: ``mem_leak_suspect`` with its
    ``mem_leak`` flight record: the JAX run's leak sentinel fires
    "unaccounted" on its own XLA compile growth on the CPU, which the
    eager port does not have. With ``run.diag_every=1`` in both: the
    same ``diag_groups``, every ``step`` row's ``diag`` with the same
    groups and keys, the ``nonfinite_step`` flight record naming
    ``patch_embed`` in both, one ``compiled_program`` row each with the
    same keys, and the same ``perf/*`` keys in every ``step`` row. On
    both journals the port's ``tools/run_doctor.py`` gives the JAX
    doctor's markdown and exit code (the env line names torch on the
    port's journal, where JAX's prints ``jax ?``), and the port's
    ``tools/perf_doctor.py`` JAX's but for the drift line, which the JAX
    doctor never prints on a CLI's journal (ROADMAP C.R6).
(c) The port's rollback over steps 5-7, on tar shards through the data
    cursor, ends bit-identical to an uninterrupted 12-step run.
(d) ``run.sentinel=false`` (no guard, no rollback) ends with a NaN loss.
(e) No checkpoint to roll back to raises ``DivergenceError``: exit code 43
    through ``main``, ``shutdown`` journaled with ``diverged``.
(f) A batch whose shape changes after step 1 journals one ``retrace``
    event naming the leaf, equal to the JAX sentinel's record for the
    same two trees.
(g) ``host.leak:corrupt(16)`` makes the leak sentinel name
    ``fault_ballast``, and ``tools/mem_doctor.py`` reads the journal.
"""

import io
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.faults import inject as jinject
from jumbo_mae_tpu_tpu.faults import sentinel as jsentinel
from jumbo_mae_tpu_tpu.obs import metrics as jmetrics
from jumbo_mae_tpu_tpu.obs.journal import RunJournal as JRunJournal
from jumbo_mae_tpu_tpu.obs.journal import read_journal as jread_journal
from jumbo_mae_tpu_tpu.obs.retrace import RetraceSentinel as JRetraceSentinel
from jumbo_mae_tpu_tpu_torch.cli import train as ttrain
from jumbo_mae_tpu_tpu_torch.config import load_config
from jumbo_mae_tpu_tpu_torch.data.tario import write_tar_samples
from jumbo_mae_tpu_tpu_torch.faults import inject as tinject
from jumbo_mae_tpu_tpu_torch.faults import sentinel as tsentinel
from jumbo_mae_tpu_tpu_torch.obs import metrics as tmetrics
from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal
from jumbo_mae_tpu_tpu_torch.tools import mem_doctor, perf_doctor, run_doctor
from jumbo_mae_tpu_tpu_torch.train.checkpoint import read_state

SMOKE = Path(__file__).resolve().parent.parent / "recipes" / "smoke_cpu.yaml"
DIVERGE = ["run.faults=train.loss:nan@n=4..6", "run.log_interval=1", "run.eval_interval=4",
           "run.sentinel_patience=3"]
SLO = "run.slo=p99_latency_ms<=250"
DIAG = "run.diag_every=1"
COMPARED = {"run_start", "step", "checkpoint_save", "sentinel_bad_step", "sentinel_loss_spike", "rollback",
            "mem_sample", "goodput_report", "flight_record", "shutdown", "compiled_program"}
FAMILIES = ("train_", "goodput_", "span_seconds")
COUNTERS = [("train_steps_skipped_total", ""), ("train_loss_spikes_total", ""), ("train_rollbacks_total", ""),
            ("faults_injected_total", "train.loss,nan")]


@pytest.fixture(autouse=True)
def no_plan_left():
    """A ``run.faults`` plan outlives its run, in either package, and the
    ballast its ``host.leak`` site keeps: both go after each test."""
    yield
    jinject.clear_plan()
    tinject.clear_plan()
    tinject._LEAK_BALLAST.clear()


def _overrides(out, steps, *extra):
    return [f"run.output_dir={out}", f"run.training_steps={steps}", f"optim.training_steps={steps}",
            "run.sanity_eval=false", *extra]


def _port(out, steps, *extra):
    return ttrain.train(load_config(SMOKE, _overrides(out, steps, *extra)), device="cpu")


def _rows(events):
    """The compared rows: (type, step), a rollback as (type, from, to), a
    flight record as (type, reason); not the leak sentinel's record."""
    def row(e):
        if e["type"] == "rollback":
            return e["type"], e["from_step"], e["to_step"]
        return e["type"], e["reason"] if e["type"] == "flight_record" else e.get("step")

    return [row(e) for e in events
            if e["type"] in COMPARED and not (e["type"] == "flight_record" and e["reason"] == "mem_leak")]


def _counters(reg) -> dict:
    snap = reg.snapshot()
    return {(name, key): snap.get(name, {}).get(key, 0.0) for name, key in COUNTERS}


# ---------------------------------------------------------------- (a) the sentinel


def _stream(seed: int, n: int = 160) -> list[dict]:
    """Seeded per-step metrics: lognormal losses around a slow decay, with
    runs of guard skips, NaN and inf losses, spikes and recoveries."""
    rng = np.random.RandomState(seed)
    out, burst = [], 0
    for i in range(n):
        loss = float(np.exp(rng.normal(0.0, 0.2)) * (1.0 + 2.0 / (1 + i)))
        m = {"loss": loss}
        if burst == 0 and rng.rand() < 0.12:
            burst = int(rng.randint(1, 6))  # a bad run of 1-5 steps
        if burst:
            burst -= 1
            kind = rng.randint(4)
            if kind == 0:
                m["skipped"] = 1.0
            elif kind == 1:
                m["loss"] = float("nan")
            elif kind == 2:
                m["loss"] = float("inf")
            else:
                m["loss"] = loss * float(rng.choice([3.0, 12.0, 60.0]))
        elif rng.rand() < 0.1:
            m["skipped"] = 0.0
        out.append(m)
    return out


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.parametrize("seed,cfg", [
    (0, dict()),
    (1, dict(patience=1, spike_factor=3.0, ema_beta=0.9, max_rollbacks=6)),
    (2, dict(patience=2, spike_factor=2.5, ema_beta=0.5, max_rollbacks=2)),
    (3, dict(patience=4, spike_factor=0.0, ema_beta=0.98, max_rollbacks=1)),
])
def test_sentinel_matches_jax_verdict_for_verdict(seed, cfg):
    sides = {}
    for name, mod, metrics in (("jax", jsentinel, jmetrics), ("port", tsentinel, tmetrics)):
        reg, events, trace = metrics.MetricsRegistry(), [], []
        s = mod.DivergenceSentinel(mod.SentinelConfig(**cfg), registry=reg,
                                   on_event=lambda kind, payload, ev=events: ev.append((kind, payload)))
        for step, m in enumerate(_stream(seed), start=1):
            verdict = s.observe(step, m)
            if verdict:
                try:
                    s.record_rollback()
                except mod.DivergenceError as e:
                    trace.append((step, "exhausted", str(e)))
                    break
            trace.append((step, verdict, s.bad_streak, s.rollbacks, s.ema))
        sides[name] = (trace, events, {k: v[""] for k, v in reg.snapshot().items()})
    (jt, je, jc), (pt, pe, pc) = sides["jax"], sides["port"]
    assert len(pt) == len(jt) and pc == jc
    assert jc["train_rollbacks_total"] >= 1 and jc["train_steps_skipped_total"] >= 5
    for p, j in zip(pt, jt):
        if len(j) == 3:
            assert p == j  # the budget spent: the same step and message
            continue
        assert p[:4] == j[:4]
        assert (p[4] is None) == (j[4] is None)
        if j[4] is not None:
            np.testing.assert_allclose(p[4], j[4], rtol=1e-12)
    assert [k for k, _ in pe] == [k for k, _ in je] and {k for k, _ in je} >= {"bad_step", "rollback"}
    for (_, p), (_, j) in zip(pe, je):
        assert p.keys() == j.keys() and all(_same(p[k], j[k]) for k in j)


def test_a_raising_event_callback_is_swallowed():
    def boom(kind, payload):
        raise RuntimeError("diagnostics down")

    s = tsentinel.DivergenceSentinel(tsentinel.SentinelConfig(patience=2), registry=tmetrics.MetricsRegistry(),
                                     on_event=boom)
    assert not s.observe(1, {"loss": float("nan")})
    assert s.observe(2, {"loss": 1.0, "skipped": 1.0})
    s.record_rollback()
    assert (s.bad_streak, s.rollbacks, s.ema) == (0, 1, None)


# --------------------------------------------------------- (b) both CLIs, one divergence


@pytest.fixture(scope="module")
def divergence(tmp_path_factory):
    """Both CLIs once under the scripted divergence, ``run.slo`` and
    ``run.diag_every=1``: their outputs, counter deltas, journals and run
    directories."""
    from jumbo_mae_tpu_tpu.cli.train import train as jtrain
    from jumbo_mae_tpu_tpu.config import load_config as jload_config

    root = tmp_path_factory.mktemp("divergence")
    try:
        j0 = _counters(jmetrics.get_registry())
        jout = jtrain(jload_config(SMOKE, _overrides(root / "jax", 12, *DIVERGE, SLO, DIAG)))
        jd = {k: v - j0[k] for k, v in _counters(jmetrics.get_registry()).items()}
        t0 = _counters(tmetrics.get_registry())
        tout = _port(root / "port", 12, *DIVERGE, SLO, DIAG)
        td = {k: v - t0[k] for k, v in _counters(tmetrics.get_registry()).items()}
    finally:
        jinject.clear_plan()
        tinject.clear_plan()
        tinject._LEAK_BALLAST.clear()
    jdir, tdir = root / "jax" / "smoke_cpu", root / "port" / "smoke_cpu"
    return dict(jout=jout, tout=tout, jd=jd, td=td, jev=jread_journal(jdir), tev=read_journal(tdir), jdir=jdir,
                tdir=tdir, families=[sorted(n for n in m.get_registry().snapshot() if n.startswith(FAMILIES))
                                     for m in (tmetrics, jmetrics)])


def test_scripted_divergence_journals_as_the_jax_cli(divergence):
    jout, tout, jd, td = (divergence[k] for k in ("jout", "tout", "jd", "td"))
    jev, tev = divergence["jev"], divergence["tev"]
    rows = _rows(tev)
    assert rows == _rows(jev)
    assert rows[0] == ("run_start", None) and rows[-1] == ("shutdown", 12)
    assert ("rollback", 7, 4) in rows
    assert [r[1] for r in rows if r[0] == "sentinel_bad_step"] == [5, 6, 7]
    assert [r[1] for r in rows if r[0] == "checkpoint_save"] == [4, 8, 12]
    assert [r[1] for r in rows if r[0] == "step"] == [1, 2, 3, 4, 5, 6, 7, 5, 6, 7, 8, 9, 10, 11, 12]
    assert td == jd and td[("train_rollbacks_total", "")] == 1 and td[("train_steps_skipped_total", "")] == 3
    assert td[("faults_injected_total", "train.loss,nan")] == 3
    # the verdicts' and the rollback's fields, the shutdown's reason
    pick = lambda evs, t, keys: [{k: e[k] for k in keys} for e in evs if e["type"] == t]  # noqa: E731
    for t, keys in (("sentinel_bad_step", ("step", "reason", "streak")),
                    ("rollback", ("from_step", "to_step", "rollbacks", "bad_steps")),
                    ("shutdown", ("reason", "step")), ("checkpoint_save", ("step",))):
        assert pick(tev, t, keys) == pick(jev, t, keys), t
    start = next(e for e in tev if e["type"] == "run_start")
    jstart = next(e for e in jev if e["type"] == "run_start")
    assert start.keys() == jstart.keys() and start["config"]["run"]["faults"] == "train.loss:nan@n=4..6"
    assert start["config"]["run"]["slo"] == jstart["config"]["run"]["slo"] == "p99_latency_ms<=250"
    # the goodput reports: at each committed save and at shutdown
    keys = ("step", "reason", "steps", "recompute_steps", "conservation_error")
    reports = [{k: e.get(k) for k in keys} | {"buckets": sorted(e["buckets"])} for e in tev
               if e["type"] == "goodput_report"]
    assert reports == [{k: e.get(k) for k in keys} | {"buckets": sorted(e["buckets"])} for e in jev
                       if e["type"] == "goodput_report"]
    assert [(r["step"], r["reason"]) for r in reports] == [(4, None), (8, None), (12, None), (12, "completed")]
    assert (reports[-1]["steps"], reports[-1]["recompute_steps"], reports[-1]["conservation_error"]) == (11, 3, 0.0)
    # the black box: the first bad window (one dump for steps 5-7), then the rollback
    assert [r[1] for r in rows if r[0] == "flight_record"] == ["nonfinite_step", "sentinel_rollback"]
    dumps = sorted(divergence["tdir"].glob("flightrec-*.json"))
    assert [d.name.rsplit("-", 1)[-1] for d in dumps] == ["nonfinite_step.json", "sentinel_rollback.json"]
    assert json.loads(dumps[0].read_text())["extra"] == {"bad_steps": [5], "first_nonfinite_group": "patch_embed"}
    families = divergence["families"]
    assert families[0] == families[1] and "train_grad_norm" in families[0] and "goodput_fraction" in families[0]
    assert "train_hardware_flops_utilization" in families[0]
    steps = [e for e in tev if e["type"] == "step"]
    assert [e.get("bad_steps") for e in steps[4:7]] == [[5], [6], [7]]
    # a window of skipped steps only has no loss: the guard refused it
    assert all(e["data_wait_fraction"] >= 0 and ("train/loss" in e["metrics"]) == ("bad_steps" not in e)
               for e in steps)
    mem = [e for e in tev if e["type"] == "mem_sample"]
    assert all(e["rss_bytes"] > 0 and "fault_ballast" in e["components"] for e in mem)
    assert math.isfinite(tout["train/loss"]) and math.isfinite(jout["train/loss"])
    assert tout["_exit_reason"] == jout["_exit_reason"] == "completed"


def test_scripted_divergence_diagnostics_as_the_jax_cli(divergence):
    jev, tev = divergence["jev"], divergence["tev"]
    starts = [next(e for e in evs if e["type"] == "run_start") for evs in (tev, jev)]
    assert starts[0]["diag_every"] == starts[1]["diag_every"] == 1
    groups = starts[0]["diag_groups"]
    assert groups == starts[1]["diag_groups"] and groups[0] == "patch_embed" and groups[-1] == "decoder"
    steps = [[e for e in evs if e["type"] == "step"] for evs in (tev, jev)]
    assert len(steps[0]) == len(steps[1]) == 15
    for t, j in zip(*steps):
        assert t["diag_step"] == j["diag_step"] == t["step"]
        assert list(t["diag"]) == list(j["diag"]) == groups
        assert all(list(t["diag"][g]) == list(j["diag"][g]) == ["grad_norm", "param_norm", "update_ratio"]
                   for g in groups)
        bad = "bad_steps" in t
        assert (t["diag"]["patch_embed"]["grad_norm"] == "nan") == bad == (j["diag"]["patch_embed"]["grad_norm"] == "nan")
        # the same perf/* keys a window: throughput, MFU and HFU, the drift
        assert sorted(k for k in t["metrics"] if k.startswith("perf/")) == sorted(
            k for k in j["metrics"] if k.startswith("perf/"))
    perf = [k for k in steps[0][-1]["metrics"] if k.startswith("perf/")]
    assert {"perf/hardware_flops_utilization", "perf/predict_vs_measured", "perf/tflops_per_chip"} <= set(perf)
    # smoke_cpu has no grad_ckpt: the step runs the model's FLOPs
    last = steps[0][-1]["metrics"]
    assert last["perf/hardware_flops_utilization"] == pytest.approx(last["perf/mfu"], rel=1e-12)
    # the black box names the group that blew up first, in both
    for d in (divergence["tdir"], divergence["jdir"]):
        dump = json.loads(sorted(d.glob("flightrec-*nonfinite_step.json"))[0].read_text())
        assert dump["extra"]["first_nonfinite_group"] == "patch_embed"
        assert any("diag" in s for s in dump["steps"]) and any("finite_frac" in s for s in dump["steps"])
    programs = [[e for e in evs if e["type"] == "compiled_program"] for evs in (tev, jev)]
    assert len(programs[0]) == len(programs[1]) == 1 and programs[0][0].keys() == programs[1][0].keys()
    assert programs[0][0]["source"] == "analytic" and programs[1][0]["source"] == "compiled"


def _reports(port_main, jax_main, argv, capsys) -> list:
    out = []
    for main in (port_main, jax_main):
        rc = main(list(argv))
        out.append((rc, capsys.readouterr().out))
    return out


def test_run_doctor_equals_jax_on_both_journals(divergence, capsys):
    import tools.run_doctor as jrun_doctor

    for which in ("jdir", "tdir"):
        d = divergence[which]
        dump = sorted(d.glob("flightrec-*nonfinite_step.json"))[0]
        for extra in ([], ["--flightrec", str(dump)]):
            (rc, md), (jrc, jmd) = _reports(run_doctor.main, jrun_doctor.main, [str(d), *extra], capsys)
            assert rc == jrc == 0
            if which == "tdir":
                # the one line that reads the framework: the port's journal has torch, no jax
                env = next(e for e in divergence["tev"] if e["type"] == "run_start")["env"]
                assert f", torch {env['torch']} (" in md and ", jax ? (" in jmd
                md = md.replace(f", torch {env['torch']} (", ", jax ? (")
            assert md == jmd
            assert "first layer group to go non-finite (grad norm): **patch_embed**" in md
            assert "per-layer-group diagnostics ON every 1 steps" in md and "`compiled_program`" in md
    assert _reports(run_doctor.main, jrun_doctor.main, [str(divergence["tdir"] / "nothing")], capsys) == [
        (2, ""), (2, "")]


def test_perf_doctor_reads_the_nested_drift_unlike_jax(divergence, capsys):
    import tools.perf_doctor as jperf_doctor

    for which, source in (("jdir", "XLA"), ("tdir", "analytic")):
        (rc, md), (jrc, jmd) = _reports(perf_doctor.main, jperf_doctor.main, [str(divergence[which])], capsys)
        assert rc == jrc == 0
        # C.R6: both CLIs nest the drift under each step row's metrics; the
        # JAX doctor reads the top level only and never prints the line
        drift = [ln for ln in md.splitlines() if ln.startswith("- predicted-vs-measured drift")]
        assert len(drift) == 1 and "predicted-vs-measured" not in jmd
        assert "1 compiled program(s) with XLA cost accounting" in jmd
        assert md.replace(drift[0] + "\n", "").replace(f"with {source} cost", "with XLA cost") == jmd


# ------------------------------------------- (c) the rollback ends where a clean run ends


@pytest.fixture(scope="module")
def shard_root(tmp_path_factory):
    """2 shards × 16 PNG samples, 48 px."""
    from PIL import Image

    root = tmp_path_factory.mktemp("sentinelshards")
    rng = np.random.default_rng(0)
    idx = 0
    for s in range(2):
        samples = []
        for _ in range(16):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 256, (48, 48, 3), dtype=np.uint8), "RGB").save(buf, format="PNG")
            samples.append({"__key__": f"s{idx:05d}", "png": buf.getvalue(), "cls": str(idx % 10).encode()})
            idx += 1
        write_tar_samples(str(root / f"train-{s:04d}.tar"), samples)
    return root


def test_rollback_ends_bit_identical_to_an_uninterrupted_run(tmp_path, shard_root):
    shards = ["run.train_batch_size=8", "run.synthetic_data=false",
              f"data.train_shards={shard_root}/train-{{0000..0001}}.tar", "data.valid_shards=", "data.dataset_size=32",
              "data.shuffle_buffer=8"]
    rolled = _port(tmp_path / "rolled", 12, *shards, *DIVERGE)
    clean = _port(tmp_path / "clean", 12, *shards, "run.log_interval=1", "run.eval_interval=4")
    events = read_journal(tmp_path / "rolled" / "smoke_cpu")
    assert [(e["from_step"], e["to_step"]) for e in events if e["type"] == "rollback"] == [(7, 4)]
    assert rolled["_exit_reason"] == clean["_exit_reason"] == "completed"
    a, b = read_state(tmp_path / "rolled" / "smoke_cpu" / "ckpt"), read_state(tmp_path / "clean" / "smoke_cpu" / "ckpt")
    assert a["step"] == b["step"] == 12 and a["seed"] == b["seed"]
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        torch.testing.assert_close(a["model"][k], b["model"][k], atol=0, rtol=0, msg=k)
    for x, y in zip(a["opt"]["mu"] + a["opt"]["nu"], b["opt"]["mu"] + b["opt"]["nu"], strict=True):
        torch.testing.assert_close(x, y, atol=0, rtol=0)
    assert a["opt"]["count"] == b["opt"]["count"] == 12 and a["opt"]["learning_rate"] == b["opt"]["learning_rate"]
    extra = json.loads((tmp_path / "rolled" / "smoke_cpu" / "ckpt" / "last" / "12" / "extra.json").read_text())
    assert extra["data_cursor"]["batches"] == 12  # the cursor went on from step 4's, not from the bad pass


# ------------------------------------------------------------- (d), (e) no rescue


def test_without_the_sentinel_the_run_ends_nan(tmp_path):
    out = _port(tmp_path, 6, "run.faults=train.loss:nan@n=1", "run.sentinel=false", "run.log_interval=1",
                "run.eval_interval=100")
    assert math.isnan(out["train/loss"]) and out["_exit_reason"] == "completed"
    types = {e["type"] for e in read_journal(tmp_path / "smoke_cpu")}
    assert "rollback" not in types and not {t for t in types if t.startswith("sentinel_")}


def test_no_checkpoint_to_roll_back_to_is_fatal(tmp_path, capsys):
    argv = ["--config", str(SMOKE), "--device", "cpu", "--set",
            *_overrides(tmp_path, 6, "run.faults=train.loss:nan@n=0..2", "run.log_interval=1", "run.eval_interval=100")]
    with pytest.raises(SystemExit) as exc:
        ttrain.main(argv)
    assert exc.value.code == 43
    assert "[train] FATAL: training diverged at step 3 with no checkpoint" in capsys.readouterr().out
    events = read_journal(tmp_path / "smoke_cpu")
    assert [e["step"] for e in events if e["type"] == "sentinel_bad_step"] == [1, 2, 3]
    assert events[-1]["type"] == "shutdown" and events[-1]["reason"] == "diverged" and events[-1]["step"] == 3
    with pytest.raises(tsentinel.DivergenceError, match="no checkpoint"):
        _port(tmp_path / "again", 6, "run.faults=train.loss:nan@n=0..2", "run.log_interval=1", "run.eval_interval=100")


# ------------------------------------------------------------------ (f) retrace


def test_a_batch_shape_change_journals_one_retrace_as_jax(tmp_path, monkeypatch):
    real = ttrain.make_train_iterator

    def halved_after_step_1(*a, **kw):
        it, *rest = real(*a, **kw)

        def gen():
            yield next(it)
            for b in it:
                yield {k: v[:8] for k, v in b.items()}

        return (gen(), *rest)

    monkeypatch.setattr(ttrain, "make_train_iterator", halved_after_step_1)
    _port(tmp_path / "port", 6, "run.log_interval=1")
    got = [e for e in read_journal(tmp_path / "port" / "smoke_cpu") if e["type"] == "retrace"]
    assert len(got) == 1
    assert got[0]["diff"] == [{"leaf": 0, "prev_shape": [16, 32, 32, 3], "prev_dtype": "uint8",
                               "new_shape": [8, 32, 32, 3], "new_dtype": "uint8"}]
    assert got[0]["task"] == "train_step" and got[0]["bucket"] == 8

    # the JAX sentinel over the same two trees, its compile a fresh jit
    full, half = {"images": np.zeros((16, 32, 32, 3), np.uint8)}, {"images": np.zeros((8, 32, 32, 3), np.uint8)}
    x = jnp.ones((7, 3))
    with JRunJournal(tmp_path / "jax") as journal:
        s = JRetraceSentinel("train", journal=journal, registry=jmetrics.MetricsRegistry())
        s.note("train_step", full)
        s.arm()
        s.note("train_step", half)
        with pytest.warns(RuntimeWarning, match="unexpected XLA compile"):
            jax.jit(lambda v: v * 3.0 + 1.0)(x).block_until_ready()
        s.close()
    want = [e for e in jread_journal(tmp_path / "jax") if e["type"] == "retrace"]
    assert len(want) >= 1
    for k in ("loop", "tag", "prev_sig", "new_sig", "diff"):
        assert got[0][k] == want[0][k], k


# ----------------------------------------------------------------- (g) the leak


def test_host_leak_is_named_and_mem_doctor_reads_the_journal(tmp_path):
    _port(tmp_path, 6, "run.faults=host.leak:corrupt(16)", "run.log_interval=1", "run.eval_interval=100")
    assert tinject.leak_ballast_bytes() == 6 * 16 * 1024 * 1024
    events = read_journal(tmp_path / "smoke_cpu")
    samples = [e for e in events if e["type"] == "mem_sample"]
    assert [e["components"]["fault_ballast"] for e in samples] == [16 * 1024 * 1024 * i for i in range(1, 7)]
    leaks = [e for e in events if e["type"] == "mem_leak_suspect"]
    assert len(leaks) == 1 and leaks[0]["component"] == "fault_ballast"
    assert leaks[0]["robust_growth_bytes"] >= 32 * 1024 * 1024
    # the doctor's contract: 2 = an incident (a leak suspect) was journaled
    assert mem_doctor.main([str(tmp_path / "smoke_cpu"), "--out", str(tmp_path / "mem.md")]) == 2
    report = (tmp_path / "mem.md").read_text()
    assert "leak suspected: **fault_ballast**" in report and "| fault_ballast |" in report
    tinject.install_plan("host.leak:raise")
    assert tinject.host_leak_tick("0") == 0  # a raise firing clears the ballast and never propagates
