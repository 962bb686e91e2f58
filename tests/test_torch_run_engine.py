"""The port's RunEngine (train/engine.py) against the JAX package's, on the CPU.

Every scenario drives both engines with the same pure-python dispatch,
``fetch=identity`` and the same hooks (the contracts of
tests/test_engine.py: hook order, boundaries, the rollback ladder, stop
requests at single- and multi-host boundaries, the host-lost ladder, the
crash ladder), and checks each engine against the expected trace, so the
two give the same trace. The port's default ``fetch_metrics`` is checked
on CPU tensors, and the exit-code protocol against the JAX one.
"""

import pytest
import torch

from jumbo_mae_tpu_tpu.train import engine as jax_engine
from jumbo_mae_tpu_tpu_torch.train import engine as port_engine

ENGINES = {"jax": jax_engine, "port": port_engine}


@pytest.fixture(params=sorted(ENGINES))
def mod(request):
    return ENGINES[request.param]


def make_engine(mod, *, steps=12, log_interval=2, eval_interval=4, should_stop=None, dispatch=None,
                process_count=1, start_step=0):
    def _dispatch(state, batch, step):
        return state + 1, {"loss": float(step)}

    return mod.RunEngine(
        training_steps=steps,
        start_step=start_step,
        log_interval=log_interval,
        eval_interval=eval_interval,
        process_count=process_count,
        next_batch=lambda step: step,
        dispatch=dispatch or _dispatch,
        should_stop=should_stop,
        fetch=lambda ms: ms,  # deviceless: metrics are already host values
    )


def test_hook_order_and_boundaries(mod):
    eng = make_engine(mod)
    trace = []
    eng.pre_step(lambda e, s: trace.append(("pre", s)))
    eng.on_step(lambda e, ev: trace.append(("step", ev.step)))
    eng.on_log_window(lambda e, win: trace.append(("log", win.step, [s for s, _ in win.fetched])))
    eng.on_eval(lambda e, s, st: trace.append(("eval", s)) or {"val/x": 1.0})
    eng.on_checkpoint(lambda e, cev: trace.append(("ckpt", cev.step, cev.reason, cev.metrics)))
    eng.on_shutdown(lambda e, reason, s: trace.append(("shutdown", reason, s)))
    assert eng.run(0) == 12
    assert eng.exit_reason == "completed"
    assert [t for t in trace if t[0] == "log"] == [("log", s, [s - 1, s]) for s in (2, 4, 6, 8, 10, 12)]
    assert [t for t in trace if t[0] == "ckpt"] == [("ckpt", s, "interval", {"val/x": 1.0}) for s in (4, 8, 12)]
    assert trace[-1] == ("shutdown", "completed", 12)
    # within a step: pre, step, log, eval, checkpoint
    at4 = [t for t in trace if len(t) > 1 and t[1] == 4]
    assert [t[0] for t in at4] == ["pre", "step", "log", "eval", "ckpt"]


@pytest.mark.parametrize("steps,log_interval,eval_interval,ckpt_interval,logs,ckpts", [
    (7, 3, 5, 0, [3, 6, 7], [5, 7]),  # the final step is always a boundary
    (6, 2, 0, 0, [2, 4, 6], [6]),  # eval_interval 0: a save only at the end
    (8, 4, 0, 3, [4, 8], [3, 6, 8]),  # ckpt_every apart from eval
])
def test_boundary_arithmetic(mod, steps, log_interval, eval_interval, ckpt_interval, logs, ckpts):
    eng = mod.RunEngine(training_steps=steps, log_interval=log_interval, eval_interval=eval_interval,
                        ckpt_interval=ckpt_interval, next_batch=lambda s: s,
                        dispatch=lambda st, b, s: (st, {}), fetch=lambda ms: ms)
    seen_logs, seen_ckpts, evals = [], [], []
    eng.on_log_window(lambda e, win: seen_logs.append(win.step))
    eng.on_eval(lambda e, s, st: evals.append(s))
    eng.on_checkpoint(lambda e, cev: seen_ckpts.append(cev.step))
    eng.run(0)
    assert seen_logs == logs and seen_ckpts == ckpts
    # evals only at eval boundaries, never at a checkpoint-only one
    assert evals == [s for s in ckpts if s == steps or (eval_interval and s % eval_interval == 0)]


def test_rollback_resumes_from_hook_returned_step(mod):
    eng = make_engine(mod, steps=8, log_interval=2, eval_interval=4)
    windows, rollbacks = [], []

    def window(e, win):
        windows.append(win.step)
        if win.step == 6 and not rollbacks:
            win.bad_steps.append(6)
            e.request_rollback()

    def restore(e, step, win):
        rollbacks.append((step, list(win.bad_steps)))
        e.state = 100  # the restore replaces the engine's state
        return 4

    eng.on_log_window(window)
    eng.on_rollback(lambda e, step, win: None)  # a hook with no step to give
    eng.on_rollback(restore)
    assert eng.run(0) == 100 + 4  # the restored state + the 4 re-dispatched steps
    assert rollbacks == [(6, [6])]
    assert windows == [2, 4, 6, 6, 8]  # resumed from 4: windows 6 and 8 run again


def test_rollback_without_resume_step_raises(mod):
    eng = make_engine(mod, steps=2, log_interval=1)
    eng.on_log_window(lambda e, win: e.request_rollback())
    eng.on_rollback(lambda e, step, win: None)
    reasons = []
    eng.on_shutdown(lambda e, reason, s: reasons.append(reason))
    with pytest.raises(RuntimeError, match="no on_rollback hook"):
        eng.run(0)
    assert reasons == ["exception:RuntimeError"]


def test_request_stop_checkpoints_then_exits(mod, capsys):
    eng = make_engine(mod, steps=100, log_interval=2, eval_interval=0)
    ckpts = []
    eng.on_log_window(lambda e, win: e.request_stop("drained") if win.step == 4 else None)
    eng.on_checkpoint(lambda e, cev: ckpts.append((cev.step, cev.reason, cev.metrics)))
    eng.run(0)
    assert eng.exit_reason == "drained" and mod.exit_code_for("drained") == mod.EXIT_FATAL
    assert ckpts == [(4, "preemption", None)]
    assert "preemption checkpoint at step 4" in capsys.readouterr().out


def test_no_duplicate_checkpoint_when_stop_lands_on_eval_boundary(mod):
    eng = make_engine(mod, steps=100, log_interval=2, eval_interval=4)
    ckpts = []
    eng.on_log_window(lambda e, win: e.request_stop() if win.step == 4 else None)
    eng.on_checkpoint(lambda e, cev: ckpts.append((cev.step, cev.reason)))
    eng.run(0)
    assert ckpts == [(4, "interval")] and eng.exit_reason == "stopped"


@pytest.mark.parametrize("process_count,stop_at,probes", [
    (1, 5, [1, 2, 3, 4, 5]),  # one host: the probe runs every step
    (2, 6, [3, 6]),  # several: only at log boundaries (agreement needs an allgather)
])
def test_should_stop_probe_boundaries(mod, process_count, stop_at, probes):
    probed = []

    def should_stop():
        probed.append(eng.step)
        return eng.step >= 5

    eng = make_engine(mod, steps=100, log_interval=3, eval_interval=0, process_count=process_count,
                      should_stop=should_stop)
    ckpts = []
    eng.on_checkpoint(lambda e, cev: ckpts.append((cev.step, cev.reason)))
    eng.run(0)
    assert probed == probes and eng.step == stop_at
    assert ckpts == [(stop_at, "preemption")] and eng.exit_reason == "preempted"
    assert mod.exit_code_for(eng.exit_reason) == mod.EXIT_OK


@pytest.mark.parametrize("process_count,lost_at", [(1, 3), (2, 4)])
def test_host_lost_exits_for_elastic_restart_without_a_save(mod, capsys, process_count, lost_at):
    eng = make_engine(mod, steps=100, log_interval=2, eval_interval=0, process_count=process_count)
    trace = []

    def on_step(e, ev):
        if ev.step == 3:
            e.notify_host_lost({"hosts": [1], "detected_by": "beacon"})
            e.notify_host_lost({"hosts": [2]})  # the first notification wins

    eng.on_step(on_step)
    eng.on_host_lost(lambda e, info: trace.append(("host_lost", e.step, info)))
    eng.on_checkpoint(lambda e, cev: trace.append(("ckpt", cev.step)))
    eng.on_shutdown(lambda e, reason, s: trace.append(("shutdown", reason, s)))
    eng.run(0)
    # one host stops at once; several wait for the next log boundary
    assert trace == [("host_lost", lost_at, {"hosts": [1], "detected_by": "beacon"}),
                     ("shutdown", "host_lost", lost_at)]
    assert eng.exit_reason == "host_lost" and mod.exit_code_for("host_lost") == mod.EXIT_ELASTIC
    assert f"host lost at step {lost_at}" in capsys.readouterr().out


def test_crash_ladder_runs_crash_then_shutdown_hooks(mod):
    def dispatch(state, batch, step):
        if step == 3:
            raise ValueError("boom")
        return state, {"loss": 0.0}

    eng = make_engine(mod, steps=10, dispatch=dispatch)
    order = []
    eng.on_crash(lambda e, exc: order.append(("crash", type(exc).__name__)))
    eng.on_crash(lambda e, exc: (_ for _ in ()).throw(RuntimeError("hook")))
    eng.on_crash(lambda e, exc: order.append(("crash2", e.exit_reason)))
    eng.on_crash(lambda e, exc: setattr(e, "exit_reason", "diverged"))
    eng.on_shutdown(lambda e, reason, s: order.append(("shutdown", reason, s)))
    with pytest.raises(ValueError, match="boom"):
        eng.run(0)
    # a throwing crash hook masks neither the failure nor later hooks
    assert order == [("crash", "ValueError"), ("crash2", "exception:ValueError"), ("shutdown", "diverged", 3)]
    assert mod.exit_code_for("diverged") == mod.EXIT_FATAL


def test_step_event_metrics_are_mutable_before_buffering(mod):
    eng = make_engine(mod, steps=2, log_interval=2)

    def strip(e, ev):
        ev.metrics = {k: v for k, v in ev.metrics.items() if k != "loss"}

    seen = []
    eng.on_step(strip)
    eng.on_log_window(lambda e, win: seen.extend(m for _, m in win.fetched))
    eng.run(0)
    assert seen == [{}, {}]


def test_start_step_resume_boundaries(mod):
    eng = make_engine(mod, steps=6, start_step=4, log_interval=2, eval_interval=0)
    logs, pre = [], []
    eng.pre_step(lambda e, s: pre.append(s))
    eng.on_log_window(lambda e, win: logs.append([s for s, _ in win.fetched]))
    assert eng.run(0) == 2
    assert logs == [[5, 6]] and pre == [5, 6]


@pytest.mark.parametrize("reason", ["completed", "preempted", "stopped", "host_lost", "hang", "diverged",
                                    "exception:ValueError", "drained"])
def test_exit_codes_match_jax(reason):
    assert port_engine.exit_code_for(reason) == jax_engine.exit_code_for(reason)
    for name in ("EXIT_OK", "EXIT_ELASTIC", "EXIT_FATAL", "EXIT_HANG", "FATAL_REASONS"):
        assert getattr(port_engine, name) == getattr(jax_engine, name)


def test_default_fetch_is_one_host_copy_per_window(monkeypatch):
    """Without ``fetch`` the port's engine takes :func:`fetch_metrics`:
    the window's tensors become host floats in one stacked copy; other
    values pass through ``float``."""
    copies = []
    real_cpu = torch.Tensor.cpu

    def counted_cpu(self, *a, **kw):
        copies.append(self.shape)
        return real_cpu(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counted_cpu)
    eng = port_engine.RunEngine(
        training_steps=4, log_interval=2, next_batch=lambda s: s,
        dispatch=lambda st, b, s: (st, {"loss": torch.tensor(float(s)) / 2, "lr": 0.5, "n": torch.tensor(s)}),
    )
    windows = []
    eng.on_log_window(lambda e, win: windows.append(win.fetched))
    eng.run(None)
    assert windows == [[(1, {"loss": 0.5, "lr": 0.5, "n": 1.0}), (2, {"loss": 1.0, "lr": 0.5, "n": 2.0})],
                       [(3, {"loss": 1.5, "lr": 0.5, "n": 3.0}), (4, {"loss": 2.0, "lr": 0.5, "n": 4.0})]]
    assert copies == [(4,), (4,)]  # one copy of the window's 4 tensors per boundary
