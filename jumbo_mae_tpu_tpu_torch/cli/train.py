"""Training entry point: MAE pretraining driven by a YAML recipe.

Counterpart of ``jumbo_mae_tpu_tpu/cli/train.py`` for ``mode: pretrain``:

    python -m jumbo_mae_tpu_tpu_torch.cli.train --config recipes/pretrain_vit_l16_in1k_800ep.yaml \\
        --set data.train_shards=... data.valid_shards=... run.output_dir=runs
    python -m jumbo_mae_tpu_tpu_torch.cli.train --config recipes/smoke_cpu.yaml --device cpu

The run: the recipe's model and AdamW (``train/steps.py``), synthetic or
tar-shard data through worker interpreters (``data/loader.py``) copied to
the card on a side CUDA stream, a sanity eval before step 1, eval at
``eval_interval`` and at the end (padded valid rows masked out),
checkpoints at every eval and every ``ckpt_every`` steps
(``train/checkpoint.py``), ``run.resume`` from the newest save with the
sample-exact data cursor (or, without one, the stream restarted at the
resumed step's epoch), a checkpoint on SIGTERM/SIGINT at the next step
boundary, and a metrics JSONL with images/s and ``perf/mfu`` against one
H100's bf16 peak (``obs/mfu.py``). The step drops non-finite updates
(``run.sentinel``, its device guard).

Everything runs on ``"cuda"`` unless ``--device cpu`` (``device="cpu"``)
asks for the CPU. What the port does not have yet raises, naming its
ROADMAP item: finetuning and linear probing and warm starts (A4); FSDP,
tensor and pipeline parallelism, ``--distributed`` and ``--elastic`` (A6);
fault plans, telemetry, publishing, traces, diagnostics, the hang watchdog
and SLOs (A7); ``eval_only`` and the ``"dots"`` remat policies (A3's
remainder). The platform layers a recipe has on by default — the rollback
sentinel, journal, retrace sentinel, fleet beacons and memory watch — are
named once at start as not ported (A7) and the run goes on without them.
"""

from __future__ import annotations

import argparse
import signal
import time
from pathlib import Path

import numpy as np
import torch

from jumbo_mae_tpu_tpu_torch.config import TrainConfig, config_to_dict, load_config
from jumbo_mae_tpu_tpu_torch.data.loader import TrainLoader, prefetch_to_device, split_for_accum, valid_loader
from jumbo_mae_tpu_tpu_torch.data.synthetic import synthetic_batches
from jumbo_mae_tpu_tpu_torch.models.config import DecoderConfig, preset
from jumbo_mae_tpu_tpu_torch.models.mae import MAEPretrainModel
from jumbo_mae_tpu_tpu_torch.obs.mfu import mfu, pretrain_flops_per_image
from jumbo_mae_tpu_tpu_torch.parallel.mesh import create_mesh
from jumbo_mae_tpu_tpu_torch.train import engine as engine_mod
from jumbo_mae_tpu_tpu_torch.train.checkpoint import Checkpointer
from jumbo_mae_tpu_tpu_torch.train.engine import EXIT_OK, RunEngine, exit_code_for
from jumbo_mae_tpu_tpu_torch.train.optim import make_optimizer
from jumbo_mae_tpu_tpu_torch.train.steps import create_state, make_eval_step, make_train_step
from jumbo_mae_tpu_tpu_torch.utils.device import resolve_device
from jumbo_mae_tpu_tpu_torch.utils.logging import MetricLogger, StepTimer
from jumbo_mae_tpu_tpu_torch.utils.meters import AverageMeter
from jumbo_mae_tpu_tpu_torch.utils.summary import param_summary

NOT_PORTED = "{what} is not ported yet: ROADMAP queue {item}"
# run fields on by default whose layers are not ported: named once at start
DEFAULT_LAYERS_NOT_PORTED = {
    "sentinel": "the divergence rollback, while the step's non-finite guard runs",
    "journal": "the run journal and flight recorder",
    "retrace": "the recompile sentinel",
    "fleet": "the fleet beacons",
    "memwatch": "the memory watch",
}


def _refuse_unported(cfg: TrainConfig) -> None:
    """Raise for every setting that needs a part of the JAX package the
    port does not have yet, naming its ROADMAP item."""
    run, mesh = cfg.run, cfg.mesh
    if run.mode != "pretrain":
        raise NotImplementedError(NOT_PORTED.format(what=f"run.mode={run.mode!r} (finetuning, linear probing)", item="A4"))
    if run.pretrained_ckpt:
        raise NotImplementedError(NOT_PORTED.format(what="run.pretrained_ckpt (warm start)", item="A4"))
    if mesh.pipe > 1:
        raise NotImplementedError(NOT_PORTED.format(what="mesh.pipe > 1 (the GPipe pipeline)", item="A6"))
    a7 = {
        "run.faults": bool(run.faults),
        "run.telemetry": run.telemetry,
        "run.publish_dir": bool(run.publish_dir),
        "run.chrome_trace": bool(run.chrome_trace),
        "run.profile_dir": bool(run.profile_dir),
        "run.diag_every > 0": run.diag_every > 0,
        "run.hangwatch_deadline_s > 0": run.hangwatch_deadline_s > 0,
        "run.slo": bool(run.slo),
    }
    asked = [k for k, on in a7.items() if on]
    if asked:
        raise NotImplementedError(NOT_PORTED.format(what=", ".join(asked) + " (the platform layers)", item="A7"))
    if run.eval_only:
        raise NotImplementedError(NOT_PORTED.format(what="run.eval_only", item="A3's remainder"))
    if run.eval_which != "last":
        raise ValueError(f"run.eval_which={run.eval_which!r} needs run.eval_only, which is not ported")


def build_model(cfg: TrainConfig, *, device: str | torch.device = "cuda"):
    """The MAE model of the recipe with weights from ``run.init_seed``, its
    encoder config, and its train FLOPs per image."""
    m = cfg.model
    enc = preset(m.preset, labels=None, **{"mask_ratio": 0.75, **m.overrides})
    dec = DecoderConfig(**{"layers": m.dec_layers, "dim": m.dec_dim, "heads": m.dec_heads, "dtype": m.dec_dtype,
                           **m.dec_overrides})
    model = MAEPretrainModel(enc, dec, m.norm_pix_loss, device=device, seed=cfg.run.init_seed)
    return model, enc, pretrain_flops_per_image(enc, dec)


def make_train_iterator(
    cfg: TrainConfig,
    per_process: int,
    start_step: int = 0,
    data_cursor: dict | None = None,
    *,
    device: str | torch.device = "cuda",
):
    """The train batches, copied to ``device`` ahead of the step.

    With a checkpointed ``data_cursor`` the loader continues the stream
    sample-exactly; without one it restarts the stream at the epoch the
    resumed step falls in (shard order and shuffles are keyed on (seed,
    epoch)). One stream epoch yields ``dataset_size × repeats`` samples.

    Returns ``(iterator, source, cursor_log, shard_log)``: ``source`` is
    the :class:`TrainLoader` (``None`` for synthetic data); ``cursor_log``
    and ``shard_log`` map each absolute step to the loader's cursor and
    consumed-shard snapshot after that step's batch left the loader."""
    run, data = cfg.run, cfg.data
    start_epoch = (start_step * run.train_batch_size) // max(1, data.dataset_size * max(1, data.repeats))
    if start_step > 0 and data_cursor is None:
        print(f"[train] data cursor: resuming stream at epoch {start_epoch}")
    cursor_log: dict[int, dict] = {}
    shard_log: dict[int, dict] = {}
    if run.synthetic_data:
        it = synthetic_batches(per_process, data.image_size, grad_accum=run.grad_accum, seed=run.seed)
        source = None
    else:
        try:
            source = TrainLoader(data, per_process, cursor=data_cursor, start_epoch=start_epoch)
            if data_cursor is not None:
                print(f"[train] data cursor: sample-exact resume at epoch/offset {data_cursor['workers']}")
        except ValueError as e:
            if data_cursor is None:
                raise
            print(f"[train] WARNING: {e}; falling back to epoch-{start_epoch} resume")
            source = TrainLoader(data, per_process, start_epoch=start_epoch)

        def tracked():
            step = start_step
            for b in source:
                step += 1
                cursor_log[step] = source.snapshot()
                shards = source.shard_snapshot()
                if shards is not None:
                    shard_log[step] = shards
                yield b

        it = (split_for_accum(b, run.grad_accum) for b in tracked())
    it = ({"images": b["images"]} for b in it)  # pretraining reads the images only
    return prefetch_to_device(it, device), source, cursor_log, shard_log


def make_valid_iterator(cfg: TrainConfig, per_process: int, *, device: str | torch.device = "cuda"):
    """A factory of fresh eval iterators on ``device``, or ``None`` without
    validation data. Synthetic data gives 4 batches from ``seed + 1``."""
    if cfg.run.synthetic_data:
        def gen():
            it = synthetic_batches(per_process, cfg.data.image_size, seed=cfg.run.seed + 1)
            for _, batch in zip(range(4), it):
                yield {"images": batch["images"], "valid": np.ones((per_process,), bool)}

        return lambda: prefetch_to_device(gen(), device)
    if not cfg.data.valid_shards:
        return None
    return lambda: prefetch_to_device(
        ({"images": b["images"], "valid": b["valid"]} for b in valid_loader(cfg.data, per_process)), device
    )


def evaluate(eval_step, state, batches) -> dict[str, float]:
    """The exact weighted mean over the valid rows (padded rows count
    nothing): per-batch sums stay on the device and are fetched once."""
    pending = [eval_step(state, batch, i) for i, batch in enumerate(batches)]
    totals: dict[str, float] = {}
    for sums in engine_mod.fetch_metrics(pending):
        for k, v in sums.items():
            totals[k] = totals.get(k, 0.0) + v
    n = max(totals.pop("num_samples", 0.0), 1.0)
    return {f"val/{k}": v / n for k, v in totals.items()}


def train(cfg: TrainConfig, *, device: str | torch.device = "cuda") -> dict:
    """Run the configured pretraining; returns the last logged metrics and
    ``_exit_reason``."""
    _refuse_unported(cfg)
    dev = resolve_device(device)
    run = cfg.run
    create_mesh(cfg.mesh, device=dev)  # refuses fsdp/tensor > 1 (A6) and axes beyond this device
    if run.train_batch_size % run.grad_accum:
        raise ValueError(f"grad_accum ({run.grad_accum}) must divide the global batch size ({run.train_batch_size})")
    skipped = [f"run.{k}: {what}" for k, what in DEFAULT_LAYERS_NOT_PORTED.items() if getattr(run, k)]
    if skipped:
        print("[train] not ported yet (ROADMAP A7), running without: " + "; ".join(skipped))
    per_process = run.train_batch_size
    per_process_valid = max(1, run.valid_batch_size)

    model, _, flops_per_image = build_model(cfg, device=dev)
    ckpt = Checkpointer(cfg.checkpoint_config())
    resuming = run.resume and ckpt.latest_step() is not None
    state = create_state(model, make_optimizer(cfg.optim, run.train_batch_size), device=dev,
                         init_seed=run.init_seed, rng_seed=run.seed)
    start_step, data_cursor = 0, None
    if resuming:
        state, extra = ckpt.restore(
            state, fallback_steps=2,
            on_fallback=lambda a, b, err: print(f"[train] checkpoint step {a} unreadable ({err}); trying step {b}"),
        )
        start_step = state.step
        data_cursor = extra.get("data_cursor")
        print(f"[train] resumed from step {start_step} in {ckpt.last_restore_s:.2f} s")

    train_step = make_train_step(mode="pretrain", grad_accum=run.grad_accum, guard_nonfinite=run.sentinel)
    eval_step = make_eval_step(mode="pretrain")
    print(param_summary(state.model))
    run_dir = Path(run.output_dir) / run.name
    logger = MetricLogger(
        run_dir, name=run.name, config=config_to_dict(cfg), use_wandb=run.use_wandb,
        wandb_project=run.wandb_project, wandb_entity=run.wandb_entity,
        wandb_tags=tuple(run.wandb_tags), wandb_id=run.wandb_id,
    )
    valid_factory = make_valid_iterator(cfg, per_process_valid, device=dev)
    if run.sanity_eval and valid_factory is not None:
        print("[train] sanity eval:", evaluate(eval_step, state, valid_factory()))

    train_iter, source, cursor_log, shard_log = make_train_iterator(
        cfg, per_process, start_step, data_cursor, device=dev
    )
    try:
        meter = AverageMeter()
        timer = StepTimer(warmup_steps=min(2, max(1, run.training_steps - 1)))
        last_metrics: dict[str, float] = {}
        window = {"t0": time.perf_counter(), "wait": 0.0, "steps": 0}

        def _next_batch(step_now: int):
            t0 = time.perf_counter()
            batch = next(train_iter)
            window["wait"] += time.perf_counter() - t0
            return batch

        engine = RunEngine(
            training_steps=run.training_steps,
            start_step=start_step,
            log_interval=run.log_interval,
            eval_interval=run.eval_interval,
            ckpt_interval=run.ckpt_every,
            next_batch=_next_batch,
            dispatch=lambda state_now, batch, step_now: train_step(state_now, batch),
        )

        @engine.on_step
        def _pacing(eng, ev):
            timer.tick()
            window["steps"] += 1
            # only cursor_log[step] (and prefetched later steps) are ever read
            for log in (cursor_log, shard_log):
                for k in [k for k in log if k < ev.step]:
                    del log[k]

        @engine.on_log_window
        def _log_window(eng, win):
            nonlocal last_metrics
            for s, m in win.fetched:
                skipped = m.get("skipped", 0.0) >= 0.5
                if skipped or not np.isfinite(m.get("loss", np.nan)):
                    win.bad_steps.append(s)
                if not skipped:  # a skipped step's loss is what the guard refused
                    meter.update(m)
            summary = meter.summary("train/")
            sps = timer.steps_per_sec
            if sps:
                imgs = sps * run.train_batch_size
                summary |= {"perf/images_per_sec": imgs, "perf/mfu": mfu(imgs, flops_per_image)}
            now = time.perf_counter()
            summary["perf/data_wait_fraction"] = window["wait"] / max(now - window["t0"], 1e-9)
            summary["perf/data_wait_s_per_step"] = window["wait"] / max(window["steps"], 1)
            window.update(t0=now, wait=0.0, steps=0)
            if win.bad_steps:
                print(f"[train] non-finite steps skipped by the guard: {win.bad_steps}")
            logger.log(summary, step=win.step)
            last_metrics = summary
            win.summary = summary

        @engine.on_eval
        def _eval(eng, step, state_now):
            nonlocal last_metrics
            if valid_factory is None:
                return None
            val = evaluate(eval_step, state_now, valid_factory())
            logger.log(val, step=step)
            print(f"[train] eval at step {step}: {val}")
            last_metrics |= val
            return val

        @engine.on_checkpoint
        def _checkpoint(eng, cev):
            step = cev.step
            extra = {}
            if cursor_log.get(step) is not None:
                extra["data_cursor"] = {**cursor_log[step], "process_count": 1}
            if shard_log.get(step) is not None:
                extra["shard_cursor"] = shard_log[step]
            ckpt.save(step, eng.state, metrics=cev.metrics, extra=extra)
            for log in (cursor_log, shard_log):
                for k in [k for k in log if k <= step]:
                    del log[k]
            logger.log({"ckpt/save_s": ckpt.last_save_s}, step=step)
            print(f"[train] checkpoint at step {step} ({cev.reason}): {ckpt.last_save_s:.3f} s blocking")

        @engine.on_shutdown
        def _drain(eng, reason, step):
            # a save left in flight at exit is a torn step the next resume
            # would have to walk back from
            ckpt.wait()
            if ckpt.last_write_s is not None:
                logger.log({"ckpt/write_s": ckpt.last_write_s, "ckpt/bytes": ckpt.last_save_bytes}, step=step)
                print(f"[train] last checkpoint written in {ckpt.last_write_s:.3f} s, {ckpt.last_save_bytes} bytes")

        def _on_signal(signum, frame):
            print(f"[train] caught signal {signum}: checkpointing and exiting at the next step boundary")
            engine.request_stop("preempted")

        handlers = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                handlers[sig] = signal.signal(sig, _on_signal)
        except ValueError:  # not the main thread: no graceful preemption
            print("[train] WARNING: not on the main thread; SIGTERM will kill the run without a checkpoint")
        try:
            engine.run(state)
        finally:
            for sig, h in handlers.items():
                signal.signal(sig, h)
        if source is not None:
            print(f"[train] host seconds waiting on the loader: {source.wait_s:.3f} over {engine.step - start_step} steps")
        return {**last_metrics, "_exit_reason": engine.exit_reason}
    finally:  # the loader's workers and the log file close however the run ends
        if source is not None:
            source.close()
        logger.close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", type=str, default=None, help="YAML recipe path")
    p.add_argument(
        "--set", dest="overrides", nargs="*", action="extend", default=[],
        help="dotted config overrides, e.g. optim.learning_rate=1e-3 (repeatable)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--distributed", action="store_true", help="multi-process training: not ported yet (ROADMAP A6)")
    p.add_argument("--elastic", type=int, default=0, metavar="N", help="elastic supervisor: not ported yet (ROADMAP A6)")
    return p


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if args.distributed or args.elastic:
        raise NotImplementedError(NOT_PORTED.format(what="--distributed / --elastic", item="A6"))
    metrics = train(load_config(args.config, args.overrides), device=args.device)
    reason = str(metrics.pop("_exit_reason", "completed"))
    print("[train] done:", metrics)
    code = exit_code_for(reason)
    if code != EXIT_OK:
        print(f"[train] exit reason {reason!r} -> exit code {code}")
        raise SystemExit(code)


if __name__ == "__main__":
    main()
