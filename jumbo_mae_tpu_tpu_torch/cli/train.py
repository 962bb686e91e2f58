"""Training entry point: MAE pretraining, finetuning and linear probing,
driven by a YAML recipe.

Counterpart of ``jumbo_mae_tpu_tpu/cli/train.py``:

    python -m jumbo_mae_tpu_tpu_torch.cli.train --config recipes/pretrain_vit_l16_in1k_800ep.yaml \\
        --set data.train_shards=... data.valid_shards=... run.output_dir=runs
    python -m jumbo_mae_tpu_tpu_torch.cli.train --config recipes/finetune_vit_b16.yaml \\
        --set run.pretrained_ckpt=runs/pretrain_vit_b16_in1k_1600ep/ckpt data.train_shards=... data.valid_shards=...
    python -m jumbo_mae_tpu_tpu_torch.cli.train --config recipes/finetune_vit_b16.yaml \\
        --set run.eval_only=true run.resume=true run.eval_which=best data.valid_shards=...
    python -m jumbo_mae_tpu_tpu_torch.cli.train --config recipes/smoke_cpu.yaml --device cpu

The run: the recipe's model (``run.mode``: ``pretrain`` builds the MAE
model; ``finetune`` the classifier; ``linear`` the classifier with its
trunk frozen and a BatchNorm head) and optimizer (``train/steps.py``,
``train/optim.py``), synthetic or tar-shard data through worker
interpreters (``data/loader.py``) copied to the card on a side CUDA
stream (or, with ``data.use_native``, the native tar reader in this
process), a warm start from a port checkpoint or a flax ``.msgpack``
params file (``run.pretrained_ckpt``: the encoder of an MAE save merged
into the classifier's trunk, then the optimizer built on the merged
weights), a sanity eval before step 1, eval
at ``eval_interval`` and at the end (padded valid rows masked out;
``val/loss``, and ``val/acc1``/``val/acc5`` when classifying),
checkpoints at every eval and every ``ckpt_every`` steps with ``best`` by
``val/loss`` (pretraining) or ``val/acc1`` (``train/checkpoint.py``),
``run.resume`` from the newest save with the sample-exact data cursor (or,
without one, the stream restarted at the resumed step's epoch), a
checkpoint on SIGTERM/SIGINT at the next step boundary, and a metrics
JSONL with images/s and ``perf/mfu`` against one H100's bf16 peak
(``obs/mfu.py``). The step drops non-finite updates (``run.sentinel``, its
device guard). ``run.eval_only`` evaluates and exits: from the ``last`` or
``best`` save (``run.resume=true``, ``run.eval_which``) or a warm start,
with an identity optimizer so no moment reaches the card.
``run.publish_dir`` turns on the gated weights publisher
(``serve/publisher.py``): each interval checkpoint that passes its gates
is exported, int8 and as a delta by default, into that directory, the
one ``cli.predict --swap-watch`` polls; its events (``publish``,
``publish_skipped``, ``publish_failed`` and the ``publish`` tenant's
``tenant_usage``) go to ``<output_dir>/<name>/journal``.

Everything runs on ``"cuda"`` unless ``--device cpu`` (``device="cpu"``)
asks for the CPU. What the port does not have yet raises, naming its
ROADMAP item: FSDP, tensor and pipeline parallelism, ``--distributed`` and
``--elastic`` (A6); fault plans, telemetry, traces, diagnostics, the hang
watchdog and SLOs (A7). The platform layers a recipe has on by default
— the rollback sentinel, journal, retrace sentinel, fleet beacons and
memory watch — are named once at start as not ported (A7) and the run
goes on without them.
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
from jumbo_mae_tpu_tpu_torch.models.classifier import ClassificationModel
from jumbo_mae_tpu_tpu_torch.models.config import DecoderConfig, preset
from jumbo_mae_tpu_tpu_torch.models.mae import MAEPretrainModel
from jumbo_mae_tpu_tpu_torch.obs.mfu import classify_flops_per_image, mfu, pretrain_flops_per_image
from jumbo_mae_tpu_tpu_torch.parallel.mesh import create_mesh
from jumbo_mae_tpu_tpu_torch.train import engine as engine_mod
from jumbo_mae_tpu_tpu_torch.train.checkpoint import Checkpointer, load_pretrained_params
from jumbo_mae_tpu_tpu_torch.train.engine import EXIT_OK, RunEngine, exit_code_for
from jumbo_mae_tpu_tpu_torch.train.optim import Identity, make_optimizer
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
    port does not have yet, naming its ROADMAP item, and for the settings
    the JAX driver refuses."""
    run, mesh = cfg.run, cfg.mesh
    if run.mode not in ("pretrain", "finetune", "linear"):
        raise ValueError(f"run.mode must be pretrain, finetune or linear, got {run.mode!r}")
    if mesh.pipe > 1:
        raise NotImplementedError(NOT_PORTED.format(what="mesh.pipe > 1 (the GPipe pipeline)", item="A6"))
    a7 = {
        "run.faults": bool(run.faults),
        "run.telemetry": run.telemetry,
        "run.chrome_trace": bool(run.chrome_trace),
        "run.profile_dir": bool(run.profile_dir),
        "run.diag_every > 0": run.diag_every > 0,
        "run.hangwatch_deadline_s > 0": run.hangwatch_deadline_s > 0,
        "run.slo": bool(run.slo),
    }
    asked = [k for k, on in a7.items() if on]
    if asked:
        raise NotImplementedError(NOT_PORTED.format(what=", ".join(asked) + " (the platform layers)", item="A7"))
    if run.eval_only and not (cfg.data.valid_shards or run.synthetic_data):
        raise ValueError("run.eval_only requires validation data (data.valid_shards or run.synthetic_data)")
    if run.eval_which not in ("last", "best"):
        raise ValueError(f"run.eval_which must be 'last' or 'best', got {run.eval_which!r}")
    if run.eval_which != "last" and not (run.eval_only and run.resume):
        # only the eval_only + resume restore reads the slot; elsewhere it
        # would be dropped without a word
        raise ValueError("run.eval_which=best requires run.eval_only=true AND run.resume=true")


def build_model(cfg: TrainConfig, *, device: str | torch.device = "cuda"):
    """The recipe's model with weights from ``run.init_seed``, its encoder
    config, and its train FLOPs per image: the MAE model in pretraining,
    the classifier otherwise (``linear`` freezes the trunk and adds the
    BatchNorm head)."""
    m = cfg.model
    if cfg.run.mode == "pretrain":
        enc = preset(m.preset, labels=None, **{"mask_ratio": 0.75, **m.overrides})
        dec = DecoderConfig(**{"layers": m.dec_layers, "dim": m.dec_dim, "heads": m.dec_heads,
                               "dtype": m.dec_dtype, **m.dec_overrides})
        model = MAEPretrainModel(enc, dec, m.norm_pix_loss, device=device, seed=cfg.run.init_seed)
        return model, enc, pretrain_flops_per_image(enc, dec)
    linear = cfg.run.mode == "linear"
    enc = preset(m.preset, **{"mask_ratio": None, "linear_probing": linear, "batch_norm": linear, **m.overrides})
    model = ClassificationModel(
        enc, mixup_alpha=m.mixup, cutmix_alpha=m.cutmix, label_smoothing=m.label_smoothing,
        criterion=m.criterion, device=device, seed=cfg.run.init_seed,
    )
    return model, enc, classify_flops_per_image(enc)


def _model_keys(cfg: TrainConfig) -> tuple[str, ...]:
    return ("images",) if cfg.run.mode == "pretrain" else ("images", "labels")


def make_train_iterator(
    cfg: TrainConfig,
    per_process: int,
    start_step: int = 0,
    data_cursor: dict | None = None,
    *,
    num_labels: int = 1000,
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
        # the model's class count: a label >= labels one-hots to a zero row
        labels = None if run.mode == "pretrain" else num_labels
        it = synthetic_batches(per_process, data.image_size, labels=labels, grad_accum=run.grad_accum, seed=run.seed)
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
    keys = _model_keys(cfg)  # pretraining reads the images only
    it = ({k: b[k] for k in keys} for b in it)
    return prefetch_to_device(it, device), source, cursor_log, shard_log


def make_valid_iterator(cfg: TrainConfig, per_process: int, *, num_labels: int = 1000,
                        device: str | torch.device = "cuda", keys: tuple[str, ...] | None = None):
    """A factory of fresh eval iterators on ``device``, or ``None`` without
    validation data. Synthetic data gives 4 batches from ``seed + 1``.
    A batch holds ``keys`` where the data has them (default: what the
    eval step reads, and ``valid``)."""
    keys = (*_model_keys(cfg), "valid") if keys is None else keys
    if cfg.run.synthetic_data:
        labels = None if cfg.run.mode == "pretrain" else num_labels

        def gen():
            it = synthetic_batches(per_process, cfg.data.image_size, labels=labels, seed=cfg.run.seed + 1)
            for _, batch in zip(range(4), it):
                yield {**batch, "valid": np.ones((per_process,), bool)}

        batches = gen
    elif cfg.data.valid_shards:
        batches = lambda: valid_loader(cfg.data, per_process)  # noqa: E731
    else:
        return None
    return lambda: prefetch_to_device(({k: b[k] for k in keys if k in b} for b in batches()), device)


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


def _warm_start(model, path: str) -> dict:
    """Merge the port checkpoint under ``path`` into ``model``'s
    parameters in place (``load_pretrained_params``); returns the merge's
    name lists."""
    stats: dict = {}
    params = dict(model.named_parameters())
    merged = load_pretrained_params(path, params, stats=stats)
    with torch.no_grad():
        for name, p in params.items():
            if merged[name] is not p:
                p.copy_(merged[name])
    return stats


def train(cfg: TrainConfig, *, device: str | torch.device = "cuda") -> dict:
    """Run the configured training (or, with ``run.eval_only``, one
    evaluation); returns the last logged metrics and ``_exit_reason``."""
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
    mode = "pretrain" if run.mode == "pretrain" else "classify"

    model, enc_cfg, flops_per_image = build_model(cfg, device=dev)
    # an eval_only run without resume never saves: no checkpoint directory
    ckpt = None if run.eval_only and not run.resume else Checkpointer(cfg.checkpoint_config())
    resuming = run.resume and ckpt is not None and ckpt.latest_step(run.eval_which) is not None
    if run.eval_only and run.resume and not resuming:
        # a restore asked for and impossible must not fall through to
        # plausible-looking metrics of a random init
        raise FileNotFoundError(
            f"run.eval_only with run.resume=true but no '{run.eval_which}' checkpoint under "
            f"{cfg.checkpoint_config().directory}"
        )
    if run.pretrained_ckpt and not resuming:
        # the merge comes first, into the float32 model, so the optimizer
        # (and its master weights) is built on the merged parameters; a
        # resume overwrites both
        _warm_start(model, run.pretrained_ckpt)
    # evaluation takes no step: the identity optimizer keeps no moments
    tx = (Identity(cfg.optim.param_dtype) if run.eval_only
          else make_optimizer(cfg.optim, run.train_batch_size, num_layers=enc_cfg.layers))
    state = create_state(model, tx, device=dev, init_seed=run.init_seed, rng_seed=run.seed)
    start_step, data_cursor = 0, None
    if resuming and run.eval_only:
        # parameters, buffers, step and seed; the optimizer's bytes are never read
        state, _ = ckpt.restore_eval(state, which=run.eval_which)
        start_step = state.step
        print(f"[train] restored '{run.eval_which}' step {start_step} for evaluation")
    elif resuming:
        state, extra = ckpt.restore(
            state, fallback_steps=2,
            on_fallback=lambda a, b, err: print(f"[train] checkpoint step {a} unreadable ({err}); trying step {b}"),
        )
        start_step = state.step
        data_cursor = extra.get("data_cursor")
        print(f"[train] resumed from step {start_step} in {ckpt.last_restore_s:.2f} s")

    eval_step = make_eval_step(mode=mode)
    print(param_summary(state.model))
    run_dir = Path(run.output_dir) / run.name
    logger = MetricLogger(
        run_dir, name=run.name, config=config_to_dict(cfg), use_wandb=run.use_wandb,
        wandb_project=run.wandb_project, wandb_entity=run.wandb_entity,
        wandb_tags=tuple(run.wandb_tags), wandb_id=run.wandb_id,
    )
    num_labels = enc_cfg.labels or 1000
    valid_factory = make_valid_iterator(cfg, per_process_valid, num_labels=num_labels, device=dev)
    if run.eval_only:
        try:
            if not (resuming or run.pretrained_ckpt):
                print("[eval] WARNING: eval_only on a fresh random init; set run.pretrained_ckpt or "
                      "run.resume=true to restore weights")
            val = evaluate(eval_step, state, valid_factory())
            logger.log(val, step=start_step)
            print(f"[eval] step {start_step}: {val}")
            return {**val, "_exit_reason": "completed"}
        finally:
            logger.close()

    train_step = make_train_step(mode=mode, grad_accum=run.grad_accum, guard_nonfinite=run.sentinel)
    if run.sanity_eval and valid_factory is not None:
        print("[train] sanity eval:", evaluate(eval_step, state, valid_factory()))

    train_iter, source, cursor_log, shard_log = make_train_iterator(
        cfg, per_process, start_step, data_cursor, num_labels=num_labels, device=dev
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

        # continuous deployment: registered after the saver, so a publish
        # follows its checkpoint
        journal = None
        if run.publish_dir:
            from jumbo_mae_tpu_tpu_torch.obs.journal import RunJournal
            from jumbo_mae_tpu_tpu_torch.serve.publisher import CheckpointPublisher

            journal = RunJournal(run_dir / "journal")
            CheckpointPublisher(
                run.publish_dir, quant=run.publish_quant, min_interval_steps=run.publish_min_interval_steps,
                full_every=run.publish_full_every, metric_key=run.publish_metric_key,
                metric_floor=run.publish_metric_floor, metric_sense=run.publish_metric_sense, emit=journal.event,
            ).register(engine)
            print(f"[publish] gated weights publisher -> {run.publish_dir}")

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
            if journal is not None:
                journal.close()
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
