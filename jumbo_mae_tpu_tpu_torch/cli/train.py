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
JSONL with images/s, ``perf/mfu`` against one H100's bf16 peak
(``obs/mfu.py``) and the host's wait for data (``data/wait_fraction``,
``data/wait_s_per_step``). ``run.eval_only`` evaluates and exits: from the ``last`` or
``best`` save (``run.resume=true``, ``run.eval_which``) or a warm start,
with an identity optimizer so no moment reaches the card.
``run.publish_dir`` turns on the gated weights publisher
(``serve/publisher.py``): each interval checkpoint that passes its gates
is exported, int8 and as a delta by default, into that directory, the
one ``cli.predict --swap-watch`` polls; its events (``publish``,
``publish_skipped``, ``publish_failed`` and the ``publish`` tenant's
``tenant_usage``) go to the run's journal.

The run's safety layers, each on by default, in the JAX driver's order:

- ``run.faults``: a fault plan installed at the top of :func:`train`;
  each train step ticks ``host.leak`` and passes ``train.loss`` /
  ``train.grad`` (keyed by the step) to the step as its ``inject``
  multipliers; ``ckpt.save`` and ``ckpt.load`` fire in the checkpointer.
- ``run.journal``: the crash-safe run journal under
  ``<output_dir>/<name>/journal`` (``obs/journal.py``): ``run_start``,
  ``step`` every log window, ``checkpoint_save``, the sentinel's verdicts,
  ``rollback``, ``retrace``, ``mem_sample``, ``mem_leak_suspect``,
  ``shutdown``. A journal write that fails warns and the run goes on.
- ``run.sentinel``: the step's non-finite guard skips a bad update on the
  device, and the host :class:`DivergenceSentinel` watches the fetched
  metrics: ``run.sentinel_patience`` bad steps in a row roll the run back
  to the last checkpoint (parameters, optimizer state, step, the stream
  seed, and the data cursor the save carries); no checkpoint, or more
  than ``run.sentinel_max_rollbacks`` rollbacks, raise
  :class:`DivergenceError` (exit code 43).
- ``run.retrace``: the retrace sentinel (``obs/retrace.py``), armed after
  the first step: a train-step dispatch of a batch signature the loop
  has not dispatched before journals a ``retrace`` event; evals are
  expected.
- ``run.memwatch``: a memory sample every log window (the card's
  allocator, host RSS, the accountant's components, ``fault_ballast``,
  ``flightrec_ring`` and ``journal_file`` among them) and the leak
  sentinel, which names the fastest-growing component
  (``tools/mem_doctor.py`` reads the journal).

What watches the live run, in the same order:

- the goodput ledger (``obs/goodput.py``), from the top of :func:`train`:
  every wall second in one bucket (data wait, compile, productive step,
  rollback recompute, eval, saves, restores, hang latency, idle), a
  ``goodput_report`` row after each committed save and at shutdown, the
  ``goodput_*`` gauges each log window (``tools/goodput_doctor.py`` reads
  the journal);
- ``run.flightrec_steps``: the flight recorder (``obs/flightrec.py``), a
  ring of the last steps and events dumped to
  ``<output_dir>/<name>/flightrec-*.json`` on the first non-finite window,
  a rollback, a leak suspect, SIGTERM (before the graceful checkpoint),
  an escaping exception and a hang;
- ``run.hangwatch_deadline_s``: the hang watchdog (``obs/hangwatch.py``):
  no step for that long outside an eval, a save or a restore journals
  ``hang_detected``, a ``goodput_report`` with ``reason: "hang"`` and a
  flight record, and exits 44 (``EXIT_HANG``); the ``fleet.wedge`` fault
  site (keyed by the step) wedges a dispatch to prove it;
- spans into ``span_seconds{name=...}`` (``data_wait``, ``train_step``,
  ``checkpoint_save``) and the ``train_*`` gauges; ``run.chrome_trace``
  writes them as a Chrome trace at the end, ``run.profile_dir`` a
  ``torch.profiler`` trace of the run's kernels (``obs/trace.py``);
- ``run.telemetry``: ``/metrics`` and ``/healthz`` on
  ``run.telemetry_host:run.telemetry_port`` (``obs/exporter.py``), ready
  once the state is built, degraded once the leak sentinel fires.
  ``run.slo`` is accepted and not read, as in the JAX driver.

What diagnoses the run, in the same order:

- ``run.diag_every``: the step's per-layer-group diagnostics
  (``obs/modelstats.py``): every step reports ``finite_frac``, and every
  ``diag_every``-th step (and the last) the ``(groups, 3)`` array of grad
  norm, param norm and update ratio, computed on the device and fetched
  with the log window's scalars; it lands in the ``model_*{group=...}``
  gauges, the flight recorder, and the ``step`` row's
  ``diag_step``/``diag``; the ``nonfinite_step`` flight record names the
  first group whose grad norm went non-finite. ``run_start`` carries
  ``diag_every`` and ``diag_groups``.
- the step's cost (``obs/costmodel.py`` ``train_step_cost``): at the first
  log boundary one ``compiled_program`` row (the analytic FLOPs with the
  ``grad_ckpt`` recompute, the bytes model and, on the card, the peak
  allocated bytes since the step loop began) and the ``xla_*`` gauges;
  every later window adds ``perf/model_flops_utilization``,
  ``perf/hardware_flops_utilization`` (the recompute counted),
  ``perf/predicted_step_ms`` and ``perf/predict_vs_measured`` (the
  roofline of ``obs/perfmodel.py``) and sets
  ``train_hardware_flops_utilization``. ``tools/run_doctor.py`` explains
  a run from its journal and ``tools/perf_doctor.py`` reads the cost rows
  (or a ``BENCH_HISTORY.jsonl``, ``obs/perfledger.py``).

The data side of the run's faults, in the same order: each decode of the
train streams crosses the ``data.decode`` fault site and the decode
metrics (``data/loader.py``); each log window journals the shards
newly quarantined in this process (``quarantine``), and each save,
a preemption save too, journals this process's consumed-shard ledger
(``shard_cursor``, with ``world``), which the save's ``extra.json`` also
keeps.

``--distributed`` trains on several processes (``parallel/distributed.py``):

    torchrun --nproc-per-node 2 -m jumbo_mae_tpu_tpu_torch.cli.train --distributed \\
        --config recipes/pretrain_vit_l16_in1k_800ep.yaml --set mesh.data=2 ...
    python -m jumbo_mae_tpu_tpu_torch.cli.train --distributed --coordinator 127.0.0.1:29500 \\
        --num-processes 2 --process-id 0 --config ... --set mesh.data=2 ...

Each process takes ``train_batch_size / processes`` rows of the global
batch (its stripe of the shards), the step averages the gradients over
the mesh's ``data`` group, and the random draws cover the global batch, so
N processes take the step one process takes on the whole batch. The
preemption flag is agreed on (the maximum of every process's), so a
SIGTERM to any process stops all of them at one step, with a save. Process
0 writes the saves (the state is replicated), with every process's data
cursor gathered into its ``extra.json``; a barrier keeps every process
from reading ``last/`` before a save is whole, and every process restores
from the same directory. Each process evaluates its stripe of the
validation set and the sums are added over the processes before the
division. Process 0 alone prints the parameter table, logs the metrics
and runs the exporter, the chrome trace and the publisher; every process
keeps its own journal (``journal-host<i>`` past process 0), flight
recorder and goodput ledger.

Everything runs on ``"cuda"`` unless ``--device cpu`` (``device="cpu"``)
asks for the CPU. What the port does not have yet raises, naming its
ROADMAP item: FSDP, tensor and pipeline parallelism (A6.3-A6.5), ``seq``
over processes through this driver (A6.8) and ``--elastic`` (A7.4). The
fleet beacons, on by default, are named once at start as not ported
(A7.4) and the run goes on without them.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import signal
import time
from pathlib import Path

import numpy as np
import torch

from jumbo_mae_tpu_tpu_torch.config import TrainConfig, config_to_dict, load_config
from jumbo_mae_tpu_tpu_torch.data.loader import TrainLoader, prefetch_to_device, split_for_accum, valid_loader
from jumbo_mae_tpu_tpu_torch.data.synthetic import synthetic_batches
from jumbo_mae_tpu_tpu_torch.faults.inject import (
    fault_point, faults_active, host_leak_tick, install_plan, leak_ballast_bytes, set_host_index,
)
from jumbo_mae_tpu_tpu_torch.faults.sentinel import DivergenceError, DivergenceSentinel, SentinelConfig
from jumbo_mae_tpu_tpu_torch.models.classifier import ClassificationModel
from jumbo_mae_tpu_tpu_torch.models.config import DecoderConfig, preset
from jumbo_mae_tpu_tpu_torch.models.mae import MAEPretrainModel
from jumbo_mae_tpu_tpu_torch.data.tario import QUARANTINE
from jumbo_mae_tpu_tpu_torch.obs.costmodel import cost_asdict, publish_cost, train_step_cost, utilization_report
from jumbo_mae_tpu_tpu_torch.obs.exporter import HealthState, TelemetryServer
from jumbo_mae_tpu_tpu_torch.obs.flightrec import FlightRecorder
from jumbo_mae_tpu_tpu_torch.obs.goodput import GoodputLedger
from jumbo_mae_tpu_tpu_torch.obs.hangwatch import HangWatchdog
from jumbo_mae_tpu_tpu_torch.obs.journal import RunJournal, env_fingerprint
from jumbo_mae_tpu_tpu_torch.obs.memwatch import (
    MB, LeakSentinel, MemAccountant, MemoryWatcher, fix_mmap_threshold, tree_nbytes,
)
from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry
from jumbo_mae_tpu_tpu_torch.obs.mfu import (
    H100_PEAK_BF16_TFLOPS,
    classify_flops_per_image,
    mfu,
    pretrain_flops_per_image,
)
from jumbo_mae_tpu_tpu_torch.obs.modelstats import first_nonfinite_group, group_layout, publish_group_stats, stats_dict
from jumbo_mae_tpu_tpu_torch.obs.perfmodel import detect_chip, publish_drift, roofline
from jumbo_mae_tpu_tpu_torch.obs.retrace import RetraceSentinel
from jumbo_mae_tpu_tpu_torch.obs.trace import export_chrome_trace, span_timer, start_chrome_trace, stop_chrome_trace, trace
from jumbo_mae_tpu_tpu_torch.parallel import distributed as pdist
from jumbo_mae_tpu_tpu_torch.parallel.mesh import create_mesh, set_mesh
from jumbo_mae_tpu_tpu_torch.train import engine as engine_mod
from jumbo_mae_tpu_tpu_torch.train.checkpoint import Checkpointer, load_pretrained_params
from jumbo_mae_tpu_tpu_torch.train.engine import EXIT_FATAL, EXIT_HANG, EXIT_OK, RunEngine, exit_code_for
from jumbo_mae_tpu_tpu_torch.train.optim import Identity, make_optimizer
from jumbo_mae_tpu_tpu_torch.train.steps import create_state, make_eval_step, make_train_step
from jumbo_mae_tpu_tpu_torch.utils.device import resolve_device
from jumbo_mae_tpu_tpu_torch.utils.logging import MetricLogger, StepTimer
from jumbo_mae_tpu_tpu_torch.utils.meters import AverageMeter
from jumbo_mae_tpu_tpu_torch.utils.summary import param_summary

NOT_PORTED = "{what} is not ported yet: ROADMAP queue {item}"
# run fields on by default whose layers are not ported: named once at start
# when the field is above 0 (True, or a positive size)
DEFAULT_LAYERS_NOT_PORTED = {
    "fleet": "the fleet beacons (A7.4)",
}


def _refuse_unported(cfg: TrainConfig) -> None:
    """Raise for every setting that needs a part of the JAX package the
    port does not have yet, naming its ROADMAP item, and for the settings
    the JAX driver refuses."""
    run, mesh = cfg.run, cfg.mesh
    if run.mode not in ("pretrain", "finetune", "linear"):
        raise ValueError(f"run.mode must be pretrain, finetune or linear, got {run.mode!r}")
    if mesh.pipe > 1:
        raise NotImplementedError(NOT_PORTED.format(what="mesh.pipe > 1 (the GPipe pipeline)", item="A6.5"))
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
    process_index: int = 0,
    process_count: int = 1,
):
    """The train batches of process ``process_index`` of
    ``process_count``, copied to ``device`` ahead of the step.

    With a checkpointed ``data_cursor`` the loader continues the stream
    sample-exactly (this process's entry of a gathered cursor,
    :func:`_pick_process_cursor`); without one it restarts the stream at
    the epoch the resumed step falls in (shard order and shuffles are
    keyed on (seed, epoch)). One stream epoch yields ``dataset_size ×
    repeats`` samples.

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
        data_cursor = _pick_process_cursor(data_cursor, process_index, process_count)
        where = dict(process_index=process_index, process_count=process_count, start_epoch=start_epoch)
        try:
            source = TrainLoader(data, per_process, cursor=data_cursor, **where)
            if data_cursor is not None:
                print(f"[train] data cursor: sample-exact resume at epoch/offset {data_cursor['workers']}")
        except ValueError as e:
            if data_cursor is None:
                raise
            print(f"[train] WARNING: {e}; falling back to epoch-{start_epoch} resume")
            source = TrainLoader(data, per_process, **where)

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
                        device: str | torch.device = "cuda", keys: tuple[str, ...] | None = None,
                        process_index: int = 0, process_count: int = 1):
    """A factory of fresh eval iterators on ``device`` over process
    ``process_index``'s stripe of the validation shards, or ``None``
    without validation data. Synthetic data gives 4 batches from ``seed +
    1``. A batch holds ``keys`` where the data has them (default: what the
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
        batches = lambda: valid_loader(cfg.data, per_process, process_index=process_index,  # noqa: E731
                                       process_count=process_count)
    else:
        return None
    return lambda: prefetch_to_device(({k: b[k] for k in keys if k in b} for b in batches()), device)


def evaluate(eval_step, state, batches) -> dict[str, float]:
    """The exact weighted mean over the valid rows (padded rows count
    nothing): per-batch sums stay on the device and are fetched once.

    Over several processes each sums its own stripe, and the totals
    (``eval_step.sums``) are added over the processes in one all-reduce
    before the division. The eval step holds no collective, so a process
    whose stripe runs out first, or is empty, needs no padding batches to
    keep in step with the others."""
    pending = [eval_step(state, batch, i) for i, batch in enumerate(batches)]
    totals: dict[str, float] = {}
    for sums in engine_mod.fetch_metrics(pending):
        for k, v in sums.items():
            totals[k] = totals.get(k, 0.0) + v
    if pdist.process_topology()[0] > 1:
        keys = eval_step.sums
        totals = dict(zip(keys, pdist.all_reduce_host([totals.get(k, 0.0) for k in keys]).tolist()))
    n = max(totals.pop("num_samples", 0.0), 1.0)
    return {f"val/{k}": v / n for k, v in totals.items()}


def _agree_on_preemption(flagged: bool, process_count: int) -> bool:
    """Whether to take the preemption exit. Every process must agree (the
    save is collective): any process's flag stops them all."""
    if process_count == 1:
        return flagged
    return bool(pdist.all_reduce_host([flagged], op="max", dtype=np.int64)[0])


def _pick_process_cursor(data_cursor: dict | None, process_index: int, process_count: int) -> dict | None:
    """This process's cursor out of a saved one (:func:`_gather_data_cursor`
    wrote every process's). A sample-exact resume holds only at the saving
    process count (stripes and per-process batches depend on it), so any
    other count drops every process to the epoch resume together."""
    if data_cursor is None:
        return None
    saved = int(data_cursor.get("process_count", 1))
    if saved != process_count:
        print(f"[train] WARNING: checkpoint data cursor was saved with {saved} processes but this run has "
              f"{process_count}; falling back to epoch resume")
        return None
    if "per_process" in data_cursor:
        picked = {"workers": data_cursor["per_process"][process_index], "batches": data_cursor["batches"]}
        if data_cursor.get("native_threads") is not None:
            picked["native_threads"] = data_cursor["native_threads"]
        return picked
    return data_cursor


def _gather_data_cursor(snap: dict | None, process_count: int) -> dict | None:
    """A loader snapshot fit for the save: process 0 writes the save, so
    every process's cursor is gathered into it (``per_process``), with the
    saving ``process_count``, the native reader's thread count and the
    ``override_epoch`` marker when any process's streams are inside an
    override epoch. Collective: every process calls it at the same step."""
    if snap is None:
        return None
    if process_count == 1:
        return {**snap, "process_count": 1}
    gathered = pdist.all_gather_host(snap["workers"])
    override = pdist.all_gather_host(-1 if snap.get("override_epoch") is None else int(snap["override_epoch"]))
    out = {"per_process": gathered.tolist(), "batches": snap["batches"], "process_count": process_count}
    if snap.get("native_threads") is not None:
        out["native_threads"] = snap["native_threads"]
    if int(override.max()) >= 0:
        out["override_epoch"] = int(override.max())
    return out


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


def _chip(dev: torch.device):
    """The performance model's row of ``dev`` for the memory watch's
    capacity, or ``None`` on a card the table has no row for."""
    try:
        return detect_chip(dev)
    except ValueError as e:
        print(f"[obs] {e}; the memory samples carry no capacity")
        return None


def train(cfg: TrainConfig, *, device: str | torch.device = "cuda") -> dict:
    """Run the configured training (or, with ``run.eval_only``, one
    evaluation); returns the last logged metrics and ``_exit_reason``."""
    _refuse_unported(cfg)
    run = cfg.run
    if run.faults:
        # the plan outlives this call, as a GRAFT_FAULTS plan does: tests clear it
        plan = install_plan(run.faults)
        print(f"[faults] injection plan active: sites={plan.sites()}")
    # the goodput ledger's clock starts here, so the state build, the
    # restore and the first dispatch are on the books: every second of this
    # process's wall clock lands in exactly one bucket
    ledger = GoodputLedger(generation=0)  # one process generation until A7.4
    dev = resolve_device(device)
    # the topology: a process of a group joined by --distributed, or alone
    process_count, host_index = pdist.process_topology()
    is_main = host_index == 0
    if process_count > 1:
        # the fault layer's `@host=` identity before any site can fire,
        # mirrored into GRAFT_HOST for the data workers
        set_host_index(host_index)
    # refuses fsdp/tensor > 1 (A6.3, A6.4) and a mesh that does not cover the processes
    mesh = create_mesh(cfg.mesh, device=dev)
    if process_count > 1 and mesh.shape["seq"] > 1:
        raise NotImplementedError(NOT_PORTED.format(
            what="mesh.seq > 1 over processes through cli/train.py (each seq rank needs its data rank's rows)",
            item="A6.8"))
    if run.train_batch_size % (process_count * run.grad_accum):
        raise ValueError(f"process_count * grad_accum ({process_count} * {run.grad_accum}) must divide the global "
                         f"batch size ({run.train_batch_size})")
    skipped = [f"run.{k}: {what}" for k, what in DEFAULT_LAYERS_NOT_PORTED.items() if getattr(run, k) > 0]
    if skipped and is_main:
        print("[train] not ported yet (ROADMAP A7), running without: " + "; ".join(skipped))
    per_process = run.train_batch_size // process_count
    per_process_valid = max(1, run.valid_batch_size // process_count)
    mode = "pretrain" if run.mode == "pretrain" else "classify"

    model, enc_cfg, flops_per_image = build_model(cfg, device=dev)
    # an eval_only run without resume never saves: no checkpoint directory.
    # Process 0 writes (the state is replicated); the barrier keeps every
    # process from reading last/ before a save is whole
    ckpt = None if run.eval_only and not run.resume else Checkpointer(
        cfg.checkpoint_config(), writer=is_main, barrier=pdist.barrier if process_count > 1 else None)
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
    ckpt_fallbacks: list[dict] = []  # journaled once the journal exists
    if resuming and run.eval_only:
        # parameters, buffers, step and seed; the optimizer's bytes are never read
        state, _ = ckpt.restore_eval(state, which=run.eval_which)
        start_step = state.step
        print(f"[train] restored '{run.eval_which}' step {start_step} for evaluation")
    elif resuming:
        def _fallback(from_step, to_step, err):
            print(f"[train] checkpoint step {from_step} unreadable ({err}); trying step {to_step}")
            ckpt_fallbacks.append({"from_step": int(from_step), "to_step": int(to_step),
                                   "error": f"{type(err).__name__}: {err}"})

        state, extra = ckpt.restore(state, fallback_steps=2, on_fallback=_fallback)
        start_step = state.step
        data_cursor = extra.get("data_cursor")
        ledger.add("ckpt_restore", ckpt.last_restore_s or 0.0)
        print(f"[train] resumed from step {start_step} in {ckpt.last_restore_s:.2f} s")

    eval_step = make_eval_step(mode=mode)
    if is_main:
        print(param_summary(state.model))

    # graceful preemption: SIGTERM/SIGINT ask the engine to checkpoint and
    # exit at the next step boundary. Installed BEFORE the flight recorder,
    # whose SIGTERM handler then dumps first and chains into this one; the
    # two come out in reverse order. An eval_only run has no step loop to
    # honour the flag: the default (exit now) is the honest one there
    preempted: list[int] = []

    def _on_signal(signum, frame):
        print(f"[train] caught signal {signum}: checkpointing and exiting at the next step boundary")
        preempted.append(signum)

    handlers = {}
    if not run.eval_only:
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                handlers[sig] = signal.signal(sig, _on_signal)
        except ValueError:  # not the main thread: no graceful preemption
            print("[train] WARNING: not on the main thread; SIGTERM will kill the run without a checkpoint")
    # telemetry: the metrics always record into the process registry; the
    # exporter (/metrics, /healthz) is opt-in. The state is built and (if
    # asked) restored by now, so readiness is honest
    health = HealthState()
    health.set_ready(True, detail=f"mode={run.mode} start_step={start_step}")
    # shard URLs the retry layer gave up on in this process (the native
    # reader reports here; worker interpreters keep their own)
    health.probe("quarantined_shards", lambda: sorted(QUARANTINE.snapshot()))
    telemetry = logger = journal = flightrec = hangwatch = source = None
    run_dir = Path(run.output_dir) / run.name
    try:
        if run.telemetry and is_main:
            telemetry = TelemetryServer(health=health, host=run.telemetry_host, port=run.telemetry_port).start()
            print(f"[obs] exporter on {run.telemetry_host}:{telemetry.port} (/metrics, /healthz)")
        logger = MetricLogger(
            run_dir, name=run.name, config=config_to_dict(cfg), enabled=is_main, use_wandb=run.use_wandb,
            wandb_project=run.wandb_project, wandb_entity=run.wandb_entity,
            wandb_tags=tuple(run.wandb_tags), wandb_id=run.wandb_id,
        )
        num_labels = enc_cfg.labels or 1000
        valid_factory = make_valid_iterator(cfg, per_process_valid, num_labels=num_labels, device=dev,
                                            process_index=host_index, process_count=process_count)
        if run.eval_only:
            if not (resuming or run.pretrained_ckpt) and is_main:
                print("[eval] WARNING: eval_only on a fresh random init; set run.pretrained_ckpt or "
                      "run.resume=true to restore weights")
            with set_mesh(mesh):
                val = evaluate(eval_step, state, valid_factory())
            logger.log(val, step=start_step)
            print(f"[eval] step {start_step}: {val}")
            return {**val, "_exit_reason": "completed"}

        # per-layer-group diagnostics (obs/modelstats.py): with diag_every=0
        # the step is the one without them, not a launch more
        diag_on = run.diag_every > 0
        diag_names = group_layout(state.model) if diag_on else ()
        train_step = make_train_step(mode=mode, grad_accum=run.grad_accum, guard_nonfinite=run.sentinel,
                                     diag=diag_on)
        if run.sanity_eval and valid_factory is not None:
            with set_mesh(mesh):
                print("[train] sanity eval:", evaluate(eval_step, state, valid_factory()))

        # the run's history, crash-safe, and the black box: every layer below
        # reports through _emit, into the journal and the flight ring
        # every process keeps its own: host 0 under journal/, host i under journal-host<i>/
        journal_dir = run_dir / ("journal" if is_main else f"journal-host{host_index}")
        journal = RunJournal(journal_dir, host=host_index) if run.journal else None
        if run.flightrec_steps > 0:
            flightrec = FlightRecorder(run_dir, capacity=run.flightrec_steps, host=host_index)
            flightrec.install()

        def _emit(etype: str, **fields) -> None:
            """One diagnostic event into the journal (durable) and the
            flight ring (memory)."""
            rec = {"ts": round(time.time(), 3), "type": etype, **fields}
            if journal is not None:
                try:
                    rec = journal.event(etype, **fields)
                except OSError as e:  # a full disk must not kill the run
                    print(f"[obs] WARNING: journal write failed: {e}")
            if flightrec is not None:
                flightrec.record_event(rec)

        def _black_box(reason: str, **extra) -> None:
            if flightrec is None:
                return
            path = flightrec.dump(reason, extra=extra or None)
            _emit("flight_record", reason=reason, path=str(path))
            print(f"[obs] flight record ({reason}) -> {path}")

        # armed after the first step: a train-step dispatch of a batch
        # signature not dispatched before then journals a `retrace` event
        retrace = RetraceSentinel("train", journal=journal) if run.retrace else None

        def _noted(fn, tag: str):
            """``fn`` with each batch noted by the retrace sentinel first."""
            if retrace is None:
                return fn

            @functools.wraps(fn)  # eval_step.sums goes along
            def call(state_now, batch, *rest, **kw):
                retrace.dispatch(tag, batch)
                return fn(state_now, batch, *rest, **kw)

            return call

        step_fn, eval_fn = _noted(train_step, "train_step"), _noted(eval_step, "eval_step")
        if journal is not None:
            health.probe("journal", lambda: str(journal.path))
        _emit("run_start", config=config_to_dict(cfg), env=env_fingerprint(), start_step=start_step,
              resumed=bool(resuming), generation=0, diag_every=run.diag_every, diag_groups=list(diag_names))
        for fb in ckpt_fallbacks:
            _emit("ckpt_fallback", **fb)

        # the hang watchdog: beats ride the pre-step hook; a wedged step
        # stops them, and at the deadline the watchdog journals the stall,
        # drains the checkpoint writer (bounded) and exits EXIT_HANG
        if run.hangwatch_deadline_s > 0:
            # the drain joins the writer only: the watchdog's thread enters no collective
            hangwatch = HangWatchdog(run.hangwatch_deadline_s, exit_code=EXIT_HANG, drain=ckpt.drain)

            @hangwatch.on_fire
            def _hang_fired(info):
                _emit("hang_detected", host=host_index, **info)
                # the stall the watchdog sat through is detection latency; a
                # final cumulative report reaches the journal before os._exit
                ledger.add("hang_latency", float(info.get("stalled_s") or 0.0))
                _emit("goodput_report", **ledger.report(step=int(info.get("step") or 0), reason="hang"))
                if flightrec is not None:
                    try:
                        flightrec.dump("hang_detected", extra=info)
                    except Exception:  # noqa: BLE001 - already dying loudly
                        pass
                # os._exit flushes nothing: the line goes out now
                print(f"[train] HANG: no step progress for {info['stalled_s']:.0f}s (deadline "
                      f"{info['deadline_s']:.0f}s) — exiting {EXIT_HANG}", flush=True)

            hangwatch.start()
            print(f"[train] hang watchdog armed after step 1: deadline {run.hangwatch_deadline_s:.0f}s -> "
                  f"exit {EXIT_HANG}")

        def _hw_expected(reason: str):
            """Legitimately slow phases (eval, the rollback's restore, saves)
            suspend the step deadline; the fleet.wedge fault and real stalls
            sit outside every such window."""
            return hangwatch.expected(reason) if hangwatch is not None else contextlib.nullcontext()

        where = dict(num_labels=num_labels, device=dev, process_index=host_index, process_count=process_count)
        train_iter, source, cursor_log, shard_log = make_train_iterator(cfg, per_process, start_step, data_cursor,
                                                                        **where)
        seen_quarantine: set = set()  # shards already journaled as quarantined
        meter = AverageMeter()
        timer = StepTimer(warmup_steps=min(2, max(1, run.training_steps - 1)))
        last_metrics: dict[str, float] = {}
        window = {"t0": time.perf_counter(), "wait": 0.0, "steps": 0}
        prev_window_bad = False  # edge trigger of the non-finite black box
        # the host half of the divergence sentinel: the step's guard skips a
        # non-finite update on the device, this watches the fetched metrics
        # for bad streaks and drives the rollback to the last checkpoint
        sentinel = None
        if run.sentinel:
            sentinel = DivergenceSentinel(SentinelConfig(
                patience=run.sentinel_patience, spike_factor=run.sentinel_spike_factor,
                ema_beta=run.sentinel_ema_beta, max_rollbacks=run.sentinel_max_rollbacks,
            ))
            # each verdict with its exact step; the rollback hook journals
            # the richer rollback event itself
            sentinel.on_event = lambda kind, payload: (
                _emit(f"sentinel_{kind}", **payload) if kind != "rollback" else None
            )

        # the step loop's telemetry: spans into span_seconds{name=...}, the
        # log window's numbers as gauges. train_step spans the DISPATCH (the
        # loop syncs only at log boundaries); the step's wall time is the
        # steps/s the MFU uses
        reg = get_registry()
        g_mfu = reg.gauge("train_mfu", "model FLOP utilization (log-window)")
        g_ips = reg.gauge("train_images_per_sec", "global throughput (log-window)")
        g_wait_frac = reg.gauge("train_data_wait_fraction", "share of wall time waiting on data")
        g_step = reg.gauge("train_step", "current absolute step")
        g_grad_norm = reg.gauge("train_grad_norm", "global gradient norm of the last fetched step")
        c_steps = reg.counter("train_steps_total", "optimizer steps this process")
        # set once the step's cost is known (A7.3), as the JAX driver leaves
        # it without a compiled cost
        g_hfu = reg.gauge("train_hardware_flops_utilization",
                          "counted flops (recompute included) / peak (log-window)")
        # the step's cost: None = not built yet (the first log boundary)
        step_cost = None
        chip = _chip(dev)
        diag_pending: list = []  # [(step, device (G, 3) stats)], fetched at the log boundary
        reg.gauge("run_generation", "elastic supervisor generation of this process (0 = first launch)").set(0)
        # a memory sample every log window, the bytes of each accounted
        # component (the host.leak ballast among them) and the leak sentinel
        memwatch = leak_sentinel = None
        if run.memwatch:
            accountant = MemAccountant()
            accountant.register("fault_ballast", leak_ballast_bytes)
            if flightrec is not None:
                accountant.register("flightrec_ring", flightrec.ring_bytes)
            if journal is not None:
                accountant.register("journal_file", lambda: journal.path.stat().st_size)
            if ckpt is not None:
                # the save's host copy, kept from save to save and taken now,
                # before the first sample
                ckpt.reserve(state)
                accountant.register("ckpt_host_copy", ckpt.host_copy_bytes)
            memwatch = MemoryWatcher(accountant=accountant, chip=chip, device=dev)
            leak_sentinel = LeakSentinel(window=run.memwatch_leak_window, min_growth_mb=run.memwatch_leak_mb)
            health.probe("memory", memwatch.last_sample)
            health.degraded_when(leak_sentinel.degraded)
        sp_wait, sp_step, sp_ckpt = span_timer("data_wait"), span_timer("train_step"), span_timer("checkpoint_save")
        # liveness: a wedged step or a dead loader turns /healthz to 503
        health.watch("train_step", max_age_s=3600.0)
        health.watch("data_batch", max_age_s=3600.0)
        if run.chrome_trace and is_main:
            start_chrome_trace()

        def _next_batch(step_now: int):
            with sp_wait:
                batch = next(train_iter)
            window["wait"] += sp_wait.last_s
            ledger.add("data_wait", sp_wait.last_s)
            health.beat("data_batch")
            return batch

        def _dispatch(state_now, batch, step_now: int):
            inject = None
            # the train fault sites; without a plan this is one branch
            if faults_active():
                # corrupt(n) retains n MB a step in the ballast, raise clears it
                host_leak_tick(key=str(step_now))
                # delay(s) past the hang deadline holds this step outside
                # every expected() window: the watchdog must catch it
                fault_point("fleet.wedge", key=str(step_now), data=None)
                lm = fault_point("train.loss", key=str(step_now), data=1.0)
                gm = fault_point("train.grad", key=str(step_now), data=1.0)
                if (lm, gm) != (1.0, 1.0):
                    inject = (lm, gm)
            # the group statistics only where the host will fetch them: the
            # diag cadence and the last step (finite_frac every step)
            kw = {"diag": step_now % run.diag_every == 0 or step_now == run.training_steps} if diag_on else {}
            with sp_step:
                out = step_fn(state_now, batch, **kw) if inject is None else step_fn(state_now, batch, inject, **kw)
            # the dispatch span: compile (the first dispatch), rollback
            # recompute or productive, by step number and process history
            ledger.note_step(step_now, sp_step.last_s)
            return out

        engine = RunEngine(
            training_steps=run.training_steps,
            start_step=start_step,
            log_interval=run.log_interval,
            eval_interval=run.eval_interval,
            ckpt_interval=run.ckpt_every,
            next_batch=_next_batch,
            dispatch=_dispatch,
            process_count=process_count,
            # the maximum of every process's flag: a SIGTERM to any stops all at one step
            should_stop=lambda: _agree_on_preemption(bool(preempted), process_count),
        )

        @engine.pre_step
        def _beat(eng, step_now):
            if hangwatch is not None:
                hangwatch.beat(step_now)

        @engine.on_step
        def _telemetry(eng, ev):
            c_steps.inc()
            g_step.set(ev.step)
            health.beat("train_step")
            if ev.step == start_step + 1:
                # the first step dispatched: steady state from here
                if retrace is not None:
                    retrace.arm()
                if hangwatch is not None:
                    hangwatch.arm()

        @engine.on_step
        def _diag_component(eng, ev):
            # the (G, 3) array stays out of the window's scalars (the meter
            # and the sentinel read scalars); it is there on cadence only
            if not diag_on:
                return
            metrics = dict(ev.metrics)
            arr = metrics.pop("diag", None)
            if arr is not None:
                diag_pending.append((ev.step, arr))
            ev.metrics = metrics

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
            nonlocal last_metrics, prev_window_bad, step_cost
            for s, m in win.fetched:
                skipped = m.get("skipped", 0.0) >= 0.5
                loss = m.get("loss", np.nan)
                if skipped or not np.isfinite(loss):
                    win.bad_steps.append(s)
                gn = m.get("grad_norm")
                if gn is not None:
                    g_grad_norm.set(gn)
                if flightrec is not None:
                    entry = {"loss": loss}
                    if gn is not None:
                        entry["grad_norm"] = gn
                    if "finite_frac" in m:
                        entry["finite_frac"] = m["finite_frac"]
                    if skipped:
                        entry["skipped"] = True
                    flightrec.record_step(s, entry)
                if sentinel is not None and sentinel.observe(s, m):
                    eng.request_rollback()
                if not skipped:  # a skipped step's loss is what the guard refused
                    meter.update(m)
            # per-layer-group diagnostics: the window's kept arrays in one
            # transfer, published as model_*{group=...} gauges
            latest_diag = None
            if diag_pending:
                fetched = torch.stack([a for _, a in diag_pending]).cpu().numpy()
                for (ds, _), arr in zip(diag_pending, fetched):
                    publish_group_stats(diag_names, arr)
                    latest_diag = (ds, stats_dict(diag_names, arr), arr)
                    if flightrec is not None:
                        flightrec.record_step(ds, {"diag": latest_diag[1]})
                diag_pending.clear()
            summary = meter.summary("train/")
            if step_cost is None:
                # the step's cost, once: the card's peak since the loop began
                # covers the first window's steps
                opt = eng.state.opt_state
                # what this process's card runs: its rows of the global batch
                step_cost = train_step_cost(
                    enc_cfg, getattr(eng.state.model, "decoder_cfg", None), batch=per_process,
                    param_bytes=tree_nbytes(list(eng.state.model.parameters())),
                    opt_bytes=tree_nbytes([getattr(opt, k) for k in opt.SLOTS] + [opt.master]),
                    linear=run.mode == "linear", device_type=dev.type,
                    peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
                )
                publish_cost(step_cost, bucket="", dtype=cfg.model.overrides.get("dtype", ""))
                _emit("compiled_program", batch=per_process, **cost_asdict(step_cost))
            sps = timer.steps_per_sec
            if sps:
                imgs = sps * run.train_batch_size
                # one card a process: the per-chip figures are this process's
                util = utilization_report(flops_per_image * per_process, step_cost.flops, sps,
                                          peak_tflops=H100_PEAK_BF16_TFLOPS)
                summary |= {
                    "perf/images_per_sec": imgs,
                    "perf/images_per_sec_per_chip": imgs / process_count,
                    "perf/mfu": mfu(imgs / process_count, flops_per_image),
                    "perf/tflops_per_chip": util.achieved_model_tflops,
                    # MFU (the model's FLOPs) against HFU (the recompute counted)
                    "perf/model_flops_utilization": util.model_flops_utilization,
                    "perf/hardware_flops_utilization": util.hardware_flops_utilization,
                }
                if chip is not None:  # a card the table has no row for gets no roofline
                    pred = roofline(step_cost.flops, step_cost.bytes_accessed, chip,
                                    peak_hbm_bytes=step_cost.peak_bytes or 0.0)
                    summary["perf/predicted_step_ms"] = pred.step_time_s * 1e3
                    summary["perf/predict_vs_measured"] = publish_drift(pred.step_time_s, 1.0 / sps,
                                                                        program="train_step")
                g_mfu.set(summary["perf/mfu"])
                g_ips.set(imgs)
                g_hfu.set(util.hardware_flops_utilization)
            now = time.perf_counter()
            summary["data/wait_fraction"] = window["wait"] / max(now - window["t0"], 1e-9)
            summary["data/wait_s_per_step"] = window["wait"] / max(window["steps"], 1)
            g_wait_frac.set(summary["data/wait_fraction"])
            ledger.publish()  # the goodput_* gauges follow the log window
            window.update(t0=now, wait=0.0, steps=0)
            msnap = None
            if memwatch is not None:
                memwatch.record_predicted_peak("train_step", step_cost.peak_bytes)
                msnap = memwatch.sample()
                if "note" in msnap:
                    print(f"[obs] {msnap['note']}")
            if win.bad_steps:
                print(f"[train] non-finite steps skipped by the guard: {win.bad_steps}")
            logger.log(summary, step=win.step)
            last_metrics = summary
            win.summary = summary
            row = {"step": win.step, "metrics": summary,
                   "data_wait_fraction": round(summary["data/wait_fraction"], 4)}
            if win.bad_steps:
                row["bad_steps"] = win.bad_steps
            if latest_diag is not None:
                row["diag_step"] = latest_diag[0]
                row["diag"] = latest_diag[1]
            _emit("step", **row)
            # the shards the retry layer gave up on in this process since the last window
            new_q = set(QUARANTINE.snapshot()) - seen_quarantine
            if new_q:
                seen_quarantine.update(new_q)
                _emit("quarantine", shards=sorted(new_q))
            if msnap is not None:
                _emit("mem_sample", step=win.step, **{k: v for k, v in msnap.items() if k != "ts"})
                fired = leak_sentinel.observe(msnap)
                if fired is not None:
                    _emit("mem_leak_suspect", step=win.step, **fired)
                    print(f"[obs] WARNING: leak sentinel fired — suspect {fired['component']} "
                          f"(+{fired['robust_growth_bytes'] // MB} MiB robust growth over {fired['window']} "
                          "samples); /healthz degraded")
                    _black_box("mem_leak", **fired)
            # the black box on the first bad window only: a streak of NaN
            # steps is one incident, not a dump per log window
            if win.bad_steps:
                if flightrec is not None:
                    flightrec.mark_abnormal()
                if not prev_window_bad:
                    grp = first_nonfinite_group(diag_names, latest_diag[2]) if latest_diag is not None else None
                    _black_box("nonfinite_step", bad_steps=win.bad_steps, first_nonfinite_group=grp)
            prev_window_bad = bool(win.bad_steps)

        def _rollback(eng, step, win):
            # persistent divergence: restore the last checkpoint (parameters,
            # optimizer state, step, seed and data cursor) and go on from
            # there; skipping alone cannot repair a state that is already bad
            nonlocal train_iter, source, cursor_log, shard_log, prev_window_bad
            t0 = time.perf_counter()
            with _hw_expected("rollback"):
                ckpt.wait()  # a save still on the writer thread is not committed yet
                if ckpt.latest_step("last") is None:
                    raise DivergenceError(
                        f"training diverged at step {step} with no checkpoint to roll back to — lower the LR or "
                        "set run.eval_interval below the failure point"
                    )
                sentinel.record_rollback()  # raises once the budget is spent
                eng.state, extra = ckpt.restore(eng.state)
            ledger.add("ckpt_restore", time.perf_counter() - t0)
            new_step = int(eng.state.step)
            # every step dispatched again up to `step` is recompute, not progress
            ledger.note_rollback(step, new_step)
            print(f"[train] sentinel rollback #{sentinel.rollbacks} → resuming from step {new_step}")
            _emit("rollback", from_step=step, to_step=new_step, rollbacks=sentinel.rollbacks, bad_steps=win.bad_steps)
            # every rollback leaves a black box: the ring around the divergence
            _black_box("sentinel_rollback", from_step=step, to_step=new_step, rollbacks=sentinel.rollbacks)
            prev_window_bad = False  # the restored stream starts clean
            if source is not None:
                source.close()
            with _hw_expected("rollback-restart"):
                train_iter, source, cursor_log, shard_log = make_train_iterator(
                    cfg, per_process, new_step, extra.get("data_cursor"), **where
                )
            return new_step

        if sentinel is not None:
            engine.on_rollback(_rollback)

        @engine.on_eval
        def _eval(eng, step, state_now):
            nonlocal last_metrics
            if valid_factory is None:
                return None
            t0 = time.perf_counter()
            with _hw_expected("eval"), retrace.expected("eval") if retrace is not None else contextlib.nullcontext():
                val = evaluate(eval_fn, state_now, valid_factory())
            ledger.add("eval", time.perf_counter() - t0)
            logger.log(val, step=step)
            print(f"[train] eval at step {step}: {val}")
            last_metrics |= val
            return val

        def _emit_shard_cursor(step: int) -> None:
            # every process journals its consumed-shard ledger at the saved
            # step: the per-process cursor a resized resume merges
            shards = shard_log.get(step)
            if shards is not None:
                _emit("shard_cursor", step=step, world=process_count, **shards)

        @engine.on_checkpoint
        def _checkpoint(eng, cev):
            step = cev.step
            extra = {}
            snap = _gather_data_cursor(cursor_log.get(step), process_count)  # collective
            if snap is not None:
                extra["data_cursor"] = snap
            if shard_log.get(step) is not None:
                extra["shard_cursor"] = shard_log[step]
            with _hw_expected("checkpoint"), sp_ckpt:
                ckpt.save(step, eng.state, metrics=cev.metrics, extra=extra)
            ledger.add("ckpt_save", sp_ckpt.last_s)
            cev.save_seconds = round(sp_ckpt.last_s, 3)
            logger.log({"ckpt/save_s": ckpt.last_save_s}, step=step)
            print(f"[train] checkpoint at step {step} ({cev.reason}): {ckpt.last_save_s:.3f} s blocking")
            if cev.reason == "preemption":
                _emit("checkpoint_save", step=step, preemption=True)
            else:
                _emit("checkpoint_save", step=step, eval_metrics=cev.metrics, save_seconds=cev.save_seconds)
                # a cumulative attribution a committed save: the offline
                # stitcher keys lost work off these
                ledger.publish()
                _emit("goodput_report", **ledger.report(step=step))
            _emit_shard_cursor(step)
            for log in (cursor_log, shard_log):
                for k in [k for k in log if k <= step]:
                    del log[k]

        @engine.on_crash
        def _crash(eng, exc):
            if isinstance(exc, DivergenceError):
                eng.exit_reason = "diverged"
            # the black box is worth most here: the ring is about to vanish
            if flightrec is not None:
                try:
                    flightrec.dump("exception", extra={"error": f"{type(exc).__name__}: {exc}"})
                except Exception:  # noqa: BLE001 - never mask the real failure
                    pass

        @engine.on_shutdown
        def _drain(eng, reason, step):
            # the watchdog stands down first: a long final wait is a clean
            # drain, not a hang. A save left in flight at exit is a torn step
            # the next resume would have to walk back from
            if hangwatch is not None:
                hangwatch.disarm()
                hangwatch.stop()
            if reason.startswith("exception:"):
                ckpt.drain()  # the other processes may never reach the barrier
            else:
                ckpt.wait()
            if ckpt.last_write_s is not None:
                logger.log({"ckpt/write_s": ckpt.last_write_s, "ckpt/bytes": ckpt.last_save_bytes}, step=step)
                print(f"[train] last checkpoint written in {ckpt.last_write_s:.3f} s, {ckpt.last_save_bytes} bytes")

        @engine.on_shutdown
        def _retrace_summary(eng, reason, step):
            if retrace is not None:
                rsum = retrace.summary()
                print(f"[train] retrace sentinel: {rsum['violations']} unexpected recompile(s) after warmup "
                      f"({rsum['compiles']} compiles seen, {rsum['expected']} expected)")
                retrace.close()

        @engine.on_shutdown
        def _journal_shutdown(eng, reason, step):
            # the ledger's last word covers the tail past the last save and
            # carries the exit reason
            ledger.publish()
            _emit("goodput_report", **ledger.report(step=step, reason=reason))
            _emit("shutdown", reason=reason, step=step)
            if flightrec is not None:
                flightrec.uninstall()

        # continuous deployment: registered last, so a publish follows its
        # checkpoint and sees the restore of a rollback
        if run.publish_dir and is_main:
            from jumbo_mae_tpu_tpu_torch.serve.publisher import CheckpointPublisher

            CheckpointPublisher(
                run.publish_dir, quant=run.publish_quant, min_interval_steps=run.publish_min_interval_steps,
                full_every=run.publish_full_every, metric_key=run.publish_metric_key,
                metric_floor=run.publish_metric_floor, metric_sense=run.publish_metric_sense, emit=_emit,
            ).register(engine)
            print(f"[publish] gated weights publisher -> {run.publish_dir}")

        if dev.type == "cuda":
            # the step's peak_bytes: the allocator's high-water mark from here
            torch.cuda.reset_peak_memory_stats(dev)
        with set_mesh(mesh), trace(run.profile_dir or None):
            engine.run(state)
        if run.chrome_trace and is_main:
            print(f"[obs] chrome trace -> {export_chrome_trace(run.chrome_trace)}")
        if source is not None:
            print(f"[train] host seconds waiting on the loader: {source.wait_s:.3f} over {engine.step - start_step} steps")
        return {**last_metrics, "_exit_reason": engine.exit_reason}
    finally:
        # however the run ends: the watchdog, the recorder's hooks, then the
        # preemption handlers (reverse order of install), the span buffer,
        # the loader's workers, the journal, the log file and the exporter
        if hangwatch is not None:
            hangwatch.disarm()
            hangwatch.stop()
        if flightrec is not None:
            flightrec.uninstall()
        for sig, h in handlers.items():
            signal.signal(sig, h)
        if run.chrome_trace and is_main:
            stop_chrome_trace()
        if source is not None:
            source.close()
        if journal is not None:
            journal.close()
        if logger is not None:
            logger.close()
        if telemetry is not None:
            telemetry.close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", type=str, default=None, help="YAML recipe path")
    p.add_argument(
        "--set", dest="overrides", nargs="*", action="extend", default=[],
        help="dotted config overrides, e.g. optim.learning_rate=1e-3 (repeatable)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default: cuda:{LOCAL_RANK %% cards}) or cpu")
    p.add_argument("--distributed", action="store_true",
                   help="train on several processes: the rendezvous is --coordinator or torchrun's environment")
    p.add_argument("--coordinator", type=str, default=None,
                   help="HOST:PORT where the processes of --distributed meet (process 0 listens)")
    p.add_argument("--num-processes", type=int, default=None, help="the process count, with --coordinator")
    p.add_argument("--process-id", type=int, default=None, help="this process's index, with --coordinator")
    p.add_argument("--elastic", type=int, default=0, metavar="N", help="elastic supervisor: not ported yet (ROADMAP A7.4)")
    return p


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if args.elastic:
        raise NotImplementedError(NOT_PORTED.format(what="--elastic (the elastic supervisor)", item="A7.4"))
    # freed batch buffers leave the resident set, which the leak sentinel reads
    fix_mmap_threshold()
    device = args.device
    if args.distributed:
        rdv = pdist.rendezvous(args.coordinator, args.num_processes, args.process_id)
        device, backend = pdist.init_distributed(rdv, args.device)
        print(f"[train] --distributed: process {rdv.rank} of {rdv.world_size} ({rdv.local_world_size} on this node) "
              f"on {device}, backend {backend} ({'the CPU' if device.type == 'cpu' else 'more processes than cards'} "
              f"-> gloo, else nccl)", flush=True)
    try:
        metrics = train(load_config(args.config, args.overrides), device=device)
    except DivergenceError as e:
        # deterministic: a supervisor must not spend restarts proving it again
        print(f"[train] FATAL: {e}")
        raise SystemExit(EXIT_FATAL) from e
    finally:
        if args.distributed:
            torch.distributed.destroy_process_group()
    reason = str(metrics.pop("_exit_reason", "completed"))
    print("[train] done:", metrics)
    code = exit_code_for(reason)
    if code != EXIT_OK:
        print(f"[train] exit reason {reason!r} -> exit code {code}")
        raise SystemExit(code)


if __name__ == "__main__":
    main()
