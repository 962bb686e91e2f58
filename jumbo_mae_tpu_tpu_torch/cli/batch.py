"""Offline batch inference entry point: tar shards → durable part files.

Counterpart of ``jumbo_mae_tpu_tpu/cli/batch.py``, with its parser and
flags. Runs a resumable :class:`~jumbo_mae_tpu_tpu_torch.batch.BatchJobRunner`
over the serving stack — continuous scheduler, tenant admission (the job
is a ``batch``-class tenant by default), supervised replica pool — so an
offline dataset pass shares capacity and admission with interactive
traffic instead of bypassing them.

    python -m jumbo_mae_tpu_tpu_torch.cli.batch shard-{0..9}.tar --out runs/job1
    # killed? preempted? just run the same command again: it resumes
    # sample-exactly and the final manifest is byte-identical

    # a finetune save's ViT-B/16 features over image shards, on the card
    python -m jumbo_mae_tpu_tpu_torch.cli.batch shard-{0..3}.tar --out runs/feats \\
        --config recipes/finetune_vit_b16.yaml --ckpt runs/finetune_vit_b16/ckpt \\
        --task features --replicas 2 --workers 2 --max-batch 64

SIGTERM/SIGINT request a graceful drain: workers finish their in-flight
window, release their shard leases, and the job exits resumable (exit
code 3). A second signal aborts hard — which is also safe, only slower to
resume.

Without ``--config`` a deterministic service-time model stands in for the
engine (CI and smoke tests); each sample is its first member's bytes as a
fixed-width vector. With it, :class:`InferenceEngine` replicas serve the
job, built from the recipe and ``--ckpt`` as ``cli/predict.py`` builds
them (``--device cpu`` to run on the CPU), and each sample's image member
is decoded and put through the eval transform at the engine's size.

Every request is traced into ``<out>/access`` (``obs/reqtrace.py``) and
every flushed batch billed per tenant by a
:class:`~jumbo_mae_tpu_tpu_torch.serve.costmeter.CostMeter`: the
engines' captured-graph costs, or for the stub ``--model-gflops-per-item``
× the bucket. A tenant's ``budget=``/``window=`` is enforced at
admission (over budget, it sheds at scavenger pressure, and the runner
retries its samples). The last stdout line is one JSON summary object
(manifest path, samples, lease steals, ``tenant_usage`` from the access
log's last ``tenant_usage`` rows, ``replica_preemptions`` counted from
its ``replica_preempted`` events, the scheduler's and the replicas'
counts) for scripted callers; ``python -m
jumbo_mae_tpu_tpu_torch.tools.cost_doctor <out>/access`` reconciles the
bill.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import time

import numpy as np

from jumbo_mae_tpu_tpu_torch.batch import BatchJobRunner, JobSpec


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("shards", nargs="+", help="tar shard URLs/paths, in order")
    p.add_argument("--out", required=True, help="job output directory")
    p.add_argument("--task", default="features")
    p.add_argument("--tenant", default="batch")
    p.add_argument(
        "--tenants",
        default="batch=batch",
        help="tenant spec list (serve.parse_tenants syntax); the job "
        "submits as --tenant and shares the gate with any others listed; "
        "budget=/window= are enforced through the cost meter",
    )
    p.add_argument("--workers", type=int, default=2, help="shard-parallel job workers")
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-delay-ms", type=float, default=2.0)
    p.add_argument("--max-queue", type=int, default=64)
    p.add_argument("--lease-s", type=float, default=30.0, help="shard lease horizon")
    p.add_argument("--submit-window", type=int, default=8)
    p.add_argument("--deadline-ms", type=float, default=None)
    p.add_argument("--config", default=None, help="model config -> real engine replicas")
    p.add_argument("--ckpt", default="", help="--config: a port checkpoint (random init if omitted)")
    p.add_argument("--device", default="cuda", help="--config: cuda (default) or cpu")
    p.add_argument("--service-overhead-ms", type=float, default=1.0)
    p.add_argument("--service-per-item-ms", type=float, default=0.2)
    p.add_argument("--model-gflops-per-item", type=float, default=1.0,
                   help="the stub's cost model for the cost meter: GFLOPs an item, billed per bucket row")
    return p


class _StubEngine:
    """Deterministic service-time model (same role as loadgen's): output
    depends only on the input bytes, so restarted jobs recompute
    byte-identical part files."""

    def __init__(self, overhead_s: float, per_item_s: float):
        self.overhead_s = overhead_s
        self.per_item_s = per_item_s

    def run(self, batch: np.ndarray) -> list[dict]:
        time.sleep(self.overhead_s + len(batch) * self.per_item_s)
        return [
            {"sum": int(row.astype(np.int64).sum()), "dim": int(row.size)}
            for row in batch
        ]


def image_decoder(size: int, crop_ratio: float):
    """``decode(sample)``: the sample's image member (``data/decode.py``'s
    extensions) decoded and put through the eval transform at ``size``;
    raises naming the sample when it has none or it does not decode."""
    from jumbo_mae_tpu_tpu_torch.data.decode import decode_image, find_image_key
    from jumbo_mae_tpu_tpu_torch.data.transforms import eval_transform

    def decode(sample: dict) -> np.ndarray:
        ext = find_image_key(sample)
        img = None if ext is None else decode_image(sample[ext])
        if img is None:
            raise ValueError(f"sample {sample.get('__key__')!r} has no decodable image member")
        return eval_transform(img, size, crop_ratio=crop_ratio)

    return decode


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    from jumbo_mae_tpu_tpu_torch.infer.replicaset import ReplicaSet
    from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal
    from jumbo_mae_tpu_tpu_torch.obs.metrics import MetricsRegistry
    from jumbo_mae_tpu_tpu_torch.obs.reqtrace import AccessLog, RequestTracer
    from jumbo_mae_tpu_tpu_torch.serve import (
        AdmissionController,
        ContinuousScheduler,
        CostMeter,
        default_cost_fn,
        parse_tenants,
    )

    tenants = parse_tenants(args.tenants)
    if args.config:  # no card: raise before the job touches its directory
        from jumbo_mae_tpu_tpu_torch.utils.device import resolve_device

        resolve_device(args.device)
    access_dir = f"{args.out}/access"
    tracer = RequestTracer(access_log=AccessLog(access_dir))

    decode = None
    engines: list = []
    if args.config:
        from jumbo_mae_tpu_tpu_torch.config import load_config
        from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine

        cfg = load_config(args.config)

        def provider(idx):
            eng = InferenceEngine(cfg, ckpt=args.ckpt, max_batch=args.max_batch, device=args.device)
            engines.append(eng)
            return eng

        def run(engine, batch, metas):
            return engine.predict(batch, task=args.task)

        cost_fn = default_cost_fn
    else:
        overhead = args.service_overhead_ms / 1000.0
        per_item = args.service_per_item_ms / 1000.0

        def provider(idx):
            return _StubEngine(overhead, per_item)

        def run(engine, batch, metas):
            return engine.run(batch)

        flops_per_row = args.model_gflops_per_item * 1e9

        def cost_fn(engine, task, bucket):
            return {"flops": bucket * flops_per_row}

    # continuous mode headroom: the scheduler's accumulator is the
    # admission-visible queue; the pool takes dispatched groups above it
    meter = CostMeter(tenants, cost_fn=cost_fn, tracer=tracer)
    rs = ReplicaSet(
        provider,
        run,
        replicas=args.replicas,
        max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms,
        max_queue=args.max_queue + 2 * args.max_batch,
        tracer=tracer,
        task=args.task,
        breakdown=(lambda eng: eng.last_breakdown()) if args.config else None,
        costmeter=meter,
    )
    if engines:
        eng = engines[0]
        decode = image_decoder(eng.image_size, cfg.data.test_crop_ratio)
    admission = AdmissionController(tenants, meter=meter)
    sched = ContinuousScheduler(
        rs.submit_group,
        max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms,
        max_queue=args.max_queue,
        admission=admission,
        tracer=tracer,
        task=args.task,
    )
    admission.set_pressure_fn(lambda: max(sched.pressure(), rs.pressure()))

    spec = JobSpec(
        shards=tuple(args.shards),
        output_dir=args.out,
        task=args.task,
        tenant=args.tenant,
        workers=args.workers,
        submit_window=args.submit_window,
        lease_s=args.lease_s,
        deadline_ms=args.deadline_ms,
    )
    registry = MetricsRegistry()
    runner = BatchJobRunner(spec, sched.submit, decode=decode, registry=registry)

    def _drain(signum, frame):
        # first signal: graceful, resumable drain; a repeat falls through
        # to the default handler (hard kill — still resumable, just rude)
        print(f"[batch] signal {signum}: draining (resumable)", file=sys.stderr)
        runner.request_stop()
        signal.signal(signum, signal.SIG_DFL)

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)

    t0 = time.perf_counter()
    try:
        summary = runner.run()
    finally:
        sched.close()
        pool = rs.stats()
        rs.close()
        meter.flush()  # the last tenant_usage rows before the log closes
        tracer.close()
    summary["seconds"] = time.perf_counter() - t0
    snap = registry.snapshot()
    summary["samples_processed"] = int(snap["batch_samples_processed_total"][""])
    summary["samples_resumed"] = int(snap["batch_samples_resumed_total"][""])
    # what the meter billed and what the pool survived, from the access log
    usage: dict[str, dict] = {}
    preemptions = 0
    for e in read_journal(access_dir):
        if e.get("type") == "tenant_usage" and e.get("tenant"):
            usage[str(e["tenant"])] = {k: e.get(k) for k in ("device_s", "requests", "flops", "waste_device_s",
                                                             "budget_device_s", "over_budget") if k in e}
        elif e.get("type") == "replica_preempted":
            preemptions += 1
    summary["tenant_usage"] = usage
    summary["replica_preemptions"] = preemptions
    summary["scheduler"] = sched.stats()
    summary["pool"] = {k: pool[k] for k in ("batch_occupancy", "window_batch_occupancy", "batches_flushed",
                                            "requests_submitted", "requests_shed")}
    if engines:
        from jumbo_mae_tpu_tpu_torch.ops.flash import attention as flash

        summary["engines"] = {
            "built": len(engines),
            "dispatches": sum(e.dispatches for e in engines),
            "captures": sum(sum(e.compile_counts.values()) for e in engines),
            "k1_launches": flash.LAUNCHES,
        }
    print(json.dumps(summary, sort_keys=True))
    return 0 if summary["complete"] else 3


if __name__ == "__main__":
    sys.exit(main())
