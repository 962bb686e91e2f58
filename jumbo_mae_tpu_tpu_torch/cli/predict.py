"""Serving entry point: run a trained model over images from the command line.

Counterpart of ``jumbo_mae_tpu_tpu/cli/predict.py``, the thin front end
over ``jumbo_mae_tpu_tpu_torch.infer``: restore the recipe's save once,
then serve.

    # classification logits from a finetune (or linear-probe) save
    python -m jumbo_mae_tpu_tpu_torch.cli.predict --config recipes/finetune_vit_b16.yaml \\
        --ckpt runs/finetune_vit_b16/ckpt --task logits --images cat.png dog.png --topk 5

    # frozen-encoder features to a file, on the CPU, exact float32 path
    python -m jumbo_mae_tpu_tpu_torch.cli.predict --config recipes/linear_lars_vit_l16.yaml \\
        --ckpt runs/pretrain/ckpt --task features --pool cls --images *.png \\
        --dtype float32 --device cpu --out feats.npz

    # MAE reconstruction from a pretraining save, the encoder cached
    python -m jumbo_mae_tpu_tpu_torch.cli.predict --config recipes/pretrain_vit_l16_in1k_800ep.yaml \\
        --ckpt runs/pretrain/ckpt --task reconstruct --seed 3 --encoder-cache 128 \\
        --images cat.png --out recon.npz

    # two supervised replicas, token-packed mixed resolutions, hot swaps
    # of checkpoints moved into runs/push
    python -m jumbo_mae_tpu_tpu_torch.cli.predict --config recipes/finetune_vit_b16.yaml \\
        --ckpt runs/finetune_vit_b16/ckpt --task logits --images *.png --serve --replicas 2 \\
        --warmup --pack --pack-resolutions 224:0.5,160:0.3,96:0.2 --swap-watch runs/push

``--set`` overrides recipe fields as ``cli.train`` takes them. Image files
are decoded from their bytes (``data/decode.py``: cv2, then PIL) and put
through the eval transform (resize to ``size / data.test_crop_ratio``,
center crop), the geometry of validation; a file that does not decode
raises and names the file. ``--synthetic N`` serves N seeded images
instead. ``--serve`` submits the images one at a time through the
micro-batching queue (``--max-delay-ms``, ``--max-batch``, ``--max-queue``
and ``--deadline-ms`` are its knobs); with ``--replicas N`` through a
supervised pool of N engines (``infer/replicaset.py``: crash isolation,
restarts, the quorum breaker), ``--interarrival-ms`` pacing the submits.
``--pack`` (with ``--replicas``) coalesces requests by token budget in
the continuous scheduler and serves each group in one token-packed
dispatch; ``--pack-resolutions`` serves each request at a size drawn
from the mix (synthetic images, or each file through the eval transform
at its drawn size), and ``--pack-parity-n`` holds the first requests'
packed outputs against the unpacked forward before any traffic (a
failed gate aborts). ``--swap-watch DIR`` promotes each checkpoint that
appears in DIR through the parity and canary gates
(``WeightSwapController``); a publish artifact (``serve/publisher.py``,
what ``cli.train`` writes with ``run.publish_dir``) is verified before
any restore, and one that fails is moved to ``DIR/.quarantine/`` and
counted in ``serve_publish_quarantined_total``. ``--tenants`` (with
``--replicas``) puts weighted admission and the continuous scheduler in
front of the pool and meters every batch per tenant
(``serve/costmeter.py``; requests round-robin over the tenants, a
``budget=`` is enforced); ``--autoscale MIN:MAX`` sizes the pool from
demand against the roofline capacity of the card
(``serve/autoscaler.py``, ticks of ``--autoscale-interval-s``);
``--access-log DIR`` (with ``--serve``) writes one row per request and the
pool's, the meter's and the autoscaler's events (``obs/reqtrace.py``);
``--burst N`` sends the first N requests back to back and paces the
rest by ``--interarrival-ms`` (a flash crowd, then a trickle). Otherwise
the whole list is batched directly. Results land in ``--out`` (``.npz``) and, for ``logits``, as
one JSON line per image on stdout. Everything runs on ``"cuda"`` unless
``--device cpu``.

Telemetry and health, as the JAX CLI wires them: ``--metrics-port PORT``
(0: any free port, printed) serves Prometheus ``/metrics`` and
``/healthz`` (``obs/exporter.py``), ready once the engine or the pool is
up; with ``run.memwatch`` every scrape samples the card's and the host's
memory, the engines' caches and the predicted-vs-measured peak of every
captured graph (``obs/memwatch.py``), and the swap watcher refuses a push
whose double buffer does not fit, on the host or on the card.
``--slo SPEC`` (or ``run.slo``), ``--slo-window-s`` and
``--slo-fast-window-s`` track the served requests' objectives
(``obs/slo.py``): the ``slo_*`` gauges, the verdict line at the end and,
with the pool's breaker, ``degraded`` in ``/healthz``. With ``--serve
--warmup`` and ``run.retrace`` the capture sentinel (``obs/retrace.py``)
arms after the first served batch and counts every capture after it
(a swap, a restart or a scale-up build is expected).
``--metrics-hold-s N`` keeps the exporter up N seconds after the
requests, for a scraper to read the final counts.

The engines keep their built task weights in the warm cache
(``infer/warmcache.py``): the default directory unless
``JUMBO_WARMCACHE=0``, ``--warmcache DIR`` for another (whatever the
environment says), ``--no-warmcache`` for none; a restarted process, or a
restarted replica, loads them instead of building them again.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from pathlib import Path

import numpy as np

from jumbo_mae_tpu_tpu_torch.config import load_config
from jumbo_mae_tpu_tpu_torch.data.decode import decode_image
from jumbo_mae_tpu_tpu_torch.data.transforms import eval_transform
from jumbo_mae_tpu_tpu_torch.infer.batching import MicroBatcher
from jumbo_mae_tpu_tpu_torch.infer.engine import POOLS, InferenceEngine



def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=None, help="YAML recipe path")
    p.add_argument("--ckpt", default="", help="a port checkpoint directory or step directory; random init if omitted")
    p.add_argument("--task", choices=("features", "logits", "reconstruct"), default="logits")
    p.add_argument("--images", nargs="+", default=[], metavar="FILE", help="image files")
    p.add_argument("--synthetic", type=int, default=0, metavar="N", help="serve N seeded synthetic images instead")
    p.add_argument("--out", default="", help="output .npz path")
    p.add_argument("--pool", choices=POOLS, default="cls")
    p.add_argument("--topk", type=int, default=5, help="logits: classes per line")
    p.add_argument("--seed", type=int, default=0, help="reconstruct: mask seed")
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--serve", action="store_true", help="submit images one by one through the micro-batching queue")
    p.add_argument("--max-delay-ms", type=float, default=5.0, help="--serve coalescing deadline")
    p.add_argument("--max-queue", type=int, default=None, metavar="N",
                   help="--serve: submits beyond N pending requests shed with QueueFullError")
    p.add_argument("--deadline-ms", type=float, default=None, metavar="MS",
                   help="--serve: a request still queued after MS fails with DeadlineExceededError")
    p.add_argument("--replicas", type=int, default=0, metavar="N",
                   help="--serve: N supervised engine replicas behind the queue (crash-isolated retries, restarts "
                        "with capped backoff, the quorum breaker); 0 = the single-engine micro-batcher")
    p.add_argument("--interarrival-ms", type=float, default=0.0, metavar="MS",
                   help="--replicas: pace submits MS apart instead of all at once")
    p.add_argument("--pack", action="store_true",
                   help="--replicas: token-packed dispatch — the continuous scheduler coalesces requests by token "
                        "budget across resolutions and each group runs through engine.predict_packed; "
                        "features/logits, --pool cls|gap")
    p.add_argument("--pack-budget", type=int, default=0, metavar="TOKENS",
                   help="--pack: the scheduler's token fill target per group (0 = the engine's max_tokens); the "
                        "packer keeps rungs up to max(TOKENS, 4096)")
    p.add_argument("--pack-resolutions", default="", metavar="SPEC",
                   help="--pack: serve each request at a size drawn (seeded) from 'size:weight,...', e.g. "
                        "'224:0.5,160:0.3,96:0.2' (patch-aligned; non-native sizes need posemb=sincos2d); "
                        "default: the native size")
    p.add_argument("--pack-parity-n", type=int, default=8, metavar="N",
                   help="--pack: hold the first N requests' packed outputs against the unpacked forward before "
                        "serving (0 = skip); a failed gate aborts the run")
    p.add_argument("--burst", type=int, default=0, metavar="N",
                   help="--replicas: the first N requests go out back to back, the rest --interarrival-ms apart")
    p.add_argument("--tenants", default="", metavar="SPEC",
                   help="--replicas: weighted multi-tenant admission, continuous batching and per-tenant cost "
                        "metering; name=class[:rate=N][:burst=N][:budget=D][:window=W],... (budget: device-seconds "
                        "per window; classes interactive|batch|scavenger); requests round-robin over the tenants")
    p.add_argument("--autoscale", default="", metavar="MIN:MAX",
                   help="--replicas: reconcile the replica count between MIN and MAX from demand against the card's "
                        "roofline capacity; scale-down drains the replica first")
    p.add_argument("--autoscale-interval-s", type=float, default=1.0, help="--autoscale reconcile tick seconds")
    p.add_argument("--access-log", default="", metavar="DIR",
                   help="--serve: a crash-safe JSONL access log (one row per finished request, the pool's events, "
                        "tenant_usage rows) in DIR; read it with tools.serve_doctor and tools.cost_doctor")
    p.add_argument("--slo", default=None, metavar="SPEC",
                   help="--serve SLO objectives, e.g. 'p99_latency_ms<=250;success_rate>=0.99' (default: run.slo "
                        "from the recipe); breaches latch the degraded flag in /healthz and the slo_* gauges")
    p.add_argument("--slo-window-s", type=float, default=None,
                   help="SLO rolling window seconds (default: run.slo_window_s)")
    p.add_argument("--slo-fast-window-s", type=float, default=None,
                   help="SLO fast confirmation window seconds (default: run.slo_fast_window_s; 0 = window/12)")
    p.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                   help="serve Prometheus /metrics + /healthz on this port (0 = any free port, printed at startup; "
                        "omit to disable)")
    p.add_argument("--metrics-hold-s", type=float, default=0.0,
                   help="keep the exporter up N seconds after the requests finish (lets an external scraper read "
                        "the final counters)")
    p.add_argument("--swap-watch", default="", metavar="DIR",
                   help="--replicas: poll DIR for new checkpoints and run each through the parity- and "
                        "canary-gated hot swap (promote on pass, roll back on failure)")
    p.add_argument("--swap-poll-s", type=float, default=0.5, help="--swap-watch poll interval")
    p.add_argument("--swap-parity-min", type=float, default=0.98,
                   help="hot-swap parity gate: least feature cosine of the candidate against the live weights")
    p.add_argument("--swap-canary-requests", type=int, default=8,
                   help="hot-swap canary window: live requests the flipped replica serves before promotion")
    p.add_argument("--swap-canary-timeout-s", type=float, default=10.0, help="hot-swap canary window bound")
    p.add_argument("--warmup", action="store_true",
                   help="before the first request, capture every (task, bucket) graph (on the CPU: run it once)")
    p.add_argument("--dtype", default=None, help="compute dtype override (float32 for the exact path)")
    p.add_argument("--quant", choices=("int8",), default=None, help="int8 weight-only quantization, dequantized on use")
    p.add_argument("--encoder-cache", type=int, default=0, metavar="N",
                   help="reconstruct: LRU of up to N encoder outputs keyed by (image bytes, seed)")
    p.add_argument("--encoder-cache-mb", type=float, default=0.0, metavar="MB",
                   help="byte bound on the encoder-output LRU beside --encoder-cache (0 = entries only)")
    p.add_argument("--set", dest="overrides", metavar="KEY.PATH=VALUE", nargs="*", action="extend", default=[],
                   help="dotted recipe overrides, the grammar of cli.train")
    p.add_argument("--warmcache", default=None, metavar="DIR",
                   help="warm-cache directory for the built task weights (default: a device-keyed directory under "
                        "~/.cache/jumbo_mae_tpu/warmcache unless JUMBO_WARMCACHE=0); restarted replicas load them")
    p.add_argument("--no-warmcache", action="store_true", help="build every task's weights, cache nothing")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def load_image(path: str | Path, size: int, crop_ratio: float) -> np.ndarray:
    """One image file → (size, size, 3) uint8, as validation sees it;
    raises ``ValueError`` naming a file that does not decode."""
    img = decode_image(Path(path).read_bytes())
    if img is None:
        raise ValueError(f"cannot decode image file {path}")
    return eval_transform(img, size, crop_ratio=crop_ratio)


def parse_mix(spec: str) -> list[tuple[int, float]]:
    """``"224:0.5,160:0.3"`` → ``[(224, 0.5), (160, 0.3)]`` (a weight defaults to 1)."""
    mix = []
    for part in spec.split(","):
        size, _, w = part.partition(":")
        mix.append((int(size), float(w or 1.0)))
    return mix


def draw_sizes(mix: list[tuple[int, float]], n: int, rng: np.random.RandomState) -> list[int]:
    """``n`` sizes drawn from the weighted mix."""
    w = np.array([max(wt, 0.0) for _, wt in mix], np.float64)
    picks = rng.choice(len(mix), size=n, p=w / w.sum())
    return [mix[c][0] for c in picks]


def load_images(args, cfg, size: int, pack_mix) -> tuple[list | np.ndarray, list[str]]:
    """The request images and their names: ``--synthetic`` draws seeded
    pixels, ``--images`` decodes files; with a ``--pack-resolutions`` mix
    each request takes a drawn size."""
    rng = np.random.RandomState(0)
    n = args.synthetic or len(args.images)
    sizes = draw_sizes(pack_mix, n, rng) if pack_mix else [size] * n
    if args.synthetic:
        images = [rng.randint(0, 256, (s, s, 3)).astype(np.uint8) for s in sizes]
        names = [f"synthetic[{i}]" for i in range(n)]
    else:
        images = [load_image(f, s, cfg.data.test_crop_ratio) for f, s in zip(args.images, sizes)]
        names = list(args.images)
    if pack_mix:
        return images, [f"{name}@{s}" for name, s in zip(names, sizes)]
    return np.stack(images), names


def check_replicated(args) -> list[tuple[int, float]] | None:
    """The replicated flags' preconditions; returns the pack mix."""
    replicated = bool(args.serve and args.replicas > 0)
    if (args.pack or args.swap_watch or args.tenants or args.autoscale or args.burst) and not replicated:
        raise SystemExit("--pack, --swap-watch, --tenants, --autoscale and --burst require --serve --replicas N")
    if args.access_log and not args.serve:
        raise SystemExit("--access-log traces the served requests: it requires --serve")
    if args.pack_resolutions and not args.pack:
        raise SystemExit("--pack-resolutions requires --pack")
    if args.pack:
        if args.task not in ("features", "logits"):
            raise SystemExit("--pack serves the encoder-sharing tasks: features|logits")
        if args.pool == "tokens":
            raise SystemExit("--pack pools per segment: --pool cls or gap")
    return parse_mix(args.pack_resolutions) if args.pack_resolutions else None


def _autoscale_bounds(spec: str) -> tuple[int, int]:
    try:
        lo, hi = (int(x) for x in spec.split(":"))
    except ValueError:
        raise SystemExit("--autoscale expects MIN:MAX, e.g. 2:6") from None
    return lo, hi


def _swap_restore(path):
    """The swap watcher's restore: a publish artifact resolves its delta
    chain (every link verified), anything else is a port save."""
    from jumbo_mae_tpu_tpu_torch.serve.publisher import is_publish_artifact, restore_artifact
    from jumbo_mae_tpu_tpu_torch.train.checkpoint import restore_inference_state

    return restore_artifact(path) if is_publish_artifact(path) else restore_inference_state(path)


class Telemetry:
    """What ``--metrics-port``, ``run.memwatch``, ``--slo``/``run.slo``,
    ``--access-log`` and ``run.retrace`` switch on, each ``None`` when
    off: the exporter and its ``HealthState`` (not ready until the engine
    or the pool is up), the memory watcher and its accountant, the SLO
    tracker, the access log and the request tracer, the capture
    sentinel."""

    def __init__(self, args, cfg):
        self.server = self.health = self.memwatch = self.accountant = None
        self.slo = self.access = self.tracer = self.sentinel = None
        if args.metrics_port is not None:
            from jumbo_mae_tpu_tpu_torch.obs.exporter import HealthState, TelemetryServer

            self.health = HealthState()
            if cfg.run.memwatch:
                from jumbo_mae_tpu_tpu_torch.obs.memwatch import MemAccountant, MemoryWatcher
                from jumbo_mae_tpu_tpu_torch.obs.perfmodel import detect_chip

                self.accountant = MemAccountant()
                self.memwatch = MemoryWatcher(accountant=self.accountant, chip=detect_chip(args.device),
                                              device=args.device)
                self.health.probe("memory", self.memwatch.last_sample)
            self.server = TelemetryServer(health=self.health, port=args.metrics_port).start()
            print(f"[predict] exporter on :{self.server.port} (/metrics, /healthz)")
        if args.serve and args.warmup and cfg.run.retrace:
            from jumbo_mae_tpu_tpu_torch.obs.retrace import RetraceSentinel

            self.sentinel = RetraceSentinel("predict")

    def start_tracing(self, args, cfg, breakdown=None) -> None:
        """``--serve``'s request observability: the SLO tracker, the access
        log and a tracer feeding both (a tracer also whenever the exporter
        runs, for the ``request_*`` families)."""
        from jumbo_mae_tpu_tpu_torch.obs.reqtrace import AccessLog, RequestTracer
        from jumbo_mae_tpu_tpu_torch.obs.slo import SLOTracker, parse_slo

        spec = args.slo if args.slo is not None else cfg.run.slo
        if spec:
            self.slo = SLOTracker(
                parse_slo(spec),
                window_s=args.slo_window_s if args.slo_window_s is not None else cfg.run.slo_window_s,
                fast_window_s=(args.slo_fast_window_s if args.slo_fast_window_s is not None
                               else cfg.run.slo_fast_window_s),
                burn_threshold=cfg.run.slo_burn_threshold,
            )
            print(f"[predict] SLO: {spec} over {self.slo.window_s:g}s/{self.slo.fast_window_s:g}s windows")
        self.access = AccessLog(args.access_log) if args.access_log else None
        if self.access is not None:
            print(f"[predict] access log -> {self.access.path}")
        if self.access is not None or self.slo is not None or self.server is not None:
            self.tracer = RequestTracer(access_log=self.access, breakdown=breakdown,
                                        on_finish=self.slo.observe_trace if self.slo is not None else None)
        if self.slo is not None:
            if self.health is not None:
                self.health.probe("slo", self.slo.healthz_info)
            if self.server is not None:
                self.server.add_pre_scrape(self.slo.evaluate)

    def watch_memory(self, engines, components: dict) -> None:
        """Account ``components`` (name → byte probe) and, before every
        scrape, record each engine's predicted graph peaks (captures happen
        lazily too) and take a memory sample. ``engines()`` gives the live
        engines at scrape time, so a restarted replica stays accounted."""
        if self.memwatch is None:
            return
        for name, probe in components.items():
            self.accountant.register(name, probe)

        def sync_peaks():
            for eng in engines():
                try:
                    peaks = eng.predicted_peak_hbm()
                except Exception:  # noqa: BLE001 - a replica mid-restart
                    continue
                for prog, peak in peaks.items():
                    self.memwatch.record_predicted_peak(prog, peak)

        self.server.add_pre_scrape(sync_peaks)
        self.server.add_pre_scrape(self.memwatch.sample)

    def ready(self, detail: str, degraded=None) -> None:
        if self.health is None:
            return
        self.health.set_ready(True, detail=detail)
        if degraded is not None:
            self.health.degraded_when(degraded)
        elif self.slo is not None:
            self.health.degraded_when(self.slo.degraded)

    def note_batch(self, tag: str, batch) -> None:
        """Before a served batch: its signature. After the first one the
        serving loop is steady (call :meth:`served` after it)."""
        if self.sentinel is not None:
            self.sentinel.note(tag, batch)

    def served(self) -> None:
        if self.sentinel is not None:
            self.sentinel.arm()

    def expected(self, reason: str):
        """The sentinel's ``expected()`` block, or a no-op one."""
        import contextlib

        return self.sentinel.expected(reason) if self.sentinel is not None else contextlib.nullcontext()

    def slo_verdict(self) -> None:
        if self.slo is None:
            return
        rep = self.slo.evaluate()
        objs = "; ".join(f"{o['name']}: value={o['value']:g} burn={o['burn_slow']:g} breached={o['breached']}"
                         for o in rep["objectives"])
        print(f"[predict] SLO verdict: degraded={rep['degraded']} shed_rate={rep['shed_rate']:g} — {objs}")
        if self.tracer is not None:
            self.tracer.event("slo_summary", report=rep)

    def close_tracing(self) -> None:
        """Close the tracer and its access log (once)."""
        tracer, self.tracer = self.tracer, None
        if tracer is not None:
            tracer.close()

    def close(self, hold_s: float = 0.0) -> None:
        """The tracer if still open, the sentinel's summary line, then the
        exporter: held ``hold_s`` seconds first, for a scraper's last
        read."""
        self.close_tracing()
        if self.sentinel is not None:
            rsum = self.sentinel.summary()
            print(f"[predict] retrace sentinel: {rsum['violations']} unexpected recompile(s) after warmup "
                  f"({rsum['compiles']} compiles seen, {rsum['expected']} expected)")
            self.sentinel.close()
        if self.server is not None:
            if hold_s > 0:
                print(f"[predict] holding exporter for {hold_s:g}s (scrape :{self.server.port}/metrics)", flush=True)
                time.sleep(hold_s)
            self.server.close()


def _start_swap_watch(args, rs, ckpt_ref: dict, stop: threading.Event, tel: Telemetry) -> threading.Thread:
    """The ``--swap-watch`` thread: each new entry of the directory through
    the gated swap (the memory gate too, with the memory watcher); a
    publish artifact that fails verification is quarantined before any
    restore."""
    import os

    from jumbo_mae_tpu_tpu_torch.infer.replicaset import WeightSwapController
    from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry
    from jumbo_mae_tpu_tpu_torch.serve.publisher import PublishIntegrityError, is_publish_artifact, verify_artifact

    ctl = WeightSwapController(
        rs, restore_fn=_swap_restore, parity_min_cosine=args.swap_parity_min,
        canary_requests=args.swap_canary_requests, canary_timeout_s=args.swap_canary_timeout_s,
        on_promote=lambda c: ckpt_ref.__setitem__("ckpt", c),
        # refuse a push whose double buffer does not fit: rejected at the
        # "headroom" stage before any replica flips
        headroom_fn=tel.memwatch.headroom_check if tel.memwatch is not None else None,
    )
    watch_root = Path(args.swap_watch)
    watch_root.mkdir(parents=True, exist_ok=True)
    quarantined = get_registry().counter("serve_publish_quarantined_total",
                                         "publish artifacts the swap watcher quarantined before restore")
    # what is there at start is the baseline, not a push; push by an
    # atomic rename so a partial write is never picked up
    seen = {p.name for p in watch_root.iterdir()}

    def quarantine(p: Path) -> None:
        # a torn or poisoned artifact is evidence: moved aside (atomic, one
        # filesystem) for the doctor, never retried
        try:
            (watch_root / ".quarantine").mkdir(exist_ok=True)
            os.replace(p, watch_root / ".quarantine" / p.name)
        except OSError:
            pass  # left in place; ``seen`` skips it
        quarantined.inc()

    def watch():
        while True:
            stopping = stop.is_set()
            for p in sorted(watch_root.iterdir()):
                if p.name in seen or p.name.startswith("."):
                    continue
                seen.add(p.name)
                print(f"[predict] swap-watch: new checkpoint {p}")
                if is_publish_artifact(p):
                    try:
                        verify_artifact(p)
                    except PublishIntegrityError as e:
                        print(f"[predict] swap {p.name}: verdict=quarantined stage=verify ({e})")
                        quarantine(p)
                        continue
                with tel.expected("swap"):
                    rep = ctl.swap(str(p))
                msg = f"[predict] swap {p.name}: verdict={rep['verdict']} stage={rep['stage']}"
                if rep.get("parity"):
                    msg += f" cosine_min={rep['parity']['cosine_min']:.4f}"
                if rep["verdict"] == "rejected":
                    msg += f" ({rep['error']})"
                print(msg, flush=True)
            if stopping:
                return  # one last sweep after the stop
            stop.wait(args.swap_poll_s)

    thread = threading.Thread(target=watch, daemon=True, name="swap-watch")
    thread.start()
    print(f"[predict] swap-watch: polling {watch_root} every {args.swap_poll_s:g}s", flush=True)
    return thread


def serve_replicated(args, cfg, make_engine, load, kw: dict, pack_mix, ckpt_ref: dict,
                     tel: Telemetry) -> tuple[list[str], list]:
    """``--serve --replicas N``: the pool; with ``--pack`` or ``--tenants``
    the continuous scheduler in front of it (with ``--tenants`` admission
    and the cost meter), the autoscaler, the swap watcher, the telemetry,
    the requests (``load(native_size)`` gives them and their names);
    returns the names and one row per request (``None`` where it failed)."""
    from jumbo_mae_tpu_tpu_torch.infer.replicaset import ReplicaSet
    from jumbo_mae_tpu_tpu_torch.obs.perfmodel import detect_chip
    from jumbo_mae_tpu_tpu_torch.obs.reqtrace import RequestTracer
    from jumbo_mae_tpu_tpu_torch.serve import (
        AdmissionController,
        Autoscaler,
        ContinuousScheduler,
        CostMeter,
        parse_tenants,
        roofline_capacity,
    )

    tenant_specs = parse_tenants(args.tenants) if args.tenants else []
    bounds = _autoscale_bounds(args.autoscale) if args.autoscale else None
    chip = detect_chip(args.device) if (tenant_specs or bounds) else None

    def engine_provider(idx):
        # a (re)built replica captures its own graphs: legitimate, also
        # while the sentinel is armed
        with tel.expected("replica build"):
            eng = make_engine()
            if args.warmup:
                if args.pack:
                    n = eng.warmup_packed([s for s, _ in pack_mix] if pack_mix else [eng.image_size], (args.task,),
                                          pool=args.pool)
                else:
                    n = eng.warmup((args.task,), pool=args.pool)
                print(f"[predict] replica {idx}: warmup {n} {_first_runs(eng)} in {eng.warmup_s:.2f} s")
        return eng

    def run_replica(eng, batch, metas):
        tel.note_batch("replica_batch", batch)
        if args.pack:  # the group's images, mixed resolutions: one packed dispatch
            out = eng.predict_packed(list(batch), args.task, pool=args.pool)
        else:
            out = eng.predict(batch, task=args.task, **kw)
        tel.served()  # the first batch served: steady state
        return out

    tel.start_tracing(args, cfg)
    # the meter bills traced requests: tenants get a tracer even without a log
    tracer = tel.tracer if tel.tracer is not None or not tenant_specs else RequestTracer()
    rs = ReplicaSet(engine_provider, run_replica, replicas=args.replicas, max_batch=args.max_batch,
                    max_delay_ms=args.max_delay_ms, max_queue=args.max_queue, tracer=tracer, task=args.task,
                    health=tel.health, breakdown=lambda eng: eng.last_breakdown())
    engine = rs.replica(0).engine
    print(f"[predict] replica pool: {args.replicas} replicas, quorum {rs.quorum}")
    if engine.warmcache is not None:
        print(f"[predict] warmcache: {engine.warmcache.root}")
    # per-replica accounting: the probes read the slot's engine at sample
    # time, so a restarted replica stays accounted
    comps = {}
    for i in range(args.replicas):
        comps[f"replica{i}_enc_cache"] = lambda i=i: rs.replica(i).engine.encoder_cache_bytes()
        comps[f"replica{i}_exec_cache"] = lambda i=i: rs.replica(i).engine.executable_cache_bytes()
    if engine.warmcache is not None:
        comps["warmcache_disk"] = lambda: rs.replica(0).engine.warmcache.disk_bytes()
    tel.watch_memory(lambda: [rs.replica(i).engine for i in range(rs.n)], comps)
    slo = tel.slo
    tel.ready(f"pool up ({args.replicas} replicas)",
              degraded=(lambda: slo.degraded() or rs.degraded()) if slo is not None else rs.degraded)
    if slo is not None:
        slo.add_probe("queue_depth", lambda: rs.stats()["queue_depth"])
        slo.add_probe("healthy_replicas", lambda: rs.stats()["healthy"])
        slo.add_probe("batch_occupancy", lambda: rs.stats()["batch_occupancy"])
    images, names = load(engine.image_size)
    admission = meter = None
    if tenant_specs:
        # every flushed batch metered: serve_tenant_* metrics, tenant_usage
        # rows, the access log's device_ms/cost_flops and the budgets
        meter = CostMeter(tenant_specs, tracer=tracer, chip=chip)
        rs.set_costmeter(meter)
        admission = AdmissionController(tenant_specs, meter=meter)
        print("[predict] traffic shaping: " + ", ".join(f"{t.name}={t.tclass}" for t in tenant_specs))
    sched = None
    if args.pack or tenant_specs:
        # the scheduler's accumulator is the queue admission sees; the pool
        # gets headroom above it so a dispatched group is never shed
        if rs.max_queue is not None:
            rs.max_queue += 2 * args.max_batch
        budget = args.pack_budget or engine.max_tokens
        sched = ContinuousScheduler(rs.submit_group, max_batch=args.max_batch, max_delay_ms=args.max_delay_ms,
                                    max_queue=args.max_queue, admission=admission, tracer=tracer, task=args.task,
                                    packed=args.pack, token_budget=budget if args.pack else None,
                                    seq_len_fn=(lambda arr: engine.seq_len(arr.shape[0])) if args.pack else None)
        if args.pack:
            print(f"[predict] token packing: budget={budget} tokens/dispatch, pool={args.pool}")
        if admission is not None:
            # the accumulator or the pool's backlog: either filling sheds
            # the low classes before an interactive request meets a full queue
            admission.set_pressure_fn(lambda: max(sched.pressure(), rs.pressure()))
    autoscaler = None
    if bounds is not None:
        from jumbo_mae_tpu_tpu_torch.obs.mfu import encoder_flops_per_image

        # the roofline of one serving forward: the encoder's FLOPs an image
        # and the activation-traffic model, on the card's row
        flops = encoder_flops_per_image(engine._enc, masked=False)
        act_bytes = 2.0 * flops / max(engine._enc.dim, 1)
        capacity = roofline_capacity(flops, act_bytes, chip)
        autoscaler = Autoscaler(rs, min_replicas=bounds[0], max_replicas=bounds[1],
                                interval_s=args.autoscale_interval_s, slo=slo, capacity_fn=lambda: capacity,
                                tracer=tracer)
        print(f"[predict] autoscaler: [{bounds[0]}, {bounds[1]}] replicas, tick {args.autoscale_interval_s:g}s, "
              f"roofline capacity {capacity:.1f} req/s a replica on {chip.name}")
    swap_stop = threading.Event()
    swap_thread = _start_swap_watch(args, rs, ckpt_ref, swap_stop, tel) if args.swap_watch else None
    try:
        if args.pack and args.pack_parity_n > 0:
            par = engine.packed_parity(list(images[: args.pack_parity_n]), args.task, pool=args.pool)
            cos, t1 = par["feature_cosine_min"], par["logits_top1_agree"]
            print(f"[predict] pack parity: pass={par['pass']} n={par['n']} "
                  f"cosine_min={'-' if cos is None else format(cos, '.6f')} "
                  f"top1_agree={'-' if t1 is None else format(t1, '.4f')}")
            if not par["pass"]:
                raise SystemExit("[predict] pack parity gate FAILED")
        futs = []
        t0 = time.perf_counter()
        for i, img in enumerate(images):
            try:
                if sched is not None:
                    tenant = tenant_specs[i % len(tenant_specs)].name if tenant_specs else None
                    futs.append(sched.submit(img, deadline_ms=args.deadline_ms, tenant=tenant))
                else:
                    futs.append(rs.submit(img, deadline_ms=args.deadline_ms))
            except Exception as e:  # noqa: BLE001 - sheds are tallied, not fatal
                futs.append(None)
                print(f"[predict] request shed: {type(e).__name__}: {e}")
            if args.interarrival_ms > 0 and i + 1 >= args.burst:
                time.sleep(args.interarrival_ms / 1000.0)
        rows = []
        for f in futs:
            try:
                rows.append(None if f is None else f.result())
            except Exception as e:  # noqa: BLE001 - typed failures are tallied, not fatal
                rows.append(None)
                print(f"[predict] request failed: {type(e).__name__}: {e}")
        failed = sum(r is None for r in rows)
        wall = time.perf_counter() - t0
        print(f"[predict] pool served {len(rows) - failed}/{len(rows)} ok ({failed} failed) in {wall:.3f} s, "
              f"{(len(rows) - failed) / max(wall, 1e-9):.1f} req/s", flush=True)
    finally:
        if swap_thread is not None:
            swap_stop.set()
            swap_thread.join(timeout=args.swap_canary_timeout_s + 60.0)
        if autoscaler is not None:
            autoscaler.close()
            print(f"[predict] autoscale events: {len(autoscaler.events)} "
                  + json.dumps([{k: e[k] for k in ("current", "target", "demand_rps", "capacity_rps", "reason")}
                                for e in autoscaler.events]))
        if sched is not None:
            sched.close()
            st = sched.stats()
            label = "pack stats" if args.pack else "scheduler"
            print(f"[predict] {label}: dispatched={st['dispatched']} batches={st['batches']} "
                  f"expired={st['expired']}")
            if admission is not None:
                print(f"[predict] admission: {json.dumps(admission.stats())}")
        if meter is not None:
            meter.flush()  # the last tenant_usage rows before the log closes
            bill = meter.snapshot()
            costs = ", ".join(f"{t}={b['device_s']:.3f}s" for t, b in bill["tenants"].items())
            print(f"[predict] tenant cost: {costs} (total {bill['total_device_s']:.3f} device-s, "
                  f"{bill['total_batches']} batches)")
        print(f"[predict] replicas: {json.dumps(rs.stats()['replicas'])}")
        rs.close()
        tel.slo_verdict()
        if tracer is not tel.tracer:
            tracer.close()
        tel.close_tracing()
    return names, rows


def serve_one_engine(args, engine, images, kw: dict, tel: Telemetry):
    """``--serve`` without replicas: one request at a time through the
    micro-batcher, traced, with its probes; returns the stacked rows."""

    def run_fn(batch):
        if tel.health is not None:
            tel.health.beat("infer_batch")
        tel.note_batch("serve_batch", batch)
        out = engine.predict(batch, task=args.task, **kw)
        tel.served()  # the first batch served: steady state
        return out

    try:
        with MicroBatcher(run_fn, max_batch=args.max_batch, max_delay_ms=args.max_delay_ms,
                          max_queue=args.max_queue, tracer=tel.tracer, task=args.task) as mb:
            if tel.health is not None:
                # the batcher's live snapshot in the /healthz info payload
                tel.health.probe("serving", mb.stats)
            if tel.accountant is not None:
                tel.accountant.register("batcher_queue", lambda: mb.stats()["queue_bytes"])
            if tel.slo is not None:
                tel.slo.add_probe("queue_depth", lambda: mb.stats()["queue_depth"])
                tel.slo.add_probe("batch_occupancy", lambda: mb.stats()["batch_occupancy"])
            rows = [f.result() for f in [mb.submit(img, deadline_ms=args.deadline_ms) for img in images]]
        print(f"[predict] micro-batch sizes: {mb.batch_sizes}")
        tel.slo_verdict()
    finally:
        tel.close_tracing()
    return stack_rows(rows)


def stack_rows(rows: list):
    """Per-request rows (arrays, or dicts of arrays) stacked into one."""
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]} if isinstance(rows[0], dict) else np.stack(rows)


def _first_runs(engine) -> str:
    return "capture(s)" if engine.device.type == "cuda" else "first run(s)"


def main(argv: list[str] | None = None) -> Path | None:
    args = build_parser().parse_args(argv)
    if bool(args.images) == bool(args.synthetic):
        raise SystemExit("pass exactly one of --images or --synthetic N")
    pack_mix = check_replicated(args)
    cfg = load_config(args.config, args.overrides)
    if not args.ckpt:
        print("[predict] WARNING: no --ckpt — serving a random init")
    # restarts and promoted swaps read the checkpoint through this cell
    ckpt_ref = {"ckpt": args.ckpt}
    tel = Telemetry(args, cfg)
    try:
        out, names = _serve(args, cfg, ckpt_ref, pack_mix, tel)
    finally:
        tel.close(args.metrics_hold_s)
    if args.task == "logits":
        probs = np.exp(out - out.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        k = min(args.topk, out.shape[-1])
        for name, p_row in zip(names, probs):
            top = np.argsort(-p_row)[:k]
            print(json.dumps({"image": name, "classes": top.tolist(), "probs": [round(float(p_row[i]), 6) for i in top]}))
    payload = out if isinstance(out, dict) else {args.task: out}
    result: Path | None = None
    if args.out:
        result = Path(args.out)
        result.parent.mkdir(parents=True, exist_ok=True)
        np.savez(result, **payload)
        print(f"[predict] wrote {args.task} for {len(names)} image(s) -> {result}")
    return result


def _serve(args, cfg, ckpt_ref: dict, pack_mix, tel: Telemetry):
    """Build the engine or the pool, serve the images; returns the outputs
    and the names of the requests they answer."""

    def make_engine():
        return InferenceEngine(
            cfg, ckpt=ckpt_ref["ckpt"], dtype=args.dtype, max_batch=args.max_batch, quant=args.quant,
            # the packer's rung ceiling stays above the scheduler's fill target
            **({"max_tokens": max(args.pack_budget, 4096)} if args.pack_budget else {}),
            encoder_cache=args.encoder_cache, encoder_cache_bytes=int(args.encoder_cache_mb * 1024 * 1024),
            warm_cache=False if args.no_warmcache else args.warmcache if args.warmcache is not None else True,
            on_compile=tel.sentinel.on_compile if tel.sentinel is not None else None,
            device=args.device,
        )

    kw = {"pool": args.pool} if args.task == "features" else {"seed": args.seed} if args.task == "reconstruct" else {}
    if args.serve and args.replicas > 0:
        names, rows = serve_replicated(args, cfg, make_engine, lambda size: load_images(args, cfg, size, pack_mix),
                                       kw, pack_mix, ckpt_ref, tel)
        kept = [(n, r) for n, r in zip(names, rows) if r is not None]
        if not kept:
            raise SystemExit("[predict] every request failed")
        return stack_rows([r for _, r in kept]), [n for n, _ in kept]
    engine = make_engine()
    if engine.warmcache is not None:
        print(f"[predict] warmcache: {engine.warmcache.root}")
    if args.ckpt:
        print(f"[predict] restored {args.ckpt}: {engine.restore_bytes} bytes in {engine.restore_s:.2f} s")
    if args.warmup:
        n = engine.warmup((args.task,), pool=args.pool)
        hits = sum(engine.warm_hits.values())
        print(f"[predict] warmup: {n} {_first_runs(engine)} in {engine.warmup_s:.2f} s, {hits} task(s) loaded "
              "from warmcache")
    comps = {"engine_enc_cache": engine.encoder_cache_bytes, "engine_exec_cache": engine.executable_cache_bytes}
    if engine.warmcache is not None:
        comps["warmcache_disk"] = engine.warmcache.disk_bytes
    tel.watch_memory(lambda: [engine], comps)
    if args.serve:
        tel.start_tracing(args, cfg, breakdown=engine.last_breakdown)
    tel.ready(f"engine up (ckpt={'yes' if args.ckpt else 'random'})")
    images, names = load_images(args, cfg, engine.image_size, None)
    if args.serve:
        return serve_one_engine(args, engine, images, kw, tel), names
    return engine.predict(images, task=args.task, **kw), names


if __name__ == "__main__":
    main()
