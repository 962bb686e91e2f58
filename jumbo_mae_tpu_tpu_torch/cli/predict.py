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
(``WeightSwapController``). Otherwise the whole list is batched
directly. Results land in ``--out`` (``.npz``) and, for ``logits``, as
one JSON line per image on stdout. Everything runs on ``"cuda"`` unless
``--device cpu``.

The engines keep their built task weights in the warm cache
(``infer/warmcache.py``): the default directory unless
``JUMBO_WARMCACHE=0``, ``--warmcache DIR`` for another (whatever the
environment says), ``--no-warmcache`` for none; a restarted process, or a
restarted replica, loads them instead of building them again.

The flags of the layers still to port parse and raise, naming their
ROADMAP item: traffic shaping and autoscaling (A5.4,
``serve/{costmeter,autoscaler}.py``), and the access log, SLOs and the
metrics exporter (A7).
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

NOT_PORTED = "{flag} is not ported yet: ROADMAP queue {item}"
# flag → (argparse dest, ROADMAP item); each parses and raises
UNPORTED = {
    "--tenants": ("tenants", "A5.4 (serve/costmeter.py, serve/autoscaler.py)"),
    "--autoscale": ("autoscale", "A5.4 (serve/costmeter.py, serve/autoscaler.py)"),
    "--autoscale-interval-s": ("autoscale_interval_s", "A5.4 (serve/costmeter.py, serve/autoscaler.py)"),
    "--access-log": ("access_log", "A7"),
    "--slo": ("slo", "A7"),
    "--slo-window-s": ("slo_window_s", "A7"),
    "--slo-fast-window-s": ("slo_fast_window_s", "A7"),
    "--metrics-port": ("metrics_port", "A7"),
    "--metrics-hold-s": ("metrics_hold_s", "A7"),
}


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
    for flag, (dest, item) in UNPORTED.items():
        p.add_argument(flag, dest=dest, default=None, help=f"not ported yet (ROADMAP {item})")
    return p


def refuse_unported(args: argparse.Namespace) -> None:
    for flag, (dest, item) in UNPORTED.items():
        if getattr(args, dest) is not None:
            raise NotImplementedError(NOT_PORTED.format(flag=flag, item=item))


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
    if (args.pack or args.swap_watch) and not replicated:
        raise SystemExit("--pack and --swap-watch require --serve --replicas N")
    if args.pack_resolutions and not args.pack:
        raise SystemExit("--pack-resolutions requires --pack")
    if args.pack:
        if args.task not in ("features", "logits"):
            raise SystemExit("--pack serves the encoder-sharing tasks: features|logits")
        if args.pool == "tokens":
            raise SystemExit("--pack pools per segment: --pool cls or gap")
    return parse_mix(args.pack_resolutions) if args.pack_resolutions else None


def serve_replicated(args, make_engine, load, kw: dict, pack_mix, ckpt_ref: dict) -> tuple[list[str], list]:
    """``--serve --replicas N``: the pool (and with ``--pack`` the continuous
    scheduler in front of it), the swap watcher, the requests
    (``load(native_size)`` gives them and their names); returns the names
    and one row per request (``None`` where it failed)."""
    from jumbo_mae_tpu_tpu_torch.infer.replicaset import ReplicaSet, WeightSwapController
    from jumbo_mae_tpu_tpu_torch.serve.scheduler import ContinuousScheduler
    from jumbo_mae_tpu_tpu_torch.train.checkpoint import restore_inference_state

    def engine_provider(idx):
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
        if args.pack:  # the group's images, mixed resolutions: one packed dispatch
            return eng.predict_packed(list(batch), args.task, pool=args.pool)
        return eng.predict(batch, task=args.task, **kw)

    rs = ReplicaSet(engine_provider, run_replica, replicas=args.replicas, max_batch=args.max_batch,
                    max_delay_ms=args.max_delay_ms, max_queue=args.max_queue)
    engine = rs.replica(0).engine
    print(f"[predict] replica pool: {args.replicas} replicas, quorum {rs.quorum}")
    if engine.warmcache is not None:
        print(f"[predict] warmcache: {engine.warmcache.root}")
    images, names = load(engine.image_size)
    sched = None
    if args.pack:
        # the scheduler's accumulator is the queue admission sees; the pool
        # gets headroom above it so a dispatched group is never shed
        if rs.max_queue is not None:
            rs.max_queue += 2 * args.max_batch
        budget = args.pack_budget or engine.max_tokens
        sched = ContinuousScheduler(rs.submit_group, max_batch=args.max_batch, max_delay_ms=args.max_delay_ms,
                                    max_queue=args.max_queue, task=args.task, packed=True, token_budget=budget,
                                    seq_len_fn=lambda arr: engine.seq_len(arr.shape[0]))
        print(f"[predict] token packing: budget={budget} tokens/dispatch, pool={args.pool}")
    swap_stop = threading.Event()
    swap_thread = None
    if args.swap_watch:
        ctl = WeightSwapController(
            rs, restore_fn=restore_inference_state, parity_min_cosine=args.swap_parity_min,
            canary_requests=args.swap_canary_requests, canary_timeout_s=args.swap_canary_timeout_s,
            on_promote=lambda c: ckpt_ref.__setitem__("ckpt", c),
        )
        watch_root = Path(args.swap_watch)
        watch_root.mkdir(parents=True, exist_ok=True)
        # what is there at start is the baseline, not a push; push by an
        # atomic rename so a partial write is never picked up
        seen = {p.name for p in watch_root.iterdir()}

        def watch():
            while True:
                stopping = swap_stop.is_set()
                for p in sorted(watch_root.iterdir()):
                    if p.name in seen or p.name.startswith("."):
                        continue
                    seen.add(p.name)
                    print(f"[predict] swap-watch: new checkpoint {p}")
                    rep = ctl.swap(str(p))
                    msg = f"[predict] swap {p.name}: verdict={rep['verdict']} stage={rep['stage']}"
                    if rep.get("parity"):
                        msg += f" cosine_min={rep['parity']['cosine_min']:.4f}"
                    print(msg)
                if stopping:
                    return  # one last sweep after the stop
                swap_stop.wait(args.swap_poll_s)

        swap_thread = threading.Thread(target=watch, daemon=True, name="swap-watch")
        swap_thread.start()
        print(f"[predict] swap-watch: polling {watch_root} every {args.swap_poll_s:g}s")
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
        submit = sched.submit if sched is not None else rs.submit
        for img in images:
            try:
                futs.append(submit(img, deadline_ms=args.deadline_ms))
            except Exception as e:  # noqa: BLE001 - sheds are tallied, not fatal
                futs.append(None)
                print(f"[predict] request shed: {type(e).__name__}: {e}")
            if args.interarrival_ms > 0:
                time.sleep(args.interarrival_ms / 1000.0)
        rows = []
        for f in futs:
            try:
                rows.append(None if f is None else f.result())
            except Exception as e:  # noqa: BLE001 - typed failures are tallied, not fatal
                rows.append(None)
                print(f"[predict] request failed: {type(e).__name__}: {e}")
        failed = sum(r is None for r in rows)
        print(f"[predict] pool served {len(rows) - failed}/{len(rows)} ok ({failed} failed)")
    finally:
        if swap_thread is not None:
            swap_stop.set()
            swap_thread.join(timeout=args.swap_canary_timeout_s + 60.0)
        if sched is not None:
            sched.close()
            st = sched.stats()
            print(f"[predict] pack stats: dispatched={st['dispatched']} batches={st['batches']} "
                  f"expired={st['expired']}")
        print(f"[predict] replicas: {json.dumps(rs.stats()['replicas'])}")
        rs.close()
    return names, rows


def stack_rows(rows: list):
    """Per-request rows (arrays, or dicts of arrays) stacked into one."""
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]} if isinstance(rows[0], dict) else np.stack(rows)


def _first_runs(engine) -> str:
    return "capture(s)" if engine.device.type == "cuda" else "first run(s)"


def main(argv: list[str] | None = None) -> Path | None:
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    if bool(args.images) == bool(args.synthetic):
        raise SystemExit("pass exactly one of --images or --synthetic N")
    pack_mix = check_replicated(args)
    cfg = load_config(args.config, args.overrides)
    if not args.ckpt:
        print("[predict] WARNING: no --ckpt — serving a random init")
    # restarts and promoted swaps read the checkpoint through this cell
    ckpt_ref = {"ckpt": args.ckpt}

    def make_engine():
        return InferenceEngine(
            cfg, ckpt=ckpt_ref["ckpt"], dtype=args.dtype, max_batch=args.max_batch, quant=args.quant,
            # the packer's rung ceiling stays above the scheduler's fill target
            **({"max_tokens": max(args.pack_budget, 4096)} if args.pack_budget else {}),
            encoder_cache=args.encoder_cache, encoder_cache_bytes=int(args.encoder_cache_mb * 1024 * 1024),
            warm_cache=False if args.no_warmcache else args.warmcache if args.warmcache is not None else True,
            device=args.device,
        )

    kw = {"pool": args.pool} if args.task == "features" else {"seed": args.seed} if args.task == "reconstruct" else {}
    if args.serve and args.replicas > 0:
        names, rows = serve_replicated(args, make_engine, lambda size: load_images(args, cfg, size, pack_mix), kw,
                                       pack_mix, ckpt_ref)
        kept = [(n, r) for n, r in zip(names, rows) if r is not None]
        if not kept:
            raise SystemExit("[predict] every request failed")
        names = [n for n, _ in kept]
        out = stack_rows([r for _, r in kept])
    else:
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
        images, names = load_images(args, cfg, engine.image_size, None)
        if args.serve:
            with MicroBatcher(
                lambda batch: engine.predict(batch, task=args.task, **kw),
                max_batch=args.max_batch, max_delay_ms=args.max_delay_ms, max_queue=args.max_queue,
            ) as mb:
                out = stack_rows([f.result() for f in [mb.submit(img, deadline_ms=args.deadline_ms) for img in images]])
            print(f"[predict] micro-batch sizes: {mb.batch_sizes}")
        else:
            out = engine.predict(images, task=args.task, **kw)

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


if __name__ == "__main__":
    main()
