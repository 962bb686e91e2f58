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

``--set`` overrides recipe fields as ``cli.train`` takes them. Image files
are decoded from their bytes (``data/decode.py``: cv2, then PIL) and put
through the eval transform (resize to ``size / data.test_crop_ratio``,
center crop), the geometry of validation; a file that does not decode
raises and names the file. ``--synthetic N`` serves N seeded images
instead. ``--serve`` submits the images one at a time through the
micro-batching queue (``--max-delay-ms``, ``--max-batch``, ``--max-queue``
and ``--deadline-ms`` are its knobs); otherwise the whole list is batched
directly. Results land in ``--out`` (``.npz``) and, for ``logits``, as one
JSON line per image on stdout. Everything runs on ``"cuda"`` unless
``--device cpu``.

The flags of the layers still to port parse and raise, naming their
ROADMAP item: replicas, hot-swap watching and traffic shaping (A5,
``replicaset.py`` and ``serve/*``), token packing (A5, the packed path),
the persistent warm cache (A5, ``warmcache.py``), and the access log,
SLOs and the metrics exporter (A7).
"""

from __future__ import annotations

import argparse
import json
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
    "--replicas": ("replicas", "A5 (replicaset.py)"),
    "--interarrival-ms": ("interarrival_ms", "A5 (replicaset.py)"),
    "--swap-watch": ("swap_watch", "A5 (replicaset.py)"),
    "--swap-poll-s": ("swap_poll_s", "A5 (replicaset.py)"),
    "--swap-parity-min": ("swap_parity_min", "A5 (replicaset.py)"),
    "--swap-canary-requests": ("swap_canary_requests", "A5 (replicaset.py)"),
    "--swap-canary-timeout-s": ("swap_canary_timeout_s", "A5 (replicaset.py)"),
    "--pack": ("pack", "A5 (the packed path)"),
    "--pack-budget": ("pack_budget", "A5 (the packed path)"),
    "--pack-resolutions": ("pack_resolutions", "A5 (the packed path)"),
    "--pack-parity-n": ("pack_parity_n", "A5 (the packed path)"),
    "--tenants": ("tenants", "A5 (serve/*)"),
    "--autoscale": ("autoscale", "A5 (serve/*)"),
    "--autoscale-interval-s": ("autoscale_interval_s", "A5 (serve/*)"),
    "--warmcache": ("warmcache", "A5 (warmcache.py)"),
    "--no-warmcache": ("no_warmcache", "A5 (warmcache.py)"),
    "--access-log": ("access_log", "A7"),
    "--slo": ("slo", "A7"),
    "--slo-window-s": ("slo_window_s", "A7"),
    "--slo-fast-window-s": ("slo_fast_window_s", "A7"),
    "--metrics-port": ("metrics_port", "A7"),
    "--metrics-hold-s": ("metrics_hold_s", "A7"),
}
_FLAGS_TAKING_NO_VALUE = ("--pack", "--no-warmcache")


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
    p.add_argument("--warmup", action="store_true",
                   help="run every (task, bucket) once before the first request (kernels built at first use)")
    p.add_argument("--dtype", default=None, help="compute dtype override (float32 for the exact path)")
    p.add_argument("--quant", choices=("int8",), default=None, help="int8 weight-only quantization, dequantized on use")
    p.add_argument("--encoder-cache", type=int, default=0, metavar="N",
                   help="reconstruct: LRU of up to N encoder outputs keyed by (image bytes, seed)")
    p.add_argument("--encoder-cache-mb", type=float, default=0.0, metavar="MB",
                   help="byte bound on the encoder-output LRU beside --encoder-cache (0 = entries only)")
    p.add_argument("--set", dest="overrides", metavar="KEY.PATH=VALUE", nargs="*", action="extend", default=[],
                   help="dotted recipe overrides, the grammar of cli.train")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    for flag, (dest, item) in UNPORTED.items():
        kind = {"action": "store_true"} if flag in _FLAGS_TAKING_NO_VALUE else {"default": None}
        p.add_argument(flag, dest=dest, help=f"not ported yet (ROADMAP {item})", **kind)
    return p


def refuse_unported(args: argparse.Namespace) -> None:
    for flag, (dest, item) in UNPORTED.items():
        if getattr(args, dest) not in (None, False):
            raise NotImplementedError(NOT_PORTED.format(flag=flag, item=item))


def load_image(path: str | Path, size: int, crop_ratio: float) -> np.ndarray:
    """One image file → (size, size, 3) uint8, as validation sees it;
    raises ``ValueError`` naming a file that does not decode."""
    img = decode_image(Path(path).read_bytes())
    if img is None:
        raise ValueError(f"cannot decode image file {path}")
    return eval_transform(img, size, crop_ratio=crop_ratio)


def main(argv: list[str] | None = None) -> Path | None:
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    if bool(args.images) == bool(args.synthetic):
        raise SystemExit("pass exactly one of --images or --synthetic N")
    cfg = load_config(args.config, args.overrides)
    if not args.ckpt:
        print("[predict] WARNING: no --ckpt — serving a random init")
    engine = InferenceEngine(
        cfg, ckpt=args.ckpt, dtype=args.dtype, max_batch=args.max_batch, quant=args.quant,
        encoder_cache=args.encoder_cache, encoder_cache_bytes=int(args.encoder_cache_mb * 1024 * 1024),
        device=args.device,
    )
    if args.ckpt:
        print(f"[predict] restored {args.ckpt}: {engine.restore_bytes} bytes in {engine.restore_s:.2f} s")
    if args.warmup:
        n = engine.warmup((args.task,), pool=args.pool)
        print(f"[predict] warmup: {n} first run(s) in {engine.warmup_s:.2f} s")

    size = engine.image_size
    if args.synthetic:
        images = np.random.RandomState(0).randint(0, 256, (args.synthetic, size, size, 3)).astype(np.uint8)
        names = [f"synthetic[{i}]" for i in range(args.synthetic)]
    else:
        images = np.stack([load_image(f, size, cfg.data.test_crop_ratio) for f in args.images])
        names = list(args.images)

    kw = {"pool": args.pool} if args.task == "features" else {"seed": args.seed} if args.task == "reconstruct" else {}
    if args.serve:
        with MicroBatcher(
            lambda batch: engine.predict(batch, task=args.task, **kw),
            max_batch=args.max_batch, max_delay_ms=args.max_delay_ms, max_queue=args.max_queue,
        ) as mb:
            rows = [f.result() for f in [mb.submit(img, deadline_ms=args.deadline_ms) for img in images]]
        out = {k: np.stack([r[k] for r in rows]) for k in rows[0]} if isinstance(rows[0], dict) else np.stack(rows)
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
