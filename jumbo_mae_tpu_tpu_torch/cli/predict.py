"""Serving entry point: run the model over images from the command line.

The thin front end over ``jumbo_mae_tpu_tpu_torch.infer``:

    # classification logits, ViT-B/16 as recipes/finetune_vit_b16.yaml builds it
    python -m jumbo_mae_tpu_tpu_torch.cli.predict --preset vit_b16 \\
        --set posemb=sincos2d --task logits --synthetic 8 --max-batch 64

    # frozen-encoder features to a file, on the CPU, exact float32 path
    python -m jumbo_mae_tpu_tpu_torch.cli.predict --preset vit_t16 \\
        --task features --pool gap --synthetic 4 --dtype float32 \\
        --device cpu --out feats.npz

The model config is a preset plus ``--set key=value`` overrides of its
fields (reading recipe files is a later slice). Images are ``--synthetic
N`` seeded uint8 images at the model's resolution (decoding image files is
a later slice). Weights are a random init from ``--init-seed``. Results
land in ``--out`` (``.npz``) and, for ``logits``, as one JSON line per
image on stdout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import typing
from pathlib import Path

import numpy as np

from jumbo_mae_tpu_tpu_torch.infer.engine import POOLS, InferenceEngine
from jumbo_mae_tpu_tpu_torch.models.config import JumboViTConfig, preset


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="vit_b16", help="model preset (models/config.py)")
    p.add_argument(
        "--set", dest="overrides", metavar="KEY=VALUE", nargs="*", action="extend",
        default=[], help="model config field overrides, e.g. posemb=sincos2d",
    )
    p.add_argument("--task", choices=("features", "logits"), default="logits")
    p.add_argument("--synthetic", type=int, required=True, metavar="N", help="serve N seeded synthetic images")
    p.add_argument("--pool", choices=POOLS, default="cls")
    p.add_argument("--topk", type=int, default=5, help="logits: classes per line")
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--dtype", default=None, help="compute dtype override (float32 for the exact path)")
    p.add_argument("--init-seed", type=int, default=0, help="seed of the random init")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", default="", help="output .npz path")
    return p


def _coerce(field: dataclasses.Field, raw: str):
    """Parse ``raw`` as the type of a config field."""
    hint = typing.get_type_hints(JumboViTConfig)[field.name]
    args = set(typing.get_args(hint)) or {hint}
    if raw.lower() in ("none", "null") and type(None) in args:
        return None
    if bool in args:
        if raw.lower() not in ("true", "false", "1", "0"):
            raise ValueError(f"{field.name} takes true/false, got {raw!r}")
        return raw.lower() in ("true", "1")
    for typ in (int, float):
        if typ in args:
            return typ(raw)
    return raw


def parse_overrides(items: list[str]) -> dict:
    fields = {f.name: f for f in dataclasses.fields(JumboViTConfig)}
    out = {}
    for item in items:
        key, sep, raw = item.partition("=")
        if not sep or key not in fields:
            raise SystemExit(f"--set {item!r}: expected FIELD=VALUE with FIELD in {sorted(fields)}")
        out[key] = _coerce(fields[key], raw)
    return out


def main(argv: list[str] | None = None) -> Path | None:
    args = build_parser().parse_args(argv)
    if args.synthetic < 1:
        raise SystemExit("--synthetic N needs N >= 1")
    cfg = preset(args.preset, **parse_overrides(args.overrides))
    engine = InferenceEngine(
        cfg, dtype=args.dtype, max_batch=args.max_batch,
        init_seed=args.init_seed, device=args.device,
    )
    size = engine.image_size
    images = np.random.RandomState(0).randint(0, 256, (args.synthetic, size, size, 3)).astype(np.uint8)
    names = [f"synthetic[{i}]" for i in range(args.synthetic)]
    kw = {"pool": args.pool} if args.task == "features" else {}
    out = engine.predict(images, task=args.task, **kw)

    if args.task == "logits":
        probs = np.exp(out - out.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        k = min(args.topk, out.shape[-1])
        for name, p_row in zip(names, probs):
            top = np.argsort(-p_row)[:k]
            print(json.dumps({
                "image": name,
                "classes": top.tolist(),
                "probs": [round(float(p_row[i]), 6) for i in top],
            }))
    result: Path | None = None
    if args.out:
        result = Path(args.out)
        result.parent.mkdir(parents=True, exist_ok=True)
        np.savez(result, **{args.task: out})
        print(f"[predict] wrote {args.task} for {len(names)} image(s) -> {result}")
    return result


if __name__ == "__main__":
    main()
