"""Export frozen-encoder features of a recipe's validation split.

Counterpart of ``tools/extract_features.py``: restore a save once through
the inference engine, run the encoder deterministically (no masking, no
dropout) over the validation stream (``cli/train.py``'s
``make_valid_iterator``: ``data.valid_shards``, or synthetic data) and
write an ``.npz`` of pooled features, and labels where the data has them.

    python -m jumbo_mae_tpu_tpu_torch.tools.extract_features recipes/linear_lars_vit_l16.yaml \\
        --ckpt runs/pretrain/ckpt --out feats.npz --pool cls [--set data.valid_shards=...]

``--pool cls`` concatenates the CLS tokens (the probe representation),
``gap`` mean-pools the patch tokens, ``tokens`` exports the whole normed
sequence. ``--ckpt`` is a port save: an MAE save's ``encoder``, a
classifier's ``model`` or a bare encoder. Runs on ``"cuda"`` unless
``--device cpu``. :func:`extract_arrays` is the library surface the kNN
probe calls.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("recipe", nargs="?", default=None, help="YAML recipe path")
    p.add_argument("--ckpt", default="", help="a port checkpoint; random init if omitted")
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--pool", choices=("cls", "gap", "tokens"), default="cls")
    p.add_argument("--set", dest="overrides", metavar="KEY.PATH=VALUE", nargs="*", action="extend", default=[],
                   help="dotted recipe overrides, the grammar of cli.train")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def extract_arrays(cfg, ckpt: str, pool: str, *, device: str | torch.device = "cuda"):
    """The recipe's validation stream through the engine's ``features``;
    returns ``(features, labels or None)`` with invalid (padded) rows
    dropped. Raises ``SystemExit`` on an empty stream or a checkpoint
    that loads nothing."""
    from jumbo_mae_tpu_tpu_torch.cli.train import make_valid_iterator
    from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine, bucket_for

    # the recipe's label count: synthetic labels live in its class space
    recipe_labels = cfg.model.overrides.get("labels")
    per_batch = max(1, cfg.run.valid_batch_size)
    engine = InferenceEngine(cfg, ckpt=ckpt, max_batch=bucket_for(min(per_batch, 1024), 1024), device=device)
    # host batches: the engine uploads what it serves
    factory = make_valid_iterator(cfg, per_batch, num_labels=recipe_labels or 1000, device="cpu",
                                  keys=("images", "labels", "valid"))
    if factory is None:
        raise SystemExit("no data: set data.valid_shards or run.synthetic_data=true")
    feats: list[np.ndarray] = []
    labels: list[np.ndarray] = []
    for batch in factory():
        images = np.asarray(batch["images"])
        out = engine.features(images, pool=pool)
        valid = np.asarray(batch.get("valid", np.ones(out.shape[0], bool))).astype(bool)
        feats.append(out[valid])
        if "labels" in batch:
            labels.append(np.asarray(batch["labels"])[valid])
    if sum(f.shape[0] for f in feats) == 0:
        raise SystemExit(
            "no valid samples in the stream — check that data.valid_shards names non-empty shards "
            "(or run.synthetic_data=true)"
        )
    return np.concatenate(feats), (np.concatenate(labels) if labels else None)


def main(argv: list[str] | None = None) -> Path:
    from jumbo_mae_tpu_tpu_torch.config import load_config

    args = build_parser().parse_args(argv)
    cfg = load_config(args.recipe, args.overrides)
    features, labels = extract_arrays(cfg, args.ckpt, args.pool, device=args.device)
    out = Path(args.out)
    payload = {"features": features, "pool": np.asarray(args.pool)}
    if labels is not None:
        payload["labels"] = labels
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **payload)
    print(f"[extract] wrote {features.shape[0]} x {features.shape[1:]} {args.pool} features -> {out}")
    return out


if __name__ == "__main__":
    main()
