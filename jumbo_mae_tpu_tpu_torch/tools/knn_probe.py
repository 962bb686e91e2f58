"""k-nearest-neighbour probe over exported features.

Counterpart of ``tools/knn_probe.py``: a training-free accuracy readout of
frozen representations (cosine similarity, a temperature-weighted vote
over the k nearest reference features), in numpy on the host.

    python -m jumbo_mae_tpu_tpu_torch.tools.extract_features cfg.yaml --ckpt C --out train.npz \\
        --set data.valid_shards=<train shards>
    python -m jumbo_mae_tpu_tpu_torch.tools.extract_features cfg.yaml --ckpt C --out val.npz
    python -m jumbo_mae_tpu_tpu_torch.tools.knn_probe train.npz val.npz [--k 20] [--temp 0.07]

Each side is an ``.npz`` with ``features`` and ``labels`` (as
``extract_features`` writes them) or a ``.yaml`` recipe, extracted on the
fly through the engine from ``--ckpt`` (on ``--device``, default
``cuda``). Prints one JSON line with the top-1 accuracy.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def knn_predict(train_feats, train_labels, query_feats, *, k: int = 20, temp: float = 0.07,
                num_classes: int | None = None, block: int = 1024) -> np.ndarray:
    """Cosine-similarity kNN with temperature-weighted voting; the
    predicted label of every query row."""

    def l2norm(x):
        x = np.asarray(x, np.float32)
        return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)

    train = l2norm(train_feats)
    query = l2norm(query_feats)
    if train.shape[0] == 0:
        # k would clamp to 0 and every query would vote class 0
        raise SystemExit("kNN probe: train feature set is empty — re-extract the reference split")
    if k < 1:
        raise SystemExit(f"kNN probe: k must be >= 1, got {k}")
    labels = np.asarray(train_labels)
    classes = int(num_classes or labels.max() + 1)
    k = min(k, train.shape[0])
    preds = []
    for start in range(0, query.shape[0], block):
        sim = query[start : start + block] @ train.T
        top = np.argpartition(-sim, k - 1, axis=1)[:, :k]
        weight = np.exp(np.take_along_axis(sim, top, axis=1) / temp)
        votes = np.zeros((top.shape[0], classes), np.float32)
        rows = np.repeat(np.arange(top.shape[0]), k)
        np.add.at(votes, (rows, labels[top].reshape(-1)), weight.reshape(-1))
        preds.append(votes.argmax(axis=1))
    return np.concatenate(preds)


def _load_side(path: str, name: str, args) -> dict:
    """One side of the probe: an ``.npz``, or a recipe extracted through
    the engine."""
    if path.endswith((".yaml", ".yml")):
        from jumbo_mae_tpu_tpu_torch.config import load_config
        from jumbo_mae_tpu_tpu_torch.tools.extract_features import extract_arrays

        features, labels = extract_arrays(load_config(path, args.overrides), args.ckpt, args.pool, device=args.device)
        if labels is None:
            raise SystemExit(f"{name} recipe {path} yields no labels — the probe needs a labelled split")
        return {"features": features, "labels": labels}
    z = np.load(path)
    if "labels" not in z:
        raise SystemExit(f"{name} file has no labels — extract from a labelled split")
    return z


def main(argv: list[str] | None = None) -> float:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("train_npz", help="reference set: .npz or .yaml recipe")
    p.add_argument("query_npz", help="set to evaluate: .npz or .yaml recipe")
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--temp", type=float, default=0.07)
    p.add_argument("--ckpt", default="", help="checkpoint for .yaml recipe inputs")
    p.add_argument("--pool", choices=("cls", "gap"), default="cls")
    p.add_argument("--set", dest="overrides", metavar="KEY.PATH=VALUE", nargs="*", action="extend", default=[],
                   help="dotted recipe overrides for .yaml inputs, the grammar of cli.train")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu, for .yaml inputs")
    args = p.parse_args(argv)

    train = _load_side(args.train_npz, "train", args)
    query = _load_side(args.query_npz, "query", args)
    preds = knn_predict(train["features"], train["labels"], query["features"], k=args.k, temp=args.temp)
    acc = float((preds == query["labels"]).mean())
    print(json.dumps({
        "metric": "knn_top1", "value": round(acc, 4), "k": args.k, "temp": args.temp,
        "n_train": int(train["features"].shape[0]), "n_query": int(query["features"].shape[0]),
    }))
    return acc


if __name__ == "__main__":
    main()
