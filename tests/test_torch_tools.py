"""The port's feature export and kNN probe against the JAX tools, on the
CPU; mirrors tests/test_tools_eval_extract.py.

``extract_features`` on the smoke recipe's synthetic validation stream,
from a port save and from a ``.msgpack`` of the same flax tree (O(1)
scale, seeded numpy): the features of every pool within atol / rtol 1e-4
and the labels equal. ``knn_probe`` is numpy on both sides: equal
predictions, the JSON line, the refusals, and recipe sides extracted on
the fly.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from jumbo_mae_tpu_tpu.config import load_config as jax_load_config
from jumbo_mae_tpu_tpu.infer import InferenceEngine as JaxEngine
from jumbo_mae_tpu_tpu.train.checkpoint import export_params_msgpack
from jumbo_mae_tpu_tpu_torch.config import load_config
from jumbo_mae_tpu_tpu_torch.tools import extract_features, knn_probe
from torch_port_util import port_save, random_jumbo_params

REPO = Path(__file__).resolve().parent.parent
RECIPE = REPO / "recipes" / "smoke_cpu.yaml"
sys.path.insert(0, str(REPO / "tools"))
BASE = ["model.overrides.dtype=float32", "model.dec_layers=1", "model.dec_dim=32", "model.dec_heads=2",
        "model.dec_dtype=float32", "run.synthetic_data=true", "run.valid_batch_size=8"]
MODES = {"pretrain": BASE, "finetune": BASE + ["run.mode=finetune", "model.overrides.labels=10"]}
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    jeng = JaxEngine(jax_load_config(RECIPE, MODES["finetune"]), max_batch=4, warm_cache=False)
    out = {}
    for mode, task in (("pretrain", "reconstruct"), ("finetune", "logits")):
        init = jax.tree_util.tree_map(np.asarray, jeng._task(task)["variables"]["params"])
        params = random_jumbo_params(init, np.random.default_rng(9))
        msgpack = root / f"{mode}.msgpack"
        export_params_msgpack({"model": params} if mode == "finetune" else params, str(msgpack))
        port_save(root / mode, load_config(RECIPE, MODES[mode]), params)
        out[mode] = {"msgpack": str(msgpack), "save": str(root / mode)}
    return out


@pytest.mark.parametrize("pool", ["cls", "gap", "tokens"])
@pytest.mark.parametrize("mode", list(MODES))
def test_extract_features_matches_jax(ckpts, tmp_path, mode, pool):
    from extract_features import main as jax_extract

    ref = np.load(jax_extract([str(RECIPE), "--ckpt", ckpts[mode]["msgpack"], "--out", str(tmp_path / "j.npz"),
                               "--pool", pool, "--set", *MODES[mode]]))
    got = np.load(extract_features.main([str(RECIPE), "--ckpt", ckpts[mode]["save"], "--out", str(tmp_path / "p.npz"),
                                         "--pool", pool, "--device", "cpu", "--set", *MODES[mode]]))
    assert sorted(got.files) == sorted(ref.files)
    assert got["features"].shape[0] == 32 and str(got["pool"]) == pool
    np.testing.assert_allclose(got["features"], ref["features"], **TOL)
    if mode == "finetune":
        np.testing.assert_array_equal(got["labels"], ref["labels"])
    else:
        assert "labels" not in got.files


def test_extract_refuses_no_data_and_unrelated_saves(ckpts, tmp_path):
    cfg = load_config(RECIPE, [*BASE, "run.synthetic_data=false"])
    with pytest.raises(SystemExit, match="no data"):
        extract_features.extract_arrays(cfg, "", "cls", device="cpu")
    from jumbo_mae_tpu_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer
    from jumbo_mae_tpu_tpu_torch.train.optim import OptimConfig
    from jumbo_mae_tpu_tpu_torch.train.steps import create_state
    import torch

    state = create_state(torch.nn.Sequential(torch.nn.Linear(2, 2)), OptimConfig(), device="cpu", global_batch_size=8)
    Checkpointer(CheckpointConfig(str(tmp_path / "junk"), async_save=False)).save(1, state)
    with pytest.raises(SystemExit, match="0 params"):
        extract_features.extract_arrays(load_config(RECIPE, BASE), str(tmp_path / "junk"), "cls", device="cpu")


def _clusters(n_per, seed, centers):
    r = np.random.default_rng(seed)
    feats = np.concatenate([c + r.standard_normal((n_per, centers.shape[1])) for c in centers])
    return feats.astype(np.float32), np.repeat(np.arange(len(centers)), n_per)


def test_knn_probe_matches_jax_and_separates_clusters(tmp_path, capsys):
    from knn_probe import knn_predict as jax_knn

    centers = np.random.default_rng(0).standard_normal((5, 16)) * 4.0
    train_f, train_l = _clusters(40, 1, centers)
    query_f, query_l = _clusters(10, 2, centers)
    preds = knn_probe.knn_predict(train_f, train_l, query_f, k=10)
    assert (preds == query_l).mean() > 0.9
    np.testing.assert_array_equal(preds, jax_knn(train_f, train_l, query_f, k=10))
    noise = np.random.default_rng(3).standard_normal((50, 16)).astype(np.float32)
    labels = np.random.default_rng(4).integers(0, 7, 120)
    train = np.random.default_rng(5).standard_normal((120, 16)).astype(np.float32)
    for k, temp, block in ((1, 0.07, 1024), (20, 0.5, 7)):
        np.testing.assert_array_equal(knn_probe.knn_predict(train, labels, noise, k=k, temp=temp, block=block),
                                      jax_knn(train, labels, noise, k=k, temp=temp, block=block))
    shuffled = train_l.copy()
    np.random.default_rng(3).shuffle(shuffled)
    assert (knn_probe.knn_predict(train_f, shuffled, query_f, k=10) == query_l).mean() < 0.5
    np.savez(tmp_path / "train.npz", features=train_f, labels=train_l)
    np.savez(tmp_path / "val.npz", features=query_f, labels=query_l)
    capsys.readouterr()
    acc = knn_probe.main([str(tmp_path / "train.npz"), str(tmp_path / "val.npz")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert acc > 0.9 and line["metric"] == "knn_top1" and line["value"] == round(acc, 4)
    assert line["n_train"] == 200 and line["n_query"] == 50


def test_knn_probe_rejects_empty_train_bad_k_and_unlabelled(tmp_path):
    feats, query = np.ones((4, 8), np.float32), np.ones((3, 8), np.float32)
    with pytest.raises(SystemExit, match="empty"):
        knn_probe.knn_predict(np.zeros((0, 8), np.float32), np.zeros((0,), int), query)
    with pytest.raises(SystemExit, match="k must be"):
        knn_probe.knn_predict(feats, np.zeros((4,), np.int64), query, k=0)
    np.savez(tmp_path / "nolabels.npz", features=feats)
    with pytest.raises(SystemExit, match="no labels"):
        knn_probe.main([str(tmp_path / "nolabels.npz"), str(tmp_path / "nolabels.npz")])


def test_knn_probe_from_recipes_matches_jax(ckpts, capsys):
    """Both sides extracted on the fly from the finetune recipe (labelled
    synthetic data) through the engine: the port's accuracy is JAX's."""
    from knn_probe import main as jax_knn_main

    sets = [*MODES["finetune"]]
    ref = jax_knn_main([str(RECIPE), str(RECIPE), "--ckpt", ckpts["finetune"]["msgpack"], "--k", "5", "--set", *sets])
    got = knn_probe.main([str(RECIPE), str(RECIPE), "--ckpt", ckpts["finetune"]["save"], "--k", "5",
                          "--device", "cpu", "--set", *sets])
    assert got == ref
    with pytest.raises(SystemExit, match="no labels"):
        knn_probe.main([str(RECIPE), str(RECIPE), "--ckpt", ckpts["pretrain"]["save"], "--device", "cpu",
                        "--set", *MODES["pretrain"]])
