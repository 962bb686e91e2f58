"""The port's flax msgpack weights against flax and the JAX package, on the
CPU.

- ``interop/flax_msgpack.py`` reads what ``flax.serialization.
  msgpack_serialize`` writes with equal leaves (float32, int32, bfloat16
  as its float32 upcast, scalars, nested maps, arrays split into chunks),
  and ``msgpack_restore`` reads what it writes (numpy arrays, tensors,
  bfloat16 tensors, chunked arrays) with equal leaves;
- ``train/checkpoint.py`` ``export_params_msgpack`` and
  ``import_params_msgpack`` round-trip a port model's flax tree exactly,
  and the JAX package's ``import_params_msgpack`` reads the port's file;
- a ``.msgpack`` from the JAX package's ``export_params_msgpack`` serves:
  the port engine's logits, features and reconstructions equal the JAX
  engine's on the same file (float32, atol/rtol 1e-4, the tolerance of
  tests/test_torch_serve_ckpt.py), and ``cli.predict --ckpt x.msgpack``
  runs; it warm-starts ``cli.train`` (every encoder tensor loaded);
- an Orbax directory raises, naming the conversion command.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from jumbo_mae_tpu_tpu.config import load_config as jax_load_config
from jumbo_mae_tpu_tpu.infer import InferenceEngine as JaxEngine
from jumbo_mae_tpu_tpu.train.checkpoint import export_params_msgpack as jax_export
from jumbo_mae_tpu_tpu.train.checkpoint import import_params_msgpack as jax_import
from jumbo_mae_tpu_tpu_torch.cli import predict
from jumbo_mae_tpu_tpu_torch.cli import train as ttrain
from jumbo_mae_tpu_tpu_torch.config import load_config
from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine
from jumbo_mae_tpu_tpu_torch.infer import engine as engine_mod
from jumbo_mae_tpu_tpu_torch.interop import flax_msgpack
from jumbo_mae_tpu_tpu_torch.interop.from_jax import model_flax_tree, state_dict_from_flax
from jumbo_mae_tpu_tpu_torch.train import checkpoint as tckpt
from torch_port_util import random_images, random_jumbo_params

RECIPE = Path(__file__).resolve().parent.parent / "recipes" / "smoke_cpu.yaml"
BASE = ["model.overrides.dtype=float32", "model.dec_layers=1", "model.dec_dim=32", "model.dec_heads=2",
        "model.dec_dtype=float32"]
TOL = dict(atol=1e-4, rtol=1e-4)


def assert_trees_equal(got, want, path=()):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], (*path, k))
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, path
    np.testing.assert_array_equal(g, w.astype(g.dtype) if w.dtype.name == "bfloat16" else w, err_msg=str(path))


def mixed_tree(rng):
    return {
        "block_0": {"kernel": rng.standard_normal((3, 4)).astype(np.float32), "bias": np.zeros(4, np.float32)},
        "ints": np.arange(6, dtype=np.int32).reshape(2, 3),
        "half": jnp.asarray(rng.standard_normal((5,)), jnp.bfloat16),
        "scalar": np.float32(2.5),
        "empty": np.zeros((0, 3), np.float32),
        "nested": {"deep": {"x": rng.standard_normal((2, 2, 2)).astype(np.float64)}},
        "count": 7,
        "name": "ok",
    }


@pytest.mark.parametrize("chunk", [None, 64])
def test_the_port_reads_flax_msgpack(chunk, monkeypatch):
    if chunk:  # arrays above the chunk size are written in chunks
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
    tree = mixed_tree(np.random.default_rng(0))
    tree["big"] = np.random.default_rng(1).standard_normal((9, 7)).astype(np.float32)
    data = serialization.msgpack_serialize(tree)
    if chunk:
        assert b"__msgpack_chunked_array__" in data
    got = flax_msgpack.unpackb(data)
    assert got["half"].dtype == np.float32 and got["count"] == 7 and got["name"] == "ok"
    for key in ("block_0", "ints", "half", "scalar", "empty", "nested", "big"):
        assert_trees_equal(got[key], tree[key], (key,))


@pytest.mark.parametrize("chunk", [None, 64])
def test_flax_reads_the_ports_msgpack(chunk, monkeypatch):
    if chunk:
        monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", chunk)
    rng = np.random.default_rng(2)
    tree = {
        "a": {"kernel": rng.standard_normal((4, 3)).astype(np.float32), "bias": torch.arange(3.0)},
        "bf": torch.tensor([1.0, -2.5, 3.25], dtype=torch.bfloat16),
        "big": rng.standard_normal((11, 5)).astype(np.float32),
        "ints": np.arange(4, dtype=np.int64),
        "scalar": np.float32(-1.5),
        "meta": {"count": 300, "neg": -40, "f": 0.125, "flag": True, "none": None, "s": "x" * 40},
    }
    data = flax_msgpack.packb(tree)
    got = serialization.msgpack_restore(data)
    np.testing.assert_array_equal(got["a"]["kernel"], tree["a"]["kernel"])
    np.testing.assert_array_equal(got["a"]["bias"], tree["a"]["bias"].numpy())
    assert str(got["bf"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(got["bf"], np.float32), tree["bf"].float().numpy())
    np.testing.assert_array_equal(got["big"], tree["big"])
    np.testing.assert_array_equal(got["ints"], tree["ints"])
    assert got["scalar"] == np.float32(-1.5) and got["meta"] == tree["meta"]
    # and the port's own reader gives the tree back
    back = flax_msgpack.unpackb(data)
    np.testing.assert_array_equal(back["big"], tree["big"])
    np.testing.assert_array_equal(back["bf"], tree["bf"].float().numpy())
    assert back["meta"] == tree["meta"]


def test_export_import_round_trip_a_port_model(tmp_path):
    from jumbo_mae_tpu_tpu_torch.models import DecoderConfig, preset
    from jumbo_mae_tpu_tpu_torch.models.mae import MAEPretrainModel

    model = MAEPretrainModel(preset("vit_t16", labels=None, mask_ratio=0.75, image_size=32, patch_size=4),
                             DecoderConfig(layers=1, dim=32, heads=2), device="cpu", seed=3)
    params, _ = model_flax_tree(model)
    path = tmp_path / "sub" / "mae.msgpack"
    tckpt.export_params_msgpack(params, path)
    assert path.is_file() and not list(path.parent.glob("*.tmp"))
    assert_trees_equal(tckpt.import_params_msgpack(path), params)
    assert_trees_equal(jax_import(str(path)), params)
    sd = state_dict_from_flax(tckpt.import_params_msgpack(path))
    for name, t in model.state_dict().items():
        if name in sd:
            assert torch.equal(sd[name], t), name


@pytest.fixture(scope="module")
def jax_msgpacks(tmp_path_factory):
    """A pretraining and a finetune flax tree at O(1) scale, each exported
    by the JAX package, and a JAX engine serving the same file."""
    root = tmp_path_factory.mktemp("msgpack")
    out = {}
    for i, (mode, sets) in enumerate({"pretrain": BASE, "finetune": BASE + ["run.mode=finetune",
                                                                            "model.overrides.labels=10"]}.items()):
        jeng = JaxEngine(jax_load_config(RECIPE, sets), max_batch=8, warm_cache=False,
                         **({"labels": 10} if mode == "pretrain" else {}))
        task = "reconstruct" if mode == "pretrain" else "logits"
        init = jax.tree_util.tree_map(np.asarray, jeng._task(task)["variables"]["params"])
        params = random_jumbo_params(init, np.random.default_rng(20 + i))
        path = root / f"{mode}.msgpack"
        jax_export(params if mode == "pretrain" else {"model": params}, str(path))
        out[mode] = dict(path=str(path), sets=sets, params=params,
                         jax=JaxEngine(jax_load_config(RECIPE, sets), ckpt=str(path), max_batch=8, warm_cache=False,
                                       **({"labels": 10} if mode == "pretrain" else {})))
    return out


@pytest.mark.parametrize("mode,task", [("finetune", "logits"), ("finetune", "features"),
                                       ("pretrain", "features"), ("pretrain", "reconstruct")])
def test_a_jax_msgpack_serves_as_the_jax_engine_serves_it(jax_msgpacks, mode, task, monkeypatch):
    ck = jax_msgpacks[mode]
    eng = InferenceEngine(load_config(RECIPE, ck["sets"]), ckpt=ck["path"], device="cpu", max_batch=8)
    x = random_images(np.random.default_rng(5), 5, 32)
    if task == "reconstruct":
        want = ck["jax"].reconstruct(x, seed=3)
        # the port's mask noise pinned to the JAX engine's mask (as
        # tests/test_torch_reconstruct.py pins it)
        noise = torch.from_numpy(want["mask"][0].astype(np.float32) + np.arange(64, dtype=np.float32) / 64e3)
        monkeypatch.setattr(engine_mod, "reconstruct_noise", lambda seed, n: noise.clone())
        got = eng.reconstruct(x, seed=3)
        np.testing.assert_array_equal(got["mask"], want["mask"])
        np.testing.assert_allclose(got["reconstruction"], want["reconstruction"], **TOL)
    else:
        got, want = getattr(eng, task)(x), getattr(ck["jax"], task)(x)
        np.testing.assert_allclose(got, want, **TOL)
    params, stats = tckpt.restore_inference_state(ck["path"])
    assert stats is None and len(tckpt.save_digest(ck["path"])) == 16


def test_cli_predict_serves_and_cli_train_warm_starts_from_msgpack(jax_msgpacks, tmp_path, capsys):
    ck = jax_msgpacks["finetune"]
    out = np.load(predict.main(["--config", str(RECIPE), "--ckpt", ck["path"], "--task", "logits", "--synthetic",
                                "3", "--device", "cpu", "--out", str(tmp_path / "p.npz"), "--set", *ck["sets"]]))
    assert out["logits"].shape == (3, 10) and np.isfinite(out["logits"]).all()
    # a finetune warm-started from the MAE file: every encoder tensor loads
    mae = jax_msgpacks["pretrain"]["path"]
    stats = {}
    cfg = load_config(RECIPE, ck["sets"] + [f"run.output_dir={tmp_path}"])
    model, _, _ = ttrain.build_model(cfg, device="cpu")
    params = dict(model.named_parameters())
    merged = tckpt.load_pretrained_params(mae, params, stats=stats)
    want = state_dict_from_flax(tckpt.import_params_msgpack(mae))
    assert stats["loaded"] and not stats["skipped"]
    for name in stats["loaded"]:
        assert torch.equal(merged[name], want["encoder." + name[len("model."):]]), name
    ttrain.main(["--config", str(RECIPE), "--device", "cpu", "--set", *ck["sets"], f"run.output_dir={tmp_path}",
                 f"run.pretrained_ckpt={mae}", "run.training_steps=1", "run.eval_interval=1"])
    assert "pretrained merge:" in capsys.readouterr().out


def test_an_orbax_directory_names_the_conversion(tmp_path):
    orbax = tmp_path / "orbax" / "last" / "4"
    (orbax / "state").mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    for call in (tckpt.restore_inference_state, tckpt.load_params_tree):
        with pytest.raises(NotImplementedError, match="export_params_msgpack") as err:
            call(tmp_path / "orbax")
        assert "A3.3" in str(err.value) and "restore_inference_state" in str(err.value)
    with pytest.raises(FileNotFoundError):
        tckpt.resolve_save(tmp_path / "missing.msgpack")
