"""The port's training driver, ``cli/train.py``, on the CPU.

- ``recipes/smoke_cpu.yaml`` trains through ``train(cfg, device="cpu")``:
  a positive ``val/loss``, ``perf/mfu`` in the metrics JSONL, a committed
  ``ckpt/last``;
- resume: 6 steps straight on 32 real samples at batch 8, against 3 steps,
  a resume and 3 more (the resume point is mid-epoch, so only the
  sample-exact data cursor gives the same batches): final parameters and
  optimizer state equal at atol = rtol = 0; the same through a SIGTERM
  preemption save at step 4; the coarse epoch resume without a cursor;
- the slice against the JAX package: from the same initial weights
  (``interop/from_jax.py``), the JAX ``make_train_iterator`` and a jitted
  step against the port's ``make_train_iterator`` and ``make_train_step``
  on ``smoke_cpu``'s model in float32 over 3 steps on the same shards,
  the mask noise pinned alike: identical host batches, equal learning
  rates, losses within rtol 1e-5;
- each refusal raises and names its ROADMAP item.
"""

import functools
import io
import json
import signal
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jumbo_mae_tpu_tpu.cli import train as jtrain
from jumbo_mae_tpu_tpu.config import load_config as jload_config
from jumbo_mae_tpu_tpu.parallel import create_mesh as jcreate_mesh
from jumbo_mae_tpu_tpu.train.optim import make_optimizer as jmake_optimizer
from jumbo_mae_tpu_tpu_torch.cli import train as ttrain
from jumbo_mae_tpu_tpu_torch.config import load_config
from jumbo_mae_tpu_tpu_torch.data.tario import write_tar_samples
from jumbo_mae_tpu_tpu_torch.interop import mae_state_dict_from_jax
from jumbo_mae_tpu_tpu_torch.train.checkpoint import read_state
from jumbo_mae_tpu_tpu_torch.train.optim import make_optimizer
from jumbo_mae_tpu_tpu_torch.train.steps import create_state, make_train_step
from torch_port_util import random_jumbo_params

RECIPES = Path(__file__).resolve().parent.parent / "recipes"
SMOKE = RECIPES / "smoke_cpu.yaml"


@pytest.fixture(scope="module")
def shard_root(tmp_path_factory):
    """2 shards × 16 PNG samples, 48 px."""
    from PIL import Image

    root = tmp_path_factory.mktemp("clishards")
    rng = np.random.default_rng(0)
    idx = 0
    for s in range(2):
        samples = []
        for _ in range(16):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 256, (48, 48, 3), dtype=np.uint8), "RGB").save(buf, format="PNG")
            samples.append({"__key__": f"s{idx:05d}", "png": buf.getvalue(), "cls": str(idx % 10).encode()})
            idx += 1
        write_tar_samples(str(root / f"train-{s:04d}.tar"), samples)
    return root


def test_smoke_recipe_trains_on_the_cpu(tmp_path):
    cfg = load_config(SMOKE, [f"run.output_dir={tmp_path}", "run.eval_interval=5"])
    metrics = ttrain.train(cfg, device="cpu")
    assert metrics["val/loss"] > 0 and np.isfinite(metrics["train/loss"])
    assert metrics["_exit_reason"] == "completed"
    out = tmp_path / "smoke_cpu"
    lines = [json.loads(x) for x in (out / "smoke_cpu-metrics.jsonl").read_text().strip().splitlines()]
    assert any("perf/mfu" in rec for rec in lines)
    assert [rec["step"] for rec in lines if "val/loss" in rec] == [5, 10]
    assert (out / "ckpt" / "last" / "10" / "COMMIT").is_file()
    assert read_state(out / "ckpt")["step"] == 10


def _overrides(out, shard_root, steps, *extra):
    return [
        f"run.output_dir={out}",
        f"run.training_steps={steps}",
        "run.train_batch_size=8",
        "run.eval_interval=3",
        "run.log_interval=3",
        "run.sanity_eval=false",
        "run.synthetic_data=false",
        f"data.train_shards={shard_root}/train-{{0000..0001}}.tar",
        "data.valid_shards=",
        "data.dataset_size=32",
        "data.shuffle_buffer=8",
        "optim.training_steps=6",
        *extra,
    ]


def _assert_same_saves(a, b):
    sa, sb = read_state(a), read_state(b)
    assert sa["step"] == sb["step"] == 6
    for k in sa["model"]:
        torch.testing.assert_close(sa["model"][k], sb["model"][k], atol=0, rtol=0, msg=k)
    for x, y in zip(sa["opt"]["mu"] + sa["opt"]["nu"], sb["opt"]["mu"] + sb["opt"]["nu"], strict=True):
        torch.testing.assert_close(x, y, atol=0, rtol=0)
    assert sa["opt"]["count"] == sb["opt"]["count"] and sa["opt"]["learning_rate"] == sb["opt"]["learning_rate"]


def test_resume_equals_uninterrupted(tmp_path, shard_root):
    run = lambda out, steps, *extra: ttrain.train(load_config(SMOKE, _overrides(out, shard_root, steps, *extra)),
                                                   device="cpu")
    run(tmp_path / "a", 6)
    run(tmp_path / "b", 3)
    extra = json.loads((tmp_path / "b" / "smoke_cpu" / "ckpt" / "last" / "3" / "extra.json").read_text())
    assert extra["data_cursor"]["workers"] == [[0, 24]] and extra["data_cursor"]["batches"] == 3
    assert "shard_cursor" in extra
    run(tmp_path / "b", 6, "run.resume=true")
    _assert_same_saves(tmp_path / "a" / "smoke_cpu" / "ckpt", tmp_path / "b" / "smoke_cpu" / "ckpt")


def test_sigterm_saves_and_the_resume_continues(tmp_path, shard_root, monkeypatch):
    """The installed SIGTERM handler asks the engine to stop: a preemption
    save at the step boundary, exit reason ``preempted``; resuming from it
    ends where the uninterrupted run ends."""
    real = ttrain.make_train_step

    def preempted_at_4(**kw):
        step = real(**kw)

        def wrapped(state, batch):
            state, m = step(state, batch)
            if state.step == 4:
                signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
            return state, m

        return wrapped

    before = signal.getsignal(signal.SIGTERM)
    ttrain.train(load_config(SMOKE, _overrides(tmp_path / "a", shard_root, 6)), device="cpu")
    monkeypatch.setattr(ttrain, "make_train_step", preempted_at_4)
    out = ttrain.train(load_config(SMOKE, _overrides(tmp_path / "b", shard_root, 6)), device="cpu")
    assert out["_exit_reason"] == "preempted"
    assert read_state(tmp_path / "b" / "smoke_cpu" / "ckpt")["step"] == 4
    monkeypatch.setattr(ttrain, "make_train_step", real)
    ttrain.train(load_config(SMOKE, _overrides(tmp_path / "b", shard_root, 6, "run.resume=true")), device="cpu")
    _assert_same_saves(tmp_path / "a" / "smoke_cpu" / "ckpt", tmp_path / "b" / "smoke_cpu" / "ckpt")
    assert signal.getsignal(signal.SIGTERM) is before  # train() puts the handler back


def test_resume_without_a_cursor_restarts_the_epoch(tmp_path, shard_root, capsys):
    """A save with no data cursor resumes the stream at the epoch of the
    resumed step: batches 5-8 (epoch 1) equal a fresh loader's epoch 1."""
    cfg = load_config(SMOKE, _overrides(tmp_path, shard_root, 6))
    it, source, _, _ = ttrain.make_train_iterator(cfg, 8, start_step=4, data_cursor=None, device="cpu")
    resumed = [next(it)["images"] for _ in range(4)]
    source.close()
    it, source, _, _ = ttrain.make_train_iterator(cfg, 8, device="cpu")
    fresh = [next(it)["images"] for _ in range(8)]
    source.close()
    for a, b in zip(resumed, fresh[4:]):
        np.testing.assert_array_equal(a, b)
    assert "resuming stream at epoch 1" in capsys.readouterr().out


def test_slice_matches_the_jax_package(tmp_path, shard_root):
    overrides = _overrides(tmp_path, shard_root, 3)
    jcfg, tcfg = jload_config(SMOKE, overrides), load_config(SMOKE, overrides)
    # the JAX side: its iterator and a jitted step of its model and optax
    mesh = jcreate_mesh(jcfg.mesh)
    jit_iter, jsource, _, _ = jtrain.make_train_iterator(jcfg, mesh, 8)
    fmodel, enc, _ = jtrain.build_model(jcfg)
    n = enc.num_patches
    init = fmodel.init(jax.random.key(0), np.zeros((1, 32, 32, 3), np.uint8), True, mask_noise=np.zeros((n,), np.float32))
    params = random_jumbo_params(jax.tree_util.tree_map(np.asarray, init["params"]), np.random.default_rng(7))
    tx = jmake_optimizer(jcfg.optim, 8, num_layers=enc.layers)
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(params, opt_state, images, noise):
        loss, grads = jax.value_and_grad(
            lambda p: fmodel.apply({"params": p}, images, True, mask_noise=noise)["loss"])(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    # the port's side, from the same weights
    model, _, _ = ttrain.build_model(tcfg, device="cpu")
    model.load_state_dict(mae_state_dict_from_jax(params))
    state = create_state(model, make_optimizer(tcfg.optim, 8), device="cpu", rng_seed=tcfg.run.seed)
    step = make_train_step(guard_nonfinite=True)
    t_iter, tsource, _, _ = ttrain.make_train_iterator(tcfg, 8, device="cpu")
    forward = model.forward
    rng = np.random.default_rng(8)
    try:
        for _ in range(3):
            jb, tb = next(jit_iter), next(t_iter)
            np.testing.assert_array_equal(np.asarray(jb["images"]), tb["images"])
            noise = rng.random((n,)).astype(np.float32)
            params, opt_state, jloss = jax_step(params, opt_state, jb["images"], jnp.asarray(noise))
            model.forward = functools.partial(forward, mask_noise=torch.from_numpy(noise))
            state, m = step(state, tb)
            np.testing.assert_allclose(m["learning_rate"], float(opt_state.hyperparams["learning_rate"]), rtol=1e-7)
            np.testing.assert_allclose(m["loss"].item(), float(jloss), rtol=1e-5)
    finally:
        jsource.close()
        tsource.close()


@pytest.mark.parametrize("override,item", [
    ("run.mode=finetune", "A4"),
    ("run.mode=linear", "A4"),
    ("run.pretrained_ckpt=x", "A4"),
    ("mesh.pipe=2", "A6"),
    ("mesh.fsdp=2", "A6"),
    ("mesh.tensor=2", "A6"),
    ("run.faults=train.loss:nan@n=1", "A7"),
    ("run.telemetry=true", "A7"),
    ("run.publish_dir=x", "A7"),
    ("run.chrome_trace=x", "A7"),
    ("run.profile_dir=x", "A7"),
    ("run.diag_every=1", "A7"),
    ("run.hangwatch_deadline_s=5", "A7"),
    ("run.slo=p99_latency_ms<=250", "A7"),
    ("run.eval_only=true", "A3"),
    ("model.overrides={grad_ckpt: true, remat_policy: dots, image_size: 32, patch_size: 4}", "A3"),
])
def test_refusals_name_their_roadmap_item(tmp_path, override, item):
    cfg = load_config(SMOKE, [f"run.output_dir={tmp_path}", override])
    with pytest.raises(NotImplementedError, match=item):
        ttrain.train(cfg, device="cpu")


def test_cli_flags_not_ported_raise():
    for flags in (["--distributed"], ["--elastic", "2"]):
        with pytest.raises(NotImplementedError, match="A6"):
            ttrain.main(["--config", str(SMOKE), "--device", "cpu", *flags])


def test_main_trains_and_prints(tmp_path, capsys):
    ttrain.main(["--config", str(SMOKE), "--device", "cpu", "--set", f"run.output_dir={tmp_path}",
                 "run.training_steps=2", "optim.training_steps=10", "run.eval_interval=2"])
    out = capsys.readouterr().out
    assert "not ported yet (ROADMAP A7)" in out and "[train] done:" in out
