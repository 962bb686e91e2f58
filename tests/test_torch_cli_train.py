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
- finetuning (Mixup/CutMix, label smoothing, AdamW with layer decay) and
  linear probing (LARS, the BatchNorm head, the frozen trunk) through the
  port's iterator and step against the JAX package's on the same shards
  over 3 steps, the mixup draws pinned to JAX's: identical host batches
  and labels, equal learning rates, losses within rtol 1e-5, the
  probe's accuracies equal, the BatchNorm statistics within 1e-6;
- a warm start, ``val/acc1``/``val/acc5`` in the metrics JSONL, ``best``
  by ``val/acc1``, and ``run.eval_only`` from ``last`` and ``best``
  reproducing the training run's evaluation exactly;
- a guarded skipped classify step leaves the parameters and the
  BatchNorm statistics as they were; gradient accumulation carries the
  labels;
- ``run.publish_dir``: a linear probe of the smoke recipe publishes a
  full artifact, then a delta one (the frozen trunk rides the base), each
  verified, and ``cli.predict --swap-watch`` promotes both;
- ``run.diag_every=2`` journals the group statistics of every second step
  and one ``compiled_program`` row;
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

import jumbo_mae_tpu_tpu.models.classifier as flax_classifier
from jumbo_mae_tpu_tpu.cli import train as jtrain
from jumbo_mae_tpu_tpu.config import load_config as jload_config
from jumbo_mae_tpu_tpu.parallel import create_mesh as jcreate_mesh
from jumbo_mae_tpu_tpu.train.optim import make_optimizer as jmake_optimizer
from jumbo_mae_tpu_tpu_torch.cli import train as ttrain
from jumbo_mae_tpu_tpu_torch.config import load_config
from jumbo_mae_tpu_tpu_torch.data import tario as ttario
from jumbo_mae_tpu_tpu_torch.data.tario import write_tar_samples
from jumbo_mae_tpu_tpu_torch.interop import classifier_state_dict_from_jax, mae_state_dict_from_jax
from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal
from jumbo_mae_tpu_tpu_torch.train.checkpoint import read_state
from jumbo_mae_tpu_tpu_torch.train.optim import make_optimizer
from jumbo_mae_tpu_tpu_torch.train.steps import create_state, make_train_step
from torch_port_util import jax_mixup_draws, random_jumbo_params

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


H14_PATH = [  # the ViT-H/14 recipe's path at the smoke size: "dots" remat, the native reader, the valid cache
    "model.overrides={mask_ratio: 0.75, posemb: sincos2d, image_size: 32, patch_size: 4, dtype: float32, "
    "grad_ckpt: true, remat_policy: dots}",
    "data.use_native=true",
    "data.native_io_threads=2",
]


def test_dots_native_reader_and_valid_cache_through_the_cli(tmp_path, shard_root, monkeypatch):
    """The smoke recipe with remat_policy=dots, data.use_native and
    data.valid_cache: finite losses, the second eval reads no shard and
    equals the first pass's loss on the same weights, a native cursor in
    the save, and a resume at step 3 bit-equal to the straight 6 steps."""
    opens = []
    real = ttario.open_url
    monkeypatch.setattr(ttario, "open_url", lambda url, mode="rb": opens.append(url) or real(url, mode))
    evals = []  # the shard opens after each evaluation
    real_eval = ttrain.evaluate

    def counted(*a):
        out = real_eval(*a)
        evals.append(len(opens))
        return out

    monkeypatch.setattr(ttrain, "evaluate", counted)
    sets = [*H14_PATH, f"data.valid_shards={shard_root}/train-0001.tar", f"data.valid_cache={tmp_path / 'vc'}"]
    run = lambda out, steps, *extra: ttrain.train(  # noqa: E731
        load_config(SMOKE, _overrides(out, shard_root, steps, *sets, *extra)), device="cpu")
    metrics = run(tmp_path / "a", 6)
    assert np.isfinite(metrics["train/loss"]) and np.isfinite(metrics["val/loss"])
    assert evals == [1, 1]  # the first eval opened the shard, the second read the cache
    assert len(list((tmp_path / "vc").glob("val-*.json"))) == 1
    run(tmp_path / "b", 3)
    extra = json.loads((tmp_path / "b" / "smoke_cpu" / "ckpt" / "last" / "3" / "extra.json").read_text())
    assert extra["data_cursor"]["native_threads"] == 2 and extra["data_cursor"]["workers"] == [[0, 24]]
    run(tmp_path / "b", 6, "run.resume=true")
    _assert_same_saves(tmp_path / "a" / "smoke_cpu" / "ckpt", tmp_path / "b" / "smoke_cpu" / "ckpt")
    # the same weights give the same eval from the cache as from the shard
    cached, fresh = (ttrain.train(load_config(SMOKE, _overrides(
        tmp_path / "c", 6, *sets[:-1], f"data.valid_cache={vc}", "run.eval_only=true", "run.resume=true",
        f"run.output_dir={tmp_path / 'a'}")), device="cpu") for vc in (tmp_path / "vc", ""))
    assert cached["val/loss"] == fresh["val/loss"]


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
    ("mesh.pipe=2", "A6"),
    ("mesh.fsdp=2", "A6"),
    ("mesh.tensor=2", "A6"),
])
def test_refusals_name_their_roadmap_item(tmp_path, override, item):
    cfg = load_config(SMOKE, [f"run.output_dir={tmp_path}", override])
    with pytest.raises(NotImplementedError, match=item):
        ttrain.train(cfg, device="cpu")


def test_diag_every_journals_the_group_statistics(tmp_path):
    """``run.diag_every=2``: the group statistics of steps 2 and 4 reach
    the ``step`` rows (4 steps, a log window a step), the others carry
    none; ``run_start`` names the groups, and every step's flight-record
    entry has ``finite_frac``."""
    cfg = load_config(SMOKE, [f"run.output_dir={tmp_path}", "run.diag_every=2", "run.training_steps=4",
                              "optim.training_steps=10", "run.log_interval=1", "run.eval_interval=100",
                              "run.sanity_eval=false"])
    out = ttrain.train(cfg, device="cpu")
    assert out["_exit_reason"] == "completed" and out["train/finite_frac"] == 1.0
    events = read_journal(tmp_path / "smoke_cpu")
    start = next(e for e in events if e["type"] == "run_start")
    assert start["diag_every"] == 2 and start["diag_groups"][0] == "patch_embed" and "decoder" in start["diag_groups"]
    steps = [e for e in events if e["type"] == "step"]
    assert [e.get("diag_step") for e in steps] == [None, 2, None, 4]
    for e in steps[1::2]:
        assert list(e["diag"]) == start["diag_groups"]
        assert all(v["grad_norm"] > 0 and v["param_norm"] >= 0 and v["update_ratio"] >= 0 for v in e["diag"].values())
    programs = [e for e in events if e["type"] == "compiled_program"]
    assert len(programs) == 1 and programs[0]["source"] == "analytic" and programs[0]["peak_bytes"] is None


def test_cli_flags_not_ported_raise():
    for flags in (["--distributed"], ["--elastic", "2"]):
        with pytest.raises(NotImplementedError, match="A6"):
            ttrain.main(["--config", str(SMOKE), "--device", "cpu", *flags])


def test_main_trains_and_prints(tmp_path, capsys):
    ttrain.main(["--config", str(SMOKE), "--device", "cpu", "--set", f"run.output_dir={tmp_path}",
                 "run.training_steps=2", "optim.training_steps=10", "run.eval_interval=2"])
    out = capsys.readouterr().out
    assert "not ported yet (ROADMAP A7)" in out and "[train] done:" in out
    # of the layers on by default only the fleet beacons are skipped
    assert "running without: run.fleet: the fleet beacons (A7.4)\n" in out
    assert "retrace sentinel: 0 unexpected recompile(s)" in out


def test_run_faults_installs_the_plan_and_its_sites_fire(tmp_path, capsys):
    """``run.faults``: the plan is installed and named at start; ``train.loss``
    NaNs step 2, which the guard skips and the journal records; on a resume
    ``ckpt.load`` fails the newest save, and the restore walks back to the
    one before it, journaled as ``ckpt_fallback``."""
    from jumbo_mae_tpu_tpu_torch.faults import inject
    from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal

    run = lambda steps, *extra: ttrain.train(load_config(SMOKE, [  # noqa: E731
        f"run.output_dir={tmp_path}", f"run.training_steps={steps}", "optim.training_steps=10",
        "run.eval_interval=2", "run.log_interval=1", "run.sanity_eval=false", *extra]), device="cpu")
    try:
        run(4, "run.faults=train.loss:nan@n=1")
        out = capsys.readouterr().out
        assert "[faults] injection plan active: sites=['train.loss']" in out
        assert "non-finite steps skipped by the guard: [2]" in out
        assert inject.active_plan().counts() == {"train.loss:nan": (4, 1)}
        events = read_journal(tmp_path / "smoke_cpu")
        assert [(e["step"], e["reason"]) for e in events if e["type"] == "sentinel_bad_step"] == [(2, "device_skip")]
        run(6, "run.resume=true", "run.faults=ckpt.load:raise@n<1")
        assert "checkpoint step 4 unreadable" in capsys.readouterr().out
        events = read_journal(tmp_path / "smoke_cpu")
        fb = [e for e in events if e["type"] == "ckpt_fallback"]
        assert [(e["from_step"], e["to_step"]) for e in fb] == [(4, 2)] and fb[0]["error"].startswith("OSError")
        start = [e for e in events if e["type"] == "run_start"][-1]
        assert start["resumed"] and start["start_step"] == 2
    finally:
        inject.clear_plan()


CLASSIFY = "model.overrides={image_size: 32, patch_size: 4, posemb: sincos2d, dtype: float32, labels: 10}"
MODES = {
    "finetune": ["run.mode=finetune", CLASSIFY, "model.mixup=0.8", "model.cutmix=1.0", "model.label_smoothing=0.1",
                 "optim.layer_decay=0.75", "optim.learning_rate=1e-3", "optim.lr_scaling=none"],
    "linear": ["run.mode=linear", CLASSIFY, "optim.name=lars", "optim.learning_rate=0.5"],
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_classify_slice_matches_the_jax_package(tmp_path, shard_root, mode, monkeypatch):
    overrides = _overrides(tmp_path, shard_root, 3, *MODES[mode])
    jcfg, tcfg = jload_config(SMOKE, overrides), load_config(SMOKE, overrides)
    mesh = jcreate_mesh(jcfg.mesh)
    jit_iter, jsource, _, _ = jtrain.make_train_iterator(jcfg, mesh, 8, num_labels=10)
    fmodel, enc, _ = jtrain.build_model(jcfg)
    key = jax.random.key(0)
    init = jax.tree_util.tree_map(np.asarray, fmodel.init(
        {"params": key, "mixup": key, "dropout": key}, np.zeros((1, 32, 32, 3), np.uint8), np.zeros((1,), np.int32), True))
    params = random_jumbo_params(init["params"], np.random.default_rng(7))
    stats = init.get("batch_stats")
    tx = jmake_optimizer(jcfg.optim, 8, num_layers=enc.layers)
    opt_state = tx.init(params)
    keys = []  # the key flax's make_rng hands mixup_cutmix, traced out of the step
    real_mix = flax_classifier.mixup_cutmix
    monkeypatch.setattr(flax_classifier, "mixup_cutmix", lambda k, *a: keys.append(k) or real_mix(k, *a))

    @jax.jit
    def jax_step(params, stats, opt_state, images, labels, rng):
        def loss_fn(p):
            variables = {"params": p} | ({"batch_stats": stats} if stats is not None else {})
            out, upd = fmodel.apply(variables, images, labels, False, rngs={"mixup": rng, "dropout": rng},
                                    mutable=["batch_stats"] if stats is not None else [])
            return out["loss"].mean(), (out, upd.get("batch_stats"))

        (loss, (out, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        mix_key = jax.random.key_data(keys[-1]) if keys else None
        return optax.apply_updates(params, updates), new_stats, opt_state, out, mix_key

    model, _, _ = ttrain.build_model(tcfg, device="cpu")
    model.load_state_dict(classifier_state_dict_from_jax(params, stats))
    state = create_state(model, make_optimizer(tcfg.optim, 8, num_layers=enc.layers), device="cpu",
                         rng_seed=tcfg.run.seed)
    step = make_train_step(mode="classify", guard_nonfinite=True)
    t_iter, tsource, _, _ = ttrain.make_train_iterator(tcfg, 8, num_labels=10, device="cpu")
    forward = model.forward
    trunk_before = [p.detach().clone() for n, p in model.named_parameters() if not n.startswith("model.head.")]
    try:
        for i in range(3):
            jb, tb = next(jit_iter), next(t_iter)
            assert tb.keys() == {"images", "labels"}
            np.testing.assert_array_equal(np.asarray(jb["images"]), tb["images"])
            np.testing.assert_array_equal(np.asarray(jb["labels"]), tb["labels"])
            prev, rng = params, jax.random.key(100 + i)
            params, stats, opt_state, jout, mix_key = jax_step(params, stats, opt_state, jb["images"],
                                                               jb["labels"], rng)
            draws = None if mix_key is None else jax_mixup_draws(jax.random.wrap_key_data(mix_key), 8, 0.8, 1.0)
            model.forward = functools.partial(forward, mixup_draws=draws)
            state, m = step(state, tb)
            np.testing.assert_allclose(m["learning_rate"], float(opt_state.hyperparams["learning_rate"]), rtol=1e-7)
            np.testing.assert_allclose(float(m["loss"]), float(jout["loss"].mean()), rtol=1e-5)
            if mode == "linear":
                for k in ("acc1", "acc5"):
                    assert float(m[k]) == float(jout[k].mean()), k
            else:
                # after mixup the jitted JAX step is no reference for the
                # accuracies: on the first batch it misses rows 4 and 7, the
                # two mixed with an image of their own class, while every
                # per-sample loss agrees to 1e-5; the same forward unjitted
                # agrees with the port
                with jax.disable_jit():
                    eager = fmodel.apply({"params": prev}, jb["images"], jb["labels"], False,
                                         rngs={"mixup": rng, "dropout": rng})
                for k in ("acc1", "acc5"):
                    assert float(m[k]) == float(eager[k].mean()), k
    finally:
        jsource.close()
        tsource.close()
    assert (mode == "finetune") == bool(keys)
    if mode == "linear":
        bn = model.model.head.bn
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["model"]["head"]["bn"]["var"]), atol=1e-6)
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["model"]["head"]["bn"]["mean"]), atol=1e-6)
        trunk_after = [p for n, p in model.named_parameters() if not n.startswith("model.head.")]
        assert all(torch.equal(a, b) for a, b in zip(trunk_before, trunk_after))


def _classify_run(out, *extra):
    return load_config(SMOKE, [f"run.output_dir={out}", "run.name=ft", "run.mode=finetune", CLASSIFY,
                               "run.training_steps=4", "run.eval_interval=2", "run.log_interval=2",
                               "model.mixup=0.8", "model.cutmix=1.0", "optim.layer_decay=0.75", *extra])


def test_finetune_from_a_pretrain_save_then_eval_only(tmp_path, capsys):
    """smoke_cpu pretrains 2 steps; a finetune warm-starts from that save
    (every trunk tensor loaded, the decoder dropped), evaluates at steps 2
    and 4 into the JSONL and keeps ``best`` by ``val/acc1``; eval_only
    from ``last`` and from ``best`` reproduces those evaluations exactly,
    with an identity optimizer, and writes no checkpoint."""
    ttrain.train(load_config(SMOKE, [f"run.output_dir={tmp_path}", "run.training_steps=2"]), device="cpu")
    pre = tmp_path / "smoke_cpu" / "ckpt"
    metrics = ttrain.train(_classify_run(tmp_path, f"run.pretrained_ckpt={pre}"), device="cpu")
    out = capsys.readouterr().out
    assert "pretrained merge: 45 loaded, 0 resized, 0 shape-mismatch (fresh), 0 unused" in out
    assert "dropped outside 'encoder'" in out
    run = tmp_path / "ft"
    lines = [json.loads(x) for x in (run / "ft-metrics.jsonl").read_text().strip().splitlines()]
    evals = {rec["step"]: rec for rec in lines if "val/acc1" in rec}
    assert sorted(evals) == [2, 4] and all("val/acc5" in r and "val/loss" in r for r in evals.values())
    assert all("train/acc1" in rec for rec in lines if "train/loss" in rec)
    best_step = read_state(run / "ckpt", which="best")["step"]
    assert evals[best_step]["val/acc1"] == max(r["val/acc1"] for r in evals.values())
    saves = sorted((run / "ckpt" / "last").iterdir())
    seen = []
    real = ttrain.create_state
    for which, step in (("last", 4), ("best", best_step)):
        def spy(model, tx, **kw):
            seen.append(type(tx).__name__)
            return real(model, tx, **kw)

        ttrain.create_state = spy
        try:
            got = ttrain.train(_classify_run(tmp_path, "run.eval_only=true", "run.resume=true",
                                             f"run.eval_which={which}"), device="cpu")
        finally:
            ttrain.create_state = real
        assert {k: got[k] for k in ("val/loss", "val/acc1", "val/acc5")} == {
            k: evals[step][k] for k in ("val/loss", "val/acc1", "val/acc5")}, which
    assert seen == ["Identity", "Identity"]
    assert sorted((run / "ckpt" / "last").iterdir()) == saves  # evaluation saves nothing
    assert metrics["val/acc1"] == evals[4]["val/acc1"]


def test_eval_only_refusals(tmp_path):
    with pytest.raises(FileNotFoundError, match="best"):
        ttrain.train(_classify_run(tmp_path, "run.eval_only=true", "run.resume=true", "run.eval_which=best"),
                     device="cpu")
    with pytest.raises(ValueError, match="eval_which"):
        ttrain.train(_classify_run(tmp_path, "run.eval_which=best"), device="cpu")
    with pytest.raises(ValueError, match="validation data"):
        ttrain.train(_classify_run(tmp_path, "run.eval_only=true", "run.synthetic_data=false",
                                   "data.valid_shards="), device="cpu")


def test_guarded_skip_keeps_the_batchnorm_statistics():
    cfg = load_config(SMOKE, ["run.mode=linear", CLASSIFY, "optim.name=lars"])
    model, enc, _ = ttrain.build_model(cfg, device="cpu")
    state = create_state(model, make_optimizer(cfg.optim, 8, num_layers=enc.layers), device="cpu")
    step = make_train_step(mode="classify", guard_nonfinite=True)
    batch = {"images": np.random.default_rng(0).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
             "labels": np.arange(8, dtype=np.int32)}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, m = step(state, batch, inject=np.array([np.nan, 1.0], np.float32))
    assert m["skipped"] == 1.0 and state.step == 1 and state.opt_state.count == 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    state, m = step(state, batch)
    assert m["skipped"] == 0.0 and not torch.equal(model.model.head.bn.running_var, before["model.head.bn.running_var"])


def test_classify_grad_accum_carries_the_labels():
    """Two micro-batches of 4 give the update of one batch of 8 (no
    BatchNorm, no mixup: the loss is a mean over rows)."""
    cfg = load_config(SMOKE, ["run.mode=finetune", CLASSIFY, "optim.name=sgd", "optim.learning_rate=0.1"])
    rng = np.random.default_rng(0)
    batch = {"images": rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
             "labels": rng.integers(0, 10, 8).astype(np.int32)}
    out = []
    for accum in (1, 2):
        model, enc, _ = ttrain.build_model(cfg, device="cpu")
        state = create_state(model, make_optimizer(cfg.optim, 8), device="cpu")
        b = batch if accum == 1 else {k: v.reshape(2, 4, *v.shape[1:]) for k, v in batch.items()}
        _, m = make_train_step(mode="classify", grad_accum=accum)(state, b)
        out.append((m, [p.detach().clone() for p in model.parameters()]))
    (m1, p1), (m2, p2) = out
    for k in ("loss", "acc1", "acc5"):
        np.testing.assert_allclose(float(m1[k]), float(m2[k]), rtol=1e-6)
    for a, b in zip(p1, p2):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_publish_dir_feeds_the_swap_watch(tmp_path, capsys):
    """Checkpoints at steps 2 and 4 of a linear probe publish
    ``publish-000000`` (the whole tree, int8) and ``publish-000001`` (only
    the head and its BatchNorm ride in it: the trunk is frozen), the
    publish tenant is billed into the run journal, and a pool serving the
    step-2 save promotes both artifacts as they are pushed."""
    import os
    import threading
    import time

    from jumbo_mae_tpu_tpu_torch.cli import predict
    from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal
    from jumbo_mae_tpu_tpu_torch.serve import publisher

    sets = ["run.mode=linear", "optim.name=lars", "model.overrides={image_size: 32, patch_size: 4, posemb: sincos2d, "
            "dtype: float32, labels: 10}", "run.training_steps=4", "run.ckpt_every=2", "run.eval_interval=100",
            "run.sanity_eval=false", f"run.output_dir={tmp_path}"]
    staged = tmp_path / "staged"
    ttrain.main(["--config", str(SMOKE), "--device", "cpu", "--set", *sets, f"run.publish_dir={staged}"])
    full, delta = (publisher.load_manifest(staged / f"publish-00000{i}") for i in range(2))
    assert full["base"] is None and full["quant"] == "int8" and full["step"] == 2
    assert delta["base"] == {"name": "publish-000000", "fingerprint": full["fingerprint"]} and delta["step"] == 4
    ridden = sorted(lp for lp, row in delta["leaves"].items() if row["where"] == "payload")
    assert ridden and all("/head/" in lp for lp in ridden) and 0 < delta["delta_fraction"] < 0.2
    for m in (full, delta):
        publisher.resolve_chain(staged / m["name"])
    journal = read_journal(tmp_path / "smoke_cpu" / "journal")
    assert [e["name"] for e in journal if e["type"] == "publish"] == ["publish-000000", "publish-000001"]
    billed = [e["requests"] for e in journal if e["type"] == "tenant_usage" and e["tenant"] == "publish"]
    assert billed[0] == 1 and billed[-1] == 2 and billed == sorted(billed)  # a row a publish, more on the interval

    watch = tmp_path / "push"
    watch.mkdir()
    pushed = threading.Event()

    def push():
        time.sleep(0.5)
        os.rename(staged / "publish-000000", watch / "publish-000000")
        time.sleep(2.0)
        os.rename(staged / "publish-000001", watch / "publish-000001")
        pushed.set()

    t = threading.Thread(target=push, daemon=True)
    t.start()
    capsys.readouterr()
    predict.main(["--config", str(SMOKE), "--set", *sets, "--ckpt", str(tmp_path / "smoke_cpu" / "ckpt" / "last" / "2"),
                  "--task", "logits", "--synthetic", "90", "--max-batch", "4", "--device", "cpu", "--serve",
                  "--replicas", "2", "--interarrival-ms", "40", "--swap-watch", str(watch), "--swap-poll-s", "0.1",
                  "--swap-canary-requests", "2", "--swap-canary-timeout-s", "5", "--out", str(tmp_path / "s.npz")])
    t.join(timeout=30)
    assert pushed.is_set()
    text = capsys.readouterr().out
    assert "swap publish-000000: verdict=promoted stage=promote" in text
    assert "swap publish-000001: verdict=promoted stage=promote" in text
    assert "pool served 90/90 ok (0 failed)" in text
