"""Serving the port's own saves: restore_inference_state and the engine
against the JAX engine, on the CPU.

Three saves of the smoke recipe at float32 are written by the port's
``Checkpointer`` (optimizer state and all): an MAE pretraining save, a
finetune save and a linear-probe save with its BatchNorm statistics.
Their weights are flax trees drawn at O(1) scale from a seeded numpy
generator; the JAX engine is given the same trees through
``swap_weights`` (the layout a JAX save of that mode restores to). The
engines then serve the same images: float32, atol/rtol 1e-4. The rest
mirrors tests/test_infer_engine.py: hot swap and rollback, first runs
per bucket, warmup and the per-thread breakdown.
"""

import threading
import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.config import load_config as jax_load_config
from jumbo_mae_tpu_tpu.infer import InferenceEngine as JaxEngine
from jumbo_mae_tpu_tpu_torch.config import load_config
from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine, OversizedBatchError
from jumbo_mae_tpu_tpu_torch.interop.from_jax import flax_path
from jumbo_mae_tpu_tpu_torch.train.checkpoint import COMMIT_FILE, STATE_FILE, restore_inference_state
from torch_port_util import port_save, port_tree, random_batch_stats, random_images, random_jumbo_params

RECIPE = Path(__file__).resolve().parent.parent / "recipes" / "smoke_cpu.yaml"
BASE = ["model.overrides.dtype=float32", "model.dec_layers=1", "model.dec_dim=32", "model.dec_heads=2",
        "model.dec_dtype=float32"]
MODES = {
    "pretrain": BASE,
    "finetune": BASE + ["run.mode=finetune", "model.overrides.labels=10"],
    "linear": BASE + ["run.mode=linear", "model.overrides.labels=10"],
}
TOL = dict(atol=1e-4, rtol=1e-4)


def images(n, seed=1):
    return random_images(np.random.default_rng(seed), n, 32)


@pytest.fixture(scope="module")
def saves(tmp_path_factory):
    """Per mode: the flax tree (and statistics), the port save's directory
    and saved state_dict, and a JAX engine serving the same tree."""
    out = {}
    for i, (mode, sets) in enumerate(MODES.items()):
        jeng = JaxEngine(jax_load_config(RECIPE, sets), max_batch=8, warm_cache=False,
                         **({"labels": 10} if mode == "pretrain" else {}))
        rng = np.random.default_rng(10 + i)
        if mode == "pretrain":
            init = jax.tree_util.tree_map(np.asarray, jeng._task("reconstruct")["variables"])
            params, stats = random_jumbo_params(init["params"], rng), None
            jeng.swap_weights(params)
        else:
            init = jax.tree_util.tree_map(np.asarray, jeng._task("logits")["variables"])
            params = random_jumbo_params(init["params"], rng)
            stats = random_batch_stats(init["batch_stats"], rng) if "batch_stats" in init else None
            # a JAX classify save restores to the ClassificationModel tree
            jeng.swap_weights({"model": params}, None if stats is None else {"model": stats})
        directory = tmp_path_factory.mktemp(f"save_{mode}")
        saved = port_save(directory, load_config(RECIPE, sets), params, stats, optim="lars" if mode == "linear" else "adamw")
        out[mode] = dict(params=params, stats=stats, dir=directory, saved=saved, jax=jeng, sets=sets)
    return out


def engine(saves, mode, **kw):
    kw.setdefault("max_batch", 8)
    return InferenceEngine(load_config(RECIPE, saves[mode]["sets"]), ckpt=str(saves[mode]["dir"]), device="cpu", **kw)


# ---------------------------------------------------------------- restore


@pytest.mark.parametrize("mode", list(MODES))
def test_restore_returns_the_saved_tensors(saves, mode):
    params, stats = restore_inference_state(saves[mode]["dir"])
    saved = saves[mode]["saved"]
    want_stats = {n for n in saved if n.endswith(("running_mean", "running_var"))}
    assert set(params) | set(stats or {}) == set(saved) and not set(params) & want_stats
    if mode == "linear":
        assert set(stats) == {"model.head.bn.running_mean", "model.head.bn.running_var"}
    else:
        assert stats is None
    for n, t in {**params, **(stats or {})}.items():
        assert torch.equal(t, saved[n]), n


def _record_offsets(path: Path) -> dict[str, tuple[int, int]]:
    """(data offset, size) of every stored record of a torch zip file."""
    out = {}
    with open(path, "rb") as f, zipfile.ZipFile(path) as z:
        for info in z.infolist():
            f.seek(info.header_offset + 26)
            name_len, extra_len = np.frombuffer(f.read(4), "<u2")
            out[info.filename] = (info.header_offset + 30 + int(name_len) + int(extra_len), info.file_size)
    return out


def test_restore_reads_no_optimizer_tensor(saves, tmp_path):
    """The optimizer's records overwritten with garbage (their bytes NaN,
    the file's size and commit unchanged): the restore still returns the
    saved model bit-equal, so it never read them. The same with the
    optimizer's slots deleted from the payload."""
    import shutil

    src = saves["linear"]["dir"]
    saved = saves["linear"]["saved"]
    for case in ("corrupt", "delete"):
        d = tmp_path / case
        shutil.copytree(src, d)
        step = d / "last" / "1"
        state = step / STATE_FILE
        if case == "corrupt":
            # records are numbered in pickling order: the model's first
            records = _record_offsets(state)
            opt_keys = [k for k in records if k.rsplit("/", 1)[-1].isdigit() and int(k.rsplit("/", 1)[-1]) >= len(saved)]
            assert opt_keys
            with open(state, "r+b") as f:
                for k in opt_keys:
                    off, size = records[k]
                    f.seek(off)
                    f.write(b"\xff" * size)
            full = torch.load(state, map_location="cpu", weights_only=True)
            assert all(torch.isnan(t).all() for t in full["opt"]["trace"]), "the corruption missed the optimizer"
            assert all(torch.equal(full["model"][n], saved[n]) for n in saved)
        else:
            payload = torch.load(state, map_location="cpu", weights_only=True)
            del payload["opt"]
            torch.save(payload, state)
            import json

            commit = json.loads((step / COMMIT_FILE).read_text())
            commit["sizes"][STATE_FILE] = state.stat().st_size
            (step / COMMIT_FILE).write_text(json.dumps(commit))
        shutil.rmtree(d / "best")  # take last/, the step written above
        params, stats = restore_inference_state(d)
        for n, t in {**params, **stats}.items():
            assert torch.equal(t, saved[n]), (case, n)


def test_restore_layouts_and_refusals(saves, tmp_path):
    """A checkpoint directory (best, then last), a slot directory and a
    step directory all restore; a .msgpack file and an Orbax directory
    raise naming A3.3; an empty directory raises FileNotFoundError."""
    d = saves["finetune"]["dir"]
    want = restore_inference_state(d)[0]
    for p in (d / "best", d / "last", d / "last" / "1"):
        got = restore_inference_state(p)[0]
        assert all(torch.equal(got[n], want[n]) for n in want)
    with pytest.raises(NotImplementedError, match="A3.3"):
        restore_inference_state(tmp_path / "params.msgpack")
    orbax = tmp_path / "orbax" / "last" / "4"
    (orbax / "state").mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="A3.3"):
        restore_inference_state(tmp_path / "orbax")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        restore_inference_state(tmp_path / "empty")


# ------------------------------------------------------------ the engine


@pytest.mark.parametrize("pool", ["cls", "gap", "tokens"])
@pytest.mark.parametrize("mode", list(MODES))
def test_features_match_jax(saves, mode, pool):
    x = images(5, seed=2)
    got = engine(saves, mode).features(x, pool=pool)
    ref = saves[mode]["jax"].features(x, pool=pool)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("mode", ["finetune", "linear"])
def test_logits_match_jax(saves, mode):
    """The logits head of a finetune save, and a linear probe's with its
    BatchNorm statistics restored bit-equal into the head."""
    eng = engine(saves, mode)
    x = images(9, seed=3)
    got = eng.logits(x)
    assert got.shape == (9, 10)
    np.testing.assert_allclose(got, saves[mode]["jax"].logits(x), **TOL)
    bn = eng.model("logits").head.bn
    if mode == "linear":
        for name in ("running_mean", "running_var"):
            assert torch.equal(getattr(bn, name), saves[mode]["saved"][f"model.head.bn.{name}"])
    else:
        assert bn is None


@pytest.mark.parametrize(
    "mode,task", [("pretrain", "features"), ("pretrain", "reconstruct"), ("finetune", "features"),
                  ("finetune", "logits"), ("linear", "features"), ("linear", "logits")],
)
def test_load_stats_match_jax(saves, mode, task):
    """The graft's lists (loaded, resized, skipped, unused), mapped to
    flax paths, equal the JAX engine's for the same tree."""
    eng = engine(saves, mode, labels=10)
    jeng = saves[mode]["jax"]
    x = images(2, seed=4)
    eng.predict(x, task=task)
    jeng.predict(x, task=task)
    for key in ("loaded", "resized", "skipped", "unused"):
        got = sorted(flax_path(n) for n in eng.load_stats[task][key])
        assert got == sorted(tuple(p) for p in jeng.load_stats[task][key]), key
    assert eng.load_stats[task]["loaded"]


def test_head_for_another_label_count_kept_fresh(saves):
    """A 7-way head on a 10-way save: the trunk loads, the head keeps the
    fresh init of run.init_seed (a shape mismatch, as in JAX)."""
    eng = engine(saves, "finetune", labels=7)
    fresh = InferenceEngine(load_config(RECIPE, MODES["finetune"]), labels=7, max_batch=8, device="cpu")
    x = images(3, seed=5)
    np.testing.assert_allclose(eng.features(x), saves["finetune"]["jax"].features(x), **TOL)
    assert eng.logits(x).shape == (3, 7)
    assert sorted(eng.load_stats["logits"]["skipped"]) == ["head.fc.bias", "head.fc.weight"]
    for name, p in eng.model("logits").head.named_parameters():
        assert torch.equal(p, dict(fresh.model("logits").head.named_parameters())[name]), name


def test_unrelated_save_refused(tmp_path):
    """A save whose names fit no task loads 0 params and is refused."""
    from jumbo_mae_tpu_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer
    from jumbo_mae_tpu_tpu_torch.train.optim import OptimConfig
    from jumbo_mae_tpu_tpu_torch.train.steps import create_state

    state = create_state(torch.nn.Sequential(torch.nn.Linear(2, 3)), OptimConfig(), device="cpu", global_batch_size=8)
    Checkpointer(CheckpointConfig(str(tmp_path), async_save=False)).save(1, state)
    eng = InferenceEngine(load_config(RECIPE, MODES["finetune"]), ckpt=str(tmp_path), max_batch=4, device="cpu")
    for task in ("features", "logits", "reconstruct"):
        with pytest.raises(SystemExit, match="0 params"):
            eng.predict(images(1), task=task)


# --------------------------------------------------------------- hot swap


def test_swap_weights_and_restore_snapshot(saves):
    """A swap serves the new tree exactly as an engine restored from it;
    the snapshot rolls back bit for bit; a task first built after the
    swap rebuilds from the restored tree."""
    x = images(4, seed=6)
    eng = engine(saves, "finetune")
    old = eng.features(x)
    other = engine(saves, "linear")
    new_params, new_stats = restore_inference_state(saves["linear"]["dir"])
    snap = eng.swap_weights(new_params, new_stats, ckpt=str(saves["linear"]["dir"]))
    assert np.array_equal(eng.features(x), other.features(x))
    assert not np.allclose(eng.features(x), old)
    after_swap = eng.logits(x)  # built after the swap, from the new tree
    eng.restore_snapshot(snap)
    assert np.array_equal(eng.features(x), old)
    assert "logits" not in eng.load_stats  # dropped with the task, to rebuild
    assert not np.allclose(eng.logits(x), after_swap) and "logits" in eng.load_stats
    np.testing.assert_allclose(eng.logits(x), saves["finetune"]["jax"].logits(x), **TOL)


def test_failed_swap_keeps_live_weights(saves):
    eng = engine(saves, "finetune")
    x = images(2, seed=7)
    before = eng.features(x)
    model = eng.model("features")
    with pytest.raises(SystemExit, match="0 params"):
        eng.swap_weights({"other.weight": torch.ones(2, 2)})
    assert eng.model("features") is model and np.array_equal(eng.features(x), before)


def test_swap_is_atomic_per_request(saves):
    """Requests racing a swap each serve entirely old or entirely new
    weights. The swap writes the new values into the live model's own
    storage (a captured CUDA graph reads those addresses), under the
    engine's replay lock: the model object stays, and holds the new
    weights after the last swap."""
    x = images(8, seed=8)
    eng = engine(saves, "finetune")
    old = eng.features(x)
    params, stats = restore_inference_state(saves["linear"]["dir"])
    new = engine(saves, "linear").features(x)
    live = {n: p.clone() for n, p in eng.model("features").named_parameters()}
    live_model = eng.model("features")
    seen, stop = [], threading.Event()

    def client():
        while not stop.is_set():
            seen.append(eng.features(x))

    threads = [threading.Thread(target=client) for _ in range(2)]
    for t in threads:
        t.start()
    for i in range(3):
        snap = eng.swap_weights(params, stats)
        eng.restore_snapshot(snap) if i < 2 else None
    stop.set()
    for t in threads:
        t.join()
    assert seen and all(np.array_equal(s, old) or np.array_equal(s, new) for s in seen)
    assert eng.model("features") is live_model
    assert not all(torch.equal(p, live[n]) for n, p in live_model.named_parameters())
    assert np.array_equal(eng.features(x), new)


def test_swap_clears_the_encoder_cache(saves):
    eng = engine(saves, "pretrain", encoder_cache=8)
    eng.reconstruct(images(2, seed=9))
    assert eng.encoder_cache_stats()["size"] == 2
    eng.swap_weights(*restore_inference_state(saves["pretrain"]["dir"]))
    assert eng.encoder_cache_stats()["size"] == 0 and eng.encoder_cache_bytes() == 0


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("rollback", [False, True], ids=["swap_weights", "restore_snapshot"])
def test_cached_reconstruct_racing_a_swap_serves_one_tree(saves, monkeypatch, rollback):
    """A cached ``reconstruct`` that runs while a swap (or its rollback)
    clears the encoder-output LRU serves entirely old or entirely new
    weights: the clear happens under the replay lock, so the request
    cannot decode encoder rows of one tree with the decoder of the other.
    The reconstruct is started from inside the clear, on another thread."""
    x = images(2, seed=11)
    old_tree, _ = restore_inference_state(saves["pretrain"]["dir"])
    new_tree = {n: -0.5 * t + 0.1 if t.is_floating_point() else t for n, t in old_tree.items()}
    want_old = engine(saves, "pretrain").reconstruct(x)
    fresh = engine(saves, "pretrain")
    fresh.swap_weights(new_tree)
    want_new = fresh.reconstruct(x)
    assert not np.array_equal(want_old["reconstruction"], want_new["reconstruction"])
    eng = engine(saves, "pretrain", encoder_cache=8)
    if rollback:
        snap = eng.swap_weights(new_tree)
    eng.reconstruct(x)  # the cache now holds the live tree's encoder rows
    assert eng.encoder_cache_stats()["size"] == 2
    real = InferenceEngine._clear_encoder_cache
    raced: dict = {}

    def racing_clear(self):
        t = threading.Thread(target=lambda: raced.update(out=self.reconstruct(x)))
        t.start()
        t.join(timeout=0.5)  # a reconstruct free to run finishes well within this
        raced["thread"] = t
        real(self)

    monkeypatch.setattr(InferenceEngine, "_clear_encoder_cache", racing_clear)
    if rollback:
        eng.restore_snapshot(snap)
    else:
        eng.swap_weights(new_tree)
    raced["thread"].join(timeout=60)
    got = raced["out"]
    assert _same(got, want_new if not rollback else want_old) or _same(got, want_old if not rollback else want_new)
    assert _same(eng.reconstruct(x), want_old if rollback else want_new)


# ----------------------------------------------- first runs and warmup


def test_first_run_counted_once_per_bucket(saves):
    eng = engine(saves, "finetune")
    for n in (3, 4, 2, 4, 3, 8, 5, 1, 7):
        eng.features(images(n, seed=n))
    # buckets hit: 4, 4, 2, 4, 4, 8, 8, 1, 8 → {1, 2, 4, 8} once each
    assert sorted(b for _, b in eng.compile_counts) == [1, 2, 4, 8]
    assert all(c == 1 for c in eng.compile_counts.values())
    eng.features(images(6))
    assert sum(eng.compile_counts.values()) == 4


def test_chunking_matches_direct(saves):
    eng = engine(saves, "finetune")
    x = images(19, seed=3)  # 8 + 8 + 3 under max_batch=8
    out = eng.features(x)
    assert out.shape[0] == 19
    np.testing.assert_array_equal(out[:8], eng.features(x[:8]))
    np.testing.assert_array_equal(out[16:], eng.features(x[16:]))


def test_logits_and_reconstruct_tasks(saves):
    eng = engine(saves, "pretrain", max_batch=4, labels=11)
    x = images(5, seed=4)
    lg = eng.logits(x)  # 5 > max_batch: chunks of 4 + 1
    assert lg.shape == (5, 11) and np.isfinite(lg).all()
    out = eng.reconstruct(x[:3], seed=0)
    assert out["reconstruction"].shape == (3, 64, 4 * 4 * 3) and out["mask"].shape == (3, 64)
    assert (out["mask"].sum(1) == 48).all()
    np.testing.assert_array_equal(out["mask"], eng.reconstruct(x[:3], seed=0)["mask"])
    assert not np.array_equal(out["mask"], eng.reconstruct(x[:3], seed=1)["mask"])
    assert eng.compile_counts[("reconstruct", 4)] == 1


def test_engine_rejects_bad_inputs(saves):
    eng = engine(saves, "finetune")
    with pytest.raises(ValueError, match="resize upstream"):
        eng.features(random_images(np.random.default_rng(0), 2, 16))
    with pytest.raises(ValueError, match="pool"):
        eng.features(images(2), pool="bogus")
    with pytest.raises(ValueError, match="unknown task"):
        eng.predict(images(2), task="bogus")
    with pytest.raises(ValueError, match="quant"):
        engine(saves, "finetune", quant="int4")
    with pytest.raises(ValueError, match="max_batch"):
        engine(saves, "finetune", max_batch=0)
    cfg = load_config(RECIPE, MODES["pretrain"])
    with pytest.raises(ValueError, match="label count"):
        InferenceEngine(cfg, max_batch=2, device="cpu").logits(images(1))


def test_labels_follow_the_recipe():
    """labels=, else model.overrides.labels, else the preset's count for a
    classify recipe (what cli.train builds), none for a pretrain one."""
    def labels(sets, **kw):
        return InferenceEngine(load_config(RECIPE, sets), device="cpu", **kw)._labels

    assert labels(MODES["finetune"]) == 10 and labels(MODES["finetune"], labels=3) == 3
    assert labels(BASE + ["run.mode=finetune"]) == 1000 and labels(BASE) is None
    assert InferenceEngine(load_config(RECIPE, MODES["linear"]), device="cpu")._batch_norm


def test_warmup_first_does_not_deadlock(saves):
    eng = engine(saves, "finetune", max_batch=2)
    assert eng.warmup(("features",), buckets=(1, 2)) == 2
    assert eng.warmup(("features",), buckets=(1, 2)) == 0
    assert eng.warmup_s > 0


def test_warmup_parallel_runs_each_bucket_exactly_once(saves):
    eng = engine(saves, "pretrain", encoder_cache=4)
    n = eng.warmup(("features", "reconstruct"), workers=4)
    # features at 1, 2, 4, 8 and the cached reconstruction's two halves
    assert n == 12 and all(c == 1 for c in eng.compile_counts.values())
    assert {k for k, _ in eng.compile_counts} == {"features:cls", "reconstruct.enc", "reconstruct.dec"}
    out = eng.features(images(5, seed=11))
    assert out.shape[0] == 5 and sum(eng.compile_counts.values()) == 12


def test_warmup_rejects_oversized_bucket(saves):
    with pytest.raises(OversizedBatchError):
        engine(saves, "finetune", max_batch=4).warmup(("features",), buckets=(8,))


def test_last_breakdown_thread_local(saves):
    eng = engine(saves, "finetune")
    eng.features(images(5, seed=9))  # bucket 8, 3 pad rows
    bd = eng.last_breakdown()
    assert bd["bucket"] == 8 and bd["pad_fraction"] == pytest.approx(3 / 8)
    assert bd["compute_s"] > 0.0 and bd["fetch_s"] >= 0.0
    seen = {}
    t = threading.Thread(target=lambda: seen.update(bd=eng.last_breakdown()))
    t.start()
    t.join()
    assert seen["bd"] is None


def test_swap_weights_takes_a_flax_tree_through_the_bridge(saves):
    """The same tree handed over as a flax tree (through interop) serves
    what the save serves."""
    x = images(3, seed=12)
    eng = InferenceEngine(load_config(RECIPE, MODES["linear"]), max_batch=8, device="cpu")
    eng.swap_weights(*port_tree(saves["linear"]["params"], saves["linear"]["stats"]))
    np.testing.assert_array_equal(eng.logits(x), engine(saves, "linear").logits(x))


def test_init_draws_only_when_something_keeps_them(saves, monkeypatch):
    """A save that covers every parameter skips the random init (the
    result is the same); a fresh head draws it, so the head equals a
    fresh engine's."""
    from jumbo_mae_tpu_tpu_torch.models.vit import JumboViT

    calls = []
    real = JumboViT._init_weights
    monkeypatch.setattr(JumboViT, "_init_weights", lambda self, g: (calls.append(1), real(self, g))[1])
    x = images(3, seed=13)
    full = engine(saves, "finetune")
    full.logits(x)
    assert calls == []
    np.testing.assert_allclose(full.logits(x), saves["finetune"]["jax"].logits(x), **TOL)
    engine(saves, "finetune", labels=7).logits(x)
    assert calls == [1]
