"""The port's serving warm cache (``infer/warmcache.py``) and its wiring.

- ``fingerprint`` and ``entry_name`` equal the JAX package's for the same
  specs; the default directory follows ``JUMBO_WARMCACHE`` and
  ``JUMBO_WARMCACHE_DIR`` as the JAX package's does;
- a bad magic, a digest mismatch, a truncated and an empty entry each
  quarantine and count a miss; a missing entry counts a miss;
- the quarantine's count and age cap and the main directory's byte bound
  keep the same files as the JAX package's ``WarmCache`` over identical
  directory states;
- engines on the CPU (``vit_t16`` at 32 px): where a build quantizes or
  draws the random init (no save, or a head the save lacks), a second
  engine against the same directory loads every task (``warm_hits``),
  misses nothing and serves bit-equal outputs, BatchNorm statistics
  included; a build that only copies the save's tensors keeps no entry;
  a corrupted entry is quarantined and the engine still serves equal
  outputs; a rewritten save or a swapped-in tree misses; a save committed
  after the engine was built is neither served nor cached; a restarted
  replica of a ``ReplicaSet`` loads the cache;
- ``cli.predict --warmcache DIR`` and ``--no-warmcache`` are accepted, and
  the restart probe reports hits on its second run.

Every directory lives under ``tmp_path``: an explicit path overrides the
suite's ``JUMBO_WARMCACHE=0``, as in the JAX package.
"""

import os
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.infer import warmcache as jax_wc
from jumbo_mae_tpu_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from jumbo_mae_tpu_tpu.utils import procenv
from jumbo_mae_tpu_tpu_torch.cli import predict
from jumbo_mae_tpu_tpu_torch.config import load_config
from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine
from jumbo_mae_tpu_tpu_torch.infer import warmcache as wc
from jumbo_mae_tpu_tpu_torch.obs.metrics import MetricsRegistry

REPO = Path(__file__).resolve().parent.parent
RECIPE = str(REPO / "recipes" / "smoke_cpu.yaml")
SETS = {
    "finetune": ["run.mode=finetune", "model.overrides.labels=10", "model.overrides.dtype=float32"],
    "linear": ["run.mode=linear", "model.overrides.labels=10", "model.overrides.dtype=float32"],
    "pretrain": ["model.dec_layers=1", "model.dec_dim=32", "model.dec_heads=2"],
}


def write_save(directory: Path, mode: str, *, step: int = 1, loss: float = 1.0, seed: int = 7) -> Path:
    """A port save of the smoke recipe's model in ``mode`` (random weights
    from ``seed``) at ``step``, written by the port's ``Checkpointer``
    (``best`` when ``loss`` improves on the directory's best)."""
    from jumbo_mae_tpu_tpu_torch.cli.train import build_model
    from jumbo_mae_tpu_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer
    from jumbo_mae_tpu_tpu_torch.train.optim import OptimConfig
    from jumbo_mae_tpu_tpu_torch.train.steps import create_state

    cfg = load_config(RECIPE, SETS[mode] + [f"run.init_seed={seed}"])
    model, _, _ = build_model(cfg, device="cpu")
    if mode == "linear":
        bn = model.model.head.bn
        bn.running_mean.copy_(torch.linspace(-1, 1, bn.running_mean.numel()))
        bn.running_var.copy_(torch.linspace(0.5, 2, bn.running_var.numel()))
    state = create_state(model, OptimConfig(name="lars" if mode == "linear" else "adamw"), device="cpu",
                         global_batch_size=8)
    ck = Checkpointer(CheckpointConfig(str(directory), async_save=False))
    ck.save(step, state, metrics={"val/loss": loss})
    ck.close()
    return directory


@pytest.fixture(scope="module")
def saves(tmp_path_factory):
    return {mode: write_save(tmp_path_factory.mktemp(f"save_{mode}"), mode) for mode in SETS}


def engine(saves, mode, cache, **kw):
    """An engine on ``saves[mode]`` (the random init without a save where
    ``saves`` is None)."""
    kw.setdefault("max_batch", 4)
    return InferenceEngine(load_config(RECIPE, SETS[mode]), ckpt=str(saves[mode]) if saves else "", device="cpu",
                           warm_cache=cache, registry=MetricsRegistry(), **kw)


def images(n=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def serve(eng, tasks):
    out = {}
    for task in tasks:
        got = eng.predict(images(), task=task)
        out.update({f"{task}.{k}": v for k, v in got.items()} if isinstance(got, dict) else {task: got})
    return out


def same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------------ keys


@pytest.mark.parametrize("spec", [{"a": 1, "b": [1, 2]}, {"enc": {"dim": 768, "dtype": "bfloat16"}, "x": None},
                                  {"path": Path("/x/y"), "f": 1.5}])
def test_fingerprint_and_entry_name_equal_jax(spec):
    assert wc.fingerprint(spec) == jax_wc.fingerprint(spec)
    fp = wc.fingerprint(spec)
    for task, bucket, dtype, quant in (("features:cls", 8, "bfloat16", None), ("reconstruct.enc", 64, "float32", "int8"),
                                       ("logits/x y", 0, "torch.bfloat16", None)):
        assert wc.entry_name(fp, task, bucket, dtype, quant) == jax_wc.entry_name(fp, task, bucket, dtype, quant)
    assert wc.MAGIC == jax_wc.MAGIC


def test_default_dir_follows_the_jax_switches(monkeypatch, tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("JUMBO_WARMCACHE", "0")
    assert wc.default_warmcache_dir("cpu") is None and procenv.default_warmcache_dir() is None
    monkeypatch.setenv("JUMBO_WARMCACHE", "1")
    monkeypatch.setenv("JUMBO_WARMCACHE_DIR", str(tmp_path / "x"))
    assert wc.default_warmcache_dir("cpu") == procenv.default_warmcache_dir() == str(tmp_path / "x")
    monkeypatch.delenv("JUMBO_WARMCACHE_DIR")
    d = wc.default_warmcache_dir("cpu")
    assert d.startswith(str(tmp_path / ".cache" / "jumbo_mae_tpu" / "warmcache" / "dev-"))
    assert not Path(d).exists()  # resolving the directory creates nothing
    assert "torch" in wc.device_fingerprint("cpu")


# ------------------------------------------------------------- the store


def _state():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(4, 3, generator=g), "b": torch.zeros(3, dtype=torch.bfloat16),
            "q": torch.randint(-127, 127, (2, 5), generator=g, dtype=torch.int8), "e": torch.zeros(0),
            "s": torch.tensor(2.5), "m": torch.tensor([True, False])}


def test_put_get_round_trip_and_sidecar(tmp_path):
    cache = wc.WarmCache(tmp_path, registry=MetricsRegistry())
    st = _state()
    size = cache.put("a.exe", st, meta={"build_seconds": 1.5})
    assert size == (tmp_path / "a.exe").stat().st_size > 0
    got = cache.get("a.exe")
    assert got.keys() == st.keys() and all(torch.equal(got[k], v) and got[k].dtype == v.dtype for k, v in st.items())
    assert cache.entry_meta("a.exe") == {"build_seconds": 1.5, "entry_bytes": size}
    assert cache.stats()["hits"] == 1 and cache.stats()["puts"] == 1 and cache.stats()["entries"] == 1
    assert not list(tmp_path.glob(".*.tmp"))


@pytest.mark.parametrize("damage", ["magic", "digest", "truncated", "empty", "header"])
def test_damaged_entry_quarantined_and_counted(tmp_path, damage, capsys):
    reg = MetricsRegistry()
    cache = wc.WarmCache(tmp_path, registry=reg)
    cache.put("a.exe", _state())
    blob = bytearray((tmp_path / "a.exe").read_bytes())
    if damage == "magic":
        blob[:4] = b"XXXX"
    elif damage == "digest":
        blob[len(blob) // 2] ^= 0xFF
    elif damage == "truncated":
        blob = blob[: len(blob) - 7]
    elif damage == "empty":
        blob = bytearray()
    else:  # a header naming bytes past the end, under a valid digest
        import hashlib

        blob = bytearray(wc.MAGIC + bytes(32) + (5).to_bytes(8, "little") + b'{"x":')
        blob[4:36] = hashlib.sha256(bytes(blob[36:])).digest()
    (tmp_path / "a.exe").write_bytes(bytes(blob))
    assert cache.get("a.exe") is None
    st = cache.stats()
    assert (st["misses"], st["quarantined"], st["hits"], st["entries"]) == (1, 1, 0, 0)
    assert len(list((tmp_path / "quarantine").iterdir())) == 1
    assert reg.snapshot()["infer_warmcache_events_total"] == {"put": 1.0, "quarantined": 1.0, "miss": 1.0}
    err = capsys.readouterr().err
    assert "[warmcache] quarantined corrupt entry a.exe" in err and "[warmcache] miss a.exe" in err
    assert cache.get("nothing.exe") is None and cache.stats()["misses"] == 2


def test_validate_rejects_into_quarantine(tmp_path):
    cache = wc.WarmCache(tmp_path, registry=MetricsRegistry())
    cache.put("a.exe", _state())

    def refuse(state):
        raise ValueError("does not fit")

    assert cache.get("a.exe", validate=refuse) is None
    assert cache.stats()["quarantined"] == 1 and cache.stats()["misses"] == 1


def _populate(root: Path, now: float) -> None:
    """Main-dir entries with sidecars and a tmp, and quarantined copies,
    each of its own size and age."""
    (root / "quarantine").mkdir(parents=True)
    for i in range(6):
        e = root / f"fp-t{i}-b0-float32-none.exe"
        e.write_bytes(b"x" * (100 * (i + 1)))
        (root / f"{e.name}.meta.json").write_text("{}")
        os.utime(e, (now - 1000 * i, now - 1000 * i))
    (root / ".fp.tmp").write_bytes(b"y" * 50)
    for i in range(8):
        q = root / "quarantine" / f"fp-q{i}.exe.123.abcd"
        q.write_bytes(b"z")
        age = 3600.0 * i * 10
        os.utime(q, (now - age, now - age))


@pytest.mark.parametrize("keep, age_s, max_bytes", [(3, 1e9, 0), (10, 3600.0 * 25, 0), (32, 7 * 24 * 3600.0, 1200),
                                                    (2, 3600.0 * 45, 400)])
def test_pruning_keeps_the_same_files_as_jax(tmp_path, keep, age_s, max_bytes):
    now = time.time()
    for name in ("jax", "port"):
        _populate(tmp_path / name, now)
    jax_wc.WarmCache(tmp_path / "jax", registry=JaxRegistry(), quarantine_keep=keep, quarantine_max_age_s=age_s,
                     cache_max_bytes=max_bytes)
    port = wc.WarmCache(tmp_path / "port", registry=MetricsRegistry(), quarantine_keep=keep,
                        quarantine_max_age_s=age_s, cache_max_bytes=max_bytes)

    def listing(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())

    assert listing(tmp_path / "port") == listing(tmp_path / "jax")
    assert port.disk_bytes() <= max_bytes or max_bytes == 0
    assert port.stats()["quarantine_pruned"] + len(list((tmp_path / "port" / "quarantine").iterdir())) == 8


# ---------------------------------------------------------- the engine


@pytest.mark.parametrize("mode, tasks, quant, with_save, labels", [
    ("finetune", ("features", "logits"), "int8", True, None),
    ("linear", ("logits",), "int8", True, None),
    ("finetune", ("features", "logits"), None, False, None),
    ("pretrain", ("reconstruct", "features"), None, False, None),
    ("pretrain", ("logits",), None, True, 10),  # the save has no head: its init is drawn
])
def test_second_engine_loads_every_task_bit_equal(saves, tmp_path, mode, tasks, quant, with_save, labels):
    src = saves if with_save else None
    cold = engine(src, mode, tmp_path, quant=quant, labels=labels)
    want = serve(cold, tasks)
    assert cold.warm_hits == {} and cold.warmcache.stats()["puts"] == len(tasks)
    assert {t for t in tasks} <= set(cold.build_split) and all("put_s" in cold.build_split[t] for t in tasks)
    warm = engine(src, mode, tmp_path, quant=quant, labels=labels)
    got = serve(warm, tasks)
    assert warm.warm_hits == {t: 1 for t in tasks}
    st = warm.warmcache.stats()
    assert st["misses"] == 0 and st["quarantined"] == 0 and st["puts"] == 0
    assert same(want, got)
    assert (warm.restore_s > 0) == with_save  # the save is read once, when the engine is built
    assert all("load_s" in warm.build_split[t] and "draw_s" not in warm.build_split[t] for t in tasks)
    assert warm.load_stats == cold.load_stats
    assert warm.compile_counts.keys() == cold.compile_counts.keys()  # first runs are not cached
    if quant:
        assert warm.quant_reports.keys() == cold.quant_reports.keys()
        assert warm.quant_reports[tasks[0]]["int8_bytes"] == cold.quant_reports[tasks[0]]["int8_bytes"]
    saved = warm._m_warm_saved
    assert sum(saved.labels(t).value for t in tasks) > 0


@pytest.mark.parametrize("mode, tasks", [("finetune", ("features", "logits")), ("pretrain", ("reconstruct",))])
def test_a_save_only_build_keeps_no_entry(saves, tmp_path, mode, tasks, capsys):
    """A build that only copies the save's tensors neither reads nor
    writes an entry: reading the save is the faster restart."""
    want = serve(engine(saves, mode, False), tasks)
    for _ in range(2):
        eng = engine(saves, mode, tmp_path)
        assert same(want, serve(eng, tasks))
        st = eng.warmcache.stats()
        assert (st["puts"], st["misses"], st["hits"], eng.warm_hits) == (0, 0, 0, {})
        assert all("draw_s" not in eng.build_split[t] and "put_s" not in eng.build_split[t] for t in tasks)
    assert list(tmp_path.glob("*.exe")) == [] and "[warmcache]" not in capsys.readouterr().err


def test_corrupt_entry_still_serves_equal_outputs(saves, tmp_path):
    want = serve(engine(saves, "finetune", tmp_path, quant="int8"), ("features", "logits"))
    entry = next(p for p in tmp_path.glob("*.exe") if "-features-" in p.name)
    blob = bytearray(entry.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    entry.write_bytes(bytes(blob))
    eng = engine(saves, "finetune", tmp_path, quant="int8")
    assert same(want, serve(eng, ("features", "logits")))
    st = eng.warmcache.stats()
    assert (st["quarantined"], st["misses"], st["puts"]) == (1, 1, 1) and eng.warm_hits == {"logits": 1}
    assert [p.name.startswith(entry.name) for p in (tmp_path / "quarantine").iterdir()] == [True]
    again = engine(saves, "finetune", tmp_path, quant="int8")  # the rebuilt entry serves the next restart
    assert same(want, serve(again, ("features", "logits"))) and again.warm_hits == {"features": 1, "logits": 1}


def test_rewritten_save_and_swapped_tree_miss(saves, tmp_path):
    from jumbo_mae_tpu_tpu_torch.train.checkpoint import restore_inference_state, save_digest

    src = saves["finetune"]
    copy = tmp_path / "save"
    shutil.copytree(src, copy)
    engine({"finetune": copy}, "finetune", tmp_path / "c", quant="int8").features(images())
    d0 = save_digest(copy)
    state = next(copy.rglob("state.pt"))
    os.utime(state, ns=(state.stat().st_atime_ns, state.stat().st_mtime_ns + 10**9))
    assert save_digest(copy) != d0
    eng = engine({"finetune": copy}, "finetune", tmp_path / "c", quant="int8")
    eng.features(images())
    assert eng.warm_hits == {} and eng.warmcache.stats()["puts"] == 1
    # a swapped-in tree is named by no save: its builds bypass the cache
    eng.swap_weights(*restore_inference_state(src))
    eng.logits(images())
    assert eng.warmcache.stats()["puts"] == 1 and "logits" not in eng.warm_hits


def test_a_save_committed_after_the_engine_is_not_served(saves, tmp_path):
    """The engine resolves its save's step directory once, when it is
    built: a newer ``best`` committed before the first build changes
    neither the outputs nor the entry that build writes."""
    ckpt = tmp_path / "ckpt"
    shutil.copytree(saves["finetune"], ckpt)
    ref = engine({"finetune": ckpt}, "finetune", False, quant="int8")
    want = serve(ref, ("features",))
    eng = engine({"finetune": ckpt}, "finetune", tmp_path / "c", quant="int8")
    write_save(ckpt, "finetune", step=2, loss=0.5, seed=8)  # a newer, better save of other weights
    assert same(want, serve(eng, ("features",)))
    entry = eng.warmcache.get(eng._entry_name("features"))
    live = ref.model("features").state_dict()
    assert entry.keys() == live.keys() and all(torch.equal(entry[n], live[n]) for n in live)
    newer = engine({"finetune": ckpt}, "finetune", tmp_path / "c", quant="int8")
    assert not same(want, serve(newer, ("features",))) and newer.warm_hits == {}


def test_cache_off_and_env_switch(saves, tmp_path, monkeypatch):
    assert engine(saves, "finetune", False).warmcache is None
    assert engine(saves, "finetune", None).warmcache is None
    monkeypatch.setenv("JUMBO_WARMCACHE", "0")
    eng = engine(saves, "finetune", True)
    assert eng.warmcache is None and eng.restore_s > 0  # the save is read at construction
    monkeypatch.setenv("JUMBO_WARMCACHE", "1")
    monkeypatch.setenv("JUMBO_WARMCACHE_DIR", str(tmp_path / "env"))
    assert engine(saves, "finetune", True).warmcache.root == tmp_path / "env"


def test_restarted_replica_loads_the_cache(saves, tmp_path):
    from jumbo_mae_tpu_tpu_torch.infer.replicaset import ReplicaSet

    built = []

    def provider(idx):
        eng = engine(saves, "finetune", tmp_path, quant="int8")
        eng.features(images(1))  # a replica builds its task before it serves
        built.append(eng)
        return eng

    def run(eng, batch, metas):
        if eng is built[0]:
            raise RuntimeError("replica r0 crashed")
        return eng.features(batch)

    rs = ReplicaSet(provider, run, replicas=2, max_batch=4, max_delay_ms=1.0, restart_backoff_s=0.01,
                    supervise_interval_s=0.01)
    try:
        deadline = time.monotonic() + 60
        rows = []
        while len(built) < 3:  # r0's first batch crashes it; the supervisor restarts it
            assert time.monotonic() < deadline, f"no restart: {rs.stats()}"
            rows.extend(f.result(timeout=60) for f in [rs.submit(im) for im in images(3)])
        rows.extend(f.result(timeout=60) for f in [rs.submit(im) for im in images(3)])
    finally:
        rs.close()
    assert built[0].warm_hits == {} and all(b.warm_hits == {"features": 1} for b in built[1:])
    want = built[0].features(images(3))  # the pool batches requests otherwise: equal to float32 rounding
    np.testing.assert_allclose(np.stack(rows), np.concatenate([want] * (len(rows) // 3)), rtol=1e-5, atol=1e-6)


# -------------------------------------------------- the CLI and the probe


def test_cli_predict_warmcache_flags(saves, tmp_path, capsys):
    base = ["--config", RECIPE, "--ckpt", str(saves["finetune"]), "--task", "features", "--synthetic", "3",
            "--device", "cpu", "--max-batch", "4", "--quant", "int8", "--warmup", "--set", *SETS["finetune"]]
    outs = []
    for i in range(2):
        out = predict.main(base + ["--warmcache", str(tmp_path / "wc"), "--out", str(tmp_path / f"{i}.npz")])
        outs.append(np.load(out)["features"])
        text = capsys.readouterr().out
        assert f"[predict] warmcache: {tmp_path / 'wc'}" in text
        assert f"{i} task(s) loaded from warmcache" in text
    np.testing.assert_array_equal(outs[0], outs[1])
    predict.main(base + ["--no-warmcache", "--out", str(tmp_path / "n.npz")])
    text = capsys.readouterr().out
    assert "warmcache:" not in text and "restored" in text
    assert predict.build_parser().parse_args(base + ["--no-warmcache"]).no_warmcache  # accepted


def test_probe_reports_hits_on_the_second_run(tmp_path, capsys):
    argv = ["--dir", str(tmp_path / "wc"), "--device", "cpu", "--task", "features", "logits", "--max-batch", "2",
            "--save-outputs", str(tmp_path / "o.npz"), "--set", "model.overrides.labels=10"]
    cold = wc._probe_main(argv)
    a = dict(np.load(tmp_path / "o.npz"))
    warm = wc._probe_main(argv)
    b = dict(np.load(tmp_path / "o.npz"))
    capsys.readouterr()
    assert cold["warm_hits"] == 0 and warm["warm_hits"] == 2 and warm["warmcache"]["misses"] == 0
    assert warm["captures"] == cold["captures"] == 4 and warm["hot_path_captures"] == 0
    assert same(a, b) and set(warm["build"]) == {"features", "logits"} and warm["launches"] == {"K1": 0}
