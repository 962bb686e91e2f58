"""The port's gated weights publisher (``serve/publisher.py``) against the
JAX package's, on the CPU:

- a seeded numpy flax tree goes through three publishes with
  ``full_every=2``, a subset of leaves changed between them, in int8 and
  in float32: the leaf digests, the chain links, which leaves ride in
  each artifact, the quantization report and the tree fingerprint equal
  JAX's, and ``resolve_chain`` returns JAX's dequantized tree bit for bit;
- the gates decide as JAX's over a scripted sequence;
- a port model published from its ``RunEngine`` checkpoint hook
  fingerprints as the JAX publisher does the same weights (the flax
  bridge's inverse round-trips the JAX init tree exactly);
- ``verify_artifact`` rejects a flipped byte, a torn payload and a torn
  manifest, ``resolve_chain`` a missing base, and the payload is read
  without pickle;
- a ``publish.export``-corrupted artifact pushed into ``cli.predict
  --swap-watch`` is quarantined before any restore while a good one is
  promoted (the port's own contract: the JAX test of it fails on this
  tree, ROADMAP C.R 1).
"""

import os
import shutil
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from jumbo_mae_tpu_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from jumbo_mae_tpu_tpu.serve import publisher as jpub
from jumbo_mae_tpu_tpu_torch import faults
from jumbo_mae_tpu_tpu_torch.cli import predict
from jumbo_mae_tpu_tpu_torch.cli.train import build_model
from jumbo_mae_tpu_tpu_torch.config import load_config
from jumbo_mae_tpu_tpu_torch.interop.from_jax import model_flax_tree, state_dict_from_flax
from jumbo_mae_tpu_tpu_torch.obs.metrics import MetricsRegistry
from jumbo_mae_tpu_tpu_torch.serve import publisher as ppub
from jumbo_mae_tpu_tpu_torch.tools import publish_doctor
from torch_port_util import port_save

RECIPE = Path(__file__).resolve().parent.parent / "recipes" / "smoke_cpu.yaml"
CLASSIFY = ["model.overrides.dtype=float32", "run.mode=finetune", "model.overrides.labels=10"]


def seeded_tree(rng: np.random.Generator) -> tuple[dict, dict]:
    """A flax-layout tree: q/k/v and out kernels, dense and conv kernels
    (one with a zero output channel), biases, norms, tokens, BatchNorm
    statistics."""
    d, h, hd = 8, 2, 4

    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)

    block = {"attn": {n: {"kernel": arr(d, h, hd), "bias": arr(h, hd)} for n in ("q", "k", "v")},
             "ln1": {"scale": arr(d), "bias": arr(d)}, "mlp": {"fc1": {"kernel": arr(d, 16), "bias": arr(16)},
                                                               "fc2": {"kernel": arr(16, d), "bias": arr(d)}}}
    block["attn"]["out"] = {"kernel": arr(h, hd, d), "bias": arr(d)}
    proj = arr(4, 4, 3, d)
    proj[..., 3] = 0.0  # a zero channel: scale 1, exact zeros
    params = {"model": {"cls_tokens": arr(1, 3, d), "embed": {"proj": {"kernel": proj, "bias": arr(d)}},
                        "block_0": block}}
    params["model"]["block_1"] = {**block, "mlp": {"fc1": {"kernel": arr(d, 16), "bias": arr(16)},
                                                   "fc2": {"kernel": arr(16, d), "bias": arr(d)}}}
    params["model"]["head"] = {"fc": {"kernel": arr(3 * d, 10), "bias": arr(10)},
                               "bn": {"scale": arr(3 * d), "bias": arr(3 * d)}}
    stats = {"model": {"head": {"bn": {"mean": arr(3 * d), "var": np.abs(arr(3 * d)) + 0.5}}}}
    return params, stats


def perturb(tree: dict, rng: np.random.Generator, paths: list[tuple]) -> dict:
    out = _copy(tree)
    for path in paths:
        node = out
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = node[path[-1]] + rng.normal(size=node[path[-1]].shape).astype(np.float32)
    return out


def _copy(node):
    return {k: _copy(v) for k, v in node.items()} if isinstance(node, dict) else np.array(node)


def manifest_core(m: dict) -> dict:
    """Everything but the payload container (msgpack in JAX, npz here)."""
    return {k: v for k, v in m.items() if k != "payload"}


@pytest.mark.parametrize("quant", ["int8", "none"])
def test_three_publishes_equal_jax(tmp_path, quant):
    rng = np.random.default_rng(0)
    params, stats = seeded_tree(rng)
    trees = [params,
             perturb(params, rng, [("model", "block_0", "mlp", "fc1", "kernel"), ("model", "head", "fc", "bias")]),
             None]
    trees[2] = perturb(trees[1], rng, [("model", "block_1", "attn", "q", "kernel")])
    port = ppub.CheckpointPublisher(tmp_path / "port", quant=quant, full_every=2, registry=MetricsRegistry())
    ref = jpub.CheckpointPublisher(tmp_path / "jax", quant=quant, full_every=2, registry=JaxRegistry())
    for step, tree in zip((10, 20, 30), trees):
        metrics = {"val/loss": 1.0 / step}
        p = port.publish(step, tree, batch_stats=stats, metrics=metrics)
        j = ref.publish(step, tree, batch_stats=stats, metrics=metrics)
        pm, jm = ppub.load_manifest(p), jpub.load_manifest(j)
        assert manifest_core(pm) == manifest_core(jm)
        got, got_stats, _ = ppub.resolve_chain(p)
        want, want_stats, _ = jpub.resolve_chain(j)
        for a, b in ((got, want), (got_stats, want_stats)):
            fa, fb = {}, {}
            ppub._flatten(a, "", fa)
            ppub._flatten(b, "", fb)
            assert fa.keys() == fb.keys()
            for k in fa:
                assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k
    chain = [ppub.load_manifest(tmp_path / "port" / f"publish-00000{i}") for i in range(3)]
    assert [m["base"] and m["base"]["name"] for m in chain] == [None, "publish-000000", None]
    ridden = {lp for lp, row in chain[1]["leaves"].items() if row["where"] == "payload"}
    assert ridden == {"params/model/block_0/mlp/fc1/kernel", "params/model/head/fc/bias"}
    assert ppub.latest_artifact(tmp_path / "port").name == "publish-000002"
    # a restarted publisher continues the chain from the newest artifact
    again = ppub.CheckpointPublisher(tmp_path / "port", quant=quant, full_every=2, registry=MetricsRegistry())
    m = ppub.load_manifest(again.publish(40, trees[2], batch_stats=stats))
    assert m["name"] == "publish-000003" and m["base"]["name"] == "publish-000002" and m["delta_fraction"] == 0.0


def test_gates_decide_as_jax(tmp_path):
    kw = dict(min_interval_steps=3, metric_key="val/acc1", metric_floor=0.5, metric_sense="above")
    port = ppub.CheckpointPublisher(tmp_path / "p", registry=MetricsRegistry(), **kw)
    ref = jpub.CheckpointPublisher(tmp_path / "j", registry=JaxRegistry(), **kw)
    rng = np.random.default_rng(3)
    for step in range(1, 40):
        metrics = rng.choice([None, {"val/acc1": float(rng.uniform(0, 1))}, {"val/acc1": float("nan")}, {}])
        bad, rolled = int(rng.random() < 0.2), bool(rng.random() < 0.1)
        got, want = port._gate(step, metrics, bad, rolled), ref._gate(step, metrics, bad, rolled)
        assert got == want
        if got is None:
            port._last_published_step = ref._last_published_step = step
    with pytest.raises(ValueError):
        ppub.CheckpointPublisher(tmp_path / "x", quant="fp8", registry=MetricsRegistry())


def test_a_port_model_fingerprints_as_jax(tmp_path):
    """Published from the engine's checkpoint hook: the same fingerprint
    and digests as the JAX publisher's export of the same weights, the
    resolved tree back to the model's own state_dict exactly (float32),
    and the publish tenant billed into the journal."""
    cfg = load_config(RECIPE, CLASSIFY + ["run.mode=linear"])
    model, _, _ = build_model(cfg, device="cpu")
    events = []
    port = ppub.CheckpointPublisher(tmp_path / "p", quant="none", registry=MetricsRegistry(),
                                    emit=lambda etype, **f: events.append((etype, f)))

    class Engine:
        def __init__(self):
            self.hooks = {}
            self.state = SimpleNamespace(model=model)

        def __getattr__(self, name):
            return lambda fn: self.hooks.setdefault(name, fn)

    eng = Engine()
    port.register(eng)
    eng.hooks["on_log_window"](eng, SimpleNamespace(bad_steps=[]))
    eng.hooks["on_checkpoint"](eng, SimpleNamespace(step=5, metrics={"val/loss": 0.5}, reason="interval"))
    eng.hooks["on_checkpoint"](eng, SimpleNamespace(step=6, metrics=None, reason="preemption"))  # never published
    params, stats = model_flax_tree(model)
    ref = jpub.CheckpointPublisher(tmp_path / "j", quant="none", registry=JaxRegistry())
    jm = jpub.load_manifest(ref.publish(5, params, batch_stats=stats, metrics={"val/loss": 0.5}))
    pm = ppub.load_manifest(tmp_path / "p" / "publish-000000")
    assert manifest_core(pm) == manifest_core(jm) and not (tmp_path / "p" / "publish-000001").exists()
    got = state_dict_from_flax(*ppub.resolve_chain(tmp_path / "p" / "publish-000000")[:2])
    sd = model.state_dict()
    assert got.keys() == sd.keys() and all(np.array_equal(got[k].numpy(), sd[k].numpy()) for k in sd)
    types = [e[0] for e in events]
    assert types == ["tenant_usage", "publish"] and events[0][1]["tenant"] == "publish"


def test_bridge_inverse_round_trips_the_jax_init_tree():
    import jax

    from jumbo_mae_tpu_tpu.config import load_config as jax_load_config
    from jumbo_mae_tpu_tpu.infer import InferenceEngine as JaxEngine

    jeng = JaxEngine(jax_load_config(RECIPE, CLASSIFY), max_batch=2, warm_cache=False)
    for task in ("logits", "reconstruct"):
        variables = jeng._task(task)["variables"]
        tree = jax.tree_util.tree_map(np.asarray, variables["params"])
        params = {"model": tree} if task == "logits" else tree
        cfg = load_config(RECIPE, CLASSIFY if task == "logits" else ["model.overrides.dtype=float32"])
        model, _, _ = build_model(cfg, device="cpu")
        model.load_state_dict(state_dict_from_flax(params))
        back, _ = model_flax_tree(model)
        fa, fb = {}, {}
        ppub._flatten(back, "", fa)
        ppub._flatten(params, "", fb)
        assert fa.keys() == fb.keys()
        assert all(fa[k].shape == fb[k].shape and np.array_equal(fa[k], fb[k]) for k in fa)


def test_verification_rejects_damage(tmp_path):
    rng = np.random.default_rng(1)
    params, stats = seeded_tree(rng)
    pub = ppub.CheckpointPublisher(tmp_path / "d", full_every=4, registry=MetricsRegistry())
    a = pub.publish(1, params, batch_stats=stats)
    b = pub.publish(2, perturb(params, rng, [("model", "cls_tokens")]), batch_stats=stats)
    assert ppub.load_manifest(b)["base"]["name"] == a.name
    for path in (a, b):
        ppub.verify_artifact(path)
        ppub.resolve_chain(path)
    assert publish_doctor.main([str(tmp_path / "d")]) == 0

    def damaged(name: str) -> Path:
        dst = tmp_path / "bad" / name
        shutil.rmtree(dst.parent, ignore_errors=True)
        shutil.copytree(tmp_path / "d", dst.parent)
        return dst

    art = damaged(a.name)
    raw = bytearray((art / ppub.PAYLOAD).read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    (art / ppub.PAYLOAD).write_bytes(bytes(raw))
    with pytest.raises(ppub.PublishIntegrityError, match="sha256 mismatch"):
        ppub.verify_artifact(art)
    with pytest.raises(ppub.PublishIntegrityError):  # the delta's base is the damaged link
        ppub.resolve_chain(art.parent / b.name)
    assert publish_doctor.main([str(art.parent)]) == 2
    art = damaged(a.name)
    (art / ppub.PAYLOAD).write_bytes((art / ppub.PAYLOAD).read_bytes()[:-7])
    with pytest.raises(ppub.PublishIntegrityError, match="torn payload"):
        ppub.verify_artifact(art)
    art = damaged(b.name)
    (art / ppub.MANIFEST).write_text((art / ppub.MANIFEST).read_text()[:100])
    with pytest.raises(ppub.PublishIntegrityError, match="unreadable manifest"):
        ppub.verify_artifact(art)
    art = damaged(b.name)
    shutil.rmtree(art.parent / a.name)
    with pytest.raises(ppub.PublishIntegrityError, match="missing"):
        ppub.resolve_chain(art)
    with np.load(a / ppub.PAYLOAD, allow_pickle=False) as z:  # readable without pickle
        assert all(name.count("::") == 1 for name in z.files)


def test_export_corruption_is_quarantined_by_the_swap_watch(tmp_path, capsys):
    """A good artifact and a ``publish.export``-corrupted one pushed into
    the watched directory mid-stream: the first promotes, the second is
    moved to ``.quarantine/`` before any restore, and every request is
    served."""
    cfg = load_config(RECIPE, CLASSIFY)
    model, _, _ = build_model(cfg, device="cpu")
    params, stats = model_flax_tree(model)
    save = tmp_path / "save"
    port_save(save, cfg, params["model"])
    staged = tmp_path / "staged"
    ppub.CheckpointPublisher(staged, registry=MetricsRegistry()).publish(1, params)
    faults.install_plan("publish.export:corrupt(6)")
    try:
        ppub.CheckpointPublisher(staged, registry=MetricsRegistry()).publish(2, params)
    finally:
        faults.clear_plan()
    with pytest.raises(ppub.PublishIntegrityError):
        ppub.verify_artifact(staged / "publish-000001")
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
    from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry

    before = get_registry().counter("serve_publish_quarantined_total").value
    predict.main(["--config", str(RECIPE), "--set", *CLASSIFY, "--ckpt", str(save), "--task", "logits",
                  "--synthetic", "90", "--max-batch", "4", "--device", "cpu", "--serve", "--replicas", "2",
                  "--interarrival-ms", "40", "--swap-watch", str(watch), "--swap-poll-s", "0.1",
                  "--swap-canary-requests", "2", "--swap-canary-timeout-s", "5", "--out", str(tmp_path / "s.npz")])
    t.join(timeout=30)
    assert pushed.is_set()
    text = capsys.readouterr().out
    assert "swap publish-000000: verdict=promoted stage=promote" in text
    assert "swap publish-000001: verdict=quarantined stage=verify" in text
    assert "pool served 90/90 ok (0 failed)" in text
    assert (watch / ".quarantine" / "publish-000001").is_dir() and not (watch / "publish-000001").exists()
    assert get_registry().counter("serve_publish_quarantined_total").value == before + 1
    assert publish_doctor.main([str(watch)]) == 0  # quarantine working is health
