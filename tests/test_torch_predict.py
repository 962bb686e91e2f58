"""The port's ``cli.predict`` against the JAX package's, on the CPU.

Both CLIs serve the same weights (flax trees at O(1) scale from a seeded
numpy generator: a ``.msgpack`` for the JAX CLI, a port ``Checkpointer``
save for the port's) on the same PNG files, which every decoder reads
exactly (a JPEG can differ by an LSB between cv2 and PIL), through the
smoke recipe at ``--dtype float32``: every task's ``.npz`` within atol /
rtol 1e-4. The reconstruction's mask is pinned to the JAX CLI's (see
tests/test_torch_reconstruct.py). Then ``--serve`` against the direct
path, an undecodable file, and the telemetry flags that were refused
before they were ported. Then the replicated tier with tenants, the
autoscaler and the access log; the exporter, the SLO tracker and the
capture sentinel around a 2-replica pool, scraped over loopback during
``--metrics-hold-s``, serving logits bit-equal to a run without them;
and the single engine's access log.
"""

import json
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.cli.predict import main as jax_main
from jumbo_mae_tpu_tpu.config import load_config as jax_load_config
from jumbo_mae_tpu_tpu.infer import InferenceEngine as JaxEngine
from jumbo_mae_tpu_tpu.train.checkpoint import export_params_msgpack
from jumbo_mae_tpu_tpu_torch.cli import predict
from jumbo_mae_tpu_tpu_torch.config import load_config
from jumbo_mae_tpu_tpu_torch.infer import engine as engine_mod
from torch_port_util import port_save, random_jumbo_params

RECIPE = Path(__file__).resolve().parent.parent / "recipes" / "smoke_cpu.yaml"
BASE = ["model.overrides.dtype=float32", "model.dec_layers=1", "model.dec_dim=32", "model.dec_heads=2",
        "model.dec_dtype=float32"]
CLASSIFY = BASE + ["run.mode=finetune", "model.overrides.labels=10"]
TOL = dict(atol=1e-4, rtol=1e-4)
SHAPES = [(40, 50), (64, 48), (32, 32)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("predict")
    rng = np.random.default_rng(0)
    files = []
    for i, (h, w) in enumerate(SHAPES):
        f = root / f"im{i}.png"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(f)
        files.append(str(f))
    out = {"files": files, "root": root}
    jeng = JaxEngine(jax_load_config(RECIPE, CLASSIFY), max_batch=4, warm_cache=False)
    for kind, task, sets in (("classify", "logits", CLASSIFY), ("mae", "reconstruct", BASE)):
        init = jax.tree_util.tree_map(np.asarray, jeng._task(task)["variables"]["params"])
        params = random_jumbo_params(init, np.random.default_rng(7))
        msgpack = root / f"{kind}.msgpack"
        export_params_msgpack({"model": params} if kind == "classify" else params, str(msgpack))
        port_save(root / kind, load_config(RECIPE, sets), params)
        out[kind] = {"msgpack": str(msgpack), "save": str(root / kind), "sets": sets, "params": params}
    return out


def _args(setup, kind, task, out, *, jax_side=False, extra=()):
    ck = setup[kind]
    return ["--config", str(RECIPE), "--ckpt", ck["msgpack"] if jax_side else ck["save"], "--task", task,
            "--images", *setup["files"], "--max-batch", "4", "--dtype", "float32", "--out", str(out),
            *(["--no-warmcache"] if jax_side else ["--device", "cpu"]), *extra, "--set", *ck["sets"]]


@pytest.mark.parametrize(
    "kind,task,extra",
    [("classify", "logits", ()), ("classify", "features", ("--pool", "gap")), ("mae", "features", ("--pool", "cls")),
     ("mae", "features", ("--pool", "tokens")), ("mae", "reconstruct", ("--seed", "3")),
     ("mae", "reconstruct", ("--seed", "3", "--encoder-cache", "4"))],
)
def test_cli_matches_jax(setup, tmp_path, monkeypatch, kind, task, extra):
    jax_extra = tuple(a for a in extra if a not in ("--encoder-cache", "4"))
    ref = np.load(jax_main(_args(setup, kind, task, tmp_path / "jax.npz", jax_side=True, extra=jax_extra)))
    if task == "reconstruct":
        noise = torch.from_numpy(ref["mask"][0] + np.arange(64, dtype=np.float32) / 64 * 1e-3)
        monkeypatch.setattr(engine_mod, "reconstruct_noise", lambda seed, n: noise.clone())
    got = np.load(predict.main(_args(setup, kind, task, tmp_path / "port.npz", extra=extra)))
    assert sorted(got.files) == sorted(ref.files)
    for key in ref.files:
        assert got[key].shape == ref[key].shape and got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], ref[key], **TOL)


def test_cli_prints_one_json_line_per_image(setup, tmp_path, capsys):
    predict.main(_args(setup, "classify", "logits", tmp_path / "l.npz", extra=("--topk", "3")))
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [ln["image"] for ln in lines] == setup["files"]
    logits = np.load(tmp_path / "l.npz")["logits"]
    for ln, row in zip(lines, logits):
        assert ln["classes"] == np.argsort(-row)[:3].tolist() and len(ln["probs"]) == 3
        assert ln["probs"] == sorted(ln["probs"], reverse=True)


@pytest.mark.parametrize("task", ["features", "reconstruct"])
def test_serve_equals_direct(setup, tmp_path, capsys, task):
    kind = "mae"
    direct = np.load(predict.main(_args(setup, kind, task, tmp_path / "d.npz")))
    served = np.load(predict.main(_args(setup, kind, task, tmp_path / "s.npz",
                                        extra=("--serve", "--max-delay-ms", "20", "--max-queue", "8"))))
    assert "micro-batch sizes" in capsys.readouterr().out
    for key in direct.files:
        np.testing.assert_allclose(served[key], direct[key], rtol=1e-5, atol=1e-5)


def test_warmup_quant_and_synthetic(setup, tmp_path, capsys):
    out = predict.main(["--config", str(RECIPE), "--set", *BASE, "--ckpt", setup["mae"]["save"], "--task", "features",
                        "--synthetic", "5", "--max-batch", "4", "--warmup", "--quant", "int8", "--device", "cpu",
                        "--out", str(tmp_path / "q.npz")])
    text = capsys.readouterr().out
    assert "warmup: 3 first run(s)" in text and "restored" in text
    assert np.load(out)["features"].shape == (5, 3 * 64)


def test_undecodable_file_raises_with_its_name(setup, tmp_path):
    bad = tmp_path / "broken.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n not an image")
    args = _args(setup, "classify", "logits", tmp_path / "x.npz")
    args[args.index("--images") + 1] = str(bad)
    with pytest.raises(ValueError, match="broken.png"):
        predict.main(args)


def test_images_xor_synthetic(setup):
    with pytest.raises(SystemExit):
        predict.main(["--config", str(RECIPE), "--device", "cpu"])
    with pytest.raises(SystemExit):
        predict.main(["--config", str(RECIPE), "--device", "cpu", "--synthetic", "2", "--images", setup["files"][0]])


# the telemetry flags refused until they were ported (ROADMAP A5.7), each
# with a value it takes
A5_7_FLAGS = {"--slo": "success_rate>=0.5", "--slo-window-s": "30", "--slo-fast-window-s": "2",
              "--metrics-port": "0", "--metrics-hold-s": "0.05"}


@pytest.mark.parametrize("flag", sorted(A5_7_FLAGS))
def test_unported_flag_refused_with_its_roadmap_item(flag, tmp_path, capsys):
    """Each flag once refused with its ROADMAP item is accepted now and
    serves: no refusal is left."""
    predict.main(["--config", str(RECIPE), "--set", *BASE, "--task", "features", "--synthetic", "2", "--device",
                  "cpu", "--serve", flag, A5_7_FLAGS[flag], "--out", str(tmp_path / "f.npz")])
    text = capsys.readouterr().out
    assert "micro-batch sizes" in text and "not ported" not in text
    if flag == "--slo":
        assert "[predict] SLO verdict: degraded=False" in text
    if flag == "--metrics-port":
        assert "[predict] exporter on :" in text


# ------------------------------------------------ the replicated tier


def test_replicas_serve_like_jax_and_the_direct_path(setup, tmp_path, capsys):
    """``--serve --replicas 2`` serves the files as the JAX CLI's pool does,
    and as the port's direct path."""
    extra = ("--serve", "--replicas", "2", "--max-delay-ms", "5")
    ref = np.load(jax_main(_args(setup, "classify", "logits", tmp_path / "j.npz", jax_side=True, extra=extra)))
    got = np.load(predict.main(_args(setup, "classify", "logits", tmp_path / "p.npz", extra=extra)))
    text = capsys.readouterr().out
    assert "replica pool: 2 replicas, quorum 2" in text and "pool served 3/3 ok (0 failed)" in text
    np.testing.assert_allclose(got["logits"], ref["logits"], **TOL)
    direct = np.load(predict.main(_args(setup, "classify", "logits", tmp_path / "d.npz")))
    np.testing.assert_allclose(got["logits"], direct["logits"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("task,pool", [("features", "cls"), ("logits", "cls"), ("features", "gap")])
def test_pack_equals_jax_on_a_mixed_resolution_mix(setup, tmp_path, capsys, task, pool):
    """``--pack --pack-resolutions`` draws the same sizes and pixels as the
    JAX CLI, passes the parity gate, and serves the same rows."""
    kind = "classify"
    flags = ["--config", str(RECIPE), "--ckpt", None, "--task", task, "--pool", pool, "--synthetic", "12",
             "--max-batch", "8", "--serve", "--replicas", "2", "--pack", "--pack-resolutions", "32:0.5,24:0.3,16:0.2",
             "--pack-budget", "512", "--pack-parity-n", "6", "--dtype", "float32", "--set", *setup[kind]["sets"]]
    jflags = list(flags)
    jflags[3] = setup[kind]["msgpack"]
    ref = np.load(jax_main([*jflags, "--no-warmcache", "--out", str(tmp_path / "j.npz")]))
    flags[3] = setup[kind]["save"]
    got = np.load(predict.main([*flags, "--device", "cpu", "--warmup", "--out", str(tmp_path / "p.npz")]))
    text = capsys.readouterr().out
    port_text = text[text.index("[predict] replica pool"):]
    assert "pack parity: pass=True n=6" in port_text and "pool served 12/12 ok" in port_text
    assert "token packing: budget=512" in port_text
    np.testing.assert_allclose(got[task], ref[task], **TOL)


def test_pack_parity_failure_aborts(setup, tmp_path, monkeypatch):
    def failing(self, *a, **kw):
        return {"pass": False, "n": 1, "feature_cosine_min": 0.5, "logits_top1_agree": None}

    monkeypatch.setattr(engine_mod.InferenceEngine, "packed_parity", failing)
    with pytest.raises(SystemExit, match="parity gate FAILED"):
        predict.main(["--config", str(RECIPE), "--set", *BASE, "--task", "features", "--synthetic", "2",
                      "--device", "cpu", "--serve", "--replicas", "1", "--pack"])


@pytest.mark.parametrize("flags,msg", [
    (["--pack"], "--replicas"),
    (["--serve", "--replicas", "1", "--pack", "--task", "reconstruct"], "features|logits"),
    (["--serve", "--replicas", "1", "--pack", "--pool", "tokens"], "cls or gap"),
    (["--pack-resolutions", "32:1"], "requires --pack"),
    (["--swap-watch", "x"], "--replicas"),
    (["--tenants", "web=interactive"], "--replicas"),
    (["--autoscale", "1:2"], "--replicas"),
    (["--serve", "--replicas", "1", "--autoscale", "2"], "MIN:MAX"),
])
def test_replicated_flag_preconditions(flags, msg):
    with pytest.raises(SystemExit, match=msg):
        predict.main(["--config", str(RECIPE), "--synthetic", "1", "--device", "cpu", "--task", "features", *flags])


def test_swap_watch_promotes_a_push_and_rolls_back_a_corrupt_one(setup, tmp_path, capsys):
    """Two checkpoints moved into the watched directory mid-stream: the
    same weights promote with cosine 1.0000, a scrambled copy is rolled
    back at parity, and every request is served."""
    import os
    import shutil
    import threading

    kind = "classify"
    watch = tmp_path / "push"
    watch.mkdir()
    staged = tmp_path / "staged"
    shutil.copytree(setup[kind]["save"], staged / "good")
    scrambled = jax.tree_util.tree_map(lambda a: -3.0 * a[::-1] if a.ndim > 1 else a, setup[kind]["params"])
    port_save(staged / "bad", load_config(RECIPE, setup[kind]["sets"]), scrambled)
    pushed = threading.Event()

    def push():
        time.sleep(0.5)
        os.rename(staged / "good", watch / "a_good")
        time.sleep(2.5)
        os.rename(staged / "bad", watch / "b_bad")
        pushed.set()

    t = threading.Thread(target=push, daemon=True)
    t.start()
    predict.main(["--config", str(RECIPE), "--set", *setup[kind]["sets"], "--ckpt", setup[kind]["save"],
                  "--task", "logits", "--synthetic", "120", "--max-batch", "4", "--device", "cpu", "--serve",
                  "--replicas", "2", "--interarrival-ms", "40", "--swap-watch", str(watch), "--swap-poll-s", "0.1",
                  "--swap-canary-requests", "2", "--swap-canary-timeout-s", "5", "--out", str(tmp_path / "s.npz")])
    t.join(timeout=30)
    assert pushed.is_set()
    text = capsys.readouterr().out
    assert "swap a_good: verdict=promoted stage=promote cosine_min=1.0000" in text
    assert "swap b_bad: verdict=rolled_back stage=parity" in text
    assert "pool served 120/120 ok (0 failed)" in text


def test_access_log_without_replicas_names_a5_7(tmp_path):
    """Once refused (ROADMAP A5.7): ``--serve --access-log`` on the single
    engine's micro-batcher writes one row per request; the log traces the
    served requests, so without ``--serve`` it is refused."""
    from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal

    with pytest.raises(SystemExit, match="requires --serve"):
        predict.main(["--config", str(RECIPE), "--synthetic", "1", "--device", "cpu", "--access-log", "x"])
    acc = tmp_path / "acc"
    predict.main(["--config", str(RECIPE), "--set", *BASE, "--task", "features", "--synthetic", "5", "--device",
                  "cpu", "--serve", "--access-log", str(acc), "--out", str(tmp_path / "f.npz")])
    rows = [e for e in read_journal(acc) if e["type"] == "request"]
    assert sorted(r["rid"] for r in rows) == list(range(5))
    assert all(r["outcome"] == "ok" and r["task"] == "features" and r["compute_ms"] is not None for r in rows)


def test_tenants_autoscale_and_access_log(tmp_path, capsys):
    """``--serve --replicas 2 --tenants ... --autoscale 1:2 --access-log``:
    every request served and traced with its tenant and bill, the
    meter's ``tenant_usage`` rows reconciling with the rows, the budgeted
    tenant's budget spent, and the idle second replica drained away."""
    from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal
    from jumbo_mae_tpu_tpu_torch.tools import cost_doctor

    acc = tmp_path / "acc"
    predict.main(["--config", str(RECIPE), "--set", *BASE, "--task", "features", "--synthetic", "40", "--device",
                  "cpu", "--serve", "--replicas", "2", "--max-batch", "4", "--tenants",
                  "web=interactive:rate=1000,scrape=batch:budget=0.0001:window=30", "--autoscale", "1:2",
                  "--autoscale-interval-s", "0.05", "--access-log", str(acc), "--burst", "8", "--interarrival-ms",
                  "20", "--out", str(tmp_path / "f.npz")])
    text = capsys.readouterr().out
    assert "pool served 40/40 ok (0 failed)" in text and "traffic shaping: web=interactive, scrape=batch" in text
    assert "autoscaler: [1, 2] replicas" in text and "roofline capacity" in text and "on cpu" in text
    events = read_journal(acc)
    rows = [e for e in events if e["type"] == "request"]
    assert len(rows) == 40 and all(r["outcome"] == "ok" and r["device_ms"] is not None for r in rows)
    assert {r["tenant"] for r in rows} == {"web", "scrape"} and {r["class"] for r in rows} == {"interactive", "batch"}
    assert all(r["cost_flops"] > 0 and r["bucket"] in (1, 2, 4) for r in rows)
    usage = {e["tenant"]: e for e in events if e["type"] == "tenant_usage"}
    assert usage["web"]["requests"] == usage["scrape"]["requests"] == 20 and usage["scrape"]["over_budget"]
    scaled = [e for e in events if e["type"] == "autoscale"]
    assert scaled and scaled[0]["direction"] == "down" and scaled[0]["scaled_to"] == 1
    assert any(e["type"] == "replica_removed" for e in events)
    assert cost_doctor.main([str(acc), "--out", str(tmp_path / "cost.md")]) == 0
    report = (tmp_path / "cost.md").read_text()
    assert "agree" in report and "**disagree**" not in report and "`scrape` exhausted its budget" in report


def test_telemetry_around_the_pool_scraped_during_the_hold(setup, tmp_path, monkeypatch, capsys):
    """``--serve --replicas 2 --warmup --metrics-port 0 --slo ...
    --access-log --metrics-hold-s``: ``/healthz`` is 200 and ready, every
    replica up, the request count, the SLO and memory gauges and zero
    unexpected captures are read over loopback while the exporter holds;
    the logits are bit-equal to the same run without telemetry."""
    import threading
    import urllib.request

    from jumbo_mae_tpu_tpu_torch.obs import exporter

    servers = []

    class Recorded(exporter.TelemetryServer):
        def start(self):
            servers.append(super().start())
            return self

    monkeypatch.setattr(exporter, "TelemetryServer", Recorded)
    n = 12
    # one request a dispatch (bucket 1): the same traffic computes the same
    # rows whatever the coalescing timing
    pool = ("--serve", "--replicas", "2", "--warmup", "--max-batch", "1")
    base = _args(setup, "classify", "logits", tmp_path / "plain.npz", extra=pool)
    base[base.index("--images") + 1:base.index("--max-batch")] = setup["files"] * 4
    plain = np.load(predict.main(base))["logits"]
    capsys.readouterr()
    from jumbo_mae_tpu_tpu_torch.obs import metrics

    # a registry of its own: the counts are this run's
    monkeypatch.setattr(metrics, "_default", metrics.MetricsRegistry())
    argv = _args(setup, "classify", "logits", tmp_path / "tel.npz",
                 extra=(*pool, "--metrics-port", "0", "--slo", "p99_latency_ms<=60000;success_rate>=0.9",
                        "--access-log", str(tmp_path / "acc"), "--metrics-hold-s", "4", "--interarrival-ms", "25"))
    argv[argv.index("--images") + 1:argv.index("--max-batch")] = setup["files"] * 4
    done = {}
    t = threading.Thread(target=lambda: done.setdefault("out", predict.main(argv)), daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 120
        while not servers:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        url = f"http://127.0.0.1:{servers[0].port}"

        def scrape(path):
            try:
                with urllib.request.urlopen(url + path, timeout=10) as r:
                    return r.status, r.read().decode()
            except urllib.error.HTTPError as e:
                return e.code, e.read().decode()

        # the CLI closes the sentinel (retrace_armed 0) before the exporter's
        # hold, as the JAX CLI does: the armed gauge is read from a scrape
        # made while the requests run, the final count from one in the hold
        armed = None
        while True:  # until the final count is there: the requests are done, the exporter holds
            assert time.monotonic() < deadline and t.is_alive(), "the hold ended before the scrape"
            status, text = scrape("/metrics")
            if armed is None and 'retrace_armed{loop="predict"} 1' in text:
                armed = text
            if f"infer_requests_total {n}" in text:
                break
            time.sleep(0.01)
        status, body = scrape("/healthz")
        health = json.loads(body)
    finally:
        t.join(timeout=120)
    assert not t.is_alive()
    assert status == 200 and health["ready"] and health["ok"] and health["degraded"] is False
    assert health["detail"] == "pool up (2 replicas)" and set(health["info"]) >= {"replicas", "slo", "memory"}
    assert 'serve_replica_up{replica="r0"} 1' in text and 'serve_replica_up{replica="r1"} 1' in text
    # armed while serving, and no violation: the events counter has no child until one
    assert armed is not None and 'retrace_events_total{loop="predict"}' not in text
    assert 'slo_breached{objective="success_rate>=0.9"} 0' in text and "slo_healthy_replicas 2" in text
    assert "mem_host_rss_bytes" in text and 'mem_component_bytes{component="replica1_exec_cache"} 0' in text
    assert "mem_device_bytes" not in text  # a CPU run degrades to host gauges
    out = capsys.readouterr().out
    assert f"pool served {n}/{n} ok (0 failed)" in out and "retrace sentinel: 0 unexpected" in out
    assert "holding exporter for 4s" in out and "SLO verdict: degraded=False" in out
    np.testing.assert_array_equal(np.load(done["out"])["logits"], plain)  # bit for bit
