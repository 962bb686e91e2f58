"""Multi-process training through the train CLI's ``--distributed``, on
the CPU: two gloo processes of ``tests/torch_cli_workers.py`` that meet at
``--coordinator 127.0.0.1:<free port>``, on ``recipes/smoke_cpu.yaml``
with ``mesh.data=2`` (float32), over three train and three valid shards,
so that each process's stripe of either is uneven (16 and 8 samples).

(a) The two processes' losses are equal, their parameters bit-equal, and
    both equal one process stepping the same initial state on the two
    processes' batches side by side (losses within 1e-5; parameters
    within the bound of ``tests/test_torch_gloo.py``). Each process's
    batches equal the JAX ``TrainLoader``'s for its ``process_index``.
(b) The final ``val/loss`` equals one process's eval of the same state over
    the whole valid set, batch i being the two processes' batch i side by
    side (the rows the eval's mask draw covers), within 1e-5, with the
    second process's stripe a batch short.
(c) Process 0's saves carry JAX's gathered cursor (``per_process`` with
    both cursors, ``batches``, ``process_count`` 2); ``journal-host1``
    exists, and both journals' ``shard_cursor`` rows say ``world: 2``.
    Two processes resumed from step 2 take the straight run's steps 3-4
    bit for bit; one process resumed from that save drops to the epoch
    resume with JAX's warning.
(d) A SIGTERM to process 1 alone stops both at the same step, each with
    a preemption save row, exit code 0 and exit reason ``preempted``. NaN
    losses on process 1 alone roll both back to the same save.
(e) ``--distributed`` without a rendezvous names both ways; the recipe's
    ``mesh.fsdp=-1`` over two processes refuses with ROADMAP A6.3.

With the backend rule's and the rendezvous's unit tests. The launches
take about a minute of one CPU together.
"""

import io
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.config import load_config as jload_config
from jumbo_mae_tpu_tpu.data import loader as jloader
from jumbo_mae_tpu_tpu_torch.cli import train as ttrain
from jumbo_mae_tpu_tpu_torch.config import load_config
from jumbo_mae_tpu_tpu_torch.data.loader import valid_loader
from jumbo_mae_tpu_tpu_torch.data.tario import write_tar_samples
from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal
from jumbo_mae_tpu_tpu_torch.parallel import distributed as pdist
from jumbo_mae_tpu_tpu_torch.train.optim import make_optimizer
from jumbo_mae_tpu_tpu_torch.train.steps import create_state, make_eval_step, make_train_step

HERE = Path(__file__).resolve().parent
SMOKE = HERE.parent / "recipes" / "smoke_cpu.yaml"
TIMEOUT_S = 240
STEPS = 4


@pytest.fixture(scope="module")
def shard_root(tmp_path_factory) -> Path:
    """3 train and 3 valid shards × 8 JPEG samples, 48 px."""
    from PIL import Image

    root = tmp_path_factory.mktemp("dist_shards")
    rng = np.random.default_rng(7)
    idx = 0
    for split in ("train", "val"):
        for s in range(3):
            samples = []
            for _ in range(8):
                buf = io.BytesIO()
                Image.fromarray(rng.integers(0, 256, (48, 48, 3), dtype=np.uint8), "RGB").save(buf, format="JPEG",
                                                                                              quality=90)
                samples.append({"__key__": f"{split}{idx:05d}", "jpg": buf.getvalue(), "cls": str(idx % 10).encode()})
                idx += 1
            write_tar_samples(str(root / f"{split}-{s:04d}.tar"), samples)
    return root


def _overrides(out: Path, shard_root: Path, *extra: str) -> list[str]:
    return [f"run.output_dir={out}", "run.synthetic_data=false",
            f"data.train_shards={shard_root}/train-{{0000..0002}}.tar",
            f"data.valid_shards={shard_root}/val-{{0000..0002}}.tar", "data.dataset_size=24",
            "data.shuffle_buffer=8", "data.shard_retry_backoff_s=0", f"run.training_steps={STEPS}",
            "optim.training_steps=10", "run.log_interval=1", "run.ckpt_every=2", "run.eval_interval=4",
            "run.sanity_eval=false", *extra]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(tmp_path: Path, overrides: list[str], *, world: int = 2, sigterm: dict | None = None) -> list[dict]:
    """Run ``world`` CLI processes of one ``--distributed`` group to their
    end; returns their records. Fail-fast: when one dies, the others are
    killed, not waited out."""
    env = {**os.environ, "PYTHONPATH": f"{HERE.parent}:{HERE}", "OMP_NUM_THREADS": "1"}
    port = _free_port()
    outs = [tmp_path / f"rank{r}.pt" for r in range(world)]
    logs = [open(tmp_path / f"rank{r}.log", "w+") for r in range(world)]
    procs = []
    for r in range(world):
        opts = [str(outs[r])] + (["--sigterm-at", str(sigterm[r])] if sigterm and r in sigterm else [])
        argv = ["--config", str(SMOKE), "--device", "cpu", "--distributed", "--coordinator", f"127.0.0.1:{port}",
                "--num-processes", str(world), "--process-id", str(r)]
        procs.append(subprocess.Popen([sys.executable, str(HERE / "torch_cli_workers.py"), *opts, "--", *argv,
                                       "--set", *overrides], env=env, stdout=logs[r], stderr=subprocess.STDOUT,
                                      text=True))
    deadline = time.monotonic() + TIMEOUT_S
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
            time.sleep(2.0)  # a refusal on every process: let the others reach theirs
            for q in procs:
                if q.poll() is None:
                    q.kill()
            break
        time.sleep(0.2)
    recs = []
    for p, log, out in zip(procs, logs, outs):
        p.wait()
        log.seek(0)
        text = log.read()
        log.close()
        assert out.exists(), f"process wrote no record (exit {p.returncode}):\n{text[-4000:]}"
        recs.append({**torch.load(out, weights_only=False), "log": text, "returncode": p.returncode})
    return recs


def _cfg(out, shard_root, *extra):
    return load_config(SMOKE, _overrides(out, shard_root, *extra))


def _reference_state(cfg):
    run = cfg.run
    model, enc, _ = ttrain.build_model(cfg, device="cpu")
    tx = make_optimizer(cfg.optim, run.train_batch_size, num_layers=enc.layers)
    return create_state(model, tx, device="cpu", init_seed=run.init_seed, rng_seed=run.seed)


def _losses(run_dir: Path, journal: str) -> dict[int, float]:
    return {e["step"]: e["metrics"]["train/loss"] for e in read_journal(run_dir / journal) if e["type"] == "step"}


@pytest.fixture(scope="module")
def straight(tmp_path_factory, shard_root):
    """Two processes, 4 steps, saves at 2 and 4, an eval at 4."""
    tmp = tmp_path_factory.mktemp("straight")
    recs = launch(tmp, _overrides(tmp / "out", shard_root, "mesh.data=2"))
    for r in recs:
        assert r["exit_code"] == 0 and r["error"] is None, r["log"][-4000:]
    return dict(recs=recs, run_dir=tmp / "out" / "smoke_cpu", cfg=_cfg(tmp / "out", shard_root, "mesh.data=2"))


# ------------------------------------------------------------- (a) the steps


def test_two_processes_step_as_one_on_their_batches_side_by_side(straight, shard_root):
    recs, run_dir, cfg = straight["recs"], straight["run_dir"], straight["cfg"]
    assert "backend gloo (the CPU" in recs[0]["log"] and "process 1 of 2" in recs[1]["log"]
    l0, l1 = _losses(run_dir, "journal"), _losses(run_dir, "journal-host1")
    assert sorted(l0) == list(range(1, STEPS + 1)) and l0 == l1
    for k, v in recs[0]["state"]["model"].items():
        assert torch.equal(v, recs[1]["state"]["model"][k]), k
    # each process stepped on the JAX loader's batches for its process_index
    jcfg = jload_config(SMOKE, _overrides(run_dir.parent, shard_root, "mesh.data=2")).data
    for r, rec in enumerate(recs):
        assert len(rec["batches"]) == STEPS
        loader = jloader.TrainLoader(jcfg, 8, process_index=r, process_count=2)
        for i, got in enumerate(rec["batches"]):
            want = next(loader)
            assert got["images"].shape == (8, 32, 32, 3)
            np.testing.assert_array_equal(got["images"], want["images"], err_msg=f"process {r} batch {i}")
        loader.close()
    # one process on the global batches: process 0's rows, then process 1's
    state = _reference_state(cfg)
    step = make_train_step(mode="pretrain", grad_accum=1, guard_nonfinite=cfg.run.sentinel)
    want = []
    for b0, b1 in zip(recs[0]["batches"], recs[1]["batches"]):
        state, m = step(state, {k: np.concatenate([b0[k], b1[k]]) for k in b0})
        want.append(m["loss"].item())
    np.testing.assert_allclose([l0[s] for s in range(1, STEPS + 1)], want, rtol=1e-5, atol=0)
    lr = cfg.optim.learning_rate
    for n, p in state.model.state_dict().items():
        atol = 2 * STEPS * lr if n.endswith("attn.k.bias") else 1e-2 * lr
        torch.testing.assert_close(recs[0]["state"]["model"][n], p, atol=atol, rtol=0, msg=n)


# ------------------------------------------------------------------ (b) eval


def test_eval_sums_over_uneven_stripes_as_one_process(straight):
    recs, cfg = straight["recs"], straight["cfg"]
    val = [r["metrics"]["val/loss"] for r in recs]
    assert val[0] == val[1]
    per = [list(valid_loader(cfg.data, 8, process_index=r, process_count=2)) for r in (0, 1)]
    assert [len(p) for p in per] == [2, 1]  # 16 and 8 samples
    pad = {k: np.zeros_like(v) for k, v in per[1][0].items()}
    pad["valid"] = np.zeros_like(per[1][0]["valid"])
    state = _reference_state(cfg)
    with torch.no_grad():
        state.model.load_state_dict(recs[0]["state"]["model"])
    state.step, state.seed = recs[0]["state"]["step"], recs[0]["state"]["seed"]
    batches = [{k: np.concatenate([b0[k], b1[k]]) for k in ("images", "valid")}
               for b0, b1 in zip(per[0], per[1] + [pad])]
    want = ttrain.evaluate(make_eval_step(mode="pretrain"), state, batches)
    assert sum(int(b["valid"].sum()) for b in batches) == 24  # the whole valid set
    np.testing.assert_allclose(val[0], want["val/loss"], rtol=1e-5, atol=0)


# --------------------------------------------------------- (c) save and resume


def test_saves_gather_both_cursors_and_both_journals_say_world_2(straight):
    run_dir = straight["run_dir"]
    for step in (2, 4):
        extra = json.loads((run_dir / "ckpt" / "last" / str(step) / "extra.json").read_text())
        cur = extra["data_cursor"]
        assert cur["process_count"] == 2 and cur["batches"] == step and len(cur["per_process"]) == 2
    assert (run_dir / "journal-host1").is_dir()
    for journal, host in (("journal", 0), ("journal-host1", 1)):
        rows = [e for e in read_journal(run_dir / journal) if e["type"] == "shard_cursor"]
        assert [e["step"] for e in rows] == [2, 4] and {e["world"] for e in rows} == {2}
        assert {e["host"] for e in rows} == {host}


def test_two_processes_resume_bit_exact_one_process_falls_back(straight, shard_root, tmp_path, capsys):
    src = straight["run_dir"] / "ckpt"
    for name in ("two", "one"):
        dst = tmp_path / name / "smoke_cpu" / "ckpt"
        shutil.copytree(src, dst)
        shutil.rmtree(dst / "last" / "4")
        shutil.rmtree(dst / "best", ignore_errors=True)
    recs = launch(tmp_path, _overrides(tmp_path / "two", shard_root, "mesh.data=2", "run.resume=true"))
    for r in recs:
        assert r["exit_code"] == 0 and r["error"] is None, r["log"][-4000:]
        assert "sample-exact resume" in r["log"]
    straight_losses = _losses(straight["run_dir"], "journal")
    resumed = _losses(tmp_path / "two" / "smoke_cpu", "journal")
    assert sorted(resumed) == [3, 4] and all(resumed[s] == straight_losses[s] for s in (3, 4))
    for k, v in straight["recs"][0]["state"]["model"].items():
        for r in recs:
            assert torch.equal(r["state"]["model"][k], v), k
    # one process: the cursor of two cannot hold, every stream restarts its epoch
    out = ttrain.train(_cfg(tmp_path / "one", shard_root, "mesh.data=1", "run.resume=true", "run.training_steps=3",
                            "run.eval_interval=0"), device="cpu")
    assert out["_exit_reason"] == "completed"
    assert ("checkpoint data cursor was saved with 2 processes but this run has 1; falling back to epoch resume"
            in capsys.readouterr().out)


# ---------------------------------------------------------------- (d) preemption


def test_a_sigterm_to_one_process_stops_both_at_one_step_with_a_save(tmp_path, shard_root):
    recs = launch(tmp_path, _overrides(tmp_path / "out", shard_root, "mesh.data=2", "run.training_steps=40",
                                       "optim.training_steps=50", "run.ckpt_every=100", "run.eval_interval=0"),
                  sigterm={1: 3})
    run_dir = tmp_path / "out" / "smoke_cpu"
    for r in recs:
        assert r["returncode"] == r["exit_code"] == 0, r["log"][-4000:]
        assert r["metrics"]["_exit_reason"] == "preempted"
    assert "caught signal" in recs[1]["log"] and "caught signal" not in recs[0]["log"]
    saves = [[e for e in read_journal(run_dir / j) if e["type"] == "checkpoint_save"]
             for j in ("journal", "journal-host1")]
    assert [(e["step"], e.get("preemption")) for e in saves[0]] == [(3, True)]
    assert [(e["step"], e.get("preemption")) for e in saves[1]] == [(3, True)]
    assert (run_dir / "ckpt" / "last" / "3" / "COMMIT").exists()
    assert recs[0]["state"]["step"] == recs[1]["state"]["step"] == 3


def test_a_divergence_on_one_process_rolls_both_back_to_one_step(tmp_path, shard_root):
    """NaN losses on process 1 alone (steps 3-4): the averaged loss and
    gradients carry them to both, so both guards skip, both sentinels roll
    back at step 4 to the step-2 save, and both end on equal parameters."""
    recs = launch(tmp_path, _overrides(tmp_path / "out", shard_root, "mesh.data=2", "run.training_steps=6",
                                       "run.ckpt_every=2", "run.eval_interval=0", "run.sentinel_patience=2",
                                       "run.faults=train.loss:nan@host=1,n=2..3"))
    run_dir = tmp_path / "out" / "smoke_cpu"
    for r in recs:
        assert r["exit_code"] == 0 and r["error"] is None, r["log"][-4000:]
        assert r["metrics"]["_exit_reason"] == "completed" and r["state"]["step"] == 6
    for journal in ("journal", "journal-host1"):
        events = read_journal(run_dir / journal)
        assert [e["step"] for e in events if e["type"] == "sentinel_bad_step"] == [3, 4]
        assert [(e["from_step"], e["to_step"]) for e in events if e["type"] == "rollback"] == [(4, 2)]
    for k, v in recs[0]["state"]["model"].items():
        assert torch.equal(v, recs[1]["state"]["model"][k]), k
    assert all(np.isfinite(v).all() for v in recs[0]["state"]["model"].values())


# ---------------------------------------------------------------- (e) refusals


def test_fsdp_over_two_processes_refuses_with_a6_3(tmp_path, shard_root):
    recs = launch(tmp_path, _overrides(tmp_path / "out", shard_root))  # the recipe's mesh {data: 1, fsdp: -1}
    for r in recs:
        assert r["exit_code"] == 1 and "A6.3" in r["error"] and "mesh.data" in r["error"], r["log"][-4000:]


def test_rendezvous_needs_a_coordinator_or_torchrun():
    with pytest.raises(ValueError, match="--coordinator HOST:PORT.*torchrun"):
        pdist.rendezvous(env={})
    with pytest.raises(ValueError, match="--num-processes and --process-id"):
        pdist.rendezvous("127.0.0.1:1234", env={})
    with pytest.raises(ValueError, match="not in"):
        pdist.rendezvous("127.0.0.1:1234", 2, 2, env={})
    r = pdist.rendezvous("127.0.0.1:1234", 2, 1, env={})
    assert r == pdist.Rendezvous("tcp://127.0.0.1:1234", 2, 1, 1, 2)
    assert pdist.rendezvous("10.0.0.5:1234", 4, 3, env={}).local_world_size == 1
    env = {"RANK": "3", "WORLD_SIZE": "4", "MASTER_ADDR": "h", "MASTER_PORT": "1", "LOCAL_RANK": "1",
           "LOCAL_WORLD_SIZE": "2"}
    assert pdist.rendezvous(env=env) == pdist.Rendezvous("env://", 4, 3, 1, 2)


@pytest.mark.parametrize("device,local_procs,cards,want", [
    ("cpu", 1, 0, "gloo"), ("cpu", 2, 8, "gloo"), ("cuda", 2, 1, "gloo"), ("cuda", 1, 1, "nccl"),
    ("cuda", 4, 4, "nccl"), ("cuda", 2, 8, "nccl"),
])
def test_backend_rule(device, local_procs, cards, want):
    assert pdist.backend_for(device, local_procs, cards) == want
