"""The port's torch-native checkpoints, on the CPU.

- a save/restore round trip is bit-exact for the parameters, mu and nu
  (bf16 and f32), count, the learning rate, step, seed and the cursors;
- ``last/`` keeps ``max_keep_last`` saves, ``best/`` the single best by
  the metric under ``best_mode``, and a new Checkpointer reads the best
  metric back;
- a torn save is walked back: a truncated state file, a missing commit
  marker, a file torch cannot read; the walk is bounded;
- a restored state takes the same next step as the state that never
  stopped, at atol 0;
- a save blocks only for the host copy: the state may change while the
  writer thread writes, and the file holds the state of the save.
"""

import json
import pickle

import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu_torch.data.synthetic import synthetic_batches
from jumbo_mae_tpu_tpu_torch.models import DecoderConfig, preset
from jumbo_mae_tpu_tpu_torch.train.checkpoint import (
    COMMIT_FILE,
    STATE_FILE,
    CheckpointConfig,
    Checkpointer,
    read_state,
)
from jumbo_mae_tpu_tpu_torch.train.optim import OptimConfig
from jumbo_mae_tpu_tpu_torch.train.steps import create_state, make_train_step

SIZE = 32
ENC = dict(labels=None, mask_ratio=0.75, image_size=SIZE, patch_size=8, posemb="sincos2d", dtype="float32")
DEC = dict(layers=1, dim=32, heads=2, dtype="float32")
OPT = OptimConfig(learning_rate=1e-3, lr_scaling="none", warmup_steps=2, training_steps=20, mu_dtype="bfloat16")


def tiny_state(seed=0):
    return create_state((preset("vit_t16", **ENC), DecoderConfig(**DEC), True), OPT, device="cpu",
                        init_seed=seed, rng_seed=seed + 5, global_batch_size=4)


def trained(steps=3, seed=0):
    state, step = tiny_state(seed), make_train_step(guard_nonfinite=True)
    it = synthetic_batches(4, SIZE, seed=seed)
    for _ in range(steps):
        state, _ = step(state, next(it))
    return state


def tensors(state):
    return ([t.detach().clone() for t in state.model.state_dict().values()]
            + [m.clone() for m in state.opt_state.mu] + [n.clone() for n in state.opt_state.nu])


def assert_same_state(a, b):
    for x, y in zip(tensors(a), tensors(b), strict=True):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)
    assert (a.step, a.seed, a.opt_state.count, a.opt_state.learning_rate) == (
        b.step, b.seed, b.opt_state.count, b.opt_state.learning_rate)


@pytest.mark.parametrize("async_save", [True, False])
def test_round_trip_is_bit_exact(tmp_path, async_save):
    src = trained(3)
    ck = Checkpointer(CheckpointConfig(str(tmp_path), async_save=async_save))
    cursor = {"workers": [[0, 12], [1, 4]], "batches": 3, "process_count": 1}
    ck.save(3, src, metrics={"val/loss": 0.5}, extra={"data_cursor": cursor, "shard_cursor": {"epochs": {"0": [1]}}})
    ck.wait()
    assert ck.last_save_bytes > 0 and ck.last_write_s is not None and ck.last_save_s is not None
    dst = tiny_state(seed=9)  # other weights, seed and step
    dst, extra = Checkpointer(CheckpointConfig(str(tmp_path))).restore(dst)
    assert_same_state(dst, src)
    assert {m.dtype for m in dst.opt_state.mu} == {torch.bfloat16}
    assert extra["data_cursor"] == cursor and extra["shard_cursor"] == {"epochs": {"0": [1]}}


def test_best_and_last_policy(tmp_path):
    state = tiny_state()
    ck = Checkpointer(CheckpointConfig(str(tmp_path), max_keep_last=2, best_mode="min"))
    losses = {1: 0.9, 2: 0.7, 3: 0.8, 4: None, 5: 0.75}
    became_best = {}
    for step, loss in losses.items():
        state.step = step
        became_best[step] = ck.save(step, state, metrics=None if loss is None else {"val/loss": loss})
    ck.wait()
    assert became_best == {1: True, 2: True, 3: False, 4: False, 5: False}
    assert ck.committed_steps("last") == [5, 4] and ck.latest_step() == 5
    assert ck.committed_steps("best") == [2] and ck.best_metric == 0.7
    assert Checkpointer(CheckpointConfig(str(tmp_path))).best_metric == 0.7
    assert read_state(tmp_path, "best")["step"] == 2
    # max mode: the larger metric wins
    ck2 = Checkpointer(CheckpointConfig(str(tmp_path / "acc"), best_mode="max", metric_key="val/acc1"))
    for step, acc in ((1, 0.2), (2, 0.1), (3, 0.4)):
        ck2.save(step, state, metrics={"val/acc1": acc})
    ck2.wait()
    assert ck2.committed_steps("best") == [3] and ck2.best_metric == 0.4
    assert not list((tmp_path / "last").glob(".tmp-*"))


@pytest.mark.parametrize("damage", ["truncated", "no_commit", "garbage"])
def test_torn_save_is_walked_back(tmp_path, damage):
    ck = Checkpointer(CheckpointConfig(str(tmp_path), max_keep_last=3))
    states = {}
    for step in (2, 4, 6):
        states[step] = trained(step)
        ck.save(step, states[step])
    ck.wait()
    bad = tmp_path / "last" / "6"
    if damage == "truncated":
        data = (bad / STATE_FILE).read_bytes()
        (bad / STATE_FILE).write_bytes(data[: len(data) // 3])
    elif damage == "no_commit":
        (bad / COMMIT_FILE).unlink()
    else:  # the sizes agree but the bytes are not a torch file
        n = (bad / STATE_FILE).stat().st_size
        (bad / STATE_FILE).write_bytes(b"x" * n)
    ck = Checkpointer(CheckpointConfig(str(tmp_path)))
    with pytest.raises((OSError, RuntimeError, pickle.UnpicklingError)):
        ck.restore(tiny_state())
    hops = []
    restored, _ = ck.restore(tiny_state(), fallback_steps=2, on_fallback=lambda a, b, e: hops.append((a, b)))
    assert hops == [(6, 4)] and restored.step == 4
    assert_same_state(restored, states[4])
    assert ck.latest_step() == (4 if damage == "no_commit" else 6)


def test_restored_state_takes_the_same_next_step(tmp_path):
    step = make_train_step(guard_nonfinite=True)
    batches = list(zip(range(6), synthetic_batches(4, SIZE, seed=4)))
    straight = tiny_state()
    for _, b in batches:
        straight, m_straight = step(straight, b)
    first = tiny_state()
    ck = Checkpointer(CheckpointConfig(str(tmp_path)))
    for _, b in batches[:3]:
        first, _ = step(first, b)
    ck.save(first.step, first)
    # the writer thread writes while the state goes on changing: the save
    # holds the state at save time
    first, _ = step(first, batches[3][1])
    ck.wait()
    resumed, _ = Checkpointer(CheckpointConfig(str(tmp_path))).restore(tiny_state(seed=3))
    assert resumed.step == 3
    for _, b in batches[3:]:
        resumed, m_resumed = step(resumed, b)
    assert m_resumed["loss"].item() == m_straight["loss"].item()
    assert_same_state(resumed, straight)


def test_commit_marker_records_the_file_sizes(tmp_path):
    ck = Checkpointer(CheckpointConfig(str(tmp_path), async_save=False))
    ck.save(7, tiny_state(), extra={"k": np.float32(1.5)})
    marker = json.loads((tmp_path / "last" / "7" / COMMIT_FILE).read_text())
    assert marker["step"] == 7
    for name, size in marker["sizes"].items():
        assert (tmp_path / "last" / "7" / name).stat().st_size == size
    with pytest.raises(FileNotFoundError):
        Checkpointer(CheckpointConfig(str(tmp_path / "empty"))).restore(tiny_state())
