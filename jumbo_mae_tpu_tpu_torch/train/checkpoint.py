"""Checkpoints: atomic full-state saves with a best/last policy and walk-back.

Counterpart of ``jumbo_mae_tpu_tpu/train/checkpoint.py``'s
:class:`Checkpointer`, written for PyTorch (the JAX package saves through
Orbax, which the port cannot read or write). A save holds everything a
resume needs to take the same next step:

- the model's parameters and buffers (``state_dict``);
- the AdamW state: ``mu`` and ``nu`` in their stored dtypes, ``count``
  and the last learning rate;
- the train ``step`` and the stream ``seed``;
- ``extra`` as JSON (the data cursor, the shard cursor).

Layout: ``<directory>/last/<step>/`` and ``<directory>/best/<step>/``, each
holding ``state.pt`` (``torch.save``), ``extra.json`` and ``COMMIT``. A
save is written into a ``.tmp-*`` directory beside them, every file is
fsynced, the ``COMMIT`` marker (the other files' sizes) is written last,
and the directory is renamed into place with ``os.replace``: a reader sees
a whole save or none. ``last/`` keeps the newest ``max_keep_last`` saves;
``best/`` keeps the single best by ``metric_key`` under ``best_mode``
(hard links to the ``last/`` files, so a best save costs no second write).

The save blocks the caller only for the device → host copy; the files are
written by a writer thread (``async_save``), which :meth:`Checkpointer.wait`
joins, raising what it raised. :meth:`Checkpointer.restore` walks back past
a save that fails to load — torn, truncated or uncommitted — over at most
``fallback_steps`` older saves.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import torch

STATE_FILE = "state.pt"
EXTRA_FILE = "extra.json"
COMMIT_FILE = "COMMIT"


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    max_keep_last: int = 2
    async_save: bool = True
    best_mode: str = "min"  # "min" (val loss) or "max" (val acc)
    metric_key: str = "val/loss"


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_file(path: Path, write) -> int:
    """Write ``path`` through ``write(f)``, fsync it, return its size."""
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    return path.stat().st_size


def _step_dirs(d: Path) -> list[int]:
    """Every step directory under ``d``, committed or not, newest first."""
    return sorted((int(p.name) for p in d.iterdir() if p.is_dir() and p.name.isdigit()), reverse=True)


def _committed(d: Path) -> list[int]:
    return [s for s in _step_dirs(d) if (d / str(s) / COMMIT_FILE).is_file()]


def _load_save(d: Path) -> tuple[dict, dict]:
    """(payload, extra) of the save in ``d``; raises if it is uncommitted,
    torn (a size that disagrees with its commit marker) or unreadable."""
    if not (d / COMMIT_FILE).is_file():
        raise FileNotFoundError(f"checkpoint {d} has no {COMMIT_FILE} marker (an uncommitted save)")
    sizes = json.loads((d / COMMIT_FILE).read_text())["sizes"]
    for name, size in sizes.items():
        got = (d / name).stat().st_size
        if got != size:
            raise OSError(f"checkpoint file {d / name} has {got} bytes, its commit says {size} (a torn save)")
    payload = torch.load(d / STATE_FILE, map_location="cpu", weights_only=True)
    return payload, json.loads((d / EXTRA_FILE).read_text())


def host_state(state) -> dict:
    """A host copy of everything :meth:`Checkpointer.save` stores for a
    ``train.state.TrainState``: the device → host copy, the only part of a
    save the step waits for."""

    def host(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu", copy=True)

    opt = state.opt_state
    return {
        "model": {k: host(v) for k, v in state.model.state_dict().items()},
        "opt": {
            "count": int(opt.count),
            "learning_rate": float(opt.learning_rate),
            "mu": [host(m) for m in opt.mu],
            "nu": [host(n) for n in opt.nu],
        },
        "step": int(state.step),
        "seed": int(state.seed),
    }


class Checkpointer:
    """Full-train-state checkpoints with a best/last policy.

    ``save(step, state, metrics, extra)`` always writes ``last`` and also
    ``best`` when ``metrics[metric_key]`` improves; ``restore`` loads a
    save into a live state in place. ``last_save_s`` is the blocking part
    of the last save (the host copy), ``last_write_s`` its file writing,
    ``last_save_bytes`` its bytes on disk."""

    def __init__(self, cfg: CheckpointConfig):
        if cfg.best_mode not in ("min", "max"):
            raise ValueError(f"best_mode must be 'min' or 'max', got {cfg.best_mode!r}")
        self.cfg = cfg
        self.root = Path(cfg.directory).absolute()
        for slot in ("last", "best"):
            d = self.root / slot
            d.mkdir(parents=True, exist_ok=True)
            for stale in d.glob(".tmp-*"):  # a writer that died mid-save
                shutil.rmtree(stale, ignore_errors=True)
        self._best_metric = self._read_best_metric()
        self._writer: threading.Thread | None = None
        self._writer_error: BaseException | None = None
        self.last_save_s: float | None = None
        self.last_write_s: float | None = None
        self.last_save_bytes: int | None = None
        self.last_restore_s: float | None = None

    # ------------------------------------------------------------ layout

    def _steps(self, which: str) -> list[int]:
        return _step_dirs(self.root / which)

    def committed_steps(self, which: str = "last") -> list[int]:
        return _committed(self.root / which)

    def latest_step(self, which: str = "last") -> int | None:
        steps = self.committed_steps(which)
        return steps[0] if steps else None

    def _read_best_metric(self) -> float | None:
        step = self.latest_step("best")
        if step is None:
            return None
        try:
            extra = json.loads((self.root / "best" / str(step) / EXTRA_FILE).read_text())
        except (OSError, ValueError):
            return None
        return extra.get("_best_metric")

    @property
    def best_metric(self) -> float | None:
        return self._best_metric

    def _improved(self, value: float) -> bool:
        if self._best_metric is None:
            return True
        return value < self._best_metric if self.cfg.best_mode == "min" else value > self._best_metric

    # ------------------------------------------------------------ save

    def save(self, step: int, state, metrics: dict[str, float] | None = None, extra: dict | None = None) -> bool:
        """Save ``last``; promote to ``best`` on metric improvement. Returns
        True if this step became the new best. Blocks for the host copy;
        the writing runs on the writer thread when ``async_save``."""
        self.wait()  # one save in flight: saves land in order
        t0 = time.perf_counter()
        payload = host_state(state)
        value = None if metrics is None else metrics.get(self.cfg.metric_key)
        is_best = value is not None and self._improved(float(value))
        extra = dict(extra or {})
        if is_best:
            self._best_metric = float(value)
            extra["_best_metric"] = self._best_metric
        extra_bytes = json.dumps(extra, default=float).encode()
        self.last_save_s = time.perf_counter() - t0
        if self.cfg.async_save:
            self._writer = threading.Thread(
                target=self._write_guarded, args=(int(step), payload, extra_bytes, is_best), daemon=False
            )
            self._writer.start()
        else:
            self._write(int(step), payload, extra_bytes, is_best)
        return is_best

    def _write_guarded(self, *args) -> None:
        try:
            self._write(*args)
        except BaseException as e:  # noqa: BLE001 - re-raised by wait()
            self._writer_error = e

    def _write(self, step: int, payload: dict, extra_bytes: bytes, is_best: bool) -> None:
        t0 = time.perf_counter()
        last = self.root / "last"
        tmp = last / f".tmp-{step}-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        sizes = {
            STATE_FILE: _write_file(tmp / STATE_FILE, lambda f: torch.save(payload, f)),
            EXTRA_FILE: _write_file(tmp / EXTRA_FILE, lambda f: f.write(extra_bytes)),
        }
        commit = json.dumps({"step": step, "sizes": sizes}).encode()
        _write_file(tmp / COMMIT_FILE, lambda f: f.write(commit))
        _fsync_dir(tmp)
        self._publish(tmp, last / str(step))
        if is_best:
            best = self.root / "best"
            btmp = best / f".tmp-{step}-{os.getpid()}"
            shutil.rmtree(btmp, ignore_errors=True)
            btmp.mkdir()
            for name in (STATE_FILE, EXTRA_FILE, COMMIT_FILE):
                try:
                    os.link(last / str(step) / name, btmp / name)
                except OSError:  # a filesystem without hard links
                    shutil.copy2(last / str(step) / name, btmp / name)
            _fsync_dir(btmp)
            self._publish(btmp, best / str(step))
            for old in self._steps("best")[1:]:
                shutil.rmtree(best / str(old), ignore_errors=True)
        for old in self.committed_steps("last")[max(1, self.cfg.max_keep_last) :]:
            shutil.rmtree(last / str(old), ignore_errors=True)
        self.last_save_bytes = sum(sizes.values()) + len(commit)
        self.last_write_s = time.perf_counter() - t0

    @staticmethod
    def _publish(tmp: Path, final: Path) -> None:
        if final.exists():  # the same step saved again (a rollback replay)
            shutil.rmtree(final)
        os.replace(tmp, final)
        _fsync_dir(final.parent)

    def wait(self) -> None:
        """Join the writer thread; re-raise what the last write raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._writer_error is not None:
            err, self._writer_error = self._writer_error, None
            raise err

    def close(self) -> None:
        self.wait()

    # ------------------------------------------------------------ restore

    def restore(self, state, *, step: int | None = None, which: str = "last", fallback_steps: int = 0, on_fallback=None):
        """Load a save into ``state`` (a live ``TrainState``) in place;
        returns ``(state, extra)``. Each tensor is copied into the live one,
        so it keeps its device; a stored moment whose dtype differs from
        the configured one is cast, with a warning.

        ``step=None`` takes the newest step directory of ``which``. When it
        fails to load (no commit marker, a size that disagrees with the
        marker, a file ``torch.load`` rejects), the restore walks back over
        up to ``fallback_steps`` older step directories, calling
        ``on_fallback(from_step, to_step, error)`` per hop; when every one
        fails it raises the last error."""
        t0 = time.perf_counter()
        steps = self._steps(which)
        if step is not None:
            steps = [s for s in steps if s <= step]
        if not steps:
            raise FileNotFoundError(f"no '{which}' checkpoint under {self.root}")
        steps = steps[: 1 + max(0, int(fallback_steps))]
        last_err: Exception | None = None
        for i, s in enumerate(steps):
            if i > 0 and on_fallback is not None:
                on_fallback(steps[i - 1], s, last_err)
            try:
                payload, extra = _load_save(self.root / which / str(s))
            except (OSError, RuntimeError, ValueError, KeyError, EOFError, pickle.UnpicklingError) as e:
                if i + 1 == len(steps):
                    raise
                last_err = e
                print(f"[ckpt] restore of step {s} failed ({type(e).__name__}: {e}); walking back")
                continue
            self._apply(state, payload)
            self.last_restore_s = time.perf_counter() - t0
            return state, extra
        raise AssertionError("unreachable")  # the loop returns or raises

    @staticmethod
    @torch.no_grad()
    def _apply(state, payload: dict) -> None:
        state.model.load_state_dict(payload["model"])
        opt, saved = state.opt_state, payload["opt"]
        if len(saved["mu"]) != len(opt.mu) or len(saved["nu"]) != len(opt.nu):
            raise ValueError("the checkpoint's optimizer state does not match the model")
        for live, stored in zip(opt.mu + opt.nu, saved["mu"] + saved["nu"]):
            if live.shape != stored.shape:
                raise ValueError(f"optimizer moment of shape {tuple(stored.shape)} in the checkpoint, {tuple(live.shape)} live")
            if live.dtype != stored.dtype:
                print(f"[ckpt] WARNING: casting a stored {stored.dtype} moment to the configured {live.dtype}")
            live.copy_(stored)
        opt.count = int(saved["count"])
        opt.learning_rate = float(saved["learning_rate"])
        state.step = int(payload["step"])
        state.seed = int(payload["seed"])


def read_state(directory: str | Path, which: str = "last", step: int | None = None) -> dict:
    """The saved payload (host tensors) of a committed save under a
    checkpoint ``directory``: the newest of ``which`` unless ``step`` is
    given. Reads only."""
    d = Path(directory) / which
    if step is None:
        steps = _committed(d) if d.is_dir() else []
        if not steps:
            raise FileNotFoundError(f"no committed '{which}' checkpoint under {directory}")
        step = steps[0]
    return _load_save(d / str(step))[0]
