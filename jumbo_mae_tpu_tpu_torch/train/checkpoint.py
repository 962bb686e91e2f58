"""Checkpoints: atomic full-state saves with a best/last policy and walk-back.

Counterpart of ``jumbo_mae_tpu_tpu/train/checkpoint.py``'s
:class:`Checkpointer`, written for PyTorch (the JAX package saves through
Orbax, which the port cannot read or write). A save holds everything a
resume needs to take the same next step:

- the model's parameters and buffers (``state_dict``: BatchNorm
  statistics included);
- the optimizer's state, whatever the optimizer: every per-parameter
  tensor list of ``OptState.slots()`` (AdamW's and LAMB's ``mu`` and
  ``nu`` in their stored dtypes, LARS' and SGD's ``trace``, the
  ``master`` weights) by name, ``count`` and the last learning rate;
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

The save blocks the caller only for the device → host copy, into host
tensors the checkpointer keeps from save to save; the files are written by
a writer thread (``async_save``), which :meth:`Checkpointer.wait` joins,
raising what it raised. In a run of several processes one of them writes
and :meth:`Checkpointer.wait` ends at a barrier of all of them. :meth:`Checkpointer.restore` walks back past
a save that fails to load — torn, truncated or uncommitted — over at most
``fallback_steps`` older saves. The fault sites ``ckpt.save`` (at every
save, keyed by the step) and ``ckpt.load`` (at every step a restore tries,
keyed by that step) are the JAX checkpointer's.
:meth:`Checkpointer.restore_eval` restores
what evaluation needs — parameters, buffers, the step and the seed — and
never reads the optimizer's bytes (the file is memory-mapped);
:func:`restore_inference_state` reads what serving needs the same way.

Warm starts (counterparts of the JAX package's ``resize_posemb``,
``merge_pretrained_params``, ``require_loaded`` and
``load_pretrained_params``) read the port's own saves and flax
``.msgpack`` params files: the encoder of an MAE save (``encoder.*``) goes
to a classifier's trunk (``model.*``), the decoder is dropped and the head
stays fresh. :func:`export_params_msgpack` and
:func:`import_params_msgpack` write and read the ``.msgpack`` params
files of the JAX package (``interop/flax_msgpack.py``, no flax needed);
serving and warm starts take one wherever they take a save. An Orbax
checkpoint raises, naming the command that converts it to ``.msgpack``
where JAX is installed.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import shutil
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from jumbo_mae_tpu_tpu_torch.faults.inject import fault_point
from jumbo_mae_tpu_tpu_torch.interop import flax_msgpack
from jumbo_mae_tpu_tpu_torch.interop.from_jax import state_dict_from_flax

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


def _load_save(d: Path, *, mmap: bool = False) -> tuple[dict, dict]:
    """(payload, extra) of the save in ``d``; raises if it is uncommitted,
    torn (a size that disagrees with its commit marker) or unreadable.
    ``mmap``: map the file instead of reading it, so a tensor the caller
    never touches is never read."""
    if not (d / COMMIT_FILE).is_file():
        raise FileNotFoundError(f"checkpoint {d} has no {COMMIT_FILE} marker (an uncommitted save)")
    sizes = json.loads((d / COMMIT_FILE).read_text())["sizes"]
    for name, size in sizes.items():
        got = (d / name).stat().st_size
        if got != size:
            raise OSError(f"checkpoint file {d / name} has {got} bytes, its commit says {size} (a torn save)")
    payload = torch.load(d / STATE_FILE, map_location="cpu", weights_only=True, mmap=mmap)
    return payload, json.loads((d / EXTRA_FILE).read_text())


def _state_tensors(state) -> list[torch.Tensor]:
    """Every tensor :func:`host_state` copies, in its order."""
    return [*state.model.state_dict().values(), *(t for ts in state.opt_state.slots().values() for t in ts)]


def host_state(state, staging: list[torch.Tensor] | None = None) -> dict:
    """A host copy of everything :meth:`Checkpointer.save` stores for a
    ``train.state.TrainState``: the device → host copy, the only part of a
    save the step waits for. With ``staging`` (CPU tensors of the shapes
    and dtypes of :func:`_state_tensors`, in its order) the copy goes into
    those tensors, and the payload holds them; without, into new ones."""
    dst = iter(staging) if staging is not None else None

    def host(t: torch.Tensor) -> torch.Tensor:
        if dst is None:
            return t.detach().to("cpu", copy=True)
        return next(dst).copy_(t.detach())

    opt = state.opt_state
    return {
        "model": {k: host(v) for k, v in state.model.state_dict().items()},
        "opt": {
            "count": int(opt.count),
            "learning_rate": float(opt.learning_rate),
            **{name: [host(t) for t in ts] for name, ts in opt.slots().items()},
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
    ``last_save_bytes`` its bytes on disk.

    The host copy goes into one set of CPU tensors the checkpointer keeps
    from save to save (the staging; :meth:`reserve` takes it ahead of the
    first save, :meth:`host_copy_bytes` is its size): a copy made anew and
    freed each save leaves its pages with the C allocator, and the
    process's resident set then grows by up to a whole copy without
    anything holding it. Reused, the copy costs its bytes once.

    In a run of several processes the state is replicated over ``data``:
    one process writes (``writer=True``) and the others take every call,
    with no copy and no file. ``barrier`` (a callable every process runs)
    then ends :meth:`wait`, so no process reads ``last/`` before the
    writer's save is whole; every process restores from the same
    directory (a filesystem they share)."""

    def __init__(self, cfg: CheckpointConfig, *, writer: bool = True, barrier=None):
        if cfg.best_mode not in ("min", "max"):
            raise ValueError(f"best_mode must be 'min' or 'max', got {cfg.best_mode!r}")
        self.cfg = cfg
        self.root = Path(cfg.directory).absolute()
        self.writer = writer
        self._barrier = barrier
        for slot in ("last", "best"):
            d = self.root / slot
            d.mkdir(parents=True, exist_ok=True)
            if writer:
                for stale in d.glob(".tmp-*"):  # a writer that died mid-save
                    shutil.rmtree(stale, ignore_errors=True)
        self._best_metric = self._read_best_metric()
        self._writer: threading.Thread | None = None
        self._writer_error: BaseException | None = None
        self._staging: list[torch.Tensor] | None = None
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

    def _staging_for(self, state) -> list[torch.Tensor]:
        """The staging of ``state``'s tensors, taken anew only when their
        shapes or dtypes changed. Each tensor is written once here, so its
        pages are resident from now on."""
        live = _state_tensors(state)
        if self._staging is None or [(t.shape, t.dtype) for t in self._staging] != [(t.shape, t.dtype) for t in live]:
            self._staging = None  # the old staging goes before the new one is taken
            self._staging = [torch.empty(t.shape, dtype=t.dtype).fill_(0) for t in live]
        return self._staging

    def reserve(self, state) -> None:
        """Take the host staging of ``state`` now, ahead of the first save
        (the train CLI does it before its first step, so the memory
        samples see its bytes from the start). A process that does not
        write takes none. Not collective: it waits for no other process."""
        if self.writer:
            self.drain()  # a save in flight still reads the staging
            self._staging_for(state)

    def host_copy_bytes(self) -> int:
        """The bytes of the host staging (the ``ckpt_host_copy`` component
        of the train CLI's memory accountant)."""
        return sum(t.numel() * t.element_size() for t in self._staging or ())

    def save(self, step: int, state, metrics: dict[str, float] | None = None, extra: dict | None = None) -> bool:
        """Save ``last``; promote to ``best`` on metric improvement. Returns
        True if this step became the new best. Blocks for the host copy;
        the writing runs on the writer thread when ``async_save``."""
        self.wait()  # one save in flight: saves land in order; the staging is free again
        t0 = time.perf_counter()
        # a failing checkpoint store, injectable without a flaky filesystem
        fault_point("ckpt.save", key=str(step))
        value = None if metrics is None else metrics.get(self.cfg.metric_key)
        is_best = value is not None and self._improved(float(value))
        extra = dict(extra or {})
        if is_best:
            self._best_metric = float(value)
            extra["_best_metric"] = self._best_metric
        if not self.writer:
            self.last_save_s = time.perf_counter() - t0
            return is_best
        payload = host_state(state, self._staging_for(state))
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

    def drain(self) -> None:
        """Join the writer thread, nothing more (the hang watchdog's drain,
        which runs on a thread of its own and must not enter a
        collective)."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None

    def wait(self) -> None:
        """Join the writer thread, then pass the barrier, if any; re-raise
        what the last write raised."""
        self.drain()
        if self._barrier is not None:
            self._barrier()
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
                fault_point("ckpt.load", key=str(s))
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

    def restore_eval(self, state, *, which: str = "last"):
        """Restore only what evaluation needs into ``state`` in place — the
        parameters, the buffers (BatchNorm statistics), the step and the
        seed — from the newest committed save of ``which``; returns
        ``(state, extra)``. The optimizer state is left as it is
        (pair this with the ``Identity`` optimizer) and its bytes are never
        read: the file is memory-mapped and only the model's tensors are
        touched."""
        committed = self.committed_steps(which)
        if not committed:
            raise FileNotFoundError(f"no committed '{which}' checkpoint under {self.root}")
        payload, extra = _load_save(self.root / which / str(committed[0]), mmap=True)
        with torch.no_grad():
            state.model.load_state_dict(payload["model"])
        state.step = int(payload["step"])
        state.seed = int(payload["seed"])
        return state, extra

    @staticmethod
    @torch.no_grad()
    def _apply(state, payload: dict) -> None:
        state.model.load_state_dict(payload["model"])
        opt, saved = state.opt_state, payload["opt"]
        for name, live_list in opt.slots().items():
            stored_list = saved.get(name)
            if stored_list is None or len(stored_list) != len(live_list):
                raise ValueError(
                    f"the checkpoint's optimizer state has no {name!r} of {len(live_list)} tensors "
                    f"(it holds {sorted(k for k in saved if k not in ('count', 'learning_rate'))}): another optimizer "
                    "or another model"
                )
            for live, stored in zip(live_list, stored_list):
                if live.shape != stored.shape:
                    raise ValueError(
                        f"optimizer {name} of shape {tuple(stored.shape)} in the checkpoint, {tuple(live.shape)} live"
                    )
                if live.dtype != stored.dtype:
                    print(f"[ckpt] WARNING: casting a stored {stored.dtype} {name} to the configured {live.dtype}")
                live.copy_(stored)
        opt.count = int(saved["count"])
        opt.learning_rate = float(saved["learning_rate"])
        state.step = int(payload["step"])
        state.seed = int(payload["seed"])


def read_state(directory: str | Path, which: str = "last", step: int | None = None) -> dict:
    """The saved payload (host tensors) of a committed save under a
    checkpoint ``directory``: the newest of ``which`` unless ``step`` is
    given. Reads only, and only the tensors the caller touches (the file
    is memory-mapped)."""
    d = Path(directory) / which
    if step is None:
        steps = _committed(d) if d.is_dir() else []
        if not steps:
            raise FileNotFoundError(f"no committed '{which}' checkpoint under {directory}")
        step = steps[0]
    return _load_save(d / str(step), mmap=True)[0]


# ---------------------------------------------------------------- serving

BATCH_STATS = ("running_mean", "running_var")
ORBAX_NOT_PORTED = (
    "{path} is an Orbax checkpoint, which the port cannot read (the card has no JAX; ROADMAP A3.3). "
    "Convert it to a flax .msgpack params file where the JAX package is installed:\n"
    "  python -c \"import sys; from jumbo_mae_tpu_tpu.train.checkpoint import restore_inference_state, "
    "export_params_msgpack; export_params_msgpack(restore_inference_state(sys.argv[1])[0], sys.argv[2])\" "
    "{path} params.msgpack\n"
    "then pass params.msgpack (the parameters only, no BatchNorm statistics)"
)
MSGPACK_SUFFIX = ".msgpack"


def split_batch_stats(sd: dict[str, torch.Tensor]) -> tuple[dict, dict | None]:
    """``(params, batch_stats)`` of a saved ``state_dict``: the BatchNorm
    running statistics apart (``None`` when there are none), as flax keeps
    ``batch_stats`` beside ``params``."""
    stats = {n: t for n, t in sd.items() if n.rsplit(".", 1)[-1] in BATCH_STATS}
    params = {n: t for n, t in sd.items() if n not in stats}
    return params, (stats or None)


def _looks_like_orbax(p: Path) -> bool:
    """An Orbax layout: step directories of its own (``_CHECKPOINT_METADATA``,
    an item directory per step) where the port writes ``state.pt``."""
    for d in (p, *(p / s for s in ("best", "last"))):
        if not d.is_dir():
            continue
        for step in d.iterdir():
            if step.is_dir() and step.name.isdigit() and not (step / STATE_FILE).exists():
                if (step / "_CHECKPOINT_METADATA").exists() or (step / "state").is_dir():
                    return True
    return False


def _is_msgpack(path: str | Path) -> bool:
    return str(path).endswith(MSGPACK_SUFFIX)


def resolve_save(path: str | Path) -> Path:
    """What :func:`restore_inference_state` reads for ``path``: a flax
    ``.msgpack`` params file as it is; ``path`` itself when it holds
    ``state.pt``; else its newest committed ``best`` save, then ``last``,
    then step directories directly under it. An Orbax directory raises
    naming the conversion to ``.msgpack``."""
    s = str(path)
    p = Path(s)
    if _is_msgpack(s):
        if not p.is_file():
            raise FileNotFoundError(f"no flax params file {s}")
        return p
    if (p / STATE_FILE).is_file():
        return p
    for sub in ("best", "last", "."):
        root = p / sub
        steps = _committed(root) if root.is_dir() else []
        if steps:
            return root / str(steps[0])
    if p.is_dir() and _looks_like_orbax(p):
        raise NotImplementedError(ORBAX_NOT_PORTED.format(path=s))
    raise FileNotFoundError(f"no committed checkpoint under {s} (best/, last/ or step directories)")


def save_digest(path: str | Path) -> str:
    """A digest that names the save :func:`restore_inference_state` would
    read for ``path``, without reading its tensors: the resolved step
    directory, its commit marker's bytes, and ``state.pt``'s size and
    modification time (for a ``.msgpack`` file: its path, size and
    modification time). A save written again, even at the same step, gets
    another digest. The serving warm cache keys its entries on it."""
    d = resolve_save(path).resolve()
    if _is_msgpack(d):
        st = d.stat()
        parts = (str(d).encode(), f"{st.st_size}:{st.st_mtime_ns}".encode())
    else:
        st = (d / STATE_FILE).stat()
        parts = (str(d).encode(), (d / COMMIT_FILE).read_bytes(), f"{st.st_size}:{st.st_mtime_ns}".encode())
    h = hashlib.sha256()
    for part in parts:
        h.update(len(part).to_bytes(8, "little"))
        h.update(part)
    return h.hexdigest()[:16]


def restore_inference_state(path: str | Path) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor] | None]:
    """``(params, batch_stats)`` for serving, from a port save: the saved
    model's tensors by ``state_dict`` name, the BatchNorm statistics apart
    (``None`` for a save without BatchNorm; a linear probe's head has
    them). The JAX package's ``restore_inference_state``.

    ``path`` is a checkpoint directory or one step directory, resolved by
    :func:`resolve_save`. The file is memory-mapped and only the model's
    tensors are touched, so the optimizer's bytes are never read. A flax
    ``.msgpack`` params file (an MAE, classifier or bare ``JumboViT``
    tree) goes through ``interop/from_jax.py`` and has no statistics."""
    d = resolve_save(path)
    if _is_msgpack(d):
        return split_batch_stats(state_dict_from_flax(import_params_msgpack(d)))
    return split_batch_stats(_load_save(d, mmap=True)[0]["model"])


# ---------------------------------------------------------------- flax msgpack


def export_params_msgpack(params: dict, path: str | Path) -> None:
    """Write a flax params tree (nested dicts of numpy arrays or tensors:
    ``interop.from_jax.model_flax_tree`` gives a port model's) as the
    ``.msgpack`` file ``flax.serialization.msgpack_restore`` reads, the
    JAX package's ``export_params_msgpack`` for local paths: a temporary
    file fsynced, renamed into place, the directory fsynced, so a reader
    never sees a partial file."""
    target = Path(path)
    target.parent.mkdir(parents=True, exist_ok=True)
    payload = flax_msgpack.packb(params)
    tmp = target.with_suffix(target.suffix + ".tmp")
    _write_file(tmp, lambda f: f.write(payload))
    os.replace(tmp, target)
    _fsync_dir(target.parent)


def import_params_msgpack(path: str | Path) -> dict:
    """The params tree of a flax ``.msgpack`` file, numpy leaves (the JAX
    package's ``import_params_msgpack`` for local paths)."""
    return flax_msgpack.unpackb(Path(path).read_bytes())


# ---------------------------------------------------------------- warm starts

POSEMB_NAMES = ("pos_embed", "posemb", "wpe")
# the encoder is ``encoder`` in an MAEPretrainModel and ``model`` in a
# ClassificationModel; warm starts cross that boundary
ENCODER_KEYS = ("encoder", "model")


def _triangle_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image.resize``'s linear
    method along one axis (``compute_weight_mat``): the triangle kernel at
    half-pixel centres, widened by the downscale factor (antialiasing),
    normalized over the input; a sample outside the input weighs 0."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))  # a Python float, as JAX computes it, then float32
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0), f32(1) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps), w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= f32(-0.5)) & (sample <= f32(n_in - 0.5))
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def resize_posemb(posemb: np.ndarray, target_shape: tuple[int, ...]) -> np.ndarray:
    """Resize an (H, W, D) or (1, H, W, D) positional-embedding grid to
    another grid size as ``jax.image.resize(..., method="bilinear")`` does
    (antialiased when it shrinks): float32 separable triangle-kernel
    weights, in numpy. A grid of the target shape comes back as it is."""
    posemb = np.asarray(posemb)
    if posemb.shape == tuple(target_shape):
        return posemb
    if posemb.ndim != len(target_shape) or posemb.ndim not in (3, 4):
        raise ValueError(f"posemb resize expects (H,W,D) or (1,H,W,D) grids, got {posemb.shape} → {target_shape}")
    h_ax = posemb.ndim - 3
    out = posemb.astype(np.float32)
    for ax in (h_ax, h_ax + 1):
        n_in, n_out = out.shape[ax], int(target_shape[ax])
        if n_in == n_out:
            continue
        w = _triangle_weights(n_in, n_out)
        out = np.moveaxis(np.tensordot(out, w, axes=([ax], [0])), -1, ax)
    return out.astype(posemb.dtype)


def merge_pretrained_params(
    pretrained: dict[str, torch.Tensor],
    init_params: dict[str, torch.Tensor],
    *,
    verbose: bool = True,
    stats: dict | None = None,
) -> dict[str, torch.Tensor]:
    """Merge ``pretrained`` into ``init_params`` by name:

    - the same name and shape → the pretrained value (in the init's dtype);
    - a positional-embedding grid of another H/W → :func:`resize_posemb`;
    - any other shape mismatch (a head for another label count) → the
      fresh init;
    - names only in ``init_params`` (a new head) → the fresh init.

    Prints the JAX package's summary. ``stats`` receives its ``loaded``,
    ``resized``, ``skipped`` (shape mismatch) and ``unused`` (only in
    ``pretrained``) name lists, and ``new`` (only in ``init_params``)."""
    merged: dict[str, torch.Tensor] = {}
    loaded, resized, skipped, new = [], [], [], []
    for name, init_val in init_params.items():
        if name not in pretrained:
            merged[name] = init_val
            new.append(name)
            continue
        val = pretrained[name]
        if tuple(val.shape) == tuple(init_val.shape):
            merged[name] = val.to(init_val.dtype)
            loaded.append(name)
        elif name.rsplit(".", 1)[-1] in POSEMB_NAMES and val.dim() in (3, 4):
            grid = resize_posemb(val.float().numpy(), tuple(init_val.shape))
            merged[name] = torch.from_numpy(grid).to(init_val.dtype)
            resized.append(name)
        else:
            merged[name] = init_val
            skipped.append(name)
    unused = [n for n in pretrained if n not in init_params]
    if stats is not None:
        stats.update(loaded=loaded, resized=resized, skipped=skipped, unused=unused, new=new)
    if verbose:
        print(
            f"[checkpoint] pretrained merge: {len(loaded)} loaded, {len(resized)} resized, "
            f"{len(skipped)} shape-mismatch (fresh), {len(unused)} unused"
        )
        for what, names in (("resized", resized), ("fresh", skipped)):
            for n in sorted(names):
                print(f"[checkpoint]   {what}: {n}")
        for n in sorted(unused)[:20]:
            print(f"[checkpoint]   unused: {n}")
        if new:
            print(f"[checkpoint]   not in the checkpoint, kept fresh: {', '.join(sorted(new)[:20])}")
    return merged


def require_loaded(stats: dict, source, target_desc: str) -> None:
    """Exit unless a :func:`merge_pretrained_params` call (through its
    ``stats``) loaded something: a random init passed off as a warm start
    is worse than failing."""
    if not (stats.get("loaded") or stats.get("resized")):
        raise SystemExit(
            f"--ckpt {source} loaded 0 params into {target_desc} — wrong preset/shape or an unrelated params tree"
        )


def load_params_tree(path: str | Path) -> dict[str, torch.Tensor]:
    """The saved model tensors of a port checkpoint (a checkpoint directory,
    its newest committed ``last`` save, or one step directory), or of a
    flax ``.msgpack`` params file by ``state_dict`` name. An Orbax
    directory raises naming the conversion."""
    p = Path(path)
    if _is_msgpack(p):
        return state_dict_from_flax(import_params_msgpack(p))
    if (p / STATE_FILE).is_file():
        return _load_save(p, mmap=True)[0]["model"]
    if p.is_dir() and _looks_like_orbax(p):
        raise NotImplementedError(ORBAX_NOT_PORTED.format(path=str(p)))
    return read_state(p)["model"]


def _subtree(names, key: str) -> bool:
    return any(n.startswith(key + ".") for n in names)


def load_pretrained_params(
    path: str | Path,
    init_params: dict[str, torch.Tensor],
    *,
    verbose: bool = True,
    stats: dict | None = None,
) -> dict[str, torch.Tensor]:
    """Load a port checkpoint's parameters and merge them into
    ``init_params`` (a model's ``named_parameters()``; BatchNorm
    statistics stay fresh, as the JAX merge leaves ``batch_stats``).

    It finds the encoder on both sides (``encoder.`` in an MAE save,
    ``model.`` in a classifier) and merges across the rename: an MAE
    save's decoder, mask token and projections are dropped (listed in
    ``stats["dropped"]``), a classifier's head stays fresh. Where either
    side has no encoder subtree, the trees merge whole."""
    tree = load_params_tree(path)
    src_key = next((k for k in ENCODER_KEYS if _subtree(tree, k)), None)
    dst_key = next((k for k in ENCODER_KEYS if _subtree(init_params, k)), None)
    if src_key is None or dst_key is None:
        return merge_pretrained_params(tree, init_params, verbose=verbose, stats=stats)
    sp, dp = src_key + ".", dst_key + "."
    src = {n[len(sp):]: v for n, v in tree.items() if n.startswith(sp)}
    dst = {n[len(dp):]: v for n, v in init_params.items() if n.startswith(dp)}
    sub: dict = {}
    merged = merge_pretrained_params(src, dst, verbose=verbose, stats=sub)
    dropped = [n for n in tree if not n.startswith(sp)]
    if stats is not None:
        stats.update({k: [dp + n if k != "unused" else sp + n for n in v] for k, v in sub.items()})
        stats["dropped"] = dropped
    if verbose and dropped:
        print(f"[checkpoint]   dropped outside {src_key!r}: {len(dropped)} tensors (e.g. {sorted(dropped)[0]})")
    return {**init_params, **{dp + n: v for n, v in merged.items()}}
