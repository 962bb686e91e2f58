"""Persistent, crash-safe cache of the serving engine's built task weights.

Counterpart of ``jumbo_mae_tpu_tpu/infer/warmcache.py``. The JAX cache
holds AOT-compiled executables, so that a restarted replica compiles
nothing. The port has no executable to keep: the kernels' ``nvcc`` builds
already persist under ``ops/_build``'s directory, and a CUDA graph cannot
be serialized, so a restart still captures its graph ladder (counted in
the engine's ``compile_counts``, as before). What a restart rebuilds
besides is each task's model: the save's restore and graft, the random
init where one is drawn (no save, or a parameter the save leaves fresh)
and, with ``quant="int8"``, the quantization. An entry here is one task's
**built state dict** — grafted, and quantized where asked — as raw tensor
bytes behind a JSON header (names, dtypes, shapes, offsets). A hit maps
the file, checks its digest, and copies each tensor from the mapping into
a model constructed on the device without any init (the entry supplies
every tensor). It serves bit-equal outputs to a cold build, because it
holds the very tensors the cold build served. The engine keeps an entry
only for a build that drew the init or quantized: a build that only
copies the memory-mapped save's tensors is faster than reading an entry
of the same bytes. (A ``torch.save`` payload read back through
``torch.load`` was the first design; its deserialization copies every
tensor once more. PERF.md has the measurements.)

Because an entry holds the weights, its key names the save: the model
fingerprint covers every config field the forward depends on, the init
seed (a fresh parameter is part of the entry), the save's digest
(:func:`~jumbo_mae_tpu_tpu_torch.train.checkpoint.save_digest`), the torch
and CUDA versions and the device name; the entry name adds the task, the
compute dtype and the quant mode. The JAX key has no save in it: there
parameters are arguments of the executable, so every save of one
architecture shares its entries.

Kept from the JAX store, in order:

- **A corrupt entry must never crash the process.** A sha256 digest over
  the payload is verified *before* any byte is deserialized, writes are
  atomic (unique tmp + ``os.replace`` + ``fsync_dir``), and any entry that
  fails the header, digest or load is moved to ``quarantine/`` — kept for
  a postmortem, never retried. Every failure degrades to a miss that is
  counted (``stats()``, ``infer_warmcache_events_total``) and printed to
  stderr: the caller builds as if the cache were cold.
- **Bounded.** ``quarantine/`` keeps at most ``quarantine_keep`` entries
  no older than ``quarantine_max_age_s``; ``cache_max_bytes`` bounds the
  main directory (oldest entries first). The sweep runs when a process
  claims the directory and after each write.
- **Concurrent processes race safely.** Writers use per-process unique
  tmp names; readers see a complete old entry or a complete new one.

``python -m jumbo_mae_tpu_tpu_torch.infer.warmcache`` is the restart
probe: it builds an engine against ``--dir``, warms it, serves one batch
and prints one JSON line with the build and warmup seconds split into
their parts, the hits, captures, misses and quarantined entries.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import sys
import time
import uuid
from pathlib import Path

from jumbo_mae_tpu_tpu_torch.obs.journal import fsync_dir

# format version is part of MAGIC: bump it and every older entry misses
# cleanly (no attempt to parse an incompatible layout)
MAGIC = b"JWC1"
_DIGEST_LEN = 32  # sha256


def fingerprint(spec: dict) -> str:
    """Stable short hash of a JSON-able spec dict (the engine feeds every
    build-relevant config field through this)."""
    blob = json.dumps(spec, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def entry_name(
    fp: str, task_key: str, bucket: int, dtype: str, quant: str | None
) -> str:
    """Filesystem-safe cache entry name — the JAX package's (fingerprint,
    task, bucket, dtype, quant) schema. The engine's entries cover every
    bucket of a task and pass ``bucket=0``."""
    safe = lambda s: re.sub(r"[^A-Za-z0-9_.-]", "_", str(s))  # noqa: E731
    return (
        f"{safe(fp)}-{safe(task_key)}-b{int(bucket)}"
        f"-{safe(dtype)}-{safe(quant or 'none')}.exe"
    )


def device_fingerprint(device) -> str:
    """The device part of the default directory and of the engine's key:
    the device's name and the torch and CUDA versions (``cpu`` and the
    machine type on the CPU)."""
    import platform

    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
    else:
        name = f"cpu-{platform.machine()}"
    return f"{name}|torch {torch.__version__}|cuda {torch.version.cuda}"


def default_warmcache_dir(device="cuda") -> str | None:
    """Default root of the serving warm cache — the engine's
    ``warm_cache=True`` resolves through here. The JAX package's
    ``utils/procenv.default_warmcache_dir``, keyed on the device:

    - ``JUMBO_WARMCACHE=0`` disables the default entirely (the test suite
      sets this). An *explicit* ``warm_cache=<path>`` on the engine
      ignores this switch.
    - ``JUMBO_WARMCACHE_DIR`` overrides the location.
    - otherwise ``~/.cache/jumbo_mae_tpu/warmcache/dev-<hash>``, the hash
      of :func:`device_fingerprint`: entries built for one device and
      torch never load on another.
    """
    if os.environ.get("JUMBO_WARMCACHE", "1") == "0":
        return None
    override = os.environ.get("JUMBO_WARMCACHE_DIR")
    if override:
        return override
    key = hashlib.sha256(device_fingerprint(device).encode()).hexdigest()[:12]
    return os.path.join(
        os.path.expanduser("~"), ".cache", "jumbo_mae_tpu", "warmcache", f"dev-{key}"
    )


# An entry: MAGIC, sha256(payload), payload. The payload is a little-endian
# u64 header length, the JSON header {"tensors": [[name, dtype, shape,
# offset, nbytes], ...]}, then each tensor's bytes at its offset from the
# first 64-byte boundary after the header (offsets 64-byte aligned). A read
# maps the file, checks the digest over the mapping and takes each tensor
# as a view of it: no deserializing copy.
_ALIGN = 64


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _write_entry(f, state: dict) -> int:
    """Write ``state`` as an entry to the binary file ``f``; returns its
    size. The digest is written last, over what was written."""
    import torch

    host = {n: t.detach().to("cpu").contiguous() for n, t in state.items()}
    rows, off = [], 0
    for n, t in host.items():
        nbytes = t.numel() * t.element_size()
        rows.append([n, str(t.dtype).removeprefix("torch."), list(t.shape), off, nbytes])
        off = _aligned(off + nbytes)
    header = json.dumps({"tensors": rows}, separators=(",", ":")).encode()
    data0 = _aligned(len(MAGIC) + _DIGEST_LEN + 8 + len(header))
    h = hashlib.sha256()

    def put(b) -> None:
        h.update(b)
        f.write(b)

    f.write(MAGIC + bytes(_DIGEST_LEN))
    put(len(header).to_bytes(8, "little") + header)
    put(bytes(data0 - (len(MAGIC) + _DIGEST_LEN + 8 + len(header))))
    pos = 0
    for (_, _, _, offset, nbytes), t in zip(rows, host.values()):
        put(bytes(offset - pos))
        if nbytes:
            put(memoryview(t.view(-1).view(torch.uint8).numpy()))
        pos = offset + nbytes
    f.seek(len(MAGIC))
    f.write(h.digest())
    return data0 + pos


def _read_entry(f) -> dict:
    """The state dict of the entry in the open binary file ``f``, each
    tensor a view of a private memory map of it; raises on any damage
    before a byte of the payload is used."""
    import mmap

    import torch

    head = len(MAGIC) + _DIGEST_LEN
    mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    view = memoryview(mm)
    try:
        if len(mm) < head + 8 or view[: len(MAGIC)] != MAGIC:
            raise ValueError("bad magic/header")
        if hashlib.sha256(view[head:]).digest() != view[len(MAGIC) : head]:
            raise ValueError("payload digest mismatch (truncated write?)")
        hlen = int.from_bytes(view[head : head + 8], "little")
        rows = json.loads(bytes(view[head + 8 : head + 8 + hlen]))["tensors"]
    finally:
        view.release()
    data0 = _aligned(head + 8 + hlen)
    state = {}
    for name, dtype, shape, offset, nbytes in rows:
        dt = getattr(torch, dtype)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"entry {name}: unknown dtype {dtype!r}")
        if nbytes == 0:
            state[name] = torch.empty(shape, dtype=dt)
            continue
        if data0 + offset + nbytes > len(mm):
            raise ValueError(f"entry {name} runs past the file's end")
        state[name] = torch.frombuffer(mm, dtype=dt, count=nbytes // dt.itemsize, offset=data0 + offset).view(shape)
    return state


class WarmCache:
    """One directory of built task state dicts, with quarantine semantics.

    All failure paths degrade to a miss: the caller builds as if the
    cache were cold. ``stats()`` plus the ``infer_warmcache_*`` counters
    expose what actually happened.

    ``quarantine/`` is bounded: entries beyond ``quarantine_keep`` (newest
    kept) or older than ``quarantine_max_age_s`` are deleted when the cache
    directory is claimed (construction) and after each new quarantine — a
    crash-looping replica that corrupts an entry per restart must not fill
    the disk with postmortem copies.
    """

    def __init__(
        self,
        root: str | os.PathLike,
        *,
        registry=None,
        quarantine_keep: int = 32,
        quarantine_max_age_s: float = 7 * 24 * 3600.0,
        cache_max_bytes: int = 0,
    ):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        if registry is None:
            from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry

            registry = get_registry()
        self._m = registry.counter(
            "infer_warmcache_events_total",
            "warm-start cache events",
            labels=("event",),
        )
        self._m_pruned = registry.counter(
            "infer_warmcache_quarantine_pruned_total",
            "quarantined entries deleted by the count/age cap",
        )
        self._m_disk = registry.gauge(
            "infer_warmcache_disk_bytes",
            "on-disk bytes of main-dir cache entries + sidecars",
        )
        self.quarantine_keep = int(quarantine_keep)
        self.quarantine_max_age_s = float(quarantine_max_age_s)
        # optional byte bound on the MAIN dir (quarantine has its own
        # count/age cap): oldest-mtime entries and their sidecars are
        # deleted until the footprint fits. 0 = unbounded.
        self.cache_max_bytes = int(cache_max_bytes)
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.put_errors = 0
        self.quarantined = 0
        self.quarantine_pruned = 0
        self.main_pruned = 0
        # claim-time sweep: whoever opens the cache dir pays the prune, so
        # the bound holds even if every previous process crashed mid-flight
        self._prune_quarantine()
        self._prune_main()

    # ------------------------------------------------------------------ io

    def _miss(self, name: str, why: str) -> None:
        self.misses += 1
        self._m.labels("miss").inc()
        print(f"[warmcache] miss {name}: {why}", file=sys.stderr)

    def get(self, name: str, validate=None) -> dict | None:
        """One entry's state dict, or None (a miss, counted; a corrupt entry
        is quarantined first). The tensors are read-only views of the
        memory-mapped file, valid while they are referenced; the caller
        copies them where they are needed. ``validate(state)`` may raise to
        reject an entry that does not fit its reader, which then counts as
        corrupt."""
        path = self.root / name
        try:
            f = open(path, "rb")
        except OSError as e:
            self._miss(name, "absent" if isinstance(e, FileNotFoundError) else f"{type(e).__name__}: {e}")
            return None
        try:
            with f:
                state = _read_entry(f)
            if validate is not None:
                validate(state)
        except Exception as e:  # noqa: BLE001 — any corruption is a miss
            self._quarantine(path, e)
            self._miss(name, f"quarantined: {e}")
            return None
        self.hits += 1
        self._m.labels("hit").inc()
        return state

    def put(self, name: str, state: dict, meta: dict | None = None) -> int:
        """Write one state dict (its tensors copied to the host) and publish
        it atomically; best-effort (a full disk must not fail serving).
        Returns the entry's size in bytes (0 on failure). ``meta`` lands in
        a ``<name>.meta.json`` sidecar (what the build cost) so a
        warm-started process can credit what the hit saved."""
        path = self.root / name
        tmp = path.with_name(f".{name}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp")
        try:
            with open(tmp, "wb") as f:
                size = _write_entry(f, state)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            fsync_dir(self.root)  # rename alone is not durable over power loss
        except Exception as e:  # noqa: BLE001
            tmp.unlink(missing_ok=True)
            self.put_errors += 1
            self._m.labels("put_error").inc()
            print(f"[warmcache] put({name}) failed: {e}", file=sys.stderr)
            return 0
        self.puts += 1
        self._m.labels("put").inc()
        self._put_meta(name, {"entry_bytes": size, **(meta or {})})
        # re-enforce the byte bound (and refresh the disk gauge) after every
        # publish — the writer pays for its own growth
        self._prune_main()
        return size

    def _put_meta(self, name: str, meta: dict) -> None:
        """Atomic best-effort sidecar write; a corrupt/missing sidecar only
        loses metadata, never the entry."""
        path = self.root / f"{name}.meta.json"
        tmp = path.with_name(f".{path.name}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp")
        try:
            tmp.write_text(json.dumps(meta, sort_keys=True, default=str))
            os.replace(tmp, path)
            fsync_dir(self.root)
        except Exception:  # noqa: BLE001
            Path(tmp).unlink(missing_ok=True)

    def entry_meta(self, name: str) -> dict | None:
        """The ``put()`` metadata sidecar for one entry, or None."""
        try:
            return json.loads((self.root / f"{name}.meta.json").read_text())
        except Exception:  # noqa: BLE001 — metadata is advisory
            return None

    def _quarantine(self, path: Path, err: Exception):
        """Move a bad entry aside — kept for postmortem, never re-read."""
        qdir = self.root / "quarantine"
        dst = qdir / f"{path.name}.{os.getpid()}.{uuid.uuid4().hex[:8]}"
        try:
            qdir.mkdir(exist_ok=True)
            os.replace(path, dst)
            # both directories changed; sync both or a crash can resurrect
            # the corrupt entry under its servable name
            fsync_dir(qdir)
            fsync_dir(self.root)
        except OSError:
            path.unlink(missing_ok=True)
        self.quarantined += 1
        self._m.labels("quarantined").inc()
        print(
            f"[warmcache] quarantined corrupt entry {path.name}: {err}",
            file=sys.stderr,
        )
        self._prune_quarantine()

    def _prune_quarantine(self) -> int:
        """Enforce the quarantine count/age cap; returns entries deleted.
        Newest entries win the count cap — the freshest corruption is the
        one a postmortem wants."""
        qdir = self.root / "quarantine"
        try:
            entries = sorted(
                ((p.stat().st_mtime, p) for p in qdir.iterdir() if p.is_file()),
                reverse=True,
            )
        except OSError:
            return 0
        now = time.time()
        pruned = 0
        for rank, (mtime, path) in enumerate(entries):
            if rank < self.quarantine_keep and now - mtime <= self.quarantine_max_age_s:
                continue
            try:
                path.unlink()
            except OSError:
                continue
            pruned += 1
        if pruned:
            self.quarantine_pruned += pruned
            self._m_pruned.inc(pruned)
        return pruned

    def disk_bytes(self) -> int:
        """Main-dir footprint in bytes (entries + sidecars + in-flight
        tmps; ``quarantine/`` excluded — it has its own count/age bound)."""
        total = 0
        try:
            for p in self.root.iterdir():
                if not p.is_file():
                    continue
                try:
                    total += p.stat().st_size
                except OSError:
                    continue
        except OSError:
            return 0
        return total

    def _prune_main(self) -> int:
        """Enforce ``cache_max_bytes`` over the main dir, LRU by mtime:
        oldest entries (and their sidecars) are deleted until the footprint
        fits. Always refreshes ``infer_warmcache_disk_bytes``. Returns
        entries deleted."""
        pruned = 0
        if self.cache_max_bytes > 0:
            try:
                entries = sorted(
                    (p.stat().st_mtime, p) for p in self.root.glob("*.exe")
                )
            except OSError:
                entries = []
            total = self.disk_bytes()
            for _mtime, path in entries:
                if total <= self.cache_max_bytes:
                    break
                for victim in (path, self.root / f"{path.name}.meta.json"):
                    try:
                        size = victim.stat().st_size
                        victim.unlink()
                    except OSError:
                        continue
                    total -= size
                pruned += 1
                self._m.labels("pruned").inc()
            if pruned:
                self.main_pruned += pruned
        self._m_disk.set(self.disk_bytes())
        return pruned

    def stats(self) -> dict:
        return {
            "root": str(self.root),
            "entries": len(list(self.root.glob("*.exe"))),
            "disk_bytes": self.disk_bytes(),
            "hits": self.hits,
            "misses": self.misses,
            "puts": self.puts,
            "put_errors": self.put_errors,
            "quarantined": self.quarantined,
            "quarantine_pruned": self.quarantine_pruned,
            "main_pruned": self.main_pruned,
        }


# ------------------------------------------------------------- restart probe


def _probe_main(argv: list[str] | None = None) -> dict:
    """Restart probe: engine up against ``--dir``, warm, serve one batch,
    print a JSON line. Run twice against the same dir to measure a cold
    and a warm start; the second must report ``warm_hits`` > 0 and no
    miss."""
    import argparse

    p = argparse.ArgumentParser(description=_probe_main.__doc__)
    p.add_argument("--dir", required=True, help="warmcache directory")
    p.add_argument("--recipe", default=None, help="YAML recipe (default: CPU smoke)")
    p.add_argument(
        "--task", choices=("features", "logits", "reconstruct"), nargs="+", default=["features"],
        help="one task or several, warmed and served in turn by the one engine",
    )
    p.add_argument("--pool", choices=("cls", "gap", "tokens"), default="cls")
    p.add_argument("--ckpt", default="")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--buckets", type=int, nargs="*", default=None)
    p.add_argument("--quant", choices=("int8",), default=None)
    p.add_argument("--dtype", default=None)
    p.add_argument("--probe-images", type=int, default=3)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", default="", help="also write the JSON here")
    p.add_argument("--save-outputs", default="", help="write the probe batch's outputs per task here (.npz)")
    p.add_argument(
        "--set", dest="overrides", metavar="KEY.PATH=VALUE",
        nargs="*", action="extend", default=[],
    )
    args = p.parse_args(argv)

    import numpy as np

    from jumbo_mae_tpu_tpu_torch.config import load_config
    from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine

    recipe = args.recipe
    if recipe is None:
        recipe = str(
            Path(__file__).resolve().parents[2] / "recipes" / "smoke_cpu.yaml"
        )
    cfg = load_config(recipe, args.overrides)

    t0 = time.perf_counter()
    engine = InferenceEngine(
        cfg,
        ckpt=args.ckpt,
        dtype=args.dtype,
        max_batch=args.max_batch,
        quant=args.quant,
        warm_cache=args.dir,
        device=args.device,
    )
    init_s = time.perf_counter() - t0
    from jumbo_mae_tpu_tpu_torch.ops.flash import attention as flash

    t1 = time.perf_counter()
    captures = engine.warmup(
        tuple(args.task),
        pool=args.pool,
        buckets=tuple(args.buckets) if args.buckets else None,
    )
    warmup_s = time.perf_counter() - t1
    after_warm = sum(engine.compile_counts.values())
    images = (
        np.random.RandomState(0)
        .randint(0, 256, (args.probe_images, engine.image_size, engine.image_size, 3))
        .astype(np.uint8)
    )
    outputs = {}
    for task in args.task:
        kw = {"pool": args.pool} if task == "features" else {}
        out = engine.predict(images, task=task, **kw)
        outputs.update({f"{task}.{k}": v for k, v in out.items()} if isinstance(out, dict) else {task: out})
    if args.save_outputs:
        np.savez(args.save_outputs, **outputs)
    graphs = engine.graph_stats()
    report = {
        "probe": "warmcache",
        "dir": args.dir,
        "tasks": args.task,
        "quant": args.quant,
        "device": str(engine.device),
        "init_s": init_s,
        "warmup_s": warmup_s,
        "restore_s": engine.restore_s,
        "build": engine.build_split,
        "graphs": graphs,
        "first_run_s": sum(g["first_run_s"] for g in graphs.values()),
        "capture_s": sum(g["capture_s"] for g in graphs.values()),
        "captures": captures,
        "dispatches": engine.dispatches,
        "launches": {"K1": flash.LAUNCHES},
        "warm_hits": sum(engine.warm_hits.values()),
        "hot_path_captures": sum(engine.compile_counts.values()) - after_warm,
        "warmcache": engine.warmcache.stats() if engine.warmcache else None,
    }
    line = json.dumps(report, sort_keys=True)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return report


if __name__ == "__main__":
    _probe_main()
