"""Durable, torn-tail-tolerant per-shard output files ("parts").

Counterpart of ``jumbo_mae_tpu_tpu/batch/partfile.py``: the same frames,
canonical JSON and manifest, byte for byte, so the two packages write
identical parts and manifests for the same records (a torch tensor
encodes as the numpy array it equals).

The batch runner's exactly-once guarantee at the output rests on three
properties of this file format, mirroring the run journal's crash contract
(`obs/journal.py`):

- **append-only framed records** — each record is ``MAGIC + u32 length +
  sha256(payload)[:8] + payload``; a SIGKILL mid-append leaves a torn final
  frame that :func:`scan_part` detects (bad magic, short payload, or digest
  mismatch) and truncates, never a corrupted earlier record;
- **the partial file IS the resume cursor** — the number of good frames in
  ``<stem>.partial`` is exactly how many samples of the shard are durable;
  a restarted job re-streams the shard and skips that many samples (tar
  order is deterministic, so the skipped prefix is the written prefix);
- **deterministic bytes** — payloads are canonical JSON (sorted keys, fixed
  separators, numpy coerced to plain lists/scalars) of ``{key, out}``, so a
  killed-and-restarted job recomputes byte-identical frames and the final
  part file (and therefore the manifest's sha256) matches a fault-free run.

Completion is an atomic rename ``.partial`` → ``.part`` followed by an
``fsync_dir`` of the parent (rename alone is not durable across power
loss); the manifest lists every part with its sample count and sha256 and
carries **no timestamps or attempt counts** — byte-identical manifests are
the proof the chaos suite asserts.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
from collections.abc import Iterator
from pathlib import Path

from jumbo_mae_tpu_tpu_torch.obs.journal import fsync_dir

MAGIC = b"JMB1"
_HEAD = struct.Struct("<4sI8s")  # magic, payload length, sha256(payload)[:8]


def _json_default(obj):
    import numpy as np

    if type(obj).__module__.startswith("torch") and hasattr(obj, "detach"):
        # a tensor as the numpy array it equals (bf16, which numpy lacks,
        # widens exactly to float32 first)
        t = obj.detach().cpu()
        if str(t.dtype) == "torch.bfloat16":
            t = t.float()
        obj = t.numpy()
    if isinstance(obj, (np.floating, np.integer, np.bool_)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (bytes, bytearray)):
        return hashlib.sha256(bytes(obj)).hexdigest()
    raise TypeError(f"not JSON-encodable in a part record: {type(obj)!r}")


def encode_record(key: str, out) -> bytes:
    """Canonical payload bytes for one sample's result — deterministic
    across runs (sorted keys, fixed separators, no floats reformatting
    beyond json's repr, numpy coerced to plain types)."""
    return json.dumps(
        {"key": key, "out": out},
        sort_keys=True,
        separators=(",", ":"),
        default=_json_default,
        allow_nan=False,
    ).encode("utf-8")


def append_record(f, payload: bytes) -> None:
    """Append one framed record to an open binary file handle."""
    digest = hashlib.sha256(payload).digest()[:8]
    f.write(_HEAD.pack(MAGIC, len(payload), digest))
    f.write(payload)


def scan_part(path: str | Path) -> tuple[int, int]:
    """``(records, good_bytes)`` of a part/partial file — the resume
    cursor. Stops at the first torn/damaged frame; ``good_bytes`` is the
    offset a resuming writer must truncate to before appending."""
    p = Path(path)
    if not p.exists():
        return 0, 0
    data = p.read_bytes()
    off = 0
    n = 0
    while off + _HEAD.size <= len(data):
        magic, length, digest = _HEAD.unpack_from(data, off)
        if magic != MAGIC:
            break
        end = off + _HEAD.size + length
        if end > len(data):
            break
        payload = data[off + _HEAD.size : end]
        if hashlib.sha256(payload).digest()[:8] != digest:
            break
        n += 1
        off = end
    return n, off


def iter_records(path: str | Path) -> Iterator[dict]:
    """Yield the decoded ``{key, out}`` record dicts of a part file."""
    p = Path(path)
    data = p.read_bytes()
    off = 0
    while off + _HEAD.size <= len(data):
        magic, length, digest = _HEAD.unpack_from(data, off)
        if magic != MAGIC:
            break
        end = off + _HEAD.size + length
        if end > len(data):
            break
        payload = data[off + _HEAD.size : end]
        if hashlib.sha256(payload).digest()[:8] != digest:
            break
        yield json.loads(payload)
        off = end


def finalize_part(partial: Path, part: Path) -> str:
    """Durably promote ``.partial`` → ``.part``: fsync the data, atomic
    rename, fsync the directory; returns the part's content sha256."""
    fd = os.open(str(partial), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(partial, part)
    fsync_dir(part.parent)
    return file_sha256(part)


def file_sha256(path: str | Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_manifest(path: str | Path, entries: list[dict], total: int) -> str:
    """Atomically write the deterministic job manifest (no timestamps, no
    attempt counts — only what the data IS); returns its content sha256."""
    p = Path(path)
    payload = json.dumps(
        {"shards": entries, "total_samples": total},
        sort_keys=True,
        indent=2,
    ) + "\n"
    tmp = p.with_suffix(p.suffix + f".tmp.{os.getpid()}")
    tmp.write_text(payload, encoding="utf-8")
    fd = os.open(str(tmp), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, p)
    fsync_dir(p.parent)
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()


def read_manifest(path: str | Path) -> dict | None:
    try:
        return json.loads(Path(path).read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError):
        return None
