"""On-disk validation-sample cache: evaluations after the first read no shard.

Counterpart of ``jumbo_mae_tpu_tpu/data/valcache.py``, with its layout,
key and hash, so a cache either package writes is read by the other. It
stores the post-transform eval images (resize and center crop applied,
fixed uint8 shape), so every evaluation after the first skips the shard
reads, the decode and the resize: it streams out of one memory-mapped
flat file.

Layout, under the cache directory, keyed by the first 16 hex digits of the
SHA-1 of the key fields as sorted JSON (the shard list, image size, crop
ratio and this process's stripe):

    val-<key>.bin    images, n × (S, S, 3) uint8, written in order
    val-<key>.json   labels, the sample count and the key fields; written
                     last, so its presence is the commit marker: a crash
                     mid-capture leaves only a .tmp, which the next pass
                     writes again.
"""

from __future__ import annotations

import hashlib
import json
import os
import uuid
from collections.abc import Iterator
from pathlib import Path

import numpy as np

Sample = tuple[np.ndarray, int]


class ValidSampleCache:
    """Write-once, read-many cache of one process's eval-sample stream."""

    def __init__(self, directory: str, key_fields: dict, image_size: int):
        self.image_size = int(image_size)
        self.key_fields = dict(key_fields)
        blob = json.dumps(self.key_fields, sort_keys=True, default=str)
        key = hashlib.sha1(blob.encode()).hexdigest()[:16]
        root = Path(directory)
        root.mkdir(parents=True, exist_ok=True)
        self.data_path = root / f"val-{key}.bin"
        self.meta_path = root / f"val-{key}.json"

    def complete(self) -> bool:
        """True when a committed cache for these key fields exists."""
        if not (self.meta_path.is_file() and self.data_path.is_file()):
            return False
        try:
            meta = json.loads(self.meta_path.read_text())
        except (OSError, ValueError):
            return False
        if meta.get("key_fields") != json.loads(
            json.dumps(self.key_fields, default=str)
        ):
            return False
        expect = meta["count"] * self.image_size * self.image_size * 3
        return self.data_path.stat().st_size == expect

    def capture(self, stream: Iterator[Sample]) -> Iterator[Sample]:
        """Pass ``stream`` through while writing it to the cache; the cache
        commits only if the stream is drained to the end."""
        # unique per writer: concurrent jobs sharing a cache dir must not
        # interleave into one tmp file (the atomic replace only isolates
        # writers if each writes its own file; last committer wins)
        tmp = self.data_path.with_suffix(f".bin.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp")
        labels: list[int] = []
        finished = False
        try:
            with open(tmp, "wb") as f:
                for img, label in stream:
                    f.write(np.ascontiguousarray(img, np.uint8).tobytes())
                    labels.append(int(label))
                    yield img, label
            finished = True
        finally:
            if finished:
                tmp.replace(self.data_path)
                # atomic like the .bin commit: a racing reader must never
                # see a truncated JSON
                meta_tmp = self.meta_path.with_suffix(".json.tmp")
                meta_tmp.write_text(
                    json.dumps(
                        {
                            "count": len(labels),
                            "labels": labels,
                            "key_fields": self.key_fields,
                        },
                        default=str,
                    )
                )
                meta_tmp.replace(self.meta_path)
            else:
                tmp.unlink(missing_ok=True)

    def read(self) -> Iterator[Sample]:
        """Stream samples back from the committed cache (memory-mapped; no
        shard IO, no decode)."""
        meta = json.loads(self.meta_path.read_text())
        n, s = meta["count"], self.image_size
        if n == 0:  # np.memmap cannot map an empty file; an empty stripe
            return  # (process_count > shards) is a legal committed cache
        images = np.memmap(self.data_path, np.uint8, mode="r", shape=(n, s, s, 3))
        for i, label in enumerate(meta["labels"]):
            yield images[i], int(label)
