"""Data-worker entry point: ``python -m jumbo_mae_tpu_tpu_torch.data._worker``.

Counterpart of ``jumbo_mae_tpu_tpu/data/_worker.py``. Workers are fresh
interpreters, not ``multiprocessing`` children: ``spawn`` re-imports the
user's ``__main__`` and ``fork`` duplicates a parent that holds CUDA state.
A worker imports only the data modules, never torch, so it never
initialises CUDA; the parent also hides the GPUs from it
(``CUDA_VISIBLE_DEVICES`` empty).

Protocol: the worker reads a JSON config blob from argv, then streams
batches to stdout as length-prefixed pickle frames:

    [8-byte big-endian length][pickle({"images": ..., "labels": ...})] ...

Backpressure is the pipe buffer; worker death is an EOF on the pipe.
"""

from __future__ import annotations

import json
import pickle
import struct
import sys


def _run(cfg_json: str) -> None:
    from jumbo_mae_tpu_tpu_torch.data.loader import (
        DataConfig,
        StreamCursor,
        batch_train_samples,
        train_sample_stream,
    )
    from jumbo_mae_tpu_tpu_torch.data.resize import ShardLedger

    spec = json.loads(cfg_json)
    cfg = DataConfig(**spec["data"])
    start_epoch = spec.get("start_epoch", 0)
    cursor = StreamCursor(start_epoch, spec.get("skip_samples", 0))
    ledger = ShardLedger()
    stream = train_sample_stream(
        cfg,
        process_index=spec["process_index"],
        process_count=spec["process_count"],
        worker_index=spec["worker_index"],
        worker_count=spec["worker_count"],
        start_epoch=start_epoch,
        skip_samples=spec.get("skip_samples", 0),
        cursor=cursor,
        ledger=ledger,
    )
    out = sys.stdout.buffer
    for batch in batch_train_samples(stream, spec["batch_size"], cfg.repeats, cursor=cursor, ledger=ledger):
        payload = pickle.dumps(batch, protocol=pickle.HIGHEST_PROTOCOL)
        out.write(struct.pack(">Q", len(payload)))
        out.write(payload)
        out.flush()


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit("usage: python -m jumbo_mae_tpu_tpu_torch.data._worker <json>")
    try:
        _run(sys.argv[1])
    except (BrokenPipeError, KeyboardInterrupt):
        pass


if __name__ == "__main__":
    main()
