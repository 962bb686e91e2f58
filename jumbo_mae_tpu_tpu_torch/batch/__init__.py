"""Resumable, exactly-once offline batch inference over tar shards.

Counterpart of ``jumbo_mae_tpu_tpu/batch``.

Submodules:

- ``job``      — :class:`JobSpec` / :class:`BatchJobRunner`, the
  lease-fenced shard-parallel executor
- ``leases``   — :class:`LeaseTable`, journaled leases with expiry/steal
  and write fencing
- ``partfile`` — framed torn-tail-tolerant part files and the
  deterministic manifest
"""

from jumbo_mae_tpu_tpu_torch.batch.leases import LeaseTable
from jumbo_mae_tpu_tpu_torch.batch.partfile import (
    append_record,
    encode_record,
    file_sha256,
    finalize_part,
    iter_records,
    read_manifest,
    scan_part,
    write_manifest,
)

# the runner (and the serving stack it imports, torch included) loads on
# first use, so the offline doctor reads part files without it
_JOB = ("BatchJobRunner", "JobSpec", "default_decode", "part_stem")


def __getattr__(name: str):
    if name in _JOB:
        from jumbo_mae_tpu_tpu_torch.batch import job

        return getattr(job, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BatchJobRunner",
    "JobSpec",
    "LeaseTable",
    "append_record",
    "default_decode",
    "encode_record",
    "file_sha256",
    "finalize_part",
    "iter_records",
    "part_stem",
    "read_manifest",
    "scan_part",
    "write_manifest",
]
