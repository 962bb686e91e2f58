"""Shard-list handling: brace expansion, deterministic shuffles, striping.

A copy of ``jumbo_mae_tpu_tpu/data/shards.py`` (standard library only), so
both packages stripe and shuffle a shard list identically.

The reference streamed webdataset tars and relied on webdataset's
``SimpleShardList`` + ``detshuffle`` + ``wds.slice(process, None,
process_count)`` + ``split_by_worker`` chain to hand each DataLoader worker a
disjoint shard subset (its ``src/dataset.py``). This
module is a from-scratch equivalent with explicit, testable semantics:

- ``expand_shards`` understands the webdataset brace notation
  ``prefix-{000000..001023}.tar`` plus ``::``-joined multi-specs;
- ``shuffle_shards`` is a seeded Fisher–Yates keyed on (seed, epoch) so every
  process computes the SAME shard order without communicating;
- ``split_shards`` stripes that order first across processes then across
  workers — disjoint coverage, same contract as the reference chain.
"""

from __future__ import annotations

import random
import re

_BRACE = re.compile(r"\{(\d+)\.\.(\d+)\}")


def expand_shards(spec: str | list[str]) -> list[str]:
    """Expand a shard spec into an explicit URL list.

    ``spec`` may be a list (returned as-is), a ``::``-joined concatenation of
    specs, or a single pattern with at most one ``{AAAA..BBBB}`` numeric
    range (zero-padded to the width of the start literal).
    """
    if isinstance(spec, list):
        return list(spec)
    out: list[str] = []
    for part in spec.split("::"):
        m = _BRACE.search(part)
        if not m:
            out.append(part)
            continue
        start, end = m.group(1), m.group(2)
        width = len(start)
        lo, hi = int(start), int(end)
        if hi < lo:
            raise ValueError(f"empty brace range in {part!r}")
        for i in range(lo, hi + 1):
            out.append(part[: m.start()] + str(i).zfill(width) + part[m.end() :])
    return out


def shuffle_shards(shards: list[str], *, seed: int, epoch: int = 0) -> list[str]:
    """Deterministic shard-order shuffle, identical on every process.

    Keyed on (seed, epoch) so each pass over the dataset sees a fresh order
    while remaining reproducible (the reference's ``detshuffle`` epoch
    counter behaved the same way).
    """
    order = list(shards)
    random.Random(f"{seed}:{epoch}").shuffle(order)
    return order


def split_shards(
    shards: list[str],
    *,
    process_index: int = 0,
    process_count: int = 1,
    worker_index: int = 0,
    worker_count: int = 1,
) -> list[str]:
    """Stripe shards across processes, then across that process's workers.

    Guarantees: disjoint across (process, worker) pairs; union over all pairs
    covers every shard; stable for a fixed input order.
    """
    if not 0 <= process_index < process_count:
        raise ValueError(f"bad process {process_index}/{process_count}")
    if not 0 <= worker_index < worker_count:
        raise ValueError(f"bad worker {worker_index}/{worker_count}")
    per_process = shards[process_index::process_count]
    return per_process[worker_index::worker_count]
