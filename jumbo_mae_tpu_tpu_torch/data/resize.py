"""Resize-consistent shard assignment for elastic training.

A copy of ``jumbo_mae_tpu_tpu/data/resize.py``: the loader's
``shard_snapshot`` is built from :class:`ShardLedger` and
:func:`merge_shard_states`; the elastic supervisor that reads it is ROADMAP
A6/A7 and not ported yet.

When the JAX package's ``ElasticSupervisor``
relaunches a run at a different world size, the sample-exact cursor in the
checkpoint is useless: per-worker offsets describe streams striped for the
OLD ``(process_count, worker_count)`` topology, and replaying them under a
new one would re-read some shards and never read others. This module makes
the post-resize assignment a pure function of
``(world_size, process_id, journal cursor)``:

- every host journals a ``shard_cursor`` event at each checkpoint — the
  set of epoch-shard indices its streams have FULLY consumed as of that
  step (:class:`ShardLedger` tracks this exactly through the shuffle
  buffer);
- at a resized resume, the union of all old hosts' consumed sets is
  subtracted from the epoch's deterministic shard order, and the remainder
  is striped across the new world (:func:`resize_assignment`).

Guarantees (pinned for the JAX package by ``tests/test_elastic.py``): across the resize, the
union of shards consumed before the checkpoint and shards assigned after
it covers every shard of the epoch exactly once — no shard double-counted,
none skipped. Granularity is the SHARD: a shard that was only partially
consumed at the checkpointed step is replayed from its first sample (those
samples carry no surviving gradient in the rewound weights, so replay is
correct, not double-counting).

Shard identity is the GLOBAL INDEX into the epoch's deterministic shuffled
order (``shuffle_shards(expand_shards(spec), seed, epoch)``) — a portable
integer every process computes identically without communicating, which is
what lets per-host journals act as the cursor with no collective.
"""

from __future__ import annotations

from jumbo_mae_tpu_tpu_torch.data.shards import expand_shards, shuffle_shards


class ShardLedger:
    """Per-stream ledger of fully-consumed epoch shards.

    "Consumed" means every decoded sample of the shard has been YIELDED
    downstream — not merely read into the shuffle buffer. The stream calls
    :meth:`note_read` as each decoded sample enters the buffer,
    :meth:`note_read_done` when the shard's tar iteration finishes, and
    :meth:`note_yield` as each sample exits the buffer; a shard is
    promoted to ``consumed`` when its reads are done and every read sample
    has been yielded. A shard quarantined by the tar reader mid-epoch
    promotes like any other (matching the non-elastic one-pass-per-epoch
    behavior: a quarantined shard is not retried until the next epoch).

    Thread-compat: each stream owns its private ledger (one per
    (process, worker) pair); no locking needed.

    ``preconsumed`` seeds the ledger with shards consumed by EARLIER
    generations (the merged set a resized resume subtracted when it built
    the stripe of its resumed epoch from; ROADMAP A6). Without the seed, a fresh
    generation's ``shard_cursor`` snapshots would record only its own
    consumption, and the NEXT resize would re-assign everything consumed
    before the first one — snapshots must stay cumulative across
    generations for the conservation invariant to survive repeated
    world-size changes. Accepts the :meth:`snapshot` shape
    (``{"epochs": {str(epoch): [gidx, ...]}}``) or a bare
    ``{epoch: indices}`` mapping.
    """

    def __init__(self, preconsumed: dict | None = None):
        self._reads: dict[tuple[int, int], int] = {}
        self._yields: dict[tuple[int, int], int] = {}
        self._read_done: set[tuple[int, int]] = set()
        #: epoch -> sorted list of fully-consumed global shard indices
        self.consumed: dict[int, list[int]] = {}
        if preconsumed:
            epochs = preconsumed.get("epochs", preconsumed)
            for e, idxs in epochs.items():
                self.consumed[int(e)] = sorted(int(i) for i in idxs)

    def note_read(self, epoch: int, gidx: int) -> None:
        k = (epoch, gidx)
        self._reads[k] = self._reads.get(k, 0) + 1

    def note_read_done(self, epoch: int, gidx: int) -> None:
        k = (epoch, gidx)
        self._read_done.add(k)
        self._maybe_promote(k)

    def note_yield(self, epoch: int, gidx: int) -> None:
        k = (epoch, gidx)
        self._yields[k] = self._yields.get(k, 0) + 1
        self._maybe_promote(k)

    def _maybe_promote(self, k: tuple[int, int]) -> None:
        if k in self._read_done and self._yields.get(k, 0) >= self._reads.get(k, 0):
            epoch, gidx = k
            lst = self.consumed.setdefault(epoch, [])
            if gidx not in lst:
                lst.append(gidx)
                lst.sort()
            # retire the counters — the shard is settled
            self._read_done.discard(k)
            self._reads.pop(k, None)
            self._yields.pop(k, None)

    def snapshot(self) -> dict:
        """JSON-able state: ``{"epochs": {str(epoch): [gidx, ...]}}``."""
        return {"epochs": {str(e): list(v) for e, v in self.consumed.items()}}


def merge_shard_states(states) -> dict[int, set[int]]:
    """Union per-epoch consumed sets across ledger snapshots (one per old
    (process, worker) stream / host). ``None`` entries are skipped."""
    out: dict[int, set[int]] = {}
    for st in states:
        if not st:
            continue
        for e, idxs in (st.get("epochs") or {}).items():
            out.setdefault(int(e), set()).update(int(i) for i in idxs)
    return out


def epoch_shard_order(
    train_shards: str | list[str], *, seed: int, epoch: int
) -> list[str]:
    """The epoch's deterministic global shard order — identical on every
    process; the namespace the ledger's global indices live in."""
    return shuffle_shards(expand_shards(train_shards), seed=seed, epoch=epoch)


def resize_assignment(
    order: list[str],
    consumed,
    *,
    world_size: int,
    process_id: int,
    worker_index: int = 0,
    worker_count: int = 1,
) -> list[tuple[int, str]]:
    """Stripe the epoch's un-consumed remainder across the new world.

    Pure function of ``(world_size, process_id, cursor)``: ``order`` is
    the epoch's deterministic shard order, ``consumed`` the union of
    global indices fully consumed before the checkpointed step. Returns
    ``(global_index, url)`` pairs for one (process, worker) stream —
    order-preserving striping, same ``[p::N][w::W]`` discipline as
    :func:`~jumbo_mae_tpu_tpu_torch.data.shards.split_shards`, so the union over
    all new (process, worker) pairs is exactly the remainder, disjointly.
    """
    if not 0 <= process_id < world_size:
        raise ValueError(f"bad process {process_id}/{world_size}")
    if not 0 <= worker_index < worker_count:
        raise ValueError(f"bad worker {worker_index}/{worker_count}")
    gone = {int(i) for i in consumed}
    bad = [i for i in gone if not 0 <= i < len(order)]
    if bad:
        raise ValueError(f"consumed indices out of range: {sorted(bad)[:5]}")
    remaining = [(i, u) for i, u in enumerate(order) if i not in gone]
    return remaining[process_id::world_size][worker_index::worker_count]
