"""Journaled shard leases with expiry, steal, and write fencing.

Counterpart of ``jumbo_mae_tpu_tpu/batch/leases.py``, the same table,
transitions and journal events.

A batch job decomposes into per-shard work units; a worker *claims* a
shard by taking a lease on it. Leases make worker death a non-event
instead of a stuck job:

- a live worker **renews** its lease every progress window, so the expiry
  horizon (``lease_s``) bounds how long a dead worker's shard stays
  orphaned;
- a claim that finds a leased-but-expired shard **steals** it — the
  ``job_lease`` journal event carries ``stolen_from`` so the offline
  doctor can name the worker whose work was rescued;
- every lease carries a monotonically increasing **lease id**, the fencing
  token: the shard writer re-checks :meth:`holds` under the per-shard
  write lock before every append window, so a slow-but-alive worker whose
  lease was stolen can never interleave frames with the thief (its next
  write attempt is fenced off instead).

All transitions are journaled (``job_lease``) for the lease timeline in
``tools/batch_doctor.py``; the in-memory table is the *authority* for the
current process — a restarted job rebuilds shard state from the durable
part files, not from the journal (observability, not recovery).
"""

from __future__ import annotations

import threading
import time
from typing import Callable


class LeaseTable:
    """Thread-safe shard → lease state table for in-process workers."""

    def __init__(
        self,
        shards,
        *,
        lease_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        journal=None,
    ):
        self.lease_s = float(lease_s)
        self._clock = clock
        self._journal = journal
        self._lock = threading.Lock()
        # per-shard write fence: append windows and steal-time truncation
        # serialize here, so a fenced writer can never interleave frames
        self._fences = {s: threading.Lock() for s in shards}
        self._st: dict[str, dict] = {
            s: {"state": "pending", "worker": None, "lease": 0, "expires": 0.0}
            for s in shards
        }
        self._next_lease = 0
        self._steals = 0

    def shard_fence(self, shard: str) -> threading.Lock:
        return self._fences[shard]

    def claim(self, worker: str) -> tuple[str, int] | None:
        """Take the first pending — or leased-but-expired — shard; returns
        ``(shard, lease_id)`` or ``None`` when nothing is claimable now.
        Stealing an expired lease is journaled with ``stolen_from``."""
        now = self._clock()
        with self._lock:
            take = stolen = None
            for s, st in self._st.items():
                if st["state"] == "pending":
                    take = s
                    break
                if st["state"] == "leased" and st["expires"] <= now:
                    take, stolen = s, st["worker"]
                    break
            if take is None:
                return None
            self._next_lease += 1
            lease = self._next_lease
            self._st[take].update(
                state="leased", worker=worker, lease=lease,
                expires=now + self.lease_s,
            )
            if stolen is not None:
                self._steals += 1
        if self._journal is not None:
            fields = {"shard": take, "worker": worker, "lease": lease,
                      "lease_s": self.lease_s}
            if stolen is not None:
                fields["stolen_from"] = stolen
            self._journal.event("job_lease", **fields)
        return take, lease

    def holds(self, shard: str, worker: str, lease: int) -> bool:
        """The fencing check: does ``worker`` still own ``shard`` under
        this lease id? False the instant the lease is stolen/released."""
        with self._lock:
            st = self._st[shard]
            return (
                st["state"] == "leased"
                and st["worker"] == worker
                and st["lease"] == lease
            )

    def renew(self, shard: str, worker: str, lease: int) -> bool:
        with self._lock:
            st = self._st[shard]
            if (
                st["state"] == "leased"
                and st["worker"] == worker
                and st["lease"] == lease
            ):
                st["expires"] = self._clock() + self.lease_s
                return True
            return False

    def release(self, shard: str, worker: str, lease: int) -> bool:
        """Voluntarily hand a shard back (error path, graceful drain) —
        it becomes claimable immediately instead of at lease expiry."""
        with self._lock:
            st = self._st[shard]
            if (
                st["state"] == "leased"
                and st["worker"] == worker
                and st["lease"] == lease
            ):
                st.update(state="pending", worker=None, lease=0, expires=0.0)
                return True
            return False

    def complete(self, shard: str, worker: str, lease: int) -> bool:
        """Fenced completion: only the current lease holder can mark a
        shard done (a fenced zombie's complete is a no-op)."""
        with self._lock:
            st = self._st[shard]
            if (
                st["state"] == "leased"
                and st["worker"] == worker
                and st["lease"] == lease
            ):
                st.update(state="done", worker=None, expires=0.0)
                return True
            return False

    def mark_done(self, shard: str) -> None:
        """Pre-resolved at startup (a durable final part already exists)."""
        with self._lock:
            self._st[shard].update(
                state="done", worker=None, lease=0, expires=0.0
            )

    def done(self) -> bool:
        with self._lock:
            return all(st["state"] == "done" for st in self._st.values())

    def counts(self) -> dict[str, int]:
        out = {"pending": 0, "leased": 0, "done": 0}
        with self._lock:
            for st in self._st.values():
                out[st["state"]] += 1
        return out

    @property
    def steals(self) -> int:
        with self._lock:
            return self._steals
