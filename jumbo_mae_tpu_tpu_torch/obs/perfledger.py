"""Schema-versioned perf-regression ledger: BENCH_HISTORY.jsonl.

Counterpart of ``jumbo_mae_tpu_tpu/obs/perfledger.py``, with the same
names, row shape and file. A bench appends one row here, and
``tools/perf_doctor.py`` reads the trail back to call regressions.

Row shape (``LEDGER_SCHEMA`` = 1)::

    {"schema": 1, "ts": ..., "bench": "train"|"infer", "metric": ...,
     "git_sha": ..., "env": {...}, "env_key": "...",
     "legs": {name: value}, "quantiles": {name: value},
     "prediction": {...roofline...} | null}

Comparability is explicit: ``env_key`` hashes the subset of the
environment fingerprint (``obs/journal.py`` ``env_fingerprint``) that
makes two rows comparable — host, python, the port's version, torch and
CUDA versions, backend, device count and the card's name — and leaves out
per-process noise (pid, argv): two runs of one bench on one host get the
same key. The doctor baselines a row only against same-``env_key``
history.

Writes reuse the journal's crash-safety idioms (sanitize + fsync per
line; torn final lines are skipped on read) and are best-effort: a
read-only directory or a full disk never fails a bench.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from jumbo_mae_tpu_tpu_torch.obs.journal import _json_default, _sanitize, env_fingerprint, read_journal

LEDGER_SCHEMA = 1
DEFAULT_LEDGER = "BENCH_HISTORY.jsonl"

# env_fingerprint keys that make two rows comparable; pid/argv/process-local
# env vars are deliberately absent.
_COMPARABLE_KEYS = (
    "version",
    "python",
    "platform",
    "hostname",
    "torch",
    "cuda",
    "backend",
    "device_count",
    "device",
)


def git_sha() -> str:
    """Short sha of the repo HEAD, or "" outside a checkout."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True,
            text=True,
            timeout=5,
            cwd=Path(__file__).resolve().parent,
        ).stdout.strip()
    except Exception:  # noqa: BLE001 - best-effort provenance
        return ""


def comparable_env() -> dict:
    """The env-fingerprint subset two comparable bench rows must share;
    ``device_kind`` names the card (``torch.cuda.get_device_name``), or
    ``cpu``, so a row of one card never baselines another's."""
    fp = env_fingerprint()
    env = {k: fp[k] for k in _COMPARABLE_KEYS if k in fp}
    env["device_kind"] = fp.get("device") or fp.get("backend") or "unavailable"
    return env


def env_key(env: dict) -> str:
    blob = json.dumps(_sanitize(env), sort_keys=True, default=_json_default)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def make_row(
    *,
    bench: str,
    metric: str,
    legs: dict,
    quantiles: dict | None = None,
    prediction: dict | None = None,
    extra: dict | None = None,
) -> dict:
    """One schema-versioned ledger row. ``legs`` maps leg name → headline
    number; ``quantiles`` carries latency percentiles; ``prediction`` is the
    cost model's roofline (``dataclasses.asdict`` of a ``PerfPrediction``)."""
    env = comparable_env()
    row = {
        "schema": LEDGER_SCHEMA,
        "ts": round(time.time(), 3),
        "bench": bench,
        "metric": metric,
        "git_sha": git_sha(),
        "env": env,
        "env_key": env_key(env),
        "legs": dict(legs),
        "quantiles": dict(quantiles or {}),
        "prediction": prediction,
    }
    if extra:
        row.update(extra)
    return row


def append_row(path: str | os.PathLike, row: dict) -> bool:
    """Append one row, fsync'd; best-effort (False + stderr on failure)."""
    try:
        line = json.dumps(_sanitize(row), default=_json_default, separators=(",", ":"), allow_nan=False)
        p = Path(path)
        if p.parent and not p.parent.exists():
            p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "a", encoding="utf-8") as f:
            # a prior crash can leave a torn line with no trailing newline;
            # start on a fresh line so the torn fragment corrupts only
            # itself, not this row
            if f.tell() > 0:
                with open(p, "rb") as rf:
                    rf.seek(-1, os.SEEK_END)
                    if rf.read(1) != b"\n":
                        f.write("\n")
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())
    except Exception as e:  # noqa: BLE001 - a bench must not fail on this
        print(f"[perfledger] append to {path} failed: {e}", file=sys.stderr)
        return False
    return True


def read_ledger(path: str | os.PathLike) -> list[dict]:
    """Every parseable row in file order; torn final lines are skipped
    (same reader contract as the run journal)."""
    rows = read_journal(path)
    return [r for r in rows if r.get("schema") and r.get("bench")]


def resolve_history_path(cli_value: str | None = None) -> Path | None:
    """Where a bench should append: the CLI flag wins, then the
    ``BENCH_HISTORY`` env var, then ``BENCH_HISTORY.jsonl`` in the CWD.
    ``off``/``0``/``none``/empty-string disables the ledger (returns None)."""
    value = cli_value if cli_value is not None else os.environ.get("BENCH_HISTORY", DEFAULT_LEDGER)
    if not value or str(value).lower() in ("off", "0", "none"):
        return None
    return Path(value)
