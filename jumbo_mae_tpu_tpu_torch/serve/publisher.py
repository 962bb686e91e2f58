"""Gated train→serve weights publisher and artifact verification.

Counterpart of ``jumbo_mae_tpu_tpu/serve/publisher.py``. The serving tier
polls a ``--swap-watch`` directory and hot-swaps what lands there
(``infer/replicaset.py``'s ``WeightSwapController``: restore → parity →
canary → promote). This module feeds that directory from training:

- :class:`CheckpointPublisher` registers on the
  :class:`~jumbo_mae_tpu_tpu_torch.train.engine.RunEngine` checkpoint
  hook. Every interval checkpoint that passes the gates — no non-finite
  step and no rollback since the last save, at least
  ``min_interval_steps`` since the last publish, and optionally an eval
  metric above or below a floor — is exported as an inference artifact.
- **int8 at publish time**: matmul kernels are quantized once on the
  training host (``infer/quant.py``'s per-output-channel rule) instead of
  on every replica; ``quant="none"`` ships float32.
- **Delta against the last published tree**: only leaves whose
  (quantized) bytes changed ride in the payload; the manifest records
  every leaf's digest and whether it lives here or in the base, plus the
  base's name and fingerprint. A full tree every ``full_every``
  publishes keeps chains short.
- **Atomic commit**: staged in a dot-prefixed directory the watcher
  skips, fsync'd, ``os.replace``'d into place, the parent fsync'd.
- **A parity fingerprint** (sha256 over every leaf's digest) that
  :func:`verify_artifact` and :func:`resolve_chain` recompute before any
  byte reaches a live model; the ``publish.export`` fault site
  (``faults/inject.py``) corrupts the payload after the digests are
  sealed, for the chaos drills.
- Publish wall time is billed to a ``publish`` tenant through
  :class:`~jumbo_mae_tpu_tpu_torch.serve.costmeter.CostMeter`.

The tree is the flax layout (:func:`~jumbo_mae_tpu_tpu_torch.interop.from_jax.model_flax_tree`
of the model), and ``_leaf_digest`` and :func:`tree_fingerprint` are the
JAX package's byte for byte, so the same weights fingerprint alike in
both packages. The payload differs: the JAX package writes flax msgpack;
the port writes an uncompressed ``.npz`` (``numpy.load`` with
``allow_pickle=False`` reads it; no pickle) with one array per leaf part,
named ``<leaf path>::<part>`` (``q``/``scale`` for int8 leaves, ``v``
for the rest). Artifact layout, one directory per publish::

    <publish_dir>/publish-000007/
        manifest.json       # schema, step, leaf digests, chain link, gates
        weights.npz         # {path::q, path::scale} | {path::v}

``python -m jumbo_mae_tpu_tpu_torch.tools.publish_doctor DIR`` audits a
directory offline.
"""

from __future__ import annotations

import hashlib
import io
import json
import math
import os
import re
import shutil
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from jumbo_mae_tpu_tpu_torch.faults import fault_point
from jumbo_mae_tpu_tpu_torch.obs.journal import fsync_dir
from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry

SCHEMA = 1
MANIFEST = "manifest.json"
PAYLOAD = "weights.npz"
_NAME_RE = re.compile(r"^publish-(\d{6})$")
_QKV = ("q", "k", "v")
_SEP = "::"


class PublishIntegrityError(RuntimeError):
    """An artifact failed verification: torn write, corrupted payload,
    fingerprint mismatch, or a broken or cyclic delta chain. The watcher
    quarantines on this; it must never crash the serving process."""


# --------------------------------------------------------------- tree codec


class _Q8:
    """An int8 leaf: ``q`` and its float32 ``scale`` (numpy)."""

    __slots__ = ("q", "scale")

    def __init__(self, q: np.ndarray, scale: np.ndarray):
        self.q = q
        self.scale = scale


def _reduction_axes(names: list[str], ndim: int) -> tuple[int, ...]:
    """The JAX rule on flax layouts: q/k/v kernels (D, H, hd) keep their
    trailing (H, hd); every other kernel keeps its last axis."""
    if ndim >= 3 and len(names) >= 2 and names[-2] in _QKV:
        return tuple(range(ndim - 2))
    return tuple(range(ndim - 1))


def quantize_tree(params: dict) -> tuple[dict, dict]:
    """Quantize a flax params tree as the JAX package's ``quantize_params``
    does: every ``kernel`` leaf with ndim >= 2 becomes an int8 leaf with
    per-output-channel scales (``infer/quant.py``'s ``quantize_tensor``),
    the rest passes through. Returns ``(tree, report)``."""
    import torch

    from jumbo_mae_tpu_tpu_torch.infer.quant import quantize_tensor

    report = {"n_quantized": 0, "n_kept": 0, "bytes_before": 0, "bytes_after": 0}

    def visit(node, names):
        if isinstance(node, dict):
            return {k: visit(v, [*names, str(k)]) for k, v in node.items()}
        arr = np.asarray(node)
        nbytes = int(arr.size * arr.dtype.itemsize)
        report["bytes_before"] += nbytes
        if names and names[-1] == "kernel" and arr.ndim >= 2:
            qt = quantize_tensor(torch.from_numpy(np.array(arr, np.float32)), _reduction_axes(names, arr.ndim))
            leaf = _Q8(qt.q.numpy(), qt.scale.numpy())
            report["n_quantized"] += 1
            report["bytes_after"] += int(leaf.q.size + leaf.scale.size * leaf.scale.dtype.itemsize)
            return leaf
        report["n_kept"] += 1
        report["bytes_after"] += nbytes
        return node

    tree = visit(params, [])
    report["compression"] = round(report["bytes_before"] / max(report["bytes_after"], 1), 3)
    return tree, report


def _flatten(node, prefix: str, out: dict) -> None:
    if node is None:
        return
    if isinstance(node, _Q8):
        out[prefix] = node
    elif isinstance(node, dict):
        for k in sorted(node):
            _flatten(node[k], f"{prefix}/{k}" if prefix else str(k), out)
    else:
        out[prefix] = np.asarray(node)


def _unflatten(leaves: dict) -> dict:
    tree: dict = {}
    for path, leaf in leaves.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def _encode_leaf(leaf) -> dict:
    if isinstance(leaf, _Q8):
        return {"kind": "q8", "q": np.asarray(leaf.q), "scale": np.asarray(leaf.scale)}
    return {"kind": "raw", "v": np.asarray(leaf)}


def _decode_leaf(entry: dict, dtype: str):
    if entry["kind"] == "q8":
        q = np.asarray(entry["q"], np.float32)
        return (q * np.asarray(entry["scale"], np.float32)).astype(dtype)
    return np.asarray(entry["v"])


def _leaf_digest(entry: dict) -> str:
    h = hashlib.sha256()
    h.update(entry["kind"].encode())
    for part in ("q", "scale", "v"):
        arr = entry.get(part)
        if arr is not None:
            arr = np.ascontiguousarray(arr)
            h.update(f"|{part}:{arr.dtype}:{arr.shape}|".encode())
            h.update(arr.tobytes())
    return h.hexdigest()


def tree_fingerprint(digests: dict) -> str:
    """The parity fingerprint: sha256 over every leaf's ``path:digest``
    line, sorted — identical trees fingerprint identically whichever
    chain link carries each leaf."""
    h = hashlib.sha256()
    for path in sorted(digests):
        h.update(f"{path}:{digests[path]}\n".encode())
    return h.hexdigest()


def _serialize(entries: dict) -> bytes:
    arrays = {}
    for lp, e in entries.items():
        for part in ("q", "scale", "v"):
            if part in e:
                arrays[f"{lp}{_SEP}{part}"] = np.ascontiguousarray(e[part])
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _deserialize(raw: bytes) -> dict:
    entries: dict = {}
    with np.load(io.BytesIO(raw), allow_pickle=False) as z:
        for name in z.files:
            lp, _, part = name.rpartition(_SEP)
            if not lp or part not in ("q", "scale", "v"):
                raise ValueError(f"stray payload array {name!r}")
            entries.setdefault(lp, {})[part] = z[name]
    for lp, e in entries.items():
        e["kind"] = "raw" if "v" in e else "q8"
        if (e["kind"] == "q8") != ({"q", "scale"} <= e.keys()):
            raise ValueError(f"leaf {lp!r} has parts {sorted(k for k in e if k != 'kind')}")
    return entries


# ----------------------------------------------------------------- read side


def is_publish_artifact(path) -> bool:
    """A directory holding a publish manifest (not a raw checkpoint)."""
    p = Path(path)
    return p.is_dir() and (p / MANIFEST).is_file()


def load_manifest(path) -> dict:
    p = Path(path) / MANIFEST
    try:
        m = json.loads(p.read_text())
    except (OSError, ValueError) as e:
        raise PublishIntegrityError(f"{path}: unreadable manifest ({e})") from e
    if m.get("schema") != SCHEMA or m.get("kind") != "jumbo-publish":
        raise PublishIntegrityError(f"{path}: not a publish artifact (schema={m.get('schema')!r})")
    return m


def verify_artifact(path) -> tuple[dict, dict]:
    """Verify ONE chain link: the payload's sha256 and size against the
    manifest, every payload leaf's recomputed digest against its row.
    Returns ``(manifest, payload_leaves)``; raises
    :class:`PublishIntegrityError` before any byte reaches a model."""
    p = Path(path)
    m = load_manifest(p)
    pay = p / m["payload"]["file"]
    try:
        raw = pay.read_bytes()
    except OSError as e:
        raise PublishIntegrityError(f"{path}: unreadable payload ({e})") from e
    if len(raw) != int(m["payload"]["nbytes"]):
        raise PublishIntegrityError(f"{path}: torn payload ({len(raw)} bytes, manifest says {m['payload']['nbytes']})")
    if hashlib.sha256(raw).hexdigest() != m["payload"]["sha256"]:
        raise PublishIntegrityError(f"{path}: payload sha256 mismatch (corrupted artifact)")
    try:
        leaves = _deserialize(raw)
    except Exception as e:  # noqa: BLE001 - any decode failure is integrity
        raise PublishIntegrityError(f"{path}: undecodable payload ({e})") from e
    rows = m["leaves"]
    for lp, entry in leaves.items():
        row = rows.get(lp)
        if row is None or row["where"] != "payload":
            raise PublishIntegrityError(f"{path}: stray payload leaf {lp!r}")
        if _leaf_digest(entry) != row["digest"]:
            raise PublishIntegrityError(f"{path}: leaf {lp!r} digest mismatch (corrupted artifact)")
    missing = [lp for lp, row in rows.items() if row["where"] == "payload" and lp not in leaves]
    if missing:
        raise PublishIntegrityError(f"{path}: payload missing manifest leaves {missing[:3]}")
    return m, leaves


def resolve_chain(path, *, max_depth: int = 64) -> tuple[dict, dict | None, dict]:
    """Resolve a (possibly delta) artifact to a full dequantized tree,
    verifying every visited link and the recorded base fingerprints, then
    the resolved tree's fingerprint against the head manifest. Returns
    ``(params, batch_stats_or_None, head_manifest)``: flax trees of float32
    numpy leaves (:func:`~jumbo_mae_tpu_tpu_torch.interop.from_jax.state_dict_from_flax`
    gives the port's names)."""
    head = Path(path)
    m, leaves = verify_artifact(head)
    need = {lp for lp, row in m["leaves"].items() if row["where"] == "base"}
    cur, cur_dir = m, head
    depth = 0
    while need:
        base = cur.get("base")
        if not base:
            raise PublishIntegrityError(f"{cur_dir}: {len(need)} leaves unresolved and no base link")
        depth += 1
        if depth > max_depth:
            raise PublishIntegrityError(f"{path}: delta chain deeper than {max_depth} (cycle?)")
        bdir = head.parent / base["name"]
        if not bdir.is_dir():
            raise PublishIntegrityError(f"{cur_dir}: base {base['name']!r} is missing (broken chain)")
        bm, bleaves = verify_artifact(bdir)
        if bm["fingerprint"] != base["fingerprint"]:
            raise PublishIntegrityError(
                f"{cur_dir}: base {base['name']!r} fingerprint mismatch (chain link was replaced)")
        for lp in list(need):
            if lp in bleaves:
                leaves[lp] = bleaves[lp]
                need.discard(lp)
        cur, cur_dir = bm, bdir
    digests = {lp: _leaf_digest(entry) for lp, entry in leaves.items()}
    fp = tree_fingerprint(digests)
    if fp != m["fingerprint"]:
        raise PublishIntegrityError(f"{path}: resolved tree fingerprint {fp[:12]} != manifest {m['fingerprint'][:12]}")
    for lp, row in m["leaves"].items():
        if digests.get(lp) != row["digest"]:
            raise PublishIntegrityError(f"{path}: resolved leaf {lp!r} digest mismatch")
    decoded = {lp: _decode_leaf(entry, m["leaves"][lp]["dtype"]) for lp, entry in leaves.items()}
    tree = _unflatten(decoded)
    return tree.get("params", {}), tree.get("batch_stats"), m


def restore_artifact(path) -> tuple[dict, dict | None]:
    """``(params, batch_stats)`` by the port's ``state_dict`` names, as
    ``train.checkpoint.restore_inference_state`` returns a save's: the
    swap watcher's restore of a publish artifact."""
    from jumbo_mae_tpu_tpu_torch.interop.from_jax import state_dict_from_flax
    from jumbo_mae_tpu_tpu_torch.train.checkpoint import split_batch_stats

    params, stats, _ = resolve_chain(path)
    return split_batch_stats(state_dict_from_flax(params, stats))


def latest_artifact(publish_dir) -> Path | None:
    """The newest ``publish-NNNNNN`` entry, or None (staging directories
    are dot-prefixed and never match)."""
    d = Path(publish_dir)
    if not d.is_dir():
        return None
    names = sorted(n for n in os.listdir(d) if _NAME_RE.match(n))
    return d / names[-1] if names else None


# ---------------------------------------------------------------- write side


class CheckpointPublisher:
    """The train-side publish component (see the module docstring).

    Register on a :class:`RunEngine` with :meth:`register` *after* the
    checkpoint saver, so the save has landed when the publish hook runs.
    An export failure (an injected ``publish.export`` fault included)
    journals ``publish_failed`` and never propagates: continuous
    deployment must not be able to kill training. ``emit(etype,
    **fields)`` writes journal events (and bills the ``publish`` tenant);
    ``None`` writes none."""

    def __init__(
        self,
        publish_dir,
        *,
        quant: str = "int8",
        min_interval_steps: int = 0,
        full_every: int = 8,
        metric_key: str = "",
        metric_floor: float = 0.0,
        metric_sense: str = "below",
        emit=None,
        registry=None,
        clock=time.perf_counter,
    ):
        if quant not in ("int8", "none"):
            raise ValueError(f"publish quant must be int8|none, got {quant!r}")
        if metric_sense not in ("above", "below"):
            raise ValueError(f"publish metric sense must be above|below, got {metric_sense!r}")
        self.publish_dir = Path(publish_dir)
        self.quant = quant
        self.min_interval_steps = int(min_interval_steps)
        self.full_every = max(1, int(full_every))
        self.metric_key = metric_key
        self.metric_floor = float(metric_floor)
        self.metric_sense = metric_sense
        self._emit = emit
        self._clock = clock
        reg = registry if registry is not None else get_registry()
        self._m_published = reg.counter("publish_total", "artifacts published to the swap-watch dir")
        self._m_failed = reg.counter("publish_failed_total", "publish exports that failed")
        self._m_rejected = reg.counter("publish_gate_rejections_total", "checkpoints the publish gates rejected",
                                       labels=("reason",))
        self._g_bytes = reg.gauge("publish_bytes", "payload bytes of the last published artifact")
        self._g_delta = reg.gauge("publish_delta_fraction",
                                  "fraction of leaves shipped (vs riding the base) last publish")
        self._g_seconds = reg.gauge("publish_seconds", "wall seconds of the last publish export")
        # the publish tenant: export wall time billed through the meter, so
        # continuous deployment appears in the chargeback by name
        self._meter = None
        if emit is not None:
            from jumbo_mae_tpu_tpu_torch.serve.admission import TenantSpec
            from jumbo_mae_tpu_tpu_torch.serve.costmeter import CostMeter

            self._meter = CostMeter((TenantSpec(name="publish", tclass="batch"),),
                                    tracer=SimpleNamespace(event=emit), registry=reg)
        self._bad_since_ckpt = 0
        self._rollback_since_ckpt = False
        self._last_published_step: int | None = None
        # the chain resumes across restarts: the newest artifact on disk
        # is the delta base and names the next sequence number
        self._seq = 0
        self._base: tuple[str, str, dict] | None = None  # (name, fingerprint, digests)
        prev = latest_artifact(self.publish_dir)
        if prev is not None:
            self._seq = int(_NAME_RE.match(prev.name).group(1)) + 1
            try:
                pm = load_manifest(prev)
                self._base = (prev.name, pm["fingerprint"], {lp: row["digest"] for lp, row in pm["leaves"].items()})
            except PublishIntegrityError:
                pass

    # -- engine hooks ----------------------------------------------------
    def register(self, engine) -> None:
        engine.on_log_window(self._note_window)
        engine.on_rollback(self._note_rollback)
        engine.on_checkpoint(self._on_checkpoint)

    def _note_window(self, eng, win) -> None:
        self._bad_since_ckpt += len(getattr(win, "bad_steps", ()))

    def _note_rollback(self, eng, step, win):
        self._rollback_since_ckpt = True
        return None  # the restore hook owns the resumed step

    def _on_checkpoint(self, eng, cev) -> None:
        if cev.reason != "interval":
            return  # a preemption save: never stand between SIGTERM and exit
        bad, rolled = self._bad_since_ckpt, self._rollback_since_ckpt
        self._bad_since_ckpt = 0
        self._rollback_since_ckpt = False
        reason = self._gate(cev.step, cev.metrics, bad, rolled)
        if reason is not None:
            self._m_rejected.labels(reason).inc()
            if self._emit is not None:
                self._emit("publish_skipped", step=cev.step, reason=reason)
            return
        try:
            from jumbo_mae_tpu_tpu_torch.interop.from_jax import model_flax_tree

            params, stats = model_flax_tree(eng.state.model)
            self.publish(cev.step, params, batch_stats=stats, metrics=cev.metrics)
        except Exception as e:  # noqa: BLE001 - publish must not kill training
            self._m_failed.inc()
            if self._emit is not None:
                self._emit("publish_failed", step=cev.step, error=f"{type(e).__name__}: {e}")
            print(f"[publish] WARNING: export failed at step {cev.step}: {e}")

    def _gate(self, step, metrics, bad, rolled) -> str | None:
        """None = publish; otherwise the rejection reason."""
        if bad:
            return "bad_steps"
        if rolled:
            return "rollback"
        if self._last_published_step is not None and step - self._last_published_step < self.min_interval_steps:
            return "min_interval"
        if self.metric_key:
            val = (metrics or {}).get(self.metric_key)
            if val is None:
                return "metric_missing"
            val = float(val)
            if not math.isfinite(val):
                return "metric_nonfinite"
            ok = val >= self.metric_floor if self.metric_sense == "above" else val <= self.metric_floor
            if not ok:
                return "metric_floor"
        return None

    # -- the export ------------------------------------------------------
    def publish(self, step, params, *, batch_stats=None, metrics=None) -> Path:
        """Export one artifact of a flax-layout tree (gates already passed;
        :func:`~jumbo_mae_tpu_tpu_torch.interop.from_jax.model_flax_tree`
        gives a port model's). Raises on failure."""
        t0 = self._clock()
        host = params
        quant_report = None
        if self.quant == "int8":
            host, quant_report = quantize_tree(params)
        flat: dict = {}
        _flatten(host, "params", flat)
        if batch_stats is not None:
            _flatten(batch_stats, "batch_stats", flat)
        entries = {lp: _encode_leaf(leaf) for lp, leaf in flat.items()}
        digests = {lp: _leaf_digest(e) for lp, e in entries.items()}
        fingerprint = tree_fingerprint(digests)

        # delta against the last published tree; a full tree every
        # full_every publishes
        base = None
        in_payload = set(entries)
        if self._base is not None and self._seq % self.full_every != 0:
            bname, bfp, bdig = self._base
            carried = {lp for lp in entries if bdig.get(lp) == digests[lp]}
            if carried:
                in_payload = set(entries) - carried
                base = {"name": bname, "fingerprint": bfp}

        name = f"publish-{self._seq:06d}"
        payload = _serialize({lp: entries[lp] for lp in sorted(in_payload)})
        sha = hashlib.sha256(payload).hexdigest()
        # chaos site: corrupt() poisons the committed bytes AFTER the
        # digests are sealed (the watcher must catch it); raise models a
        # torn export (the staging directory is removed, nothing ships)
        payload = fault_point("publish.export", key=str(step), data=payload)
        manifest = {
            "schema": SCHEMA,
            "kind": "jumbo-publish",
            "name": name,
            "step": int(step),
            "quant": self.quant,
            "fingerprint": fingerprint,
            "base": base,
            "payload": {"file": PAYLOAD, "sha256": sha, "nbytes": len(payload)},
            "leaves": {
                lp: {
                    "digest": digests[lp],
                    "kind": entries[lp]["kind"],
                    "shape": list(np.asarray(flat[lp].q if entries[lp]["kind"] == "q8" else flat[lp]).shape),
                    "dtype": "float32" if entries[lp]["kind"] == "q8" else str(np.asarray(flat[lp]).dtype),
                    "where": "payload" if lp in in_payload else "base",
                }
                for lp in sorted(entries)
            },
            "delta_fraction": round(len(in_payload) / max(len(entries), 1), 4),
            "quant_report": quant_report,
            "gate": {"metric_key": self.metric_key or None, "metrics": dict(metrics or {})},
        }

        self.publish_dir.mkdir(parents=True, exist_ok=True)
        tmp = self.publish_dir / f".tmp-{name}"
        final = self.publish_dir / name
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        try:
            for fname, data in ((PAYLOAD, payload), (MANIFEST, json.dumps(manifest, indent=1).encode())):
                with open(tmp / fname, "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
            fsync_dir(tmp)
            os.replace(tmp, final)  # atomic: the watcher sees all or nothing
            fsync_dir(self.publish_dir)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

        dt = self._clock() - t0
        self._seq += 1
        self._base = (name, fingerprint, digests)
        self._last_published_step = int(step)
        self._m_published.inc()
        self._g_bytes.set(float(len(payload)))
        self._g_delta.set(manifest["delta_fraction"])
        self._g_seconds.set(dt)
        if self._meter is not None:
            self._meter.observe_batch(
                run_s=dt,
                traces=[SimpleNamespace(tenant="publish", tclass="batch", task="publish", bucket=1, tokens=None,
                                        pad_fraction=0.0)],
                batch=1,
            )
            self._meter.flush()
        if self._emit is not None:
            self._emit("publish", step=int(step), name=name, fingerprint=fingerprint, leaves=len(entries),
                       delta_leaves=len(in_payload), delta_fraction=manifest["delta_fraction"], bytes=len(payload),
                       seconds=round(dt, 3), quant=self.quant, base=base["name"] if base else None)
        print(f"[publish] {name} @ step {step}: {len(in_payload)}/{len(entries)} leaves, {len(payload)} bytes, "
              f"{self.quant}, {'delta vs ' + base['name'] if base else 'full tree'}")
        return final
