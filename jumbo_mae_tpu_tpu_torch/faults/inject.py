"""Deterministic fault injection: a seeded plan of named failure sites.

Counterpart of ``jumbo_mae_tpu_tpu/faults/inject.py``: the same plan
grammar, sites and firing order, so one ``GRAFT_FAULTS`` string drives
either package alike. Long runs die for reasons the happy path never
exercises — a transient shard read error, a killed worker, serving
overload. This module makes those failures *first-class inputs*: code
declares named sites (``fault_point("data.shard_open", key=url)``) and a
**fault plan**, parsed from the ``GRAFT_FAULTS`` env var, decides,
deterministically, which invocations fail and how. Runs without a plan pay
one module-global load + ``None`` check per site.

Plan grammar (rules separated by ``;``)::

    rule    = site ':' action [ '(' arg ')' ] [ '@' sel (',' sel)* ]
    action  = 'raise'   [ '(' ExcName ')' ]    -- raise (default OSError)
            | 'delay'   '(' seconds ')'        -- time.sleep
            | 'corrupt' [ '(' nbytes ')' ]     -- flip bytes in the payload
            | 'nan'                            -- replace the value with NaN
    sel     = 'n=' A [ '..' B ]   -- rule-local invocation index (0-based,
                                     inclusive range)
                                     -- counting selectors index into the
                                     rule's *filtered* stream: invocations
                                     rejected by 'key~'/'host=' don't
                                     advance n, so 'key~r1,n<1' is exactly
                                     "r1's first call"
            | 'n<' N              -- first N invocations
            | 'n%' K '=' R        -- every K-th invocation with remainder R
            | 'p=' F              -- seeded Bernoulli(F) per invocation
            | 'key~' SUBSTR       -- only when the site key contains SUBSTR
            | 'host=' I           -- only on process/host index I of a
                                     multi-process run (fleet chaos)
    seed    = 'seed=' N           -- standalone rule: seeds every 'p=' draw

All selectors of a rule must match for it to fire. Examples::

    data.shard_open:raise(OSError)@n<2            # first two opens fail
    train.loss:nan@n=4..6                         # NaN loss at calls 4-6
    data.shard_open:raise@key~shard-0003          # one shard always fails
    serve.submit:delay(0.05)@n%10=0               # every 10th submit is slow
    seed=7;data.decode:corrupt(4)@p=0.01          # 1% of decodes corrupted
    serve.replica:raise(RuntimeError)@key~r1,n<1  # crash replica r1's first batch
    serve.replica:delay(5.0)@key~r2               # wedge replica r2 (hang path)
    serve.preempt:raise@n=1                       # preempt (drain) one replica
    ckpt.load:corrupt(4)                          # diverge a hot-swap restore
    data.decode:delay(0.2)@host=1                 # straggle host 1 of a pod
    host.leak:corrupt(8)                          # leak 8 MB/step on the host
    batch.worker:raise@n<1                        # kill a batch-job worker mid-shard
    fleet.wedge:delay(30)@host=1,n<1              # wedge host 1's step (hangwatch)

The ``host=`` selector resolves the current process's host index lazily at
fire time: an explicit :func:`set_host_index` (it also exports
``GRAFT_HOST`` so data worker subprocesses inherit the identity), else the
``GRAFT_HOST`` env var, else the rank of ``torch.distributed`` when a
process group is initialized, else 0.

Known sites (free-form names are allowed): :data:`KNOWN_SITES`, the JAX
package's list. The port wires the ones its ported layers cross:

- ``data.shard_open`` in ``data/tario.py``'s ``iter_tar_samples``, once per
  attempt to open a shard (``key`` = the URL): ``raise`` is a failed read
  the retry layer retries, then quarantines;
- ``batch.worker`` in the offline batch runner's worker loop (``key`` =
  the worker name): a ``raise`` kills that worker dead without releasing
  its shard lease — the lease-expiry/steal path another worker must
  recover;
- ``publish.export`` in ``serve/publisher.py``'s export (``key`` = the
  step): ``corrupt`` poisons the payload after its digests are sealed
  (the swap watcher quarantines it), ``raise`` is a torn export;
- the serving sites: ``serve.submit`` at every submit of the
  micro-batcher, the pool and the continuous scheduler (no key);
  ``serve.replica`` around a replica's flush (``key`` = the replica's
  name: ``raise`` crashes it, ``delay`` wedges it); ``serve.preempt``
  once a supervisor pass per routable replica (``key`` = its name: a
  firing is a preemption notice, drained without a drop); ``ckpt.load``
  on a hot swap's restored tree (``key`` = the pushed path: ``corrupt``
  diverges it, ``raise`` is an unreadable push).

The training sites, in ``cli/train.py`` and ``train/checkpoint.py``:
``train.loss`` and ``train.grad`` once a train step (``key`` = the step;
``nan`` turns the step's loss or gradient multiplier into NaN, which the
step's guard skips and the divergence sentinel counts); ``host.leak``
once a train step (:func:`host_leak_tick`: ``corrupt(n)`` retains n MB in
a module ballast each time it fires, ``raise`` clears it);
``ckpt.save`` at every save (``key`` = the step) and ``ckpt.load`` at
every step a restore tries (``key`` = that step: ``raise`` makes the
restore walk back); ``fleet.wedge`` once a train step (``key`` = the
step; ``delay`` past the hang watchdog's deadline wedges it). The data
sites: ``data.shard_open`` at each shard open (``data/tario.py``) and
``data.decode`` before each decode of the train streams
(``data/loader.py``; ``key`` = the sample's ``__key__``, none in the
native reader's stream).
``corrupt`` flips bytes of a bytes payload and
sign-flips tensors of a flat ``{name: tensor | ndarray}`` tree; its draws
are seeded with an integer derived from (plan seed, firing, size), where
the JAX package seeds ``random.Random`` with a tuple, which Python 3.12
refuses.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from dataclasses import dataclass, field

from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry

# Exception classes `raise(Name)` may name — a closed set, so a fault plan
# can never be used to execute arbitrary attribute lookups.
_EXCEPTIONS = {
    "OSError": OSError,
    "IOError": OSError,
    "ConnectionError": ConnectionError,
    "TimeoutError": TimeoutError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
    "MemoryError": MemoryError,
}

_ACTIONS = ("raise", "delay", "corrupt", "nan")

# Every site the JAX package wires (the port wires those of its ported
# layers). Free-form names still work at runtime, but plans naming a site
# outside this tuple can never fire.
KNOWN_SITES = (
    "data.shard_open",
    "data.decode",
    "train.loss",
    "train.grad",
    "serve.submit",
    "serve.replica",
    "serve.preempt",
    "ckpt.save",
    "ckpt.load",
    "host.leak",
    "batch.worker",
    "publish.export",
    "fleet.wedge",
)


@dataclass
class FaultRule:
    site: str
    action: str
    arg: str | float | None = None
    selectors: list[tuple[str, object]] = field(default_factory=list)
    calls: int = 0  # invocations that passed this rule's identity filters
    hits: int = 0   # invocations this rule actually fired on

    def filter_matches(self, key: str | None) -> bool:
        """Identity selectors (``key~``, ``host=``): does this invocation
        belong to the stream the rule targets at all? Invocations that fail
        here are invisible to the rule — they do not advance ``calls`` — so
        ``key~r1,n<1`` means "r1's first call", not "the first call overall,
        if it happens to be r1's" (which would race against other keys)."""
        for kind, val in self.selectors:
            if kind == "key~":
                if key is None or val not in str(key):
                    return False
            elif kind == "host=":
                if current_host_index() != val:
                    return False
        return True

    def gate_matches(self, rng) -> bool:
        """Counting selectors (``n=``/``n<``/``n%``/``p=``), evaluated
        against the filtered invocation index."""
        n = self.calls
        for kind, val in self.selectors:
            if kind == "n=":
                lo, hi = val
                if not (lo <= n <= hi):
                    return False
            elif kind == "n<":
                if not n < val:
                    return False
            elif kind == "n%":
                k, r = val
                if n % k != r:
                    return False
            elif kind == "p=":
                # one seeded draw per filtered invocation
                if rng.random() >= val:
                    return False
        return True


def _parse_selector(text: str) -> tuple[str, object]:
    text = text.strip()
    if text.startswith("key~"):
        return ("key~", text[len("key~"):])
    if text.startswith("p="):
        p = float(text[2:])
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"p= selector must be in [0,1], got {text!r}")
        return ("p=", p)
    if text.startswith("n<"):
        return ("n<", int(text[2:]))
    if text.startswith("n%"):
        mod, _, rem = text[2:].partition("=")
        if not rem:
            raise ValueError(f"n%% selector needs K=R, got {text!r}")
        return ("n%", (int(mod), int(rem)))
    if text.startswith("n="):
        lo, sep, hi = text[2:].partition("..")
        return ("n=", (int(lo), int(hi) if sep else int(lo)))
    if text.startswith("host="):
        return ("host=", int(text[len("host="):]))
    raise ValueError(f"unknown fault selector {text!r}")


def _parse_rule(text: str) -> FaultRule:
    head, _, sel = text.partition("@")
    site, colon, act = head.partition(":")
    if not colon or not site.strip():
        raise ValueError(f"fault rule needs site:action, got {text!r}")
    act = act.strip()
    arg: str | float | None = None
    if "(" in act:
        if not act.endswith(")"):
            raise ValueError(f"unbalanced '(' in fault action {act!r}")
        act, _, raw = act[:-1].partition("(")
        arg = raw.strip()
    if act not in _ACTIONS:
        raise ValueError(f"unknown fault action {act!r} (one of {_ACTIONS})")
    if act == "delay":
        arg = float(arg) if arg else 0.01
    elif act == "corrupt":
        arg = int(arg) if arg else 8
    elif act == "raise" and arg and arg not in _EXCEPTIONS:
        raise ValueError(
            f"raise({arg}) not allowed; choose from {sorted(_EXCEPTIONS)}"
        )
    selectors = [_parse_selector(s) for s in sel.split(",") if s.strip()] if sel else []
    return FaultRule(site=site.strip(), action=act, arg=arg, selectors=selectors)


class FaultPlan:
    """A parsed set of rules, grouped by site, with deterministic firing.

    All mutable state (per-rule counters, the Bernoulli stream) is guarded
    by one lock — sites like ``serve.submit`` fire from many threads.
    """

    def __init__(self, rules: list[FaultRule], *, seed: int = 0, text: str = ""):
        import random

        self.text = text
        self.seed = seed
        self._by_site: dict[str, list[FaultRule]] = {}
        for r in rules:
            self._by_site.setdefault(r.site, []).append(r)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        reg = get_registry()
        self._m_injected = reg.counter(
            "faults_injected_total",
            "faults fired by the active injection plan",
            labels=("site", "action"),
        )

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        seed = 0
        rules = []
        for part in text.split(";"):
            part = part.strip()
            if not part:
                continue
            if part.startswith("seed="):
                seed = int(part[len("seed="):])
                continue
            rules.append(_parse_rule(part))
        return cls(rules, seed=seed, text=text)

    def sites(self) -> list[str]:
        return sorted(self._by_site)

    def counts(self) -> dict[str, tuple[int, int]]:
        """{'site:action' → (calls, hits)} — test/debug readout."""
        with self._lock:
            return {
                f"{r.site}:{r.action}": (r.calls, r.hits)
                for rs in self._by_site.values()
                for r in rs
            }

    def fire(self, site: str, key: str | None, data):
        """Apply the first matching rule for ``site``; returns the (possibly
        replaced) ``data``. Raise/delay actions happen here."""
        rules = self._by_site.get(site)
        if not rules:
            return data
        with self._lock:
            fired = None
            for r in rules:
                # identity filters gate the counter too: a rule only "sees"
                # invocations from its own key/host stream, so n-selectors
                # index into that stream deterministically regardless of how
                # other keys interleave with it
                if not r.filter_matches(key):
                    continue
                if fired is None and r.gate_matches(self._rng):
                    fired = r
                    r.hits += 1
                r.calls += 1
            if fired is None:
                return data
            self._m_injected.labels(site, fired.action).inc()
        # side effects OUTSIDE the lock — a delay must not serialize other
        # sites, and a raised exception must not poison the lock
        if fired.action == "raise":
            exc = _EXCEPTIONS.get(str(fired.arg) or "", OSError)
            raise exc(
                f"fault injected at {site} (rule {fired.site}:{fired.action}"
                f"{f'({fired.arg})' if fired.arg else ''})"
            )
        if fired.action == "delay":
            time.sleep(float(fired.arg))
            return data
        if fired.action == "corrupt":
            if data is _LEAK_TOKEN:
                # host.leak: corrupt(n) has nothing to corrupt; it retains
                # n MB a firing in the module ballast, the controllable
                # host leak the leak sentinel must attribute
                _LEAK_BALLAST.append(bytearray(int(fired.arg) * 1024 * 1024))
                return data
            return _corrupt_bytes(data, int(fired.arg), self.seed, fired.hits)
        if fired.action == "nan":
            return float("nan")
        return data  # pragma: no cover - _ACTIONS is closed


def _seed(*parts: int) -> int:
    """An integer seed for ``random.Random`` from integers (the port's
    ``utils/rng.derive_seed`` scheme: blake2b, 63 bits)."""
    h = hashlib.blake2b(digest_size=8)
    for p in parts:
        h.update(int(p).to_bytes(16, "little", signed=True))
    return int.from_bytes(h.digest(), "little") >> 1


def _corrupt_bytes(data, nbytes: int, seed: int, salt: int):
    """Corrupt a payload deterministically. Bytes payloads (tar members,
    image blobs) get ``nbytes`` flipped bytes; a flat dict of tensors or
    arrays (a restored ``state_dict``) gets ``nbytes`` non-empty entries,
    chosen over its sorted names, replaced by ``-3 * x - 0.5`` in their own
    dtype — numerically plausible, parity-detectably wrong. Anything else
    is returned untouched. The draws are seeded with
    ``_seed(seed, salt, size)``: the same plan, firing and payload size
    corrupt the same places."""
    import random

    if isinstance(data, (bytes, bytearray)):
        if len(data) == 0:
            return data
        rng = random.Random(_seed(seed, salt, len(data)))
        buf = bytearray(data)
        for _ in range(min(nbytes, len(buf))):
            i = rng.randrange(len(buf))
            buf[i] ^= 0xFF
        return bytes(buf)
    if isinstance(data, dict) and data:
        names = sorted(
            n for n, v in data.items()
            if hasattr(v, "shape") and _numel(v)
        )
        if not names:
            return data
        rng = random.Random(_seed(seed, salt, len(names)))
        out = dict(data)
        for n in rng.sample(names, min(nbytes, len(names))):
            v = out[n]
            if hasattr(v, "detach"):  # a torch tensor
                out[n] = (-3.0 * v.detach() - 0.5).to(v.dtype)
            else:
                import numpy as np

                arr = np.asarray(v)
                out[n] = (-3.0 * arr - 0.5).astype(arr.dtype)
        return out
    return data


def _numel(v) -> int:
    n = v.numel() if hasattr(v, "numel") else getattr(v, "size", 0)
    return int(n)


# ------------------------------------------------------------ host ballast

# The host.leak site's retained memory: every corrupt(n) firing appends an
# n-MB buffer here; a raise firing clears it. Module-level on purpose: a
# leak that vanished with its injector would be unmeasurable.
_LEAK_BALLAST: list[bytearray] = []
_LEAK_TOKEN = object()  # the payload marking a host.leak tick


def leak_ballast_bytes() -> int:
    """Bytes retained by the ``host.leak`` site now: the probe the train
    CLI registers as the ``fault_ballast`` component of its memory
    accountant, so the leak sentinel's attribution is testable."""
    return sum(len(b) for b in _LEAK_BALLAST)


def host_leak_tick(key: str | None = None) -> int:
    """Tick the ``host.leak`` site (once a train step).

    ``corrupt(n)`` rules grow the module ballast by n MB a firing;
    ``raise`` rules clear it (the exception never propagates: a *memory*
    fault must not crash the step loop). Returns the ballast's bytes."""
    try:
        fault_point("host.leak", key=key, data=_LEAK_TOKEN)
    except Exception:  # noqa: BLE001 - a raise action = "the leak got fixed"
        _LEAK_BALLAST.clear()
    return leak_ballast_bytes()


# ------------------------------------------------------------ host identity

_HOST_INDEX: int | None = None
_HOST_ENV = "GRAFT_HOST"


def set_host_index(index: int | None) -> None:
    """Pin this process's host index for ``@host=`` selectors and mirror it
    into the ``GRAFT_HOST`` env var so data-worker subprocesses (which
    activate the same plan via ``GRAFT_FAULTS``) inherit the identity.
    ``None`` resets to lazy resolution (tests)."""
    global _HOST_INDEX
    if index is None:
        _HOST_INDEX = None
        os.environ.pop(_HOST_ENV, None)
    else:
        _HOST_INDEX = int(index)
        os.environ[_HOST_ENV] = str(_HOST_INDEX)


def current_host_index() -> int:
    """The host index ``@host=`` compares against. Resolution order:
    :func:`set_host_index` > ``GRAFT_HOST`` env > the rank of
    ``torch.distributed`` when torch is already imported and a process
    group is initialized (this layer never imports torch) > 0. The
    resolved value is cached; the bare-0 fallback is not, since
    distributed init may simply not have happened yet."""
    global _HOST_INDEX
    if _HOST_INDEX is not None:
        return _HOST_INDEX
    env = os.environ.get(_HOST_ENV)
    if env is not None:
        try:
            _HOST_INDEX = int(env)
            return _HOST_INDEX
        except ValueError:
            pass
    import sys

    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            dist = torch.distributed
            if dist.is_available() and dist.is_initialized():
                _HOST_INDEX = int(dist.get_rank())
                return _HOST_INDEX
        except Exception:  # noqa: BLE001 - no process group yet
            pass
    return 0


# ---------------------------------------------------------------- installers

_PLAN: FaultPlan | None = None
_ENV_VAR = "GRAFT_FAULTS"


def install_plan(spec: "str | FaultPlan | None") -> FaultPlan | None:
    """Activate a fault plan process-wide (a string is parsed first).
    ``None``/empty deactivates. Returns the active plan."""
    global _PLAN
    if spec is None or spec == "":
        _PLAN = None
        return None
    plan = FaultPlan.parse(spec) if isinstance(spec, str) else spec
    _PLAN = plan
    return plan


def clear_plan() -> None:
    install_plan(None)


def active_plan() -> FaultPlan | None:
    return _PLAN


def faults_active() -> bool:
    return _PLAN is not None


def fault_point(site: str, *, key: str | None = None, data=None):
    """Declare a failure site. With no active plan this is a global load and
    a branch — the zero-overhead contract production runs rely on. With a
    plan, the first matching rule fires: ``raise``/``delay`` happen here;
    ``corrupt``/``nan`` transform and return ``data``."""
    plan = _PLAN
    if plan is None:
        return data
    return plan.fire(site, key, data)


# env activation: a set GRAFT_FAULTS makes every entry point (and every data
# worker subprocess, which inherits the parent env) fault-enabled at import
if os.environ.get(_ENV_VAR):
    install_plan(os.environ[_ENV_VAR])
