"""The port's fault injection against the JAX package's.

- ``FaultPlan.parse`` over the plan strings of ``tests/test_chaos.py`` and
  ``tests/test_batch.py`` gives the same sites, rules and selector matches;
- ``fire`` sequences of ``raise``, ``delay`` and ``nan`` under seeded plans
  (counting and Bernoulli selectors, key and host filters) equal the JAX
  package's, call by call, with the same ``counts()``;
- ``corrupt`` is deterministic and derives integer seeds: held to its
  docstring, not to the JAX package, whose tuple seeds Python 3.12
  refuses (ROADMAP C.R1);
- ``KNOWN_SITES`` equals the JAX package's; the ``data.shard_open`` site
  in ``data/tario.py`` retries, then quarantines, as in the JAX package.
"""

import math

import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.faults import inject as jax_inject
from jumbo_mae_tpu_tpu_torch import faults
from jumbo_mae_tpu_tpu_torch.faults import inject as port_inject

PLANS = [
    "batch.worker:raise@key~w0,n<1",
    "ckpt.load:corrupt(4)",
    "ckpt.save:raise(RuntimeError)@n=0",
    "data.shard_open:raise(OSError)@key~train-0001",
    "data.shard_open:raise(OSError)@n<2;",
    "serve.preempt:raise@n=1",
    "serve.replica:raise(RuntimeError)@key~r1,n<12",
    "serve.submit:delay(0.001)@n%3=0;serve.submit:raise(RuntimeError)@n=1",
    "train.loss:nan@n=4..6",
    "data.shard_open:raise(OSError)@n<2;train.loss:nan@n=4..6;serve.submit:delay(0.001)@n%3=0;"
    "data.decode:corrupt(4)@key~bad",
    "seed=7;s:nan@p=0.5",
    "data.decode:delay(0.0)@host=1",
    "x.y:delay(0.0)",
]
BAD = ["siteonly", "s:explode", "s:raise(Exception)", "s:nan@q=3", "s:nan@p=2.0", "s:raise(OSError", "s:nan@n%3"]


@pytest.fixture(autouse=True)
def _host_zero(monkeypatch):
    monkeypatch.delenv("GRAFT_HOST", raising=False)
    port_inject.set_host_index(None)
    jax_inject.set_host_index(None)
    yield
    port_inject.set_host_index(None)
    jax_inject.set_host_index(None)
    port_inject.clear_plan()


def _rules(plan):
    return [(r.site, r.action, r.arg, r.selectors) for site in plan.sites() for r in plan._by_site[site]]


@pytest.mark.parametrize("text", PLANS)
def test_parse_equals_jax(text):
    p, j = port_inject.FaultPlan.parse(text), jax_inject.FaultPlan.parse(text)
    assert p.sites() == j.sites() and p.seed == j.seed and p.text == j.text
    assert _rules(p) == _rules(j)


@pytest.mark.parametrize("text", BAD)
def test_bad_plans_refused_like_jax(text):
    for m in (port_inject, jax_inject):
        with pytest.raises(ValueError):
            m.FaultPlan.parse(text)


def _trace(m, text: str, calls):
    """Each call's outcome under a fresh plan of ``text``: the exception
    type and message, NaN, or the value passed through."""
    plan = m.FaultPlan.parse(text)
    out = []
    for site, key, data in calls:
        try:
            v = plan.fire(site, key, data)
            out.append("nan" if isinstance(v, float) and math.isnan(v) else v)
        except Exception as e:  # noqa: BLE001 - the outcome under test
            out.append((type(e).__name__, str(e)))
    return out, plan.counts()


CALLS = (
    [("data.shard_open", f"train-000{i % 3}", None) for i in range(6)]
    + [("train.loss", None, 1.0) for _ in range(8)]
    + [("serve.submit", None, "req") for _ in range(7)]
    + [("serve.replica", f"r{i % 2}", None) for i in range(30)]
    + [("batch.worker", f"w{i % 2}", None) for i in range(4)]
    + [("s", None, 2.0) for _ in range(40)]
    + [("data.decode", "k", "x") for _ in range(3)]
)


@pytest.mark.parametrize("text", [t for t in PLANS if "corrupt" not in t])
def test_fire_sequences_equal_jax(text):
    assert _trace(port_inject, text, CALLS) == _trace(jax_inject, text, CALLS)


@pytest.mark.parametrize("host", [0, 1])
def test_host_selector_equals_jax(host):
    port_inject.set_host_index(host)
    jax_inject.set_host_index(host)
    text = "s:nan@host=1,n<2"
    calls = [("s", None, 1.0)] * 4
    got = _trace(port_inject, text, calls)
    assert got == _trace(jax_inject, text, calls)
    assert got[0].count("nan") == (2 if host == 1 else 0)


def test_seeded_bernoulli_is_a_real_coin():
    seq = _trace(port_inject, "seed=7;s:nan@p=0.5", [("s", None, 1.0)] * 64)[0]
    assert 0 < seq.count("nan") < 64
    assert seq == _trace(port_inject, "seed=7;s:nan@p=0.5", [("s", None, 1.0)] * 64)[0]
    assert seq != _trace(port_inject, "seed=8;s:nan@p=0.5", [("s", None, 1.0)] * 64)[0]


def test_corrupt_bytes_is_deterministic_with_integer_seeds():
    payload = bytes(range(256)) * 4
    a = port_inject.FaultPlan.parse("seed=3;d:corrupt(5)")
    b = port_inject.FaultPlan.parse("seed=3;d:corrupt(5)")
    first = [a.fire("d", None, payload) for _ in range(3)]
    assert first == [b.fire("d", None, payload) for _ in range(3)]
    for got in first:  # at most nbytes bytes flipped (a repeat index flips back)
        diff = [i for i in range(len(payload)) if got[i] != payload[i]]
        assert len(got) == len(payload) and 1 <= len(diff) <= 5
        assert all(got[i] == payload[i] ^ 0xFF for i in diff)
    assert first[0] != first[1]  # each firing its own draws
    other = port_inject.FaultPlan.parse("seed=4;d:corrupt(5)").fire("d", None, payload)
    assert other != first[0]
    assert a.fire("d", None, b"") == b"" and a.fire("d", None, 3) == 3
    # the JAX package seeds random.Random with a tuple here, which this
    # Python refuses (ROADMAP C.R1); the port derives an integer instead
    seed = port_inject._seed(3, 1, len(payload))
    assert isinstance(seed, int) and 0 <= seed < 2**63


def test_corrupt_state_dict_flips_chosen_entries_deterministically():
    rng = np.random.default_rng(0)
    tree = {f"layer{i}.weight": torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)) for i in range(6)}
    tree["layer0.bias"] = np.ones(4, np.float32)
    tree["empty"] = torch.zeros(0)
    tree["note"] = "not a tensor"
    a = port_inject.FaultPlan.parse("ckpt.load:corrupt(3)").fire("ckpt.load", None, tree)
    b = port_inject.FaultPlan.parse("ckpt.load:corrupt(3)").fire("ckpt.load", None, tree)
    changed = sorted(n for n in tree if n != "note" and not np.array_equal(np.asarray(a[n]), np.asarray(tree[n])))
    assert changed == sorted(n for n in tree if n != "note" and not np.array_equal(np.asarray(b[n]), np.asarray(tree[n])))
    assert len(changed) == 3 and "empty" not in changed and a["note"] == "not a tensor"
    for n in changed:
        want = -3.0 * np.asarray(tree[n]) - 0.5
        assert np.array_equal(np.asarray(a[n]), want.astype(np.asarray(tree[n]).dtype))
        assert type(a[n]) is type(tree[n]) and np.asarray(a[n]).dtype == np.asarray(tree[n]).dtype
    assert set(a) == set(tree)


def test_known_sites_and_installers():
    assert port_inject.KNOWN_SITES == jax_inject.KNOWN_SITES
    assert faults.fault_point("ckpt.save", data=b"x") == b"x"
    faults.install_plan("ckpt.save:raise(RuntimeError)@n=0")
    assert faults.faults_active() and faults.active_plan().sites() == ["ckpt.save"]
    with pytest.raises(RuntimeError, match="fault injected"):
        faults.fault_point("ckpt.save", key="1")
    assert faults.fault_point("ckpt.save", key="2", data=1) == 1
    faults.clear_plan()
    assert not faults.faults_active() and faults.active_plan() is None


def test_host_index_resolution(monkeypatch):
    assert port_inject.current_host_index() == 0
    monkeypatch.setenv("GRAFT_HOST", "3")
    assert port_inject.current_host_index() == 3
    port_inject.set_host_index(2)
    assert port_inject.current_host_index() == 2 and port_inject.os.environ["GRAFT_HOST"] == "2"


def test_shard_open_site_retries_then_quarantines(tmp_path):
    from jumbo_mae_tpu_tpu_torch.data.tario import QUARANTINE, RetryPolicy, iter_tar_samples, write_tar_samples

    url = str(tmp_path / "train-0001.tar")
    write_tar_samples(url, [{"__key__": f"k{i}", "bin": bytes([i]) * 8} for i in range(3)])
    QUARANTINE.clear()
    retry = RetryPolicy(attempts=3, backoff_s=0.0)
    faults.install_plan("data.shard_open:raise(OSError)@n<2")
    assert [s["__key__"] for s in iter_tar_samples(url, retry=retry)] == ["k0", "k1", "k2"]
    assert faults.active_plan().counts() == {"data.shard_open:raise": (3, 2)}
    faults.install_plan("data.shard_open:raise(OSError)@key~train-0001")
    assert list(iter_tar_samples(url, retry=retry)) == []
    assert url in QUARANTINE.snapshot()
    QUARANTINE.clear()
