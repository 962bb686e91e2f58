"""The port's memory observability (``obs/memwatch.py``) against the JAX
package's, on the CPU.

- the Theil–Sen slope, the accountant, the leak sentinel and the host
  headroom check give the JAX module's verdicts and gauges on the same
  sequences (the cases of the JAX package's ``tests/test_memwatch.py``);
- ``tree_nbytes`` counts the same bytes for a flax tree and for its
  ``from_jax`` state dict;
- a watcher built for the CPU publishes host gauges only, with a one-shot
  note, as the JAX watcher does on XLA:CPU;
- a watcher built for ``"cuda"`` (``torch.cuda.memory_stats`` faked)
  publishes ``mem_device_bytes{device="cuda:0"}``, the peak and
  ``mem_hbm_predict_vs_measured``, and a failing stats read raises there;
- the card side of the headroom check refuses, naming the card, through a
  faked ``torch.cuda.mem_get_info``.
"""

import jax
import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.obs import memwatch as jmw
from jumbo_mae_tpu_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from jumbo_mae_tpu_tpu_torch.obs import memwatch as pmw
from jumbo_mae_tpu_tpu_torch.obs.metrics import MetricsRegistry

MB = pmw.MB
assert MB == jmw.MB


@pytest.mark.parametrize("values", [[], [5.0], [3.0] * 4, [0.0, 2.0, 4.0, 6.0], [0.0, 1.0, 2.0, 100.0, 4.0, 5.0, 6.0, 7.0],
                                    list(np.random.default_rng(0).normal(0, 5, 12))])
def test_theil_sen_slope_equals_jax(values):
    assert pmw._theil_sen_slope(values) == jmw._theil_sen_slope(values)
    assert pmw._theil_sen_slope([0.0, 1.0, 2.0, 100.0, 4.0, 5.0, 6.0, 7.0]) == pytest.approx(1.0, abs=0.35)


def test_tree_nbytes_flax_tree_and_its_state_dict():
    from jumbo_mae_tpu_tpu.models import JumboViT as FlaxJumboViT
    from jumbo_mae_tpu_tpu.models import preset as flax_preset
    from jumbo_mae_tpu_tpu_torch.interop.from_jax import state_dict_from_jax

    model = FlaxJumboViT(flax_preset("vit_t16", image_size=32, patch_size=4, labels=10))
    params = model.init(jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32), True)["params"]
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    want = jmw.tree_nbytes(params)
    assert want > 0 and pmw.tree_nbytes(params) == want == pmw.tree_nbytes(sd)
    mixed = {"a": np.zeros((4, 4), np.float32), "b": [np.zeros(8, np.int8), 3], "c": torch.zeros(5, dtype=torch.bfloat16)}
    assert pmw.tree_nbytes(mixed) == 64 + 8 + 10
    assert pmw.tree_nbytes(None) == 0


def test_accountant_equals_jax():
    out = []
    for mod, reg in ((pmw, MetricsRegistry()), (jmw, JaxRegistry())):
        acc = mod.MemAccountant(registry=reg)
        acc.register("good", lambda: 123)
        acc.register("unknown", lambda: None)
        acc.register("broken", lambda: 1 / 0)
        first = (acc.components(), acc.sample(), reg.render())
        acc.unregister("good")
        out.append((first, acc.sample()))
    assert out[0] == out[1]
    assert out[0][0][1] == {"good": 123} and 'mem_component_bytes{component="good"} 123' in out[0][0][2]


def _snaps(rss_series, components=None, t0=1000.0):
    for i, rss in enumerate(rss_series):
        snap = {"ts": t0 + 10.0 * i, "rss_bytes": int(rss)}
        if components:
            snap["components"] = {name: int(series[i]) for name, series in components.items()}
        yield snap


LEAK_CASES = {
    "names_the_cache": ([1000 * MB + i * 8 * MB for i in range(8)],
                        {"cache": [i * 7 * MB for i in range(8)], "steady": [64 * MB] * 8}, 8),
    "flat_with_a_spike": ([1000 * MB] * 4 + [1400 * MB] + [1000 * MB] * 3, None, 8),
    "minor_grower_is_unaccounted": ([1000 * MB + i * 20 * MB for i in range(6)], {"cache": [i * MB for i in range(6)]},
                                    6),
}


@pytest.mark.parametrize("case", sorted(LEAK_CASES))
def test_leak_sentinel_equals_jax(case):
    rss, comps, window = LEAK_CASES[case]
    out = []
    for mod, reg in ((pmw, MetricsRegistry()), (jmw, JaxRegistry())):
        s = mod.LeakSentinel(window=window, min_samples=4, min_growth_mb=32.0, registry=reg)
        fired = [s.observe(snap) for snap in _snaps(rss, comps)]
        fired.append(s.observe({"ts": 5000.0, "rss_bytes": 9000 * MB}))  # latched: never fires twice
        out.append((fired, s.degraded(), s.suspect, reg.render()))
    assert out[0] == out[1]
    hits = [f for f in out[0][0] if f is not None]
    want = {"names_the_cache": ["cache"], "flat_with_a_spike": [], "minor_grower_is_unaccounted": ["unaccounted"]}
    assert [h["component"] for h in hits] == want[case]


def test_sentinel_rejects_degenerate_window():
    with pytest.raises(ValueError):
        pmw.LeakSentinel(window=1, registry=MetricsRegistry())


@pytest.mark.parametrize("avail_mb", [1000, None])
def test_host_headroom_check_equals_jax(monkeypatch, avail_mb):
    for mod in (pmw, jmw):
        monkeypatch.setattr(mod, "host_available_bytes", lambda: None if avail_mb is None else avail_mb * MB)
    port = pmw.MemoryWatcher(registry=MetricsRegistry(), device="cpu")
    ref = jmw.MemoryWatcher(registry=JaxRegistry())
    for need in (100 * MB, 899 * MB, 950 * MB, 10**15):
        assert port.headroom_check(need) == ref.headroom_check(need)
    if avail_mb is not None:
        refusal = port.headroom_check(950 * MB)
        assert "950 MiB" in refusal and "host memory" in refusal
    else:
        assert port.headroom_check(10**15) is None  # unknowable headroom is not a refusal


def test_cpu_watcher_degrades_to_host_gauges_like_jax():
    out = []
    for watcher, reg in ((pmw.MemoryWatcher, MetricsRegistry()), (jmw.MemoryWatcher, JaxRegistry())):
        acc = (pmw if watcher is pmw.MemoryWatcher else jmw).MemAccountant(registry=reg)
        acc.register("ballast", lambda: 4 * MB)
        kw = {"device": "cpu"} if watcher is pmw.MemoryWatcher else {}
        w = watcher(accountant=acc, registry=reg, **kw)
        w.record_predicted_peak("features/b1", 1000 * MB)
        first, second = w.sample(), w.sample()
        text = reg.render()
        out.append((w.device_stats_degraded, sorted(first), first["note"], "note" in second, first["components"],
                    [ln.split(" ")[2] for ln in text.splitlines() if ln.startswith("# TYPE")]))
        assert first["rss_bytes"] > 0 and w.last_sample() is second
    assert out[0] == out[1]
    degraded, keys, note, again, comps, families = out[0]
    assert degraded and "memory_stats() unavailable" in note and not again
    assert "device_bytes" not in keys and "hbm_drift" not in keys
    assert families == ["mem_component_bytes", "mem_host_rss_bytes", "mem_py_alloc_blocks"]


def fake_stats(current, peak):
    return lambda device=None: {"allocated_bytes.all.current": current, "allocated_bytes.all.peak": peak,
                                "num_alloc_retries": 0}


def test_cuda_watcher_publishes_device_gauges_and_drift(monkeypatch):
    """With the card's stats read faked, the device and drift gauges
    register as the JAX watcher's do where memory_stats exist: labelled
    ``cuda:0``, drift = measured peak / predicted peak."""
    monkeypatch.setattr(torch.cuda, "memory_stats", fake_stats(600 * MB, 900 * MB))
    reg = MetricsRegistry()
    w = pmw.MemoryWatcher(registry=reg, device="cuda:0")
    w.record_predicted_peak("features:cls/b64", 1000 * MB)
    w.record_predicted_peak("zero_is_ignored", 0)
    w.record_predicted_peak("none_is_ignored", None)
    snap = w.sample()
    assert not w.device_stats_degraded and "note" not in snap
    assert snap["device_bytes"] == 600 * MB and snap["device_peak_bytes"] == 900 * MB
    assert snap["hbm_drift"] == {"features:cls/b64": 0.9}
    text = reg.render()
    assert f'mem_device_bytes{{device="cuda:0"}} {600 * MB}' in text
    assert f'mem_device_peak_bytes{{device="cuda:0"}} {900 * MB}' in text
    assert 'mem_hbm_predict_vs_measured{program="features:cls/b64"} 0.9' in text
    assert "zero_is_ignored" not in text
    # the JAX watcher on a backend with stats (its probe faked alike)
    monkeypatch.setattr(jmw, "_device_memory_stats", lambda: [("cuda:0", 600 * MB, 900 * MB)])
    jreg = JaxRegistry()
    jw = jmw.MemoryWatcher(registry=jreg)
    jw.record_predicted_peak("features:cls/b64", 1000 * MB)
    jsnap = jw.sample()
    assert {k: jsnap[k] for k in ("device_bytes", "device_peak_bytes", "hbm_drift")} == \
        {k: snap[k] for k in ("device_bytes", "device_peak_bytes", "hbm_drift")}
    strip = lambda t: [ln for ln in t.splitlines() if ln.startswith(("mem_device", "mem_hbm"))]  # noqa: E731
    assert strip(text) == strip(jreg.render())


def test_cuda_watcher_raises_when_the_stats_read_fails(monkeypatch):
    def broken(device=None):
        raise RuntimeError("CUDA error: invalid device ordinal")

    monkeypatch.setattr(torch.cuda, "memory_stats", broken)
    reg = MetricsRegistry()
    w = pmw.MemoryWatcher(registry=reg, device="cuda:0")
    with pytest.raises(RuntimeError, match="invalid device ordinal"):
        w.sample()
    assert "mem_device_bytes" not in reg.render() and not w.device_stats_degraded


def test_card_headroom_refusal_names_the_card(monkeypatch):
    monkeypatch.setattr(pmw, "host_available_bytes", lambda: 64 * 1024 * MB)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (300 * MB, 80 * 1024 * MB))
    w = pmw.MemoryWatcher(registry=MetricsRegistry(), device="cuda:0")
    assert w.headroom_check(100 * MB, 200 * MB) is None
    refusal = w.headroom_check(100 * MB, 512 * MB)
    assert "512 MiB" in refusal and "card memory on cuda:0" in refusal and "host" not in refusal
    assert "host memory" in w.headroom_check(60 * 1024 * MB, 1)  # the host is checked first
    cpu = pmw.MemoryWatcher(registry=MetricsRegistry(), device="cpu")
    assert cpu.headroom_check(100 * MB, 512 * MB) is None  # a CPU watcher checks no card
