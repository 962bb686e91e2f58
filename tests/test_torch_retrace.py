"""The port's capture sentinel (``obs/retrace.py``) on the CPU.

``_sig_diff`` (the attribution) equals the JAX sentinel's on the same
signatures, and ``_signature`` reads numpy arrays as the JAX one does.
Then a CPU engine whose ``on_compile`` hook is the sentinel: after a
warmup of buckets 1 and 2 and ``arm()``, requests at warmed buckets make
no violation; one request at an unwarmed bucket makes exactly one, naming
its key and bucket, with the signature change that caused it; the same
kind of request inside ``expected()`` makes none. The metrics follow.
"""

import warnings
from pathlib import Path

import numpy as np
import pytest

from jumbo_mae_tpu_tpu.obs import retrace as jrt
from jumbo_mae_tpu_tpu_torch.config import load_config
from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine
from jumbo_mae_tpu_tpu_torch.obs import retrace as prt
from jumbo_mae_tpu_tpu_torch.obs.metrics import MetricsRegistry

RECIPE = Path(__file__).resolve().parent.parent / "recipes" / "smoke_cpu.yaml"

SIGS = [
    ((((2, 32, 32, 3), "uint8"),), (((4, 32, 32, 3), "uint8"),)),
    ((((2, 32, 32, 3), "uint8"),), (((2, 32, 32, 3), "float32"),)),
    ((((2, 8), "float32"), ((2,), "int32")), (((2, 8), "float32"),)),
    ((((1,), "float32"),), (((1,), "float32"), ((3, 3), "bfloat16"))),
    ((((5, 5), "uint8"),), (((5, 5), "uint8"),)),
]


@pytest.mark.parametrize("prev,new", SIGS)
def test_sig_diff_equals_jax(prev, new):
    assert prt._sig_diff(prev, new) == jrt._sig_diff(prev, new)


def test_signature_of_arrays_equals_jax():
    tree = {"b": np.zeros((2, 3), np.float32), "a": [np.zeros(4, np.uint8), np.zeros((1, 1), np.int32)]}
    assert prt._signature(tree) == jrt._signature(tree)


def test_capture_sentinel_on_a_cpu_engine():
    reg = MetricsRegistry()
    s = prt.RetraceSentinel("predict", registry=reg)
    eng = InferenceEngine(load_config(RECIPE), max_batch=4, device="cpu", warm_cache=False, on_compile=s.on_compile,
                          registry=MetricsRegistry())
    assert eng.warmup(("features",), buckets=(1, 2)) == 2
    s.arm()
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    for n in (1, 2, 2, 1):  # warmed buckets: no capture, no violation
        s.note("serve_batch", imgs[:n])
        eng.features(imgs[:n])
    assert s.summary() == {"loop": "predict", "compiles": 2, "expected": 2, "violations": 0}
    s.assert_steady()
    s.note("serve_batch", imgs[:3])  # bucket 4 was never warmed
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng.features(imgs[:3])
    assert len(caught) == 1 and "features:cls/b4" in str(caught[0].message)
    (v,) = s.violations
    assert (v["task"], v["bucket"], v["tag"]) == ("features:cls", 4, "serve_batch")
    assert v["diff"] == [{"leaf": 0, "prev_shape": [1, 32, 32, 3], "prev_dtype": "uint8", "new_shape": [3, 32, 32, 3],
                          "new_dtype": "uint8"}]
    with pytest.raises(AssertionError, match="1 unexpected capture"):
        s.assert_steady()
    eng.features(imgs[:4])  # now captured: a hit
    with s.expected("swap"):  # a key first built inside expected(): legitimate
        eng.features(imgs[:2], pool="gap")
    assert s.summary() == {"loop": "predict", "compiles": 4, "expected": 3, "violations": 1}
    snap = reg.snapshot()
    assert snap["retrace_compiles_total"] == {"predict": 4.0} and snap["retrace_events_total"] == {"predict": 1.0}
    assert snap["retrace_armed"] == {"predict": 1.0}
    s.close()
    eng.features(imgs[:2], pool="tokens")  # a closed sentinel counts nothing
    assert s.summary()["compiles"] == 4 and reg.snapshot()["retrace_armed"] == {"predict": 0.0}


def test_journal_gets_the_violation():
    events = []

    class Journal:
        def event(self, etype, **fields):
            events.append((etype, fields))

    s = prt.RetraceSentinel("predict", journal=Journal(), registry=MetricsRegistry())
    s.on_compile("logits", 8)  # before arm(): expected
    s.arm()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s.on_compile("logits", 16)
    assert [(e, f["task"], f["bucket"], f["tag"]) for e, f in events] == [("retrace", "logits", 16, None)]
