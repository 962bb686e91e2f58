"""The port's MicroBatcher (infer/batching.py), on the CPU.

Mirrors the JAX package's batcher cases (tests/test_infer_engine.py and
tests/test_serve.py): FIFO row routing under a thread storm, the delay
and size caps, coalescing, per-batch error routing, ``pass_meta``, the
engine behind the queue, the windowed occupancy; plus the bounded-queue,
deadline and shutdown contracts and the counts ``stats()`` carries.
"""

import threading
import time
from concurrent.futures import wait
from pathlib import Path

import numpy as np
import pytest

from jumbo_mae_tpu_tpu_torch.config import load_config
from jumbo_mae_tpu_tpu_torch.infer import (
    DeadlineExceededError,
    InferenceEngine,
    MicroBatcher,
    QueueFullError,
    ShutdownError,
)
from jumbo_mae_tpu_tpu_torch.infer.batching import OccupancyWindow

RECIPE = Path(__file__).resolve().parent.parent / "recipes" / "smoke_cpu.yaml"


def _img(v):
    return np.full((2, 2, 1), v, np.float64)


def test_microbatcher_orders_and_caps_batches():
    """Thread storm: every response is the transform of its own request,
    and no flushed batch exceeds max_batch."""
    sizes = []

    def run_fn(batch):
        sizes.append(batch.shape[0])
        return batch.sum(axis=(1, 2, 3)).astype(np.int64)

    n, workers = 200, 16
    tags = np.arange(n)
    imgs = tags[:, None, None, None] * np.ones((1, 2, 2, 1), np.int64)
    results = [None] * n
    with MicroBatcher(run_fn, max_batch=7, max_delay_ms=2.0) as mb:
        def client(lo, hi):
            for i in range(lo, hi):
                results[i] = mb.submit(imgs[i]).result()

        step = -(-n // workers)
        threads = [threading.Thread(target=client, args=(w * step, min(n, (w + 1) * step))) for w in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert max(sizes) <= 7 and sum(sizes) == n
    np.testing.assert_array_equal(np.asarray(results), tags * 4)


def test_microbatcher_respects_deadline_without_full_batch():
    with MicroBatcher(lambda b: b.sum(axis=(1, 2, 3)), max_batch=64, max_delay_ms=30.0) as mb:
        t0 = time.monotonic()
        mb.submit(np.ones((2, 2, 1))).result(timeout=5)
        elapsed = time.monotonic() - t0
    assert elapsed < 2.0
    assert mb.batch_sizes == [1]


def test_microbatcher_coalesces_within_window():
    release = threading.Event()

    def run_fn(batch):
        release.wait(5)
        return batch.sum(axis=(1, 2, 3))

    with MicroBatcher(run_fn, max_batch=8, max_delay_ms=200.0) as mb:
        a = mb.submit(np.ones((2, 2, 1)))
        b = mb.submit(np.full((2, 2, 1), 2.0))
        release.set()
        assert a.result(timeout=5) == 4.0
        assert b.result(timeout=5) == 8.0
    assert mb.batch_sizes[0] >= 1 and sum(mb.batch_sizes) == 2


def test_microbatcher_propagates_errors_per_batch():
    calls = []

    def run_fn(batch):
        calls.append(batch.shape[0])
        if len(calls) == 1:
            raise RuntimeError("boom")
        return batch.sum(axis=(1, 2, 3))

    with MicroBatcher(run_fn, max_batch=4, max_delay_ms=1.0) as mb:
        bad = mb.submit(np.ones((2, 2, 1)))
        with pytest.raises(RuntimeError, match="boom"):
            bad.result(timeout=5)
        good = mb.submit(np.ones((2, 2, 1)))
        assert good.result(timeout=5) == 4.0
    assert mb.stats()["requests_failed"] == 1
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(np.ones((2, 2, 1)))


def test_microbatcher_pass_meta():
    seen = []

    def run_fn(batch, metas):
        seen.append(list(metas))
        return batch.sum(axis=(1, 2, 3))

    with MicroBatcher(run_fn, max_batch=4, max_delay_ms=50.0, pass_meta=True) as mb:
        futs = [mb.submit(np.full((2, 2, 1), i), meta={"req": i}) for i in range(3)]
        vals = [f.result(timeout=5) for f in futs]
    assert vals == [0.0, 4.0, 8.0]
    assert [m for batch in seen for m in batch] == [{"req": 0}, {"req": 1}, {"req": 2}]


def test_microbatcher_serves_engine_concurrently():
    """Single-image submits through the batcher reproduce the engine's
    direct batched output row for row (float32: every bucket exact), for
    features and for the dict of reconstruct."""
    eng = InferenceEngine(load_config(RECIPE), max_batch=8, device="cpu")
    imgs = np.random.default_rng(8).integers(0, 256, (12, 32, 32, 3), dtype=np.uint8)
    direct = eng.features(imgs)
    with MicroBatcher(eng.features, max_batch=8, max_delay_ms=5.0) as mb:
        rows = np.stack([f.result(timeout=30) for f in [mb.submit(img) for img in imgs]])
    np.testing.assert_allclose(rows, direct, rtol=1e-5, atol=1e-5)
    assert max(mb.batch_sizes) <= 8
    with MicroBatcher(lambda b: eng.reconstruct(b, seed=3), max_batch=8, max_delay_ms=5.0) as mb:
        rows = [f.result(timeout=30) for f in [mb.submit(img) for img in imgs[:3]]]
    ref = eng.reconstruct(imgs[:3], seed=3)
    assert set(rows[0]) == {"reconstruction", "mask"}
    np.testing.assert_array_equal(np.stack([r["mask"] for r in rows]), ref["mask"])


def test_occupancy_window_ewma_and_window_mean():
    w = OccupancyWindow(8, alpha=0.5, window=4)
    snap = w.snapshot()
    assert snap["ewma"] == 0.0 and snap["batches"] == 0
    w.observe(8)
    w.observe(4)
    snap = w.snapshot()
    assert snap["ewma"] == pytest.approx(0.75) and snap["window_mean"] == pytest.approx(0.75)
    assert snap["last"] == pytest.approx(0.5) and snap["batches"] == 2


def test_microbatcher_occupancy_is_windowed_not_last_flush():
    mb = MicroBatcher(lambda b: {"y": b[:, 0, 0, 0]}, max_batch=4, max_delay_ms=1.0)
    try:
        wait([mb.submit(_img(i)) for i in range(4)], timeout=10)
        wait([mb.submit(_img(9))], timeout=10)
        for _ in range(200):
            if len(mb.batch_sizes) >= 2:
                break
            time.sleep(0.005)
        s = mb.stats()
        assert s["last_batch_occupancy"] == pytest.approx(0.25)
        assert s["batch_occupancy"] > 0.25
        assert s["window_batch_occupancy"] == pytest.approx(0.625)
    finally:
        mb.close()


def test_max_queue_sheds_instead_of_buffering():
    gate = threading.Event()

    def run_fn(batch):
        gate.wait(5)
        return batch.sum(axis=(1, 2, 3))

    with MicroBatcher(run_fn, max_batch=1, max_delay_ms=0.0, max_queue=2) as mb:
        first = mb.submit(_img(1))
        time.sleep(0.05)  # the collector holds it inside run_fn
        queued = [mb.submit(_img(2)), mb.submit(_img(3))]
        with pytest.raises(QueueFullError):
            mb.submit(_img(4))
        gate.set()
        assert [f.result(timeout=5) for f in [first, *queued]] == [4.0, 8.0, 12.0]
        s = mb.stats()
    assert s["requests_shed"] == 1 and s["requests_submitted"] == 4 and s["shed_rate"] == 0.25
    with pytest.raises(ValueError):
        MicroBatcher(run_fn, max_queue=0)
    with pytest.raises(ValueError):
        MicroBatcher(run_fn, max_batch=0)


def test_deadline_expires_queued_and_late_requests():
    """A request still queued past its deadline is expired before
    admission; one admitted in time whose deadline passes inside run_fn is
    failed as late, not resolved."""
    gate = threading.Event()

    def run_fn(batch):
        gate.wait(5)
        return batch.sum(axis=(1, 2, 3))

    with MicroBatcher(run_fn, max_batch=1, max_delay_ms=0.0) as mb:
        late = mb.submit(_img(1), deadline_ms=20.0)
        time.sleep(0.05)
        expired = mb.submit(_img(2), deadline_ms=1.0)
        time.sleep(0.05)
        ok = mb.submit(_img(3))
        gate.set()
        with pytest.raises(DeadlineExceededError, match="coalescing/compute"):
            late.result(timeout=5)
        with pytest.raises(DeadlineExceededError, match="queued"):
            expired.result(timeout=5)
        assert ok.result(timeout=5) == 12.0
        s = mb.stats()
    assert s["requests_late"] == 1 and s["requests_expired"] == 1 and s["requests_served"] == 2


@pytest.mark.parametrize("drain", [True, False])
def test_close_resolves_every_pending_request(drain):
    gate = threading.Event()

    def run_fn(batch):
        gate.wait(5)
        return batch.sum(axis=(1, 2, 3))

    mb = MicroBatcher(run_fn, max_batch=1, max_delay_ms=0.0)
    futs = [mb.submit(_img(i)) for i in range(4)]
    time.sleep(0.05)
    closer = threading.Thread(target=mb.close, kwargs={"drain": drain})
    closer.start()
    time.sleep(0.05)
    gate.set()
    closer.join(10)
    assert not closer.is_alive() and all(f.done() for f in futs)
    assert futs[0].result() == 0.0  # in run_fn when the close came
    rest = [f.exception() for f in futs[1:]]
    if drain:
        assert all(isinstance(e, ShutdownError) for e in rest)
        assert mb.stats()["requests_aborted"] == 3
    else:
        assert rest == [None, None, None] and [f.result() for f in futs[1:]] == [4.0, 8.0, 12.0]


def test_stats_counts_and_latency():
    with MicroBatcher(lambda b: b.sum(axis=(1, 2, 3)), max_batch=4, max_delay_ms=1.0) as mb:
        assert mb(_img(1)) == 4.0
        wait([mb.submit(_img(i)) for i in range(5)], timeout=10)
        s = mb.stats()
    assert s["requests_submitted"] == 6 and s["requests_served"] == 6 and s["queue_depth"] == 0
    assert s["batches"] == len(mb.batch_sizes) and s["queue_bytes"] == 0
    assert 0.0 < s["latency_p50_s"] <= s["latency_p99_s"] < 5.0
