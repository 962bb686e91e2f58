"""The port's native tar reader against the JAX package's, on the CPU.

``data/native.py`` builds ``native/tario.cc`` with g++ into the port's
``_build/`` and reads it through ctypes; ``native_train_stream`` and
``TrainLoader(use_native=True)`` run over it. On 5 toy shards of 6
samples (JPEG and PNG, one sample without a label), at 1 and 3 reader
threads (3 threads over 5 shards leaves the stripes uneven):

- the reader yields the JAX reader's (bytes, label) sequence exactly;
- loader batches equal the JAX native loader's bit for bit over two
  epochs (the image backend is the same);
- a loader built from a mid-epoch ``snapshot()`` continues the sequence
  bit for bit, and the JAX native loader resumes from the port's cursor
  to the same batches; ``skip_samples`` of the stream replays exactly;
- a cursor of another thread count, or of the worker loader, is refused
  as the JAX loader refuses it, and a native cursor by the worker loader;
- a g++ that fails raises with its output instead of falling back.
"""

import io
import json
import os
import stat
from pathlib import Path

import numpy as np
import pytest

from jumbo_mae_tpu_tpu.data import loader as jloader
from jumbo_mae_tpu_tpu.data.native import NativeShardReader as JaxReader
from jumbo_mae_tpu_tpu_torch.data import loader as tloader
from jumbo_mae_tpu_tpu_torch.data import native as tnative
from jumbo_mae_tpu_tpu_torch.data import tario as ttario


def _encode(img: np.ndarray, fmt: str) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img, "RGB").save(buf, format=fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_shards")
    rng = np.random.default_rng(7)
    idx = 0
    for s in range(5):
        samples = []
        for _ in range(6):
            h, w = (int(x) for x in rng.integers(20, 40, 2))
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            fmt = "JPEG" if idx % 2 else "PNG"
            sample = {"__key__": f"n{idx:05d}", fmt.lower().replace("jpeg", "jpg"): _encode(img, fmt)}
            if idx != 7:  # one sample without a .cls member: label -1
                sample["cls"] = str(idx % 10).encode()
            samples.append(sample)
            idx += 1
        ttario.write_tar_samples(str(root / f"train-{s:04d}.tar"), samples)
    return root


def _urls(shard_dir):
    return [str(shard_dir / f"train-{s:04d}.tar") for s in range(5)]


def _cfgs(shard_dir, **kw):
    doc = dict(train_shards=f"{shard_dir}/train-{{0000..0004}}.tar", image_size=16, shuffle_buffer=5, seed=3,
               use_native=True, decode_threads=2, **kw)
    return tloader.DataConfig(**doc), jloader.DataConfig(**doc)


def _take(loader, n):
    out = [next(loader) for _ in range(n)]
    loader.close()
    return out


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys() == {"images", "labels"}
        np.testing.assert_array_equal(g["images"], w["images"], err_msg=f"batch {i}")
        np.testing.assert_array_equal(g["labels"], w["labels"], err_msg=f"batch {i}")


@pytest.mark.parametrize("threads", [1, 3])
def test_reader_order_matches_jax(shard_dir, threads):
    with tnative.NativeShardReader(_urls(shard_dir), threads=threads) as r:
        got = list(r)
    with JaxReader(_urls(shard_dir), threads=threads) as r:
        want = list(r)
    assert len(got) == 30 and got == want
    assert sorted(label for _, label in got).count(-1) == 1
    assert tnative.library_path().parent.parent == tnative.BUILD_ROOT  # built into the port's _build/


@pytest.mark.parametrize("threads", [1, 3])
def test_native_loader_matches_jax_over_two_epochs(shard_dir, threads):
    tcfg, jcfg = _cfgs(shard_dir, native_io_threads=threads, repeats=2, hflip=0.5, min_scale=0.3)
    n = 2 * 30 * 2 // 4  # two epochs of 30 samples, 2 repeats, batch 4
    loader = tloader.TrainLoader(tcfg, 4)
    got = [next(loader) for _ in range(n)]
    assert loader.snapshot()["native_threads"] == threads and loader.shard_snapshot() is None
    loader.close()
    _assert_batches_equal(got, _take(jloader.TrainLoader(jcfg, 4), n))


@pytest.mark.parametrize("threads", [1, 3])
def test_cursor_resume_and_skip_samples_are_bit_equal(shard_dir, threads):
    tcfg, jcfg = _cfgs(shard_dir, native_io_threads=threads)
    ref = _take(tloader.TrainLoader(tcfg, 4), 12)
    first = tloader.TrainLoader(tcfg, 4)
    for _ in range(9):  # past the first epoch's 7.5 batches
        next(first)
    snap = json.loads(json.dumps(first.snapshot()))  # as a checkpoint stores it
    first.close()
    assert snap["native_threads"] == threads and snap["workers"][0][0] == 1
    _assert_batches_equal(_take(tloader.TrainLoader(tcfg, 4, cursor=snap), 3), ref[9:])
    _assert_batches_equal(_take(jloader.TrainLoader(jcfg, 4, cursor=snap), 3), ref[9:])
    # the stream itself: skip_samples replays the JAX stream's prefix
    got = tloader.native_train_stream(tcfg, skip_samples=11)
    want = jloader.native_train_stream(jcfg, skip_samples=11)
    for _ in range(8):
        (gi, gl), (wi, wl) = next(got), next(want)
        np.testing.assert_array_equal(gi, wi)
        assert gl == wl
    got.close()
    want.close()


def test_cursor_of_another_loader_is_refused_as_jax_refuses_it(shard_dir):
    tcfg, jcfg = _cfgs(shard_dir, native_io_threads=3)
    native = {"workers": [[0, 8]], "batches": 2, "native_threads": 1}
    workers = {"workers": [[0, 8]], "batches": 2}
    for cursor, match in ((native, "native_io_threads=1"), (workers, "subprocess-worker")):
        with pytest.raises(ValueError, match=match):
            tloader.TrainLoader(tcfg, 4, cursor=cursor)
        with pytest.raises(ValueError, match=match):
            jloader.TrainLoader(jcfg, 4, cursor=cursor)
    plain_t, plain_j = (type(c)(**{**c.__dict__, "use_native": False, "workers": 0}) for c in (tcfg, jcfg))
    for make in (lambda: tloader.TrainLoader(plain_t, 4, cursor=native),
                 lambda: jloader.TrainLoader(plain_j, 4, cursor=native)):
        with pytest.raises(ValueError, match="native-IO loader"):
            make()


def test_a_failing_gxx_raises_with_its_output(shard_dir, tmp_path, monkeypatch):
    fake = tmp_path / "bin" / "g++"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'tario.cc:1: error: the compiler refused' >&2\nexit 3\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{fake.parent}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="exit 3") as err:
        tnative.NativeShardReader(_urls(shard_dir))
    assert "the compiler refused" in str(err.value)
    assert not list((tmp_path / "build").rglob("*.so"))  # nothing half-built is left
    tcfg, _ = _cfgs(shard_dir)
    loader = tloader.TrainLoader(tcfg, 4)
    with pytest.raises(RuntimeError, match="the compiler refused"):
        next(loader)
    loader.close()
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tnative.build()
