"""The port's data pipeline against the JAX package's, on the CPU.

- shard expansion, shuffle and split equal the JAX functions;
- a tar written by either package reads identically in the other;
- decode and every transform equal the JAX function bit for bit with the
  same backend (cv2, and PIL with cv2 patched out of both packages) and
  the same ``np.random.Generator``;
- ``TrainLoader`` batches equal the JAX ``TrainLoader``'s bit for bit over
  two epochs of shards written here, inline and with 2 worker processes,
  with 1 and 2 repeats; a loader built from a mid-epoch ``snapshot()``
  continues the same sequence;
- ``valid_loader`` keeps the pad contract (``valid=False``, ``label=-1``)
  as the JAX one does;
- ``write_toy_shards`` decodes to ``toy_examples``' arrays;
- RandAugment, AugMix and AutoAugment (``data/randaugment.py``) give the
  JAX policies' outputs bit for bit from the same generator, and loader
  batches with ``auto_augment`` equal the JAX ``TrainLoader``'s, inline
  and with worker processes;
- a worker runs where torch cannot be imported; the prefetch passes host
  batches through on the CPU; every data option constructs.
"""

import io
import json
import os
import pickle
import struct
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

import jumbo_mae_tpu_tpu.data.decode as jdecode
import jumbo_mae_tpu_tpu.data.transforms as jtr
from jumbo_mae_tpu_tpu.data import loader as jloader
from jumbo_mae_tpu_tpu.data import shards as jshards
from jumbo_mae_tpu_tpu.data import tario as jtario
from jumbo_mae_tpu_tpu.data import toy as jtoy
from jumbo_mae_tpu_tpu_torch.data import decode as tdecode
from jumbo_mae_tpu_tpu.data import randaugment as jaug
from jumbo_mae_tpu_tpu_torch.data import loader as tloader
from jumbo_mae_tpu_tpu_torch.data import randaugment as taug
from jumbo_mae_tpu_tpu_torch.data import resize as tresize
from jumbo_mae_tpu_tpu_torch.data import shards as tshards
from jumbo_mae_tpu_tpu_torch.data import tario as ttario
from jumbo_mae_tpu_tpu_torch.data import toy as ttoy
from jumbo_mae_tpu_tpu_torch.data import transforms as ttr

REPO = Path(__file__).resolve().parent.parent


def _encode(img: np.ndarray, fmt: str) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img, "RGB").save(buf, format=fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    """4 shards × 6 samples of varied sizes, JPEG and PNG, with labels."""
    root = tmp_path_factory.mktemp("tshards")
    rng = np.random.default_rng(0)
    idx = 0
    for s in range(4):
        samples = []
        for _ in range(6):
            h, w = (int(x) for x in rng.integers(20, 48, 2))
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            fmt = "JPEG" if idx % 2 else "PNG"
            samples.append({"__key__": f"s{idx:05d}", fmt.lower().replace("jpeg", "jpg"): _encode(img, fmt),
                            "cls": str(idx % 10).encode()})
            idx += 1
        ttario.write_tar_samples(str(root / f"train-{s:04d}.tar"), samples)
    return root


def test_shard_functions_match_jax():
    specs = ["pre-{0000..0011}.tar", "a.tar::b-{01..03}.tar", ["x", "y", "z"]]
    for spec in specs:
        assert tshards.expand_shards(spec) == jshards.expand_shards(spec)
    urls = tshards.expand_shards(specs[0])
    for seed in (0, 3):
        for epoch in (0, 1, 7):
            assert tshards.shuffle_shards(urls, seed=seed, epoch=epoch) == jshards.shuffle_shards(urls, seed=seed, epoch=epoch)
    for pc in (1, 3):
        for wc in (1, 2):
            for p in range(pc):
                for w in range(wc):
                    kw = dict(process_index=p, process_count=pc, worker_index=w, worker_count=wc)
                    assert tshards.split_shards(urls, **kw) == jshards.split_shards(urls, **kw)
    with pytest.raises(ValueError):
        tshards.expand_shards("x-{5..3}.tar")


def test_resize_ledger_functions_match_jax():
    from jumbo_mae_tpu_tpu.data import resize as jresize

    order = tresize.epoch_shard_order("s-{00..09}.tar", seed=2, epoch=1)
    assert order == jresize.epoch_shard_order("s-{00..09}.tar", seed=2, epoch=1)
    consumed = {0, 3, 4}
    for w in range(2):
        kw = dict(world_size=3, process_id=1, worker_index=w, worker_count=2)
        assert tresize.resize_assignment(order, consumed, **kw) == jresize.resize_assignment(order, consumed, **kw)
    led = tresize.ShardLedger()
    led.note_read(0, 5)
    led.note_read_done(0, 5)
    assert led.snapshot() == {"epochs": {}}
    led.note_yield(0, 5)
    assert led.snapshot() == {"epochs": {"0": [5]}}
    states = [led.snapshot(), None, {"epochs": {"0": [1], "1": [2]}}]
    assert tresize.merge_shard_states(states) == jresize.merge_shard_states(states)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tar_written_by_one_package_reads_in_the_other(tmp_path, writer):
    rng = np.random.default_rng(1)
    samples = [{"__key__": f"d/k{i}", "seg.png": rng.bytes(50), "cls": b"3", "jpg": rng.bytes(int(rng.integers(1, 900)))}
               for i in range(5)]
    url = str(tmp_path / "x.tar")
    (ttario if writer == "port" else jtario).write_tar_samples(url, samples)
    got = list(ttario.iter_tar_samples(url))
    want = list(jtario.iter_tar_samples(url))
    assert got == want
    assert [s["__key__"] for s in got] == [f"d/k{i}" for i in range(5)] and got[2]["seg.png"] == samples[2]["seg.png"]
    assert list(ttario.iter_shards_samples([url, "file://" + url])) == list(jtario.iter_shards_samples([url, "file://" + url]))


def test_truncated_shard_is_quarantined(tmp_path):
    url = str(tmp_path / "t.tar")
    ttario.write_tar_samples(url, [{"__key__": f"k{i}", "bin": bytes(3000)} for i in range(4)])
    data = Path(url).read_bytes()
    Path(url).write_bytes(data[: len(data) // 2])
    ttario.QUARANTINE.clear()
    got = list(ttario.iter_tar_samples(url, retry=ttario.RetryPolicy(attempts=2, backoff_s=0.0)))
    assert 0 < len(got) < 4
    assert url in ttario.QUARANTINE.snapshot()
    ttario.QUARANTINE.clear()


@pytest.fixture(params=["cv2", "PIL"])
def backend(request, monkeypatch):
    """Both packages on one backend: cv2, or PIL with cv2 patched out of
    the decode and transform modules of both."""
    if request.param == "PIL":
        for mod in (jdecode, jtr, tdecode, ttr):
            monkeypatch.setattr(mod, "cv2", None)
    assert tdecode.backend() == request.param
    assert ttr.backend() == request.param
    return request.param


def test_decode_matches_jax(backend):
    rng = np.random.default_rng(2)
    for fmt in ("PNG", "JPEG", "BMP"):
        img = rng.integers(0, 256, (23, 31, 3), dtype=np.uint8)
        payload = _encode(img, fmt)
        got, want = tdecode.decode_image(payload), jdecode.decode_image(payload)
        assert got.dtype == np.uint8 and got.shape == (23, 31, 3)
        np.testing.assert_array_equal(got, want)
    assert tdecode.decode_image(b"not an image") is None
    assert tdecode.decode_label(b" 7\n") == jdecode.decode_label(b" 7\n") == 7
    sample = {"__key__": "k", "cls": b"1", "png": b""}
    assert tdecode.find_image_key(sample) == jdecode.find_image_key(sample) == "png"


TRANSFORMS = {
    "resize": lambda m, g, img: m.resize(img, (17, 29)),
    "resize_bilinear": lambda m, g, img: m.resize(img, (40, 12), "bilinear"),
    "resize_shorter": lambda m, g, img: m.resize_shorter(img, 24),
    "center_crop": lambda m, g, img: m.center_crop(img, 40),
    "eval_transform": lambda m, g, img: m.eval_transform(img, 16),
    "random_resized_crop": lambda m, g, img: m.random_resized_crop(g, img, 16),
    "random_resized_crop_wide": lambda m, g, img: m.random_resized_crop(g, img, 20, scale=(0.9, 1.0), ratio=(3.0, 4.0)),
    "simple_resize_crop": lambda m, g, img: m.simple_resize_crop(g, img, 16),
    "random_hflip": lambda m, g, img: m.random_hflip(g, img, 0.5),
    "brightness": lambda m, g, img: m.adjust_brightness(img, 1.3),
    "contrast": lambda m, g, img: m.adjust_contrast(img, 0.6),
    "saturation": lambda m, g, img: m.adjust_saturation(img, 1.7),
    "hue": lambda m, g, img: m.adjust_hue(img, 0.2),
    "color_jitter": lambda m, g, img: m.color_jitter(g, img, 0.4, hue=0.1),
    "random_erasing": lambda m, g, img: m.random_erasing(g, img, 0.9),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax_bit_for_bit(name, backend):
    fn = TRANSFORMS[name]
    for seed in range(4):
        img = np.random.default_rng(seed).integers(0, 256, (27 + seed, 35, 3), dtype=np.uint8)
        got = fn(ttr, np.random.default_rng(100 + seed), img)
        want = fn(jtr, np.random.default_rng(100 + seed), img)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"{name} seed {seed}")


LOADER_CASES = [(0, 1), (2, 1), (0, 2), (2, 2)]


def _cfgs(shard_dir, **kw):
    doc = dict(train_shards=f"{shard_dir}/train-{{0000..0003}}.tar", image_size=16, shuffle_buffer=5, seed=3, **kw)
    return tloader.DataConfig(**doc), jloader.DataConfig(**doc)


def _take(loader, n):
    out = [next(loader) for _ in range(n)]
    loader.close()
    return out


@pytest.mark.parametrize("workers,repeats", LOADER_CASES)
def test_train_loader_matches_jax_over_two_epochs(shard_dir, workers, repeats):
    tcfg, jcfg = _cfgs(shard_dir, workers=workers, repeats=repeats, hflip=0.5, min_scale=0.3)
    batch = 4
    n = 2 * 24 * repeats // batch  # two epochs of 24 samples (clones included)
    got = _take(tloader.TrainLoader(tcfg, batch), n)
    want = _take(jloader.TrainLoader(jcfg, batch), n)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys() == {"images", "labels"}
        np.testing.assert_array_equal(g["images"], w["images"], err_msg=f"batch {i}")
        np.testing.assert_array_equal(g["labels"], w["labels"], err_msg=f"batch {i}")
    assert got[0]["images"].shape == (batch, 16, 16, 3) and got[0]["images"].dtype == np.uint8


@pytest.mark.parametrize("workers", [0, 2])
def test_snapshot_mid_epoch_continues_the_sequence(shard_dir, workers):
    tcfg, jcfg = _cfgs(shard_dir, workers=workers, repeats=2)
    full = tloader.TrainLoader(tcfg, 4)
    ref = _take(full, 9)
    first = tloader.TrainLoader(tcfg, 4)
    for _ in range(5):
        next(first)
    snap = json.loads(json.dumps(first.snapshot()))  # as a checkpoint stores it
    shards = first.shard_snapshot()
    first.close()
    resumed = _take(tloader.TrainLoader(tcfg, 4, cursor=snap), 4)
    for a, b in zip(resumed, ref[5:]):
        np.testing.assert_array_equal(a["images"], b["images"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
    # the JAX loader resumes from the port's cursor to the same batches
    jres = _take(jloader.TrainLoader(jcfg, 4, cursor=snap), 4)
    for a, b in zip(jres, ref[5:]):
        np.testing.assert_array_equal(a["images"], b["images"])
    assert snap["batches"] == 5 and isinstance(shards, dict)
    with pytest.raises(ValueError, match="worker streams"):
        tloader.TrainLoader(tcfg, 4, cursor={"workers": [[0, 0]] * 3, "batches": 0})


def test_valid_loader_pad_contract_matches_jax(shard_dir):
    tcfg, jcfg = _cfgs(shard_dir, valid_shards=f"{shard_dir}/train-{{0000..0002}}.tar")
    got = list(tloader.valid_loader(tcfg, 5))
    want = list(jloader.valid_loader(jcfg, 5))
    assert len(got) == len(want) == 4  # 18 samples: 3 full batches and one of 3 rows
    for g, w in zip(got, want):
        for k in ("images", "labels", "valid"):
            np.testing.assert_array_equal(g[k], w[k])
    last = got[-1]
    assert last["valid"].tolist() == [True] * 3 + [False] * 2
    assert last["labels"][3:].tolist() == [-1, -1] and not last["images"][3:].any()


def test_toy_shards_decode_to_toy_examples(tmp_path):
    urls = ttoy.write_toy_shards(tmp_path, n_train=20, n_val=6, shard_size=8, image_size=24, classes=4)
    images, labels = ttoy.toy_examples(26, image_size=24, classes=4)
    jimages, jlabels = jtoy.toy_examples(26, image_size=24, classes=4)
    np.testing.assert_array_equal(images, jimages)
    np.testing.assert_array_equal(labels, jlabels)
    got = [s for s in ttario.iter_shards_samples(tshards.expand_shards(urls["train"]))]
    got += [s for s in ttario.iter_shards_samples(tshards.expand_shards(urls["val"]))]
    assert len(got) == 26
    for s in got:
        i = int(s["__key__"][3:])
        np.testing.assert_array_equal(tdecode.decode_image(s["png"]), images[i])
        assert tdecode.decode_label(s["cls"]) == labels[i]
    assert ttoy.toy_pretrain_hparams(600) == jtoy.toy_pretrain_hparams(600)


def test_worker_runs_without_torch(shard_dir):
    """A worker interpreter where ``import torch`` raises still streams
    batches: the data path never needs torch."""
    tcfg, _ = _cfgs(shard_dir)
    spec = {"data": asdict(tcfg), "batch_size": 4, "process_index": 0, "process_count": 1,
            "worker_index": 0, "worker_count": 1}
    code = (
        "import sys, runpy\n"
        "sys.modules['torch'] = None\n"
        f"sys.argv = ['w', {json.dumps(spec)!r}]\n"
        "runpy.run_module('jumbo_mae_tpu_tpu_torch.data._worker', run_name='__main__')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
    try:
        (length,) = struct.unpack(">Q", proc.stdout.read(8))
        batch = pickle.loads(proc.stdout.read(length))
    finally:
        proc.kill()
        proc.communicate(timeout=30)
    assert batch["images"].shape == (4, 16, 16, 3) and batch["_cursor"] == (0, 4)


def test_prefetch_passes_host_batches_through_on_the_cpu():
    batches = [{"images": np.full((2, 4, 4, 3), i, np.uint8)} for i in range(5)]
    got = list(tloader.prefetch_to_device(iter(batches), "cpu"))
    assert all(g is b for g, b in zip(got, batches)) and len(got) == 5
    accum = tloader.split_for_accum({"images": np.zeros((8, 2, 2, 3))}, 4)
    assert accum["images"].shape == (4, 2, 2, 2, 3)


def test_more_workers_than_shards_raises(shard_dir):
    """A worker without shards would spin forever reading nothing (the JAX
    loader then waits 10 minutes and raises); the port refuses it at once."""
    with pytest.raises(ValueError, match="lower data.workers"):
        tloader.TrainLoader(_cfgs(shard_dir, workers=5)[0], 4)
    with pytest.raises(ValueError, match="lower data.workers"):
        tloader.TrainLoader(_cfgs(shard_dir, workers=3)[0], 4, process_index=1, process_count=2)


def test_unported_data_options_raise(shard_dir, tmp_path):
    """No data option is left unported: auto_augment (A4) runs since
    finetuning was ported, use_native and valid_cache (A3.1, A3.2) since
    the native reader and the validation cache were (their parity tests:
    tests/test_torch_native.py, tests/test_torch_valcache.py)."""
    loader = tloader.TrainLoader(_cfgs(shard_dir, use_native=True)[0], 4)
    assert next(loader)["images"].shape == (4, 16, 16, 3)
    loader.close()
    tloader.TrainLoader(_cfgs(shard_dir, auto_augment="rand-m9-mstd0.5-inc1")[0], 4).close()
    cfg = _cfgs(shard_dir, valid_cache=str(tmp_path / "vc"), valid_shards=f"{shard_dir}/train-0000.tar")[0]
    assert [b["valid"].sum() for b in tloader.valid_loader(cfg, 4)] == [4, 2]
    assert len(list((tmp_path / "vc").glob("val-*.json"))) == 1


POLICIES = ["rand-m9-mstd0.5-inc1", "rand-m5-n3-p0.9", "rand-m7", "augmix-m3-w3-d2", "augmix-m5-a0.5",
            "original", "original-mstd0.5"]


@pytest.mark.parametrize("policy", POLICIES)
def test_augment_policies_match_jax_bit_for_bit(policy):
    rng = np.random.default_rng(1)
    for seed in range(6):
        h, w = (int(x) for x in rng.integers(16, 40, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got = taug.auto_augment_factory(policy)(np.random.default_rng(seed), img)
        want = jaug.auto_augment_factory(policy)(np.random.default_rng(seed), img)
        assert got.dtype == want.dtype == np.uint8 and got.shape == img.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{policy} seed {seed}")
    assert taug.auto_augment_factory("none") is None and taug.auto_augment_factory("") is None
    with pytest.raises(ValueError, match="bad policy token"):
        taug.auto_augment_factory("rand-x")


@pytest.mark.parametrize("workers", [0, 2])
def test_train_loader_with_auto_augment_matches_jax(shard_dir, workers):
    tcfg, jcfg = _cfgs(shard_dir, workers=workers, hflip=0.5, min_scale=0.3, auto_augment="rand-m9-mstd0.5-inc1",
                       color_jitter=0.3, random_erasing=0.25)
    n = 24 // 4 + 2  # past the first epoch
    got = _take(tloader.TrainLoader(tcfg, 4), n)
    want = _take(jloader.TrainLoader(jcfg, 4), n)
    plain = _take(tloader.TrainLoader(_cfgs(shard_dir, workers=workers, hflip=0.5, min_scale=0.3,
                                            color_jitter=0.3, random_erasing=0.25)[0], 4), n)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g["images"], w["images"], err_msg=f"batch {i}")
        np.testing.assert_array_equal(g["labels"], w["labels"], err_msg=f"batch {i}")
    assert any(not np.array_equal(g["images"], p["images"]) for g, p in zip(got, plain))
