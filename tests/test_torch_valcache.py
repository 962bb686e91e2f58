"""The port's validation-sample cache against the JAX package's, on the CPU.

``data/valcache.py`` and ``valid_loader`` with ``data.valid_cache`` set, on
3 toy validation shards of 5 samples (JPEG and PNG) at 16 px:

- the two packages name a cache alike (the same key fields and hash), a
  cache the JAX loader wrote is read by the port's with batches equal to
  an uncached pass bit for bit, and the other way round;
- the second pass opens no shard (every open of a tar is counted);
- a pass that stops before its end leaves no commit marker and no data
  file, and the next pass reads the shards and commits.
"""

import io

import numpy as np
import pytest

from jumbo_mae_tpu_tpu.data import loader as jloader
from jumbo_mae_tpu_tpu.data import tario as jtario
from jumbo_mae_tpu_tpu.data.valcache import ValidSampleCache as JaxCache
from jumbo_mae_tpu_tpu_torch.data import loader as tloader
from jumbo_mae_tpu_tpu_torch.data import tario as ttario
from jumbo_mae_tpu_tpu_torch.data.valcache import ValidSampleCache


def _encode(img: np.ndarray, fmt: str) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img, "RGB").save(buf, format=fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


@pytest.fixture(scope="module")
def val_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("val_shards")
    rng = np.random.default_rng(11)
    for s in range(3):
        samples = []
        for i in range(5):
            img = rng.integers(0, 256, tuple(int(x) for x in rng.integers(18, 40, 2)) + (3,), dtype=np.uint8)
            fmt = "JPEG" if (s + i) % 2 else "PNG"
            samples.append({"__key__": f"v{s}{i}", fmt.lower().replace("jpeg", "jpg"): _encode(img, fmt),
                            "cls": str(s * 5 + i).encode()})
        ttario.write_tar_samples(str(root / f"val-{s:02d}.tar"), samples)
    return root


def _cfgs(val_dir, cache=""):
    doc = dict(valid_shards=f"{val_dir}/val-{{00..02}}.tar", image_size=16, valid_cache=str(cache))
    return tloader.DataConfig(**doc), jloader.DataConfig(**doc)


@pytest.fixture
def opens(monkeypatch):
    """Counts of shard opens by each package's tar reader."""
    count = {"port": 0, "jax": 0}
    for mod, key in ((ttario, "port"), (jtario, "jax")):
        real = mod.open_url

        def counted(url, mode="rb", _real=real, _key=key):
            count[_key] += 1
            return _real(url, mode)

        monkeypatch.setattr(mod, "open_url", counted)
    return count


def _assert_equal(got, want):
    assert len(got) == len(want) == 4  # 15 samples in batches of 4, the last padded
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"images", "labels", "valid"}
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


def test_cache_names_agree_across_packages(tmp_path):
    fields = {"shards": ["a.tar", "b.tar"], "image_size": 16, "test_crop_ratio": 0.875,
              "process_index": 0, "process_count": 1}
    port, jax_ = ValidSampleCache(tmp_path, fields, 16), JaxCache(str(tmp_path), fields, 16)
    assert (port.data_path, port.meta_path) == (jax_.data_path, jax_.meta_path)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_cache_written_by_either_package_is_read_by_the_other(val_dir, tmp_path, opens, writer):
    (tcfg, jcfg), (tplain, _) = _cfgs(val_dir, tmp_path), _cfgs(val_dir)
    ref = list(tloader.valid_loader(tplain, 4))
    assert opens["port"] == 3
    first = list((jloader if writer == "jax" else tloader).valid_loader(jcfg if writer == "jax" else tcfg, 4))
    _assert_equal(first, ref)
    assert opens[writer] == 3 + (writer == "port") * 3
    assert len(list(tmp_path.glob("val-*.json"))) == len(list(tmp_path.glob("val-*.bin"))) == 1
    reader = "port" if writer == "jax" else "jax"
    before = dict(opens)
    got = list((tloader if reader == "port" else jloader).valid_loader(tcfg if reader == "port" else jcfg, 4))
    _assert_equal(got, ref)
    assert opens == before  # the cache hit opened no shard


def test_second_pass_opens_no_shard(val_dir, tmp_path, opens):
    tcfg, _ = _cfgs(val_dir, tmp_path)
    first = list(tloader.valid_loader(tcfg, 4))
    assert opens["port"] == 3
    second = list(tloader.valid_loader(tcfg, 4))
    assert opens["port"] == 3
    _assert_equal(second, first)


def test_a_pass_stopped_midway_commits_nothing(val_dir, tmp_path, opens):
    tcfg, _ = _cfgs(val_dir, tmp_path)
    it = tloader.valid_loader(tcfg, 4)
    next(it)
    it.close()  # the consumer stops: the capture unwinds as a crash would
    assert not list(tmp_path.glob("val-*.json")) and not list(tmp_path.glob("val-*.bin"))
    assert not list(tmp_path.glob("*.tmp"))
    full = list(tloader.valid_loader(tcfg, 4))  # reads the shards again, then commits
    assert opens["port"] == 1 + 3
    assert len(list(tmp_path.glob("val-*.json"))) == 1
    _assert_equal(list(tloader.valid_loader(tcfg, 4)), full)
    assert opens["port"] == 4
