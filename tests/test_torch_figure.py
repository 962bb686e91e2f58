"""The port's reconstruction figure against the repo-root tool, on the CPU.

``jumbo_mae_tpu_tpu_torch/tools/reconstruct.py`` and the repo-root
``tools/reconstruct.py`` (JAX, PIL) render the same figure from the same
save (a flax ``.msgpack`` the JAX package exported, random weights at
O(1) drawn from a seeded numpy generator, the smoke recipe in float32)
and the same mask noise (pinned on both sides), for image files written
here. Both PNGs are decoded by this file's own reader (zlib and the five
PNG row filters), not by an image package. The original panels are equal
bit for bit; the other panels within 1 of 255 per channel (the
reconstructions agree to 1e-4 in float32, so a value on a rounding edge
may move by one), and at least 99 % of their pixels equal. The figure from
a port save of the same tree is the same file, byte for byte.
"""

import importlib.util
import io
import struct
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.config import load_config as jax_load_config
from jumbo_mae_tpu_tpu.infer import InferenceEngine as JaxEngine
from jumbo_mae_tpu_tpu.models import vit as jax_vit
from jumbo_mae_tpu_tpu.train.checkpoint import export_params_msgpack
from jumbo_mae_tpu_tpu_torch.config import load_config
from jumbo_mae_tpu_tpu_torch.infer import engine as engine_mod
from jumbo_mae_tpu_tpu_torch.tools import reconstruct as trecon
from torch_port_util import port_save, random_images, random_jumbo_params

REPO = Path(__file__).resolve().parent.parent
RECIPE = REPO / "recipes" / "smoke_cpu.yaml"
SETS = ["model.overrides.dtype=float32", "model.dec_layers=1", "model.dec_dim=32", "model.dec_heads=2",
        "model.dec_dtype=float32"]
N_PATCHES, SIZE = 64, 32


def read_png(path) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit RGB, non-interlaced PNG."""
    data = Path(path).read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF, tag
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color, _, _, interlace = header
    assert (depth, color, interlace) == (8, 2, 0)
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    out = np.zeros((h, 3 * w), np.int64)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int64)
        prev = out[y - 1] if y else np.zeros(3 * w, np.int64)
        row = np.zeros(3 * w, np.int64)
        for x in range(3 * w):
            a = row[x - 3] if x >= 3 else 0
            b = prev[x]
            c = prev[x - 3] if x >= 3 else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            row[x] = (line[x] + pred) & 0xFF
        out[y] = row
    return out.reshape(h, w, 3).astype(np.uint8)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """An MAE flax tree as a .msgpack and a port save, and 3 PNG files."""
    from PIL import Image

    root = tmp_path_factory.mktemp("figure")
    jeng = JaxEngine(jax_load_config(RECIPE, SETS), max_batch=8, warm_cache=False, labels=10)
    init = jax.tree_util.tree_map(np.asarray, jeng._task("reconstruct")["variables"]["params"])
    rng = np.random.default_rng(31)
    params = random_jumbo_params(init, rng)
    export_params_msgpack(params, str(root / "mae.msgpack"))
    port_save(root / "save", load_config(RECIPE, SETS), params)
    files = []
    for i, img in enumerate(random_images(rng, 3, 40)):
        files.append(str(root / f"img{i}.png"))
        Image.fromarray(img).save(files[-1])
    noise = rng.random(N_PATCHES).astype(np.float32)
    return dict(root=root, msgpack=str(root / "mae.msgpack"), save=str(root / "save"), files=files, noise=noise)


def _root_tool():
    spec = importlib.util.spec_from_file_location("root_reconstruct", REPO / "tools" / "reconstruct.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pin_noise(monkeypatch, noise):
    """The same shared mask noise for both: the JAX model's random_masking
    and the port engine's reconstruct_noise."""
    real = jax_vit.random_masking

    def pinned(x, rng, keep_len, **kw):
        return real(x, None, keep_len, **{**kw, "noise": jax.numpy.asarray(noise)})

    monkeypatch.setattr(jax_vit, "random_masking", pinned)
    monkeypatch.setattr(engine_mod, "reconstruct_noise", lambda seed, n: torch.from_numpy(noise.copy()))


def test_figure_pixels_match_the_root_tool(setup, tmp_path, monkeypatch):
    pin_noise(monkeypatch, setup["noise"])
    ref = _root_tool().main([str(RECIPE), "--ckpt", setup["msgpack"], "--out", str(tmp_path / "jax.png"),
                             "--images", *setup["files"], "--set", *SETS])
    got = trecon.main([str(RECIPE), "--ckpt", setup["msgpack"], "--out", str(tmp_path / "port.png"),
                       "--images", *setup["files"], "--device", "cpu", "--set", *SETS])
    want, have = read_png(ref), read_png(got)
    assert have.shape == want.shape == (3 * (SIZE + 2) - 2, 4 * (SIZE + 2) - 2, 3)
    w = SIZE + 2
    np.testing.assert_array_equal(have[:, :SIZE], want[:, :SIZE])  # the originals
    diff = np.abs(have.astype(int) - want.astype(int))
    assert diff.max() <= 1, diff.max()
    assert (diff[:, w:] == 0).mean() >= 0.99
    # the masked panel shows gray where the mask is, the pasted one the original elsewhere
    assert not np.array_equal(have[:, w:w + SIZE], have[:, :SIZE])
    # a port save of the same tree draws the same file
    again = trecon.main([str(RECIPE), "--ckpt", setup["save"], "--out", str(tmp_path / "save.png"),
                         "--images", *setup["files"], "--device", "cpu", "--set", *SETS])
    assert Path(again).read_bytes() == Path(got).read_bytes()


def test_the_originals_are_the_input_images(setup, tmp_path):
    """With the validation stream (synthetic), row i's first panel is
    input i bit for bit, and --n picks the rows."""
    from jumbo_mae_tpu_tpu_torch.cli.train import make_valid_iterator

    sets = SETS + ["run.synthetic_data=true"]
    out = trecon.main([str(RECIPE), "--ckpt", setup["save"], "--out", str(tmp_path / "s.png"), "--n", "2",
                       "--device", "cpu", "--set", *sets])
    grid = read_png(out)
    images = next(iter(make_valid_iterator(load_config(RECIPE, sets), 2, device="cpu", keys=("images",))()))["images"]
    assert grid.shape == (2 * (SIZE + 2) - 2, 4 * (SIZE + 2) - 2, 3)
    for i in range(2):
        np.testing.assert_array_equal(grid[i * (SIZE + 2):i * (SIZE + 2) + SIZE, :SIZE], images[i])


def test_write_png_is_read_back_by_pil_and_this_reader(tmp_path):
    from PIL import Image

    img = np.random.default_rng(0).integers(0, 256, (7, 13, 3), dtype=np.uint8)
    path = trecon.write_png(tmp_path / "a" / "x.png", img)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), img)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")  # PIL's filtered rows through this reader
    (tmp_path / "pil.png").write_bytes(buf.getvalue())
    np.testing.assert_array_equal(read_png(tmp_path / "pil.png"), img)
    with pytest.raises(ValueError):
        trecon.write_png(tmp_path / "bad.png", img[..., 0])
