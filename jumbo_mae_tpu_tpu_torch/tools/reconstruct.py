"""Render MAE reconstructions as a side-by-side image grid.

Counterpart of the repo-root ``tools/reconstruct.py``: one row per image,
four panels (original | masked input | reconstruction | reconstruction
with the visible patches pasted back), the masked patches at ImageNet-mean
gray. The predictions come from the inference engine's ``reconstruct``
task (on the card unless ``--device cpu``), the mask from the engine's
noise of ``--seed``; with ``norm_pix_loss`` the per-patch normalization is
inverted with the target patch statistics (the model predicts in
normalized-patch space).

    python -m jumbo_mae_tpu_tpu_torch.tools.reconstruct recipes/pretrain_vit_h14_in1k_fsdp.yaml \\
        --ckpt runs/x/ckpt --out recon.png --n 8 \\
        [--images a.png b.jpg | --set data.valid_shards=... | --set run.synthetic_data=true] [--seed 0]

``--ckpt`` is a port save or a flax ``.msgpack`` params file (random init
without one). The PNG is written by :func:`write_png` (zlib and CRC
chunks, no image package); image files are decoded with cv2 or PIL.
"""

from __future__ import annotations

import argparse
import os
import struct
import zlib
from pathlib import Path

import numpy as np
import torch

from jumbo_mae_tpu_tpu_torch.ops.patches import extract_patches, merge_patches
from jumbo_mae_tpu_tpu_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD, normalize_images

PAD = 2  # white pixels between the panels and between the rows


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("recipe", nargs="?", default=None, help="YAML recipe path")
    p.add_argument("--ckpt", default="", help="a port save or a .msgpack params file; random init if omitted")
    p.add_argument("--out", required=True, help="output .png path")
    p.add_argument("--n", type=int, default=None, help="images in the grid (default: 8, or all --images files)")
    p.add_argument("--seed", type=int, default=0, help="masking seed")
    p.add_argument("--images", nargs="+", default=[], metavar="FILE",
                   help="image files to reconstruct instead of the recipe's validation stream, through the eval "
                        "transform (shorter side to size/crop_ratio, center crop)")
    p.add_argument("--set", dest="overrides", metavar="KEY.PATH=VALUE", nargs="*", action="extend", default=[],
                   help="dotted recipe overrides, the grammar of cli.train")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def write_png(path: str | Path, rgb: np.ndarray) -> Path:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG: one IDAT chunk
    of zlib-compressed rows, each with filter type 0, every chunk with its
    CRC-32. Written to a temporary name and renamed into place."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + ".tmp")
    tmp.write_bytes(png)
    os.replace(tmp, out)
    return out


def _to_uint8(patches: np.ndarray, patch: int) -> np.ndarray:
    """(B, N, p·p·3) normalized patches → (B, H, W, 3) uint8 images."""
    img = merge_patches(torch.from_numpy(np.ascontiguousarray(patches, np.float32)), patch).numpy()
    img = (img * np.float32(IMAGENET_STD) + np.float32(IMAGENET_MEAN)) * 255.0  # float32 throughout
    return np.clip(img, 0, 255).astype(np.uint8)


def figure(images: np.ndarray, reconstruction: np.ndarray, mask: np.ndarray, patch: int,
           norm_pix_loss: bool) -> np.ndarray:
    """The (n·(H+2)−2, 4·(W+2)−2, 3) uint8 grid of ``images`` (n, H, W, 3)
    and the engine's ``reconstruction`` (n, N, p·p·3) and ``mask`` (n, N,
    1 = masked): original, masked, reconstruction, pasted."""
    pred = np.asarray(reconstruction, np.float32)
    mask = np.asarray(mask, np.float32)[..., None]
    norm = normalize_images(torch.from_numpy(np.ascontiguousarray(images)), dtype=torch.float32)
    target = extract_patches(norm, patch).numpy()
    if norm_pix_loss:
        mean = target.mean(axis=-1, keepdims=True)
        var = target.var(axis=-1, keepdims=True)
        pred = pred * np.sqrt(var + 1e-6) + mean
    panels = [
        images,
        _to_uint8(target * (1.0 - mask), patch),  # zeroed normalized patches render as mean gray
        _to_uint8(pred, patch),
        _to_uint8(target * (1.0 - mask) + pred * mask, patch),
    ]
    n, h, w = images.shape[:3]
    grid = np.full((n * (h + PAD) - PAD, len(panels) * (w + PAD) - PAD, 3), 255, np.uint8)
    for row in range(n):
        for col, panel in enumerate(panels):
            y, x = row * (h + PAD), col * (w + PAD)
            grid[y:y + h, x:x + w] = panel[row]
    return grid


def _load_images(cfg, args) -> np.ndarray:
    """The images to render, uint8 (n, S, S, 3): ``--images`` files through
    the eval transform, else the first ``--n`` of the validation stream."""
    size = cfg.data.image_size
    if args.images:
        from jumbo_mae_tpu_tpu_torch.data.decode import decode_image
        from jumbo_mae_tpu_tpu_torch.data.transforms import eval_transform

        n = max(1, args.n) if args.n is not None else len(args.images)
        if len(args.images) > n:
            print(f"[reconstruct] rendering the first {n} of {len(args.images)} files (--n)")
        out = []
        for f in args.images[:n]:
            img = decode_image(Path(f).read_bytes())
            if img is None:
                raise SystemExit(f"[reconstruct] cannot decode {f}")
            out.append(eval_transform(img, size, crop_ratio=cfg.data.test_crop_ratio))
        return np.stack(out)
    from jumbo_mae_tpu_tpu_torch.cli.train import make_valid_iterator

    n = args.n if args.n is not None else 8
    factory = make_valid_iterator(cfg, max(1, n), device="cpu", keys=("images",))
    if factory is None:
        raise SystemExit("no data: pass --images, set data.valid_shards, or run.synthetic_data=true")
    images = np.asarray(next(iter(factory()))["images"])[:n]
    if images.shape[0] == 0:
        raise SystemExit("empty validation stream")
    return images


def main(argv: list[str] | None = None) -> Path:
    args = build_parser().parse_args(argv)
    from jumbo_mae_tpu_tpu_torch.config import load_config
    from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine

    cfg = load_config(args.recipe, args.overrides)
    if cfg.run.mode != "pretrain":
        raise SystemExit("reconstruction needs a pretrain recipe (run.mode=pretrain)")
    engine = InferenceEngine(cfg, ckpt=args.ckpt, device=args.device)
    images = _load_images(cfg, args)
    out = engine.reconstruct(images, seed=args.seed)
    grid = figure(images, out["reconstruction"], out["mask"], engine.model("reconstruct").encoder_cfg.patch_size,
                  cfg.model.norm_pix_loss)
    path = write_png(args.out, grid)
    print(f"[reconstruct] wrote {images.shape[0]}x4 grid (original | masked | reconstruction | paste) -> {path}")
    return path


if __name__ == "__main__":
    main()
