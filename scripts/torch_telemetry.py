#!/usr/bin/env python3
"""chip_smoke's phase 24 alone — the serving tier's telemetry and health —
on one NVIDIA GPU.

    python3 scripts/torch_telemetry.py [--out FILE.json]

It runs ``chip_smoke.phase_telemetry`` with its gates on a save of random
weights written here (the ViT-B/16 classifier of
``recipes/finetune_vit_b16.yaml``, by the port's ``Checkpointer``), on 70
PNGs of a toy valid shard at 224 px and on their logits through
``cli.predict``'s direct path (phase 19's first step), where
chip_smoke.py runs it on the save and files of its phases 16 and 19.
Prints one JSON object as its last line and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))


def write_save(tmp: Path) -> Path:
    """A save of random weights where chip_smoke's phase 16 leaves its."""
    import chip_smoke as cs

    from jumbo_mae_tpu_tpu_torch.cli.train import build_model
    from jumbo_mae_tpu_tpu_torch.config import load_config
    from jumbo_mae_tpu_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer
    from jumbo_mae_tpu_tpu_torch.train.optim import OptimConfig
    from jumbo_mae_tpu_tpu_torch.train.steps import create_state

    d = tmp / "ft" / "finetune_vit_b16" / "ckpt"
    model, _, _ = build_model(load_config(HERE / cs.FT_RECIPE), device="cuda")
    state = create_state(model, OptimConfig(name="adamw"), device="cuda", global_batch_size=8)
    ck = Checkpointer(CheckpointConfig(str(d), async_save=False))
    ck.save(1, state, metrics={"val/loss": 1.0})
    ck.close()
    return d


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    os.environ["JUMBO_WARMCACHE"] = "0"
    import chip_smoke as cs
    from jumbo_mae_tpu_tpu_torch.data.toy import write_toy_shards
    from jumbo_mae_tpu_tpu_torch.ops import _build
    from jumbo_mae_tpu_tpu_torch.ops.flash import attention as fa

    t0 = time.perf_counter()
    smi = cs.nvidia_smi_line()
    cs.log(smi)
    cs.build_kernels(_build)
    res: dict = {"device": smi}
    with tempfile.TemporaryDirectory(prefix="telemetry_") as d:
        tmp = Path(d)
        urls = write_toy_shards(tmp / "shards", image_size=224, n_train=256, n_val=256, shard_size=256)
        ft = write_save(tmp)
        files = cs._serve_files(urls, tmp / "serve" / "images")
        # phase 19's direct path: the logits the pool's engines must equal
        cs.cli_predict(fa, ["--config", str(HERE / cs.FT_RECIPE), "--ckpt", str(ft), "--images", *files,
                            "--max-batch", "64", "--task", "logits", "--out", str(tmp / "serve" / "b16_logits.npz")])
        cs.log(f"save, files and direct logits in {time.perf_counter() - t0:.1f} s")
        res["telemetry"] = cs.phase_telemetry(fa, smi, tmp)
    line = json.dumps(res, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return res


if __name__ == "__main__":
    main()
