#!/usr/bin/env python3
"""chip_smoke's phase 23 alone — tenant cost metering, the autoscaler on
the H100 roofline and the gated train→serve weights publisher — on one
NVIDIA GPU.

    python3 scripts/torch_billing.py [--out FILE.json]

It runs ``chip_smoke.phase_billing`` with its gates on saves of random
weights written here (the ViT-B/16 classifier of
``recipes/finetune_vit_b16.yaml`` and the ViT-B/16 MAE model of
``recipes/pretrain_vit_b16_in1k_1600ep.yaml``, by the port's
``Checkpointer``), on toy shards at 224 px (1,024 train and 256 valid
images) and on 70 PNGs of the valid shard, where chip_smoke.py runs it on
the saves, shards and files of its phases 13, 15, 16 and 19. The drift
line's measured step is phase 7's, run here first
(``chip_smoke.phase_train``). Prints one JSON object as its last line and
writes it to ``--out``.
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


def write_saves(tmp: Path) -> None:
    """Saves of random weights where chip_smoke's phases 16 and 15 leave
    theirs."""
    import chip_smoke as cs

    from jumbo_mae_tpu_tpu_torch.cli.train import build_model
    from jumbo_mae_tpu_tpu_torch.config import load_config
    from jumbo_mae_tpu_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer
    from jumbo_mae_tpu_tpu_torch.train.optim import OptimConfig
    from jumbo_mae_tpu_tpu_torch.train.steps import create_state

    for recipe, d in ((cs.FT_RECIPE, "ft/finetune_vit_b16/ckpt"),
                      (cs.MAE_B16_RECIPE, "b16/pretrain_vit_b16_in1k_1600ep/ckpt")):
        model, _, _ = build_model(load_config(HERE / recipe), device="cuda")
        state = create_state(model, OptimConfig(name="adamw"), device="cuda", global_batch_size=8)
        ck = Checkpointer(CheckpointConfig(str(tmp / d), async_save=False))
        ck.save(1, state, metrics={"val/loss": 1.0})
        ck.close()


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
    train = cs.phase_train(fa, smi)
    res: dict = {"device": smi, "phase7_step_ms": train["step_ms"]}
    with tempfile.TemporaryDirectory(prefix="billing_") as d:
        tmp = Path(d)
        urls = write_toy_shards(tmp / "shards", image_size=224, n_train=1024, n_val=256, shard_size=256)
        write_saves(tmp)
        cs._serve_files(urls, tmp / "serve" / "images")
        cs.log(f"saves, shards and files in {time.perf_counter() - t0:.1f} s")
        res["billing"] = cs.phase_billing(fa, smi, tmp, urls, train["step_ms"])
    line = json.dumps(res, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return res


if __name__ == "__main__":
    main()
