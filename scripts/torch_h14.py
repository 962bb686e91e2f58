#!/usr/bin/env python3
"""chip_smoke.py's phase 25 alone: ViT-H/14 MAE pretraining from
recipes/pretrain_vit_h14_in1k_fsdp.yaml on one NVIDIA GPU.

    python3 scripts/torch_h14.py [--out h14.json]

Builds the kernels, writes the toy shards of phase 13 (1,024 train and
256 validation PNGs at 224 px) into a temporary directory, runs
``chip_smoke.phase_h14`` on them (kernel checks and timings at the slice's
shapes, blockwise attention, the native streams, the "dots" and "none"
steps, the recipe through ``cli/train.py``, the second eval on the
cache and the reconstruction figure) and writes its result as JSON to
``--out``. Exits non-zero on any failed gate, and without a GPU.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="", help="write the phase's result here as JSON")
    args = p.parse_args(argv)

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("[torch_h14] FAIL: torch.cuda.is_available() is false; this needs an NVIDIA GPU")
    from jumbo_mae_tpu_tpu_torch.data.toy import write_toy_shards
    from jumbo_mae_tpu_tpu_torch.ops import _build
    from jumbo_mae_tpu_tpu_torch.ops.flash import attention as fa

    smi = cs.nvidia_smi_line()
    cs.log(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    cs.build_kernels(_build)
    tmp = Path(tempfile.mkdtemp(prefix="torch_h14_"))
    try:
        t0 = time.perf_counter()
        urls = write_toy_shards(tmp / "shards", image_size=224, n_train=1024, n_val=256, shard_size=256)
        cs.log(f"toy shards written in {time.perf_counter() - t0:.1f} s")
        res = cs.phase_h14(fa, smi, tmp, urls)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res = {"device": smi, **cs.h14_summary(res),
           "kernels": {k: cs.h14_kernel_fields(res, k) for k in ("K1", "K2", "K3")}}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1, default=str))
    print(json.dumps(res, default=str))
    return res


if __name__ == "__main__":
    main()
