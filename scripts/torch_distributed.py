#!/usr/bin/env python3
"""chip_smoke.py's phase 29 alone: a save's host copy under the leak
sentinel, and ``cli/train.py --distributed`` with two ranks on one NVIDIA
GPU.

    python3 scripts/torch_distributed.py [--out dist.json]

Builds the kernels, writes the toy shards of phase 13 (1,024 train and
256 validation PNGs at 224 px) into a temporary directory and runs
``chip_smoke.phase_distributed`` on them: (a) phase 13's ViT-L/16 MAE run
in a fresh process with saves at steps 2, 4 and 6 and the leak sentinel at
its defaults (no leak suspect; the resident set after each save); (b) two
ranks sharing the card over gloo, ``mesh.data=2``, 4 steps, saves at 2
and 4 and the final eval (launches, losses, parameter digests, the
gathered cursor, both journals, the gradient all-reduce's share of a
step); (c) one process evaluating (b)'s save. Writes the result as JSON
to ``--out``. Exits non-zero on any failed gate, and without a GPU.
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
        raise SystemExit("[torch_distributed] FAIL: torch.cuda.is_available() is false; this needs an NVIDIA GPU")
    from jumbo_mae_tpu_tpu_torch.data.toy import write_toy_shards
    from jumbo_mae_tpu_tpu_torch.ops import _build

    smi = cs.nvidia_smi_line()
    cs.log(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    cs.build_kernels(_build)
    tmp = Path(tempfile.mkdtemp(prefix="torch_distributed_"))
    try:
        t0 = time.perf_counter()
        urls = write_toy_shards(tmp / "shards", image_size=224, n_train=1024, n_val=256, shard_size=256)
        cs.log(f"toy shards written in {time.perf_counter() - t0:.1f} s")
        res = {"device": smi, **cs.phase_distributed(smi, tmp, {"urls": urls})}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1, default=str))
    print(json.dumps(res, default=str))
    return res


if __name__ == "__main__":
    main()
