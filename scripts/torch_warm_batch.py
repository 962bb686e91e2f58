#!/usr/bin/env python3
"""chip_smoke's warm restarts and batch jobs (phases 21-22) alone, and the
warm cache's entry against a ``torch.save`` payload, on one NVIDIA GPU.

    python3 scripts/torch_warm_batch.py [--phases warm,batch,formats] [--out FILE.json]

``warm`` and ``batch`` run ``chip_smoke.phase_warm_restart`` and
``phase_batch_job`` with their gates, on saves of random weights written
here (the ViT-B/16 classifier of ``recipes/finetune_vit_b16.yaml`` and the
ViT-L/16 MAE model of ``recipes/pretrain_vit_l16_in1k_800ep.yaml``, by the
port's ``Checkpointer``) and on toy shards at 224 px (1,024 train images),
where chip_smoke.py runs them on the saves and shards of its phases 13 and
16. ``formats`` times, for the ViT-B/16 features model's state dict, the
cache's put and its verified, memory-mapped load with the copy to the card,
against ``torch.save`` to a file with its sha256 and a read, sha256 and
``torch.load`` back (the first design of the entry), and the model's
construction with ``init_weights=False`` on the host (then moved) against
on the device; then whole task builds of that model through the engine
(``InferenceEngine._build_task``): from the save in bf16 (no entry), from
the save in int8 and without a save (the random init drawn), each cold
(cache off) against a hit of its entry; medians of 3. Prints one JSON
object as its last line and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))


B16_SAVE = "ft/finetune_vit_b16/ckpt"


def write_saves(tmp: Path, l16: bool = True) -> None:
    """Saves of random weights where chip_smoke's phases 16 and 13 leave
    theirs (the ViT-L/16 one where ``l16``)."""
    import chip_smoke as cs

    from jumbo_mae_tpu_tpu_torch.cli.train import build_model
    from jumbo_mae_tpu_tpu_torch.config import load_config
    from jumbo_mae_tpu_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer
    from jumbo_mae_tpu_tpu_torch.train.optim import OptimConfig
    from jumbo_mae_tpu_tpu_torch.train.steps import create_state

    for recipe, d in ((cs.FT_RECIPE, B16_SAVE), (cs.RECIPE, "a/pretrain_vit_l16_in1k_800ep/ckpt"))[: 2 if l16 else 1]:
        model, _, _ = build_model(load_config(HERE / recipe), device="cuda")
        state = create_state(model, OptimConfig(name="adamw"), device="cuda", global_batch_size=8)
        ck = Checkpointer(CheckpointConfig(str(tmp / d), async_save=False))
        ck.save(1, state, metrics={"val/loss": 1.0})
        ck.close()


def median_s(fn, reps: int = 3) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def formats(tmp: Path) -> dict:
    import torch

    import chip_smoke as cs
    from jumbo_mae_tpu_tpu_torch.config import load_config
    from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine
    from jumbo_mae_tpu_tpu_torch.infer.warmcache import WarmCache
    from jumbo_mae_tpu_tpu_torch.models import JumboViT
    from jumbo_mae_tpu_tpu_torch.obs.metrics import MetricsRegistry

    eng = InferenceEngine(load_config(HERE / cs.FT_RECIPE), warm_cache=False)
    model = eng.model("features")
    state = model.state_dict()  # the live tensors: the loads below copy into them
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    cache = WarmCache(tmp / "formats", registry=MetricsRegistry())

    def entry_load():
        got = cache.get("b16.exe")
        for n, t in state.items():
            t.copy_(got[n])
        torch.cuda.synchronize()

    path = tmp / "formats" / "b16.pt"

    def torch_put():
        buf = io.BytesIO()
        torch.save({n: t.detach().cpu() for n, t in state.items()}, buf)
        payload = buf.getbuffer()
        digest = hashlib.sha256(payload).digest()
        with open(path, "wb") as f:
            f.write(digest)
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())

    def torch_load():
        with open(path, "rb") as f:
            digest, payload = f.read(32), f.read()
        if hashlib.sha256(payload).digest() != digest:
            raise ValueError("the torch.save payload's digest does not match")
        got = torch.load(io.BytesIO(payload), map_location="cpu", weights_only=True)
        for n, t in state.items():
            t.copy_(got[n])
        torch.cuda.synchronize()

    enc = eng._enc

    def on_host():
        JumboViT(enc, init_weights=False, device="cuda")
        torch.cuda.synchronize()

    def on_device():
        with torch.device("cuda"):
            JumboViT(enc, init_weights=False, device="cuda")
        torch.cuda.synchronize()

    if not (tmp / B16_SAVE).exists():
        write_saves(tmp, l16=False)

    def builds(label: str, **kw) -> dict:
        """Median seconds of a cold build (cache off) and of a hit of the
        entry the first cached build wrote, with the parts of the last."""
        cold = InferenceEngine(cfg, warm_cache=False, **kw)
        cold_s = median_s(lambda: cold._build_task("features"))
        warm = InferenceEngine(cfg, warm_cache=tmp / "builds", registry=MetricsRegistry(), **kw)
        warm._build_task("features")
        put = warm.build_split["features"]
        hit_s = median_s(lambda: warm._build_task("features"))
        got = {f"{label}_cold_s": cold_s, f"{label}_cold_split": cold.build_split["features"],
               f"{label}_restore_s": cold.restore_s, f"{label}_put_s": put.get("put_s")}
        if warm.warm_hits:
            got.update({f"{label}_hit_s": hit_s, f"{label}_hit_split": warm.build_split["features"]})
        return got

    cfg = load_config(HERE / cs.FT_RECIPE)
    ckpt = str(tmp / B16_SAVE)
    out = {
        **builds("save_bf16", ckpt=ckpt),
        **builds("save_int8", ckpt=ckpt, quant="int8"),
        **builds("drawn_bf16"),
        "state_bytes": nbytes,
        "entry_put_s": median_s(lambda: cache.put("b16.exe", state)),
        "entry_load_s": median_s(entry_load),
        "torch_save_put_s": median_s(torch_put),
        "torch_load_s": median_s(torch_load),
        "construct_host_s": median_s(on_host),
        "construct_device_s": median_s(on_device),
    }
    cs.log(f"formats: {json.dumps(out)}")
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--phases", default="warm,batch,formats")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    phases = set(args.phases.split(","))
    os.environ["JUMBO_WARMCACHE"] = "0"
    import chip_smoke as cs
    from jumbo_mae_tpu_tpu_torch.data.toy import write_toy_shards
    from jumbo_mae_tpu_tpu_torch.ops import _build

    t0 = time.perf_counter()
    smi = cs.nvidia_smi_line()
    cs.log(smi)
    cs.build_kernels(_build)
    res: dict = {"device": smi}
    with tempfile.TemporaryDirectory(prefix="warm_batch_") as d:
        tmp = Path(d)
        if phases & {"warm", "batch"}:
            urls = write_toy_shards(tmp / "shards", image_size=224, n_train=1024, n_val=256, shard_size=256)
            write_saves(tmp)
            cs.log(f"saves and shards in {time.perf_counter() - t0:.1f} s")
        if "warm" in phases:
            res["warm"] = cs.phase_warm_restart(smi, tmp)
        if "batch" in phases:
            res["batch"] = cs.phase_batch_job(smi, tmp, urls)
        if "formats" in phases:
            res["formats"] = formats(tmp)
    line = json.dumps(res, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return res


if __name__ == "__main__":
    main()
