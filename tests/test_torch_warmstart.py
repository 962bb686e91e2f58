"""Warm starts and the eval restore (``train/checkpoint.py``) against the
JAX package, on the CPU.

- ``resize_posemb`` against ``jax.image.resize(method="bilinear")``, up
  and down (JAX antialiases when it shrinks), (H, W, D) and
  (1, H, W, D): atol 1e-6 (float32 weights; the two contractions sum in
  another order);
- ``merge_pretrained_params``: its loaded, resized, skipped and unused
  lists name, through ``flax_path``, exactly the paths of JAX's, on an
  encoder whose grid and head differ; the merged values are JAX's;
- ``load_pretrained_params`` from a port MAE save (``Checkpointer``):
  every trunk parameter loaded from the encoder, the decoder dropped,
  the head and the BatchNorm statistics fresh; ``require_loaded``;
- ``restore_eval``: parameters, BatchNorm statistics, step and seed, and
  never the optimizer state.
"""

import jax
import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.train import checkpoint as jckpt
from jumbo_mae_tpu_tpu_torch.interop import flax_path
from jumbo_mae_tpu_tpu_torch.models import DecoderConfig, preset
from jumbo_mae_tpu_tpu_torch.models.classifier import ClassificationModel
from jumbo_mae_tpu_tpu_torch.models.mae import MAEPretrainModel
from jumbo_mae_tpu_tpu_torch.train import checkpoint as tckpt
from jumbo_mae_tpu_tpu_torch.train.optim import Identity, OptimConfig
from jumbo_mae_tpu_tpu_torch.train.steps import create_state
from test_torch_optim_classify import classifier_pair


@pytest.mark.parametrize("src,dst", [
    ((14, 14, 8), (16, 16, 8)),       # up (224 → 256 px at /16)
    ((16, 16, 8), (14, 14, 8)),       # down: antialiased
    ((8, 8, 4), (3, 5, 4)),           # down 2.7x and 1.6x
    ((1, 7, 5, 4), (1, 14, 3, 4)),    # (1, H, W, D), one axis each way
    ((4, 4, 2), (4, 9, 2)),           # one axis only
    ((6, 6, 3), (6, 6, 3)),           # the same grid comes back as it is
])
def test_resize_posemb_matches_jax(src, dst):
    x = np.random.default_rng(0).standard_normal(src).astype(np.float32)
    got = tckpt.resize_posemb(x, dst)
    np.testing.assert_allclose(got, jckpt.resize_posemb(x, dst), atol=1e-6, rtol=0)
    assert got.dtype == np.float32 and got.shape == dst


def test_resize_posemb_rejects_other_shapes():
    with pytest.raises(ValueError, match="posemb"):
        tckpt.resize_posemb(np.zeros((4, 4)), (2, 2))


def _paths(names):
    return sorted(flax_path(n) for n in names)


def test_merge_lists_and_values_match_jax():
    """A 24 px, 6-label source into a 32 px, 10-label classifier with a
    learnable grid: the grid resized, the head skipped (shape), the rest
    loaded; a source-only entry unused."""
    src_params, src_model, _ = classifier_pair(seed=3, image_size=24, labels=6)
    dst_params, dst_model, _ = classifier_pair(seed=4)
    src_params["model"]["extra"] = {"kernel": np.ones((2, 2), np.float32)}
    stats = {}
    jmerged = jckpt.merge_pretrained_params(src_params["model"], dst_params["model"], verbose=False, stats=stats)
    src_sd = {k: v for k, v in src_model.state_dict().items() if k.startswith("model.")}
    src_sd["model.extra.weight"] = torch.ones(2, 2)  # flax path ("extra", "kernel")
    tstats = {}
    init = dict(dst_model.named_parameters())
    merged = tckpt.merge_pretrained_params({k[len("model."):]: v for k, v in src_sd.items()},
                                           {k[len("model."):]: v for k, v in init.items()}, verbose=False, stats=tstats)
    for key in ("loaded", "resized", "skipped", "unused"):
        assert _paths(tstats[key]) == sorted(tuple(p) for p in stats[key]), key
    assert [tuple(p) for p in stats["resized"]] == [("embed", "pos_embed")]
    assert {p[:2] for p in stats["skipped"]} == {("head", "fc")}
    from jumbo_mae_tpu_tpu_torch.interop import state_dict_from_jax

    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jmerged))
    for name, val in merged.items():
        np.testing.assert_allclose(val.detach().numpy(), want[name].numpy(), atol=1e-6, err_msg=name)


ENC = dict(image_size=32, patch_size=8, posemb="sincos2d", dtype="float32", layers=2)


def _mae_save(tmp_path):
    enc = preset("vit_t16", **dict(ENC, labels=None, mask_ratio=0.75))
    mae = MAEPretrainModel(enc, DecoderConfig(layers=1, dim=32, heads=2, dtype="float32"), device="cpu", seed=5)
    state = create_state(mae, OptimConfig(), device="cpu", global_batch_size=8)
    ck = tckpt.Checkpointer(tckpt.CheckpointConfig(str(tmp_path / "ckpt"), async_save=False))
    ck.save(7, state)
    return mae, tmp_path / "ckpt"


@pytest.mark.parametrize("linear", [False, True])
def test_warm_start_from_a_port_mae_save(tmp_path, capsys, linear):
    mae, path = _mae_save(tmp_path)
    clf = ClassificationModel(preset("vit_t16", **dict(ENC, labels=10, linear_probing=linear, batch_norm=linear)),
                              device="cpu", seed=9)
    init = {n: p.detach().clone() for n, p in clf.named_parameters()}
    stats = {}
    merged = tckpt.load_pretrained_params(path, dict(clf.named_parameters()), stats=stats)
    enc = {n: p for n, p in mae.encoder.named_parameters()}
    trunk = [n for n in init if not n.startswith("model.head.")]
    assert sorted(stats["loaded"]) == sorted(trunk) and not stats["resized"] and not stats["skipped"]
    assert stats["unused"] == []
    assert sorted(stats["new"]) == sorted(n for n in init if n.startswith("model.head."))
    assert stats["dropped"] and all(n.startswith(("decoder", "mask_token", "pixel_proj")) for n in stats["dropped"])
    for n in trunk:
        assert torch.equal(merged[n], enc[n[len("model."):]]), n
    for n in stats["new"]:
        assert torch.equal(merged[n], init[n]), n
    out = capsys.readouterr().out
    assert f"pretrained merge: {len(trunk)} loaded, 0 resized, 0 shape-mismatch (fresh), 0 unused" in out
    assert "dropped outside 'encoder'" in out and "kept fresh: head." in out
    tckpt.require_loaded(stats, path, "the classifier")
    with pytest.raises(SystemExit, match="loaded 0 params"):
        tckpt.require_loaded({"loaded": [], "resized": []}, path, "the classifier")


def test_restore_eval_reads_params_stats_step_and_seed_only(tmp_path):
    model = ClassificationModel(preset("vit_t16", **dict(ENC, labels=10, linear_probing=True, batch_norm=True)),
                                device="cpu", seed=1)
    state = create_state(model, OptimConfig(name="lars"), device="cpu", global_batch_size=8, rng_seed=4)
    with torch.no_grad():
        model.model.head.bn.running_var.fill_(2.5)
        model.model.head.fc.weight.mul_(3)
    state.step = 5
    ck = tckpt.Checkpointer(tckpt.CheckpointConfig(str(tmp_path), async_save=False, best_mode="max",
                                                   metric_key="val/acc1"))
    ck.save(5, state, metrics={"val/acc1": 0.5})
    fresh = ClassificationModel(preset("vit_t16", **dict(ENC, labels=10, linear_probing=True, batch_norm=True)),
                                device="cpu", seed=2)
    other = create_state(fresh, Identity(), device="cpu")
    assert other.opt_state.slots() == {}
    ck.restore_eval(other, which="best")
    for (n, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), n
    assert (other.step, other.seed) == (5, 4) and other.opt_state.slots() == {} and other.opt_state.count == 0
    empty = tckpt.Checkpointer(tckpt.CheckpointConfig(str(tmp_path / "empty"), async_save=False))
    with pytest.raises(FileNotFoundError):
        empty.restore_eval(other)
