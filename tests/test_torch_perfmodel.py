"""The port's performance and cost models (``obs/perfmodel.py``,
``obs/costmodel.py``) against the JAX package's, on the CPU:

- ``roofline``, the comm bytes, ``approx_param_count`` and
  ``predict_train_step`` equal JAX's for the same ``ChipSpec`` fields
  (rel 1e-12), on tiny configs and on the ViT-L/16 pretraining recipe's;
- the table has one accelerator row, the H100: its device name maps to
  it, any other card (a TPU kind included) raises, the generic CPU entry
  comes only when the caller names the CPU, and ``"cuda"`` without a
  card raises;
- ``lookup_cost`` and ``utilization_report`` equal JAX's;
- an engine's captured ``ProgramCost`` of ``(logits, b)`` is the JAX
  package's analytic count (``obs/mfu.py``: encoder × b plus the head),
  of ``(reconstruct, b)`` its encoder-and-decoder count, with the weights'
  bytes plus ``2·flops/dim`` as bytes and the ``xla_*`` gauges set;
- the train step's analytic ``flops`` (``train_step_cost``) lies within
  0.90-1.10× of XLA's count of the JAX step's lowered program on one
  device, at ``recipes/smoke_cpu.yaml``'s model and batch 16, with
  ``grad_ckpt`` off and under ``"none"`` and ``"dots"`` (XLA counts every
  elementwise op too; the port counts matmuls, as ``obs/mfu.py`` does);
  the port's own count orders ``"none"`` ≥ ``"dots"`` ≥ off, on the card
  too, where K1 reruns under ``"dots"``; a linear probe's trunk counts
  its forward only; the bytes model and the peak as stated.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.models.config import DecoderConfig as JaxDecoderConfig
from jumbo_mae_tpu_tpu.models.config import preset as jax_preset
from jumbo_mae_tpu_tpu.obs import costmodel as jcost
from jumbo_mae_tpu_tpu.obs import mfu as jmfu
from jumbo_mae_tpu_tpu.obs import perfmodel as jperf
from jumbo_mae_tpu_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from jumbo_mae_tpu_tpu_torch.config import load_config
from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine
from jumbo_mae_tpu_tpu_torch.models.config import DecoderConfig, preset
from jumbo_mae_tpu_tpu_torch.obs import costmodel as pcost
from jumbo_mae_tpu_tpu_torch.obs import perfmodel as pperf
from jumbo_mae_tpu_tpu_torch.obs.metrics import MetricsRegistry

REPO = Path(__file__).resolve().parent.parent
SMOKE = REPO / "recipes" / "smoke_cpu.yaml"
L16 = REPO / "recipes" / "pretrain_vit_l16_in1k_800ep.yaml"
REL = 1e-12


def chips():
    """The same fields as a port and a JAX ChipSpec: the H100 row, a
    hypothetical slow card and the generic CPU entry."""
    rows = [tuple(dataclasses.astuple(pperf.H100)), ("slow", 10.0, 100.0, 5.0, 2.0**34), pperf.GENERIC_CPU]
    return [(pperf.ChipSpec(*r), jperf.ChipSpec(*r)) for r in rows]


def close(a: float, b: float) -> bool:
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)


def same_prediction(p, j) -> None:
    pa, ja = dataclasses.asdict(p), dataclasses.asdict(j)
    assert pa.keys() == ja.keys()
    for k in pa:
        if isinstance(pa[k], str):
            assert pa[k] == ja[k], k
        else:
            assert close(pa[k], ja[k]), (k, pa[k], ja[k])


def config_pairs():
    """(port enc, port dec, JAX enc, JAX dec) with the same fields: tiny
    ones and the ViT-L/16 recipe's (its preset and decoder)."""
    out = []
    for name, kw, dec in (
        ("vit_t16", {"image_size": 32, "patch_size": 4}, {"layers": 1, "dim": 32, "heads": 2}),
        ("vit_s16", {"image_size": 64, "patch_size": 8, "num_cls_tokens": 2}, {"layers": 2, "dim": 64, "heads": 4}),
    ):
        out.append((preset(name, mask_ratio=0.75, **kw), DecoderConfig(**dec),
                    jax_preset(name, mask_ratio=0.75, **kw), JaxDecoderConfig(**dec)))
    cfg = load_config(L16)
    m = cfg.model
    dec = {"layers": m.dec_layers, "dim": m.dec_dim, "heads": m.dec_heads}
    kw = {"labels": None, "mask_ratio": 0.75, **m.overrides}
    out.append((preset(m.preset, **kw), DecoderConfig(**dec), jax_preset(m.preset, **kw), JaxDecoderConfig(**dec)))
    return out


@pytest.mark.parametrize("idx", range(3))
def test_roofline_and_comm_bytes_equal_jax(idx):
    pchip, jchip = chips()[idx]
    rng = np.random.default_rng(idx)
    for _ in range(50):
        flops, nbytes, comm = (float(x) for x in 10.0 ** rng.uniform(3, 15, 3))
        batch = int(rng.integers(1, 512)) if rng.random() < 0.7 else None
        peak = float(rng.uniform(0, 1e10))
        same_prediction(pperf.roofline(flops, nbytes, pchip, comm_bytes=comm, batch=batch, peak_hbm_bytes=peak),
                        jperf.roofline(flops, nbytes, jchip, comm_bytes=comm, batch=batch, peak_hbm_bytes=peak))
        n = int(rng.integers(1, 9))
        assert close(pperf.fsdp_comm_bytes(nbytes, fsdp=n), jperf.fsdp_comm_bytes(nbytes, fsdp=n))
        assert close(pperf.dp_comm_bytes(nbytes, dp=n), jperf.dp_comm_bytes(nbytes, dp=n))


@pytest.mark.parametrize("idx", range(3))
def test_param_count_and_train_step_prediction_equal_jax(idx):
    penc, pdec, jenc, jdec = config_pairs()[idx]
    assert close(pperf.approx_param_count(penc, pdec), jperf.approx_param_count(jenc, jdec))
    assert close(pperf.approx_param_count(penc), jperf.approx_param_count(jenc))
    for pchip, jchip in chips():
        for mode, dp, fsdp, batch in (("pretrain", 1, 1, 128), ("pretrain", 4, 1, 32), ("classify", 1, 8, 64)):
            kw = dict(per_device_batch=batch, mode=mode, dp=dp, fsdp=fsdp)
            if mode == "pretrain":
                got = pperf.predict_train_step(penc, pdec, chip=pchip, **kw)
                want = jperf.predict_train_step(jenc, jdec, chip=jchip, **kw)
            else:
                pe, je = penc.replace(mask_ratio=None, labels=1000), jenc.replace(mask_ratio=None, labels=1000)
                got = pperf.predict_train_step(pe, chip=pchip, **kw)
                want = jperf.predict_train_step(je, chip=jchip, **kw)
            same_prediction(got, want)


def test_vit_l16_step_on_the_h100_row():
    """The number phase 7 is read against: the ViT-L/16 MAE step at batch
    128 on the H100 row is compute-bound at about 17.6 ms."""
    penc, pdec, _, _ = config_pairs()[2]
    pred = pperf.predict_train_step(penc, pdec, per_device_batch=128, chip=pperf.H100)
    assert pred.bound == "compute" and 0.017 < pred.t_compute_s < 0.0182


def test_the_table_has_one_accelerator_row():
    for kind in ("NVIDIA H100 80GB HBM3", "NVIDIA H100 SXM5 80GB"):
        assert pperf.chip_spec(kind) == pperf.H100
    assert pperf.H100.peak_tflops == 989.0 and pperf.H100.hbm_gbps == 3350.0 and pperf.H100.ici_gbps == 450.0
    for kind in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "NVIDIA H100 NVL", "TPU v4", "TPU v5 lite", "", None):
        with pytest.raises(ValueError, match="no performance-model row"):
            pperf.chip_spec(kind)
    cpu = pperf.chip_spec("cpu")
    assert dataclasses.astuple(cpu) == pperf.GENERIC_CPU == jperf.GENERIC_CPU
    assert pperf.detect_chip("cpu") == cpu
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pperf.detect_chip("cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pperf.predict_train_step(config_pairs()[0][0], config_pairs()[0][1], per_device_batch=4)


def cost_tables():
    """The same cost table in both packages' ProgramCost."""
    rng = np.random.default_rng(7)
    keys = [("features/cls", 1), ("features/cls", 8), ("logits", 8), ("reconstruct", 4), ("features/mean", 16),
            ("logits", 16)]
    port, jax_ = {}, {}
    for task, b in keys:
        flops, nbytes, peak = (float(x) for x in rng.uniform(1e6, 1e12, 3))
        port[(task, b)] = pcost.ProgramCost(program=f"{task}/b{b}", flops=flops, bytes_accessed=nbytes,
                                            peak_bytes=peak)
        jax_[(task, b)] = jcost.ProgramCost(program=f"{task}/b{b}", flops=flops, bytes_accessed=nbytes,
                                            peak_bytes=peak)
    return port, jax_


def test_lookup_cost_equals_jax():
    port, jax_ = cost_tables()
    for task in ("features", "features/cls", "logits", "reconstruct", "other"):
        for b in (1, 4, 8, 16, 32):
            got, want = pcost.lookup_cost(port, task, b), jcost.lookup_cost(jax_, task, b)
            assert (got is None) == (want is None), (task, b)
            if got is not None:
                assert (got.program, got.flops, got.bytes_accessed) == (want.program, want.flops, want.bytes_accessed)
    assert pcost.lookup_cost({}, "logits", 8) is None and pcost.lookup_cost(None, "logits", 8) is None
    # the port's own pool separator resolves as JAX's does
    port_keys = {("features:cls", 8): port[("features/cls", 8)], ("logits", 8): port[("logits", 8)]}
    assert pcost.lookup_cost(port_keys, "features", 8) is port[("features/cls", 8)]


def test_utilization_report_equals_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        analytic, counted, sps = float(rng.uniform(1e9, 1e14)), float(rng.uniform(1e9, 1e14)), float(rng.uniform(0.1, 50))
        n = int(rng.integers(1, 9))
        for hw in (counted, None):
            got = pcost.utilization_report(analytic, hw, sps, n_chips=n, peak_tflops=989.0)
            want = jcost.utilization_report(analytic, hw, sps, n_chips=n, peak_tflops=989.0)
            for k, v in dataclasses.asdict(want).items():
                assert close(getattr(got, k), v), k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pcost.utilization_report(1e12, None, 1.0)


def test_engine_program_costs_are_the_analytic_counts():
    cfg = load_config(SMOKE, ["model.overrides.labels=10"])
    reg = MetricsRegistry()
    eng = InferenceEngine(cfg, device="cpu", max_batch=4, warm_cache=False, registry=reg)
    imgs = np.random.default_rng(0).integers(0, 256, (3, eng.image_size, eng.image_size, 3), dtype=np.uint8)
    eng.predict(imgs, task="logits")
    eng.predict(imgs[:2], task="reconstruct")
    enc = eng.model("logits").model.cfg if hasattr(eng.model("logits"), "model") else eng.model("logits").cfg
    logits = eng.cost_reports[("logits", 4)]
    # the JAX package's count on the same config: encoder x b plus the head
    want = jmfu.classify_flops_per_image(enc, training=False) * 4
    assert logits.flops == want
    assert logits.flops == (jmfu.encoder_flops_per_image(enc, masked=False) + 2 * enc.num_cls_tokens * enc.dim * 10) * 4
    weights = sum(t.numel() * 4 for t in eng.model("logits").state_dict().values())  # float32 on the CPU
    assert logits.bytes_accessed == weights + 2.0 * logits.flops / enc.dim
    assert logits.peak_bytes is None and logits.argument_bytes is None and logits.source == "analytic"
    mae = eng.model("reconstruct")
    recon = eng.cost_reports[("reconstruct", 2)]
    assert recon.flops == jmfu.pretrain_flops_per_image(mae.encoder_cfg, mae.decoder_cfg, training=False) * 2
    snap = reg.snapshot()
    assert snap["xla_flops"]["logits,4,float32"] == logits.flops
    assert "logits,4,float32" not in snap.get("xla_temp_bytes", {})


def test_publish_cost_sets_gauges_and_journals():
    reg, events = MetricsRegistry(), []

    class Journal:
        def event(self, etype, **fields):
            events.append((etype, fields))

    cost = pcost.program_cost("logits", flops=1e9, weight_nbytes=2e6, dim=64, peak_bytes=3e6)
    pcost.publish_cost(cost, bucket="8", dtype="bfloat16", registry=reg, journal=Journal())
    snap = reg.snapshot()
    assert snap["xla_flops"]["logits,8,bfloat16"] == 1e9
    assert snap["xla_bytes_accessed"]["logits,8,bfloat16"] == 2e6 + 2.0 * 1e9 / 64
    assert snap["xla_peak_bytes"]["logits,8,bfloat16"] == 3e6
    assert "xla_temp_bytes" not in snap or not snap["xla_temp_bytes"]
    ((etype, fields),) = events
    assert etype == "compiled_program" and fields["cost_schema"] == pcost.COST_SCHEMA_VERSION == jcost.COST_SCHEMA_VERSION
    jreg = JaxRegistry()
    jcost.publish_cost(jcost.ProgramCost(program="logits", flops=1e9, bytes_accessed=cost.bytes_accessed,
                                         peak_bytes=3e6), bucket="8", dtype="bfloat16", registry=jreg)
    assert jreg.snapshot()["xla_flops"] == snap["xla_flops"]


# ------------------------------------------------------- the train step's cost

SMOKE_ENC = dict(labels=None, mask_ratio=0.75, posemb="sincos2d", image_size=32, patch_size=4, dtype="float32")
SMOKE_DEC = dict(layers=2, dim=64, heads=4, dtype="float32")
REMAT = {"off": {}, "none": dict(grad_ckpt=True, remat_policy="none"), "dots": dict(grad_ckpt=True, remat_policy="dots")}


@pytest.fixture(scope="module")
def xla_step_flops():
    """XLA's FLOP count of the JAX train step's program on a one-device
    mesh, smoke_cpu's model at batch 16, per remat setting: the program
    ``make_train_step`` compiles, lowered here (``extract_cost`` of the
    ``Lowered``: the cost analysis before XLA's optimization passes,
    within 2 % of the compiled program's at these shapes; no compile, no
    run). The parameters are shared: a remat policy changes none."""
    import jax.numpy as jnp

    from jumbo_mae_tpu_tpu.models import MAEPretrainModel as JaxMAE
    from jumbo_mae_tpu_tpu.parallel import MeshConfig, create_mesh
    from jumbo_mae_tpu_tpu.train import OptimConfig as JaxOptimConfig
    from jumbo_mae_tpu_tpu.train import create_sharded_state, make_train_step
    from jumbo_mae_tpu_tpu.train import make_optimizer as jax_make_optimizer

    mesh = create_mesh(MeshConfig(data=1, fsdp=1))
    tx = jax_make_optimizer(JaxOptimConfig(name="adamw", learning_rate=1.5e-4, warmup_steps=5, training_steps=10),
                            global_batch_size=16)
    batch = {"images": jnp.zeros((16, 32, 32, 3), jnp.uint8)}
    state = sharding = None
    out = {}
    for name, extra in REMAT.items():
        module = JaxMAE(jax_preset("vit_t16", **SMOKE_ENC, **extra), JaxDecoderConfig(**SMOKE_DEC))
        if state is None:
            state, sharding = create_sharded_state(module, tx, batch, mesh, mode="pretrain")
        state, sharding = state.replace(apply_fn=module.apply), sharding.replace(apply_fn=module.apply)
        step = make_train_step(mesh, sharding, mode="pretrain", guard_nonfinite=True)
        jitted = dict(zip(step.__code__.co_freevars, (c.cell_contents for c in step.__closure__)))["_train_step"]
        lowered = jitted.lower(state, batch, np.ones(2, np.float32))
        out[name] = jcost.extract_cost(lowered, "train_step").flops
    return out


@pytest.mark.parametrize("remat", list(REMAT))
def test_train_step_flops_against_xla(xla_step_flops, remat):
    enc = preset("vit_t16", **SMOKE_ENC, **REMAT[remat])
    got = pcost.train_step_flops(enc, DecoderConfig(**SMOKE_DEC), batch=16, device_type="cpu")
    ratio = got / xla_step_flops[remat]
    assert 0.90 <= ratio <= 1.10, (remat, got, xla_step_flops[remat])
    # the recompute: one more encoder forward of the blocks under "none"
    base = jmfu.pretrain_flops_per_image(jax_preset("vit_t16", **SMOKE_ENC), JaxDecoderConfig(**SMOKE_DEC)) * 16
    assert (got > base) == (remat == "none")


def test_train_step_cost_orders_the_policies():
    dec = DecoderConfig(layers=8, dim=512, heads=16)
    for dev in ("cpu", "cuda"):
        flops = {name: pcost.train_step_flops(preset("vit_l16", labels=None, mask_ratio=0.75, **extra), dec,
                                              batch=128, device_type=dev) for name, extra in REMAT.items()}
        assert flops["none"] >= flops["dots"] >= flops["off"]
        # ViT-L/16 MAE under "none": the encoder's blocks run twice
        assert flops["none"] / flops["off"] == pytest.approx(1.25, abs=0.01)
        # on the card K1 reruns in the "dots" recompute: the attention scores
        assert (flops["dots"] > flops["off"]) == (dev == "cuda")
    enc = preset("vit_l16", labels=10, mask_ratio=None, linear_probing=True, batch_norm=True, grad_ckpt=True)
    probe = pcost.train_step_flops(enc, batch=4, linear=True)
    head = 2 * enc.num_cls_tokens * enc.dim * 10
    assert probe == (jmfu.encoder_flops_per_image(enc, masked=False) + 3 * head) * 4
    assert probe < pcost.train_step_flops(enc, batch=4)  # finetuning runs the backward and the recompute
    cost = pcost.train_step_cost(preset("vit_t16", **SMOKE_ENC), DecoderConfig(**SMOKE_DEC), batch=16,
                                 param_bytes=1e6, opt_bytes=2e6, device_type="cpu", peak_bytes=None)
    flops = pcost.train_step_flops(preset("vit_t16", **SMOKE_ENC), DecoderConfig(**SMOKE_DEC), batch=16,
                                   device_type="cpu")
    # forward + backward read the weights, gradients written and read, the
    # optimizer's state and the parameters read and written, activations
    assert cost.bytes_accessed == pytest.approx(1e6 * 2 + 1e6 * 2 + (2e6 + 1e6) * 2 + 2.0 * flops / 64, rel=1e-12)
    assert (cost.flops, cost.peak_bytes, cost.source, cost.program) == (flops, None, "analytic", "train_step")
    assert pcost.cost_asdict(cost).keys() == jcost.cost_asdict(jcost.ProgramCost(program="train_step")).keys()
