"""Analytic capacity model: predicted step time, throughput and memory.

Counterpart of ``jumbo_mae_tpu_tpu/obs/perfmodel.py``: a roofline over
the costs ``obs/costmodel.py`` builds. Each program is bounded by the
slowest of its compute term (FLOPs / peak FLOP/s), its memory term
(bytes accessed / HBM bandwidth) and, for sharded training, its
collective term (comm bytes / link bandwidth). FSDP pays 3·P·(n−1)/n
collective bytes a step (two all-gathers, one reduce-scatter), plain
data parallelism 2·P·(n−1)/n (one ring all-reduce).

Two uses: capacity planning before a run (:func:`predict_train_step`
works from the analytic FLOP counts alone) and live drift
(:func:`publish_drift` sets ``perf_predict_vs_measured{program}`` =
measured / predicted).

The JAX package's tables are TPU generations. The port's table has one
accelerator row, the H100 SXM, and no TPU row. An unknown card raises,
naming its kind, rather than being priced as some other chip; the
generic CPU entry is returned only when the caller names the CPU. A
card's memory capacity is read from the device
(``torch.cuda.get_device_properties``), not from the table.
"""

from __future__ import annotations

from dataclasses import dataclass

from jumbo_mae_tpu_tpu_torch.obs.mfu import H100_PEAK_BF16_TFLOPS, classify_flops_per_image, pretrain_flops_per_image

# NVIDIA H100 SXM5 data sheet: 989 dense bf16 TFLOP/s, 3.35 TB/s of HBM3
# and 900 GB/s of NVLink both ways (450 GB/s one way)
H100_HBM_GBPS = 3350.0
H100_NVLINK_GBPS = 450.0

# Order-of-magnitude generic host CPU, the JAX package's: it keeps the
# drift gauge publishing on a CPU run and is never a capacity claim
# (capacity 0 = no device memory to run out of)
GENERIC_CPU = ("cpu", 0.5, 20.0, 10.0, 0.0)


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_tflops: float
    hbm_gbps: float
    ici_gbps: float  # the collective link's one-way rate (NVLink on the H100)
    hbm_bytes: float = 0.0  # capacity; 0 = unknown / not an accelerator


H100 = ChipSpec("h100", H100_PEAK_BF16_TFLOPS, H100_HBM_GBPS, H100_NVLINK_GBPS)


def chip_spec(kind: str | None) -> ChipSpec:
    """The table row of a device kind: ``torch.cuda.get_device_name()``
    of an H100 SXM (``"NVIDIA H100 80GB HBM3"``) is the H100 row, ``"cpu"``
    the generic CPU entry. Any other kind raises ``ValueError`` naming it:
    the PCIe and NVL H100s have other rates and no row here."""
    k = (kind or "").strip()
    if k.lower() == "cpu":
        return ChipSpec(*GENERIC_CPU)
    up = k.upper()
    if "H100" in up and ("HBM3" in up or "SXM" in up) and "PCIE" not in up and "NVL" not in up:
        return H100
    raise ValueError(
        f"no performance-model row for device kind {kind!r}: the table has the H100 SXM only "
        "(pass chip=ChipSpec(...) for another card)"
    )


def detect_chip(device="cuda") -> ChipSpec:
    """The :class:`ChipSpec` of ``device`` (a name or ``torch.device``): on
    a CUDA device its table row with the card's memory capacity; on
    ``"cpu"`` the generic entry. Raises when ``"cuda"`` is asked for and
    there is no card, or the card has no row. (torch is imported here:
    the obs package loads in the data workers, which run without it.)"""
    import torch

    dev = torch.device(device)
    if dev.type == "cpu":
        return ChipSpec(*GENERIC_CPU)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for the performance model ({device!r}); pass device='cpu' explicitly")
    spec = chip_spec(torch.cuda.get_device_name(dev))
    total = torch.cuda.get_device_properties(dev).total_memory
    return ChipSpec(spec.name, spec.peak_tflops, spec.hbm_gbps, spec.ici_gbps, float(total))


@dataclass
class PerfPrediction:
    """One program's roofline: the three terms and which one binds."""

    step_time_s: float
    throughput_per_sec: float  # items/s if batch given, else steps/s
    peak_hbm_bytes: float
    bound: str  # "compute" | "bandwidth" | "comm"
    t_compute_s: float
    t_memory_s: float
    t_comm_s: float


def roofline(
    flops: float,
    bytes_accessed: float,
    chip: ChipSpec,
    *,
    comm_bytes: float = 0.0,
    batch: int | None = None,
    peak_hbm_bytes: float = 0.0,
) -> PerfPrediction:
    """max(compute, memory, comm): a lower bound on one execution."""
    t_c = flops / (chip.peak_tflops * 1e12)
    t_m = bytes_accessed / (chip.hbm_gbps * 1e9)
    t_x = comm_bytes / (chip.ici_gbps * 1e9)
    step = max(t_c, t_m, t_x, 1e-12)
    bound = {t_c: "compute", t_m: "bandwidth", t_x: "comm"}[max(t_c, t_m, t_x)]
    return PerfPrediction(
        step_time_s=step,
        throughput_per_sec=(batch if batch else 1.0) / step,
        peak_hbm_bytes=peak_hbm_bytes,
        bound=bound,
        t_compute_s=t_c,
        t_memory_s=t_m,
        t_comm_s=t_x,
    )


# ----------------------------------------------------------------- comms


def fsdp_comm_bytes(param_bytes: float, *, fsdp: int) -> float:
    """Per-device FSDP collective bytes a step: 3·P·(n−1)/n."""
    if fsdp <= 1:
        return 0.0
    return 3.0 * param_bytes * (fsdp - 1) / fsdp


def dp_comm_bytes(param_bytes: float, *, dp: int) -> float:
    """Per-device DP gradient all-reduce bytes a step (ring): 2·P·(n−1)/n."""
    if dp <= 1:
        return 0.0
    return 2.0 * param_bytes * (dp - 1) / dp


# ------------------------------------------------- analytic train predictor


def approx_param_count(enc_cfg, dec_cfg=None) -> float:
    """Matmul-weight parameter count from the configs (embeddings and
    norms are noise at this precision)."""
    d, h = enc_cfg.dim, enc_cfg.hidden_dim
    per_layer = 4 * d * d + 2 * d * h  # qkv + out projections, the MLP
    jumbo = 2 * (enc_cfg.num_cls_tokens * d) * (4 * enc_cfg.num_cls_tokens * d)
    n = enc_cfg.layers * (per_layer + jumbo / max(enc_cfg.layers, 1))
    n += enc_cfg.patch_size**2 * 3 * d  # patchify
    if dec_cfg is not None:
        dd, dh = dec_cfg.dim, dec_cfg.hidden_dim
        n += dec_cfg.layers * (4 * dd * dd + 2 * dd * dh)
        n += d * dd + dd * enc_cfg.patch_size**2 * 3  # in/out projections
    return float(n)


def predict_train_step(
    enc_cfg,
    dec_cfg=None,
    *,
    per_device_batch: int,
    mode: str = "pretrain",
    chip: ChipSpec | None = None,
    dp: int = 1,
    fsdp: int = 1,
    param_bytes_per_elt: float = 4.0,
) -> PerfPrediction:
    """One train step on one device, from the configs alone. FLOPs from
    ``obs/mfu.py``; bytes ≈ 8 × the parameter bytes (parameters,
    gradients and two Adam moments, each read and written once) plus one
    activation read and write per FLOP-byte of the batch (2·FLOPs/dim).
    ``chip`` defaults to :func:`detect_chip` of ``"cuda"``."""
    if chip is None:
        chip = detect_chip("cuda")
    if mode == "pretrain":
        flops_img = pretrain_flops_per_image(enc_cfg, dec_cfg, training=True)
    else:
        flops_img = classify_flops_per_image(enc_cfg, training=True)
    flops = flops_img * per_device_batch
    p_bytes = approx_param_count(enc_cfg, dec_cfg) * param_bytes_per_elt
    act_bytes = 2.0 * flops / max(enc_cfg.dim, 1)
    bytes_accessed = 8.0 * p_bytes + act_bytes
    comm = fsdp_comm_bytes(p_bytes, fsdp=fsdp) + dp_comm_bytes(p_bytes, dp=dp)
    peak_hbm = 4.0 * p_bytes + act_bytes / 8.0  # parameters, gradients, m and v live across the step
    return roofline(flops, bytes_accessed, chip, comm_bytes=comm, batch=per_device_batch, peak_hbm_bytes=peak_hbm)


# ------------------------------------------------------------- drift gauge


def publish_drift(predicted_s: float, measured_s: float, *, program: str, registry=None) -> float:
    """Set ``perf_predicted_step_seconds{program}`` and
    ``perf_predict_vs_measured{program}`` = measured / predicted (1.0 = on
    the roofline). Returns the ratio."""
    if registry is None:
        from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry

        registry = get_registry()
    ratio = measured_s / max(predicted_s, 1e-12)
    registry.gauge("perf_predicted_step_seconds", "roofline-predicted execution seconds",
                   labels=("program",)).labels(program).set(predicted_s)
    registry.gauge("perf_predict_vs_measured", "measured / roofline-predicted execution time",
                   labels=("program",)).labels(program).set(ratio)
    return ratio
